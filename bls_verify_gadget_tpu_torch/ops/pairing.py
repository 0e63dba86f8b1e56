"""Batched optimal-ate pairing (counterpart of the JAX package's
ops/pairing.py, unfused path).

Miller loop in homogeneous projective coordinates on the M-twist with
sparse mul_by_014 line application (Costello-Lange-Naehrig step formulas);
the negative BLS parameter is handled by a final conjugation.  A shared
multi-pairing keeps one f accumulator; per-pair validity masks make an
invalid pair contribute the neutral line.  The loop has the static run
structure (doubling runs plus one addition block per set bit of |x|).
"""

import torch

from .. import constants as C
from .fp import FP
from . import tower as T

_ABS_X_BITS_MSB = C.ABS_X_BITS[::-1]  # MSB first


def fp_half(a):
    """a/2 mod p: add p if odd, then shift right one bit across limbs."""
    odd = (a[..., 0] & 1) > 0
    ap = FP.propagate(a + FP.const("P", a.device))  # a + p < 2^382 fits
    s = torch.where(odd[..., None], ap, a)
    up = (s << 15) & 0x8000
    return (s >> 1) | torch.cat([up[..., 1:], torch.zeros_like(up[..., :1])], -1)


def fp2_half(a):
    return (fp_half(a[0]), fp_half(a[1]))


# ----------------------------------------------------------------------------
# sparse Fp12 multiplication by a line value c0 + c1 v + c4 vw
# ----------------------------------------------------------------------------

def fp12_mul_by_014(f, c0, c1, c4):
    """f * (g0 + g1 w) with g0 = (c0, c1, 0), g1 = (0, c4, 0)."""
    a, b = f
    v0 = _fp6_mul_by_01(a, c0, c1)
    v1 = _fp6_mul_by_1(b, c4)
    c1c4 = T.fp2_add(c1, c4)
    t = _fp6_mul_by_01(T.fp6_add(a, b), c0, c1c4)
    out0 = T.fp6_add(v0, T.fp6_mul_v(v1))
    out1 = T.fp6_sub(t, T.fp6_add(v0, v1))
    return (out0, out1)


def _fp6_mul_by_01(a, d0, d1):
    """(a0,a1,a2) * (d0 + d1 v) =
    (a0 d0 + xi a2 d1, a0 d1 + a1 d0, a1 d1 + a2 d0)."""
    p = T.fp2_mul_pairs([
        (a[0], d0), (a[2], d1), (a[0], d1), (a[1], d0), (a[1], d1), (a[2], d0),
    ])
    return (
        T.fp2_add(p[0], T.fp2_mul_xi(p[1])),
        T.fp2_add(p[2], p[3]),
        T.fp2_add(p[4], p[5]),
    )


def _fp6_mul_by_1(a, d1):
    """(a0,a1,a2) * (d1 v) = (xi a2 d1, a0 d1, a1 d1)."""
    p = T.fp2_mul_pairs([(a[2], d1), (a[0], d1), (a[1], d1)])
    return (T.fp2_mul_xi(p[0]), p[1], p[2])


# ----------------------------------------------------------------------------
# Miller loop steps (CLN homogeneous projective, M-twist)
# ----------------------------------------------------------------------------

def _dbl_step(t, xp, yp):
    """Doubling step: returns (new T, line coeffs (c0, c1, c4))."""
    X, Y, Z = t
    a_, b_, c_ = T.fp2_mul_pairs([(X, Y), (Y, Y), (Z, Z)])
    a_ = fp2_half(a_)
    c3 = T.fp2_add(T.fp2_add(c_, c_), c_)
    # e = 3 b' Z^2 with b' = 4(1+u): b'*c = 4*xi(c) -- multiplication-free
    e_ = T.fp2_mul_xi(c3)
    e_ = T.fp2_add(e_, e_)
    e_ = T.fp2_add(e_, e_)
    f_ = T.fp2_add(T.fp2_add(e_, e_), e_)           # 3e
    g_ = fp2_half(T.fp2_add(b_, f_))
    h_ = T.fp2_sub(T.fp2_sqr(T.fp2_add(Y, Z)), T.fp2_add(b_, c_))  # 2YZ
    i_ = T.fp2_sub(e_, b_)
    j_ = T.fp2_sqr(X)
    e2 = T.fp2_sqr(e_)
    x3, z3 = T.fp2_mul_pairs([(a_, T.fp2_sub(b_, f_)), (b_, h_)])
    y3 = T.fp2_sub(T.fp2_sqr(g_), T.fp2_add(T.fp2_add(e2, e2), e2))
    # line: c0 = e - b, c1 = 3 X^2 * xp, c4 = -h * yp
    j3 = T.fp2_add(T.fp2_add(j_, j_), j_)
    c1l = T.fp2_muls(j3, xp)
    c4l = T.fp2_muls(T.fp2_neg(h_), yp)
    return (x3, y3, z3), (i_, c1l, c4l)


def _add_step(t, q, xp, yp):
    """Mixed addition step with affine q = (xq, yq): (new T, line)."""
    X, Y, Z = t
    xq, yq = q
    yqz, xqz = T.fp2_mul_pairs([(yq, Z), (xq, Z)])
    th = T.fp2_sub(Y, yqz)        # theta
    lm = T.fp2_sub(X, xqz)        # lambda
    cc = T.fp2_sqr(th)
    dd = T.fp2_sqr(lm)
    e_, f_, g_ = T.fp2_mul_pairs([(lm, dd), (Z, cc), (X, dd)])
    h_ = T.fp2_sub(T.fp2_add(e_, f_), T.fp2_add(g_, g_))
    x3, z3 = T.fp2_mul_pairs([(lm, h_), (Z, e_)])
    t1, t2 = T.fp2_mul_pairs([(th, T.fp2_sub(g_, h_)), (e_, Y)])
    y3 = T.fp2_sub(t1, t2)
    # line: c0 = theta xq - lambda yq, c1 = -theta xp, c4 = lambda yp
    p1, p2 = T.fp2_mul_pairs([(th, xq), (lm, yq)])
    c0l = T.fp2_sub(p1, p2)
    c1l = T.fp2_muls(T.fp2_neg(th), xp)
    c4l = T.fp2_muls(lm, yp)
    return (x3, y3, z3), (c0l, c1l, c4l)


def _neutral_line(c0, c1, c4, valid):
    one = T.fp2_one_like(c0)
    zero = T.fp2_zero_like(c0)
    return (
        T.fp2_cmov(valid, c0, one),
        T.fp2_cmov(valid, c1, zero),
        T.fp2_cmov(valid, c4, zero),
    )


def _cat2(f2s):
    return (torch.cat([a[0] for a in f2s]), torch.cat([a[1] for a in f2s]))


def _fp12_one_like_from(fp2_sample):
    one2 = T.fp2_one_like(fp2_sample)
    z2 = T.fp2_zero_like(fp2_sample)
    return ((one2, z2, z2), (z2, z2, z2))


def multi_miller_loop(pairs):
    """pairs: list of (p_aff, q_aff, valid) with p_aff = (xp, yp) Fp limb
    tensors (B, 24), q_aff = (xq, yq) Fp2 pairs, valid a (B,) bool mask.
    Returns the shared Miller accumulator f (Fp12), conjugated for x < 0.

    The k pairs are stacked along the batch axis, so each Miller step
    (doubling or addition plus line coefficients) runs once at k*B; the
    line applications into the shared f stay sequential."""
    B = pairs[0][0][0].shape[0]
    valids = [v for _, _, v in pairs]
    xp = torch.cat([p[0] for p, _, _ in pairs])
    yp = torch.cat([p[1] for p, _, _ in pairs])
    q = (_cat2([q[0] for _, q, _ in pairs]), _cat2([q[1] for _, q, _ in pairs]))

    def apply_lines(f, lines):
        c0, c1, c4 = lines
        for i, valid in enumerate(valids):
            sl = slice(i * B, (i + 1) * B)
            l0, l1, l4 = _neutral_line(
                (c0[0][sl], c0[1][sl]), (c1[0][sl], c1[1][sl]),
                (c4[0][sl], c4[1][sl]), valid,
            )
            f = fp12_mul_by_014(f, l0, l1, l4)
        return f

    f = _fp12_one_like_from(pairs[0][1][0])
    t = (q[0], q[1], T.fp2_one_like(q[0]))
    # doubling runs + one addition block per set bit (static bit pattern)
    for bit in _ABS_X_BITS_MSB[1:]:
        f = T.fp12_sqr(f)
        t, lines = _dbl_step(t, xp, yp)
        f = apply_lines(f, lines)
        if bit:
            t, lines = _add_step(t, q, xp, yp)
            f = apply_lines(f, lines)
    return T.fp12_conj(f)  # x < 0


# ----------------------------------------------------------------------------
# final exponentiation
# ----------------------------------------------------------------------------

def _exp_by_neg_x(m):
    """m^x (x the negative BLS parameter) for m in the cyclotomic
    subgroup: Granger-Scott squaring runs + one multiply per set bit."""
    f = m  # top set bit
    for bit in _ABS_X_BITS_MSB[1:]:
        f = T.fp12_cyclotomic_sqr(f)
        if bit:
            f = T.fp12_mul(f, m)
    return T.fp12_conj(f)


def final_exponentiation(f):
    """Easy part, then the hard part via
    3(p^4-p^2+1)/r = (x-1)^2 (x+p) (x^2+p^2-1) + 3."""
    f1 = T.fp12_mul(T.fp12_frob(f, 6), T.fp12_inv(f))
    m = T.fp12_mul(T.fp12_frob(f1, 2), f1)
    t0 = T.fp12_mul(_exp_by_neg_x(m), T.fp12_conj(m))
    t1 = T.fp12_mul(_exp_by_neg_x(t0), T.fp12_conj(t0))
    t2 = T.fp12_mul(_exp_by_neg_x(t1), T.fp12_frob(t1, 1))
    t3 = T.fp12_mul(
        T.fp12_mul(_exp_by_neg_x(_exp_by_neg_x(t2)), T.fp12_frob(t2, 2)),
        T.fp12_conj(t2),
    )
    m3 = T.fp12_mul(T.fp12_sqr(m), m)
    return T.fp12_mul(t3, m3)


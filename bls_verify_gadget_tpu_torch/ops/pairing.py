"""Batched optimal-ate pairing (counterpart of the JAX package's
ops/pairing.py).

Miller loop in homogeneous projective coordinates on the M-twist with
sparse mul_by_014 line application (Costello-Lange-Naehrig step formulas);
the negative BLS parameter is handled by a final conjugation.  A shared
multi-pairing keeps one f accumulator; per-pair validity masks make an
invalid pair contribute the neutral line.

The loop follows the run structure of |x|.  By default (config.fuse_miller)
it is one miller_dbl_run launch per doubling run and one miller_add launch
per set bit (11 launches), each carrying every pair, and each exp-by-x
chain of the final exponentiation is one exp_x launch (config.fuse_expx).
With a flag off, the JAX package's step-wise form of that part runs
instead: per doubling one fp12_sqr, one dbl_step over the pairs stacked on
the batch axis and one mul014 per pair; per set bit one add_step and one
mul014 per pair; per run of |x| in a chain one cyclo_sqr and per set bit
one fp12_mul.  Both forms give the same limbs.  The plain versions of the
Miller and exp_x kernels and of the step kernels are here, over the plain
Fp12 layer of ops/tower.py.
"""

import torch

from .. import constants as C
from ..utils.config import config
from .curve import X_SEGMENTS
from .fp import FP
from . import kernels as K
from . import tower as T
from .tower import F2


def fp_half(a):
    """a/2 mod p: add p if odd, then shift right one bit across limbs."""
    odd = (a[..., 0] & 1) > 0
    ap = FP.propagate(a + FP.const("P", a.device))  # a + p < 2^382 fits
    s = torch.where(odd[..., None], ap, a)
    up = (s << 15) & 0x8000
    return (s >> 1) | torch.cat([up[..., 1:], torch.zeros_like(up[..., :1])], -1)


# ----------------------------------------------------------------------------
# plain versions of the Miller kernels: points and lines are (k, 3, 2, N, 24)
# stacks (X, Y, Z) and (c0, c1, c4), one row per pair
# ----------------------------------------------------------------------------

def _dbl_step(t, xp, yp):
    """CLN doubling step of every pair at once (the JAX kernels'
    _miller_dbl_rows) -> (2T, line (e - b, 3 X^2 xp, -h yp)).  The twist
    coefficient b' = 4(1 + u) enters as e = 4 xi(3 Z^2), without a
    product."""
    X, Y, Z = t.unbind(-4)
    a, b, c = F2.mul(F2.stack(X, Y, Z), F2.stack(Y, Y, Z)).unbind(-4)
    a = fp_half(a)
    e = F2.xi(F2.triple(c))
    e = F2.add(e, e)
    e = F2.add(e, e)
    f = F2.triple(e)
    g = fp_half(F2.add(b, f))
    yz, bc = F2.add(F2.stack(Y, b), F2.stack(Z, c)).unbind(-4)
    yz2, j, e2 = F2.sqr(F2.stack(yz, X, e)).unbind(-4)
    h = F2.sub(yz2, bc)
    i, bf = F2.sub(F2.stack(e, b), F2.stack(b, f)).unbind(-4)
    x3, z3 = F2.mul(F2.stack(a, b), F2.stack(bf, h)).unbind(-4)
    y3 = F2.sub(F2.sqr(g), F2.triple(e2))
    c1, c4 = F2.muls(F2.stack(F2.triple(j), F2.neg(h)), torch.stack([xp, yp], -3)).unbind(-4)
    return F2.stack(x3, y3, z3), F2.stack(i, c1, c4)


def _add_step(t, q, xp, yp):
    """CLN mixed addition of the affine q (k, 2, 2, N, 24) = (xq, yq) to
    every pair's T at once (_miller_add_rows) -> (T + Q, line
    (theta xq - lambda yq, -theta xp, lambda yp))."""
    X, Y, Z = t.unbind(-4)
    xq, yq = q.unbind(-4)
    yqz, xqz = F2.mul(F2.stack(yq, xq), Z.unsqueeze(-4)).unbind(-4)
    th, lm = F2.sub(F2.stack(Y, X), F2.stack(yqz, xqz)).unbind(-4)
    cc, dd = F2.sqr(F2.stack(th, lm)).unbind(-4)
    e, f, g = F2.mul(F2.stack(lm, Z, X), F2.stack(dd, cc, dd)).unbind(-4)
    h = F2.sub(F2.add(e, f), F2.add(g, g))
    x3, z3, t1, t2, p1, p2 = F2.mul(
        F2.stack(lm, Z, th, e, th, lm), F2.stack(h, e, F2.sub(g, h), Y, xq, yq)
    ).unbind(-4)
    y3, c0 = F2.sub(F2.stack(t1, p1), F2.stack(t2, p2)).unbind(-4)
    c1, c4 = F2.muls(F2.stack(F2.neg(th), lm), torch.stack([xp, yp], -3)).unbind(-4)
    return F2.stack(x3, y3, z3), F2.stack(c0, c1, c4)


def dbl_step_plain(t, p):
    """Plain version of the dbl_step kernel: T (6, N, 24) = X, Y, Z and the
    G1 points p (2, N, 24) = xp, yp -> (12, N, 24) = 2T, then the line."""
    pts, line = _dbl_step(t.reshape(3, 2, *t.shape[1:]), p[0], p[1])
    return torch.cat([pts, line]).flatten(0, 1)


def add_step_plain(t, q, p):
    """Plain version of the add_step kernel: T (6, N, 24), the affine Q (4,
    N, 24) and p (2, N, 24) -> (12, N, 24) = T + Q, then the line."""
    pts, line = _add_step(t.reshape(3, 2, *t.shape[1:]), q.reshape(2, 2, *q.shape[1:]),
                          p[0], p[1])
    return torch.cat([pts, line]).flatten(0, 1)


def _f6_mul_by_01(a, d0, d1):
    """(a0, a1, a2)(d0 + d1 v) = (a0 d0 + xi a2 d1, a0 d1 + a1 d0,
    a1 d1 + a2 d0) on a (3, 2, N, 24) a."""
    p = F2.mul(a[[0, 2, 0, 1, 1, 2]], torch.stack([d0, d1, d1, d0, d1, d0]))
    return F2.add(p[0::2], torch.stack([F2.xi(p[1]), p[3], p[5]]))


def _f6_mul_by_1(a, d1):
    """(a0, a1, a2)(d1 v) = (xi a2 d1, a0 d1, a1 d1)."""
    p = F2.mul(a[[2, 0, 1]], d1)
    return torch.stack([F2.xi(p[0]), p[1], p[2]])


def neutral_line(n: int, device):
    """The neutral line (1, 0, 0) as a packed (6, n, 24) tensor: an invalid
    pair's line (the JAX package's _neutral_line), which leaves the limbs
    of f as they are."""
    line = torch.zeros((6, n, 24), dtype=torch.int32, device=device)
    line[0] = FP.const("ONE", device)
    return line


def mul014_plain(f, line):
    """Plain version of the mul014 kernel: f * (c0 + c1 v + c4 v w) for a
    packed f and line (6, N, 24) = c0, c1, c4 (the JAX kernels' _f12_mul_014,
    15 Fp2 products)."""
    c0, c1, c4 = line.reshape(3, 2, *line.shape[-2:]).unbind(0)
    a, b = T.fp12_view(f).unbind(0)
    v0 = _f6_mul_by_01(a, c0, c1)
    v1 = _f6_mul_by_1(b, c4)
    t = _f6_mul_by_01(F2.add(a, b), c0, F2.add(c1, c4))
    out0, v01 = F2.add(torch.stack([v0, v0]), torch.stack([T.fp6_mul_v_plain(v1), v1])).unbind(0)
    return torch.stack([out0, F2.sub(t, v01)]).flatten(0, 2)


def miller_dbl_run_plain(f, t, xp, yp, valid, count: int):
    """Plain version of the miller_dbl_run kernel (ops/kernels.py, same
    operands): `count` times [f <- f^2; every pair's doubling step; each
    pair's line into f, in pair order]."""
    k = t.shape[0]
    pts = t.reshape(k, 3, 2, *t.shape[-2:])
    neutral = neutral_line(f.shape[1], f.device)
    for _ in range(count):
        f = T.fp12_sqr_plain(f)
        pts, lines = _dbl_step(pts, xp, yp)
        for i in range(k):
            f = mul014_plain(f, torch.where(valid[i][:, None], lines[i].flatten(0, 1), neutral))
    return f, pts.reshape(t.shape)


def miller_add_plain(f, t, q, xp, yp, valid):
    """Plain version of the miller_add kernel (same operands)."""
    k = t.shape[0]
    pts, lines = _add_step(
        t.reshape(k, 3, 2, *t.shape[-2:]), q.reshape(k, 2, 2, *q.shape[-2:]), xp, yp
    )
    neutral = neutral_line(f.shape[1], f.device)
    for i in range(k):
        f = mul014_plain(f, torch.where(valid[i][:, None], lines[i].flatten(0, 1), neutral))
    return f, pts.reshape(t.shape)


def multi_miller_loop(pairs):
    """pairs: list of (p_aff, q_aff, valid) with p_aff = (xp, yp) Fp limb
    tensors (B, 24), q_aff = (xq, yq) Fp2 pairs, valid a (B,) bool mask.
    Returns the shared Miller accumulator f (Fp12), conjugated for x < 0.

    The pairs ride stacked through every launch: T starts at (xq, yq, 1),
    each doubling run of |x| is one miller_dbl_run launch and each set bit
    one miller_add launch; with config.fuse_miller off, the step-wise loop
    (_step_miller_loop) runs instead, to the same limbs."""
    xp = torch.stack([p[0] for p, _, _ in pairs])
    yp = torch.stack([p[1] for p, _, _ in pairs])
    q = torch.stack([torch.stack([*qa[0], *qa[1]]) for _, qa, _ in pairs])
    valid = torch.stack([v for _, _, v in pairs])
    z = torch.zeros_like(xp)
    t = torch.cat([q, torch.stack([FP.one_like(xp), z], 1)], 1)
    f = torch.cat([FP.one_like(xp[:1]), z[:1].expand(11, *z.shape[1:])])
    if not config.fuse_miller:
        return T.fp12_conj(T.fp12_unpack(_step_miller_loop(f, t, q, xp, yp, valid)))
    for length, add in X_SEGMENTS:
        f, t = K.miller_dbl_run(FP, f, t, xp, yp, valid, length)
        if add:
            f, t = K.miller_add(FP, f, t, q, xp, yp, valid)
    return T.fp12_conj(T.fp12_unpack(f))  # x < 0


def _step_miller_loop(f, t, q, xp, yp, valid):
    """The step-wise Miller loop (the JAX package's static run form,
    ops/pairing.py:266-359) on multi_miller_loop's operands: the k pairs
    stacked on the batch axis (pair i at elements i*n .. (i+1)*n - 1) ride
    one dbl_step launch per doubling and one add_step launch per set bit;
    each pair's line, neutral where the pair is invalid, goes into the
    shared f with one mul014 launch, in pair order.  T and the lines stay
    views of the step's output.  -> f, before the conjugation."""
    k, n = xp.shape[:2]
    p = torch.stack([xp.flatten(0, 1), yp.flatten(0, 1)])
    q, t = (x.transpose(0, 1).flatten(1, 2) for x in (q, t))
    neutral = neutral_line(n, f.device)

    def lines_into(f, out):
        for i in range(k):
            line = torch.where(valid[i][:, None], out[6:, i * n:(i + 1) * n], neutral)
            f = K.mul014(FP, f, line)
        return f, out[:6]

    for length, add in X_SEGMENTS:
        for _ in range(length):
            f = K.fp12_sqr(FP, f)
            f, t = lines_into(f, K.dbl_step(FP, t, p))
        if add:
            f, t = lines_into(f, K.add_step(FP, t, q, p))
    return f


# ----------------------------------------------------------------------------
# final exponentiation
# ----------------------------------------------------------------------------

def exp_x_plain(m, segments):
    """Plain version of the exp_x kernel: from f = m, per (squares,
    multiply) segment that many Granger-Scott squares, then f <- f * m."""
    f = m
    for length, mul in segments:
        f = T.cyclo_sqr_plain(f, length)
        if mul:
            f = T.fp12_mul_plain(f, m)
    return f


def _exp_by_neg_x(m):
    """m^x (x the negative BLS parameter) for m in the cyclotomic subgroup:
    ONE exp_x launch over the runs of |x|, then the conjugation.  With
    config.fuse_expx off, the step-wise chain (the JAX package's static run
    form): from f = m, per run of |x| one cyclo_sqr launch and, where the
    run ends on a set bit, one fp12_mul by m."""
    if config.fuse_expx:
        return T.fp12_conj(T.fp12_unpack(K.exp_x(FP, T.fp12_pack(m), X_SEGMENTS)))
    f = m
    for length, mul in X_SEGMENTS:
        f = T.fp12_cyclotomic_sqr_k(f, length)
        if mul:
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

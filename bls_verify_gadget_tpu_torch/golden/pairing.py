"""Golden optimal-ate pairing on BLS12-381; own copy of the reference
package's golden/pairing.py.

Deliberately transparent implementation: the Miller loop runs on the
untwisted curve E(Fp12) with affine line functions, so every step is
textbook math.  The optimized twisted/projective device path
(ops/pairing.py) is differential-tested against this after final
exponentiation.

Parity: replaces the reference's use of ark-ec `Bls12::multi_pairing`
(reference src/bls.rs:21, :454-457).
"""

from ..constants import P, R, ABS_X, ABS_X_BITS
from . import field as F

# ----------------------------------------------------------------------------
# embedding / untwist helpers
# ----------------------------------------------------------------------------

def _fp12_from_fp2(a):
    return ((a, F.FP2_ZERO, F.FP2_ZERO), F.FP6_ZERO)

def _fp12_from_fp(a):
    return _fp12_from_fp2((a % P, 0))

# w and its inverse powers, for the M-twist untwist map
_W = (F.FP6_ZERO, (F.FP2_ONE, F.FP2_ZERO, F.FP2_ZERO))
_W2 = F.fp12_mul(_W, _W)
_W3 = F.fp12_mul(_W2, _W)
_W2_INV = F.fp12_inv(_W2)
_W3_INV = F.fp12_inv(_W3)


def untwist(q):
    """E'(Fp2) -> E(Fp12): (x, y) -> (x / w^2, y / w^3)."""
    x, y = q
    return (
        F.fp12_mul(_fp12_from_fp2(x), _W2_INV),
        F.fp12_mul(_fp12_from_fp2(y), _W3_INV),
    )


# ----------------------------------------------------------------------------
# Miller loop (affine, over Fp12)
# ----------------------------------------------------------------------------

def _line(t, q, p12):
    """Evaluate the line through t and q (or tangent if t == q) at p12,
    and return (line_value, t + q).  All points affine over Fp12."""
    (x1, y1), (x2, y2) = t, q
    xp, yp = p12
    if x1 == x2 and y1 == y2:
        # tangent
        lam = F.fp12_mul(
            F.fp12_mul(F.fp12_sqr(x1), _fp12_from_fp(3)),
            F.fp12_inv(F.fp12_add(y1, y1)),
        )
    else:
        if x1 == x2:
            raise ValueError("vertical line in Miller loop")
        lam = F.fp12_mul(F.fp12_sub(y2, y1), F.fp12_inv(F.fp12_sub(x2, x1)))
    # l = (yp - y1) - lam (xp - x1)
    lval = F.fp12_sub(F.fp12_sub(yp, y1), F.fp12_mul(lam, F.fp12_sub(xp, x1)))
    x3 = F.fp12_sub(F.fp12_sub(F.fp12_sqr(lam), x1), x2)
    y3 = F.fp12_sub(F.fp12_mul(lam, F.fp12_sub(x1, x3)), y1)
    return lval, (x3, y3)


def miller_loop(p_g1, q_g2):
    """f_{|x|, Q}(P), conjugated for the negative BLS parameter.  Points are
    affine; caller must ensure neither is infinity."""
    q12 = untwist(q_g2)
    p12 = (_fp12_from_fp(p_g1[0]), _fp12_from_fp(p_g1[1]))
    f = F.FP12_ONE
    t = q12
    for bit in reversed(ABS_X_BITS[:-1]):
        f = F.fp12_sqr(f)
        lval, t = _line(t, t, p12)
        f = F.fp12_mul(f, lval)
        if bit:
            lval, t = _line(t, q12, p12)
            f = F.fp12_mul(f, lval)
    return F.fp12_conj(f)  # x < 0


# ----------------------------------------------------------------------------
# final exponentiation
# ----------------------------------------------------------------------------

def _exp_by_neg_x(m):
    """m^x for the (negative) BLS parameter x, via m^|x| then conjugate.
    m must be in the cyclotomic subgroup (conj == inverse)."""
    r = F.FP12_ONE
    b = m
    for i, bit in enumerate(ABS_X_BITS):
        if bit:
            r = F.fp12_mul(r, b)
        if i != len(ABS_X_BITS) - 1:
            b = F.fp12_sqr(b)
    return F.fp12_conj(r)


def final_exponentiation(f):
    """f^(3 (p^12 - 1) / r), computed as easy part then the hard part via
        3 (p^4 - p^2 + 1)/r = (x-1)^2 (x+p) (x^2 + p^2 - 1) + 3.
    The extra cube is a fixed automorphism of the r-th roots of unity, so
    is_one / equality semantics of pairing products are unchanged.
    """
    # easy part: f^((p^6 - 1)(p^2 + 1))
    f1 = F.fp12_mul(F.fp12_frob(f, 6), F.fp12_inv(f))
    m = F.fp12_mul(F.fp12_frob(f1, 2), f1)
    # hard part
    t0 = F.fp12_mul(_exp_by_neg_x(m), F.fp12_conj(m))          # m^(x-1)
    t1 = F.fp12_mul(_exp_by_neg_x(t0), F.fp12_conj(t0))        # t0^(x-1)
    t2 = F.fp12_mul(_exp_by_neg_x(t1), F.fp12_frob(t1, 1))     # t1^(x+p)
    t3 = F.fp12_mul(
        F.fp12_mul(_exp_by_neg_x(_exp_by_neg_x(t2)), F.fp12_frob(t2, 2)),
        F.fp12_conj(t2),
    )                                                          # t2^(x^2+p^2-1)
    m3 = F.fp12_mul(F.fp12_sqr(m), m)
    return F.fp12_mul(t3, m3)


def pairing(p_g1, q_g2):
    """Full pairing e(P, Q) (up to the fixed cube, see final_exponentiation)."""
    if p_g1 is None or q_g2 is None:
        return F.FP12_ONE
    return final_exponentiation(miller_loop(p_g1, q_g2))


def multi_pairing(g1s, g2s):
    """prod_i e(P_i, Q_i): shared final exponentiation over the product of
    Miller loops (reference src/bls.rs:454-457 semantics)."""
    assert len(g1s) == len(g2s)
    f = F.FP12_ONE
    for p, q in zip(g1s, g2s):
        if p is None or q is None:
            continue
        f = F.fp12_mul(f, miller_loop(p, q))
    return final_exponentiation(f)

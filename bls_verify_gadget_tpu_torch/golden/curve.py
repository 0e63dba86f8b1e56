"""Golden G1/G2 elliptic curve ops (affine, python ints); own copy of the
reference package's golden/curve.py.

Points are (x, y) tuples, infinity is None.  G1 coordinates in Fp,
G2 coordinates in Fp2.

Parity: replaces the reference's use of ark-ec G1Projective/G2Projective
(reference src/bls.rs:3, :191, :214, :296) and `.check()` on-curve/subgroup
validation (reference src/bls.rs:438-447).
"""

from ..constants import (
    P, R, ABS_X, B_G1, B_G2, G1_GEN, G2_GEN, PSI_X, PSI_Y, PSI2_X_C0,
    H_EFF_G2, BETA_G1,
)
from . import field as F


# ----------------------------------------------------------------------------
# generic affine short-Weierstrass ops, parameterised by the field
# ----------------------------------------------------------------------------

class _CurveOps:
    def __init__(self, add, sub, mul, sqr, neg, inv, eq_zero, b):
        self.add, self.sub, self.mul, self.sqr = add, sub, mul, sqr
        self.neg, self.inv, self.eq_zero, self.b = neg, inv, eq_zero, b

    def is_on_curve(self, pt):
        if pt is None:
            return True
        x, y = pt
        return self.sub(self.sqr(y), self.add(self.mul(self.sqr(x), x), self.b)) == self._zero(x)

    @staticmethod
    def _zero(sample):
        return 0 if isinstance(sample, int) else (0, 0)

    def pt_neg(self, pt):
        if pt is None:
            return None
        return (pt[0], self.neg(pt[1]))

    def pt_add(self, p1, p2):
        if p1 is None:
            return p2
        if p2 is None:
            return p1
        x1, y1 = p1
        x2, y2 = p2
        if x1 == x2:
            if y1 == self.neg(y2):
                return None
            # doubling
            lam = self.mul(self.mul(self.sqr(x1), self._three(x1)), self.inv(self.add(y1, y1)))
        else:
            lam = self.mul(self.sub(y2, y1), self.inv(self.sub(x2, x1)))
        x3 = self.sub(self.sub(self.sqr(lam), x1), x2)
        y3 = self.sub(self.mul(lam, self.sub(x1, x3)), y1)
        return (x3, y3)

    @staticmethod
    def _three(sample):
        return 3 if isinstance(sample, int) else (3, 0)

    def pt_double(self, p):
        return self.pt_add(p, p)

    def pt_mul(self, p, k):
        if k < 0:
            return self.pt_mul(self.pt_neg(p), -k)
        r = None
        q = p
        while k:
            if k & 1:
                r = self.pt_add(r, q)
            q = self.pt_add(q, q)
            k >>= 1
        return r


g1_ops = _CurveOps(
    F.fp_add, F.fp_sub, F.fp_mul, lambda a: F.fp_mul(a, a), F.fp_neg,
    F.fp_inv, lambda a: a == 0, B_G1,
)
g2_ops = _CurveOps(
    F.fp2_add, F.fp2_sub, F.fp2_mul, F.fp2_sqr, F.fp2_neg, F.fp2_inv,
    F.fp2_is_zero, B_G2,
)

# convenience wrappers ---------------------------------------------------------

def g1_add(p, q): return g1_ops.pt_add(p, q)
def g1_neg(p): return g1_ops.pt_neg(p)
def g1_mul(p, k): return g1_ops.pt_mul(p, k)
def g1_is_on_curve(p): return g1_ops.is_on_curve(p)

def g2_add(p, q): return g2_ops.pt_add(p, q)
def g2_neg(p): return g2_ops.pt_neg(p)
def g2_mul(p, k): return g2_ops.pt_mul(p, k)
def g2_is_on_curve(p): return g2_ops.is_on_curve(p)


# ----------------------------------------------------------------------------
# endomorphisms
# ----------------------------------------------------------------------------

def g1_phi(p):
    """GLV endomorphism phi(x, y) = (beta x, y)."""
    if p is None:
        return None
    return (F.fp_mul(BETA_G1, p[0]), p[1])


def g2_psi(p):
    """Untwist-Frobenius-twist endomorphism.

    psi(x, y) = (PSI_X * conj(x), PSI_Y * conj(y)); acts as multiplication
    by x (the BLS parameter) on the r-torsion subgroup of G2.
    """
    if p is None:
        return None
    return (
        F.fp2_mul(PSI_X, F.fp2_conj(p[0])),
        F.fp2_mul(PSI_Y, F.fp2_conj(p[1])),
    )


def g2_psi2(p):
    """psi applied twice: (PSI2_X_C0 * x, -y)."""
    if p is None:
        return None
    return (F.fp2_muls(p[0], PSI2_X_C0), F.fp2_neg(p[1]))


# ----------------------------------------------------------------------------
# subgroup checks (mirror reference `.check()` semantics, src/bls.rs:438-447)
# ----------------------------------------------------------------------------

def g1_in_subgroup(p):
    """Fast G1 subgroup check (Scott 2021): P in subgroup iff
    phi(P) == [-x^2] P, checked as [|x|]([|x|]P) == -phi(P) using two cheap
    64-bit scalar muls.  Validated against r*P == inf in tests."""
    if p is None:
        return True
    if not g1_is_on_curve(p):
        return False
    xxp = g1_mul(g1_mul(p, ABS_X), ABS_X)  # [x^2] P (sign squares away)
    return xxp == g1_neg(g1_phi(p))


def g1_in_subgroup_slow(p):
    if p is None:
        return True
    return g1_is_on_curve(p) and g1_mul(p, R) is None


def g2_in_subgroup(p):
    """Fast G2 subgroup check: psi(Q) == [x]Q (x negative: psi(Q) == -[|x|]Q)."""
    if p is None:
        return True
    if not g2_is_on_curve(p):
        return False
    return g2_psi(p) == g2_neg(g2_mul(p, ABS_X))


def g2_in_subgroup_slow(p):
    if p is None:
        return True
    return g2_is_on_curve(p) and g2_mul(p, R) is None


# ----------------------------------------------------------------------------
# cofactor clearing for hash-to-G2
# ----------------------------------------------------------------------------

def g2_clear_cofactor_slow(p):
    """Multiply by h_eff (the reference's in-circuit method,
    src/hasher.rs:663-673)."""
    return g2_mul(p, H_EFF_G2)


def g2_clear_cofactor(p):
    """Budroni-Pintore psi-based cofactor clearing (the fast method the
    reference left commented out at src/hasher.rs:675-724):

        h_eff * P = [x^2 - x - 1] P + [x - 1] psi(P) + psi2(2 P)
    """
    xp = g2_neg(g2_mul(p, ABS_X))           # [x] P   (x < 0)
    xxp = g2_neg(g2_mul(xp, ABS_X))         # [x^2] P
    t = g2_add(g2_add(xxp, g2_neg(xp)), g2_neg(p))   # [x^2 - x - 1] P
    t2 = g2_psi(g2_add(xp, g2_neg(p)))               # psi([x - 1] P)
    t3 = g2_psi2(g2_double2(p))                      # psi2(2P)
    return g2_add(g2_add(t, t2), t3)


def g2_double2(p):
    return g2_ops.pt_double(p)


G1_GENERATOR = G1_GEN
G2_GENERATOR = G2_GEN

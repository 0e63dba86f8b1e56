"""Affine point gadgets G1Var / G2Var with explicit infinity flags.

Complete addition via hinted field inversions and Boolean selects — the
gadget analogue of the device path's branch-free cmov formulas.  Plays the
role of ark-r1cs-std G1Var/G2Var + scalar_mul_le
(reference src/hasher.rs:11,672; src/constraints.rs:20-21).
"""

from __future__ import annotations

from .. import constants as C
from .gadgets import FpVar, Boolean
from .fields import Fp2Var
from .system import AllocationMode


class AffinePointVar:
    """(x, y, is_inf) with coordinates in F (FpVar for G1, Fp2Var for G2)."""

    __slots__ = ("x", "y", "inf")

    def __init__(self, x, y, inf: Boolean):
        self.x = x
        self.y = y
        self.inf = inf

    @property
    def cs(self):
        return self.inf.cs

    def value(self):
        if self.inf.value:
            return None
        return (self.x.value, self.y.value)

    def negate(self):
        return AffinePointVar(self.x, -self.y, self.inf)

    def select(self, cond: Boolean, other: "AffinePointVar"):
        return AffinePointVar(
            self.x.select(cond, other.x),
            self.y.select(cond, other.y),
            cond.select_bool(self.inf, other.inf),
        )


def _zero_coord(sample):
    cs = sample.cs if isinstance(sample, FpVar) else sample.c0.cs
    if isinstance(sample, FpVar):
        return FpVar.constant(cs, 0)
    return Fp2Var.constant(cs, (0, 0))


def _three(sample):
    cs = sample.cs if isinstance(sample, FpVar) else sample.c0.cs
    if isinstance(sample, FpVar):
        return FpVar.constant(cs, 3)
    return Fp2Var.constant(cs, (3, 0))


def pt_infinity(sample_coord) -> AffinePointVar:
    cs = sample_coord.cs if isinstance(sample_coord, FpVar) else sample_coord.c0.cs
    z = _zero_coord(sample_coord)
    return AffinePointVar(z, z, Boolean.constant(cs, 1))


def pt_add(p: AffinePointVar, q: AffinePointVar) -> AffinePointVar:
    """Complete affine addition with hinted inverses and selects."""
    dx = q.x - p.x
    dy = q.y - p.y
    dx_inv, x_eq = dx.inverse_or_zero()
    y_eq = dy.is_zero()

    # chord slope (garbage when x_eq — selected away)
    lam_add = dy * dx_inv
    # tangent slope: 3 x^2 / (2 y)  (y != 0 on these curves)
    y2_inv, _ = (p.y + p.y).inverse_or_zero()
    lam_dbl = p.x.square() * _three(p.x) * y2_inv
    is_dbl = x_eq.and_(y_eq)
    lam = lam_dbl.select(is_dbl, lam_add)

    x3 = lam.square() - p.x - q.x
    y3 = lam * (p.x - x3) - p.y

    res = AffinePointVar(x3, y3, Boolean.constant(p.cs, 0))
    # P == -Q (x equal, y not equal) -> infinity
    to_inf = x_eq.and_(y_eq.not_())
    res = pt_infinity(p.x).select(to_inf, res)
    # identity cases
    res = q.select(p.inf, res)
    res = p.select(q.inf.and_(p.inf.not_()), res)
    return res


def pt_double(p: AffinePointVar) -> AffinePointVar:
    y2_inv, y_zero = (p.y + p.y).inverse_or_zero()
    lam = p.x.square() * _three(p.x) * y2_inv
    x3 = lam.square() - p.x - p.x
    y3 = lam * (p.x - x3) - p.y
    res = AffinePointVar(x3, y3, Boolean.constant(p.cs, 0))
    return pt_infinity(p.x).select(p.inf.or_(y_zero), res)


def pt_scalar_mul_bits(p: AffinePointVar, bits_msb_first) -> AffinePointVar:
    """Double-and-select-add over Boolean scalar bits (MSB first) — the
    gadget analogue of ark scalar_mul_le (reference src/hasher.rs:672)."""
    acc = pt_infinity(p.x)
    for b in bits_msb_first:
        acc = pt_double(acc)
        added = pt_add(acc, p)
        acc = added.select(b, acc)
    return acc


def pt_scalar_mul_const(p: AffinePointVar, scalar: int) -> AffinePointVar:
    """Scalar mul by a host constant: static double-and-add (no selects)."""
    acc = None
    for bit in bin(scalar)[2:]:
        if acc is not None:
            acc = pt_double(acc)
        if bit == "1":
            acc = pt_add(acc, p) if acc is not None else p
    return acc if acc is not None else pt_infinity(p.x)


# ----------------------------------------------------------------------------
# G2-specific: psi endomorphisms + fast cofactor clearing (circuit version)
# ----------------------------------------------------------------------------

def g2_psi(p: AffinePointVar) -> AffinePointVar:
    from ..constants import PSI_X, PSI_Y

    cs = p.cs
    cx = Fp2Var.constant(cs, PSI_X)
    cy = Fp2Var.constant(cs, PSI_Y)
    return AffinePointVar(cx * p.x.conjugate(), cy * p.y.conjugate(), p.inf)


def g2_psi2(p: AffinePointVar) -> AffinePointVar:
    from ..constants import PSI2_X_C0

    return AffinePointVar(p.x.scale_fp(PSI2_X_C0), -p.y, p.inf)


def g2_clear_cofactor(p: AffinePointVar) -> AffinePointVar:
    """Budroni-Pintore, mirroring the device path (ops/curve.py
    g2_clear_cofactor; fast version of reference src/hasher.rs:663-673)."""
    from ..constants import ABS_X

    xp = pt_scalar_mul_const(p, ABS_X).negate()          # [x] P
    xxp = pt_scalar_mul_const(xp, ABS_X).negate()        # [x^2] P
    t = pt_add(pt_add(xxp, xp.negate()), p.negate())     # [x^2 - x - 1] P
    t2 = g2_psi(pt_add(xp, p.negate()))                  # psi([x-1] P)
    t3 = g2_psi2(pt_double(p))                           # psi2(2P)
    return pt_add(pt_add(t, t2), t3)


def alloc_g1(cs, pt, mode=AllocationMode.WITNESS) -> AffinePointVar:
    """Host affine int point (or None) -> G1 gadget.

    Finite allocations enforce y^2 == x^3 + 4 (arkworks allocates SW points
    with an on-curve check; soundness of the hinted-slope pairing gadget
    relies on it — an off-curve (0, 0) would zero the doubling denominator
    and leave the slope hint unconstrained, tests/test_r1cs_adversarial.py)."""
    if pt is None:
        return pt_infinity(FpVar.constant(cs, 0))
    x = FpVar.alloc(cs, pt[0], mode)
    y = FpVar.alloc(cs, pt[1], mode)
    (y.square() - FpVar.constant(cs, C.B_G1)).enforce_equal(x.square() * x)
    return AffinePointVar(x, y, Boolean.constant(cs, 0))


def alloc_g2(cs, pt, mode=AllocationMode.WITNESS) -> AffinePointVar:
    """As alloc_g1, enforcing the twist equation y^2 == x^3 + 4(1+u)."""
    if pt is None:
        return pt_infinity(Fp2Var.constant(cs, (0, 0)))
    x = Fp2Var.alloc(cs, pt[0], mode)
    y = Fp2Var.alloc(cs, pt[1], mode)
    (y.square() - Fp2Var.constant(cs, C.B_G2)).enforce_equal(x.square() * x)
    return AffinePointVar(x, y, Boolean.constant(cs, 0))

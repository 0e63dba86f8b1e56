"""Fp2 / Fp6 / Fp12 tower gadgets over FpVar (native Fq arithmetic —
SURVEY.md sec 2.1: the constraint field IS the base field, so these are
cheap native rows, never bignum emulation).

Mirrors ark-r1cs-std Fp2Var usage in the reference (src/hasher.rs:33-34) and
provides the Fp6/Fp12 tower the in-circuit pairing gadget needs
(replacing upstream PairingVar internals, reference src/constraints.rs:19).

Formulas track golden/field.py one-to-one so the gadget path is
differential-testable against the golden value path.
"""

from __future__ import annotations

from .gadgets import FpVar, Boolean
from ..golden import field as GF


class Fp2Var:
    __slots__ = ("c0", "c1")

    def __init__(self, c0: FpVar, c1: FpVar):
        self.c0 = c0
        self.c1 = c1

    # --------------------------------------------------------------

    @property
    def cs(self):
        return self.c0.cs

    @property
    def value(self):
        return (self.c0.value, self.c1.value)

    @staticmethod
    def constant(cs, v) -> "Fp2Var":
        return Fp2Var(FpVar.constant(cs, v[0]), FpVar.constant(cs, v[1]))

    @staticmethod
    def alloc(cs, v, mode=None) -> "Fp2Var":
        from .system import AllocationMode

        mode = mode or AllocationMode.WITNESS
        return Fp2Var(FpVar.alloc(cs, v[0], mode), FpVar.alloc(cs, v[1], mode))

    def __add__(self, o):
        return Fp2Var(self.c0 + o.c0, self.c1 + o.c1)

    def __sub__(self, o):
        return Fp2Var(self.c0 - o.c0, self.c1 - o.c1)

    def __neg__(self):
        return Fp2Var(-self.c0, -self.c1)

    def double(self):
        return Fp2Var(self.c0.double(), self.c1.double())

    def conjugate(self):
        return Fp2Var(self.c0, -self.c1)

    def scale_fp(self, k: int):
        return Fp2Var(self.c0.scale(k), self.c1.scale(k))

    def mul_fpvar(self, k: FpVar):
        return Fp2Var(self.c0 * k, self.c1 * k)

    def __mul__(self, o):
        """Karatsuba: 3 Fp muls."""
        v0 = self.c0 * o.c0
        v1 = self.c1 * o.c1
        v2 = (self.c0 + self.c1) * (o.c0 + o.c1)
        return Fp2Var(v0 - v1, v2 - v0 - v1)

    def square(self):
        """(c0+c1)(c0-c1), 2 c0 c1 — 2 Fp muls."""
        a = (self.c0 + self.c1) * (self.c0 - self.c1)
        b = self.c0 * self.c1
        return Fp2Var(a, b.double())

    def mul_xi(self):
        """* (1 + u)."""
        return Fp2Var(self.c0 - self.c1, self.c0 + self.c1)

    def inverse(self) -> "Fp2Var":
        """Witness-hinted inverse: allocate inv, enforce self * inv == 1
        (2 constraints via Karatsuba rows)."""
        cs = self.cs
        inv_val = GF.fp2_inv(self.value) if self.value != (0, 0) else None
        if inv_val is None:
            raise ZeroDivisionError("Fp2Var.inverse of zero")
        with cs.suppress_tape():
            w = Fp2Var.alloc(cs, inv_val)
        cs.record(
            "fp2inv0", [w.c0.lc[0][0], w.c1.lc[0][0]], [self.c0.lc, self.c1.lc]
        )
        prod = self * w
        prod.c0.enforce_equal(FpVar.constant(cs, 1))
        prod.c1.enforce_equal(FpVar.constant(cs, 0))
        return w

    def inverse_or_zero(self) -> tuple["Fp2Var", "Boolean"]:
        """(inv0, is_zero): norm-based: z = is_zero(c0^2 + c1^2)... uses the
        norm (c0^2+c1^2 == 0 iff self == 0 since -1 is a non-residue)."""
        cs = self.cs
        is_z = self.value == (0, 0)
        inv_val = (0, 0) if is_z else GF.fp2_inv(self.value)
        with cs.suppress_tape():
            w = Fp2Var.alloc(cs, inv_val)
            z = Boolean.alloc(cs, 1 if is_z else 0)
        cs.record(
            "fp2inv0z",
            [w.c0.lc[0][0], w.c1.lc[0][0], z.lc[0][0]],
            [self.c0.lc, self.c1.lc],
        )
        prod = self * w
        one_minus_z = FpVar.constant(cs, 1) - z.to_fp()
        prod.c0.enforce_equal(one_minus_z)
        prod.c1.enforce_equal(FpVar.constant(cs, 0))
        # self * z == 0 componentwise
        cs.enforce(self.c0.lc, z.lc, [])
        cs.enforce(self.c1.lc, z.lc, [])
        return w, z

    def is_zero(self) -> Boolean:
        return self.inverse_or_zero()[1]

    def is_eq(self, o) -> Boolean:
        return (self - o).is_zero()

    def enforce_equal(self, o):
        self.c0.enforce_equal(o.c0)
        self.c1.enforce_equal(o.c1)

    def select(self, cond: Boolean, other: "Fp2Var") -> "Fp2Var":
        """cond ? self : other (the reference's cmov, src/hasher.rs:506-513)."""
        return Fp2Var(self.c0.select(cond, other.c0), self.c1.select(cond, other.c1))

    def sgn0(self) -> Boolean:
        """RFC 9380 sgn0 m=2 (reference src/hasher.rs:520-530): parity of c0,
        or parity of c1 when c0 == 0.  Uses canonical (< p enforced) bit
        decompositions so the parity bit is sound."""
        cs = self.cs
        b0 = self.c0.to_bits_le_canonical()
        b1 = self.c1.to_bits_le_canonical()
        z0 = self.c0.is_zero()
        return Boolean(
            cs,
            z0.select_bool(b1[0], b0[0]).lc,
            GF.fp2_sgn0(self.value),
        )

    def pow_const(self, exponent: int) -> "Fp2Var":
        """Square-and-select-multiply over a constant exponent (the
        reference's pow, src/hasher.rs:532-548, but with static bits so no
        selects are needed)."""
        result = Fp2Var.constant(self.cs, (1, 0))
        started = False
        for bit in [(exponent >> i) & 1 for i in range(exponent.bit_length())][::-1]:
            if started:
                result = result.square()
            if bit:
                result = result * self if started else self
                started = True
        return result


# ----------------------------------------------------------------------------
# Fp6 / Fp12 (tuples of Fp2Var) — used by the pairing gadget
# ----------------------------------------------------------------------------

def fp6_add(a, b):
    return tuple(x + y for x, y in zip(a, b))

def fp6_sub(a, b):
    return tuple(x - y for x, y in zip(a, b))

def fp6_neg(a):
    return tuple(-x for x in a)

def fp6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    v0, v1, v2 = a0 * b0, a1 * b1, a2 * b2
    c0 = v0 + ((a1 + a2) * (b1 + b2) - (v1 + v2)).mul_xi()
    c1 = (a0 + a1) * (b0 + b1) - (v0 + v1) + v2.mul_xi()
    c2 = (a0 + a2) * (b0 + b2) - (v0 + v2) + v1
    return (c0, c1, c2)

def fp6_mul_v(a):
    return (a[2].mul_xi(), a[0], a[1])

def fp6_inverse(a):
    """Witness-hinted: 6 constraints-ish instead of the algebraic tower
    formula."""
    cs = a[0].cs
    val = tuple(x.value for x in a)
    inv_val = GF.fp6_inv(val)
    with cs.suppress_tape():
        w = tuple(Fp2Var.alloc(cs, c) for c in inv_val)
    cs.record(
        "fp6inv",
        [c.lc[0][0] for f2 in w for c in (f2.c0, f2.c1)],
        [c.lc for f2 in a for c in (f2.c0, f2.c1)],
    )
    prod = fp6_mul(a, w)
    one = Fp2Var.constant(cs, (1, 0))
    zero = Fp2Var.constant(cs, (0, 0))
    prod[0].enforce_equal(one)
    prod[1].enforce_equal(zero)
    prod[2].enforce_equal(zero)
    return w

def fp12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    v0 = fp6_mul(a0, b0)
    v1 = fp6_mul(a1, b1)
    c0 = fp6_add(v0, fp6_mul_v(v1))
    c1 = fp6_sub(fp6_mul(fp6_add(a0, a1), fp6_add(b0, b1)), fp6_add(v0, v1))
    return (c0, c1)

def fp12_sqr(a):
    a0, a1 = a
    v0 = fp6_mul(a0, a1)
    t = fp6_mul(fp6_add(a0, a1), fp6_add(a0, fp6_mul_v(a1)))
    c0 = fp6_sub(fp6_sub(t, v0), fp6_mul_v(v0))
    c1 = fp6_add(v0, v0)
    return (c0, c1)

def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))

def fp12_inverse(a):
    """Witness-hinted Fp12 inverse: 1 alloc + mul + equality rows."""
    cs = a[0][0].cs
    val = (tuple(x.value for x in a[0]), tuple(x.value for x in a[1]))
    inv_val = GF.fp12_inv(val)
    with cs.suppress_tape():
        w = tuple(tuple(Fp2Var.alloc(cs, c2) for c2 in c6) for c6 in inv_val)
    cs.record(
        "fp12inv",
        [c.lc[0][0] for c6 in w for f2 in c6 for c in (f2.c0, f2.c1)],
        [c.lc for c6 in a for f2 in c6 for c in (f2.c0, f2.c1)],
    )
    prod = fp12_mul(a, w)
    one = Fp2Var.constant(cs, (1, 0))
    zero = Fp2Var.constant(cs, (0, 0))
    prod[0][0].enforce_equal(one)
    for i in range(1, 3):
        prod[0][i].enforce_equal(zero)
    for i in range(3):
        prod[1][i].enforce_equal(zero)
    return w

def fp12_frob(a, power):
    from ..constants import FROB6_C1, FROB6_C2, FROB12_C1

    cs = a[0][0].cs
    i = power % 12

    def cj(x):
        return x.conjugate() if power % 2 else x

    def f6(x6, j):
        return (
            cj(x6[0]),
            cj(x6[1]) * Fp2Var.constant(cs, FROB6_C1[j % 6]),
            cj(x6[2]) * Fp2Var.constant(cs, FROB6_C2[j % 6]),
        )

    c0 = f6(a[0], i)
    c1 = f6(a[1], i)
    k = Fp2Var.constant(cs, FROB12_C1[i])
    c1 = tuple(x * k for x in c1)
    return (c0, c1)

def fp12_value(a):
    return (tuple(x.value for x in a[0]), tuple(x.value for x in a[1]))

def fp12_constant(cs, v):
    return (
        tuple(Fp2Var.constant(cs, c) for c in v[0]),
        tuple(Fp2Var.constant(cs, c) for c in v[1]),
    )

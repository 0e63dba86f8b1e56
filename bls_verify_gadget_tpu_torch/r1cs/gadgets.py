"""Gadget vocabulary over Fq: FpVar, Boolean, UInt8, UInt32.

Parity with the reference's ark-r1cs-std usage (SURVEY.md sec 2.3):
FpVar/Boolean/UInt8/UInt32::addmany/select/is_eq/to_bits_le
(reference src/hasher.rs:8-16, src/constraints.rs:7,183-187).

FpVar carries a lazy linear combination (like arkworks), so add/sub/scalar
ops emit no constraints; each nonlinear op (mul, inverse, is_zero, bit
decomposition) emits the standard minimal rows.
"""

from __future__ import annotations

from .system import ConstraintSystem, AllocationMode


def _merge(lc1, lc2, s1=1, s2=1, mod=None):
    acc = {}
    for i, c in lc1:
        acc[i] = (acc.get(i, 0) + c * s1) % mod
    for i, c in lc2:
        acc[i] = (acc.get(i, 0) + c * s2) % mod
    return [(i, c) for i, c in acc.items() if c != 0]


class FpVar:
    """Field element as a lazy LC + concrete value."""

    __slots__ = ("cs", "lc", "value")

    def __init__(self, cs: ConstraintSystem, lc, value: int):
        self.cs = cs
        self.lc = lc
        self.value = value % cs.field_mod

    # construction ---------------------------------------------------------

    @staticmethod
    def constant(cs, v: int) -> "FpVar":
        v = v % cs.field_mod
        return FpVar(cs, [(0, v)] if v else [], v)

    @staticmethod
    def alloc(cs, v: int, mode: AllocationMode = AllocationMode.WITNESS) -> "FpVar":
        if mode == AllocationMode.CONSTANT:
            return FpVar.constant(cs, v)
        idx = cs.new_variable(v, mode)
        cs.record("input", [idx], [])
        return FpVar(cs, [(idx, 1)], v)

    @property
    def is_constant(self) -> bool:
        return all(i == 0 for i, _ in self.lc)

    def const_value(self) -> int:
        return self.value

    # linear ops (free) ----------------------------------------------------

    def __add__(self, other: "FpVar") -> "FpVar":
        m = self.cs.field_mod
        return FpVar(self.cs, _merge(self.lc, other.lc, mod=m), self.value + other.value)

    def __sub__(self, other: "FpVar") -> "FpVar":
        m = self.cs.field_mod
        return FpVar(self.cs, _merge(self.lc, other.lc, 1, -1, mod=m), self.value - other.value)

    def __neg__(self) -> "FpVar":
        m = self.cs.field_mod
        return FpVar(self.cs, [(i, (-c) % m) for i, c in self.lc], -self.value)

    def scale(self, k: int) -> "FpVar":
        m = self.cs.field_mod
        k %= m
        return FpVar(self.cs, [(i, c * k % m) for i, c in self.lc], self.value * k)

    def double(self) -> "FpVar":
        return self.scale(2)

    # nonlinear ops --------------------------------------------------------

    def __mul__(self, other: "FpVar") -> "FpVar":
        cs, m = self.cs, self.cs.field_mod
        if self.is_constant:
            return other.scale(self.const_value())
        if other.is_constant:
            return self.scale(other.const_value())
        val = self.value * other.value % m
        w = cs.new_witness(val)
        cs.record("mul", [w], [self.lc, other.lc])
        cs.enforce(self.lc, other.lc, [(w, 1)])
        return FpVar(cs, [(w, 1)], val)

    def square(self) -> "FpVar":
        return self * self

    def inverse(self) -> "FpVar":
        """Strict inverse: enforces self * inv == 1 (unsatisfiable at 0),
        matching arkworks FpVar::inverse semantics."""
        cs, m = self.cs, self.cs.field_mod
        inv_val = pow(self.value, -1, m) if self.value else 0
        w = cs.new_witness(inv_val)
        cs.record("inv", [w], [self.lc])
        cs.enforce(self.lc, [(w, 1)], [(0, 1)])
        return FpVar(cs, [(w, 1)], inv_val)

    def inverse_or_zero(self) -> tuple["FpVar", "Boolean"]:
        """inv0: (inverse-or-zero, is_zero flag), both enforced:
        a*i = 1 - z ; a*z = 0."""
        cs, m = self.cs, self.cs.field_mod
        z_val = 1 if self.value == 0 else 0
        i_val = pow(self.value, -1, m) if self.value else 0
        with cs.suppress_tape():
            z = Boolean.alloc(cs, z_val)
        iw = cs.new_witness(i_val)
        cs.record("inv0", [z.lc[0][0], iw], [self.lc])
        cs.enforce(self.lc, [(iw, 1)], _merge([(0, 1)], z.lc, 1, -1, mod=m))
        cs.enforce(self.lc, z.lc, [])
        return FpVar(cs, [(iw, 1)], i_val), z

    def is_zero(self) -> "Boolean":
        return self.inverse_or_zero()[1]

    def is_eq(self, other: "FpVar") -> "Boolean":
        return (self - other).is_zero()

    def enforce_equal(self, other: "FpVar"):
        self.cs.enforce(self.lc, [(0, 1)], other.lc)

    def enforce_not_equal(self, other: "FpVar"):
        """(a-b) has an inverse (reference pk != identity check,
        src/constraints.rs:96-99 flavour)."""
        (self - other).inverse()

    def select(self, cond: "Boolean", other: "FpVar") -> "FpVar":
        """cond ? self : other — one constraint."""
        return _select_fp(cond, self, other)

    def to_bits_le(self, nbits: int) -> list["Boolean"]:
        """Decompose into nbits booleans, enforcing sum b_i 2^i == self.
        Caller must know the value fits in nbits.  NOTE: not canonical —
        for values with a second representation mod p use
        to_bits_le_canonical."""
        cs, m = self.cs, self.cs.field_mod
        bits = []
        v = self.value
        assert v < (1 << nbits), "value does not fit bit width"
        lc = []
        with cs.suppress_tape():
            for i in range(nbits):
                b = Boolean.alloc(cs, (v >> i) & 1)
                bits.append(b)
                lc = _merge(lc, b.lc, 1, (1 << i) % m, mod=m)
        cs.record("bits", [b.lc[0][0] for b in bits], [self.lc], nbits)
        cs.enforce(lc, [(0, 1)], self.lc)
        return bits

    def to_bits_le_canonical(self) -> list["Boolean"]:
        """Full 381-bit decomposition with an enforced value < p check, so
        exactly one witness satisfies it (parity extraction is sound —
        matching ark-r1cs-std's canonical to_bits_le semantics)."""
        cs, m = self.cs, self.cs.field_mod
        bits = self.to_bits_le(m.bit_length())
        # big-endian walk: prefix_eq tracks "all higher bits equal p's";
        # where p has a 0-bit, a set bit under prefix_eq would mean > p;
        # at the end prefix_eq == 1 would mean == p.  Both are forbidden.
        prefix = Boolean.constant(cs, 1)
        for i in range(m.bit_length() - 1, -1, -1):
            b = bits[i]
            if (m >> i) & 1:
                prefix = prefix.and_(b)
            else:
                # prefix * b == 0
                cs.enforce(prefix.lc, b.lc, [])
        cs.enforce(prefix.lc, [(0, 1)], [])
        return bits


def _select_fp(cond: "Boolean", a: FpVar, b: FpVar) -> FpVar:
    """b + cond * (a - b)."""
    cs, m = a.cs, a.cs.field_mod
    diff = a - b
    val = a.value if cond.value else b.value
    w = cs.new_witness((val - b.value) % m)
    cs.record("mul", [w], [cond.lc, diff.lc])
    cs.enforce(cond.lc, diff.lc, [(w, 1)])
    return FpVar(cs, _merge(b.lc, [(w, 1)], mod=m), val)


class Boolean:
    """0/1 variable with b*(1-b) = 0 enforced at allocation."""

    __slots__ = ("cs", "lc", "value")

    def __init__(self, cs, lc, value):
        self.cs = cs
        self.lc = lc
        self.value = int(value) & 1

    @staticmethod
    def alloc(cs, v: int, mode: AllocationMode = AllocationMode.WITNESS) -> "Boolean":
        v = int(v) & 1
        if mode == AllocationMode.CONSTANT:
            return Boolean.constant(cs, v)
        idx = cs.new_variable(v, mode)
        cs.record("input", [idx], [])
        m = cs.field_mod
        cs.enforce([(idx, 1)], _merge([(0, 1)], [(idx, 1)], 1, -1, mod=m), [])
        return Boolean(cs, [(idx, 1)], v)

    @staticmethod
    def constant(cs, v: int) -> "Boolean":
        v = int(v) & 1
        return Boolean(cs, [(0, 1)] if v else [], v)

    @property
    def is_constant(self) -> bool:
        return all(i == 0 for i, _ in self.lc)

    def to_fp(self) -> FpVar:
        return FpVar(self.cs, list(self.lc), self.value)

    def not_(self) -> "Boolean":
        m = self.cs.field_mod
        return Boolean(self.cs, _merge([(0, 1)], self.lc, 1, -1, mod=m), 1 - self.value)

    def and_(self, other: "Boolean") -> "Boolean":
        cs, m = self.cs, self.cs.field_mod
        if self.is_constant:
            return other if self.value else Boolean.constant(cs, 0)
        if other.is_constant:
            return self if other.value else Boolean.constant(cs, 0)
        v = self.value & other.value
        w = cs.new_witness(v)
        cs.record("mul", [w], [self.lc, other.lc])
        cs.enforce(self.lc, other.lc, [(w, 1)])
        return Boolean(cs, [(w, 1)], v)

    def or_(self, other: "Boolean") -> "Boolean":
        return self.not_().and_(other.not_()).not_()

    def xor(self, other: "Boolean") -> "Boolean":
        """a + b - 2ab."""
        cs, m = self.cs, self.cs.field_mod
        if self.is_constant:
            return other if not self.value else other.not_()
        if other.is_constant:
            return self if not other.value else self.not_()
        v = self.value ^ other.value
        w = cs.new_witness(v)
        cs.record("xor", [w], [self.lc, other.lc])
        # 2ab = a + b - (a xor b)
        cs.enforce(
            [(i, 2 * c % m) for i, c in self.lc],
            other.lc,
            _merge(_merge(self.lc, other.lc, mod=m), [(w, 1)], 1, -1, mod=m),
        )
        return Boolean(cs, [(w, 1)], v)

    def select_bool(self, a: "Boolean", b: "Boolean") -> "Boolean":
        f = _select_fp(self, a.to_fp(), b.to_fp())
        return Boolean(self.cs, f.lc, f.value)


class UInt32:
    """32 booleans, little-endian (ark UInt32 parity; addmany used by the
    reference's signer counting, src/constraints.rs:183-187)."""

    __slots__ = ("cs", "bits", "value")
    WIDTH = 32

    def __init__(self, cs, bits, value):
        self.cs = cs
        self.bits = bits  # list[Boolean], LSB first
        self.value = value & 0xFFFFFFFF

    @staticmethod
    def constant(cs, v: int) -> "UInt32":
        return UInt32(cs, [Boolean.constant(cs, (v >> i) & 1) for i in range(32)], v)

    @staticmethod
    def alloc(cs, v: int) -> "UInt32":
        return UInt32(cs, [Boolean.alloc(cs, (v >> i) & 1) for i in range(32)], v)

    def to_fp(self) -> FpVar:
        m = self.cs.field_mod
        lc = []
        for i, b in enumerate(self.bits):
            lc = _merge(lc, b.lc, 1, (1 << i) % m, mod=m)
        return FpVar(self.cs, lc, self.value)

    @staticmethod
    def addmany(terms: list["UInt32"]) -> "UInt32":
        """Sum mod 2^32 (ark UInt32::addmany parity)."""
        cs = terms[0].cs
        m = cs.field_mod
        total = sum(t.value for t in terms)
        k = len(terms)
        carry_bits = max(1, (k - 1).bit_length())
        lc = []
        for t in terms:
            lc = _merge(lc, t.to_fp().lc, mod=m)
        with cs.suppress_tape():
            out = UInt32.alloc(cs, total & 0xFFFFFFFF)
        rhs = out.to_fp().lc
        cbs = []
        with cs.suppress_tape():
            for j in range(carry_bits):
                cb = Boolean.alloc(cs, (total >> (32 + j)) & 1)
                cbs.append(cb)
                rhs = _merge(rhs, cb.lc, 1, (1 << (32 + j)) % m, mod=m)
        cs.record(
            "bits",
            [b.lc[0][0] for b in out.bits] + [b.lc[0][0] for b in cbs],
            [lc],
            32 + carry_bits,
        )
        cs.enforce(lc, [(0, 1)], rhs)
        return out

    def xor(self, other: "UInt32") -> "UInt32":
        return UInt32(
            self.cs,
            [a.xor(b) for a, b in zip(self.bits, other.bits)],
            self.value ^ other.value,
        )

    def and_(self, other: "UInt32") -> "UInt32":
        return UInt32(
            self.cs,
            [a.and_(b) for a, b in zip(self.bits, other.bits)],
            self.value & other.value,
        )

    def not_(self) -> "UInt32":
        return UInt32(self.cs, [b.not_() for b in self.bits], ~self.value & 0xFFFFFFFF)

    def rotr(self, n: int) -> "UInt32":
        n %= 32
        bits = self.bits[n:] + self.bits[:n]
        v = ((self.value >> n) | (self.value << (32 - n))) & 0xFFFFFFFF
        return UInt32(self.cs, bits, v)

    def shr(self, n: int) -> "UInt32":
        zero = Boolean.constant(self.cs, 0)
        bits = self.bits[n:] + [zero] * n
        return UInt32(self.cs, bits, self.value >> n)


class UInt8:
    """8 booleans, little-endian (byte gadget for messages/DST)."""

    __slots__ = ("cs", "bits", "value")

    def __init__(self, cs, bits, value):
        self.cs = cs
        self.bits = bits
        self.value = value & 0xFF

    @staticmethod
    def constant(cs, v: int) -> "UInt8":
        return UInt8(cs, [Boolean.constant(cs, (v >> i) & 1) for i in range(8)], v)

    @staticmethod
    def alloc(cs, v: int) -> "UInt8":
        return UInt8(cs, [Boolean.alloc(cs, (v >> i) & 1) for i in range(8)], v)

    def to_fp(self) -> FpVar:
        m = self.cs.field_mod
        lc = []
        for i, b in enumerate(self.bits):
            lc = _merge(lc, b.lc, 1, 1 << i, mod=m)
        return FpVar(self.cs, lc, self.value)

    def xor(self, other: "UInt8") -> "UInt8":
        return UInt8(
            self.cs,
            [a.xor(b) for a, b in zip(self.bits, other.bits)],
            self.value ^ other.value,
        )

"""BlsSignatureVerifyGadget: the in-circuit BLS verification surface
(reference src/constraints.rs).

  * ParametersVar / PublicKeyVar / SignatureVar wrappers with
    constant/input/witness allocation (reference src/constraints.rs:23-68,
    :194-249)
  * verify: enforce pk != identity, hash the message in-circuit, pairing
    product e(-g1, sig) * e(pk, H(m)) == 1 (reference src/constraints.rs:
    90-128; subgroup checks are intentionally NOT enforced in-circuit,
    mirroring the comment at src/constraints.rs:101-105)
  * aggregate_verify / mapped_aggregate: bitmap-gated pk fold + set-bit
    count via UInt32 addmany (reference src/constraints.rs:149-192)
"""

from __future__ import annotations

import dataclasses

from .. import constants as C
from .system import ConstraintSystem, AllocationMode
from .gadgets import FpVar, Boolean, UInt8, UInt32
from .fields import Fp2Var
from . import curve as RC
from . import pairing as RP
from .hasher import hash_to_g2_gadget


@dataclasses.dataclass
class ParametersVar:
    """G1 generator (reference ParametersVar, src/constraints.rs:23-30)."""

    g1: RC.AffinePointVar

    @staticmethod
    def constant(cs) -> "ParametersVar":
        return ParametersVar(
            RC.AffinePointVar(
                FpVar.constant(cs, C.G1_GEN[0]),
                FpVar.constant(cs, C.G1_GEN[1]),
                Boolean.constant(cs, 0),
            )
        )

    @staticmethod
    def alloc(cs, g1=None, mode=AllocationMode.WITNESS) -> "ParametersVar":
        """Full AllocVar surface (reference src/constraints.rs:194-212):
        allocate the generator as a constant, public input, or witness —
        a prover that witnesses its parameters delegates to the G1 point
        allocator exactly as the reference delegates to G1Var::new_variable.
        `g1` is an affine (x, y) pair or None for the canonical generator."""
        if g1 is None:
            g1 = C.G1_GEN
        if mode == AllocationMode.CONSTANT and g1 == C.G1_GEN:
            return ParametersVar.constant(cs)
        return ParametersVar(RC.alloc_g1(cs, g1, mode))


def _fq_bytes_le(coord: FpVar) -> list[UInt8]:
    """Decompose one base-field coordinate into 48 LE byte gadgets."""
    cs = coord.cs
    bits = coord.to_bits_le(384)
    out = []
    for i in range(48):
        byte_bits = bits[8 * i : 8 * i + 8]
        val = sum(b.value << j for j, b in enumerate(byte_bits))
        out.append(UInt8(cs, byte_bits, val))
    return out


def _point_bytes_le(pt: RC.AffinePointVar, coords) -> list[UInt8]:
    """arkworks affine to_bytes: coordinate LE bytes then one infinity
    byte (0/1)."""
    cs = pt.cs
    out = []
    for coord in coords:
        out.extend(_fq_bytes_le(coord))
    zero = Boolean.constant(cs, 0)
    out.append(UInt8(cs, [pt.inf] + [zero] * 7, pt.inf.value))
    return out


@dataclasses.dataclass
class PublicKeyVar:
    """G1 point (reference PublicKeyVar, src/constraints.rs:33-44)."""

    pt: RC.AffinePointVar

    @staticmethod
    def alloc(cs, pk, mode=AllocationMode.WITNESS) -> "PublicKeyVar":
        return PublicKeyVar(RC.alloc_g1(cs, pk, mode))

    def is_eq(self, other: "PublicKeyVar") -> Boolean:
        """EqGadget parity (reference src/constraints.rs:251-258)."""
        both_fin = self.pt.inf.not_().and_(other.pt.inf.not_())
        eq_xy = self.pt.x.is_eq(other.pt.x).and_(self.pt.y.is_eq(other.pt.y))
        both_inf = self.pt.inf.and_(other.pt.inf)
        return both_inf.or_(both_fin.and_(eq_xy))

    def conditional_enforce_equal(self, other: "PublicKeyVar", cond: Boolean):
        """EqGadget::conditional_enforce_equal (reference
        src/constraints.rs:260-270): when cond holds the two keys must be
        equal — cond * (1 - is_eq) == 0."""
        cs = self.pt.cs
        cs.enforce(cond.lc, self.is_eq(other).not_().lc, [])

    def conditional_enforce_not_equal(self, other: "PublicKeyVar", cond: Boolean):
        """EqGadget::conditional_enforce_not_equal (reference
        src/constraints.rs:272-278): when cond holds the two keys must
        differ — cond * is_eq == 0."""
        cs = self.pt.cs
        cs.enforce(cond.lc, self.is_eq(other).lc, [])

    def to_bytes_le(self) -> list[UInt8]:
        """ToBytesGadget flavour (reference src/constraints.rs:281-287,
        arkworks affine to_bytes): little-endian x bytes, then y bytes, then
        one infinity byte (0/1) — 97 bytes total."""
        return _point_bytes_le(self.pt, (self.pt.x, self.pt.y))


@dataclasses.dataclass
class SignatureVar:
    """G2 point (reference SignatureVar, src/constraints.rs:47-68)."""

    pt: RC.AffinePointVar

    @staticmethod
    def alloc(cs, sig, mode=AllocationMode.WITNESS) -> "SignatureVar":
        return SignatureVar(RC.alloc_g2(cs, sig, mode))

    def to_bytes_le(self) -> list[UInt8]:
        """ToBytesGadget flavour for G2 (reference src/constraints.rs:289-297,
        arkworks Fp2 serialization: c0 LE bytes then c1 LE bytes per
        coordinate): x.c0 ‖ x.c1 ‖ y.c0 ‖ y.c1 ‖ infinity byte — 193 bytes."""
        x, y = self.pt.x, self.pt.y
        return _point_bytes_le(self.pt, (x.c0, x.c1, y.c0, y.c1))


class BlsSignatureVerifyGadget:
    """Reference BlsSignatureVerifyGadget (src/constraints.rs:70-192)."""

    @staticmethod
    def verify(
        cs: ConstraintSystem,
        params: ParametersVar,
        pk: PublicKeyVar,
        msg: list[UInt8],
        sig: SignatureVar,
    ) -> Boolean:
        # enforce pk is not the identity (reference src/constraints.rs:96-99)
        cs.enforce(pk.pt.inf.lc, [(0, 1)], [])
        # (subgroup checks intentionally skipped in-circuit,
        #  reference src/constraints.rs:101-105)
        neg_g1 = params.g1.negate()
        h = hash_to_g2_gadget(cs, msg)
        pairs = [
            ((neg_g1.x, neg_g1.y), (sig.pt.x, sig.pt.y), sig.pt.inf.not_()),
            ((pk.pt.x, pk.pt.y), (h.x, h.y), h.inf.not_()),
        ]
        f = RP.multi_pairing_gadget(cs, pairs)
        return RP.fp12_is_one_gadget(f)

    @staticmethod
    def mapped_aggregate(
        cs: ConstraintSystem,
        pubkeys: list[PublicKeyVar],
        bitmap: list[Boolean],
    ) -> tuple[PublicKeyVar, UInt32]:
        """Bitmap-gated fold: ret += bit ? pk_i : 0 with set-bit counting
        (reference src/constraints.rs:169-191)."""
        assert len(pubkeys) == len(bitmap)
        acc = RC.pt_infinity(pubkeys[0].pt.x)
        count = UInt32.constant(cs, 0)
        for pk, bit in zip(pubkeys, bitmap):
            added = RC.pt_add(acc, pk.pt)
            acc = added.select(bit, acc)
            # increment is the bit itself in the LSB (select(bit, 1, 0))
            inc = UInt32(
                cs, [bit] + [Boolean.constant(cs, 0)] * 31, 1 if bit.value else 0
            )
            count = UInt32.addmany([count, inc])
        return PublicKeyVar(acc), count

    @staticmethod
    def aggregate_verify(
        cs: ConstraintSystem,
        params: ParametersVar,
        pubkeys: list[PublicKeyVar],
        bitmap: list[Boolean],
        msg: list[UInt8],
        sig: SignatureVar,
    ) -> tuple[Boolean, UInt32]:
        """(reference src/constraints.rs:153-167)."""
        assert len(pubkeys) == len(bitmap)
        apk, count = BlsSignatureVerifyGadget.mapped_aggregate(cs, pubkeys, bitmap)
        ok = BlsSignatureVerifyGadget.verify(cs, params, apk, msg, sig)
        return ok, count

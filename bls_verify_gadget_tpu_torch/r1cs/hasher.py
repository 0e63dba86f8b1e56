"""In-circuit hash-to-G2 (the reference's hasher.rs capability surface):

  * expand_message_xmd over the SHA-256 gadget
    (DefaultFieldHasherWithCons::expand parity, src/hasher.rs:109-173)
  * hash_to_field: 64 BE bytes -> Fq element as a single linear combination
    (the reference's head/tail 47/17-byte recombination at
    src/hasher.rs:79-94 is an arkworks artifact; an LC with 256^i
    coefficients realises the same value mod p with zero constraints)
  * SSWU map with a *hinted* square root: allocate y and the is-square bit,
    enforce y^2 == select(e, gx1, gx2) — sound because exactly one of
    gx1, gx2 is a square (replaces the reference's in-circuit ~762-step
    exponentiation chain, src/hasher.rs:532-548, at a fraction of the rows)
  * 3-isogeny with hinted division (isogeny_map parity, src/hasher.rs:294-348)
  * Budroni-Pintore cofactor clearing (the fast method; the reference ships
    the slow h_eff scalar mul at src/hasher.rs:663-673)
"""

from __future__ import annotations

from .. import constants as C
from ..golden import field as GF
from .system import ConstraintSystem
from .gadgets import FpVar, Boolean, UInt8
from .fields import Fp2Var
from .sha256 import sha256_gadget
from . import curve as RC


def expand_message_xmd_gadget(cs, msg: list[UInt8], dst: bytes, len_in_bytes: int):
    ell = -(-len_in_bytes // 32)
    assert ell <= 255 and len(dst) <= 255
    dst_prime = [UInt8.constant(cs, b) for b in dst + bytes([len(dst)])]
    z_pad = [UInt8.constant(cs, 0) for _ in range(64)]
    lib = [UInt8.constant(cs, b) for b in len_in_bytes.to_bytes(2, "big")]
    b0 = sha256_gadget(cs, z_pad + msg + lib + [UInt8.constant(cs, 0)] + dst_prime)
    b1 = sha256_gadget(cs, b0 + [UInt8.constant(cs, 1)] + dst_prime)
    blocks = [b1]
    prev = b1
    for i in range(2, ell + 1):
        x = [a.xor(b) for a, b in zip(b0, prev)]
        prev = sha256_gadget(cs, x + [UInt8.constant(cs, i)] + dst_prime)
        blocks.append(prev)
    return [b for blk in blocks for b in blk][:len_in_bytes]


def _bytes_be_to_fp(cs, tv: list[UInt8]) -> FpVar:
    """64 big-endian byte gadgets -> FpVar via one linear combination
    (value = sum bytes * 256^i mod p, zero constraints)."""
    m = cs.field_mod
    acc = FpVar.constant(cs, 0)
    n = len(tv)
    for i, byte in enumerate(tv):
        acc = acc + byte.to_fp().scale(pow(256, n - 1 - i, m))
    return acc


def hash_to_field_gadget(cs, msg: list[UInt8], count: int = 2, dst: bytes = C.DST_G2):
    """-> count Fp2Var elements (reference hash_to_field,
    src/hasher.rs:58-107)."""
    mext = 2
    lib = count * mext * C.L_FIELD
    uniform = expand_message_xmd_gadget(cs, msg, dst, lib)
    out = []
    for i in range(count):
        coords = []
        for j in range(mext):
            off = C.L_FIELD * (j + i * mext)
            coords.append(_bytes_be_to_fp(cs, uniform[off : off + C.L_FIELD]))
        out.append(Fp2Var(coords[0], coords[1]))
    return out


def sswu_map_gadget(u: Fp2Var):
    """Branch-free SSWU to E2' with hinted sqrt (value semantics identical to
    golden sswu_map_fp2 / reference map_to_curve_9mod16)."""
    cs = u.cs
    A = Fp2Var.constant(cs, C.SSWU_A)
    B = Fp2Var.constant(cs, C.SSWU_B)
    Z = Fp2Var.constant(cs, C.SSWU_Z)
    c1 = Fp2Var.constant(cs, GF.fp2_mul(GF.fp2_neg(C.SSWU_B), GF.fp2_inv(C.SSWU_A)))
    c2 = Fp2Var.constant(cs, GF.fp2_neg(GF.fp2_inv(C.SSWU_Z)))

    tv1 = Z * u.square()
    tv2 = tv1.square() + tv1
    inv_tv2, e1 = tv2.inverse_or_zero()
    x1f = (Fp2Var.constant(cs, (1, 0)) + inv_tv2).select(e1.not_(), c2)
    x1 = c1 * x1f
    gx1 = (x1.square() + A) * x1 + B
    x2 = tv1 * x1
    gx2 = (x2.square() + A) * x2 + B  # direct eval (u == 0 safe)

    # hinted sqrt: exactly one of gx1, gx2 is square (u != 0 non-exceptional)
    gx1_val = gx1.value
    is_sq = GF.fp2_is_square(gx1_val)
    y_val = GF.fp2_sqrt(gx1_val if is_sq else gx2.value)
    with cs.suppress_tape():
        e_sq = Boolean.alloc(cs, 1 if is_sq else 0)
        y = Fp2Var.alloc(cs, y_val)
    cs.record(
        "sqrt2",
        [e_sq.lc[0][0], y.c0.lc[0][0], y.c1.lc[0][0]],
        [gx1.c0.lc, gx1.c1.lc, gx2.c0.lc, gx2.c1.lc],
    )
    target = gx1.select(e_sq, gx2)
    y.square().enforce_equal(target)
    x = x1.select(e_sq, x2)

    # sign: sgn0(y) == sgn0(u); flip via select on a hinted bit enforced by
    # the sgn0 decompositions
    su = u.sgn0()
    sy = y.sgn0()
    flip = su.xor(sy)
    y = (-y).select(flip, y)
    return x, y


def iso3_map_gadget(x: Fp2Var, y: Fp2Var):
    """3-isogeny with hinted division; returns (x', y', is_inf)."""
    cs = x.cs

    def horner(coeffs):
        acc = Fp2Var.constant(cs, coeffs[-1])
        for c in reversed(coeffs[:-1]):
            acc = acc * x + Fp2Var.constant(cs, c)
        return acc

    xn, xd, yn, yd = (
        horner(C.ISO3_XNUM),
        horner(C.ISO3_XDEN),
        horner(C.ISO3_YNUM),
        horner(C.ISO3_YDEN),
    )
    xdi, xd_zero = xd.inverse_or_zero()
    ydi, yd_zero = yd.inverse_or_zero()
    xo = xn * xdi
    yo = y * yn * ydi
    inf = xd_zero.or_(yd_zero)
    return RC.AffinePointVar(xo, yo, inf)


def map_to_curve_gadget(u: Fp2Var) -> RC.AffinePointVar:
    x, y = sswu_map_gadget(u)
    return iso3_map_gadget(x, y)


def hash_to_g2_gadget(cs, msg: list[UInt8], dst: bytes = C.DST_G2) -> RC.AffinePointVar:
    """Full in-circuit hash-to-G2 (reference hash_to_g2_with_cons,
    src/hasher.rs:727-740)."""
    u0, u1 = hash_to_field_gadget(cs, msg, 2, dst)
    q0 = map_to_curve_gadget(u0)
    q1 = map_to_curve_gadget(u1)
    r = RC.pt_add(q0, q1)
    return RC.g2_clear_cofactor(r)

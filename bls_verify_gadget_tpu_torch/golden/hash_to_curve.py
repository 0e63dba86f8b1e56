"""Golden hash-to-G2: expand_message_xmd, hash_to_field, SSWU, 3-isogeny,
cofactor clearing (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_ with the ETH2
POP ciphersuite DST); own copy of the reference package's
golden/hash_to_curve.py.

Parity: replaces the reference's native hash_to_g2 (src/bls.rs:477-493) and
is the value-level oracle for the circuit hasher (src/hasher.rs:26-740).
"""

import hashlib

from ..constants import (
    P, DST_G2, L_FIELD, SSWU_A, SSWU_B, SSWU_Z,
    ISO3_XNUM, ISO3_XDEN, ISO3_YNUM, ISO3_YDEN,
)
from . import field as F
from . import curve as cv


def sha256(data: bytes) -> bytes:
    return hashlib.sha256(data).digest()


def expand_message_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """RFC 9380 sec 5.3.1 (reference circuit version: src/hasher.rs:109-173)."""
    b_in_bytes = 32   # SHA-256 output
    s_in_bytes = 64   # SHA-256 block
    ell = -(-len_in_bytes // b_in_bytes)
    if ell > 255 or len_in_bytes > 65535 or len(dst) > 255:
        raise ValueError("expand_message_xmd bounds")
    dst_prime = dst + bytes([len(dst)])
    z_pad = bytes(s_in_bytes)
    l_i_b_str = len_in_bytes.to_bytes(2, "big")
    msg_prime = z_pad + msg + l_i_b_str + b"\x00" + dst_prime
    b0 = sha256(msg_prime)
    b1 = sha256(b0 + b"\x01" + dst_prime)
    blocks = [b1]
    prev = b1
    for i in range(2, ell + 1):
        prev = sha256(bytes(a ^ b for a, b in zip(b0, prev)) + bytes([i]) + dst_prime)
        blocks.append(prev)
    return b"".join(blocks)[:len_in_bytes]


def hash_to_field_fp2(msg: bytes, count: int = 2, dst: bytes = DST_G2):
    """RFC 9380 sec 5.2: count Fp2 elements, L=64 bytes per base element
    (reference src/hasher.rs:58-107)."""
    m = 2
    len_in_bytes = count * m * L_FIELD
    uniform = expand_message_xmd(msg, dst, len_in_bytes)
    out = []
    for i in range(count):
        coords = []
        for j in range(m):
            off = L_FIELD * (j + i * m)
            tv = uniform[off:off + L_FIELD]
            coords.append(int.from_bytes(tv, "big") % P)
        out.append(tuple(coords))
    return out


def sswu_map_fp2(u):
    """Simplified SWU map to the isogenous curve E2' (RFC 9380 sec 6.6.2).

    Returns an affine point on E2': y^2 = x^3 + A'x + B'.
    Value-level equivalent of the reference's 70-step in-circuit
    map_to_curve_9mod16 (src/hasher.rs:352-502).
    """
    A, B, Z = SSWU_A, SSWU_B, SSWU_Z
    tv1 = F.fp2_mul(Z, F.fp2_sqr(u))              # Z u^2
    tv2 = F.fp2_add(F.fp2_sqr(tv1), tv1)          # Z^2 u^4 + Z u^2
    nAinv = F.fp2_neg(F.fp2_inv(A))
    if F.fp2_is_zero(tv2):
        # exceptional case: x1 = B / (Z A)
        x1 = F.fp2_mul(B, F.fp2_inv(F.fp2_mul(Z, A)))
    else:
        # x1 = (-B/A) * (1 + 1/tv2)
        x1 = F.fp2_mul(F.fp2_mul(B, nAinv), F.fp2_add(F.FP2_ONE, F.fp2_inv(tv2)))
    gx1 = F.fp2_add(F.fp2_mul(F.fp2_add(F.fp2_sqr(x1), A), x1), B)
    if F.fp2_is_square(gx1):
        x, y = x1, F.fp2_sqrt(gx1)
    else:
        x2 = F.fp2_mul(tv1, x1)                   # Z u^2 x1
        gx2 = F.fp2_add(F.fp2_mul(F.fp2_add(F.fp2_sqr(x2), A), x2), B)
        x, y = x2, F.fp2_sqrt(gx2)
    if F.fp2_sgn0(u) != F.fp2_sgn0(y):
        y = F.fp2_neg(y)
    return (x, y)


def _eval_poly_fp2(coeffs, x):
    """Evaluate sum coeffs[i] x^i (reference DensePolynomialVar::evaluate,
    src/hasher.rs:195-206)."""
    acc = F.FP2_ZERO
    for c in reversed(coeffs):
        acc = F.fp2_add(F.fp2_mul(acc, x), c)
    return acc


def iso3_map(pt):
    """3-isogeny E2' -> E2 (reference isogeny_map, src/hasher.rs:294-348)."""
    if pt is None:
        return None
    x, y = pt
    xn = _eval_poly_fp2(ISO3_XNUM, x)
    xd = _eval_poly_fp2(ISO3_XDEN, x)
    yn = _eval_poly_fp2(ISO3_YNUM, x)
    yd = _eval_poly_fp2(ISO3_YDEN, x)
    if F.fp2_is_zero(xd) or F.fp2_is_zero(yd):
        return None
    return (
        F.fp2_mul(xn, F.fp2_inv(xd)),
        F.fp2_mul(y, F.fp2_mul(yn, F.fp2_inv(yd))),
    )


def map_to_curve_g2(u):
    """SSWU then isogeny (reference map_to_curve, src/hasher.rs:273-276)."""
    return iso3_map(sswu_map_fp2(u))


def hash_to_g2(msg: bytes, dst: bytes = DST_G2):
    """Full hash-to-curve (reference native hash_to_g2 src/bls.rs:477-493;
    circuit entry hash_to_g2_with_cons src/hasher.rs:727-740)."""
    u0, u1 = hash_to_field_fp2(msg, 2, dst)
    q0 = map_to_curve_g2(u0)
    q1 = map_to_curve_g2(u1)
    r = cv.g2_add(q0, q1)
    return cv.g2_clear_cofactor(r)

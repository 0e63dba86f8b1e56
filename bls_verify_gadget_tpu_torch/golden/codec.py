"""ZCash/ETH2 compressed point encoding and decoding on the host (own copy
of the reference package's golden/bls.py compression and decompression):
48-byte G1 and 96-byte G2 encodings with the c/b/a flag bits.  Both happen
at the host I/O boundary; the device path consumes and produces affine
points (ops/curve.py g1_decode / g2_decode)."""

from ..constants import P, B_G1, B_G2
from . import field as F

HALF_P = (P - 1) // 2


def _fp_is_largest(y: int) -> bool:
    return y > HALF_P


def _fp2_is_largest(y) -> bool:
    """Lexicographic order with the u coefficient taking priority."""
    if y[1] != 0:
        return _fp_is_largest(y[1])
    return _fp_is_largest(y[0])


def g1_compress(pt) -> bytes:
    """Affine G1 point (or None, the infinity) -> 48 bytes."""
    if pt is None:
        return bytes([0xC0]) + bytes(47)
    x, y = pt
    raw = bytearray(x.to_bytes(48, "big"))
    raw[0] |= 0x80 | (0x20 if _fp_is_largest(y) else 0)
    return bytes(raw)


def g2_compress(pt) -> bytes:
    """Affine G2 point (or None) -> 96 bytes: x1 (the u coefficient), then
    x0."""
    if pt is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), y = pt
    raw = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    raw[0] |= 0x80 | (0x20 if _fp2_is_largest(y) else 0)
    return bytes(raw)


def _decompress_flags(data: bytes, nbytes: int):
    if len(data) != nbytes:
        raise ValueError(f"expected {nbytes} bytes, got {len(data)}")
    c_flag = (data[0] >> 7) & 1
    b_flag = (data[0] >> 6) & 1
    a_flag = (data[0] >> 5) & 1
    if c_flag != 1:
        raise ValueError("compression flag must be set")
    return b_flag, a_flag


def g1_decompress(data: bytes):
    """48-byte compressed G1 -> affine point or None (infinity).  Raises
    ValueError on malformed flags, padding, out-of-range x or a point off
    the curve.  Subgroup membership is checked on the device, inside
    verify."""
    b_flag, a_flag = _decompress_flags(data, 48)
    body = bytes([data[0] & 0x1F]) + data[1:]
    x = int.from_bytes(body, "big")
    if b_flag:
        if a_flag or x != 0:
            raise ValueError("malformed infinity encoding")
        return None
    if x >= P:
        raise ValueError("x out of range")
    y = F.fp_sqrt((x * x % P * x + B_G1) % P)
    if y is None:
        raise ValueError("not on curve")
    if _fp_is_largest(y) != bool(a_flag):
        y = P - y
    return (x, y)


def g2_decompress(data: bytes):
    """96-byte compressed G2 -> affine point or None (infinity)."""
    b_flag, a_flag = _decompress_flags(data, 96)
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:96], "big")
    if b_flag:
        if a_flag or x1 != 0 or x0 != 0:
            raise ValueError("malformed infinity encoding")
        return None
    if x0 >= P or x1 >= P:
        raise ValueError("x out of range")
    x = (x0, x1)
    y = F.fp2_sqrt(F.fp2_add(F.fp2_mul(F.fp2_sqr(x), x), B_G2))
    if y is None:
        raise ValueError("not on curve")
    if _fp2_is_largest(y) != bool(a_flag):
        y = F.fp2_neg(y)
    return (x, y)

"""Golden BLS scheme (ETH2 min-pubkey-size: pk in G1, sig in G2) and its
host codecs; own copy of the reference package's golden/bls.py, with the
compressed-point parsing of golden/codec.py.

This is the host-side scheme API and the oracle for the batched device path
(models/bls.py):

  * keygen: uniform random scalar, no HKDF
  * sign:  H(m) * sk, zero sk rejected
  * verify: identity-pk check, on-curve + subgroup checks for pk and sig,
    then e(-g1, sig) * e(pk, H(m)) == 1
  * aggregate: projective sums, None for empty input
  * codecs: 48-byte G1 / 96-byte G2 ZCash compressed with c/b/a flag bits
    (golden/codec.py, plus the subgroup check here), scalars little-endian
    in 32 bytes, pairing outputs as 12 x 48 big-endian bytes
"""

import secrets

from ..constants import P, R, G1_GEN
from . import field as F
from . import curve as cv
from . import codec
from .hash_to_curve import hash_to_g2

g1_compress = codec.g1_compress
g2_compress = codec.g2_compress


class BLSError(Exception):
    """The scheme's errors (the reference's BLSError enum)."""


class InvalidSecretKey(BLSError):
    pass


class InvalidPublicKey(BLSError):
    pass


class InvalidSignature(BLSError):
    pass


# ----------------------------------------------------------------------------
# scalar codec (little-endian 32 bytes)
# ----------------------------------------------------------------------------

def sk_to_bytes(sk: int) -> bytes:
    return int(sk % R).to_bytes(32, "little")


def sk_from_bytes(data: bytes) -> int:
    if len(data) != 32:
        raise InvalidSecretKey("secret key must be 32 bytes")
    v = int.from_bytes(data, "little")
    if v >= R:
        raise InvalidSecretKey("scalar out of range")
    return v


def sk_from_hex(s: str) -> int:
    """Hex codec for the little-endian scalar encoding."""
    return sk_from_bytes(bytes.fromhex(s.removeprefix("0x")))


def sk_to_hex(sk: int) -> str:
    return sk_to_bytes(sk).hex()


def pk_from_hex(s: str):
    """48-byte compressed hex -> G1 point."""
    return g1_decompress(bytes.fromhex(s.removeprefix("0x")))


def pk_to_hex(pt) -> str:
    return g1_compress(pt).hex()


def sig_from_hex(s: str):
    """96-byte compressed hex -> G2 point."""
    return g2_decompress(bytes.fromhex(s.removeprefix("0x")))


def sig_to_hex(pt) -> str:
    return g2_compress(pt).hex()


# ----------------------------------------------------------------------------
# point decompression with the subgroup check
# ----------------------------------------------------------------------------

def g1_decompress(data: bytes, check_subgroup: bool = True):
    """48-byte compressed G1 -> affine point or None (infinity).

    Raises ValueError on every reject case of the deserialization_G1 vectors
    (flag bits, padding, out-of-range x, not on curve, not in subgroup)."""
    pt = codec.g1_decompress(data)
    if pt is not None and check_subgroup and not cv.g1_in_subgroup(pt):
        raise ValueError("not in subgroup")
    return pt


def g2_decompress(data: bytes, check_subgroup: bool = True):
    """96-byte compressed G2 -> affine point or None (infinity)."""
    pt = codec.g2_decompress(data)
    if pt is not None and check_subgroup and not cv.g2_in_subgroup(pt):
        raise ValueError("not in subgroup")
    return pt


# ----------------------------------------------------------------------------
# scheme
# ----------------------------------------------------------------------------

def keygen(rng=None):
    """Uniform random nonzero scalar (no RFC 5869 HKDF, as in the
    reference)."""
    while True:
        sk = (secrets.randbits(256) if rng is None else rng.getrandbits(256)) % R
        if sk != 0:
            return sk, sk_to_pk(sk)


def sk_to_pk(sk: int):
    """pk = g1 * sk."""
    return cv.g1_mul(G1_GEN, sk % R)


def sign(sk: int, msg: bytes):
    """sig = H(m) * sk; zero sk rejected."""
    if sk % R == 0:
        raise InvalidSecretKey("zero secret key")
    return cv.g2_mul(hash_to_g2(msg), sk % R)


def _check_pk(pk):
    if pk is None:
        raise InvalidPublicKey("identity public key")
    if not (cv.g1_is_on_curve(pk) and cv.g1_in_subgroup(pk)):
        raise InvalidPublicKey("pk fails curve/subgroup check")


def _check_sig(sig):
    if sig is not None and not (cv.g2_is_on_curve(sig) and cv.g2_in_subgroup(sig)):
        raise InvalidSignature("sig fails curve/subgroup check")


def verify(pk, msg: bytes, sig) -> bool:
    """Pairing-product verification.

    Raises BLSError subclasses for invalid inputs, as the reference's Err
    paths do; a conformance run maps errors to False."""
    from . import pairing as pr

    _check_pk(pk)
    _check_sig(sig)
    h = hash_to_g2(msg)
    prod = pr.multi_pairing([cv.g1_neg(G1_GEN), pk], [sig, h])
    return F.fp12_is_one(prod)


def aggregate_pubkeys(pks):
    """Projective sum; None for empty input."""
    if not pks:
        return None
    acc = None
    for pk in pks:
        acc = cv.g1_add(acc, pk)
    return acc


def aggregate_signatures(sigs):
    """Projective sum; None for empty input."""
    if not sigs:
        return None
    acc = None
    for s in sigs:
        acc = cv.g2_add(acc, s)
    return acc


def fast_aggregate_verify(pks, msg: bytes, sig) -> bool:
    """Aggregate pubkeys, then ordinary verify."""
    apk = aggregate_pubkeys(pks)
    if apk is None:
        raise InvalidPublicKey("empty pubkey set")
    return verify(apk, msg, sig)


def gt_to_bytes(f) -> bytes:
    """Serialize a pairing output (Fp12 element) as 12 x 48 big-endian bytes
    (coefficients in tower order c0.c0.c0, c0.c0.c1, ..., c1.c2.c1)."""
    out = bytearray()
    for c6 in f:
        for c2 in c6:
            for c in c2:
                out += int(c).to_bytes(48, "big")
    return bytes(out)


def gt_from_bytes(data: bytes):
    """Inverse of gt_to_bytes; validates field-element ranges."""
    if len(data) != 576:
        raise ValueError("GT encoding must be 576 bytes")
    vals = []
    for i in range(12):
        v = int.from_bytes(data[48 * i : 48 * i + 48], "big")
        if v >= P:
            raise ValueError("coefficient out of range")
        vals.append(v)
    return (
        ((vals[0], vals[1]), (vals[2], vals[3]), (vals[4], vals[5])),
        ((vals[6], vals[7]), (vals[8], vals[9]), (vals[10], vals[11])),
    )


def aggregate_verify(pks, msgs, sig) -> bool:
    """Distinct-message aggregate verification (IETF BLS AggregateVerify):
    e(-g1, sig) * prod_i e(pk_i, H(m_i)) == 1."""
    from . import pairing as pr

    if not pks or len(pks) != len(msgs):
        raise InvalidPublicKey("empty or mismatched pubkey/message sets")
    for pk in pks:
        _check_pk(pk)
    _check_sig(sig)
    g1s = [cv.g1_neg(G1_GEN)] + list(pks)
    g2s = [sig] + [hash_to_g2(m) for m in msgs]
    return F.fp12_is_one(pr.multi_pairing(g1s, g2s))

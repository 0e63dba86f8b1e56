"""The port's host boundary against the JAX package: the native C++ batch
codec (bls_verify_gadget_tpu_torch/native_codec.py over native/bls_host.cpp,
its constants.h generated from the port's constants.py) and the golden
host scheme (golden/bls.py over golden/curve.py, hash_to_curve.py and
pairing.py), and BatchedBLS's leading batch dims.

The 22 deserialization_G1/G2 vectors and 32 seeded points (16 per group,
half of them with their x moved off the curve or out of the subgroup) go
through both packages' native codecs and golden decompressions: the same
points and the same reject strings.  Then the compress round trips, the
hex, scalar and GT codecs, the golden scheme on two sign/ and two
fast_aggregate_verify/ vectors, the decode to device batches, and verify
on a (2, 1) batch against the flat one.  Values from
numpy.random.default_rng; points, bytes, statuses and booleans compare
exactly (tolerance 0).  About a minute on the CPU, most of it the two
CPU verifies."""

import numpy as np
import pytest
import torch

from vector_loader import load_suite, unhex
from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu import native_codec as JN
from bls_verify_gadget_tpu.golden import bls as JB
from bls_verify_gadget_tpu.golden import curve as JGC
from bls_verify_gadget_tpu.golden import field as JGF
from bls_verify_gadget_tpu_torch import native_codec as NC
from bls_verify_gadget_tpu_torch.golden import bls as gbls
from bls_verify_gadget_tpu_torch.golden import curve as GC
from bls_verify_gadget_tpu_torch.golden import field as GF
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_pubkeys, encode_scalars, encode_signatures,
)
from bls_verify_gadget_tpu_torch.native import gen_constants

GROUPS = {
    "g1": (48, NC.g1_decompress_batch, JN.g1_decompress_batch, gbls.g1_decompress,
           JB.g1_decompress),
    "g2": (96, NC.g2_decompress_batch, JN.g2_decompress_batch, gbls.g2_decompress,
           JB.g2_decompress),
}
VECTORS = [("g1", name, unhex(v["input"]["pubkey"])) for name, v in load_suite("deserialization_G1")]
VECTORS += [("g2", name, unhex(v["input"]["signature"]))
            for name, v in load_suite("deserialization_G2")]


def _seeded_blobs(group, n=16):
    """n compressed points of `group`: n - 2 from seeded scalars, every
    fourth with x + 1 (then mostly not on the curve) and every fourth, from
    the second, with its sign flag flipped; then two points on the curve
    outside the order-r subgroup."""
    rng = np.random.default_rng(7 if group == "g1" else 8)
    out = []
    for i in range(n - 2):
        k = int.from_bytes(rng.bytes(32), "little") % JC.R
        if group == "g1":
            pt = JGC.g1_mul(JC.G1_GEN, k)
            raw = bytearray(JB.g1_compress(pt))
        else:
            pt = JGC.g2_mul(JC.G2_GEN, k)
            raw = bytearray(JB.g2_compress(pt))
        if i % 4 == 0:
            raw[-1] ^= 1
        elif i % 4 == 1:
            raw[0] ^= 0x20
        out.append(bytes(raw))
    x = 0
    while len(out) < n:
        x += 1
        if group == "g1":
            y = GF.fp_sqrt((x ** 3 + JC.B_G1) % JC.P)
            if y is not None and not GC.g1_in_subgroup((x, y)):
                out.append(JB.g1_compress((x, y)))
        else:
            xx = (x, 1)
            y = GF.fp2_sqrt(GF.fp2_add(GF.fp2_mul(GF.fp2_sqr(xx), xx), JC.B_G2))
            if y is not None and not GC.g2_in_subgroup((xx, y)):
                out.append(JB.g2_compress((xx, y)))
    return out


SEEDED = [(g, f"seeded_{g}_{i}", b) for g in GROUPS for i, b in enumerate(_seeded_blobs(g))]
CASES = [pytest.param(g, b, id=name) for g, name, b in VECTORS + SEEDED]


def _leaves(x):
    return [t for c in x for t in _leaves(c)] if isinstance(x, tuple) else [x]


def _golden(fn, blob):
    try:
        return fn(blob)
    except ValueError as e:
        return f"ValueError: {e}"


def test_constants_header_comes_from_the_ports_constants():
    """The generator reads the port's constants.py, and the codec builds."""
    assert gen_constants.C.__name__ == "bls_verify_gadget_tpu_torch.constants"
    body = gen_constants.header().splitlines()
    assert f"static const uint64_t FP_P[6] = {{ {gen_constants.limbs64(JC.P)} }};" in body
    assert f"static const uint64_t ABS_X = 0x{JC.ABS_X:016x}ULL;" in body
    assert NC.available() and NC.library_path().exists()


@pytest.mark.parametrize("group,blob", CASES)
def test_native_decompress_is_the_jax_packages(group, blob):
    nbytes, port, jax_native, _, _ = GROUPS[group]
    if len(blob) != nbytes:  # the JAX codec hands these to its golden codec; the port refuses
        with pytest.raises(ValueError, match=f"takes {nbytes}-byte strings"):
            port([blob])
        return
    assert port([blob]) == jax_native([blob])


@pytest.mark.parametrize("group,blob", CASES)
def test_golden_decompress_is_the_jax_packages(group, blob):
    _, _, _, port, jax_golden = GROUPS[group]
    assert _golden(port, blob) == _golden(jax_golden, blob)
    assert _golden(lambda b: port(b, check_subgroup=False), blob) == \
        _golden(lambda b: jax_golden(b, check_subgroup=False), blob)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_batches_and_compress_round_trips(group):
    """The seeded blobs as one batch; the decoded points and the infinity
    compress back to their bytes through both codecs."""
    nbytes, port, jax_native, _, _ = GROUPS[group]
    blobs = [b for g, _, b in VECTORS + SEEDED if g == group and len(b) == nbytes]
    got = port(blobs)
    assert got == jax_native(blobs)
    pts = [p for p in got if not isinstance(p, str)]
    assert None in pts and len(pts) > 8
    compress = NC.g1_compress_batch if group == "g1" else NC.g2_compress_batch
    jcompress = JN.g1_compress_batch if group == "g1" else JN.g2_compress_batch
    golden = gbls.g1_compress if group == "g1" else gbls.g2_compress
    comp = compress(pts)
    assert comp == jcompress(pts) == [golden(p) for p in pts]
    assert port(comp) == pts
    assert compress([]) == [] and port([]) == []


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_decode_to_device_batches(group):
    """Wire bytes -> the batch encode_pubkeys / encode_signatures make of
    the golden decode, rejects as the infinity, and the codec's statuses."""
    nbytes, _, jax_native, _, jax_golden = GROUPS[group]
    blobs = [b for g, _, b in VECTORS + SEEDED if g == group and len(b) == nbytes]
    decode = NC.decode_pubkeys if group == "g1" else NC.decode_signatures
    encode = encode_pubkeys if group == "g1" else encode_signatures
    batch, status = decode(blobs, "cpu")
    pts = [_golden(jax_golden, b) for b in blobs]
    want = encode([None if isinstance(p, str) else p for p in pts], "cpu")
    assert all(torch.equal(a, b) for a, b in zip(_leaves(batch), _leaves(want)))
    reasons = {v: k for k, v in NC.REJECT_REASONS.items()}
    codes = [NC.STATUS_INF if p is None else reasons[p] if isinstance(p, str) else NC.STATUS_OK
             for p in jax_native(blobs)]
    assert status.tolist() == codes and status.dtype == torch.uint8
    assert {NC.STATUS_OK, NC.STATUS_INF} < set(codes)


def test_scalar_and_hex_codecs():
    rng = np.random.default_rng(11)
    for _ in range(8):
        sk = int.from_bytes(rng.bytes(32), "little") % JC.R
        assert gbls.sk_to_bytes(sk) == JB.sk_to_bytes(sk)
        assert gbls.sk_from_hex(gbls.sk_to_hex(sk)) == sk == JB.sk_from_hex("0x" + JB.sk_to_hex(sk))
        pk, sig = JB.sk_to_pk(sk), JGC.g2_mul(JC.G2_GEN, sk)
        assert gbls.pk_to_hex(pk) == JB.pk_to_hex(pk) and gbls.sig_to_hex(sig) == JB.sig_to_hex(sig)
        assert gbls.pk_from_hex("0x" + gbls.pk_to_hex(pk)) == pk
        assert gbls.sig_from_hex(gbls.sig_to_hex(sig)) == sig
    for bad, msg in ((JC.R.to_bytes(32, "little"), "out of range"), (bytes(31), "32 bytes")):
        with pytest.raises(gbls.InvalidSecretKey, match=msg):
            gbls.sk_from_bytes(bad)
        with pytest.raises(JB.InvalidSecretKey, match=msg):
            JB.sk_from_bytes(bad)
    assert issubclass(gbls.InvalidPublicKey, gbls.BLSError)


def test_gt_codec():
    rng = np.random.default_rng(12)
    vals = [int.from_bytes(rng.bytes(48), "little") % JC.P for _ in range(12)]
    f = tuple(tuple(tuple(vals[6 * i + 2 * j: 6 * i + 2 * j + 2]) for j in range(3))
              for i in range(2))
    raw = gbls.gt_to_bytes(f)
    assert raw == JB.gt_to_bytes(f) and len(raw) == 576
    assert gbls.gt_from_bytes(raw) == JB.gt_from_bytes(raw) == f
    bad = raw[:48 * 5] + JC.P.to_bytes(48, "big") + raw[48 * 6:]
    for codec in (gbls, JB):
        with pytest.raises(ValueError, match="coefficient out of range"):
            codec.gt_from_bytes(bad)
        with pytest.raises(ValueError, match="576 bytes"):
            codec.gt_from_bytes(raw[:-1])
    assert GF.fp12_mul(f, GF.fp12_inv(f)) == JGF.FP12_ONE


def test_golden_scheme_on_vectors():
    """sign on two sign/ vectors byte for byte, and verify of what it
    signed; fast_aggregate_verify on two fast_aggregate_verify/ vectors
    (valid, and with an extra pubkey) as they say; aggregate_verify."""
    for _, vec in list(load_suite("sign"))[:2]:
        sk = int.from_bytes(unhex(vec["input"]["privkey"]), "big")
        sig = gbls.sign(sk, unhex(vec["input"]["message"]))
        assert gbls.g2_compress(sig) == unhex(vec["output"])
        assert gbls.verify(gbls.sk_to_pk(sk), unhex(vec["input"]["message"]), sig)
    cases = {n: v for n, v in load_suite("fast_aggregate_verify")}
    for name in ("fast_aggregate_verify_valid_3d7576f3c0e3570a",
                 "fast_aggregate_verify_extra_pubkey_4f079f946446fabf"):
        vec = cases[name]
        pks = [gbls.pk_from_hex(x) for x in vec["input"]["pubkeys"]]
        sig = gbls.sig_from_hex(vec["input"]["signature"])
        msg = unhex(vec["input"]["message"])
        assert gbls.fast_aggregate_verify(pks, msg, sig) is vec["output"]
    with pytest.raises(gbls.InvalidSecretKey):
        gbls.sign(0, b"m")
    with pytest.raises(gbls.InvalidPublicKey):
        gbls.verify(None, b"m", None)
    import random

    sk1, pk1 = gbls.keygen(random.Random(1))
    sk2, pk2 = gbls.keygen(random.Random(2))
    sig = gbls.aggregate_signatures([gbls.sign(sk1, b"a"), gbls.sign(sk2, b"b")])
    assert gbls.aggregate_verify([pk1, pk2], [b"a", b"b"], sig)
    assert not gbls.aggregate_verify([pk1, pk2], [b"b", b"a"], sig)


def test_leading_batch_dims():
    """verify on a (2, 1) batch is the flat result reshaped; the keys and
    the aggregates take leading dims; operands whose batch shapes differ
    are refused by name."""
    vec = dict(load_suite("verify"))["verify_valid_case_195246ee3bd3b6ec"]["input"]
    pk = gbls.pk_from_hex(vec["pubkey"])
    sig = gbls.sig_from_hex(vec["signature"])
    msg = unhex(vec["message"])
    bls = BatchedBLS(device="cpu")
    p, s, m = (encode_pubkeys([pk, None], "cpu"), encode_signatures([sig, sig], "cpu"),
               encode_messages([msg, msg], "cpu"))

    def as21(x):
        return tuple(as21(c) for c in x) if isinstance(x, tuple) else x.reshape(2, 1, *x.shape[1:])

    flat = bls.verify(p, s, m)
    assert flat.tolist() == [True, False]
    got = bls.verify(as21(p), as21(s), as21(m))
    assert got.shape == (2, 1) and torch.equal(got, flat.reshape(2, 1))
    with pytest.raises(ValueError, match=r"pk_aff \[\(2, 1\)\], sig_aff \[\(2,\)\]"):
        bls.verify(as21(p), s, m)

    sk = encode_scalars([3, 5, 7, 11], "cpu")
    pk_flat = bls.derive_pubkeys(sk)
    pk22 = bls.derive_pubkeys(sk.reshape(2, 2, 16))
    assert all(torch.equal(a.reshape(4, 24), b) for a, b in zip(pk22, pk_flat))
    rows = bls.aggregate_pubkeys(pk22, axis=-1)
    for i in range(2):
        row = bls.aggregate_pubkeys(tuple(c[2 * i: 2 * i + 2] for c in pk_flat))
        assert all(torch.equal(a[i], b) for a, b in zip(rows, row))
    bits = torch.tensor([[1, 0], [3, -1]], dtype=torch.int32)
    msum, count = bls.aggregate_pubkeys_masked(pk22, bits, axis=1)
    assert count.tolist() == [1, 2] and msum[0].shape == (2, 24)
    with pytest.raises(ValueError, match="bitmap"):
        bls.aggregate_pubkeys_masked(pk22, bits[0], axis=1)
    with pytest.raises(ValueError, match="not a batch axis"):
        bls.aggregate_pubkeys(pk22, axis=2)

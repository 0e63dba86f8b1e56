"""Two reference behaviours of the port pinned against the JAX package and
the vendored vectors, on the CPU: SHA-256 and expand_message_xmd at the
JAX package's message lengths (tests/test_sha256.py) and on the RFC 9380
vectors, and the 22 deserialization_G1/G2 vectors through the port's codec
and its device-side point checks (models/bls.py _point_checks).  Bytes and
booleans compare exactly."""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.ops.hash_to_g2 import expand_message_xmd as jax_xmd
from bls_verify_gadget_tpu.ops.sha256 import sha256_bytes as jax_sha256
from bls_verify_gadget_tpu_torch.golden import codec
from bls_verify_gadget_tpu_torch.models.bls import (
    _point_checks, encode_pubkeys, encode_signatures,
)
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops.sha256 import sha256_bytes
from vector_loader import VECTOR_DIR, unhex

RFC_DST = b"QUUX-V01-CS02-with-expander-SHA256-128"
RFC_VECTORS = [  # RFC 9380 K.1, len_in_bytes = 0x20 (tests/test_sha256.py)
    (b"", "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235"),
    (b"abc", "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"),
    (b"abcdef0123456789", "eff31487c770a893cfb36f912fbfcbff40d5661771ca4b2cb4eafe524333f5c1"),
]


def rows(t):
    return [bytes(int(v) for v in r) for r in np.asarray(t).tolist()]


@pytest.mark.parametrize("length", [0, 3, 32, 55, 56, 64, 143])
def test_sha256_and_xmd_match_jax(length):
    """The port's sha256_bytes and expand_message_xmd (256 bytes, DST_G2)
    equal the JAX package's jitted functions and hashlib on two seeded
    messages of each length the JAX package tests."""
    msgs = np.random.default_rng(60 + length).integers(0, 256, size=(2, length), dtype=np.uint32)
    m = torch.from_numpy(msgs.astype(np.int64))
    want = [hashlib.sha256(bytes(r.astype(np.uint8))).digest() for r in msgs]
    assert rows(sha256_bytes(m, length)) == want
    assert rows(jax.jit(lambda d: jax_sha256(d, length))(jnp.asarray(msgs))) == want
    xmd = rows(H.expand_message_xmd(m, length, JC.DST_G2, 256))
    assert xmd == rows(jax.jit(lambda d: jax_xmd(d, length, JC.DST_G2, 256))(jnp.asarray(msgs)))
    assert all(len(x) == 256 for x in xmd)


def test_xmd_rfc_vectors():
    for msg, want in RFC_VECTORS:
        m = torch.tensor([list(msg)], dtype=torch.int64).reshape(1, len(msg))
        assert rows(H.expand_message_xmd(m, len(msg), RFC_DST, 0x20)) == [bytes.fromhex(want)]


def test_deserialization_vectors_through_the_port():
    """Each vector decodes with golden/codec.py or raises; the points that
    decode go through _point_checks (on the curve and in the subgroup) in
    one CPU batch per group.  A vector's output is True exactly when its
    point decodes and is the infinity or passes the checks; the three that
    decode but lie outside the subgroup come out False on the device."""
    decoded, got, want = {"G1": [], "G2": []}, {}, {}
    for group, key, decode in (("G1", "pubkey", codec.g1_decompress),
                               ("G2", "signature", codec.g2_decompress)):
        for path in sorted((VECTOR_DIR / f"deserialization_{group}").glob("*.json")):
            vec = json.loads(path.read_text())
            name = f"{group}/{path.stem}"
            want[name] = vec["output"]
            try:
                point = decode(unhex(vec["input"][key]))
            except ValueError:
                got[name] = False
                continue
            if point is None:
                got[name] = True
            else:
                decoded[group].append((name, point))
    pk_ok, sig_ok = _point_checks(
        encode_pubkeys([p for _, p in decoded["G1"]], device="cpu"),
        encode_signatures([p for _, p in decoded["G2"]], device="cpu"))
    for group, ok in (("G1", pk_ok), ("G2", sig_ok)):
        got.update({name: bool(v) for (name, _), v in zip(decoded[group], ok.tolist())})
    assert len(got) == 22
    assert got == want
    rejected = {name for g in decoded for name, _ in decoded[g] if not got[name]}
    assert rejected == {"G1/deserialization_fails_infinity_with_false_b_flag",
                        "G1/deserialization_fails_not_in_G1",
                        "G2/deserialization_fails_not_in_G2"}

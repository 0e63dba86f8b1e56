"""The port's mixed-length message path and its xmd kernel, on the CPU:
SHA-256 and expand_message_xmd with per-element lengths against the JAX
package's jitted sha256_bytes_var / expand_message_xmd(lens=) /
hash_to_field_fp2(lens=) and hashlib; a Python-int model of
csrc/xmd_kernels.cu (its tables, and each thread's block assembly and b_i
chain) against the plain version, and the word flags of chip_smoke.py's
xmd bound on that model; BatchedBLS hash_stage, sign and verify with
msg_lens; encode_messages_var and the refusal of bad lengths.

Bytes and limbs compare exactly (tolerance 0).  The JAX functions here are
small jitted graphs (a few seconds to compile); the slice as a whole runs
on the port alone (see test_mixed_sign_then_verify).  ~1.5 min on one CPU
process, most of it the two end-to-end tests."""

import hashlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_reference_pins import RFC_DST, RFC_VECTORS
from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.golden import hash_to_curve as GH
from bls_verify_gadget_tpu.ops.hash_to_g2 import expand_message_xmd as jax_xmd
from bls_verify_gadget_tpu.ops.hash_to_g2 import hash_to_field_fp2 as jax_h2f
from bls_verify_gadget_tpu.ops.sha256 import sha256_bytes_var as jax_sha256_var
from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch.convert import limbs_to_numpy
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_messages_var, encode_pubkeys, encode_scalars,
)
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops.fp import FP
from bls_verify_gadget_tpu_torch.ops.sha256 import (
    _compress, bytes_to_padded_words, sha256_bytes_var,
)

# message lengths at which a padded SHA-256 input or XMD's msg' (64 + len
# + 47 bytes with DST_G2) gains a block: 55/56, 119/120 and 8/9, 72/73,
# 136/137, 200/201
EDGE_LENS = (0, 1, 8, 9, 55, 56, 63, 64, 72, 73, 119, 120, 136, 137, 200)
WIDTH = 200
# RFC 9380 K.1's two longer messages, len_in_bytes = 0x20
RFC_LONG = [
    (b"q128_" + b"q" * 128, "b23a1d2b4d97b2ef7785562a7e8bac7eed54ed6e97e29aa51bfe3f12ddad1ff9"),
    (b"a512_" + b"a" * 512, "4623227bcc01293b8c130bf771da8c298dede7383243dc0993d2d94823958c4c"),
]
M32 = 0xFFFFFFFF
CU = K.CSRC_DIR / "xmd_kernels.cu"


def rows(t):
    return [bytes(int(v) for v in r) for r in np.asarray(t).tolist()]


def edge_batch(seed):
    """The edge lengths as one batch: seeded bytes, padded to WIDTH with
    seeded bytes too (a path that read past a length would show)."""
    data = np.random.default_rng(seed).integers(0, 256, size=(len(EDGE_LENS), WIDTH))
    return data.astype(np.uint8), np.array(EDGE_LENS, np.int32)


def test_sha256_bytes_var_matches_jax_and_hashlib():
    data, lens = edge_batch(80)
    got = rows(sha256_bytes_var(torch.from_numpy(data), torch.from_numpy(lens), WIDTH))
    want = [hashlib.sha256(bytes(r[:n])).digest() for r, n in zip(data, lens)]
    assert got == want
    jit = jax.jit(lambda d, n: jax_sha256_var(d, n, WIDTH))
    assert rows(jit(jnp.asarray(data, jnp.uint32), jnp.asarray(lens, jnp.uint32))) == want


def test_xmd_lens_matches_jax_and_the_fixed_length_path():
    """expand_message_xmd(lens=) (DST_G2, 256 bytes) equals the JAX
    package's jitted expand_message_xmd(lens=) on the same batch, and each
    element equals the fixed-length path on its own bytes."""
    data, lens = edge_batch(81)
    got = H.expand_message_xmd(torch.from_numpy(data), WIDTH, JC.DST_G2, 256,
                               lens=torch.from_numpy(lens))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(EDGE_LENS), 256)
    jit = jax.jit(lambda d, n: jax_xmd(d, WIDTH, JC.DST_G2, 256, lens=n))
    assert rows(got) == rows(jit(jnp.asarray(data, jnp.uint32), jnp.asarray(lens, jnp.uint32)))
    for row, n, out in zip(data, lens, rows(got)):
        fixed = H.expand_message_xmd(torch.from_numpy(row[None, :n].copy()), int(n), JC.DST_G2, 256)
        assert rows(fixed) == [out]


def test_xmd_rfc_vectors_as_one_mixed_batch():
    """RFC 9380 K.1 (len_in_bytes 0x20): the three vectors that
    tests/test_torch_reference_pins.py runs one by one, and the 133- and
    517-byte messages, through the lens path in one batch."""
    vectors = RFC_VECTORS + RFC_LONG
    msg, lens, width = encode_messages_var([m for m, _ in vectors], device="cpu")
    got = H.expand_message_xmd(msg, width, RFC_DST, 0x20, lens=lens)
    assert rows(got) == [bytes.fromhex(want) for _, want in vectors]


def cu_table(name):
    """The hex words of the array `name` in csrc/xmd_kernels.cu."""
    body = re.search(rf"{name}\[\d+\] = \{{(.*?)\}};", CU.read_text(), re.S)[1]
    return [int(x, 16) for x in re.findall(r"0x[0-9a-fA-F]+", body)]


def test_kernel_tables_are_the_plain_versions():
    """The kernel's round constants and initial state are SHA-256's, its
    midstate is the plain compression of a zero block, and its table sizes
    are xmd_table's."""
    assert cu_table("kSha256K") == list(C.SHA256_K)
    assert cu_table("kSha256IV") == list(C.SHA256_IV)
    mid = _compress(torch.tensor(C.SHA256_IV), torch.zeros(16, dtype=torch.int64))
    assert cu_table("kZeroPadMidstate") == mid.tolist()
    sizes = re.search(r"kExtWords = (\d+), kTmplWords = (\d+);", CU.read_text()).groups()
    assert tuple(map(int, sizes)) == (H.XMD_EXT_WORDS, H.XMD_TMPL_WORDS)


def model_compress(s, block):
    """One compression as the kernel runs it: the schedule in a 16-word
    window, overwritten in place."""
    def rotr(x, n):
        return ((x >> n) | (x << (32 - n))) & M32

    w = list(block)
    a, b, c, d, e, f, g, h = s
    for t in range(64):
        if t >= 16:
            w15, w2 = w[(t - 15) & 15], w[(t - 2) & 15]
            w[t & 15] = (w[t & 15] + (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3))
                         + w[(t - 7) & 15] + (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10))) & M32
        t1 = (h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g))
              + C.SHA256_K[t] + w[t & 15]) & M32
        t2 = ((rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)))) & M32
        h, g, f, e, d, c, b, a = g, f, e, (d + t1) & M32, c, b, a, (t1 + t2) & M32
    return [(x + y) & M32 for x, y in zip(s, (a, b, c, d, e, f, g, h))]


class KernelModel:
    """One thread of xmd_kernel on Python ints, reading the table that the
    wrapper hands the kernel (xmd_table) as the kernel reads it from shared
    memory: bytes in memory order, then words."""

    def __init__(self, dst, len_in_bytes):
        table, self.tlen, self.nbi = H.xmd_table(dst, len_in_bytes, "cpu")
        words = [w & M32 for w in table.tolist()]
        self.ext = b"".join(w.to_bytes(4, "little") for w in words[:H.XMD_EXT_WORDS])
        self.tmpl = words[H.XMD_EXT_WORDS:]
        self.len_in_bytes = len_in_bytes

    def b0_blocks(self, row, n):
        """b0_block for blk = 1 .. nb - 1: byte q past Z_pad is row[q]
        while q < n, else ext[q - n] (inside the staged table); the final
        block ends with the bit length."""
        total = 64 + n + self.tlen
        nb = (total + 8) // 64 + 1
        blocks = []
        for blk in range(1, nb):
            w = []
            for i in range(16):
                word = 0
                for j in range(4):
                    q = (blk - 1) * 64 + 4 * i + j
                    assert q < n or q - n < len(self.ext)
                    word = (word << 8) | (row[q] if q < n else self.ext[q - n])
                w.append(word)
            if blk == nb - 1:
                w[14], w[15] = (8 * total) >> 32, (8 * total) & M32
            blocks.append(w)
        return blocks

    def bi_blocks(self, x, i):
        """b_i's blocks: x = b0 ^ b_{i-1} and the counter in the first, the
        rest from the template."""
        first = list(x) + [(i << 24) | self.tmpl[8]] + self.tmpl[9:16]
        return [first] + [self.tmpl[16 * blk : 16 * blk + 16] for blk in range(1, self.nbi)]

    def xmd(self, row, n):
        b0 = cu_table("kZeroPadMidstate")
        for blk in self.b0_blocks(row, n):
            b0 = model_compress(b0, blk)
        prev, out = [0] * 8, b""
        for i in range(1, -(-self.len_in_bytes // 32) + 1):
            s = list(C.SHA256_IV)
            for blk in self.bi_blocks([u ^ v for u, v in zip(b0, prev)], i):
                s = model_compress(s, blk)
            prev = s
            out += b"".join(v.to_bytes(4, "big") for v in s)
        return out[: self.len_in_bytes]


def padded_words(data: bytes):
    """The plain version's padded SHA-256 blocks of `data` as int lists."""
    t = torch.tensor(list(data), dtype=torch.int64)
    return bytes_to_padded_words(t, len(data)).tolist()


@pytest.mark.parametrize("dst, len_in_bytes", [(JC.DST_G2, 256), (RFC_DST, 0x20),
                                               (bytes(range(1, 256)), 77), (b"", 33)],
                         ids=["DST_G2", "RFC", "255-byte DST", "empty DST"])
def test_kernel_model_matches_the_plain_version(dst, len_in_bytes):
    """For every edge length, the model's block assembly equals the plain
    padded buffers block for block (b0 past its zero first block, and each
    b_i), and its output equals xmd_plain and hashlib's XMD: the widest DST
    (a 259-byte tail, 5 blocks per b_i), an empty one, and outputs that are
    not a multiple of 32 bytes."""
    model = KernelModel(dst, len_in_bytes)
    tail = len_in_bytes.to_bytes(2, "big") + b"\x00" + dst + bytes([len(dst)])
    data, lens = edge_batch(82)
    plain = rows(H.xmd_plain(torch.from_numpy(data), torch.from_numpy(lens), dst, len_in_bytes))
    for row, n, want in zip(data.tolist(), lens.tolist(), plain):
        ref = padded_words(bytes(64) + bytes(row[:n]) + tail)
        assert ref[0] == [0] * 16
        assert model.b0_blocks(row, n) == ref[1:]
        x = list(range(1, 9))
        xb = b"".join(v.to_bytes(4, "big") for v in x)
        assert model.bi_blocks(x, 7) == padded_words(xb + bytes([7]) + dst + bytes([len(dst)]))
        got = model.xmd(row, n)
        assert got == want == GH.expand_message_xmd(bytes(row[:n]), dst, len_in_bytes)


def test_hash_to_field_lens_matches_jax():
    """hash_to_field_fp2(lens=) equals the JAX package's jitted
    hash_to_field_fp2(lens=) limb for limb."""
    data, lens = edge_batch(83)
    got = H.hash_to_field_fp2(torch.from_numpy(data), WIDTH, 2, JC.DST_G2,
                              lens=torch.from_numpy(lens))
    jit = jax.jit(lambda d, n: jax_h2f(d, WIDTH, 2, JC.DST_G2, lens=n))
    want = jit(jnp.asarray(data, jnp.uint32), jnp.asarray(lens, jnp.uint32))
    for (g0, g1), (w0, w1) in zip(got, want):
        np.testing.assert_array_equal(limbs_to_numpy(g0), np.asarray(w0))
        np.testing.assert_array_equal(limbs_to_numpy(g1), np.asarray(w1))


def test_bytes_be_to_fp_widens_uint8():
    """The kernel's uint8 bytes give the limbs of the int64 bytes (a uint8
    byte shifted by 8 would wrap): the Montgomery form of the 512-bit
    big-endian value mod p."""
    tv = np.random.default_rng(84).integers(0, 256, size=(5, 64))
    tv[0], tv[1] = 255, 0
    a = H._bytes_be_to_fp(torch.from_numpy(tv.astype(np.uint8)))
    assert torch.equal(a, H._bytes_be_to_fp(torch.from_numpy(tv.astype(np.int64))))
    assert FP.decode(a) == [int.from_bytes(bytes(r), "big") % C.P for r in tv.tolist()]


MIXED = [b"", bytes(range(32)), bytes(range(100, 177))]  # lengths 0, 32, 77


def test_mixed_hash_stage_matches_fixed_length_and_golden():
    """BatchedBLS(device="cpu").hash_stage with msg_lens on three messages
    of lengths 0, 32 and 77 equals, element by element, each message's own
    fixed-length hash stage and the JAX package's golden hash_to_g2.  The
    fixed-length stage runs its first part (XMD + hash_to_field) per
    message at the message's own width and the later parts, which work
    element by element, once on the three stacked outputs."""
    bls = BatchedBLS(device="cpu")
    msg, lens, width = encode_messages_var(MIXED, device="cpu")
    got = bls.hash_stage(msg, width, msg_lens=lens)
    parts = [bls.hash_parts(len(m)) for m in MIXED]
    us = [p[0][1](encode_messages([m], device="cpu")) for p, m in zip(parts, MIXED)]
    x = [tuple(torch.cat([u[i][j] for u in us]) for j in range(2)) for i in range(2)]
    for _, part in parts[0][1:]:
        x = part(x)
    for g, w in zip(_flat(got), _flat(x)):
        assert torch.equal(g, w)
    (x0, x1), (y0, y1), inf = got
    assert not inf.any()
    dec = [((a, b), (c, d)) for a, b, c, d in zip(*(FP.decode(t) for t in (x0, x1, y0, y1)))]
    assert dec == [GH.hash_to_g2(m) for m in MIXED]


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return [x]


def test_mixed_sign_then_verify():
    """sign(msg_lens=) then verify(msg_lens=) on the three messages: true
    for all three, and false for each with its length off by one (one
    verify batch of six).  The JAX package's whole verify with msg_lens is
    not jitted here: it would compile a new multi-minute XLA program in a
    test run that its clock already cuts.  The public keys come from the
    JAX package's golden scheme.  test_hash_to_field_lens_matches_jax
    holds the mixed-length part to JAX, and the per-element equality with
    the fixed-length path above, which
    tests/test_torch_verify.py::test_stages_match_jax_staged_pipeline holds
    to JAX's staged verify, closes the chain."""
    bls = BatchedBLS(device="cpu")
    msg, lens, width = encode_messages_var(MIXED, device="cpu")
    keys = [3, 0x1234567, C.R - 2]
    sig, valid = bls.sign(encode_scalars(keys, device="cpu"), msg, width, msg_lens=lens)
    assert valid.tolist() == [True] * 3
    pk = encode_pubkeys([gbls.sk_to_pk(k) for k in keys], device="cpu")
    sig = CV.pt_to_affine(CV.FP2_OPS, sig)
    off = torch.where(lens < width, lens + 1, lens - 1)

    def twice(t):
        return tuple(twice(v) for v in t) if isinstance(t, tuple) else torch.cat([t, t])

    out = bls.verify(twice(pk), twice(sig), twice(msg), width, msg_lens=torch.cat([lens, off]))
    assert out.tolist() == [True] * 3 + [False] * 3


def test_encode_messages_var():
    msg, lens, width = encode_messages_var([b"ab", b"", b"xyz"], device="cpu")
    assert width == 3 and msg.dtype == torch.uint8 and lens.dtype == torch.int32
    assert msg.tolist() == [[97, 98, 0], [0, 0, 0], [120, 121, 122]]
    assert lens.tolist() == [2, 0, 3]
    msg, lens, width = encode_messages_var([b"ab"], pad_to=5, device="cpu")
    assert width == 5 and msg.tolist() == [[97, 98, 0, 0, 0]] and lens.tolist() == [2]
    with pytest.raises(ValueError, match="longer than pad_to"):
        encode_messages_var([b"abc"], pad_to=2, device="cpu")


def test_lengths_outside_the_width_are_refused():
    msg = torch.zeros(2, 4, dtype=torch.uint8)
    for bad in ([0, 5], [-1, 2]):
        with pytest.raises(ValueError, match="lengths must lie in 0..4"):
            K.xmd(msg, torch.tensor(bad, dtype=torch.int32), JC.DST_G2, 256)
    with pytest.raises(ValueError, match="expected lens"):
        K.xmd(msg, torch.tensor([1, 2, 3], dtype=torch.int32), JC.DST_G2, 256)
    bls = BatchedBLS(device="cpu")
    with pytest.raises(ValueError, match="msg_lens must be"):
        bls.hash_stage(msg, 4, msg_lens=torch.tensor([1, 2, 3]))
    with pytest.raises(ValueError, match="msg_len 3"):
        bls.hash_stage(msg, 3, msg_lens=torch.tensor([1, 2]))


def test_bound_counts_only_what_differs_between_messages():
    """chip_smoke.py's bound for xmd counts no instruction for a word that
    is the same for every message of a length: its flags hold for the
    kernel model's blocks of two different messages at each edge length;
    a compression that differs everywhere counts 1,384 instructions, a
    shared block on a varying state 904, a shared one on a shared state
    none."""
    import chip_smoke as CS

    model = KernelModel(JC.DST_G2, 256)
    data, lens = edge_batch(83)
    other, _ = edge_batch(84)
    for n in lens.tolist():
        flags = CS.xmd_b0_flags(n, model.tlen)
        a, b = model.b0_blocks(data[0].tolist(), n), model.b0_blocks(other[0].tolist(), n)
        assert len(flags) == len(a) == len(b)
        for fl, wa, wb in zip(flags, a, b):
            assert all(f or x == y for f, x, y in zip(fl, wa, wb))
            assert all(x != y for f, x, y in zip(fl, wa, wb) if f)
    assert CS.sha_compression_ops([1] * 8, [1] * 16) == (CS.OPS_PER_COMPRESSION, [1] * 8)
    assert CS.sha_compression_ops([1] * 8, [0] * 16)[0] == 64 * 14 + 8
    assert CS.sha_compression_ops([0] * 8, [0] * 16) == (0, [0] * 8)
    per_32 = CS.xmd_element_ops(32, model.tlen, model.nbi, 8)
    assert per_32 < 18 * CS.OPS_PER_COMPRESSION - 9 * 480
    assert CS.xmd_element_ops(0, model.tlen, model.nbi, 8) == 0

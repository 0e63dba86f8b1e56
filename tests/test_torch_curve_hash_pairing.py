"""The port's curve, hash-to-G2 and pairing layers
(bls_verify_gadget_tpu_torch/ops/{curve,sha256,hash_to_g2,pairing}.py)
against the JAX package's python-int golden/ oracle.

Everything runs on the CPU (plain versions of the kernels).  Scalars come
from numpy.random.default_rng; field elements are integers and are
compared exactly (tolerance 0)."""

import hashlib

import numpy as np
import torch

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import curve as GC
from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu.golden import hash_to_curve as GH
from bls_verify_gadget_tpu.golden import pairing as GP
from bls_verify_gadget_tpu_torch.models.bls import encode_messages
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops import pairing as PR
from bls_verify_gadget_tpu_torch.ops import tower as T
from bls_verify_gadget_tpu_torch.ops.sha256 import sha256_bytes


def scalars(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % JC.R for _ in range(n)]


def g1_off_subgroup():
    """An on-curve G1 point outside the prime-order subgroup."""
    for x in range(1, 100):
        y = GF.fp_sqrt((x**3 + 4) % JC.P)
        if y is not None and not GC.g1_in_subgroup((x, y)):
            return (x, y)
    raise AssertionError("no point found")


def g2_off_subgroup():
    for x0 in range(1, 100):
        x = (x0, 1)
        y = GF.fp2_sqrt(GF.fp2_add(GF.fp2_mul(GF.fp2_sqr(x), x), JC.B_G2))
        if y is not None and not GC.g2_in_subgroup((x, y)):
            return (x, y)
    raise AssertionError("no point found")


def test_g1_add_double_mul_match_golden():
    a, b = scalars(31, 2)
    p, q = GC.g1_mul(JC.G1_GEN, a), GC.g1_mul(JC.G1_GEN, b)
    P = CV.g1_encode_batch([p, q, p, None], "cpu")
    Q = CV.g1_encode_batch([q, q, GC.g1_neg(p), p], "cpu")
    got = CV.g1_decode(CV.pt_add(CV.FP_OPS, P, Q))
    assert got == [GC.g1_add(p, q), GC.g1_add(q, q), None, p]
    assert CV.g1_decode(CV.pt_double(CV.FP_OPS, P)) == [
        GC.g1_add(p, p), GC.g1_add(q, q), GC.g1_add(p, p), None]
    k = 0xD201000000010000
    assert CV.g1_decode(CV.pt_mul_const(CV.FP_OPS, P, k)) == [
        GC.g1_mul(p, k), GC.g1_mul(q, k), GC.g1_mul(p, k), None]


def test_g1_subgroup_check_matches_golden():
    a, b = scalars(32, 2)
    pts = [GC.g1_mul(JC.G1_GEN, a), g1_off_subgroup(), GC.g1_mul(JC.G1_GEN, b), None]
    got = CV.g1_in_subgroup(CV.g1_encode_batch(pts, "cpu")).tolist()
    assert got == [True, False, True, True]
    assert got == [GC.g1_in_subgroup(p) for p in pts]


def test_g2_subgroup_check_matches_golden():
    (a,) = scalars(33, 1)
    pts = [GC.g2_mul(JC.G2_GEN, a), g2_off_subgroup(), None, JC.G2_GEN]
    got = CV.g2_in_subgroup(CV.g2_encode_batch(pts, "cpu")).tolist()
    assert got == [True, False, True, True]
    assert got == [GC.g2_in_subgroup(p) for p in pts]


def test_sha256_and_xmd_match_golden():
    rng = np.random.default_rng(34)
    msgs = [rng.bytes(32), rng.bytes(32)]
    m = encode_messages(msgs, device="cpu")
    digest = sha256_bytes(m, 32)
    assert [bytes(r) for r in digest.tolist()] == [hashlib.sha256(x).digest() for x in msgs]
    out = H.expand_message_xmd(m, 32, JC.DST_G2, 256)
    assert [bytes(r) for r in out.tolist()] == [
        GH.expand_message_xmd(x, JC.DST_G2, 256) for x in msgs]
    u0, u1 = H.hash_to_field_fp2(m, 32)
    got = list(zip(zip(*T.fp2_decode(u0)), zip(*T.fp2_decode(u1))))
    assert got == [tuple(GH.hash_to_field_fp2(x)) for x in msgs]


def test_hash_to_g2_matches_golden():
    rng = np.random.default_rng(35)
    msgs = [rng.bytes(32), bytes(32)]
    h = H.hash_to_g2(encode_messages(msgs, device="cpu"), 32)
    assert CV.g2_decode(h) == [GH.hash_to_g2(x) for x in msgs]


def test_pairing_matches_golden():
    """final_exponentiation(multi_miller_loop(...)) on two pairs, with the
    second pair masked off in one element, against golden multi_pairing."""
    a, b, c, d = scalars(36, 4)
    p1 = [GC.g1_mul(JC.G1_GEN, a), GC.g1_mul(JC.G1_GEN, b)]
    q1 = [GC.g2_mul(JC.G2_GEN, c), JC.G2_GEN]
    p2 = [GC.g1_neg(JC.G1_GEN), GC.g1_mul(JC.G1_GEN, d)]
    q2 = [GC.g2_mul(JC.G2_GEN, a), GC.g2_mul(JC.G2_GEN, c)]
    valid2 = torch.tensor([True, False])

    def aff1(ps):
        x, y, _ = CV.g1_encode_batch(ps, "cpu")
        return (x, y)

    def aff2(qs):
        x, y, _ = CV.g2_encode_batch(qs, "cpu")
        return (x, y)

    f = PR.multi_miller_loop([
        (aff1(p1), aff2(q1), torch.tensor([True, True])),
        (aff1(p2), aff2(q2), valid2),
    ])
    got = T.fp12_decode(PR.final_exponentiation(f))
    got = [
        tuple(tuple((c6[k][0][i], c6[k][1][i]) for k in range(3)) for c6 in got)
        for i in range(2)
    ]
    want = [
        GP.multi_pairing([p1[0], p2[0]], [q1[0], q2[0]]),
        GP.multi_pairing([p1[1]], [q1[1]]),
    ]
    assert got == want

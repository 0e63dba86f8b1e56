"""The port's step-wise pairing configuration (bls_verify_gadget_tpu_torch
utils/config.py: fuse_miller and fuse_expx off): the mul014, dbl_step,
add_step and cyclo_sqr kernels through their wrappers on CPU tensors, i.e.
their plain versions, against the JAX package's jnp compositions under
jax.jit (on the CPU the JAX package runs no Pallas kernel, so these are
what its kernels are held to); the step-wise Miller loop and exp-by-x
chain against the fused ones, which tests/test_torch_pairing_kernels.py
and tests/test_torch_verify.py hold to JAX; verify and
aggregate_verify_distinct end to end with both flags off.

Batch 4 (8 for two stacked pairs); field values from
numpy.random.default_rng, points from the JAX golden scheme.  Limbs and
booleans are compared exactly (tolerance 0).  No JAX Miller loop, final
exponentiation or verify is jitted (multi-minute CPU compiles); the plain
Miller loops, the CPU verify and the two aggregate verifications take
most of its ~2 minutes on one CPU process."""

import collections

import jax
import numpy as np
import pytest
import torch

import op_counts
from vector_loader import load_suite, unhex
from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu.ops import pairing as JPR
from bls_verify_gadget_tpu.ops import tower as JT
from bls_verify_gadget_tpu.ops.fp import FP as JFP
from bls_verify_gadget_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from bls_verify_gadget_tpu_torch.golden import codec
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_pubkeys, encode_signatures,
)
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops import pairing as PR
from bls_verify_gadget_tpu_torch.ops import tower as T
from bls_verify_gadget_tpu_torch.ops.fp import FP
from bls_verify_gadget_tpu_torch.utils.config import config
from bls_verify_gadget_tpu_torch.utils.profiling import count_ops

B = 4
# port launches per verify batch by kernel: the default configuration and
# the step-wise one (63 doublings, 5 set bits of |x|, two pairs; five
# x-chains of 6 runs and 5 set bits each)
FUSED_CALLS = {"mul": 15, "add": 13, "sub": 29, "fp2_mul": 24, "fp2_sqr": 1, "fp6_mul": 2,
               "fp12_mul": 9, "fp12_sqr": 1, "miller_dbl_run": 6, "miller_add": 5, "exp_x": 5,
               "pow_win": 2, "pt_mul_const": 3, "g2_cofactor": 1, "sswu_map2": 1, "xmd": 1}
STEP_CALLS = {**{k: v for k, v in FUSED_CALLS.items()
                 if k not in ("miller_dbl_run", "miller_add", "exp_x")},
              "fp12_sqr": 64, "fp12_mul": 34, "dbl_step": 63, "add_step": 5, "mul014": 136,
              "cyclo_sqr": 30}


def rand_fp(rng, n=B):
    """n canonical Fp values as the JAX package's uint32 Montgomery limbs."""
    return np.asarray(JFP.encode([int.from_bytes(rng.bytes(48), "little") % JC.P
                                  for _ in range(n)]))


def port(coords):
    """JAX-side coordinate arrays -> one packed (c, N, 24) CPU tensor."""
    return limbs_from_numpy(np.stack([np.asarray(c) for c in coords]), device="cpu")


def assert_same(got, want_coords):
    np.testing.assert_array_equal(
        limbs_to_numpy(got), np.stack([np.asarray(c) for c in want_coords])
    )


def count_calls(monkeypatch):
    """Counter of the kernel wrappers' calls (on the CPU, each call is one
    launch on the card)."""
    calls = collections.Counter()
    for name in K.KERNELS:
        wrapper = getattr(K, name)

        def shim(*args, _wrapper=wrapper, _name=name):  # xmd's first argument is no field
            calls[_name] += 1
            return _wrapper(*args)

        monkeypatch.setattr(K, name, shim)
    return calls


def golden_pairs(k, rng, n=B):
    """k pairs of n golden (G1, G2) points, pair i rotated by i, with mixed
    valid masks: [(xp, yp), (xq, yq), valid] as JAX-side numpy limbs."""
    sks = [int(rng.integers(1, 2**62)) for _ in range(n)]
    g1s = [gbls.sk_to_pk(sk) for sk in sks]
    g2s = [gbls.sign(sk, b"step-wise pairing test") for sk in sks]

    def enc(vals):
        return np.asarray(JFP.encode(vals))

    pairs = []
    for i in range(k):
        a, b = g1s[i:] + g1s[:i], g2s[i:] + g2s[:i]
        pairs.append((
            (enc([p[0] for p in a]), enc([p[1] for p in a])),
            ((enc([q[0][0] for q in b]), enc([q[0][1] for q in b])),
             (enc([q[1][0] for q in b]), enc([q[1][1] for q in b]))),
            np.array([(j + i) % 3 != 0 for j in range(n)]),
        ))
    return pairs


@pytest.mark.parametrize("line", ["mixed", "neutral"])
def test_mul014_matches_jax(line):
    """mul014 on a random f and random lines, neutral where the mask is
    false (the port's glue, the JAX package's _neutral_line), against
    fp12_mul_by_014; an all-neutral line leaves f's limbs as they are."""
    rng = np.random.default_rng(51)
    f = [rand_fp(rng) for _ in range(12)]
    c = [rand_fp(rng) for _ in range(6)]
    valid = np.array([True, False, True, True]) if line == "mixed" else np.zeros(B, bool)

    @jax.jit
    def ref(f, c, valid):
        lines = JPR._neutral_line((c[0], c[1]), (c[2], c[3]), (c[4], c[5]), valid)
        return JT._flat12(JPR.fp12_mul_by_014(JT._unflat12(f), *lines))

    want = ref(f, c, valid)
    lines = torch.where(torch.from_numpy(valid)[:, None], port(c), PR.neutral_line(B, "cpu"))
    got = K.mul014(FP, port(f), lines)
    assert_same(got, want)
    if line == "neutral":
        assert torch.equal(got, port(f))


@pytest.mark.parametrize("stacked", [False, True], ids=["per_pair", "stacked"])
def test_dbl_and_add_step_match_jax(stacked):
    """A doubling step from T = (xq, yq, 1), then a mixed addition of Q,
    for two pairs of golden points: each pair at 4 elements, or both
    stacked at 8 as the step-wise Miller loop runs them, against the JAX
    package's _dbl_step and _add_step per pair (T and the line)."""
    rng = np.random.default_rng(52)
    pairs = golden_pairs(2, rng)
    one, zero = np.asarray(JFP.encode([1] * B)), np.asarray(JFP.encode([0] * B))
    jdbl, jadd = jax.jit(JPR._dbl_step), jax.jit(JPR._add_step)
    want_dbl, want_add = [], []
    for (xp, yp), q, _ in pairs:
        t1, l1 = jdbl((q[0], q[1], (one, zero)), xp, yp)
        t2, l2 = jadd(t1, q, xp, yp)
        want_dbl.append([c for x in (*t1, *l1) for c in x])
        want_add.append([c for x in (*t2, *l2) for c in x])

    def ports(i):
        (xp, yp), q, _ = pairs[i]
        t = port([*q[0], *q[1], one, zero])
        return t, port([*q[0], *q[1]]), port([xp, yp])

    if stacked:
        t, q, p = (torch.cat(x, 1) for x in zip(ports(0), ports(1)))
        out_dbl = K.dbl_step(FP, t, p)
        out_add = K.add_step(FP, out_dbl[:6], q, p)
        assert_same(out_dbl, [np.concatenate(c) for c in zip(*want_dbl)])
        assert_same(out_add, [np.concatenate(c) for c in zip(*want_add)])
    else:
        for i in range(2):
            t, q, p = ports(i)
            out_dbl = K.dbl_step(FP, t, p)
            assert_same(out_dbl, want_dbl[i])
            assert_same(K.add_step(FP, out_dbl[:6], q, p), want_add[i])


def golden_fp12(rng, cyclotomic):
    """A random golden Fp12, or one in the cyclotomic subgroup: the easy
    part f^((p^6 - 1)(p^2 + 1)) of a random one."""
    ints = [int.from_bytes(rng.bytes(48), "little") % JC.P for _ in range(12)]
    f2 = [(ints[2 * i], ints[2 * i + 1]) for i in range(6)]
    f = (tuple(f2[:3]), tuple(f2[3:]))
    if cyclotomic:
        f = GF.fp12_mul(GF.fp12_frob(f, 6), GF.fp12_inv(f))
        f = GF.fp12_mul(GF.fp12_frob(f, 2), f)
    return f


def golden_coords(fs):
    """Golden Fp12 values -> 12 coordinate arrays of JAX-side limbs."""
    flat = [[c for f6 in f for f2 in f6 for c in f2] for f in fs]
    return [np.asarray(JFP.encode([row[j] for row in flat])) for j in range(12)]


@pytest.mark.parametrize("count", [1, 3])
def test_cyclo_sqr_matches_jax(count):
    """cyclo_sqr on two random Fp12 (the Granger-Scott formula, not a
    square) and two cyclotomic ones, against fp12_cyclotomic_sqr_k; on the
    cyclotomic ones it equals `count` golden squares."""
    rng = np.random.default_rng(53)
    fs = [golden_fp12(rng, cyclotomic=i >= 2) for i in range(B)]
    f = golden_coords(fs)
    want = jax.jit(JT.fp12_cyclotomic_sqr_k, static_argnums=1)(JT._unflat12(f), count)
    got = K.cyclo_sqr(FP, port(f), count)
    assert_same(got, JT._flat12(want))
    cols = FP.decode(got)  # [coordinate][element]
    for j, g in enumerate(fs[2:], 2):
        for _ in range(count):
            g = GF.fp12_sqr(g)
        f2 = [(cols[2 * i][j], cols[2 * i + 1][j]) for i in range(6)]
        assert (tuple(f2[:3]), tuple(f2[3:])) == g


@pytest.mark.parametrize("k", [1, 2])
def test_step_miller_loop_matches_fused(k, monkeypatch):
    """multi_miller_loop with config.fuse_miller off (k = 2: the pairs
    stacked as verify's; k = 1: aggregate_verify_distinct's one pair) on
    golden points with mixed valid masks: the same limbs as the fused loop,
    through 63 dbl_step, 5 add_step, 63 fp12_sqr and 68k mul014 calls."""
    rng = np.random.default_rng(54)

    def tensors(x):
        if isinstance(x, tuple):
            return tuple(tensors(c) for c in x)
        return limbs_from_numpy(x, device="cpu")

    pairs = [(tensors(p), tensors(q), torch.from_numpy(v))
             for p, q, v in golden_pairs(k, rng)]
    fused = T.fp12_pack(PR.multi_miller_loop(pairs))
    calls = count_calls(monkeypatch)
    monkeypatch.setattr(config, "fuse_miller", False)
    step = T.fp12_pack(PR.multi_miller_loop(pairs))
    assert torch.equal(step, fused)
    assert dict(calls) == {"fp12_sqr": 63, "dbl_step": 63, "add_step": 5, "mul014": 68 * k,
                           "sub": 1}


def test_step_exp_by_neg_x_matches_fused(monkeypatch):
    """_exp_by_neg_x with config.fuse_expx off (cyclo_sqr per run of |x|,
    fp12_mul per set bit) gives the fused exp_x chain's limbs on random
    Fp12."""
    rng = np.random.default_rng(55)
    m = T.fp12_unpack(port([rand_fp(rng) for _ in range(12)]))
    fused = T.fp12_pack(PR._exp_by_neg_x(m))
    calls = count_calls(monkeypatch)
    monkeypatch.setattr(config, "fuse_expx", False)
    assert torch.equal(T.fp12_pack(PR._exp_by_neg_x(m)), fused)
    assert dict(calls) == {"cyclo_sqr": 6, "fp12_mul": 5, "sub": 1}


def test_step_verify_matches_vectors(monkeypatch):
    """BatchedBLS.verify with both flags off on two valid verify vectors,
    the second with a tampered message and the first with an identity pk:
    True, True, False, False, through STEP_CALLS (424 kernel calls); the
    op counter over the call holds the JAX package's count of a step-wise
    verify per element (tests/data/jax_op_counts.json)."""
    valid = [(codec.g1_decompress(unhex(v["input"]["pubkey"])),
              codec.g2_decompress(unhex(v["input"]["signature"])), unhex(v["input"]["message"]))
             for _, v in load_suite("verify") if v["output"]][:2]
    (pk0, sig0, msg0), (pk1, sig1, msg1) = valid
    tampered = bytes([msg1[0] ^ 1]) + msg1[1:]
    cases = [(pk0, sig0, msg0), (pk1, sig1, msg1), (pk1, sig1, tampered), (None, sig0, msg0)]
    monkeypatch.setattr(config, "fuse_miller", False)
    monkeypatch.setattr(config, "fuse_expx", False)
    calls = count_calls(monkeypatch)
    with count_ops() as counter:
        out = BatchedBLS(device="cpu").verify(
            encode_pubkeys([c[0] for c in cases], device="cpu"),
            encode_signatures([c[1] for c in cases], device="cpu"),
            encode_messages([c[2] for c in cases], device="cpu"), 32)
    assert out.tolist() == [True, True, False, False]
    assert dict(calls) == STEP_CALLS and sum(calls.values()) == 424
    op_counts.assert_jax_counts(counter, "verify_stepwise", len(cases))


def test_step_aggregate_verify_distinct(monkeypatch):
    """aggregate_verify_distinct with both flags off over 3 (pk, msg) pairs
    and their aggregated signature: true, and false with two messages
    swapped, as the JAX package's golden aggregate_verify decides."""
    rng = np.random.default_rng(56)
    sks = [int.from_bytes(rng.bytes(32), "little") % JC.R for _ in range(3)]
    pks = [gbls.sk_to_pk(k) for k in sks]
    msgs = [bytes([7 + i]) * 32 for i in range(3)]
    agg = gbls.aggregate_signatures([gbls.sign(k, m) for k, m in zip(sks, msgs)])
    monkeypatch.setattr(config, "fuse_miller", False)
    monkeypatch.setattr(config, "fuse_expx", False)
    bls = BatchedBLS(device="cpu")
    pk, sig = encode_pubkeys(pks, device="cpu"), encode_signatures([agg], device="cpu")
    for m, want in ((msgs, True), ([msgs[1], msgs[0], msgs[2]], False)):
        got = bls.aggregate_verify_distinct(pk, sig, encode_messages(m, device="cpu"))
        assert got.shape == ()
        assert bool(got) == gbls.aggregate_verify(pks, m, agg) == want

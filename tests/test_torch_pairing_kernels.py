"""The port's pairing kernels (bls_verify_gadget_tpu_torch/ops/kernels.py
fp6_mul, fp12_mul, fp12_sqr, miller_dbl_run, miller_add, exp_x) through their
wrappers on CPU tensors, i.e. their plain versions, against the JAX
package's jnp compositions under jax.jit (on the CPU the JAX package runs
no Pallas kernel, so these are the references its fused kernels are held
to).

Batch 4; field elements from numpy.random.default_rng, points from the
JAX golden scheme; limbs are compared exactly (tolerance 0).  The JAX
compiles take most of the time: ~20 s for the Miller references, a few
seconds for the others."""

import jax
import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.ops import pairing as JPR
from bls_verify_gadget_tpu.ops import tower as JT
from bls_verify_gadget_tpu.ops.fp import FP as JFP
from bls_verify_gadget_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops import tower as T
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops.fp import FP

B = 4
PAIRS = 2


def rand_fp(rng, n=B):
    """n canonical Fp values as the JAX package's uint32 Montgomery limbs."""
    return np.asarray(JFP.encode([int.from_bytes(rng.bytes(48), "little") % JC.P
                                  for _ in range(n)]))


def rand_fp12(rng):
    """A random Fp12 as 12 (B, 24) coordinate arrays, coefficient-major."""
    return [rand_fp(rng) for _ in range(12)]


def port(coords):
    """JAX-side coordinate arrays -> one packed (c, B, 24) CPU tensor."""
    return limbs_from_numpy(np.stack([np.asarray(c) for c in coords]), device="cpu")


def assert_same(got, want_coords):
    np.testing.assert_array_equal(
        limbs_to_numpy(got), np.stack([np.asarray(c) for c in want_coords])
    )


@pytest.mark.parametrize("op", ["mul", "sqr"])
def test_fp12_kernels_match_jax(op):
    rng = np.random.default_rng(41)
    a, b = rand_fp12(rng), rand_fp12(rng)
    if op == "mul":
        want = jax.jit(JT.fp12_mul)(JT._unflat12(a), JT._unflat12(b))
        got = K.fp12_mul(FP, port(a), port(b))
    else:
        want = jax.jit(JT.fp12_sqr)(JT._unflat12(a))
        got = K.fp12_sqr(FP, port(a))
    assert_same(got, JT._flat12(want))


def test_fp6_mul_kernel_matches_jax():
    """fp6_mul on packed (6, B, 24) operands, and the port's fp6_mul_pairs,
    which stacks its k = 2 pairs into one fp6_mul call, against the JAX
    package's fp6_mul_pairs (its composition on the CPU)."""
    rng = np.random.default_rng(44)
    a, b, c = ([rand_fp(rng) for _ in range(6)] for _ in range(3))

    def fp6(coords):
        return tuple((coords[2 * i], coords[2 * i + 1]) for i in range(3))

    def flat6(x):
        return [t for f2 in x for t in f2]

    want = jax.jit(JT.fp6_mul_pairs)([(fp6(a), fp6(b)), (fp6(c), fp6(a))])
    assert_same(K.fp6_mul(FP, port(a), port(b)), flat6(want[0]))
    tensors = [fp6(port(x).unbind(0)) for x in (a, b, c)]
    got = T.fp6_mul_pairs([(tensors[0], tensors[1]), (tensors[2], tensors[0])])
    for g, w in zip(got, want):
        assert_same(torch.stack(flat6(g)), flat6(w))


def test_miller_dbl_run_and_add_match_jax():
    """miller_dbl_run with k = 2 pairs and count = 2, then miller_add, on
    G1/G2 points of the golden scheme with a mixed valid mask, against the
    jnp composition (tests/test_pallas.py builds the same reference for the
    JAX kernels): f and both T's after the run and after the block."""
    rng = np.random.default_rng(42)
    sks = [int(rng.integers(1, 2**62)) for _ in range(B)]
    g1s = [gbls.sk_to_pk(sk) for sk in sks]
    g2s = [gbls.sign(sk, b"miller run test") for sk in sks]

    def enc(vals):
        return np.asarray(JFP.encode(vals))

    xp, yp = enc([p[0] for p in g1s]), enc([p[1] for p in g1s])
    xq = (enc([q[0][0] for q in g2s]), enc([q[0][1] for q in g2s]))
    yq = (enc([q[1][0] for q in g2s]), enc([q[1][1] for q in g2s]))
    one, zero = enc([1] * B), enc([0] * B)
    valids = [np.array([(j + i) % 3 != 0 for j in range(B)]) for i in range(PAIRS)]
    f0 = rand_fp12(rng)
    # pair 1 takes the G1 and G2 points rotated by one, so the two pairs'
    # lines and T's differ
    rot, rot2 = g1s[1:] + g1s[:1], g2s[1:] + g2s[:1]
    qs = [(xq, yq), ((enc([q[0][0] for q in rot2]), enc([q[0][1] for q in rot2])),
                     (enc([q[1][0] for q in rot2]), enc([q[1][1] for q in rot2])))]
    xps = [xp, enc([p[0] for p in rot])]
    yps = [yp, enc([p[1] for p in rot])]
    ts0 = [(q[0], q[1], (one, zero)) for q in qs]

    @jax.jit
    def dbl_iter(f, ts):
        f = JT.fp12_sqr(f)
        out = []
        for i in range(PAIRS):
            tn, line = JPR._dbl_step(ts[i], xps[i], yps[i])
            f = JPR.fp12_mul_by_014(f, *JPR._neutral_line(*line, valids[i]))
            out.append(tn)
        return f, tuple(out)

    @jax.jit
    def add_block(f, ts):
        out = []
        for i in range(PAIRS):
            tn, line = JPR._add_step(ts[i], qs[i], xps[i], yps[i])
            f = JPR.fp12_mul_by_014(f, *JPR._neutral_line(*line, valids[i]))
            out.append(tn)
        return f, tuple(out)

    f, ts = JT._unflat12(f0), tuple(ts0)
    for _ in range(2):
        f, ts = dbl_iter(f, ts)
    f_run, ts_run = f, ts
    f_add, ts_add = add_block(f, ts)

    def t_coords(ts):
        return [c for t in ts for f2 in t for c in f2]

    pf = port(f0)
    pt = port(t_coords(ts0)).view(PAIRS, 6, B, 24)
    pxp, pyp = port(xps), port(yps)
    pq = port([c for q in qs for f2 in q for c in f2]).view(PAIRS, 4, B, 24)
    pvalid = torch.from_numpy(np.stack(valids))
    f1, t1 = K.miller_dbl_run(FP, pf, pt, pxp, pyp, pvalid, 2)
    assert not torch.equal(t1[0], t1[1])
    assert_same(f1, JT._flat12(f_run))
    assert_same(t1.reshape(-1, B, 24), t_coords(ts_run))
    f2, t2 = K.miller_add(FP, f1, t1, pq, pxp, pyp, pvalid)
    assert_same(f2, JT._flat12(f_add))
    assert_same(t2.reshape(-1, B, 24), t_coords(ts_add))


def test_exp_x_matches_jax():
    """exp_x over the runs of |x| against the JAX package's _exp_by_neg_x,
    conjugated back.  On the CPU that is the cmov scan from f = 1, which
    computes the same sequence from f = m, so the comparison is exact on
    random (not cyclotomic) inputs."""
    rng = np.random.default_rng(43)
    m = rand_fp12(rng)
    want = jax.jit(lambda x: JT.fp12_conj(JPR._exp_by_neg_x(x)))(JT._unflat12(m))
    assert CV.X_SEGMENTS == [(1, True), (2, True), (3, True), (9, True), (32, True), (16, False)]
    assert_same(K.exp_x(FP, port(m), CV.X_SEGMENTS), JT._flat12(want))

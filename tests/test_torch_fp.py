"""The port's Fp/Fr ops (bls_verify_gadget_tpu_torch/ops/fp.py) against the
JAX package: its jnp path and its Pallas field kernels in interpret mode.

Everything runs on the CPU, so each wrapper runs its kernel's plain
PyTorch version.  Inputs come from numpy.random.default_rng; limbs are
integers and are compared exactly (tolerance 0)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.ops.fp import FP as JFP, FR as JFR
from bls_verify_gadget_tpu.ops.pallas.kernels import FieldKernels
from bls_verify_gadget_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops.fp import FP, FR
from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_ints

FIELDS = {"fp": (FP, JFP), "fr": (FR, JFR)}


def rand_limbs(rng, shape, field):
    """Canonical values < m as uint32 limbs, edge values in the first rows:
    0, 1, m-1, m-2, R mod m."""
    n = field.nlimb
    x = rng.integers(0, 1 << 16, size=shape + (n,), dtype=np.int64)
    x[..., n - 1] = rng.integers(0, field.modulus >> (16 * (n - 1)), size=shape)
    m = field.modulus
    edges = ints_to_limbs([0, 1, m - 1, m - 2, field.mont_r % m], n)
    flat = x.reshape(-1, n)
    flat[: len(edges)] = edges[: len(flat)]
    return flat.reshape(x.shape).astype(np.uint32)


def port(a):
    return limbs_from_numpy(a, device="cpu")


def same(port_out, jax_out):
    return np.array_equal(limbs_to_numpy(port_out), np.asarray(jax_out))


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_mul_add_sub_neg_match_jnp(name):
    F, JF = FIELDS[name]
    rng = np.random.default_rng(11)
    a, b = rand_limbs(rng, (37,), F), rand_limbs(rng, (37,), F)
    b = np.roll(b, 2, axis=0)
    assert same(F.mul(port(a), port(b)), JF.mul(a, b))
    assert same(F.add(port(a), port(b)), JF.add(a, b))
    assert same(F.sub(port(a), port(b)), JF.sub(a, b))
    assert same(F.neg(port(a)), JF.neg(a))
    m = F.modulus
    xs, ys = F.decode(port(a)), F.decode(port(b))
    assert F.decode(F.mul(port(a), port(b))) == [x * y % m for x, y in zip(xs, ys)]


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_inv_matches_jnp(name):
    F, JF = FIELDS[name]
    a = rand_limbs(np.random.default_rng(12), (6,), F)
    got = F.inv(port(a))
    assert same(got, JF.inv(a))
    xs = F.decode(port(a))
    assert F.decode(got) == [pow(x, F.modulus - 2, F.modulus) for x in xs]


def test_mul_operands_below_2p_match_jnp():
    """Raw sums a + b < 2p (the Karatsuba operands of the fp2 kernels) and
    full-width 384-bit values against R^2 (the hash_to_field folding)."""
    rng = np.random.default_rng(13)
    a, b = rand_limbs(rng, (32,), FP), rand_limbs(rng, (32,), FP)
    s = FP.propagate(port(a) + port(b))
    s_np = limbs_to_numpy(s)
    assert limbs_to_ints(s_np) == [
        x + y for x, y in zip(limbs_to_ints(a), limbs_to_ints(b))
    ]
    assert max(limbs_to_ints(s_np)) >= JC.P  # some operands really exceed p
    assert same(FP.mul(s, port(b)), JFP.mul(s_np, b))
    assert same(FP.mul(s, s), JFP.mul(s_np, s_np))
    full = rng.integers(0, 1 << 16, size=(32, 24)).astype(np.uint32)
    r2 = np.broadcast_to(np.asarray(JFP.R2), (32, 24))
    assert same(FP.mul(port(full), FP.const("R2", "cpu")), JFP.mul(full, r2))


def test_stacked_shapes_match_jnp():
    """(k, B, nlimb) stacked operands and broadcasting, the tower's layout."""
    rng = np.random.default_rng(14)
    a, b = rand_limbs(rng, (3, 16), FP), rand_limbs(rng, (3, 16), FP)
    c = rand_limbs(rng, (16,), FP)
    assert same(FP.mul(port(a), port(b)), JFP.mul(a, b))
    assert same(FP.add(port(a), port(c)), JFP.add(a, c))
    assert same(FP.sub(port(c), port(a)), JFP.sub(c, a))


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_match_pallas_kernels_interpret(name):
    """The port's mul/add/sub against the JAX package's Pallas field
    kernels (FieldKernels, tile 128) run in interpret mode."""
    F, JF = FIELDS[name]
    KJ = FieldKernels(JF, tile=128)
    rng = np.random.default_rng(15)
    a, b = rand_limbs(rng, (130,), F), rand_limbs(rng, (130,), F)
    b = np.roll(b, 1, axis=0)
    with pltpu.force_tpu_interpret_mode():
        mul, add, sub = KJ.mul(a, b), KJ.add(a, b), KJ.sub(a, b)
    assert same(F.mul(port(a), port(b)), mul)
    assert same(F.add(port(a), port(b)), add)
    assert same(F.sub(port(a), port(b)), sub)


def test_mul_below_2p_matches_pallas_interpret():
    rng = np.random.default_rng(16)
    a, b = rand_limbs(rng, (64,), FP), rand_limbs(rng, (64,), FP)
    s = FP.propagate(port(a) + port(b))
    with pltpu.force_tpu_interpret_mode():
        want = FieldKernels(JFP, tile=128).mul(limbs_to_numpy(s), b)
    assert same(FP.mul(s, port(b)), want)


def test_helpers_match_jnp():
    rng = np.random.default_rng(17)
    a = rand_limbs(rng, (8,), FP)
    assert same(FP.mul_small(port(a), 3), JFP.mul_small(a, 3))
    assert same(FP.from_mont(port(a)), JFP.from_mont(a))
    assert same(FP.to_mont(port(a)), JFP.to_mont(a))
    sq = FP.sqr(port(a))
    root = FP.sqrt_3mod4(sq)
    assert bool(FP.eq(FP.sqr(root), sq).all())


def test_cpu_tensors_take_the_plain_version():
    """On the CPU a wrapper runs the plain version and counts no launch;
    a tensor on any other device than the CPU or a card raises."""
    a = port(rand_limbs(np.random.default_rng(18), (4,), FP))
    K.COUNTS.reset()
    assert torch.equal(K.mul(FP, a, a), FP.mul_plain(a, a))
    assert torch.equal(K.add(FP, a, a), FP.add_plain(a, a))
    assert torch.equal(K.sub(FP, a, a), FP.sub_plain(a, a))
    assert sum(K.COUNTS.launches.values()) == 0
    with pytest.raises(ValueError):
        K.mul(FP, a.to("meta"), a.to("meta"))

"""The port's tower (bls_verify_gadget_tpu_torch/ops/tower.py) against the
JAX package: Fp2 products and squares against its jnp path and its Pallas
fp2 kernels in interpret mode; Fp6/Fp12 against its golden/field.py.

Everything runs on the CPU (plain versions of the kernels).  Inputs come
from numpy.random.default_rng; integers are compared exactly (tolerance 0)."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu.ops import tower as JT
from bls_verify_gadget_tpu.ops.fp import FP as JFP
from bls_verify_gadget_tpu.ops.pallas.kernels import FieldKernels
from bls_verify_gadget_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from bls_verify_gadget_tpu_torch.ops import tower as T

B = 4


def rand_fp(rng, shape):
    """Canonical Fp values as uint32 limbs (edge values in the first rows)."""
    x = rng.integers(0, 1 << 16, size=shape + (24,), dtype=np.int64)
    x[..., 23] = rng.integers(0, JC.P >> 368, size=shape)
    flat = x.reshape(-1, 24)
    edges = [0, 1, JC.P - 1, JC.P - 2]
    for i, e in enumerate(edges[: len(flat)]):
        flat[i] = [(e >> (16 * j)) & 0xFFFF for j in range(24)]
    return flat.reshape(x.shape).astype(np.uint32)


def port(a):
    return limbs_from_numpy(a, device="cpu")


def same(p, j):
    return np.array_equal(limbs_to_numpy(p), np.asarray(j))


def ints(rng, n=B):
    return [int.from_bytes(rng.bytes(48), "little") % JC.P for _ in range(n)]


def rfp2(rng, n=B):
    return list(zip(ints(rng, n), ints(rng, n)))


def rfp6(rng):
    return [tuple(zip(ints(rng), ints(rng))) for _ in range(3)]


def enc6(cols):
    """cols: 3 lists (one per Fp6 coefficient) of B Fp2 ints -> device."""
    return tuple(T.fp2_encode_batch(c, "cpu") for c in cols)


def dec6(d):
    cols = [list(zip(*T.fp2_decode(d[i]))) for i in range(3)]
    return [tuple(cols[i][j] for i in range(3)) for j in range(B)]


def golden6(cols):
    return [tuple(cols[i][j] for i in range(3)) for j in range(B)]


def rfp12(rng):
    return (rfp6(rng), rfp6(rng))


def enc12(x):
    return (enc6(x[0]), enc6(x[1]))


def dec12(d):
    return list(zip(dec6(d[0]), dec6(d[1])))


def golden12(x):
    return list(zip(golden6(x[0]), golden6(x[1])))


def test_fp2_mul_pairs_and_sqr_many_match_jnp():
    """Three stacked Fp2 products with one broadcast operand, and three
    stacked squares, against the JAX jnp tower."""
    rng = np.random.default_rng(21)
    a = [(rand_fp(rng, (B,)), rand_fp(rng, (B,))) for _ in range(3)]
    b = [(rand_fp(rng, (B,)), rand_fp(rng, (B,))) for _ in range(2)]
    b.append((rand_fp(rng, ()), rand_fp(rng, ())))  # broadcast constant
    pa = [(port(x), port(y)) for x, y in a]
    pb = [(port(x), port(y)) for x, y in b]
    got = T.fp2_mul_pairs(list(zip(pa, pb)))
    want = JT.fp2_mul_pairs(list(zip(a, b)))
    for g, w in zip(got, want):
        assert same(g[0], w[0]) and same(g[1], w[1])
    got = T.fp2_sqr_many(pa)
    want = JT.fp2_sqr_many(a)
    for g, w in zip(got, want):
        assert same(g[0], w[0]) and same(g[1], w[1])


def test_fp2_kernels_match_pallas_interpret():
    rng = np.random.default_rng(22)
    a0, a1, b0, b1 = (rand_fp(rng, (130,)) for _ in range(4))
    b0, b1 = np.roll(b0, 1, axis=0), np.roll(b1, 2, axis=0)
    KJ = FieldKernels(JFP, tile=128)
    with pltpu.force_tpu_interpret_mode():
        m0, m1 = KJ.fp2_mul(a0, a1, b0, b1)
        s0, s1 = KJ.fp2_sqr(a0, a1)
    (c0, c1), = T.fp2_mul_pairs([((port(a0), port(a1)), (port(b0), port(b1)))])
    assert same(c0, m0) and same(c1, m1)
    (d0, d1), = T.fp2_sqr_many([(port(a0), port(a1))])
    assert same(d0, s0) and same(d1, s1)


def test_fp2_plain_versions_match_golden():
    rng = np.random.default_rng(23)
    xs, ys = rfp2(rng), rfp2(rng)
    a, b = T.fp2_encode_batch(xs, "cpu"), T.fp2_encode_batch(ys, "cpu")
    got = list(zip(*T.fp2_decode(T.fp2_mul_plain(*a, *b))))
    assert got == [GF.fp2_mul(x, y) for x, y in zip(xs, ys)]
    got = list(zip(*T.fp2_decode(T.fp2_sqr_plain(*a))))
    assert got == [GF.fp2_sqr(x) for x in xs]


def test_fp2_misc_match_golden():
    rng = np.random.default_rng(24)
    xs = rfp2(rng)
    a = T.fp2_encode_batch(xs, "cpu")
    assert list(zip(*T.fp2_decode(T.fp2_inv(a)))) == [GF.fp2_inv(x) for x in xs]
    assert list(zip(*T.fp2_decode(T.fp2_mul_xi(a)))) == [GF.fp2_mul_xi(x) for x in xs]
    assert list(zip(*T.fp2_decode(T.fp2_conj(a)))) == [GF.fp2_conj(x) for x in xs]
    assert T.fp2_sgn0(a).tolist() == [GF.fp2_sgn0(x) for x in xs]


def test_fp6_mul_inv_frob_match_golden():
    rng = np.random.default_rng(25)
    x, y = rfp6(rng), rfp6(rng)
    a, b = enc6(x), enc6(y)
    gx, gy = golden6(x), golden6(y)
    assert dec6(T.fp6_mul(a, b)) == [GF.fp6_mul(u, v) for u, v in zip(gx, gy)]
    assert dec6(T.fp6_inv(a)) == [GF.fp6_inv(u) for u in gx]
    assert dec6(T.fp6_frob(a, 1)) == [GF.fp6_frob(u, 1) for u in gx]


@pytest.mark.parametrize("op", ["mul", "sqr", "conj", "frob1", "frob2", "frob6"])
def test_fp12_ops_match_golden(op):
    rng = np.random.default_rng(26)
    x, y = rfp12(rng), rfp12(rng)
    a, b = enc12(x), enc12(y)
    gx, gy = golden12(x), golden12(y)
    if op == "mul":
        got, want = T.fp12_mul(a, b), [GF.fp12_mul(u, v) for u, v in zip(gx, gy)]
    elif op == "sqr":
        got, want = T.fp12_sqr(a), [GF.fp12_sqr(u) for u in gx]
    elif op == "conj":
        got, want = T.fp12_conj(a), [GF.fp12_conj(u) for u in gx]
    else:
        k = int(op[4:])
        got, want = T.fp12_frob(a, k), [GF.fp12_frob(u, k) for u in gx]
    assert dec12(got) == want


def test_fp12_inv_cyclotomic_sqr_is_one():
    rng = np.random.default_rng(27)
    x = rfp12(rng)
    a = enc12(x)
    gx = golden12(x)
    inv = T.fp12_inv(a)
    assert dec12(inv) == [GF.fp12_inv(u) for u in gx]
    # project into the cyclotomic subgroup: g = f^((p^6-1)(p^2+1))
    g = T.fp12_mul(T.fp12_frob(a, 6), inv)
    g = T.fp12_mul(T.fp12_frob(g, 2), g)
    gg = [GF.fp12_mul(GF.fp12_frob(u, 6), GF.fp12_inv(u)) for u in gx]
    gg = [GF.fp12_mul(GF.fp12_frob(u, 2), u) for u in gg]
    assert dec12(g) == gg
    gs = T.fp12_unpack(T.fp12_cyclotomic_sqr_plain(T.fp12_pack(g)))
    assert dec12(gs) == [GF.fp12_cyclotomic_sqr(u) for u in gg]
    assert dec12(gs) == [GF.fp12_sqr(u) for u in gg]
    one = T.fp12_mul(a, inv)
    assert T.fp12_is_one(one).tolist() == [True] * B
    assert T.fp12_is_one(a).tolist() == [False] * B
    assert isinstance(one[0][0][0], torch.Tensor)

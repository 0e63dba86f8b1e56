"""The port's hash-stage and subgroup kernels (bls_verify_gadget_tpu_torch/
ops/kernels.py pow_win, sswu_map2, g2_cofactor, pt_mul_const) through
their wrappers on CPU tensors, i.e. their plain versions, against the JAX
package's golden oracle (python ints), and for the Fermat inverse, the
3 mod 4 square root and the G1 ladder against the JAX package's jnp
compositions under jax.jit (on the CPU the JAX package runs no Pallas
kernel, so these are the references its fused kernels are held to).
sswu_map2 and g2_cofactor are held to the golden oracle only: a jax.jit of
their JAX compositions takes about two minutes each on the CPU, and
test_torch_verify.py's staged-pipeline test already holds the whole hash
stage limb for limb against the JAX pipeline.

Batch 4; field elements from numpy.random.default_rng, points from the JAX
golden curve; limbs and decoded integers are compared exactly (tolerance
0).  About 40-60 s on the CPU, most of it the plain G2 ladders and the
JAX compiles."""

import functools

import jax
import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import curve as GC
from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu.golden import hash_to_curve as GH
from bls_verify_gadget_tpu.ops import curve as JCV
from bls_verify_gadget_tpu.ops.fp import FP as JFP
from bls_verify_gadget_tpu_torch.convert import limbs_from_numpy, limbs_to_numpy
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops import tower as T
from bls_verify_gadget_tpu_torch.ops.fp import FP
from test_torch_curve_hash_pairing import g1_off_subgroup, g2_off_subgroup

B = 4
P = JC.P


def rand_ints(rng, n, m=P):
    return [int.from_bytes(rng.bytes(48), "little") % m for _ in range(n)]


def fp2_port(vals):
    """Host Fp2 ints -> packed (2, N, 24) CPU tensor."""
    return torch.stack(T.fp2_encode_batch(vals, "cpu"))


def fp2_host(t):
    """Packed (2, N, 24) -> host Fp2 ints."""
    return list(zip(*FP.decode(t)))


# ----------------------------------------------------------------------------
# pow_win
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("exp", ["p-2", "(p+1)/4"])
def test_pow_win_fp_matches_jax_and_pow(exp):
    """Fp, e = p - 2 (FP.inv, the Fermat inverse; 0 -> 0) and e = (p+1)/4
    (the 3 mod 4 square root) on 0, 1, p - 1 and a random value: limbs
    against jax.jit of the JAX package's FP.inv / FP.pow_const, values
    against Python's pow."""
    e = P - 2 if exp == "p-2" else (P + 1) // 4
    vals = [0, 1, P - 1] + rand_ints(np.random.default_rng(51), B - 3)
    a_np = np.asarray(JFP.encode(vals))
    a = limbs_from_numpy(a_np, device="cpu")
    K.COUNTS.reset()
    got = K.pow_win(FP, a[None], e)[0]
    assert sum(K.COUNTS.launches.values()) == 0  # CPU tensors: the plain version
    assert FP.decode(got) == [pow(v, e, P) for v in vals]
    if exp == "p-2":
        want = jax.jit(JFP.inv)(a_np)
        assert torch.equal(FP.inv(a), got)
    else:
        want = jax.jit(lambda x: JFP.pow_const(x, e))(a_np)
    np.testing.assert_array_equal(limbs_to_numpy(got), np.asarray(want))


def test_pow_win_fp2_matches_golden():
    """Fp2, e = (p - 11)/16 (the SSWU sqrt chain's exponent) on 0, 1, u and
    a random value, against the golden fp2_pow."""
    rng = np.random.default_rng(52)
    vals = [(0, 0), (1, 0), (0, 1), tuple(rand_ints(rng, 2))]
    got = K.pow_win(FP, fp2_port(vals), H.SQRT_K)
    assert fp2_host(got) == [GF.fp2_pow(v, H.SQRT_K) for v in vals]


# ----------------------------------------------------------------------------
# sswu_map2, and the unfused composition it replaces
# ----------------------------------------------------------------------------

def _gx1_is_square(u):
    """Whether SSWU's first candidate x1 of u gives a square gx1 (golden)."""
    A, Bc, Z = JC.SSWU_A, JC.SSWU_B, JC.SSWU_Z
    tv1 = GF.fp2_mul(Z, GF.fp2_sqr(u))
    tv2 = GF.fp2_add(GF.fp2_sqr(tv1), tv1)
    x1 = GF.fp2_mul(GF.fp2_mul(Bc, GF.fp2_neg(GF.fp2_inv(A))),
                    GF.fp2_add((1, 0), GF.fp2_inv(tv2)))
    gx1 = GF.fp2_add(GF.fp2_mul(GF.fp2_add(GF.fp2_sqr(x1), A), x1), Bc)
    return GF.fp2_is_square(gx1)


def sswu_inputs():
    """u0, u1 lists of B Fp2 values: u0 = 0 in element 0, a u0 whose gx1 is
    not a square in element 1, hash_to_field outputs of random messages
    elsewhere."""
    rng = np.random.default_rng(53)
    pairs = [GH.hash_to_field_fp2(rng.bytes(32)) for _ in range(B)]
    u0, u1 = [list(x) for x in zip(*pairs)]
    u0[0] = (0, 0)
    u0[1] = next((k, 1) for k in range(1, 100) if not _gx1_is_square((k, 1)))
    assert _gx1_is_square(u1[0]) or _gx1_is_square(u1[2]) or _gx1_is_square(u1[3])
    return u0, u1


# The port's unfused map composition that sswu_map2 replaced (a copy of
# the former ops/hash_to_g2.py sswu_map, iso3_map_jacobian and helpers,
# over the tower's kernel wrappers): sswu_map2's Jacobian output must equal
# pt_add(map_to_curve_g2(u0), map_to_curve_g2(u1)) limb for limb, as the
# JAX kernel's docstring promises for its unfused path.

_C1_HOST = GF.fp2_mul(GF.fp2_neg(JC.SSWU_B), GF.fp2_inv(JC.SSWU_A))
_C2_HOST = GF.fp2_neg(GF.fp2_inv(JC.SSWU_Z))
_Z3_HOST = GF.fp2_mul(GF.fp2_mul(JC.SSWU_Z, JC.SSWU_Z), JC.SSWU_Z)
_CZ3_HOST = GF.fp2_pow(_Z3_HOST, (JC.Q2 + 7) // 16)
_SQRT_CANDS = ((1, 0), (0, 1), GF.fp2_sqrt((0, 1)), GF.fp2_sqrt(GF.fp2_neg((0, 1))))


def _sqrt_from_candidate(z, target):
    best = T.fp2_zero_like(target)
    found = T.fp2_is_zero(target)
    for cand in _SQRT_CANDS:
        (t,) = T.fp2_mul_pairs([(z, T._bcast(cand, target))])
        ok = T.fp2_eq(T.fp2_sqr(t), target)
        best = T.fp2_cmov(ok & ~found, t, best)
        found = found | ok
    return best, found


def _fp2_pow_const(a, exponent):
    digits = K.pow_digits(exponent)
    tab = [T.fp2_one_like(a), a]
    for i in range(2, 16):
        tab.append(T.fp2_mul(tab[i - 1], a))
    f = T.fp2_one_like(a)
    for d in digits:
        for _ in range(4):
            f = T.fp2_sqr(f)
        f = T.fp2_mul(f, tab[d])
    return f


def _fp2_pow_sqrt(a):
    a2 = T.fp2_sqr(a)
    a8 = T.fp2_sqr(T.fp2_sqr(a2))
    (a11,) = T.fp2_mul_pairs([(a8, T.fp2_mul(a2, a))])
    (b,) = T.fp2_mul_pairs([(T.fp2_conj(a), a11)])
    (z,) = T.fp2_mul_pairs([(_fp2_pow_const(b, H.SQRT_K), a8)])
    return z


def _sswu_map(u):
    u2 = T.fp2_sqr(u)
    (tv1,) = T.fp2_mul_pairs([(T._bcast(JC.SSWU_Z, u), u2)])
    tv2 = T.fp2_add(T.fp2_sqr(tv1), tv1)
    inv_tv2 = T.fp2_inv(tv2)
    e1 = T.fp2_is_zero(tv2)
    x1f = T.fp2_add(T.fp2_one_like(u), inv_tv2)
    x1f = T.fp2_cmov(e1, T._bcast(_C2_HOST, u), x1f)
    (x1,) = T.fp2_mul_pairs([(T._bcast(_C1_HOST, u), x1f)])
    A, Bc = T._bcast(JC.SSWU_A, u), T._bcast(JC.SSWU_B, u)
    gx1_a, ax1 = T.fp2_mul_pairs([(T.fp2_sqr(x1), x1), (A, x1)])
    gx1 = T.fp2_add(T.fp2_add(gx1_a, ax1), Bc)
    (x2,) = T.fp2_mul_pairs([(tv1, x1)])
    gx2_a, ax2 = T.fp2_mul_pairs([(T.fp2_sqr(x2), x2), (A, x2)])
    gx2 = T.fp2_add(T.fp2_add(gx2_a, ax2), Bc)
    z1 = _fp2_pow_sqrt(gx1)
    y1, ok1 = _sqrt_from_candidate(z1, gx1)
    (u3,) = T.fp2_mul_pairs([(u2, u)])
    (zc,) = T.fp2_mul_pairs([(z1, T._bcast(_CZ3_HOST, u))])
    (z2,) = T.fp2_mul_pairs([(zc, u3)])
    y2, _ = _sqrt_from_candidate(z2, gx2)
    x = T.fp2_cmov(ok1, x1, x2)
    y = T.fp2_cmov(ok1, y1, y2)
    flip = T.fp2_sgn0(u) != T.fp2_sgn0(y)
    return x, T.fp2_cmov(flip, T.fp2_neg(y), y)


def _horner(coeffs, x):
    acc = T._bcast(coeffs[-1], x)
    for c in reversed(coeffs[:-1]):
        (ax,) = T.fp2_mul_pairs([(acc, x)])
        acc = T.fp2_add(ax, T._bcast(c, x))
    return acc


def _map_to_curve_g2(u):
    """SSWU + 3-isogeny in Jacobian packing Z = xd yd."""
    x, y = _sswu_map(u)
    xn, xd = _horner(JC.ISO3_XNUM, x), _horner(JC.ISO3_XDEN, x)
    yn, yd = _horner(JC.ISO3_YNUM, x), _horner(JC.ISO3_YDEN, x)
    (z,) = T.fp2_mul_pairs([(xd, yd)])
    xnyd, yxd = T.fp2_mul_pairs([(xn, yd), (y, xd)])
    (X,) = T.fp2_mul_pairs([(xnyd, z)])
    (ynyxd,) = T.fp2_mul_pairs([(yn, yxd)])
    (Y,) = T.fp2_mul_pairs([(ynyxd, T.fp2_sqr(z))])
    return (X, Y, z)


@functools.cache
def sswu_case():
    """sswu_inputs, their encodings and sswu_map2's (6, B, 24) output."""
    u0, u1 = sswu_inputs()
    tu0, tu1 = T.fp2_encode_batch(u0, "cpu"), T.fp2_encode_batch(u1, "cpu")
    return u0, u1, tu0, tu1, K.sswu_map2(FP, torch.stack([*tu0, *tu1]))


def test_sswu_map2_matches_golden_and_unfused_composition():
    u0, u1, tu0, tu1, q = sswu_case()
    assert q.shape == (6, B, 24)
    jac = CV.unpack_point(CV.FP2_OPS, q)
    want = [GC.g2_add(GH.map_to_curve_g2(a), GH.map_to_curve_g2(b)) for a, b in zip(u0, u1)]
    assert CV.g2_decode(jac) == want
    m = _map_to_curve_g2((torch.cat([tu0[0], tu1[0]]), torch.cat([tu0[1], tu1[1]])))
    q0 = tuple((c[0][:B], c[1][:B]) for c in m)
    q1 = tuple((c[0][B:], c[1][B:]) for c in m)
    assert torch.equal(q, CV.pack_point(CV.FP2_OPS, CV.pt_add(CV.FP2_OPS, q0, q1)))


# ----------------------------------------------------------------------------
# g2_cofactor and pt_mul_const
# ----------------------------------------------------------------------------

def test_g2_cofactor_matches_golden():
    """Points outside the subgroup -- two sswu_map2 outputs in Jacobian
    form, an on-curve point off the subgroup -- and the infinity, cleared
    and compared in affine with the golden Budroni-Pintore clearing."""
    u0, u1, _, _, q = sswu_case()
    pts = [GC.g2_add(GH.map_to_curve_g2(a), GH.map_to_curve_g2(b))
           for a, b in zip(u0[:2], u1[:2])] + [g2_off_subgroup(), None]
    assert not any(p is not None and GC.g2_in_subgroup(p) for p in pts)
    # the map's Jacobian outputs as they are (Z != 1), then two affine points
    P2 = torch.cat([q[:, :2], CV.pack_point(CV.FP2_OPS, CV.g2_encode_batch(pts[2:], "cpu"))], 1)
    got = K.g2_cofactor(FP, P2, CV.X_SEGMENTS)
    dec = CV.g2_decode(CV.unpack_point(CV.FP2_OPS, got))
    assert dec == [None if p is None else GC.g2_clear_cofactor(p) for p in pts]
    assert all(GC.g2_in_subgroup(p) for p in dec)


def _points(group, seed):
    """B points: two random multiples of the generator, one on the curve
    outside the subgroup, the infinity."""
    rng = np.random.default_rng(seed)
    gen, mul, off = ((JC.G1_GEN, GC.g1_mul, g1_off_subgroup) if group == "g1"
                     else (JC.G2_GEN, GC.g2_mul, g2_off_subgroup))
    return [mul(gen, k) for k in rand_ints(rng, 2, JC.R)] + [off(), None]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_pt_mul_const_matches_golden(group):
    """By |x| through the kernel wrapper, and by 1 and 5 through
    curve.pt_mul_const (1 returns P without a launch), in affine against
    the golden scalar multiplication."""
    ops, enc, dec, gmul = ((CV.FP_OPS, CV.g1_encode_batch, CV.g1_decode, GC.g1_mul)
                           if group == "g1" else
                           (CV.FP2_OPS, CV.g2_encode_batch, CV.g2_decode, GC.g2_mul))
    pts = _points(group, 54 if group == "g1" else 55)
    p = enc(pts, "cpu")
    packed = K.pt_mul_const(FP, CV.pack_point(ops, p), CV.X_SEGMENTS)
    assert packed.shape == (3 if group == "g1" else 6, B, 24)
    got = dec(CV.unpack_point(ops, packed))
    assert got == [None if q is None else gmul(q, JC.ABS_X) for q in pts]
    assert CV.pt_mul_const(ops, p, 1) is p
    assert dec(CV.pt_mul_const(ops, p, 5)) == [None if q is None else gmul(q, 5) for q in pts]


def test_pt_mul_const_g1_matches_jax():
    """The G1 ladder by |x| against jax.jit of the JAX package's
    CV.pt_mul_const, in affine: on the CPU the JAX package runs a cmov
    scan ladder whose Jacobian representative differs."""
    pts = _points("g1", 56)
    x, y, z = (np.asarray(c) for c in JCV.g1_encode_batch(pts))
    jx, jy, jz = jax.jit(lambda *p: JCV.pt_mul_const(JCV.FP_OPS, p, JC.ABS_X))(x, y, z)
    want = CV.g1_decode(tuple(limbs_from_numpy(np.asarray(c), device="cpu") for c in (jx, jy, jz)))
    p = tuple(limbs_from_numpy(c, device="cpu") for c in (x, y, z))
    got = CV.g1_decode(CV.pt_mul_const(CV.FP_OPS, p, JC.ABS_X))
    assert got == want == [None if q is None else GC.g1_mul(q, JC.ABS_X) for q in pts]

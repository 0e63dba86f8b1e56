"""The port's keygen, signing and aggregation slice (bls_verify_gadget_tpu_torch:
ops/kernels.py pt_dbl, pt_add, pt_mul_var and the one-pair Miller kernels;
curve.pt_sum, tower.fp12_prod; BatchedBLS.derive_pubkeys, sign,
aggregate_pubkeys, aggregate_signatures, aggregate_pubkeys_masked,
aggregate_verify_distinct) on CPU tensors, i.e. the kernels' plain
versions, against the JAX package's jnp compositions under jax.jit (on the
CPU the JAX package runs no Pallas kernel, so these are the references its
fused kernels are held to), the golden oracle and the sign/, aggregate/
and fast_aggregate_verify/ conformance vectors.

Batches of at most 5 (12 for the sign vectors); values from
numpy.random.default_rng; JAX inputs pass through the port's convert.py.
Limbs, bytes and booleans are compared exactly (tolerance 0).  About
2-3 minutes on the CPU alone: the plain 255-bit ladders (one G1, one G2),
the CPU verify of the fast_aggregate_verify vectors, the two
distinct-message aggregate verifications and the JAX compiles take most
of it.  JAX's sign and
aggregate_verify_distinct are not jitted (multi-minute CPU compiles)."""

import functools

import jax
import numpy as np
import pytest
import torch

import op_counts
from vector_loader import load_suite, unhex
from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.golden import curve as GC
from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu.models.bls import BatchedBLS as JBatchedBLS
from bls_verify_gadget_tpu.models.bls import encode_scalars as jencode_scalars
from bls_verify_gadget_tpu.ops import curve as JCV
from bls_verify_gadget_tpu.ops import pairing as JPR
from bls_verify_gadget_tpu.ops import tower as JT
from bls_verify_gadget_tpu.ops.fp import FP as JFP
from bls_verify_gadget_tpu_torch.convert import (
    bitmap_from_numpy, limbs_from_numpy, limbs_to_numpy, points_from_numpy,
    scalars_from_numpy,
)
from bls_verify_gadget_tpu_torch.golden import codec
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_pubkeys, encode_scalars, encode_signatures,
)
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops import pairing as PR
from bls_verify_gadget_tpu_torch.ops import tower as T
from bls_verify_gadget_tpu_torch.ops.fp import FP
from bls_verify_gadget_tpu_torch.utils.profiling import count_ops

P, R = JC.P, JC.R
GROUPS = {
    "g1": (JCV.FP_OPS, CV.FP_OPS, JC.G1_GEN, GC.g1_mul, GC.g1_neg),
    "g2": (JCV.FP2_OPS, CV.FP2_OPS, JC.G2_GEN, GC.g2_mul, GC.g2_neg),
}


def rand_ints(rng, n, m=P):
    return [int.from_bytes(rng.bytes(48), "little") % m for _ in range(n)]


def flat(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for x in tree for leaf in flat(x)]
    return [tree]


def assert_same(got, want):
    """Port tensors and JAX arrays (nested alike) equal limb for limb."""
    got, want = flat(got), flat(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(limbs_to_numpy(g), np.asarray(w))


def jacobian(group, pts, lams):
    """Affine points (None = infinity) as Jacobian JAX limb tuples in a
    random representative (X l^2, Y l^3, Z = l; the infinity (l^2, l^3, 0)),
    so that the outputs' representatives follow the formulas, not Z = 1."""
    def scale(c, k):
        return GF.fp2_mul(c, (k, 0)) if group == "g2" else c * k % P

    coords = [[], [], []]
    for pt, lam in zip(pts, lams):
        l2, l3 = lam * lam % P, lam * lam * lam % P
        if pt is None:
            one = (1, 0) if group == "g2" else 1
            zero = (0, 0) if group == "g2" else 0
            xyz = (scale(one, l2), scale(one, l3), zero)
        else:
            one = (1, 0) if group == "g2" else 1
            xyz = (scale(pt[0], l2), scale(pt[1], l3), scale(one, lam))
        for j in range(3):
            coords[j].append(xyz[j])
    if group == "g1":
        return tuple(np.asarray(JFP.encode(c)) for c in coords)
    return tuple((np.asarray(JFP.encode([v[0] for v in c])),
                  np.asarray(JFP.encode([v[1] for v in c]))) for c in coords)


def random_points(group, rng, n):
    _, _, gen, mul, _ = GROUPS[group]
    return [mul(gen, k) for k in rand_ints(rng, n, R)]


def unsqueeze(pt):
    """A point with its batch axis dropped (pt_sum) -> a batch of one."""
    return T._tree(lambda c: c[None], pt)


# ----------------------------------------------------------------------------
# the point kernels against JAX
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("group", ["g1", "g2"])
def test_pt_dbl_and_pt_add_match_jax(group):
    """pt_dbl with count 1 (curve.pt_double) and 3 (the kernel wrapper),
    and pt_add both ways round on P = [a, b, c, inf], Q = [d, b', -c, e]:
    the generic sum, P == Q in another representative (doubling), P == -Q
    (the infinity (1, 1, 0)), P at infinity and, swapped, Q at infinity;
    against jax.jit of the JAX package's CV.pt_double / CV.pt_add."""
    jops, ops, _, _, neg = GROUPS[group]
    rng = np.random.default_rng(61 if group == "g1" else 62)
    a, b, c, d, e = random_points(group, rng, 5)
    jp = jacobian(group, [a, b, c, None], rand_ints(rng, 4))
    jq = jacobian(group, [d, b, neg(c), e], rand_ints(rng, 4))
    p, q = points_from_numpy(jp, device="cpu"), points_from_numpy(jq, device="cpu")

    jdbl = jax.jit(lambda x: JCV.pt_double(jops, x))
    jadd = jax.jit(lambda x, y: JCV.pt_add(jops, x, y))
    K.COUNTS.reset()
    assert_same(CV.pt_double(ops, p), jdbl(jp))
    want = jp
    for _ in range(3):
        want = jdbl(want)
    got = K.pt_dbl(FP, CV.pack_point(ops, p), 3)
    assert_same(CV.unpack_point(ops, got), want)
    assert_same(CV.pt_add(ops, p, q), jadd(jp, jq))
    assert_same(CV.pt_add(ops, q, p), jadd(jq, jp))
    assert sum(K.COUNTS.launches.values()) == 0  # CPU tensors: the plain versions

    mul = GROUPS[group][3]
    dec = CV.g1_decode if group == "g1" else CV.g2_decode
    gadd = GC.g1_add if group == "g1" else GC.g2_add
    assert dec(CV.pt_add(ops, p, q)) == [gadd(a, d), mul(b, 2), None, e]


def test_derive_pubkeys_matches_jax_pt_mul_var():
    """derive_pubkeys (pt_mul_var on the G1 generator, 255 bits) for the
    scalars 0, 1, r - 1 and a random one, limb for limb against jax.jit of
    the JAX package's derive_pubkeys (CV.pt_mul_var), and against the
    golden sk_to_pk, compressed alike by both codecs; scalars through
    scalars_from_numpy."""
    sks = [0, 1, R - 1] + rand_ints(np.random.default_rng(63), 1, R)
    jsk = np.asarray(jencode_scalars(sks))
    want = jax.jit(JBatchedBLS().derive_pubkeys)(jsk)
    sk = scalars_from_numpy(jsk, device="cpu")
    assert torch.equal(sk, encode_scalars(sks, device="cpu"))
    got = BatchedBLS(device="cpu").derive_pubkeys(sk)
    assert_same(got, want)
    pks = CV.g1_decode(got)
    assert pks == [None] + [gbls.sk_to_pk(k) for k in sks[1:]]
    assert [codec.g1_compress(p) for p in pks] == [gbls.g1_compress(p) for p in pks]


def test_sign_matches_vectors_and_jax_pt_mul_var():
    """sign on the 10 sign/ vectors (the zero key among them) and on the
    keys 1 and r - 1, in ONE batch: each vector's signature byte for byte
    through the port's g2_compress, key 0 invalid, and every signature limb
    for limb against jax.jit of the JAX package's CV.pt_mul_var on the
    port's own Jacobian H(m) (test_torch_verify.py holds H(m) to the JAX
    hash stage).  The op counter over the call holds the JAX package's
    count of sign per element (tests/data/jax_op_counts.json)."""
    vecs = [v for _, v in load_suite("sign")]
    assert len(vecs) == 10
    sks = [int.from_bytes(unhex(v["input"]["privkey"]), "big") for v in vecs] + [1, R - 1]
    msgs = [unhex(v["input"]["message"]) for v in vecs] + [b"\x11" * 32, b"\x22" * 32]
    bls = BatchedBLS(device="cpu")
    sk = encode_scalars(sks, device="cpu")
    msg = encode_messages(msgs, device="cpu")
    K.COUNTS.reset()
    with count_ops() as counter:
        sig, valid = bls.sign(sk, msg)
    assert sum(K.COUNTS.launches.values()) == 0
    op_counts.assert_jax_counts(counter, "sign", len(sks))
    assert valid.tolist() == [k != 0 for k in sks]
    out = [codec.g2_compress(s) for s in CV.g2_decode(sig)]
    for v, got, ok in zip(vecs, out, valid.tolist()):
        if v["output"] is None:
            assert not ok
        else:
            assert got == unhex(v["output"])
    assert out[-2:] == [gbls.g2_compress(gbls.sign(k, m)) for k, m in zip(sks[-2:], msgs[-2:])]

    h = bls.hash_to_g2(msg)
    jh = tuple(tuple(limbs_to_numpy(c) for c in x) for x in h)
    want = jax.jit(lambda p, s: JCV.pt_mul_var(JCV.FP2_OPS, p, s, 255))(
        jh, np.asarray(jencode_scalars(sks)))
    assert_same(sig, want)


def test_pt_sum_matches_jax():
    """pt_sum over 5 G1 points [b, inf, b, c, -c] (odd tails at two
    levels; the tree meets a doubling, an infinity and generic sums),
    against jax.jit of the JAX package's CV.pt_sum, and against the golden
    sum.  (G2 sums: the aggregate/ vectors below; a jax.jit of the G2 tree
    takes ~25 s on the CPU, and the G2 pt_add is held to JAX above.)"""
    rng = np.random.default_rng(64)
    b, c = random_points("g1", rng, 2)
    jp = jacobian("g1", [b, None, b, c, GC.g1_neg(c)], rand_ints(rng, 5))
    got = CV.pt_sum(CV.FP_OPS, points_from_numpy(jp, device="cpu"))
    assert_same(got, jax.jit(lambda x: JCV.pt_sum(JCV.FP_OPS, x))(jp))
    assert CV.g1_decode(unsqueeze(got)) == [GC.g1_mul(b, 2)]


def test_fp12_prod_matches_jax():
    """fp12_prod over 5 random Fp12 elements (an odd tail at two levels)
    against jax.jit of the JAX package's T.fp12_prod."""
    rng = np.random.default_rng(66)
    coords = [np.asarray(JFP.encode(rand_ints(rng, 5))) for _ in range(12)]
    want = jax.jit(JT.fp12_prod)(JT._unflat12(coords))
    f = T.fp12_unpack(limbs_from_numpy(np.stack(coords), device="cpu"))
    assert_same(T.fp12_prod(f), JT._flat12(want))


def test_one_pair_miller_loop_matches_jax():
    """multi_miller_loop with ONE pair (the k = 1 Miller kernels' plain
    versions) on 4 (pk, sig) pairs of the golden scheme with one invalid,
    against jax.jit of the JAX package's PR.multi_miller_loop with one
    pair: the 12 coordinates of f."""
    sks = rand_ints(np.random.default_rng(67), 4, R)
    g1s = [gbls.sk_to_pk(k) for k in sks]
    g2s = [gbls.sign(k, b"one-pair Miller loop") for k in sks]
    enc = lambda vals: np.asarray(JFP.encode(vals))  # noqa: E731
    xp, yp = enc([p[0] for p in g1s]), enc([p[1] for p in g1s])
    xq = (enc([q[0][0] for q in g2s]), enc([q[0][1] for q in g2s]))
    yq = (enc([q[1][0] for q in g2s]), enc([q[1][1] for q in g2s]))
    valid = np.array([True, False, True, True])
    want = jax.jit(lambda *a: JPR.multi_miller_loop([((a[0], a[1]), (a[2], a[3]), a[4])]))(
        xp, yp, xq, yq, valid)
    port = lambda x: points_from_numpy(x, device="cpu")  # noqa: E731
    K.COUNTS.reset()
    got = PR.multi_miller_loop([((port(xp), port(yp)), (port(xq), port(yq)),
                                 bitmap_from_numpy(valid, device="cpu"))])
    assert sum(K.COUNTS.launches.values()) == 0
    assert_same(got, want)


# ----------------------------------------------------------------------------
# the slice against the conformance vectors and JAX
# ----------------------------------------------------------------------------

def test_aggregate_signatures_matches_vectors():
    """aggregate_signatures on each of the 6 aggregate/ vectors, compressed
    by the port's codec; an empty input is None at the host boundary."""
    bls = BatchedBLS(device="cpu")
    cases = list(load_suite("aggregate"))
    assert len(cases) == 6
    for name, vec in cases:
        sigs = [codec.g2_decompress(unhex(s)) for s in vec["input"]]
        if not sigs:
            assert vec["output"] is None, name
            continue
        agg = bls.aggregate_signatures(CV.g2_encode_batch(sigs, "cpu"))
        (pt,) = CV.g2_decode(unsqueeze(agg))
        assert codec.g2_compress(pt) == unhex(vec["output"]), name


def test_fast_aggregate_verify_matches_vectors():
    """The 11 fast_aggregate_verify/ vectors: aggregate_pubkeys per vector,
    then ONE batched verify of every vector whose pubkeys and signature
    decode; no pubkeys or an undecodable input is False at the host
    boundary."""
    bls = BatchedBLS(device="cpu")
    cases = list(load_suite("fast_aggregate_verify"))
    assert len(cases) == 11
    results, batch = {}, []
    for name, vec in cases:
        try:
            pks = [codec.g1_decompress(unhex(p)) for p in vec["input"]["pubkeys"]]
            sig = codec.g2_decompress(unhex(vec["input"]["signature"]))
        except ValueError:
            results[name] = False
            continue
        if not pks:
            results[name] = False
            continue
        batch.append((name, bls.aggregate_pubkeys(CV.g1_encode_batch(pks, "cpu")), sig,
                      unhex(vec["input"]["message"])))
    assert len(batch) == 6
    apk = tuple(torch.stack(c) for c in zip(*[b[1] for b in batch]))
    out = bls.verify(CV.pt_to_affine(CV.FP_OPS, apk),
                     encode_signatures([b[2] for b in batch], device="cpu"),
                     encode_messages([b[3] for b in batch], device="cpu"))
    results.update({b[0]: bool(ok) for b, ok in zip(batch, out.tolist())})
    assert results == {name: vec["output"] for name, vec in cases}


@functools.cache
def jax_masked_aggregate():
    """jax.jit of the JAX package's aggregate_pubkeys_masked, one for the
    module: the masked tests' uint32 bitmaps share its compile."""
    return jax.jit(JBatchedBLS().aggregate_pubkeys_masked)


def test_aggregate_pubkeys_masked_matches_jax():
    """aggregate_pubkeys_masked over 5 pubkeys (Jacobian, random Z) and a
    bitmap of 3 set bits against jax.jit of the JAX package's
    aggregate_pubkeys_masked: the sum's limbs and the count; and the sum
    equals aggregate_pubkeys of the selected keys (pt_eq)."""
    rng = np.random.default_rng(68)
    pts = random_points("g1", rng, 5)
    jp = jacobian("g1", pts, rand_ints(rng, 5))
    bitmap = np.array([1, 0, 1, 1, 0], np.uint32)
    jsum, jcount = jax_masked_aggregate()(jp, bitmap)
    bls = BatchedBLS(device="cpu")
    p = points_from_numpy(jp, device="cpu")
    sel = bitmap_from_numpy(bitmap, device="cpu")
    got, count = bls.aggregate_pubkeys_masked(p, sel)
    assert_same(got, jsum)
    assert int(count) == int(jcount) == 3
    subset = bls.aggregate_pubkeys(tuple(c[sel] for c in p))
    assert bool(CV.pt_eq(CV.FP_OPS, unsqueeze(got), unsqueeze(subset))[0])


@pytest.mark.parametrize("bitmap, count", [
    (np.array([2, 0, 1, 3, 0], np.uint32), 6),
    (np.array([1, 0, -1, 1, 0], np.int32), 1),
    (np.array([0.5, 1.0, 0.0, 0.25, 1.0], np.float32), 2),
], ids=["uint32", "int32", "float32"])
def test_aggregate_pubkeys_masked_counts_values_as_jax(bitmap, count):
    """Bitmaps that are not 0/1, on test_aggregate_pubkeys_masked_matches_jax's
    5 pubkeys: aggregate_pubkeys_masked on the raw bitmap tensor gives
    jax.jit of the JAX package's sum and count -- the values as uint32
    summed mod 2^32 (2 + 1 + 3 = 6; 1 + (2^32 - 1) + 1 wraps to 1; the
    floats truncate, 0 + 1 + 0 + 0 + 1 = 2) over the points with a value
    > 0 (the int32 -1 leaves its point out, the float 0.5 and 0.25 keep
    theirs); and bitmap_from_numpy selects those points, as JAX's
    bitmap > 0 does."""
    rng = np.random.default_rng(68)
    pts = random_points("g1", rng, 5)
    jp = jacobian("g1", pts, rand_ints(rng, 5))
    jsum, jcount = jax_masked_aggregate()(jp, bitmap)
    bls = BatchedBLS(device="cpu")
    p = points_from_numpy(jp, device="cpu")
    got, got_count = bls.aggregate_pubkeys_masked(p, torch.from_numpy(bitmap))
    assert_same(got, jsum)
    assert int(got_count) == int(jcount) == count
    sel = bitmap_from_numpy(bitmap, device="cpu")
    assert sel.dtype == torch.bool
    assert sel.tolist() == np.asarray(jax.numpy.asarray(bitmap) > 0).tolist()
    subset = bls.aggregate_pubkeys(tuple(c[sel] for c in p))
    assert bool(CV.pt_eq(CV.FP_OPS, unsqueeze(got), unsqueeze(subset))[0])


def test_aggregate_verify_distinct_matches_golden():
    """aggregate_verify_distinct over 3 (pk, msg) pairs and their
    aggregated signature: true, and false with two messages swapped, as the
    JAX package's golden aggregate_verify decides."""
    sks = rand_ints(np.random.default_rng(69), 3, R)
    pks = [gbls.sk_to_pk(k) for k in sks]
    msgs = [bytes([i]) * 32 for i in range(3)]
    agg = gbls.aggregate_signatures([gbls.sign(k, m) for k, m in zip(sks, msgs)])
    swapped = [msgs[1], msgs[0], msgs[2]]
    bls = BatchedBLS(device="cpu")
    pk = encode_pubkeys(pks, device="cpu")
    sig = encode_signatures([agg], device="cpu")
    for m, want in ((msgs, True), (swapped, False)):
        got = bls.aggregate_verify_distinct(pk, sig, encode_messages(m, device="cpu"))
        assert got.shape == ()
        assert bool(got) == gbls.aggregate_verify(pks, m, agg) == want

"""The port's parallel layer (bls_verify_gadget_tpu_torch/parallel: mesh,
distributed, api, launch) on one spawned world of 2 CPU ranks over Gloo,
against the JAX package's sharded functions on 2 of conftest's 8 virtual
devices, the golden oracle and the port's unsharded verify.

One world runs every case (tests/torch_parallel_ranks.py), so the ranks'
interpreters and CPU verifies are paid once; dryrun_multichip's world,
the JAX compiles and the unsharded verify run meanwhile.  Under
pytest-xdist the first worker to need them computes these results and
the others read them (a file lock in the session's shared temp dir).  16 G1 points, 8 G2
points, a verify batch of 2 and a committee of 4; values from
numpy.random.default_rng.  Limbs, counts and booleans compare exactly
(tolerance 0).  About 2 minutes on the CPU."""

import concurrent.futures
import fcntl
import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vector_loader import unhex
from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.golden import curve as GC
from bls_verify_gadget_tpu.ops import curve as JCV
from bls_verify_gadget_tpu.parallel import make_mesh as jmake_mesh
from bls_verify_gadget_tpu.parallel import sharded_aggregate_pubkeys as jsharded_pubkeys
from bls_verify_gadget_tpu.parallel import sharded_aggregate_signatures as jsharded_signatures
from bls_verify_gadget_tpu.parallel import sharded_masked_aggregate as jsharded_masked
from bls_verify_gadget_tpu_torch.convert import points_from_numpy
from bls_verify_gadget_tpu_torch.golden import codec
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_pubkeys, encode_signatures,
)
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.parallel.launch import dryrun_multichip, run_ranks

TESTS = pathlib.Path(__file__).resolve().parent
VALID = TESTS / "vectors" / "verify" / "verify_valid_case_195246ee3bd3b6ec.json"


def _np(x):
    """A JAX result -> the nested lists of ints a rank's JSON line holds."""
    return json.loads(json.dumps(jax.tree.map(lambda a: np.asarray(a).astype(np.int64).tolist(), x)))


def _inputs(rng):
    """The saved inputs of the ranks, and the host values behind them."""
    pts = [GC.g1_mul(JC.G1_GEN, int(rng.integers(1, 2**62))) for _ in range(16)]
    sigs = [GC.g2_mul(JC.G2_GEN, int(rng.integers(1, 2**62))) for _ in range(8)]
    bitmaps = [rng.integers(0, 2, 16).astype(np.int32) for _ in range(3)]
    bitmaps[1][[2, 11]] = 3  # values that are not 0/1: selected, counted as themselves
    bitmaps[2][[5, 9]] = -1  # uint32 0xFFFFFFFF: not selected, counted mod 2^32
    # floats: 0.5 selected and counted as 0 (JAX's bitmap > 0 and uint32 cast)
    bitmaps.append(np.where(np.arange(16) % 3 == 0, 0.5, bitmaps[0]).astype(np.float32))
    vec = json.loads(VALID.read_text())["input"]
    pk = codec.g1_decompress(unhex(vec["pubkey"]))
    sig = codec.g2_decompress(unhex(vec["signature"]))
    msg = unhex(vec["message"])
    sks = [int(rng.integers(1, 2**62)) for _ in range(4)]
    bits = np.array([1, 1, 0, 1], np.int32)
    agg_msg = b"sharded committee"
    agg_sig = gbls.sign(sum(k for k, b in zip(sks, bits) if b) % JC.R, agg_msg)
    data = {
        "pk_jac": points_from_numpy(JCV.g1_encode_batch(pts), "cpu"),
        "sig_jac": points_from_numpy(JCV.g2_encode_batch(sigs), "cpu"),
        "bitmaps": [torch.from_numpy(b) for b in bitmaps],
        "pk": encode_pubkeys([pk, None], "cpu"),
        "sig": encode_signatures([sig, sig], "cpu"),
        "msg": encode_messages([msg, msg], "cpu"),
        "committee_pk": CV.g1_encode_batch([gbls.sk_to_pk(k) for k in sks], "cpu"),
        "committee_bits": [torch.from_numpy(bits), torch.ones(4, dtype=torch.int32)],
        "agg_sig": encode_signatures([agg_sig], "cpu"),
        "agg_msg": encode_messages([agg_msg], "cpu"),
    }
    return data, pts, sigs, bitmaps


def _jax_references(pts, sigs, bitmaps):
    mesh = jmake_mesh(2)
    masked = jax.jit(lambda d, b: jsharded_masked(mesh, d, b))
    d1 = JCV.g1_encode_batch(pts)
    return {
        "pk_sum": _np(jax.jit(lambda d: jsharded_pubkeys(mesh, d))(d1)),
        "sig_sum": _np(jax.jit(lambda d: jsharded_signatures(mesh, d))(JCV.g2_encode_batch(sigs))),
        "masked": [_np(masked(d1, jnp.asarray(b))) for b in bitmaps],
    }


def _once_per_session(tmp_path_factory, name, produce):
    """produce() -> JSON, computed once per test session: under
    pytest-xdist by the first worker that asks, the others waiting on a
    file lock and reading its result."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return produce()
    root = tmp_path_factory.getbasetemp().parent
    path = root / f"{name}.json"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not path.exists():
            path.write_text(json.dumps(produce()))
        return json.loads(path.read_text())


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(20)
    data, pts, sigs, bitmaps = _inputs(rng)

    def produce():
        path = tmp_path_factory.mktemp("parallel") / "inputs.pt"
        torch.save(data, path)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            ranks = pool.submit(run_ranks, 2, "torch_parallel_ranks:ranks",
                                {"data": str(path)}, "cpu", None, 900.0, [TESTS])
            dryrun = pool.submit(dryrun_multichip, 2, "cpu")
            jax_refs = _jax_references(pts, sigs, bitmaps)
            flat = BatchedBLS(device="cpu").verify(data["pk"], data["sig"], data["msg"]).tolist()
            return {"results": ranks.result(), "dryrun": dryrun.result(), "jax": jax_refs,
                    "flat": flat}

    return {**_once_per_session(tmp_path_factory, "torch_parallel_world", produce),
            "pts": pts, "sigs": sigs, "bitmaps": bitmaps}


def _point(limbs):
    """Jacobian limb lists of one point -> a batch of one on the CPU."""
    if isinstance(limbs[0], int):
        return torch.tensor(limbs, dtype=torch.int32)[None]
    return tuple(_point(c) for c in limbs)


def test_every_rank_holds_the_same_results(world):
    r0, r1 = world["results"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert {**r0, "rank": 1} == r1


def test_make_mesh_refuses_more_ranks_than_the_world(world):
    assert "requested 3 ranks but the world has only 2" in world["results"][0]["bigger_mesh"]


def test_process_local_to_global_is_the_slabs_in_rank_order(world):
    assert world["results"][0]["global"] is True


@pytest.mark.parametrize("name", ["pk_sum", "sig_sum"])
def test_point_sums_are_the_jax_fold_and_the_golden_sum(world, name):
    got = world["results"][0][name]
    assert got == world["jax"][name]
    if name == "pk_sum":
        (pt,) = CV.g1_decode(_point(got))
        want = gbls.aggregate_pubkeys(world["pts"])
    else:
        (pt,) = CV.g2_decode(_point(got))
        want = gbls.aggregate_signatures(world["sigs"])
    assert pt == want


@pytest.mark.parametrize("i", [0, 1, 2, 3])
def test_masked_aggregate_is_the_jax_one(world, i):
    point, count = world["results"][0]["masked"][i]
    jpoint, jcount = world["jax"]["masked"][i]
    assert point == jpoint
    bits = world["bitmaps"][i]
    assert count == jcount == int(bits.astype(np.uint32).astype(np.int64).sum() % 2**32)
    (pt,) = CV.g1_decode(_point(point))
    assert pt == gbls.aggregate_pubkeys([p for p, b in zip(world["pts"], bits) if b > 0])


@pytest.mark.parametrize("form", ["verify", "stages", "chained"])
def test_sharded_verify_gives_the_expected_and_the_unsharded_results(world, form):
    assert world["results"][0][form] == [True, False] == world["flat"]


def test_masked_aggregate_verify_true_then_false_with_an_extra_bit(world):
    assert world["results"][0]["masked_verify"] == [[True, 3], [False, 4]]


def test_dryrun_multichip_on_two_cpu_ranks(world):
    results = world["dryrun"]
    assert [r["verify"] for r in results] == [[True, True]] * 2
    assert [r["count"] for r in results] == [1, 1]

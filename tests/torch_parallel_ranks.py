"""The rank side of tests/test_torch_parallel.py: every case of the port's
parallel layer on one rank of a spawned world (parallel/launch.py
run_ranks).  It imports torch and the port only, never JAX: a rank is a
fresh interpreter without the tests' conftest."""

import torch
import torch.distributed as dist

from bls_verify_gadget_tpu_torch.models.bls import BatchedBLS
from bls_verify_gadget_tpu_torch.parallel import (
    make_mesh,
    make_sharded_verify,
    make_sharded_verify_staged,
    sharded_aggregate_pubkeys,
    sharded_aggregate_signatures,
    sharded_masked_aggregate,
    sharded_masked_aggregate_verify,
)
from bls_verify_gadget_tpu_torch.parallel.distributed import process_local_to_global


def _tree(fn, x):
    return tuple(_tree(fn, c) for c in x) if isinstance(x, tuple) else fn(x)


def _lists(x):
    return _tree(lambda t: t.tolist(), x)


def ranks(mesh, arg):
    """Every case on this rank's slab of the saved inputs -> the results
    the test holds to the JAX package, the golden oracle and the port's
    unsharded path."""
    data = torch.load(arg["data"])
    rank, world = dist.get_rank(), dist.get_world_size()

    def slab(x):
        return _tree(lambda t: t.chunk(world)[rank].contiguous(), x)

    out = {}
    try:
        make_mesh(world + 1)
        out["bigger_mesh"] = "no error"
    except ValueError as e:
        out["bigger_mesh"] = str(e)
    full = process_local_to_global(mesh, slab(data["pk_jac"]))
    out["global"] = all(torch.equal(g.full_tensor(), t) for g, t in zip(full, data["pk_jac"]))

    out["pk_sum"] = _lists(sharded_aggregate_pubkeys(mesh, slab(data["pk_jac"])))
    out["sig_sum"] = _lists(sharded_aggregate_signatures(mesh, slab(data["sig_jac"])))
    out["masked"] = [_lists(sharded_masked_aggregate(mesh, slab(data["pk_jac"]), slab(bits)))
                     for bits in data["bitmaps"]]

    bls = BatchedBLS(device="cpu")
    pk, sig, msg = (slab(data[k]) for k in ("pk", "sig", "msg"))
    msg_len = msg.shape[-1]
    out["verify"] = make_sharded_verify(bls, mesh, msg_len)(pk, sig, msg).tolist()
    run = make_sharded_verify_staged(bls, mesh, msg_len)
    hash_fn, pair_fn = run.stages
    out["stages"] = pair_fn(pk, sig, hash_fn(msg)).tolist()
    out["chained"] = run(pk, sig, msg).tolist()

    out["masked_verify"] = []
    for bits in data["committee_bits"]:
        ok, count = sharded_masked_aggregate_verify(
            bls, mesh, slab(data["committee_pk"]), slab(bits), data["agg_sig"],
            data["agg_msg"], data["agg_msg"].shape[-1])
        out["masked_verify"].append([bool(ok), int(count)])
    return out

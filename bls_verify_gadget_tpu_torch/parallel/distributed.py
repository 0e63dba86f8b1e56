"""Multi-process runtime of the parallel layer.

Each rank is one process that joins the global process group with
`initialize`; the "batch" mesh (mesh.py) then spans every rank and the
SPMD functions of api.py run unchanged, whether the ranks share a host or
not.  NCCL carries CUDA tensors between cards, one card per rank; Gloo
carries CPU tensors (the tests) and also CUDA ones, as in a dry run of
several ranks on one card.  torch has no backend that locks at import, so
unlike the JAX package's initialize there is no ordering constraint: a
process may import the port before it joins the group.  Nothing tells a
process of a cluster: the caller passes the address, world size and rank
(launch.py does).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.fp import resolve_device


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    device: str = "cuda",
    backend: str | None = None,
) -> None:
    """Join this process to the global process group, once per process.

    coordinator_address: "host:port" of rank 0 (a tcp:// init method).
    device: "cuda" (backend NCCL, one card per rank: this rank's card is
    made the current device, process_id modulo the cards of the host,
    before any tensor is made) or "cpu" (backend Gloo).  backend="gloo"
    with device="cuda" runs Gloo's collectives on CUDA tensors, which lets
    several ranks share one card (NCCL refuses that)."""
    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        cards = torch.cuda.device_count()
        if backend == "nccl" and num_processes > cards:
            raise ValueError(f"NCCL needs one card per rank: {num_processes} ranks, {cards} cards")
        torch.cuda.set_device(process_id % cards)
    address = coordinator_address.removeprefix("tcp://")
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=num_processes, rank=process_id,
    )


def process_local_to_global(mesh, tree):
    """This rank's contiguous slab of the global batch (a tensor or nested
    tuples of them, batch axis 0) -> DTensors sharded on the mesh's batch
    axis, leaf by leaf; their full_tensor() is the global batch in rank
    order.  Every rank's slab must have the same length."""
    from torch.distributed.tensor import DTensor, Shard

    if isinstance(tree, tuple):
        return tuple(process_local_to_global(mesh, x) for x in tree)
    return DTensor.from_local(tree, mesh, [Shard(0)])

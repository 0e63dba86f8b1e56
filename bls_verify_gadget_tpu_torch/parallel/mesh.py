"""Mesh construction.

One logical axis ("batch") is all this workload needs: BLS verification is
embarrassingly parallel over signatures, and the only cross-rank reductions
are point sums (aggregation) and the signer count.  Each rank of the
process group (distributed.initialize) is one member of the mesh: one card
per rank under NCCL, a CPU process under Gloo.
"""

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

batch_axis = "batch"


def make_mesh(n_devices: int | None = None, devices=None, device: str | None = None):
    """1-D DeviceMesh, its one dimension named `batch_axis`, over the given
    ranks (`devices`), or the first `n_devices` ranks of the world, or the
    whole world.  Every rank of the world calls it.

    The mesh's device type is `device`, else `cuda` when the process group
    is NCCL and `cpu` when it is Gloo; Gloo also carries CUDA tensors when
    the caller asks for device="cuda".  Raises if the world holds fewer
    ranks than asked: a silently smaller mesh would make every multi-rank
    run vacuous."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call parallel.distributed.initialize")
    world = dist.get_world_size()
    if devices is None:
        if n_devices is not None and world < n_devices:
            raise ValueError(
                f"make_mesh: requested {n_devices} ranks but the world has only {world}; "
                "start one process per rank (parallel.launch)"
            )
        devices = list(range(world if n_devices is None else n_devices))
    elif n_devices is not None and len(devices) != n_devices:
        raise ValueError(f"make_mesh: {len(devices)} ranks passed but n_devices={n_devices}")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device, torch.tensor(devices, dtype=torch.int), mesh_dim_names=(batch_axis,))

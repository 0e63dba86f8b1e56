"""Distribution layer of the port on torch.distributed: a 1-D device mesh,
sharded batch verification and cross-rank aggregation.  SPMD: every rank
calls each function on its own slab of the batch (mesh.py, api.py);
distributed.py joins a process to the group and launch.py spawns ranks."""

from .mesh import make_mesh, batch_axis  # noqa: F401
from .api import (  # noqa: F401
    make_sharded_verify,
    make_sharded_verify_staged,
    sharded_verify,
    sharded_aggregate_pubkeys,
    sharded_aggregate_signatures,
    sharded_masked_aggregate,
    sharded_masked_aggregate_verify,
)

"""Sharded scheme operations over a 1-D batch mesh, in SPMD form: every
rank of the mesh calls each function on its own slab of the batch (plain
tensors, batch axis 0, the same length on every rank) and gets what the
JAX package's function of the same name returns for the whole batch.

Patterns:
  * sharded_verify: pure data parallelism -- each rank verifies its slab
    of the (pk, msg, sig) batch; the verdicts are all-gathered so every
    rank holds the global (B,) vector.
  * sharded point aggregation: each rank folds its slab into one partial
    point sum, the partials are all-gathered in rank order and folded (a
    G1 partial is 3 x 24 limbs, 288 bytes): the point-sum analogue of a
    sum all-reduce, since Jacobian addition is not elementwise.  With the
    same number of shards the fold order, so the Jacobian limbs, are the
    JAX package's.
  * sharded_masked_aggregate_verify: the bitmap-gated pubkey fold across
    ranks, then one verification, on every rank.

The collectives are the list forms (all_gather, all_reduce), which both
NCCL and Gloo carry for CUDA tensors.
"""

import torch
import torch.distributed as dist

from ..models.bls import masked_sum
from ..ops import curve as CV
from ..ops import tower as T
from .mesh import batch_axis


def _group(mesh):
    return mesh.get_group(batch_axis)


def _all_gather(t, group):
    """Every rank's `t` (the same shape on each), concatenated on axis 0 in
    rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def _gather_verdicts(ok, group):
    """This rank's (n, ...) bool verdicts -> the global (world n, ...)
    vector on every rank.  Raises on every rank if the slabs differ in
    length."""
    sizes = _all_gather(torch.tensor([ok.shape[0]], device=ok.device), group)
    if (sizes != sizes[0]).any():
        raise ValueError(f"sharded verify: the ranks' slabs differ in length: {sizes.tolist()}")
    return _all_gather(ok.to(torch.uint8), group).bool()


def _gather_fold(ops, partial, group):
    """partial: this rank's partial sum with a leading axis of 1 -> the
    total over the mesh: all-gather the world's partials (one packed
    tensor each) and fold them in rank order."""
    shape = CV._coord_shape(ops, [partial])
    world = dist.get_world_size(group)
    packed = CV.pack_point(ops, partial).transpose(0, 1)  # (N, 3c, 24): rank-major once gathered
    gathered = _all_gather(packed, group).transpose(0, 1)
    return CV.pt_sum(ops, CV.unpack_point(ops, gathered.contiguous(), (world, *shape[1:])), 0)


def make_sharded_verify(bls, mesh, msg_len: int):
    """Batch verify over the mesh: run(pk, sig, msg) on this rank's slab
    -> the global (B,) bool verdicts on every rank."""
    group = _group(mesh)

    def run(pk_aff, sig_aff, msg_u8):
        return _gather_verdicts(bls.verify(pk_aff, sig_aff, msg_u8, msg_len), group)

    return run


def sharded_verify(bls, mesh, pk_aff, sig_aff, msg_u8, msg_len: int):
    """Batch verify over the mesh (one-shot convenience form)."""
    return make_sharded_verify(bls, mesh, msg_len)(pk_aff, sig_aff, msg_u8)


def make_sharded_verify_staged(bls, mesh, msg_len: int):
    """Stage-wise batch verify over the mesh: hash_to_g2 and the pairing
    test as two functions chained through device tensors, with the same
    result as make_sharded_verify.  run.stages = (hash_fn, pair_fn):
    hash_fn(msg) -> this rank's affine H(m); pair_fn(pk, sig, h) -> the
    global verdicts."""
    group = _group(mesh)

    def hash_fn(msg_u8):
        return bls.hash_stage(msg_u8, msg_len)

    def pair_fn(pk_aff, sig_aff, h_aff):
        return _gather_verdicts(bls.pairing_stage(pk_aff, sig_aff, h_aff), group)

    def run(pk_aff, sig_aff, msg_u8):
        return pair_fn(pk_aff, sig_aff, hash_fn(msg_u8))

    run.stages = (hash_fn, pair_fn)
    return run


def _keep(pt):
    """A point whose batch axis pt_sum dropped -> a leading axis of 1."""
    return T._tree(lambda c: c[None], pt)


def _sharded_point_sum(ops, mesh, pts):
    local = CV.pt_sum(ops, pts, axis=0)
    return _gather_fold(ops, _keep(local), _group(mesh))


def sharded_aggregate_pubkeys(mesh, pk_jac):
    """Cross-rank G1 aggregation of this rank's Jacobian pubkeys: the sum
    over the whole batch, on every rank."""
    return _sharded_point_sum(CV.FP_OPS, mesh, pk_jac)


def sharded_aggregate_signatures(mesh, sig_jac):
    """Cross-rank G2 aggregation of this rank's Jacobian signatures."""
    return _sharded_point_sum(CV.FP2_OPS, mesh, sig_jac)


def sharded_masked_aggregate(mesh, pk_jac, bitmap):
    """Bitmap-gated cross-rank pubkey fold and signer count: the sum of
    pk_i where bitmap_i > 0, and the bitmap's values as uint32 summed mod
    2^32 over the batch (int64 in [0, 2^32), as
    BatchedBLS.aggregate_pubkeys_masked counts; NCCL has no uint32 sum).
    Returns (aggregated point, count), the same on every rank."""
    group = _group(mesh)
    local, count = masked_sum(pk_jac, bitmap, 0)
    total = _gather_fold(CV.FP_OPS, _keep(local), group)
    count = count.reshape(1)
    dist.all_reduce(count, group=group)
    return total, (count & 0xFFFFFFFF)[0]


def sharded_masked_aggregate_verify(bls, mesh, pk_jac, bitmap, sig_aff, msg_u8, msg_len: int):
    """Bitmap-gated aggregate, then one verification of the aggregate
    signature (a batch of one: sig_aff and msg_u8 with a leading axis of
    1), on every rank.  Returns (ok, signer count)."""
    apk, count = sharded_masked_aggregate(mesh, pk_jac, bitmap)
    ok = bls.verify(CV.pt_to_affine(CV.FP_OPS, _keep(apk)), sig_aff, msg_u8, msg_len)
    return ok[0], count

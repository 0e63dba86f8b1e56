"""Batched R1CS satisfiability checking on the device (counterpart of the
JAX package's r1cs/evaluator.py).

Constraint rows come from ConstraintSystem.to_arrays as fixed-width (R, W)
index / coefficient tables; evaluation is a batched sparse dot over the
witness tensor in Montgomery limb form:

    <A_i, w> * <B_i, w> == <C_i, w>   for every row i, every batch element.

With w and the coefficients both in Montgomery form, a Montgomery product
gives the Montgomery form of the product, sums stay in Montgomery form, and
mont_mul(A, B) = (a*b)R compares directly against C = cR.

Every dot product is one launch of the lc_dot kernel (ops/kernels.py):
check_satisfied runs three per chunk of rows and one mul; complete_witness
fills the LC-split partial sums one dependency level at a time, one
lc_dot and one index_copy_ per level, where the JAX package scans them
one variable at a time.  lc_dot_plain, the kernel's plain version, is here.
"""

import numpy as np
import torch

from .. import constants as C
from ..ops import kernels as K
from ..ops.fp import FP, resolve_device
from ..ops.limbs import ints_to_limbs

_PLAIN_ROWS = 1 << 18  # products per FP.mul_plain call of lc_dot_plain


def mont_limbs(values) -> np.ndarray:
    """Host ints -> (n, 24) int32 Montgomery limbs (numpy)."""
    m, r = C.P, FP.mont_r
    return ints_to_limbs([v % m * r % m for v in values], C.NLIMB)


def encode_witness(assignments, device="cuda") -> torch.Tensor:
    """Python-int assignment vector -> (num_vars, 24) Montgomery limbs."""
    return torch.from_numpy(mont_limbs(assignments)).to(resolve_device(device))


def encode_witness_batch(batch_assignments, device="cuda") -> torch.Tensor:
    """List of assignment vectors -> (B, num_vars, 24)."""
    return torch.stack([encode_witness(a, device) for a in batch_assignments])


def _encode_coeffs(coeff_obj: np.ndarray) -> np.ndarray:
    """(..., W) object array of python ints -> (..., W, 24) int32 Montgomery
    limbs.  Coefficient values repeat massively (0/1/-1, powers of two,
    256^i), so each distinct value is encoded once and gathered."""
    flat = [int(x) if x else 0 for x in coeff_obj.reshape(-1)]
    uniq = sorted(set(flat))
    lut = {v: i for i, v in enumerate(uniq)}
    idx = np.fromiter((lut[v] for v in flat), np.int64, len(flat))
    return mont_limbs(uniq)[idx].reshape(*coeff_obj.shape, C.NLIMB)


def prepare(arrays, device="cuda"):
    """to_arrays() output -> the device tables of check_satisfied and
    complete_witness (see stage)."""
    host = {"num_vars": arrays["num_vars"]}
    for side in "abc":
        host[f"{side}_idx"] = np.asarray(arrays[f"{side}_idx"], np.int32)
        host[f"{side}_coeff"] = _encode_coeffs(arrays[f"{side}_coeff"])
    for k in ("aux_var", "aux_row"):
        if k in arrays:
            host[k] = np.asarray(arrays[k], np.int32)
    return stage(host, device)


def _aux_levels(a_idx, aux_var, aux_row, num_vars: int) -> np.ndarray:
    """Dependency level of each LC-split partial sum: 0 if its binding row
    (tail * 1 = s, system._cap_row_widths) reads no other partial sum, else
    one more than the highest level it reads.  Sums of one level are
    independent of each other."""
    n = len(aux_var)
    pos = np.full(num_vars, -1, np.int64)
    pos[aux_var] = np.arange(n)
    ref = pos[a_idx[aux_row]]  # (N, W): the partial sums each row reads
    has = ref >= 0
    safe = np.where(has, ref, 0)
    level = np.zeros(n, np.int64)
    for _ in range(n + 1):
        nxt = np.where(has, level[safe] + 1, 0).max(axis=1)
        if np.array_equal(nxt, level):
            return level
        level = nxt
    raise ValueError("the LC-split partial sums depend on each other in a cycle")


def stage(host, device="cuda"):
    """Host tables (numpy: *_idx (R, W) int32, *_coeff (R, W, 24)
    Montgomery limbs, aux_var / aux_row, num_vars) -> the same as tensors on
    `device`, plus "levels": per dependency level of the partial sums (its
    variables, their binding rows' A-side idx and coeff), in the order
    complete_witness runs them."""
    dev = resolve_device(device)
    num_vars = int(host["num_vars"])
    out = {"num_vars": num_vars}
    for side in "abc":
        idx = np.asarray(host[f"{side}_idx"], np.int32)
        if idx.size and (idx.min() < 0 or idx.max() >= num_vars):
            raise ValueError(f"{side}_idx holds a variable outside 0..{num_vars - 1}")
        out[f"{side}_idx"] = torch.from_numpy(idx).to(dev)
        out[f"{side}_coeff"] = torch.from_numpy(
            np.asarray(host[f"{side}_coeff"]).astype(np.int32)).to(dev)
    aux_var = np.asarray(host.get("aux_var", np.zeros(0)), np.int64)
    aux_row = np.asarray(host.get("aux_row", np.zeros(0)), np.int64)
    out["aux_var"] = torch.from_numpy(aux_var.astype(np.int32)).to(dev)
    out["aux_row"] = torch.from_numpy(aux_row.astype(np.int32)).to(dev)
    levels = []
    if len(aux_var):
        a_idx = np.asarray(host["a_idx"])
        level = _aux_levels(a_idx, aux_var, aux_row, num_vars)
        a_coeff = np.asarray(host["a_coeff"]).astype(np.int32)
        for lv in range(int(level.max()) + 1):
            sel = np.nonzero(level == lv)[0]
            rows = aux_row[sel]
            levels.append((torch.from_numpy(aux_var[sel]).to(dev),
                           torch.from_numpy(a_idx[rows]).to(dev),
                           torch.from_numpy(a_coeff[rows]).to(dev)))
    out["levels"] = levels
    return out


def complete_witness(prepared, witness):
    """Materialise the LC-split partial sums on the device, in place.

    witness: (B, num_vars, 24) with the base (gadget-allocated) columns
    filled and the partial-sum columns arbitrary (e.g. zero).  Each partial
    sum is the A-side dot of its binding row; the levels run in order, so a
    row reads only sums already written.  The limbs are those of the JAX
    package's reverse scan.  Returns the witness."""
    for var, idx, coeff in prepared["levels"]:
        witness.index_copy_(1, var, _dot_rows(witness, idx, coeff))
    return witness


def _dot_rows(witness, idx, coeff):
    """witness (B, V, 24); idx (R, W); coeff (R, W, 24) -> (B, R, 24) mod-p
    row dot products: one lc_dot launch."""
    return K.lc_dot(FP, witness, idx, coeff)


def lc_dot_plain(w, idx, coeff):
    """Plain version of the lc_dot kernel: the witness columns gathered,
    FP.mul_plain by the coefficients and the products summed mod p by
    FP.add_plain in a halving tree -> (B, R, 24).  The terms go in blocks of
    at most _PLAIN_ROWS products."""
    b, r, width = w.shape[0], idx.shape[0], idx.shape[1]
    acc = torch.zeros((b, r, C.NLIMB), dtype=torch.int32, device=w.device)
    if b == 0 or r == 0:
        return acc
    idx = idx.long()
    step = max(1, _PLAIN_ROWS // (b * r))
    for lo in range(0, width, step):
        hi = min(lo + step, width)
        prods = FP.mul_plain(w[:, idx[:, lo:hi]], coeff[:, lo:hi].expand(b, r, hi - lo, C.NLIMB))
        while prods.shape[2] > 1:
            half = prods.shape[2] // 2
            s = FP.add_plain(prods[:, :, :half], prods[:, :, half:2 * half])
            prods = torch.cat([s, prods[:, :, 2 * half:]], 2)
        acc = FP.add_plain(acc, prods[:, :, 0])
    return acc


def check_satisfied(prepared, witness, chunk: int = 8192):
    """-> (B,) bool: every constraint row holds for every batch element.
    Per chunk of rows three lc_dot launches and one mul; a chunk past the
    last row is shorter (the JAX package pads it with zero rows, which
    hold)."""
    n_rows = prepared["a_idx"].shape[0]
    ok = torch.ones(witness.shape[0], dtype=torch.bool, device=witness.device)
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        a, b, c = (_dot_rows(witness, prepared[f"{s}_idx"][lo:hi], prepared[f"{s}_coeff"][lo:hi])
                   for s in "abc")
        ok &= FP.eq(FP.mul(a, b), c).all(-1)
    return ok

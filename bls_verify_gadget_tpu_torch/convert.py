"""Carry state across from the JAX package's numpy arrays.

The JAX package keeps field elements as uint32 (..., nlimb) arrays of
16-bit Montgomery limbs; the port keeps the same integers in torch.int32.
These helpers take numpy arrays (e.g. np.asarray of the JAX package's
encode_* outputs) and need nothing from that package.
"""

import numpy as np
import torch

from .models.bls import Params
from .ops.fp import resolve_device


def limbs_from_numpy(arr, device="cuda") -> torch.Tensor:
    """uint32 (..., nlimb) limb array -> int32 tensor on `device`."""
    arr = np.asarray(arr)
    if arr.size and int(arr.max()) > 0xFFFF:
        raise ValueError("limbs must be below 2^16")
    return torch.from_numpy(arr.astype(np.int32)).to(resolve_device(device))


def limbs_to_numpy(t) -> np.ndarray:
    """int32 limb tensor -> uint32 numpy array (the JAX package's dtype)."""
    return t.detach().cpu().numpy().astype(np.uint32)


def params_from_numpy(g1_x, g1_y, device="cuda") -> Params:
    """The port's Params from the JAX Params arrays (g1_x, g1_y)."""
    return Params(limbs_from_numpy(g1_x, device), limbs_from_numpy(g1_y, device))


def _tree(x, device):
    if isinstance(x, (tuple, list)):
        return tuple(_tree(v, device) for v in x)
    arr = np.asarray(x)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(resolve_device(device))
    return limbs_from_numpy(arr, device)


def scalars_from_numpy(arr, device="cuda") -> torch.Tensor:
    """The JAX package's encode_scalars array ((B, 16) uint32 raw Fr limbs)
    -> the port's (B, 16) int32 scalars on `device`."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.shape[-1] != 16:
        raise ValueError(f"expected (B, 16) scalar limbs, got {arr.shape}")
    return limbs_from_numpy(arr, device)


def points_from_numpy(pt, device="cuda"):
    """A JAX Jacobian point tuple, G1 (X, Y, Z) or G2 ((X0, X1), (Y0, Y1),
    (Z0, Z1)), of uint32 limb arrays -> the port's tuple on `device`."""
    return _tree(pt, device)


def bitmap_from_numpy(bitmap, device="cuda") -> torch.Tensor:
    """A participation bitmap (any integer or bool array) -> bool tensor of
    the elements > 0, the JAX package's selection."""
    return torch.from_numpy(np.asarray(bitmap) > 0).to(resolve_device(device))


def batch_from_numpy(pk_aff, sig_aff, msg_u8, device="cuda"):
    """The JAX package's encode_pubkeys / encode_signatures /
    encode_messages outputs (as numpy) -> the port's (pk_aff, sig_aff,
    msg_u8) on `device`."""
    msg = torch.from_numpy(np.asarray(msg_u8).astype(np.uint8)).to(resolve_device(device))
    return _tree(pk_aff, device), _tree(sig_aff, device), msg


def prepared_from_numpy(prepared, device="cuda"):
    """The JAX package's r1cs evaluator.prepare dict (numpy *_idx (R, W),
    *_coeff (R, W, 24) uint32 Montgomery limbs, aux_var, aux_row,
    num_vars) -> the port's prepared dict on `device` (its tables as
    tensors, and the partial sums' dependency levels)."""
    from .r1cs import evaluator

    host = {"num_vars": int(prepared["num_vars"])}
    for side in "abc":
        coeff = np.asarray(prepared[f"{side}_coeff"])
        if coeff.size and int(coeff.max()) > 0xFFFF:
            raise ValueError("limbs must be below 2^16")
        host[f"{side}_idx"] = np.asarray(prepared[f"{side}_idx"], np.int32)
        host[f"{side}_coeff"] = coeff.astype(np.int32)
    for k in ("aux_var", "aux_row"):
        if k in prepared:
            host[k] = np.asarray(prepared[k], np.int32)
    return evaluator.stage(host, device)

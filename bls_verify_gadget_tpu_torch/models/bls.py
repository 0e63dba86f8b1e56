"""Batched BLS verify on the device (ETH2 min-pubkey-size: pk in G1, sig in
G2), the counterpart of the JAX package's models/bls.py verify path.

Semantics mirror the reference: identity-pk rejection, on-curve and
subgroup checks for pk and sig, then e(-g1, sig) * e(pk, H(m)) == 1.
Invalid inputs are masked to False, never raised.

Every tensor lives on the instance's device: `cuda` unless the caller
passes device="cpu", where each kernel's plain PyTorch version runs.
Without a card, BatchedBLS() raises; it never falls back to the CPU.
"""

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..ops.fp import FP, resolve_device
from ..ops import tower as T
from ..ops import curve as CV
from ..ops import pairing as PR
from ..ops.hash_to_g2 import hash_to_g2_steps


@dataclasses.dataclass
class Params:
    """Scheme parameters: the G1 generator as affine Montgomery limbs
    (a host copy by default; BatchedBLS moves it to its device)."""

    g1_x: torch.Tensor | None = None
    g1_y: torch.Tensor | None = None

    def __post_init__(self):
        if self.g1_x is None:
            self.g1_x = FP.encode(C.G1_GEN[0], "cpu")
            self.g1_y = FP.encode(C.G1_GEN[1], "cpu")


class BatchedBLS:
    """Batch-first BLS verify over the torch ops on one device.  Batches
    are 1-D: pk (B, 24) limbs, sig Fp2 pairs of (B, 24), messages (B, L)."""

    def __init__(self, params: Params | None = None, device="cuda"):
        self.device = resolve_device(device)
        params = params or Params()
        self.params = Params(params.g1_x.to(self.device), params.g1_y.to(self.device))

    def _to(self, x):
        if isinstance(x, tuple):
            return tuple(self._to(v) for v in x)
        return x.to(self.device)

    @staticmethod
    def hash_parts(msg_len: int):
        """Stage 1 as its ordered parts [(name, fn)]: hash_to_g2's steps,
        then the affine conversion; each fn takes the previous part's
        output, the first the (B, msg_len) message bytes."""
        return [*hash_to_g2_steps(msg_len),
                ("pt_to_affine", lambda h: CV.pt_to_affine(CV.FP2_OPS, h))]

    def hash_stage(self, msg_u8, msg_len: int | None = None):
        """Stage 1 of verify: h = hash_to_g2(msg) as affine coordinates
        (x, y, is_inf) for the mixed-addition Miller loop."""
        msg_u8 = self._to(msg_u8)
        if msg_len is not None and msg_len != msg_u8.shape[-1]:
            raise ValueError(f"msg_len {msg_len} != message width {msg_u8.shape[-1]}")
        x = msg_u8
        for _, part in self.hash_parts(msg_u8.shape[-1]):
            x = part(x)
        return x

    def miller_stage(self, pk_aff, sig_aff, h_aff):
        """Stage 2a: validity checks + the shared two-pair Miller loop for
        e(-g1, sig) * e(pk, h).  Returns (f, checks_ok)."""
        pk_x, pk_y, pk_inf = self._to(pk_aff)
        sig_x, sig_y, sig_inf = self._to(sig_aff)
        h_x, h_y, h_inf = self._to(h_aff)

        pk_jac = CV.pt_from_affine(CV.FP_OPS, pk_x, pk_y, pk_inf)
        sig_jac = CV.pt_from_affine(CV.FP2_OPS, sig_x, sig_y, sig_inf)
        pk_ok = ~pk_inf & CV.pt_on_curve_affine(
            CV.FP_OPS, pk_x, pk_y, CV.FP_OPS.const(C.B_G1, pk_x)
        )
        sig_on_curve = CV.pt_on_curve_affine(
            CV.FP2_OPS, sig_x, sig_y, T._bcast(C.B_G2, sig_x)
        )
        sig_ok = sig_inf | sig_on_curve
        pk_ok = pk_ok & CV.g1_in_subgroup(pk_jac)
        sig_ok = sig_ok & (sig_inf | CV.g2_in_subgroup(sig_jac))

        neg_g1 = (
            self.params.g1_x.expand(pk_x.shape),
            FP.neg(self.params.g1_y.expand(pk_y.shape)),
        )
        f = PR.multi_miller_loop([
            (neg_g1, (sig_x, sig_y), ~sig_inf),
            ((pk_x, pk_y), (h_x, h_y), ~h_inf),
        ])
        return f, pk_ok & sig_ok

    def finalexp_stage(self, f, checks_ok):
        """Stage 2b: final exponentiation + the is-one test, masked by the
        stage-2a validity checks."""
        paired_one = T.fp12_is_one(PR.final_exponentiation(f))
        return paired_one & checks_ok

    def pairing_stage(self, pk_aff, sig_aff, h_aff):
        """Stage 2: validity checks + the pairing product test."""
        return self.finalexp_stage(*self.miller_stage(pk_aff, sig_aff, h_aff))

    def verify(self, pk_aff, sig_aff, msg_u8, msg_len: int | None = None):
        """Batched verification -> (B,) bool tensor.

        pk_aff  = (x, y, is_inf): affine G1 limb tensors + infinity mask
        sig_aff = ((x0, x1), (y0, y1), is_inf): affine G2 + infinity mask
        msg_u8  = (B, L) byte tensor, one length L for the whole batch

        Identity pk -> False; pk/sig off the curve or outside the subgroup
        -> False; else the pairing product test."""
        return self.pairing_stage(pk_aff, sig_aff, self.hash_stage(msg_u8, msg_len))


# ----------------------------------------------------------------------------
# host-side convenience: decoded points -> device batches
# ----------------------------------------------------------------------------

def encode_pubkeys(points, device="cuda"):
    """Host affine G1 points (int tuples / None) -> (x, y, is_inf)."""
    dev = resolve_device(device)
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    inf = torch.tensor([p is None for p in points], device=dev)
    return FP.encode(xs, dev), FP.encode(ys, dev), inf


def encode_signatures(points, device="cuda"):
    """Host affine G2 points -> ((x0, x1), (y0, y1), is_inf)."""
    dev = resolve_device(device)
    x = [(0, 0) if p is None else p[0] for p in points]
    y = [(1, 0) if p is None else p[1] for p in points]
    inf = torch.tensor([p is None for p in points], device=dev)
    return T.fp2_encode_batch(x, dev), T.fp2_encode_batch(y, dev), inf


def encode_messages(msgs, device="cuda"):
    """Equal-length host byte strings -> (B, L) uint8 tensor."""
    dev = resolve_device(device)
    L = len(msgs[0])
    if any(len(m) != L for m in msgs):
        raise ValueError("batch messages must share a length")
    arr = np.frombuffer(b"".join(msgs), np.uint8).reshape(len(msgs), L)
    return torch.from_numpy(arr.copy()).to(dev)

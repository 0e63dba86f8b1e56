"""Batched BLS on the device (ETH2 min-pubkey-size: pk in G1, sig in G2),
the counterpart of the JAX package's models/bls.py: keygen, sign, verify,
distinct-message aggregate verification and aggregation.

Semantics mirror the reference:
  * verify = identity-pk rejection + on-curve/subgroup checks for pk and
    sig + e(-g1, sig) * e(pk, H(m)) == 1; invalid inputs are masked to
    False, never raised;
  * sign = H(m) * sk, with zero keys flagged invalid;
  * aggregation = projective sums by a halving tree.

Every tensor lives on the instance's device: `cuda` unless the caller
passes device="cpu", where each kernel's plain PyTorch version runs.
Without a card, BatchedBLS() raises; it never falls back to the CPU.

Batch shapes are leading dims, as in the JAX package: the entry points
flatten them, run the kernels on one batch axis, and give the outputs the
operands' batch shape (less the summed axis, for the aggregates).
"""

import dataclasses

import numpy as np
import torch

from .. import constants as C
from ..ops.fp import FP, resolve_device
from ..ops import tower as T
from ..ops import curve as CV
from ..ops import pairing as PR
from ..ops.hash_to_g2 import hash_to_g2, hash_to_g2_steps
from ..ops.limbs import ints_to_limbs
from ..utils.config import config
from ..utils.profiling import named_scope


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


def _batch_shapes(x, trailing: int):
    """The batch shapes of a tensor with `trailing` non-batch dims, or of
    the tensors of a nested tuple (a bool mask has none)."""
    if isinstance(x, tuple):
        return set().union(*(_batch_shapes(c, trailing) for c in x))
    if x.dtype == torch.bool or not trailing:
        return {tuple(x.shape)}
    return {tuple(x.shape[:-trailing])}


def _batch(**operands):
    """The one batch shape of the named operands, each (value, trailing
    dims) with value a tensor or a nested tuple of them (limbs (..., 24),
    bytes (..., L), scalars (..., 16), masks and lengths (...)).  Raises a
    ValueError that names the operands where their shapes differ."""
    shapes = {name: _batch_shapes(x, k) for name, (x, k) in operands.items() if x is not None}
    found = set().union(*shapes.values())
    if len(found) != 1:
        raise ValueError("batch shapes differ: " + ", ".join(
            f"{name} {sorted(s)}" for name, s in shapes.items()))
    return found.pop()


def _flat(x, batch):
    """Tensors of batch shape `batch` (leading) -> one batch axis (as they
    are when it is one axis already: no walk on the host)."""
    if len(batch) == 1:
        return x
    return T._tree(lambda t: t.reshape(-1, *t.shape[len(batch):]), x)


def _unflat(x, batch):
    """One batch axis -> the batch shape `batch` (as _flat)."""
    if len(batch) == 1:
        return x
    return T._tree(lambda t: t.reshape(*batch, *t.shape[1:]), x)


class BatchedBLS:
    """Batch-first BLS over the torch ops on one device.  Batch shapes are
    leading dims (...): pk (..., 24) limbs, sig Fp2 pairs of (..., 24),
    messages (..., L), secret keys (..., 16) raw Fr limbs; the kernels run
    on them flattened to one axis."""

    def __init__(self, params: Params | None = None, device="cuda"):
        self.device = resolve_device(device)
        params = params or Params()
        self.params = Params(params.g1_x.to(self.device), params.g1_y.to(self.device))

    def _to(self, x):
        if isinstance(x, tuple):
            return tuple(self._to(v) for v in x)
        return x.to(self.device)

    def _msg(self, msg_u8, msg_len, msg_lens=None):
        """-> (messages, per-element lengths or None) on the device: msg_len,
        where given, is the width; msg_lens the messages' batch shape of
        lengths."""
        msg_u8 = self._to(msg_u8)
        if msg_len is not None and msg_len != msg_u8.shape[-1]:
            raise ValueError(f"msg_len {msg_len} != message width {msg_u8.shape[-1]}")
        if msg_lens is not None:
            msg_lens = self._to(torch.as_tensor(msg_lens))
            if tuple(msg_lens.shape) != tuple(msg_u8.shape[:-1]):
                raise ValueError(f"msg_lens must be of the messages' batch shape "
                                 f"{tuple(msg_u8.shape[:-1])}, got {tuple(msg_lens.shape)}")
        return msg_u8, msg_lens

    # ------------------------------------------------------------------
    # keygen / sign
    # ------------------------------------------------------------------

    def derive_pubkeys(self, sk_limbs):
        """sk_limbs: (..., 16) raw (non-Montgomery) Fr limbs -> G1 Jacobian
        pubkeys [sk]g1: ONE pt_mul_var launch over 255 bits."""
        sk = self._to(sk_limbs)
        batch = tuple(sk.shape[:-1])
        sk = _flat(sk, batch)
        gen = CV.g1_generator((sk.shape[0], C.NLIMB), self.device)
        return _unflat(CV.pt_mul_var(CV.FP_OPS, gen, sk, 255), batch)

    def hash_to_g2(self, msg_u8, msg_len: int | None = None, msg_lens=None):
        """H(m) as a Jacobian G2 point.  `msg_lens` (per-element byte
        lengths) enables mixed-length batches; msg_len is then the padded
        width."""
        msg_u8, msg_lens = self._msg(msg_u8, msg_len, msg_lens)
        batch = tuple(msg_u8.shape[:-1])
        lens = None if msg_lens is None else _flat(msg_lens, batch)
        return _unflat(hash_to_g2(_flat(msg_u8, batch), msg_u8.shape[-1], lens=lens), batch)

    def sign(self, sk_limbs, msg_u8, msg_len: int | None = None, msg_lens=None):
        """-> (sig Jacobian G2 [sk]H(m), valid mask): ONE pt_mul_var launch
        after the hash.  Zero keys give valid = False (the reference
        rejects them).  `msg_lens` as in hash_to_g2."""
        sk = self._to(sk_limbs)
        batch = _batch(sk_limbs=(sk, 1), msg_u8=(self._to(msg_u8), 1))
        h = _flat(self.hash_to_g2(msg_u8, msg_len, msg_lens), batch)
        sig = CV.pt_mul_var(CV.FP2_OPS, h, _flat(sk, batch), 255)
        return _unflat(sig, batch), ~(sk == 0).all(-1)

    # ------------------------------------------------------------------
    # verify
    # ------------------------------------------------------------------

    @staticmethod
    def hash_parts(msg_len: int, msg_lens=None):
        """Stage 1 as its ordered parts [(name, fn)]: hash_to_g2's steps,
        then the affine conversion; each fn takes the previous part's
        output, the first the (B, msg_len) message bytes (with msg_lens,
        each row's first msg_lens bytes)."""
        return [*hash_to_g2_steps(msg_len, lens=msg_lens),
                ("pt_to_affine", lambda h: CV.pt_to_affine(CV.FP2_OPS, h))]

    def hash_stage(self, msg_u8, msg_len: int | None = None, msg_lens=None):
        """Stage 1 of verify: h = hash_to_g2(msg) as affine coordinates
        (x, y, is_inf) for the mixed-addition Miller loop.  `msg_lens`
        (per-element byte lengths) enables mixed-length batches; msg_len is
        then the padded width."""
        msg_u8, msg_lens = self._msg(msg_u8, msg_len, msg_lens)
        batch = tuple(msg_u8.shape[:-1])
        lens = None if msg_lens is None else _flat(msg_lens, batch)
        x = _flat(msg_u8, batch)
        with named_scope("bls_hash_to_g2"):
            for _, part in self.hash_parts(msg_u8.shape[-1], lens):
                x = part(x)
        return _unflat(x, batch)

    def miller_stage(self, pk_aff, sig_aff, h_aff):
        """Stage 2a: validity checks + the shared two-pair Miller loop for
        e(-g1, sig) * e(pk, h).  Returns (f, checks_ok)."""
        pk_aff, sig_aff, h_aff = self._to(pk_aff), self._to(sig_aff), self._to(h_aff)
        batch = _batch(pk_aff=(pk_aff, 1), sig_aff=(sig_aff, 1), h_aff=(h_aff, 1))
        pk_x, pk_y, pk_inf = _flat(pk_aff, batch)
        sig_x, sig_y, sig_inf = _flat(sig_aff, batch)
        h_x, h_y, h_inf = _flat(h_aff, batch)
        with named_scope("bls_validity_checks"):
            pk_ok, sig_ok = _point_checks((pk_x, pk_y, pk_inf), (sig_x, sig_y, sig_inf),
                                          config.check_subgroups)

        with named_scope("bls_miller_loop"):
            neg_g1 = (
                self.params.g1_x.expand(pk_x.shape),
                FP.neg(self.params.g1_y.expand(pk_y.shape)),
            )
            f = PR.multi_miller_loop([
                (neg_g1, (sig_x, sig_y), ~sig_inf),
                ((pk_x, pk_y), (h_x, h_y), ~h_inf),
            ])
        return _unflat((f, pk_ok & sig_ok), batch)

    def finalexp_stage(self, f, checks_ok):
        """Stage 2b: final exponentiation + the is-one test, masked by the
        stage-2a validity checks."""
        batch = _batch(f=(f, 1), checks_ok=(checks_ok, 0))
        f, checks_ok = _flat((f, checks_ok), batch)
        with named_scope("bls_final_exp"):
            paired_one = T.fp12_is_one(PR.final_exponentiation(f))
        return _unflat(paired_one & checks_ok, batch)

    def pairing_stage(self, pk_aff, sig_aff, h_aff):
        """Stage 2: validity checks + the pairing product test."""
        return self.finalexp_stage(*self.miller_stage(pk_aff, sig_aff, h_aff))

    def verify(self, pk_aff, sig_aff, msg_u8, msg_len: int | None = None, msg_lens=None):
        """Batched verification -> (...,) bool tensor.

        pk_aff   = (x, y, is_inf): affine G1 limb tensors + infinity mask
        sig_aff  = ((x0, x1), (y0, y1), is_inf): affine G2 + infinity mask
        msg_u8   = (..., L) byte tensor
        msg_lens = optional (...,) per-element byte lengths for mixed-length
                   batches (msg_u8 is then padded to L)

        The operands share one batch shape (...); else ValueError.
        Identity pk -> False; pk/sig off the curve or outside the subgroup
        -> False; else the pairing product test.  With
        config.check_subgroups off, the subgroup checks are skipped, for
        callers that check their inputs beforehand."""
        _batch(pk_aff=(pk_aff, 1), sig_aff=(sig_aff, 1), msg_u8=(msg_u8, 1),
               msg_lens=(None if msg_lens is None else torch.as_tensor(msg_lens), 0))
        return self.pairing_stage(pk_aff, sig_aff, self.hash_stage(msg_u8, msg_len, msg_lens))

    def aggregate_verify_distinct(self, pk_aff, sig_aff, msg_u8, msg_len: int | None = None):
        """Distinct-message aggregate verification (IETF AggregateVerify):
        n pubkeys sign n messages of one length, one aggregated signature.

        pk_aff: (x, y, inf) over the n pubkeys; sig_aff: the aggregated G2
        signature with a leading dim of 1; msg_u8: (n, L).  The n + 1 pairs
        (pk_i, H(m_i)) and (-g1, sig) ride the batch axis of ONE one-pair
        Miller loop, then an fp12_mul halving tree and one final
        exponentiation.  Returns a 0-dim bool tensor: false if any pk is
        the identity or fails its checks, or sig fails its checks."""
        pk_x, pk_y, pk_inf = self._to(pk_aff)
        sig_x, sig_y, sig_inf = self._to(sig_aff)
        pk_ok, sig_ok = _point_checks((pk_x, pk_y, pk_inf), (sig_x, sig_y, sig_inf))
        h_x, h_y, h_inf = self.hash_stage(msg_u8, msg_len)

        def cat(a, b):
            return torch.cat([a, b[:1]])

        p_x = cat(pk_x, self.params.g1_x[None])
        p_y = cat(pk_y, FP.neg(self.params.g1_y)[None])
        q_x = (cat(h_x[0], sig_x[0]), cat(h_x[1], sig_x[1]))
        q_y = (cat(h_y[0], sig_y[0]), cat(h_y[1], sig_y[1]))
        f = PR.multi_miller_loop([((p_x, p_y), (q_x, q_y), cat(~h_inf, ~sig_inf))])
        total = T._tree(lambda c: c[None], T.fp12_prod(f))
        paired_one = T.fp12_is_one(PR.final_exponentiation(total))[0]
        return paired_one & pk_ok.all() & sig_ok.all()

    # ------------------------------------------------------------------
    # aggregation
    # ------------------------------------------------------------------

    def aggregate_pubkeys(self, pk_jac, axis: int = 0):
        """Projective sum of G1 Jacobian pubkeys over a batch axis: ONE
        pt_add launch per tree level.  The axis is dropped from the batch
        shape.  Empty input is the host's concern."""
        pk_jac = self._to(pk_jac)
        return CV.pt_sum(CV.FP_OPS, pk_jac, _batch_axis(_batch(pk_jac=(pk_jac, 1)), axis))

    def aggregate_signatures(self, sig_jac, axis: int = 0):
        """Projective sum of G2 Jacobian signatures over a batch axis."""
        sig_jac = self._to(sig_jac)
        return CV.pt_sum(CV.FP2_OPS, sig_jac, _batch_axis(_batch(sig_jac=(sig_jac, 1)), axis))

    def aggregate_pubkeys_masked(self, pk_jac, bitmap, axis: int = 0):
        """Bitmap-gated aggregation: the sum of pk_i where bitmap_i > 0
        (the others replaced by the infinity), and the count, the JAX
        package's: the bitmap's values as uint32 summed mod 2^32 (int64
        here, in [0, 2^32)) -- the device analogue of the reference's
        mapped_aggregate."""
        pk_jac, bitmap = self._to(pk_jac), self._to(bitmap)
        axis = _batch_axis(_batch(pk_jac=(pk_jac, 1), bitmap=(bitmap, 0)), axis)
        return masked_sum(pk_jac, bitmap, axis)


def masked_sum(pk_jac, bitmap, axis: int = 0):
    """The sum over `axis` of the G1 Jacobian pk_i where bitmap_i > 0 (the
    others replaced by the infinity), and the count: the bitmap's values
    as uint32 summed mod 2^32 (int64 here, in [0, 2^32)), the JAX
    package's selection and count.  The selection compares the values in
    the bitmap's own dtype, so a float 0.5 selects its point."""
    bits = bitmap.to(torch.int64)  # integer bitmaps, uint32 too, as their values
    sel = bitmap > 0 if bitmap.is_floating_point() else bits > 0
    inf = CV.pt_infinity_like(CV.FP_OPS, pk_jac)
    masked = CV.pt_cmov(CV.FP_OPS, sel, pk_jac, inf)
    count = (bits & 0xFFFFFFFF).sum(axis) & 0xFFFFFFFF
    return CV.pt_sum(CV.FP_OPS, masked, axis), count


def _batch_axis(batch, axis: int) -> int:
    """A batch axis (negative counts from the last) -> its index."""
    if not -len(batch) <= axis < len(batch):
        raise ValueError(f"axis {axis} is not a batch axis of batch shape {batch}")
    return axis % len(batch)


def _point_checks(pk_aff, sig_aff, subgroups: bool = True):
    """Per-element validity of affine pubkeys and signatures: pk not the
    identity, on the curve and in the subgroup; sig the identity, or on the
    curve and in the subgroup.  `subgroups` False skips the two subgroup
    checks (config.check_subgroups)."""
    pk_x, pk_y, pk_inf = pk_aff
    sig_x, sig_y, sig_inf = sig_aff
    pk_jac = CV.pt_from_affine(CV.FP_OPS, pk_x, pk_y, pk_inf)
    sig_jac = CV.pt_from_affine(CV.FP2_OPS, sig_x, sig_y, sig_inf)
    pk_ok = ~pk_inf & CV.pt_on_curve_affine(
        CV.FP_OPS, pk_x, pk_y, CV.FP_OPS.const(C.B_G1, pk_x)
    )
    sig_on_curve = CV.pt_on_curve_affine(
        CV.FP2_OPS, sig_x, sig_y, T._bcast(C.B_G2, sig_x)
    )
    sig_ok = sig_inf | sig_on_curve
    if subgroups:
        pk_ok = pk_ok & CV.g1_in_subgroup(pk_jac)
        sig_ok = sig_ok & (sig_inf | CV.g2_in_subgroup(sig_jac))
    return pk_ok, sig_ok


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


def encode_scalars(sks, device="cuda"):
    """Host ints -> (B, 16) int32 raw (non-Montgomery) Fr limbs, reduced
    mod r."""
    dev = resolve_device(device)
    return torch.from_numpy(ints_to_limbs([s % C.R for s in sks], C.NLIMB_FR)).to(dev)


def encode_messages(msgs, device="cuda"):
    """Equal-length host byte strings -> (B, L) uint8 tensor."""
    dev = resolve_device(device)
    L = len(msgs[0])
    if any(len(m) != L for m in msgs):
        raise ValueError("batch messages must share a length")
    arr = np.frombuffer(b"".join(msgs), np.uint8).reshape(len(msgs), L)
    return torch.from_numpy(arr.copy()).to(dev)


def encode_messages_var(msgs, pad_to: int | None = None, device="cuda"):
    """Host byte strings of any lengths -> (msg (B, L) uint8, lens (B,)
    int32, L): zero-padded to the batch's longest (or to `pad_to`), with
    the per-element byte lengths that hash_to_g2, sign, hash_stage and
    verify take as `msg_lens`."""
    dev = resolve_device(device)
    L = max((len(m) for m in msgs), default=0) if pad_to is None else pad_to
    if any(len(m) > L for m in msgs):
        raise ValueError(f"a message is longer than pad_to = {L} bytes")
    buf = np.zeros((len(msgs), L), np.uint8)
    for i, m in enumerate(msgs):
        buf[i, : len(m)] = np.frombuffer(m, np.uint8)
    lens = np.array([len(m) for m in msgs], np.int32)
    return torch.from_numpy(buf).to(dev), torch.from_numpy(lens).to(dev), L

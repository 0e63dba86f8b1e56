"""Batch-parallel device replay of a circuit's witness-generation tape
(counterpart of the JAX package's r1cs/witness_vm.py).

ConstraintSystem.record() captures, at every allocation site, how the new
witnesses derive from LCs over earlier variables (input / mul / xor / bits
/ inv / inv0 / fp2inv0 / fp2inv0z / fp2div0 / fp6inv / fp12inv / sqrt2).
compile_tape() wave-schedules the entries by data dependency and groups
same-kind/same-shape entries per wave, as the JAX package does, and stages
every group's tables on the device once; run_tape() executes the groups in
place on a (B, num_vars, 24) Montgomery witness for B independent inputs --
the host builds the circuit once, the device generates every proof's
assignment.

Each LC operand of a group is one lc_dot launch; the kinds then run on the
port's field kernels (mul, add, sub, fp2_mul, fp2_sqr, pow_win for every
inverse and the square roots, fp6_mul through fp12_inv), and the results
land in the witness by index_copy_.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import kernels as K
from ..ops import tower as T
from ..ops.fp import FP, resolve_device
from .evaluator import mont_limbs

NL = C.NLIMB


class CompiledTape:
    """The packed groups in run order, the witness width and the input
    variables (in tape order), on one device."""

    __slots__ = ("groups", "num_vars", "input_vars", "bit_table", "device")

    def __init__(self, groups, num_vars, input_vars, device):
        self.groups = groups
        self.num_vars = num_vars
        self.input_vars = input_vars
        self.device = device
        self.bit_table = FP.encode([0, 1], device)  # (2, NL)


def _bucket(n):
    b = 1
    while b < n:
        b *= 2
    return b


def _schedule(cs):
    """The JAX package's wave schedule: (groups in wave order, input vars).
    A group is every entry of one (wave, kind, meta, width bucket)."""
    wave_of = np.zeros(len(cs.assignments), np.int64)  # availability wave per var
    groups_map = {}
    input_vars = []
    order = []
    for e in cs.tape:
        kind = e["kind"]
        if kind == "input":
            input_vars.extend(e["outs"])
            continue
        deps = [i for lc in e["lcs"] for i, _ in lc]
        w = (max((wave_of[d] for d in deps), default=0)) + 1
        width = _bucket(max(1, max(len(lc) for lc in e["lcs"])))
        key = (int(w), kind, e["meta"], width)
        g = groups_map.get(key)
        if g is None:
            g = {"kind": kind, "meta": e["meta"], "width": width, "outs": [], "lcs": []}
            groups_map[key] = g
            order.append(key)
        g["outs"].append(e["outs"])
        g["lcs"].append(e["lcs"])
        for o in e["outs"]:
            wave_of[o] = w
    order.sort(key=lambda k: k[0])
    return [groups_map[k] for k in order], input_vars


def compile_tape(cs, device="cuda"):
    """Wave-schedule cs.tape and stage each group's tables on `device`:
    idx (n_ops, G, W) int32, coeff (n_ops, G, W, 24) Montgomery limbs, outs
    (G, n_outs) and its columns, as views of one buffer each (one copy to
    the device for the whole tape).  Each distinct coefficient is encoded
    once."""
    dev = resolve_device(device)
    V = len(cs.assignments)
    groups, input_vars = _schedule(cs)
    lut = {0: 0}
    idx_parts, cid_parts, out_parts = [], [], []
    for g in groups:
        G, n_ops, W = len(g["outs"]), len(g["lcs"][0]), g["width"]
        idx = np.zeros((n_ops, G, W), np.int32)
        cid = np.zeros((n_ops, G, W), np.int64)
        for gi, lcs in enumerate(g["lcs"]):
            for oi, lc in enumerate(lcs):
                for t, (v, co) in enumerate(lc):
                    idx[oi, gi, t] = v
                    cid[oi, gi, t] = lut.setdefault(co % C.P, len(lut))
        idx_parts.append(idx.reshape(-1))
        cid_parts.append(cid.reshape(-1))
        out_parts.append(np.asarray(g["outs"], np.int64).reshape(-1))
    if idx_parts and (min(p.min() for p in idx_parts if p.size) < 0
                      or max(p.max() for p in idx_parts if p.size) >= V):
        raise ValueError(f"the tape reads a variable outside 0..{V - 1}")
    cat = (lambda parts, dt: np.concatenate(parts) if parts else np.zeros(0, dt))
    table = mont_limbs(list(lut))  # dict order: the ids
    idx_d = torch.from_numpy(cat(idx_parts, np.int32)).to(dev)
    coeff_d = torch.from_numpy(table[cat(cid_parts, np.int64)]).to(dev)
    outs_d = torch.from_numpy(cat(out_parts, np.int64)).to(dev)
    packed, ti, to = [], 0, 0
    for g in groups:
        G, n_ops, W = len(g["outs"]), len(g["lcs"][0]), g["width"]
        n_outs = len(g["outs"][0])
        n, m = n_ops * G * W, G * n_outs
        outs = outs_d[to:to + m].view(G, n_outs)
        packed.append({
            "kind": g["kind"], "meta": g["meta"],
            "idx": idx_d[ti:ti + n].view(n_ops, G, W),
            "coeff": coeff_d[ti:ti + n].view(n_ops, G, W, NL),
            "outs": outs,
            "cols": [outs[:, k].contiguous() for k in range(n_outs)],
        })
        ti, to = ti + n, to + m
    return CompiledTape(packed, V, input_vars, dev)


def _eval_lcs(wit, idx, coeff):
    """wit (B, V, L); idx (n_ops, G, W); coeff (n_ops, G, W, L) -> n_ops
    (B, G, L) LC evaluations, one lc_dot launch each."""
    return [K.lc_dot(FP, wit, idx[oi], coeff[oi]) for oi in range(idx.shape[0])]


_BIT_POS = {}


def _bit_pos(nbits: int, device):
    """(limb of each bit, shift within it) for bits 0 .. nbits - 1."""
    key = (nbits, device)
    t = _BIT_POS.get(key)
    if t is None:
        pos = torch.arange(nbits, device=device)
        t = (pos // C.LIMB_BITS, (pos % C.LIMB_BITS).to(torch.int32))
        _BIT_POS[key] = t
    return t


def _fp2_inv0(d0, d1):
    """(d0 + d1 u)^-1 (or 0): conj / norm."""
    norm = FP.add(FP.mul(d0, d0), FP.mul(d1, d1))
    ninv = FP.pow_const(norm, C.P - 2)
    return FP.mul(d0, ninv), FP.neg(FP.mul(d1, ninv))


def _exec_group(kind, meta, bit_table, wit, idx, coeff, outs, cols):
    """Execute one group on the witness in place."""
    ev = _eval_lcs(wit, idx, coeff)

    def put(k, vals):
        wit.index_copy_(1, cols[k], vals)

    if kind == "mul":
        put(0, FP.mul(ev[0], ev[1]))
    elif kind == "xor":
        ab = FP.mul(ev[0], ev[1])
        put(0, FP.sub(FP.add(ev[0], ev[1]), FP.add(ab, ab)))
    elif kind == "bits":
        limb, shift = _bit_pos(meta, wit.device)
        std = FP.from_mont(ev[0])  # (B, G, L) standard limbs
        bits = (std[..., limb] >> shift) & 1  # (B, G, nbits)
        mont_bits = bit_table[bits.long()]  # (B, G, nbits, L)
        wit.index_copy_(1, outs.reshape(-1), mont_bits.reshape(wit.shape[0], -1, NL))
    elif kind == "inv":
        put(0, FP.pow_const(ev[0], C.P - 2))
    elif kind == "inv0":
        put(0, bit_table[FP.is_zero(ev[0]).long()])
        put(1, FP.pow_const(ev[0], C.P - 2))
    elif kind == "fp2inv0":
        i0, i1 = _fp2_inv0(ev[0], ev[1])
        put(0, i0)
        put(1, i1)
    elif kind == "fp2inv0z":
        d0, d1 = ev
        i0, i1 = _fp2_inv0(d0, d1)
        put(0, i0)
        put(1, i1)
        put(2, bit_table[(FP.is_zero(d0) & FP.is_zero(d1)).long()])
    elif kind == "fp2div0":
        n0, n1, d0, d1 = ev
        (lam,) = T.fp2_mul_pairs([((n0, n1), _fp2_inv0(d0, d1))])
        put(0, lam[0])
        put(1, lam[1])
    elif kind == "fp6inv":
        a6 = ((ev[0], ev[1]), (ev[2], ev[3]), (ev[4], ev[5]))
        for k, v in enumerate(c for f2 in T.fp6_inv(a6) for c in f2):
            put(k, v)
    elif kind == "fp12inv":
        a12 = (((ev[0], ev[1]), (ev[2], ev[3]), (ev[4], ev[5])),
               ((ev[6], ev[7]), (ev[8], ev[9]), (ev[10], ev[11])))
        for k, v in enumerate(c for c6 in T.fp12_inv(a12) for f2 in c6 for c in f2):
            put(k, v)
    elif kind == "sqrt2":
        from ..ops.hash_to_g2 import fp2_sqrt_candidates

        g10, g11, g20, g21 = ev
        s1, ok1 = fp2_sqrt_candidates((g10, g11))
        s2, _ = fp2_sqrt_candidates((g20, g21))
        y = T.fp2_cmov(ok1, s1, s2)
        put(0, bit_table[ok1.long()])
        put(1, y[0])
        put(2, y[1])
    else:
        raise ValueError(f"unknown tape kind {kind}")


def run_tape(ct: CompiledTape, input_limbs, batch: int):
    """input_limbs: (B, n_inputs, 24) Montgomery values for ct.input_vars
    (in that order), on ct's device.  Returns the (B, num_vars, 24)
    witness: variable 0 the one, the inputs, every tape output; any other
    column (a partial sum that to_arrays appended) zero."""
    wit = torch.zeros((batch, ct.num_vars, NL), dtype=torch.int32, device=ct.device)
    wit[:, 0, :] = FP.const("ONE", ct.device)
    if ct.input_vars:
        cols = torch.as_tensor(ct.input_vars, dtype=torch.int64, device=ct.device)
        wit.index_copy_(1, cols, input_limbs.to(torch.int32))
    for g in ct.groups:
        _exec_group(g["kind"], g["meta"], ct.bit_table, wit, g["idx"], g["coeff"],
                    g["outs"], g["cols"])
    return wit

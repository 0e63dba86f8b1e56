"""The port's witness VM (bls_verify_gadget_tpu_torch/r1cs/witness_vm.py)
against the JAX package's: the tape of one circuit, compiled by both,
gives the same group tables, and its replay for a batch of inputs gives
the JAX replay's limbs for every variable, which are each element's host
build encoded.  The arithmetic is integer: every comparison is exact."""

import random

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bls_verify_gadget_tpu.r1cs import witness_vm as JVM
from bls_verify_gadget_tpu_torch.ops.fp import FP
from bls_verify_gadget_tpu_torch.r1cs import evaluator as EV
from bls_verify_gadget_tpu_torch.r1cs import witness_vm as VM

from test_torch_r1cs import CIRCUITS, JAX, PORT

# map_to_curve alone (the JAX package's tests/test_witness_vm.py pattern),
# then the inverse, arithmetic and Miller-step circuits in one system
TAPES = {"map_to_curve": ("map_to_curve",),
         "inverses_arith_steps": ("fp6_inverse", "fp12_inverse", "fp_arith", "miller_steps")}


def _build(m, parts, seed):
    cs, rng = m.system.ConstraintSystem(), random.Random(seed)
    for name in parts:
        CIRCUITS[name](m, cs, rng)
    return cs


def _limbs_equal(jax_arr, t):
    got = np.asarray(jax_arr)
    assert got.shape == tuple(t.shape)
    assert np.array_equal(got.astype(np.int64), t.numpy().astype(np.int64))


@pytest.mark.parametrize("tape", list(TAPES))
def test_tape_replay_matches_jax(tape, monkeypatch):
    """One circuit defines the tape (seed 0); B = 2 elements with their own
    inputs (seeds 0 and 1) replay it in both packages.  The host builds
    that give each element's expected limbs take the square-root hint the
    device takes (see test_replay_takes_the_candidate_root)."""
    from bls_verify_gadget_tpu_torch.golden import field as GF

    parts = TAPES[tape]
    monkeypatch.setattr(GF, "fp2_sqrt", GF.fp2_sqrt_candidate_root)
    css = [_build(PORT, parts, s) for s in (0, 1)]
    jcs = _build(JAX, parts, 0)
    ct = VM.compile_tape(css[0], "cpu")
    jct = JVM.compile_tape(jcs)
    assert ct.input_vars == jct.input_vars
    assert len(ct.groups) == len(jct.groups)
    for g, jg in zip(ct.groups, jct.groups):
        assert (g["kind"], g["meta"]) == (jg["kind"], jg["meta"])
        _limbs_equal(jg["idx"], g["idx"])
        _limbs_equal(jg["coeff"], g["coeff"])
        _limbs_equal(jg["outs"], g["outs"])
    inputs = torch.stack([FP.encode([cs.assignments[v] for v in ct.input_vars], "cpu")
                          for cs in css])
    got = VM.run_tape(ct, inputs, 2)
    want = JVM.run_tape(jct, jnp.asarray(inputs.numpy().astype(np.uint32)), 2)
    _limbs_equal(want, got)
    assert torch.equal(got, EV.encode_witness_batch([cs.assignments for cs in css], "cpu"))


def test_replayed_tapes_cover_every_kind():
    kinds = {g["kind"] for parts in TAPES.values()
             for g in VM.compile_tape(_build(PORT, parts, 0), "cpu").groups}
    assert kinds == {"mul", "xor", "bits", "inv", "inv0", "fp2inv0", "fp2inv0z", "fp2div0",
                     "sqrt2", "fp6inv", "fp12inv"}


def test_replay_takes_the_candidate_root(monkeypatch):
    """The sqrt2 kind takes fp2_sqrt_candidates' root, in the port as in
    the JAX package; the builders' hint takes golden fp2_sqrt's, which is
    its negation for about half of all squares.  On an input where the two
    differ, the port's replay gives the JAX replay's limbs and those of the
    host build whose hint takes the candidate root; the plain host build
    differs from it, only where the hint's sign reaches, and both satisfy
    the circuit."""
    from bls_verify_gadget_tpu_torch.golden import field as GF

    def build_with(sqrt, seed):
        monkeypatch.setattr(GF, "fp2_sqrt", sqrt)
        return _build(PORT, ("map_to_curve",), seed)

    golden_sqrt = GF.fp2_sqrt
    seed = next(s for s in range(100)
                if build_with(golden_sqrt, s).assignments
                != build_with(GF.fp2_sqrt_candidate_root, s).assignments)
    cand = [build_with(GF.fp2_sqrt_candidate_root, s) for s in (seed, 0)]
    plain = build_with(golden_sqrt, seed)
    assert plain.is_satisfied() and cand[0].is_satisfied()
    assert plain.tape == cand[0].tape
    ct = VM.compile_tape(plain, "cpu")
    inputs = torch.stack([FP.encode([cs.assignments[v] for v in ct.input_vars], "cpu")
                          for cs in cand])
    got = VM.run_tape(ct, inputs, 2)
    want = JVM.run_tape(JVM.compile_tape(_build(JAX, ("map_to_curve",), seed)),
                        jnp.asarray(inputs.numpy().astype(np.uint32)), 2)
    _limbs_equal(want, got)
    assert torch.equal(got, EV.encode_witness_batch([cs.assignments for cs in cand], "cpu"))
    hinted = [v for e in plain.tape if e["kind"] == "sqrt2" for v in e["outs"][1:]]
    assert any(plain.assignments[v] != cand[0].assignments[v] for v in hinted)
    assert not torch.equal(got[0], EV.encode_witness(plain.assignments, "cpu"))

"""The port's R1CS device layer (bls_verify_gadget_tpu_torch/r1cs:
evaluator, device_witness; ops/hash_to_g2.py fp2_sqrt_candidates) against
the JAX package's, on the CPU: the lc_dot kernel's plain version against
JAX _dot_rows, complete_witness and check_satisfied against JAX on the
SHA-256 subcircuit, the SHA/XMD witness mirrors against JAX's (the witness
VM's replays: tests/test_torch_r1cs_vm.py).  The arithmetic is integer:
every comparison is exact (tolerance 0)."""

import random

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.ops.fp import FP as JFP
from bls_verify_gadget_tpu.ops import hash_to_g2 as JH
from bls_verify_gadget_tpu.r1cs import device_witness as JDW
from bls_verify_gadget_tpu.r1cs import evaluator as JEV
from bls_verify_gadget_tpu.r1cs.gadgets import UInt8 as JUInt8
from bls_verify_gadget_tpu.r1cs.sha256 import sha256_gadget as jsha_gadget
from bls_verify_gadget_tpu.r1cs.system import ConstraintSystem as JCS
from bls_verify_gadget_tpu_torch import convert
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops.fp import FP
from bls_verify_gadget_tpu_torch.r1cs import device_witness as DW
from bls_verify_gadget_tpu_torch.r1cs import evaluator as EV
from bls_verify_gadget_tpu_torch.r1cs.gadgets import UInt8
from bls_verify_gadget_tpu_torch.r1cs.sha256 import sha256_gadget

from test_torch_r1cs import PORT

P = JC.P
MSG_LEN = 24  # the JAX package's tools/bench_r1cs.py configuration


def _np(t):
    return t.numpy().astype(np.uint32)


def _limbs_equal(jax_arr, t):
    got = np.asarray(jax_arr)
    assert got.shape == tuple(t.shape)
    assert np.array_equal(got.astype(np.int64), t.numpy().astype(np.int64))


# ----------------------------------------------------------------------------
# lc_dot's plain version against the JAX package's _dot_rows
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 8, 1024])
def test_lc_dot_plain_matches_jax_dot_rows(width):
    rng = np.random.default_rng(width)
    B, V, R = 2, 37, 2 if width == 1024 else 16
    vals = [int(x) for x in rng.integers(0, 2**62, (B * V,))]
    vals[:4] = [0, P - 1, 1, P - 2]
    w_host = np.stack([JFP.encode([v * 0x9E3779B97F4A7C15 % P for v in vals[b * V:(b + 1) * V]])
                       for b in range(B)])
    w_host[:, 0] = JFP.encode([0])
    w_host[:, 1] = JFP.encode([P - 1])
    idx = rng.integers(0, V, (R, width)).astype(np.int32)
    idx[0, :2 if width > 1 else 1] = 1  # p - 1 times p - 1
    co = [[int(x) for x in row] for row in rng.integers(0, 2**62, (R, width))]
    co[0][0] = P - 1
    co[-1] = [0] * width  # a padding row
    if width > 2:
        co[1][1] = 0
    coeff_obj = np.array(co, dtype=object)
    jcoeff = JEV._encode_coeffs(coeff_obj)
    tcoeff = EV._encode_coeffs(coeff_obj)
    assert np.array_equal(np.asarray(jcoeff).astype(np.int32), tcoeff)
    want = JEV._dot_rows(jnp.asarray(w_host), jnp.asarray(idx), jnp.asarray(jcoeff))
    w = torch.from_numpy(w_host.astype(np.int32))
    got = EV.lc_dot_plain(w, torch.from_numpy(idx), torch.from_numpy(tcoeff))
    _limbs_equal(want, got)
    before = dict(K.COUNTS.launches)
    via_wrapper = K.lc_dot(FP, w, torch.from_numpy(idx), torch.from_numpy(tcoeff))
    assert torch.equal(via_wrapper, got)
    assert K.COUNTS.launches == before  # a CPU tensor runs the plain version


# ----------------------------------------------------------------------------
# evaluator on the SHA-256 subcircuit (24-byte messages, batch 2)
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sha_circuit():
    rng = random.Random(0x5A)
    msgs = [bytes(rng.randrange(256) for _ in range(MSG_LEN)) for _ in range(2)]
    css = []
    for m in msgs:
        cs = PORT.system.ConstraintSystem()
        sha256_gadget(cs, [UInt8.alloc(cs, b) for b in m])
        n_base = len(cs.assignments)
        arrays = cs.to_arrays()
        css.append(cs)
        jcs = JCS()
        jsha_gadget(jcs, [JUInt8.alloc(jcs, b) for b in m])
        jarrays = jcs.to_arrays()
    return {"msgs": msgs, "cs": css, "n_base": n_base, "prepared": EV.prepare(arrays, "cpu"),
            "jprepared": JEV.prepare(jarrays)}


def test_prepared_from_numpy_gives_the_ports_prepare(sha_circuit):
    ours, jp = sha_circuit["prepared"], sha_circuit["jprepared"]
    theirs = convert.prepared_from_numpy(jp, "cpu")
    assert set(ours) == set(theirs)
    for k in ("a_idx", "b_idx", "c_idx", "a_coeff", "b_coeff", "c_coeff", "aux_var", "aux_row"):
        assert torch.equal(ours[k], theirs[k]), k
        _limbs_equal(jp[k], ours[k])
    assert ours["num_vars"] == theirs["num_vars"] == jp["num_vars"]
    assert len(ours["levels"]) == len(theirs["levels"]) > 1
    for a, b in zip(ours["levels"], theirs["levels"]):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_aux_levels_read_only_earlier_levels(sha_circuit):
    """Every partial sum's binding row reads partial sums of lower levels
    only, and each is written once."""
    prep = sha_circuit["prepared"]
    level_of = {}
    for lv, (var, _, _) in enumerate(prep["levels"]):
        for v in var.tolist():
            assert v not in level_of
            level_of[v] = lv
    assert sorted(level_of) == sorted(prep["aux_var"].tolist())
    for lv, (_, idx, _) in enumerate(prep["levels"]):
        for v in idx.reshape(-1).tolist():
            assert level_of.get(v, -1) < lv


def test_complete_witness_gives_the_limbs_of_jax_scan(sha_circuit):
    prep, jp, n_base = sha_circuit["prepared"], sha_circuit["jprepared"], sha_circuit["n_base"]
    full = EV.encode_witness_batch([cs.assignments for cs in sha_circuit["cs"]], "cpu")
    base = full.clone()
    base[:, n_base:] = 0
    got = EV.complete_witness(prep, base.clone())
    want = JEV.complete_witness(jp, jnp.asarray(_np(base)))
    _limbs_equal(want, got)
    assert torch.equal(got, full)  # the host capping's values


def test_check_satisfied_agrees_with_jax(sha_circuit):
    prep, jp = sha_circuit["prepared"], sha_circuit["jprepared"]
    full = EV.encode_witness_batch([cs.assignments for cs in sha_circuit["cs"]], "cpu")
    bad = full[1:].clone()
    bad[0, sha_circuit["n_base"] - 3] = DW.witness_table("cpu")[2]
    wit = torch.cat([full, bad])  # element 2 corrupted
    want = [True, True, False]
    assert EV.check_satisfied(prep, wit, chunk=4096).tolist() == want
    assert np.asarray(JEV.check_satisfied(jp, _np(wit), chunk=4096)).tolist() == want


def test_sha_subcircuit_witness_from_the_device_mirror(sha_circuit):
    """The bench_r1cs witness: the one, the message bit planes, the mirror's
    SHA segment, then complete_witness: equal to the host assignments."""
    msgs = torch.tensor([list(m) for m in sha_circuit["msgs"]])
    tab = DW.witness_table("cpu")
    bits = ((msgs[:, :, None] >> torch.arange(8)) & 1).reshape(2, -1)
    idx = torch.cat([torch.ones((2, 1), dtype=torch.int64), bits,
                     DW.sha256_gadget_witness_indices(msgs, MSG_LEN)], 1)
    prep = sha_circuit["prepared"]
    wit = torch.zeros((2, prep["num_vars"], 24), dtype=torch.int32)
    wit[:, :idx.shape[1]] = tab[idx]
    EV.complete_witness(prep, wit)
    want = EV.encode_witness_batch([cs.assignments for cs in sha_circuit["cs"]], "cpu")
    assert torch.equal(wit, want)


# ----------------------------------------------------------------------------
# device witness mirrors: the indices of the JAX package's
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("msg_len", [24, 100])  # one SHA block, two
def test_sha_witness_indices_match_jax(msg_len):
    rng = np.random.default_rng(msg_len)
    msgs = rng.integers(0, 256, (2, msg_len))
    got = DW.sha256_gadget_witness_indices(torch.from_numpy(msgs), msg_len)
    want = JDW.sha256_gadget_witness_indices(jnp.asarray(msgs.astype(np.uint32)), msg_len)
    _limbs_equal(want, got)
    cs = PORT.system.ConstraintSystem()
    mv = [UInt8.alloc(cs, int(b)) for b in msgs[0]]
    start = len(cs.assignments)
    sha256_gadget(cs, mv)
    lut = {0: 0, 1: 1, P - 1: 2}
    assert got[0].tolist() == [lut[v] for v in cs.assignments[start:]]
    limbs = DW.sha256_gadget_witness_limbs(torch.from_numpy(msgs), msg_len)
    assert torch.equal(limbs[0], EV.encode_witness(cs.assignments[start:], "cpu"))


def test_xmd_witness_indices_match_jax():
    rng = np.random.default_rng(7)
    msgs = rng.integers(0, 256, (2, 16))
    got = DW.xmd_witness_indices(torch.from_numpy(msgs), 16, JC.DST_G2, 64)
    want = JDW.xmd_witness_indices(jnp.asarray(msgs.astype(np.uint32)), 16, JC.DST_G2, 64)
    _limbs_equal(want, got)


# ----------------------------------------------------------------------------
# square roots
# ----------------------------------------------------------------------------

def test_fp2_sqrt_candidates_match_jax():
    """The same root and flag as the JAX function, on squares (random
    squares, 0, real and imaginary ones) and non-squares."""
    rng = random.Random(0x5027)
    vals = []
    for _ in range(4):
        r = (rng.randrange(P), rng.randrange(P))
        vals.append(((r[0] * r[0] - r[1] * r[1]) % P, 2 * r[0] * r[1] % P))  # r^2
        vals.append((rng.randrange(P), rng.randrange(P)))
    vals += [(0, 0), (4, 0), (P - 4, 0), (0, 1), (0, P - 1), (1, 1)]
    a0, a1 = [v[0] for v in vals], [v[1] for v in vals]
    js, jok = jax.jit(JH.fp2_sqrt_candidates)((jnp.asarray(JFP.encode(a0)),
                                               jnp.asarray(JFP.encode(a1))))
    ts, tok = H.fp2_sqrt_candidates((FP.encode(a0, "cpu"), FP.encode(a1, "cpu")))
    assert tok.tolist() == np.asarray(jok).tolist()
    assert tok.sum() >= 6 and (~tok).sum() >= 1
    _limbs_equal(js[0], ts[0])
    _limbs_equal(js[1], ts[1])

"""The port's utils/profiling.py against the JAX package's: the op counter
(keys, weights, nesting), the records of the field ops and of every fused
kernel's wrapper, named ranges in a torch.profiler trace, and the Chrome
trace export.  All on the CPU at a few elements; counts are compared
exactly.

The slow test counts one default verify, one step-wise verify and one sign
live in both packages (the JAX count is an eval_shape with the fused
kernels' records on, ~6-10 minutes a call) and holds the port and
tests/data/jax_op_counts.json to it.  The tier-1 tests hold the port's
count of the same calls to that file inside test_torch_verify.py,
test_torch_step_pairing.py and test_torch_sign_aggregate.py, over CPU runs
they make anyway (tests/op_counts.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import op_counts
from bls_verify_gadget_tpu import utils as jutils
from bls_verify_gadget_tpu.ops.fp import FP as JFP, FR as JFR
from bls_verify_gadget_tpu.ops.pallas.kernels import FieldKernels
from bls_verify_gadget_tpu.r1cs import evaluator as jevaluator
from bls_verify_gadget_tpu.utils import profiling as jprofiling
from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch import utils
from bls_verify_gadget_tpu_torch.models.bls import BatchedBLS, encode_messages
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops.fp import FP, FR
from bls_verify_gadget_tpu_torch.utils import profiling

N = 3  # elements of each wrapper call


def test_utils_exports_as_jax():
    """utils exports named_scope, OpCounter, profile_trace and config, as
    the JAX package's utils does."""
    names = {"named_scope", "OpCounter", "profile_trace", "config"}
    assert names <= set(vars(jutils)) and names <= set(vars(utils))
    assert utils.named_scope is profiling.named_scope


def test_fp_mul_equivalent_matches_jax():
    counts = {"mul_24": 30006, "add_24": 71870, "sub_24": 91, "mul_16": 7,
              "add_16": 5, "sub_16": 3, "other": 11}
    got, want = profiling.OpCounter(), jprofiling.OpCounter()
    for kind, n in counts.items():
        got.add(kind, n)
        want.add(kind, n)
    assert got.fp_mul_equivalent() == want.fp_mul_equivalent()
    assert dict(got.counts) == dict(want.counts)
    c = profiling.OpCounter()
    c.add("mul_24", 30006)
    c.add("add_24", 71870)
    c.add("sub_24", 91)
    assert c.fp_mul_equivalent() == pytest.approx(37202.1, abs=1e-9)


def test_count_ops_nests_and_restores():
    assert profiling._active_counter is None
    with profiling.count_ops() as outer:
        profiling.record("mul_24", 2)
        with profiling.count_ops() as inner:
            profiling.record("mul_24", 5)
            with profiling.uncounted():
                profiling.record("mul_24", 100)
            profiling.record("add_24")
        assert profiling._active_counter is outer
        profiling.record("sub_24", 3)
    assert profiling._active_counter is None
    assert dict(outer.counts) == {"mul_24": 2, "sub_24": 3}
    assert dict(inner.counts) == {"mul_24": 5, "add_24": 1}


def test_record_outside_count_ops_changes_nothing():
    with profiling.count_ops() as c:
        pass
    profiling.record("mul_24", 7)
    FP.mul(torch.zeros(2, 24, dtype=torch.int32), torch.zeros(2, 24, dtype=torch.int32))
    assert not c.counts and profiling._active_counter is None


@pytest.mark.parametrize("op", ["add", "sub", "mul", "neg", "sqr"])
@pytest.mark.parametrize("field", ["fp", "fr"])
def test_field_ops_record_as_jax(op, field):
    """FP / FR add, sub and mul record one op per broadcast element, neg
    and sqr through sub and mul, as the JAX package's ModField does for
    the same shapes (traced with jax.eval_shape)."""
    pf, jf = (FP, JFP) if field == "fp" else (FR, JFR)
    shapes = [(2, 1), (3,)] if op not in ("neg", "sqr") else [(2, 3)]
    port = [torch.zeros(*s, pf.nlimb, dtype=torch.int32) for s in shapes]
    with profiling.count_ops() as got:
        getattr(pf, op)(*port)
    with jprofiling.count_ops() as want:
        jax.eval_shape(getattr(jf, op), *[jnp.zeros(s + (jf.nlimb,), jnp.uint32)
                                          for s in shapes])
    assert dict(got.counts) == dict(want.counts) and sum(got.counts.values()) == 6


def _segs():
    return CV.run_segments(C.ABS_X)


def _z(*shape):
    return torch.zeros(*shape, N, C.NLIMB, dtype=torch.int32)


def _j(n):
    return [jnp.zeros((N, C.NLIMB), jnp.uint32) for _ in range(n)]


_SQRT_NWIN = -(-len(K.pow_digits(H.SQRT_K)) // 8) * 8
_FP_DIGITS = K.pow_digits(C.P - 2)

# kernel -> (port wrapper call, JAX FieldKernels call), both on N elements
WRAPPERS = {
    "fp2_mul": (lambda: K.fp2_mul(FP, *[_z(1)[0]] * 4), lambda k: k.fp2_mul(*_j(4))),
    "fp2_sqr": (lambda: K.fp2_sqr(FP, *[_z(1)[0]] * 2), lambda k: k.fp2_sqr(*_j(2))),
    "fp6_mul": (lambda: K.fp6_mul(FP, _z(6), _z(6)), lambda k: k.fp6_mul(_j(6), _j(6))),
    "fp12_mul": (lambda: K.fp12_mul(FP, _z(12), _z(12)), lambda k: k.fp12_mul(_j(24))),
    "fp12_sqr": (lambda: K.fp12_sqr(FP, _z(12)), lambda k: k.fp12_sqr(_j(12))),
    "mul014": (lambda: K.mul014(FP, _z(12), _z(6)), lambda k: k.mul014(_j(18))),
    "dbl_step": (lambda: K.dbl_step(FP, _z(6), _z(2)), lambda k: k.dbl_step(_j(8))),
    "add_step": (lambda: K.add_step(FP, _z(6), _z(4), _z(2)), lambda k: k.add_step(_j(12))),
    "pt_dbl_g1": (lambda: K.pt_dbl(FP, _z(3), 5), lambda k: k.pt_dbl(_j(3), "fp", 5)),
    "pt_dbl_g2": (lambda: K.pt_dbl(FP, _z(6), 5), lambda k: k.pt_dbl(_j(6), "fp2", 5)),
    "pt_add_g1": (lambda: K.pt_add(FP, _z(3), _z(3)), lambda k: k.pt_add(_j(6), "fp")),
    "pt_add_g2": (lambda: K.pt_add(FP, _z(6), _z(6)), lambda k: k.pt_add(_j(12), "fp2")),
    "pt_mul_const_g1": (lambda: K.pt_mul_const(FP, _z(3), _segs()),
                        lambda k: k.pt_mul_const(_j(3), "fp", _segs())),
    "pt_mul_const_g2": (lambda: K.pt_mul_const(FP, _z(6), _segs()),
                        lambda k: k.pt_mul_const(_j(6), "fp2", _segs())),
    "pow_win_fp": (lambda: K.pow_win(FP, _z(1), C.P - 2),
                   lambda k: k.pow_win(_j(1), 1, _FP_DIGITS)),
    "pow_win_fp2": (lambda: K.pow_win(FP, _z(2), C.P - 2),
                    lambda k: k.pow_win(_j(2), 2, _FP_DIGITS)),
    "pow_win_fp2_sqrt": (lambda: K.pow_win(FP, _z(2), H.SQRT_K, _SQRT_NWIN),
                         lambda k: k.pow_win(_j(2), 2, K.pow_digits(H.SQRT_K), _SQRT_NWIN)),
    "sswu_map2": (lambda: K.sswu_map2(FP, _z(4)),
                  lambda k: k.sswu_map2(_j(4), None, K.pow_digits(H.SQRT_K), _FP_DIGITS)),
    "g2_cofactor": (lambda: K.g2_cofactor(FP, _z(6), _segs()),
                    lambda k: k.g2_cofactor(_j(6), None, _segs())),
    "pt_mul_var_g1": (lambda: K.pt_mul_var(FP, _z(3), _z(1)[0][:, :16], 255),
                      lambda k: k.pt_mul_var(_j(3), "fp", jnp.zeros((N, 16), jnp.uint32), 255)),
    "pt_mul_var_g2": (lambda: K.pt_mul_var(FP, _z(6), _z(1)[0][:, :16], 255),
                      lambda k: k.pt_mul_var(_j(6), "fp2", jnp.zeros((N, 16), jnp.uint32), 255)),
    "cyclo_sqr": (lambda: K.cyclo_sqr(FP, _z(12), 7), lambda k: k.cyclo_sqr(_j(12), 7)),
    "exp_x": (lambda: K.exp_x(FP, _z(12), _segs()), lambda k: k.exp_x(_j(12), _segs())),
    "miller_dbl_run_k1": (
        lambda: K.miller_dbl_run(FP, _z(12), _z(1, 6), _z(1), _z(1), _z(1)[..., 0] > 0, 9),
        lambda k: k.miller_dbl_run(_j(12 + 9), 1, 9)),
    "miller_dbl_run_k2": (
        lambda: K.miller_dbl_run(FP, _z(12), _z(2, 6), _z(2), _z(2), _z(2)[..., 0] > 0, 9),
        lambda k: k.miller_dbl_run(_j(12 + 18), 2, 9)),
    "miller_add_k1": (
        lambda: K.miller_add(FP, _z(12), _z(1, 6), _z(1, 4), _z(1), _z(1), _z(1)[..., 0] > 0),
        lambda k: k.miller_add(_j(12 + 13), 1)),
    "miller_add_k2": (
        lambda: K.miller_add(FP, _z(12), _z(2, 6), _z(2, 4), _z(2), _z(2), _z(2)[..., 0] > 0),
        lambda k: k.miller_add(_j(12 + 26), 2)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_fused_wrappers_record_as_jax(name, monkeypatch):
    """Each fused kernel's wrapper records, on a CPU call of N elements,
    what the JAX package's FieldKernels wrapper of the same kernel records
    for the same call (its kernel launch stubbed out; the port's plain
    version too, so that only the wrappers' records count)."""
    port_call, jax_call = WRAPPERS[name]
    monkeypatch.setattr(K, "_plain", lambda fn, *args: None)
    monkeypatch.setattr(FieldKernels, "_tower_call", lambda self, *a, **kw: None)
    monkeypatch.setattr(FieldKernels, "_fp2_call", lambda self, *a, **kw: None)
    with profiling.count_ops() as got:
        port_call()
    with jprofiling.count_ops() as want:
        jax_call(JFP.kernels)
    assert dict(got.counts) == dict(want.counts) and got.counts["mul_24"] > 0


def test_lc_dot_records_the_jax_evaluators_ops():
    """lc_dot records the FP.mul and FP.add that the JAX evaluator's row
    dot product (_dot_rows) records for the same rows: W products and W - 1
    additions per row and witness; xmd records nothing."""
    rng = np.random.default_rng(21)
    b, v, r, w = 2, 9, 5, 4
    idx = rng.integers(0, v, (r, w)).astype(np.int32)
    with profiling.count_ops() as got:
        K.lc_dot(FP, torch.zeros(b, v, C.NLIMB, dtype=torch.int32), torch.from_numpy(idx),
                 torch.zeros(r, w, C.NLIMB, dtype=torch.int32))
        K.xmd(torch.zeros(2, 32, dtype=torch.uint8), None, b"DST", 64)
    with jprofiling.count_ops() as want:
        jax.eval_shape(jevaluator._dot_rows, jnp.zeros((b, v, 24), jnp.uint32), jnp.asarray(idx),
                       jnp.zeros((r, w, 24), jnp.uint32))
    assert dict(got.counts) == dict(want.counts) == {"mul_24": b * r * w,
                                                     "add_24": b * r * (w - 1)}


def test_named_scope_ranges_in_profiler_events(monkeypatch):
    """The four stage ranges, named as the JAX package names them, and a
    decorated function's range show in a torch.profiler trace of a CPU
    verify of one element (no NVTX range here: CUDA is not in use).  The
    work inside the ranges is stubbed out (hash parts, point checks,
    Miller loop, final exponentiation): the profiler costs minutes on the
    plain versions' eager ops, and other tests hold the stages' results."""
    import bls_verify_gadget_tpu_torch.models.bls as M

    assert not profiling._nvtx_in_use()
    z = torch.zeros(1, C.NLIMB, dtype=torch.int32)
    ones = torch.ones(1, dtype=torch.bool)
    f = tuple(tuple((z, z) for _ in range(3)) for _ in range(2))
    h = ((z, z), (z, z), ~ones)
    monkeypatch.setattr(BatchedBLS, "hash_parts", staticmethod(lambda *a: [("h", lambda m: h)]))
    monkeypatch.setattr(M, "_point_checks", lambda *a: (ones, ones))
    monkeypatch.setattr(M.PR, "multi_miller_loop", lambda pairs: f)
    monkeypatch.setattr(M.PR, "final_exponentiation", lambda f: f)
    monkeypatch.setattr(M.T, "fp12_is_one", lambda f: ones)

    @profiling.named_scope("probe_range")
    def probe(x):
        return x + 1

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = BatchedBLS(device="cpu").verify((z, z, ~ones), h, encode_messages(
            [b"\x01" * 32], device="cpu"), 32)
        probe(torch.ones(2))
    assert out.tolist() == [True]
    names = {ev.name for ev in prof.events()}
    assert {"bls_hash_to_g2", "bls_validity_checks", "bls_miller_loop", "bls_final_exp",
            "probe_range"} <= names


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    with profiling.profile_trace(str(tmp_path / "trace")) as logdir:
        with profiling.named_scope("bls_final_exp"):
            FP.add(torch.zeros(2, 24, dtype=torch.int32), torch.zeros(2, 24, dtype=torch.int32))
    assert logdir == str(tmp_path / "trace")
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any(ev.get("name") == "bls_final_exp" for ev in trace["traceEvents"])


@pytest.mark.slow
@pytest.mark.parametrize("call", op_counts.CALLS)
def test_port_counts_equal_live_jax_counts(call, monkeypatch):
    """The JAX package's count_ops of `call` at batch 4, live (an
    eval_shape with the fused kernels' records on, tests/op_counts.py),
    equals tests/data/jax_op_counts.json and the port's count of the same
    call on the CPU, key by key."""
    want = op_counts.jax_counts(call, monkeypatch)
    assert want == op_counts.per_element(call)
    monkeypatch.undo()
    assert op_counts.port_counts(call, monkeypatch) == want

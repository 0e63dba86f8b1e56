"""Package rules of the PyTorch/CUDA port (bls_verify_gadget_tpu_torch):
it imports neither JAX nor the JAX package, builds nothing at import, and
its entry points run on the card unless given device="cpu" -- without a
card they raise instead of falling back."""

import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import sys
import bls_verify_gadget_tpu_torch
from bls_verify_gadget_tpu_torch import convert
from bls_verify_gadget_tpu_torch.models import bls
from bls_verify_gadget_tpu_torch.ops import curve, hash_to_g2, kernels, pairing, sha256, tower
from bls_verify_gadget_tpu_torch.golden import bls as golden_bls, codec, curve as golden_curve
from bls_verify_gadget_tpu_torch import native_codec
from bls_verify_gadget_tpu_torch.native import gen_constants
from bls_verify_gadget_tpu_torch.parallel import api, distributed, launch, mesh
from bls_verify_gadget_tpu_torch.ops.fp import FP
from bls_verify_gadget_tpu_torch.r1cs import (
    curve, device_witness, evaluator, fields, gadgets, hasher, pairing, sha256, system,
    verify, witness_vm,
)
from bls_verify_gadget_tpu_torch.utils import config
a = FP.encode([3, 5], "cpu")
assert FP.decode(FP.mul(a, a)) == [9, 25]
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bls_verify_gadget_tpu"))
print("BAD", bad)
print("LOADED", kernels._lib is not None or native_codec._lib is not None)
print("SOURCES", all((kernels.CSRC_DIR / n).is_file() for n in kernels.SOURCES)
      and set(kernels.UNITS) <= set(kernels.SOURCES))
"""


def test_port_imports_no_jax_and_builds_nothing():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    assert "LOADED False" in res.stdout, res.stdout
    assert "SOURCES True" in res.stdout, res.stdout


def test_source_imports_no_jax():
    pkg = ROOT / "bls_verify_gadget_tpu_torch"
    sources = [p for p in pkg.rglob("*.py") if p.relative_to(pkg).parts[0] != "build"]
    for path in sources + [ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("jax", "bls_verify_gadget_tpu.")), (path, line)
                assert words[1] != "bls_verify_gadget_tpu", (path, line)


def test_entry_points_need_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card behaviour")
    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_scalars,
    )
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import tower as T
    from bls_verify_gadget_tpu_torch.ops.fp import FP
    from bls_verify_gadget_tpu_torch.parallel import launch
    from bls_verify_gadget_tpu_torch.parallel.distributed import initialize

    for call in (
        BatchedBLS,
        lambda: launch.dryrun_multichip(1),
        lambda: launch.run_ranks(1, "bls_verify_gadget_tpu_torch.parallel.launch:dryrun_rank"),
        lambda: launch.main(["--dryrun", "1"]),
        lambda: initialize("localhost:1", 1, 0),
        lambda: encode_messages([b"ab"]),
        lambda: encode_scalars([1]),
        lambda: FP.encode([3]),
        lambda: T.fp2_encode((1, 2)),
        lambda: CV.g1_encode_batch([None]),
        lambda: CV.g2_encode_batch([None]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert BatchedBLS(device="cpu").device.type == "cpu"


def test_r1cs_entry_points_need_a_card_unless_cpu():
    """prepare, compile_tape and the witness encoders run on the card
    unless given device="cpu"; check_satisfied and run_tape then run where
    their tables are."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-card behaviour")
    from bls_verify_gadget_tpu_torch.r1cs import evaluator as EV
    from bls_verify_gadget_tpu_torch.r1cs import witness_vm as VM
    from bls_verify_gadget_tpu_torch.r1cs.gadgets import FpVar
    from bls_verify_gadget_tpu_torch.r1cs.system import ConstraintSystem

    cs = ConstraintSystem()
    a, b = FpVar.alloc(cs, 3), FpVar.alloc(cs, 5)
    (a * b + a).enforce_equal(FpVar.constant(cs, 18))
    for call in (
        lambda: VM.compile_tape(cs),
        lambda: EV.prepare(cs.to_arrays()),
        lambda: EV.encode_witness(cs.assignments),
        lambda: EV.encode_witness_batch([cs.assignments]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    ct = VM.compile_tape(cs, device="cpu")
    prepared = EV.prepare(cs.to_arrays(), device="cpu")
    inputs = EV.encode_witness(cs.assignments, "cpu")[None, 1:3]
    wit = VM.run_tape(ct, inputs, 1)
    assert wit.device.type == "cpu"
    assert EV.check_satisfied(prepared, wit).tolist() == [True]


def test_kernel_wrappers_do_not_fall_back():
    """A tensor that is neither on the CPU nor on a card is refused; the
    plain version runs only for CPU tensors."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    a = FP.encode([7, 11], "cpu").to("meta")
    f, t, q = a.new_zeros(12, 2, 24), a.new_zeros(2, 6, 2, 24), a.new_zeros(2, 4, 2, 24)
    xp, valid = a.new_zeros(2, 2, 24), torch.ones(2, 2, dtype=torch.bool, device="meta")
    g1, g2, u = a.new_zeros(3, 2, 24), a.new_zeros(6, 2, 24), a.new_zeros(4, 2, 24)
    sk = torch.zeros(2, 16, dtype=torch.int32, device="meta")
    for call in (
        lambda: K.add(FP, a, a),
        lambda: K.sub(FP, a, a),
        lambda: K.fp2_mul(FP, a, a, a, a),
        lambda: K.fp2_sqr(FP, a, a),
        lambda: K.fp6_mul(FP, g2, g2),
        lambda: K.fp12_mul(FP, f, f),
        lambda: K.fp12_sqr(FP, f),
        lambda: K.miller_dbl_run(FP, f, t, xp, xp, valid, 1),
        lambda: K.miller_add(FP, f, t, q, xp, xp, valid),
        lambda: K.miller_dbl_run(FP, f, t[:1], xp[:1], xp[:1], valid[:1], 1),
        lambda: K.miller_add(FP, f, t[:1], q[:1], xp[:1], xp[:1], valid[:1]),
        lambda: K.exp_x(FP, f, CV.X_SEGMENTS),
        lambda: K.pow_win(FP, a[None], FP.modulus - 2),
        lambda: K.pow_win(FP, xp, FP.modulus - 2),
        lambda: K.pt_mul_const(FP, g1, CV.X_SEGMENTS),
        lambda: K.pt_mul_const(FP, g2, CV.X_SEGMENTS),
        lambda: K.g2_cofactor(FP, g2, CV.X_SEGMENTS),
        lambda: K.sswu_map2(FP, u),
        lambda: K.pt_dbl(FP, g1, 1),
        lambda: K.pt_dbl(FP, g2, 63),
        lambda: K.pt_add(FP, g1, g1),
        lambda: K.pt_add(FP, g2, g2),
        lambda: K.pt_mul_var(FP, g1, sk, 255),
        lambda: K.pt_mul_var(FP, g2, sk, 255),
        lambda: K.mul014(FP, f, g2),
        lambda: K.dbl_step(FP, g2, xp),
        lambda: K.add_step(FP, g2, u, xp),
        lambda: K.cyclo_sqr(FP, f, 1),
        lambda: K.cyclo_sqr(FP, f, 32),
        lambda: K.xmd(torch.zeros(2, 3, dtype=torch.uint8, device="meta"), None, b"DST", 256),
        lambda: K.lc_dot(FP, a.new_zeros(2, 5, 24), torch.zeros(3, 8, dtype=torch.int32,
                                                                   device="meta"),
                         a.new_zeros(3, 8, 24)),
    ):
        with pytest.raises(ValueError):
            call()


def test_sources_name_every_csrc_file():
    """library_path() hashes SOURCES only: a csrc/ file left out of it
    would keep a stale library after an edit."""
    from bls_verify_gadget_tpu_torch.ops import kernels as K

    files = {p.name for p in K.CSRC_DIR.iterdir() if p.suffix in (".cu", ".cuh")}
    assert files == set(K.SOURCES)
    assert {p.name for p in K.CSRC_DIR.iterdir()} == files
    assert set(K.UNITS) == {n for n in files if n.endswith(".cu")}
    assert "point_kernels.cu" in K.UNITS
    assert "r1cs_kernels.cu" in K.UNITS and "lc_dot" in K.KERNELS


def test_config_defaults_keep_the_fused_path(monkeypatch):
    """The configuration flags default to True, and with them a CPU verify
    of one element calls the same kernel wrappers as before the step-wise
    configuration was ported, and xmd once (on the card each call is one
    launch)."""
    import collections
    import dataclasses

    from vector_loader import load_suite, unhex
    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_pubkeys, encode_signatures,
    )
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.utils.config import Config, config

    assert {f.name: f.default for f in dataclasses.fields(Config)} == {
        "fuse_miller": True, "fuse_expx": True, "check_subgroups": True}
    assert config.fuse_miller and config.fuse_expx and config.check_subgroups
    calls = collections.Counter()
    for name in K.KERNELS:
        def shim(*args, _wrapper=getattr(K, name), _name=name):  # xmd's first is no field
            calls[_name] += 1
            return _wrapper(*args)

        monkeypatch.setattr(K, name, shim)
    vec = next(v for _, v in load_suite("verify") if v["output"])["input"]
    out = BatchedBLS(device="cpu").verify(
        encode_pubkeys([codec.g1_decompress(unhex(vec["pubkey"]))], device="cpu"),
        encode_signatures([codec.g2_decompress(unhex(vec["signature"]))], device="cpu"),
        encode_messages([unhex(vec["message"])], device="cpu"))
    assert out.tolist() == [True]
    assert set(calls) == {
        "mul", "add", "sub", "fp2_mul", "fp2_sqr", "fp6_mul", "fp12_mul", "fp12_sqr",
        "miller_dbl_run", "miller_add", "exp_x", "pow_win", "pt_mul_const", "g2_cofactor",
        "sswu_map2", "xmd"}
    assert calls["xmd"] == 1
    assert sum(calls.values()) == 118

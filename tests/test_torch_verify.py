"""The port's whole verify slice (bls_verify_gadget_tpu_torch/models/bls.py)
against the JAX package and against the verify conformance vectors.

Everything runs on the CPU (plain versions of the kernels): about 25 s per
verify batch, three batches in this file.  The vectors test comes first
because the staged test also builds the JAX `staged_fns` fixture, minutes
of tracing and compiling unless its worker already holds it.  Limbs and
booleans are compared exactly (tolerance 0)."""

import jax
import numpy as np

import op_counts
from test_torch_curve_hash_pairing import g1_off_subgroup, g2_off_subgroup
from vector_loader import load_suite, unhex
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.models.bls import (
    encode_messages as jencode_messages,
    encode_pubkeys as jencode_pubkeys,
    encode_signatures as jencode_signatures,
)
from bls_verify_gadget_tpu.ops import curve as JCV
from bls_verify_gadget_tpu_torch.convert import (
    batch_from_numpy, limbs_to_numpy, params_from_numpy,
)
from bls_verify_gadget_tpu_torch.golden import codec
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_pubkeys, encode_signatures,
)
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.utils.config import config
from bls_verify_gadget_tpu_torch.utils.profiling import count_ops


def _np(tree):
    if isinstance(tree, tuple):
        return tuple(_np(x) for x in tree)
    return np.asarray(tree)


def _flat(tree):
    if isinstance(tree, tuple):
        return [leaf for x in tree for leaf in _flat(x)]
    return [tree]


def test_verify_matches_all_vectors():
    """Every decodable verify vector (all 32-byte messages) in ONE batch
    through BatchedBLS.verify, decoded by the port's own codec; cases
    whose wire bytes do not decode map to False at the host boundary.  The
    op counter over the call holds the JAX package's count of a default
    verify per element (tests/data/jax_op_counts.json)."""
    results, cases = {}, []
    for name, vec in load_suite("verify"):
        try:
            pk = codec.g1_decompress(unhex(vec["input"]["pubkey"]))
            sig = codec.g2_decompress(unhex(vec["input"]["signature"]))
        except ValueError:
            results[name] = False
            continue
        cases.append((name, pk, sig, unhex(vec["input"]["message"])))
    assert len(results) + len(cases) == 29 and len(cases) >= 20
    bls = BatchedBLS(device="cpu")
    with count_ops() as counter:
        out = bls.verify(
            encode_pubkeys([c[1] for c in cases], device="cpu"),
            encode_signatures([c[2] for c in cases], device="cpu"),
            encode_messages([c[3] for c in cases], device="cpu"),
            32,
        )
    op_counts.assert_jax_counts(counter, "verify", len(cases))
    results.update({c[0]: bool(g) for c, g in zip(cases, out.tolist())})
    expected = {name: vec["output"] for name, vec in load_suite("verify")}
    assert results == expected


def test_stages_match_jax_staged_pipeline(staged_fns):
    """The inputs of test_verify_smoke.py (batch 4, 32-byte messages:
    valid, tampered message, identity pk, valid) through the JAX staged
    pipeline and through the port: h_aff limbs, the Miller accumulator's
    limbs, the checks mask and the final bools agree exactly."""
    case = dict(load_suite("verify"))["verify_valid_case_195246ee3bd3b6ec"]["input"]
    pk = gbls.g1_decompress(unhex(case["pubkey"]), check_subgroup=False)
    sig = gbls.g2_decompress(unhex(case["signature"]), check_subgroup=False)
    msg = unhex(case["message"])
    tampered = bytes([msg[0] ^ 1]) + msg[1:]
    pk_b = jencode_pubkeys([pk, pk, None, pk])
    sig_b = jencode_signatures([sig] * 4)
    msg_b = jencode_messages([msg, tampered, msg, msg])

    jbls, hash_fn, miller_fn, fexp_fn = staged_fns
    j_h = hash_fn(msg_b)
    j_f, j_ok = miller_fn(pk_b, sig_b, j_h)
    j_out = fexp_fn(j_f, j_ok)

    params = params_from_numpy(np.asarray(jbls.params.g1_x), np.asarray(jbls.params.g1_y),
                               device="cpu")
    bls = BatchedBLS(params, device="cpu")
    p_pk, p_sig, p_msg = batch_from_numpy(_np(pk_b), _np(sig_b), _np(msg_b), device="cpu")
    h = bls.hash_stage(p_msg, 32)
    for got, want in zip(_flat(h[:2]), _flat(_np(j_h[:2]))):
        assert np.array_equal(limbs_to_numpy(got), want)
    assert np.array_equal(h[2].numpy(), np.asarray(j_h[2]))
    f, ok = bls.miller_stage(p_pk, p_sig, h)
    for got, want in zip(_flat(f), _flat(_np(j_f))):
        assert np.array_equal(limbs_to_numpy(got), want)
    assert ok.tolist() == np.asarray(j_ok).tolist()
    out = bls.finalexp_stage(f, ok)
    assert out.tolist() == np.asarray(j_out).tolist() == [True, False, False, True]


def test_check_subgroups_off_matches_jax(staged_fns, monkeypatch):
    """config.check_subgroups off, on SMOKE_BATCH = 4 elements: valid, a pk
    and then a sig on their curves but outside the subgroup, the identity
    pk.  The port's miller_stage f limbs and checks mask and its
    verdicts equal the JAX package's flag-off verify, built from what the
    flag does not touch: staged_fns's Miller loop for f, the checks as the
    JAX models/bls.py builds them with the flag off (identity mask and
    CV.pt_on_curve_affine), staged_fns's final exponentiation.  The mask
    passes the off-subgroup elements (flag on, it fails them), and no
    pt_mul_const runs."""
    case = dict(load_suite("verify"))["verify_valid_case_195246ee3bd3b6ec"]["input"]
    pk = gbls.g1_decompress(unhex(case["pubkey"]), check_subgroup=False)
    sig = gbls.g2_decompress(unhex(case["signature"]), check_subgroup=False)
    msg = unhex(case["message"])
    off_pk, off_sig = g1_off_subgroup(), g2_off_subgroup()
    pk_b = jencode_pubkeys([pk, off_pk, pk, None])
    sig_b = jencode_signatures([sig, sig, off_sig, sig])
    msg_b = jencode_messages([msg] * 4)

    jbls, hash_fn, miller_fn, fexp_fn = staged_fns
    j_f, _ = miller_fn(pk_b, sig_b, hash_fn(msg_b))

    @jax.jit
    def checks_off(pk_aff, sig_aff):
        (pk_x, pk_y, pk_inf), (sig_x, sig_y, sig_inf) = pk_aff, sig_aff
        pk_ok = ~pk_inf & JCV.pt_on_curve_affine(JCV.FP_OPS, pk_x, pk_y, JCV.B_G1_MONT)
        sig_ok = sig_inf | JCV.pt_on_curve_affine(JCV.FP2_OPS, sig_x, sig_y, JCV.B_G2_MONT)
        return pk_ok & sig_ok

    j_ok = checks_off(pk_b, sig_b)
    j_out = fexp_fn(j_f, j_ok)

    monkeypatch.setattr(config, "check_subgroups", False)
    ladders = []
    pt_mul_const = K.pt_mul_const
    monkeypatch.setattr(K, "pt_mul_const", lambda *a: ladders.append(a) or pt_mul_const(*a))
    params = params_from_numpy(np.asarray(jbls.params.g1_x), np.asarray(jbls.params.g1_y),
                               device="cpu")
    bls = BatchedBLS(params, device="cpu")
    p_pk, p_sig, p_msg = batch_from_numpy(_np(pk_b), _np(sig_b), _np(msg_b), device="cpu")
    f, ok = bls.miller_stage(p_pk, p_sig, bls.hash_stage(p_msg, 32))
    for got, want in zip(_flat(f), _flat(_np(j_f))):
        assert np.array_equal(limbs_to_numpy(got), want)
    assert ok.tolist() == np.asarray(j_ok).tolist() == [True, True, True, False]
    out = bls.finalexp_stage(f, ok)
    assert out.tolist() == np.asarray(j_out).tolist() == [True, False, False, False]
    assert not ladders

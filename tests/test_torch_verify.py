"""The port's whole verify slice (bls_verify_gadget_tpu_torch/models/bls.py)
against the JAX package and against the verify conformance vectors.

Everything runs on the CPU (plain versions of the kernels): about 25 s per
verify batch, two batches in this file.  The vectors test comes first
because the staged test also builds the JAX `staged_fns` fixture, minutes
of tracing and compiling unless its worker already holds it.  Limbs and
booleans are compared exactly (tolerance 0)."""

import numpy as np

from vector_loader import load_suite, unhex
from bls_verify_gadget_tpu.golden import bls as gbls
from bls_verify_gadget_tpu.models.bls import (
    encode_messages as jencode_messages,
    encode_pubkeys as jencode_pubkeys,
    encode_signatures as jencode_signatures,
)
from bls_verify_gadget_tpu_torch.convert import (
    batch_from_numpy, limbs_to_numpy, params_from_numpy,
)
from bls_verify_gadget_tpu_torch.golden import codec
from bls_verify_gadget_tpu_torch.models.bls import (
    BatchedBLS, encode_messages, encode_pubkeys, encode_signatures,
)


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
    whose wire bytes do not decode map to False at the host boundary."""
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
    out = bls.verify(
        encode_pubkeys([c[1] for c in cases], device="cpu"),
        encode_signatures([c[2] for c in cases], device="cpu"),
        encode_messages([c[3] for c in cases], device="cpu"),
        32,
    )
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

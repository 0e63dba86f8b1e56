"""The JAX package's op counts (utils/profiling.py count_ops) per element of
one default verify, one step-wise verify (fuse_miller and fuse_expx off)
and one sign, and the port's count of the same calls.

tests/data/jax_op_counts.json records the JAX counts, with the batch and
the last commit of the JAX package they came from.  The tier-1 tests hold
the port's count_ops over CPU runs they make anyway to that file, key by
key (assert_jax_counts); test_torch_profiling.py's slow test counts both
packages live and holds them to each other and to the file.  Rewrite the
file after a change to the JAX package's pipeline (about ten minutes, the
three calls in parallel processes):

    JAX_PLATFORMS=cpu python tests/op_counts.py

The JAX count is tools/gen_roofline.py's: jax.eval_shape of the call with
ModField._use_pallas forced on and config.static_ladders "on", so the
fused kernels' wrappers record what the TPU runs.  One change: JAX traces
a lax.scan body once, so a trace-time count charges the step-wise Miller
loop's doubling runs (jax.lax.scan over `run` doublings) one doubling
each.  Here jax.lax.scan charges its body's records once per iteration,
the work the scan executes; the default verify and sign run no scan whose
body records, and count the same either way.
"""

import json
import pathlib
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent.parent
PATH = pathlib.Path(__file__).resolve().parent / "data" / "jax_op_counts.json"
CALLS = ("verify", "verify_stepwise", "sign")
MSG_LEN = 32
BATCH = 4  # tests/conftest.py SMOKE_BATCH


def per_element(call: str) -> dict:
    return json.loads(PATH.read_text())["per_element"][call]


def assert_jax_counts(counter, call: str, n: int):
    """The port's OpCounter over `call` on n elements holds the JAX
    package's count of the same call, key by key."""
    want = {k: v * n for k, v in per_element(call).items()}
    assert dict(counter.counts) == want, (call, n)


def _per_element(counts, n: int) -> dict:
    assert all(v % n == 0 for v in counts.values()), (counts, n)
    return {k: v // n for k, v in sorted(counts.items()) if v}


def _counting_scan(scan, profiling):
    """jax.lax.scan that charges its body's records to the active counter
    once per iteration (the body is traced once per scan, under a counter
    of its own)."""
    import jax

    def counted(f, init, xs=None, length=None, **kw):
        outer = profiling._active_counter
        if outer is None:
            return scan(f, init, xs, length=length, **kw)
        n = length if xs is None else jax.tree_util.tree_leaves(xs)[0].shape[0]
        with profiling.count_ops() as body:
            # a new function each call: scan caches the trace of a body it
            # has seen, and a cached trace records nothing
            out = scan(lambda c, x: f(c, x), init, xs, length=length, **kw)
        for kind, v in body.counts.items():
            outer.add(kind, v * n)
        return out

    return counted


def jax_counts(call: str, mp, batch: int = BATCH) -> dict:
    """The JAX package's count_ops of `call` over jax.eval_shape at
    `batch`, per element.  mp: a pytest MonkeyPatch, undone by the
    caller."""
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _example_batch
    from bls_verify_gadget_tpu.models.bls import BatchedBLS
    from bls_verify_gadget_tpu.ops.fp import ModField
    from bls_verify_gadget_tpu.utils import profiling
    from bls_verify_gadget_tpu.utils.config import config

    jax.clear_caches()  # nothing traced under another configuration is reused
    mp.setattr(ModField, "_use_pallas", lambda self: True)
    mp.setattr(config, "static_ladders", "on")
    mp.setattr(jax.lax, "scan", _counting_scan(jax.lax.scan, profiling))
    if call == "verify_stepwise":
        mp.setattr(config, "fuse_miller", False)
        mp.setattr(config, "fuse_expx", False)
    bls = BatchedBLS()
    pk, sig, msg = _example_batch(batch)
    with profiling.count_ops() as c:
        if call == "sign":
            sk = jnp.zeros((batch, 16), jnp.uint32)
            jax.eval_shape(lambda s, m: bls.sign(s, m, MSG_LEN), sk, msg)
        else:
            jax.eval_shape(lambda p, s, m: bls.verify(p, s, m, MSG_LEN), pk, sig, msg)
    return _per_element(c.counts, batch)


def port_counts(call: str, mp, batch: int = BATCH) -> dict:
    """The port's count_ops of `call` on the CPU at `batch` (the example
    case of __graft_entry__._example_batch; sign with the keys 1..batch),
    per element."""
    from vector_loader import load_suite, unhex
    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_pubkeys, encode_scalars, encode_signatures,
    )
    from bls_verify_gadget_tpu_torch.utils import profiling
    from bls_verify_gadget_tpu_torch.utils.config import config

    case = dict(load_suite("verify"))["verify_valid_case_195246ee3bd3b6ec"]["input"]
    msg = encode_messages([unhex(case["message"])] * batch, device="cpu")
    bls = BatchedBLS(device="cpu")
    if call == "verify_stepwise":
        mp.setattr(config, "fuse_miller", False)
        mp.setattr(config, "fuse_expx", False)
    with profiling.count_ops() as c:
        if call == "sign":
            bls.sign(encode_scalars(list(range(1, batch + 1)), device="cpu"), msg, MSG_LEN)
        else:
            pk = encode_pubkeys([codec.g1_decompress(unhex(case["pubkey"]))] * batch,
                                device="cpu")
            sig = encode_signatures([codec.g2_decompress(unhex(case["signature"]))] * batch,
                                    device="cpu")
            bls.verify(pk, sig, msg, MSG_LEN)
    return _per_element(c.counts, batch)


def jax_commit() -> str:
    """The last commit that changed the JAX package."""
    return subprocess.run(["git", "log", "-1", "--format=%H", "--", "bls_verify_gadget_tpu"],
                          cwd=ROOT, capture_output=True, text=True, check=True).stdout.strip()


def _count_in_child(call):
    import os
    import sys

    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path[:0] = [str(ROOT), str(PATH.parent.parent)]
    import jax
    import pytest

    jax.config.update("jax_platforms", "cpu")
    with pytest.MonkeyPatch.context() as mp:
        return call, jax_counts(call, mp)


def main():
    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(len(CALLS)) as pool:
        counts = dict(pool.map(_count_in_child, CALLS))
    PATH.parent.mkdir(exist_ok=True)
    PATH.write_text(json.dumps({
        "source": "tests/op_counts.py jax_counts: count_ops over jax.eval_shape, "
                  "ModField._use_pallas on, static_ladders on, scan bodies per iteration",
        "batch": BATCH,
        "msg_len": MSG_LEN,
        "jax_commit": jax_commit(),
        "per_element": {call: counts[call] for call in CALLS},
    }, indent=1) + "\n")
    print(PATH.read_text())


if __name__ == "__main__":
    main()

"""Tracing and op accounting of the port (counterpart of the JAX package's
utils/profiling.py).

  * named_scope: a named range around a block or a function.  It shows in
    a torch.profiler trace on either device and, while this process uses
    a CUDA device, as an NVTX range in Nsight Systems.
  * OpCounter + count_ops: counts of the field work that runs, keyed and
    weighted as in the JAX package.  The field ops (ops/fp.py) and every
    fused kernel's wrapper (ops/kernels.py) record into the active
    counter the JAX package's counts for the same call, before they pick
    the CPU plain version or the kernel, so both devices count alike.
    The JAX package counts while it traces, the port while it runs.
  * profile_trace: torch.profiler capture of a block, exported as a
    Chrome trace.
"""

import collections
import contextlib
import os
import tempfile

import torch


def _nvtx_in_use() -> bool:
    """True where this process has set up CUDA and torch has NVTX: its
    ranges then go to NVTX as well (a CPU-only torch has neither)."""
    return torch.cuda.is_initialized() and hasattr(torch._C, "_nvtx")


@contextlib.contextmanager
def named_scope(name: str):
    """Context and decorator: names the ops of a block in a profiler trace,
    as jax.named_scope does.  It adds no launch and no host sync."""
    nvtx = _nvtx_in_use()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class OpCounter:
    """Counts logical field ops.  Keys are "<kind>_<nlimb>" (mul_24 = one
    Fp multiply, mul_16 = one Fr multiply); a call over N elements
    counts N."""

    def __init__(self):
        self.counts = collections.Counter()

    def add(self, kind: str, n: int = 1):
        self.counts[kind] += n

    def fp_mul_equivalent(self) -> float:
        """Everything in units of one 24-limb Fp multiply, with the JAX
        package's weights: add/sub ~1/10 of a mul, Fr (16-limb) ops
        scaled by (16/24)^2."""
        w = {
            "mul_24": 1.0, "add_24": 0.1, "sub_24": 0.1,
            "mul_16": (16 / 24) ** 2, "add_16": 0.07, "sub_16": 0.07,
        }
        return sum(w.get(k, 0.0) * v for k, v in self.counts.items())

    def __repr__(self):
        return f"OpCounter({dict(self.counts)})"


_active_counter: OpCounter | None = None


def record(kind: str, n: int = 1):
    """Called by the ops layer on every logical field op and fused kernel;
    a no-op unless a count_ops() context is active."""
    if _active_counter is not None:
        _active_counter.add(kind, n)


@contextlib.contextmanager
def count_ops():
    """Activate an OpCounter for the block, restoring the outer one after:

        with count_ops() as c:
            bls.verify(pk, sig, msg)
        print(c.fp_mul_equivalent())
    """
    global _active_counter
    prev, _active_counter = _active_counter, OpCounter()
    try:
        yield _active_counter
    finally:
        _active_counter = prev


@contextlib.contextmanager
def uncounted():
    """Suspend the active counter for the block: a wrapper that has
    recorded its kernel's work runs the plain version under it, so the
    ops inside that version add nothing."""
    global _active_counter
    prev, _active_counter = _active_counter, None
    try:
        yield
    finally:
        _active_counter = prev


@contextlib.contextmanager
def profile_trace(logdir: str | None = None):
    """torch.profiler capture of a block: CPU activity, and CUDA activity
    where a card is present.  On exit the trace is written to
    `logdir`/trace.json (a new directory under TMPDIR by default);
    yields `logdir`."""
    if logdir is None:
        logdir = tempfile.mkdtemp(prefix="bls_torch_trace_")
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))

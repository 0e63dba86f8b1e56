#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (bls_verify_gadget_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc.  Phases, each fatal on failure:
  1. device   -- card name and power limit (nvidia-smi), torch's name;
  2. build    -- nvcc builds the five field kernels from csrc/;
  3. main path -- BatchedBLS(device="cuda").verify at batch 4096 with
     32-byte messages: the decodable verify vectors tiled, plus tampered-
     message and identity-pk probes.  One warm-up run, then timed runs;
     launch counters are zeroed just before the first timed run and read
     just after it; every element must equal its expected result;
  4. profile  -- device time by kernel over one more verify batch
     (torch.profiler), and the device's busy share of the wall time;
  5. kernels  -- each kernel against its plain PyTorch version on the same
     CUDA tensors (seeded random values plus edge values), at the element
     counts the main path launched, bit for bit; device time per launch
     from CUDA-graph replay, eager call time and plain time from CUDA
     events, and the bound from bytes and integer multiply-adds.
Prints one JSON line of kernels, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 20261016
BATCH = 4096
MSG_LEN = 32
TIMED_RUNS = 3

# bytes/s and int32 multiply-adds/s of one H100 SXM: 3.35 TB/s HBM, and the
# 67 TFLOP/s fp32 rate (an FMA counted as 2 flops) halved, since a Hopper
# SM has 64 INT32 lanes against 128 FP32 lanes
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2
MAD_PER_MONT = 600  # 12x12 word products for a*b and for m*p, lo + hi each

# name -> (TPU kernel replaced, field elements in, out, Montgomery products)
KERNELS = {
    "mul": ("bls_verify_gadget_tpu/ops/pallas/kernels.py:227", 2, 1, 1),
    "add": ("bls_verify_gadget_tpu/ops/pallas/kernels.py:234", 2, 1, 0),
    "sub": ("bls_verify_gadget_tpu/ops/pallas/kernels.py:241", 2, 1, 0),
    "fp2_mul": ("bls_verify_gadget_tpu/ops/pallas/kernels.py:262", 4, 2, 3),
    "fp2_sqr": ("bls_verify_gadget_tpu/ops/pallas/kernels.py:276", 2, 2, 2),
}
SOURCE = "bls_verify_gadget_tpu_torch/csrc/field_kernels.cu"
FIELD_KERNEL_NAME = re.compile(r"bls_kernels::(mul|add|sub|fp2_mul|fp2_sqr)_kernel\b")


def log(msg):
    print(msg, flush=True)


def device_phase(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] nvidia-smi: {smi} | torch: {kind} | count {torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")
    return smi, kind


def build_phase(K):
    t0 = time.perf_counter()
    so = K.build()
    K.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")


def load_cases():
    from bls_verify_gadget_tpu_torch.golden import codec

    def unhex(s):
        return bytes.fromhex(s[2:] if s.startswith("0x") else s)

    cases = []
    for path in sorted((ROOT / "tests" / "vectors" / "verify").glob("*.json")):
        vec = json.loads(path.read_text())
        try:
            pk = codec.g1_decompress(unhex(vec["input"]["pubkey"]))
            sig = codec.g2_decompress(unhex(vec["input"]["signature"]))
        except ValueError:
            continue
        msg = unhex(vec["input"]["message"])
        if len(msg) != MSG_LEN:
            continue
        cases.append((pk, sig, msg, bool(vec["output"])))
        if vec["output"]:
            tampered = bytes([msg[0] ^ 1]) + msg[1:]
            cases.append((pk, sig, tampered, False))
            cases.append((None, sig, msg, False))
    if not any(c[3] for c in cases):
        raise RuntimeError("no valid verify vector decoded")
    return [cases[i % len(cases)] for i in range(BATCH)]


def main_path_phase(torch, K):
    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_pubkeys, encode_signatures,
    )

    cases = load_cases()
    pk = encode_pubkeys([c[0] for c in cases])
    sig = encode_signatures([c[1] for c in cases])
    msg = encode_messages([c[2] for c in cases])
    want = torch.tensor([c[3] for c in cases], device="cuda")
    bls = BatchedBLS(device="cuda")

    def run():
        t0 = time.perf_counter()
        h = bls.hash_stage(msg, MSG_LEN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f, ok = bls.miller_stage(pk, sig, h)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = bls.finalexp_stage(f, ok)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return out, (t1 - t0, t2 - t1, t3 - t2)

    t0 = time.perf_counter()
    out, _ = run()
    log(f"[main] warm-up verify at batch {BATCH}: {time.perf_counter() - t0:.3f} s")
    if not torch.equal(out, want):
        raise RuntimeError(f"warm-up verify: {int((out != want).sum())} wrong results")

    # the composed entry point a user calls, checked once end to end
    if not torch.equal(bls.verify(pk, sig, msg, MSG_LEN), want):
        raise RuntimeError("BatchedBLS.verify disagrees with the expected results")
    torch.cuda.synchronize()

    stage_times = []
    counts = None
    for i in range(TIMED_RUNS):
        if i == 0:
            K.COUNTS.reset()
        out, st = run()
        if i == 0:
            counts = (dict(K.COUNTS.launches), dict(K.COUNTS.elements),
                      {k: dict(v) for k, v in K.COUNTS.sizes.items()})
        if not torch.equal(out, want):
            raise RuntimeError(f"timed verify {i}: {int((out != want).sum())} wrong results")
        stage_times.append(st)
    launches, elements, sizes = counts
    idle = [k for k in K.KERNELS if launches[k] == 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the main path: {idle}")
    n_true = int(want.sum())
    totals = [sum(st) for st in stage_times]
    mean = sum(totals) / len(totals)
    log(f"[main] {BATCH} verifications ({n_true} true, {BATCH - n_true} false), "
        f"all {TIMED_RUNS} timed runs correct")
    log(f"[main] verify wall s per run: {[round(t, 6) for t in totals]}; "
        f"mean {mean:.6f} s = {BATCH / mean:.1f} verifications/s")
    for j, name in enumerate(("hash", "miller", "final_exp")):
        ms = [st[j] * 1e3 for st in stage_times]
        log(f"[main] stage {name}: mean {sum(ms) / len(ms):.3f} ms ({[round(x, 3) for x in ms]})")
    log(f"[main] launches per verify batch: {launches} (total {sum(launches.values())})")
    log(f"[main] elements per verify batch: {elements}")
    return launches, sizes, mean, run


def profile_phase(torch, run, verify_s):
    """Device time by kernel over one verify batch (torch.profiler, CUPTI):
    the field kernels, all other kernels (torch glue), and the device's
    busy share of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    field_us = other_us = 0.0
    n_other = 0
    others = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op's average also carries the
        # device time of the kernels it launched, which would count twice
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        if FIELD_KERNEL_NAME.search(ev.key):
            field_us += us
        else:
            other_us += us
            n_other += ev.count
            others.append((us, ev.count, ev.key[:80]))
    if field_us + other_us == 0:
        log("[profile] device time: not measured (the profiler saw no device activity)")
        return
    busy = (field_us + other_us) / 1e3
    log(f"[profile] one verify batch: field kernels {field_us / 1e3:.3f} ms, other kernels "
        f"{other_us / 1e3:.3f} ms over {n_other} launches; device busy {busy:.3f} ms of "
        f"{verify_s * 1e3:.3f} ms unprofiled wall = {100 * busy / (verify_s * 1e3):.2f}% "
        f"busy, {100 - 100 * busy / (verify_s * 1e3):.2f}% idle")
    for us, count, key in sorted(others, reverse=True)[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count:7d} launches  {key}")


def rand_limbs(torch, rng, n, top):
    """n uniform-ish canonical values as (n, 24) limbs (top limb < `top`)."""
    import numpy as np

    x = rng.integers(0, 1 << 16, size=(n, 24), dtype=np.int64)
    x[:, 23] = rng.integers(0, top, size=n)
    return torch.from_numpy(x.astype(np.int32)).cuda()


def kernel_inputs(torch, rng, name, n, field=None):
    """Seeded operands for one kernel at n elements: random canonical
    values with edge values (0, 1, m-1, m-2, R mod m) in the first rows;
    for mul also raw sums < 2m and full-width values against R^2 (the
    hash_to_field folding)."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP
    from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs

    F = field or FP
    m = F.modulus
    top = m >> (16 * (F.nlimb - 1))
    ops = [rand_limbs(torch, rng, n, top)[:, : F.nlimb].contiguous()
           for _ in range(KERNELS[name][1])]
    edges = torch.from_numpy(
        ints_to_limbs([0, 1, m - 1, m - 2, F.mont_r % m], F.nlimb)).cuda()
    e = min(len(edges), n)
    for i, t in enumerate(ops):
        if F.nlimb != 24:
            t[:, -1] = torch.from_numpy(rng.integers(0, top, size=n)).cuda()
        t[:e] = edges.roll(i, 0)[:e]
    if name == "mul" and n >= 16:
        q = n // 4
        ops[0][q : 2 * q] = F.propagate(ops[0][q : 2 * q] + ops[1][q : 2 * q])
        ops[0][2 * q : 3 * q] = rand_limbs(torch, rng, q, 1 << 16)[:, : F.nlimb]
        ops[1][2 * q : 3 * q] = F.const("R2", "cuda")
    return ops


def kernel_call(name):
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.ops import tower as T
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    if name == "fp2_mul":
        return (lambda *a: K.fp2_mul(FP, *a)), T.fp2_mul_plain
    if name == "fp2_sqr":
        return (lambda *a: K.fp2_sqr(FP, *a)), T.fp2_sqr_plain
    plain = {"mul": FP.mul_plain, "add": FP.add_plain, "sub": FP.sub_plain}[name]
    return (lambda a, b: getattr(K, name)(FP, a, b)), plain


def call_ms(torch, fn, args, reps):
    """Per-call time of the eager wrapper: CUDA events around `reps` calls
    (host launch cost included)."""
    for _ in range(2):
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, args, reps=20, replays=5):
    """Device time per launch: `reps` launches captured in a CUDA graph,
    replayed `replays` times between CUDA events (no host launch cost)."""
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def kernel_phase(torch, K, launches, sizes, verify_s):
    import numpy as np

    rng = np.random.default_rng(SEED)
    rows, field_ms = [], 0.0
    for name, (replaces, n_in, n_out, n_mont) in KERNELS.items():
        kern, plain = kernel_call(name)
        hist = sizes[name]
        n_main = max(hist, key=lambda s: (hist[s], s))
        worst = 0
        for n in sorted(set(hist) | {max(hist)}):
            args = kernel_inputs(torch, rng, name, n)
            got, ref = kern(*args), plain(*args)
            got = got if isinstance(got, tuple) else (got,)
            ref = ref if isinstance(ref, tuple) else (ref,)
            for g, r in zip(got, ref):
                worst = max(worst, int((g.long() - r.long()).abs().max()))
            field_ms += device_ms(torch, kern, args) * hist[n]
            if n == n_main:
                ms = device_ms(torch, kern, args)
                eager_ms = call_ms(torch, kern, args, 50)
                plain_ms = call_ms(torch, plain, args, 3)
        if worst != 0:
            raise RuntimeError(f"kernel {name} disagrees with its plain version: max |err| {worst}")
        nbytes = n_main * (n_in + n_out) * 24 * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_main * n_mont * MAD_PER_MONT / INT32_MAD_PER_S * 1e3
        rows.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "elements": n_main, "call_ms": eager_ms,
        })
        log(f"[kernel] {name}: bit-equal to plain at {len(hist)} main-path sizes "
            f"{sorted(hist)}; at {n_main} elements: device {ms:.5f} ms, eager call "
            f"{eager_ms:.5f} ms, plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.5f} "
            f"ms ({'bytes' if bytes_ms >= ops_ms else 'operations'}); "
            f"{launches[name]} launches per verify")
    from bls_verify_gadget_tpu_torch.ops.fp import FR

    n_fr = rows[0]["elements"]
    a, b = kernel_inputs(torch, rng, "mul", n_fr, FR)
    err = int((K.mul(FR, a, b).long() - FR.mul_plain(a, b).long()).abs().max())
    if err != 0:
        raise RuntimeError(f"Fr mul kernel disagrees with its plain version: max |err| {err}")
    log(f"[kernel] mul (Fr, 16 limbs): bit-equal to plain at {n_fr} elements")
    log(f"[kernel] field-kernel device time per verify batch (launches x device time "
        f"at each size) {field_ms:.3f} ms of {verify_s * 1e3:.3f} ms wall "
        f"({100 * field_ms / (verify_s * 1e3):.2f}%)")
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "bls_verify_gadget_tpu_torch").is_dir():
        print("chip_smoke: bls_verify_gadget_tpu_torch not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from bls_verify_gadget_tpu_torch.ops import kernels as K

    smi, kind = device_phase(torch)
    build_phase(K)
    launches, sizes, verify_s, run = main_path_phase(torch, K)
    profile_phase(torch, run, verify_s)
    rows = kernel_phase(torch, K, launches, sizes, verify_s)
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

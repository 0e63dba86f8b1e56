#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (bls_verify_gadget_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc.  Phases, each fatal on failure:
  1. device   -- card name and power limit (nvidia-smi), torch's name;
  2. build    -- nvcc builds the ten kernels from csrc/ (one nvcc per
     source, all at once) and prints ptxas's register/stack/spill report;
  3. main path -- BatchedBLS(device="cuda").verify at batch 4096 with
     32-byte messages: the decodable verify vectors tiled, plus tampered-
     message and identity-pk probes.  One warm-up run, then timed runs;
     launch counters are zeroed just before the first timed run and read
     just after it: every kernel must have launched, the fused pairing
     kernels once per product / run / chain; every element must equal its
     expected result;
  4. profile  -- device time by kernel over one more verify batch
     (torch.profiler), and the device's busy share of the wall time;
  5. kernels  -- each kernel against its plain PyTorch version on the same
     CUDA tensors (seeded random values plus edge values), at the element
     counts the main path launched (miller_dbl_run at each run length), bit
     for bit, with the launch counters unmoved by every plain call (the
     plain versions launch no kernel of the port); device time per launch
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

FIELD_SRC = "bls_verify_gadget_tpu_torch/csrc/field_kernels.cu"
PAIRING_SRC = "bls_verify_gadget_tpu_torch/csrc/pairing_kernels.cu"
TPU_KERNELS = "bls_verify_gadget_tpu/ops/pallas/kernels.py"
# name -> (TPU kernel replaced, source, launches per verify expected or None)
KERNELS = {
    "mul": (f"{TPU_KERNELS}:227", FIELD_SRC, None),
    "add": (f"{TPU_KERNELS}:234", FIELD_SRC, None),
    "sub": (f"{TPU_KERNELS}:241", FIELD_SRC, None),
    "fp2_mul": (f"{TPU_KERNELS}:262", FIELD_SRC, None),
    "fp2_sqr": (f"{TPU_KERNELS}:276", FIELD_SRC, None),
    "fp12_mul": (f"{TPU_KERNELS}:584", PAIRING_SRC, 9),
    "fp12_sqr": (f"{TPU_KERNELS}:596", PAIRING_SRC, 1),
    "miller_dbl_run": (f"{TPU_KERNELS}:1494", PAIRING_SRC, 6),
    "miller_add": (f"{TPU_KERNELS}:1537", PAIRING_SRC, 5),
    "exp_x": (f"{TPU_KERNELS}:1446", PAIRING_SRC, 5),
}
PORT_KERNEL_NAME = re.compile(r"bls_kernels::(%s)_kernel\b" % "|".join(KERNELS))


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
    keys = ("entry function", "Function properties", "registers", "spill")
    for line in so.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in keys):
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
    off = {k: launches[k] for k, (_, _, want_n) in KERNELS.items()
           if want_n is not None and launches[k] != want_n}
    if off:
        raise RuntimeError(f"fused kernels launched other than once per run/chain/product: {off}")
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
    the port's kernels (each by name), all other kernels (torch glue), and
    the device's busy share of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    field_us = other_us = 0.0
    n_other = 0
    others, ours = [], {}
    for ev in prof.key_averages():
        # device-side events only: a CPU op's average also carries the
        # device time of the kernels it launched, which would count twice
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.self_device_time_total
        hit = PORT_KERNEL_NAME.search(ev.key)
        if hit:
            field_us += us
            kus, kn = ours.get(hit.group(1), (0.0, 0))
            ours[hit.group(1)] = (kus + us, kn + ev.count)
        else:
            other_us += us
            n_other += ev.count
            others.append((us, ev.count, ev.key[:80]))
    if field_us + other_us == 0:
        log("[profile] device time: not measured (the profiler saw no device activity)")
        return
    busy = (field_us + other_us) / 1e3
    log(f"[profile] one verify batch: port kernels {field_us / 1e3:.3f} ms, other kernels "
        f"{other_us / 1e3:.3f} ms over {n_other} launches; device busy {busy:.3f} ms of "
        f"{verify_s * 1e3:.3f} ms unprofiled wall = {100 * busy / (verify_s * 1e3):.2f}% "
        f"busy, {100 - 100 * busy / (verify_s * 1e3):.2f}% idle")
    for name, (us, count) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {us / 1e3:9.3f} ms {count:7d} launches  port kernel {name}")
    for us, count, key in sorted(others, reverse=True)[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count:7d} launches  {key}")


def rand_limbs(torch, rng, n, top):
    """n uniform-ish canonical values as (n, 24) limbs (top limb < `top`)."""
    import numpy as np

    x = rng.integers(0, 1 << 16, size=(n, 24), dtype=np.int64)
    x[:, 23] = rng.integers(0, top, size=n)
    return torch.from_numpy(x.astype(np.int32)).cuda()


def edge_limbs(torch, F):
    """Edge values 0, 1, m-1, m-2 and R mod m as (5, nlimb) limbs."""
    from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs

    m = F.modulus
    return torch.from_numpy(ints_to_limbs([0, 1, m - 1, m - 2, F.mont_r % m], F.nlimb)).cuda()


def field_inputs(torch, rng, name, n, field=None):
    """Seeded operands for one field kernel at n elements: random canonical
    values with edge values in the first rows; for mul also raw sums < 2m
    and full-width values against R^2 (the hash_to_field folding)."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    F = field or FP
    top = F.modulus >> (16 * (F.nlimb - 1))
    n_in = {"mul": 2, "add": 2, "sub": 2, "fp2_mul": 4, "fp2_sqr": 2}[name]
    ops = [rand_limbs(torch, rng, n, top)[:, : F.nlimb].contiguous() for _ in range(n_in)]
    edges = edge_limbs(torch, F)
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


def pairing_inputs(torch, rng, name, n, count=None):
    """Seeded operands for one pairing kernel at n elements: packed
    (c, n, 24) canonical values, each coordinate with the edge values in
    its first elements (rolled per coordinate), and a mixed valid mask.
    The kernels and their plain versions compute the same formulas, so
    random values (off the curve, outside the cyclotomic subgroup) compare
    bit for bit."""
    import math

    from bls_verify_gadget_tpu_torch.ops import pairing as PR
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    edges = edge_limbs(torch, FP)
    top = FP.modulus >> (16 * 23)

    def fp(*shape):
        c = math.prod(shape)
        x = rand_limbs(torch, rng, c * n, top).view(c, n, 24)
        e = min(len(edges), n)
        for j in range(c):
            x[j, :e] = edges.roll(j, 0)[:e]
        return x.view(*shape, n, 24)

    valid = torch.from_numpy(rng.random((2, n)) < 0.75).cuda()
    return {
        "fp12_mul": lambda: (fp(12), fp(12)),
        "fp12_sqr": lambda: (fp(12),),
        "miller_dbl_run": lambda: (fp(12), fp(2, 6), fp(2), fp(2), valid, count),
        "miller_add": lambda: (fp(12), fp(2, 6), fp(2, 4), fp(2), fp(2), valid),
        "exp_x": lambda: (fp(12), PR.X_RUNS),
    }[name]()


def kernel_call(name):
    """(kernel wrapper, plain version) of `name`, both on the same operands."""
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.ops import pairing as PR
    from bls_verify_gadget_tpu_torch.ops import tower as T
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    plain = {
        "mul": FP.mul_plain, "add": FP.add_plain, "sub": FP.sub_plain,
        "fp2_mul": T.fp2_mul_plain, "fp2_sqr": T.fp2_sqr_plain,
        "fp12_mul": T.fp12_mul_plain, "fp12_sqr": T.fp12_sqr_plain,
        "miller_dbl_run": PR.miller_dbl_run_plain, "miller_add": PR.miller_add_plain,
        "exp_x": PR.exp_x_plain,
    }[name]
    return (lambda *a: getattr(K, name)(FP, *a)), plain


def work(name, n, args):
    """(bytes moved, Montgomery products) of one call at n elements: each
    Fp coordinate in or out is 96 bytes, a valid mask 4 bytes per pair.
    The Miller kernels' products count what this call's masks need: T's
    update for every pair, the line and f * line only for valid pairs."""
    from bls_verify_gadget_tpu_torch.ops import kernels as K

    k = K.PAIRS
    fp_io = {
        "mul": 3, "add": 3, "sub": 3, "fp2_mul": 6, "fp2_sqr": 4, "fp12_mul": 36,
        "fp12_sqr": 24, "miller_dbl_run": 12 + 8 * k + 12 + 6 * k,
        "miller_add": 12 + 12 * k + 12 + 6 * k, "exp_x": 24,
    }[name]
    mask = 4 * k if name.startswith("miller") else 0
    nbytes = n * (fp_io * 96 + mask)
    if name == "miller_dbl_run":  # per iteration f^2 36; per pair T 19, line 6 + f*line 45
        valid_pairs = int(args[4].sum())
        return nbytes, args[-1] * ((36 + 19 * k) * n + 51 * valid_pairs)
    if name == "miller_add":  # per pair T 31; line 10 + f*line 45
        return nbytes, 31 * k * n + 55 * int(args[-1].sum())
    if name == "exp_x":  # 18 per Granger-Scott square, 54 per product
        mont = sum(18 * s + 54 * bool(b) for s, b in args[-1])
    else:
        mont = {"mul": 1, "add": 0, "sub": 0, "fp2_mul": 3, "fp2_sqr": 2,
                "fp12_mul": 54, "fp12_sqr": 36}[name]
    return nbytes, n * mont


def flat_outputs(out):
    """A wrapper's result (a tensor or nested tuples of them) as a list."""
    if not isinstance(out, tuple):
        return [out]
    return [t for x in out for t in flat_outputs(x)]


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
    """Each kernel against its plain version on the same CUDA tensors, bit
    for bit, at every element count the main path launched it with (and
    miller_dbl_run at each run length of |x|), with COUNTS unchanged across
    every plain call.  Device time per launch (CUDA-graph replay), eager
    call time and plain time at the main path's most frequent size
    (miller_dbl_run: its longest run), and the bound of that call."""
    import numpy as np

    from bls_verify_gadget_tpu_torch.ops import pairing as PR

    def plain_call(name, plain, args):
        before = dict(K.COUNTS.launches)
        out = plain(*args)
        if K.COUNTS.launches != before:
            raise RuntimeError(f"the plain version of {name} launched kernels")
        return out

    rng = np.random.default_rng(SEED)
    longest = max(c for c, _ in PR.X_RUNS)
    rows, kernel_ms = [], 0.0
    for name, (replaces, source, _) in KERNELS.items():
        kern, plain = kernel_call(name)
        field = source == FIELD_SRC
        hist = sizes[name]
        n_main = max(hist, key=lambda s: (hist[s], s))
        if name == "miller_dbl_run":  # each run length once per verify
            cases = [(n, c, hist[n] / len(PR.X_RUNS)) for n in sorted(hist) for c, _ in PR.X_RUNS]
        else:
            cases = [(n, None, hist[n]) for n in sorted(hist)]
        worst, main = 0, None
        for n, count, weight in cases:
            if field:
                args = field_inputs(torch, rng, name, n)
            else:
                args = pairing_inputs(torch, rng, name, n, count)
            got = flat_outputs(kern(*args))
            ref = flat_outputs(plain_call(name, plain, args))
            if len(got) != len(ref):
                raise RuntimeError(f"kernel {name}: {len(got)} outputs, plain {len(ref)}")
            for g, r in zip(got, ref):
                worst = max(worst, int((g.long() - r.long()).abs().max()))
            ms = device_ms(torch, kern, args, *((20, 5) if field else (3, 2)))
            kernel_ms += ms * weight
            if n == n_main and count in (None, longest):
                main = (n, count, args, ms)
        if worst != 0:
            raise RuntimeError(f"kernel {name} disagrees with its plain version: max |err| {worst}")
        n, count, args, ms = main
        eager_ms = call_ms(torch, kern, args, 50 if field else 3)
        plain_ms = call_ms(torch, lambda *a: plain_call(name, plain, a), args, 3 if field else 1)
        nbytes, nmont = work(name, n, args)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nmont * MAD_PER_MONT / INT32_MAD_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
            "library_ms": None, "elements": n, "call_ms": eager_ms,
        }
        if count is not None:
            row["count"] = count
        rows.append(row)
        at = f"{n} elements" + (f", run of {count}" if count else "")
        checked = sorted({c for _, c, _ in cases}) if name == "miller_dbl_run" else sorted(hist)
        log(f"[kernel] {name}: bit-equal to plain at {len(cases)} main-path calls "
            f"({'run lengths' if name == 'miller_dbl_run' else 'sizes'} {checked}), COUNTS "
            f"unchanged by plain; at {at}: device {ms:.5f} ms, eager call {eager_ms:.5f} "
            f"ms, plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.5f} ms "
            f"({bound_by}); {launches[name]} launches per verify")
    from bls_verify_gadget_tpu_torch.ops.fp import FR

    n_fr = rows[0]["elements"]
    a, b = field_inputs(torch, rng, "mul", n_fr, FR)
    err = int((K.mul(FR, a, b).long() - FR.mul_plain(a, b).long()).abs().max())
    if err != 0:
        raise RuntimeError(f"Fr mul kernel disagrees with its plain version: max |err| {err}")
    log(f"[kernel] mul (Fr, 16 limbs): bit-equal to plain at {n_fr} elements")
    log(f"[kernel] kernel device time per verify batch (launches x device time "
        f"at each size) {kernel_ms:.3f} ms of {verify_s * 1e3:.3f} ms wall "
        f"({100 * kernel_ms / (verify_s * 1e3):.2f}%)")
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

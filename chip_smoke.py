#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (bls_verify_gadget_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card and nvcc.  Phases, each fatal on failure:
  1. device   -- card name and power limit (nvidia-smi), torch's name;
  2. build    -- nvcc builds the 24 kernels from csrc/ (one nvcc per
     source, all at once) and prints ptxas's register/stack/spill report
     (xmd's must show no stack and no spill); g++ builds the host codec;
  3. main path -- BatchedBLS(device="cuda").verify at batch 4096 with
     32-byte messages: the decodable verify vectors tiled, plus tampered-
     message and identity-pk probes.  One warm-up run, then timed runs;
     launch counters are zeroed just before the first timed run and read
     just after it: every kernel must have launched, the fused kernels
     and xmd the expected number of times (KERNELS); every element must
     equal its expected result.  Then the hash stage split into its parts (XMD +
     hash_to_field, sswu_map2, g2_cofactor, pt_to_affine), each closed by
     a synchronize, and its result held to hash_stage's;
  4. profile  -- one torch.profiler run over one verify batch, each part
     of the pipeline (the four hash parts, miller, final_exp) in its own
     range: device time by kernel, port and glue launches per part; the
     device's busy share of the wall time;
  5. keys     -- the second path, keygen, signing and aggregation, at the
     size users run it: 4096 keys (the sign/ vectors' keys, 0, 1, r - 1 and
     seeded random ones) through derive_pubkeys and sign; aggregate_pubkeys
     of the 4096 pubkeys, aggregate_signatures of the 4096 signatures
     (key 0's is the infinity), aggregate_pubkeys_masked over a 512-key sync committee at
     ~2/3 participation, aggregate_verify_distinct over the 4095 (pk, msg)
     pairs (its one-pair Miller launches at 4096 elements), and a doubling
     of the pubkeys (CV.pt_double).  Launch counters are zeroed just
     before and read just after that run: every kernel must have launched,
     pt_mul_var, pt_add, pt_dbl and xmd the expected number of times.  Then the
     checks: the sign/ vectors byte for byte (g2_compress), key 0 invalid,
     every valid (pk, msg, sig) true through verify and false with a
     tampered message, the aggregate/ and fast_aggregate_verify/ vectors,
     the masked sum against the subset's sum, the distinct-message
     aggregate false with two messages swapped; then ms and launches per
     call of each entry point.  Neither default path may launch a
     step-wise kernel;
  6. mixed    -- the mixed-length message path at batch 4096: the decodable
     verify vectors, then messages signed with the keys phase's keys (the
     sign/ vectors' messages, the RFC 9380 K.1 messages, every length at
     which msg' gains a block and seeded lengths up to 256), zero-padded
     to the longest, with per-element lengths.  sign(msg_lens=) and
     verify(msg_lens=) are counted apart (counters zeroed just before each
     and read just after): each launches what the keys phase's sign and
     the main path's verify launch.  Checks: the sign/ vectors byte for
     byte, each verify vector's expected output and true for every valid
     port-signed element, all false with a byte flipped inside each
     element's length and with each length changed by one, H(m) of the
     32-byte elements equal to the fixed-length path's; then the verify
     wall and verifications/s interleaved with the main path's
     fixed-length verify;
  7. steps    -- the step-wise pairing configuration (config.fuse_miller
     and fuse_expx off, restored however the phase ends) on the main
     path's batch: a warm-up verify that records the step kernels'
     operands, miller_stage's f and its final exponentiation limb-equal to
     the fused path's, one counted verify (counters zeroed just before,
     read just after: 424 launches, the default's less the 16 run and
     exp_x launches, plus 63 dbl_step and 5 add_step at 8192, 136 mul014
     and 63 more fp12_sqr at 4096, 30 cyclo_sqr at the run lengths of |x|
     and 25 more fp12_mul), every result as expected, then the stage times
     and verifications/s of the step-wise and the fused path in
     interleaved runs; then aggregate_verify_distinct over the keys
     phase's 4095 pairs, recorded, counted (368 launches: the fused call's
     launches with the same changes for one pair at 4096, the x-chains at
     batch 1), true, false with two messages swapped, and timed
     interleaved with the fused path;
  8. r1cs     -- the R1CS layer (r1cs/: builders, witness VM, evaluator,
     device_witness) on the lc_dot kernel and the field kernels.  The
     full BLS verify circuit: 64 (pk, 24-byte message, sig) triples from
     derive_pubkeys and sign on the card, decoded to host ints through
     golden/codec.py; the circuit built once on the host for triple 0
     (601,320 constraints, the JAX package's count, asserted before
     to_arrays), its rows, variables, tape entries and groups printed;
     every triple's input variables encoded; run_tape, complete_witness
     and check_satisfied on the card, each counted (counters zeroed just
     before, read just after) and timed: all 64 satisfied, one variable
     corrupted in the odd elements rejects exactly those, element 0's
     936,180 variables limb-equal to the host build's assignments.  The
     SHA-256 subcircuit (24-byte messages, the JAX package's
     tools/bench_r1cs.py configuration) at 256: the witness from
     device_witness and the message bit planes, complete_witness,
     check_satisfied, counted and timed: all satisfied, one element
     corrupted the only one rejected, element 0 equal to its host build.
     Host seconds of build, to_arrays, compile_tape and prepare; card
     seconds of replay, completion and evaluation; rows/s, witnesses/s;
     launches per kernel and lc_dot's per row width of each run;
  9. kernels  -- each kernel against its plain PyTorch version on the same
     CUDA tensors, bit for bit, at every element count that the verify
     run, the keys run, the mixed run or a steps run launched it with (a
     kernel launched
     at a count no case covers fails the run), with the launch counters
     unmoved by every plain call (the plain versions launch no kernel of
     the port): the field and
     pairing kernels on seeded random values plus edge values
     (miller_dbl_run at each run length, the Miller kernels with two pairs
     at verify's counts and with one pair at the keys run's), the
     hash-stage and subgroup kernels on each path's own data (pow_win for
     Fp and Fp2, pt_mul_const for G1 and G2 on the batch's points with
     infinity and off-subgroup probes, on the 4095 valid pubkeys and on the
     aggregate signature, sswu_map2 on hash_to_field's outputs with u = 0,
     g2_cofactor on sswu_map2's), the point kernels on the keys phase's
     data (pt_mul_var G1 and G2 at 4096, pt_add on the operands of every
     level of the three aggregation trees as the keys path passed them,
     and on P, Q meeting each branch of the complete addition, pt_dbl with
     count 1 and 63 on the pubkeys), the step-wise kernels on the steps
     phase's recorded operands (mul014 and dbl_step / add_step with two
     pairs stacked at 8192 and one pair at 4096, cyclo_sqr on cyclotomic
     elements at every run length at 4096 and 1) and on seeded random ones
     (mul014 with a quarter of the lines neutral, cyclo_sqr at every run
     length at 4096 and 1); lc_dot on the r1cs phase's witnesses and
     tables at every row width its runs launched (the evaluator's chunk
     at W = 8 on both circuits, the widest partial-sum level, per tape
     width the widest group), and mul, add, sub, fp2_mul, fp2_sqr,
     fp6_mul and pow_win at every element count the r1cs runs launched
     them with, on seeded operands; xmd on each path's messages (the verify
     batch, the keys run's 4096 and 4095, the mixed batch with its
     lengths), also against a host hashlib XMD element by element, on the
     RFC 9380 K.1 vectors with their DST, and with a 255-byte DST and 77
     bytes out;
     mul, add and sub (Fp and Fr), fp2_mul and fp2_sqr also on edge
     operands (0, 1, m - 1, the Montgomery one, a = b, borrows and carries
     across every word and lane; for mul 2^384 - 1 by R^2 and R^3 and 2p -
     1 squared; for fp2_sqr a sum of 2p - 2 and a doubling that crosses p)
     at 1, 4095, 4096, 8191 and 8192 elements;
     device time per launch from CUDA-graph replay, eager call time and
     plain time from CUDA events (a mean of 3 calls for the field kernels;
     the slow plain versions of the others: their one comparison call at
     the main size), and the bound from bytes and
     integer multiply-adds (xmd: SHA-256's 32-bit integer instructions);
     the launch floor: an empty kernel
     (launch_floor_kernel) timed the same way at 1 block and on each field
     kernel's grid;
 10. group    -- the group kernels (csrc/group.cuh): miller_dbl_run (k =
     1 and 2) and exp_x at 4096 and 4095 elements with mixed valid masks,
     fp12_mul at 4096, 4095 and 1, fp6_mul at 8192, 8191, 2 and 1 and
     fp12_sqr at 4096, 4095 and 1 (edge values in elements 0-4),
     pt_mul_const (G1 and G2 by |x|) and g2_cofactor at 4096, 4095 and 1
     with the ladders' edge points in the first elements (the infinity,
     G1 points of order 3 and 11, which meet the complete addition's
     P == -Q and P == Q cases, the off-subgroup points), miller_add (k = 1
     and 2) at 4096 and 4095 with mixed valid masks, sswu_map2 at 4096,
     4095 and 1 on hash_to_field's outputs with u = 0 elements (u0 = u1 =
     0 meets the sum's doubling case), and the lane-split pow_win
     (csrc/lanes.cuh) in Fp (e = p - 2) at 4096, 4095 and 1 with edge
     values and in Fp2 (e = (p - 11)/16) at 4096, pt_mul_var (G1 on
     the generator, G2 on H(m), 255 bits) at 4096, 4095 and 1 with the
     scalars 0, 1, 2, r - 1, r, r + 2 and 2^255 - 1 and a base at infinity
     in the first elements, cyclo_sqr at 4096, 4095 and 1, runs of 1 and
     32, on cyclotomic elements (the easy part of seeded values; the one
     in element 0) and on seeded random Fp12 with edge values in elements
     0-4, and mul014 at 4096, 4095 and 1 with a quarter of the lines
     neutral and edge values in elements 0-4 of f, dbl_step and add_step
     at 8192 (the step-wise verify's two pairs), 4096
     (aggregate_verify_distinct's one) and 1 with edge values in elements
     0-4, pt_add in G1 and G2 on seeded points at every level of the keys
     run's aggregation trees (2048, 1024, ..., 1 elements) and on P, Q
     meeting each branch of the complete addition at 2048 and 1, and
     pt_dbl in G1 and G2, count 1 and 63, at 4096 (edge values in
     elements 0-4, the infinity in element 5) and 1: bit-equal to the
     plain versions; the sweep's
     group sizes (throwaway copies of csrc/pairing_kernels.cu built with
     -DBLS_GROUP=G for G = 4, 8 and 16, which sets every group instance of
     the unit, of csrc/hash_kernels.cu built with -DBLS_HASH_GROUP=G for
     G = 2, 4 and 8 and with -DBLS_POW_LANES=L for pow_win's L = 2 and 4,
     of csrc/point_kernels.cu built with -DBLS_POINT_GROUP=G for G = 2, 4,
     8 and 16, into build/, in parallel with the library) bit-equal to the
     wrapper, and device ms per launch of each G or L at 4096 (fp6_mul,
     dbl_step and add_step 8192; and at 1 for the ladders, sswu_map2, the
     three tower products, pow_win, pt_mul_var, cyclo_sqr, mul014,
     dbl_step, add_step and pt_dbl; pt_add at every tree level, with the
     keys run's pt_add device time summed over its 33 launches); with
     --parent DIR, the
     parent commit's
     kernels (its pairing_kernels.cu, hash_kernels.cu and
     point_kernels.cu, built from DIR in parallel too) bit-equal as well
     and timed interleaved with this tree's (parent, group, group,
     parent).
     ptxas's registers, stack and spills and the shared memory per block of
     each group kernel instance are printed under [build];
 11. field    -- the staged field kernels (csrc/field_kernels.cu mul, add,
     sub, fp2_mul and fp2_sqr): fp2_mul at 8192, 4096 and 1 elements,
     fp2_sqr at 4096, 8192 and 1, mul in Fp at 8192, 4096 and 1 and in Fr
     at 8192 and 1, add and sub in Fp at 4096, 8192 and 1 and in Fr at
     4096 and 1, on seeded rows with edge operands: the wrapper bit-equal
     to the plain version, and bit-equal to it the sweep builds (throwaway
     copies of the unit built with -DBLS_MUL_PER_BLOCK=E
     -DBLS_ADD_PER_BLOCK=E -DBLS_SUB_PER_BLOCK=E -DBLS_FP2_MUL_PER_BLOCK=E
     -DBLS_FP2_SQR_PER_BLOCK=E for E = 8, 16, 32 and 64, each with mul,
     fp2_mul and fp2_sqr on 4 lanes and with -DBLS_MUL_LANES=1
     -DBLS_FP2_MUL_LANES=1 -DBLS_FP2_SQR_LANES=1, their one-thread bodies
     on the same staged rows, into build/, in
     parallel with the library) and with --parent DIR the parent commit's
     kernels (its field_kernels.cu, built from DIR in parallel too); device
     ms per launch of each, of the empty kernel on the library's grid, and
     of the parent's kernel and the library's interleaved (parent, change,
     change, parent); ptxas's lines of each instance under [build];
 12. parallel -- the sharded layer (parallel/) and the host codec.  The
     native batch codec (native_codec.py, built with g++ in the build
     phase) on the main path's 4096 (pk, sig) wire pairs, every verify/
     vector's and the deserialization vectors of a valid length: points
     and statuses equal to golden/bls.py's decode (its subgroup checks
     included) element for element, and host µs per element of the
     native decode to device batches beside the Python decodes'; then
     the native decode of wire traffic, the keys' own distinct pubkeys
     and signatures compressed: every status ok, every point the card's,
     host µs per element.  The host µs per verify at 4096 of the leading
     batch dims' shape handling (models/bls.py _batch, _flat, _unflat),
     and with --parent DIR the parent commit's BatchedBLS.verify and this
     tree's at 4096 interleaved (parent, change, change, parent).  On
     NCCL at world size 1, the main path's batch through sharded_verify,
     make_sharded_verify and make_sharded_verify_staged (its stages alone
     and chained): every result as expected, each form counted (counters
     zeroed just before, read just after) with BatchedBLS.verify's
     launches; the verify wall interleaved with the unsharded verify.
     Then two Gloo ranks on the one card (fresh interpreters after the
     kernels are built, CUDA tensors), 2048 elements each: the sharded
     verify of the main path's batch, sharded_aggregate_pubkeys and
     sharded_aggregate_signatures over the keys phase's 4096 keys and
     signatures, sharded_masked_aggregate over its 512-key committee at
     2/3, all limb-equal to CV.pt_sum of the two slabs' CV.pt_sum here,
     the count exact and the point equal to aggregate_pubkeys_masked's,
     and sharded_masked_aggregate_verify of the committee's aggregate
     signature true, then false with one more bit set.  A rank that
     fails or outlives its limit fails the phase;
 13. trace    -- utils/profiling.py and config.check_subgroups on the main
     path's batch.  Two verifies under profile_trace: the exported Chrome
     trace must hold the JAX package's four range names (bls_hash_to_g2,
     bls_validity_checks, bls_miller_loop, bls_final_exp) twice each; per
     range of the second verify its host wall, the device ms and launches
     of the kernels launched inside it (joined by correlation id) and its
     device span.  Verify without a
     counter: 118 launches, the wall; one default verify, one sign (the
     keys phase's keys) and one step-wise verify (fuse_miller and
     fuse_expx off, restored however the phase ends) under count_ops: per
     key, 1024 x the CPU's counts of the same call at 4 elements (the first
     cases, the first keys), with the counter's launches those of the
     uncounted run; Fp-mul-equivalents per element, and per second at the
     uncounted wall.  check_subgroups off (restored however the phase
     ends): no pt_mul_const launch; the elements whose points are in their
     subgroups give the flag-on results, the others the CPU's flag-off
     verify of the same elements.  The CPU references run in child
     processes (CUDA hidden, one thread each, lowest priority), started
     before the kernels phase (with --trace, at the phase's start).
Prints one JSON line of kernels, the card's name and power limit, and as
its last line {"ok": true, "device": {...}}.  Imports nothing of JAX.

    python3 chip_smoke.py --group [--parent DIR]
    python3 chip_smoke.py --field [--parent DIR]
    python3 chip_smoke.py --r1cs
    python3 chip_smoke.py --parallel [--parent DIR]
    python3 chip_smoke.py --trace

run only phases 1, 2 and 10 (the group kernels' checks, sweep and
timing), 1, 2 and 11 (the staged field kernels'), 1, 2, 8 and phase
9's R1CS checks (lc_dot's row and the field kernels at the r1cs runs'
counts), 1, 2 and 12 or 1, 2 and 13, and start only the builds of that
phase.
"""

import collections
import contextlib
import json
import pathlib
import re
import shutil
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
# SM has 64 INT32 lanes against 128 FP32 lanes: 132 SMs x 64 lanes x 1.98
# GHz, one 32-bit integer instruction (IMAD, IADD3, LOP3, SHF) per lane per
# clock
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 2 / 2
MAD_PER_MONT = 600  # 12x12 word products for a*b and for m*p, lo + hi each
# 32-bit integer instructions of one SHA-256 compression whose state and
# block differ in every word between elements: 64 rounds of 14 (3 SHF and a
# LOP3 per Sigma, a LOP3 each for ch and maj, 4 IADD3), 48 schedule words
# of 10 (3 SHF and a LOP3 per sigma, 2 IADD3), 8 adds (csrc/xmd_kernels.cu);
# sha_compression_ops counts fewer where words are the same for all
OPS_PER_COMPRESSION = 64 * 14 + 48 * 10 + 8

FIELD_SRC = "bls_verify_gadget_tpu_torch/csrc/field_kernels.cu"
PAIRING_SRC = "bls_verify_gadget_tpu_torch/csrc/pairing_kernels.cu"
HASH_SRC = "bls_verify_gadget_tpu_torch/csrc/hash_kernels.cu"
POINT_SRC = "bls_verify_gadget_tpu_torch/csrc/point_kernels.cu"
XMD_SRC = "bls_verify_gadget_tpu_torch/csrc/xmd_kernels.cu"
R1CS_SRC = "bls_verify_gadget_tpu_torch/csrc/r1cs_kernels.cu"
TPU_KERNELS = "bls_verify_gadget_tpu/ops/pallas/kernels.py"
# name -> (TPU kernel replaced, source, launches per verify expected or None)
KERNELS = {
    "mul": (f"{TPU_KERNELS}:227", FIELD_SRC, None),
    "add": (f"{TPU_KERNELS}:234", FIELD_SRC, None),
    "sub": (f"{TPU_KERNELS}:241", FIELD_SRC, None),
    "fp2_mul": (f"{TPU_KERNELS}:262", FIELD_SRC, None),
    "fp2_sqr": (f"{TPU_KERNELS}:276", FIELD_SRC, None),
    "fp6_mul": (f"{TPU_KERNELS}:291", PAIRING_SRC, 2),  # the two in fp12_inv
    "fp12_mul": (f"{TPU_KERNELS}:584", PAIRING_SRC, 9),
    "fp12_sqr": (f"{TPU_KERNELS}:596", PAIRING_SRC, 1),
    "miller_dbl_run": (f"{TPU_KERNELS}:1494", PAIRING_SRC, 6),
    "miller_add": (f"{TPU_KERNELS}:1537", PAIRING_SRC, 5),
    "exp_x": (f"{TPU_KERNELS}:1446", PAIRING_SRC, 5),
    # pt_to_affine in the hash stage, fp12_inv in final_exp
    "pow_win": (f"{TPU_KERNELS}:866", HASH_SRC, 2),
    "pt_mul_const": (f"{TPU_KERNELS}:819", HASH_SRC, 3),  # G1 twice, G2 once
    "g2_cofactor": (f"{TPU_KERNELS}:1219", HASH_SRC, 1),
    "sswu_map2": (f"{TPU_KERNELS}:1023", HASH_SRC, 1),
    # keygen, signing and aggregation (the keys phase), not verify
    "pt_dbl": (f"{TPU_KERNELS}:771", POINT_SRC, 0),
    "pt_add": (f"{TPU_KERNELS}:795", POINT_SRC, 0),
    "pt_mul_var": (f"{TPU_KERNELS}:1329", POINT_SRC, 0),
    # the step-wise configuration (the steps phase), not the default path
    "mul014": (f"{TPU_KERNELS}:606", PAIRING_SRC, 0),
    "dbl_step": (f"{TPU_KERNELS}:646", PAIRING_SRC, 0),
    "add_step": (f"{TPU_KERNELS}:688", PAIRING_SRC, 0),
    "cyclo_sqr": (f"{TPU_KERNELS}:1412", PAIRING_SRC, 0),
    # not a TPU kernel: the port's counterpart of the jnp code XLA fuses
    "xmd": ("none: the JAX package's jnp SHA-256/XMD (bls_verify_gadget_tpu/ops/sha256.py:28, "
            "bls_verify_gadget_tpu/ops/hash_to_g2.py:143)", XMD_SRC, 1),
    # not a TPU kernel either: the R1CS layer's LC dot (the r1cs phase), not verify
    "lc_dot": ("none: the JAX package's jnp LC dot (bls_verify_gadget_tpu/r1cs/evaluator.py:95 "
               "_dot_rows, :64 complete_witness, bls_verify_gadget_tpu/r1cs/witness_vm.py:120 "
               "_eval_lcs)", R1CS_SRC, 0),
}
STEP_KERNELS = ("mul014", "dbl_step", "add_step", "cyclo_sqr")
R1CS_KERNELS = ("lc_dot",)  # launched only by the r1cs phase
# launches of the step-wise configuration less the default's, per Miller
# pair count k: 63 doublings and 5 set bits of |x|, five x-chains of 6 runs
# and 5 set bits
STEP_DELTA = {"miller_dbl_run": -6, "miller_add": -5, "exp_x": -5, "dbl_step": 63,
              "add_step": 5, "fp12_sqr": 63, "cyclo_sqr": 30, "fp12_mul": 25}
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
    from bls_verify_gadget_tpu_torch import native_codec as NC

    t0 = time.perf_counter()
    so = K.build()
    K.library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    NC.library()
    log(f"[build] native codec {NC.library_path().name} (g++) in {time.perf_counter() - t0:.2f} s")
    keys = ("entry function", "Function properties", "registers", "spill")
    for line in so.with_suffix(".log").read_text().splitlines():
        if any(k in line for k in keys):
            log(f"[build] {line.strip()}")
    group_build_report(so.with_suffix(".log"), "library")
    field_build_report(so.with_suffix(".log"), "library")
    xmd_build_report(so.with_suffix(".log"), "library")


def unhex(s):
    return bytes.fromhex(s[2:] if s.startswith("0x") else s)


def verify_wire():
    """(pk bytes, sig bytes, msg, expected) of every verify/ vector."""
    out = []
    for path in sorted((ROOT / "tests" / "vectors" / "verify").glob("*.json")):
        vec = json.loads(path.read_text())
        out.append((unhex(vec["input"]["pubkey"]), unhex(vec["input"]["signature"]),
                    unhex(vec["input"]["message"]), bool(vec["output"])))
    return out


def verify_vectors():
    """(pk, sig, msg, expected, pk bytes, sig bytes) of every decodable
    verify/ vector."""
    from bls_verify_gadget_tpu_torch.golden import codec

    out = []
    for pk_raw, sig_raw, msg, ok in verify_wire():
        try:
            pk = codec.g1_decompress(pk_raw)
            sig = codec.g2_decompress(sig_raw)
        except ValueError:
            continue
        out.append((pk, sig, msg, ok, pk_raw, sig_raw))
    return out


def load_cases():
    """The main path's BATCH elements (pk, sig, msg, expected, pk bytes,
    sig bytes): the decodable verify vectors of MSG_LEN-byte messages, and
    for each valid one a tampered message and the identity pk, tiled."""
    from bls_verify_gadget_tpu_torch.golden import codec

    cases = []
    for pk, sig, msg, ok, pk_raw, sig_raw in verify_vectors():
        if len(msg) != MSG_LEN:
            continue
        cases.append((pk, sig, msg, ok, pk_raw, sig_raw))
        if ok:
            tampered = bytes([msg[0] ^ 1]) + msg[1:]
            cases.append((pk, sig, tampered, False, pk_raw, sig_raw))
            cases.append((None, sig, msg, False, codec.g1_compress(None), sig_raw))
    if not any(c[3] for c in cases):
        raise RuntimeError("no valid verify vector decoded")
    return [cases[i % len(cases)] for i in range(BATCH)]


def staged_verify(torch, bls, pk, sig, msg):
    """One verify batch stage by stage, each closed by a synchronize ->
    (result, (hash s, miller s, final_exp s))."""
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


def encode_cases(torch, cases):
    """The cases as device batches (pk, sig, msg, expected results).  The
    points are golden/codec.py's, which checks no subgroup: the inputs
    outside the subgroup reach the device's subgroup checks, where the
    native codec (parallel phase) rejects them on the host."""
    from bls_verify_gadget_tpu_torch.models.bls import (
        encode_messages, encode_pubkeys, encode_signatures,
    )

    pk = encode_pubkeys([c[0] for c in cases])
    sig = encode_signatures([c[1] for c in cases])
    msg = encode_messages([c[2] for c in cases])
    return pk, sig, msg, torch.tensor([c[3] for c in cases], device="cuda")


def main_path_phase(torch, K):
    from bls_verify_gadget_tpu_torch.models.bls import BatchedBLS

    pk, sig, msg, want = encode_cases(torch, load_cases())
    bls = BatchedBLS(device="cuda")

    def run():
        return staged_verify(torch, bls, pk, sig, msg)

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
    idle = [k for k, (_, _, want_n) in KERNELS.items() if want_n != 0 and launches[k] == 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the main path: {idle}")
    off = {k: launches[k] for k, (_, _, want_n) in KERNELS.items()
           if want_n is not None and launches[k] != want_n}
    if off:
        raise RuntimeError(f"fused kernels launched other than expected: {off}")
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
    parts = pipeline_parts(bls, pk, sig)
    n_hash = len(bls.hash_parts(MSG_LEN))
    hash_split(torch, parts[:n_hash], msg, bls.hash_stage(msg, MSG_LEN), stage_times)
    return launches, sizes, mean, parts, want, {"pk": pk, "sig": sig, "msg": msg}


def pipeline_parts(bls, pk, sig):
    """The verify pipeline as its parts, each a function of the previous
    part's output, the first of the message bytes: the parts of
    BatchedBLS.hash_stage (BatchedBLS.hash_parts), then miller_stage and
    finalexp_stage."""
    return [
        *bls.hash_parts(MSG_LEN),
        ("miller", lambda h: bls.miller_stage(pk, sig, h)),
        ("final_exp", lambda f_ok: bls.finalexp_stage(*f_ok)),
    ]


def hash_split(torch, parts, msg, want, stage_times):
    """Wall time of each hash part (closed by a synchronize) over
    TIMED_RUNS runs; each run's result must equal hash_stage's."""
    times = []
    for i in range(TIMED_RUNS):
        x, row = msg, []
        for _, fn in parts:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn(x)
            torch.cuda.synchronize()
            row.append(time.perf_counter() - t0)
        if not all(torch.equal(a, b) for a, b in zip(flat_outputs(x), flat_outputs(want))):
            raise RuntimeError(f"hash split run {i} disagrees with hash_stage")
        times.append(row)
    hash_ms = sum(st[0] for st in stage_times) / len(stage_times) * 1e3
    total = sum(sum(r) for r in times) / len(times) * 1e3
    log(f"[main] hash split, {TIMED_RUNS} runs (each equal to hash_stage): total {total:.3f} ms "
        f"(hash stage in the timed runs {hash_ms:.3f} ms)")
    for j, (name, _) in enumerate(parts):
        ms = [r[j] * 1e3 for r in times]
        mean = sum(ms) / len(ms)
        log(f"[main]   {name}: mean {mean:.3f} ms ({100 * mean / total:.2f}%) "
            f"{[round(x, 3) for x in ms]}")


def profile_phase(torch, parts, msg, want, verify_s):
    """Device time by kernel over one verify batch, in ONE torch.profiler
    run (CUPTI; back-to-back runs, one per part, lost a whole run's device
    events): each part of the pipeline in its own record_function range,
    closed by a synchronize, so every device kernel starts inside the range
    of the part that launched it.  Per part the port's kernel launches and
    time, and the other kernels' (torch glue); over the batch, the port
    kernels by name, the heaviest glue kernels, and the device's busy share
    of the unprofiled wall time."""
    from torch.profiler import ProfilerActivity, profile, record_function

    x = msg
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for name, fn in parts:
            with record_function(f"part:{name}"):
                x = fn(x)
                torch.cuda.synchronize()
    if not torch.equal(x, want):
        raise RuntimeError("the profiled verify batch disagrees with the expected results")
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranges = sorted((ev.time_range.start, ev.time_range.end, ev.name[5:]) for ev in events
                    if ev.name.startswith("part:") and ev.device_type != cuda)
    names = [name for name, _ in parts] + ["(outside every part)"]
    per_part = {n: [0.0, 0, 0.0, 0] for n in names}  # port us, launches, glue us, launches
    ours, others = {}, {}
    for ev in events:
        # device-side kernels only (a CPU op's total also carries the device
        # time of the kernels it launched, which would count twice; a
        # range's GPU annotation spans kernels counted already)
        if ev.device_type != cuda or ev.name.startswith("part:") or ev.name in TRACE_RANGES:
            continue
        start, us = ev.time_range.start, ev.time_range.elapsed_us()
        part = next((n for a, b, n in ranges if a <= start <= b), names[-1])
        hit = PORT_KERNEL_NAME.search(ev.name)
        acc, key = (ours, hit.group(1)) if hit else (others, ev.name[:80])
        kus, kn = acc.get(key, (0.0, 0))
        acc[key] = (kus + us, kn + 1)
        row = per_part[part]
        row[0 if hit else 2] += us
        row[1 if hit else 3] += 1
    port_us = sum(us for us, _ in ours.values())
    other_us = sum(us for us, _ in others.values())
    if port_us + other_us == 0:
        log("[profile] device time: not measured (the profiler saw no device activity)")
        return
    for name in names:
        p_us, p_n, o_us, o_n = per_part[name]
        if name in dict(parts) or p_n + o_n:
            log(f"[profile] {name}: port kernels {p_us / 1e3:.3f} ms over {p_n} launches, "
                f"glue {o_us / 1e3:.3f} ms over {o_n} launches")
    busy = (port_us + other_us) / 1e3
    n_other = sum(n for _, n in others.values())
    log(f"[profile] one verify batch: port kernels {port_us / 1e3:.3f} ms, other kernels "
        f"{other_us / 1e3:.3f} ms over {n_other} launches; device busy {busy:.3f} ms of "
        f"{verify_s * 1e3:.3f} ms unprofiled wall = {100 * busy / (verify_s * 1e3):.2f}% "
        f"busy, {100 - 100 * busy / (verify_s * 1e3):.2f}% idle")
    for name, (us, count) in sorted(ours.items(), key=lambda kv: -kv[1][0]):
        log(f"[profile]   {us / 1e3:9.3f} ms {count:7d} launches  port kernel {name}")
    for key, (us, count) in sorted(others.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[profile]   {us / 1e3:9.3f} ms {count:7d} launches  {key}")


# ----------------------------------------------------------------------------
# keys phase: keygen, signing and aggregation
# ----------------------------------------------------------------------------

COMMITTEE = 512  # pubkeys of a sync committee
PARTICIPATION = 2 / 3


def tree_counts(n):
    """Elements of each pt_add launch of a pt_sum halving tree over n points,
    level by level (an odd element carried to the next level)."""
    counts = []
    while n > 1:
        counts.append(n // 2)
        n = n // 2 + n % 2
    return counts


def tree_levels(n):
    """pt_add launches of a pt_sum halving tree over n points."""
    return len(tree_counts(n))


def keys_data():
    """BATCH secret keys and MSG_LEN-byte messages: the sign/ vectors' own
    (key, message) pairs first, then the keys 0, 1 and r - 1, then seeded
    random keys with seeded random messages.  -> (keys, messages, [(index,
    expected signature bytes)] of the vectors)."""
    import numpy as np

    from bls_verify_gadget_tpu_torch import constants as C

    rng = np.random.default_rng(SEED + 1)
    keys, msgs, vectors = [], [], []
    for path in sorted((ROOT / "tests" / "vectors" / "sign").glob("*.json")):
        vec = json.loads(path.read_text())
        if vec["output"] is None:  # the zero key: covered below
            continue
        vectors.append((len(keys), unhex(vec["output"])))
        keys.append(int.from_bytes(unhex(vec["input"]["privkey"]), "big"))
        msgs.append(unhex(vec["input"]["message"]))
    if len(vectors) != 9 or any(len(m) != MSG_LEN for m in msgs):
        raise RuntimeError(f"expected 9 sign vectors with {MSG_LEN}-byte messages")
    keys += [0, 1, C.R - 1]
    while len(keys) < BATCH:
        keys.append(int.from_bytes(rng.bytes(32), "little") % C.R)
    msgs += [rng.bytes(MSG_LEN) for _ in range(BATCH - len(msgs))]
    return keys, msgs, vectors


def committee_of(torch, keys):
    """-> (key != 0 mask, the indices of the nonzero keys, a seeded sync
    committee of COMMITTEE of them, its seeded bitmap at PARTICIPATION)."""
    import numpy as np

    rng = np.random.default_rng(SEED + 2)
    valid_keys = torch.tensor([k != 0 for k in keys], device="cuda")
    idx = valid_keys.nonzero().squeeze(1)  # the BATCH - 1 nonzero keys
    committee = torch.from_numpy(rng.permutation(idx.cpu().numpy())[:COMMITTEE]).cuda()
    bitmap = torch.from_numpy(rng.random(COMMITTEE) < PARTICIPATION).cuda()
    return valid_keys, idx, committee, bitmap


def take(pt, idx):
    """The elements `idx` of a point or affine tuple (nested tensors)."""
    if isinstance(pt, tuple):
        return tuple(take(c, idx) for c in pt)
    return pt[idx]


def batch_of_one(pt):
    """A point whose batch axis pt_sum dropped -> a batch of one."""
    if isinstance(pt, tuple):
        return tuple(batch_of_one(c) for c in pt)
    return pt[None]


def aggregate_vector_checks(torch, bls, CV, codec):
    """The 6 aggregate/ vectors through aggregate_signatures and the 11
    fast_aggregate_verify/ vectors through aggregate_pubkeys, then ONE
    batched verify, as the vectors' outputs say; an empty input or an
    undecodable one is decided at the host boundary."""
    from bls_verify_gadget_tpu_torch.models.bls import encode_messages, encode_signatures

    vec_dir = ROOT / "tests" / "vectors"
    n_agg = 0
    for path in sorted((vec_dir / "aggregate").glob("*.json")):
        vec = json.loads(path.read_text())
        sigs = [codec.g2_decompress(unhex(x)) for x in vec["input"]]
        if not sigs:
            if vec["output"] is not None:
                raise RuntimeError(f"{path.name}: an empty aggregate has no output")
            n_agg += 1
            continue
        (agg,) = CV.g2_decode(batch_of_one(bls.aggregate_signatures(
            CV.g2_encode_batch(sigs, "cuda"))))
        if codec.g2_compress(agg) != unhex(vec["output"]):
            raise RuntimeError(f"{path.name}: aggregate_signatures disagrees with the vector")
        n_agg += 1
    want, got, batch = {}, {}, []
    for path in sorted((vec_dir / "fast_aggregate_verify").glob("*.json")):
        vec = json.loads(path.read_text())
        want[path.name] = vec["output"]
        try:
            pks = [codec.g1_decompress(unhex(x)) for x in vec["input"]["pubkeys"]]
            sig = codec.g2_decompress(unhex(vec["input"]["signature"]))
        except ValueError:
            got[path.name] = False
            continue
        if not pks:
            got[path.name] = False
            continue
        batch.append((path.name, bls.aggregate_pubkeys(CV.g1_encode_batch(pks, "cuda")), sig,
                      unhex(vec["input"]["message"])))
    apk = tuple(torch.stack(c) for c in zip(*[b[1] for b in batch]))
    out = bls.verify(CV.pt_to_affine(CV.FP_OPS, apk), encode_signatures([b[2] for b in batch]),
                     encode_messages([b[3] for b in batch]))
    got.update({b[0]: bool(ok) for b, ok in zip(batch, out.tolist())})
    if got != want or n_agg != 6 or len(want) != 11:
        raise RuntimeError(f"fast_aggregate_verify vectors: got {got}, want {want}")
    log(f"[keys] the 6 aggregate/ vectors and the 11 fast_aggregate_verify/ vectors "
        f"({len(batch)} through one batched verify) give their expected outputs")


def keys_phase(torch, K):
    """The keygen, signing and aggregation path at BATCH keys, counted,
    checked and timed (see the module docstring, phase 5).  -> the data and
    counts the kernel rows use."""
    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_scalars,
    )
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    keys, msgs, vectors = keys_data()
    sk = encode_scalars(keys)
    msg = encode_messages(msgs)
    bls = BatchedBLS(device="cuda")
    valid_keys, idx, committee, bitmap = committee_of(torch, keys)
    pair_msg = msg[idx]

    def run():
        """The path as a user drives it: keys, signatures, the three
        aggregates, the distinct-message aggregate verification of every
        valid key's signature, and a doubling of the pubkeys."""
        pk = bls.derive_pubkeys(sk)
        sig, valid = bls.sign(sk, msg)
        out = {"pk": pk, "sig": sig, "valid": valid,
               "apk": bls.aggregate_pubkeys(pk), "asig": bls.aggregate_signatures(sig)}
        out["msum"], out["mcount"] = bls.aggregate_pubkeys_masked(take(pk, committee), bitmap)
        out["pk_aff"] = CV.pt_to_affine(CV.FP_OPS, take(pk, idx))
        out["sig_aff"] = CV.pt_to_affine(CV.FP2_OPS, batch_of_one(out["asig"]))
        out["distinct"] = bls.aggregate_verify_distinct(out["pk_aff"], out["sig_aff"], pair_msg)
        out["dbl"] = CV.pt_double(CV.FP_OPS, pk)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run()
    log(f"[keys] warm-up run at {BATCH} keys: {time.perf_counter() - t0:.3f} s")
    K.COUNTS.reset()
    t0 = time.perf_counter()
    out = run()
    run_s = time.perf_counter() - t0
    launches = dict(K.COUNTS.launches)
    sizes = {k: dict(v) for k, v in K.COUNTS.sizes.items()}
    idle = [k for k in K.KERNELS
            if k not in STEP_KERNELS + R1CS_KERNELS and launches[k] == 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the keys path: {idle}")
    stray = {k: launches[k] for k in STEP_KERNELS + R1CS_KERNELS if launches[k]}
    if stray:
        raise RuntimeError(f"step-wise or R1CS kernels launched on the keys path: {stray}")
    want_n = {"pt_mul_var": 2, "pt_dbl": 1, "xmd": 2,  # xmd: sign's hash, the distinct pairs'
              "pt_add": 2 * tree_levels(BATCH) + tree_levels(COMMITTEE)}
    off = {k: launches[k] for k, n in want_n.items() if launches[k] != n}
    if off:
        raise RuntimeError(f"point kernels and xmd launched other than expected {want_n}: {off}")
    log(f"[keys] counted run {run_s:.3f} s; launches: {launches} (total {sum(launches.values())})")
    log(f"[keys] element counts per kernel: "
        f"{ {k: dict(sorted(v.items())) for k, v in sizes.items()} }")

    # outputs of the counted run
    pk, sig = out["pk"], out["sig"]
    if out["valid"].tolist() != [k != 0 for k in keys]:
        raise RuntimeError("sign's valid mask is not 'key != 0'")
    vsig = CV.g2_decode(take(sig, torch.tensor([i for i, _ in vectors], device="cuda")))
    bad = [i for (i, want), got in zip(vectors, vsig) if codec.g2_compress(got) != want]
    if bad:
        raise RuntimeError(f"sign/ vectors at batch indices {bad} differ from their bytes")
    pk_aff, sig_aff = CV.pt_to_affine(CV.FP_OPS, pk), CV.pt_to_affine(CV.FP2_OPS, sig)
    if not torch.equal(bls.verify(pk_aff, sig_aff, msg), valid_keys):
        raise RuntimeError("verify of the port's own (pk, msg, sig) is not 'key != 0'")
    tampered = msg.clone()
    tampered[:, 0] ^= 1
    if bls.verify(pk_aff, sig_aff, tampered).any():
        raise RuntimeError("verify accepts a tampered message")
    log(f"[keys] sign/ vectors: all {len(vectors)} byte for byte; key 0 invalid; "
        f"verify of all {BATCH} (pk, msg, sig): {BATCH - 1} true (key 0 false), all false "
        f"with a tampered message")
    subset = bls.aggregate_pubkeys(take(take(pk, committee), bitmap))
    if not bool(CV.pt_eq(CV.FP_OPS, batch_of_one(out["msum"]), batch_of_one(subset))[0]):
        raise RuntimeError("the masked aggregate differs from the subset's sum")
    if int(out["mcount"]) != int(bitmap.sum()):
        raise RuntimeError("the masked aggregate's count is wrong")
    if not bool(out["distinct"]):
        raise RuntimeError("aggregate_verify_distinct rejects the valid signatures")
    # two valid keys that differ, with messages that differ (swapping the
    # messages of one key's two signatures leaves the product as it is)
    i, j = next((a, b) for a in range(len(msgs)) for b in range(a + 1, len(msgs))
                if keys[a] and keys[b] and keys[a] != keys[b] and msgs[a] != msgs[b])
    swapped = pair_msg.clone()
    ii, jj = int((idx == i).nonzero()), int((idx == j).nonzero())
    swapped[[ii, jj]] = swapped[[jj, ii]]
    if bool(bls.aggregate_verify_distinct(out["pk_aff"], out["sig_aff"], swapped)):
        raise RuntimeError("aggregate_verify_distinct accepts two swapped messages")
    if max_err(out["dbl"], CV.pt_add(CV.FP_OPS, pk, pk)) != 0:
        raise RuntimeError("pt_double differs from pt_add's doubling case")
    log(f"[keys] masked aggregate over {COMMITTEE} keys ({int(bitmap.sum())} set) equals the "
        f"subset's sum; aggregate_verify_distinct over {BATCH - 1} pairs true, false with "
        f"two messages swapped; pt_double equals pt_add(P, P)")
    aggregate_vector_checks(torch, bls, CV, codec)

    h = bls.hash_to_g2(msg)
    calls = [
        ("derive_pubkeys", lambda: bls.derive_pubkeys(sk)),
        ("sign", lambda: bls.sign(sk, msg)),
        ("sign: hash_to_g2", lambda: bls.hash_to_g2(msg)),
        ("sign: pt_mul_var", lambda: CV.pt_mul_var(CV.FP2_OPS, h, sk, 255)),
        ("aggregate_pubkeys", lambda: bls.aggregate_pubkeys(pk)),
        ("aggregate_signatures", lambda: bls.aggregate_signatures(sig)),
        ("aggregate_pubkeys_masked", lambda: bls.aggregate_pubkeys_masked(
            take(pk, committee), bitmap)),
        ("aggregate_verify_distinct", lambda: bls.aggregate_verify_distinct(
            out["pk_aff"], out["sig_aff"], pair_msg)),
    ]
    per_call = {}
    for name, fn in calls:
        ms = []
        for _ in range(TIMED_RUNS):
            K.COUNTS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        n_launch = sum(K.COUNTS.launches.values())
        per_call[name] = (sum(ms) / len(ms), n_launch, dict(K.COUNTS.launches))
        log(f"[keys] {name}: mean {per_call[name][0]:.3f} ms ({[round(x, 3) for x in ms]}), "
            f"{n_launch} port launches per call")
    sign_ms = per_call["sign"][0]
    log(f"[keys] {BATCH / (sign_ms / 1e3):.1f} signatures/s and "
        f"{BATCH / (per_call['derive_pubkeys'][0] / 1e3):.1f} pubkeys/s at batch {BATCH}")
    gen = CV.g1_generator((BATCH, 24), "cuda")
    return {"launches": launches, "sizes": sizes, "pk": pk, "sig": sig, "h": h, "sk": sk,
            "gen": gen, "bls": bls, "pk_valid": take(pk, idx), "pk_aff": out["pk_aff"],
            "asig": batch_of_one(out["asig"]), "sig_aff": out["sig_aff"],
            "pair_msg": pair_msg, "swapped_msg": swapped, "committee_pk": take(pk, committee),
            "bitmap": bitmap, "msg": msg, "keys": keys, "vectors": vectors,
            "sign_launches": per_call["sign"][2]}


# ----------------------------------------------------------------------------
# mixed phase: messages of many lengths in one batch (msg_lens)
# ----------------------------------------------------------------------------

RFC_DST = b"QUUX-V01-CS02-with-expander-SHA256-128"
RFC_XMD = [  # RFC 9380 K.1, expand_message_xmd(msg, RFC_DST, 0x20)
    (b"", "68a985b87eb6b46952128911f2a4412bbc302a9d759667f87f7a21d803f07235"),
    (b"abc", "d8ccab23b5985ccea865c6c97b6e5b8350e794e603b4b97902f53a8a0d605615"),
    (b"abcdef0123456789", "eff31487c770a893cfb36f912fbfcbff40d5661771ca4b2cb4eafe524333f5c1"),
    (b"q128_" + b"q" * 128, "b23a1d2b4d97b2ef7785562a7e8bac7eed54ed6e97e29aa51bfe3f12ddad1ff9"),
    (b"a512_" + b"a" * 512, "4623227bcc01293b8c130bf771da8c298dede7383243dc0993d2d94823958c4c"),
]
# message lengths at which msg' (64 + len + 47 bytes with DST_G2) or the
# padding of a SHA-256 input gains a block, and the ends of 0..256
EDGE_LENS = (0, 1, 8, 9, 55, 56, 63, 64, 72, 73, 119, 120, 136, 137, 200, 201, 255, 256)


def host_xmd(msg: bytes, dst: bytes, len_in_bytes: int) -> bytes:
    """expand_message_xmd with hashlib (RFC 9380 sec 5.3.1)."""
    import hashlib

    dst_prime = dst + bytes([len(dst)])
    b0 = hashlib.sha256(bytes(64) + msg + len_in_bytes.to_bytes(2, "big") + b"\x00"
                        + dst_prime).digest()
    out, prev = b"", bytes(32)
    for i in range(1, -(-len_in_bytes // 32) + 1):
        prev = hashlib.sha256(bytes(a ^ b for a, b in zip(b0, prev)) + bytes([i])
                              + dst_prime).digest()
        out += prev
    return out[:len_in_bytes]


def cat_tree(torch, a, b):
    """Two point or affine tuples (nested tensors) joined on the batch axis."""
    if isinstance(a, tuple):
        return tuple(cat_tree(torch, x, y) for x, y in zip(a, b))
    return torch.cat([a, b])


def mixed_phase(torch, K, ctx, want, keys, main_launches):
    """The mixed-length path at BATCH messages (module docstring, phase 6),
    counted, checked and timed interleaved with the main path's
    fixed-length verify.  -> its launches, element counts and operands for
    the kernel rows."""
    import numpy as np

    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import (
        encode_messages_var, encode_pubkeys, encode_signatures,
    )
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    bls = keys["bls"]
    vecs = verify_vectors()
    nv = len(vecs)
    rng = np.random.default_rng(SEED + 4)
    # element nv + j is signed with the keys phase's key j: the sign/
    # vectors' keys and messages first, then the RFC messages and the edge
    # lengths, then seeded lengths; the vectors' elements take the last keys
    nsign = len(keys["vectors"])
    kmsgs = [bytes(m) for m in keys["msg"][:nsign].cpu().numpy()]
    kmsgs += [m for m, _ in RFC_XMD] + [rng.bytes(n) for n in EDGE_LENS]
    kmsgs += [rng.bytes(int(n)) for n in rng.integers(0, 257, BATCH - nv - len(kmsgs))]
    msgs = [v[2] for v in vecs] + kmsgs
    msg, lens, width = encode_messages_var(msgs)
    order = torch.arange(BATCH, device="cuda").roll(nv)  # element i <- key order[i]
    sk = keys["sk"][order]
    valid_key = torch.tensor([k != 0 for k in keys["keys"]], device="cuda")[order]
    pk_aff = CV.pt_to_affine(CV.FP_OPS, take(keys["pk"], order[nv:]))
    pk_aff = cat_tree(torch, encode_pubkeys([v[0] for v in vecs]), pk_aff)
    expect = torch.cat([torch.tensor([v[3] for v in vecs], device="cuda"), valid_key[nv:]])

    def sign():
        return bls.sign(sk, msg, width, msg_lens=lens)

    def sig_aff(sig):
        port = CV.pt_to_affine(CV.FP2_OPS, take(sig, slice(nv, None)))
        return cat_tree(torch, encode_signatures([v[1] for v in vecs]), port)

    def verify(m=msg, n=lens, sig=None):
        return bls.verify(pk_aff, sig, m, width, msg_lens=n)

    (sig, valid), launches_s, sizes_s = counted(torch, K, sign)
    sig_v = sig_aff(sig)
    out, launches_v, sizes_v = counted(torch, K, lambda: verify(sig=sig_v))
    off = {k: (launches_s[k], keys["sign_launches"][k]) for k in launches_s
           if launches_s[k] != keys["sign_launches"][k]}
    off.update({k: (launches_v[k], main_launches[k]) for k in launches_v
                if launches_v[k] != main_launches[k]})
    if off:
        raise RuntimeError(f"mixed sign / verify launches other than the fixed-length "
                           f"path's, (got, want): {off}")
    launches = {k: launches_s[k] + launches_v[k] for k in launches_s}
    sizes = {k: {n: sizes_s[k].get(n, 0) + sizes_v[k].get(n, 0)
                 for n in {*sizes_s[k], *sizes_v[k]}} for k in sizes_s}
    if not torch.equal(valid, valid_key):
        raise RuntimeError("mixed sign's valid mask is not 'key != 0'")
    vsig = CV.g2_decode(take(sig, torch.arange(nv, nv + nsign, device="cuda")))
    bad = [i for (i, want_b), got in zip(keys["vectors"], vsig) if codec.g2_compress(got) != want_b]
    if bad:
        raise RuntimeError(f"sign/ vectors inside the mixed batch at {bad} differ from their bytes")
    if not torch.equal(out, expect):
        raise RuntimeError(f"mixed verify: {int((out != expect).sum())} wrong results")
    flipped = msg.clone()
    live = lens > 0
    rows = torch.arange(BATCH, device="cuda")[live]
    flipped[rows, (rows * 7919) % lens[live]] ^= 1
    if verify(flipped, sig=sig_v)[live].any():
        raise RuntimeError("mixed verify accepts a message with a byte flipped")
    moved = torch.where(lens < width, lens + 1, lens - 1)
    if verify(msg, moved, sig_v).any():
        raise RuntimeError("mixed verify accepts a length changed by one")
    idx = (lens == MSG_LEN).nonzero().squeeze(1)
    h_mixed = take(bls.hash_to_g2(msg, width, msg_lens=lens), idx)
    if max_err(h_mixed, bls.hash_to_g2(msg[idx, :MSG_LEN].contiguous())) != 0:
        raise RuntimeError("H(m) of the 32-byte elements differs from the fixed-length path's")
    n_true = int(expect.sum())
    log(f"[mixed] {BATCH} messages of lengths {int(lens.min())}..{int(lens.max())} padded to "
        f"{width} ({nv} verify vectors, {nsign} sign/ vectors, {len(RFC_XMD)} RFC 9380 K.1 "
        f"messages, {len(EDGE_LENS)} edge lengths): sign {sum(launches_s.values())} and verify "
        f"{sum(launches_v.values())} port launches, each the fixed-length path's; sign/ "
        f"vectors byte for byte; verify right ({n_true} true); all false with a byte flipped "
        f"({int(live.sum())} elements) and with each length moved by one; H(m) of the "
        f"{len(idx)} 32-byte elements equal to the fixed-length path's")

    times = {"mixed": [], "fixed": []}
    runs = {"mixed": lambda: verify(sig=sig_v),
            "fixed": lambda: bls.verify(ctx["pk"], ctx["sig"], ctx["msg"], MSG_LEN)}
    wants = {"mixed": expect, "fixed": want}
    for i in range(TIMED_RUNS):
        for which in (("mixed", "fixed") if i % 2 == 0 else ("fixed", "mixed")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runs[which]()
            torch.cuda.synchronize()
            times[which].append(time.perf_counter() - t0)
            if not torch.equal(res, wants[which]):
                raise RuntimeError(f"timed {which} verify wrong")
    for which, ts in times.items():
        mean = sum(ts) / len(ts)
        log(f"[mixed] {which} verify, {TIMED_RUNS} runs interleaved: wall s "
            f"{[round(t, 6) for t in ts]}; mean {mean:.6f} s = {BATCH / mean:.1f} "
            f"verifications/s")
    return {"launches": launches, "sizes": sizes, "msg": msg, "lens": lens}


# ----------------------------------------------------------------------------
# steps phase: the step-wise pairing configuration
# ----------------------------------------------------------------------------

def recorded_steps(torch, K, fn, keep):
    """Run fn with the step kernels' wrappers wrapped -> (fn's result, a
    Counter of (name, elements, run length or None) over their calls, and
    where `keep` the operands (cloned) of the last call per such key).  The
    wrappers launch and count as they always do."""
    import collections

    calls, kept = collections.Counter(), {}
    wrappers = {name: getattr(K, name) for name in STEP_KERNELS}

    def recording(name):
        def call(field, *args):
            key = (name, args[0].shape[1], args[-1] if name == "cyclo_sqr" else None)
            calls[key] += 1
            if keep:
                kept[key] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            return wrappers[name](field, *args)
        return call

    for name in STEP_KERNELS:
        setattr(K, name, recording(name))
    try:
        out = fn()
    finally:
        for name, wrapper in wrappers.items():
            setattr(K, name, wrapper)
    return out, calls, kept


def counted(torch, K, fn):
    """fn's result with the launches and element counts of its run alone."""
    K.COUNTS.reset()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(K.COUNTS.launches), {k: dict(v) for k, v in K.COUNTS.sizes.items()}


def check_step_launches(path, launches, fused, pairs, total):
    """The step-wise run's launches are the default run's plus STEP_DELTA
    and 68 mul014 per pair, `total` in all."""
    want = {k: fused[k] + STEP_DELTA.get(k, 0) for k in fused}
    want["mul014"] = 68 * pairs
    off = {k: (launches[k], n) for k, n in want.items() if launches[k] != n}
    if off or sum(launches.values()) != total:
        raise RuntimeError(f"step-wise {path}: {sum(launches.values())} launches (want {total}); "
                           f"(got, want) where they differ: {off}")


def check_sizes(path, sizes, want):
    """Each kernel in `want` launched at exactly these element counts."""
    off = {k: sizes[k] for k, v in want.items() if sizes[k] != v}
    if off:
        raise RuntimeError(f"step-wise {path}: launches per element count {off}, want "
                           f"{ {k: want[k] for k in off} }")


def steps_phase(torch, K, ctx, want, main_launches, keys):
    """The step-wise configuration (config.fuse_miller and fuse_expx off)
    on the main path's batch and on the keys phase's 4095 pairs (module
    docstring, phase 7); the configuration is restored however the phase
    ends.  -> launches, element counts and recorded operands of its counted
    runs, per path ("steps": verify, "steps_avd":
    aggregate_verify_distinct), for the kernel rows."""
    from bls_verify_gadget_tpu_torch.models.bls import BatchedBLS
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import pairing as PR
    from bls_verify_gadget_tpu_torch.ops import tower as T
    from bls_verify_gadget_tpu_torch.utils.config import config

    bls = BatchedBLS(device="cuda")
    pk, sig, msg = ctx["pk"], ctx["sig"], ctx["msg"]
    lengths = [c for c, _ in CV.X_SEGMENTS]
    saved = (config.fuse_miller, config.fuse_expx)

    def step_wise(on):
        config.fuse_miller = config.fuse_expx = not on

    def verify():
        return bls.verify(pk, sig, msg, MSG_LEN)

    def distinct(m):
        return bool(bls.aggregate_verify_distinct(keys["pk_aff"], keys["sig_aff"], m))

    try:
        step_wise(True)
        t0 = time.perf_counter()
        out, calls, kept_v = recorded_steps(torch, K, verify, keep=True)
        log(f"[steps] warm-up step-wise verify at batch {BATCH}: {time.perf_counter() - t0:.3f} s")
        if not torch.equal(out, want):
            raise RuntimeError(f"step-wise verify: {int((out != want).sum())} wrong results")
        runs = sorted(c for (name, _, c), n in calls.items() if name == "cyclo_sqr"
                      for _ in range(n))
        if runs != sorted(lengths * 5):
            raise RuntimeError(f"cyclo_sqr run lengths {runs}, want each of {lengths} 5 times")

        h = bls.hash_stage(msg, MSG_LEN)
        stages = {}
        for on in (False, True):
            step_wise(on)
            f, ok = bls.miller_stage(pk, sig, h)
            stages[on] = (T.fp12_pack(f), T.fp12_pack(PR.final_exponentiation(f)), ok)
        for name, a, b in zip(("miller_stage f", "final exponentiation", "checks"),
                              stages[True], stages[False]):
            if not torch.equal(a, b):
                raise RuntimeError(f"step-wise {name} differs from the fused path's")
        log(f"[steps] miller_stage's f, its final exponentiation and the checks mask: "
            f"limb-equal to the fused path's at batch {BATCH}")

        step_wise(True)
        out, launches, sizes = counted(torch, K, verify)
        if not torch.equal(out, want):
            raise RuntimeError(f"counted step-wise verify: {int((out != want).sum())} wrong")
        check_step_launches("verify", launches, main_launches, 2, 424)
        check_sizes("verify", sizes, {
            "dbl_step": {2 * BATCH: 63}, "add_step": {2 * BATCH: 5}, "mul014": {BATCH: 136},
            "fp12_sqr": {BATCH: 64}, "cyclo_sqr": {BATCH: 30}, "miller_dbl_run": {},
            "miller_add": {}, "exp_x": {}})
        n_true = int(want.sum())
        log(f"[steps] verify: {BATCH} verifications ({n_true} true, {BATCH - n_true} false) "
            f"right; {sum(launches.values())} port launches per batch: {launches}")

        times = {True: [], False: []}
        for i in range(TIMED_RUNS):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                step_wise(on)
                out, st = staged_verify(torch, bls, pk, sig, msg)
                if not torch.equal(out, want):
                    raise RuntimeError(f"timed verify ({'step-wise' if on else 'fused'}) wrong")
                times[on].append(st)
        for on, label in ((True, "step-wise"), (False, "fused")):
            totals = [sum(st) for st in times[on]]
            mean = sum(totals) / len(totals)
            stage_ms = [sum(st[j] for st in times[on]) / len(times[on]) * 1e3 for j in range(3)]
            log(f"[steps] {label} verify, {TIMED_RUNS} runs interleaved: wall s "
                f"{[round(t, 6) for t in totals]}; mean {mean:.6f} s = "
                f"{BATCH / mean:.1f} verifications/s; hash {stage_ms[0]:.3f}, miller "
                f"{stage_ms[1]:.3f}, final_exp {stage_ms[2]:.3f} ms")

        step_wise(True)
        _, calls_a, kept_a = recorded_steps(torch, K, lambda: distinct(keys["pair_msg"]),
                                            keep=True)
        ok, launches_a, sizes_a = counted(torch, K, lambda: distinct(keys["pair_msg"]))
        if not ok:
            raise RuntimeError("step-wise aggregate_verify_distinct rejects the valid pairs")
        if distinct(keys["swapped_msg"]):
            raise RuntimeError("step-wise aggregate_verify_distinct accepts swapped messages")
        step_wise(False)
        ok, launches_f, _ = counted(torch, K, lambda: distinct(keys["pair_msg"]))
        if not ok:
            raise RuntimeError("aggregate_verify_distinct rejects the valid pairs")
        check_step_launches("aggregate_verify_distinct", launches_a, launches_f, 1, 368)
        n = keys["pair_msg"].shape[0] + 1
        check_sizes("aggregate_verify_distinct", sizes_a, {
            "dbl_step": {n: 63}, "add_step": {n: 5}, "mul014": {n: 68},
            "cyclo_sqr": {1: 30}})
        if sizes_a["fp12_sqr"].get(n) != 63 or sizes_a["fp12_mul"].get(1, 0) < 34:
            raise RuntimeError(f"step-wise aggregate_verify_distinct: fp12_sqr at "
                               f"{sizes_a['fp12_sqr']}, fp12_mul at {sizes_a['fp12_mul']}")
        ms = {True: [], False: []}
        for i in range(TIMED_RUNS):
            for on in ((True, False) if i % 2 == 0 else (False, True)):
                step_wise(on)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if not distinct(keys["pair_msg"]):
                    raise RuntimeError("timed aggregate_verify_distinct rejects the valid pairs")
                ms[on].append((time.perf_counter() - t0) * 1e3)
        log(f"[steps] aggregate_verify_distinct over {n - 1} pairs: true, false with two "
            f"messages swapped; {sum(launches_a.values())} port launches per call (fused "
            f"{sum(launches_f.values())}): {launches_a}")
        for on, label in ((True, "step-wise"), (False, "fused")):
            log(f"[steps] {label} aggregate_verify_distinct, {TIMED_RUNS} runs interleaved: "
                f"mean {sum(ms[on]) / len(ms[on]):.3f} ms ({[round(x, 3) for x in ms[on]]})")
    finally:
        config.fuse_miller, config.fuse_expx = saved
    return {"launches": {"steps": launches, "steps_avd": launches_a},
            "sizes": {"steps": sizes, "steps_avd": sizes_a},
            "kept": {"steps": kept_v, "steps_avd": kept_a},
            "calls": {"steps": calls, "steps_avd": calls_a}}


# ----------------------------------------------------------------------------
# r1cs phase: the full BLS verify circuit and the SHA-256 subcircuit on the
# R1CS layer (witness VM, complete_witness, check_satisfied on lc_dot)
# ----------------------------------------------------------------------------

R1CS_BATCH = 64  # verify-circuit witnesses: 64 x 936,180 x 96 B of witness
R1CS_MSG_LEN = 24  # the message length of the JAX package's circuit count
VERIFY_ROWS = 601320  # bls_verify_gadget_tpu's tests/test_r1cs_verify.py:29
SHA_BATCH = 256  # the SHA-256 subcircuit (tools/bench_r1cs.py's configuration)
R1CS_CHUNK = 8192  # rows per check_satisfied chunk
R1CS_FIELD = ("mul", "add", "sub", "fp2_mul", "fp2_sqr", "fp6_mul", "pow_win")


def r1cs_triples(torch, rng, n):
    """n (pk, 24-byte message, sig) triples from the port's keys path on the
    card (derive_pubkeys, sign), decoded to host ints through the port's
    compressed-point codec."""
    from bls_verify_gadget_tpu_torch import constants as C
    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import BatchedBLS, encode_messages, encode_scalars
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    keys = [int.from_bytes(rng.bytes(32), "little") % (C.R - 1) + 1 for _ in range(n)]
    msgs = [rng.bytes(R1CS_MSG_LEN) for _ in range(n)]
    bls = BatchedBLS(device="cuda")
    sk, msg = encode_scalars(keys), encode_messages(msgs)
    pk = bls.derive_pubkeys(sk)
    sig, valid = bls.sign(sk, msg)
    if not bool(valid.all()):
        raise RuntimeError("sign marks a nonzero key invalid")
    pks = [codec.g1_decompress(codec.g1_compress(p)) for p in CV.g1_decode(pk)]
    sigs = [codec.g2_decompress(codec.g2_compress(s)) for s in CV.g2_decode(sig)]
    if any(p is None for p in pks) or any(s is None for s in sigs):
        raise RuntimeError("a key or signature of the keys path does not decode")
    return list(zip(pks, msgs, sigs))


def verify_input_values(pk, msg, sig):
    """The verify circuit's input variables for one triple, in tape order:
    the pk and sig coordinates and the message bits, read from their
    allocations on a scratch system (tools/witness_vm_verify.py's
    input_values)."""
    from bls_verify_gadget_tpu_torch.r1cs.gadgets import UInt8
    from bls_verify_gadget_tpu_torch.r1cs.system import ConstraintSystem
    from bls_verify_gadget_tpu_torch.r1cs.verify import PublicKeyVar, SignatureVar

    scratch = ConstraintSystem()
    PublicKeyVar.alloc(scratch, pk)
    [UInt8.alloc(scratch, b) for b in msg]
    SignatureVar.alloc(scratch, sig)
    return [scratch.assignments[i] for e in scratch.tape if e["kind"] == "input"
            for i in e["outs"]]


def nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def merge_sizes(*size_maps):
    out = collections.defaultdict(collections.Counter)
    for sizes in size_maps:
        for k, v in sizes.items():
            out[k].update(v)
    return {k: dict(v) for k, v in out.items()}


def corrupt(torch, wit, col, elems):
    """Add one to variable `col` of the witness elements `elems`, in place;
    -> the column's old values."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    saved = wit[:, col].clone()
    wit[elems, col] = FP.add(wit[elems, col], FP.const("ONE", wit.device).expand(
        len(elems), 24).contiguous())
    return saved


@contextlib.contextmanager
def candidate_root_hints():
    """Host builds inside take the square-root hint of the SSWU map
    (r1cs/hasher.py sswu_map_gadget) as the device does: the root that
    fp2_sqrt_candidates returns (golden field fp2_sqrt_candidate_root), not
    golden fp2_sqrt's, which is its negation for about half of all
    squares.  Both satisfy the circuit."""
    from bls_verify_gadget_tpu_torch.golden import field as GF

    saved = GF.fp2_sqrt
    GF.fp2_sqrt = GF.fp2_sqrt_candidate_root
    try:
        yield
    finally:
        GF.fp2_sqrt = saved


def build_verify_circuit(triple):
    """The port's verify gadget for one (pk, msg, sig) on a new system ->
    (cs, the gadget's output bit)."""
    from bls_verify_gadget_tpu_torch.r1cs.gadgets import UInt8
    from bls_verify_gadget_tpu_torch.r1cs.system import ConstraintSystem
    from bls_verify_gadget_tpu_torch.r1cs.verify import (
        BlsSignatureVerifyGadget, ParametersVar, PublicKeyVar, SignatureVar,
    )

    pk, msg, sig = triple
    cs = ConstraintSystem()
    ok = BlsSignatureVerifyGadget.verify(cs, ParametersVar.constant(cs), PublicKeyVar.alloc(cs, pk),
                                         [UInt8.alloc(cs, b) for b in msg],
                                         SignatureVar.alloc(cs, sig))
    return cs, ok.value


def verify_circuit(torch, K, smi, rng):
    """The full 601,320-constraint verify circuit: built once on the host
    for triple 0, its tape replayed for R1CS_BATCH triples on the card, the
    partial sums completed, every element checked; exactly the corrupted
    elements rejected; element 0 limb-equal to the host build that takes
    the device's square roots, and the host build with golden fp2_sqrt's
    roots differing only where those roots' sign reaches."""
    from bls_verify_gadget_tpu_torch.r1cs import evaluator as EV
    from bls_verify_gadget_tpu_torch.r1cs import witness_vm as VM

    B = R1CS_BATCH
    t0 = time.perf_counter()
    triples = r1cs_triples(torch, rng, B)
    keys_s = time.perf_counter() - t0
    host_s = {}
    t0 = time.perf_counter()
    cs, ok = build_verify_circuit(triples[0])
    host_s["build"] = time.perf_counter() - t0
    n_constraints = cs.num_constraints
    if ok != 1 or n_constraints != VERIFY_ROWS:
        raise RuntimeError(f"verify circuit: output {ok}, {n_constraints} constraints (want 1 "
                           f"and {VERIFY_ROWS})")
    uncovered = cs.tape_uncovered()
    if uncovered:
        raise RuntimeError(f"{len(uncovered)} variables no tape entry produces")
    n_base, n_tape = len(cs.assignments), len(cs.tape)
    t0 = time.perf_counter()
    arrays = cs.to_arrays()
    host_s["to_arrays"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ct = VM.compile_tape(cs)
    host_s["compile_tape"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prepared = EV.prepare(arrays)
    host_s["prepare"] = time.perf_counter() - t0
    rows, n_vars = arrays["a_idx"].shape[0], arrays["num_vars"]
    log(f"[r1cs] verify circuit ({R1CS_MSG_LEN}-byte message): {n_constraints} "
        f"constraints, {n_base} variables, {n_tape} tape entries; after to_arrays {rows} rows "
        f"of width {arrays['a_idx'].shape[1]}, {n_vars} variables ({len(arrays['aux_var'])} "
        f"partial sums in {len(prepared['levels'])} levels), {len(ct.groups)} tape groups; "
        f"{B} triples from derive_pubkeys / sign in {keys_s:.3f} s")
    log(f"[r1cs] host s: build {host_s['build']:.3f}, to_arrays {host_s['to_arrays']:.3f}, "
        f"compile_tape {host_s['compile_tape']:.3f}, prepare {host_s['prepare']:.3f} "
        f"({smi})")
    t0 = time.perf_counter()
    inputs = EV.encode_witness_batch([verify_input_values(*t) for t in triples])
    host_s["inputs"] = time.perf_counter() - t0
    if inputs.shape[1] != len(ct.input_vars):
        raise RuntimeError(f"{inputs.shape[1]} input values for {len(ct.input_vars)} inputs")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wit, *replay = counted(torch, K, lambda: VM.run_tape(ct, inputs, B))
    replay_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, *complete = counted(torch, K, lambda: EV.complete_witness(prepared, wit))
    complete_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    good, *evaluate = counted(torch, K, lambda: EV.check_satisfied(prepared, wit, R1CS_CHUNK))
    eval_s = time.perf_counter() - t0
    if not bool(good.all()):
        raise RuntimeError(f"verify circuit: {int((~good).sum())} of {B} device witnesses "
                           f"unsatisfied")
    col = n_base - 5
    odd = list(range(1, B, 2))
    saved = corrupt(torch, wit, col, odd)
    bad = EV.check_satisfied(prepared, wit, R1CS_CHUNK)
    wit[:, col] = saved
    if bad.tolist() != [i % 2 == 0 for i in range(B)]:
        raise RuntimeError(f"verify circuit: variable {col} corrupted in the odd elements, "
                           f"check_satisfied gives {bad.tolist()}")
    gen_s = replay_s + complete_s
    log(f"[r1cs] verify circuit on the card at B = {B}: run_tape {replay_s:.3f} s, "
        f"complete_witness {complete_s:.3f} s, check_satisfied {eval_s:.3f} s (chunks of "
        f"{R1CS_CHUNK} rows); {B / gen_s:.3f} witnesses/s generated, {rows * B / eval_s:.4g} "
        f"rows/s checked ({smi})")
    for label, (launches, sizes) in (("run_tape", replay), ("complete_witness", complete),
                                     ("check_satisfied", evaluate)):
        log(f"[r1cs] {label} launches: {nonzero(launches)} (total {sum(launches.values())}); "
            f"lc_dot by row width {dict(sorted(sizes['lc_dot'].items()))}")
    log(f"[r1cs] verify circuit: all {B} satisfied; variable {col} corrupted in the {len(odd)} "
        f"odd elements: exactly those rejected; inputs encoded on the host in "
        f"{host_s['inputs']:.3f} s")
    t0 = time.perf_counter()
    with candidate_root_hints():
        cs_dev, _ = build_verify_circuit(triples[0])
    cs_dev.to_arrays()
    rebuild_s = time.perf_counter() - t0
    if cs_dev.tape != cs.tape or cs_dev.num_constraints != cs.num_constraints:
        raise RuntimeError("the build with the device's square roots has another circuit")
    host = EV.encode_witness(cs.assignments)
    moved = (wit[0] != host).any(-1).nonzero().squeeze(1)
    want = EV.encode_witness(cs_dev.assignments)
    if want.shape[0] != n_vars or not torch.equal(wit[0], want):
        diff = (wit[0] != want).any(-1).nonzero().squeeze(1)
        raise RuntimeError(f"verify circuit: element 0 differs from the host build with the "
                           f"device's square roots at {diff.numel()} of {n_vars} variables, "
                           f"first {diff[:8].tolist()}")
    hinted = [v for e in cs.tape if e["kind"] == "sqrt2" for v in e["outs"][1:]]
    flipped = [v for v in hinted if cs.assignments[v] != cs_dev.assignments[v]]
    if moved.numel() and not flipped:
        raise RuntimeError("element 0 differs from the golden-root host build, though no "
                           "square-root hint does")
    log(f"[r1cs] verify circuit: element 0's {n_vars} variables limb-equal to the host build "
        f"of triple 0 that takes the device's square roots (rebuilt with to_arrays in "
        f"{rebuild_s:.3f} s); the host build with golden fp2_sqrt's roots differs at "
        f"{moved.numel()} variables ({len(flipped)} of the {len(hinted)} sqrt2 root "
        f"coordinates negated, and what derives from their sign)")
    fp2_pow = sorted({B * g["idx"].shape[1] for g in ct.groups if g["kind"] == "sqrt2"})
    return {"wit": wit, "ct": ct, "prepared": prepared, "fp2_pow_counts": fp2_pow,
            "runs": {"r1cs_replay": replay, "r1cs_complete": complete, "r1cs_eval": evaluate},
            "stats": {"rows": rows, "vars": n_vars, "constraints": cs.num_constraints,
                      "tape_entries": n_tape, "groups": len(ct.groups), "batch": B,
                      "host_s": host_s, "replay_s": replay_s, "complete_s": complete_s,
                      "eval_s": eval_s}}


def sha_subcircuit(torch, K, smi, rng):
    """The SHA-256 gadget over 24-byte messages at SHA_BATCH: the witness
    from device_witness and the message bit planes, then complete_witness
    and check_satisfied; one element corrupted is the only one rejected;
    element 0 limb-equal to a host build of its message."""
    from bls_verify_gadget_tpu_torch.r1cs import device_witness as DW
    from bls_verify_gadget_tpu_torch.r1cs import evaluator as EV
    from bls_verify_gadget_tpu_torch.r1cs.gadgets import UInt8
    from bls_verify_gadget_tpu_torch.r1cs.sha256 import sha256_gadget
    from bls_verify_gadget_tpu_torch.r1cs.system import ConstraintSystem

    B, L = SHA_BATCH, R1CS_MSG_LEN
    msgs = torch.from_numpy(rng.integers(0, 256, (B, L))).cuda()

    def build(msg):
        cs = ConstraintSystem()
        sha256_gadget(cs, [UInt8.alloc(cs, int(b)) for b in msg])
        return cs

    t0 = time.perf_counter()
    cs = build(msgs[0].tolist())
    build_s = time.perf_counter() - t0
    n_base = len(cs.assignments)
    t0 = time.perf_counter()
    prepared = EV.prepare(cs.to_arrays())
    prepare_s = time.perf_counter() - t0
    rows, n_vars = prepared["a_idx"].shape[0], prepared["num_vars"]

    def witness():
        table = DW.witness_table("cuda")
        bits = ((msgs[:, :, None] >> torch.arange(8, device="cuda")) & 1).reshape(B, -1)
        idx = torch.cat([torch.ones((B, 1), dtype=torch.int64, device="cuda"), bits,
                         DW.sha256_gadget_witness_indices(msgs, L)], 1)
        wit = torch.zeros((B, n_vars, 24), dtype=torch.int32, device="cuda")
        wit[:, :idx.shape[1]] = table[idx]
        return EV.complete_witness(prepared, wit)

    witness()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wit, *gen = counted(torch, K, witness)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    good, *evaluate = counted(torch, K, lambda: EV.check_satisfied(prepared, wit, R1CS_CHUNK))
    eval_s = time.perf_counter() - t0
    if not bool(good.all()):
        raise RuntimeError(f"SHA subcircuit: {int((~good).sum())} of {B} witnesses unsatisfied")
    col = 1 + 8 * L  # the first witness of the SHA segment
    saved = corrupt(torch, wit, col, [0])
    bad = EV.check_satisfied(prepared, wit, R1CS_CHUNK)
    wit[:, col] = saved
    if bad.tolist() != [i != 0 for i in range(B)]:
        raise RuntimeError(f"SHA subcircuit: element 0 corrupted, check_satisfied gives "
                           f"{int((~bad).sum())} false")
    host = EV.encode_witness(cs.assignments)
    if not torch.equal(wit[0], host):
        raise RuntimeError("SHA subcircuit: element 0 differs from the host build")
    log(f"[r1cs] SHA-256 subcircuit ({L}-byte messages): {cs.num_constraints} constraints, "
        f"{rows} rows after to_arrays, {n_vars} variables ({n_vars - n_base} partial sums in "
        f"{len(prepared['levels'])} levels); host s: build {build_s:.3f}, to_arrays + prepare "
        f"{prepare_s:.3f}")
    log(f"[r1cs] SHA subcircuit on the card at B = {B}: witness (device_witness + bit planes "
        f"+ complete_witness) {gen_s:.4f} s = {B / gen_s:.1f} witnesses/s, check_satisfied "
        f"{eval_s:.4f} s = {rows * B / eval_s:.4g} rows/s, end to end "
        f"{rows * B / (gen_s + eval_s):.4g} rows/s ({smi}); all {B} satisfied, element 0 "
        f"corrupted the only one rejected, element 0 limb-equal to its host build")
    for label, (launches, sizes) in (("witness", gen), ("check_satisfied", evaluate)):
        log(f"[r1cs] SHA subcircuit {label} launches: {nonzero(launches)} "
            f"(total {sum(launches.values())}); lc_dot by row width "
            f"{dict(sorted(sizes['lc_dot'].items()))}")
    return {"wit": wit, "prepared": prepared,
            "runs": {"r1cs_sha_gen": gen, "r1cs_sha_eval": evaluate},
            "stats": {"rows": rows, "vars": n_vars, "batch": B, "gen_s": gen_s,
                      "eval_s": eval_s}}


def r1cs_phase(torch, K, smi):
    """The R1CS path (see the module docstring, phase 8).  -> the data, the
    counts of each run and the stats the kernel rows use."""
    import numpy as np

    rng = np.random.default_rng(SEED + 19)
    verify = verify_circuit(torch, K, smi, rng)
    sha = sha_subcircuit(torch, K, smi, rng)
    runs = {**verify["runs"], **sha["runs"]}
    launches = {k: sum(r[0][k] for r in runs.values()) for k in K.KERNELS}
    sizes = merge_sizes(*(r[1] for r in runs.values()))
    idle = [k for k in ("lc_dot", *R1CS_FIELD) if launches[k] == 0]
    if idle:
        raise RuntimeError(f"kernels not launched on the R1CS path: {idle}")
    log(f"[r1cs] launches over the phase's runs: {nonzero(launches)} "
        f"(total {sum(launches.values())})")
    return {"verify": verify, "sha": sha, "runs": runs, "launches": launches, "sizes": sizes,
            "fp2_pow_counts": verify["fp2_pow_counts"]}


def lc_dot_cases(torch, r1cs):
    """(label, (w, idx, coeff), run) for lc_dot at every row width the R1CS
    runs launched it with, on the witnesses and tables of those runs: the
    evaluator's first chunk (W = 8) on each circuit, the partial sums'
    deepest level, and per tape width the widest group's first operand."""
    verify, sha = r1cs["verify"], r1cs["sha"]
    wit, prep = verify["wit"], verify["prepared"]
    cases = [
        ("verify circuit, check_satisfied chunk",
         (wit, prep["a_idx"][:R1CS_CHUNK], prep["a_coeff"][:R1CS_CHUNK]), "r1cs_eval"),
        ("SHA subcircuit, check_satisfied chunk",
         (sha["wit"], sha["prepared"]["c_idx"][:R1CS_CHUNK],
          sha["prepared"]["c_coeff"][:R1CS_CHUNK]), "r1cs_sha_eval"),
    ]
    var, idx, coeff = max(prep["levels"], key=lambda lv: lv[0].numel())
    cases.append(("verify circuit, widest partial-sum level", (wit, idx, coeff), "r1cs_complete"))
    widest = {}
    for g in verify["ct"].groups:
        w = g["idx"].shape[-1]
        if w not in widest or g["idx"].shape[1] > widest[w]["idx"].shape[1]:
            widest[w] = g
    for w, g in sorted(widest.items()):
        cases.append((f"verify tape, {g['kind']} group of {g['idx'].shape[1]} at W = {w}",
                      (wit, g["idx"][0], g["coeff"][0]), "r1cs_replay"))
    return cases


def lc_dot_work(args):
    """(bytes, Montgomery products) of one lc_dot call on this data: per
    output the witness rows of its nonzero terms gathered and one row
    written, the (R, W) coefficient rows and indices read once, one product
    per nonzero term (the kernel skips zero coefficients)."""
    w, idx, coeff = args
    b, (r, width) = w.shape[0], idx.shape
    nnz = int((coeff != 0).any(-1).sum())
    return 96 * (b * nnz + r * width + b * r) + 4 * r * width, b * nnz


def lc_dot_row(torch, K, r1cs, plain_call):
    """lc_dot against its plain version, bit for bit, at every row width
    the R1CS runs launched it with; device time per launch by CUDA-graph
    replay, eager call time, plain time (one call, CUDA events) and bound
    of each case; the row's main case is the evaluator's chunk."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP
    from bls_verify_gadget_tpu_torch.r1cs import evaluator as EV

    kern = lambda *a: K.lc_dot(FP, *a)  # noqa: E731
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = []
    for label, args, run in lc_dot_cases(torch, r1cs):
        width = args[1].shape[1]
        if width not in r1cs["runs"][run][1]["lc_dot"]:
            raise RuntimeError(f"lc_dot ({label}) checked at W = {width}, but the {run} run "
                               f"launched it at {sorted(r1cs['runs'][run][1]['lc_dot'])}")
        got = kern(*args)
        torch.cuda.synchronize()
        start.record()
        ref = plain_call("lc_dot", EV.lc_dot_plain, args)
        end.record()
        torch.cuda.synchronize()
        err = max_err(got, ref)
        if err != 0:
            raise RuntimeError(f"kernel lc_dot ({label}) disagrees with its plain version: "
                               f"max |err| {err}")
        nbytes, nmont = lc_dot_work(args)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nmont * MAD_PER_MONT / INT32_MAD_PER_S * 1e3
        c = {"case": label, "path": run, "width": width, "rows": args[1].shape[0],
             "batch": args[0].shape[0], "max_abs_err": err,
             "ms": device_ms(torch, kern, args, 3, 2), "call_ms": call_ms(torch, kern, args, 3),
             "plain_ms": start.elapsed_time(end), "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "launches": r1cs["runs"][run][1]["lc_dot"][width]}
        out.append(c)
        log(f"[kernel] lc_dot ({label}): bit-equal to plain, B = {c['batch']}, R = {c['rows']}, "
            f"W = {width}; device {c['ms']:.5f} ms, eager call {c['call_ms']:.5f} ms, plain "
            f"{c['plain_ms']:.4f} ms (one call), bound {c['bound_ms']:.5f} ms "
            f"({c['bound_by']}); {c['launches']} launches at this width in the {run} run")
    for run, (_, sizes) in r1cs["runs"].items():
        check_covered("lc_dot", [c["width"] for c in out], run, sizes["lc_dot"])
    by_run = {}
    for c in out:
        for run, (_, sizes) in r1cs["runs"].items():
            if c["width"] in sizes["lc_dot"] and run not in by_run.get(c["width"], {}):
                by_run.setdefault(c["width"], {})[run] = c["ms"] * sizes["lc_dot"][c["width"]]
    device_by_run = collections.Counter()
    for w, per_run in by_run.items():
        device_by_run.update(per_run)
    log(f"[kernel] lc_dot device ms per run, launches x device time of the case at each width "
        f"(an estimate: a width's groups differ in size): "
        f"{ {k: round(v, 3) for k, v in device_by_run.items()} }")
    main = out[0]
    row = {
        "name": "lc_dot", "route": "cuda", "source": R1CS_SRC, "replaces": KERNELS["lc_dot"][0],
        "launches": r1cs["launches"]["lc_dot"], "max_abs_err": max(c["max_abs_err"] for c in out),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "elements": main["batch"] * main["rows"], "width": main["width"],
        "call_ms": main["call_ms"], "cases": out,
    }
    for run, (launches, _) in r1cs["runs"].items():
        row[f"launches_{run}"] = launches["lc_dot"]
    return row


def r1cs_field_checks(torch, K, r1cs, plain_call):
    """The field kernels that the R1CS runs launched (mul, add, sub, fp2_mul,
    fp2_sqr, fp6_mul through fp12_inv, pow_win through every inverse and
    the square roots) against their plain versions, bit for bit, on seeded
    operands with edge values at every element count those runs launched
    them with (pow_win in Fp with e = p - 2 at each, and in Fp2 with e = (p -
    11)/16 at the sqrt2 groups' counts).  -> name -> {"counts": [...],
    "launches": N}."""
    import numpy as np

    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    rng = np.random.default_rng(SEED + 20)
    out = {}
    t0 = time.perf_counter()
    for name in R1CS_FIELD:
        kern, plain = kernel_call(name)
        counts = sorted(r1cs["sizes"][name])
        for n in counts:
            if name == "fp6_mul":
                calls = [pairing_inputs(torch, rng, name, n)]
            elif name == "pow_win":
                a = field_inputs(torch, rng, "fp2_mul", n)
                calls = [(a[0][None], FP.modulus - 2)]
                if n in r1cs["fp2_pow_counts"]:
                    calls.append((torch.stack(a[:2]), H.SQRT_K))
            else:
                calls = [field_inputs(torch, rng, name, n)]
            for args in calls:
                err = max_err(kern(*args), plain_call(name, plain, args))
                if err != 0:
                    raise RuntimeError(f"kernel {name} disagrees with its plain version at {n} "
                                       f"elements (R1CS path): max |err| {err}")
        for run, (_, sizes) in r1cs["runs"].items():
            check_covered(name, counts, run, sizes[name])
        out[name] = {"counts": counts, "launches": r1cs["launches"][name]}
    log(f"[kernel] R1CS path: {', '.join(f'{k} at {len(v['counts'])} element counts' for k, v in out.items())} "
        f"bit-equal to plain (every count its runs launched; COUNTS unchanged by plain) in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


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


def pairing_inputs(torch, rng, name, n, count=None, k=2):
    """Seeded operands for one pairing kernel at n elements: packed
    (c, n, 24) canonical values, each coordinate with the edge values in
    its first elements (rolled per coordinate), and a mixed valid mask of
    the Miller kernels' k pairs.
    The kernels and their plain versions compute the same formulas, so
    random values (off the curve, outside the cyclotomic subgroup) compare
    bit for bit."""
    import math

    from bls_verify_gadget_tpu_torch.ops import curve as CV
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

    valid = torch.from_numpy(rng.random((k, n)) < 0.75).cuda()
    neutral = PR.neutral_line(n, "cuda")
    return {
        "fp6_mul": lambda: (fp(6), fp(6)),
        "fp12_mul": lambda: (fp(12), fp(12)),
        "fp12_sqr": lambda: (fp(12),),
        "miller_dbl_run": lambda: (fp(12), fp(k, 6), fp(k), fp(k), valid, count),
        "miller_add": lambda: (fp(12), fp(k, 6), fp(k, 4), fp(k), fp(k), valid),
        "exp_x": lambda: (fp(12), CV.X_SEGMENTS),
        "mul014": lambda: (fp(12), torch.where(valid[0][:, None], fp(6), neutral)),
        "dbl_step": lambda: (fp(6), fp(2)),
        "add_step": lambda: (fp(6), fp(4), fp(2)),
        "cyclo_sqr": lambda: (fp(12), count),
    }[name]()


def kernel_call(name):
    """(kernel wrapper, plain version) of `name`, both on the same operands."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.ops import pairing as PR
    from bls_verify_gadget_tpu_torch.ops import tower as T
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    plain = {
        "mul": FP.mul_plain, "add": FP.add_plain, "sub": FP.sub_plain,
        "fp2_mul": T.fp2_mul_plain, "fp2_sqr": T.fp2_sqr_plain,
        "fp6_mul": T.fp6_mul_packed_plain,
        "fp12_mul": T.fp12_mul_plain, "fp12_sqr": T.fp12_sqr_plain,
        "miller_dbl_run": PR.miller_dbl_run_plain, "miller_add": PR.miller_add_plain,
        "exp_x": PR.exp_x_plain, "pow_win": T.pow_win_plain,
        "pt_mul_const": CV.pt_mul_const_plain, "g2_cofactor": CV.g2_cofactor_plain,
        "sswu_map2": H.sswu_map2_plain, "pt_dbl": CV.pt_dbl_plain,
        "pt_add": CV.pt_add_plain, "pt_mul_var": CV.pt_mul_var_plain,
        "mul014": PR.mul014_plain, "dbl_step": PR.dbl_step_plain,
        "add_step": PR.add_step_plain, "cyclo_sqr": T.cyclo_sqr_plain, "xmd": H.xmd_plain,
    }[name]
    if name == "xmd":  # no field argument
        return K.xmd, plain
    return (lambda *a: getattr(K, name)(FP, *a)), plain


def work(name, n, args):
    """(bytes moved, Montgomery products) of one call at n elements: each
    Fp coordinate in or out is 96 bytes, a valid mask 4 bytes per pair.
    The Miller kernels' products count what this call's masks need: T's
    update for every pair, the line and f * line only for valid pairs."""
    if name in HASH_WORK:
        return HASH_WORK[name](n, *args)
    k = args[1].shape[0] if name.startswith("miller") else 0
    fp_io = {
        "mul": 3, "add": 3, "sub": 3, "fp2_mul": 6, "fp2_sqr": 4, "fp6_mul": 18, "fp12_mul": 36,
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
                "fp6_mul": 18, "fp12_mul": 54, "fp12_sqr": 36}[name]
    return nbytes, n * mont


def _pow_products(c, exponent):
    """Montgomery products of pow_win per element (csrc/hash_kernels.cu):
    14 table products, then per window after the first 4 squarings and a
    product where its digit is not 0; an Fp2 product is 3, a square 2."""
    from bls_verify_gadget_tpu_torch.ops import kernels as K

    d = K.pow_digits(exponent)
    nonzero = sum(1 for x in d[1:] if x)
    sqr, mul = (1, 1) if c == 1 else (2, 3)
    return 14 * mul + 4 * (len(d) - 1) * sqr + nonzero * mul


def _ladder_products(c, segments):
    """Montgomery products of one constant-scalar ladder per element (the
    programs of ops/group_rounds.py): a doubling is 7 (G1) or 17 (G2), a
    complete addition 16 or 44.  The addition's doubling case (acc == P,
    finite) needs a doubling more; it arises only where a prefix of the
    scalar is 1 modulo the point's order (the [group] phase's order-11 G1
    point, ladder_edge_points), never for the main path's points, whose
    order is r or a multiple of it, and the bound does not count it."""
    dbl, add = (7, 16) if c == 1 else (17, 44)
    return sum(s for s, _ in segments) * dbl + sum(1 for _, b in segments if b) * add


def _finite(p, c):
    """Points of a packed (3c, N, 24) operand not at infinity (Z != 0).  The
    function needs no products for the infinity, so the bound counts only
    these; the kernels have no early exit and still run the whole ladder on
    an infinity, which is part of their gap to the bound."""
    return int((p[2 * c:] != 0).any(-1).any(0).sum())


def _sswu_products():
    """Montgomery products that sswu_map2 needs per element, counted from
    the function (the formulas of hash_to_g2.py's sswu_map2_plain), not from
    a kernel: per map 112 around the sqrt chain plus the chain, and 67 for
    affine, sgn0 and the isogeny; then 8 + 3 for the four norms, the Fermat
    inverse, 6 for Montgomery's trick and 44 for q0 + q1.  Each chain
    (_pow_products) runs 4-bit windows with no product for a digit of 0, and
    the chains' table products are counted once each; the sqrt candidates'
    products (at most 3 per check, where sqrt(+-u) passes) are not counted:
    3,032 in all."""
    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    chain = _pow_products(2, H.SQRT_K)
    return 2 * (112 + chain + 67) + 8 + 3 + _pow_products(1, FP.modulus - 2) + 6 + 44


# (bytes, Montgomery products) of one hash-stage kernel call at n elements
HASH_WORK = {
    "pow_win": lambda n, a, e: (n * 2 * a.shape[0] * 96, n * _pow_products(a.shape[0], e)),
    "pt_mul_const": lambda n, p, segs: (
        n * 2 * p.shape[0] * 96,
        _finite(p, p.shape[0] // 3) * _ladder_products(p.shape[0] // 3, segs)),
    "g2_cofactor": lambda n, p, segs: (
        n * 12 * 96, _finite(p, 2) * (2 * _ladder_products(2, segs) + 17 + 6 + 2 + 5 * 44)),
    # u in, the point out, and the 46-row constant table read once
    "sswu_map2": lambda n, u: (n * 10 * 96 + 46 * 96, n * _sswu_products()),
}


def _ladder_var_products(c, p, scalars):
    """Montgomery products that [s]P needs per element by double-and-add
    from s's top bit: (bit length - 1) doublings and (set bits - 1)
    additions, for finite P and s > 0 (this call's scalars; the kernel runs
    all nbits doublings and an addition for every bit that is set in some
    element of its warp).  A G1 doubling is 7 products (ops/group_rounds.py
    pt_dbl_rounds), the group kernel's."""
    import numpy as np

    dbl, add = (7, 16) if c == 1 else (17, 44)
    finite = (p[2 * c:] != 0).any(-1).any(0).cpu().numpy()
    limbs = scalars.cpu().numpy().astype(np.int64)
    total = 0
    for row, fin in zip(limbs, finite):
        s = sum(int(v) << (16 * j) for j, v in enumerate(row))
        if s and fin:
            total += (s.bit_length() - 1) * dbl + (bin(s).count("1") - 1) * add
    return total


def _both_finite(p, q, c):
    return int(((p[2 * c:] != 0).any(-1).any(0) & (q[2 * c:] != 0).any(-1).any(0)).sum())


def _doublings(p, q, c):
    """Elements of a pt_add call with P == Q, both finite: the doubling
    case, which needs a doubling's products besides the addition's."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    ops = CV.FP_OPS if c == 1 else CV.FP2_OPS
    eq = CV.pt_eq(ops, CV.unpack_point(ops, p), CV.unpack_point(ops, q))
    return int((eq & (p[2 * c:] != 0).any(-1).any(0)).sum())


def _lines(line):
    """Elements of a mul014 line other than the neutral (1, 0, 0): f times
    the neutral line is f, which needs no product."""
    from bls_verify_gadget_tpu_torch.ops import pairing as PR

    return int((line != PR.neutral_line(line.shape[1], line.device)).any(-1).any(0).sum())


# (bytes, Montgomery products) of one point or step kernel call at n
# elements (step kernels: the line product 45, the doubling step 25
# (group_rounds.py dbl_step_program), the addition step 41 (ops/pairing.py
# _add_step), the Granger-Scott square 18; a G1 doubling 7, as
# group_rounds.py pt_dbl_rounds computes it, a G2 doubling 17)
HASH_WORK.update({
    "mul014": lambda n, f, line: (n * 30 * 96, _lines(line) * 45),
    "dbl_step": lambda n, t, p: (n * 20 * 96, n * 25),
    "add_step": lambda n, t, q, p: (n * 24 * 96, n * 41),
    "cyclo_sqr": lambda n, f, count: (n * 24 * 96, n * 18 * count),
    "pt_dbl": lambda n, p, count: (
        n * 2 * p.shape[0] * 96,
        _finite(p, p.shape[0] // 3) * count * (7 if p.shape[0] == 3 else 17)),
    "pt_add": lambda n, p, q: (
        n * 3 * p.shape[0] * 96,
        _both_finite(p, q, p.shape[0] // 3) * (16 if p.shape[0] == 3 else 44)
        + _doublings(p, q, p.shape[0] // 3) * (7 if p.shape[0] == 3 else 17)),
    "pt_mul_var": lambda n, p, s, nbits: (
        n * (2 * p.shape[0] * 96 + 4 * s.shape[1]),
        _ladder_var_products(p.shape[0] // 3, p, s)),
})


def off_subgroup_points():
    """The first on-curve G1 point (x, y) and G2 point ((x0, 1), y) over
    small x: outside the prime-order subgroup, as
    tests/test_torch_curve_hash_pairing.py checks against the golden
    oracle for these same points."""
    from bls_verify_gadget_tpu_torch import constants as C
    from bls_verify_gadget_tpu_torch.golden import field as GF

    g1 = next((x, y) for x in range(1, 100)
              if (y := GF.fp_sqrt((x**3 + 4) % C.P)) is not None)
    g2 = next((x, y) for x in ((x0, 1) for x0 in range(1, 100))
              if (y := GF.fp2_sqrt(GF.fp2_add(GF.fp2_mul(GF.fp2_sqr(x), x), C.B_G2)))
              is not None)
    return g1, g2


def hash_cases(torch, rng, ctx):
    """name -> [(label, args, launches per verify, "verify")] for the hash-stage and
    subgroup kernels, on the main path's own data: pow_win on seeded Fp
    values with edge values (e = p - 2, as FP.inv) and Fp2 values (e =
    (p - 11)/16, the SSWU sqrt chain); pt_mul_const by |x| on the batch's
    public keys (G1, with its identity probes) and signatures (G2), an
    off-subgroup point in the first element of each; sswu_map2 on
    hash_to_field's outputs for the batch's messages with u0 = u1 = 0 in
    element 0 and u1 = 0 in element 1; g2_cofactor on sswu_map2's outputs
    (points outside the subgroup)."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    pk, sig, msg = ctx["pk"], ctx["sig"], ctx["msg"]
    n = pk[0].shape[0]
    off1, off2 = off_subgroup_points()
    g1 = CV.pack_point(CV.FP_OPS, CV.pt_from_affine(CV.FP_OPS, *pk)).clone()
    g1[:, :1] = CV.pack_point(CV.FP_OPS, CV.g1_encode_batch([off1], "cuda"))
    g2 = CV.pack_point(CV.FP2_OPS, CV.pt_from_affine(CV.FP2_OPS, *sig)).clone()
    g2[:, :1] = CV.pack_point(CV.FP2_OPS, CV.g2_encode_batch([off2], "cuda"))
    a1 = field_inputs(torch, rng, "add", n)[0][None]
    a2 = torch.stack(field_inputs(torch, rng, "fp2_mul", n)[:2])
    u0, u1 = H.hash_to_field_fp2(msg, MSG_LEN)
    u = torch.stack([*u0, *u1])
    u[:, 0] = 0
    u[2:, 1] = 0
    q = K.sswu_map2(FP, u)
    return {
        "pow_win": [("Fp, e = p - 2", (a1, FP.modulus - 2), 2, "verify"),
                    ("Fp2, e = (p - 11)/16", (a2, H.SQRT_K), 0, "verify")],
        "pt_mul_const": [("G1 by |x|", (g1, CV.X_SEGMENTS), 2, "verify"),
                         ("G2 by |x|", (g2, CV.X_SEGMENTS), 1, "verify")],
        "sswu_map2": [("hash_to_field outputs", (u,), 1, "verify")],
        "g2_cofactor": [("sswu_map2 outputs", (q, CV.X_SEGMENTS), 1, "verify")],
    }


def keys_hash_cases(torch, keys):
    """name -> [(label, args, launches per keys run, "keys")] for the
    hash-stage and subgroup kernels at the element counts that only the
    keys path gives them, on its own data: aggregate_verify_distinct's 4095
    pairs (the pubkeys' Z and the hashes' norms inverted in pt_to_affine,
    the pubkeys' subgroup check, the messages' hash) and its one aggregate
    signature (the norm of its Z inverted, as also fp12_inv's one element
    in the final exponentiation; its subgroup check)."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
    from bls_verify_gadget_tpu_torch.ops import kernels as K
    from bls_verify_gadget_tpu_torch.ops import tower as T
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    n = keys["pair_msg"].shape[0]
    z0, z1 = keys["asig"][2]
    norm = FP.add(*T._mul_many([(z0, z0), (z1, z1)]))
    pk = CV.pack_point(CV.FP_OPS, CV.pt_from_affine(CV.FP_OPS, *keys["pk_aff"]))
    sig = CV.pack_point(CV.FP2_OPS, CV.pt_from_affine(CV.FP2_OPS, *keys["sig_aff"]))
    u0, u1 = H.hash_to_field_fp2(keys["pair_msg"], MSG_LEN)
    u = torch.stack([*u0, *u1])
    return {
        "pow_win": [(f"keys: Fp, e = p - 2, Z of the {n} valid pubkeys",
                     (keys["pk_valid"][2][None], FP.modulus - 2), 2, "keys"),
                    ("keys: Fp, e = p - 2, the aggregate signature's Z norm",
                     (norm[None], FP.modulus - 2), 2, "keys")],
        "pt_mul_const": [(f"keys: G1 by |x| on the {n} valid pubkeys", (pk, CV.X_SEGMENTS), 2,
                          "keys"),
                         ("keys: G2 by |x| on the aggregate signature", (sig, CV.X_SEGMENTS),
                          1, "keys")],
        "sswu_map2": [(f"keys: hash_to_field outputs of the {n} messages", (u,), 1, "keys")],
        "g2_cofactor": [(f"keys: sswu_map2 outputs of the {n} messages",
                         (K.sswu_map2(FP, u), CV.X_SEGMENTS), 1, "keys")],
    }


def xmd_cases(torch, ctx, keys, mixed):
    """[(label, args, launches per run, path)] of xmd: each path's messages
    as it passed them (the verify batch; sign's 4096 and
    aggregate_verify_distinct's 4095 in the keys run; the mixed batch with
    its lengths, sign's and verify's launch), then the RFC 9380 K.1
    messages with their DST and 0x20 bytes out, and the mixed batch with a
    255-byte DST and 77 bytes out (the widest table, 5 blocks per b_i,
    stores byte by byte)."""
    from bls_verify_gadget_tpu_torch import constants as C
    from bls_verify_gadget_tpu_torch.models.bls import encode_messages_var

    rfc, rlens, _ = encode_messages_var([m for m, _ in RFC_XMD])
    out = 4 * C.L_FIELD  # hash_to_field's two Fp2 elements
    return [
        ("verify: the main path's messages", (ctx["msg"], None, C.DST_G2, out), 1, "verify"),
        ("keys: sign's messages", (keys["msg"], None, C.DST_G2, out), 1, "keys"),
        ("keys: aggregate_verify_distinct's messages", (keys["pair_msg"], None, C.DST_G2, out),
         1, "keys"),
        ("mixed: sign's and verify's messages", (mixed["msg"], mixed["lens"], C.DST_G2, out), 2,
         "mixed"),
        ("RFC 9380 K.1, 0x20 bytes", (rfc, rlens, RFC_DST, 0x20), 0, "mixed"),
        ("mixed batch, 255-byte DST, 77 bytes", (mixed["msg"], mixed["lens"],
                                                 bytes(range(1, 256)), 77), 0, "mixed"),
    ]


def xmd_host_checks(torch, K, cases):
    """Every element of every xmd case equal to a hashlib XMD on the host;
    the RFC case also equal to the vectors' bytes."""
    for label, (msg, lens, dst, nbytes), _, _ in cases:
        got = K.xmd(msg, lens, dst, nbytes).cpu().numpy()
        rows = msg.cpu().numpy()
        n = [rows.shape[1]] * len(rows) if lens is None else lens.tolist()
        bad = [i for i, (r, m, g) in enumerate(zip(rows, n, got))
               if bytes(g) != host_xmd(bytes(r[:m]), dst, nbytes)]
        if bad:
            raise RuntimeError(f"xmd ({label}) differs from hashlib's XMD at elements {bad[:8]}")
        if dst == RFC_DST and [bytes(g).hex() for g in got] != [h for _, h in RFC_XMD]:
            raise RuntimeError("xmd differs from the RFC 9380 K.1 vectors")
    log(f"[kernel] xmd equal to hashlib's XMD on every element of its {len(cases)} cases "
        f"({sum(c[1][0].shape[0] for c in cases)} messages), and to the RFC 9380 K.1 vectors")


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


def _iadd3(var, folded):
    """IADD3s that sum `var` terms that differ between elements and, if
    `folded`, one term that does not (the sum of the shared ones)."""
    return (var + folded) // 2 if var else 0


def sha_compression_ops(state, words):
    """32-bit integer instructions of one SHA-256 compression that depend on
    the element, for a state and a block given as 8 and 16 flags (1: the
    word differs between elements; 0: it is the same for all, so what it
    alone decides is computed once and not counted) -> (instructions, the
    state's flags after it).  Every flag 1: OPS_PER_COMPRESSION; a shared
    block on a varying state: 64 * 14 + 8 (its schedule is shared)."""
    (a, b, c, d, e, f, g, h), w = state, list(words)
    ops = 0
    for t in range(64):
        if t >= 16:  # W_t = sigma1(W_t-2) + W_t-7 + sigma0(W_t-15) + W_t-16
            w15, w2, w7, w16 = w[(t - 15) % 16], w[(t - 2) % 16], w[(t - 7) % 16], w[t % 16]
            var = w15 + w2 + w7 + w16
            ops += 4 * (w15 + w2) + _iadd3(var, int(var < 4))
            w[t % 16] = int(var > 0)
        efg, abc = e | f | g, a | b | c
        v1 = h + e + efg + w[t % 16]  # T1 = h + Sigma1(e) + ch + K_t + W_t
        t1 = int(v1 > 0)
        # e' = d + T1 (a shared d folds into T1's shared term), a' = T1 + Sigma0(a) + maj
        ops += 4 * e + efg + 4 * a + abc + _iadd3(v1, 1) + (d & t1) + _iadd3(t1 + abc, 0)
        a, b, c, d, e, f, g, h = t1 | abc, a, b, c, d | t1, e, f, g
    out = [x | y for x, y in zip(state, (a, b, c, d, e, f, g, h))]
    return ops + sum(out), out


def xmd_b0_flags(m, tlen):
    """The word flags of b0's blocks past Z_pad at length m and a tail of
    tlen bytes: a word differs between elements iff it holds a message
    byte."""
    return [[int((blk - 1) * 64 + 4 * i < m) for i in range(16)]
            for blk in range(1, (64 + m + tlen + 8) // 64 + 1)]


def xmd_element_ops(m, tlen, nbi, ell):
    """32-bit integer instructions of one element's XMD at length m (tail
    tlen bytes, nbi blocks per b_i, ell b_i) that depend on its message:
    b0 from Z_pad's midstate, a word of msg' shared unless it holds a
    message byte (past the message, msg' depends on m, the DST and
    len_in_bytes alone); each b_i's block of b0 ^ b_i-1 (XOR for i > 1)
    and counter i and DST', then its shared blocks."""
    state, ops = [0] * 8, 0
    for words in xmd_b0_flags(m, tlen):
        n, state = sha_compression_ops(state, words)
        ops += n
    b0, prev = state, [0] * 8
    for i in range(1, ell + 1):
        x = [p | q for p, q in zip(b0, prev)]
        ops += sum(x) if i > 1 else 0
        prev = [0] * 8
        for blk in range(nbi):
            n, prev = sha_compression_ops(prev, x + [0] * 8 if blk == 0 else [0] * 16)
            ops += n
    return ops


def xmd_work(msg, lens, dst, len_in_bytes):
    """(bytes moved, 32-bit integer operations) of one xmd call: each
    element's live message bytes and its length read once, its output
    written once, the table read once; xmd_element_ops per element at this
    call's lengths.  What is shared by the elements of one length (msg'
    past the message and b0 if m = 0, each b_i's blocks past its first) is
    counted in no element, and its one-off work per length is left out: a
    lower bound."""
    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H

    n, width = msg.shape
    given = lens is not None
    lens = lens.tolist() if given else [width] * n
    dlen = len(dst) + 1
    tlen, nbi = 3 + dlen, (33 + dlen + 8) // 64 + 1
    ell = -(-len_in_bytes // 32)
    ops = sum(k * xmd_element_ops(m, tlen, nbi, ell)
              for m, k in collections.Counter(lens).items())
    table = 4 * (H.XMD_EXT_WORDS + H.XMD_TMPL_WORDS)
    nbytes = sum(lens) + 4 * n * given + n * len_in_bytes + table
    return nbytes, ops


def elements(name, args):
    """Batch elements of a kernel call: xmd's messages are (N, L) rows,
    every other kernel's operands (c, N, 24)."""
    return args[0].shape[0] if name == "xmd" else args[0].shape[1]


def bound(name, n, args):
    """(bound ms, "bytes" or "operations") of one call at n elements."""
    if name == "xmd":
        nbytes, ops = xmd_work(*args)
    else:
        nbytes, nmont = work(name, n, args)
        ops = nmont * MAD_PER_MONT
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_MAD_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else "operations"


def max_err(got, ref):
    got, ref = flat_outputs(got), flat_outputs(ref)
    if len(got) != len(ref):
        raise RuntimeError(f"{len(got)} outputs, plain {len(ref)}")
    return max(int((g.long() - r.long()).abs().max()) for g, r in zip(got, ref))


def check_covered(name, checked, path, sizes):
    """Fail unless every element count that `path` launched kernel `name`
    with is among the counts `checked` against its plain version."""
    missing = sorted(set(sizes) - set(checked))
    if missing:
        raise RuntimeError(f"kernel {name} launched on the {path} path at {missing} elements, "
                           f"which no case compares with its plain version")


def case_kernel_row(torch, name, replaces, source, cases, launches, sizes, plain_call,
                    main_path):
    """One hash-stage, subgroup or point kernel against its plain version on
    each case (label, args, launches, path) of hash_cases, keys_hash_cases
    or point_cases; a case that stands for launches on its path must have
    an element count that path launched it with, and every count that a
    path launched it with must have a case.  The plain version is slow on
    the card, so it runs once per case, timed with CUDA events; device time
    per launch from CUDA-graph replay, eager call time, bound.  `launches`
    and `sizes` map each path to COUNTS' launches and sizes of its run.
    -> (row, device ms per verify run)."""
    kern, plain = kernel_call(name)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out, kernel_ms = [], 0.0
    for label, args, weight, path in cases:
        n = elements(name, args)
        if weight and n not in sizes[path][name]:
            raise RuntimeError(f"kernel {name} ({label}) checked at {n} elements, but the "
                               f"{path} path launched it at {sorted(sizes[path][name])}")
        got = kern(*args)
        torch.cuda.synchronize()
        start.record()
        ref = plain_call(name, plain, args)
        end.record()
        torch.cuda.synchronize()
        err = max_err(got, ref)
        if err != 0:
            raise RuntimeError(f"kernel {name} ({label}) disagrees with its plain version: "
                               f"max |err| {err}")
        if name == "xmd":  # its wrapper reads the lengths on the host: no graph captures it
            from bls_verify_gadget_tpu_torch.ops import kernels as K

            ms = device_ms(torch, entry_launch(torch, K, name, K.library().bls_xmd, args)[0], ())
        else:
            ms = device_ms(torch, kern, args, 3, 2)
        bound_ms, bound_by = bound(name, n, args)
        if path == "verify":
            kernel_ms += ms * weight
        out.append({"case": label, "path": path, "elements": n, "max_abs_err": err, "ms": ms,
                    "call_ms": call_ms(torch, kern, args, 3),
                    "plain_ms": start.elapsed_time(end), "bound_ms": bound_ms,
                    "bound_by": bound_by, "launches": weight})
        c = out[-1]
        log(f"[kernel] {name} ({label}): bit-equal to plain at {n} elements, COUNTS "
            f"unchanged by plain; device {ms:.5f} ms, eager call {c['call_ms']:.5f} ms, "
            f"plain {c['plain_ms']:.4f} ms (one call), bound {bound_ms:.5f} ms ({bound_by}); "
            f"{weight} launches per {path} run")
    for path in sizes:
        check_covered(name, [c["elements"] for c in out], path, sizes[path][name])
    main = out[0]
    row = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[main_path][name], "max_abs_err": max(c["max_abs_err"] for c in out),
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "elements": main["elements"], "call_ms": main["call_ms"],
        "cases": out,
    }
    for path in launches:
        if path != main_path:
            row[f"launches_{path}"] = launches[path][name]
    return row, kernel_ms


def recorded_calls(torch, K, name, fn):
    """The arguments (cloned) of every call of the wrapper K.<name> while
    fn runs; the wrapper launches and counts as it always does."""
    calls, wrapper = [], getattr(K, name)

    def recording(field, *args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a for a in args))
        return wrapper(field, *args)

    setattr(K, name, recording)
    try:
        fn()
    finally:
        setattr(K, name, wrapper)
    return calls


def pt_add_branches(torch, rng, ops, pts, half):
    """Packed P, Q of `half` elements that meet every branch of the complete
    addition, by element index mod 6: Q = -P and Q = P, each in another
    Jacobian representative (l^2 X, l^3 Y, l Z for a seeded l); Q at
    infinity; P at infinity; both at infinity; P + Q of two other points.
    P is the first half of `pts`, the other points its second half."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    p, other = take(pts, slice(0, half)), take(pts, slice(half, 2 * half))
    top = FP.modulus >> (16 * 23)
    coords = 1 if ops is CV.FP_OPS else 2
    lam = [rand_limbs(torch, rng, half, top) for _ in range(coords)]
    lam = lam[0] if coords == 1 else tuple(lam)
    (lam2,) = ops.mul_pairs([(lam, lam)])
    (lam3,) = ops.mul_pairs([(lam2, lam)])
    scaled = tuple(ops.mul_pairs([(p[0], lam2), (p[1], lam3), (p[2], lam)]))
    which = torch.arange(half, device="cuda") % 6
    inf = CV.pt_infinity_like(ops, p)
    q = CV.pt_cmov(ops, which == 0, CV.pt_neg(ops, scaled), other)
    q = CV.pt_cmov(ops, which == 1, scaled, q)
    q = CV.pt_cmov(ops, (which == 2) | (which == 4), inf, q)
    p = CV.pt_cmov(ops, (which == 3) | (which == 4), inf, p)
    return CV.pack_point(ops, p), CV.pack_point(ops, q)


def point_cases(torch, rng, K, keys):
    """name -> [(label, args, launches per keys run, "keys")] for the point
    kernels on the keys phase's data: pt_mul_var by the 4096 keys on the G1
    generator (derive_pubkeys) and on H(m) (sign); pt_add on the operands
    of every level of the three aggregation trees, recorded as the keys
    path passes them, then on P, Q meeting each branch (pt_add_branches,
    G1 and G2); pt_dbl on the pubkeys once and 63 times."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    bls = keys["bls"]
    g1 = CV.pack_point(CV.FP_OPS, keys["pk"])
    sk = keys["sk"]
    trees = [
        ("G1 pubkey tree", BATCH, lambda: bls.aggregate_pubkeys(keys["pk"])),
        ("G2 signature tree", BATCH, lambda: bls.aggregate_signatures(keys["sig"])),
        ("G1 masked committee tree", COMMITTEE,
         lambda: bls.aggregate_pubkeys_masked(keys["committee_pk"], keys["bitmap"])),
    ]
    add = []
    for label, n, fn in trees:
        calls = recorded_calls(torch, K, "pt_add", fn)
        if len(calls) != tree_levels(n):
            raise RuntimeError(f"{label}: {len(calls)} pt_add calls, expected {tree_levels(n)}")
        add += [(f"{label} level {i + 1}", args, 1, "keys") for i, args in enumerate(calls)]
    half = BATCH // 2
    add += [("G1 branches", pt_add_branches(torch, rng, CV.FP_OPS, keys["pk"], half), 0, "keys"),
            ("G2 branches", pt_add_branches(torch, rng, CV.FP2_OPS, keys["sig"], half), 0,
             "keys")]
    return {
        "pt_mul_var": [
            ("G1, derive_pubkeys", (CV.pack_point(CV.FP_OPS, keys["gen"]), sk, 255), 1, "keys"),
            ("G2, sign", (CV.pack_point(CV.FP2_OPS, keys["h"]), sk, 255), 1, "keys")],
        "pt_add": add,
        "pt_dbl": [("G1 pubkeys, count 1", (g1, 1), 1, "keys"),
                   ("G1 pubkeys, count 63", (g1, 63), 0, "keys")],
    }


def step_cases(torch, rng, steps):
    """name -> [(label, args, launches per run, path)] for the step-wise
    kernels: the operands of the last call per element count (cyclo_sqr:
    and run length) of the steps phase's recorded warm-up runs, as the
    path passed them (verify's two pairs stacked at 8192, one pair at 4096
    in aggregate_verify_distinct, cyclo_sqr on genuine cyclotomic elements
    at 4096 and 1), verify's first (cyclo_sqr: its run of 32); then
    mul014 on a seeded random f and lines, a quarter of them neutral, and
    cyclo_sqr on seeded random Fp12 (the Granger-Scott formula, not a
    square) at every run length at 4096 and at 1."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    cases = {name: [] for name in STEP_KERNELS}
    for path, label in (("steps", "verify"), ("steps_avd", "aggregate_verify_distinct")):
        for key in sorted(steps["kept"][path], key=lambda k: (-k[1], -(k[2] or 0))):
            name, n, count = key
            at = f"{label}, last call at {n}" + (f", run of {count}" if count else "")
            cases[name].append((at, steps["kept"][path][key], steps["calls"][path][key], path))
    cases["mul014"].append(("random f and lines, 1/4 neutral",
                            pairing_inputs(torch, rng, "mul014", BATCH), 0, "steps"))
    for n in (BATCH, 1):
        for count, _ in CV.X_SEGMENTS:
            cases["cyclo_sqr"].append((f"random Fp12 at {n}, run of {count}",
                                       pairing_inputs(torch, rng, "cyclo_sqr", n, count), 0,
                                       "steps"))
    return cases


def miller_k1_cases(torch, rng, name, kern, plain_call, plain, keys, longest):
    """The Miller kernel with one pair (aggregate_verify_distinct's) at every
    element count the keys path launched it with, and miller_dbl_run at
    every run length of |x|: bit-equal to the plain version.  Device time,
    the plain call (timed with CUDA events, one call) and the bound at the
    largest count (miller_dbl_run: its longest run)."""
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    hist = keys["sizes"][name]
    runs = [c for c, _ in CV.X_SEGMENTS] if name == "miller_dbl_run" else [None]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    worst, main, n_main = 0, None, max(hist)
    for n in sorted(hist):
        for count in runs:
            args = pairing_inputs(torch, rng, name, n, count, k=1)
            got = kern(*args)
            is_main = n == n_main and count in (None, longest)
            start.record()
            ref = plain_call(name, plain, args)
            end.record()
            torch.cuda.synchronize()
            worst = max(worst, max_err(got, ref))
            if is_main:
                main = (n, count, args, start.elapsed_time(end))
    if worst != 0:
        raise RuntimeError(f"kernel {name} (k = 1) disagrees with its plain version: "
                           f"max |err| {worst}")
    n, count, args, plain_ms = main
    ms = device_ms(torch, kern, args, 3, 2)
    bound_ms, bound_by = bound(name, n, args)
    checked = f"sizes {sorted(hist)}" + (f" x run lengths {runs}" if count else "")
    log(f"[kernel] {name} (k = 1): bit-equal to plain at {len(hist) * len(runs)} keys-path "
        f"calls ({checked}); at {n} elements" + (f", run of {count}" if count else "")
        + f": device {ms:.5f} ms, plain {plain_ms:.4f} ms (one call), bound {bound_ms:.5f} "
        f"ms ({bound_by}); {keys['launches'][name]} launches per keys run")
    return {"pairs": 1, "elements": n, "count": count, "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "launches": keys["launches"][name], "sizes": sorted(hist)}


def kernel_phase(torch, K, launches, sizes, verify_s, ctx, keys, steps, mixed, r1cs):
    """Each kernel against its plain version on the same CUDA tensors, bit
    for bit, with COUNTS unchanged across every plain call, at every
    element count that the verify run or the keys run launched it with:
    the field and pairing kernels on seeded values (miller_dbl_run at each
    run length; the Miller kernels with two pairs at verify's counts and
    with one pair at the keys run's); the hash-stage and subgroup kernels
    on hash_cases and keys_hash_cases, the point kernels on point_cases,
    the step-wise kernels on step_cases, xmd on xmd_cases (and against a
    hashlib XMD), and every kernel at
    every count that the mixed and steps phases' runs launched it with.
    Device time per launch (CUDA-graph replay), eager call time and plain
    time (field kernels: a mean of 3 calls; the others: their compared
    call, CUDA events) at the main path's most frequent size (miller_dbl_run: its longest
    run; pow_win: Fp; pt_mul_const, pt_mul_var, pt_add, pt_dbl: G1), and
    the bound of that call.  "launches" counts the path the kernel serves
    (verify; keys for the point kernels; steps, the step-wise verify, for
    the step-wise kernels; the r1cs runs for lc_dot, lc_dot_row); the
    other paths' counts ride beside it, and the field kernels, fp6_mul and
    pow_win are also held to their plain versions at every element count
    the r1cs runs launched them with (r1cs_field_checks)."""
    import numpy as np

    from bls_verify_gadget_tpu_torch.ops import curve as CV

    def plain_call(name, plain, args):
        before = dict(K.COUNTS.launches)
        out = plain(*args)
        if K.COUNTS.launches != before:
            raise RuntimeError(f"the plain version of {name} launched kernels")
        return out

    rng = np.random.default_rng(SEED)
    longest = max(c for c, _ in CV.X_SEGMENTS)
    rows, kernel_ms = [], 0.0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    by_path = {"launches": {"verify": launches, "keys": keys["launches"],
                            "mixed": mixed["launches"], **steps["launches"]},
               "sizes": {"verify": sizes, "keys": keys["sizes"], "mixed": mixed["sizes"],
                         **steps["sizes"]}}
    hcases, kcases = hash_cases(torch, rng, ctx), keys_hash_cases(torch, keys)
    pcases, scases = point_cases(torch, rng, K, keys), step_cases(torch, rng, steps)
    step_ms = {}
    for name, (replaces, source, _) in KERNELS.items():
        if source == R1CS_SRC:
            rows.append(lc_dot_row(torch, K, r1cs, plain_call))
            continue
        if source == XMD_SRC:
            xcases = xmd_cases(torch, ctx, keys, mixed)
            xmd_host_checks(torch, K, xcases)
            row, ms = case_kernel_row(torch, name, replaces, source, xcases, by_path["launches"],
                                      by_path["sizes"], plain_call, "verify")
            rows.append(row)
            kernel_ms += ms
            continue
        if name in STEP_KERNELS:
            row, _ = case_kernel_row(torch, name, replaces, source, scases[name],
                                     by_path["launches"], by_path["sizes"], plain_call, "steps")
            rows.append(row)
            step_ms[name] = sum(c["ms"] * c["launches"] for c in row["cases"]
                                if c["path"] == "steps")
            continue
        if source in (HASH_SRC, POINT_SRC):
            cases = hcases[name] + kcases[name] if source == HASH_SRC else pcases[name]
            row, ms = case_kernel_row(torch, name, replaces, source, cases, by_path["launches"],
                                      by_path["sizes"], plain_call,
                                      "verify" if source == HASH_SRC else "keys")
            rows.append(row)
            kernel_ms += ms
            continue
        kern, plain = kernel_call(name)
        field = source == FIELD_SRC
        hist, khist = sizes[name], keys["sizes"][name]
        n_main = max(hist, key=lambda s: (hist[s], s))
        miller = name.startswith("miller")
        # two pairs here at verify's counts; the keys run's one pair below
        counts = sorted(hist) if miller else sorted(set(hist) | set(khist))
        runs = [c for c, _ in CV.X_SEGMENTS] if name == "miller_dbl_run" else [None]
        worst, main = 0, None
        for n in counts:
            for count in runs:
                if field:
                    args = field_inputs(torch, rng, name, n)
                else:
                    args = pairing_inputs(torch, rng, name, n, count)
                got = kern(*args)
                start.record()
                ref = plain_call(name, plain, args)
                end.record()
                torch.cuda.synchronize()
                worst = max(worst, max_err(got, ref))
                ms = device_ms(torch, kern, args, *((20, 5) if field else (3, 2)))
                kernel_ms += ms * hist.get(n, 0) / len(runs)
                if n == n_main and count in (None, longest):
                    main = (n, count, args, ms, start.elapsed_time(end))
        if worst != 0:
            raise RuntimeError(f"kernel {name} disagrees with its plain version: max |err| {worst}")
        check_covered(name, counts, "verify", hist)
        n, count, args, ms, plain_ms = main
        eager_ms = call_ms(torch, kern, args, 50 if field else 3)
        if field:  # cheap: a mean of 3 calls; the slow pairing ones: the compared call
            plain_ms = call_ms(torch, lambda *a: plain_call(name, plain, a), args, 3)
        bound_ms, bound_by = bound(name, n, args)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "elements": n, "call_ms": eager_ms,
        }
        if count is not None:
            row["count"] = count
        row["launches_keys"] = keys["launches"][name]
        if miller:
            row["k1"] = miller_k1_cases(torch, rng, name, kern, plain_call, plain, keys, longest)
        else:
            check_covered(name, counts, "keys", khist)
        check_covered(name, counts, "mixed", mixed["sizes"][name])
        row["launches_mixed"] = mixed["launches"][name]
        for path in steps["sizes"]:
            check_covered(name, counts, path, steps["sizes"][path][name])
            row[f"launches_{path}"] = steps["launches"][path][name]
        if field:  # the empty kernel on the same grid
            row["floor_ms"] = device_ms(torch, floor_launch(torch, K, *field_grid(K, name, n)), ())
        rows.append(row)
        at = f"{n} elements" + (f", run of {count}" if count else "")
        checked = f"sizes {counts}" + (f" x run lengths {runs}" if count else "")
        log(f"[kernel] {name}: bit-equal to plain at {len(counts) * len(runs)} calls "
            f"({checked}; verify's {sorted(hist)}"
            + ("" if miller else f", the keys run's {sorted(khist)}") + "), COUNTS "
            f"unchanged by plain; at {at}: device {ms:.5f} ms, eager call {eager_ms:.5f} "
            f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}); {launches[name]} launches per verify")
    by_name = {r["name"]: r for r in rows}
    for name, checked in r1cs_field_checks(torch, K, r1cs, plain_call).items():
        by_name[name]["launches_r1cs"] = checked["launches"]
        by_name[name]["r1cs_counts"] = checked["counts"]
    for name, fields in staged_edge_checks(torch, K, rng, plain_call).items():
        by_name[name]["edge_counts"] = list(EDGE_COUNTS)
        by_name[name]["edge_fields"] = fields
    floor_ms = device_ms(torch, floor_launch(torch, K, 1, 32), ())
    log(f"[kernel] launch floor (an empty kernel, timed as device_ms times every kernel): "
        f"{floor_ms:.5f} ms at 1 block of 32 threads; on each field kernel's grid at its size "
        f"above, kernel / floor / bound ms: " + "; ".join(
            f"{r['name']} {r['ms']:.5f} / {r['floor_ms']:.5f} / {r['bound_ms']:.5f}"
            for r in rows if "floor_ms" in r))
    log(f"[kernel] kernel device time per verify batch (launches x device time "
        f"at each size) {kernel_ms:.3f} ms of {verify_s * 1e3:.3f} ms wall "
        f"({100 * kernel_ms / (verify_s * 1e3):.2f}%)")
    miller_ms = (step_ms["dbl_step"] + step_ms["add_step"] + step_ms["mul014"]
                 + 63 * by_name["fp12_sqr"]["ms"])
    chains_ms = step_ms["cyclo_sqr"] + 25 * by_name["fp12_mul"]["ms"]
    log(f"[kernel] step-wise verify batch, launches x device time: Miller loop (63 fp12_sqr, "
        f"dbl_step, add_step, mul014) {miller_ms:.3f} ms; x-chains (cyclo_sqr, 25 fp12_mul) "
        f"{chains_ms:.3f} ms against 5 exp_x {5 * by_name['exp_x']['ms']:.3f} ms; step "
        f"kernels by name {({k: round(v, 3) for k, v in step_ms.items()})}")
    return rows


def r1cs_only(torch, K, smi):
    """--r1cs: the r1cs phase, then lc_dot's row and the R1CS path's field
    kernels against their plain versions (kernel_phase's R1CS parts)."""
    def plain_call(name, plain, args):
        before = dict(K.COUNTS.launches)
        out = plain(*args)
        if K.COUNTS.launches != before:
            raise RuntimeError(f"the plain version of {name} launched kernels")
        return out

    r1cs = r1cs_phase(torch, K, smi)
    row = lc_dot_row(torch, K, r1cs, plain_call)
    r1cs_field_checks(torch, K, r1cs, plain_call)
    log(f"[kernel] lc_dot row: {json.dumps({k: v for k, v in row.items() if k != 'cases'})}")


# ----------------------------------------------------------------------------
# group phase: the group kernels (csrc/group.cuh) at each G, against the
# parent commit's kernels
# ----------------------------------------------------------------------------

# threads per element swept: the pairing unit's group kernels (the library's
# is BLS_GROUP), the hash unit's (kGroupG1, kGroupG2, kGroupCofactor,
# kGroupSswu), pow_win's lanes (kPowLanes, in the hash unit's source) and the
# point unit's pt_mul_var and pt_add (kGroupVarG1, kGroupVarG2, kGroupAddG1,
# kGroupAddG2)
GROUP_SWEEP = {"pairing": (4, 8, 16), "hash": (2, 4, 8), "pow": (2, 4), "point": (2, 4, 8, 16)}
GROUP_UNITS = {"pairing": "pairing_kernels.cu", "hash": "hash_kernels.cu",
               "pow": "hash_kernels.cu", "point": "point_kernels.cu"}
GROUP_DEFINE = {"pairing": "BLS_GROUP", "hash": "BLS_HASH_GROUP", "pow": "BLS_POW_LANES",
                "point": "BLS_POINT_GROUP"}
GROUP_VAR = {"pairing": "G", "hash": "G", "pow": "L", "point": "G"}  # the swept value's name
# group kernel -> its sweep; a group instance: the kernel, or the ladder's field
GROUP_KERNELS = {"miller_dbl_run": "pairing", "miller_add": "pairing", "exp_x": "pairing",
                 "fp12_mul": "pairing", "fp6_mul": "pairing", "fp12_sqr": "pairing",
                 "mul014": "pairing", "cyclo_sqr": "pairing", "dbl_step": "pairing",
                 "add_step": "pairing", "pt_mul_const": "hash", "g2_cofactor": "hash",
                 "sswu_map2": "hash", "pow_win": "pow", "pt_mul_var": "point", "pt_add": "point",
                 "pt_dbl": "point"}
# ptxas's mangled name of each group kernel instance -> (label, program of
# ops/group_rounds.py, G)
GROUP_LOG = (
    (re.compile(r"miller_dbl_run_kernelILi(\d+)ELi(\d+)E"),
     lambda m: (f"miller_dbl_run<K={m[1]}, G={m[2]}>", f"miller{m[1]}", int(m[2]))),
    (re.compile(r"miller_add_kernelILi(\d+)ELi(\d+)E"),
     lambda m: (f"miller_add<K={m[1]}, G={m[2]}>", f"miller_add{m[1]}", int(m[2]))),
    (re.compile(r"exp_x_kernelILi(\d+)E"),
     lambda m: (f"exp_x<G={m[1]}>", "exp_x", int(m[1]))),
    (re.compile(r"pt_mul_const_kernelIN3bls5group\d+Ladder(G[12])ProgramELi(\d+)E"),
     lambda m: (f"pt_mul_const<{m[1]}, G={m[2]}>", f"ladder_{m[1].lower()}", int(m[2]))),
    (re.compile(r"g2_cofactor_kernelILi(\d+)E"),
     lambda m: (f"g2_cofactor<G={m[1]}>", "g2_cofactor", int(m[1]))),
    (re.compile(r"sswu_map2_kernelILi(\d+)E"),
     lambda m: (f"sswu_map2<G={m[1]}>", "sswu_map2", int(m[1]))),
    (re.compile(r"(fp12_mul|fp6_mul|fp12_sqr|mul014|cyclo_sqr|dbl_step)_kernelILi(\d+)E"),
     lambda m: (f"{m[1]}<G={m[2]}>", m[1], int(m[2]))),
    (re.compile(r"pow_win_kernelILi(\d+)ELi(\d+)E"),
     lambda m: (f"pow_win<C={m[1]}, L={m[2]}>", None, int(m[2]))),
    (re.compile(r"pt_mul_var_kernelIN3bls5group\d+VarLadder(G[12])ProgramELi(\d+)E"),
     lambda m: (f"pt_mul_var<{m[1]}, G={m[2]}>", f"var_ladder_{m[1].lower()}", int(m[2]))),
    (re.compile(r"pt_add_kernelIN3bls5group\d+PtAdd(G[12])ProgramELi(\d+)E"),
     lambda m: (f"pt_add<{m[1]}, G={m[2]}>", f"pt_add_{m[1].lower()}", int(m[2]))),
    (re.compile(r"add_step_kernelILi(\d+)E"),
     lambda m: (f"add_step<G={m[1]}>", "miller_add1", int(m[1]))),
    (re.compile(r"pt_dbl_kernelIN3bls5group\d+PtAdd(G[12])ProgramELi(\d+)E"),
     lambda m: (f"pt_dbl<{m[1]}, G={m[2]}>", f"pt_add_{m[1].lower()}", int(m[2]))),
)


def library_groups(K):
    """The library's threads per element of each group instance:
    pairing_kernels.cu's kGroup, kGroupFp12Mul, kGroupFp6Mul,
    kGroupFp12Sqr, kGroupMul014, kGroupCycloSqr, kGroupDblStep and
    kGroupAddStep, hash_kernels.cu's kGroupG1, kGroupG2, kGroupCofactor,
    kGroupSswu and BLS_POW_LANES (pow_win's L), point_kernels.cu's
    kGroupVarG1, kGroupVarG2, kGroupAddG1, kGroupAddG2, kGroupDblG1 and
    kGroupDblG2."""
    pairing, fp12, fp6, sqr, mul014, cyclo, dbl, add_step = map(int, re.search(
        r"#else\nconstexpr int kGroup = (\d+), kGroupFp12Mul = (\d+), kGroupFp6Mul = (\d+),"
        r"\s+kGroupFp12Sqr = (\d+), kGroupMul014 = (\d+), kGroupCycloSqr = (\d+),"
        r"\s+kGroupDblStep = (\d+), kGroupAddStep = (\d+);",
        (K.CSRC_DIR / GROUP_UNITS["pairing"]).read_text()).groups())
    hash_src = (K.CSRC_DIR / GROUP_UNITS["hash"]).read_text()
    g1, g2, cofactor, sswu = map(int, re.search(
        r"#else\nconstexpr int kGroupG1 = (\d+), kGroupG2 = (\d+), kGroupCofactor = (\d+), "
        r"kGroupSswu = (\d+);", hash_src).groups())
    lanes = int(re.search(r"#define BLS_POW_LANES (\d+)", hash_src)[1])
    var1, var2, add1, add2, dbl1, dbl2 = map(int, re.search(
        r"#else\nconstexpr int kGroupVarG1 = (\d+), kGroupVarG2 = (\d+), kGroupAddG1 = (\d+),"
        r"\s+kGroupAddG2 = (\d+), kGroupDblG1 = (\d+), kGroupDblG2 = (\d+);",
        (K.CSRC_DIR / GROUP_UNITS["point"]).read_text()).groups())
    return {"miller_dbl_run": pairing, "miller_add": pairing, "exp_x": pairing,
            "fp12_mul": fp12, "fp6_mul": fp6, "fp12_sqr": sqr, "mul014": mul014,
            "cyclo_sqr": cyclo, "dbl_step": dbl, "add_step": add_step, "pt_mul_const G1": g1,
            "pt_mul_const G2": g2, "g2_cofactor": cofactor, "sswu_map2": sswu, "pow_win Fp": lanes,
            "pow_win Fp2": lanes, "pt_mul_var G1": var1, "pt_mul_var G2": var2,
            "pt_add G1": add1, "pt_add G2": add2, "pt_dbl G1": dbl1, "pt_dbl G2": dbl2}


def ptxas_report(log_path, patterns):
    """ptxas's lines (stack frame and spills; registers and shared memory)
    of each kernel instance whose mangled name matches one of `patterns`
    ((regex, name of the match), ...) in a build's report -> {name: lines}."""
    name, out = None, {}
    for line in log_path.read_text().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            hits = [(pat.search(line), fn) for pat, fn in patterns]
            name = next((fn(m) for m, fn in hits if m), None)
            continue
        if name and ("stack frame" in line or "Used" in line):
            out.setdefault(name, []).append(line.strip())
    return out


def group_build_report(log_path, label):
    """ptxas's registers, stack and spills of the group kernels, one line
    per instance, from a build's report, and each group instance's dynamic
    shared memory per block (ops/group_rounds.py shared_bytes; pow_win's
    table is static shared memory, in ptxas's line)."""
    from bls_verify_gadget_tpu_torch.ops import group_rounds as GR

    progs = {P.name: P for P in GR.programs()}
    lines = ptxas_report(log_path, GROUP_LOG)
    for name in sorted(lines, key=str):
        P = progs.get(name[1])
        log(f"[build] ptxas {name[0]} ({label}): " + "; ".join(lines[name])
            + ("" if P is None else
               f"; {GR.shared_bytes(P, name[2])} bytes of dynamic shared memory per block "
               f"({GR.elements_per_block(P, name[2])} elements of {P.nslots} slots)"))


def field_build_report(log_path, label):
    """ptxas's registers, stack, spills and static shared memory of the
    staged field kernels (sub, fp2_mul) and the launch floor, one line per
    instance."""
    for name, lines in ptxas_report(log_path, FIELD_LOG).items():
        log(f"[build] ptxas {name} ({label}): " + "; ".join(lines))


def xmd_build_report(log_path, label):
    """ptxas's registers, stack and spills of xmd_kernel in a build's
    report; fatal unless it has no stack and no spill (its schedule window
    must stay in registers)."""
    lines = ptxas_report(log_path, ((re.compile(r"\d+xmd_kernel"), lambda m: "xmd"),))["xmd"]
    log(f"[build] ptxas xmd ({label}): " + "; ".join(lines))
    frame = next(line for line in lines if "stack frame" in line)
    if re.findall(r"(\d+) bytes", frame) != ["0", "0", "0"]:
        raise RuntimeError(f"xmd ({label}) has a stack frame or spills: {frame}")


def unit_build_start(K, src, so, defines=()):
    """Start nvcc on one unit `src` into the throwaway library `so` under
    build/ -> (process, library, log)."""
    K.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    log_path = so.with_suffix(".log")
    with open(log_path, "w") as fh:
        proc = subprocess.Popen(
            [K.nvcc_path(), *K.NVCC_FLAGS, *defines, "-shared", "-o", str(so), str(src)],
            stdout=fh, stderr=subprocess.STDOUT)
    return proc, so, log_path


def sweep_build_start(K):
    """Start nvcc on this tree's group units at each G of their sweep that
    the library does not hold for every instance of the unit -> {(unit, G):
    (process, library, log)}."""
    lib = library_groups(K)
    started = {}
    for unit, sweep in GROUP_SWEEP.items():
        have = {g for key, g in lib.items() if GROUP_KERNELS[key.split()[0]] == unit}
        for g in sweep:
            if have != {g}:
                started[(unit, g)] = unit_build_start(
                    K, K.CSRC_DIR / GROUP_UNITS[unit], K.BUILD_DIR / f"sweep_{unit}{g}.so",
                    (f"-D{GROUP_DEFINE[unit]}={g}",))
    return started


def parent_build_start(K, parent, group=True, field=True):
    """Start nvcc on the parent tree's group units (group) and its field
    unit (field), one build per source: DIR is a git archive of the parent
    commit in a git-ignored directory of this checkout, such as
    chip_scratch/ -> {sweep or "field": (process, library, log)}."""
    root = pathlib.Path(parent).resolve()
    if not root.is_relative_to(ROOT):
        raise RuntimeError(f"--parent: {root} lies outside the checkout {ROOT}")
    builds = {}
    names = ({*GROUP_UNITS.values()} if group else set()) | ({FIELD_UNIT} if field else set())
    for name in sorted(names):
        src = root / "bls_verify_gadget_tpu_torch" / "csrc" / name
        if not src.is_file():
            raise RuntimeError(f"--parent: {src} not found")
        builds[name] = unit_build_start(K, src, K.BUILD_DIR / f"parent_{name[:-3]}.so")
    out = {unit: builds[name] for unit, name in GROUP_UNITS.items() if name in builds}
    if FIELD_UNIT in builds:
        out["field"] = builds[FIELD_UNIT]
    return out


def unit_library(K, unit, started):
    """Wait for a unit_build_start build -> its library, with the unit's
    group kernels' entry points declared as in ops/kernels.py."""
    import ctypes

    proc, so, log_path = started
    if proc.wait() != 0:
        raise RuntimeError(f"build of {so.name} failed:\n{log_path.read_text()}")
    lib = ctypes.CDLL(str(so))
    K._declare(lib, [k for k, u in GROUP_KERNELS.items() if u == unit])
    return lib


def entry_launch(torch, K, name, fn, args, packed=False):
    """A closure that launches the C entry point `fn` (bls_<name> of some
    build) on the operands the wrapper K.<name> would pass for `args`, into
    one preallocated output; -> (launch, output).  `packed`: fn is a pt_add
    that takes P and Q as one (6c, n, 24) operand (a parent's)."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    p, n0 = K._p_words(FP), FP.n0_word
    if name in ("fp12_mul", "fp6_mul", "fp12_sqr"):
        packed = torch.cat(args)
        out = packed.new_empty((args[0].shape[0], *packed.shape[1:]))

        def launch():
            K._check_rc(name, fn(packed.data_ptr(), out.data_ptr(), packed.shape[1], p, n0,
                                 K._stream(packed)))
        return launch, out
    if name in ("mul014", "dbl_step", "add_step"):  # each operand through a pointer of its own
        out = args[0].new_empty((12, *args[0].shape[1:]))

        def launch():
            K._check_rc(name, fn(*(a.data_ptr() for a in args), out.data_ptr(),
                                 args[0].shape[1], p, n0, K._stream(args[0])))
        return launch, out
    if name == "pt_add":  # P and Q through a pointer each, or packed
        pts, qts = args
        out, one = torch.empty_like(pts), K._mont_words(FP, [1])
        ops = (torch.cat([pts, qts]),) if packed else (pts, qts)

        def launch():
            K._check_rc(name, fn(*(t.data_ptr() for t in ops), out.data_ptr(), pts.shape[1],
                                 pts.shape[0] // 3, one, p, n0, K._stream(pts)))
        return launch, out
    if name in ("cyclo_sqr", "pt_dbl"):  # pt_dbl: the coordinate count before the count
        f, count = args
        out = torch.empty_like(f)
        nc = (f.shape[0] // 3,) if name == "pt_dbl" else ()

        def launch():
            K._check_rc(name, fn(f.data_ptr(), out.data_ptr(), f.shape[1], *nc, count, p, n0,
                                 K._stream(f)))
        return launch, out
    if name == "pow_win":
        a, exponent = args
        digits, ndig = K._digits(exponent)
        out = torch.empty_like(a)

        def launch():
            K._check_rc(name, fn(a.data_ptr(), out.data_ptr(), a.shape[1], a.shape[0], digits,
                                 ndig, p, n0, K._stream(a)))
        return launch, out
    if name == "pt_mul_var":
        pts, scalars, nbits = args
        out, one = torch.empty_like(pts), K._mont_words(FP, [1])

        def launch():
            K._check_rc(name, fn(pts.data_ptr(), scalars.data_ptr(), out.data_ptr(),
                                 pts.shape[1], pts.shape[0] // 3, nbits, one, p, n0,
                                 K._stream(pts)))
        return launch, out
    if name in ("miller_dbl_run", "miller_add"):  # miller_dbl_run's run length last
        count = args[-1:] if name == "miller_dbl_run" else ()
        f, t, *per_pair, valid = args[:len(args) - len(count)]
        packed, mask = K._miller_pack(f, t, per_pair, valid)
        k, n = t.shape[0], f.shape[1]
        out = packed.new_empty((12 + 6 * k, n, 24))

        def launch():
            K._check_rc(name, fn(packed.data_ptr(), mask.data_ptr(), out.data_ptr(), n, k,
                                 *count, p, n0, K._stream(packed)))
        return launch, out
    if name == "xmd":  # K.xmd checks the lengths on the host: launch past that check
        msg, lens, dst, nbytes = args
        lens32 = None if lens is None else lens.to(torch.int32).contiguous()
        out = msg.new_empty((msg.shape[0], nbytes))

        def launch():
            K._xmd_launch(fn, msg, lens32, dst, nbytes, out)
        return launch, out
    if name == "sswu_map2":
        from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H

        (u,) = args
        table, out = H.sswu_consts(u.device), u.new_empty((6, *u.shape[1:]))
        sqrt_digits, nsqrt = K._digits(H.SQRT_K)
        inv_digits, ninv = K._digits(FP.modulus - 2)

        def launch():
            K._check_rc(name, fn(u.data_ptr(), table.data_ptr(), out.data_ptr(), u.shape[1],
                                 sqrt_digits, nsqrt, inv_digits, ninv, K._mont_words(FP, [1]),
                                 p, n0, K._stream(u)))
        return launch, out
    m, segs = args
    lens, muls, nseg = K._segments(name, segs)
    out = torch.empty_like(m)
    one = K._mont_words(FP, [1])
    tail = {"exp_x": (lens, muls, nseg),
            "pt_mul_const": (m.shape[0] // 3, lens, muls, nseg, one),
            "g2_cofactor": (lens, muls, nseg, K.psi_words(FP), one)}[name]

    def launch():  # holds out: a captured graph writes it after the caller drops it
        K._check_rc(name, fn(m.data_ptr(), out.data_ptr(), m.shape[1], *tail, p, n0,
                             K._stream(m)))
    return launch, out


def ladder_edge_points():
    """Host affine edge points of the ladder cases (None the infinity):
    G1 the infinity, [#E1/3] (5, y) of order 3 (the first addition of the
    |x| ladder meets acc = [2]P = -P, then acc at infinity), [#E1/121]
    (4, y) of order 11 (its second addition meets acc = [12]P = P, the
    doubling case), the off-subgroup point; G2 the infinity and the
    off-subgroup point."""
    from bls_verify_gadget_tpu_torch import constants as C
    from bls_verify_gadget_tpu_torch.golden import field as GF

    p = C.P

    def add(a, b):  # affine, on E1
        if a is None or b is None:
            return b if a is None else a
        (x1, y1), (x2, y2) = a, b
        if x1 == x2 and (y1 + y2) % p == 0:
            return None
        lam = (3 * x1 * x1 * pow(2 * y1, -1, p) if x1 == x2
               else (y2 - y1) * pow(x2 - x1, -1, p)) % p
        x3 = (lam * lam - x1 - x2) % p
        return x3, (lam * (x1 - x3) - y1) % p

    def mul(pt, k):
        acc = None
        for bit in bin(k)[2:]:
            acc = add(acc, acc)
            acc = add(acc, pt) if bit == "1" else acc
        return acc

    order = (C.ABS_X + 1) ** 2 // 3 * C.R  # #E1 = h1 r, h1 = (x - 1)^2 / 3
    small = [mul((x, GF.fp_sqrt((x**3 + 4) % p)), order // m) for x, m in ((5, 3), (4, 121))]
    off1, off2 = off_subgroup_points()
    return [None, *small, off1], [None, off2]


def cyclotomic_inputs(torch, rng, n):
    """n cyclotomic Fp12 as a packed (12, n, 24) operand: the easy part
    f^((p^6 - 1)(p^2 + 1)) of pairing_inputs' seeded values (through the
    port's kernels), the one in element 0."""
    from bls_verify_gadget_tpu_torch.ops import tower as T

    f = T.fp12_unpack(pairing_inputs(torch, rng, "fp12_sqr", n)[0])
    f1 = T.fp12_mul(T.fp12_frob(f, 6), T.fp12_inv(f))
    m = T.fp12_pack(T.fp12_mul(T.fp12_frob(f1, 2), f1)).contiguous()
    m[:, 0] = T.fp12_pack(T.fp12_one_like(T.fp12_unpack(m[:, :1])))[:, 0]
    return m


def group_cases(torch, rng):
    """(label, kernel, instance, args, timed) of the group phase:
    miller_dbl_run with two pairs and with one, runs of 32 at 4096 (timed)
    and of 3 at 4095 (a count that is no multiple of any G's elements per
    block), exp_x over |x| at 4096 (timed) and 4095; masks mixed
    (pairing_inputs: 3/4 valid); pt_mul_const by |x| in G1 and G2 and
    g2_cofactor at 4096 (timed), 4095 and 1 (timed), the counts the paths
    launch them with: seeded random coordinates (off the curve; the kernels
    and the plain versions compute the same formulas), with
    ladder_edge_points in elements 0 and up of 4096 and 4095; miller_add
    with two pairs and with one at 4096 (timed) and 4095, masks mixed;
    sswu_map2 at 4096 (timed), 4095 and 1 (timed) on hash_to_field's
    outputs for seeded messages, with hash_cases' u = 0 elements (u0 = u1
    = 0: both maps' e1 branch and the sum's doubling case; u1 = 0) in
    elements 0 and 1 of 4096 and 4095; fp12_mul at 4096 (timed), 4095 and
    1 (timed), fp6_mul at 8192 (timed), 8191, 2 and 1 (timed) and fp12_sqr
    at 4096 (timed), 4095 and 1 (timed): pairing_inputs, so 0, 1, p - 1,
    p - 2 and R mod p in elements 0-4 (rolled per coordinate), the counts
    that the paths launch them with (fp6_mul 8192 verify and steps, 2 keys;
    fp12_sqr 4096 verify and steps, 1 keys) and a count that is no multiple
    of any G's elements per block; pow_win in Fp with e = p - 2 at 4096
    (timed), 4095 and 1 (timed), with 0, 1, p - 1 and values whose low 6 and 11 words
    are all 0xFFFFFFFF in elements 0-4 of 4096 and 4095, and in Fp2 with e
    = (p - 11)/16 at 4096 (timed), the same values in its coordinates;
    pt_mul_var over 255 bits on the keys path's points (G1 the generator,
    derive_pubkeys'; G2 H(m) of seeded messages, sign's) at 4096 (timed),
    4095 and 1 (timed): the scalars 0, 1, 2, r - 1, r (its last addition
    meets acc = -P: set_inf), r + 2 (acc = P: the doubling case) and
    2^255 - 1 in elements 0-6, the base at infinity (Z = 0) in element 7,
    seeded 255-bit scalars in the rest; 4095 and 1 are the first 4095
    elements and the last one; cyclo_sqr at 4096 (timed), 4095 and 1
    (timed), runs of 1 and 32 (|x|'s longest), on cyclotomic_inputs and
    on pairing_inputs (random Fp12, the edge values in elements 0-4); mul014
    at 4096 (timed), 4095 and 1 (timed) on pairing_inputs (f with the edge
    values in elements 0-4, a quarter of the lines neutral); dbl_step and
    add_step at 8192, 4096 and 1 (all timed) on pairing_inputs; pt_add in G1 and G2 on
    seeded coordinates (off the curve: the generic sum) at every level of a
    4096-point tree, 2048 down to 1 (all timed), and on pt_add_branches of
    seeded points at 2048 (timed) and 1 (Q = -P); pt_dbl in G1 and G2,
    counts 1 and 63, at 4096 (timed; seeded coordinates, edge_limbs rolled
    per coordinate in elements 0-4, the infinity in element 5) and at 1
    (timed; the last element of 4096).  The plain variable ladder and
    pt_dbl's plain version cost about the same at any count on the card
    (launch-bound: ~30-45 s and a few s), and each element's result depends
    on its own operands only, so each runs once, at 4096, and its columns
    are the reference of 4095 and 1 (a case's sixth item)."""
    import numpy as np

    from bls_verify_gadget_tpu_torch import constants as C
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
    from bls_verify_gadget_tpu_torch.ops.fp import FP
    from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs

    longest = max(c for c, _ in CV.X_SEGMENTS)
    cases = [
        (f"k = 2, run of {longest}, {BATCH}", "miller_dbl_run", "miller_dbl_run",
         pairing_inputs(torch, rng, "miller_dbl_run", BATCH, longest, k=2), True),
        (f"k = 1, run of {longest}, {BATCH}", "miller_dbl_run", "miller_dbl_run",
         pairing_inputs(torch, rng, "miller_dbl_run", BATCH, longest, k=1), True),
        (f"k = 2, run of 3, {BATCH - 1}", "miller_dbl_run", "miller_dbl_run",
         pairing_inputs(torch, rng, "miller_dbl_run", BATCH - 1, 3, k=2), False),
        (f"k = 1, run of 3, {BATCH - 1}", "miller_dbl_run", "miller_dbl_run",
         pairing_inputs(torch, rng, "miller_dbl_run", BATCH - 1, 3, k=1), False),
        (f"|x|, {BATCH}", "exp_x", "exp_x", pairing_inputs(torch, rng, "exp_x", BATCH), True),
        (f"|x|, {BATCH - 1}", "exp_x", "exp_x",
         pairing_inputs(torch, rng, "exp_x", BATCH - 1), False),
    ]
    top = FP.modulus >> (16 * 23)
    edges1, edges2 = ladder_edge_points()
    ladders = (("G1 by |x|", "pt_mul_const", "pt_mul_const G1", 3, CV.FP_OPS,
                CV.g1_encode_batch, edges1),
               ("G2 by |x|", "pt_mul_const", "pt_mul_const G2", 6, CV.FP2_OPS,
                CV.g2_encode_batch, edges2),
               ("G2", "g2_cofactor", "g2_cofactor", 6, CV.FP2_OPS, CV.g2_encode_batch, edges2))
    for what, name, key, c, ops, enc, edges in ladders:
        for n in (BATCH, BATCH - 1, 1):
            pts = rand_limbs(torch, rng, c * n, top).view(c, n, 24)
            e = min(len(edges), n) if n > 1 else 0
            pts[:, :e] = CV.pack_point(ops, enc(edges[:e], "cuda"))
            label = f"{what}, {n}" + (f", edge points in elements 0-{e - 1}" if e else "")
            cases.append((label, name, key, (pts, CV.X_SEGMENTS), n != BATCH - 1))
    for k in (2, 1):
        for n in (BATCH, BATCH - 1):
            cases.append((f"k = {k}, {n}", "miller_add", "miller_add",
                          pairing_inputs(torch, rng, "miller_add", n, k=k), n == BATCH))
    msg = torch.from_numpy(rng.integers(0, 256, (BATCH, MSG_LEN), dtype=np.uint8)).cuda()
    u = torch.stack([*(c for f2 in H.hash_to_field_fp2(msg, MSG_LEN) for c in f2)])
    for n in (BATCH, BATCH - 1, 1):
        un = u[:, BATCH - n:].contiguous()
        label = f"hash_to_field outputs, {n}"
        if n > 1:
            un[:, 0] = 0
            un[2:, 1] = 0
            label += ", u0 = u1 = 0 in element 0, u1 = 0 in element 1"
        cases.append((label, "sswu_map2", "sswu_map2", (un,), n != BATCH - 1))
    for name, counts in (("fp12_mul", (BATCH, BATCH - 1, 1)),
                         ("fp6_mul", (2 * BATCH, 2 * BATCH - 1, 2, 1)),
                         ("fp12_sqr", (BATCH, BATCH - 1, 1))):
        for n in counts:
            label = f"{n}, edge values in " + (f"elements 0-{min(n, 5) - 1}" if n > 1
                                               else "element 0")
            cases.append((label, name, name, pairing_inputs(torch, rng, name, n),
                          n in (counts[0], 1)))
    edges = torch.from_numpy(ints_to_limbs(
        [0, 1, FP.modulus - 1, (1 << 192) - 1, (1 << 352) - 1], 24)).cuda()
    for n in (BATCH, BATCH - 1, 1):
        a = rand_limbs(torch, rng, n, top).view(1, n, 24)
        e = len(edges) if n > 1 else 0
        a[0, :e] = edges[:e]
        label = f"Fp, e = p - 2, {n}" + (", edge values in elements 0-4" if e else "")
        cases.append((label, "pow_win", "pow_win Fp", (a, FP.modulus - 2), n != BATCH - 1))
    a = rand_limbs(torch, rng, 2 * BATCH, top).view(2, BATCH, 24)
    a[0, :len(edges)], a[1, :len(edges)] = edges, edges.roll(1, 0)
    cases.append((f"Fp2, e = (p - 11)/16, {BATCH}, edge values in elements 0-4", "pow_win",
                  "pow_win Fp2", (a, H.SQRT_K), True))
    for n in (BATCH, BATCH - 1, 1):
        edge = "element 0" if n == 1 else "elements 0-4"
        for count in (1, longest):
            cases.append((f"cyclotomic, the one in element 0, run of {count}, {n}", "cyclo_sqr",
                          "cyclo_sqr", (cyclotomic_inputs(torch, rng, n), count), n != BATCH - 1))
            cases.append((f"random Fp12, edge values in {edge}, run of {count}, {n}",
                          "cyclo_sqr", "cyclo_sqr", pairing_inputs(torch, rng, "cyclo_sqr", n,
                                                                   count), n != BATCH - 1))
        cases.append((f"1/4 of the lines neutral, edge values in {edge}, {n}", "mul014",
                      "mul014", pairing_inputs(torch, rng, "mul014", n), n != BATCH - 1))
    r = C.R
    edge_keys = [0, 1, 2, r - 1, r, r + 2, (1 << 255) - 1]
    keys = edge_keys + [int.from_bytes(rng.bytes(32), "little") >> 1
                        for _ in range(BATCH - len(edge_keys))]
    scalars = torch.from_numpy(ints_to_limbs(keys, 16)).cuda()
    bases = (("G1 on the generator", "pt_mul_var G1", 3,
              CV.pack_point(CV.FP_OPS, CV.g1_generator((BATCH, 24), "cuda"))),
             ("G2 on H(m)", "pt_mul_var G2", 6,
              CV.pack_point(CV.FP2_OPS, H.hash_to_g2(msg, MSG_LEN))))
    for what, key, c, pts in bases:
        pts = pts.contiguous()
        pts[2 * c:, len(edge_keys)] = 0  # the base at infinity
        ref = CV.pt_mul_var_plain(pts, scalars, 255)
        cases.append((f"{what}, {BATCH}, scalars 0, 1, 2, r - 1, r, r + 2, 2^255 - 1 in "
                      f"elements 0-6, the base at infinity in element 7", "pt_mul_var", key,
                      (pts, scalars, 255), True, ref))
        cases.append((f"{what}, {BATCH - 1}, the first {BATCH - 1} of {BATCH}", "pt_mul_var",
                      key, (pts[:, :-1].contiguous(), scalars[:-1].contiguous(), 255), False,
                      ref[:, :-1]))
        cases.append((f"{what}, 1, the last of {BATCH}", "pt_mul_var", key,
                      (pts[:, -1:].contiguous(), scalars[-1:].contiguous(), 255), True,
                      ref[:, -1:]))
    for n in (2 * BATCH, BATCH, 1):
        edge = "elements 0-4" if n > 1 else "element 0"
        cases.append((f"{n}, edge values in {edge}", "dbl_step", "dbl_step",
                      pairing_inputs(torch, rng, "dbl_step", n), True))
        cases.append((f"{n}, edge values in {edge}", "add_step", "add_step",
                      pairing_inputs(torch, rng, "add_step", n), True))
    edges = edge_limbs(torch, FP)
    for what, c in (("G1", 1), ("G2", 2)):
        pts = rand_limbs(torch, rng, 3 * c * BATCH, top).view(3 * c, BATCH, 24)
        for j in range(3 * c):
            pts[j, :len(edges)] = edges.roll(j, 0)
        pts[2 * c:, len(edges)] = 0  # the infinity
        for count in (1, 63):
            ref = CV.pt_dbl_plain(pts, count)
            cases.append((f"{what}, {BATCH}, edge values in elements 0-4, the infinity in "
                          f"element 5, count {count}", "pt_dbl", f"pt_dbl {what}", (pts, count),
                          True, ref))
            cases.append((f"{what}, 1, the last of {BATCH}, count {count}", "pt_dbl",
                          f"pt_dbl {what}", (pts[:, -1:].contiguous(), count), True,
                          ref[:, -1:]))
    for what, ops in (("G1", CV.FP_OPS), ("G2", CV.FP2_OPS)):
        c = 3 if ops is CV.FP_OPS else 6
        for n in tree_counts(BATCH):
            p, q = (rand_limbs(torch, rng, c * n, top).view(c, n, 24) for _ in range(2))
            cases.append((f"{what}, tree level of {n}", "pt_add", f"pt_add {what}", (p, q), True))
        for n in (BATCH // 2, 1):
            pts = CV.unpack_point(ops, rand_limbs(torch, rng, 2 * c * n, top).view(c, 2 * n, 24))
            cases.append((f"{what} branches, {n}", "pt_add", f"pt_add {what}",
                          pt_add_branches(torch, rng, ops, pts, n), n > 1))
    return cases


def group_phase(torch, K, sweep_started, parent_started=None, parent_dir=None):
    """The group kernels (module docstring, phase 10): on each case of
    group_cases, the wrapper bit-equal to the plain version, each G of the
    sweep (the library's and the throwaway builds of sweep_started) and the
    parent's kernel bit-equal to the wrapper, all on the same
    CUDA tensors; on the timed cases device ms per launch (CUDA-graph
    replay) of each G, and of the parent's kernel and the wrapper
    interleaved (parent, group, group, parent); then the keys run's pt_add
    device time, each tree level's time summed over its 33 launches.  A
    parent whose bls_pt_add takes P and Q as one packed operand (the
    one-thread kernel's interface) is launched so.  -> {kernel: {case:
    timings}} for the kernel rows."""
    import ctypes

    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    lib_g = library_groups(K)
    libs = {}
    for (unit, g), started in sweep_started.items():
        libs[(unit, g)] = unit_library(K, unit, started)
        group_build_report(started[2], f"sweep build, {GROUP_DEFINE[unit]}={g}")
    parent = {unit: unit_library(K, unit, s) for unit, s in (parent_started or {}).items()
              if unit in GROUP_SWEEP}
    parent_packed = set()
    if parent:
        src = (pathlib.Path(parent_dir) / "bls_verify_gadget_tpu_torch" / "csrc"
               / GROUP_UNITS["point"]).read_text()
        if "bls_pt_add(const int32_t* in," in src:
            vp, i64, i32, u32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_uint
            parent["point"].bls_pt_add.argtypes = [vp, vp, i64, i32, vp, vp, u32, vp]
            parent_packed.add("pt_add")
    out = {name: {} for name in GROUP_KERNELS}
    for label, name, key, args, timed, *ref in group_cases(torch, rng):
        unit = GROUP_KERNELS[name]
        kern, plain = kernel_call(name)
        got = kern(*args)
        err = max_err(got, ref[0] if ref else plain(*args))
        if err != 0:
            raise RuntimeError(f"group kernel {name} ({label}) disagrees with its plain version: "
                               f"max |err| {err}")
        want = torch.cat([g.reshape(-1, *g.shape[-2:]) for g in flat_outputs(got)])
        var = GROUP_VAR[unit]
        variants = [(f"{var} = {g}",
                     libs.get((unit, g), K.library() if g == lib_g[key] else None))
                    for g in GROUP_SWEEP[unit]]
        variants = [(v, getattr(lib, f"bls_{name}")) for v, lib in variants if lib is not None]
        variants.append(("group", getattr(K.library(), f"bls_{name}")))
        if parent:
            variants.append(("parent", getattr(parent[unit], f"bls_{name}")))
        launches = {}
        for vlabel, fn in variants:
            launch, res = entry_launch(torch, K, name, fn, args,
                                       vlabel == "parent" and name in parent_packed)
            launch()
            torch.cuda.synchronize()
            if not torch.equal(res, want):
                raise RuntimeError(f"{name} ({label}), {vlabel}: differs from the wrapper's output")
            launches[vlabel] = launch
        row = {"elements": args[0].shape[1], "max_abs_err": err, var: lib_g[key]}
        swept = [v for v in launches if v not in ("group", "parent")]
        extra = ""
        if timed:
            row.update({v: device_ms(torch, launches[v], (), 3, 2) for v in swept})
            extra = "; device ms per launch: " + ", ".join(f"{v} {row[v]:.5f}" for v in swept)
            if parent:
                times = {"parent": [], "group": []}
                for who in ("parent", "group", "group", "parent"):
                    times[who].append(device_ms(torch, launches[who], (), 3, 2))
                row["interleaved"] = times
                row["parent_ms"] = sum(times["parent"]) / 2
                row["group_ms"] = sum(times["group"]) / 2
                extra += (f"; interleaved parent / group / group / parent: "
                          f"{times['parent'][0]:.5f} / {times['group'][0]:.5f} / "
                          f"{times['group'][1]:.5f} / {times['parent'][1]:.5f} "
                          f"({row['parent_ms'] / row['group_ms']:.2f}x)")
        out[name][label] = row
        log(f"[group] {name} ({label}): bit-equal to plain; {', '.join(launches)} bit-equal "
            f"to it (library {var} = {lib_g[key]}){extra}")
    # the keys run's pt_add: G1 over 4096 pubkeys and the 512-key committee,
    # G2 over 4096 signatures, one launch per tree level
    levels = [("G1", n) for n in tree_counts(BATCH) + tree_counts(COMMITTEE)]
    levels += [("G2", n) for n in tree_counts(BATCH)]
    rows = [out["pt_add"][f"{what}, tree level of {n}"] for what, n in levels]
    timed = [v for v in rows[0] if v.startswith("G = ") or v in ("parent_ms", "group_ms")]
    total = {v: sum(r[v] for r in rows) for v in timed if all(v in r for r in rows)}
    out["pt_add"]["keys run, 33 launches"] = total
    log(f"[group] pt_add, the keys run's {len(levels)} launches (G1 levels "
        f"{tree_counts(BATCH)} and {tree_counts(COMMITTEE)}, G2 {tree_counts(BATCH)}), device "
        f"ms summed over the levels: " + ", ".join(f"{v} {t:.5f}" for v, t in total.items()))
    return out


# ----------------------------------------------------------------------------
# field phase: the staged field kernels (mul, add, sub, fp2_mul, fp2_sqr) at
# each elements-per-block count and form of mul, fp2_mul and fp2_sqr, the
# launch floor, and the parent's kernels
# ----------------------------------------------------------------------------

FIELD_UNIT = "field_kernels.cu"
FIELD_E = (8, 16, 32, 64)  # elements per block of the sweep builds
# threads per Fp mul, fp2_mul and fp2_sqr element of the sweep builds: the
# library's lanes and the one-thread bodies on the same staged rows
FIELD_LANES = (4, 1)
FIELD_KERNELS = ("mul", "add", "sub", "fp2_mul", "fp2_sqr")
EDGE_COUNTS = (1, 4095, 4096, 8191, 8192)  # element counts of the edge operands
FIELD_LOG = (
    (re.compile(r"(fp2_mul|fp2_sqr)_kernel"), lambda m: m[1]),
    (re.compile(r"bls_kernels10(mul|add|sub)_kernelILi(\d+)E"), lambda m: f"{m[1]}<NW={m[2]}>"),
    (re.compile(r"launch_floor_kernel"), lambda m: "launch_floor"),
)


def library_field(K):
    """The library's elements per block of mul, add, sub, fp2_mul and
    fp2_sqr and the threads per Fp mul, fp2_mul and fp2_sqr element
    (BLS_MUL_PER_BLOCK, BLS_ADD_PER_BLOCK, BLS_SUB_PER_BLOCK,
    BLS_FP2_MUL_PER_BLOCK, BLS_FP2_SQR_PER_BLOCK, BLS_MUL_LANES,
    BLS_FP2_MUL_LANES and BLS_FP2_SQR_LANES in csrc/field_kernels.cu)."""
    src = (K.CSRC_DIR / FIELD_UNIT).read_text()
    return {key: int(re.search(rf"#define BLS_{define} (\d+)", src)[1])
            for key, define in (("mul", "MUL_PER_BLOCK"), ("add", "ADD_PER_BLOCK"),
                                ("sub", "SUB_PER_BLOCK"), ("fp2_mul", "FP2_MUL_PER_BLOCK"),
                                ("fp2_sqr", "FP2_SQR_PER_BLOCK"), ("mul_lanes", "MUL_LANES"),
                                ("fp2_mul_lanes", "FP2_MUL_LANES"),
                                ("fp2_sqr_lanes", "FP2_SQR_LANES"))}


def field_lanes(cfg, name, nlimb=24):
    """Threads per element of the library's field kernel `name` (Fr's mul
    runs one thread per element)."""
    if name == "mul":
        return cfg["mul_lanes"] if nlimb == 24 else 1
    return cfg.get(f"{name}_lanes", 1)


def field_build_start(K):
    """Start nvcc on this tree's field unit at each elements-per-block
    count E of FIELD_E (all five staged kernels) and each of FIELD_LANES
    (mul, fp2_mul and fp2_sqr) -> {(lanes, E): (process, library, log)}."""
    return {(lanes, e): unit_build_start(
                K, K.CSRC_DIR / FIELD_UNIT, K.BUILD_DIR / f"sweep_field_l{lanes}_e{e}.so",
                (f"-DBLS_MUL_PER_BLOCK={e}", f"-DBLS_ADD_PER_BLOCK={e}",
                 f"-DBLS_SUB_PER_BLOCK={e}", f"-DBLS_FP2_MUL_PER_BLOCK={e}",
                 f"-DBLS_FP2_SQR_PER_BLOCK={e}", f"-DBLS_MUL_LANES={lanes}",
                 f"-DBLS_FP2_MUL_LANES={lanes}", f"-DBLS_FP2_SQR_LANES={lanes}"))
            for lanes in FIELD_LANES for e in FIELD_E}


def field_library(K, started):
    """Wait for a build of a field unit -> its library, with mul, add, sub,
    fp2_mul and fp2_sqr declared as in ops/kernels.py."""
    import ctypes

    proc, so, log_path = started
    if proc.wait() != 0:
        raise RuntimeError(f"build of {so.name} failed:\n{log_path.read_text()}")
    lib = ctypes.CDLL(str(so))
    K._declare(lib, FIELD_KERNELS)
    return lib


def field_launch(torch, K, name, fn, field, ops):
    """A closure that launches `fn` (bls_<name> of some build, name one of
    FIELD_KERNELS) on `ops` into preallocated outputs -> (launch, outputs)."""
    n = ops[0].shape[0]
    outs = [torch.empty_like(ops[0]) for _ in range(2 if name.startswith("fp2") else 1)]
    ptrs = [t.data_ptr() for t in (*ops, *outs)]
    mid = {"fp2_mul": (K._p_words(field), field.n0_word),
           "fp2_sqr": (K._p_words(field), field.n0_word),
           "mul": (field.nlimb, K._p_words(field), field.n0_word)}.get(
               name, (field.nlimb, K._p_words(field)))

    def launch(_keep=(ops, outs)):  # holds outs: a captured graph writes them
        K._check_rc(name, fn(*ptrs, n, *mid, K._stream(ops[0])))
    return launch, outs


def floor_launch(torch, K, blocks, threads):
    """A closure that launches the empty kernel on `blocks` x `threads`."""
    lib = K.library()

    def launch():
        K._check_rc("launch_floor", lib.bls_launch_floor(
            blocks, threads, torch.cuda.current_stream().cuda_stream))
    return launch


def field_grid(K, name, n, nlimb=24):
    """(blocks, threads) of the library's launch of field kernel `name` at n
    elements (of nlimb limbs: Fr's mul runs one thread per element)."""
    cfg = library_field(K)
    return -(-n // cfg[name]), cfg[name] * field_lanes(cfg, name, nlimb)


def staged_edge_inputs(torch, rng, name, n, field):
    """Operands of a staged field kernel (FIELD_KERNELS) at n elements:
    field_inputs' seeded rows with edge operands in the first elements.
    mul: R - 1 (a full-width raw value, hash_to_field's) by R^2 and by R^3,
    0 by m - 1, 1 by 1, m - 1 squared, m - 1 by the Montgomery one, the one
    squared; in Fp also 2p - 1 squared (the largest Karatsuba sums) and
    (p >> 288) - 1 in the top lane's words by the one, whose deferred carry
    crosses lanes 1 to 3 (tests/test_torch_field_lanes.py ripple_row); add:
    (m - 1) + (m - 1), (m - 1) + 1 = m -> 0 (a carry across every word), 1
    + (m - 1), 0 + 0, a + b = m - 1 seeded; sub: 0 - 1 (a borrow across
    every word), a = b = m - 1, 0 - (m - 1), 1 - 0, a = b seeded; fp2_mul:
    (x, x + 1) by the Montgomery one (1, 1) (v0 - v1 = -1: a borrow across
    every word and lane), p - 1 in all four (sums 2p - 2), 0 by p - 1, the
    Montgomery one by itself, (1, 0) by (0, 1); fp2_sqr: a0 = a1 seeded, (0,
    p - 1), (p - 1, p - 1) (the sum 2p - 2), the Montgomery one, (one, (p +
    1) / 2) (the JAX body's doubling 2 mont(a0, a1) = p + 1 crosses p), (one,
    ((p >> 288) - 1) << 287) (c1's product the ripple row of mul, whose
    deferred carry crosses lanes 1 to 3; tests/test_torch_field_lanes.py
    fp2_sqr_edges)."""
    from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs

    m, r = field.modulus, field.mont_r
    one = r % m
    x = int.from_bytes(rng.bytes(48), "little") % (m - 1)
    if name == "mul":
        rows = [(r - 1, r * r % m), (r - 1, r**3 % m), (0, m - 1), (1, 1), (m - 1, m - 1),
                (m - 1, one), (one, one)]
        if field.nlimb == 24:
            rows += [(2 * m - 1, 2 * m - 1), (((m >> 288) - 1) << 288, one)]
    elif name == "add":
        rows = [(m - 1, m - 1), (m - 1, 1), (1, m - 1), (0, 0), (x, m - 1 - x)]
    elif name == "sub":
        rows = [(0, 1), (m - 1, m - 1), (0, m - 1), (1, 0), (x, x)]
    elif name == "fp2_sqr":
        rows = [(x, x), (0, m - 1), (m - 1, m - 1), (one, 0), ((m + 1) // 2, 0),
                (one, (m + 1) // 2), (one, ((m >> 288) - 1) << 287)]
    else:
        rows = [(x, x + 1, one, one), (m - 1,) * 4, (0, 0, m - 1, m - 1), (one,) * 4,
                (one, 0, 0, one)]
    ops = field_inputs(torch, rng, name, n, field)
    e = min(len(rows), n)
    for i, t in enumerate(ops):
        t[:e] = torch.from_numpy(ints_to_limbs([r[i] for r in rows[:e]], field.nlimb)).cuda()
    return ops


def field_plain(name, field):
    """The plain version of staged field kernel `name` in `field`."""
    from bls_verify_gadget_tpu_torch.ops import tower as T

    if name.startswith("fp2"):
        return getattr(T, f"{name}_plain")
    return getattr(field, f"{name}_plain")


def staged_edge_checks(torch, K, rng, plain_call):
    """mul, add and sub (Fp and Fr), fp2_mul and fp2_sqr bit-equal to their
    plain versions on staged_edge_inputs at EDGE_COUNTS -> {kernel: [field
    names]}."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP, FR

    checked = {name: [] for name in FIELD_KERNELS}
    for name, fname, field in [(k, f, F) for k in FIELD_KERNELS[:3]
                               for f, F in (("Fp", FP), ("Fr", FR))] + [
                                   ("fp2_mul", "Fp", FP), ("fp2_sqr", "Fp", FP)]:
        plain = field_plain(name, field)
        for n in EDGE_COUNTS:
            ops = staged_edge_inputs(torch, rng, name, n, field)
            err = max_err(getattr(K, name)(field, *ops), plain_call(name, plain, ops))
            if err != 0:
                raise RuntimeError(f"kernel {name} ({fname}) disagrees with its plain version on "
                                   f"edge operands at {n} elements: max |err| {err}")
        checked[name].append(fname)
        log(f"[kernel] {name} ({fname}, {field.nlimb} limbs): bit-equal to plain on edge operands "
            f"and seeded rows at {list(EDGE_COUNTS)} elements")
    return checked


def field_cases(torch, rng):
    """(label, kernel, field, operands) of the field phase, each on
    staged_edge_inputs: fp2_mul at 8192, 4096 and 1; fp2_sqr at 4096, 8192
    and 1; mul in Fp at 8192, 4096 and 1, in Fr at 8192 and 1; add and sub
    in Fp at 4096, 8192 and 1, in Fr at 4096 and 1."""
    from bls_verify_gadget_tpu_torch.ops.fp import FP, FR

    cases = [(f"{n}", "fp2_mul", FP) for n in (2 * BATCH, BATCH, 1)]
    cases += [(f"{n}", "fp2_sqr", FP) for n in (BATCH, 2 * BATCH, 1)]
    cases += [(f"Fp, {n}", "mul", FP) for n in (2 * BATCH, BATCH, 1)]
    cases += [(f"Fr, {n}", "mul", FR) for n in (2 * BATCH, 1)]
    for name in ("add", "sub"):
        cases += [(f"Fp, {n}", name, FP) for n in (BATCH, 2 * BATCH, 1)]
        cases += [(f"Fr, {n}", name, FR) for n in (BATCH, 1)]
    return [(label, name, field,
             staged_edge_inputs(torch, rng, name, int(label.split()[-1]), field))
            for label, name, field in cases]


def field_phase(torch, K, field_started, parent_started=None):
    """The staged field kernels (module docstring, phase 11): on each case of
    field_cases the wrapper bit-equal to the plain version; the sweep
    builds (every E of FIELD_E, Fp mul, fp2_mul and fp2_sqr also on one
    thread) and the
    parent's kernel bit-equal to the wrapper on the same CUDA tensors;
    device ms per launch of the library's kernel and of each build
    (CUDA-graph replay), of the empty kernel at the library's grid, and of
    the parent's kernel and the library's interleaved (parent, change,
    change, parent).  -> {kernel: {case: timings}} for the kernel rows."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    cfg = library_field(K)
    libs = {}
    for (lanes, e), started in sorted(field_started.items(), reverse=True):
        libs[(lanes, e)] = field_library(K, started)
        field_build_report(started[2], f"sweep build, E = {e}, mul, fp2_mul and fp2_sqr on "
                                       f"{lanes} lane(s)")
    parent = field_library(K, parent_started) if parent_started else None
    if parent is not None:
        field_build_report(parent_started[2], "parent")
    out = {name: {} for name in FIELD_KERNELS}
    for label, name, field, ops in field_cases(torch, rng):
        got = getattr(K, name)(field, *ops)
        err = max_err(got, field_plain(name, field)(*ops))
        got = flat_outputs(got)
        if err != 0:
            raise RuntimeError(f"{name} ({label}) disagrees with its plain version: max |err| {err}")
        # the kernels whose threads per element the lanes builds set
        laned = name.startswith("fp2") or (name == "mul" and field.nlimb == 24)
        lib_lanes = field_lanes(cfg, name, field.nlimb)
        lib_label = f"E = {cfg[name]}" + (f", {lib_lanes} lanes" if laned else "")
        builds = {"library": K.library()}
        for (lanes, e), lib in libs.items():
            if laned:
                builds[f"E = {e}, {lanes} lane{'s' * (lanes > 1)}"] = lib
            elif lanes == FIELD_LANES[0]:  # the same in every lanes build
                builds[f"E = {e}"] = lib
        if parent is not None:
            builds["parent"] = parent
        launches = {}
        for v, lib in builds.items():
            launch, res = field_launch(torch, K, name, getattr(lib, f"bls_{name}"), field, ops)
            launch()
            torch.cuda.synchronize()
            if not all(torch.equal(r, g) for r, g in zip(res, got)):
                raise RuntimeError(f"{name} ({label}), {v}: differs from the wrapper's output")
            launches[v] = launch
        n = ops[0].shape[0]
        row = {"elements": n, "max_abs_err": err, "library_config": lib_label,
               **{v: device_ms(torch, launch, ()) for v, launch in launches.items()
                  if v != "parent"}}
        blocks, threads = field_grid(K, name, n, field.nlimb)
        row["floor_ms"] = device_ms(torch, floor_launch(torch, K, blocks, threads), ())
        extra = ""
        if parent is not None:
            times = {"parent": [], "change": []}
            for who in ("parent", "change", "change", "parent"):
                times[who].append(device_ms(torch, launches["library" if who == "change"
                                                             else "parent"], ()))
            row["interleaved"] = times
            row["parent_ms"] = sum(times["parent"]) / 2
            row["change_ms"] = sum(times["change"]) / 2
            extra = (f"; interleaved parent / change / change / parent: "
                     f"{times['parent'][0]:.5f} / {times['change'][0]:.5f} / "
                     f"{times['change'][1]:.5f} / {times['parent'][1]:.5f} ms "
                     f"({row['parent_ms'] / row['change_ms']:.2f}x)")
        out[name][label] = row
        log(f"[field] {name} ({label}): bit-equal to plain; {', '.join(launches)} bit-equal to it "
            f"(library: {lib_label}); device ms per launch: "
            + ", ".join(f"{v} {row[v]:.5f}" for v in launches if v != "parent")
            + f"; empty kernel on the library's grid ({blocks} x {threads}) "
            f"{row['floor_ms']:.5f}" + extra)
    return out


# ----------------------------------------------------------------------------
# parallel phase: the sharded layer (parallel/) at world size 1 over NCCL and
# on two ranks of the one card over Gloo; the native batch codec
# ----------------------------------------------------------------------------

PARALLEL_RANKS = 2  # Gloo ranks sharing the card
RANK_TIMEOUT_S = 300
GOLDEN_REJECT = {"x out of range": 3, "not on curve": 4, "not in subgroup": 5}  # else 2


def golden_decode(fn, blobs):
    """The golden decode (with its subgroup check) of each blob, once per
    distinct blob -> (points with rejects as None, the native codec's
    status codes): 0 a point, 1 the infinity, 2-5 the reject."""
    memo = {}
    for b in set(blobs):
        try:
            pt = fn(b)
            memo[b] = (pt, 1 if pt is None else 0)
        except ValueError as e:
            memo[b] = (None, GOLDEN_REJECT.get(str(e), 2))
    return [memo[b][0] for b in blobs], [memo[b][1] for b in blobs]


def host_us(fn, items):
    """Host µs per item of fn over the items, rejects included."""
    t0 = time.perf_counter()
    for x in items:
        try:
            fn(x)
        except ValueError:
            pass
    return (time.perf_counter() - t0) / len(items) * 1e6


def codec_checks(torch, cases):
    """The native batch codec on the main path's BATCH wire pairs, every
    verify/ vector's and the deserialization vectors of a valid length:
    points and statuses equal to the golden decode element for element;
    host µs per element of the native decode (to device batches) and of
    the Python decodes."""
    from bls_verify_gadget_tpu_torch import native_codec as NC
    from bls_verify_gadget_tpu_torch.golden import bls as gbls
    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import encode_pubkeys, encode_signatures

    wire = verify_wire()
    pk_wire = [c[4] for c in cases] + [w[0] for w in wire if len(w[0]) == 48]
    sig_wire = [c[5] for c in cases] + [w[1] for w in wire if len(w[1]) == 96]
    for suite, field, nbytes, out in (("deserialization_G1", "pubkey", 48, pk_wire),
                                      ("deserialization_G2", "signature", 96, sig_wire)):
        for path in sorted((ROOT / "tests" / "vectors" / suite).glob("*.json")):
            raw = unhex(json.loads(path.read_text())["input"][field])
            if len(raw) == nbytes:
                out.append(raw)
    t0 = time.perf_counter()
    pk, pk_status = NC.decode_pubkeys(pk_wire)
    sig, sig_status = NC.decode_signatures(sig_wire)
    torch.cuda.synchronize()
    native_s = time.perf_counter() - t0
    for name, batch, status, blobs, fn, encode in (
            ("pubkeys", pk, pk_status, pk_wire, gbls.g1_decompress, encode_pubkeys),
            ("signatures", sig, sig_status, sig_wire, gbls.g2_decompress, encode_signatures)):
        pts, codes = golden_decode(fn, blobs)
        if status.tolist() != codes:
            bad = [i for i, (a, b) in enumerate(zip(status.tolist(), codes)) if a != b]
            raise RuntimeError(f"native {name}: statuses differ from the golden decode at {bad[:8]}")
        if max_err(batch, encode(pts)) != 0:
            raise RuntimeError(f"native {name}: the device batch differs from the golden decode's")
        log(f"[parallel] codec {name}: {len(blobs)} elements ({len(set(blobs))} distinct) equal "
            f"to the golden decode, statuses included: "
            f"{dict(sorted(collections.Counter(codes).items()))}")
    n = len(cases)
    t0 = time.perf_counter()
    NC.decode_pubkeys([c[4] for c in cases])
    NC.decode_signatures([c[5] for c in cases])
    torch.cuda.synchronize()
    main_us = (time.perf_counter() - t0) / n * 1e6
    pks, sigs = sorted({c[4] for c in cases}), sorted({c[5] for c in cases})
    py_us = host_us(codec.g1_decompress, pks) + host_us(codec.g2_decompress, sigs)
    golden_us = host_us(gbls.g1_decompress, pks) + host_us(gbls.g2_decompress, sigs)
    log(f"[parallel] codec host µs per (pk, sig) element: native batch decode to device "
        f"batches {main_us:.2f} (the main path's {n}; with the vectors, "
        f"{len(pk_wire)} + {len(sig_wire)} elements in {native_s:.3f} s); Python decode "
        f"(golden/codec.py, no subgroup check, the main path's decoder) "
        f"{py_us:.2f}; golden/bls.py with its subgroup checks {golden_us:.2f} (over the "
        f"{len(pks)} + {len(sigs)} distinct blobs)")
    return {"native_us": main_us, "python_us": py_us, "golden_us": golden_us}


def codec_valid_pairs(torch, pk_jac, sig_jac):
    """The native batch codec on wire traffic: the keys' derived pubkeys
    and their signatures compressed, each distinct one once (all valid:
    in the subgroup, none the infinity).  Every status ok and every point
    the one the card computed; host µs per element of the native decode
    to device batches, and of the Python decodes on the first 64 of each
    (golden/codec.py with no subgroup check, golden/bls.py with it)."""
    from bls_verify_gadget_tpu_torch import native_codec as NC
    from bls_verify_gadget_tpu_torch.golden import bls as gbls
    from bls_verify_gadget_tpu_torch.golden import codec
    from bls_verify_gadget_tpu_torch.models.bls import encode_pubkeys, encode_signatures
    from bls_verify_gadget_tpu_torch.ops import curve as CV

    res = {}
    for name, pts, compress, decode, encode, py, golden in (
            ("pubkeys", CV.g1_decode(pk_jac), codec.g1_compress, NC.decode_pubkeys,
             encode_pubkeys, codec.g1_decompress, gbls.g1_decompress),
            ("signatures", CV.g2_decode(sig_jac), codec.g2_compress, NC.decode_signatures,
             encode_signatures, codec.g2_decompress, gbls.g2_decompress)):
        pts = list(dict.fromkeys(p for p in pts if p is not None))
        wire = [compress(p) for p in pts]
        t0 = time.perf_counter()
        batch, status = decode(wire)
        torch.cuda.synchronize()
        native_us = (time.perf_counter() - t0) / len(wire) * 1e6
        if status.any():
            raise RuntimeError(f"native {name}: valid wire bytes rejected, statuses "
                               f"{collections.Counter(status.tolist())}")
        if max_err(batch, encode(pts)) != 0:
            raise RuntimeError(f"native {name}: the device batch differs from the card's points")
        few = wire[:64]
        if [golden(b) for b in few[:4]] != pts[:4]:
            raise RuntimeError(f"golden/bls.py {name}: decode differs from the card's points")
        res[name] = {"n": len(wire), "native_us": native_us, "python_us": host_us(py, few),
                     "golden_us": host_us(golden, few[:4])}
    pk, sig = res["pubkeys"], res["signatures"]
    log(f"[parallel] codec on wire traffic ({pk['n']} distinct valid pubkeys, {sig['n']} "
        f"distinct valid signatures: the keys' own, compressed), every status ok and every "
        f"point the card's; host µs per element, pubkey / signature / (pk, sig): native batch "
        f"decode to device batches {pk['native_us']:.2f} / {sig['native_us']:.2f} / "
        f"{pk['native_us'] + sig['native_us']:.2f}; Python decode (golden/codec.py, no "
        f"subgroup check, over 64 each) {pk['python_us']:.2f} / {sig['python_us']:.2f} / "
        f"{pk['python_us'] + sig['python_us']:.2f}; golden/bls.py with its subgroup checks "
        f"(over 4 each) {pk['golden_us']:.2f} / {sig['golden_us']:.2f} / "
        f"{pk['golden_us'] + sig['golden_us']:.2f}")
    return res


BATCH_DIMS_ROUNDS = 10  # (parent, change, change, parent) rounds of verify at BATCH


def parent_package(K, parent_dir):
    """The parent commit's package (a git archive in parent_dir) imported
    beside this tree's as parent_bls_verify_gadget_tpu_torch -> its
    models.bls.  Its kernel library is looked up in this tree's build/:
    when its sources are this tree's it is the same file, loaded once;
    else it is built there under its own name."""
    import importlib
    import importlib.util

    root = pathlib.Path(parent_dir).resolve()
    if not root.is_relative_to(ROOT):
        raise RuntimeError(f"--parent: {root} lies outside the checkout {ROOT}")
    src = root / "bls_verify_gadget_tpu_torch"
    name = "parent_bls_verify_gadget_tpu_torch"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, src / "__init__.py", submodule_search_locations=[str(src)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
        importlib.import_module(f"{name}.ops.kernels").BUILD_DIR = K.BUILD_DIR
    return importlib.import_module(f"{name}.models.bls")


def batch_dims_cost(torch, K, bls, pk, sig, msg, want, parent_dir=None):
    """What the leading batch dims cost a verify at BATCH: the host µs of
    models/bls.py's _batch, _flat and _unflat, called on the main path's
    operands as verify and its stages call them; with --parent DIR,
    BatchedBLS.verify of the parent commit's package (1-D only) and of
    this tree's on the same operands, both every result as expected, the
    walls interleaved (parent, change, change, parent)."""
    from bls_verify_gadget_tpu_torch.models import bls as M

    h = bls.hash_stage(msg, MSG_LEN)
    f, ok = bls.miller_stage(pk, sig, h)
    torch.cuda.synchronize()

    def shape_handling():
        M._batch(pk_aff=(pk, 1), sig_aff=(sig, 1), msg_u8=(msg, 1), msg_lens=(None, 0))
        batch = tuple(msg.shape[:-1])  # hash_stage
        M._flat(msg, batch)
        M._unflat(h, batch)
        batch = M._batch(pk_aff=(pk, 1), sig_aff=(sig, 1), h_aff=(h, 1))  # miller_stage
        M._flat(pk, batch)
        M._flat(sig, batch)
        M._flat(h, batch)
        M._unflat((f, ok), batch)
        batch = M._batch(f=(f, 1), checks_ok=(ok, 0))  # finalexp_stage
        M._flat((f, ok), batch)
        M._unflat(ok, batch)

    reps = 2000
    shape_handling()
    t0 = time.perf_counter()
    for _ in range(reps):
        shape_handling()
    host_us_per_verify = (time.perf_counter() - t0) / reps * 1e6
    log(f"[parallel] leading batch dims: _batch/_flat/_unflat host µs per verify at {BATCH} "
        f"(as verify and its stages call them, {reps} reps): {host_us_per_verify:.3f}")
    res = {"shape_us": host_us_per_verify}
    if not parent_dir:
        return res
    runs = {"parent": parent_package(K, parent_dir).BatchedBLS(device="cuda"), "change": bls}
    for who, b in runs.items():
        out = b.verify(pk, sig, msg, MSG_LEN)  # warm-up
        if not torch.equal(out, want):
            raise RuntimeError(f"{who} verify: {int((out != want).sum())} wrong results")
    walls = {"parent": [], "change": []}
    for _ in range(BATCH_DIMS_ROUNDS):
        for who in ("parent", "change", "change", "parent"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[who].verify(pk, sig, msg, MSG_LEN)
            torch.cuda.synchronize()
            walls[who].append((time.perf_counter() - t0) * 1e3)
    med = {who: sorted(w)[len(w) // 2] for who, w in walls.items()}
    log(f"[parallel] BatchedBLS.verify wall ms at {BATCH}, parent commit's package and this "
        f"tree's on the same operands, interleaved (parent, change, change, parent) x "
        f"{BATCH_DIMS_ROUNDS}: parent {[round(x, 3) for x in walls['parent']]} (median "
        f"{med['parent']:.3f}, min {min(walls['parent']):.3f}), change "
        f"{[round(x, 3) for x in walls['change']]} (median {med['change']:.3f}, min "
        f"{min(walls['change']):.3f}); change - parent median {med['change'] - med['parent']:+.3f} ms")
    return {**res, "walls": walls}


def nccl_world_one(torch, K, bls, pk, sig, msg, want):
    """sharded_verify, the staged form (its stages alone and chained) on a
    world of 1 over NCCL at BATCH: every result as expected, the launches
    of BatchedBLS.verify; the verify wall interleaved with the unsharded
    one (verify, sharded, sharded, verify)."""
    import torch.distributed as dist

    from bls_verify_gadget_tpu_torch.parallel import (
        make_mesh, make_sharded_verify, make_sharded_verify_staged, sharded_verify,
    )
    from bls_verify_gadget_tpu_torch.parallel.distributed import initialize
    from bls_verify_gadget_tpu_torch.parallel.launch import free_port

    initialize(f"localhost:{free_port()}", 1, 0, "cuda")
    try:
        if dist.get_backend() != "nccl":
            raise RuntimeError(f"world of 1 on {dist.get_backend()}, not NCCL")
        mesh = make_mesh(1)
        run = make_sharded_verify(bls, mesh, MSG_LEN)
        staged = make_sharded_verify_staged(bls, mesh, MSG_LEN)
        hash_fn, pair_fn = staged.stages
        forms = {
            "BatchedBLS.verify": lambda: bls.verify(pk, sig, msg, MSG_LEN),
            "sharded_verify": lambda: sharded_verify(bls, mesh, pk, sig, msg, MSG_LEN),
            "make_sharded_verify": lambda: run(pk, sig, msg),
            "staged, chained": lambda: staged(pk, sig, msg),
            "staged, its stages": lambda: pair_fn(pk, sig, hash_fn(msg)),
        }
        counts = {}
        for name, fn in forms.items():
            fn()  # warm-up
            K.COUNTS.reset()
            out = fn()
            torch.cuda.synchronize()
            counts[name] = dict(K.COUNTS.launches)
            if out.shape != want.shape or not torch.equal(out, want):
                raise RuntimeError(f"[parallel] {name} on NCCL world 1: wrong results")
        base = counts["BatchedBLS.verify"]
        off = [name for name, c in counts.items() if c != base]
        if off:
            raise RuntimeError(f"launches differ from BatchedBLS.verify's: {off}")
        off = {k: base[k] for k, (_, _, n) in KERNELS.items() if n is not None and base[k] != n}
        if off:
            raise RuntimeError(f"fused kernels launched other than on the main path: {off}")
        log(f"[parallel] NCCL world 1 at batch {BATCH}: {', '.join(forms)}: every result as "
            f"expected ({int(want.sum())} true), {sum(base.values())} port launches each")
        walls = {"verify": [], "sharded": []}
        for _ in range(TIMED_RUNS):
            for name in ("verify", "sharded", "sharded", "verify"):
                fn = forms["BatchedBLS.verify" if name == "verify" else "make_sharded_verify"]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        log(f"[parallel] NCCL world 1 verify wall ms, interleaved (verify, sharded, sharded, "
            f"verify) x {TIMED_RUNS}: unsharded {[round(x, 3) for x in walls['verify']]} "
            f"(median {med['verify']:.3f}), sharded {[round(x, 3) for x in walls['sharded']]} "
            f"(median {med['sharded']:.3f}); {BATCH / med['sharded'] * 1e3:.1f} "
            f"verifications/s sharded")
    finally:
        dist.destroy_process_group()
    return {"launches": sum(base.values()), "verify_ms": med["verify"],
            "sharded_ms": med["sharded"]}


def fold_of_slabs(torch, CV, ops, pts, ranks):
    """The parallel layer's fold computed here: CV.pt_sum of each rank's
    contiguous slab, then CV.pt_sum of the partials in rank order."""
    n = CV._coord_shape(ops, [pts])[0] // ranks
    parts = [CV.pt_sum(ops, take(pts, slice(r * n, (r + 1) * n)), 0) for r in range(ranks)]
    stacked = CV.unpack_point(ops, torch.stack([CV.pack_point(ops, batch_of_one(p))[:, 0]
                                                for p in parts], 1))
    return CV.pt_sum(ops, stacked, 0)


def limbs(pt):
    """A point (nested tuples of tensors) -> nested lists."""
    if isinstance(pt, tuple):
        return [limbs(c) for c in pt]
    return pt.tolist()


def parallel_rank(mesh, arg):
    """One Gloo rank of the parallel phase, on the card: its slab of the
    verify batch, of the keys and signatures and of the committee."""
    import torch
    import torch.distributed as dist

    from bls_verify_gadget_tpu_torch.models.bls import BatchedBLS
    from bls_verify_gadget_tpu_torch.parallel import (
        make_sharded_verify, sharded_aggregate_pubkeys, sharded_aggregate_signatures,
        sharded_masked_aggregate, sharded_masked_aggregate_verify,
    )

    data = torch.load(arg["data"], map_location=f"cuda:{torch.cuda.current_device()}")
    rank, world = dist.get_rank(), dist.get_world_size()

    def slab(x):
        if isinstance(x, tuple):
            return tuple(slab(c) for c in x)
        return x.chunk(world)[rank].contiguous()

    bls = BatchedBLS(device="cuda")
    run = make_sharded_verify(bls, mesh, MSG_LEN)
    pk, sig, msg = slab(data["pk"]), slab(data["sig"]), slab(data["msg"])
    walls = []
    for _ in range(1 + TIMED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(pk, sig, msg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        if not torch.equal(out, data["want"]):
            raise RuntimeError(f"rank {rank}: sharded verify: {int((out != data['want']).sum())} "
                               f"wrong results")
    res = {"slab": msg.shape[0], "verify_true": int(out.sum()), "verify_ms": walls}
    res["pk_sum"] = limbs(sharded_aggregate_pubkeys(mesh, slab(data["kpk"])))
    res["sig_sum"] = limbs(sharded_aggregate_signatures(mesh, slab(data["ksig"])))
    point, count = sharded_masked_aggregate(mesh, slab(data["cpk"]), slab(data["bitmap"]))
    res["masked"], res["count"] = limbs(point), int(count)
    res["masked_verify"] = []
    for bits in (data["bitmap"], data["bitmap_extra"]):
        ok, count = sharded_masked_aggregate_verify(bls, mesh, slab(data["cpk"]), slab(bits),
                                                    data["agg_sig"], data["agg_msg"], MSG_LEN)
        res["masked_verify"].append([bool(ok), int(count)])
    torch.cuda.synchronize()
    return res


def parallel_phase(torch, K, smi, keys=None, parent_dir=None):
    """The sharded layer and the native codec (see the module docstring,
    phase 12).  keys: keys_phase's result (the full run), else its keys,
    messages, pubkeys and signatures are made here.  parent_dir: --parent."""
    import tempfile

    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_scalars,
    )
    from bls_verify_gadget_tpu_torch.ops import curve as CV
    from bls_verify_gadget_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    cases = load_cases()
    codec = codec_checks(torch, cases)
    pk, sig, msg, want = encode_cases(torch, cases)
    bls = BatchedBLS(device="cuda")
    batch_dims_cost(torch, K, bls, pk, sig, msg, want, parent_dir)
    nccl = nccl_world_one(torch, K, bls, pk, sig, msg, want)

    # the keys phase's keys, signatures and committee; the committee signs one message
    if keys is None:  # --parallel: the keys phase did not run
        key_ints, msgs, _ = keys_data()
        sk, kmsg = encode_scalars(key_ints), encode_messages(msgs)
        keys = {"keys": key_ints, "sk": sk, "msg": kmsg, "pk": bls.derive_pubkeys(sk),
                "sig": bls.sign(sk, kmsg)[0]}
    sk, kpk, ksig = keys["sk"], keys["pk"], keys["sig"]
    codec["valid"] = codec_valid_pairs(torch, kpk, ksig)
    _, _, committee, bitmap = committee_of(torch, keys["keys"])
    cpk = take(kpk, committee)
    agg_msg = keys["msg"][:1]
    csig, _ = bls.sign(sk[committee], agg_msg.expand(COMMITTEE, -1).contiguous())
    agg = bls.aggregate_signatures(take(csig, bitmap.nonzero().squeeze(1)))
    agg_sig = CV.pt_to_affine(CV.FP2_OPS, batch_of_one(agg))
    extra = bitmap.clone()
    extra[int((~bitmap).nonzero()[0])] = True
    n_set = int(bitmap.sum())
    want_fold = {"pk_sum": fold_of_slabs(torch, CV, CV.FP_OPS, kpk, PARALLEL_RANKS),
                 "sig_sum": fold_of_slabs(torch, CV, CV.FP2_OPS, ksig, PARALLEL_RANKS)}
    masked = CV.pt_cmov(CV.FP_OPS, bitmap, cpk, CV.pt_infinity_like(CV.FP_OPS, cpk))
    want_fold["masked"] = fold_of_slabs(torch, CV, CV.FP_OPS, masked, PARALLEL_RANKS)
    unsharded, _ = bls.aggregate_pubkeys_masked(cpk, bitmap)

    def cpu(x):
        return tuple(cpu(c) for c in x) if isinstance(x, tuple) else x.cpu()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        path = pathlib.Path(tmp) / "inputs.pt"
        torch.save({"pk": cpu(pk), "sig": cpu(sig), "msg": cpu(msg), "want": cpu(want),
                    "kpk": cpu(kpk), "ksig": cpu(ksig), "cpk": cpu(cpk), "bitmap": cpu(bitmap),
                    "bitmap_extra": cpu(extra), "agg_sig": cpu(agg_sig),
                    "agg_msg": cpu(agg_msg)}, path)
        t0 = time.perf_counter()
        results = run_ranks(PARALLEL_RANKS, "chip_smoke:parallel_rank", {"data": str(path)},
                            device="cuda", backend="gloo", timeout=RANK_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
    for res in results:
        r = res["rank"]
        if res["slab"] != BATCH // PARALLEL_RANKS or res["verify_true"] != int(want.sum()):
            raise RuntimeError(f"rank {r}: sharded verify over {res['slab']} elements")
        for name, pt in want_fold.items():
            if res[name] != limbs(pt):
                raise RuntimeError(f"rank {r}: {name} is not limb-equal to the fold of the slabs")
        if res["count"] != n_set:
            raise RuntimeError(f"rank {r}: masked count {res['count']} != {n_set}")
        got = tuple(torch.tensor(c, dtype=torch.int32, device="cuda")[None] for c in res["masked"])
        if not bool(CV.pt_eq(CV.FP_OPS, got, batch_of_one(unsharded))[0]):
            raise RuntimeError(f"rank {r}: masked aggregate != aggregate_pubkeys_masked")
        if res["masked_verify"] != [[True, n_set], [False, n_set + 1]]:
            raise RuntimeError(f"rank {r}: sharded_masked_aggregate_verify gave "
                               f"{res['masked_verify']}")
    walls = [res["verify_ms"] for res in results]
    log(f"[parallel] {PARALLEL_RANKS} Gloo ranks on the one card (CUDA tensors), "
        f"{BATCH // PARALLEL_RANKS} elements each: sharded verify every result as expected on "
        f"every rank; verify wall ms per rank (first call, then {TIMED_RUNS}): "
        f"{[[round(x, 3) for x in w] for w in walls]}")
    log(f"[parallel] sharded_aggregate_pubkeys over {BATCH} keys, sharded_aggregate_signatures "
        f"over {BATCH} signatures and sharded_masked_aggregate over the {COMMITTEE}-key committee "
        f"({n_set} set) limb-equal to CV.pt_sum of the slabs' CV.pt_sum; masked count exact, "
        f"its point equal to aggregate_pubkeys_masked's; sharded_masked_aggregate_verify true, "
        f"false with one more bit ({n_set + 1}); ranks spawned and done in {ranks_s:.1f} s")
    log(f"[parallel] phase {time.perf_counter() - t_phase:.1f} s | {smi}")
    return {"codec": codec, "nccl": nccl, "ranks_s": ranks_s, "rank_verify_ms": walls}


# ----------------------------------------------------------------------------
# trace phase: named ranges, the op counter, check_subgroups
# ----------------------------------------------------------------------------

TRACE_RANGES = ("bls_hash_to_g2", "bls_validity_checks", "bls_miller_loop", "bls_final_exp")
CPU_BATCH = 4  # the CPU reference's batch; the card's counts at BATCH are BATCH / CPU_BATCH times
VERIFY_LAUNCHES = 118  # port launches of one default verify at BATCH ([main])
CPU_JOBS = ("verify", "verify_stepwise", "sign", "subgroups_off")


def off_subgroup_cases(cases):
    """-> (indices of the cases whose pk or sig lies outside its subgroup,
    by the golden curve's checks (the infinity counts as inside), and for
    each distinct (pk bytes, sig bytes, msg) among them the index of its
    first case)."""
    from bls_verify_gadget_tpu_torch.golden import curve as GC

    g1, g2, off, first = {}, {}, [], {}
    for i, (pk, sig, msg, _, pk_raw, sig_raw) in enumerate(cases):
        if pk_raw not in g1:
            g1[pk_raw] = pk is None or GC.g1_in_subgroup(pk)
        if sig_raw not in g2:
            g2[sig_raw] = sig is None or GC.g2_in_subgroup(sig)
        if not (g1[pk_raw] and g2[sig_raw]):
            off.append(i)
            first.setdefault((pk_raw, sig_raw, msg), i)
    return off, first


def cpu_reference(job, path):
    """One CPU reference of the trace phase, run in a child process with
    CUDA hidden, one torch thread and the lowest priority: for "verify",
    "verify_stepwise" (fuse_miller and fuse_expx off) and "sign" the
    port's op counts of that call on the CPU at CPU_BATCH elements (the
    main batch's first cases, the keys phase's first keys); for
    "subgroups_off" verify with config.check_subgroups off on the first
    case of each distinct off-subgroup (pk, sig, msg) of the main batch.
    Writes {"job", "counts" or "results", "s"} as JSON to `path`."""
    import os

    import torch

    os.nice(19)
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT))
    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_pubkeys, encode_scalars, encode_signatures,
    )
    from bls_verify_gadget_tpu_torch.utils.config import config
    from bls_verify_gadget_tpu_torch.utils.profiling import count_ops

    t0 = time.perf_counter()
    bls = BatchedBLS(device="cpu")
    out = {"job": job}
    if job == "sign":
        keys, msgs, _ = keys_data()
        with count_ops() as c:
            bls.sign(encode_scalars(keys[:CPU_BATCH], device="cpu"),
                     encode_messages(msgs[:CPU_BATCH], device="cpu"), MSG_LEN)
        out["counts"] = dict(c.counts)
    else:
        cases = load_cases()
        if job == "subgroups_off":
            _, first = off_subgroup_cases(cases)
            sub = [cases[i] for i in first.values()]
            config.check_subgroups = False
        else:
            sub = cases[:CPU_BATCH]
            config.fuse_miller = config.fuse_expx = job == "verify"
        with count_ops() as c:
            res = bls.verify(encode_pubkeys([x[0] for x in sub], device="cpu"),
                             encode_signatures([x[1] for x in sub], device="cpu"),
                             encode_messages([x[2] for x in sub], device="cpu"), MSG_LEN)
        if job == "subgroups_off":
            out["results"] = {str(i): bool(r) for i, r in zip(first.values(), res.tolist())}
        else:
            out["counts"] = dict(c.counts)
    out["s"] = time.perf_counter() - t0
    pathlib.Path(path).write_text(json.dumps(out))


def cpu_reference_start():
    """Start the CPU references (cpu_reference), one child process each, in
    a new temporary directory -> {job: (process, output path, log path)}."""
    import os
    import tempfile

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_trace_"))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.cpu_reference(sys.argv[2], sys.argv[3])")
    procs = {}
    for job in CPU_JOBS:
        out, log_path = tmp / f"{job}.json", tmp / f"{job}.log"
        with open(log_path, "w") as log_file:
            proc = subprocess.Popen([sys.executable, "-c", code, str(ROOT), job, str(out)],
                                    env=env, stdout=log_file, stderr=subprocess.STDOUT)
        procs[job] = (proc, out, log_path)
    return procs


def cpu_reference_results(procs, limit_s=600):
    """Wait for the CPU references -> {job: their JSON}; a failed or late
    child fails the phase."""
    deadline = time.perf_counter() + limit_s
    out = {}
    for job, (proc, path, log_path) in procs.items():
        try:
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            raise RuntimeError(f"[trace] CPU reference {job} outlived {limit_s} s")
        if proc.returncode != 0:
            raise RuntimeError(f"[trace] CPU reference {job} failed (exit {proc.returncode}): "
                               f"{log_path.read_text()[-2000:]}")
        out[job] = json.loads(path.read_text())
    shutil.rmtree(path.parent)
    return out


def trace_ranges(trace):
    """Per JAX range name in a torch.profiler Chrome trace: how many host
    ranges it has, and of the last: its wall ms, the device ms and launches
    (port kernels, other kernels) of the kernels launched inside it (a
    kernel joined to its launch by the correlation id), and the device span
    of its GPU annotation where the trace has one."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    kernels = {e["args"]["correlation"]: e for e in events
               if e.get("cat") == "kernel" and "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in kernels]
    out = {}
    for name in TRACE_RANGES:
        named = sorted((e for e in events if e.get("name") == name), key=lambda e: e["ts"])
        host = [e for e in named if e.get("cat") != "gpu_user_annotation"]
        gpu = [e for e in named if e.get("cat") == "gpu_user_annotation"]
        row = {"host": len(host), "wall_ms": 0.0, "port_ms": 0.0, "port_n": 0, "glue_ms": 0.0,
               "glue_n": 0, "span_ms": gpu[-1]["dur"] / 1e3 if gpu else None}
        if host:
            ev = host[-1]
            row["wall_ms"] = ev["dur"] / 1e3
            a, b = ev["ts"], ev["ts"] + ev["dur"]
            for launch in launches:
                if launch["tid"] == ev["tid"] and a <= launch["ts"] <= b:
                    kern = kernels[launch["args"]["correlation"]]
                    key = "port" if PORT_KERNEL_NAME.search(kern["name"]) else "glue"
                    row[f"{key}_ms"] += kern["dur"] / 1e3
                    row[f"{key}_n"] += 1
        out[name] = row
    return out


def trace_phase(torch, K, smi, cpu_ref, ctx=None, want=None, keys=None):
    """Named ranges, the op counter and check_subgroups on the main path's
    batch (module docstring, phase 13).  cpu_ref: the running CPU
    references (cpu_reference_start); ctx, want, keys: the main and keys
    phases' data (the full run), else made here.  The configuration is
    restored however the phase ends."""
    import tempfile

    from bls_verify_gadget_tpu_torch.models.bls import (
        BatchedBLS, encode_messages, encode_scalars,
    )
    from bls_verify_gadget_tpu_torch.utils import profiling
    from bls_verify_gadget_tpu_torch.utils.config import config

    t_phase = time.perf_counter()
    cases = load_cases()
    if ctx is None:  # --trace: the main and keys phases did not run
        pk, sig, msg, want = encode_cases(torch, cases)
        keys_host, msgs, _ = keys_data()
        sk, sign_msg = encode_scalars(keys_host), encode_messages(msgs)
    else:
        pk, sig, msg = ctx["pk"], ctx["sig"], ctx["msg"]
        sk, sign_msg = keys["sk"], keys["msg"]
    bls = BatchedBLS(device="cuda")

    def verify():
        return bls.verify(pk, sig, msg, MSG_LEN)

    def checked(label, out):
        if not torch.equal(out, want):
            raise RuntimeError(f"[trace] {label}: {int((out != want).sum())} wrong results")

    checked("warm-up verify", verify())
    log(f"[trace] NVTX ranges beside the profiler's: {profiling._nvtx_in_use()}")

    # the four JAX range names in a profiled verify: the second of two (the
    # tracer drops the first kernels after it starts: the hash range of a
    # lone profiled verify joined 9 of its 19 launches)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        with profiling.profile_trace(tmp):
            verify()
            out = verify()
            torch.cuda.synchronize()
        trace = json.loads((pathlib.Path(tmp) / "trace.json").read_text())
    checked("profiled verify", out)
    ranges = trace_ranges(trace)
    missing = [n for n, row in ranges.items() if row["host"] != 2]
    if missing:
        raise RuntimeError(f"[trace] the profiled verifies' trace lacks the ranges {missing}")
    for name, row in ranges.items():
        span = "not measured" if row["span_ms"] is None else f"{row['span_ms']:.3f} ms"
        log(f"[trace] range {name}: wall {row['wall_ms']:.3f} ms (host, as issued); kernels "
            f"launched inside: port {row['port_ms']:.3f} ms over {row['port_n']} launches, "
            f"other {row['glue_ms']:.3f} ms over {row['glue_n']}; device span {span} | {smi}")
    if not any(row["port_n"] for row in ranges.values()):
        log("[trace] device ms per range: not measured (no kernel joined to a launch)")

    # no counter, no cost: launches and wall of plain verifies
    walls, plain = [], None
    for i in range(TIMED_RUNS):
        K.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = verify()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        checked(f"verify {i}", out)
        plain = plain or dict(K.COUNTS.launches)
    if sum(plain.values()) != VERIFY_LAUNCHES:
        raise RuntimeError(f"[trace] verify without a counter: {sum(plain.values())} launches, "
                           f"want {VERIFY_LAUNCHES}")
    wall = sorted(walls)[len(walls) // 2]

    # the card's counts at BATCH against the CPU's at CPU_BATCH
    cpu = cpu_reference_results(cpu_ref)
    scale = BATCH // CPU_BATCH
    log(f"[trace] CPU references (one thread each, CUDA hidden): "
        + ", ".join(f"{job} {cpu[job]['s']:.1f} s" for job in CPU_JOBS))

    def card_counts(label, fn, job):
        K.COUNTS.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profiling.count_ops() as c:
            result = fn()
        torch.cuda.synchronize()
        counted_s = time.perf_counter() - t0
        launches = dict(K.COUNTS.launches)
        want_counts = {k: v * scale for k, v in cpu[job]["counts"].items()}
        if dict(c.counts) != want_counts:
            raise RuntimeError(f"[trace] {label}: card counts {dict(c.counts)} at {BATCH}, want "
                               f"{scale} x the CPU's at {CPU_BATCH}: {want_counts}")
        log(f"[trace] {label} at {BATCH}: counts {dict(sorted(c.counts.items()))} = {scale} x "
            f"the CPU's at {CPU_BATCH}; {c.fp_mul_equivalent() / BATCH:.1f} Fp-mul-equivalents "
            f"per element; {sum(launches.values())} launches; counted run {counted_s * 1e3:.3f} "
            f"ms, {c.fp_mul_equivalent() / counted_s:.6e} Fp-mul-equivalents/s | {smi}")
        return result, c, launches

    out, c, launches = card_counts("verify", verify, "verify")
    checked("counted verify", out)
    if launches != plain:
        raise RuntimeError(f"[trace] the counter changed verify's launches: {launches} "
                           f"against {plain}")
    log(f"[trace] verify wall without a counter: median {wall * 1e3:.3f} ms "
        f"({[round(w * 1e3, 3) for w in walls]}), {VERIFY_LAUNCHES} launches with and without "
        f"the counter; sustained {c.fp_mul_equivalent() / wall:.6e} Fp-mul-equivalents/s | {smi}")
    (_, valid), c, _ = card_counts("sign", lambda: bls.sign(sk, sign_msg, MSG_LEN), "sign")
    if int(valid.sum()) != BATCH - 1:
        raise RuntimeError(f"[trace] sign: {int(valid.sum())} valid keys, want {BATCH - 1}")
    saved = (config.fuse_miller, config.fuse_expx, config.check_subgroups)
    try:
        config.fuse_miller = config.fuse_expx = False
        checked("step-wise warm-up verify", verify())
        out, _, _ = card_counts("step-wise verify", verify, "verify_stepwise")
        checked("counted step-wise verify", out)
        config.fuse_miller, config.fuse_expx = saved[:2]

        # check_subgroups off
        config.check_subgroups = False
        verify()
        off_walls = []
        for i in range(TIMED_RUNS):
            K.COUNTS.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = verify()
            torch.cuda.synchronize()
            off_walls.append(time.perf_counter() - t0)
            if i == 0:
                off_launches = dict(K.COUNTS.launches)
    finally:
        config.fuse_miller, config.fuse_expx, config.check_subgroups = saved
    if off_launches["pt_mul_const"]:
        raise RuntimeError(f"[trace] check_subgroups off: {off_launches['pt_mul_const']} "
                           f"pt_mul_const launches")
    off, first = off_subgroup_cases(cases)
    ref = cpu["subgroups_off"]["results"]
    key_of = {i: (c[4], c[5], c[2]) for i, c in enumerate(cases)}
    want_off = want.tolist()
    for i in off:
        want_off[i] = ref[str(first[key_of[i]])]
    want_off = torch.tensor(want_off, device="cuda")
    if not torch.equal(out, want_off):
        raise RuntimeError(f"[trace] check_subgroups off: {int((out != want_off).sum())} results "
                           f"differ from the flag-on ones (in-subgroup elements) and the CPU's "
                           f"flag-off ones (the rest)")
    off_wall = sorted(off_walls)[len(off_walls) // 2]
    log(f"[trace] check_subgroups off at {BATCH}: {len(off)} elements with a point outside "
        f"its subgroup ({len(first)} distinct, {sum(ref.values())} of them true flag off, as "
        f"the CPU's flag-off verify), the other {BATCH - len(off)} as flag on; "
        f"{sum(off_launches.values())} launches against {VERIFY_LAUNCHES} (pt_mul_const 0 "
        f"against 3); wall median {off_wall * 1e3:.3f} ms against {wall * 1e3:.3f} "
        f"({[round(w * 1e3, 3) for w in off_walls]}) | {smi}")
    log(f"[trace] phase {time.perf_counter() - t_phase:.1f} s | {smi}")


def main():
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="On-card smoke run of the PyTorch/CUDA port.")
    only = ap.add_mutually_exclusive_group()
    only.add_argument("--group", action="store_true",
                      help="run only the device, build and group phases (the group kernels, "
                           "pow_win and pt_mul_var)")
    only.add_argument("--field", action="store_true",
                      help="run only the device, build and field phases (mul, add, sub, "
                           "fp2_mul and fp2_sqr)")
    only.add_argument("--r1cs", action="store_true",
                      help="run only the device, build and r1cs phases, then lc_dot's and "
                           "the R1CS path's field kernels' checks against their plain versions")
    only.add_argument("--parallel", action="store_true",
                      help="run only the device, build and parallel phases (the sharded layer "
                           "on NCCL at world size 1 and on two Gloo ranks of the card, and the "
                           "native batch codec)")
    only.add_argument("--trace", action="store_true",
                      help="run only the device, build and trace phases (named ranges, the op "
                           "counter against the CPU's, check_subgroups off)")
    ap.add_argument("--parent", metavar="DIR",
                    help="a git archive of the parent commit in a git-ignored directory of "
                         "this checkout: time its miller_dbl_run, miller_add, exp_x, "
                         "fp12_mul, fp6_mul, fp12_sqr, pt_mul_const, g2_cofactor, "
                         "sswu_map2, pow_win, pt_mul_var, mul014, cyclo_sqr, dbl_step, "
                         "add_step, pt_add and pt_dbl kernels interleaved with this tree's in the group "
                         "phase, its mul, add, sub, fp2_mul and fp2_sqr in the field "
                         "phase, and its BatchedBLS.verify at 4096 in the parallel phase")
    args = ap.parse_args()
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
    # the phases that run
    groups = not (args.field or args.r1cs or args.parallel or args.trace)
    fields = not (args.group or args.r1cs or args.parallel or args.trace)
    sweep = sweep_build_start(K) if groups else {}
    field_sweep = field_build_start(K) if fields else {}
    parent = parent_build_start(K, args.parent, groups, fields) if args.parent else {}
    parent_group = {u: b for u, b in parent.items() if u != "field"}
    cpu_ref = {}
    try:
        build_phase(K)
        if args.group:
            group_phase(torch, K, sweep, parent_group, args.parent)
        elif args.field:
            field_phase(torch, K, field_sweep, parent.get("field"))
        elif args.r1cs:
            r1cs_only(torch, K, smi)
        elif args.parallel:
            parallel_phase(torch, K, smi, parent_dir=args.parent)
        elif args.trace:
            cpu_ref = cpu_reference_start()
            trace_phase(torch, K, smi, cpu_ref)
        else:
            launches, sizes, verify_s, parts, want, ctx = main_path_phase(torch, K)
            profile_phase(torch, parts, ctx["msg"], want, verify_s)
            keys = keys_phase(torch, K)
            mixed = mixed_phase(torch, K, ctx, want, keys, launches)
            steps = steps_phase(torch, K, ctx, want, launches, keys)
            r1cs = r1cs_phase(torch, K, smi)
            # the trace phase's CPU references run beside the device-timed phases
            cpu_ref = cpu_reference_start()
            rows = kernel_phase(torch, K, launches, sizes, verify_s, ctx, keys, steps, mixed,
                                r1cs)
            del r1cs
            group = group_phase(torch, K, sweep, parent_group, args.parent)
            staged = field_phase(torch, K, field_sweep, parent.get("field"))
            for row in rows:
                if row["name"] in group:
                    row["group"] = group[row["name"]]
                if row["name"] in staged:
                    row["field"] = staged[row["name"]]
            parallel_phase(torch, K, smi, keys, args.parent)
            trace_phase(torch, K, smi, cpu_ref, ctx, want, keys)
            print(json.dumps({"kernels": rows}))
    finally:  # a phase that failed leaves no nvcc of the sweeps or the parent, and no
        # CPU reference, running
        for proc, _, _ in [*sweep.values(), *field_sweep.values(), *parent.values(),
                           *cpu_ref.values()]:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A model on Python ints of the staged field kernels of
bls_verify_gadget_tpu_torch/csrc/field_kernels.cu, sub and fp2_mul.

fp2_mul: each element on 4 lanes, its three Karatsuba products (a0 b0, a1
b1 and the unreduced sums (a0 + a1)(b0 + b1)) the lane-split Montgomery
product of tests/test_torch_pow_lanes.py (lanes.cuh mont_mul_slices, in
lockstep: the order of independent steps does not change a value), the
differences on the lanes' slices, the borrows and the correction's
carries across lanes by lookahead (field_kernels.cu sub_slice); the
one-thread body of a -DBLS_FP2_MUL_LANES=1 sweep build on whole words
(field.cuh mont_mul, mod_sub).  Both held against the JAX package's golden
fp2_mul on seeded inputs below p and on edge inputs (0, 1, p - 1, the
Montgomery one, operand sums just below 2p, and a v0 - v1 whose borrow
ripples across every lane).

The staged tiling of both kernels (field.cuh stage_rows / unstage_rows, the
kernels' element and tail logic, the entry points' grid of n / E blocks):
at n = 1, 4095, 4096, 8191 and 8193 and every elements-per-block count E
of chip_smoke.py's sweep builds (the library's among them), every int4 of
a block's span is staged once, every element's
output rows are written exactly once and computed from its own input rows,
and a tail element's threads read a live element's row; for Fp and Fr rows
(sub) and Fp rows on 4 lanes (fp2_mul).  The padded shared-memory stride
gives the per-row reads no bank conflicts.  Tolerance 0."""

import pathlib
import re

import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch.ops import kernels as K
from test_torch_pow_lanes import NW, RINV, lookahead, mont_mul_lanes, value, words

LANES = 4  # lanes per fp2_mul element (field_kernels.cu BLS_FP2_MUL_LANES)
PER_BLOCK = (8, 16, 32, 64)  # E of chip_smoke.py's sweep builds (FIELD_E)
S = NW // LANES
ONE = C.MONT_R_MOD_P  # 1 in Montgomery form
TOP = 1 << (32 * NW)
COUNTS = (1, 4095, 4096, 8191, 8193)
STAGED = {"sub Fp": (12, 1), "sub Fr": (8, 1), "fp2_mul": (12, LANES)}  # (NW, lanes)
CSRC = pathlib.Path(K.CSRC_DIR)


def stride(nw):
    """field.cuh kStagedStride: int32 per staged row."""
    return 2 * nw + 4


def mod_sub(a, b):
    """field.cuh mod_sub on whole words: d = a - b mod 2^384, then d + p
    where a < b."""
    d = (a - b) % TOP
    return (d + C.P) % TOP if a < b else d


def sub_slices(a, b):
    """field_kernels.cu sub_slice<4>: (a - b) mod p on the lanes' slices.
    -> (the result, the borrow into each lane, a < b)."""
    top = 1 << (32 * S)
    aw, bw, pw = words(a), words(b), words(C.P)
    diff = [value(aw[j * S:(j + 1) * S]) - value(bw[j * S:(j + 1) * S]) for j in range(LANES)]
    d = [x % top for x in diff]
    bin_, under = lookahead([x < 0 for x in diff], [x == 0 for x in d])
    d = [(x - b_) % top for x, b_ in zip(d, bin_)]
    e = [x + value(pw[j * S:(j + 1) * S]) for j, x in enumerate(d)]
    cin, _ = lookahead([x >= top for x in e], [x % top == top - 1 for x in e])
    e = [(x + c) % top for x, c in zip(e, cin)]
    r = e if under else d
    return value([w for x in r for w in words(x, S)]), bin_, under


def fp2_mul_model(a, b, lanes):
    """field_kernels.cu fp2_mul_kernel's arithmetic: three canonical
    Montgomery products, then c0 = v0 - v1, c1 = (v2 - v0) - v1; on 4
    lanes the lane products and the differences split across the lanes,
    on 1 lane whole-word products and differences."""
    (a0, a1), (b0, b1) = a, b
    if lanes == LANES:
        prod, sub = (lambda x, y: mont_mul_lanes(x, y, LANES)), (lambda x, y: sub_slices(x, y)[0])
    else:
        prod, sub = (lambda x, y: x * y * RINV % C.P), mod_sub
    v0, v1 = prod(a0, b0), prod(a1, b1)
    v2 = prod(a0 + a1, b0 + b1)  # the sums below 2p
    return sub(v0, v1), sub(sub(v2, v0), v1)


def golden(a, b):
    """The golden Fp2 product of Montgomery-form pairs, in Montgomery form."""
    c = GF.fp2_mul((a[0] * RINV % C.P, a[1] * RINV % C.P), (b[0] * RINV % C.P, b[1] * RINV % C.P))
    return c[0] * C.MONT_R % C.P, c[1] * C.MONT_R % C.P


@pytest.mark.parametrize("lanes", (LANES, 1))
def test_fp2_mul_lanes_matches_golden(lanes):
    rng = np.random.default_rng(110 + lanes)
    rand = [int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(64)]
    pairs = [((rand[i], rand[i + 1]), (rand[i + 2], rand[i + 3])) for i in range(0, 64, 4)]
    edges = (0, 1, C.P - 1, C.P - 2, ONE)  # (p - 1) + (p - 1) = 2p - 2
    pairs += [((x0, x1), (y0, y1)) for x0 in edges for x1 in edges
              for y0 in edges[::2] for y1 in edges[1::2]]
    for a, b in pairs:
        assert fp2_mul_model(a, b, lanes) == golden(a, b), (a, b)


@pytest.mark.parametrize("lanes", (LANES, 1))
def test_fp2_mul_borrow_ripples_across_every_lane(lanes):
    """b = (1, 1) in Montgomery form makes v0 = a0, v1 = a1; a1 = a0 + 1
    makes v0 - v1 = -1: lane 0 borrows and the borrow passes every lane
    above it out of the top, and p is added back."""
    x = int.from_bytes(np.random.default_rng(113).bytes(48), "little") % (C.P - 1)
    a, b = (x, x + 1), (ONE, ONE)
    _, borrows, under = sub_slices(x, x + 1)
    assert borrows == [0] + [1] * (LANES - 1) and under == 1
    c = fp2_mul_model(a, b, lanes)
    assert c[0] == C.P - 1 and c == golden(a, b)


def staged_run(n, per_block, nw, lanes):
    """field_kernels.cu's staged kernels over n elements, per_block (E)
    elements per block on `lanes` threads each, as index arithmetic: ->
    (the input element each output element was computed from, the times
    each output int4 was written)."""
    q_row, w = nw // 2, stride(nw)
    threads = per_block * lanes
    kiter = -(-per_block * q_row // threads)  # stage_rows' kIter
    source, writes = [None] * n, [0] * (n * q_row)
    for blk in range(-(-n // per_block)):
        first = blk * per_block
        if first >= n:
            continue
        rows = min(per_block, n - first)
        span = rows * q_row
        staged = {}  # shared int32 offset -> input int4
        for it in range(kiter):
            for tid in range(threads):
                g = tid + it * threads
                if g < span:
                    r = g // q_row
                    slot = r * w + 4 * (g - r * q_row)
                    assert slot not in staged
                    staged[slot] = first * q_row + g
        assert sorted(staged.values()) == list(range(first * q_row, first * q_row + span))
        result = {}  # staged row -> input element it was computed from
        for tid in range(threads):
            g = tid // lanes
            at = g if g < rows else rows - 1  # a tail element: a copy of a live one
            assert 0 <= at < rows
            ins = {staged[at * w + 4 * q] // q_row for q in range(q_row)}
            if g < rows:
                result[g] = ins.pop()
                assert not ins
        for it in range(kiter):
            for tid in range(threads):
                g = tid + it * threads
                if g < span:
                    r = g // q_row
                    writes[first * q_row + g] += 1
                    source[first + r] = result[r]
    return source, writes


@pytest.mark.parametrize("n", COUNTS)
@pytest.mark.parametrize("kernel", STAGED)
def test_staged_tiling_writes_each_element_once(kernel, n):
    nw, lanes = STAGED[kernel]
    for per_block in PER_BLOCK:
        source, writes = staged_run(n, per_block, nw, lanes)
        assert source == list(range(n)), (per_block, n)
        assert writes == [1] * (n * nw // 2), (per_block, n)


@pytest.mark.parametrize("kernel", STAGED)
def test_staged_row_reads_have_no_bank_conflicts(kernel):
    """Each quarter-warp (8 threads) reading int4 q of its element's staged
    row hits one group of 4 banks per distinct address (32 banks: 8 groups);
    the elements of a tail read the last live row, the same address."""
    nw, lanes = STAGED[kernel]
    w = stride(nw)
    for per_block in PER_BLOCK:
        for rows in (per_block, per_block - 3):
            for base in range(0, per_block * lanes, 8):
                for q in range(nw // 2):
                    addrs = {min(t // lanes, rows - 1) * w // 4 + q
                             for t in range(base, base + 8)}
                    assert len({a % 8 for a in addrs}) == len(addrs), (per_block, rows, q)
    # without the padding the same reads would conflict
    assert len({(t * 2 * nw // 4) % 8 for t in range(8)}) < 8


def test_model_constants_match_the_sources():
    """The model's stride and lanes are the sources', and the library's
    elements per block are among the modelled counts."""
    field_cuh = (CSRC / "field.cuh").read_text()
    unit = (CSRC / "field_kernels.cu").read_text()
    assert "constexpr int kStagedStride = 2 * NW + 4;" in field_cuh
    assert re.search(r"#define BLS_FP2_MUL_LANES %d\n" % LANES, unit)
    for define in ("BLS_SUB_PER_BLOCK", "BLS_FP2_MUL_PER_BLOCK"):
        assert int(re.search(r"#define %s (\d+)\n" % define, unit)[1]) in PER_BLOCK, define


def test_staged_wrappers_refuse_what_the_kernels_do_not_take():
    """An operand off a 16-byte boundary is refused (the CUDA path checks
    every operand and output with _check_aligned before the launch)."""
    rows = torch.zeros(4, 24, dtype=torch.int32)
    K._check_aligned("sub", [rows, rows[1:]])  # a 96-byte row keeps the alignment
    with pytest.raises(ValueError, match="16-byte"):
        K._check_aligned("fp2_mul", [rows.view(-1)[1:]])

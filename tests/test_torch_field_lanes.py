"""A model on Python ints of the staged field kernels of
bls_verify_gadget_tpu_torch/csrc/field_kernels.cu, mul, add, sub, fp2_mul
and fp2_sqr.

mul: in Fp each element on 4 lanes, the lane-split Montgomery product of
tests/test_torch_pow_lanes.py (lanes.cuh mont_mul_slice); in Fr and in a
-DBLS_MUL_LANES=1 sweep build one thread per element, field.cuh's CIOS
mont_mul on 32-bit words.  add: field.cuh mod_add on whole words, one
thread per element.  Both held against the JAX package's golden fp_mul and
fp_add in Fp (Python's modular arithmetic in Fr, which has no golden
field) on seeded inputs and on edge rows: 2^384 - 1 by R^2 and by R^3, 2p
- 1 by 2p - 1, 0, 1, p - 1 and the Montgomery one, a product whose
deferred carry ripples across every lane it can cross; (p - 1) + (p - 1),
(p - 1) + 1 = p -> 0, 0 + 0.

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

fp2_sqr: each element on 4 lanes, its two products c0 = (a0 + a1)(a0 + p
- a1) and c1 = (2 a1) a0, every factor below 2p, the lane-split product in
lockstep (mont_mul_slices, N = 2); the one-thread body of a
-DBLS_FP2_SQR_LANES=1 sweep build the same products on whole words.  Both
held against the JAX package's golden fp2_sqr on seeded inputs and on
edge rows: a0 = a1, a0 = 0 with a1 = p - 1, a0 = a1 = p - 1 (the sum 2p -
2), the Montgomery one, a row whose JAX doubling 2 mont(a0, a1) crosses p,
a row whose c1 product carries across every lane it can.

The staged tiling of the five kernels (field.cuh stage_rows / unstage_rows,
the kernels' element and tail logic, the entry points' grid of n / E
blocks):
at n = 1, 4095, 4096, 8191 and 8193 and every elements-per-block count E
of chip_smoke.py's sweep builds (the library's among them), every int4 of
a block's span is staged once, every element's
output rows are written exactly once and computed from its own input rows,
and a tail element's threads read a live element's row; for Fp and Fr rows
on one thread (add, sub, mul in Fr) and Fp rows on 4 lanes (mul,
fp2_mul).  The padded shared-memory stride
gives the per-row reads no bank conflicts.  Tolerance 0."""

import pathlib
import re

import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch.ops import kernels as K
from test_torch_pow_lanes import (
    NW, R, RINV, carry_pass, lane_rows, lookahead, mont_mul_lanes, value, words)

LANES = 4  # lanes per Fp mul and fp2_mul element (BLS_MUL_LANES, BLS_FP2_MUL_LANES)
PER_BLOCK = (8, 16, 32, 64)  # E of chip_smoke.py's sweep builds (FIELD_E)
S = NW // LANES
ONE = C.MONT_R_MOD_P  # 1 in Montgomery form
TOP = 1 << (32 * NW)
COUNTS = (1, 4095, 4096, 8191, 8193)
STAGED = {"mul Fp": (12, LANES), "mul Fr": (8, 1), "add Fp": (12, 1), "add Fr": (8, 1),
          "sub Fp": (12, 1), "sub Fr": (8, 1), "fp2_mul": (12, LANES),
          "fp2_sqr": (12, LANES)}  # (NW, lanes)
FIELDS = {"Fp": (C.P, 12), "Fr": (C.R, 8)}  # modulus, 32-bit words
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


def fp2_sqr_model(a, lanes):
    """field_kernels.cu fp2_sqr_kernel's arithmetic: c0 = (a0 + a1)(a0 + p
    - a1) and c1 = (2 a1) a0, the sum, the unreduced difference and the
    double on whole words, every factor below 2p; two canonical Montgomery
    products, on 4 lanes the lane product, on 1 lane field.cuh's CIOS."""
    a0, a1 = a
    u, v = (a0 + a1, 2 * a1), (a0 + C.P - a1, a0)
    assert all(0 <= x < 2 * C.P for x in (*u, *v))
    if lanes == LANES:
        return tuple(mont_mul_lanes(x, y, LANES) for x, y in zip(u, v))
    return tuple(mont_mul_words(x, y, C.P, NW) for x, y in zip(u, v))


def fp2_sqr_golden(a):
    """The golden Fp2 square of a Montgomery-form pair, in Montgomery form."""
    c = GF.fp2_sqr((a[0] * RINV % C.P, a[1] * RINV % C.P))
    return c[0] * C.MONT_R % C.P, c[1] * C.MONT_R % C.P


def fp2_sqr_edges():
    """fp2_sqr's edge rows: a0 = a1 (c0 = 0), a0 = 0 with a1 = p - 1, a0 =
    a1 = p - 1 (the sum 2p - 2), 0, the Montgomery one, (one, one), (1, 0),
    (one, h) with mont(one, h) = (p + 1) / 2 (the JAX body's doubling of it
    crosses p: p + 1 -> 1), (one, ripple / 2): c1's product is the ripple
    row's (2 a1 = ((p >> 288) - 1) << 288 by the one), whose deferred carry
    crosses lanes 1 to 3 (ripple_row)."""
    x = int.from_bytes(np.random.default_rng(116).bytes(48), "little") % C.P
    h = (C.P + 1) // 2
    return [(x, x), (0, C.P - 1), (C.P - 1, C.P - 1), (0, 0), (ONE, 0), (ONE, ONE), (1, 0),
            (ONE, h), (ONE, ripple_row()[0] // 2)]


@pytest.mark.parametrize("lanes", (LANES, 1))
def test_fp2_sqr_matches_golden(lanes):
    rng = np.random.default_rng(117 + lanes)
    rows = [tuple(int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(2))
            for _ in range(32)]
    for a in rows + fp2_sqr_edges():
        assert fp2_sqr_model(a, lanes) == fp2_sqr_golden(a), a
    _, h = fp2_sqr_edges()[-2]
    assert 2 * (ONE * h * RINV % C.P) == C.P + 1  # the JAX doubling crosses p
    a, b = ripple_row()
    t, hw = lane_rows(a, b, LANES)
    top = 1 << (32 * S)
    v = [value(t[j]) + (hw[j - 1] if j else 0) for j in range(LANES)]
    cin, _ = lookahead([x >= top for x in v], [x % top == top - 1 for x in v])
    assert cin == [0, 0, 1, 1] and fp2_sqr_model((ONE, a // 2), LANES)[1] == a


def mont_mul_words(a, b, m, nw):
    """field.cuh mont_mul<NW>: CIOS on 32-bit words with 64-bit partial
    sums, t in NW + 2 words, one conditional subtraction of the low NW
    words (t[NW] must end 0)."""
    mask, n0 = (1 << 32) - 1, -pow(m, -1, 1 << 32) % (1 << 32)
    aw, bw, pw = words(a, nw), words(b, nw), words(m, nw)
    t = [0] * (nw + 2)
    for i in range(nw):
        c = 0
        for j in range(nw):
            c += aw[j] * bw[i] + t[j]
            assert c < 1 << 64
            t[j], c = c & mask, c >> 32
        c += t[nw]
        t[nw], t[nw + 1] = c & mask, c >> 32
        mq = t[0] * n0 & mask
        c = (mq * pw[0] + t[0]) >> 32
        for j in range(1, nw):
            c += mq * pw[j] + t[j]
            assert c < 1 << 64
            t[j - 1], c = c & mask, c >> 32
        c += t[nw]
        t[nw - 1], t[nw] = c & mask, t[nw + 1] + (c >> 32)
        assert t[nw] <= mask
    assert t[nw] == 0
    lo = value(t[:nw])
    return lo if lo < m else lo - m


def mod_add_words(a, b, m, nw):
    """field.cuh mod_add<NW>: s = a + b with its carry out, d = s - m; s
    where there is no carry and d borrows."""
    top = 1 << (32 * nw)
    s = a + b
    carry, s = s >= top, s % top
    return s if not carry and s < m else (s - m) % top


def mul_model(a, b, field, lanes):
    """mul_kernel's arithmetic: Fp on 4 lanes, else one thread."""
    m, nw = FIELDS[field]
    return mont_mul_lanes(a, b, LANES) if lanes == LANES else mont_mul_words(a, b, m, nw)


def ripple_row():
    """An Fp product whose deferred carry crosses every lane it can: the
    value (p >> 288) - 1 in lane 3, zeros below, by the Montgomery one.  Lane
    0 never generates a carry (no carry word below it); here lane 1 does and
    lane 2 passes it into lane 3 (chip_smoke.py's edge rows build the same)."""
    return ((C.P >> 288) - 1) << 288, ONE


def mul_edges(field):
    """mul's edge rows: raw full-width values by R^2 and R^3 (hash_to_field's
    folding), 0, 1, m - 1, the Montgomery one; in Fp also 2p - 1 squared
    (the largest Karatsuba sums) and the ripple row.  Fr has 4r > 2^256, so
    its sums below 2r are no operands of mul."""
    m, nw = FIELDS[field]
    top, one = 1 << (32 * nw), (1 << (32 * nw)) % m
    rows = [(top - 1, top * top % m), (top - 1, top**3 % m), (0, m - 1), (1, 1),
            (m - 1, m - 1), (m - 1, one), (one, one)]
    if field == "Fp":
        rows += [(2 * m - 1, 2 * m - 1), ripple_row()]
    return rows


def add_edges(field):
    """add's edge rows: (m - 1) + (m - 1); (m - 1) + 1 = m -> 0, a carry
    across every word; 0 + 0."""
    m = FIELDS[field][0]
    return [(m - 1, m - 1), (m - 1, 1), (1, m - 1), (0, 0)]


def seeded_rows(field, seed):
    """Canonical pairs, sums below 2m by canonical values (the Karatsuba
    operands; Fp only), full-width values by R^2."""
    m, nw = FIELDS[field]
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(4 * nw), "little") for _ in range(48)]
    rows = [(x % m, y % m) for x, y in zip(rand[:16], rand[16:32])]
    rows += [(x, (1 << (32 * nw)) ** 2 % m) for x in rand[32:]]
    if field == "Fp":
        rows += [(x % m + y % m, y % m) for x, y in zip(rand[:16], rand[32:])]
    return rows


def fp_golden(a, b, op):
    """The golden Fp product or sum of Montgomery-form operands (any
    representative), in Montgomery form."""
    x, y = a % C.P * RINV % C.P, b % C.P * RINV % C.P
    return op(x, y) * C.MONT_R % C.P


@pytest.mark.parametrize("field, lanes", (("Fp", LANES), ("Fp", 1), ("Fr", 1)))
def test_mul_matches_golden(field, lanes):
    """Fp on the lanes and on one thread; Fr on one thread (lanes.cuh is
    Fp-only)."""
    m, nw = FIELDS[field]
    rinv = pow(1 << (32 * nw), -1, m)
    for a, b in seeded_rows(field, 120 + lanes) + mul_edges(field):
        want = fp_golden(a, b, GF.fp_mul) if field == "Fp" else a * b * rinv % m
        assert mul_model(a, b, field, lanes) == want, (a, b)


@pytest.mark.parametrize("field", FIELDS)
def test_add_matches_golden(field):
    m, nw = FIELDS[field]
    for a, b in seeded_rows(field, 123)[:16] + add_edges(field):
        want = fp_golden(a, b, GF.fp_add) if field == "Fp" else (a + b) % m
        assert mod_add_words(a, b, m, nw) == want, (a, b)
    assert mod_add_words(m - 1, 1, m, nw) == 0


def test_mul_carry_ripples_across_every_lane():
    """The ripple row's deferred carries: lane 1 generates (its slice plus
    lane 0's carry word reaches 2^96), lane 2 passes it on (all ones), and
    the product is still the value."""
    a, b = ripple_row()
    t, h = lane_rows(a, b, LANES)
    top = 1 << (32 * S)
    v = [value(t[j]) + (h[j - 1] if j else 0) for j in range(LANES)]
    cin, _ = lookahead([x >= top for x in v], [x % top == top - 1 for x in v])
    assert cin == [0, 0, 1, 1]
    assert value([w for s in carry_pass(t, h)[0] for w in s]) == a
    assert mul_model(a, b, "Fp", LANES) == mul_model(a, b, "Fp", 1) == a
    assert a * b * RINV % C.P == a and R > a


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
    for define in ("BLS_MUL_LANES", "BLS_FP2_MUL_LANES", "BLS_FP2_SQR_LANES"):
        assert re.search(r"#define %s %d\n" % (define, LANES), unit), define
    for define in ("BLS_MUL_PER_BLOCK", "BLS_ADD_PER_BLOCK", "BLS_SUB_PER_BLOCK",
                   "BLS_FP2_MUL_PER_BLOCK", "BLS_FP2_SQR_PER_BLOCK"):
        assert int(re.search(r"#define %s (\d+)\n" % define, unit)[1]) in PER_BLOCK, define


def test_staged_wrappers_refuse_what_the_kernels_do_not_take(monkeypatch):
    """An operand off a 16-byte boundary is refused (the CUDA path checks
    every operand and output with _check_aligned before the launch): the
    mul, add, sub and fp2_sqr wrappers' launch refuses it before the
    library is loaded, and never falls back to the plain version."""
    rows = torch.zeros(4, 24, dtype=torch.int32)
    K._check_aligned("sub", [rows, rows[1:]])  # a 96-byte row keeps the alignment
    with pytest.raises(ValueError, match="16-byte"):
        K._check_aligned("fp2_mul", [rows.view(-1)[1:]])

    def loaded():
        raise LookupError("library loaded")

    monkeypatch.setattr(K, "_cuda_operands", lambda field, ts: [t.contiguous() for t in ts])
    monkeypatch.setattr(K, "library", loaded)
    from bls_verify_gadget_tpu_torch.ops.fp import FP

    off = torch.zeros(4 * 24 + 1, dtype=torch.int32)[1:].view(4, 24)
    for name in ("mul", "add", "sub"):
        for a, b in ((off, rows), (rows, off)):
            with pytest.raises(ValueError, match="16-byte"):
                K._binary_launch(name, FP, a, b)
        with pytest.raises(LookupError):  # aligned rows go on to the launch
            K._binary_launch(name, FP, rows, rows.clone())
    for a0, a1 in ((off, rows), (rows, off)):
        with pytest.raises(ValueError, match="16-byte"):
            K._fp2_sqr_launch(FP, a0, a1)
    with pytest.raises(LookupError):
        K._fp2_sqr_launch(FP, rows, rows.clone())

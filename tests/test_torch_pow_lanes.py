"""A model on Python ints of the lane-split Montgomery product of
bls_verify_gadget_tpu_torch/csrc/lanes.cuh, the product of the pow_win
kernel, and of that kernel's chain: the same word slices per lane (S = 12 /
L words), the same per-row chains with two carries, the quotient digit from
lane 0, the shift by one word with each lane's carries folded into its top
word and deferred to the end, the final pass (the carry word of the lane
below, then the carries and the borrows of the conditional subtraction
across lanes by carry-lookahead; left out where a chain's product may stay
below 2p).  Held at L = 2 and 4 against the JAX package's golden field
multiplication on
seeded inputs below 2p and on edge inputs (0, 1, p - 1, p, inputs near 2p,
low words all 0xFFFFFFFF), on the other domain of the mul kernel (a below
2^384, 2^384 - 1 among them, by R^2, R^3 and p - 1), with a carry that
ripples across every lane, and
the chain (the window table, 4-bit windows from the top digit, no product
for a zero digit) against pow() for both exponents of the port, e = p - 2
and (p - 11)/16, on two elements in Fp and in Fp2.  Tolerance 0."""

import numpy as np
import pytest

from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch.ops import kernels as K
from bls_verify_gadget_tpu_torch.ops.hash_to_g2 import SQRT_K

NW, MASK = 12, (1 << 32) - 1
R = 1 << 384
RINV = pow(R, -1, C.P)
N0 = -pow(C.P, -1, 1 << 32) % (1 << 32)
LANES = (2, 4)
EXPONENTS = {"p - 2": C.P - 2, "(p - 11)/16": SQRT_K}


def words(x, n=NW):
    return [(x >> (32 * k)) & MASK for k in range(n)]


def value(ws):
    return sum(w << (32 * k) for k, w in enumerate(ws))


def lookahead(g, p):
    """lanes.cuh lookahead: lane j generates a carry (g[j]) or passes one on
    (p[j]) -> (the carry into each lane, the carry out of the top lane)."""
    gm = sum(int(b) << j for j, b in enumerate(g))
    x = gm | sum(int(b) << j for j, b in enumerate(p))
    c = (x + gm) ^ x ^ gm
    return [(c >> j) & 1 for j in range(len(g))], (c >> len(g)) & 1


def carry_pass(t, h):
    """The deferred carries: each lane's slice t[j] (S words) plus the carry
    word of the lane below, then the 0/1 carries across lanes.  -> the
    slices and the carry out of the top lane (with the top lane's h)."""
    L, S = len(t), len(t[0])
    top = 1 << (32 * S)
    v = [value(t[j]) + (h[j - 1] if j else 0) for j in range(L)]
    g = [x >= top for x in v]
    v = [x % top for x in v]
    cin, cout = lookahead(g, [x == top - 1 for x in v])
    return [words((x + c) % top, S) for x, c in zip(v, cin)], cout + h[-1]


def cond_sub(t):
    """t - p where t >= p, lane by lane: each lane's borrow given none from
    below, the borrows across lanes by lookahead, the top lane's borrow out
    keeping t."""
    L, S = len(t), len(t[0])
    top = 1 << (32 * S)
    pw = words(C.P)
    diff = [value(t[j]) - value(pw[j * S:(j + 1) * S]) for j in range(L)]
    d = [x % top for x in diff]
    bin_, bout = lookahead([x < 0 for x in diff], [x == 0 for x in d])
    d = [words((x - b) % top, S) for x, b in zip(d, bin_)]
    return t if bout else d


def mont_mul_lanes(a, b, L, canonical=True):
    """lanes.cuh mont_mul<L, canonical>: a b R^-1 mod p for a, b < 2p, or
    for a < R and b < p (mul's raw halves by R^2 and R^3); below p, or
    below 2p without the conditional subtraction."""
    t, h = lane_rows(a, b, L)
    t, over = carry_pass(t, h)
    assert over == 0
    whole = value([w for s in t for w in s])
    assert whole < 2 * C.P and whole % C.P == a * b * RINV % C.P
    if not canonical:
        return whole
    r = value([w for s in cond_sub(t) for w in s])
    assert r == (whole - C.P if whole >= C.P else whole)
    return r


def lane_rows(a, b, L):
    """mont_mul_slices' 12 rows: -> each lane's slice and carry word before
    the deferred carries."""
    assert (0 <= a < 2 * C.P and 0 <= b < 2 * C.P) or (0 <= a < R and 0 <= b < C.P)
    S = NW // L
    aw, bw, pw = words(a), words(b), words(C.P)
    t, h = [[0] * S for _ in range(L)], [0] * L
    an0 = aw[0] * N0 & MASK
    for i in range(NW):
        m = (t[0][0] * N0 + an0 * bw[i]) & MASK  # lane 0's (t0 + a0 b[i]) n0
        w0, out = [], []
        for j in range(L):
            c1 = c2 = 0
            for k in range(S):
                x = aw[j * S + k] * bw[i] + t[j][k] + c1
                y = m * pw[j * S + k] + (x & MASK) + c2
                assert x <= 2**64 - 1 and y <= 2**64 - 1
                c1, c2 = x >> 32, y >> 32
                if k:
                    t[j][k - 1] = y & MASK
                else:
                    w0.append(y & MASK)
            out.append(c1 + c2)
        assert w0[0] == 0  # m clears lane 0's word 0
        for j in range(L):
            topw = (w0[j + 1] if j + 1 < L else 0) + h[j] + out[j]
            t[j][S - 1], h[j] = topw & MASK, topw >> 32
            assert h[j] <= 3
    return t, h


def val_mul(a, b, L):
    """lanes.cuh val_mul: Fp (ints, below 2p) or Fp2 (pairs, canonical) by
    Karatsuba."""
    if isinstance(a, int):
        return mont_mul_lanes(a, b, L, canonical=False)
    v0, v1 = mont_mul_lanes(a[0], b[0], L), mont_mul_lanes(a[1], b[1], L)
    v2 = mont_mul_lanes(a[0] + a[1], b[0] + b[1], L)
    return (v0 - v1) % C.P, (v2 - v0 - v1) % C.P


def val_sqr(a, L):
    if isinstance(a, int):
        return mont_mul_lanes(a, a, L, canonical=False)
    m = mont_mul_lanes(a[0], a[1], L)
    return mont_mul_lanes(a[0] + a[1], (a[0] - a[1]) % C.P, L), 2 * m % C.P


def pow_chain(a, exponent, L):
    """hash_kernels.cu pow_win_kernel: the table a^1 .. a^15 (f = f a), f
    the top digit's entry, per later window 4 squarings and, where the digit
    is not 0, f times its entry; in Fp the products below 2p and f made
    canonical at the end (lanes.cuh canonical)."""
    tab = [a]
    for _ in range(14):
        tab.append(val_mul(tab[-1], a, L))
    digits = K.pow_digits(exponent)
    f = tab[digits[0] - 1]
    for d in digits[1:]:
        for _ in range(4):
            f = val_sqr(f, L)
        if d:
            f = val_mul(f, tab[d - 1], L)
    return f - C.P if isinstance(f, int) and f >= C.P else f


def _edge_inputs():
    p = C.P
    return [0, 1, p - 1, p, p + 1, 2 * p - 2, 2 * p - 1, (1 << 352) - 1, (1 << 192) - 1,
            (1 << 96) - 1]


@pytest.mark.parametrize("L", LANES)
def test_lane_product_matches_golden(L):
    rng = np.random.default_rng(90 + L)
    rand = [int.from_bytes(rng.bytes(48), "little") % (2 * C.P) for _ in range(24)]
    edges = [x for x in _edge_inputs() if x < 2 * C.P]
    pairs = list(zip(rand[::2], rand[1::2])) + [(x, y) for x in edges for y in edges]
    for a, b in pairs:
        want = GF.fp_mul(a % C.P, b % C.P) * RINV % C.P
        assert mont_mul_lanes(a, b, L) == want
        lazy = mont_mul_lanes(a, b, L, canonical=False)
        assert lazy < 2 * C.P and lazy % C.P == want


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("b", ("R^2", "R^3", "p - 1"))
def test_lane_product_takes_full_width_by_canonical(L, b):
    """The mul kernel's second domain: a < 2^384 (the raw 384-bit halves of
    hash_to_field) by a canonical b (R^2 and R^3 mod p, which put them in
    Montgomery form; p - 1, the largest)."""
    y = {"R^2": R * R % C.P, "R^3": R**3 % C.P, "p - 1": C.P - 1}[b]
    rng = np.random.default_rng(97 + L)
    xs = [int.from_bytes(rng.bytes(48), "little") for _ in range(16)]
    xs += [R - 1, R - 2, 2 * C.P, (R - 1) - ((1 << 96) - 1), 1 << 383]
    for x in xs:
        want = x * y * RINV % C.P
        assert mont_mul_lanes(x, y, L) == want
        lazy = mont_mul_lanes(x, y, L, canonical=False)
        assert lazy < 2 * C.P and lazy % C.P == want


@pytest.mark.parametrize("L", LANES)
def test_carry_pass_ripples_across_every_lane(L):
    """Lane 0's carry word 3 into lane 1, whose words are all 0xFFFFFFFF as
    every lane's but the top word: the carry passes every lane above lane 1
    (L = 4: a carry-lookahead ripple) into the top lane.  p - 1 against p:
    lane 0 borrows and the borrow passes every lane (t kept); p: no borrow."""
    S = NW // L
    ones = [MASK] * S
    t = [ones] * (L - 1) + [ones[:-1] + [5]]
    got, over = carry_pass(t, [3] + [0] * (L - 1))
    assert over == 0
    assert value([w for s in got for w in s]) == value([w for s in t for w in s]) + (3 << (32 * S))
    for x, want in ((C.P - 1, C.P - 1), (C.P, 0), (2 * C.P - 1, C.P - 1)):
        sl = [words(x)[j * S:(j + 1) * S] for j in range(L)]
        assert value([w for s in cond_sub(sl) for w in s]) == want


@pytest.mark.parametrize("L", LANES)
@pytest.mark.parametrize("exp", EXPONENTS)
def test_pow_chain_matches_pow(L, exp):
    e = EXPONENTS[exp]
    rng = np.random.default_rng(95)
    mont = [int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(2)]
    for x in mont:
        assert pow_chain(x, e, L) == pow(x * RINV, e, C.P) * R % C.P
    a = (mont[0], mont[1])
    want = GF.fp2_pow((a[0] * RINV % C.P, a[1] * RINV % C.P), e)
    assert pow_chain(a, e, L) == (want[0] * R % C.P, want[1] * R % C.P)

"""The round-wise bodies of the group kernels (ops/group_rounds.py, the
tables of csrc/group_rounds.cuh that csrc/group.cuh runs) on the CPU: the
committed header is the generator's output, and each body run on Python
ints as the kernels run it (run_body: phase by phase, every form and
product with the kernels' bounds checked) gives the limbs of the plain
versions of miller_dbl_run, miller_add, exp_x, mul014, dbl_step and
add_step (ops/pairing.py), fp12_mul, fp6_mul, fp12_sqr and cyclo_sqr
(ops/tower.py) and pt_dbl (ops/curve.py; with 0, 1 and p - 1 among their
operands, mul014 also on a neutral line, pt_dbl also on the infinity) on
seeded random operands, off the curve and off the cyclotomic subgroup,
with mixed valid masks, the step and pt_dbl bodies with every slot that
their kernels leave unloaded holding seeded values; pt_add's script (G1,
G2) gives those of pt_add_plain on operands that meet each of the complete
addition's five cases; the point programs' scripts (run_script) give
those of pt_mul_const (G1, G2) and g2_cofactor (ops/curve.py) on edge
points, and in affine the JAX package's golden curve and, in G1, its
jitted pt_mul_const, and those of sswu_map2 (ops/hash_to_g2.py) on u
values that meet each of its branches; the variable ladder's script
(pt_mul_var, G1 and G2, 255 bits) gives those of pt_mul_var_plain on the
edge scalars 0, 1, 2, r - 1, r, r + 2 and 2^255 - 1 and a base at
infinity, and in affine the golden curve's; the cases' flags, forced,
pick their bodies in the JAX order, a variable ladder's clear bit first.
Tolerance 0."""

import functools

import jax
import numpy as np
import pytest
import torch

from bls_verify_gadget_tpu import constants as JC
from bls_verify_gadget_tpu.golden import curve as GC
from bls_verify_gadget_tpu.golden import field as GF
from bls_verify_gadget_tpu.ops import curve as JCV
from bls_verify_gadget_tpu_torch import constants as C
from bls_verify_gadget_tpu_torch.convert import limbs_from_numpy
from bls_verify_gadget_tpu_torch.ops import curve as CV
from bls_verify_gadget_tpu_torch.ops import group_rounds as GR
from bls_verify_gadget_tpu_torch.ops import hash_to_g2 as H
from bls_verify_gadget_tpu_torch.ops import pairing as PR
from bls_verify_gadget_tpu_torch.ops import tower as T
from bls_verify_gadget_tpu_torch.ops.limbs import ints_to_limbs, limbs_to_int
from test_torch_curve_hash_pairing import g1_off_subgroup, g2_off_subgroup
from test_torch_hash_kernels import _gx1_is_square

N = 3  # elements


def packed(rng, coords):
    """(coords, N, 24) canonical limbs from seeded ints, and the ints."""
    vals = [[int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(N)]
            for _ in range(coords)]
    return torch.from_numpy(np.stack([ints_to_limbs(v, 24) for v in vals])), vals


def ints(t):
    return [[limbs_to_int(t[c, i].numpy()) for i in range(t.shape[1])] for c in range(t.shape[0])]


def test_header_is_the_generators_output():
    assert GR.HEADER.read_text() == GR.render()


def test_exp_x_bodies_match_the_plain_version():
    segments = [(2, True), (1, False), (3, True)]
    m, vals = packed(np.random.default_rng(70), 12)
    want = ints(PR.exp_x_plain(m, segments))
    P = GR.exp_x_program()
    for i in range(N):
        slots = [0] * P.nslots
        for c in range(12):
            slots[c] = vals[c][i]
        GR.run_body(P, "setup", slots)
        for length, mul in segments:
            for _ in range(length):
                GR.run_body(P, "square", slots)
            if mul:
                GR.run_body(P, "mul", slots)
        assert slots[:12] == [want[c][i] for c in range(12)]


# program, body, its plain version, coordinates of each operand, outputs
TOWER_BODIES = {
    "fp12_mul": (GR.fp12_mul_program, "mul", T.fp12_mul_plain, (12, 12), 12),
    "fp6_mul": (GR.fp6_mul_program, "mul", T.fp6_mul_packed_plain, (6, 6), 6),
    "fp12_sqr": (GR.fp12_sqr_program, "sqr", T.fp12_sqr_plain, (12,), 12),
    "mul014": (GR.mul014_program, "line0", PR.mul014_plain, (12, 6), 12),
}


def _edge_operands(rng, coords):
    """Seeded operands of `coords` coordinates each, with 0, 1 and p - 1 in
    every coordinate of element 0 and the first three (or all) of element
    2: [(the packed (c, N, 24) tensor, its ints)]."""
    edges = [0, 1, C.P - 1]
    ops = []
    for c in coords:
        _, vals = packed(rng, c)
        for j in range(c):
            vals[j][0] = edges[j % 3]
        for j in range(min(3, c)):
            vals[j][2] = edges[j]
        ops.append((torch.from_numpy(np.stack([ints_to_limbs(v, 24) for v in vals])), vals))
    return ops


@pytest.mark.parametrize("name", TOWER_BODIES)
def test_tower_body_matches_the_plain_version(name):
    """The tower products' bodies on seeded operands with 0, 1 and p - 1 in
    every coordinate of element 0 and the first three of element 2; mul014's
    line of element 1 is the neutral (1, 0, 0), which its kernel multiplies
    by as any other."""
    program, body, plain, coords, nout = TOWER_BODIES[name]
    rng = np.random.default_rng(75 + len(coords) + coords[0])
    ops = _edge_operands(rng, coords)
    if name == "mul014":
        line, vals = ops[1]
        for j in range(6):
            vals[j][1] = _mont(1) if j == 0 else 0
        line[:, 1] = torch.from_numpy(np.stack(ints_to_limbs([v[1] for v in vals], 24)))
    want = ints(plain(*(t for t, _ in ops)))
    P = program()
    out = P.slots[P.outputs[0]][0]
    for i in range(N):
        slots = [0] * P.nslots  # the operands in order: the packed operand's
        slots[:sum(coords)] = [v[j][i] for _, v in ops for j in range(len(v))]
        GR.run_body(P, body, slots)
        assert slots[out:out + nout] == [want[c][i] for c in range(nout)]


@pytest.mark.parametrize("count", [1, 3])
def test_cyclo_sqr_body_matches_the_plain_version(count):
    """cyclo_sqr's kernel runs the body square `count` times: on seeded
    Fp12 off the cyclotomic subgroup, with 0, 1 and p - 1 among element 0's
    and element 2's coordinates, the limbs of cyclo_sqr_plain."""
    ((f, vals),) = _edge_operands(np.random.default_rng(90 + count), (12,))
    want = ints(T.cyclo_sqr_plain(f, count))
    P = GR.cyclo_sqr_program()
    for i in range(N):
        slots = [0] * P.nslots
        slots[:12] = [vals[c][i] for c in range(12)]
        for _ in range(count):
            GR.run_body(P, "square", slots)
        assert slots[:12] == [want[c][i] for c in range(12)]


def test_step_programs_are_one_phase_of_products():
    """cyclo_sqr's square and mul014's line0 are each one phase of
    products (18 and 45), then the stores of f; the programs that share
    their bodies keep their slot counts."""
    for P, body, n in [(GR.cyclo_sqr_program(), "square", 18), (GR.mul014_program(), "line0", 45)]:
        phases = P.bodies[body]
        assert [sum(op.b is not None for op in ops) for ops in phases] == [n, 0]
        assert [len(ops) for ops in phases] == [n, 12]
        assert P.nslots == (12 if body == "square" else 18) + n
    assert GR.exp_x_program().nslots == 90
    assert [GR.miller_program(k).nslots for k in GR.MILLER_PAIRS] == [93, 126]


def test_dbl_step_body_matches_the_plain_version():
    """dbl_step's kernel runs the body dbl once on T and the G1 point
    (slots 0-7): the Miller programs' doubling without f^2, [11 products];
    [the intermediates and c0]; [14 products]; [T].  On seeded T and points
    off the curve, with 0, 1 and p - 1 among element 0's and element 2's
    coordinates, 2T and the line are the limbs of dbl_step_plain."""
    (t, tv), (p, pv) = _edge_operands(np.random.default_rng(95), (6, 2))
    want = ints(PR.dbl_step_plain(t, p))
    P = GR.dbl_step_program()
    assert [sum(op.b is not None for op in ops) for ops in P.bodies["dbl"]] == [11, 0, 14, 0]
    t0, line = P.slots["t0"][0], P.slots["line0"][0]
    for i in range(N):
        slots = [0] * P.nslots
        slots[:8] = [tv[c][i] for c in range(6)] + [pv[c][i] for c in range(2)]
        GR.run_body(P, "dbl", slots)
        assert slots[t0:t0 + 6] + slots[line:line + 6] == [want[c][i] for c in range(12)]


def _unloaded(rng, P):
    """Seeded values in every slot of program P: the shared memory that a
    kernel leaves unloaded, which its body must not read."""
    return [int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(P.nslots)]


def test_add_step_body_matches_the_plain_version():
    """add_step's kernel runs MillerAdd1Program's body add once on T, Q and
    the G1 point loaded into t0, q0 and p0, f's slots not loaded: [6
    products]; [14]; [9]; [the line's c0]; [12]; [T].  On seeded T, Q and
    points off the curve, with 0, 1 and p - 1 among element 0's and element
    2's coordinates, and seeded values in every other slot, T + Q and the
    line are the limbs of add_step_plain."""
    rng = np.random.default_rng(97)
    (t, tv), (q, qv), (p, pv) = _edge_operands(rng, (6, 4, 2))
    want = ints(PR.add_step_plain(t, q, p))
    P = GR.miller_add_program(1)
    assert [sum(op.b is not None for op in ops) for ops in P.bodies["add"]] == [6, 14, 9, 0, 12, 0]
    t0, q0, p0, line = (P.slots[name][0] for name in ("t0", "q0", "p0", "line0"))
    for i in range(N):
        slots = _unloaded(rng, P)
        slots[t0:t0 + 6] = [tv[c][i] for c in range(6)]
        slots[q0:q0 + 4] = [qv[c][i] for c in range(4)]
        slots[p0:p0 + 2] = [pv[c][i] for c in range(2)]
        GR.run_body(P, "add", slots)
        assert slots[t0:t0 + 6] + slots[line:line + 6] == [want[c][i] for c in range(12)]


@pytest.mark.parametrize("count", [1, 3])
@pytest.mark.parametrize("F", [GR.FP_COORD, GR.FP2_COORD], ids=["G1", "G2"])
def test_pt_dbl_on_the_add_programs_dbl_body(F, count):
    """pt_dbl's kernel runs the body dbl of pt_add's program `count` times
    on the point loaded into acc, no other slot loaded: 3 product phases
    (G1 3, 3, 1 products; G2 7, 7, 3), then acc.  On seeded points off the
    curve, with 0, 1 and p - 1 among element 0's and element 2's
    coordinates, element 1 at infinity (Z = 0), and seeded values in every
    other slot, acc is the limbs of pt_dbl_plain."""
    c = F.width
    rng = np.random.default_rng(98 + 2 * c + count)
    ((_, vals),) = _edge_operands(rng, (3 * c,))
    for j in range(2 * c, 3 * c):
        vals[j][1] = 0
    pts = torch.from_numpy(np.stack([ints_to_limbs(v, 24) for v in vals]))
    want = ints(CV.pt_dbl_plain(pts, count))
    P = GR.add_program(F)
    products = [3, 3, 1, 0] if c == 1 else [7, 7, 3, 0]
    assert [sum(op.b is not None for op in ops) for ops in P.bodies["dbl"]] == products
    acc = P.slots["acc"][0]
    for i in range(N):
        slots = _unloaded(rng, P)
        slots[acc:acc + 3 * c] = [vals[j][i] for j in range(3 * c)]
        for _ in range(count):
            GR.run_body(P, "dbl", slots)
        assert slots[acc:acc + 3 * c] == [want[j][i] for j in range(3 * c)]


# the complete addition's outcomes (add_case) in _pt_add_body's order
ADD_OUTCOMES = ("take_base", None, "dbl", "set_inf", "take_sum")


@pytest.mark.parametrize("F", [GR.FP_COORD, GR.FP2_COORD], ids=["G1", "G2"])
def test_add_program_matches_pt_add_plain(F, monkeypatch):
    """pt_add's script (one ADD step) on P in acc and Q in base, element e
    meeting ADD_OUTCOMES[e]: P at infinity (Z = 0); Q at infinity; Q = P
    and Q = -P in another Jacobian representative (l^2 X, +-l^3 Y, l Z for
    a seeded l); two unrelated points.  Seeded coordinates off the curve
    (the formulas are polynomials): acc is the limbs of pt_add_plain, and
    add_case picks each outcome once, in order."""
    c = F.width
    rng = np.random.default_rng(96 + c)

    def coords():
        return [int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(3 * c)]

    ps, qs = [], []
    for case in ADD_OUTCOMES:
        p, q = coords(), coords()
        lam = int.from_bytes(rng.bytes(48), "little") % C.P
        if case == "take_base":
            p[2 * c:] = [0] * c
        elif case is None:
            q[2 * c:] = [0] * c
        elif case in ("dbl", "set_inf"):
            sign = 1 if case == "dbl" else -1
            q = ([x * lam**2 % C.P for x in p[:c]] + [sign * y * lam**3 % C.P for y in p[c:2 * c]]
                 + [z * lam % C.P for z in p[2 * c:]])
        ps.append(p)
        qs.append(q)

    def pack(pts):
        return torch.from_numpy(np.stack([ints_to_limbs([pt[j] for pt in pts], 24)
                                          for j in range(3 * c)]))

    want = ints(CV.pt_add_plain(pack(ps), pack(qs)))
    P = GR.add_program(F)
    cases, add_case = [], GR.add_case

    def counted(*args):
        cases.append(add_case(*args))
        return cases[-1]

    monkeypatch.setattr(GR, "add_case", counted)
    for i in range(len(ADD_OUTCOMES)):
        slots = [0] * P.nslots  # P, then Q: the inputs acc and base at slots 0 and up
        slots[:6 * c] = ps[i] + qs[i]
        slots[P.slots["one"][0]] = _mont(1)
        GR.run_script(P, (), slots)
        assert slots[:3 * c] == [want[j][i] for j in range(3 * c)]
    assert cases == list(ADD_OUTCOMES)


@pytest.mark.parametrize("k", GR.MILLER_PAIRS)
def test_miller_bodies_match_the_plain_version(k):
    rng = np.random.default_rng(71 + k)
    f, fv = packed(rng, 12)
    t, tv = packed(rng, 6 * k)
    p, pv = packed(rng, 2 * k)
    valid = torch.tensor([[True, False, True], [True, True, False]][:k])
    count = 2
    want_f, want_t = PR.miller_dbl_run_plain(f, t.view(k, 6, N, 24), p[0::2], p[1::2], valid,
                                             count)
    want = ints(torch.cat([want_f, want_t.reshape(6 * k, N, 24)]))
    P = GR.miller_program(k)
    for i in range(N):
        slots = [0] * P.nslots
        for c in range(12):  # f, then per pair X, Y, Z, xp, yp: the operand's order
            slots[c] = fv[c][i]
        for q in range(k):
            for c in range(6):
                slots[12 + 8 * q + c] = tv[6 * q + c][i]
            slots[18 + 8 * q], slots[19 + 8 * q] = pv[2 * q][i], pv[2 * q + 1][i]
        for _ in range(count):
            GR.run_body(P, "dbl", slots)
            for q in range(k):
                if valid[q, i]:
                    GR.run_body(P, f"line{q}", slots)
        got = slots[:12] + [slots[12 + 8 * q + c] for q in range(k) for c in range(6)]
        assert got == [want[c][i] for c in range(12 + 6 * k)]
    # miller_add: its program's body add, then line<p> per valid pair, on f,
    # T and the G1 points above with seeded affine Q
    q, qv = packed(rng, 4 * k)
    tq = t.view(k, 6, N, 24)
    want_f, want_t = PR.miller_add_plain(f, tq, q.view(k, 4, N, 24), p[0::2], p[1::2], valid)
    want = ints(torch.cat([want_f, want_t.reshape(6 * k, N, 24)]))
    P = GR.miller_add_program(k)
    for i in range(N):
        slots = [0] * P.nslots  # f, then per pair X, Y, Z, xq, yq, xp, yp
        slots[:12] = [fv[c][i] for c in range(12)]
        for j in range(k):
            slots[12 + 12 * j:24 + 12 * j] = ([tv[6 * j + c][i] for c in range(6)]
                                              + [qv[4 * j + c][i] for c in range(4)]
                                              + [pv[2 * j][i], pv[2 * j + 1][i]])
        GR.run_body(P, "add", slots)
        for j in range(k):
            if valid[j, i]:
                GR.run_body(P, f"line{j}", slots)
        got = slots[:12] + [slots[12 + 12 * j + c] for j in range(k) for c in range(6)]
        assert got == [want[c][i] for c in range(12 + 6 * k)]


# ---------------------------------------------------------------------------
# the point programs: pt_mul_const (G1, G2) and g2_cofactor
# ---------------------------------------------------------------------------

def _small_order_g1(x0, m):
    """[#E1 / m] (x0, y) with #E1 = h1 r, h1 = (x - 1)^2 / 3."""
    y = GF.fp_sqrt((x0**3 + 4) % JC.P)
    return GC.g1_mul((x0, y), (JC.ABS_X + 1) ** 2 // 3 * JC.R // m)


def _mont(v):
    return v * (1 << 384) % C.P


def _g2_jacobian(pt, z):
    """Montgomery ints X, Y, Z (re, im each) of the affine G2 point pt
    scaled by z: (x z^2, y z^3, z)."""
    z2 = GF.fp2_sqr(z)
    coords = (GF.fp2_mul(pt[0], z2), GF.fp2_mul(pt[1], GF.fp2_mul(z2, z)), z)
    return [_mont(v) for c in coords for v in c]


def _points(kernel):
    """(affine points or None, packed (3c, N, 24) operand): G1 the infinity,
    points of order 3 and 11 (the |x| ladder's first addition meets acc =
    [2]P = -P, the second acc = [12]P = P), an off-subgroup point; G2 the
    infinity, an off-subgroup point and, in Jacobian form with Z != 1, a
    multiple of the generator (ladder) or the off-subgroup point
    (g2_cofactor)."""
    if kernel == "ladder_g1":
        pts = [None, _small_order_g1(5, 3), _small_order_g1(4, 121), g1_off_subgroup()]
        return pts, CV.pack_point(CV.FP_OPS, CV.g1_encode_batch(pts, "cpu"))
    off = g2_off_subgroup()
    last = GC.g2_mul(JC.G2_GEN, 0x1234567) if kernel == "ladder_g2" else off
    pts = [None, off, last]
    packed = CV.pack_point(CV.FP2_OPS, CV.g2_encode_batch(pts, "cpu"))
    jac = _g2_jacobian(last, (3, 7))
    packed[:, 2] = torch.from_numpy(np.stack(ints_to_limbs(jac, 24)))
    return pts, packed


def _sswu_inputs():
    """Montgomery ints u0.re, u0.im, u1.re, u1.im of sswu_map2's elements:
    u0 = u1 = 0 (both maps' e1 branch, q0 == q1: the sum's doubling case),
    u1 = 0 alone, a u0 whose gx1 is not a square and one whose gx1 is (the
    two values of found1), and seeded values (with the rest, both sgn0
    branches)."""
    rng = np.random.default_rng(77)
    nonsq = next((k, 1) for k in range(1, 100) if not _gx1_is_square((k, 1)))
    sq = next((k, 1) for k in range(1, 100) if _gx1_is_square((k, 1)))
    rand = [tuple(int.from_bytes(rng.bytes(48), "little") % C.P for _ in range(2))
            for _ in range(4)]
    us = [((0, 0), (0, 0)), (rand[0], (0, 0)), (nonsq, rand[1]), (sq, rand[2]), (rand[3], nonsq)]
    return [[_mont(u[m][c]) for u in us] for m in range(2) for c in range(2)]


@pytest.mark.parametrize("kernel", ["ladder_g1", "ladder_g2", "g2_cofactor", "sswu_map2"])
def test_point_programs_match_the_plain_versions(kernel, monkeypatch):
    """The script of each point program (run_script: the ladder by |x|,
    the whole g2_cofactor body, sswu_map2's table loads, cases and chains)
    on Python ints, limb-equal to the plain version and, for the ladders
    and g2_cofactor, in affine to the JAX package's golden curve (and in G1
    to jax.jit of its pt_mul_const, a cmov ladder with another Jacobian
    representative); every case of the complete addition, and of
    sswu_map2's cases, that the data meets is counted."""
    if kernel == "sswu_map2":
        _sswu_program_matches_plain(monkeypatch)
        return
    pts, packed = _points(kernel)
    n = len(pts)
    if kernel == "g2_cofactor":
        P = GR.cofactor_program()
        want = CV.g2_cofactor_plain(packed, CV.X_SEGMENTS)
        golden = [None if p is None else GC.g2_clear_cofactor(p) for p in pts]
    else:
        P = GR.ladder_program(GR.FP_COORD if kernel == "ladder_g1" else GR.FP2_COORD)
        want = CV.pt_mul_const_plain(packed, CV.X_SEGMENTS)
        mul = GC.g1_mul if kernel == "ladder_g1" else GC.g2_mul
        golden = [None if p is None else mul(p, JC.ABS_X) for p in pts]
    cases, add_case = [], GR.add_case

    def counted(*args):
        cases.append(add_case(*args))
        return cases[-1]

    monkeypatch.setattr(GR, "add_case", counted)
    nc, first = packed.shape[0], P.slots["p" if kernel == "g2_cofactor" else "base"][0]
    consts = {"one": [1], "cx": C.PSI_X, "cy": C.PSI_Y, "c2": [C.PSI2_X_C0]}
    got = []
    for i, vals in enumerate(zip(*ints(packed))):
        slots = [0] * P.nslots
        slots[first:first + nc] = vals
        for name, values in consts.items():
            if name in P.slots:
                slots[P.slots[name][0]:P.slots[name][0] + len(values)] = map(_mont, values)
        acc = P.slots["acc"][0]
        got.append(GR.run_script(P, CV.X_SEGMENTS, slots)[acc:acc + nc])
    assert [list(c) for c in zip(*got)] == ints(want)
    if kernel == "ladder_g1":
        assert set(cases) == {"take_base", "set_inf", "dbl", "take_sum"}
        assert CV.g1_decode(CV.unpack_point(CV.FP_OPS, want)) == golden
        x, y, z = (np.asarray(c) for c in JCV.g1_encode_batch(pts))
        jac = jax.jit(lambda *q: JCV.pt_mul_const(JCV.FP_OPS, q, JC.ABS_X))(x, y, z)
        assert CV.g1_decode(tuple(limbs_from_numpy(np.asarray(c), device="cpu")
                                  for c in jac)) == golden
    else:
        assert set(cases) == {"take_base", "take_sum"}
        assert CV.g2_decode(CV.unpack_point(CV.FP2_OPS, want)) == golden
    assert len(cases) == n * (5 if kernel != "g2_cofactor" else 15)


@pytest.mark.parametrize("flags, case", [
    ((1, 1, 1, 1), "take_base"),  # P at infinity: Q, whatever else holds
    ((0, 1, 1, 1), None),  # Q at infinity: P
    ((0, 0, 1, 1), "dbl"),  # P == Q
    ((0, 0, 1, 0), "set_inf"),  # P == -Q
    ((0, 0, 0, 1), "take_sum"),
])
def test_add_case_follows_the_jax_order(flags, case):
    """add_case picks the complete addition's case in _pt_add_body's order
    from the zero flags of (P's Z, Q's Z, h, r); in a variable ladder the
    scalar's bit comes first: set, the same case; clear, none (acc stays,
    the plain version's cmov), whatever the other flags."""
    for P in (GR.ladder_program(GR.FP_COORD), GR.cofactor_program(),
              GR.var_ladder_program(GR.FP_COORD), GR.var_ladder_program(GR.FP2_COORD),
              GR.add_program(GR.FP_COORD), GR.add_program(GR.FP2_COORD)):
        c = P.consts["kCoord"]
        slots = [7] * P.nslots
        for flag, (name, off) in zip(flags, [("acc", 2 * c), ("base", 2 * c), ("h", 0),
                                             ("r", 0)]):
            first = P.slots[name][0] + off
            slots[first:first + c] = [0] * c if flag else [5] * c
        assert GR.add_case(P, slots) == case
        if "scalar" in P.slots:
            slots[P.slots["scalar"][0]] = 1 << 254 | 1 << 37 | 2
            for bit, want in ((254, case), (37, case), (1, case), (0, None), (36, None),
                              (253, None)):
                assert GR.add_case(P, slots, bit) == want, bit


def _var_ladder_inputs(F):
    """(affine bases or None, packed (3c, 8, 24) operand, scalars) of the
    variable ladder: the generator (order r) by 0, 1, 2, r - 1, r (whose
    last addition meets acc = -P: set_inf), r + 2 (acc = P: the doubling
    case) and 2^255 - 1, in elements 1, 3 and 5 as a Jacobian point with Z
    != 1, and the infinity by a seeded 255-bit scalar."""
    rng = np.random.default_rng(79 + F.width)
    gen = JC.G1_GEN if F.width == 1 else JC.G2_GEN
    r = JC.R
    scalars = [0, 1, 2, r - 1, r, r + 2, (1 << 255) - 1,
               int.from_bytes(rng.bytes(32), "little") >> 1 | 1 << 254]
    pts = [gen] * 7 + [None]
    if F.width == 1:
        packed = CV.pack_point(CV.FP_OPS, CV.g1_encode_batch(pts, "cpu"))
        z = 0x5EED
        jac = [_mont(v) for v in (gen[0] * z * z % JC.P, gen[1] * z**3 % JC.P, z)]
    else:
        packed = CV.pack_point(CV.FP2_OPS, CV.g2_encode_batch(pts, "cpu"))
        jac = _g2_jacobian(gen, (3, 7))
    for i in (1, 3, 5):
        packed[:, i] = torch.from_numpy(np.stack(ints_to_limbs(jac, 24)))
    return pts, packed, scalars


@pytest.mark.parametrize("F", [GR.FP_COORD, GR.FP2_COORD], ids=["G1", "G2"])
def test_var_ladder_matches_pt_mul_var_plain(F, monkeypatch):
    """The variable ladder's script (run_script's VLADDER: set_inf, then per
    bit MSB first a doubling and the addition whose case add_case picks
    with the bit's flag first) on Python ints at 255 bits, limb-equal to
    pt_mul_var_plain (the JAX package's ladder limb for limb) and in affine
    to the golden curve.  The data meets every case the ladder can: the
    clear bit's none, take_base (acc at infinity at the first set bit),
    take_sum, dbl (r + 2), set_inf (r) and, with the base at infinity,
    take_base at every set bit: acc stays at the infinity, so the case of Q
    at infinity never comes (add_case checks P first)."""
    pts, packed, scalars = _var_ladder_inputs(F)
    limbs = torch.from_numpy(ints_to_limbs(scalars, 16)).to(torch.int32)
    want = ints(CV.pt_mul_var_plain(packed, limbs, 255))
    mul = GC.g1_mul if F.width == 1 else GC.g2_mul
    golden = [None if p is None or k % JC.R == 0 else mul(p, k) for p, k in zip(pts, scalars)]
    decode = CV.g1_decode if F.width == 1 else CV.g2_decode
    ops = CV.FP_OPS if F.width == 1 else CV.FP2_OPS
    assert decode(CV.unpack_point(ops, torch.from_numpy(np.array(
        [[ints_to_limbs([v], 24)[0] for v in c] for c in want])))) == golden
    P = GR.var_ladder_program(F)
    cases, add_case = [], GR.add_case

    def counted(P, slots, bit=None):
        clear = bit is not None and not slots[P.slots["scalar"][0]] >> bit & 1
        cases.append((len(got), "clear" if clear else add_case(P, slots)))
        return add_case(P, slots, bit)

    monkeypatch.setattr(GR, "add_case", counted)
    nc, got = packed.shape[0], []
    acc, base = P.slots["acc"][0], P.slots["base"][0]
    for vals, k in zip(zip(*ints(packed)), scalars):
        slots = [0] * P.nslots
        slots[base:base + nc] = vals
        slots[P.slots["one"][0]], slots[P.slots["scalar"][0]] = _mont(1), k
        got.append(GR.run_script(P, None, slots, nbits=255)[acc:acc + nc])
    assert [list(c) for c in zip(*got)] == want
    assert len(cases) == 255 * len(scalars)
    met = {c for _, c in cases}
    assert met == {"clear", "take_base", "take_sum", "dbl", "set_inf"}
    last = {i: c for i, c in cases}  # each element's last case
    assert last[4] == "set_inf" and last[5] == "dbl"
    assert {c for i, c in cases if i == 7} == {"clear", "take_base"}


def _sswu_program_matches_plain(monkeypatch):
    vals = _sswu_inputs()
    u = torch.from_numpy(np.stack([ints_to_limbs(v, 24) for v in vals]))
    want = ints(H.sswu_map2_plain(u))
    P = GR.sswu_program()
    table = [limbs_to_int(row.numpy()) for row in H.sswu_consts("cpu")]
    picks, pick_case, add_case = [], GR.pick_case, GR.add_case
    monkeypatch.setattr(GR, "pick_case", lambda *a: picks.append(pick_case(*a)) or picks[-1])
    monkeypatch.setattr(GR, "add_case", lambda *a: picks.append(add_case(*a)) or picks[-1])
    acc = P.slots["acc"][0]
    for i, u_i in enumerate(zip(*vals)):
        slots = [0] * P.nslots
        slots[:4] = u_i
        slots[P.slots["one"][0]], slots[P.slots["raw1"][0]] = _mont(1), 1
        got = GR.run_script(P, None, slots, (H.SQRT_K, C.P - 2), table)[acc:acc + 6]
        assert got == [w[i] for w in want]
    e1, cand, sign, add = picks[:2], picks[2:4], picks[4:6], picks[6]  # u0 = u1 = 0
    assert e1 == ["e1_0", "e1_1"] and cand[0][-2:] == cand[1][-2:] and add == "dbl"
    assert sign[0][:3] == sign[1][:3]
    met = set(picks)
    assert {"ne1_0", "ne1_1", "neg0", "neg1", "take_sum"} <= met
    assert any(c.startswith("cand0_1") and c != "cand0_10" for c in met)  # found1
    assert any(c.startswith("cand0_2") for c in met)  # not found1
    assert len(picks) == 7 * len(want[0])


_sswu_program = functools.cache(GR.sswu_program)


def _sgn0(re, im):
    """RFC 9380 sgn0 (m = 2) of a canonical (re, im) (_sgn0_rows)."""
    return re & 1 if re else im & 1


@pytest.mark.parametrize("case, on, body", [
    ("e1_0", {"t0"}, "e1_0"),  # t == 0: (B, Z A)
    ("e1_0", set(), "ne1_0"),
    ("e1_1", {"t1"}, "e1_1"),
    ("e1_1", set(), "ne1_1"),
    # _cand_select_rows: gx = 0 (R = 0) first, then c^2 = 1, -1, u, -u; the
    # first set's candidate where it has one (found1), else the second's
    ("cand0", {"r01", "d010", "d011", "d012", "d013", "r02", "d020"}, "cand0_10"),
    ("cand0", {"d010", "d011", "d012", "d013", "r02"}, "cand0_11"),
    ("cand0", {"d011", "d012", "d013", "d020"}, "cand0_12"),
    ("cand0", {"d012", "d013", "r02"}, "cand0_13"),
    ("cand0", {"d013", "d020"}, "cand0_14"),
    ("cand1", {"r12", "d120", "d121", "d122", "d123"}, "cand1_20"),
    ("cand1", {"d120", "d121", "d122", "d123"}, "cand1_21"),
    ("cand1", {"d121", "d122", "d123"}, "cand1_22"),
    ("cand1", {"d122", "d123"}, "cand1_23"),
    ("cand1", {"d123"}, "cand1_24"),
    ("cand1", set(), "cand1_20"),  # no candidate: the second set's 0
    ("sgn0_0", None, None),
    ("sgn0_1", None, None),
])
def test_sswu_cases_follow_the_jax_order(case, on, body):
    """pick_case picks sswu_map2's bodies from the forced flags of its
    slots: e1 from t's zero flag; the sqrt candidate in _cand_select_rows
    order from the zero flags of R and the four candidate forms of each
    set, the target's first (gx = 0 cannot be reached from data); the sign
    (neg: -Y) where sgn0(u) != sgn0(y), over u's and y's raw values in {0,
    1, 2}^2."""
    P = _sswu_program()
    flags, _ = P.cases[case]
    slots = [7] * P.nslots
    if on is not None:
        for name, off, count, _ in flags:
            first = P.slots[name][0] + off
            slots[first:first + count] = [0 if name in on else 5] * count
        assert GR.pick_case(P, case, slots) == body
        return
    m = case[-1]
    ru, ry = P.slots[f"ru{m}"][0], P.slots[f"ry{m}"][0]
    for vals in np.ndindex(3, 3, 3, 3):
        slots[ru:ru + 2], slots[ry:ry + 2] = vals[:2], vals[2:]
        differ = _sgn0(*vals[:2]) != _sgn0(*vals[2:])
        assert GR.pick_case(P, case, slots) == (f"neg{m}" if differ else f"pos{m}")

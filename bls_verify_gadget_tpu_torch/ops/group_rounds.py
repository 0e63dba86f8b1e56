"""Round-wise forms of the pairing and point bodies that the group kernels
run (csrc/group.cuh): the tables of csrc/group_rounds.cuh, generated here.

    python3 -m bls_verify_gadget_tpu_torch.ops.group_rounds   # rewrites the header

A group kernel runs one batch element on a group of G threads, with the
element's Fp values in shared memory as numbered slots.  Its bodies are
lists of phases.  A phase is a list of independent ops that the group deals
out round-robin over its threads, each op whole in one thread, and ends at
a barrier of the group.  An op writes one slot:
  - a product: mont_mul(A, B) of two linear forms A and B;
  - a combination: the linear form A alone.
A linear form is (sum_j c_j * slot_j) / 2^h mod p with small integer c_j:
the sums, differences, multiples, xi and halvings of the formulas.
No op of a phase reads a slot that another op of the same phase writes, so
the order in which the threads run a phase's ops does not matter.

A thread evaluates a form as group.cuh's eval_form and eval_operands do
(eval_exact below is the same value on Python ints): V = sum of the
positive terms + W- p - sum of the negative ones, in 64-bit word sums, with
W- the negative coefficients' total, so that 0 <= V <= W p for W = sum
|c_j|; then, by the form's mode,
  COPY      the slot itself (one term, coefficient 1, no halving);
  LAZY      V as it is (a product operand);
  REDUCED   V - q p, q = floor(top 64 bits of V / (p's top word + 1)) in
            double precision, which leaves V below 3p (a product operand);
  CANONICAL V - q p, then below p, then the halvings (a stored value).
field.cuh's mont_mul returns a canonical product for operands a, b < R
with a b < p R (its accumulator then ends below 2p); p R > 9.8 p^2, so the
generator keeps the two operands' bounds (V <= W p, or V < 3p when
REDUCED) at a product of at most 9 p^2.

The forms come from tracing csrc/tower.cuh's formulas with symbolic values
(Lin below): every value is the same polynomial in the inputs as there, and
every slot holds a canonical residue, so the kernels' limbs equal the plain
versions' whatever the grouping of products and sums.  The Miller line and
T are tower.cuh's miller_dbl_step formula and the Granger-Scott square is
its f12_cyclotomic_sqr formula (both matter off the curve and off the
cyclotomic subgroup); the Fp12 square and products are exact products.
The point programs (pt_mul_const, g2_cofactor) trace csrc/curve.cuh's
Jacobian doubling and complete addition: the Jacobian representative is
the formulas' polynomial, so the doubling may regroup it (pt_dbl_rounds),
and the addition's exceptional cases keep its order (add_case).

run_body() executes a body, run_script() a point program's script, on
Python ints as the kernels do, for the CPU tests
(tests/test_torch_group_rounds.py).
"""

import pathlib

from .. import constants as C

HEADER = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "group_rounds.cuh"
MILLER_PAIRS = (1, 2)
THREADS = 128  # threads per block of a group kernel: THREADS / G elements, or
MAX_SHARED = 232448  # fewer where their slots would pass this (bytes; Hopper's limit)
SLOT_BYTES = 48  # an Fp slot: 12 32-bit words
COPY, LAZY, REDUCED, CANONICAL = range(4)  # how a form is evaluated
OPERAND_BOUND = 9  # a * b < 9 p^2 < p R: mont_mul's product is canonical
# op ordering only: a Montgomery product, a term and a reduction in
# thread instructions, roughly
PRODUCT_COST, TERM_COST, REDUCE_COST = 1000, 20, 60


class Lin:
    """A linear form (sum_j c[slot_j] * slot_j) / 2^h over slots."""

    __slots__ = ("c", "h")

    def __init__(self, c=None, h=0):
        self.c = {s: k for s, k in (c or {}).items() if k}
        self.h = h
        while self.h and all(k % 2 == 0 for k in self.c.values()):
            self.c = {s: k // 2 for s, k in self.c.items()}
            self.h -= 1

    @staticmethod
    def slot(s):
        return Lin({s: 1})

    def _at(self, h):
        return {s: k << (h - self.h) for s, k in self.c.items()}

    def __add__(self, o):
        h = max(self.h, o.h)
        c = self._at(h)
        for s, k in o._at(h).items():
            c[s] = c.get(s, 0) + k
        return Lin(c, h)

    def __neg__(self):
        return Lin({s: -k for s, k in self.c.items()}, self.h)

    def __sub__(self, o):
        return self + (-o)

    def scale(self, k):
        return Lin({s: k * v for s, v in self.c.items()}, self.h)

    def half(self):
        return Lin(self.c, self.h + 1)

    def weight(self):
        """W = sum |c_j|: the form's value before reduction is at most W p."""
        return sum(abs(k) for k in self.c.values())

    def is_slot(self):
        return self.h == 0 and len(self.c) == 1 and next(iter(self.c.values())) == 1


def _slot_of(lin):
    (s,) = lin.c
    return s


class Op:
    __slots__ = ("dst", "a", "b")

    def __init__(self, dst, a, b=None):
        self.dst, self.a, self.b = dst, a, b

    def reads(self):
        return set(self.a.c) | (set(self.b.c) if self.b is not None else set())

    def modes(self):
        """(mode of A, mode of B or None): a combination is CANONICAL (or a
        COPY); a product's operands stay LAZY while the bounds allow, the
        heavier first made REDUCED."""
        if self.b is None:
            return (COPY if self.a.is_slot() else CANONICAL), None
        forms = [self.a, self.b]
        if any(f.h for f in forms):
            raise ValueError("a product operand with a halving")
        modes = [COPY if f.is_slot() else LAZY for f in forms]
        bound = [f.weight() for f in forms]
        for i in sorted(range(2), key=lambda i: -bound[i]):
            if bound[i] > OPERAND_BOUND or bound[0] * bound[1] > OPERAND_BOUND:
                modes[i], bound[i] = REDUCED, 3
        if bound[0] * bound[1] > OPERAND_BOUND:
            raise ValueError(f"operand bounds {bound}")
        return tuple(modes)

    def cost(self):
        def form(f, mode):
            return TERM_COST * len(f.c) * (mode != COPY) + REDUCE_COST * (mode >= REDUCED)

        ma, mb = self.modes()
        return form(self.a, ma) + (0 if self.b is None else PRODUCT_COST + form(self.b, mb))


class Program:
    """The slots and bodies of one kernel.  Named slot ranges are fixed;
    product slots follow them, are allocated afresh per round and may be
    read only within the round that wrote them."""

    def __init__(self, name):
        self.name = name
        self.slots = {}  # name -> (first, count)
        self.consts = {}  # name -> value, emitted beside the slots
        self.nslots = 0
        self.bodies = {}  # name -> list of phases (lists of Op)
        self.script = []  # a point program's steps (run_script): (kind, body)
        self._phases = None
        self._temp0 = self._temp = None
        self._live = set()

    def named(self, name, count):
        self.slots[name] = (self.nslots, count)
        self.nslots += count
        return self.slot_list(name)

    def slot_list(self, name):
        first, count = self.slots[name]
        return [Lin.slot(s) for s in range(first, first + count)]

    def body(self, name):
        """Start body `name` (and a round: products start afresh)."""
        self._phases = self.bodies.setdefault(name, [])
        self.round()

    def round(self):
        if self._temp0 is None:
            self._temp0 = self.nslots
        self._temp = self._temp0
        self._live = set()

    def phase(self):
        self._phases.append([])

    def mul(self, a, b, dst=None):
        """A product into a fresh product slot, or into the named slot `dst`."""
        if dst is None:
            s = self._temp
            self._temp += 1
            self.nslots = max(self.nslots, self._temp)
            self._live.add(s)
        else:
            s = _slot_of(dst)
        self._op(Op(s, a, b))
        return Lin.slot(s)

    def store(self, dst, a):
        """A combination into the named slot `dst`."""
        self._op(Op(_slot_of(dst), a))

    def _op(self, op):
        for s in op.reads():
            if s >= self._temp0 and s not in self._live:
                raise ValueError(f"{self.name}: reads product slot {s} of another round")
        self._phases[-1].append(op)


# ----------------------------------------------------------------- the tower
# tower.cuh's formulas on symbolic values: Fp a Lin, Fp2 a pair, Fp6 a
# triple of Fp2, Fp12 a pair of Fp6.

def f2_add(a, b):
    return (a[0] + b[0], a[1] + b[1])


def f2_sub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def f2_neg(a):
    return (-a[0], -a[1])


def f2_xi(a):
    return (a[0] - a[1], a[0] + a[1])


def f2_scale(a, k):
    return (a[0].scale(k), a[1].scale(k))


def f2_half(a):
    return (a[0].half(), a[1].half())


def f2_mul(P, a, b):
    v0, v1 = P.mul(a[0], b[0]), P.mul(a[1], b[1])
    v2 = P.mul(a[0] + a[1], b[0] + b[1])
    return (v0 - v1, v2 - v0 - v1)


def f2_sqr(P, a):
    re = P.mul(a[0] + a[1], a[0] - a[1])
    m = P.mul(a[0], a[1])
    return (re, m + m)


def f2_muls(P, a, s):
    return (P.mul(a[0], s), P.mul(a[1], s))


def f6_add(a, b):
    return tuple(f2_add(x, y) for x, y in zip(a, b))


def f6_sub(a, b):
    return tuple(f2_sub(x, y) for x, y in zip(a, b))


def f6_mul_v(a):
    return (f2_xi(a[2]), a[0], a[1])


def f6_mul(P, a, b):
    v0, v1, v2 = f2_mul(P, a[0], b[0]), f2_mul(P, a[1], b[1]), f2_mul(P, a[2], b[2])
    t12 = f2_mul(P, f2_add(a[1], a[2]), f2_add(b[1], b[2]))
    t01 = f2_mul(P, f2_add(a[0], a[1]), f2_add(b[0], b[1]))
    t02 = f2_mul(P, f2_add(a[0], a[2]), f2_add(b[0], b[2]))
    return (f2_add(v0, f2_xi(f2_sub(t12, f2_add(v1, v2)))),
            f2_add(f2_sub(t01, f2_add(v0, v1)), f2_xi(v2)),
            f2_add(f2_sub(t02, f2_add(v0, v2)), v1))


def f6_mul_by_01(P, a, d0, d1):
    p0, p1 = f2_mul(P, a[0], d0), f2_mul(P, a[2], d1)
    p2, p3 = f2_mul(P, a[0], d1), f2_mul(P, a[1], d0)
    p4, p5 = f2_mul(P, a[1], d1), f2_mul(P, a[2], d0)
    return (f2_add(p0, f2_xi(p1)), f2_add(p2, p3), f2_add(p4, p5))


def f6_mul_by_1(P, a, d1):
    return (f2_xi(f2_mul(P, a[2], d1)), f2_mul(P, a[0], d1), f2_mul(P, a[1], d1))


def f12_mul(P, a, b, a_sum, b_sum):
    """tower.cuh f12_mul, with the Karatsuba sums a.c0 + a.c1 and b.c0 + b.c1
    given (materialized in slots)."""
    v0, v1 = f6_mul(P, a[0], b[0]), f6_mul(P, a[1], b[1])
    v2 = f6_mul(P, a_sum, b_sum)
    return (f6_add(v0, f6_mul_v(v1)), f6_sub(v2, f6_add(v0, v1)))


def f12_sqr_products(P, a, s, t_in):
    """tower.cuh f12_sqr's two Fp6 products, with s = a.c0 + a.c1 and
    t_in = a.c0 + v a.c1 given: (v0, t)."""
    return f6_mul(P, a[0], a[1]), f6_mul(P, s, t_in)


def f12_sqr_out(v0, t):
    return (f6_sub(f6_sub(t, v0), f6_mul_v(v0)), f6_add(v0, v0))


def f12_mul_014(P, f, c0, c1, c4):
    v0 = f6_mul_by_01(P, f[0], c0, c1)
    v1 = f6_mul_by_1(P, f[1], c4)
    t = f6_mul_by_01(P, f6_add(f[0], f[1]), c0, f2_add(c1, c4))
    return (f6_add(v0, f6_mul_v(v1)), f6_sub(t, f6_add(v0, v1)))


def f12_cyclotomic_sqr(P, f):
    """tower.cuh f12_cyclotomic_sqr: -> the new f."""
    z0, z1, z2, z3, z4, z5 = f[0][0], f[1][1], f[1][0], f[0][2], f[0][1], f[1][2]
    s0, s1, s2 = f2_sqr(P, z0), f2_sqr(P, z1), f2_sqr(P, z2)
    s3, s4, s5 = f2_sqr(P, z3), f2_sqr(P, z4), f2_sqr(P, z5)
    s01 = f2_sqr(P, f2_add(z0, z1))
    s23 = f2_sqr(P, f2_add(z2, z3))
    s45 = f2_sqr(P, f2_add(z4, z5))
    t00, t20, t40 = f2_add(s0, f2_xi(s1)), f2_add(s2, f2_xi(s3)), f2_add(s4, f2_xi(s5))
    t01 = f2_sub(s01, f2_add(s0, s1))
    t21 = f2_sub(s23, f2_add(s2, s3))
    t41 = f2_sub(s45, f2_add(s4, s5))

    def m3m2(t, z):
        r = f2_sub(t, z)
        return f2_add(f2_add(r, r), t)

    def p3p2(t, z):
        r = f2_add(t, z)
        return f2_add(f2_add(r, r), t)

    n0, n1 = m3m2(t00, z0), p3p2(t01, z1)
    n2, n3 = p3p2(f2_xi(t41), z2), m3m2(t40, z3)
    n4, n5 = m3m2(t20, z4), p3p2(t21, z5)
    return ((n0, n4, n3), (n2, n1, n5))


# ------------------------------------------------------------------ helpers

def fp2s(xs):
    return [(xs[2 * i], xs[2 * i + 1]) for i in range(len(xs) // 2)]


def fp6(xs):
    return tuple(fp2s(xs))


def fp12(xs):
    return (fp6(xs[:6]), fp6(xs[6:]))


def flat(v):
    """An Fp2 / Fp6 / Fp12 value as its list of Fp forms, coefficient-major."""
    return [v] if isinstance(v, Lin) else [x for c in v for x in flat(c)]


def store_all(P, dsts, values):
    for d, v in zip(dsts, flat(values)):
        P.store(d, v)


# ------------------------------------------------------------------ programs

def exp_x_program():
    """exp_x: f from the input (slots 0-11); m = f and the Karatsuba sum of
    m's halves once (body setup); a Granger-Scott square (body square: 18
    products, then f in place); f <- f * m (body mul: the sum of f's
    halves, 54 products, f)."""
    P = Program("exp_x")
    f, m = P.named("f", 12), P.named("m", 12)
    ms, fs = P.named("m_sum", 6), P.named("f_sum", 6)
    P.body("setup")
    P.phase()
    store_all(P, m, fp12(f))
    store_all(P, ms, f6_add(fp12(f)[0], fp12(f)[1]))
    P.body("square")
    P.phase()
    out = f12_cyclotomic_sqr(P, fp12(f))
    P.phase()
    store_all(P, f, out)
    P.body("mul")
    P.phase()
    store_all(P, fs, f6_add(fp12(f)[0], fp12(f)[1]))
    P.phase()
    out = f12_mul(P, fp12(f), fp12(m), fp6(fs), fp6(ms))
    P.phase()
    store_all(P, f, out)
    return P


def miller_program(k):
    """miller_dbl_run with k pairs: f, then per pair X, Y, Z, xp, yp in the
    slots of the packed operand's coordinates 0 .. 12 + 8k - 1; per pair a
    line and the doubling step's intermediates.
      body dbl: [pre: s, t_in of f^2]; [the 36 products of f^2 and the 11 of
        each pair's first doubling round]; [f^2 into f; per pair the
        intermediates a, b - f, e, g, b, h, 3j and the line's c0 = e - b];
        round two: [per pair 14 products, the line's c1 and c4 among them];
        [per pair X', Y', Z' into T].
      body line<p>: f <- f * line_p: [45 products]; [f]."""
    P = Program(f"miller{k}")
    f = P.named("f", 12)
    pairs = []
    for p in range(k):
        t = P.named(f"t{p}", 6)
        xp, yp = P.named(f"p{p}", 2)
        pairs.append((fp2s(t), xp, yp))
    lines = [P.named(f"line{p}", 6) for p in range(k)]
    inter = [P.named(f"dbl{p}", 14) for p in range(k)]
    pre = P.named("pre", 12)
    F = fp12(f)

    P.body("dbl")
    P.phase()
    s, t_in = f6_add(F[0], F[1]), f6_add(F[0], f6_mul_v(F[1]))
    store_all(P, pre, (s, t_in))
    P.phase()
    v0, t = f12_sqr_products(P, F, fp6(pre[:6]), fp6(pre[6:]))
    first = []
    for (X, Y, Z), _, _ in pairs:  # miller_dbl_step, first round
        xy = f2_mul(P, X, Y)
        b, c = f2_sqr(P, Y), f2_sqr(P, Z)
        yz2 = f2_sqr(P, f2_add(Y, Z))
        j = f2_sqr(P, X)
        first.append((xy, b, c, yz2, j))
    P.phase()
    store_all(P, f, f12_sqr_out(v0, t))
    for p, (xy, b, c, yz2, j) in enumerate(first):
        e = f2_scale(f2_xi(f2_scale(c, 3)), 4)
        ff = f2_scale(e, 3)
        a = f2_half(xy)
        g = f2_half(f2_add(b, ff))
        h = f2_sub(yz2, f2_add(b, c))
        store_all(P, inter[p], (a, f2_sub(b, ff), e, g, b, h, f2_scale(j, 3)))
        store_all(P, lines[p][:2], f2_sub(e, b))
    P.round()
    P.phase()
    second = []
    for p, (_, xp, yp) in enumerate(pairs):  # second round
        a, bmf, e, g, b, h, j3 = fp2s(inter[p])
        e2 = f2_sqr(P, e)
        x3 = f2_mul(P, a, bmf)
        g2 = f2_sqr(P, g)
        z3 = f2_mul(P, b, h)
        for d, x in zip(lines[p][2:4], j3):  # the line's c1 = 3j xp
            P.mul(x, xp, dst=d)
        for d, x in zip(lines[p][4:], f2_neg(h)):  # and c4 = -h yp
            P.mul(x, yp, dst=d)
        second.append((x3, f2_sub(g2, f2_scale(e2, 3)), z3))
    P.phase()
    for (t, _, _), new in zip(pairs, second):
        store_all(P, flat(t), new)

    for p in range(k):
        P.body(f"line{p}")
        P.phase()
        c0, c1, c4 = fp2s(lines[p])
        out = f12_mul_014(P, F, c0, c1, c4)
        P.phase()
        store_all(P, f, out)
    return P


# ------------------------------------------------------------ point programs
# A point program's kernel runs its script (group.cuh run_script): a list of
# steps, each a body, an addition (the body add, then the body of the case
# that its flags pick: add_case) or a ladder over the kernel's segments
# (take_base, then per segment len doublings and, where it ends on a set
# bit, an addition).
BODY, ADD, LADDER = range(3)
# curve.cuh's Jacobian formulas on symbolic coordinates: Fp (G1) a Lin,
# Fp2 (G2) a pair of them.  A point is (X, Y, Z).

class Coord:
    """A coordinate field of the point programs: width 1 (Fp) or 2 (Fp2)."""

    def __init__(self, width):
        self.width = width

    def add(self, a, b):
        return a + b if self.width == 1 else f2_add(a, b)

    def sub(self, a, b):
        return a - b if self.width == 1 else f2_sub(a, b)

    def neg(self, a):
        return -a if self.width == 1 else f2_neg(a)

    def scale(self, a, k):
        return a.scale(k) if self.width == 1 else f2_scale(a, k)

    def mul(self, P, a, b):
        return P.mul(a, b) if self.width == 1 else f2_mul(P, a, b)

    def sqr(self, P, a):  # an Fp square is the Montgomery product a * a
        return P.mul(a, a) if self.width == 1 else f2_sqr(P, a)

    def point(self, slots):
        """The point whose 3 * width coordinate slots are `slots`."""
        if self.width == 1:
            return tuple(slots)
        return tuple(fp2s(slots))

    def infinity(self, one):
        """(one, one, 0): the complete addition's P == -Q result."""
        o = one if self.width == 1 else (one, Lin())
        z = Lin() if self.width == 1 else (Lin(), Lin())
        return (o, o, z)


FP_COORD, FP2_COORD = Coord(1), Coord(2)


def pt_dbl_rounds(P, F, p):
    """curve.cuh pt_dbl (_pt_dbl_body) in three product phases: a = X^2,
    b = Y^2, Y Z; d = b^2, X b, a^2; a (s - 3 a^2).  Its values, regrouped
    so that the operands stay unreduced: with s = 2((X + b)^2 - a - d) =
    4 X b and m = 3a, x3 = m^2 - 2s = 9 a^2 - 2s, y3 = m (s - x3) - 8d =
    9 a (s - 3 a^2) - 8d and z3 = (Y + Z)^2 - b - Z^2 = 2 Y Z, the same
    polynomials (Fp2: 17 products, Fp: 7).  -> (x3, y3, z3), with the
    third phase still open for more products."""
    X, Y, Z = p
    P.phase()
    a, b, yz = F.sqr(P, X), F.sqr(P, Y), F.mul(P, Y, Z)
    P.phase()
    d, xb, aa = F.sqr(P, b), F.mul(P, X, b), F.sqr(P, a)
    s = F.scale(xb, 4)
    x3 = F.sub(F.scale(aa, 9), F.scale(s, 2))
    P.phase()
    t = F.mul(P, a, F.sub(s, F.scale(aa, 3)))
    return x3, F.sub(F.scale(t, 9), F.scale(d, 8)), F.scale(yz, 2)


def pt_add_rounds(P, F, p, q):
    """The generic sum of curve.cuh pt_add (_pt_add_body) in five product
    phases: Z1^2, Z2^2, Z1 Z2; u1, u2, Y1 Z2^2, Y2 Z1^2; s1, s2, h^2, z3;
    h^3, v, r^2; r (v - x3), s1 h^3.  -> ((x3, y3, z3), h, r)."""
    (X1, Y1, Z1), (X2, Y2, Z2) = p, q
    P.phase()
    z1z1, z2z2, z1z2 = F.sqr(P, Z1), F.sqr(P, Z2), F.mul(P, Z1, Z2)
    P.phase()
    u1, u2 = F.mul(P, X1, z2z2), F.mul(P, X2, z1z1)
    t1, t2 = F.mul(P, Y1, z2z2), F.mul(P, Y2, z1z1)
    P.phase()
    s1, s2 = F.mul(P, t1, Z2), F.mul(P, t2, Z1)
    h = F.sub(u2, u1)
    hh, z3 = F.sqr(P, h), F.mul(P, z1z2, h)
    P.phase()
    r = F.sub(s2, s1)
    hhh, v, rr = F.mul(P, h, hh), F.mul(P, u1, hh), F.sqr(P, r)
    x3 = F.sub(F.sub(rr, hhh), F.scale(v, 2))
    P.phase()
    y3 = F.sub(F.mul(P, r, F.sub(v, x3)), F.mul(P, s1, hhh))
    return (x3, y3, z3), h, r


def ladder_bodies(P, F):
    """The bodies of the constant-scalar ladder and the complete addition on
    point_slots (group.cuh run_script and add_case run them):
      take_base  acc = base;
      dbl        acc = 2 acc (3 product phases, then acc);
      add        the generic sum acc + base into sum, with h and r, whose
                 zero flags and those of acc's and base's Z pick the case;
      take_sum   acc = sum;
      set_inf    acc = (one, one, 0)."""
    acc, base = P.slot_list("acc"), P.slot_list("base")
    sm, h, r = P.slot_list("sum"), P.slot_list("h"), P.slot_list("r")
    (one,) = P.slot_list("one")
    P.consts["kCoord"] = F.width
    P.body("take_base")
    P.phase()
    store_all(P, acc, base)
    P.body("dbl")
    new = pt_dbl_rounds(P, F, F.point(acc))
    P.phase()
    store_all(P, acc, new)
    P.body("add")
    new, hv, rv = pt_add_rounds(P, F, F.point(acc), F.point(base))
    P.phase()
    store_all(P, sm + h + r, (new, hv, rv))
    P.body("take_sum")
    P.phase()
    store_all(P, acc, sm)
    P.body("set_inf")
    P.phase()
    store_all(P, acc, F.infinity(one))


def point_slots(P, F):
    """The named slots of a point program over F: the accumulator, the base
    (P + Q's Q), the sum, h and r (width coordinates each) and the one."""
    w = F.width
    for name, count in (("acc", 3 * w), ("base", 3 * w), ("sum", 3 * w), ("h", w), ("r", w),
                        ("one", 1)):
        P.named(name, count)


def ladder_program(F):
    """pt_mul_const over F: the point in base, the Montgomery one in one;
    the script a ladder, the result in acc."""
    P = Program("ladder_g1" if F.width == 1 else "ladder_g2")
    point_slots(P, F)
    ladder_bodies(P, F)
    P.script = [(LADDER, None)]
    return P


def cofactor_program():
    """g2_cofactor (hash_kernels.cu): P in p, the constants cx, cy (Fp2) and
    c2 (Fp) of psi and psi^2 and the one in their slots, then, in the order
    of the one-thread body (every intermediate the same representative):
      start     base = P;                  ladder: acc = L1 = [|x|]P
      x1        base = xp = -L1, t1 = L1;  ladder: acc = L2 = [|x|]xp
      aux_in    t2 = xxp = -L2, base = -P; then acc = xp;  add: aux
      psi_aux   t3 = psi(aux); then acc = xxp, base = L1 = -xp;  add
      sub_p     base = -P;  add
      add_psi   base = t3;  add
      psi2_2p   base = psi^2(2P) (the doubling traced on p, c2 x3 beside
                its last product);  add."""
    F = FP2_COORD
    P = Program("g2_cofactor")
    point_slots(P, F)
    p, t1, t2, t3 = (P.named(name, 6) for name in ("p", "t1", "t2", "t3"))
    cx, cy = fp2s(P.named("cx", 2))[0], fp2s(P.named("cy", 2))[0]
    (c2,) = P.named("c2", 1)
    ladder_bodies(P, F)
    acc, base = P.slot_list("acc"), P.slot_list("base")

    def neg(q):
        X, Y, Z = F.point(q)
        return (X, F.neg(Y), Z)

    P.body("start")
    P.phase()
    store_all(P, base, p)
    P.body("x1")
    P.phase()
    store_all(P, base + t1, (neg(acc), acc))
    P.body("aux_in")
    P.phase()
    store_all(P, t2 + base, (neg(acc), neg(p)))
    P.phase()
    store_all(P, acc, neg(t1))
    P.body("psi_aux")
    P.phase()
    X, Y, Z = F.point(acc)
    px, py = f2_mul(P, (X[0], -X[1]), cx), f2_mul(P, (Y[0], -Y[1]), cy)
    P.phase()
    store_all(P, t3, (px, py, (Z[0], -Z[1])))
    P.phase()
    store_all(P, acc + base, (t2, t1))
    P.body("sub_p")
    P.phase()
    store_all(P, base, neg(p))
    P.body("add_psi")
    P.phase()
    store_all(P, base, t3)
    P.body("psi2_2p")
    x3, y3, z3 = pt_dbl_rounds(P, F, F.point(p))
    cx3 = f2_muls(P, x3, c2)
    P.phase()
    store_all(P, base, (cx3, F.neg(y3), z3))
    P.script = [(BODY, "start"), (LADDER, None), (BODY, "x1"), (LADDER, None)]
    for body in ("aux_in", "psi_aux", "sub_p", "add_psi", "psi2_2p"):
        P.script += [(BODY, body), (ADD, "add")]
    return P


def programs():
    return ([exp_x_program()] + [miller_program(k) for k in MILLER_PAIRS]
            + [ladder_program(FP_COORD), ladder_program(FP2_COORD), cofactor_program()])


def elements_per_block(P, g):
    """Elements per block of the kernel of program P at G = g (group.cuh)."""
    return min(THREADS // g, MAX_SHARED // (P.nslots * SLOT_BYTES))


def shared_bytes(P, g):
    """Dynamic shared memory of a block of the kernel of program P at G = g."""
    return elements_per_block(P, g) * P.nslots * SLOT_BYTES


def check_phases(P):
    """No op of a phase writes a slot that another op of it reads or writes,
    and a phase holds products only or combinations only."""
    for name, phases in P.bodies.items():
        for i, ops in enumerate(phases):
            if len({op.b is None for op in ops}) != 1:
                raise ValueError(f"{P.name}.{name} phase {i}: products and combinations")
            dsts = [op.dst for op in ops]
            if len(set(dsts)) != len(dsts):
                raise ValueError(f"{P.name}.{name} phase {i}: a slot written twice")
            for op in ops:
                for other in ops:
                    if other is not op and op.dst in other.reads():
                        raise ValueError(f"{P.name}.{name} phase {i}: slot {op.dst} "
                                         f"written and read")


def products(P, body):
    return sum(op.b is not None for ops in P.bodies[body] for op in ops)


# ------------------------------------------------------------ the interpreter

R = 1 << 384
_INV_TOP = 1.0 / (float(C.P >> 352) + 1.0)  # group.cuh: 1 / (p's top word + 1)


def eval_exact(form, mode, slots):
    """A form's value as group.cuh's eval_form computes it, on Python ints
    (and the same IEEE double for q), with its bounds checked."""
    if mode == COPY:
        (s,) = form.c
        return slots[s]
    pos = sum(k * slots[s] for s, k in form.c.items() if k > 0)
    neg = sum(-k * slots[s] for s, k in form.c.items() if k < 0)
    v = pos - neg + sum(-k for k in form.c.values() if k < 0) * C.P
    if not 0 <= v <= form.weight() * C.P or v >> 416:
        raise AssertionError("form sum out of range")
    if mode >= REDUCED:
        q = int(float(v >> 352) * _INV_TOP)
        v -= q * C.P
        if not 0 <= v < 3 * C.P:
            raise AssertionError("quotient estimate out of range")
    if mode == CANONICAL:
        v -= 2 * C.P if v >= 2 * C.P else 0
        v -= C.P if v >= C.P else 0
        for _ in range(form.h):
            v = (v + C.P if v & 1 else v) >> 1
    elif form.h:
        raise AssertionError("halving of an operand")
    return v


def run_body(P, body, slots):
    """Run `body` on a list of canonical ints (Montgomery form, R = 2^384),
    phase by phase as the kernels do: every op of a phase reads the slots as
    the phase found them."""
    rinv = pow(R, -1, C.P)
    for ops in P.bodies[body]:
        out = []
        for op in ops:
            ma, mb = op.modes()
            v = eval_exact(op.a, ma, slots)
            if op.b is not None:
                w = eval_exact(op.b, mb, slots)
                if not (v < R and w < R and v * w < C.P * R):
                    raise AssertionError("mont_mul operands out of range")
                v = v * w * rinv % C.P
            out.append((op.dst, v))
        for dst, v in out:
            slots[dst] = v
    return slots


def add_case(P, slots):
    """The body that the complete addition's case picks after the body add,
    or None (group.cuh add_case; curve.cuh pt_add, in _pt_add_body's order):
    P at infinity -> take_base; Q at infinity -> none (acc is P); h = r =
    0 -> dbl; h = 0 -> set_inf; else take_sum."""
    c = P.consts["kCoord"]

    def zero(name, off=0):
        first = P.slots[name][0] + off
        return not any(slots[first:first + c])

    if zero("acc", 2 * c):
        return "take_base"
    if zero("base", 2 * c):
        return None
    if zero("h"):
        return "dbl" if zero("r") else "set_inf"
    return "take_sum"


def run_script(P, segments, slots):
    """Run a point program's script on a list of canonical ints, as
    group.cuh run_script does: `segments` the ladder's (len, set bit) runs."""

    def add():
        run_body(P, "add", slots)
        case = add_case(P, slots)
        if case:
            run_body(P, case, slots)

    for kind, body in P.script:
        if kind == BODY:
            run_body(P, body, slots)
        elif kind == ADD:
            add()
        else:
            run_body(P, "take_base", slots)
            for length, mul in segments:
                for _ in range(length):
                    run_body(P, "dbl", slots)
                if mul:
                    add()
    return slots


# ---------------------------------------------------------------- the header

def _tables(progs):
    """(terms, forms, ops, phases, {(program, body): (first, last phase)},
    script steps, {program: (first, last step)})."""
    terms, forms, ops, phases, ranges = [], [], [], [], {}
    steps, scripts = [], {}
    index = {}  # (terms, mode, halvings) -> form: a square's two operands are one form

    def form(lin, mode):
        """Positive terms first: the kernels add them, then the others."""
        items = sorted(lin.c.items(), key=lambda sk: (sk[1] < 0, sk[0]))
        key = (tuple(items), mode, lin.h)
        if key in index:
            return index[key]
        npos = sum(k > 0 for _, k in items)
        if len(items) >= 64 or lin.h > 3 or len(terms) >= 1 << 14:
            raise ValueError("form out of range")
        forms.append(len(terms) | len(items) << 14 | npos << 20 | mode << 26 | lin.h << 28)
        for s, k in items:
            if not (0 <= s < 256 and 0 < abs(k) < 256):
                raise ValueError(f"term ({s}, {k}) out of range")
            terms.append(s | abs(k) << 8)
        index[key] = len(forms) - 1
        return index[key]

    for P in progs:
        check_phases(P)
        for name, body in P.bodies.items():
            first = len(phases)
            for body_ops in body:
                phases.append(len(ops))
                # costliest first: the round-robin deal gives each step's
                # threads ops of about one cost
                for op in sorted(body_ops, key=lambda o: -o.cost()):
                    ma, mb = op.modes()
                    ops.append((form(op.a, ma) | op.dst << 16,
                                0xFFFFFFFF if op.b is None else form(op.b, mb)))
            ranges[(P.name, name)] = (first, len(phases))
    phases.append(len(ops))
    if len(forms) >= 1 << 16 or len(phases) >= 1 << 16:
        raise ValueError("tables too large")
    for P in progs:
        if P.script:
            first = len(steps)
            for kind, body in P.script:
                a, b = ranges[(P.name, body)] if body else (0, 0)
                steps.append((kind, a | b << 16))
            scripts[P.name] = (first, len(steps))
    return terms, forms, ops, phases, ranges, steps, scripts


def _array(ctype, name, values, per_line=8, fmt="{}"):
    rows = [", ".join(fmt.format(v) for v in values[i:i + per_line])
            for i in range(0, len(values), per_line)]
    return (f"static __device__ const {ctype} {name}[{len(values)}] = {{\n    "
            + ",\n    ".join(rows) + "};\n")


def render():
    """The text of csrc/group_rounds.cuh."""
    progs = programs()
    terms, forms, ops, phases, ranges, steps, scripts = _tables(progs)
    out = [
        "// Generated by bls_verify_gadget_tpu_torch/ops/group_rounds.py: do not edit.",
        "// python3 -m bls_verify_gadget_tpu_torch.ops.group_rounds rewrites it.",
        "//",
        "// The round-wise bodies of the group kernels (group.cuh), as tables:",
        "//   kGroupTerms  a term: slot | |coefficient| << 8",
        "//   kGroupForms  a linear form: first term | terms << 14 | positive terms",
        "//                << 20 | mode << 26 | halvings << 28 (mode: 0 the slot,",
        "//                1 the sum, 2 below 3p, 3 canonical; group_rounds.py)",
        "//   kGroupOps    an op: {form A | destination slot << 16, form B or ~0u",
        "//                for a combination}",
        "//   kGroupPhases the first op of each phase (and the end of the last)",
        "//   kGroupScript a point program's step: {kind (0 a body, 1 an addition,",
        "//                2 a ladder), its body's first | last phase << 16}",
        "// and per program its slot count, named slots, bodies [first, last",
        "// phase) and script [first, last step).  Products per body in the",
        "// comments.",
        "#pragma once",
        "",
        "#include <cstdint>",
        "",
        "namespace bls {",
        "namespace group {",
        "",
        f"constexpr int kThreads = {THREADS};  // threads per block of a group kernel, or",
        f"constexpr int kMaxShared = {MAX_SHARED};  // fewer where the slots would pass this",
        "",
    ]
    for P in progs:
        cname = "".join(w.capitalize() for w in P.name.split("_"))
        out.append(f"struct {cname}Program {{")
        out.append(f"  static constexpr int kSlots = {P.nslots};")
        for name, value in P.consts.items():
            out.append(f"  static constexpr int {name} = {value};")
        for name, (first, count) in P.slots.items():
            out.append(f"  static constexpr int kSlot_{name} = {first};  // {count} slots")
        for name in P.bodies:
            a, b = ranges[(P.name, name)]
            out.append(f"  static constexpr int kBody_{name} = {a}, kEnd_{name} = {b};"
                       f"  // {products(P, name)} products")
        if P.name in scripts:
            a, b = scripts[P.name]
            out.append(f"  static constexpr int kScript = {a}, kEndScript = {b};")
        out.append("};")
        out.append("")
    out.append(_array("uint16_t", "kGroupTerms", terms, 12, "0x{:04x}"))
    out.append(_array("uint32_t", "kGroupForms", forms, 6, "0x{:08x}u"))
    out.append(_array("uint2", "kGroupOps", [f"{{0x{a:08x}u, 0x{b:08x}u}}" for a, b in ops], 3))
    out.append(_array("uint16_t", "kGroupPhases", phases, 12))
    out.append(_array("uint2", "kGroupScript", [f"{{{k}u, 0x{r:08x}u}}" for k, r in steps], 4))
    out += ["}  // namespace group", "}  // namespace bls", ""]
    return "\n".join(out)


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")

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

The forms come from tracing the plain versions' formulas (the Fp6 and Fp12
products, the line product and the Granger-Scott square: ops/tower.py's and
ops/pairing.py's) with symbolic values (Lin below): every value is the same
polynomial in the inputs as there, and every slot holds a canonical
residue, so the kernels' limbs equal the plain versions' whatever the
grouping of products and sums.  The Miller line and T are ops/pairing.py's
_dbl_step and _add_step formulas, and the Granger-Scott
square is ops/tower.py's fp12_cyclotomic_sqr_plain formula (both matter
off the curve and off the cyclotomic subgroup); the Fp12 square and
products are exact products.
The point programs (pt_mul_const, g2_cofactor, sswu_map2, pt_mul_var,
pt_add, pt_dbl) trace ops/curve.py's Jacobian doubling and complete
addition: the Jacobian representative is the formulas' polynomial, so the
doubling may regroup it (pt_dbl_rounds), and the addition's exceptional
cases keep its order (add_case).  sswu_map2 traces ops/hash_to_g2.py's
SSWU formulas (its fractions and output keep their representatives) and
runs its exponent chains in lockstep (POW) and its data-dependent choices
as cases (CASE).

Every value gets a slot of its own while a program is traced, auto
bodies are scheduled into phases by their data (Program._flush), and
allocate() then gives the values the kernel's slots by liveness over the
order in which the kernel runs the bodies (its script, or the program's
flow: loops and branches included), so a slot is reused once its value
is dead (sswu_map2: 106 slots).

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
    """The slots and bodies of one kernel.  While a program is traced, every
    named range and every product is a value with slots of its own (slot
    numbers in tracing order); allocate() then gives the values the
    kernel's slots by liveness over the order in which the kernel runs the
    bodies (its script, or `flow`), so a slot is reused once its value is
    dead.  A body's phases are placed by hand (phase()), or the body is
    auto: its ops are then scheduled into phases by their data (_flush)."""

    def __init__(self, name):
        self.name = name
        self.slots = {}  # name -> (first, count)
        self.consts = {}  # name -> value, emitted beside the slots
        self.nslots = 0
        self.bodies = {}  # name -> list of phases (lists of Op)
        self.script = []  # a point program's steps (run_script): (kind, argument)
        # the order in which a kernel without a script runs the bodies (_flow)
        self.flow = None
        # CASE steps: name -> ([flag: (named range, offset, slots, ZERO | PARITY)],
        #                      [rule: (mask, value, body or None)])
        self.cases = {}
        # a POW step's chains: (table range, o range, f range, width, exponent index)
        self.chains = []
        self.pow_bits = 0  # a POW step's window width
        # named ranges: the kernel's loads (the inputs at slots 0 and up, in
        # order), its constants and its stores
        self.inputs, self.presets, self.outputs = [], [], []
        self._phases = None
        self._pending = None  # an auto body's ops, in program order

    def named(self, name, count):
        self.slots[name] = (self.nslots, count)
        self.nslots += count
        return self.slot_list(name)

    def slot_list(self, name):
        first, count = self.slots[name]
        return [Lin.slot(s) for s in range(first, first + count)]

    def fresh(self):
        """A slot of its own."""
        self.nslots += 1
        return Lin.slot(self.nslots - 1)

    def body(self, name, auto=False):
        """Start body `name`; an auto body schedules its ops itself."""
        self._flush()
        self._phases = self.bodies.setdefault(name, [])
        if auto:
            self._pending = []

    def phase(self):
        if self._pending is not None:
            raise ValueError("phase() in an auto body")
        self._phases.append([])

    def mul(self, a, b, dst=None):
        """A product into a fresh slot, or into the named slot `dst`."""
        s = _slot_of(self.fresh() if dst is None else dst)
        self._op(Op(s, a, b))
        return Lin.slot(s)

    def store(self, dst, a):
        """A combination into the named slot `dst`."""
        self._op(Op(_slot_of(dst), a))

    def _op(self, op):
        if self._pending is not None:
            self._pending.append(op)
        else:
            self._phases[-1].append(op)

    def _flush(self):
        """Schedule the pending ops of an auto body into its phases: each op
        one level after every earlier op of the body that writes a slot it
        reads or that reads or writes its destination (as early as its data
        allows: a stored value frees the product slots it reads), then a
        phase per level and kind, products first."""
        ops, self._pending = self._pending, None
        if not ops:
            return
        level, wrote, read = [], {}, {}
        for op in ops:
            lv = 1 + max([wrote.get(s, 0) for s in op.reads()]
                         + [read.get(op.dst, 0), wrote.get(op.dst, 0)])
            level.append(lv)
            for s in op.reads():
                read[s] = max(read.get(s, 0), lv)
            wrote[op.dst] = lv
        keys = sorted({(lv, op.b is None) for lv, op in zip(level, ops)})
        phases = {k: [] for k in keys}
        for lv, op in zip(level, ops):
            phases[(lv, op.b is None)].append(op)
        self._phases.extend(phases[k] for k in keys)

    def allocate(self):
        """The kernel's slots by liveness (_allocate)."""
        self._flush()
        _allocate(self)
        return self


# ----------------------------------------------------------------- the tower
# ops/tower.py's Fp2, Fp6 and Fp12 products and ops/pairing.py's line, on
# symbolic values: Fp a Lin, Fp2 a pair, Fp6 a triple of Fp2, Fp12 a pair of
# Fp6.

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
    """ops/tower.py fp12_mul_plain's Karatsuba over Fp6, with the sums
    a.c0 + a.c1 and b.c0 + b.c1 given (materialized in slots)."""
    v0, v1 = f6_mul(P, a[0], b[0]), f6_mul(P, a[1], b[1])
    v2 = f6_mul(P, a_sum, b_sum)
    return (f6_add(v0, f6_mul_v(v1)), f6_sub(v2, f6_add(v0, v1)))


def f12_sqr_products(P, a, s, t_in):
    """ops/tower.py fp12_sqr_plain's two Fp6 products, with s = a.c0 + a.c1
    and t_in = a.c0 + v a.c1 given: (v0, t)."""
    return f6_mul(P, a[0], a[1]), f6_mul(P, s, t_in)


def f12_sqr_out(v0, t):
    return (f6_sub(f6_sub(t, v0), f6_mul_v(v0)), f6_add(v0, v0))


def f12_mul_014(P, f, c0, c1, c4):
    v0 = f6_mul_by_01(P, f[0], c0, c1)
    v1 = f6_mul_by_1(P, f[1], c4)
    t = f6_mul_by_01(P, f6_add(f[0], f[1]), c0, f2_add(c1, c4))
    return (f6_add(v0, f6_mul_v(v1)), f6_sub(t, f6_add(v0, v1)))


def f12_cyclotomic_sqr(P, f):
    """ops/tower.py fp12_cyclotomic_sqr_plain's Granger-Scott square (the
    JAX _gs_body) in its z-ordering: -> the new f."""
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
    square_body(P, f)
    P.body("mul")
    P.phase()
    store_all(P, fs, f6_add(fp12(f)[0], fp12(f)[1]))
    P.phase()
    out = f12_mul(P, fp12(f), fp12(m), fp6(fs), fp6(ms))
    P.phase()
    store_all(P, f, out)
    P.inputs = P.outputs = ["f"]
    P.flow = ["setup", ("loop", ("alt", "square", "mul"))]
    return P.allocate()


def square_body(P, f):
    """The body square of exp_x and cyclo_sqr: a Granger-Scott square of f
    (f12_cyclotomic_sqr): [18 products]; [f in place]."""
    P.body("square")
    P.phase()
    out = f12_cyclotomic_sqr(P, fp12(f))
    P.phase()
    store_all(P, f, out)


def cyclo_sqr_program():
    """cyclo_sqr: f from the input (slots 0-11); body square, exp_x's (its
    kernel runs it `count` times)."""
    P = Program("cyclo_sqr")
    f = P.named("f", 12)
    square_body(P, f)
    P.inputs = P.outputs = ["f"]
    P.flow = ("loop", "square")
    return P.allocate()


def mul014_program():
    """mul014: f and the line c0, c1, c4 from the input (slots 0-17); body
    line0, the Miller programs' (line_bodies): f <- f * line, [45
    products]; [f]."""
    P = Program("mul014")
    f, line = P.named("f", 12), P.named("line0", 6)
    line_bodies(P, f, [line])
    P.inputs, P.outputs = ["f", "line0"], ["f"]
    P.flow = "line0"
    return P.allocate()


def fp12_mul_program():
    """fp12_mul: a and b from the input (slots 0-23); body mul: [the
    Karatsuba sums a.c0 + a.c1 and b.c0 + b.c1: 12 forms]; [the 54
    products of f12_mul, as exp_x's mul body traces them]; [the product
    into out]."""
    P = Program("fp12_mul")
    a, b = P.named("a", 12), P.named("b", 12)
    a_sum, b_sum = P.named("a_sum", 6), P.named("b_sum", 6)
    out = P.named("out", 12)
    A, B = fp12(a), fp12(b)
    P.body("mul")
    P.phase()
    store_all(P, a_sum, f6_add(A[0], A[1]))
    store_all(P, b_sum, f6_add(B[0], B[1]))
    P.phase()
    res = f12_mul(P, A, B, fp6(a_sum), fp6(b_sum))
    P.phase()
    store_all(P, out, res)
    P.inputs, P.outputs = ["a", "b"], ["out"]
    P.flow = "mul"
    return P.allocate()


def fp6_mul_program():
    """fp6_mul: a and b from the input (slots 0-11); body mul: [the 18
    products of f6_mul, the Karatsuba and Toom sums carried in the
    operands' forms]; [the Toom combination into out: 6 forms]."""
    P = Program("fp6_mul")
    a, b = P.named("a", 6), P.named("b", 6)
    out = P.named("out", 6)
    P.body("mul")
    P.phase()
    res = f6_mul(P, fp6(a), fp6(b))
    P.phase()
    store_all(P, out, res)
    P.inputs, P.outputs = ["a", "b"], ["out"]
    P.flow = "mul"
    return P.allocate()


def fp12_sqr_program():
    """fp12_sqr: a from the input (slots 0-11); body sqr: [s = a.c0 + a.c1
    and t_in = a.c0 + v a.c1: 12 forms, as the Miller programs' pre]; [the
    36 products of f12_sqr_products]; [the square into out]."""
    P = Program("fp12_sqr")
    a = P.named("a", 12)
    pre = P.named("pre", 12)
    out = P.named("out", 12)
    A = fp12(a)
    P.body("sqr")
    P.phase()
    store_all(P, pre, (f6_add(A[0], A[1]), f6_add(A[0], f6_mul_v(A[1]))))
    P.phase()
    v0, t = f12_sqr_products(P, A, fp6(pre[:6]), fp6(pre[6:]))
    P.phase()
    store_all(P, out, f12_sqr_out(v0, t))
    P.inputs, P.outputs = ["a"], ["out"]
    P.flow = "sqr"
    return P.allocate()


def miller_program(k):
    """miller_dbl_run with k pairs: f, then per pair X, Y, Z, xp, yp in the
    slots of the packed operand's coordinates 0 .. 12 + 8k - 1; per pair a
    line and the doubling step's intermediates.
      body dbl: [pre: s, t_in of f^2]; [the 36 products of f^2 beside each
        pair's first doubling round, dbl_first_round]; [f^2 into f beside
        the doubling's intermediates]; the doubling's second round
        (dbl_second_round).
      body line<p>: f <- f * line_p: [45 products]; [f].
    A run repeats dbl, then line<p> for each valid pair."""
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
    first = dbl_first_round(P, pairs)
    P.phase()
    store_all(P, f, f12_sqr_out(v0, t))
    dbl_second_round(P, pairs, first, inter, lines)
    line_bodies(P, f, lines)
    P.inputs = ["f"] + [f"{n}{p}" for p in range(k) for n in "tp"]
    P.outputs = ["f"] + [f"t{p}" for p in range(k)]
    P.flow = ("loop", ["dbl"] + [("alt", None, f"line{p}") for p in range(k)])
    return P.allocate()


def dbl_first_round(P, pairs):
    """The CLN doubling step's first round (ops/pairing.py _dbl_step) for
    every pair (X, Y, Z), xp, yp into the open phase: 11 products per pair,
    X Y, Y^2, Z^2, (Y + Z)^2 and X^2."""
    first = []
    for (X, Y, Z), _, _ in pairs:
        xy = f2_mul(P, X, Y)
        b, c = f2_sqr(P, Y), f2_sqr(P, Z)
        yz2 = f2_sqr(P, f2_add(Y, Z))
        j = f2_sqr(P, X)
        first.append((xy, b, c, yz2, j))
    return first


def dbl_second_round(P, pairs, first, inter, lines):
    """The rest of the doubling step for every pair, from the open phase:
    the intermediates a, b - f, e, g, b, h, 3j into inter and the line's
    c0 = e - b; [14 products per pair, the line's c1 = 3j xp and c4 = -h
    yp among them]; [X', Y', Z' into T]."""
    for p, (xy, b, c, yz2, j) in enumerate(first):
        e = f2_scale(f2_xi(f2_scale(c, 3)), 4)
        ff = f2_scale(e, 3)
        a = f2_half(xy)
        g = f2_half(f2_add(b, ff))
        h = f2_sub(yz2, f2_add(b, c))
        store_all(P, inter[p], (a, f2_sub(b, ff), e, g, b, h, f2_scale(j, 3)))
        store_all(P, lines[p][:2], f2_sub(e, b))
    P.phase()
    second = []
    for p, (_, xp, yp) in enumerate(pairs):
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


def dbl_step_program():
    """dbl_step: T = X, Y, Z and the G1 point xp, yp from the input (slots
    0-7); body dbl, the Miller programs' doubling without f^2
    (ops/pairing.py _dbl_step): [11 products]; [the intermediates and the
    line's c0]; [14 products, c1 and c4 among them]; [T].  Out: T, then
    the line."""
    P = Program("dbl_step")
    t = P.named("t0", 6)
    xp, yp = P.named("p0", 2)
    line, inter = P.named("line0", 6), P.named("dbl0", 14)
    pairs = [(fp2s(t), xp, yp)]
    P.body("dbl")
    P.phase()
    first = dbl_first_round(P, pairs)
    P.phase()
    dbl_second_round(P, pairs, first, [inter], [line])
    P.inputs, P.outputs = ["t0", "p0"], ["t0", "line0"]
    P.flow = "dbl"
    return P.allocate()


def line_bodies(P, f, lines):
    """Per pair p the body line<p> of a Miller program: f <- f * line_p
    (f12_mul_014): [45 products]; [f]."""
    F = fp12(f)
    for p, line in enumerate(lines):
        P.body(f"line{p}")
        P.phase()
        c0, c1, c4 = fp2s(line)
        out = f12_mul_014(P, F, c0, c1, c4)
        P.phase()
        store_all(P, f, out)


def miller_add_program(k):
    """miller_add with k pairs: f, then per pair X, Y, Z, xq, yq, xp,
    yp in the slots of the packed operand's coordinates 0 .. 12 + 12k - 1;
    per pair a line.
      body add: ops/pairing.py _add_step for every pair at once, scheduled
        (auto): [yq Z, xq Z]; [theta^2, lambda^2 and the line's theta xq,
        lambda yq, -theta xp, lambda yp]; [e = lambda dd, f = Z cc, g = X
        dd]; [the line's c0]; [lambda h, Z e, theta (g - h), e Y]; [T].
      body line<p>: f <- f * line_p (line_bodies, as miller_program's)."""
    P = Program(f"miller_add{k}")
    f = P.named("f", 12)
    pairs = []
    for p in range(k):
        t, q = P.named(f"t{p}", 6), P.named(f"q{p}", 4)
        xp, yp = P.named(f"p{p}", 2)
        pairs.append((t, fp2s(q), xp, yp))
    lines = [P.named(f"line{p}", 6) for p in range(k)]
    P.inputs = ["f"] + [f"{n}{p}" for p in range(k) for n in "tqp"]
    P.outputs = ["f"] + [f"t{p}" for p in range(k)]
    P.body("add", auto=True)
    for (t, (xq, yq), xp, yp), line in zip(pairs, lines):
        X, Y, Z = fp2s(t)
        th = f2_sub(Y, f2_mul(P, yq, Z))
        lm = f2_sub(X, f2_mul(P, xq, Z))
        cc, dd = f2_sqr(P, th), f2_sqr(P, lm)
        e, ff, g = f2_mul(P, lm, dd), f2_mul(P, Z, cc), f2_mul(P, X, dd)
        h = f2_sub(f2_add(e, ff), f2_scale(g, 2))
        x3, z3 = f2_mul(P, lm, h), f2_mul(P, Z, e)
        y3 = f2_sub(f2_mul(P, th, f2_sub(g, h)), f2_mul(P, e, Y))
        store_all(P, line[:2], f2_sub(f2_mul(P, th, xq), f2_mul(P, lm, yq)))
        for d, x in zip(line[2:4], f2_neg(th)):  # c1 = -theta xp
            P.mul(x, xp, dst=d)
        for d, x in zip(line[4:], lm):  # c4 = lambda yp
            P.mul(x, yp, dst=d)
        store_all(P, t, (x3, y3, z3))
    line_bodies(P, f, lines)
    P.flow = ["add"] + [("alt", None, f"line{p}") for p in range(k)]
    return P.allocate()


# ------------------------------------------------------------ point programs
# A point program's kernel runs its script (group.cuh run_script): a list of
# steps, each
#   BODY    a body;
#   ADD     an addition: the body add, then the body of the case that its
#           flags pick (add_case);
#   LADDER  a ladder over the kernel's segments (take_base, then per segment
#           len doublings and, where it ends on a set bit, an addition);
#   POW     the program's chains in lockstep (run_pow);
#   CASE    the body that the first matching rule of a case picks from the
#           flags of named slots (pick_case);
#   LOAD    rows of the kernel's constant table into a named range;
#   VLADDER a ladder over the element's own scalar, MSB first over the
#           kernel's nbits bits: set_inf, then per bit dbl and an addition
#           whose case is none where the bit is clear (add_case's bit flag,
#           read from the slot scalar; group.cuh skips the addition where
#           the bit is clear in every element of its warp: the same
#           values).
BODY, ADD, LADDER, POW, CASE, LOAD, VLADDER = range(7)
ZERO, PARITY = range(2)  # a CASE flag: the slots all zero, the slot's value odd
ADD_CASES = ("take_base", "dbl", "set_inf", "take_sum")  # the bodies add_case picks
# ops/curve.py's Jacobian formulas on symbolic coordinates: Fp (G1) a Lin,
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
    """ops/curve.py pt_double (_pt_dbl_body) in three product phases: a = X^2,
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
    """The generic sum of ops/curve.py pt_add (_pt_add_body) in five product
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
    P.inputs, P.presets, P.outputs = ["base"], ["one"], ["acc"]
    P.script = [(LADDER, None)]
    return P.allocate()


def var_ladder_program(F):
    """pt_mul_var over F: the point in base, the Montgomery one in one and
    the element's scalar in scalar (its 16 raw 16-bit limbs as 8 words);
    the script a variable ladder (VLADDER), the result in acc.  From acc =
    (one, one, 0) per bit a doubling, then the complete addition of base
    where the bit is set: the plain version's double-and-add, in its order,
    so the Jacobian representative is its."""
    P = Program("var_ladder_g1" if F.width == 1 else "var_ladder_g2")
    point_slots(P, F)
    P.named("scalar", 1)
    ladder_bodies(P, F)
    P.inputs, P.presets, P.outputs = ["base"], ["one", "scalar"], ["acc"]
    P.script = [(VLADDER, None)]
    return P.allocate()


def add_program(F):
    """pt_add over F: P in acc, Q in base, the Montgomery one in one; the
    script one complete addition (ADD: the body add, then the case that
    add_case picks: take_base where P is at infinity, none where Q is, dbl
    where P == Q, set_inf where P == -Q, else take_sum), the result in
    acc."""
    P = Program("pt_add_g1" if F.width == 1 else "pt_add_g2")
    point_slots(P, F)
    ladder_bodies(P, F)
    P.inputs, P.presets, P.outputs = ["acc", "base"], ["one"], ["acc"]
    P.script = [(ADD, "add")]
    return P.allocate()


def cofactor_program():
    """g2_cofactor (hash_kernels.cu): P in p, the constants cx, cy (Fp2) and
    c2 (Fp) of psi and psi^2 and the one in their slots, then, in the order
    of g2_cofactor_plain (every intermediate the same representative):
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
    P.inputs, P.presets, P.outputs = ["p"], ["one", "cx", "cy", "c2"], ["acc"]
    return P.allocate()


# ------------------------------------------------------------------ sswu_map2
# hash_to_g2.py's table of the SSWU constants (an Fp2 two rows): A, B, Z,
# Z A, Z^3 and Cz3 (the head's, rows 0-11), sqrt(u) (rows 12-13), sqrt(-u)
# and the isogeny's coefficients (rows 16-45).
SSWU_HEAD_ROWS, SSWU_SQI_ROW, SSWU_ISO_ROW, SSWU_ROWS = 12, 12, 16, 46
# Window width of the sqrt and inverse chains: 3-bit windows (tables of 7
# entries) keep sswu_map2 at 106 slots, so that 4096 elements fit the SMs'
# shared memory at once at G = 8; 4-bit windows (15 entries, a phase per
# window less for every 12 bits) need 165 slots, and 4096 elements would
# run in two waves.
SSWU_POW_BITS = 3


def keep(P, v):
    """v (an Fp form, or a tuple of them) with each form of several slots
    stored in a slot of its own: a value that later bodies read."""
    if isinstance(v, Lin):
        if len(v.c) <= 1 and not v.h:
            return v
        s = P.fresh()
        P.store(s, v)
        return s
    return tuple(keep(P, x) for x in v)


def _value(slots, width):
    """Slots as an Fp (width 1) or an Fp2."""
    return slots[0] if width == 1 else tuple(slots)


def _sq_into(P, a, dst):
    """a^2 into the slots dst, one product each: Fp a a; Fp2 (a0 + a1)(a0 -
    a1) and (2 a0) a1."""
    if isinstance(a, Lin):
        return P.mul(a, a, dst=dst[0])
    P.mul(a[0] + a[1], a[0] - a[1], dst=dst[0])
    P.mul(a[0].scale(2), a[1], dst=dst[1])
    return tuple(dst)


def _mul_into(P, a, b, v):
    """a b into a chain's product slots v, one product each: Fp a b; Fp2 the
    Karatsuba a0 b0, a1 b1, (a0 + a1)(b0 + b1) (_vform reads them)."""
    if isinstance(a, Lin):
        P.mul(a, b, dst=v[0])
        return
    P.mul(a[0], b[0], dst=v[0])
    P.mul(a[1], b[1], dst=v[1])
    P.mul(a[0] + a[1], b[0] + b[1], dst=v[2])


def _vform(v):
    """The value in a chain's product slots v (_mul_into)."""
    return v[0] if len(v) == 1 else (v[0] - v[1], v[2] - v[0] - v[1])


def pow_table(P, tab, width, base):
    """A chain's window table base^1 .. base^(2^bits - 1) into the slots tab
    (width each): base stored as the first entry; an even power the square
    of its half, into its slots; an odd one base^hi base^(e - hi) for the
    largest power of two hi < e (Fp: one product into its slot; Fp2: the
    product's form, stored).  The products read their operands' forms, so
    that the auto body schedules the table in `bits` levels of products."""
    if [(x.c, x.h) for x in flat(base)] != [(x.c, x.h) for x in tab[:width]]:
        store_all(P, tab[:width], base)
    val = [None, base]
    for e in range(2, len(tab) // width + 1):
        dst = tab[(e - 1) * width:e * width]
        if e % 2 == 0:
            val.append(_sq_into(P, val[e // 2], dst))
            continue
        hi = 1 << (e.bit_length() - 1)
        if width == 1:
            val.append(P.mul(val[hi], val[e - hi], dst=dst[0]))
        else:
            val.append(f2_mul(P, val[hi], val[e - hi]))
            store_all(P, dst, val[-1])


def horner(P, coeffs, x):
    """sum_i coeffs[i] x^i over Fp2 (_horner_rows)."""
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = f2_add(f2_mul(P, acc, x), c)
    return acc


def _sgn0_rules(off):
    """([(mask, value)] for sgn0 = 1, [...] for sgn0 = 0) of a value whose
    flags are bits off .. off + 2: its real part zero, the real part odd,
    the imaginary part odd.  RFC 9380 sgn0 (m = 2; _sgn0_rows): the real
    part's parity, or where the real part is zero the imaginary part's."""
    z, p0, p1 = 1 << off, 2 << off, 4 << off
    return [(z | p0, p0), (z | p1, z | p1)], [(z | p0, 0), (z | p1, z)]


def sswu_program():
    """sswu_map2 (hash_kernels.cu; _sswu_kernel, kernels.py:1023) on the
    packed (4, N) u = u0, u1, both maps side by side in every phase, with
    the values of sswu_map2_plain's formulas (the fractions xn / xd, yn / yd
    and the Jacobian output keep their representatives; every other value
    is unique and may come from any chain).  Its script:
      LOAD   the head's constants;
      head   per map tv1 = u^2, tv3 = Z tv1, t = tv3^2 + tv3 (stored: e1's
             flag), -B (t + 1) and A t, Cz3 u^3 and u out of Montgomery form
             (sgn0's flags);
      CASE   per map e1 = (t == 0): (xn, xd) = (B, Z A), else (-B (t + 1), A t);
      pre    xd^2, xd^3 = gxd, gxn = xn^3 + A xn xd^2 + B xd^3, x2n = tv3 xn
             and gx2n, g2, g4, g8 = yd, W = gxn gxd^15, w2, w8, b = conj(W)
             w11; yd^2 and the candidates' right sides R = gx yd^2; the four
             norms, their product (the Fermat inverse's base) and each norm's
             cofactor in it (Montgomery's trick), times conj(xd) and conj(yd);
             the window tables of both maps' b and of the norms' product;
      POW    three chains in lockstep, window by window: b^((p - 11)/16) for
             each map, and the norms' product^(p - 2);
      LOAD   sqrt(u);
      post1  z1 = b^k w8, z2 = z1 Cz3 u^3, per candidate set X = z^2 gxd and
             the stored forms X - R, -X - R, u X - R, (X1, -X0) - R, whose
             zero flags (and R's: R = 0 iff gx = 0, since yd != 0) pick the
             candidate; z sqrt(u) (z sqrt(-u) is its product by u);
      CASE   per map the candidate of the first set that has one, else the
             second set's (_cand_select_rows order; found1 picks the set);
      LOAD   the isogeny's coefficients;
      post2  affine x = xn conj(xd) / N(xd), y likewise, y out of Montgomery
             form, the isogeny's four Horner polynomials, Z = xd' yd', X =
             xn' yd' Z and y yn' xd' Z^2;
      CASE   per map sgn0(u) != sgn0(y): the point with -Y into acc (map 0)
             or base (map 1), else with Y;
      ADD    acc + base (the complete addition and its case)."""
    F = FP2_COORD
    P = Program("sswu_map2")
    u = fp2s(P.named("u", 4))
    point_slots(P, F)
    (one,), (raw1,) = P.slot_list("one"), P.named("raw1", 1)
    A, B, Z, ZA, _, CZ3 = fp2s(P.named("head_consts", SSWU_HEAD_ROWS))
    (sqi,) = fp2s(P.named("sqi", 2))
    iso = fp2s(P.named("iso", SSWU_ROWS - SSWU_ISO_ROW))
    XNUM, XDEN, YNUM, YDEN = iso[0:4], iso[4:7], iso[7:11], iso[11:15]
    P.inputs, P.presets, P.outputs = ["u"], ["one", "raw1"], ["acc"]
    P.pow_bits = bits = SSWU_POW_BITS
    maps = range(2)
    chains = (("0", 2, 0), ("1", 2, 0), ("i", 1, 1))  # both maps' sqrt chains, the inverse
    for c, width, ex in chains:
        P.named(f"tab{c}", width * ((1 << bits) - 1))
        for name in "fgo":
            P.named(f"{name}{c}", width)
        P.named(f"v{c}", 1 if width == 1 else 3)
        P.chains.append((f"tab{c}", f"o{c}", f"f{c}", width, ex))

    def flag(name, off=0, count=None, kind=ZERO):
        return (name, off, P.slots[name][1] if count is None else count, kind)

    P.body("head", auto=True)
    tv3, bt1, at, cz = [], [], [], []
    for m in maps:
        tv1 = f2_sqr(P, u[m])
        tv3.append(f2_mul(P, Z, tv1))
        t = f2_add(f2_sqr(P, tv3[m]), tv3[m])
        store_all(P, P.named(f"t{m}", 2), t)
        bt1.append(f2_mul(P, B, (t[0] + one, t[1])))
        at.append(f2_mul(P, A, t))
        cz.append(keep(P, f2_mul(P, CZ3, f2_mul(P, tv1, u[m]))))
        for d, x in zip(P.named(f"ru{m}", 2), u[m]):
            P.mul(x, raw1, dst=d)

    xn = [fp2s(P.named(f"xn{m}", 2))[0] for m in maps]
    xd = [fp2s(P.named(f"xd{m}", 2))[0] for m in maps]
    for m in maps:
        for name, val in ((f"e1_{m}", (B, ZA)), (f"ne1_{m}", (f2_neg(bt1[m]), at[m]))):
            P.body(name)
            P.phase()
            store_all(P, flat(xn[m]) + flat(xd[m]), val)
        P.cases[f"e1_{m}"] = ([flag(f"t{m}")], [(1, 1, f"e1_{m}"), (0, 0, f"ne1_{m}")])

    P.body("pre", auto=True)
    w8, gxd, x2, rs, norms, yds = [], [], [], [], [], []
    for m in maps:
        xd2, xn2 = f2_sqr(P, xd[m]), f2_sqr(P, xn[m])
        xd3 = f2_mul(P, xd2, xd[m])
        bxd3 = f2_mul(P, f2_mul(P, B, xd[m]), xd2)
        x2n = f2_mul(P, tv3[m], xn[m])

        def gx_num(num, num2):  # num^3 + A num xd^2 + B xd^3, over gxd = xd^3
            return f2_add(f2_add(f2_mul(P, num2, num), f2_mul(P, f2_mul(P, A, num), xd2)), bxd3)

        gxn, gx2n = gx_num(xn[m], xn2), gx_num(x2n, f2_sqr(P, x2n))
        g2 = f2_sqr(P, xd3)
        g4 = f2_sqr(P, g2)
        g8 = f2_sqr(P, g4)
        W = f2_mul(P, f2_mul(P, f2_mul(P, f2_mul(P, gxn, xd3), g2), g4), g8)
        w2 = f2_sqr(P, W)
        w8.append(keep(P, f2_sqr(P, f2_sqr(P, w2))))
        b = f2_mul(P, w8[m], f2_mul(P, (W[0], -W[1]), f2_mul(P, w2, W)))
        pow_table(P, P.slot_list(f"tab{m}"), 2, b)
        yd2 = f2_sqr(P, g8)
        rs.append([P.named(f"r{m}{s}", 2) for s in (1, 2)])
        store_all(P, rs[m][0], f2_mul(P, gxn, yd2))
        store_all(P, rs[m][1], f2_mul(P, gx2n, yd2))
        gxd.append(keep(P, xd3))
        x2.append(keep(P, x2n))
        norms.append([P.mul(c, c) + P.mul(d, d) for c, d in (xd[m], g8)])
        yds.append(g8)
    (nx0, ny0), (nx1, ny1) = norms
    a01, a23 = P.mul(nx0, ny0), P.mul(nx1, ny1)
    tabi = P.slot_list("tabi")
    pow_table(P, tabi, 1, P.mul(a01, a23, dst=tabi[0]))
    # conj(xd) and conj(yd) times the other three norms: times the inverse
    # of the product, conj(d) / N(d)
    ixd, iyd = [], []
    for m, (cx, cy) in enumerate(((P.mul(ny0, a23), P.mul(nx0, a23)),
                                  (P.mul(ny1, a01), P.mul(nx1, a01)))):
        ixd.append((P.mul(xd[m][0], cx), P.mul(-xd[m][1], cx)))
        iyd.append((P.mul(yds[m][0], cy), P.mul(-yds[m][1], cy)))

    P.body("post1", auto=True)
    (tinv,) = P.slot_list("vi")
    cands = []
    for m in maps:
        ixd[m] = tuple(P.mul(x, tinv) for x in ixd[m])
        iyd[m] = tuple(P.mul(x, tinv) for x in iyd[m])
        z1 = f2_mul(P, _vform(P.slot_list(f"v{m}")), w8[m])
        z2 = f2_mul(P, z1, cz[m])
        for s, z in ((1, z1), (2, z2)):
            X = f2_mul(P, f2_sqr(P, z), gxd[m])
            R = fp2s(rs[m][s - 1])[0]
            for k, d in enumerate((X, f2_neg(X), (-X[1], X[0]), (X[1], -X[0]))):
                store_all(P, P.named(f"d{m}{s}{k}", 2), f2_sub(d, R))
            cands.append((z, f2_mul(P, z, sqi)))

    xs = [fp2s(P.named(f"xs{m}", 2))[0] for m in maps]
    ys = [fp2s(P.named(f"ys{m}", 2))[0] for m in maps]
    for m in maps:
        flags, rules = [], []
        for s, x in ((1, xn[m]), (2, x2[m])):
            z, zs = cands[2 * m + s - 1]
            flags += [flag(f"r{m}{s}")] + [flag(f"d{m}{s}{k}") for k in range(4)]
            # 0 where gx = 0; else z c for c^2 = 1, -1, u, -u: c = 1, u,
            # sqrt(u), sqrt(-u) = sqrt(u) u
            for k, y in enumerate(((Lin(), Lin()), z, (-z[1], z[0]), zs, (-zs[1], zs[0]))):
                name = f"cand{m}_{s}{k}"
                P.body(name)
                P.phase()
                store_all(P, flat(xs[m]) + flat(ys[m]), (x, y))
                rules.append((1 << len(rules), 1 << len(rules), name))
        P.cases[f"cand{m}"] = (flags, rules + [(0, 0, f"cand{m}_20")])

    P.body("post2", auto=True)
    pts = []
    for m in maps:
        x, y = f2_mul(P, xs[m], ixd[m]), f2_mul(P, ys[m], iyd[m])
        for d, c in zip(P.named(f"ry{m}", 2), y):
            P.mul(c, raw1, dst=d)
        xnum, xden = horner(P, XNUM, x), horner(P, XDEN, x)
        ynum, yden = horner(P, YNUM, x), horner(P, YDEN, x)
        z = f2_mul(P, xden, yden)
        X = f2_mul(P, f2_mul(P, xnum, yden), z)
        pts.append((X, f2_mul(P, f2_mul(P, f2_mul(P, y, ynum), xden), f2_sqr(P, z)), z))

    one_u, zero_u = _sgn0_rules(0)
    one_y, zero_y = _sgn0_rules(3)
    differ = [(mu | my, vu | vy) for a, b in ((one_u, zero_y), (zero_u, one_y))
              for mu, vu in a for my, vy in b]
    for m, dst in zip(maps, ("acc", "base")):
        X, Y, Z3 = pts[m]
        for name, y in ((f"neg{m}", f2_neg(Y)), (f"pos{m}", Y)):
            P.body(name)
            P.phase()
            store_all(P, P.slot_list(dst), (X, y, Z3))
        flags = [flag(n, k, 1, kind) for n in (f"ru{m}", f"ry{m}")
                 for k, kind in ((0, ZERO), (0, PARITY), (1, PARITY))]
        P.cases[f"sgn0_{m}"] = (flags, [(mk, v, f"neg{m}") for mk, v in differ]
                                + [(0, 0, f"pos{m}")])
    ladder_bodies(P, F)
    P.script = [(LOAD, (0, SSWU_HEAD_ROWS, "head_consts")), (BODY, "head"),
                (CASE, "e1_0"), (CASE, "e1_1"), (BODY, "pre"), (POW, None),
                (LOAD, (SSWU_SQI_ROW, 2, "sqi")), (BODY, "post1"), (CASE, "cand0"),
                (CASE, "cand1"), (LOAD, (SSWU_ISO_ROW, SSWU_ROWS - SSWU_ISO_ROW, "iso")),
                (BODY, "post2"),
                (CASE, "sgn0_0"), (CASE, "sgn0_1"), (ADD, "add")]

    # a window: `bits` squares, from v to f by way of g, f, ...; then f * o
    st = [(c, width) for c, width, _ in chains]
    dsts = ["fg"[(bits - i) % 2] for i in range(1, bits + 1)]
    P.body("win_sq")
    for src, dst in zip(["v"] + dsts, dsts):
        P.phase()
        for c, width in st:
            a = P.slot_list(f"{src}{c}")
            _sq_into(P, _vform(a) if src == "v" else _value(a, width), P.slot_list(f"{dst}{c}"))
    P.body("win_mul")
    P.phase()
    for c, width in st:
        _mul_into(P, _value(P.slot_list(f"f{c}"), width), _value(P.slot_list(f"o{c}"), width),
                  P.slot_list(f"v{c}"))
    return P.allocate()


# ------------------------------------------------------- slots by liveness

def _range(P, name, off=0, count=None):
    first, n = P.slots[name]
    return set(range(first + off, first + off + (n - off if count is None else count)))


def _flow(P):
    """The order in which P's kernel runs its bodies, as _flow_graph reads
    it: a body's name; a list, in sequence; ("loop", x), x any number of
    times; ("alt", x, ...), one of them (None: nothing); ("touch", reads,
    writes), slots that the kernel reads and writes outside the bodies.
    First the kernel's loads, then its script's steps (a CASE's or an
    addition's flags before the bodies they pick, a ladder's doublings and
    additions in any order, a variable ladder's scalar read at every bit
    and its addition run or not, a POW's copies before each window's
    bodies) or P.flow, last its stores."""

    def ranges(names):
        return set().union(*(_range(P, n) for n in names))

    def add():
        return ["add", ("touch", ranges(("acc", "base", "h", "r")), set()),
                ("alt", None, *ADD_CASES)]

    flow = [("touch", set(), ranges(P.inputs + P.presets))]
    for kind, arg in P.script:
        if kind == BODY:
            flow.append(arg)
        elif kind == ADD:
            flow += add()
        elif kind == LADDER:
            flow += ["take_base", ("loop", ("alt", "dbl", add()))]
        elif kind == VLADDER:
            flow += ["set_inf", ("loop", ["dbl", ("touch", _range(P, "scalar"), set()),
                                          ("alt", None, add())])]
        elif kind == LOAD:
            flow.append(("touch", set(), _range(P, arg[2])))
        elif kind == CASE:
            flags, rules = P.cases[arg]
            bodies = list(dict.fromkeys(b for _, _, b in rules))
            if all(mask for mask, _, _ in rules):  # no rule may match: no body
                bodies.append(None)
            flow += [("touch", set().union(*(_range(P, n, o, c) for n, o, c, _ in flags)),
                      set()), ("alt", *bodies)]
        else:  # POW: window 0 sets o and f, a later window o
            tabs = ranges([t for t, _, _, _, _ in P.chains] + ["one"])
            o = ranges([o for _, o, _, _, _ in P.chains])
            f = ranges([f for _, _, f, _, _ in P.chains])
            flow += [("touch", tabs, o | f), "win_mul",
                     ("loop", [("touch", tabs, o), "win_sq", "win_mul"])]
    return flow + [P.flow, ("touch", ranges(P.outputs), set())]


def _flow_graph(P, flow):
    """The flow as a graph of positions: [(reads, writes)], a phase's or a
    touch's, and each position's successors."""
    nodes, succ = [], []

    def node(reads, writes, preds):
        nodes.append((reads, writes))
        succ.append([])
        for p in preds:
            succ[p].append(len(nodes) - 1)
        return [len(nodes) - 1]

    def walk(x, preds):
        if x is None:
            return preds
        if isinstance(x, str):
            for ops in P.bodies[x]:
                preds = node(set().union(*(op.reads() for op in ops)), {op.dst for op in ops},
                             preds)
            return preds
        if isinstance(x, list):
            for y in x:
                preds = walk(y, preds)
            return preds
        if x[0] == "touch":
            return node(x[1], x[2], preds)
        if x[0] == "alt":
            return [p for y in x[1:] for p in walk(y, preds)]
        head = node(set(), set(), preds)  # a loop
        for p in walk(x[1], head):
            succ[p].append(head[0])
        return head

    walk(flow, [])
    return nodes, succ


def _allocate(P):
    """The kernel's slots for P's values: a value occupies the positions of
    the flow where it is written or live (read there or later before it is
    written again), and two values share a slot only where no position
    holds both.  A named range keeps its slots together; the inputs' ranges
    land first and in order at slots 0 and up (the packed operand's
    coordinates), then first fit in order of first position."""
    nodes, succ = _flow_graph(P, _flow(P))
    live = [set() for _ in nodes]
    changed = True
    while changed:
        changed = False
        for i in reversed(range(len(nodes))):
            reads, writes = nodes[i]
            new = reads | (set().union(*(live[j] for j in succ[i])) - writes)
            if new != live[i]:
                live[i], changed = new, True
    if live[0]:
        raise ValueError(f"{P.name}: slots {sorted(live[0])} read before written")
    occ = {}  # value -> bit i set where position i holds it
    for i, (_, writes) in enumerate(nodes):
        for s in live[i] | writes:
            occ[s] = occ.get(s, 0) | 1 << i

    def first(masks):
        return min((m & -m).bit_length() for m in masks if m)

    units, named = [], set()
    for i, (name, (lo, count)) in enumerate(P.slots.items()):
        masks = [occ.get(s, 0) for s in range(lo, lo + count)]
        if not any(masks):
            raise ValueError(f"{P.name}: slots {name} unused")
        order = (0, P.inputs.index(name)) if name in P.inputs else (first(masks), i)
        units.append((order, lo, masks))
        named.update(range(lo, lo + count))
    units += [((first([m]), len(P.slots) + s), s, [m]) for s, m in occ.items() if s not in named]
    busy, phys = [], {}  # busy[slot]: the positions of the values in it
    for _, lo, masks in sorted(units):
        base = 0
        while any(busy[base + j] & m for j, m in enumerate(masks) if base + j < len(busy)):
            base += 1
        busy += [0] * max(0, base + len(masks) - len(busy))
        for j, m in enumerate(masks):
            busy[base + j] |= m
            phys[lo + j] = base + j

    def lin(f):
        return Lin({phys[s]: k for s, k in f.c.items()}, f.h)

    for phases in P.bodies.values():
        for ops in phases:
            for op in ops:
                op.dst, op.a = phys[op.dst], lin(op.a)
                op.b = None if op.b is None else lin(op.b)
    P.slots = {n: (phys[lo], count) for n, (lo, count) in P.slots.items()}
    P.nslots = len(busy)
    at = 0
    for n in P.inputs:
        if P.slots[n][0] != at:
            raise ValueError(f"{P.name}: input {n} at slot {P.slots[n][0]}, not {at}")
        at += P.slots[n][1]
    check_phases(P)


def programs():
    return ([exp_x_program()] + [miller_program(k) for k in MILLER_PAIRS]
            + [ladder_program(FP_COORD), ladder_program(FP2_COORD), cofactor_program()]
            + [miller_add_program(k) for k in MILLER_PAIRS] + [sswu_program()]
            + [fp12_mul_program(), fp6_mul_program(), fp12_sqr_program()]
            + [var_ladder_program(FP_COORD), var_ladder_program(FP2_COORD)]
            + [cyclo_sqr_program(), mul014_program()]
            + [dbl_step_program(), add_program(FP_COORD), add_program(FP2_COORD)])


def elements_per_block(P, g):
    """Elements per block of the kernel of program P at G = g (group.cuh)."""
    return min(THREADS // g, MAX_SHARED // (P.nslots * SLOT_BYTES))


def shared_bytes(P, g):
    """Dynamic shared memory of a block of the kernel of program P at G = g."""
    return elements_per_block(P, g) * P.nslots * SLOT_BYTES


def check_phases(P):
    """No op of a phase writes a slot that another op of it reads or writes,
    and a phase holds products only or combinations only.  A POW step's
    copies of a later window run beside win_sq's first phase, with no
    barrier between (group.cuh pow_step): that phase touches none of the
    slots they read or write (the tables, o and the one)."""
    if P.chains:
        copies = _range(P, "one").union(*(_range(P, n) for t, o, _, _, _ in P.chains
                                          for n in (t, o)))
        touched = {s for op in P.bodies["win_sq"][0] for s in op.reads() | {op.dst}}
        if copies & touched:
            raise ValueError(f"{P.name}.win_sq phase 0: slots {sorted(copies & touched)} "
                             f"of the window's copies")
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


def add_case(P, slots, bit=None):
    """The body that the complete addition's case picks after the body add,
    or None (group.cuh add_case; ops/curve.py pt_add, in _pt_add_body's
    order): P at infinity -> take_base; Q at infinity -> none (acc is P);
    h = r = 0 -> dbl; h = 0 -> set_inf; else take_sum.  In a variable ladder
    (`bit` the scalar's bit) a clear bit comes first: none, acc stays (the
    plain version's cmov)."""
    c = P.consts["kCoord"]

    def zero(name, off=0):
        first = P.slots[name][0] + off
        return not any(slots[first:first + c])

    if bit is not None and not slots[P.slots["scalar"][0]] >> bit & 1:
        return None
    if zero("acc", 2 * c):
        return "take_base"
    if zero("base", 2 * c):
        return None
    if zero("h"):
        return "dbl" if zero("r") else "set_inf"
    return "take_sum"


def pick_case(P, case, slots):
    """The body that CASE step `case` picks, or None (group.cuh pick_case):
    every flag of the case read from the slots (ZERO: its slots all zero;
    PARITY: its slot's value odd) into bit i of a word, then the first rule
    (mask, value, body) with word & mask == value."""
    flags, rules = P.cases[case]
    word = 0
    for i, (name, off, count, kind) in enumerate(flags):
        s = P.slots[name][0] + off
        on = slots[s] & 1 if kind == PARITY else not any(slots[s:s + count])
        word |= bool(on) << i
    return next((body for mask, value, body in rules if word & mask == value), None)


def pow_windows(exponent, bits):
    return -(-exponent.bit_length() // bits)


def pow_digit(exponent, nwin, w, bits):
    """Window w (from the top) of `exponent` split into nwin windows."""
    return (exponent >> (bits * (nwin - 1 - w))) & ((1 << bits) - 1)


def run_pow(P, exps, slots):
    """A POW step on a list of canonical ints, as group.cuh pow_step runs
    it: every chain (table, o, f, width, exponent index) in lockstep over
    the windows of the longer exponent.  Window 0: o = the table entry of
    the chain's digit (the one where the digit is 0, and at the windows
    before its exponent's first), f = one, then the body win_mul (f o into
    v); every later window: o = its digit's entry, then the bodies win_sq
    (v^(2^bits) into f) and win_mul."""
    bits, one = P.pow_bits, slots[P.slots["one"][0]]
    nwin = max(pow_windows(e, bits) for e in exps)
    for w in range(nwin):
        for tab, o, f, width, ex in P.chains:
            d = pow_digit(exps[ex], nwin, w, bits)
            unit = [one] + [0] * (width - 1)
            t = P.slots[tab][0] + (d - 1) * width
            first = P.slots[o][0]
            slots[first:first + width] = slots[t:t + width] if d else unit
            if w == 0:
                first = P.slots[f][0]
                slots[first:first + width] = unit
        if w:
            run_body(P, "win_sq", slots)
        run_body(P, "win_mul", slots)


def run_script(P, segments, slots, exps=(), table=(), nbits=0):
    """Run a point program's script on a list of canonical ints, as
    group.cuh run_script does: `segments` the ladder's (len, set bit) runs,
    `exps` the POW chains' exponents, `table` the LOAD rows (ints), `nbits`
    the variable ladder's bit count (its scalar an int in the slot
    scalar)."""

    def add(*bit):
        run_body(P, "add", slots)
        case = add_case(P, slots, *bit)
        if case:
            run_body(P, case, slots)

    for kind, arg in P.script:
        if kind == BODY:
            run_body(P, arg, slots)
        elif kind == ADD:
            add()
        elif kind == CASE:
            body = pick_case(P, arg, slots)
            if body:
                run_body(P, body, slots)
        elif kind == LOAD:
            row, count, name = arg
            first = P.slots[name][0]
            slots[first:first + count] = table[row:row + count]
        elif kind == POW:
            run_pow(P, exps, slots)
        elif kind == VLADDER:
            run_body(P, "set_inf", slots)
            for bit in reversed(range(nbits)):
                run_body(P, "dbl", slots)
                add(bit)
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
    """The header's tables and index ranges: terms, forms, ops, phases,
    {(program, body): (first, last phase)}, script steps, {program: (first,
    last step)}, cases, flags, rules, chains, {program: (first, last
    chain)}."""
    terms, forms, ops, phases, ranges = [], [], [], [], {}
    steps, scripts = [], {}
    cases, flags, rules, chains, chain_ranges, case_index = [], [], [], [], {}, {}
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
        for name, (fl, ru) in P.cases.items():
            if len(fl) > 16:
                raise ValueError(f"{P.name}.{name}: more than 16 flags")
            case_index[(P.name, name)] = len(cases)
            cases.append((len(flags) | len(fl) << 16, len(rules) | len(ru) << 16))
            for n, off, count, kind in fl:
                flags.append(P.slots[n][0] + off | count << 8 | kind << 16)
            for mask, value, body in ru:
                a, b = ranges[(P.name, body)] if body else (0, 0)
                rules.append((mask | value << 16, a | b << 16))
        if P.chains:
            chain_ranges[P.name] = (len(chains), len(chains) + len(P.chains))
            for tab, o, f, width, ex in P.chains:
                chains.append(P.slots[tab][0] | P.slots[o][0] << 8 | P.slots[f][0] << 16
                              | width << 24 | ex << 28)
        if P.script:
            first = len(steps)
            for kind, arg in P.script:
                if kind in (BODY, ADD):
                    a, b = ranges[(P.name, arg)]
                    y = a | b << 16
                elif kind == CASE:
                    y = case_index[(P.name, arg)]
                elif kind == LOAD:
                    row, count, name = arg
                    y = row | count << 8 | P.slots[name][0] << 16
                else:  # LADDER, POW, VLADDER: their bodies are the program's
                    y = 0
                steps.append((kind, y))
            scripts[P.name] = (first, len(steps))
    return (terms, forms, ops, phases, ranges, steps, scripts, cases, flags, rules, chains,
            chain_ranges)


def _array(ctype, name, values, per_line=8, fmt="{}"):
    rows = [", ".join(fmt.format(v) for v in values[i:i + per_line])
            for i in range(0, len(values), per_line)]
    return (f"static __device__ const {ctype} {name}[{len(values)}] = {{\n    "
            + ",\n    ".join(rows) + "};\n")


def render():
    """The text of csrc/group_rounds.cuh."""
    progs = programs()
    (terms, forms, ops, phases, ranges, steps, scripts, cases, flags, rules, chains,
     chain_ranges) = _tables(progs)
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
        "//                2 a ladder, 3 a pow, 4 a case, 5 a load, 6 a variable",
        "//                ladder), its body's",
        "//                first | last phase << 16, the case, or the load's",
        "//                first row | rows << 8 | first slot << 16}",
        "//   kGroupCases  a case: {first flag | flags << 16, first rule | rules",
        "//                << 16}",
        "//   kGroupFlags  a flag: slot | slots << 8 | kind << 16 (0 all zero, 1",
        "//                odd)",
        "//   kGroupRules  a rule: {mask | value << 16 over the case's flags, its",
        "//                body's first | last phase << 16}",
        "//   kGroupChains a pow chain: table slot | o slot << 8 | f slot << 16 |",
        "//                width << 24 | exponent << 28",
        "// and per program its slot count, named slots, bodies [first, last",
        "// phase), script [first, last step), its script's step kinds and its",
        "// chains [first, last).  Products per body in the comments.",
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
            kinds = sum(1 << k for k in {k for k, _ in P.script} | {BODY})
            out.append(f"  static constexpr int kScript = {a}, kEndScript = {b};")
            out.append(f"  static constexpr unsigned kStepKinds = 0x{kinds:x}u;")
        if P.name in chain_ranges:
            a, b = chain_ranges[P.name]
            out.append(f"  static constexpr int kChains = {a}, kEndChains = {b}, "
                       f"kPowBits = {P.pow_bits};")
        out.append("};")
        out.append("")
    out.append(_array("uint16_t", "kGroupTerms", terms, 12, "0x{:04x}"))
    out.append(_array("uint32_t", "kGroupForms", forms, 6, "0x{:08x}u"))
    out.append(_array("uint2", "kGroupOps", [f"{{0x{a:08x}u, 0x{b:08x}u}}" for a, b in ops], 3))
    out.append(_array("uint16_t", "kGroupPhases", phases, 12))
    out.append(_array("uint2", "kGroupScript", [f"{{{k}u, 0x{r:08x}u}}" for k, r in steps], 4))
    out.append(_array("uint2", "kGroupCases", [f"{{0x{a:08x}u, 0x{b:08x}u}}" for a, b in cases],
                      3))
    out.append(_array("uint32_t", "kGroupFlags", flags, 6, "0x{:08x}u"))
    out.append(_array("uint2", "kGroupRules", [f"{{0x{a:08x}u, 0x{b:08x}u}}" for a, b in rules],
                      3))
    out.append(_array("uint32_t", "kGroupChains", chains, 6, "0x{:08x}u"))
    out += ["}  // namespace group", "}  // namespace bls", ""]
    return "\n".join(out)


if __name__ == "__main__":
    HEADER.write_text(render())
    print(f"wrote {HEADER}")

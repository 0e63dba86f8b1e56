"""G1/G2 Jacobian point ops, batch-first and branch-free (counterpart of the
JAX package's ops/curve.py).

Points are Jacobian (X, Y, Z) with Z == 0 encoding infinity; coordinates
are Fp limb tensors for G1 and Fp2 pairs for G2.  All ops are complete
(exceptional cases resolved with cmov).  Neither E(Fp) nor E'(Fp2) has
2-torsion, so Y != 0 for every finite point and doubling is complete.

On the kernel adapters FP_OPS / FP2_OPS a doubling and a complete
addition are ONE pt_dbl / pt_add kernel launch each, as the JAX package
runs them on its accelerator (config.fuse_pt).  Constant-scalar ladders use
the static run structure (doubling runs plus one addition per set bit):
each is ONE pt_mul_const launch, the G2 cofactor clearing ONE g2_cofactor
launch, a variable-scalar ladder ONE pt_mul_var launch, and each level of
a pt_sum tree ONE pt_add launch (ops/kernels.py).  The plain versions of
those kernels are here: the generic point bodies below over two coordinate
adapters that call only the plain field functions.
"""

import torch

from .. import constants as C
from .fp import FP
from . import kernels as K
from . import tower as T
from .tower import F2


class _FpOps:
    """Coordinate-field adapter: Fp."""
    name = "fp"

    add = staticmethod(FP.add)
    sub = staticmethod(FP.sub)
    neg = staticmethod(FP.neg)
    sqr = staticmethod(FP.sqr)
    cmov = staticmethod(FP.cmov)
    is_zero = staticmethod(FP.is_zero)
    eq = staticmethod(FP.eq)
    inv = staticmethod(FP.inv)
    mul_pairs = staticmethod(T._mul_many)
    zero_like = staticmethod(torch.zeros_like)
    one_like = staticmethod(FP.one_like)

    @staticmethod
    def const(x, like):
        return FP.constant(x, like.device).expand(like.shape)


class _Fp2Ops:
    """Coordinate-field adapter: Fp2."""
    name = "fp2"

    add = staticmethod(T.fp2_add)
    sub = staticmethod(T.fp2_sub)
    neg = staticmethod(T.fp2_neg)
    sqr = staticmethod(T.fp2_sqr)
    cmov = staticmethod(T.fp2_cmov)
    is_zero = staticmethod(T.fp2_is_zero)
    eq = staticmethod(T.fp2_eq)
    inv = staticmethod(T.fp2_inv)
    mul_pairs = staticmethod(T.fp2_mul_pairs)
    zero_like = staticmethod(T.fp2_zero_like)
    one_like = staticmethod(T.fp2_one_like)
    const = staticmethod(T._bcast)


def _plain_mul_pairs(mul):
    def mul_pairs(pairs):
        a, b = torch.broadcast_tensors(torch.stack([p[0] for p in pairs]),
                                       torch.stack([p[1] for p in pairs]))
        return list(mul(a, b).unbind(0))
    return staticmethod(mul_pairs)


class _FpPlainOps:
    """Coordinate-field adapter of the plain versions: Fp as (N, 24)
    tensors, plain field functions only (no kernel launch on any device)."""
    name = "fp"

    add = staticmethod(lambda a, b: FP.add_plain(*torch.broadcast_tensors(a, b)))
    sub = staticmethod(lambda a, b: FP.sub_plain(*torch.broadcast_tensors(a, b)))
    neg = staticmethod(lambda a: FP.sub_plain(torch.zeros_like(a), a))
    cmov = staticmethod(FP.cmov)
    is_zero = staticmethod(FP.is_zero)
    mul_pairs = _plain_mul_pairs(FP.mul_plain)
    zero_like = staticmethod(torch.zeros_like)
    one_like = staticmethod(FP.one_like)


class _Fp2PlainOps:
    """Coordinate-field adapter of the plain versions: Fp2 as (2, N, 24)
    tensors (tower.F2)."""
    name = "fp2"

    add = staticmethod(F2.add)
    sub = staticmethod(F2.sub)
    neg = staticmethod(F2.neg)
    cmov = staticmethod(lambda cond, a, b: torch.where(cond[..., :, None], a, b))
    is_zero = staticmethod(F2.is_zero)
    mul_pairs = _plain_mul_pairs(F2.mul)
    zero_like = staticmethod(torch.zeros_like)

    @staticmethod
    def one_like(a):
        return torch.stack([FP.one_like(a[0]), torch.zeros_like(a[1])])


FP_OPS = _FpOps()
FP2_OPS = _Fp2Ops()
FP_PLAIN = _FpPlainOps()
FP2_PLAIN = _Fp2PlainOps()


# ----------------------------------------------------------------------------
# generic Jacobian ops
# ----------------------------------------------------------------------------

def pt_infinity_like(ops, p):
    x, y, z = p
    return (ops.one_like(x), ops.one_like(y), ops.zero_like(z))


def pt_is_infinity(ops, p):
    return ops.is_zero(p[2])


def pt_neg(ops, p):
    return (p[0], ops.neg(p[1]), p[2])


def pt_cmov(ops, cond, p, q):
    return tuple(ops.cmov(cond, a, b) for a, b in zip(p, q))


def _fused(ops):
    return ops is FP_OPS or ops is FP2_OPS


def pt_double(ops, p):
    """Complete Jacobian doubling for a = 0 curves.  Infinity stays
    infinity because Z3 = 2 Y Z.  On FP_OPS / FP2_OPS: ONE pt_dbl launch;
    on the plain adapters, the body below (the kernel's plain version): the
    JAX package's formula, its independent products grouped into three
    stacked calls (the values are exact, so grouping changes no limb)."""
    if _fused(ops):
        return _packed_call(ops, [p], K.pt_dbl, 1)
    x, y, z = p
    yz = ops.add(y, z)
    a_, b_, c_, yz2 = ops.mul_pairs([(x, x), (y, y), (z, z), (yz, yz)])  # XX, YY, ZZ
    m = ops.add(ops.add(a_, a_), a_)  # M = 3*XX (a = 0)
    xb = ops.add(x, b_)
    d_, t, mm = ops.mul_pairs([(b_, b_), (xb, xb), (m, m)])  # YYYY, (X+YY)^2, M^2
    # S = 2*((X+YY)^2 - XX - YYYY)
    s = ops.sub(ops.sub(t, a_), d_)
    s = ops.add(s, s)
    # X3 = M^2 - 2S
    x3 = ops.sub(mm, ops.add(s, s))
    # Y3 = M*(S - X3) - 8*YYYY
    d8 = ops.add(d_, d_)
    d8 = ops.add(d8, d8)
    d8 = ops.add(d8, d8)
    (my,) = ops.mul_pairs([(m, ops.sub(s, x3))])
    y3 = ops.sub(my, d8)
    # Z3 = (Y+Z)^2 - YY - ZZ  (= 2YZ)
    z3 = ops.sub(ops.sub(yz2, b_), c_)
    return (x3, y3, z3)


def pt_add(ops, p, q):
    """Complete Jacobian addition: generic add, with doubling / infinity /
    inverse cases resolved by cmov in the JAX bodies' order.  On FP_OPS /
    FP2_OPS: ONE pt_add launch; on the plain adapters, the body below, its
    independent products grouped into six stacked calls."""
    if _fused(ops):
        return _packed_call(ops, [p, q], K.pt_add)
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2, z1z2 = ops.mul_pairs([(z1, z1), (z2, z2), (z1, z2)])
    u1, u2, t1, t2 = ops.mul_pairs([
        (x1, z2z2), (x2, z1z1), (y1, z2z2), (y2, z1z1),
    ])
    s1, s2 = ops.mul_pairs([(t1, z2), (t2, z1)])
    h = ops.sub(u2, u1)
    r = ops.sub(s2, s1)
    hh, rr, z3 = ops.mul_pairs([(h, h), (r, r), (z1z2, h)])
    hhh, v = ops.mul_pairs([(h, hh), (u1, hh)])
    x3 = ops.sub(ops.sub(rr, hhh), ops.add(v, v))
    ry, s1hhh = ops.mul_pairs([(r, ops.sub(v, x3)), (s1, hhh)])
    y3 = ops.sub(ry, s1hhh)
    res = (x3, y3, z3)

    h_zero = ops.is_zero(h)
    r_zero = ops.is_zero(r)
    # P == Q -> double; P == -Q -> infinity
    res = pt_cmov(ops, h_zero & r_zero, pt_double(ops, p), res)
    res = pt_cmov(ops, h_zero & ~r_zero, pt_infinity_like(ops, p), res)
    # identity cases
    p_inf = pt_is_infinity(ops, p)
    q_inf = pt_is_infinity(ops, q)
    res = pt_cmov(ops, p_inf, q, res)
    res = pt_cmov(ops, q_inf & ~p_inf, p, res)
    return res


def pt_to_affine(ops, p):
    """Jacobian -> affine (x, y, is_infinity).  Infinity maps to (0, 0)."""
    x, y, z = p
    zi = ops.inv(z)  # 0 -> 0
    zi2 = ops.sqr(zi)
    (zi3,) = ops.mul_pairs([(zi2, zi)])
    ax, ay = ops.mul_pairs([(x, zi2), (y, zi3)])
    return ax, ay, pt_is_infinity(ops, p)


def pt_from_affine(ops, x, y, is_inf=None):
    """Affine -> Jacobian; optional is_inf mask selects Z = 0."""
    z = ops.one_like(x)
    if is_inf is not None:
        z = ops.cmov(is_inf, ops.zero_like(x), z)
    return (x, y, z)


def pt_on_curve_affine(ops, x, y, b):
    """y^2 == x^3 + b for affine coordinates (b in Montgomery form,
    broadcast to x)."""
    yy, xx = ops.mul_pairs([(y, y), (x, x)])
    (xxx,) = ops.mul_pairs([(xx, x)])
    return ops.eq(yy, ops.add(xxx, b))


def pt_eq(ops, p, q):
    """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3,
    plus matching infinity flags."""
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1, z2z2 = ops.mul_pairs([(z1, z1), (z2, z2)])
    a_, b_ = ops.mul_pairs([(x1, z2z2), (x2, z1z1)])
    t1, t2 = ops.mul_pairs([(y1, z2z2), (y2, z1z1)])
    c_, d_ = ops.mul_pairs([(t1, z2), (t2, z1)])
    p_inf = pt_is_infinity(ops, p)
    q_inf = pt_is_infinity(ops, q)
    finite_eq = ops.eq(a_, b_) & ops.eq(c_, d_) & ~p_inf & ~q_inf
    return finite_eq | (p_inf & q_inf)


# ----------------------------------------------------------------------------
# scalar multiplication
# ----------------------------------------------------------------------------

def run_segments(scalar: int):
    """The MSB-first run structure of a positive scalar after its top bit:
    [(run_len, ends_on_set_bit), ...]."""
    segs, run = [], 0
    for bit in bin(scalar)[3:]:
        run += 1
        if bit == "1":
            segs.append((run, True))
            run = 0
    if run:
        segs.append((run, False))
    return segs


X_SEGMENTS = run_segments(C.ABS_X)  # |x|: runs 1, 2, 3, 9, 32 on set bits, then 16


def _coords_of(ops, p):
    return list(p) if ops.name == "fp" else [c for x in p for c in x]


def pack_point(ops, p, shape=None):
    """Jacobian point of `ops` -> the point kernels' packed (3c, N, 24)
    operand, each coordinate broadcast to `shape` (default: theirs)."""
    coords = _coords_of(ops, p)
    shape = shape or torch.broadcast_shapes(*[c.shape for c in coords])
    return torch.stack([c.expand(shape) for c in coords]).reshape(len(coords), -1, shape[-1])


def unpack_point(ops, packed, shape=None):
    """Packed (3c, N, 24) -> a Jacobian point of `ops`, each coordinate
    viewed as `shape` (default (N, 24)): an Fp2 one a pair of them, or one
    (2, N, 24) tensor for FP2_PLAIN."""
    c = packed.view(packed.shape[0], *(shape or packed.shape[1:]))
    if ops is FP2_PLAIN:
        return tuple(c.view(3, 2, *c.shape[1:]).unbind(0))
    c = c.unbind(0)
    if ops.name == "fp":
        return c
    return ((c[0], c[1]), (c[2], c[3]), (c[4], c[5]))


def _coord_shape(ops, pts):
    return torch.broadcast_shapes(*[c.shape for p in pts for c in _coords_of(ops, p)])


def _packed_call(ops, pts, kernel, *args):
    """A point kernel on the points `pts` of `ops` (each packed at their
    common shape), result shaped as they are."""
    shape = _coord_shape(ops, pts)
    packed = [pack_point(ops, p, shape) for p in pts]
    return unpack_point(ops, kernel(FP, *packed, *args), shape)


def pt_mul_const(ops, p, scalar: int):
    """p * scalar for a host-constant non-negative scalar: ONE pt_mul_const
    launch runs the whole static ladder (doubling runs plus one complete
    addition per set bit); scalar 1 returns p without a launch."""
    if scalar == 0:
        return pt_infinity_like(ops, p)
    segs = run_segments(scalar)
    if not segs:
        return p
    return _packed_call(ops, [p], K.pt_mul_const, segs)


def _ladder_plain(ops, base, segments):
    """acc = base at the top bit, then per segment len doublings and a
    complete addition of the base where it ends on a set bit (the JAX
    kernels' _ladder_rows)."""
    acc = base
    for run, add in segments:
        for _ in range(run):
            acc = pt_double(ops, acc)
        if add:
            acc = pt_add(ops, acc, base)
    return acc


def pt_mul_const_plain(p, segments):
    """Plain version of the pt_mul_const kernel (same operands)."""
    ops = FP_PLAIN if p.shape[0] == 3 else FP2_PLAIN
    return pack_point(ops, _ladder_plain(ops, unpack_point(ops, p), segments))


def g2_cofactor_plain(p, segments):
    """Plain version of the g2_cofactor kernel: Budroni-Pintore in the order
    of the JAX kernel's add schedule (_g2cofactor_kernel), which is that of
    the JAX package's unfused g2_clear_cofactor."""
    ops = FP2_PLAIN
    P = unpack_point(ops, p)
    dev = p.device
    cx, cy = (torch.stack([FP.constant(c, dev) for c in k])[:, None] for k in (C.PSI_X, C.PSI_Y))
    c2 = FP.constant(C.PSI2_X_C0, dev)[None]

    def psi(q):
        return (F2.mul(F2.conj(q[0]), cx), F2.mul(F2.conj(q[1]), cy), F2.conj(q[2]))

    def psi2(q):
        return (F2.muls(q[0], c2), F2.neg(q[1]), q[2])

    xp = pt_neg(ops, _ladder_plain(ops, P, segments))       # [x]P
    xxp = pt_neg(ops, _ladder_plain(ops, xp, segments))     # [x^2]P
    neg_p = pt_neg(ops, P)
    aux = pt_add(ops, xp, neg_p)                            # [x - 1]P
    acc = pt_add(ops, xxp, pt_neg(ops, xp))
    acc = pt_add(ops, acc, neg_p)                           # [x^2 - x - 1]P
    acc = pt_add(ops, acc, psi(aux))
    acc = pt_add(ops, acc, psi2(pt_double(ops, P)))         # + psi^2(2P)
    return pack_point(ops, acc)


def pt_mul_var(ops, p, scalar_limbs, nbits: int):
    """p * scalar for per-element variable scalars given as (..., 16) int32
    raw (non-Montgomery) 16-bit limbs, MSB-first over nbits bits, from the
    infinity: ONE pt_mul_var launch on FP_OPS / FP2_OPS.  The point and
    the scalars broadcast against each other."""
    shape = _coord_shape(ops, [p])
    shape = torch.broadcast_shapes(shape, (*scalar_limbs.shape[:-1], shape[-1]))
    m = scalar_limbs.shape[-1]
    s = scalar_limbs.expand(*shape[:-1], m).reshape(-1, m)
    return unpack_point(ops, K.pt_mul_var(FP, pack_point(ops, p, shape), s, nbits), shape)


def pt_sum(ops, p, axis: int = 0):
    """Sum of the points along a leading batch axis by the JAX package's
    halving tree (tower.halving_tree): ONE pt_add launch per level.  The
    axis is dropped."""
    return T.halving_tree(lambda a, b: pt_add(ops, a, b), p, axis)


def pt_dbl_plain(p, count: int):
    """Plain version of the pt_dbl kernel (same operands)."""
    ops = FP_PLAIN if p.shape[0] == 3 else FP2_PLAIN
    q = unpack_point(ops, p)
    for _ in range(count):
        q = pt_double(ops, q)
    return pack_point(ops, q)


def pt_add_plain(p, q):
    """Plain version of the pt_add kernel (same operands)."""
    ops = FP_PLAIN if p.shape[0] == 3 else FP2_PLAIN
    return pack_point(ops, pt_add(ops, unpack_point(ops, p), unpack_point(ops, q)))


def pt_mul_var_plain(p, scalars, nbits: int):
    """Plain version of the pt_mul_var kernel: from the infinity, per bit
    MSB first a doubling, then the complete addition of the base selected
    where the bit is set (the JAX package's ladder, ops/curve.py
    pt_mul_var).  scalars (N, 16) raw limbs."""
    ops = FP_PLAIN if p.shape[0] == 3 else FP2_PLAIN
    base = unpack_point(ops, p)
    acc = pt_infinity_like(ops, base)
    for i in range(nbits - 1, -1, -1):
        bit = ((scalars[:, i // 16] >> (i % 16)) & 1) > 0
        acc = pt_double(ops, acc)
        acc = pt_cmov(ops, bit, pt_add(ops, acc, base), acc)
    return pack_point(ops, acc)


# ----------------------------------------------------------------------------
# G1/G2 specific: endomorphisms, subgroup checks, cofactor clearing
# ----------------------------------------------------------------------------

def g1_phi(p):
    """GLV endomorphism (beta x, y) on Jacobian coords: scales X only."""
    x, y, z = p
    (bx,) = FP_OPS.mul_pairs([(x, FP_OPS.const(C.BETA_G1, x))])
    return (bx, y, z)


def g2_psi(p):
    """psi(x, y) = (PSI_X conj(x), PSI_Y conj(y)) on Jacobian coords:
    X' = cx conj(X), Y' = cy conj(Y), Z' = conj(Z)."""
    x, y, z = p
    rx, ry = T.fp2_mul_pairs([
        (T.fp2_conj(x), T._bcast(C.PSI_X, x)),
        (T.fp2_conj(y), T._bcast(C.PSI_Y, y)),
    ])
    return (rx, ry, T.fp2_conj(z))


def g1_in_subgroup(p):
    """[|x|]([|x|]P) == -phi(P)."""
    xxp = pt_mul_const(FP_OPS, pt_mul_const(FP_OPS, p, C.ABS_X), C.ABS_X)
    return pt_eq(FP_OPS, xxp, pt_neg(FP_OPS, g1_phi(p)))


def g2_in_subgroup(p):
    """psi(Q) == [x]Q, i.e. psi(Q) == -[|x|]Q."""
    xq = pt_mul_const(FP2_OPS, p, C.ABS_X)
    return pt_eq(FP2_OPS, g2_psi(p), pt_neg(FP2_OPS, xq))


def g2_clear_cofactor(p):
    """Budroni-Pintore [x^2 - x - 1]P + [x - 1]psi(P) + psi2(2P): ONE
    g2_cofactor launch."""
    return _packed_call(FP2_OPS, [p], K.g2_cofactor, X_SEGMENTS)


# ----------------------------------------------------------------------------
# host conversions
# ----------------------------------------------------------------------------

def g1_generator(shape, device):
    """The G1 generator as a Jacobian point (Z = 1) broadcast to the
    coordinate shape `shape`."""
    x, y = (FP.constant(c, device).expand(shape) for c in C.G1_GEN)
    return (x, y, FP.one_like(x))


def g1_encode_batch(points, device="cuda"):
    """Host affine points (int tuples, None = infinity) -> device Jacobian."""
    xs = [0 if p is None else p[0] for p in points]
    ys = [1 if p is None else p[1] for p in points]
    zs = [0 if p is None else 1 for p in points]
    return tuple(FP.encode(v, device) for v in (xs, ys, zs))


def g2_encode_batch(points, device="cuda"):
    xs = [(0, 0) if p is None else p[0] for p in points]
    ys = [(1, 0) if p is None else p[1] for p in points]
    zs = [(0, 0) if p is None else (1, 0) for p in points]
    return tuple(T.fp2_encode_batch(v, device) for v in (xs, ys, zs))


def _decode_affine(ops, p):
    ax, ay, inf = pt_to_affine(ops, p)
    if ops.name == "fp2":
        xs = list(zip(FP.decode(ax[0]), FP.decode(ax[1])))
        ys = list(zip(FP.decode(ay[0]), FP.decode(ay[1])))
    else:
        xs, ys = FP.decode(ax), FP.decode(ay)
    return [None if i else (x, y) for x, y, i in zip(xs, ys, inf.tolist())]


def g1_decode(p):
    """Device Jacobian batch (B,) -> list of host affine points."""
    return _decode_affine(FP_OPS, p)


def g2_decode(p):
    return _decode_affine(FP2_OPS, p)

"""Fp2 / Fp6 / Fp12 extension towers over the limb field (counterpart of
the JAX package's ops/tower.py).

Representation (tuples of limb tensors):
  Fp2  : (c0, c1)               each (..., 24) int32 Montgomery limbs
  Fp6  : (x0, x1, x2)           each Fp2
  Fp12 : (y0, y1)               each Fp6

Tower: Fp2 = Fp[u]/(u^2+1), Fp6 = Fp2[v]/(v^3 - (1+u)), Fp12 = Fp6[w]/(w^2 - v).

Independent products and sums are stacked along a new leading axis and
issued as ONE field op, so a whole group costs one kernel launch.  Fp2
products and squares go to the fp2_mul / fp2_sqr CUDA kernels
(ops/kernels.py); their plain versions, fp2_mul_plain and fp2_sqr_plain,
live here.  The Fp12 product and square are ONE fused kernel launch each
(fp12_mul / fp12_sqr) on a packed (12, N, 24) operand; their plain
versions, and the Granger-Scott square that the exp_x and cyclo_sqr
kernels repeat, are the plain Fp12 layer at the end of this file;
fp12_cyclotomic_sqr_k is one cyclo_sqr launch; fp12_prod is a halving tree
of fp12_mul launches.  A group of Fp6 products is
ONE fp6_mul launch on packed (6, N, 24) operands.  The Fp6 and Fp12
inverses and the Frobenius maps stay compositions of these kernels; the Fp
inverse inside them is one pow_win launch (ops/fp.py).  The plain versions
of fp6_mul and pow_win are here too.
"""

import torch

from .. import constants as C
from . import kernels as K
from .fp import FP


# ----------------------------------------------------------------------------
# stacked low-level helpers
# ----------------------------------------------------------------------------

def _shape_of(ts):
    return torch.broadcast_shapes(*[t.shape for t in ts])


def _stack(ts, shape):
    return torch.stack([t.expand(shape) for t in ts])


def _stack2(pairs):
    """Broadcast all operands to one shape and stack both sides."""
    shape = _shape_of([t for p in pairs for t in p])
    return _stack([p[0] for p in pairs], shape), _stack([p[1] for p in pairs], shape)


def _many(op, pairs):
    if len(pairs) == 1:
        return [op(pairs[0][0], pairs[0][1])]
    return list(op(*_stack2(pairs)).unbind(0))


def _mul_many(pairs):
    """k independent Fp products in one stacked FP.mul."""
    return _many(FP.mul, pairs)


def _add_many(pairs):
    return _many(FP.add, pairs)


def _sub_many(pairs):
    return _many(FP.sub, pairs)


# ----------------------------------------------------------------------------
# Fp2
# ----------------------------------------------------------------------------

def fp2_const(c, device):
    """Host Fp2 int pair -> Montgomery limb pair on `device` (cached)."""
    return (FP.constant(c[0] % C.P, device), FP.constant(c[1] % C.P, device))


def _bcast(c, like):
    """Host Fp2 constant broadcast to the shape of the Fp2 `like`."""
    t = fp2_const(c, like[0].device)
    return (t[0].expand(like[0].shape), t[1].expand(like[1].shape))


def fp2_encode(x, device="cuda"):
    return (FP.encode(x[0], device), FP.encode(x[1], device))


def fp2_encode_batch(xs, device="cuda"):
    return (FP.encode([x[0] for x in xs], device), FP.encode([x[1] for x in xs], device))


def fp2_decode(a):
    return (FP.decode(a[0]), FP.decode(a[1]))


def fp2_zero_like(a):
    return (torch.zeros_like(a[0]), torch.zeros_like(a[1]))


def fp2_one_like(a):
    return (FP.one_like(a[0]), torch.zeros_like(a[1]))


def fp2_add(a, b):
    r = _add_many([(a[0], b[0]), (a[1], b[1])])
    return (r[0], r[1])


def fp2_sub(a, b):
    r = _sub_many([(a[0], b[0]), (a[1], b[1])])
    return (r[0], r[1])


def fp2_add_many(pairs):
    """k independent Fp2 adds in one stacked FP.add."""
    flat = [(x, y) for (a, b) in pairs for x, y in ((a[0], b[0]), (a[1], b[1]))]
    r = _add_many(flat)
    return [(r[2 * i], r[2 * i + 1]) for i in range(len(pairs))]


def fp2_sub_many(pairs):
    flat = [(x, y) for (a, b) in pairs for x, y in ((a[0], b[0]), (a[1], b[1]))]
    r = _sub_many(flat)
    return [(r[2 * i], r[2 * i + 1]) for i in range(len(pairs))]


def fp2_neg(a):
    z = torch.zeros_like(a[0])
    r = _sub_many([(z, a[0]), (z, a[1])])
    return (r[0], r[1])


def fp2_conj(a):
    return (a[0], FP.neg(a[1]))


def fp2_mul_plain(a0, a1, b0, b1):
    """Plain version of the fp2_mul kernel: Karatsuba with unreduced
    operand sums (< 2p) fed to the Montgomery product."""
    asum = FP.propagate(a0 + a1)
    bsum = FP.propagate(b0 + b1)
    v = FP.mul_plain(torch.stack([a0, a1, asum]), torch.stack([b0, b1, bsum]))
    c0 = FP.sub_plain(v[0], v[1])
    c1 = FP.sub_plain(FP.sub_plain(v[2], v[0]), v[1])
    return c0, c1


def fp2_sqr_plain(a0, a1):
    """Plain version of the fp2_sqr kernel: (a0+a1)(a0-a1) + 2 a0 a1 u."""
    s = FP.propagate(a0 + a1)
    d = FP.sub_plain(a0, a1)
    v = FP.mul_plain(torch.stack([s, a0]), torch.stack([d, a1]))
    return v[0], FP.add_plain(v[1], v[1])


def fp2_mul_pairs(pairs):
    """k independent Fp2 products in ONE fp2_mul kernel launch."""
    k = len(pairs)
    ts = [c for a, b in pairs for c in (*a, *b)]
    if k == 1:
        (a0, a1), (b0, b1) = pairs[0]
        c0, c1 = K.fp2_mul(FP, a0, a1, b0, b1)
        return [(c0, c1)]
    shape = _shape_of(ts)
    ops = [_stack([p[i][j] for p in pairs], shape) for i in (0, 1) for j in (0, 1)]
    c0, c1 = K.fp2_mul(FP, *ops)
    return list(zip(c0.unbind(0), c1.unbind(0)))


def fp2_mul(a, b):
    return fp2_mul_pairs([(a, b)])[0]


def fp2_sqr_many(elems):
    """k independent Fp2 squares in ONE fp2_sqr kernel launch."""
    if len(elems) == 1:
        return [K.fp2_sqr(FP, elems[0][0], elems[0][1])]
    shape = _shape_of([c for a in elems for c in a])
    c0, c1 = K.fp2_sqr(
        FP, _stack([a[0] for a in elems], shape), _stack([a[1] for a in elems], shape)
    )
    return list(zip(c0.unbind(0), c1.unbind(0)))


def fp2_sqr(a):
    return fp2_sqr_many([a])[0]


def fp2_muls(a, s):
    """Multiply by an Fp scalar (limb tensor)."""
    vs = _mul_many([(a[0], s), (a[1], s)])
    return (vs[0], vs[1])


def fp2_mul_xi(a):
    return (FP.sub(a[0], a[1]), FP.add(a[0], a[1]))


def fp2_mul_xi_many(elems):
    shape = _shape_of([c for a in elems for c in a])
    a0 = _stack([a[0] for a in elems], shape)
    a1 = _stack([a[1] for a in elems], shape)
    re = FP.sub(a0, a1)
    im = FP.add(a0, a1)
    return list(zip(re.unbind(0), im.unbind(0)))


def fp2_inv(a):
    """1 / (a0 + a1 u) = conj(a) / (a0^2 + a1^2); 0 -> 0."""
    vs = _mul_many([(a[0], a[0]), (a[1], a[1])])
    ni = FP.inv(FP.add(vs[0], vs[1]))
    vs = _mul_many([(a[0], ni), (a[1], ni)])
    return (vs[0], FP.neg(vs[1]))


def fp2_cmov(cond, a, b):
    return (FP.cmov(cond, a[0], b[0]), FP.cmov(cond, a[1], b[1]))


def fp2_is_zero(a):
    return FP.is_zero(a[0]) & FP.is_zero(a[1])


def fp2_eq(a, b):
    return FP.eq(a[0], b[0]) & FP.eq(a[1], b[1])


def fp2_sgn0(a):
    """RFC 9380 sgn0 for m=2, on the canonical (non-Montgomery) value."""
    shape = _shape_of(a)
    both = FP.from_mont(_stack([a[0], a[1]], shape))
    r0, r1 = both[0], both[1]
    s0 = r0[..., 0] & 1
    s1 = r1[..., 0] & 1
    return torch.where(FP.is_zero(r0), s1, s0)


# ----------------------------------------------------------------------------
# Fp6
# ----------------------------------------------------------------------------

def fp6_sub(a, b):
    return tuple(fp2_sub_many(list(zip(a, b))))


def fp6_neg(a):
    z = fp2_zero_like(a[0])
    return tuple(fp2_sub_many([(z, x) for x in a]))


def fp6_mul_pairs(pairs):
    """k independent Fp6 products: ONE fp6_mul kernel launch, the k pairs
    stacked along the batch axis of its packed (6, k*N, 24) operands."""
    k = len(pairs)
    shape = _shape_of([c for p in pairs for x in p for f2 in x for c in f2])

    def pack(side):
        return torch.stack([_stack([p[side][i][j] for p in pairs], shape)
                            for i in range(3) for j in range(2)]).reshape(6, -1, shape[-1])

    o = K.fp6_mul(FP, pack(0), pack(1)).view(6, k, *shape)
    return [tuple((o[2 * i, q], o[2 * i + 1, q]) for i in range(3)) for q in range(k)]


def fp6_mul(a, b):
    return fp6_mul_pairs([(a, b)])[0]


def fp6_mul_v(a):
    return (fp2_mul_xi(a[2]), a[0], a[1])


def fp6_inv(a):
    a0, a1, a2 = a
    vs = fp2_mul_pairs([(a0, a0), (a1, a2), (a2, a2), (a0, a1), (a1, a1), (a0, a2)])
    sq0, m12, sq2, m01, sq1, m02 = vs
    xis = fp2_mul_xi_many([m12, sq2])
    c0, c1, c2 = fp2_sub_many([(sq0, xis[0]), (xis[1], m01), (sq1, m02)])
    vs = fp2_mul_pairs([(a2, c1), (a1, c2), (a0, c0)])
    t = fp2_add(fp2_mul_xi(fp2_add(vs[0], vs[1])), vs[2])
    ti = fp2_inv(t)
    vs = fp2_mul_pairs([(c0, ti), (c1, ti), (c2, ti)])
    return (vs[0], vs[1], vs[2])


def fp6_frob(a, power):
    def cj(x):
        return fp2_conj(x) if power % 2 else x

    i = power % 6
    r1, r2 = fp2_mul_pairs([
        (cj(a[1]), _bcast(C.FROB6_C1[i], a[1])),
        (cj(a[2]), _bcast(C.FROB6_C2[i], a[2])),
    ])
    return (cj(a[0]), r1, r2)


# ----------------------------------------------------------------------------
# Fp12
# ----------------------------------------------------------------------------

def fp12_one_like(a):
    f2 = a[0][0]
    one2 = fp2_one_like(f2)
    z2 = fp2_zero_like(f2)
    return ((one2, z2, z2), (z2, z2, z2))


def fp12_pack(a):
    """Fp12 tuple -> the pairing kernels' packed (12, N, 24) operand
    (coefficient-major: c0.c0.re, c0.c0.im, ..., c1.c2.im)."""
    ts = [c for f6 in a for f2 in f6 for c in f2]
    return _stack(ts, _shape_of(ts))


def fp12_unpack(x):
    """Packed (12, N, 24) -> Fp12 tuple of (N, 24) views."""
    c = x.unbind(0)
    f2 = [(c[2 * i], c[2 * i + 1]) for i in range(6)]
    return ((f2[0], f2[1], f2[2]), (f2[3], f2[4], f2[5]))


def fp12_mul(a, b):
    """Fp12 product: ONE fp12_mul kernel launch."""
    return fp12_unpack(K.fp12_mul(FP, fp12_pack(a), fp12_pack(b)))


def fp12_sqr(a):
    """Generic Fp12 square: ONE fp12_sqr kernel launch."""
    return fp12_unpack(K.fp12_sqr(FP, fp12_pack(a)))


def _tree(fn, *xs):
    """fn over the leaves (tensors) of nested tuples of one structure."""
    if isinstance(xs[0], tuple):
        return tuple(_tree(fn, *ys) for ys in zip(*xs))
    return fn(*xs)


def halving_tree(op, x, axis: int = 0):
    """op over the elements of x (nested tuples of tensors) along a leading
    batch axis by the JAX package's halving tree: op(first half, second
    half), an odd element carried to the end of the next level, one op call
    per level.  The axis is dropped.  The limbs of a Jacobian point sum
    depend on that order."""
    def take(y, sl):
        return _tree(lambda c: c[(slice(None),) * axis + (sl,)], y)

    leaf = x
    while isinstance(leaf, tuple):
        leaf = leaf[0]
    cur, m = x, leaf.shape[axis]
    while m > 1:
        half = m // 2
        out = op(take(cur, slice(0, half)), take(cur, slice(half, 2 * half)))
        if m % 2:
            out = _tree(lambda a, b: torch.cat([a, b], axis), out,
                        take(cur, slice(2 * half, m)))
        cur, m = out, half + m % 2
    return take(cur, 0)


def fp12_cyclotomic_sqr_k(f, count: int):
    """`count` Granger-Scott squares of a cyclotomic Fp12: ONE cyclo_sqr
    kernel launch."""
    return fp12_unpack(K.cyclo_sqr(FP, fp12_pack(f), count))


def fp12_prod(f, axis: int = 0):
    """Product of Fp12 elements along a leading batch axis: a halving tree
    of fp12_mul, ONE launch per level.  The axis is dropped."""
    return halving_tree(fp12_mul, f, axis)


def fp12_conj(a):
    return (a[0], fp6_neg(a[1]))


def fp12_inv(a):
    a0, a1 = a
    s0, s1 = fp6_mul_pairs([(a0, a0), (a1, a1)])
    t = fp6_sub(s0, fp6_mul_v(s1))
    ti = fp6_inv(t)
    r0, r1 = fp6_mul_pairs([(a0, ti), (a1, ti)])
    return (r0, fp6_neg(r1))


def fp12_frob(a, power):
    i = power % 12
    c0 = fp6_frob(a[0], power)
    c1 = fp6_frob(a[1], power)
    k = _bcast(C.FROB12_C1[i], c1[0])
    r = fp2_mul_pairs([(x, k) for x in c1])
    return (c0, (r[0], r[1], r[2]))


def fp12_is_one(a):
    one = fp12_one_like(a)
    ok = fp2_eq(a[0][0], one[0][0])
    for i in range(3):
        if i:
            ok = ok & fp2_is_zero(a[0][i])
        ok = ok & fp2_is_zero(a[1][i])
    return ok


# host conversions -----------------------------------------------------------

def fp12_decode(a):
    return tuple(tuple(fp2_decode(c2) for c2 in c6) for c6 in a)


# ----------------------------------------------------------------------------
# plain Fp12 layer: the plain versions of the pairing kernels' tower
# ----------------------------------------------------------------------------
# A packed (12, N, 24) Fp12 is viewed as (2, 3, 2, N, 24): an Fp2 is a
# (..., 2, N, 24) tensor and an Fp6 a (..., 3, 2, N, 24) one; leading axes
# stack independent values, so a group of Fp2 products is ONE fp2_mul_plain
# call.  The bodies compute what the JAX kernel bodies compute
# (ops/pallas/kernels.py _f6_mul .. _f12_sqr, _gs_body) and call only the
# plain field functions, so they launch none of the port's kernels on any
# device.

class F2:
    """Plain Fp2 arithmetic on (..., 2, N, 24) tensors (the counterpart of
    the JAX kernels' _F2Rows); operands broadcast, results are canonical."""

    @staticmethod
    def add(a, b):
        return FP.add_plain(*torch.broadcast_tensors(a, b))

    @staticmethod
    def sub(a, b):
        return FP.sub_plain(*torch.broadcast_tensors(a, b))

    @staticmethod
    def neg(a):
        return FP.sub_plain(torch.zeros_like(a), a)

    @staticmethod
    def triple(a):
        return FP.add_plain(FP.add_plain(a, a), a)

    @staticmethod
    def xi(a):
        """a * (1 + u)"""
        a0, a1 = a.unbind(-3)
        return torch.stack([FP.sub_plain(a0, a1), FP.add_plain(a0, a1)], -3)

    @staticmethod
    def mul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        return torch.stack(fp2_mul_plain(*a.unbind(-3), *b.unbind(-3)), -3)

    @staticmethod
    def sqr(a):
        return torch.stack(fp2_sqr_plain(*a.unbind(-3)), -3)

    @staticmethod
    def muls(a, s):
        """a * s for an Fp scalar s (..., N, 24)"""
        return FP.mul_plain(*torch.broadcast_tensors(a, s.unsqueeze(-3)))

    @staticmethod
    def conj(a):
        a0, a1 = a.unbind(-3)
        return torch.stack([a0, FP.sub_plain(torch.zeros_like(a1), a1)], -3)

    @staticmethod
    def is_zero(a):
        """(..., N) mask of the zero elements"""
        return (a == 0).all(-1).all(-2)

    @staticmethod
    def eq(a, b):
        return (a == b).all(-1).all(-2)

    @staticmethod
    def stack(*xs):
        """Fp2 tensors -> one (..., len(xs), 2, N, 24) stack."""
        return torch.stack(xs, -4)


def pow_win_plain(a, exponent: int):
    """Plain version of the pow_win kernel: a^exponent (exponent > 0) for a
    packed (c, N, 24) operand, c = 1 an Fp, c = 2 an Fp2.  The table a^1 ..
    a^15, then f = a^d0 for the top 4-bit digit and per later digit 4
    squarings and, unless it is 0, one table product (_pow_win_rows)."""
    if a.shape[0] == 2:
        mul, sqr = F2.mul, F2.sqr
    else:
        mul, sqr = FP.mul_plain, lambda x: FP.mul_plain(x, x)
    digits = K.pow_digits(exponent)
    tab = [None, a]
    for _ in range(14):
        tab.append(mul(tab[-1], a))
    f = tab[digits[0]]
    for d in digits[1:]:
        for _ in range(4):
            f = sqr(f)
        if d:
            f = mul(f, tab[d])
    return f


def fp6_mul_v_plain(a):
    """(a0, a1, a2) * v = (xi a2, a0, a1) on (..., 3, 2, N, 24)."""
    return torch.cat([F2.xi(a[..., 2:, :, :, :]), a[..., :2, :, :, :]], -4)


def fp6_mul_plain(a, b):
    """Toom/Karatsuba Fp6 product on (..., 3, 2, N, 24) tensors: its 6 Fp2
    products in one call (the JAX kernels' _f6_mul)."""
    a, b = torch.broadcast_tensors(a, b)
    (a0, a1, a2), (b0, b1, b2) = a.unbind(-4), b.unbind(-4)
    s = F2.add(F2.stack(a1, a0, a0, b1, b0, b0), F2.stack(a2, a1, a2, b2, b1, b2))
    v0, v1, v2, t12, t01, t02 = F2.mul(
        torch.cat([a, s[..., :3, :, :, :]], -4), torch.cat([b, s[..., 3:, :, :, :]], -4)
    ).unbind(-4)
    sums = F2.add(F2.stack(v1, v0, v0), F2.stack(v2, v1, v2))
    d12, d01, d02 = F2.sub(F2.stack(t12, t01, t02), sums).unbind(-4)
    x12, x2 = F2.xi(F2.stack(d12, v2)).unbind(-4)
    return F2.add(F2.stack(v0, d01, d02), F2.stack(x12, x2, v1))


def fp6_mul_packed_plain(a, b):
    """Plain version of the fp6_mul kernel on packed (6, N, 24) operands."""
    return fp6_mul_plain(a.view(3, 2, *a.shape[1:]), b.view(3, 2, *b.shape[1:])).reshape(a.shape)


def fp12_view(x):
    """Packed (12, N, 24) -> its (2, 3, 2, N, 24) view."""
    return x.reshape(2, 3, 2, *x.shape[-2:])


def fp12_mul_plain(a, b):
    """Plain version of the fp12_mul kernel on packed (12, N, 24) operands:
    Karatsuba over Fp6, its 3 Fp6 products in one call (_f12_mul)."""
    (a0, a1), (b0, b1) = fp12_view(a).unbind(0), fp12_view(b).unbind(0)
    asum, bsum = F2.add(torch.stack([a0, b0]), torch.stack([a1, b1])).unbind(0)
    v0, v1, v2 = fp6_mul_plain(torch.stack([a0, a1, asum]), torch.stack([b0, b1, bsum])).unbind(0)
    c0, v01 = F2.add(torch.stack([v0, v0]), torch.stack([fp6_mul_v_plain(v1), v1])).unbind(0)
    return torch.stack([c0, F2.sub(v2, v01)]).flatten(0, 2)


def fp12_sqr_plain(a):
    """Plain version of the fp12_sqr kernel: (a0 + a1 w)^2 from the two Fp6
    products a0 a1 and (a0 + a1)(a0 + v a1) (_f12_sqr)."""
    a0, a1 = fp12_view(a).unbind(0)
    s, t_in = F2.add(torch.stack([a0, a0]), torch.stack([a1, fp6_mul_v_plain(a1)])).unbind(0)
    v0, t = fp6_mul_plain(torch.stack([a0, s]), torch.stack([a1, t_in])).unbind(0)
    c0 = F2.sub(F2.sub(t, v0), fp6_mul_v_plain(v0))
    return torch.stack([c0, F2.add(v0, v0)]).flatten(0, 2)


# Granger-Scott z-ordering z = (a0, b1, b0, a2, a1, b2) of f = ((a0, a1, a2),
# (b0, b1, b2)), as Fp2 indices of the packed element
_GS_Z = [0, 4, 3, 2, 1, 5]


def fp12_cyclotomic_sqr_plain(f):
    """Granger-Scott square of a packed cyclotomic (12, N, 24) element
    (_gs_body): its 9 Fp2 squares in one call.  On an element outside the
    cyclotomic subgroup it computes the same formula, not a square."""
    z = f.reshape(6, 2, *f.shape[-2:])[_GS_Z]
    sq = F2.sqr(torch.cat([z, F2.add(z[0::2], z[1::2])]))  # z_i^2, (z0+z1)^2 ...
    t0 = F2.add(sq[0:6:2], F2.xi(sq[1:6:2]))  # t00, t20, t40
    t1 = F2.sub(sq[6:], F2.add(sq[0:6:2], sq[1:6:2]))  # t01, t21, t41
    # 3t - 2z for (t00, z0), (t40, z3), (t20, z4); 3t + 2z for (t01, z1),
    # (xi t41, z2), (t21, z5)
    tm, tp = t0[[0, 2, 1]], torch.stack([t1[0], F2.xi(t1[2]), t1[1]])
    r = torch.cat([F2.sub(tm, z[[0, 3, 4]]), F2.add(tp, z[[1, 2, 5]])])
    r = F2.add(F2.add(r, r), torch.cat([tm, tp]))  # z0' z3' z4' z1' z2' z5'
    # f' = ((z0', z4', z3'), (z2', z1', z5'))
    return r[[0, 2, 1, 4, 3, 5]].reshape(f.shape)


def cyclo_sqr_plain(f, count: int):
    """Plain version of the cyclo_sqr kernel: `count` Granger-Scott squares
    of a packed (12, N, 24) Fp12."""
    for _ in range(count):
        f = fp12_cyclotomic_sqr_plain(f)
    return f

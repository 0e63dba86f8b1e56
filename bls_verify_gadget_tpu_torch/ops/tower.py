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
live here.  Fp6/Fp12 are compositions of those and of FP.mul/add/sub.
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

def fp6_add(a, b):
    return tuple(fp2_add_many(list(zip(a, b))))


def fp6_sub(a, b):
    return tuple(fp2_sub_many(list(zip(a, b))))


def fp6_neg(a):
    z = fp2_zero_like(a[0])
    return tuple(fp2_sub_many([(z, x) for x in a]))


def fp6_mul_pairs(pairs):
    """k independent Fp6 products (Toom-style 6-mul schedule): one
    fp2_mul launch for all 6k Fp2 products plus ~8 stacked add/sub calls."""
    k = len(pairs)
    sum_jobs = []
    for a, b in pairs:
        sum_jobs += [(a[1], a[2]), (a[0], a[1]), (a[0], a[2]),
                     (b[1], b[2]), (b[0], b[1]), (b[0], b[2])]
    sums = fp2_add_many(sum_jobs)
    mul_jobs = []
    for i, (a, b) in enumerate(pairs):
        sa12, sa01, sa02, sb12, sb01, sb02 = sums[6 * i : 6 * i + 6]
        mul_jobs += [
            (a[0], b[0]), (a[1], b[1]), (a[2], b[2]),
            (sa12, sb12), (sa01, sb01), (sa02, sb02),
        ]
    vs = fp2_mul_pairs(mul_jobs)
    s_jobs = []
    for i in range(k):
        v0, v1, v2 = vs[6 * i : 6 * i + 3]
        s_jobs += [(v1, v2), (v0, v1), (v0, v2)]
    ssum = fp2_add_many(s_jobs)
    d_jobs = []
    for i in range(k):
        _, _, _, t12, t01, t02 = vs[6 * i : 6 * i + 6]
        s12, s01, s02 = ssum[3 * i : 3 * i + 3]
        d_jobs += [(t12, s12), (t01, s01), (t02, s02)]
    ds = fp2_sub_many(d_jobs)
    xi_jobs = []
    for i in range(k):
        xi_jobs += [ds[3 * i], vs[6 * i + 2]]
    xis = fp2_mul_xi_many(xi_jobs)
    out_jobs = []
    for i in range(k):
        v0, v1 = vs[6 * i], vs[6 * i + 1]
        d01, d02 = ds[3 * i + 1], ds[3 * i + 2]
        xi12, xiv2 = xis[2 * i], xis[2 * i + 1]
        out_jobs += [(v0, xi12), (d01, xiv2), (d02, v1)]
    outs = fp2_add_many(out_jobs)
    return [tuple(outs[3 * i : 3 * i + 3]) for i in range(k)]


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


def fp12_mul(a, b):
    """Karatsuba over Fp6: 3 Fp6 products in one stacked schedule."""
    a0, a1 = a
    b0, b1 = b
    pre = fp2_add_many(list(zip(a0, a1)) + list(zip(b0, b1)))
    asum, bsum = tuple(pre[:3]), tuple(pre[3:])
    v0, v1, v2 = fp6_mul_pairs([(a0, b0), (a1, b1), (asum, bsum)])
    c0 = fp6_add(v0, fp6_mul_v(v1))
    c1 = fp6_sub(v2, fp6_add(v0, v1))
    return (c0, c1)


def fp12_sqr(a):
    a0, a1 = a
    pre = fp2_add_many(list(zip(a0, a1)) + list(zip(a0, fp6_mul_v(a1))))
    s, t_in = tuple(pre[:3]), tuple(pre[3:])
    v0, t = fp6_mul_pairs([(a0, a1), (s, t_in)])
    c0 = fp6_sub(fp6_sub(t, v0), fp6_mul_v(v0))
    c1 = fp6_add(v0, v0)
    return (c0, c1)


def fp12_cyclotomic_sqr(f):
    """Granger-Scott squaring for cyclotomic-subgroup elements: 9 Fp2
    squares in one fp2_sqr launch + stacked combinations."""
    a, b = f
    z = (a[0], b[1], b[0], a[2], a[1], b[2])
    sums = fp2_add_many([(z[0], z[1]), (z[2], z[3]), (z[4], z[5])])
    sq = fp2_sqr_many([z[0], z[1], z[2], z[3], z[4], z[5]] + sums)
    # fp4 squares: c0 = t0 + xi t1, c1 = (a+b)^2 - t0 - t1
    xi_t1 = fp2_mul_xi_many([sq[1], sq[3], sq[5]])
    t00 = fp2_add(sq[0], xi_t1[0])
    t20 = fp2_add(sq[2], xi_t1[1])
    t40 = fp2_add(sq[4], xi_t1[2])
    t01, t21, t41 = fp2_sub_many([
        (sq[6], fp2_add(sq[0], sq[1])),
        (sq[7], fp2_add(sq[2], sq[3])),
        (sq[8], fp2_add(sq[4], sq[5])),
    ])

    def m3m2(t, zz):  # 3t - 2z
        r = fp2_sub(t, zz)
        r = fp2_add(r, r)
        return fp2_add(r, t)

    def p3p2(t, zz):  # 3t + 2z
        r = fp2_add(t, zz)
        r = fp2_add(r, r)
        return fp2_add(r, t)

    z0n = m3m2(t00, z[0])
    z1n = p3p2(t01, z[1])
    z2n = p3p2(fp2_mul_xi(t41), z[2])
    z3n = m3m2(t40, z[3])
    z4n = m3m2(t20, z[4])
    z5n = p3p2(t21, z[5])
    return ((z0n, z4n, z3n), (z2n, z1n, z5n))


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

"""Batched hash-to-G2 on the device, branch-free (counterpart of the JAX
package's ops/hash_to_g2.py, unfused path).

Pipeline (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_): expand_message_xmd
(batched SHA-256) -> hash_to_field (512-bit -> Fp via Montgomery folding)
-> simplified SWU (9 mod 16 sqrt with candidate multipliers) -> 3-isogeny
-> point sum -> Budroni-Pintore cofactor clearing.

All messages of a batch share one byte length.  The two field elements
u0, u1 of each message go through ONE map call, concatenated along the
batch axis: the same field values as two calls, half the launches.
"""

import torch

from .. import constants as C
from ..golden import field as GF
from .fp import FP
from . import tower as T
from . import curve as CV
from .sha256 import sha256_bytes

# ----------------------------------------------------------------------------
# sqrt in Fp2 for q == 9 mod 16: candidate multipliers
# ----------------------------------------------------------------------------

EXP_SQRT = (C.Q2 + 7) // 16  # z = a^((q+7)/16); true sqrt is z * one of CANDS

# Frobenius split of the sqrt exponent: with p == 11 (mod 16) and
# k = (p - 11)/16, a^((p^2+7)/16) = (conj(a) * a^11)^k * a^8 -- one 377-bit
# chain plus 7 multiplies instead of a 764-bit chain.
_SQRT_K = (C.P - 11) // 16
assert C.P % 16 == 11 and _SQRT_K * C.P + 11 * _SQRT_K + 8 == EXP_SQRT


def _compute_sqrt_candidates():
    """1, sqrt(-1) = u, sqrt(u), sqrt(-u), from the host sqrt."""
    one = (1, 0)
    i_ = (0, 1)
    sq_i = GF.fp2_sqrt(i_)
    sq_mi = GF.fp2_sqrt(GF.fp2_neg(i_))
    assert sq_i is not None and sq_mi is not None
    assert GF.fp2_sqr(sq_i) == i_ and GF.fp2_sqr(sq_mi) == GF.fp2_neg(i_)
    return (one, i_, sq_i, sq_mi)


SQRT_CANDS = _compute_sqrt_candidates()


def _sqrt_from_candidate(z, target):
    """Given z with z^2 = target * w for w an 8th root of unity, try the 4
    candidate multipliers; returns (sqrt, found) branch-free."""
    best = T.fp2_zero_like(target)
    found = T.fp2_is_zero(target)  # sqrt(0) = 0
    for cand in SQRT_CANDS:
        (t,) = T.fp2_mul_pairs([(z, T._bcast(cand, target))])
        ok = T.fp2_eq(T.fp2_sqr(t), target)
        best = T.fp2_cmov(ok & ~found, t, best)
        found = found | ok
    return best, found


def _fp2_pow_sqrt(a):
    """a^EXP_SQRT via the Frobenius split: (conj(a) * a^11)^k * a^8."""
    a2 = T.fp2_sqr(a)
    a4 = T.fp2_sqr(a2)
    a8 = T.fp2_sqr(a4)
    (a3,) = T.fp2_mul_pairs([(a2, a)])
    (a11,) = T.fp2_mul_pairs([(a8, a3)])
    (b,) = T.fp2_mul_pairs([(T.fp2_conj(a), a11)])
    bk = _fp2_pow_const(b, _SQRT_K)
    (z,) = T.fp2_mul_pairs([(bk, a8)])
    return z


def _fp2_pow_const(a, exponent: int):
    """a^exponent for a host-constant exponent: 4-bit windows, MSB first
    (4 squarings + one table multiply per window)."""
    digits = []
    e = exponent
    while e:
        digits.append(e & 15)
        e >>= 4
    tab = [T.fp2_one_like(a), a]
    for i in range(2, 16):
        tab.append(T.fp2_mul(tab[i - 1], a))
    f = T.fp2_one_like(a)
    for d in reversed(digits):
        for _ in range(4):
            f = T.fp2_sqr(f)
        f = T.fp2_mul(f, tab[d])
    return f


# ----------------------------------------------------------------------------
# expand_message_xmd + hash_to_field
# ----------------------------------------------------------------------------

def _const_bytes(bs, batch, device):
    return torch.tensor(list(bs), dtype=torch.int64, device=device).expand(batch + (len(bs),))


def expand_message_xmd(msg_u8, msg_len: int, dst: bytes, len_in_bytes: int):
    """(..., msg_len) byte tensor -> (..., len_in_bytes) byte tensor
    (RFC 9380 sec 5.3.1)."""
    ell = -(-len_in_bytes // 32)
    assert ell <= 255 and len(dst) <= 255
    dst_prime = dst + bytes([len(dst)])
    batch, dev = msg_u8.shape[:-1], msg_u8.device
    tail = len_in_bytes.to_bytes(2, "big") + b"\x00" + dst_prime
    msg_prime = torch.cat(
        [_const_bytes(bytes(64), batch, dev), msg_u8.to(torch.int64),
         _const_bytes(tail, batch, dev)], -1,
    )
    b0 = sha256_bytes(msg_prime, 64 + msg_len + len(tail))
    tail_dst = _const_bytes(dst_prime, batch, dev)
    blen = 32 + 1 + len(dst_prime)

    def block_input(prev_xor, ctr):
        return torch.cat([prev_xor, _const_bytes(bytes([ctr]), batch, dev), tail_dst], -1)

    prev = sha256_bytes(block_input(b0, 1), blen)
    blocks = [prev]
    for i in range(2, ell + 1):
        prev = sha256_bytes(block_input(b0 ^ prev, i), blen)
        blocks.append(prev)
    return torch.cat(blocks, -1)[..., :len_in_bytes]


def _bytes_be_to_fp(tv):
    """(..., 64) big-endian bytes -> Fp Montgomery limbs:
    v = hi*2^384 + lo, v*R = mont_mul(lo, R^2) + mont_mul(hi, R^3)."""
    rev = tv.flip(-1)
    limbs = (rev[..., 0::2] + (rev[..., 1::2] << 8)).to(torch.int32)  # (..., 32)
    lo = limbs[..., :24]
    hi = torch.cat([limbs[..., 24:], torch.zeros_like(limbs[..., :16])], -1)
    consts = torch.stack([
        FP.const("R2", tv.device).expand(lo.shape),
        FP.const("R3", tv.device).expand(hi.shape),
    ])
    prods = FP.mul(torch.stack([lo, hi]), consts)
    return FP.add(prods[0], prods[1])


def hash_to_field_fp2(msg_u8, msg_len: int, count: int = 2, dst: bytes = C.DST_G2):
    """-> list of `count` Fp2 elements (Montgomery form), 64 bytes per base
    field element."""
    m = 2
    uniform = expand_message_xmd(msg_u8, msg_len, dst, count * m * C.L_FIELD)
    out = []
    for i in range(count):
        coords = []
        for j in range(m):
            off = C.L_FIELD * (j + i * m)
            coords.append(_bytes_be_to_fp(uniform[..., off : off + C.L_FIELD]))
        out.append((coords[0], coords[1]))
    return out


# ----------------------------------------------------------------------------
# simplified SWU for AB != 0 (9 mod 16), then 3-isogeny
# ----------------------------------------------------------------------------

# c1 = -B/A, c2 = -1/Z (host-precomputed)
_C1_HOST = GF.fp2_mul(GF.fp2_neg(C.SSWU_B), GF.fp2_inv(C.SSWU_A))
_C2_HOST = GF.fp2_neg(GF.fp2_inv(C.SSWU_Z))
# Cz3 = (Z^3)^((q+7)/16): lets sqrt(gx2) reuse the gx1 exponentiation
_Z3_HOST = GF.fp2_mul(GF.fp2_mul(C.SSWU_Z, C.SSWU_Z), C.SSWU_Z)
assert not GF.fp2_is_square(_Z3_HOST), "Z^3 must be a non-residue"
_CZ3_HOST = GF.fp2_pow(_Z3_HOST, (C.Q2 + 7) // 16)


def sswu_map(u):
    """u (Fp2) -> affine point on E2' (branch-free, RFC 9380 F.2.1.2)."""
    u2 = T.fp2_sqr(u)
    (tv1,) = T.fp2_mul_pairs([(T._bcast(C.SSWU_Z, u), u2)])
    tv2 = T.fp2_add(T.fp2_sqr(tv1), tv1)
    inv_tv2 = T.fp2_inv(tv2)  # 0 -> 0
    e1 = T.fp2_is_zero(tv2)
    x1f = T.fp2_add(T.fp2_one_like(u), inv_tv2)
    x1f = T.fp2_cmov(e1, T._bcast(_C2_HOST, u), x1f)
    (x1,) = T.fp2_mul_pairs([(T._bcast(_C1_HOST, u), x1f)])
    A = T._bcast(C.SSWU_A, u)
    B = T._bcast(C.SSWU_B, u)
    # gx1 = x1^3 + A x1 + B
    x1sq = T.fp2_sqr(x1)
    gx1_a, ax1 = T.fp2_mul_pairs([(x1sq, x1), (A, x1)])
    gx1 = T.fp2_add(T.fp2_add(gx1_a, ax1), B)
    # x2 = tv1 * x1 ; gx2 evaluated directly (exact for all u)
    (x2,) = T.fp2_mul_pairs([(tv1, x1)])
    x2sq = T.fp2_sqr(x2)
    gx2_a, ax2 = T.fp2_mul_pairs([(x2sq, x2), (A, x2)])
    gx2 = T.fp2_add(T.fp2_add(gx2_a, ax2), B)
    # one shared exponentiation: z1 = gx1^((q+7)/16); z1 * Cz3 * u^3 gives
    # the sqrt(gx2) candidates
    z1 = _fp2_pow_sqrt(gx1)
    y1, ok1 = _sqrt_from_candidate(z1, gx1)
    (u3,) = T.fp2_mul_pairs([(u2, u)])
    (zc,) = T.fp2_mul_pairs([(z1, T._bcast(_CZ3_HOST, u))])
    (z2,) = T.fp2_mul_pairs([(zc, u3)])
    y2, _ = _sqrt_from_candidate(z2, gx2)
    x = T.fp2_cmov(ok1, x1, x2)
    y = T.fp2_cmov(ok1, y1, y2)
    # fix sign: sgn0(y) == sgn0(u)
    flip = T.fp2_sgn0(u) != T.fp2_sgn0(y)
    y = T.fp2_cmov(flip, T.fp2_neg(y), y)
    return x, y


def _horner(coeffs, x):
    acc = T._bcast(coeffs[-1], x)
    for c in reversed(coeffs[:-1]):
        (ax,) = T.fp2_mul_pairs([(acc, x)])
        acc = T.fp2_add(ax, T._bcast(c, x))
    return acc


def iso3_map_jacobian(x, y):
    """3-isogeny E2' -> E2 in Jacobian coords (no inversion), Z = xd*yd:
    X = xn*yd*Z, Y = y*yn*xd*Z^2.  xd == 0 or yd == 0 gives infinity."""
    xn = _horner(C.ISO3_XNUM, x)
    xd = _horner(C.ISO3_XDEN, x)
    yn = _horner(C.ISO3_YNUM, x)
    yd = _horner(C.ISO3_YDEN, x)
    (z,) = T.fp2_mul_pairs([(xd, yd)])
    xnyd, yxd = T.fp2_mul_pairs([(xn, yd), (y, xd)])
    (X,) = T.fp2_mul_pairs([(xnyd, z)])
    z2 = T.fp2_sqr(z)
    (ynyxd,) = T.fp2_mul_pairs([(yn, yxd)])
    (Y,) = T.fp2_mul_pairs([(ynyxd, z2)])
    return (X, Y, z)


def map_to_curve_g2(u):
    """SSWU + isogeny -> G2 Jacobian point."""
    x, y = sswu_map(u)
    return iso3_map_jacobian(x, y)


def hash_to_g2(msg_u8, msg_len: int, dst: bytes = C.DST_G2):
    """Full batched hash-to-G2 -> Jacobian G2 point (in the subgroup)."""
    u0, u1 = hash_to_field_fp2(msg_u8, msg_len, 2, dst)
    b = u0[0].shape[0]
    q = map_to_curve_g2((torch.cat([u0[0], u1[0]]), torch.cat([u0[1], u1[1]])))
    q0 = tuple((c[0][:b], c[1][:b]) for c in q)
    q1 = tuple((c[0][b:], c[1][b:]) for c in q)
    return CV.g2_clear_cofactor(CV.pt_add(CV.FP2_OPS, q0, q1))

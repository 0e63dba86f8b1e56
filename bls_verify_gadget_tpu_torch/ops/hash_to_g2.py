"""Batched hash-to-G2 on the device, branch-free (counterpart of the JAX
package's ops/hash_to_g2.py, fused path).

Pipeline (RFC 9380 BLS12381G2_XMD:SHA-256_SSWU_RO_): expand_message_xmd
(SHA-256 and the b_1..b_ell chain in ONE xmd launch) -> hash_to_field
(512-bit -> Fp via Montgomery folding) -> both simplified-SWU maps, their
3-isogeny and their sum in ONE sswu_map2 kernel launch -> Budroni-Pintore
cofactor clearing in ONE g2_cofactor launch (ops/curve.py).  Messages of
one batch share a padded width; `lens` gives each element its own byte
length (mixed-length batches).  The plain versions of xmd and sswu_map2
are here, beside the constant tables that they and the kernels read, and
fp2_sqrt_candidates, the Fp2 square root that the R1CS witness VM's sqrt2
kind takes (the JAX package's function of that name).
"""

import torch

from .. import constants as C
from ..golden import field as GF
from .fp import FP
from . import kernels as K
from . import curve as CV
from . import tower as T
from .tower import F2, pow_win_plain
from .sha256 import sha256_bytes, sha256_bytes_var

# ----------------------------------------------------------------------------
# sqrt in Fp2 for q == 9 mod 16: candidate multipliers
# ----------------------------------------------------------------------------

# z = a^((q+7)/16); the true sqrt is z times one of 1, u, sqrt(u), sqrt(-u).
# Frobenius split of the exponent: with p == 11 (mod 16) and k = (p - 11)/16,
# a^((p^2+7)/16) = (conj(a) * a^11)^k * a^8 -- one 377-bit chain plus 7
# multiplies instead of a 764-bit chain.
SQRT_K = (C.P - 11) // 16
assert C.P % 16 == 11 and SQRT_K * C.P + 11 * SQRT_K + 8 == (C.Q2 + 7) // 16


def _compute_sqrt_candidates():
    """sqrt(u), sqrt(-u) from the host sqrt."""
    sq_i = GF.fp2_sqrt((0, 1))
    sq_mi = GF.fp2_sqrt(GF.fp2_neg((0, 1)))
    assert sq_i is not None and sq_mi is not None
    assert GF.fp2_sqr(sq_i) == (0, 1) and GF.fp2_sqr(sq_mi) == GF.fp2_neg((0, 1))
    return sq_i, sq_mi


# the candidate multipliers in the JAX package's order: 1, u, sqrt(u),
# sqrt(-u)
SQRT_CANDS = ((1, 0), (0, 1), *_compute_sqrt_candidates())


def _sqrt_from_candidate(z, target):
    """Given z with z^2 = target * w for w an 8th root of unity, the first
    of z * c over SQRT_CANDS whose square is target -> (sqrt, found), both
    branch-free; sqrt(0) = 0 is found.  The four products in one fp2_mul
    launch, their squares in one fp2_sqr launch."""
    ts = T.fp2_mul_pairs([(z, T._bcast(c, target)) for c in SQRT_CANDS])
    sqs = T.fp2_sqr_many(ts)
    best = T.fp2_zero_like(target)
    found = T.fp2_is_zero(target)
    for t, sq in zip(ts, sqs):
        ok = T.fp2_eq(sq, target)
        best = T.fp2_cmov(ok & ~found, t, best)
        found = found | ok
    return best, found


def _fp2_pow_sqrt(a):
    """a^((p^2 + 7)/16) by the Frobenius split: (conj(a) * a^11)^SQRT_K *
    a^8, the 377-bit chain in one Fp2 pow_win launch."""
    a2 = T.fp2_sqr(a)
    a4 = T.fp2_sqr(a2)
    a8 = T.fp2_sqr(a4)
    a3 = T.fp2_mul(a2, a)
    a11 = T.fp2_mul(a8, a3)
    b = T.fp2_mul(T.fp2_conj(a), a11)
    shape = b[0].shape
    # the op count charges the JAX package's windows: its digits rounded
    # up to a multiple of 8 (hash_to_g2._fp2_pow_const)
    nwin = -(-len(K.pow_digits(SQRT_K)) // 8) * 8
    bk = K.pow_win(FP, torch.stack(b).reshape(2, -1, C.NLIMB), SQRT_K, nwin)
    bk = bk.reshape(2, *shape)
    return T.fp2_mul((bk[0], bk[1]), a8)


def fp2_sqrt_candidates(a):
    """(sqrt, is_square) of the Fp2 a = (a0, a1), limb tensors of one
    shape, branch-free: the root the JAX package's fp2_sqrt_candidates
    returns (one pow, then the candidates in its order); 0 where a is not
    a square."""
    return _sqrt_from_candidate(_fp2_pow_sqrt(a), a)


# ----------------------------------------------------------------------------
# expand_message_xmd + hash_to_field
# ----------------------------------------------------------------------------

def _const_bytes(bs, batch, device):
    return torch.tensor(list(bs), dtype=torch.int64, device=device).expand(batch + (len(bs),))


def _xmd_tail(dst: bytes, len_in_bytes: int):
    """(I2OSP(len_in_bytes, 2) || 0 || DST', DST') of expand_message_xmd."""
    if not 1 <= -(-len_in_bytes // 32) <= 255 or len(dst) > 255:
        raise ValueError(f"expand_message_xmd takes 1 to {255 * 32} bytes out and a DST of at "
                         f"most 255 bytes, got {len_in_bytes} and {len(dst)}")
    dst_prime = dst + bytes([len(dst)])
    return len_in_bytes.to_bytes(2, "big") + b"\x00" + dst_prime, dst_prime


def xmd_plain(msg_u8, lens, dst: bytes, len_in_bytes: int):
    """Plain version of the xmd kernel: expand_message_xmd (RFC 9380 sec
    5.3.1) of each (..., L) row of byte values -> (..., len_in_bytes) uint8.
    With `lens` ((...,) byte lengths <= L), each row is its first lens
    bytes: msg' = Z_pad || msg || I2OSP(len_in_bytes, 2) || 0 || DST' is
    built by masks, as the JAX package does, and hashed by sha256_bytes_var
    (every element pays the block count of the widest)."""
    tail, dst_prime = _xmd_tail(dst, len_in_bytes)
    ell = -(-len_in_bytes // 32)
    batch, dev, width = msg_u8.shape[:-1], msg_u8.device, msg_u8.shape[-1]
    msg = msg_u8.to(torch.int64)
    if lens is None:
        msg_prime = torch.cat([_const_bytes(bytes(64), batch, dev), msg,
                               _const_bytes(tail, batch, dev)], -1)
        b0 = sha256_bytes(msg_prime, 64 + width + len(tail))
    else:
        n = lens.to(device=dev, dtype=torch.int64)[..., None]
        total = 64 + width + len(tail)
        buf = torch.cat([_const_bytes(bytes(64), batch, dev), msg,
                         torch.zeros(batch + (len(tail),), dtype=torch.int64, device=dev)], -1)
        iota = torch.arange(total, device=dev)
        # the tail starts right after each element's own message bytes
        t_idx = (iota - 64 - n).clamp(0, len(tail) - 1)
        tail_vals = torch.tensor(list(tail), dtype=torch.int64, device=dev)[t_idx]
        buf = torch.where(iota < 64 + n, buf, tail_vals)
        b0 = sha256_bytes_var(buf, n[..., 0] + 64 + len(tail), total)
    tail_dst = _const_bytes(dst_prime, batch, dev)
    blen = 32 + 1 + len(dst_prime)

    def block_input(prev_xor, ctr):
        return torch.cat([prev_xor, _const_bytes(bytes([ctr]), batch, dev), tail_dst], -1)

    prev = sha256_bytes(block_input(b0, 1), blen)
    blocks = [prev]
    for i in range(2, ell + 1):
        prev = sha256_bytes(block_input(b0 ^ prev, i), blen)
        blocks.append(prev)
    return torch.cat(blocks, -1)[..., :len_in_bytes].to(torch.uint8)


# Words of the xmd kernel's table (csrc/xmd_kernels.cu kExtWords,
# kTmplWords): b0's bytes past the message, up to 72 past its tail (b0's
# last block), then the padded b_i input as words.
XMD_EXT_WORDS, XMD_TMPL_WORDS = 84, 80
_xmd_tables = {}


def xmd_table(dst: bytes, len_in_bytes: int, device):
    """-> ((164,) int32 table, tail length, blocks per b_i) of the xmd
    kernel on `device` (built once per DST, output length and device).
    The table holds, as bytes in memory order, I2OSP(len_in_bytes, 2) ||
    0 || DST' || 0x80 and zeros (b0's bytes past each message, its padding
    up to the bit length), then, as big-endian words, the padded SHA-256
    input of b_i = H(x || i || DST') with the 32 bytes of x and the counter
    i zero: every b_i's blocks but those 33 bytes."""
    dev = torch.device(device)
    key = (dst, len_in_bytes, dev)
    hit = _xmd_tables.get(key)
    if hit is None:
        tail, dst_prime = _xmd_tail(dst, len_in_bytes)
        ext = tail + b"\x80" + bytes(4 * XMD_EXT_WORDS - len(tail) - 1)
        m = 33 + len(dst_prime)
        nbi = (m + 8) // 64 + 1
        tmpl = bytes(33) + dst_prime + b"\x80"
        tmpl += bytes(nbi * 64 - 8 - len(tmpl)) + (8 * m).to_bytes(8, "big")
        tmpl += bytes(4 * XMD_TMPL_WORDS - len(tmpl))
        words = [int.from_bytes(ext[i : i + 4], "little") for i in range(0, len(ext), 4)]
        words += [int.from_bytes(tmpl[i : i + 4], "big") for i in range(0, len(tmpl), 4)]
        table = torch.tensor([w - (1 << 32) if w >> 31 else w for w in words],
                             dtype=torch.int32, device=dev)
        hit = _xmd_tables[key] = (table, len(tail), nbi)
    return hit


def expand_message_xmd(msg_u8, msg_len: int, dst: bytes, len_in_bytes: int, lens=None):
    """(..., msg_len) byte tensor -> (..., len_in_bytes) uint8 tensor (RFC
    9380 sec 5.3.1): ONE xmd launch on a CUDA tensor, its plain version on
    a CPU one.  With `lens` ((...,) per-element byte lengths <= msg_len),
    messages of different lengths batch together and msg_len is the
    padded width."""
    if msg_u8.shape[-1] != msg_len:
        raise ValueError(f"msg_len {msg_len} != message width {msg_u8.shape[-1]}")
    return K.xmd(msg_u8, lens, dst, len_in_bytes)


def _bytes_be_to_fp(tv):
    """(..., 64) big-endian bytes -> Fp Montgomery limbs:
    v = hi*2^384 + lo, v*R = mont_mul(lo, R^2) + mont_mul(hi, R^3).
    Widened first: a uint8 byte shifted by 8 would wrap."""
    rev = tv.flip(-1).to(torch.int32)
    limbs = rev[..., 0::2] + (rev[..., 1::2] << 8)  # (..., 32)
    lo = limbs[..., :24]
    hi = torch.cat([limbs[..., 24:], torch.zeros_like(limbs[..., :16])], -1)
    consts = torch.stack([
        FP.const("R2", tv.device).expand(lo.shape),
        FP.const("R3", tv.device).expand(hi.shape),
    ])
    prods = FP.mul(torch.stack([lo, hi]), consts)
    return FP.add(prods[0], prods[1])


def hash_to_field_fp2(msg_u8, msg_len: int, count: int = 2, dst: bytes = C.DST_G2,
                      lens=None):
    """-> list of `count` Fp2 elements (Montgomery form), 64 bytes per base
    field element; `lens` as in expand_message_xmd."""
    m = 2
    uniform = expand_message_xmd(msg_u8, msg_len, dst, count * m * C.L_FIELD, lens)
    out = []
    for i in range(count):
        coords = []
        for j in range(m):
            off = C.L_FIELD * (j + i * m)
            coords.append(_bytes_be_to_fp(uniform[..., off : off + C.L_FIELD]))
        out.append((coords[0], coords[1]))
    return out


# ----------------------------------------------------------------------------
# both simplified-SWU maps (AB != 0, 9 mod 16) + 3-isogeny + their sum
# ----------------------------------------------------------------------------

# Cz3 = (Z^3)^((q+7)/16): lets sqrt(gx2) reuse the gx1 exponentiation
_Z3_HOST = GF.fp2_mul(GF.fp2_mul(C.SSWU_Z, C.SSWU_Z), C.SSWU_Z)
assert not GF.fp2_is_square(_Z3_HOST), "Z^3 must be a non-residue"

# Rows of the SSWU constant table (an Fp2 is two rows, Montgomery form):
# the columns of the JAX kernel's constant block, in its order.
SSWU_A, SSWU_B, SSWU_Z, SSWU_ZA, SSWU_Z3, SSWU_CZ3, SSWU_SQI, SSWU_SQMI = range(0, 16, 2)
SSWU_XNUM, SSWU_XDEN, SSWU_YNUM, SSWU_YDEN = 16, 24, 30, 38
SSWU_ROWS = 46
_SSWU_VALUES = [
    C.SSWU_A, C.SSWU_B, C.SSWU_Z, GF.fp2_mul(C.SSWU_Z, C.SSWU_A), _Z3_HOST,
    GF.fp2_pow(_Z3_HOST, (C.Q2 + 7) // 16), *_compute_sqrt_candidates(),
    *C.ISO3_XNUM, *C.ISO3_XDEN, *C.ISO3_YNUM, *C.ISO3_YDEN,
]
assert 2 * len(_SSWU_VALUES) == SSWU_ROWS
_sswu_tables = {}


def sswu_consts(device):
    """The (46, 24) int32 table of the SSWU map's constants on `device`
    (built once per device): the sswu_map2 kernel's device operand."""
    dev = torch.device(device)
    t = _sswu_tables.get(dev)
    if t is None:
        t = FP.encode([c for v in _SSWU_VALUES for c in v], dev)
        _sswu_tables[dev] = t
    return t


def _sel(mask, a, b):
    """Per element (..., N) mask: a where set, else b, for Fp2 tensors
    (..., 2, N, 24)."""
    return torch.where(mask[..., None, :, None], a, b)


def _muli(a):
    """a * u = -a1 + a0 u"""
    a0, a1 = a.unbind(-3)
    return torch.stack([FP.sub_plain(torch.zeros_like(a1), a1), a0], -3)


def _cand_select(z, X, R, target, sqi, sqmi):
    """Fraction-form sqrt candidate resolution (the JAX kernels'
    _cand_select_rows): y = z c for the first c in (1, u, sqrt(u),
    sqrt(-u)) with X c^2 == R, X = z^2 gxd; 0 where target == 0 (sqrt(0) =
    0) or nothing passes.  -> (y numerator, found)."""
    neg_x = F2.neg(X)
    checks = [
        (F2.eq(X, R), z),                                # c^2 = 1
        (F2.eq(neg_x, R), _muli(z)),                     # c^2 = -1
        (F2.eq(_muli(X), R), F2.mul(z, sqi)),            # c^2 = u
        (F2.eq(torch.stack([X[..., 1, :, :], neg_x[..., 0, :, :]], -3), R),
         F2.mul(z, sqmi)),                               # c^2 = -u
    ]
    found = F2.is_zero(target)
    best = torch.zeros_like(z)
    for ok, val in checks:
        best = _sel(ok & ~found, val, best)
        found = found | ok
    return best, found


def _sgn0(a):
    """RFC 9380 sgn0 (m = 2) of Fp2 tensors (..., 2, N, 24) on their
    canonical values: out of Montgomery form by a product with a raw 1."""
    raw1 = torch.zeros_like(a[..., :1, :1, :])
    raw1[..., 0] = 1
    r0, r1 = FP.mul_plain(*torch.broadcast_tensors(a, raw1)).unbind(-3)
    return torch.where(FP.is_zero(r0), r1[..., 0] & 1, r0[..., 0] & 1)


def _horner(coeffs, x):
    acc = coeffs[-1]
    for c in reversed(coeffs[:-1]):
        acc = F2.add(F2.mul(acc, x), c)
    return acc


def sswu_map2_plain(u):
    """Plain version of the sswu_map2 kernel (_sswu_kernel): for the packed
    (4, N, 24) u = u0, u1, iso3(map(u0)) + iso3(map(u1)) as a (6, N, 24)
    Jacobian point.  Both maps ride stacked through one pass, as the TPU
    kernel's lane-concatenated halves: fraction-form SSWU with one
    Frobenius-split sqrt chain, one Fermat inversion of the four
    denominators' norms (Montgomery's trick), affine x, y, the sgn0 fix,
    the isogeny in Jacobian packing, then the complete addition."""
    tab = sswu_consts(u.device)

    def c2(row, n=1):  # n Fp2 constants from `row` on, each (2, 1, 24)
        return [tab[row + 2 * i : row + 2 * i + 2, None] for i in range(n)]

    (A,), (B,), (Z,), (ZA,) = c2(SSWU_A), c2(SSWU_B), c2(SSWU_Z), c2(SSWU_ZA)
    (CZ3,), (SQI,), (SQMI,) = c2(SSWU_CZ3), c2(SSWU_SQI), c2(SSWU_SQMI)
    n = u.shape[1]
    U = u.view(2, 2, n, u.shape[-1])  # (map, re/im, N, 24)
    one2 = torch.stack([FP.one_like(U[0, 0]), torch.zeros_like(U[0, 0])])

    tv1 = F2.sqr(U)                                  # u^2
    tv3 = F2.mul(Z, tv1)                             # Z u^2
    t = F2.add(F2.sqr(tv3), tv3)
    e1 = F2.is_zero(t)
    xn = _sel(e1, B, F2.neg(F2.mul(B, F2.add(t, one2))))   # -B (t + 1)
    xd = _sel(e1, ZA, F2.mul(A, t))                       # t == 0: B / (Z A)
    xd2 = F2.sqr(xd)
    xd3 = F2.mul(xd2, xd)

    def gx_num(num):  # over gxd = xd^3
        return F2.add(F2.add(F2.mul(F2.sqr(num), num), F2.mul(A, F2.mul(num, xd2))),
                      F2.mul(B, xd3))

    gxn, gxd = gx_num(xn), xd3
    g2 = F2.sqr(gxd)
    g4 = F2.sqr(g2)
    g8 = F2.sqr(g4)
    W = F2.mul(gxn, F2.mul(F2.mul(g8, g4), F2.mul(g2, gxd)))
    w2 = F2.sqr(W)
    w8 = F2.sqr(F2.sqr(w2))
    b = F2.mul(F2.conj(W), F2.mul(w8, F2.mul(w2, W)))
    # the sqrt chain b^k for both maps as one (2, 2N, 24) Fp2 operand
    bk = pow_win_plain(b.transpose(0, 1).reshape(2, 2 * n, -1), SQRT_K)
    z1 = F2.mul(bk.view(2, 2, n, -1).transpose(0, 1), w8)
    yd = g8  # gxd^(q+7) = gxd^8
    yd2 = F2.sqr(yd)
    yn1, found1 = _cand_select(z1, F2.mul(F2.sqr(z1), gxd), F2.mul(gxn, yd2), gxn, SQI, SQMI)
    x2n = F2.mul(tv3, xn)
    gx2n = gx_num(x2n)
    z2 = F2.mul(F2.mul(z1, CZ3), F2.mul(tv1, U))
    yn2, _ = _cand_select(z2, F2.mul(F2.sqr(z2), gxd), F2.mul(gx2n, yd2), gx2n, SQI, SQMI)
    xn = _sel(found1, xn, x2n)
    yn = _sel(found1, yn1, yn2)

    # one Fermat inversion for the four norms (xd, yd of each map)
    xy_d = torch.stack([xd, yd], 1)  # (map, x/y, 2, N, 24)
    d0, d1 = xy_d.unbind(-3)
    ns = FP.add_plain(FP.mul_plain(d0, d0), FP.mul_plain(d1, d1)).reshape(4, n, -1)
    pre1 = FP.mul_plain(ns[0], ns[1])
    pre2 = FP.mul_plain(pre1, ns[2])
    (tinv,) = pow_win_plain(FP.mul_plain(pre2, ns[3])[None], C.P - 2)
    inv3 = FP.mul_plain(tinv, pre2)
    tinv = FP.mul_plain(tinv, ns[3])
    inv2 = FP.mul_plain(tinv, pre1)
    tinv = FP.mul_plain(tinv, ns[2])
    inv1 = FP.mul_plain(tinv, ns[0])
    inv0 = FP.mul_plain(tinv, ns[1])
    invs = torch.stack([inv0, inv1, inv2, inv3]).view(2, 2, n, -1)  # (map, x/y, N, 24)
    ixd, iyd = F2.muls(F2.conj(xy_d), invs).unbind(1)

    x = F2.mul(xn, ixd)
    y = F2.mul(yn, iyd)
    y = _sel(_sgn0(U) != _sgn0(y), F2.neg(y), y)
    xnum = _horner(c2(SSWU_XNUM, 4), x)
    xden = _horner(c2(SSWU_XDEN, 3), x)
    ynum = _horner(c2(SSWU_YNUM, 4), x)
    yden = _horner(c2(SSWU_YDEN, 4), x)
    z = F2.mul(xden, yden)
    X = F2.mul(F2.mul(xnum, yden), z)
    Y = F2.mul(F2.mul(ynum, F2.mul(y, xden)), F2.sqr(z))
    q0, q1 = ((X[m], Y[m], z[m]) for m in range(2))
    return CV.pack_point(CV.FP2_PLAIN, CV.pt_add(CV.FP2_PLAIN, q0, q1))


def sswu_map2(u0, u1):
    """iso3(map(u0)) + iso3(map(u1)) (Fp2 pairs, (B, 24) each) as a Jacobian
    G2 point: ONE sswu_map2 kernel launch."""
    return CV.unpack_point(CV.FP2_OPS, K.sswu_map2(FP, torch.stack([*u0, *u1])))


def hash_to_g2_steps(msg_len: int, dst: bytes = C.DST_G2, lens=None):
    """hash_to_g2 as its ordered steps [(name, fn)]: each fn takes the
    previous step's output, the first the (B, msg_len) message bytes
    (with `lens`, each row's first lens bytes)."""
    return [
        ("xmd+hash_to_field", lambda msg: hash_to_field_fp2(msg, msg_len, 2, dst, lens)),
        ("sswu_map2", lambda u: sswu_map2(*u)),
        ("g2_cofactor", CV.g2_clear_cofactor),
    ]


def hash_to_g2(msg_u8, msg_len: int, dst: bytes = C.DST_G2, lens=None):
    """Full batched hash-to-G2 -> Jacobian G2 point (in the subgroup);
    `lens` enables mixed-length batches (see expand_message_xmd)."""
    x = msg_u8
    for _, step in hash_to_g2_steps(msg_len, dst, lens):
        x = step(x)
    return x

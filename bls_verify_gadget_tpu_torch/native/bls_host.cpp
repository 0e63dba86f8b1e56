// Native host-side codec of bls_verify_gadget_tpu_torch (own copy of the
// reference package's native/bls_host.cpp).
//
// Batch G1/G2 compressed-point decompression and compression with full
// validation (flag bits, range, on-curve, fast subgroup checks) at the host
// I/O boundary, the role of ark-serialize + ark-ec validation in the
// reference crate.
//
// Arithmetic: 6x64-bit Montgomery over the BLS12-381 base field using
// unsigned __int128 accumulation; affine coordinates in/out are big-endian
// canonical (non-Montgomery) 48-byte strings.
//
// Build (bls_verify_gadget_tpu_torch/native_codec.py does it on first use):
//   python -m bls_verify_gadget_tpu_torch.native.gen_constants DIR
//   g++ -O3 -shared -fPIC -I DIR -o libbls_host.so bls_host.cpp
// Exposed C ABI (see bls_verify_gadget_tpu_torch/native_codec.py for the
// ctypes wrapper):
//   int bls_g1_decompress_batch(const uint8_t* in, size_t n,
//                               uint8_t* out_xy, uint8_t* status);
//   int bls_g2_decompress_batch(...);
//   void bls_g1_compress_batch(const uint8_t* in_xy, const uint8_t* inf,
//                              size_t n, uint8_t* out);
//   void bls_g2_compress_batch(...);
// status per point: 0 ok, 1 infinity, >=2 reject reason.

#include <cstdint>
#include <cstring>
#include "constants.h"

typedef unsigned __int128 u128;

struct Fp { uint64_t l[6]; };

static inline bool fp_is_zero(const Fp& a) {
    uint64_t r = 0; for (int i = 0; i < 6; i++) r |= a.l[i];
    return r == 0;
}

static inline int fp_cmp(const Fp& a, const Fp& b) {
    for (int i = 5; i >= 0; i--) {
        if (a.l[i] < b.l[i]) return -1;
        if (a.l[i] > b.l[i]) return 1;
    }
    return 0;
}

static inline void fp_sub_raw(Fp& o, const Fp& a, const Fp& b) {
    u128 borrow = 0;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)a.l[i] - b.l[i] - borrow;
        o.l[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
}

static inline void fp_add(Fp& o, const Fp& a, const Fp& b) {
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 s = (u128)a.l[i] + b.l[i] + carry;
        o.l[i] = (uint64_t)s;
        carry = s >> 64;
    }
    Fp p; memcpy(p.l, FP_P, sizeof p.l);
    if (carry || fp_cmp(o, p) >= 0) fp_sub_raw(o, o, p);
}

static inline void fp_sub(Fp& o, const Fp& a, const Fp& b) {
    if (fp_cmp(a, b) >= 0) { fp_sub_raw(o, a, b); return; }
    Fp p; memcpy(p.l, FP_P, sizeof p.l);
    Fp t; fp_sub_raw(t, b, a);
    fp_sub_raw(o, p, t);
}

static inline void fp_neg(Fp& o, const Fp& a) {
    if (fp_is_zero(a)) { o = a; return; }
    Fp p; memcpy(p.l, FP_P, sizeof p.l);
    fp_sub_raw(o, p, a);
}

// CIOS Montgomery multiply, 64-bit radix.
static void fp_mul(Fp& o, const Fp& a, const Fp& b) {
    uint64_t t[8] = {0};
    for (int i = 0; i < 6; i++) {
        // t += a_i * b
        u128 carry = 0;
        for (int j = 0; j < 6; j++) {
            u128 s = (u128)t[j] + (u128)a.l[i] * b.l[j] + carry;
            t[j] = (uint64_t)s;
            carry = s >> 64;
        }
        u128 s = (u128)t[6] + carry;
        t[6] = (uint64_t)s;
        t[7] = (uint64_t)(s >> 64);
        // reduce
        uint64_t m = t[0] * FP_N0;
        carry = ((u128)t[0] + (u128)m * FP_P[0]) >> 64;
        for (int j = 1; j < 6; j++) {
            u128 s2 = (u128)t[j] + (u128)m * FP_P[j] + carry;
            t[j - 1] = (uint64_t)s2;
            carry = s2 >> 64;
        }
        s = (u128)t[6] + carry;
        t[5] = (uint64_t)s;
        t[6] = t[7] + (uint64_t)(s >> 64);
        t[7] = 0;
    }
    memcpy(o.l, t, 6 * sizeof(uint64_t));
    Fp p; memcpy(p.l, FP_P, sizeof p.l);
    if (t[6] || fp_cmp(o, p) >= 0) fp_sub_raw(o, o, p);
}

static inline void fp_sqr(Fp& o, const Fp& a) { fp_mul(o, a, a); }

static void fp_pow(Fp& o, const Fp& a, const uint64_t* exp) {
    Fp result; memcpy(result.l, FP_ONE_MONT, sizeof result.l);
    Fp base = a;
    bool started = false;
    for (int w = 5; w >= 0; w--) {
        for (int bit = 63; bit >= 0; bit--) {
            if (started) fp_sqr(result, result);
            if ((exp[w] >> bit) & 1) {
                if (started) fp_mul(result, result, base);
                else { result = base; started = true; }
            }
        }
    }
    o = result;
}

static bool fp_sqrt(Fp& o, const Fp& a) {  // a Montgomery; p == 3 mod 4
    if (fp_is_zero(a)) { o = a; return true; }
    Fp cand; fp_pow(cand, a, SQRT_EXP);
    Fp chk; fp_sqr(chk, cand);
    if (fp_cmp(chk, a) != 0) return false;
    o = cand;
    return true;
}

static void fp_to_mont(Fp& o, const Fp& a) {
    Fp r2; memcpy(r2.l, FP_R2, sizeof r2.l);
    fp_mul(o, a, r2);
}

static void fp_from_mont(Fp& o, const Fp& a) {
    Fp one = {{1, 0, 0, 0, 0, 0}};
    fp_mul(o, a, one);
}

// big-endian 48-byte <-> Fp (canonical).  Returns false if >= p.
static bool fp_from_be(Fp& o, const uint8_t* in) {
    for (int i = 0; i < 6; i++) {
        uint64_t w = 0;
        for (int j = 0; j < 8; j++) w = (w << 8) | in[(5 - i) * 8 + j];
        o.l[i] = w;
    }
    Fp p; memcpy(p.l, FP_P, sizeof p.l);
    return fp_cmp(o, p) < 0;
}

static void fp_to_be(uint8_t* out, const Fp& a) {
    for (int i = 0; i < 6; i++) {
        uint64_t w = a.l[5 - i];
        for (int j = 0; j < 8; j++) out[i * 8 + j] = (uint8_t)(w >> (8 * (7 - j)));
    }
}

// ---------------------------------------------------------------------------
// Fp2
// ---------------------------------------------------------------------------

struct Fp2 { Fp c0, c1; };

static inline bool fp2_is_zero(const Fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }

static void fp2_add(Fp2& o, const Fp2& a, const Fp2& b) {
    fp_add(o.c0, a.c0, b.c0); fp_add(o.c1, a.c1, b.c1);
}
static void fp2_sub(Fp2& o, const Fp2& a, const Fp2& b) {
    fp_sub(o.c0, a.c0, b.c0); fp_sub(o.c1, a.c1, b.c1);
}
static void fp2_neg(Fp2& o, const Fp2& a) { fp_neg(o.c0, a.c0); fp_neg(o.c1, a.c1); }

static void fp2_mul(Fp2& o, const Fp2& a, const Fp2& b) {
    Fp v0, v1, s1, s2, v2;
    fp_mul(v0, a.c0, b.c0);
    fp_mul(v1, a.c1, b.c1);
    fp_add(s1, a.c0, a.c1);
    fp_add(s2, b.c0, b.c1);
    fp_mul(v2, s1, s2);
    Fp re; fp_sub(re, v0, v1);
    Fp im; fp_sub(im, v2, v0); fp_sub(im, im, v1);
    o.c0 = re; o.c1 = im;
}

static void fp2_sqr(Fp2& o, const Fp2& a) { fp2_mul(o, a, a); }

static void fp_inv(Fp& o, const Fp& a) {  // Fermat (Montgomery in/out)
    // exp = p - 2
    uint64_t e[6]; memcpy(e, FP_P, sizeof e);
    // subtract 2
    u128 borrow = 2;
    for (int i = 0; i < 6; i++) {
        u128 d = (u128)e[i] - borrow;
        e[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
    fp_pow(o, a, e);
}

static void fp2_inv(Fp2& o, const Fp2& a) {
    Fp n, t0, t1;
    fp_sqr(t0, a.c0); fp_sqr(t1, a.c1); fp_add(n, t0, t1);
    Fp ni; fp_inv(ni, n);
    fp_mul(o.c0, a.c0, ni);
    Fp nneg; fp_neg(nneg, ni);
    fp_mul(o.c1, a.c1, nneg);
}

// Fp2 sqrt via the norm trick (p == 3 mod 4); a Montgomery, returns false
// if not a square.  Mirrors golden/field.py fp2_sqrt.
static bool fp2_sqrt(Fp2& o, const Fp2& a) {
    if (fp2_is_zero(a)) { o = a; return true; }
    if (fp_is_zero(a.c1)) {
        if (fp_sqrt(o.c0, a.c0)) { o.c1 = Fp{}; memset(o.c1.l, 0, sizeof o.c1.l); return true; }
        Fp na; fp_neg(na, a.c0);
        Fp s;
        if (!fp_sqrt(s, na)) return false;
        memset(o.c0.l, 0, sizeof o.c0.l);
        o.c1 = s;
        return true;
    }
    Fp n, t0, t1;
    fp_sqr(t0, a.c0); fp_sqr(t1, a.c1); fp_add(n, t0, t1);
    Fp m;
    if (!fp_sqrt(m, n)) return false;
    // alpha = (c0 + m)/2 — division by 2 via multiply with inv2 (Montgomery)
    Fp two_m; memcpy(two_m.l, FP_ONE_MONT, sizeof two_m.l); fp_add(two_m, two_m, two_m);
    Fp inv2; fp_inv(inv2, two_m);
    Fp alpha; fp_add(alpha, a.c0, m); fp_mul(alpha, alpha, inv2);
    Fp s;
    if (!fp_sqrt(s, alpha)) {
        fp_sub(alpha, a.c0, m); fp_mul(alpha, alpha, inv2);
        if (!fp_sqrt(s, alpha)) return false;
    }
    if (fp_is_zero(s)) return false;
    Fp s2; fp_add(s2, s, s);
    Fp s2i; fp_inv(s2i, s2);
    Fp t; fp_mul(t, a.c1, s2i);
    o.c0 = s; o.c1 = t;
    Fp2 chk; fp2_sqr(chk, o);
    return fp_cmp(chk.c0, a.c0) == 0 && fp_cmp(chk.c1, a.c1) == 0;
}

// ---------------------------------------------------------------------------
// curve ops (Jacobian, Montgomery coords) for subgroup checks
// ---------------------------------------------------------------------------

struct G1 { Fp x, y, z; };   // z == 0 -> infinity
struct G2 { Fp2 x, y, z; };

template <typename P> static bool is_inf(const P& p);
template <> bool is_inf<G1>(const G1& p) { return fp_is_zero(p.z); }
template <> bool is_inf<G2>(const G2& p) { return fp2_is_zero(p.z); }

static void g1_double(G1& o, const G1& p) {
    if (is_inf(p)) { o = p; return; }
    Fp a, b, c, d, e, f;
    fp_sqr(a, p.x);
    fp_sqr(b, p.y);
    fp_sqr(c, b);
    Fp t; fp_add(t, p.x, b); fp_sqr(t, t); fp_sub(t, t, a); fp_sub(t, t, c);
    fp_add(d, t, t);                       // D = 2((X+B)^2 - A - C)
    fp_add(e, a, a); fp_add(e, e, a);      // E = 3A
    fp_sqr(f, e);
    Fp x3; fp_sub(x3, f, d); fp_sub(x3, x3, d);
    Fp c8; fp_add(c8, c, c); fp_add(c8, c8, c8); fp_add(c8, c8, c8);
    Fp y3; fp_sub(y3, d, x3); fp_mul(y3, e, y3); fp_sub(y3, y3, c8);
    Fp z3; fp_mul(z3, p.y, p.z); fp_add(z3, z3, z3);
    o.x = x3; o.y = y3; o.z = z3;
}

static void g1_add(G1& o, const G1& p, const G1& q) {
    if (is_inf(p)) { o = q; return; }
    if (is_inf(q)) { o = p; return; }
    Fp z1z1, z2z2, u1, u2, s1, s2, t;
    fp_sqr(z1z1, p.z); fp_sqr(z2z2, q.z);
    fp_mul(u1, p.x, z2z2); fp_mul(u2, q.x, z1z1);
    fp_mul(t, p.y, z2z2); fp_mul(s1, t, q.z);
    fp_mul(t, q.y, z1z1); fp_mul(s2, t, p.z);
    Fp h; fp_sub(h, u2, u1);
    Fp r; fp_sub(r, s2, s1);
    if (fp_is_zero(h)) {
        if (fp_is_zero(r)) { g1_double(o, p); return; }
        memset(&o, 0, sizeof o); return;  // infinity
    }
    Fp hh; fp_sqr(hh, h);
    Fp hhh; fp_mul(hhh, h, hh);
    Fp v; fp_mul(v, u1, hh);
    Fp x3; fp_sqr(x3, r); fp_sub(x3, x3, hhh);
    fp_sub(x3, x3, v); fp_sub(x3, x3, v);
    Fp y3; fp_sub(y3, v, x3); fp_mul(y3, r, y3);
    Fp t2; fp_mul(t2, s1, hhh); fp_sub(y3, y3, t2);
    Fp z3; fp_mul(z3, p.z, q.z); fp_mul(z3, z3, h);
    o.x = x3; o.y = y3; o.z = z3;
}

static void g1_mul_u64(G1& o, const G1& p, uint64_t k) {
    G1 acc; memset(&acc, 0, sizeof acc);
    for (int bit = 63; bit >= 0; bit--) {
        g1_double(acc, acc);
        if ((k >> bit) & 1) g1_add(acc, acc, p);
    }
    o = acc;
}

// same for G2 over Fp2
static void g2_double(G2& o, const G2& p) {
    if (is_inf(p)) { o = p; return; }
    Fp2 a, b, c, d, e, f, t;
    fp2_sqr(a, p.x); fp2_sqr(b, p.y); fp2_sqr(c, b);
    fp2_add(t, p.x, b); fp2_sqr(t, t); fp2_sub(t, t, a); fp2_sub(t, t, c);
    fp2_add(d, t, t);
    fp2_add(e, a, a); fp2_add(e, e, a);
    fp2_sqr(f, e);
    Fp2 x3; fp2_sub(x3, f, d); fp2_sub(x3, x3, d);
    Fp2 c8; fp2_add(c8, c, c); fp2_add(c8, c8, c8); fp2_add(c8, c8, c8);
    Fp2 y3; fp2_sub(y3, d, x3); fp2_mul(y3, e, y3); fp2_sub(y3, y3, c8);
    Fp2 z3; fp2_mul(z3, p.y, p.z); fp2_add(z3, z3, z3);
    o.x = x3; o.y = y3; o.z = z3;
}

static void g2_add(G2& o, const G2& p, const G2& q) {
    if (is_inf(p)) { o = q; return; }
    if (is_inf(q)) { o = p; return; }
    Fp2 z1z1, z2z2, u1, u2, s1, s2, t;
    fp2_sqr(z1z1, p.z); fp2_sqr(z2z2, q.z);
    fp2_mul(u1, p.x, z2z2); fp2_mul(u2, q.x, z1z1);
    fp2_mul(t, p.y, z2z2); fp2_mul(s1, t, q.z);
    fp2_mul(t, q.y, z1z1); fp2_mul(s2, t, p.z);
    Fp2 h; fp2_sub(h, u2, u1);
    Fp2 r; fp2_sub(r, s2, s1);
    if (fp2_is_zero(h)) {
        if (fp2_is_zero(r)) { g2_double(o, p); return; }
        memset(&o, 0, sizeof o); return;
    }
    Fp2 hh; fp2_sqr(hh, h);
    Fp2 hhh; fp2_mul(hhh, h, hh);
    Fp2 v; fp2_mul(v, u1, hh);
    Fp2 x3; fp2_sqr(x3, r); fp2_sub(x3, x3, hhh);
    fp2_sub(x3, x3, v); fp2_sub(x3, x3, v);
    Fp2 y3; fp2_sub(y3, v, x3); fp2_mul(y3, r, y3);
    Fp2 t2; fp2_mul(t2, s1, hhh); fp2_sub(y3, y3, t2);
    Fp2 z3; fp2_mul(z3, p.z, q.z); fp2_mul(z3, z3, h);
    o.x = x3; o.y = y3; o.z = z3;
}

static void g2_mul_u64(G2& o, const G2& p, uint64_t k) {
    G2 acc; memset(&acc, 0, sizeof acc);
    for (int bit = 63; bit >= 0; bit--) {
        g2_double(acc, acc);
        if ((k >> bit) & 1) g2_add(acc, acc, p);
    }
    o = acc;
}

static void g2_psi(G2& o, const G2& p) {
    Fp2 cx, cy;
    memcpy(cx.c0.l, PSI_X_C0_MONT, sizeof cx.c0.l);
    memcpy(cx.c1.l, PSI_X_C1_MONT, sizeof cx.c1.l);
    memcpy(cy.c0.l, PSI_Y_C0_MONT, sizeof cy.c0.l);
    memcpy(cy.c1.l, PSI_Y_C1_MONT, sizeof cy.c1.l);
    Fp2 xc = p.x; fp_neg(xc.c1, xc.c1);
    Fp2 yc = p.y; fp_neg(yc.c1, yc.c1);
    Fp2 zc = p.z; fp_neg(zc.c1, zc.c1);
    fp2_mul(o.x, cx, xc);
    fp2_mul(o.y, cy, yc);
    o.z = zc;
}

// projective equality X1 Z2^2 == X2 Z1^2 && Y1 Z2^3 == Y2 Z1^3
static bool g2_eq(const G2& p, const G2& q) {
    if (is_inf(p) || is_inf(q)) return is_inf(p) && is_inf(q);
    Fp2 z1z1, z2z2, a, b, t, c, d;
    fp2_sqr(z1z1, p.z); fp2_sqr(z2z2, q.z);
    fp2_mul(a, p.x, z2z2); fp2_mul(b, q.x, z1z1);
    fp2_mul(t, p.y, z2z2); fp2_mul(c, t, q.z);
    fp2_mul(t, q.y, z1z1); fp2_mul(d, t, p.z);
    return fp_cmp(a.c0, b.c0) == 0 && fp_cmp(a.c1, b.c1) == 0 &&
           fp_cmp(c.c0, d.c0) == 0 && fp_cmp(c.c1, d.c1) == 0;
}

static bool g1_eq(const G1& p, const G1& q) {
    if (is_inf(p) || is_inf(q)) return is_inf(p) && is_inf(q);
    Fp z1z1, z2z2, a, b, t, c, d;
    fp_sqr(z1z1, p.z); fp_sqr(z2z2, q.z);
    fp_mul(a, p.x, z2z2); fp_mul(b, q.x, z1z1);
    fp_mul(t, p.y, z2z2); fp_mul(c, t, q.z);
    fp_mul(t, q.y, z1z1); fp_mul(d, t, p.z);
    return fp_cmp(a, b) == 0 && fp_cmp(c, d) == 0;
}

// fast subgroup checks (same method as golden/curve.py)
static bool g1_in_subgroup(const G1& p) {
    if (is_inf(p)) return true;
    G1 xp, xxp;
    g1_mul_u64(xp, p, ABS_X);
    g1_mul_u64(xxp, xp, ABS_X);
    G1 phi = p;
    Fp beta; memcpy(beta.l, BETA_MONT, sizeof beta.l);
    fp_mul(phi.x, beta, p.x);
    fp_neg(phi.y, phi.y);  // -phi(P)
    return g1_eq(xxp, phi);
}

static bool g2_in_subgroup(const G2& p) {
    if (is_inf(p)) return true;
    G2 xq, psi;
    g2_mul_u64(xq, p, ABS_X);
    // psi(Q) == -[|x|]Q
    Fp2 ny; fp2_neg(ny, xq.y);
    xq.y = ny;
    g2_psi(psi, p);
    return g2_eq(psi, xq);
}

// ---------------------------------------------------------------------------
// codec
// ---------------------------------------------------------------------------

static bool fp_is_largest(const Fp& canon) {
    // canon non-Montgomery; compare 2*canon > p  <=>  canon > (p-1)/2
    Fp dbl;
    u128 carry = 0;
    for (int i = 0; i < 6; i++) {
        u128 s = ((u128)canon.l[i] << 1) | carry;
        dbl.l[i] = (uint64_t)s;
        carry = s >> 64;
    }
    Fp p; memcpy(p.l, FP_P, sizeof p.l);
    return carry || fp_cmp(dbl, p) > 0;
}

extern "C" {

// in: n*48 bytes; out_xy: n*96 bytes (x||y big-endian canonical);
// status: 0 ok, 1 infinity, 2 bad flags, 3 out of range, 4 not on curve,
// 5 not in subgroup.  Returns number of accepted points.
int bls_g1_decompress_batch(const uint8_t* in, size_t n, uint8_t* out_xy,
                            uint8_t* status) {
    int ok = 0;
    for (size_t i = 0; i < n; i++) {
        const uint8_t* src = in + 48 * i;
        uint8_t* dst = out_xy + 96 * i;
        memset(dst, 0, 96);
        int c_flag = (src[0] >> 7) & 1, b_flag = (src[0] >> 6) & 1,
            a_flag = (src[0] >> 5) & 1;
        if (!c_flag) { status[i] = 2; continue; }
        uint8_t body[48]; memcpy(body, src, 48); body[0] &= 0x1F;
        Fp x;
        bool in_range = fp_from_be(x, body);
        if (b_flag) {
            if (a_flag || !fp_is_zero(x)) { status[i] = 2; continue; }
            status[i] = 1; ok++; continue;
        }
        if (!in_range) { status[i] = 3; continue; }
        Fp xm; fp_to_mont(xm, x);
        Fp y2, t, b; fp_sqr(t, xm); fp_mul(y2, t, xm);
        memcpy(b.l, B_G1_MONT, sizeof b.l);
        fp_add(y2, y2, b);
        Fp ym;
        if (!fp_sqrt(ym, y2)) { status[i] = 4; continue; }
        Fp ycan; fp_from_mont(ycan, ym);
        if (fp_is_largest(ycan) != (bool)a_flag) { fp_neg(ym, ym); fp_from_mont(ycan, ym); }
        G1 pt; pt.x = xm; pt.y = ym;
        memcpy(pt.z.l, FP_ONE_MONT, sizeof pt.z.l);
        if (!g1_in_subgroup(pt)) { status[i] = 5; continue; }
        fp_to_be(dst, x);
        fp_to_be(dst + 48, ycan);
        status[i] = 0; ok++;
    }
    return ok;
}

// in: n*96; out_xy: n*192 (x0||x1||y0||y1 big-endian canonical)
int bls_g2_decompress_batch(const uint8_t* in, size_t n, uint8_t* out_xy,
                            uint8_t* status) {
    int ok = 0;
    for (size_t i = 0; i < n; i++) {
        const uint8_t* src = in + 96 * i;
        uint8_t* dst = out_xy + 192 * i;
        memset(dst, 0, 192);
        int c_flag = (src[0] >> 7) & 1, b_flag = (src[0] >> 6) & 1,
            a_flag = (src[0] >> 5) & 1;
        if (!c_flag) { status[i] = 2; continue; }
        uint8_t body[48]; memcpy(body, src, 48); body[0] &= 0x1F;
        Fp x1, x0;
        bool r1 = fp_from_be(x1, body);
        bool r0 = fp_from_be(x0, src + 48);
        if (b_flag) {
            if (a_flag || !fp_is_zero(x1) || !fp_is_zero(x0)) { status[i] = 2; continue; }
            status[i] = 1; ok++; continue;
        }
        if (!r0 || !r1) { status[i] = 3; continue; }
        Fp2 xm; fp_to_mont(xm.c0, x0); fp_to_mont(xm.c1, x1);
        Fp2 y2, t, b;
        fp2_sqr(t, xm); fp2_mul(y2, t, xm);
        memcpy(b.c0.l, B_G2_C0_MONT, sizeof b.c0.l);
        memcpy(b.c1.l, B_G2_C1_MONT, sizeof b.c1.l);
        fp2_add(y2, y2, b);
        Fp2 ym;
        if (!fp2_sqrt(ym, y2)) { status[i] = 4; continue; }
        Fp y0c, y1c; fp_from_mont(y0c, ym.c0); fp_from_mont(y1c, ym.c1);
        bool largest = fp_is_zero(ym.c1) ? fp_is_largest(y0c) : fp_is_largest(y1c);
        if (largest != (bool)a_flag) {
            fp2_neg(ym, ym); fp_from_mont(y0c, ym.c0); fp_from_mont(y1c, ym.c1);
        }
        G2 pt; pt.x = xm; pt.y = ym;
        memcpy(pt.z.c0.l, FP_ONE_MONT, sizeof pt.z.c0.l);
        memset(pt.z.c1.l, 0, sizeof pt.z.c1.l);
        if (!g2_in_subgroup(pt)) { status[i] = 5; continue; }
        fp_to_be(dst, x0); fp_to_be(dst + 48, x1);
        fp_to_be(dst + 96, y0c); fp_to_be(dst + 144, y1c);
        status[i] = 0; ok++;
    }
    return ok;
}

// in_xy: n*96 canonical big-endian x||y; inf: n flags; out: n*48
void bls_g1_compress_batch(const uint8_t* in_xy, const uint8_t* inf, size_t n,
                           uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        uint8_t* dst = out + 48 * i;
        if (inf[i]) { memset(dst, 0, 48); dst[0] = 0xC0; continue; }
        Fp x, y;
        fp_from_be(x, in_xy + 96 * i);
        fp_from_be(y, in_xy + 96 * i + 48);
        fp_to_be(dst, x);
        dst[0] |= 0x80 | (fp_is_largest(y) ? 0x20 : 0);
    }
}

void bls_g2_compress_batch(const uint8_t* in_xy, const uint8_t* inf, size_t n,
                           uint8_t* out) {
    for (size_t i = 0; i < n; i++) {
        uint8_t* dst = out + 96 * i;
        if (inf[i]) { memset(dst, 0, 96); dst[0] = 0xC0; continue; }
        Fp x0, x1, y0, y1;
        fp_from_be(x0, in_xy + 192 * i);
        fp_from_be(x1, in_xy + 192 * i + 48);
        fp_from_be(y0, in_xy + 192 * i + 96);
        fp_from_be(y1, in_xy + 192 * i + 144);
        fp_to_be(dst, x1);
        fp_to_be(dst + 48, x0);
        bool largest = fp_is_zero(y1) ? fp_is_largest(y0) : fp_is_largest(y1);
        dst[0] |= 0x80 | (largest ? 0x20 : 0);
    }
}

}  // extern "C"

// Device layer of the port's one-thread pairing and point kernels
// (pairing_kernels.cu's add_step, curve.cuh): Fp and Fp2 arithmetic and
// the CLN Miller addition step, for one batch element per thread,
// over field.cuh's 32-bit words; and the packed operands' loads and stores
// and the parameter-bank structs that every unit shares.
//
// Each function is the counterpart of a JAX kernel body in
// bls_verify_gadget_tpu/ops/pallas/kernels.py (named beside it) and returns
// canonical values (< p).  The arithmetic is exact, so the formulas must be
// the JAX bodies' own only where a different formula gives a different
// value: a Miller line is fixed only up to an Fp2 factor.
//
// mont_mul takes operands below 2p: the only unreduced values here are the
// Karatsuba sums of two canonical values (fp_lazy_add), which stay below 2p.
//
// Code size: the products are __noinline__ (fp_mul, the Fp2 product and
// square, the Miller step).  Inlined, the step's 41 Montgomery products
// would take nvcc minutes and overflow the instruction cache.  Additions
// and subtractions (two 12-word carry chains each) are inlined.  The
// __noinline__ functions are static: nvcc emits a host definition of each,
// and two units that include this header are linked into one library.
#pragma once

#include "field.cuh"

namespace bls {

constexpr int kFpWords = 12;
using FpModulus = Modulus<kFpWords>;

struct Fp {
  uint32_t w[kFpWords];
};
struct Fp2 {
  Fp c0, c1;
};
struct G2Proj {  // homogeneous projective point on the twist
  Fp2 X, Y, Z;
};
struct Line {  // sparse line value c0 + c1 v + c4 v w
  Fp2 c0, c1, c4;
};

// The runs of a host-constant exponent or scalar after its top bit, by
// value in the parameter bank: segment s squares (doubles) len[s] times,
// then multiplies (adds) the base iff mul[s].
constexpr int kMaxSegments = 64;  // runs of a 64-bit exponent
struct Segments {
  int count;
  int len[kMaxSegments];
  int mul[kMaxSegments];
};

constexpr int kMaxDigits = 192;  // 4-bit digits of a 768-bit exponent

// The MSB-first 4-bit digits of a positive host-constant exponent, by
// value in the parameter bank; d[0] (the top digit) is not zero.
struct PowDigits {
  int count;
  unsigned char d[kMaxDigits];
};

// Host side: an Fp from 12 host words (a Montgomery constant).
inline Fp make_fp(const uint32_t* w) {
  Fp r;
  for (int j = 0; j < kFpWords; ++j) r.w[j] = w[j];
  return r;
}

// ------------------------------------------------- packed (c, n, 24) operands
// Coordinate j of batch element i is the 24-limb row at ((j * n) + i) * 24.

constexpr int kLimbs = 2 * kFpWords;

__device__ __forceinline__ Fp load_fp(const int32_t* buf, int j, long long n,
                                      long long i) {
  Fp r;
  load_words<kFpWords>(buf + ((long long)j * n + i) * kLimbs, r.w);
  return r;
}

__device__ __forceinline__ Fp2 load_fp2(const int32_t* buf, int j,
                                        long long n, long long i) {
  return {load_fp(buf, j, n, i), load_fp(buf, j + 1, n, i)};
}

__device__ __forceinline__ void store_fp(int32_t* buf, int j, long long n,
                                         long long i, const Fp& a) {
  store_words<kFpWords>(buf + ((long long)j * n + i) * kLimbs, a.w);
}

__device__ __forceinline__ void store_fp2(int32_t* buf, int j, long long n,
                                          long long i, const Fp2& a) {
  store_fp(buf, j, n, i, a.c0);
  store_fp(buf, j + 1, n, i, a.c1);
}

// ---------------------------------------------------------------- Fp

__device__ __forceinline__ Fp fp_zero() {
  Fp r;
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) r.w[j] = 0;
  return r;
}

__device__ __forceinline__ Fp fp_add(const Fp& a, const Fp& b,
                                     const FpModulus& M) {
  Fp r;
  mod_add<kFpWords>(a.w, b.w, r.w, M);
  return r;
}

__device__ __forceinline__ Fp fp_sub(const Fp& a, const Fp& b,
                                     const FpModulus& M) {
  Fp r;
  mod_sub<kFpWords>(a.w, b.w, r.w, M);
  return r;
}

// a + b unreduced (< 2p): a mont_mul operand only.
__device__ __forceinline__ Fp fp_lazy_add(const Fp& a, const Fp& b) {
  Fp r;
  add_words<kFpWords>(a.w, b.w, r.w);
  return r;
}

static __device__ __noinline__ Fp fp_mul(const Fp& a, const Fp& b,
                                  const FpModulus& M) {
  Fp r;
  mont_mul<kFpWords>(a.w, b.w, r.w, M);
  return r;
}

// ---------------------------------------------------------------- Fp2
// _F2Rows (kernels.py:350): Fp2 = Fp[u]/(u^2 + 1).

__device__ __forceinline__ Fp2 f2_add(const Fp2& a, const Fp2& b,
                                      const FpModulus& M) {
  return {fp_add(a.c0, b.c0, M), fp_add(a.c1, b.c1, M)};
}

__device__ __forceinline__ Fp2 f2_sub(const Fp2& a, const Fp2& b,
                                      const FpModulus& M) {
  return {fp_sub(a.c0, b.c0, M), fp_sub(a.c1, b.c1, M)};
}

__device__ __forceinline__ Fp2 f2_neg(const Fp2& a, const FpModulus& M) {
  const Fp z = fp_zero();
  return {fp_sub(z, a.c0, M), fp_sub(z, a.c1, M)};
}

// Karatsuba with 3 Montgomery products (_fp2_mul_rows; the fp2_mul kernel).
static __device__ __noinline__ Fp2 f2_mul(const Fp2& a, const Fp2& b,
                                   const FpModulus& M) {
  const Fp v0 = fp_mul(a.c0, b.c0, M);
  const Fp v1 = fp_mul(a.c1, b.c1, M);
  const Fp v2 = fp_mul(fp_lazy_add(a.c0, a.c1), fp_lazy_add(b.c0, b.c1), M);
  return {fp_sub(v0, v1, M), fp_sub(fp_sub(v2, v0, M), v1, M)};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u with 2 Montgomery products (_F2Rows.sqr).
static __device__ __noinline__ Fp2 f2_sqr(const Fp2& a, const FpModulus& M) {
  const Fp re = fp_mul(fp_lazy_add(a.c0, a.c1), fp_sub(a.c0, a.c1, M), M);
  const Fp m = fp_mul(a.c0, a.c1, M);
  return {re, fp_add(m, m, M)};
}

// * an Fp scalar (_F2Rows.muls)
__device__ __forceinline__ Fp2 f2_muls(const Fp2& a, const Fp& s,
                                       const FpModulus& M) {
  return {fp_mul(a.c0, s, M), fp_mul(a.c1, s, M)};
}

// ---------------------------------------------------------------- Miller
// The CLN addition step in homogeneous projective coordinates on the
// M-twist (kernels.py:620-685); the doubling step runs on group.cuh
// (group_rounds.py dbl_step_program).

// Mixed addition step with affine Q = (xq, yq): T <- T + Q, returns the
// line (theta xq - lambda yq, -theta xp, lambda yp) (_miller_add_rows).
static __device__ __noinline__ Line miller_add_step(G2Proj& T, const Fp2& xq,
                                             const Fp2& yq, const Fp& xp,
                                             const Fp& yp,
                                             const FpModulus& M) {
  const Fp2 th = f2_sub(T.Y, f2_mul(yq, T.Z, M), M);
  const Fp2 lm = f2_sub(T.X, f2_mul(xq, T.Z, M), M);
  const Fp2 cc = f2_sqr(th, M);
  const Fp2 dd = f2_sqr(lm, M);
  const Fp2 e = f2_mul(lm, dd, M);
  const Fp2 f = f2_mul(T.Z, cc, M);
  const Fp2 g = f2_mul(T.X, dd, M);
  const Fp2 h = f2_sub(f2_add(e, f, M), f2_add(g, g, M), M);
  const Fp2 x3 = f2_mul(lm, h, M);
  const Fp2 z3 = f2_mul(T.Z, e, M);
  const Fp2 y3 = f2_sub(f2_mul(th, f2_sub(g, h, M), M), f2_mul(e, T.Y, M), M);
  const Line l = {f2_sub(f2_mul(th, xq, M), f2_mul(lm, yq, M), M),
                  f2_muls(f2_neg(th, M), xp, M), f2_muls(lm, yp, M)};
  T = {x3, y3, z3};
  return l;
}

}  // namespace bls

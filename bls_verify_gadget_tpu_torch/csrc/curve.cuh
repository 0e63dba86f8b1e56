// Device point layer of the port's one-thread point kernels
// (point_kernels.cu): Jacobian doubling and complete addition for G1
// (coordinates in Fp) and G2 (Fp2) as one template over the coordinate
// field, for one batch element per thread over tower.cuh.  The
// constant-scalar ladders and sswu_map2 run on group.cuh, from the same
// doubling and addition traced in group_rounds.py; pow_win runs on
// lanes.cuh.
//
// Each function is the counterpart of a JAX kernel body in
// bls_verify_gadget_tpu/ops/pallas/kernels.py (named beside it).  Values
// are canonical (< p) and the arithmetic is exact, so any formula for the
// same field value gives the same limbs; what must follow the JAX bodies is
// the choice of Jacobian representative: the doubling and addition
// formulas, and the order in which the complete addition resolves its
// exceptional cases.  Where the JAX bodies compute a value and then discard
// it with a cmov on a condition that is the same for every thread (a
// ladder's set bit, a window's digit), or only rarely true for one thread
// (the doubling case of an addition), these bodies branch instead and
// compute only the value they keep.
//
// tower.cuh's G2Proj is homogeneous projective (the Miller loop's); the
// ladders here use Jacobian points, Jac<F>.
#pragma once

#include "tower.cuh"

namespace bls {

// ------------------------------------------------ coordinate-field helpers

__device__ __forceinline__ bool fp_is_zero(const Fp& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) acc |= a.w[j];
  return acc == 0;
}

__device__ __forceinline__ bool f2_is_zero(const Fp2& a) {
  return fp_is_zero(a.c0) && fp_is_zero(a.c1);
}

// The same names over Fp and Fp2, for the templates below.  A square in Fp
// is a Montgomery product of a with itself, as the plain versions compute it.
__device__ __forceinline__ Fp c_add(const Fp& a, const Fp& b, const FpModulus& M) { return fp_add(a, b, M); }
__device__ __forceinline__ Fp2 c_add(const Fp2& a, const Fp2& b, const FpModulus& M) { return f2_add(a, b, M); }
__device__ __forceinline__ Fp c_sub(const Fp& a, const Fp& b, const FpModulus& M) { return fp_sub(a, b, M); }
__device__ __forceinline__ Fp2 c_sub(const Fp2& a, const Fp2& b, const FpModulus& M) { return f2_sub(a, b, M); }
__device__ __forceinline__ Fp c_mul(const Fp& a, const Fp& b, const FpModulus& M) { return fp_mul(a, b, M); }
__device__ __forceinline__ Fp2 c_mul(const Fp2& a, const Fp2& b, const FpModulus& M) { return f2_mul(a, b, M); }
__device__ __forceinline__ Fp c_sqr(const Fp& a, const FpModulus& M) { return fp_mul(a, a, M); }
__device__ __forceinline__ Fp2 c_sqr(const Fp2& a, const FpModulus& M) { return f2_sqr(a, M); }
__device__ __forceinline__ bool c_is_zero(const Fp& a) { return fp_is_zero(a); }
__device__ __forceinline__ bool c_is_zero(const Fp2& a) { return f2_is_zero(a); }
// the field's one from the Montgomery one of Fp
__device__ __forceinline__ void c_set_one(Fp& r, const Fp& one) { r = one; }
__device__ __forceinline__ void c_set_one(Fp2& r, const Fp& one) { r = {one, fp_zero()}; }

// Packed coordinates: an Fp is one row, an Fp2 two.
__device__ __forceinline__ void load_c(Fp& r, const int32_t* buf, int j, long long n, long long i) { r = load_fp(buf, j, n, i); }
__device__ __forceinline__ void load_c(Fp2& r, const int32_t* buf, int j, long long n, long long i) { r = load_fp2(buf, j, n, i); }
__device__ __forceinline__ void store_c(int32_t* buf, int j, long long n, long long i, const Fp& a) { store_fp(buf, j, n, i, a); }
__device__ __forceinline__ void store_c(int32_t* buf, int j, long long n, long long i, const Fp2& a) { store_fp2(buf, j, n, i, a); }

// ------------------------------------------------------------ Jacobian points

template <class F>
struct Jac {  // (X, Y, Z), Z == 0 at infinity
  F X, Y, Z;
};

template <class F>
constexpr int kCoords = sizeof(F) / sizeof(Fp);  // rows per coordinate

template <class F>
__device__ __forceinline__ Jac<F> load_jac(const int32_t* buf, int j,
                                           long long n, long long i) {
  constexpr int c = kCoords<F>;
  Jac<F> p;
  load_c(p.X, buf, j, n, i);
  load_c(p.Y, buf, j + c, n, i);
  load_c(p.Z, buf, j + 2 * c, n, i);
  return p;
}

template <class F>
__device__ __forceinline__ void store_jac(int32_t* buf, int j, long long n,
                                          long long i, const Jac<F>& p) {
  constexpr int c = kCoords<F>;
  store_c(buf, j, n, i, p.X);
  store_c(buf, j + c, n, i, p.Y);
  store_c(buf, j + 2 * c, n, i, p.Z);
}

// Complete doubling for a = 0 curves (_pt_dbl_body, kernels.py:703):
// 3 products and 5 squares (Fp: 8 Montgomery products; Fp2: 17).  Infinity
// stays infinity, since Z3 = 2 Y Z.
template <class F>
__device__ __noinline__ Jac<F> pt_dbl(const Jac<F>& p, const FpModulus& M) {
  const F a = c_sqr(p.X, M);
  const F b = c_sqr(p.Y, M);
  const F c = c_sqr(p.Z, M);
  const F d = c_sqr(b, M);
  F s = c_sub(c_sub(c_sqr(c_add(p.X, b, M), M), a, M), d, M);
  s = c_add(s, s, M);
  const F m = c_add(c_add(a, a, M), a, M);
  const F x3 = c_sub(c_sqr(m, M), c_add(s, s, M), M);
  F d8 = c_add(d, d, M);
  d8 = c_add(d8, d8, M);
  d8 = c_add(d8, d8, M);
  const F y3 = c_sub(c_mul(m, c_sub(s, x3, M), M), d8, M);
  const F z3 = c_sub(c_sub(c_sqr(c_add(p.Y, p.Z, M), M), b, M), c, M);
  return {x3, y3, z3};
}

// Complete addition (_pt_add_body, kernels.py:724): the generic sum with 12
// products and 4 squares (Fp: 16 Montgomery products; Fp2: 44), then its
// exceptional cases in the JAX body's order -- P == Q doubles, P == -Q
// gives the infinity (one, one, 0), P at infinity gives Q, Q at infinity
// gives P.  That order fixes the Jacobian representative.  The doubling is
// computed only where its case is taken and neither point is at infinity
// (where it is, a later case overrides it).
template <class F>
__device__ __noinline__ Jac<F> pt_add(const Jac<F>& p, const Jac<F>& q,
                                      const Fp& one, const FpModulus& M) {
  const F z1z1 = c_sqr(p.Z, M);
  const F z2z2 = c_sqr(q.Z, M);
  const F u1 = c_mul(p.X, z2z2, M);
  const F u2 = c_mul(q.X, z1z1, M);
  const F s1 = c_mul(c_mul(p.Y, z2z2, M), q.Z, M);
  const F s2 = c_mul(c_mul(q.Y, z1z1, M), p.Z, M);
  const F h = c_sub(u2, u1, M);
  const F r = c_sub(s2, s1, M);
  const F hh = c_sqr(h, M);
  const F hhh = c_mul(h, hh, M);
  const F v = c_mul(u1, hh, M);
  const F x3 = c_sub(c_sub(c_sqr(r, M), hhh, M), c_add(v, v, M), M);
  const F y3 =
      c_sub(c_mul(r, c_sub(v, x3, M), M), c_mul(s1, hhh, M), M);
  const F z3 = c_mul(c_mul(p.Z, q.Z, M), h, M);
  Jac<F> res = {x3, y3, z3};
  const bool h0 = c_is_zero(h), r0 = c_is_zero(r);
  const bool p_inf = c_is_zero(p.Z), q_inf = c_is_zero(q.Z);
  if (p_inf) return q;
  if (q_inf) return p;
  if (h0 && r0) return pt_dbl(p, M);
  if (h0) {
    c_set_one(res.X, one);
    c_set_one(res.Y, one);
    res.Z = F{};
  }
  return res;
}

}  // namespace bls

// Device point layer of the port's one-thread point kernel
// (point_kernels.cu's pt_dbl): Jacobian doubling for G1 (coordinates in
// Fp) and G2 (Fp2) as one template over the coordinate field, for one
// batch element per thread over tower.cuh.  The complete addition
// (pt_add), the ladders and sswu_map2 run on group.cuh, from the same
// doubling and addition traced in group_rounds.py; pow_win runs on
// lanes.cuh.
//
// The doubling is the counterpart of _pt_dbl_body in
// bls_verify_gadget_tpu/ops/pallas/kernels.py.  Values are canonical (< p)
// and the arithmetic is exact, so any formula for the same field value
// gives the same limbs; what must follow the JAX body is the Jacobian
// representative, the doubling formula's polynomial.
//
// tower.cuh's G2Proj is homogeneous projective (the Miller loop's); the
// doubling here uses Jacobian points, Jac<F>.
#pragma once

#include "tower.cuh"

namespace bls {

// ------------------------------------------------ coordinate-field helpers

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

}  // namespace bls

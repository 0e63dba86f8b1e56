// The port's point kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by ops/kernels.py: Jacobian doubling repeated
// `count` times, the complete Jacobian addition, and the variable-scalar
// double-and-add ladder of keygen and signing, for G1 (coordinates in Fp)
// and G2 (Fp2) as template instances over curve.cuh.
//
// Layout.  As in hash_kernels.cu: one packed operand buffer in and one
// packed output buffer out, (c, n, 24) int32 16-bit Montgomery limbs, a
// Jacobian point X, Y, Z (3 coordinates in G1, 6 in G2).  The ladder also
// reads each element's scalar as a row of kScalarLimbs raw (non-Montgomery)
// 16-bit limbs, little-endian.  The Montgomery one and the bit count ride
// by value in the parameter bank.
//
// What bounds them, and the design.  One thread runs one batch element, so
// device memory sees the operands and the results only: 96 bytes per Fp
// coordinate in or out, and 64 per scalar, against 8 / 17 Montgomery
// products per G1 / G2 doubling and 16 / 44 per addition (~600 32-bit
// multiply-adds each).  The ladder is bound by operations (6,120 / 15,555
// products per element for 255 bits); a single addition or doubling at the
// 2,048 elements of a 4096-element aggregation tree's widest level is
// bound by operations too, at 1-3 microseconds, about what a launch costs.
// The ladder's bits differ per thread, so a warp runs the addition
// whenever one of its threads has a set bit (divergence): the simple
// design accepts that; a fixed-window or warp-uniform schedule is later
// work.
#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"

namespace {

// One warp per block, as in pairing_kernels.cu.
constexpr int kThreads = 32;
constexpr int kScalarLimbs = 16;  // raw Fr scalar: 16 x 16-bit limbs

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

namespace bls_kernels {

using bls::Fp;
using bls::Fp2;
using bls::FpModulus;
using bls::Jac;

// ----------------------------------------------------------------- pt_dbl

// Replaces _ptdbl_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:771):
// `count` Jacobian doublings (curve.cuh pt_dbl, _pt_dbl_body) in one launch.
// in and out (3c, n), c = 1 (G1) or 2 (G2).  8 (G1) or 17 (G2) Montgomery
// products per doubling: ~0.29 / ~0.61 ns of operations per element against
// ~0.17 / ~0.34 ns of bytes for one doubling.
template <class F>
__global__ void __launch_bounds__(kThreads)
    pt_dbl_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  long long n, int count, FpModulus M) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Jac<F> p = bls::load_jac<F>(in, 0, n, i);
  for (int r = 0; r < count; ++r) p = bls::pt_dbl(p, M);
  bls::store_jac(out, 0, n, i, p);
}

// ----------------------------------------------------------------- pt_add

// Replaces _ptadd_kernel (kernels.py:795): the complete addition P + Q
// (curve.cuh pt_add, _pt_add_body) with the JAX body's case order: P == Q
// doubles, P == -Q gives (1, 1, 0), P at infinity gives Q, Q at infinity
// gives P.  in (6c, n) = P then Q, out (3c, n).  16 (G1) or 44 (G2)
// Montgomery products per element: ~0.57 / ~1.6 ns of operations against
// ~0.26 / ~0.52 ns of bytes.
template <class F>
__global__ void __launch_bounds__(kThreads)
    pt_add_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  long long n, FpModulus M, Fp one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<F> p = bls::load_jac<F>(in, 0, n, i);
  const Jac<F> q = bls::load_jac<F>(in, 3 * bls::kCoords<F>, n, i);
  bls::store_jac(out, 0, n, i, bls::pt_add(p, q, one, M));
}

// ------------------------------------------------------------- pt_mul_var

// Replaces _ptmulvar_kernel (kernels.py:1329): [s]P for a per-element
// scalar s, MSB first over `nbits` bits from acc = (1, 1, 0): per bit
// acc = pt_dbl(acc), then acc = pt_add(acc, P) where the bit is set.  The
// JAX body computes both and selects per lane; the values are exact, so
// branching per thread keeps the same limbs (the doubling of (1, 1, 0) is
// (1, 1, 0), and its addition to P returns P).  A thread reads bit b of
// its own scalar row directly (limb b / 16, bit b % 16); the JAX wrapper's
// pre-aligned scalar rows are a TPU row layout and do not carry over.
// in and out (3c, n), scalars (n, 16).  Montgomery products per element:
// 255 x (8 + 16) = 6,120 for G1, 255 x (17 + 44) = 15,555 for G2 where
// every bit is set; a clear bit skips its addition (~219 / ~557 ns of
// operations against ~0.2 / ~0.4 ns of bytes at 255 bits).
template <class F>
__global__ void __launch_bounds__(kThreads)
    pt_mul_var_kernel(const int32_t* __restrict__ in,
                      const int32_t* __restrict__ scalars,
                      int32_t* __restrict__ out, long long n, int nbits,
                      FpModulus M, Fp one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Jac<F> base = bls::load_jac<F>(in, 0, n, i);
  const int32_t* s = scalars + i * kScalarLimbs;
  Jac<F> acc;
  bls::c_set_one(acc.X, one);
  bls::c_set_one(acc.Y, one);
  acc.Z = F{};
  for (int b = nbits - 1; b >= 0; --b) {
    acc = bls::pt_dbl(acc, M);
    if ((__ldg(s + (b >> 4)) >> (b & 15)) & 1) {
      acc = bls::pt_add(acc, base, one, M);
    }
  }
  bls::store_jac(out, 0, n, i, acc);
}

}  // namespace bls_kernels

extern "C" {

int bls_pt_dbl(const int32_t* in, int32_t* out, long long n, int nc, int count,
               const uint32_t* p, unsigned n0, void* stream) {
  if ((nc != 1 && nc != 2) || count < 1) return (int)cudaErrorInvalidValue;
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (nc == 1) {
    bls_kernels::pt_dbl_kernel<bls::Fp>
        <<<grid_for(n), kThreads, 0, s>>>(in, out, n, count, M);
  } else {
    bls_kernels::pt_dbl_kernel<bls::Fp2>
        <<<grid_for(n), kThreads, 0, s>>>(in, out, n, count, M);
  }
  return (int)cudaGetLastError();
}

int bls_pt_add(const int32_t* in, int32_t* out, long long n, int nc,
               const uint32_t* one, const uint32_t* p, unsigned n0,
               void* stream) {
  if (nc != 1 && nc != 2) return (int)cudaErrorInvalidValue;
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const bls::Fp o = bls::make_fp(one);
  const cudaStream_t s = (cudaStream_t)stream;
  if (nc == 1) {
    bls_kernels::pt_add_kernel<bls::Fp>
        <<<grid_for(n), kThreads, 0, s>>>(in, out, n, M, o);
  } else {
    bls_kernels::pt_add_kernel<bls::Fp2>
        <<<grid_for(n), kThreads, 0, s>>>(in, out, n, M, o);
  }
  return (int)cudaGetLastError();
}

// scalars: (n, 16) int32 raw 16-bit limbs on the device
int bls_pt_mul_var(const int32_t* in, const int32_t* scalars, int32_t* out,
                   long long n, int nc, int nbits, const uint32_t* one,
                   const uint32_t* p, unsigned n0, void* stream) {
  if ((nc != 1 && nc != 2) || nbits < 1 || nbits > 16 * kScalarLimbs) {
    return (int)cudaErrorInvalidValue;
  }
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const bls::Fp o = bls::make_fp(one);
  const cudaStream_t s = (cudaStream_t)stream;
  if (nc == 1) {
    bls_kernels::pt_mul_var_kernel<bls::Fp>
        <<<grid_for(n), kThreads, 0, s>>>(in, scalars, out, n, nbits, M, o);
  } else {
    bls_kernels::pt_mul_var_kernel<bls::Fp2>
        <<<grid_for(n), kThreads, 0, s>>>(in, scalars, out, n, nbits, M, o);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// The sparse Montgomery dot product of the R1CS layer, lc_dot, for Hopper
// (sm_90a), with a plain C interface loaded through ctypes by
// ops/kernels.py.
//
//   out[b, r] = sum_t mont_mul(w[b, idx[r, t]], coeff[r, t]) mod p
//
// w (B, V, 24), coeff (R, W, 24) and out (B, R, 24) are int32 rows of
// 16-bit Montgomery limbs, canonical (< p); idx (R, W) int32 in [0, V).
// A coefficient of 0 contributes nothing, so its term is skipped: the
// padding of a row (idx 0, coeff 0) costs one 96-byte read.
//
// What it replaces.  No TPU kernel: the JAX package's LC dot products in
// jnp (bls_verify_gadget_tpu/r1cs/evaluator.py:95 _dot_rows, the scan body
// of complete_witness at :64 and witness_vm.py:120 _eval_lcs), a gather, a
// batched product and an add tree that XLA fuses.  Its three callers in the
// port: the evaluator's constraint rows (W = 8, row chunks), the LC-split
// partial sums of complete_witness (W = 8, one dependency level's rows)
// and the witness VM's LC operands (W = 1 .. 1024, one launch per operand
// of a group).
//
// What bounds it.  Per output W gathered witness rows, W coefficient rows
// and one written row, 96 bytes each, and W Montgomery products of ~600
// 32-bit integer multiply-adds: at W = 8 ~864 bytes against 4,800
// multiply-adds, so at 3.35 TB/s and ~16.7 T multiply-adds/s the products
// bound first (chip_smoke.py computes the bound of each call from its
// nonzero coefficients).
//
// The design.  kLanes(W) lanes of a warp share one output: lane l sums the
// terms t = l, l + L, ... (field.cuh mont_mul, one thread's CIOS, and
// mod_add), then the L partial sums meet by a butterfly of shuffles, each
// step a mod_add of 12 words; lane 0 stores.  L = 1 up to W = 8 (the
// evaluator's rows, where B x R outputs fill the card), rising to 32 at W
// >= 256, where a group of the witness VM has few outputs and a term chain
// of W products would run on one thread.  Rows are read with 16-byte
// loads (the wrapper checks the bases are 16-byte aligned).
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace bls_kernels {

using bls::Modulus;

constexpr int kNW = 12;       // 32-bit words of an Fp element
constexpr int kThreads = 128;  // threads per block

__device__ __forceinline__ void load_row(const int32_t* __restrict__ row,
                                         uint32_t (&w)[kNW]) {
  const int4* q = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int k = 0; k < kNW / 2; ++k) {
    const int4 v = __ldg(q + k);
    w[2 * k] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    w[2 * k + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

__device__ __forceinline__ void store_row(int32_t* __restrict__ row,
                                          const uint32_t (&w)[kNW]) {
  int4* q = reinterpret_cast<int4*>(row);
#pragma unroll
  for (int k = 0; k < kNW / 2; ++k) {
    q[k] = make_int4((int32_t)(w[2 * k] & 0xFFFFu), (int32_t)(w[2 * k] >> 16),
                     (int32_t)(w[2 * k + 1] & 0xFFFFu), (int32_t)(w[2 * k + 1] >> 16));
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads)
lc_dot_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ idx,
              const int32_t* __restrict__ coeff, int32_t* __restrict__ out,
              long long B, long long V, long long R, int W, Modulus<kNW> M) {
  const long long gid = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long o = gid / L;  // the output (b, r) of this lane's group
  const int lane = (int)(gid % L);
  const bool live = o < B * R;
  const long long b = live ? o / R : 0;
  const long long r = live ? o - b * R : 0;

  uint32_t acc[kNW];
#pragma unroll
  for (int j = 0; j < kNW; ++j) acc[j] = 0;
  if (live) {
    const int32_t* crow = coeff + r * W * 24;
    const int32_t* irow = idx + r * W;
    const int32_t* wb = w + b * V * 24;
    for (int t = lane; t < W; t += L) {
      uint32_t c[kNW];
      load_row(crow + (long long)t * 24, c);
      uint32_t any = 0;
#pragma unroll
      for (int j = 0; j < kNW; ++j) any |= c[j];
      if (any == 0) continue;
      uint32_t x[kNW], prod[kNW];
      load_row(wb + (long long)__ldg(irow + t) * 24, x);
      bls::mont_mul<kNW>(x, c, prod, M);
      bls::mod_add<kNW>(acc, prod, acc, M);
    }
  }
  // groups of L lanes never straddle a warp (L divides 32, kThreads is a
  // multiple of 32), and every lane of the warp takes part in each shuffle
#pragma unroll
  for (int step = L / 2; step > 0; step /= 2) {
    uint32_t other[kNW];
#pragma unroll
    for (int j = 0; j < kNW; ++j) other[j] = __shfl_xor_sync(0xFFFFFFFFu, acc[j], step);
    bls::mod_add<kNW>(acc, other, acc, M);
  }
  if (live && lane == 0) store_row(out + o * 24, acc);
}

// Lanes per output for a row width W (a power of two up to 32).
inline int lanes_for(int W) {
  int L = 1;
  while (L < 32 && L * 8 < W) L *= 2;
  return L;
}

template <int L>
int launch(const int32_t* w, const int32_t* idx, const int32_t* coeff, int32_t* out,
           long long B, long long V, long long R, int W, const Modulus<kNW>& M,
           cudaStream_t s) {
  const long long threads = B * R * L;
  const unsigned grid = (unsigned)((threads + kThreads - 1) / kThreads);
  lc_dot_kernel<L><<<grid, kThreads, 0, s>>>(w, idx, coeff, out, B, V, R, W, M);
  return (int)cudaGetLastError();
}

}  // namespace bls_kernels

extern "C" {

// w (B, V, 24), idx (R, W), coeff (R, W, 24), out (B, R, 24), int32, the
// rows of w, coeff and out on 16-byte boundaries; p the modulus as 12
// host words, n0 = -p^-1 mod 2^32.
int bls_lc_dot(const int32_t* w, const int32_t* idx, const int32_t* coeff, int32_t* out,
               long long B, long long V, long long R, int W, const uint32_t* p, uint32_t n0,
               void* stream) {
  using namespace bls_kernels;
  if (B < 0 || V < 1 || R < 0 || W < 1 ||
      (((uintptr_t)w | (uintptr_t)coeff | (uintptr_t)out) & 15u)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || R == 0) return 0;
  const Modulus<kNW> M = bls::make_modulus<kNW>(p, n0);
  cudaStream_t s = (cudaStream_t)stream;
  switch (lanes_for(W)) {
    case 1: return launch<1>(w, idx, coeff, out, B, V, R, W, M, s);
    case 2: return launch<2>(w, idx, coeff, out, B, V, R, W, M, s);
    case 4: return launch<4>(w, idx, coeff, out, B, V, R, W, M, s);
    case 8: return launch<8>(w, idx, coeff, out, B, V, R, W, M, s);
    case 16: return launch<16>(w, idx, coeff, out, B, V, R, W, M, s);
    default: return launch<32>(w, idx, coeff, out, B, V, R, W, M, s);
  }
}

}  // extern "C"

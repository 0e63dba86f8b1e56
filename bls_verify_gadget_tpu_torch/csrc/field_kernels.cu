// The port's field kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by ops/kernels.py.
//
// Operands are contiguous (n, 2*NW) int32 rows of 16-bit limbs; outputs are
// allocated by the torch wrapper.  Each entry point launches on the caller's
// stream and returns cudaGetLastError() (or cudaErrorInvalidValue for a
// width or alignment it does not take) so that a refused launch raises in
// Python.  Every kernel writes canonical 16-bit limbs (< 2^16,
// value < p).
//
// What bounds them.  Per element a Montgomery product moves 288 bytes (two
// 96-byte inputs, one output) and issues about 600 32-bit integer
// multiply-adds (12x12 word products for a*b and 12x12 for m*p, each a
// lo/hi pair).  At 3.35 TB/s and ~16.7 T int32 multiply-adds/s (half the
// fp32 FMA rate) the bytes bound first; add and sub are bytes-bound with no
// multiplies at all.  At the main path's sizes (4096-8192 elements) every
// bound is 0.35-1.4 us, at or below the time of one launch (chip_smoke.py
// times launch_floor_kernel, PERF.md): what a launch costs beyond that is
// its latency, not its rate.
//
// The kernels stage a block's rows: the block reads each operand as one
// contiguous span with 16-byte loads into shared memory (field.cuh
// stage_rows, rows padded against bank conflicts) and writes its results
// back the same way, kMulPerBlock, kAddPerBlock, kSubPerBlock,
// kFp2MulPerBlock and kFp2SqrPerBlock elements per block (chip_smoke.py's
// sweep, PERF.md), on a grid the entry point computes from n.
//   - add and sub, and mul in Fr, run one thread per element on their
//     staged rows (staged_binary).
//   - mul in Fp runs each element on kMulLanes = 4 lanes of a warp, its
//     product split across the lanes (lanes.cuh mont_mul_slice, the
//     product of pow_win; ~0.55 us a product against ~1.35 us for
//     field.cuh's one-thread CIOS, whose serial carry chain set the old
//     kernel's time); each lane stores its own words.
//   - fp2_mul runs each element on 4 lanes too: its three Karatsuba
//     products in lockstep (mont_mul_slices, N = 3), each row step taken
//     for all three before the next so that one product's shuffles and
//     carries hide behind the others' work; the differences on the lanes'
//     slices (sub_slice, the borrows by lookahead), and each lane stores
//     its own words: no gather.
//   - fp2_sqr runs each element on 4 lanes: its two products in lockstep
//     (mont_mul_slices, N = 2), with no sum or difference after them.
//   A tail element's lanes run a copy of a live element and store nothing:
//   every shuffle and ballot spans the whole warp.
// chip_smoke.py's throwaway sweep builds set -DBLS_MUL_PER_BLOCK=E,
// -DBLS_ADD_PER_BLOCK=E, -DBLS_SUB_PER_BLOCK=E, -DBLS_FP2_MUL_PER_BLOCK=E
// and -DBLS_FP2_SQR_PER_BLOCK=E, and -DBLS_MUL_LANES=1
// -DBLS_FP2_MUL_LANES=1 -DBLS_FP2_SQR_LANES=1: the one-thread bodies of
// mul, fp2_mul and fp2_sqr on the same staged rows, the baseline that
// splits the gain between the staged I/O and the lanes.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"
#include "lanes.cuh"

namespace {

// Elements per block of the staged kernels, and threads per Fp mul,
// fp2_mul and fp2_sqr element (the header note).
#ifndef BLS_MUL_PER_BLOCK
#define BLS_MUL_PER_BLOCK 8
#endif
#ifndef BLS_MUL_LANES
#define BLS_MUL_LANES 4
#endif
#ifndef BLS_ADD_PER_BLOCK
#define BLS_ADD_PER_BLOCK 64
#endif
#ifndef BLS_SUB_PER_BLOCK
#define BLS_SUB_PER_BLOCK 64
#endif
#ifndef BLS_FP2_MUL_PER_BLOCK
#define BLS_FP2_MUL_PER_BLOCK 8
#endif
#ifndef BLS_FP2_MUL_LANES
#define BLS_FP2_MUL_LANES 4
#endif
#ifndef BLS_FP2_SQR_PER_BLOCK
#define BLS_FP2_SQR_PER_BLOCK 8
#endif
#ifndef BLS_FP2_SQR_LANES
#define BLS_FP2_SQR_LANES 4
#endif
constexpr int kMulPerBlock = BLS_MUL_PER_BLOCK;
constexpr int kMulLanes = BLS_MUL_LANES;
constexpr int kAddPerBlock = BLS_ADD_PER_BLOCK;
constexpr int kSubPerBlock = BLS_SUB_PER_BLOCK;
constexpr int kFp2MulPerBlock = BLS_FP2_MUL_PER_BLOCK;
constexpr int kFp2MulLanes = BLS_FP2_MUL_LANES;
constexpr int kFp2SqrPerBlock = BLS_FP2_SQR_PER_BLOCK;
constexpr int kFp2SqrLanes = BLS_FP2_SQR_LANES;
static_assert(kMulLanes == 4 || kMulLanes == 1, "BLS_MUL_LANES is 4 or 1");
static_assert(kFp2MulLanes == 4 || kFp2MulLanes == 1, "BLS_FP2_MUL_LANES is 4 or 1");
static_assert(kFp2SqrLanes == 4 || kFp2SqrLanes == 1, "BLS_FP2_SQR_LANES is 4 or 1");
static_assert(kMulLanes == 1 || kMulPerBlock * kMulLanes % 32 == 0,
              "whole warps for the lanes' shuffles");
static_assert(kFp2MulLanes == 1 || kFp2MulPerBlock * kFp2MulLanes % 32 == 0,
              "whole warps for the lanes' shuffles");
static_assert(kFp2SqrLanes == 1 || kFp2SqrPerBlock * kFp2SqrLanes % 32 == 0,
              "whole warps for the lanes' shuffles");

// Threads per element of mul: lanes.cuh is Fp-only, so Fr runs on one.
template <int NW>
constexpr int kMulThreads = NW == bls::kFpWords ? kMulLanes : 1;

using bls::make_modulus;

inline unsigned grid_for(long long n, int per_block) {
  return (unsigned)((n + per_block - 1) / per_block);
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

// The kernels carry a named namespace so that a profiler trace tells
// them apart from PyTorch's own kernels.
namespace bls_kernels {

// One thread per element on staged rows: the block stages its E rows of a
// and b (two spans of E x 8 NW bytes), each thread runs op(x, y, r) on its
// element's staged words and puts r in a's row, and the block writes the
// span of out back.
template <int NW, int E, typename Op>
__device__ __forceinline__ void staged_binary(const int32_t* __restrict__ a,
                                              const int32_t* __restrict__ b,
                                              int32_t* __restrict__ out, long long n,
                                              Op op) {
  constexpr int W = bls::kStagedStride<NW>;
  __shared__ __align__(16) int32_t s[2][E * W];
  const long long first = (long long)blockIdx.x * E;
  if (first >= n) return;  // the whole block
  const int rows = (int)(n - first < E ? n - first : E);
  {
    const int32_t* src[2] = {a, b};
    int32_t* dst[2] = {s[0], s[1]};
    bls::stage_rows<NW, E, E, 2>(src, dst, first, rows);
  }
  __syncthreads();
  const int g = threadIdx.x;
  if (g < rows) {
    uint32_t x[NW], y[NW], r[NW];
    bls::load_staged<NW>(s[0] + g * W, x);
    bls::load_staged<NW>(s[1] + g * W, y);
    op(x, y, r);
    bls::store_staged<NW>(s[0] + g * W, r);
  }
  __syncthreads();
  {
    const int32_t* src[1] = {s[0]};
    int32_t* dst[1] = {out};
    bls::unstage_rows<NW, E, E, 1>(src, dst, first, rows);
  }
}

// Replaces _mul_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:227,
// merged CIOS _conv_reduce_v3 at :167): batched Montgomery a*b*R^-1 mod m
// for Fp (NW = 12) and Fr (NW = 8), for a, b < 2m or a < R and b < m (the
// raw 384-bit halves of hash_to_field by R^2 and R^3).  288 bytes and ~600
// multiply-adds per Fp element: bound by bytes (the header note), 0.70 us
// at 8192 elements.  E elements per block.  In Fp each element runs on
// kMulLanes = 4 lanes: the block stages its rows of a and b, each lane
// reads both operands whole, runs its slice of the product and stores its
// words into a's staged row, and the block writes the span of out back.
// In Fr (lanes.cuh is Fp-only), and in a -DBLS_MUL_LANES=1 sweep build,
// one thread per element runs field.cuh's mont_mul on the same staged
// rows.
template <int NW>
__global__ void __launch_bounds__(kMulPerBlock * kMulThreads<NW>)
    mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long long n, bls::Modulus<NW> M) {
  constexpr int E = kMulPerBlock;
  if constexpr (kMulThreads<NW> == 1) {
    staged_binary<NW, E>(a, b, out, n, [&](const uint32_t(&x)[NW], const uint32_t(&y)[NW],
                                           uint32_t(&r)[NW]) { bls::mont_mul<NW>(x, y, r, M); });
  } else {
    constexpr int L = kMulThreads<NW>, T = E * L, W = bls::kStagedStride<NW>;
    constexpr int S = bls::lanes::Lane<L>::S;
    __shared__ __align__(16) int32_t s[2][E * W];
    const long long first = (long long)blockIdx.x * E;
    if (first >= n) return;  // the whole block
    const int rows = (int)(n - first < E ? n - first : E);
    {
      const int32_t* src[2] = {a, b};
      int32_t* dst[2] = {s[0], s[1]};
      bls::stage_rows<NW, E, T, 2>(src, dst, first, rows);
    }
    __syncthreads();
    const int g = threadIdx.x / L;  // the block's element
    const bool live = g < rows;
    const int at = live ? g : rows - 1;  // a tail element: a copy of a live one
    uint32_t x[NW], y[NW], t[S];
    bls::load_staged<NW>(s[0] + at * W, x);
    bls::load_staged<NW>(s[1] + at * W, y);
    __syncthreads();  // every operand in registers: a's rows take the product
    const bls::lanes::Lane<L> ln = bls::lanes::make_lane<L>(M);
    bls::lanes::mont_mul_slice<L, true>(x, y, t, ln);
    if (live) {  // lane j stores words j S .. j S + S - 1
      int2* row = reinterpret_cast<int2*>(s[0] + g * W + 2 * S * ln.j);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        row[k] = make_int2((int32_t)(t[k] & 0xFFFFu), (int32_t)(t[k] >> 16));
      }
    }
    __syncthreads();
    const int32_t* src[1] = {s[0]};
    int32_t* dst[1] = {out};
    bls::unstage_rows<NW, E, T, 1>(src, dst, first, rows);
  }
}

// Replaces _add_kernel (kernels.py:234): canonical (a + b) mod m for Fp
// (NW = 12) and Fr (NW = 8).  Pure data movement plus a 2 x NW-word carry
// chain: bytes-bound, and at the main path's 4096 elements (0.35 us of
// bytes) below the time of a launch.  E elements per block, one thread
// each, on staged rows (staged_binary).
template <int NW>
__global__ void __launch_bounds__(kAddPerBlock)
    add_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long long n, bls::Modulus<NW> M) {
  staged_binary<NW, kAddPerBlock>(a, b, out, n, [&](const uint32_t(&x)[NW],
                                                    const uint32_t(&y)[NW], uint32_t(&r)[NW]) {
    bls::mod_add<NW>(x, y, r, M);
  });
}

// Replaces _sub_kernel (kernels.py:241): canonical (a - b) mod m, as add.
template <int NW>
__global__ void __launch_bounds__(kSubPerBlock)
    sub_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
               int32_t* __restrict__ out, long long n, bls::Modulus<NW> M) {
  staged_binary<NW, kSubPerBlock>(a, b, out, n, [&](const uint32_t(&x)[NW],
                                                    const uint32_t(&y)[NW], uint32_t(&r)[NW]) {
    bls::mod_sub<NW>(x, y, r, M);
  });
}

// (a - b) mod p on this lane's slices of canonical a, b, split across the
// element's lanes as lanes.cuh's products are: the borrows, then the carries
// of the correction by p, across lanes by lookahead (fp2_mul).
template <int L>
__device__ __forceinline__ void sub_slice(const uint32_t (&a)[bls::lanes::Lane<L>::S],
                                          const uint32_t (&b)[bls::lanes::Lane<L>::S],
                                          uint32_t (&r)[bls::lanes::Lane<L>::S],
                                          const bls::lanes::Lane<L>& ln) {
  constexpr int S = bls::lanes::Lane<L>::S;
  uint32_t d[S], e[S], bw = 0;
  bool zero = true;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint64_t v = (uint64_t)a[k] - b[k] - bw;
    d[k] = (uint32_t)v;
    bw = (uint32_t)(v >> 32) & 1u;
    zero = zero && d[k] == 0;
  }
  const uint32_t borrows = bls::lanes::lookahead<L>(bw != 0, zero, ln);
  bw = (borrows >> ln.j) & 1u;
  const bool under = (borrows >> L) & 1u;  // a < b: add p
  uint64_t c = 0;
  bool ones = true;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const uint64_t v = (uint64_t)d[k] - bw;
    bw = (uint32_t)(v >> 32) & 1u;
    d[k] = (uint32_t)v;
    c += (uint64_t)d[k] + ln.p[k];
    e[k] = (uint32_t)c;
    c >>= 32;
    ones = ones && e[k] == 0xFFFFFFFFu;
  }
  c = (bls::lanes::lookahead<L>(c != 0, ones, ln) >> ln.j) & 1u;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    c += e[k];
    e[k] = (uint32_t)c;
    c >>= 32;
    r[k] = bls::lanes::pick(under, e[k], d[k]);
  }
}

// Replaces _fp2mul_kernel (kernels.py:262): Karatsuba Fp2 product
// (a0 + a1 u)(b0 + b1 u), u^2 = -1, with 3 Montgomery products; the operand
// sums a0 + a1, b0 + b1 stay unreduced (< 2p), which every product takes.
// 576 bytes and ~1,800 multiply-adds per element: bound by bytes (~172 ps
// per element; the operations ~107 ps), 1.4 us at 8192 elements.  E
// elements per block on kFp2MulLanes threads each: the block stages its
// rows of a0, a1, b0, b1, each element's threads read its operands whole,
// and the block writes the spans of c0 and c1 back.
__global__ void __launch_bounds__(kFp2MulPerBlock * kFp2MulLanes)
    fp2_mul_kernel(const int32_t* __restrict__ a0,
                   const int32_t* __restrict__ a1,
                   const int32_t* __restrict__ b0,
                   const int32_t* __restrict__ b1, int32_t* __restrict__ c0,
                   int32_t* __restrict__ c1, long long n, bls::FpModulus M) {
  constexpr int NW = bls::kFpWords, W = bls::kStagedStride<NW>;
  constexpr int E = kFp2MulPerBlock, T = E * kFp2MulLanes;
  __shared__ __align__(16) int32_t s[4][E * W];
  const long long first = (long long)blockIdx.x * E;
  if (first >= n) return;  // the whole block
  const int rows = (int)(n - first < E ? n - first : E);
  {
    const int32_t* src[4] = {a0, a1, b0, b1};
    int32_t* dst[4] = {s[0], s[1], s[2], s[3]};
    bls::stage_rows<NW, E, T, 4>(src, dst, first, rows);
  }
  __syncthreads();
  const int g = threadIdx.x / kFp2MulLanes;  // the block's element
  const bool live = g < rows;
  const int at = live ? g : rows - 1;  // a tail element: a copy of a live one
  uint32_t x0[NW], x1[NW], y0[NW], y1[NW];
  bls::load_staged<NW>(s[0] + at * W, x0);
  bls::load_staged<NW>(s[1] + at * W, x1);
  bls::load_staged<NW>(s[2] + at * W, y0);
  bls::load_staged<NW>(s[3] + at * W, y1);
  __syncthreads();  // every operand in registers: the rows of s[0], s[1] take c0, c1
  if constexpr (kFp2MulLanes == 4) {
    constexpr int S = bls::lanes::Lane<4>::S;
    const bls::lanes::Lane<4> ln = bls::lanes::make_lane<4>(M);
    uint32_t u[3][NW], v[3][NW], t[3][S], r0[S];
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      u[0][k] = x0[k], u[1][k] = x1[k];
      v[0][k] = y0[k], v[1][k] = y1[k];
    }
    bls::add_words<NW>(x0, x1, u[2]);  // < 2p
    bls::add_words<NW>(y0, y1, v[2]);
    bls::lanes::mont_mul_slices<4, 3, true>(u, v, t, ln);
    sub_slice<4>(t[0], t[1], r0, ln);
    sub_slice<4>(t[2], t[0], t[2], ln);
    sub_slice<4>(t[2], t[1], t[1], ln);
    if (live) {  // lane j stores words j S .. j S + S - 1 of c0 and c1
      int2* row0 = reinterpret_cast<int2*>(s[0] + g * W + 2 * S * ln.j);
      int2* row1 = reinterpret_cast<int2*>(s[1] + g * W + 2 * S * ln.j);
#pragma unroll
      for (int k = 0; k < S; ++k) {
        row0[k] = make_int2((int32_t)(r0[k] & 0xFFFFu), (int32_t)(r0[k] >> 16));
        row1[k] = make_int2((int32_t)(t[1][k] & 0xFFFFu), (int32_t)(t[1][k] >> 16));
      }
    }
  } else {  // the one-thread body of a sweep build
    uint32_t xs[NW], ys[NW], v0[NW], v1[NW], v2[NW], r[NW];
    bls::add_words<NW>(x0, x1, xs);
    bls::add_words<NW>(y0, y1, ys);
    bls::mont_mul<NW>(x0, y0, v0, M);
    bls::mont_mul<NW>(x1, y1, v1, M);
    bls::mont_mul<NW>(xs, ys, v2, M);
    if (live) {
      bls::mod_sub<NW>(v0, v1, r, M);
      bls::store_staged<NW>(s[0] + g * W, r);
      bls::mod_sub<NW>(v2, v0, xs, M);
      bls::mod_sub<NW>(xs, v1, r, M);
      bls::store_staged<NW>(s[1] + g * W, r);
    }
  }
  __syncthreads();
  {
    const int32_t* src[2] = {s[0], s[1]};
    int32_t* dst[2] = {c0, c1};
    bls::unstage_rows<NW, E, T, 2>(src, dst, first, rows);
  }
}

// Replaces _fp2sqr_kernel (kernels.py:276): (a0 + a1 u)^2 with 2
// Montgomery products, c0 = (a0 + a1)(a0 + p - a1) and c1 = a0 (2 a1).
// Every factor lies below 2p, the lanes' domain: the sum a0 + a1 and the
// double 2 a1 below 2p, and the difference a0 + p - a1 unreduced in (0,
// 2p), so no mod_sub before the products and no mod_add after them.  Each
// product is canonical and congruent to the JAX body's (kernels.py:276-289:
// mont(s, d) with d = a0 - a1 mod p, and add(m, m) with m = mont(a0, a1)),
// so the limbs are its limbs and fp2_sqr_plain's.  384 bytes, ~1,200
// multiply-adds per element: bytes-bound (~115 ps against ~72 ps), 0.47 us
// at 4096 elements.  E elements per block on kFp2SqrLanes threads each:
// the block stages its rows of a0 and a1, each element's threads read
// both whole, and the block writes the spans of c0 and c1 back.  On 4
// lanes the two products run in lockstep (mont_mul_slices, N = 2) and each
// lane stores its own words of c0 and c1.
__global__ void __launch_bounds__(kFp2SqrPerBlock * kFp2SqrLanes)
    fp2_sqr_kernel(const int32_t* __restrict__ a0,
                   const int32_t* __restrict__ a1, int32_t* __restrict__ c0,
                   int32_t* __restrict__ c1, long long n, bls::FpModulus M) {
  constexpr int NW = bls::kFpWords, W = bls::kStagedStride<NW>;
  constexpr int E = kFp2SqrPerBlock, T = E * kFp2SqrLanes;
  __shared__ __align__(16) int32_t s[2][E * W];
  const long long first = (long long)blockIdx.x * E;
  if (first >= n) return;  // the whole block
  const int rows = (int)(n - first < E ? n - first : E);
  {
    const int32_t* src[2] = {a0, a1};
    int32_t* dst[2] = {s[0], s[1]};
    bls::stage_rows<NW, E, T, 2>(src, dst, first, rows);
  }
  __syncthreads();
  const int g = threadIdx.x / kFp2SqrLanes;  // the block's element
  const bool live = g < rows;
  const int at = live ? g : rows - 1;  // a tail element: a copy of a live one
  // u[0] = a0 + a1, v[0] = a0 + p - a1; u[1] = 2 a1, v[1] = a0
  uint32_t u[2][NW], v[2][NW];
  bls::load_staged<NW>(s[0] + at * W, v[1]);
  bls::load_staged<NW>(s[1] + at * W, u[1]);
  __syncthreads();  // every operand in registers: the rows take c0, c1
  bls::add_words<NW>(v[1], u[1], u[0]);
  bls::add_words<NW>(v[1], M.p, v[0]);
  bls::sub_words<NW>(v[0], u[1], v[0]);
  bls::add_words<NW>(u[1], u[1], u[1]);
  if constexpr (kFp2SqrLanes == 4) {
    constexpr int S = bls::lanes::Lane<4>::S;
    const bls::lanes::Lane<4> ln = bls::lanes::make_lane<4>(M);
    uint32_t t[2][S];
    bls::lanes::mont_mul_slices<4, 2, true>(u, v, t, ln);
    if (live) {  // lane j stores words j S .. j S + S - 1 of c0 and c1
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int2* row = reinterpret_cast<int2*>(s[c] + g * W + 2 * S * ln.j);
#pragma unroll
        for (int k = 0; k < S; ++k) {
          row[k] = make_int2((int32_t)(t[c][k] & 0xFFFFu), (int32_t)(t[c][k] >> 16));
        }
      }
    }
  } else {  // the one-thread body of a sweep build
    uint32_t r[NW];
    bls::mont_mul<NW>(u[0], v[0], r, M);
    if (live) bls::store_staged<NW>(s[0] + g * W, r);
    bls::mont_mul<NW>(u[1], v[1], r, M);
    if (live) bls::store_staged<NW>(s[1] + g * W, r);
  }
  __syncthreads();
  {
    const int32_t* src[2] = {s[0], s[1]};
    int32_t* dst[2] = {c0, c1};
    bls::unstage_rows<NW, E, T, 2>(src, dst, first, rows);
  }
}

// Replaces no TPU kernel: it returns at once, so chip_smoke.py's time of
// it at a field kernel's grid is the floor under every launch (PERF.md).
__global__ void launch_floor_kernel() {}

}  // namespace bls_kernels

using bls_kernels::add_kernel;
using bls_kernels::fp2_mul_kernel;
using bls_kernels::fp2_sqr_kernel;
using bls_kernels::launch_floor_kernel;
using bls_kernels::mul_kernel;
using bls_kernels::sub_kernel;

extern "C" {

// Every operand 16-byte aligned (mul, add, sub).
int bls_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n,
            int nlimb, const uint32_t* p, unsigned n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!aligned16(a) || !aligned16(b) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_for(n, kMulPerBlock);
  if (nlimb == 24) {
    mul_kernel<12><<<blocks, kMulPerBlock * kMulThreads<12>, 0, s>>>(
        a, b, out, n, make_modulus<12>(p, n0));
  } else if (nlimb == 16) {
    mul_kernel<8><<<blocks, kMulPerBlock * kMulThreads<8>, 0, s>>>(
        a, b, out, n, make_modulus<8>(p, n0));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bls_add(const int32_t* a, const int32_t* b, int32_t* out, long long n,
            int nlimb, const uint32_t* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!aligned16(a) || !aligned16(b) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_for(n, kAddPerBlock);
  if (nlimb == 24) {
    add_kernel<12><<<blocks, kAddPerBlock, 0, s>>>(a, b, out, n, make_modulus<12>(p, 0));
  } else if (nlimb == 16) {
    add_kernel<8><<<blocks, kAddPerBlock, 0, s>>>(a, b, out, n, make_modulus<8>(p, 0));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bls_sub(const int32_t* a, const int32_t* b, int32_t* out, long long n,
            int nlimb, const uint32_t* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!aligned16(a) || !aligned16(b) || !aligned16(out)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = grid_for(n, kSubPerBlock);
  if (nlimb == 24) {
    sub_kernel<12><<<blocks, kSubPerBlock, 0, s>>>(a, b, out, n, make_modulus<12>(p, 0));
  } else if (nlimb == 16) {
    sub_kernel<8><<<blocks, kSubPerBlock, 0, s>>>(a, b, out, n, make_modulus<8>(p, 0));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Every operand 16-byte aligned.
int bls_fp2_mul(const int32_t* a0, const int32_t* a1, const int32_t* b0,
                const int32_t* b1, int32_t* c0, int32_t* c1, long long n,
                const uint32_t* p, unsigned n0, void* stream) {
  if (!aligned16(a0) || !aligned16(a1) || !aligned16(b0) || !aligned16(b1) ||
      !aligned16(c0) || !aligned16(c1)) {
    return (int)cudaErrorInvalidValue;
  }
  fp2_mul_kernel<<<grid_for(n, kFp2MulPerBlock), kFp2MulPerBlock * kFp2MulLanes, 0,
                   (cudaStream_t)stream>>>(a0, a1, b0, b1, c0, c1, n, make_modulus<12>(p, n0));
  return (int)cudaGetLastError();
}

// Every operand 16-byte aligned.
int bls_fp2_sqr(const int32_t* a0, const int32_t* a1, int32_t* c0,
                int32_t* c1, long long n, const uint32_t* p, unsigned n0,
                void* stream) {
  if (!aligned16(a0) || !aligned16(a1) || !aligned16(c0) || !aligned16(c1)) {
    return (int)cudaErrorInvalidValue;
  }
  fp2_sqr_kernel<<<grid_for(n, kFp2SqrPerBlock), kFp2SqrPerBlock * kFp2SqrLanes, 0,
                   (cudaStream_t)stream>>>(a0, a1, c0, c1, n, make_modulus<12>(p, n0));
  return (int)cudaGetLastError();
}

int bls_launch_floor(unsigned blocks, int threads, void* stream) {
  launch_floor_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"

// The port's field kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by ops/kernels.py.
//
// Every kernel maps ONE thread to one field element (one Fp2 element for
// the fp2 kernels): it reads the element's int32 16-bit-limb rows, packs
// them to 32-bit words in registers, runs the word-level arithmetic of
// field.cuh and writes canonical 16-bit limbs (< 2^16, value < p) back.
// Operands are contiguous (n, 2*NW) int32 rows; outputs are allocated by
// the torch wrapper.  Each entry point launches on the caller's stream and
// returns cudaGetLastError() so that a refused launch raises in Python.
//
// What bounds them.  Per element a Montgomery product moves 288 bytes
// (two 96-byte inputs, one output) and issues about 600 32-bit integer
// multiply-adds (12x12 word products for a*b and 12x12 for m*p, each a
// lo/hi pair).  At 3.35 TB/s and ~16.7 T int32 multiply-adds/s (half the
// fp32 FMA rate) the bytes bound first, at ~86 ps per element; add and sub
// are bytes-bound with no multiplies at all.  The design answers only the
// first-order need -- one launch covers a whole stacked tower call (k x B
// elements), and each thread keeps every word in registers so nothing but
// the operands and the result touches memory.  Coalesced 16-byte loads,
// shared-memory staging and a warp-cooperative limb layout are later
// work; so is fusing tower products, which removes the launches that
// dominate the main path today.
#include <cuda_runtime.h>

#include <cstdint>

#include "field.cuh"

namespace {

constexpr int kThreads = 128;

using bls::make_modulus;

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// The kernels carry a named namespace so that a profiler trace tells
// them apart from PyTorch's own kernels.
namespace bls_kernels {

// Replaces _mul_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:227,
// merged CIOS _conv_reduce_v3 at :167): batched Montgomery a*b*R^-1 mod m
// for Fp (NW = 12) and Fr (NW = 8).  Bytes-bound (see the header note).
template <int NW>
__global__ void mul_kernel(const int32_t* __restrict__ a,
                           const int32_t* __restrict__ b,
                           int32_t* __restrict__ out, long long n,
                           bls::Modulus<NW> M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], r[NW];
  bls::load_words<NW>(a + i * 2 * NW, x);
  bls::load_words<NW>(b + i * 2 * NW, y);
  bls::mont_mul<NW>(x, y, r, M);
  bls::store_words<NW>(out + i * 2 * NW, r);
}

// Replaces _add_kernel (kernels.py:234): canonical (a + b) mod m.
// Pure data movement plus a 2 x NW-word carry chain: bytes-bound.
template <int NW>
__global__ void add_kernel(const int32_t* __restrict__ a,
                           const int32_t* __restrict__ b,
                           int32_t* __restrict__ out, long long n,
                           bls::Modulus<NW> M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], r[NW];
  bls::load_words<NW>(a + i * 2 * NW, x);
  bls::load_words<NW>(b + i * 2 * NW, y);
  bls::mod_add<NW>(x, y, r, M);
  bls::store_words<NW>(out + i * 2 * NW, r);
}

// Replaces _sub_kernel (kernels.py:241): canonical (a - b) mod m.
// Bytes-bound like add.
template <int NW>
__global__ void sub_kernel(const int32_t* __restrict__ a,
                           const int32_t* __restrict__ b,
                           int32_t* __restrict__ out, long long n,
                           bls::Modulus<NW> M) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t x[NW], y[NW], r[NW];
  bls::load_words<NW>(a + i * 2 * NW, x);
  bls::load_words<NW>(b + i * 2 * NW, y);
  bls::mod_sub<NW>(x, y, r, M);
  bls::store_words<NW>(out + i * 2 * NW, r);
}

// Replaces _fp2mul_kernel (kernels.py:262): Karatsuba Fp2 product
// (a0 + a1 u)(b0 + b1 u), u^2 = -1, with 3 Montgomery products.  The
// operand sums a0 + a1, b0 + b1 stay unreduced (< 2p); mont_mul takes
// inputs < 2p.  576 bytes and ~1,800 multiply-adds per element: bound by
// bytes (~172 ps per element), the operation bound (~107 ps) is about 60%
// of the byte bound.
__global__ void fp2_mul_kernel(const int32_t* __restrict__ a0,
                               const int32_t* __restrict__ a1,
                               const int32_t* __restrict__ b0,
                               const int32_t* __restrict__ b1,
                               int32_t* __restrict__ c0,
                               int32_t* __restrict__ c1, long long n,
                               bls::Modulus<12> M) {
  constexpr int NW = 12;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long off = i * 2 * NW;
  uint32_t x0[NW], x1[NW], y0[NW], y1[NW];
  bls::load_words<NW>(a0 + off, x0);
  bls::load_words<NW>(a1 + off, x1);
  bls::load_words<NW>(b0 + off, y0);
  bls::load_words<NW>(b1 + off, y1);
  uint32_t xs[NW], ys[NW], v0[NW], v1[NW], v2[NW], r[NW];
  bls::add_words<NW>(x0, x1, xs);
  bls::add_words<NW>(y0, y1, ys);
  bls::mont_mul<NW>(x0, y0, v0, M);
  bls::mont_mul<NW>(x1, y1, v1, M);
  bls::mont_mul<NW>(xs, ys, v2, M);
  bls::mod_sub<NW>(v0, v1, r, M);
  bls::store_words<NW>(c0 + off, r);
  bls::mod_sub<NW>(v2, v0, xs, M);
  bls::mod_sub<NW>(xs, v1, r, M);
  bls::store_words<NW>(c1 + off, r);
}

// Replaces _fp2sqr_kernel (kernels.py:276): (a0 + a1 u)^2 =
// (a0 + a1)(a0 - a1) + 2 a0 a1 u with 2 Montgomery products; the sum
// a0 + a1 stays unreduced (< 2p).  384 bytes, ~1,200 multiply-adds per
// element: bytes-bound (~115 ps vs ~72 ps).
__global__ void fp2_sqr_kernel(const int32_t* __restrict__ a0,
                               const int32_t* __restrict__ a1,
                               int32_t* __restrict__ c0,
                               int32_t* __restrict__ c1, long long n,
                               bls::Modulus<12> M) {
  constexpr int NW = 12;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long off = i * 2 * NW;
  uint32_t x0[NW], x1[NW], s[NW], d[NW], r[NW];
  bls::load_words<NW>(a0 + off, x0);
  bls::load_words<NW>(a1 + off, x1);
  bls::add_words<NW>(x0, x1, s);
  bls::mod_sub<NW>(x0, x1, d, M);
  bls::mont_mul<NW>(s, d, r, M);
  bls::store_words<NW>(c0 + off, r);
  bls::mont_mul<NW>(x0, x1, s, M);
  bls::mod_add<NW>(s, s, r, M);
  bls::store_words<NW>(c1 + off, r);
}

}  // namespace bls_kernels

using bls_kernels::add_kernel;
using bls_kernels::fp2_mul_kernel;
using bls_kernels::fp2_sqr_kernel;
using bls_kernels::mul_kernel;
using bls_kernels::sub_kernel;

extern "C" {

int bls_mul(const int32_t* a, const int32_t* b, int32_t* out, long long n,
            int nlimb, const uint32_t* p, unsigned n0, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nlimb == 24) {
    mul_kernel<12><<<grid_for(n), kThreads, 0, s>>>(a, b, out, n,
                                                    make_modulus<12>(p, n0));
  } else if (nlimb == 16) {
    mul_kernel<8><<<grid_for(n), kThreads, 0, s>>>(a, b, out, n,
                                                   make_modulus<8>(p, n0));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bls_add(const int32_t* a, const int32_t* b, int32_t* out, long long n,
            int nlimb, const uint32_t* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nlimb == 24) {
    add_kernel<12><<<grid_for(n), kThreads, 0, s>>>(a, b, out, n,
                                                    make_modulus<12>(p, 0));
  } else if (nlimb == 16) {
    add_kernel<8><<<grid_for(n), kThreads, 0, s>>>(a, b, out, n,
                                                   make_modulus<8>(p, 0));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bls_sub(const int32_t* a, const int32_t* b, int32_t* out, long long n,
            int nlimb, const uint32_t* p, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nlimb == 24) {
    sub_kernel<12><<<grid_for(n), kThreads, 0, s>>>(a, b, out, n,
                                                    make_modulus<12>(p, 0));
  } else if (nlimb == 16) {
    sub_kernel<8><<<grid_for(n), kThreads, 0, s>>>(a, b, out, n,
                                                   make_modulus<8>(p, 0));
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int bls_fp2_mul(const int32_t* a0, const int32_t* a1, const int32_t* b0,
                const int32_t* b1, int32_t* c0, int32_t* c1, long long n,
                const uint32_t* p, unsigned n0, void* stream) {
  fp2_mul_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a0, a1, b0, b1, c0, c1, n, make_modulus<12>(p, n0));
  return (int)cudaGetLastError();
}

int bls_fp2_sqr(const int32_t* a0, const int32_t* a1, int32_t* c0,
                int32_t* c1, long long n, const uint32_t* p, unsigned n0,
                void* stream) {
  fp2_sqr_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      a0, a1, c0, c1, n, make_modulus<12>(p, n0));
  return (int)cudaGetLastError();
}

}  // extern "C"

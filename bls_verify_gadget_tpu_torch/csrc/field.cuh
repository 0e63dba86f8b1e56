// Device helpers of the port's field kernels: multi-precision words,
// carry chains and the CIOS Montgomery product, templated on the word
// count (Fp: 12 x 32-bit words, R = 2^384; Fr: 8 words, R = 2^256).
//
// Storage format (shared with the torch side and the JAX package): a field
// element is a row of 2*NW int32 values, each a 16-bit limb, little-endian,
// in Montgomery form.  Inside a thread the row is packed to NW 32-bit words
// so that the arithmetic uses 32x32->64 products; R stays (2^32)^NW =
// (2^16)^(2*NW), so the Montgomery form -- and every output limb -- is the
// same integer as the 16-bit-limb reference computes.
#pragma once

#include <cstdint>

namespace bls {

// The modulus and n0 = -p^-1 mod 2^32, passed by value as a kernel
// parameter (constant bank): no device memory, no per-launch copy.
template <int NW>
struct Modulus {
  uint32_t p[NW];
  uint32_t n0;
};

// Host side: the kernel parameter from the host word array and n0.
template <int NW>
inline Modulus<NW> make_modulus(const uint32_t* p, uint32_t n0) {
  Modulus<NW> M;
  for (int j = 0; j < NW; ++j) M.p[j] = p[j];
  M.n0 = n0;
  return M;
}

template <int NW>
__device__ __forceinline__ void load_words(const int32_t* __restrict__ row,
                                           uint32_t (&w)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    w[k] = (uint32_t)row[2 * k] | ((uint32_t)row[2 * k + 1] << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_words(int32_t* __restrict__ row,
                                            const uint32_t (&w)[NW]) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    row[2 * k] = (int32_t)(w[k] & 0xFFFFu);
    row[2 * k + 1] = (int32_t)(w[k] >> 16);
  }
}

// ---------------------------------------------------------------- staged rows
// A block's rows of an operand are one contiguous span of rows x 8 NW bytes,
// 16-byte aligned (a row of 2 NW int32 limbs is NW / 2 int4; the wrappers
// check the base).  stage_rows copies it into shared memory with 16-byte
// loads, neighbouring threads on neighbouring int4, every load of a thread
// issued before its first store; a thread then reads its element's row from
// there.  unstage_rows writes result rows back the same way.
//
// In shared memory a row takes kStagedStride<NW> int32, 4 more than its
// limbs: (2 NW + 4) / 4 int4 (7 in Fp, 5 in Fr) is odd, so the 8 threads of
// a quarter-warp that read one int4 each of 8 different rows hit 8
// different groups of 4 banks, no conflict (at 2 NW the stride of 6 or 4
// int4 would hit 4 or 2 groups: 2- or 4-way conflicts).
template <int NW>
constexpr int kStagedStride = 2 * NW + 4;

// Rows [first, first + rows) of each of the K operands src[k] into dst[k]
// (E rows of kStagedStride<NW> int32 each), by the block's T threads.
template <int NW, int E, int T, int K>
__device__ __forceinline__ void stage_rows(const int32_t* const (&src)[K],
                                           int32_t* const (&dst)[K],
                                           long long first, int rows) {
  constexpr int Q = NW / 2;                  // int4 per row
  constexpr int kIter = (E * Q + T - 1) / T;  // int4 per thread and operand
  const int span = rows * Q;
  int4 v[K][kIter];
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int g = threadIdx.x + it * T;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g < span) {
        v[k][it] = reinterpret_cast<const int4*>(src[k] + first * 2 * NW)[g];
      }
    }
  }
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int g = threadIdx.x + it * T;
    const int r = g / Q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g < span) {
        *reinterpret_cast<int4*>(dst[k] + r * kStagedStride<NW> + 4 * (g - r * Q)) =
            v[k][it];
      }
    }
  }
}

// The staged rows [0, rows) of each src[k] to rows [first, first + rows)
// of dst[k] in device memory.
template <int NW, int E, int T, int K>
__device__ __forceinline__ void unstage_rows(const int32_t* const (&src)[K],
                                             int32_t* const (&dst)[K],
                                             long long first, int rows) {
  constexpr int Q = NW / 2;
  constexpr int kIter = (E * Q + T - 1) / T;
  const int span = rows * Q;
#pragma unroll
  for (int it = 0; it < kIter; ++it) {
    const int g = threadIdx.x + it * T;
    const int r = g / Q;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (g < span) {
        reinterpret_cast<int4*>(dst[k] + first * 2 * NW)[g] =
            *reinterpret_cast<const int4*>(src[k] + r * kStagedStride<NW> +
                                           4 * (g - r * Q));
      }
    }
  }
}

// One staged row <-> NW words, by 16-byte shared-memory accesses.
template <int NW>
__device__ __forceinline__ void load_staged(const int32_t* row,
                                            uint32_t (&w)[NW]) {
#pragma unroll
  for (int q = 0; q < NW / 2; ++q) {
    const int4 v = reinterpret_cast<const int4*>(row)[q];
    w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
}

template <int NW>
__device__ __forceinline__ void store_staged(int32_t* row,
                                             const uint32_t (&w)[NW]) {
#pragma unroll
  for (int q = 0; q < NW / 2; ++q) {
    reinterpret_cast<int4*>(row)[q] =
        make_int4((int32_t)(w[2 * q] & 0xFFFFu), (int32_t)(w[2 * q] >> 16),
                  (int32_t)(w[2 * q + 1] & 0xFFFFu),
                  (int32_t)(w[2 * q + 1] >> 16));
  }
}

// r = a + b over NW words; returns the carry out (0/1).
template <int NW>
__device__ __forceinline__ uint32_t add_words(const uint32_t (&a)[NW],
                                              const uint32_t (&b)[NW],
                                              uint32_t (&r)[NW]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    c += (uint64_t)a[j] + b[j];
    r[j] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b over NW words; returns the borrow out (0/1).
template <int NW>
__device__ __forceinline__ uint32_t sub_words(const uint32_t (&a)[NW],
                                              const uint32_t (&b)[NW],
                                              uint32_t (&r)[NW]) {
  uint32_t borrow = 0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    uint64_t d = (uint64_t)a[j] - b[j] - borrow;
    r[j] = (uint32_t)d;
    borrow = (uint32_t)(d >> 32) & 1u;
  }
  return borrow;
}

template <int NW>
__device__ __forceinline__ void select_words(bool take_a,
                                             const uint32_t (&a)[NW],
                                             const uint32_t (&b)[NW],
                                             uint32_t (&r)[NW]) {
#pragma unroll
  for (int j = 0; j < NW; ++j) r[j] = take_a ? a[j] : b[j];
}

// (a + b) mod p for canonical a, b < p.
template <int NW>
__device__ __forceinline__ void mod_add(const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        uint32_t (&r)[NW],
                                        const Modulus<NW>& M) {
  uint32_t s[NW], d[NW];
  uint32_t carry = add_words<NW>(a, b, s);
  uint32_t borrow = sub_words<NW>(s, M.p, d);
  select_words<NW>(carry == 0 && borrow != 0, s, d, r);
}

// (a - b) mod p for canonical a, b < p.
template <int NW>
__device__ __forceinline__ void mod_sub(const uint32_t (&a)[NW],
                                        const uint32_t (&b)[NW],
                                        uint32_t (&r)[NW],
                                        const Modulus<NW>& M) {
  uint32_t d[NW], e[NW];
  uint32_t borrow = sub_words<NW>(a, b, d);
  add_words<NW>(d, M.p, e);
  select_words<NW>(borrow != 0, e, d, r);
}

// Montgomery product a*b*R^-1 mod p, canonical output, for a, b < 2p:
// CIOS with 32-bit words and 64-bit partial sums.  With 4p < R the
// accumulator ends below 2p, so one conditional subtraction suffices
// (the Karatsuba sums of the Fp2 kernels rely on this bound).
template <int NW>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[NW],
                                         const uint32_t (&b)[NW],
                                         uint32_t (&r)[NW],
                                         const Modulus<NW>& M) {
  uint32_t t[NW + 2];
#pragma unroll
  for (int j = 0; j < NW + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) {
      c += (uint64_t)a[j] * b[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW] = (uint32_t)c;
    t[NW + 1] = (uint32_t)(c >> 32);

    uint32_t m = t[0] * M.n0;
    c = ((uint64_t)m * M.p[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NW; ++j) {
      c += (uint64_t)m * M.p[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NW];
    t[NW - 1] = (uint32_t)c;
    t[NW] = t[NW + 1] + (uint32_t)(c >> 32);
  }
  uint32_t lo[NW], d[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) lo[j] = t[j];
  uint32_t borrow = sub_words<NW>(lo, M.p, d);
  select_words<NW>(borrow != 0, lo, d, r);
}

}  // namespace bls

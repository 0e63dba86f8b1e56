// A Montgomery product split across the lanes of one element: the product
// of hash_kernels.cu's pow_win, whose chain of dependent products (485 for
// the Fermat inverse e = p - 2) one product cannot hide behind another,
// and of field_kernels.cu's fp2_mul, whose three independent Karatsuba
// products run in lockstep (mont_mul_slices, N = 3) and hide each other's
// latency.
//
// What it replaces, and what bounds it.  The one-thread pow_win ran
// field.cuh's mont_mul on one thread per element: a 12-word
// CIOS whose every row is a serial carry chain of 12 multiply-adds for
// a * b[i], the quotient digit m, and 12 more for m * p, ~1.35 us per
// product, and the same time at 1 element as at 4096 (one warp per SM):
// the chain's latency, not the card's rate, sets its time.  The only lever
// is the latency of one product, so here a product runs on L lanes of a
// warp (L divides 32 and 12: 2 or 4, S = 12 / L words per lane; L = 4
// from the sweep).
//
// The design.  Every operand is whole in every lane of its element (a
// gather of 12 shuffles after each product); lane j owns the accumulator's
// words [j S, j S + S) and a carry word h above them.  Per CIOS row i every
// lane adds a[slice] b[i] and m p[slice] in one chain of S words with two
// carries; m = (t0 + a[0] b[i]) n0 comes from lane 0 by one shuffle; the
// shift by a word moves each lane's bottom word into the lane below by one
// shuffle, with the lane's carries folded into its top word.  So the
// carries between lanes are deferred: each lane keeps its carry word (at
// most 3) across the rows.  They are resolved once, at the end of the
// product: the carry word of the lane below added in, then the 0/1 carries
// that ripple across lanes by a carry-lookahead over two warp ballots
// (generate, propagate), the same for the borrows of the conditional
// subtraction of p.  In Fp that subtraction is left out inside the chain (a
// product of inputs below 2p stays below 2p, 4p < R) and made once at its
// end; the Fp2 instance keeps it, its Karatsuba sums need canonical
// inputs.  Every lane of the warp runs every shuffle: the kernel keeps a
// tail element's lanes on a copy of a live element.  A lane-dependent
// choice is a select (pick), never a branch: a branch made the lanes of a
// product diverge, several times slower.
//
// What bounds it now (PERF.md): the instructions one warp issues per row,
// so more lanes per element (fewer words each) run faster: L = 4 beats
// L = 2.  Tried on the card and slower, so not kept: lane 0's slice
// mirrored in every lane (no shuffle for m, more instructions per row);
// the accumulator as 64-bit columns with no carry chain in a row; 6 and 12
// lanes in segments of 8 and 16 (faster at 1 element, slower at 4096); a
// dedicated square (row i adding a[i] a[i] at word i and 2 a[k] above: 78
// word products instead of 144), since every lane still issues the zero
// products and the lane-dependent coefficient selects cost more than they
// save, so a square is a product here.
#pragma once

#include "tower.cuh"

namespace bls {
namespace lanes {

// This thread's place among its element's L lanes, and the lane's words of p.
// Every lane of the warp takes part in every shuffle and ballot (the
// kernel keeps a tail element's lanes on a copy of a live element), so the
// mask is the whole warp's.
template <int L>
struct Lane {
  static_assert(L >= 2 && 32 % L == 0 && kFpWords % L == 0,
                "L divides 32 and 12");
  static constexpr int S = kFpWords / L;  // words per lane
  static constexpr unsigned mask = 0xFFFFFFFFu;
  int j;          // the lane, 0 .. L - 1
  int base;       // the element's first lane in the warp
  uint32_t p[S];  // words j S .. j S + S - 1 of p
  uint32_t n0;
};

// c ? x : y as one select: a lane-dependent condition must not become a
// branch, whose lanes would diverge inside a product.
__device__ __forceinline__ uint32_t pick(bool c, uint32_t x, uint32_t y) {
  uint32_t r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %1, 0;\n\t"
      "selp.b32 %0, %2, %3, q;\n\t}"
      : "=r"(r)
      : "r"((uint32_t)c), "r"(x), "r"(y));
  return r;
}

// x's words j S .. j S + S - 1: a select per word, no runtime index into x.
template <int L>
__device__ __forceinline__ void slice_of(const uint32_t (&x)[kFpWords], int j,
                                         uint32_t (&s)[Lane<L>::S]) {
  constexpr int S = Lane<L>::S;
#pragma unroll
  for (int k = 0; k < S; ++k) {
    uint32_t v = x[k];
#pragma unroll
    for (int q = 1; q < L; ++q) v = pick(j == q, x[q * S + k], v);
    s[k] = v;
  }
}

template <int L>
__device__ __forceinline__ Lane<L> make_lane(const FpModulus& M) {
  Lane<L> ln;
  const int w = threadIdx.x & 31;
  ln.j = w % L;
  ln.base = w - ln.j;
  slice_of<L>(M.p, ln.j, ln.p);
  ln.n0 = M.n0;
  return ln;
}

// The lanes' slices s into the whole value x in every lane.
template <int L>
__device__ __forceinline__ void gather(const uint32_t (&s)[Lane<L>::S],
                                       uint32_t (&x)[kFpWords],
                                       const Lane<L>& ln) {
  constexpr int S = Lane<L>::S;
#pragma unroll
  for (int k = 0; k < kFpWords; ++k) {
    x[k] = __shfl_sync(ln.mask, s[k % S], k / S, L);
  }
}

// Carry-lookahead over the element's lanes: lane j generates a carry (g)
// or passes one on (p).  -> bit j the carry into lane j, bit L the carry
// out of the top lane.
template <int L>
__device__ __forceinline__ uint32_t lookahead(bool g, bool p,
                                              const Lane<L>& ln) {
  constexpr uint32_t all = (1u << L) - 1;
  const uint32_t G = (__ballot_sync(ln.mask, g) >> ln.base) & all;
  const uint32_t P = (__ballot_sync(ln.mask, p) >> ln.base) & all;
  const uint32_t x = G | P;
  return (x + G) ^ x ^ G;
}

// t[q] = this lane's slice of a[q] b[q] R^-1 mod p for N independent
// products, whole in every lane, in lockstep: each step is taken for every
// q before the next, so the N chains hide each other's latency (fp2_mul's
// three Karatsuba products; pow_win and mul run N = 1).  The domain: a,
// b < 2p, or a < R = 2^384 and b < p (mul's raw 384-bit halves of
// hash_to_field by R^2 and R^3).  Either way a b / R < p, so the sum ends
// below 2p (the top lane's carries are 0, one subtraction of p makes it
// canonical); a < R against b up to 2p does not hold (tests/
// test_torch_pow_lanes.py models both).
// kCanonical: below p, else below 2p (the conditional subtraction of p
// left out, for a chain's next product).
template <int L, int N, bool kCanonical>
__device__ __forceinline__ void mont_mul_slices(const uint32_t (&a)[N][kFpWords],
                                                const uint32_t (&b)[N][kFpWords],
                                                uint32_t (&t)[N][Lane<L>::S],
                                                const Lane<L>& ln) {
  constexpr int S = Lane<L>::S;
  uint32_t as[N][S], an0[N], h[N];  // a's words of this lane, a[0] n0, t's carry word
#pragma unroll
  for (int q = 0; q < N; ++q) {
    slice_of<L>(a[q], ln.j, as[q]);
    an0[q] = as[q][0] * ln.n0;  // a[0] n0 in lane 0
    h[q] = 0;
#pragma unroll
    for (int k = 0; k < S; ++k) t[q][k] = 0;
  }
#pragma unroll
  for (int i = 0; i < kFpWords; ++i) {
    // each step for every product before the next: warps issue in order,
    // so the independent instructions must stand between a shuffle and
    // its use in the source
    uint32_t m[N], w0[N], c1[N], c2[N];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      // lane 0's m = (t0 + a[0] b[i]) n0, one product after t0
      m[q] = __shfl_sync(ln.mask, t[q][0] * ln.n0 + an0[q] * b[q][i], 0, L);
    }
#pragma unroll
    for (int q = 0; q < N; ++q) {
      uint64_t x = (uint64_t)as[q][0] * b[q][i] + t[q][0];
      uint64_t y = (uint64_t)m[q] * ln.p[0] + (uint32_t)x;
      c1[q] = (uint32_t)(x >> 32), c2[q] = (uint32_t)(y >> 32);
      w0[q] = (uint32_t)y;  // 0 in lane 0
#pragma unroll
      for (int k = 1; k < S; ++k) {
        x = (uint64_t)as[q][k] * b[q][i] + t[q][k] + c1[q];
        c1[q] = (uint32_t)(x >> 32);
        y = (uint64_t)m[q] * ln.p[k] + (uint32_t)x + c2[q];
        c2[q] = (uint32_t)(y >> 32);
        t[q][k - 1] = (uint32_t)y;
      }
    }
#pragma unroll
    for (int q = 0; q < N; ++q) {
      // the shift: the bottom word of the lane above, and this lane's carries
      const uint32_t up = __shfl_down_sync(ln.mask, w0[q], 1, L);
      const uint64_t top = (uint64_t)pick(ln.j == L - 1, 0u, up) + h[q] + c1[q] + c2[q];
      t[q][S - 1] = (uint32_t)top;
      h[q] = (uint32_t)(top >> 32);
    }
  }
  // the deferred carries: the carry word of the lane below, then the 0/1
  // carries across lanes (the top lane's carries are 0: t < 2p < R)
  uint32_t below[N], cin[N];
#pragma unroll
  for (int q = 0; q < N; ++q) below[q] = __shfl_up_sync(ln.mask, h[q], 1, L);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    uint64_t c = pick(ln.j == 0, 0u, below[q]);
    bool ones = true;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      c += t[q][k];
      t[q][k] = (uint32_t)c;
      c >>= 32;
      ones = ones && t[q][k] == 0xFFFFFFFFu;
    }
    cin[q] = lookahead<L>(c != 0, ones, ln);
  }
#pragma unroll
  for (int q = 0; q < N; ++q) {
    uint64_t c = (cin[q] >> ln.j) & 1u;
#pragma unroll
    for (int k = 0; k < S; ++k) {
      c += t[q][k];
      t[q][k] = (uint32_t)c;
      c >>= 32;
    }
  }
  if constexpr (kCanonical) {
    // t - p where t >= p: the borrows across lanes by the same lookahead
    uint32_t d[N][S], borrows[N];
#pragma unroll
    for (int q = 0; q < N; ++q) {
      uint32_t bw = 0;
      bool zero = true;
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const uint64_t v = (uint64_t)t[q][k] - ln.p[k] - bw;
        d[q][k] = (uint32_t)v;
        bw = (uint32_t)(v >> 32) & 1u;
        zero = zero && d[q][k] == 0;
      }
      borrows[q] = lookahead<L>(bw != 0, zero, ln);
    }
#pragma unroll
    for (int q = 0; q < N; ++q) {
      uint32_t bw = (borrows[q] >> ln.j) & 1u;
      const bool keep = (borrows[q] >> L) & 1u;  // t < p
#pragma unroll
      for (int k = 0; k < S; ++k) {
        const uint64_t v = (uint64_t)d[q][k] - bw;
        bw = (uint32_t)(v >> 32) & 1u;
        t[q][k] = pick(keep, t[q][k], (uint32_t)v);
      }
    }
  }
}

// One product of mont_mul_slices: t = this lane's slice of a b R^-1 mod p.
template <int L, bool kCanonical>
__device__ __forceinline__ void mont_mul_slice(const uint32_t (&a)[kFpWords],
                                               const uint32_t (&b)[kFpWords],
                                               uint32_t (&t)[Lane<L>::S],
                                               const Lane<L>& ln) {
  using Row = uint32_t[1][kFpWords];
  mont_mul_slices<L, 1, kCanonical>(reinterpret_cast<const Row&>(a),
                                    reinterpret_cast<const Row&>(b),
                                    reinterpret_cast<uint32_t(&)[1][Lane<L>::S]>(t), ln);
}

// r = a b R^-1 mod p as mont_mul_slice, whole in every lane; r may alias a
// or b.
template <int L, bool kCanonical>
__device__ __forceinline__ void mont_mul(const uint32_t (&a)[kFpWords],
                                         const uint32_t (&b)[kFpWords],
                                         uint32_t (&r)[kFpWords],
                                         const Lane<L>& ln) {
  uint32_t t[Lane<L>::S];
  mont_mul_slice<L, kCanonical>(a, b, t, ln);
  gather<L>(t, r, ln);
}

// The values of the chain: C Fp coordinates (1 an Fp, 2 an Fp2), whole in
// every lane.
template <int C>
struct alignas(16) Val {
  uint32_t w[C][kFpWords];
};

// In Fp the chain's products stay below 2p, made canonical once at its end
// (canonical()).
template <int L>
__device__ __forceinline__ void val_mul(const Val<1>& a, const Val<1>& b,
                                        Val<1>& r, const Lane<L>& ln,
                                        const FpModulus&) {
  mont_mul<L, false>(a.w[0], b.w[0], r.w[0], ln);
}

template <int L>
__device__ __forceinline__ void val_sqr(const Val<1>& a, Val<1>& r,
                                        const Lane<L>& ln, const FpModulus&) {
  mont_mul<L, false>(a.w[0], a.w[0], r.w[0], ln);
}

__device__ __forceinline__ void canonical(Val<1>& a, const FpModulus& M) {
  uint32_t d[kFpWords];
  const uint32_t borrow = sub_words<kFpWords>(a.w[0], M.p, d);
  select_words<kFpWords>(borrow != 0, a.w[0], d, a.w[0]);
}

// Karatsuba with 3 products (ops/tower.py fp2_mul_plain); its sums and differences
// in every lane on the whole words (field.cuh).
template <int L>
__device__ __forceinline__ void val_mul(const Val<2>& a, const Val<2>& b,
                                        Val<2>& r, const Lane<L>& ln,
                                        const FpModulus& M) {
  uint32_t sa[kFpWords], sb[kFpWords], v0[kFpWords], v1[kFpWords];
  add_words<kFpWords>(a.w[0], a.w[1], sa);  // < 2p
  add_words<kFpWords>(b.w[0], b.w[1], sb);
  mont_mul<L, true>(a.w[0], b.w[0], v0, ln);
  mont_mul<L, true>(a.w[1], b.w[1], v1, ln);
  mont_mul<L, true>(sa, sb, sa, ln);
  mod_sub<kFpWords>(v0, v1, r.w[0], M);
  mod_sub<kFpWords>(sa, v0, sa, M);
  mod_sub<kFpWords>(sa, v1, r.w[1], M);
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u with 2 products (ops/tower.py
// fp2_sqr_plain).
template <int L>
__device__ __forceinline__ void val_sqr(const Val<2>& a, Val<2>& r,
                                        const Lane<L>& ln,
                                        const FpModulus& M) {
  uint32_t s[kFpWords], d[kFpWords], m[kFpWords];
  add_words<kFpWords>(a.w[0], a.w[1], s);  // < 2p
  mod_sub<kFpWords>(a.w[0], a.w[1], d, M);
  mont_mul<L, true>(a.w[0], a.w[1], m, ln);
  mont_mul<L, true>(s, d, r.w[0], ln);
  mod_add<kFpWords>(m, m, r.w[1], M);
}

}  // namespace lanes
}  // namespace bls

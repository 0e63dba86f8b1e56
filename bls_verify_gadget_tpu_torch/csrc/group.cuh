// The cooperative layer of the group kernels (pairing_kernels.cu's
// miller_dbl_run and exp_x): one batch element on a group of G threads
// (G a divisor of 32, so a group lies in one warp), its state in shared
// memory, its bodies run as the rounds of group_rounds.cuh.
//
// State.  The element's Fp values are numbered slots of 12 32-bit words
// (48 bytes, 16-byte aligned) in the block's dynamic shared memory; a
// program (group_rounds.cuh) names them: f, T, the G1 point, the lines, the
// sums that feed products, and one slot per product of a round.
//
// Rounds.  A body is a list of phases; a phase is a list of independent
// ops, dealt out round-robin over the group's threads (op j to thread
// j mod G), each op whole in one thread, and ends at __syncwarp over the
// group.  An op evaluates one or two linear forms of slots -- the sums,
// differences, small multiples and halvings of tower.cuh's formulas, made
// by the thread itself (eval_form) -- and stores either the form or, for a
// product, field.cuh's mont_mul of the two, inlined in registers (no call,
// no stack).  Every slot holds a canonical residue and every operation is
// exact mod p, so the limbs equal tower.cuh's whatever thread runs which
// op.
//
// The tables of ops are read through the read-only cache: the threads of a
// group read different ops, and __constant__ would serialize them.
#pragma once

#include "group_rounds.cuh"
#include "tower.cuh"

namespace bls {
namespace group {

constexpr int kSlotBytes = kFpWords * 4;

// The lanes of this thread's group in its warp.
template <int G>
__device__ __forceinline__ unsigned lane_mask() {
  static_assert(G >= 1 && G <= 32 && (32 % G) == 0, "G divides 32");
  if (G == 32) return 0xFFFFFFFFu;
  return ((1u << G) - 1) << ((threadIdx.x & 31) & ~(G - 1));
}

__device__ __forceinline__ void load_slot(const uint32_t* S, int s,
                                          uint32_t (&w)[kFpWords]) {
  const uint4* q = reinterpret_cast<const uint4*>(S + kFpWords * s);
#pragma unroll
  for (int k = 0; k < kFpWords / 4; ++k) {
    const uint4 v = q[k];
    w[4 * k] = v.x;
    w[4 * k + 1] = v.y;
    w[4 * k + 2] = v.z;
    w[4 * k + 3] = v.w;
  }
}

__device__ __forceinline__ void store_slot(uint32_t* S, int s,
                                           const uint32_t (&w)[kFpWords]) {
  uint4* q = reinterpret_cast<uint4*>(S + kFpWords * s);
#pragma unroll
  for (int k = 0; k < kFpWords / 4; ++k) {
    q[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  }
}

// a / 2 mod p (tower.cuh fp_half) on words.
__device__ __forceinline__ void half_words(uint32_t (&a)[kFpWords],
                                           const FpModulus& M) {
  uint32_t t[kFpWords];
  add_words<kFpWords>(a, M.p, t);
  select_words<kFpWords>((a[0] & 1u) != 0, t, a, t);
#pragma unroll
  for (int j = 0; j < kFpWords - 1; ++j) a[j] = (t[j] >> 1) | (t[j + 1] << 31);
  a[kFpWords - 1] = t[kFpWords - 1] >> 1;
}

// How a form is evaluated (the mode bits of kGroupForms; group_rounds.py).
enum : uint32_t { kCopy = 0, kLazy = 1, kReduced = 2, kCanonical = 3 };

// r = a - m if a >= m, else a.
__device__ __forceinline__ void cond_sub(uint32_t (&a)[kFpWords],
                                         const uint32_t (&m)[kFpWords]) {
  uint32_t d[kFpWords];
  const uint32_t borrow = sub_words<kFpWords>(a, m, d);
  select_words<kFpWords>(borrow != 0, a, d, a);
}

// The form `form` of kGroupForms, (sum_j c_j * slot_j) / 2^h, into r.  The
// terms' words add up in independent 64-bit sums (the positive terms, then
// the negative ones): V = pos - neg + W- p with W- the negative
// coefficients' total, so 0 <= V <= W p for W = sum |c_j|; one carry pass
// makes it 13 words.  Then by mode: kCopy the slot alone; kLazy V (W <= 9:
// a mont_mul operand); kReduced V - q p with q = floor(top / (p_11 + 1))
// from V's top 64 bits in double precision, at most floor(V / p) and at
// least floor(V / p) - 2, so below 3p; kCanonical that, then below p, then
// the halvings.  `inv_top` is 1 / (p_11 + 1).
__device__ __forceinline__ void eval_form(const uint32_t* S, uint32_t form,
                                          uint32_t (&r)[kFpWords],
                                          const FpModulus& M,
                                          double inv_top) {
  const uint32_t f = __ldg(&kGroupForms[form]);
  const int first = f & 0x3FFF, count = (f >> 14) & 0x3F;
  const int npos = (f >> 20) & 0x3F;
  const uint32_t mode = (f >> 26) & 3, halve = f >> 28;
  if (mode == kCopy) {
    load_slot(S, __ldg(&kGroupTerms[first]) & 0xFF, r);
    return;
  }
  uint64_t pos[kFpWords], neg[kFpWords];
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) pos[j] = neg[j] = 0;
  uint32_t wneg = 0;
  for (int t = 0; t < npos; ++t) {
    const uint32_t term = __ldg(&kGroupTerms[first + t]);
    uint32_t v[kFpWords];
    load_slot(S, term & 0xFF, v);
#pragma unroll
    for (int j = 0; j < kFpWords; ++j) pos[j] += (uint64_t)(term >> 8) * v[j];
  }
  for (int t = npos; t < count; ++t) {
    const uint32_t term = __ldg(&kGroupTerms[first + t]);
    uint32_t v[kFpWords];
    load_slot(S, term & 0xFF, v);
    wneg += term >> 8;
#pragma unroll
    for (int j = 0; j < kFpWords; ++j) neg[j] += (uint64_t)(term >> 8) * v[j];
  }
  int64_t carry = 0;
#pragma unroll
  for (int j = 0; j < kFpWords; ++j) {
    const int64_t s = (int64_t)(pos[j] + (uint64_t)wneg * M.p[j]) -
                      (int64_t)neg[j] + carry;
    r[j] = (uint32_t)s;
    carry = s >> 32;
  }
  if (mode >= kReduced) {
    const uint64_t hi = ((uint64_t)carry << 32) | r[kFpWords - 1];
    const uint32_t q = (uint32_t)((double)hi * inv_top);
    uint64_t borrow = 0;
#pragma unroll
    for (int j = 0; j < kFpWords; ++j) {
      const uint64_t t = (uint64_t)q * M.p[j] + borrow;
      const uint32_t lo = (uint32_t)t;
      borrow = (t >> 32) + (r[j] < lo ? 1u : 0u);
      r[j] -= lo;
    }
  }
  if (mode == kCanonical) {
    uint32_t twice[kFpWords];
#pragma unroll
    for (int j = 0; j < kFpWords; ++j) {
      twice[j] = (M.p[j] << 1) | (j ? M.p[j - 1] >> 31 : 0u);
    }
    cond_sub(r, twice);
    cond_sub(r, M.p);
    for (uint32_t k = 0; k < halve; ++k) half_words(r, M);
  }
}

// Run phases [p0, p1) of the tables on the element's slots S, each thread
// taking its ops one at a time (op j, j + G, ...).  A phase holds products
// only or combinations only.
template <int G>
__device__ __forceinline__ void run(int p0, int p1, uint32_t* S, int lane,
                                    unsigned mask, const FpModulus& M) {
  const double inv_top = 1.0 / ((double)M.p[kFpWords - 1] + 1.0);
  for (int ph = p0; ph < p1; ++ph) {
    const int end = __ldg(&kGroupPhases[ph + 1]);
    for (int o = __ldg(&kGroupPhases[ph]) + lane; o < end; o += G) {
      const uint2 op = __ldg(&kGroupOps[o]);
      uint32_t a[kFpWords];
      eval_form(S, op.x & 0xFFFF, a, M, inv_top);
      if (op.y != 0xFFFFFFFFu) {
        uint32_t b[kFpWords];
        eval_form(S, op.y, b, M, inv_top);
        mont_mul<kFpWords>(a, b, a, M);
      }
      store_slot(S, (op.x >> 16) & 0xFF, a);
    }
    __syncwarp(mask);
  }
}

// Packed coordinates c < ncoord of element i (24 16-bit limbs at
// ((c n) + i) 24) into slots slot_of(c), the group's threads sharing the
// words: neighbouring threads read neighbouring 8-byte limb pairs.
template <int G, typename SlotOf>
__device__ __forceinline__ void load_coords(const int32_t* __restrict__ in,
                                            long long n, long long i,
                                            int ncoord, SlotOf slot_of,
                                            uint32_t* S, int lane) {
  for (int w = lane; w < ncoord * kFpWords; w += G) {
    const int c = w / kFpWords, k = w - kFpWords * c;
    const int2 l = *reinterpret_cast<const int2*>(
        in + ((long long)c * n + i) * kLimbs + 2 * k);
    S[kFpWords * slot_of(c) + k] = (uint32_t)l.x | ((uint32_t)l.y << 16);
  }
}

template <int G, typename SlotOf>
__device__ __forceinline__ void store_coords(int32_t* __restrict__ out,
                                             long long n, long long i,
                                             int ncoord, SlotOf slot_of,
                                             const uint32_t* S, int lane) {
  for (int w = lane; w < ncoord * kFpWords; w += G) {
    const int c = w / kFpWords, k = w - kFpWords * c;
    const uint32_t x = S[kFpWords * slot_of(c) + k];
    *reinterpret_cast<int2*>(out + ((long long)c * n + i) * kLimbs + 2 * k) =
        make_int2((int32_t)(x & 0xFFFFu), (int32_t)(x >> 16));
  }
}

}  // namespace group
}  // namespace bls

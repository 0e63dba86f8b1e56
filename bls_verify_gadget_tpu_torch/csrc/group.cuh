// The cooperative layer of the group kernels (pairing_kernels.cu's
// miller_dbl_run, miller_add, exp_x, fp12_mul, fp6_mul, fp12_sqr, mul014,
// cyclo_sqr, dbl_step and add_step, hash_kernels.cu's pt_mul_const,
// g2_cofactor and sswu_map2, point_kernels.cu's pt_dbl, pt_mul_var and
// pt_add): one batch
// element on a group of G threads (G a divisor of 32, so a group lies in
// one warp), its state in shared memory, its bodies run as the rounds of
// group_rounds.cuh.
//
// State.  The element's Fp values are numbered slots of 12 32-bit words
// (48 bytes, 16-byte aligned) in the block's dynamic shared memory; a
// program (group_rounds.cuh) names them: f, T, the G1 point, the lines, the
// sums that feed products; a product's slot is reused once its value is dead
// (group_rounds.py allocates the slots by liveness).
//
// Rounds.  A body is a list of phases; a phase is a list of independent
// ops, dealt out round-robin over the group's threads (op j to thread
// j mod G), each op whole in one thread, and ends at __syncwarp over the
// group.  An op evaluates one or two linear forms of slots -- the sums,
// differences, small multiples and halvings of the plain versions'
// formulas (ops/tower.py, ops/pairing.py, ops/curve.py, ops/hash_to_g2.py),
// made by the thread itself (eval_form; eval_operands for a product's two)
// -- and stores either the form or, for a product, field.cuh's mont_mul of
// the two, inlined in registers (no call, no stack).  Every slot holds a
// canonical residue and every operation is exact mod p, so the limbs equal
// the plain versions' whatever thread runs which op.
//
// The tables of ops are read through the read-only cache: the threads of a
// group read different ops, and __constant__ would serialize them.
//
// Point programs (the ladders, g2_cofactor, sswu_map2, pt_add) run a script
// (run_script): bodies, complete additions, constant-scalar ladders,
// variable-scalar ladders, cases, table loads and exponent chains in
// lockstep, all through one run<G>, so that a kernel inlines one copy of
// the op loop.  The complete addition's exceptional cases, a variable
// ladder's bit and the other cases are branches on flags that every thread
// of the group reads from the element's slots (add_case, pick_case), so a
// group never diverges; only groups of a warp may, and only on
// data-dependent choices.  No op reads a slot by a runtime index:
// a chain's window copies its table entry into a fixed slot (pow_step).
#pragma once

#include <cuda_runtime.h>

#include "group_rounds.cuh"
#include "tower.cuh"

namespace bls {
namespace group {

constexpr int kSlotBytes = kFpWords * 4;

// Elements per block of the kernel of program Prog at G threads each:
// kThreads / G, or fewer where their slots would pass kMaxShared bytes
// (group_rounds.py elements_per_block).
template <class Prog, int G>
__host__ __device__ constexpr int elements_per_block() {
  constexpr int by_threads = kThreads / G;
  constexpr int by_shared = kMaxShared / (Prog::kSlots * kSlotBytes);
  static_assert(by_shared >= 1, "an element's slots pass kMaxShared");
  return by_threads < by_shared ? by_threads : by_shared;
}

// Launch a group kernel of program Prog at G threads per element over n
// elements, raising the kernel's dynamic shared-memory limit on every
// launch (it applies to the current device); that call's error returns as
// the launch's.
template <class Prog, int G, typename Kernel, typename... Args>
int launch(Kernel kernel, long long n, cudaStream_t s, Args... args) {
  constexpr int per = elements_per_block<Prog, G>();
  constexpr int bytes = per * Prog::kSlots * kSlotBytes;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<(unsigned)((n + per - 1) / per), per * G, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

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

// a / 2 mod p (ops/pairing.py fp_half) on words.
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

// Form sums.  A form (kGroupForms) is (sum_j c_j * slot_j) / 2^h over its
// terms (kGroupTerms), the positive ones first.  Its terms add up in
// independent 64-bit word sums x_k: a positive term c v adds c v_k, a
// negative one c ~v_k (the complement of each word: -v = sum_k ~v_k
// 2^(32 k) + 1 - 2^384).  With W- the negative coefficients' total, one
// carry pass that adds W- + W- p makes
//   V = (positive terms) - (negative terms) + W- p,
// 0 <= V <= W p for W = sum |c_j|, 13 words (the top one less W-).
struct FormSum {
  uint64_t x[kFpWords];
  uint32_t wneg;
};

// Term `term` (slot | c << 8) of a form into f; term 0 with c = 0 adds
// nothing, which lets two forms of unequal length share one loop.
__device__ __forceinline__ void form_add(const uint32_t* S, uint32_t term,
                                         bool neg, FormSum& f) {
  uint32_t v[kFpWords];
  load_slot(S, term & 0xFF, v);
  const uint32_t c = term >> 8, flip = neg ? 0xFFFFFFFFu : 0u;
  f.wneg += neg ? c : 0u;
#pragma unroll
  for (int k = 0; k < kFpWords; ++k) f.x[k] += (uint64_t)c * (v[k] ^ flip);
}

// The carry pass: V's low 12 words into r; returns its top word.
__device__ __forceinline__ uint32_t form_carry(const FormSum& f,
                                               uint32_t (&r)[kFpWords],
                                               const FpModulus& M) {
  uint64_t carry = f.wneg;
#pragma unroll
  for (int k = 0; k < kFpWords; ++k) {
    const uint64_t s = f.x[k] + (uint64_t)f.wneg * M.p[k] + carry;
    r[k] = (uint32_t)s;
    carry = s >> 32;
  }
  return (uint32_t)carry - f.wneg;
}

// V - q p with q = floor(top 64 bits of V / (p_11 + 1)) in double
// precision, at most floor(V / p) and at least floor(V / p) - 2, so below
// 3p; `on` false leaves V (q = 0).  `inv_top` is 1 / (p_11 + 1).
__device__ __forceinline__ void form_reduce(uint32_t (&r)[kFpWords],
                                            uint32_t top, bool on,
                                            const FpModulus& M,
                                            double inv_top) {
  const uint64_t hi = ((uint64_t)top << 32) | r[kFpWords - 1];
  const uint32_t q = on ? (uint32_t)((double)hi * inv_top) : 0u;
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kFpWords; ++k) {
    const uint64_t t = (uint64_t)q * M.p[k] + borrow;
    const uint32_t lo = (uint32_t)t;
    borrow = (t >> 32) + (r[k] < lo ? 1u : 0u);
    r[k] -= lo;
  }
}

// The form `form` of a combination into r, by its mode: kCopy the slot
// alone; otherwise V reduced below 3p, then below p, then the halvings
// (kCanonical, the mode of every stored form).
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
  FormSum sum = {};
  for (int t = 0; t < count; ++t) {
    form_add(S, __ldg(&kGroupTerms[first + t]), t >= npos, sum);
  }
  form_reduce(r, form_carry(sum, r, M), true, M, inv_top);
  uint32_t twice[kFpWords];
#pragma unroll
  for (int k = 0; k < kFpWords; ++k) {
    twice[k] = (M.p[k] << 1) | (k ? M.p[k - 1] >> 31 : 0u);
  }
  cond_sub(r, twice);
  cond_sub(r, M.p);
  for (uint32_t k = 0; k < halve; ++k) half_words(r, M);
}

// The operands of a product, forms fa and fb, into a and b: their terms
// accumulate side by side in one loop (the two forms' loads and carry
// chains overlap), each reduced below 3p where its mode is kReduced (kLazy
// leaves V, below R; a kCopy form is its slot).  fb == fa, a square, is
// evaluated once.
__device__ __forceinline__ void eval_operands(const uint32_t* S, uint32_t fa,
                                              uint32_t fb,
                                              uint32_t (&a)[kFpWords],
                                              uint32_t (&b)[kFpWords],
                                              const FpModulus& M,
                                              double inv_top) {
  const bool square = fb == fa;
  const uint32_t ea = __ldg(&kGroupForms[fa]);
  const uint32_t eb = square ? 0u : __ldg(&kGroupForms[fb]);  // no terms
  const int a0 = ea & 0x3FFF, na = (ea >> 14) & 0x3F, pa = (ea >> 20) & 0x3F;
  const int b0 = eb & 0x3FFF, nb = (eb >> 14) & 0x3F, pb = (eb >> 20) & 0x3F;
  FormSum sa = {}, sb = {};
  const int n = na > nb ? na : nb;
  for (int t = 0; t < n; ++t) {
    const uint32_t ta = __ldg(&kGroupTerms[a0 + (t < na ? t : 0)]);
    const uint32_t tb = __ldg(&kGroupTerms[b0 + (t < nb ? t : 0)]);
    form_add(S, t < na ? ta : 0u, t >= pa, sa);
    form_add(S, t < nb ? tb : 0u, t >= pb, sb);
  }
  const uint32_t topa = form_carry(sa, a, M), topb = form_carry(sb, b, M);
  form_reduce(a, topa, ((ea >> 26) & 3) == kReduced, M, inv_top);
  form_reduce(b, topb, ((eb >> 26) & 3) == kReduced, M, inv_top);
  if (square) {
#pragma unroll
    for (int k = 0; k < kFpWords; ++k) b[k] = a[k];
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
      if (op.y != 0xFFFFFFFFu) {
        uint32_t b[kFpWords];
        eval_operands(S, op.x & 0xFFFF, op.y, a, b, M, inv_top);
        mont_mul<kFpWords>(a, b, a, M);
      } else {
        eval_form(S, op.x & 0xFFFF, a, M, inv_top);
      }
      store_slot(S, (op.x >> 16) & 0xFF, a);
    }
    __syncwarp(mask);
  }
}

// The Fp constant v into slot s (a word per lane).
template <int G>
__device__ __forceinline__ void store_const(uint32_t* S, int s, const Fp& v,
                                            int lane) {
#pragma unroll
  for (int k = 0; k < kFpWords; ++k) {
    if (k % G == lane) S[kFpWords * s + k] = v.w[k];
  }
}

// Whether the c slots from s hold zero (canonical: every word 0).
__device__ __forceinline__ bool slots_zero(const uint32_t* S, int s, int c) {
  uint32_t acc = 0;
  for (int k = 0; k < c * kFpWords; ++k) acc |= S[kFpWords * s + k];
  return acc == 0;
}

// The kinds of a script step (kGroupScript; group_rounds.py BODY, ADD,
// LADDER, POW, CASE, LOAD, VLADDER).
enum : uint32_t {
  kStepBody = 0,
  kStepAdd = 1,
  kStepLadder = 2,
  kStepPow = 3,
  kStepCase = 4,
  kStepLoad = 5,
  kStepVarLadder = 6
};

// Bit `bit` of the element's scalar (the slot scalar: 8 words, little-endian).
template <class Prog>
__device__ __forceinline__ bool scalar_bit(const uint32_t* S, int bit) {
  return (S[kFpWords * Prog::kSlot_scalar + (bit >> 5)] >> (bit & 31)) & 1u;
}

// After the body add of a point program: the phase range [p0, p1) of the
// body that the complete addition's case picks (ops/curve.py pt_add, in
// _pt_add_body's order): P (acc) at infinity -> take_base; Q (base) at
// infinity -> none, acc is P; h = r = 0 -> dbl, the doubling of acc; h = 0
// -> set_inf, (one, one, 0); else take_sum.  In a variable ladder (bit >=
// 0) a clear bit of the scalar comes first: none, acc stays.  Every lane
// reads the same flags, then waits for the others before the case body
// writes acc.
template <class Prog>
__device__ __forceinline__ void add_case(const uint32_t* S, unsigned mask,
                                         int bit, int& p0, int& p1) {
  constexpr int c = Prog::kCoord;
  bool clear = false;
  if constexpr ((Prog::kStepKinds >> kStepVarLadder) & 1) {
    clear = bit >= 0 && !scalar_bit<Prog>(S, bit);
  }
  const bool p_inf = slots_zero(S, Prog::kSlot_acc + 2 * c, c);
  const bool q_inf = slots_zero(S, Prog::kSlot_base + 2 * c, c);
  const bool h0 = slots_zero(S, Prog::kSlot_h, c);
  const bool r0 = slots_zero(S, Prog::kSlot_r, c);
  __syncwarp(mask);
  if (clear) {
    p0 = p1 = 0;
  } else if (p_inf) {
    p0 = Prog::kBody_take_base, p1 = Prog::kEnd_take_base;
  } else if (q_inf) {
    p0 = p1 = 0;
  } else if (h0 && r0) {
    p0 = Prog::kBody_dbl, p1 = Prog::kEnd_dbl;
  } else if (h0) {
    p0 = Prog::kBody_set_inf, p1 = Prog::kEnd_set_inf;
  } else {
    p0 = Prog::kBody_take_sum, p1 = Prog::kEnd_take_sum;
  }
}

// A CASE step (group_rounds.py pick_case): the phase range [p0, p1) of the
// body that case c picks.  Every lane reads the case's flags from the
// element's slots (kGroupFlags: all zero, or odd) into one word, waits for
// the others, and takes the body of the first rule (kGroupRules) whose
// masked word matches; no rule, no body.  So the whole group takes one
// branch, as in add_case.
__device__ __forceinline__ void pick_case(const uint32_t* S, uint32_t c,
                                          unsigned mask, int& p0, int& p1) {
  const uint2 e = __ldg(&kGroupCases[c]);
  uint32_t word = 0;
  for (uint32_t f = 0; f < (e.x >> 16); ++f) {
    const uint32_t fl = __ldg(&kGroupFlags[(e.x & 0xFFFF) + f]);
    const int s = fl & 0xFF, count = (fl >> 8) & 0xFF;
    const bool on = (fl >> 16) != 0 ? (S[kFpWords * s] & 1u) != 0
                                    : slots_zero(S, s, count);
    word |= (uint32_t)on << f;
  }
  __syncwarp(mask);
  p0 = p1 = 0;
  for (uint32_t r = 0; r < (e.y >> 16); ++r) {
    const uint2 rule = __ldg(&kGroupRules[(e.y & 0xFFFF) + r]);
    if ((word & (rule.x & 0xFFFF)) == (rule.x >> 16)) {
      p0 = rule.y & 0xFFFF, p1 = rule.y >> 16;
      return;
    }
  }
}

// A LOAD step: rows [row, row + count) of a device table of 24 16-bit limbs
// per row into slots [slot, slot + count), y = row | count << 8 | slot <<
// 16, the group's threads sharing the words.
template <int G>
__device__ __forceinline__ void load_rows(const int32_t* __restrict__ table,
                                          uint32_t y, uint32_t* S, int lane) {
  const int row = y & 0xFF, count = (y >> 8) & 0xFF, slot = y >> 16;
  for (int w = lane; w < count * kFpWords; w += G) {
    const int r = w / kFpWords, k = w - kFpWords * r;
    const int2 l = *reinterpret_cast<const int2*>(
        table + (long long)(row + r) * kLimbs + 2 * k);
    S[kFpWords * (slot + r) + k] = (uint32_t)l.x | ((uint32_t)l.y << 16);
  }
}

// What a script's POW and LOAD steps read besides the slots: the chains'
// exponents as 4-bit digits (a chain names e0 or e1) and the device table
// of LOAD's rows.
struct ChainInputs {
  const PowDigits& e0;
  const PowDigits& e1;
  const int32_t* table;
};

// The bit length of e (its top digit is not zero).
__device__ __forceinline__ int pow_bit_length(const PowDigits& e) {
  return 4 * (e.count - 1) + 32 - __clz((unsigned)e.d[0]);
}

// Window w, from the top, of e split into nwin windows of `bits` bits.
template <int bits>
__device__ __forceinline__ int pow_digit(const PowDigits& e, int nwin, int w) {
  const int lo = bits * (nwin - 1 - w);
  int d = 0;
#pragma unroll
  for (int j = 0; j < bits; ++j) {
    const int b = lo + j;  // bit b % 4 of the digit (b / 4) from the bottom
    if (b < 4 * e.count) d |= ((e.d[e.count - 1 - (b >> 2)] >> (b & 3)) & 1) << j;
  }
  return d;
}

// Slots [dst, dst + width) = slots [src, src + width) where `entry`, else
// the field's one (src the one's slot, then zeros); the group's threads
// share the words.
template <int G>
__device__ __forceinline__ void copy_entry(uint32_t* S, int dst, int src,
                                           bool entry, int width, int lane) {
  for (int k = lane; k < width * kFpWords; k += G) {
    S[kFpWords * dst + k] =
        entry || k < kFpWords ? S[kFpWords * src + k] : 0u;
  }
}

// One window of a POW step (group_rounds.py run_pow): Prog's chains
// (kGroupChains: a table of base^1 .. base^(2^bits - 1), the operand o,
// the accumulator f, the width, the exponent) in lockstep over the windows
// of the longer exponent.  win < 0 starts the step; -> (p0, p1) the
// window's bodies, or win < 0 again at the step's end.  Each lane copies
// its words of every chain's o: the table entry of the chain's digit, the
// one where the digit is 0 (so every window runs the same product body; no
// op reads a slot by a runtime index).  Window 0 also sets f = one and,
// after a barrier, runs win_mul alone (v = f o, the entry); a later window
// runs win_sq (v^(2^bits) into f), whose first phase touches neither o,
// the tables nor the one (group_rounds.py check_phases asserts it), so its
// barrier publishes the copy, then win_mul.
template <class Prog, int G>
__device__ __forceinline__ void pow_step(const ChainInputs& in, uint32_t* S,
                                         int lane, unsigned mask, int& win,
                                         int& nwin, int& p0, int& p1) {
  constexpr int bits = Prog::kPowBits;
  static_assert(Prog::kEnd_win_sq == Prog::kBody_win_mul,
                "win_mul follows win_sq");
  if (win < 0) {
    const int l0 = pow_bit_length(in.e0), l1 = pow_bit_length(in.e1);
    nwin = ((l0 > l1 ? l0 : l1) + bits - 1) / bits;
    win = 0;
  } else if (++win == nwin) {
    win = -1;
    return;
  }
  const int d0 = pow_digit<bits>(in.e0, nwin, win);
  const int d1 = pow_digit<bits>(in.e1, nwin, win);
  for (int c = Prog::kChains; c < Prog::kEndChains; ++c) {
    const uint32_t ch = __ldg(&kGroupChains[c]);
    const int tab = ch & 0xFF, o = (ch >> 8) & 0xFF, f = (ch >> 16) & 0xFF;
    const int width = (ch >> 24) & 0xF, d = (ch >> 28) != 0 ? d1 : d0;
    copy_entry<G>(S, o, d != 0 ? tab + (d - 1) * width : Prog::kSlot_one,
                  d != 0, width, lane);
    if (win == 0) copy_entry<G>(S, f, Prog::kSlot_one, false, width, lane);
  }
  if (win == 0) __syncwarp(mask);
  p0 = win == 0 ? Prog::kBody_win_mul : Prog::kBody_win_sq;
  p1 = Prog::kEnd_win_mul;
}

// Run point program Prog's script on the element's slots: a body step runs
// its body; an addition step the body add, then the body that add_case
// picks; a ladder step take_base (acc = base), then per segment of `env`
// (the kernel's Segments) len doublings and, where it ends on a set bit, an
// addition (the constant-scalar ladder, _ladder_rows); a variable ladder
// step set_inf (acc = (one, one, 0)), then for bit nbits - 1 .. 0 (env, the
// kernel's bit count) a doubling and an addition whose case add_case picks
// with the bit's flag first (none where the bit is clear); a case step the
// body that pick_case picks; a load step rows of env.table; a pow step its
// windows (pow_step, env's ChainInputs).  One run<G> for all of them; the
// steps that Prog's script lacks (kStepKinds) are not compiled.
template <class Prog, int G, class Env>
__device__ __forceinline__ void run_script(const Env& env, uint32_t* S,
                                           int lane, unsigned mask,
                                           const FpModulus& M) {
  constexpr unsigned kinds = Prog::kStepKinds;
  int k = Prog::kScript;
  int seg = -1, step = 0;  // in a ladder step: its segment and doublings done
  int win = -1, nwin = 0;  // in a pow step: its window and window count
  int vstep = -1;          // in a variable ladder: 2 x its bits to run, less its steps
  int bit = -1;            // in a variable ladder: the bit of the add just run
  bool pick = false;       // the body just run was add
  for (;;) {
    int p0 = 0, p1 = 0;
    if (pick) {
      pick = false;
      add_case<Prog>(S, mask, bit, p0, p1);
    } else if (k == Prog::kEndScript) {
      break;
    } else {
      const uint2 e = __ldg(&kGroupScript[k]);
      if (e.x == kStepBody || e.x == kStepAdd) {
        ++k;
        p0 = e.y & 0xFFFF, p1 = e.y >> 16;
        pick = e.x == kStepAdd;
      } else if (e.x == kStepLadder) {
        if constexpr ((kinds >> kStepLadder) & 1) {
          const Segments& segs = env;
          if (seg < 0) {
            seg = step = 0;
            p0 = Prog::kBody_take_base, p1 = Prog::kEnd_take_base;
          } else {
            bool found = false;
            while (!found && seg < segs.count) {
              if (step < segs.len[seg]) {
                ++step;
                p0 = Prog::kBody_dbl, p1 = Prog::kEnd_dbl;
                found = true;
              } else {
                found = pick = segs.mul[seg] != 0;
                p0 = Prog::kBody_add, p1 = Prog::kEnd_add;
                ++seg;
                step = 0;
              }
            }
            if (!found) {  // the ladder's end
              seg = -1;
              ++k;
              continue;
            }
          }
        }
      } else if (e.x == kStepVarLadder) {
        if constexpr ((kinds >> kStepVarLadder) & 1) {
          const int nbits = env;
          if (vstep < 0) {  // the ladder's start
            vstep = 2 * nbits;
            p0 = Prog::kBody_set_inf, p1 = Prog::kEnd_set_inf;
          } else if (vstep == 0) {  // the ladder's end
            vstep = -1;
            ++k;
            continue;
          } else if (--vstep & 1) {  // bit vstep / 2: its doubling
            p0 = Prog::kBody_dbl, p1 = Prog::kEnd_dbl;
          } else {
            // its addition, and add_case picks none where the bit is clear
            // (the JAX body's double-and-cmov-add); skipped where the bit
            // is clear in every element of the warp, by a vote over its
            // live threads, so that the groups of a warp stay together (a
            // branch per group let them drift apart: 1.8-2.2x slower at
            // 4096 elements, PERF.md).  At 4096 elements a warp holds 4-8
            // elements and almost never skips; one element skips the
            // additions of its clear bits.
            bit = vstep >> 1;
            if (__all_sync(__activemask(), !scalar_bit<Prog>(S, bit))) continue;
            p0 = Prog::kBody_add, p1 = Prog::kEnd_add;
            pick = true;
          }
        }
      } else if (e.x == kStepCase) {
        if constexpr ((kinds >> kStepCase) & 1) {
          ++k;
          pick_case(S, e.y, mask, p0, p1);
        }
      } else if (e.x == kStepLoad) {
        if constexpr ((kinds >> kStepLoad) & 1) {
          ++k;
          load_rows<G>(env.table, e.y, S, lane);
          __syncwarp(mask);
          continue;
        }
      } else {
        if constexpr ((kinds >> kStepPow) & 1) {
          pow_step<Prog, G>(env, S, lane, mask, win, nwin, p0, p1);
          if (win < 0) {  // the pow's end
            ++k;
            continue;
          }
        }
      }
    }
    run<G>(p0, p1, S, lane, mask, M);
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

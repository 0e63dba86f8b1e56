// The port's hash-stage and subgroup kernels for Hopper (sm_90a), with a
// plain C interface loaded through ctypes by ops/kernels.py: the windowed
// power (the Fermat inverse), the constant-scalar point ladder (the G1/G2
// subgroup checks), the Budroni-Pintore G2 cofactor clearing, and both SSWU
// maps of hash-to-G2 with their isogeny and sum.
//
// Layout.  As in pairing_kernels.cu, every kernel reads one packed operand
// buffer and writes one packed output buffer, (c, n, 24) int32 16-bit
// Montgomery limbs: an Fp2 is two coordinates (re, im), a Jacobian point
// X, Y, Z (3 coordinates in G1, 6 in G2).  Host constants (exponent
// digits, ladder segments, psi constants, the Montgomery one) ride by value
// in the parameter bank; the SSWU map's 46 Fp constants (4.4 KB) do not
// fit there and come as a device table that the wrapper builds once.
//
// What bounds them, and the design.  Device memory sees the operands, the
// results and the broadcast constants only: a few hundred bytes per
// element against 600-3,000 Montgomery products of ~600 32-bit
// multiply-adds each.  All four are bound by operations, not bytes (the
// notes per kernel give products per element).  Fusing buys launches: a
// subgroup check's ladder was ~1,500 field launches and the hash map
// ~5,000, each is one here.
// pt_mul_const, g2_cofactor and sswu_map2 (the TPU's _ptmulconst_kernel,
// _g2cofactor_kernel and _sswu_kernel) run on group.cuh: a group of G
// threads per batch element, its state in shared memory, its bodies as
// rounds of independent Montgomery products (group_rounds.cuh, traced from
// ops/curve.py's pt_double and pt_add and the SSWU map's formulas), its
// data-dependent choices (the addition's exceptional cases, sswu_map2's
// e1, sqrt candidate and sgn0) as branches that the whole group takes
// together.  The one-thread design they replace ran a G2 ladder's 1,291
// products one after another per element (2.3 ms at n = 1), and sswu_map2's
// ~3,000 (its two sqrt chains and the Fermat inverse in series), behind
// __noinline__ calls with the state in an L1-backed stack, one warp per SM
// at 4096 elements.  A G2 doubling's 17 products are 3 rounds here (7, 7,
// 3), an addition's 44 are 5, and sswu_map2 runs its three exponent chains
// side by side, window by window.  G per kernel and coordinate field is
// chosen on the card (PERF.md has the sweep).  pow_win is one chain of
// dependent products per element, which no grouping of independent
// products shortens (a group phase would hold one product and leave 7 of 8
// threads idle): it runs each product split across L lanes (lanes.cuh),
// which cuts the latency of the product itself.
#include <cuda_runtime.h>

#include <cstdint>

#include "group.cuh"
#include "lanes.cuh"

namespace {

// One warp per block for pow_win: kThreads / L elements.
constexpr int kThreads = 32;

// The group kernels' threads per element (a divisor of 32), from the sweep
// at 4096 elements (PERF.md): pt_mul_const over Fp (G1) and Fp2 (G2),
// g2_cofactor and sswu_map2.  chip_smoke.py builds the sweep's other values
// as throwaway copies of this unit with -DBLS_HASH_GROUP=G, which sets all
// four.
#ifdef BLS_HASH_GROUP
constexpr int kGroupG1 = BLS_HASH_GROUP, kGroupG2 = BLS_HASH_GROUP,
              kGroupCofactor = BLS_HASH_GROUP, kGroupSswu = BLS_HASH_GROUP;
#else
constexpr int kGroupG1 = 4, kGroupG2 = 8, kGroupCofactor = 8, kGroupSswu = 8;
#endif

// pow_win's lanes per element (lanes.cuh; L divides 32 and 12), from the
// sweep at 4096 and 1 elements (PERF.md); chip_smoke.py builds the sweep's
// other value as a throwaway copy of this unit with -DBLS_POW_LANES=L.
#ifndef BLS_POW_LANES
#define BLS_POW_LANES 4
#endif
constexpr int kPowLanes = BLS_POW_LANES;

}  // namespace

// The psi constants of G2 cofactor clearing, by value: psi(x, y) =
// (cx conj(x), cy conj(y)), psi^2(x, y) = (c2 x, -y) with c2 in Fp.
struct PsiConsts {
  bls::Fp2 cx, cy;
  bls::Fp c2;
};

// Both exponents of the SSWU kernel: the Frobenius-split sqrt chain k =
// (p - 11)/16 (Fp2) and the Fermat inverse p - 2 (Fp).
struct SswuDigits {
  bls::PowDigits sqrt_k, inv;
};

namespace bls_kernels {

using bls::Fp;
using bls::FpModulus;

// ---------------------------------------------------------------- pow_win

// Replaces _powwin_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:866):
// a^e for a host-constant e, Fp (C = 1) or Fp2 (C = 2).  in (c, n), out
// (c, n).  Montgomery products per element: 14 for the table, then per
// window after the first 4 squarings and one product where its digit is not
// zero (Fp2: 3 per product, 2 per square).  For the Fermat inverse p - 2:
// 14 + 380 + 91 = 485, ~17 ns of operations against ~0.06 ns of bytes.
// On L lanes per element (lanes.cuh, kPowLanes): every product of the chain
// split across them, the values whole in every lane (in Fp below 2p, made
// canonical once before the store).  The window table a^1 .. a^15 lives in
// shared memory, whole rows, written by lane 0 and read by every lane at
// the digit's row (the digit is the same for every element: no runtime
// index into registers, no local memory).  As the one-thread
// kernel, the chain skips the leading zero windows and a zero digit's
// product: its schedule depends on the exponent alone, never on the data
// (derive_pubkeys runs it on the Z of [sk]G).
template <int C, int L>
__global__ void __launch_bounds__(kThreads)
    pow_win_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                   long long n, FpModulus M, bls::PowDigits e) {
  using V = bls::lanes::Val<C>;
  constexpr int kPer = kThreads / L;  // elements per block
  __shared__ V tab[kPer][15];         // a^1 .. a^15
  const bls::lanes::Lane<L> ln = bls::lanes::make_lane<L>(M);
  const int g = threadIdx.x / L;
  // a tail element's lanes run a copy of the last element and store
  // nothing: every shuffle and ballot spans the whole warp
  const long long at = (long long)blockIdx.x * kPer + g;
  const bool live = at < n;
  const long long i = live ? at : n - 1;
  V a, f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    bls::load_words<bls::kFpWords>(in + ((long long)c * n + i) * bls::kLimbs,
                                   a.w[c]);
  }
  V* T = tab[g];
  if (ln.j == 0) T[0] = a;
  f = a;
  // loops of one inlined product each: the code stays in the instruction cache
#pragma unroll 1
  for (int t = 1; t < 15; ++t) {
    bls::lanes::val_mul<L>(f, a, f, ln, M);
    if (ln.j == 0) T[t] = f;
  }
  __syncwarp();
  f = T[e.d[0] - 1];
  for (int w = 1; w < e.count; ++w) {
#pragma unroll 1
    for (int s = 0; s < 4; ++s) bls::lanes::val_sqr<L>(f, f, ln, M);
    if (e.d[w]) {
      const V entry = T[e.d[w] - 1];  // into registers: b[i] is on m's path
      bls::lanes::val_mul<L>(f, entry, f, ln, M);
    }
  }
  if constexpr (C == 1) bls::lanes::canonical(f, M);
  if (live && ln.j == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      bls::store_words<bls::kFpWords>(
          out + ((long long)c * n + i) * bls::kLimbs, f.w[c]);
    }
  }
}

// ----------------------------------------------------------- pt_mul_const

// Replaces _ptmulconst_kernel (kernels.py:819): the whole static ladder
// [k]P in one launch, from acc = P at k's top bit, per segment len
// doublings and a complete addition of P where it ends on a set bit.  in
// and out (3c, n), c = 1 (G1) or 2 (G2).  For |x| (63 doublings, 5
// additions): G1 63 x 7 + 5 x 16 = 521 Montgomery products, G2 63 x 17 +
// 5 x 44 = 1,291 (~19 and ~46 ns of operations per element).
// On a group of G threads with LadderG1Program / LadderG2Program: P into
// base and the Montgomery one into its slot, the script (one ladder step),
// acc out.  A doubling is 3 rounds (G1: 3, 3, 1 products; G2: 7, 7, 3),
// an addition 5 (G1 16 products, G2 44) and its case.
template <class Prog, int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    pt_mul_const_kernel(const int32_t* __restrict__ in,
                        int32_t* __restrict__ out, long long n, FpModulus M,
                        bls::Segments segs, Fp one) {
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  constexpr int nc = 3 * Prog::kCoord;
  bls::group::load_coords<G>(
      in, n, i, nc, [](int c) { return Prog::kSlot_base + c; }, S, lane);
  bls::group::store_const<G>(S, Prog::kSlot_one, one, lane);
  __syncwarp(mask);
  bls::group::run_script<Prog, G>(segs, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, nc, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
}

// ------------------------------------------------------------ g2_cofactor

// Replaces _g2cofactor_kernel (kernels.py:1219): Budroni-Pintore
// [x^2 - x - 1]P + [x - 1]psi(P) + psi^2(2P) with x < 0, in the JAX
// kernel's order (its add schedule, kernels.py:1286-1322, is the order of
// the unfused curve.g2_clear_cofactor): [x]P = -ladder(P), [x^2]P =
// -ladder([x]P), then aux = [x]P - P, acc = [x^2]P - [x]P, acc -= P,
// acc += psi(aux), acc += psi^2(2P), where psi(x, y, z) = (cx conj(x),
// cy conj(y), conj(z)) and psi^2(x, y, z) = (c2 x, -y, z).  in and out
// (6, n).  Montgomery products per element: 2 x 1,291 for the ladders, 17
// for 2P, 6 for psi, 2 for psi^2 and 5 x 44 for the additions: 2,827
// (~101 ns of operations).
// On a group of G threads with G2CofactorProgram: P, the one and the psi
// constants into their slots, then the program's script, which keeps that
// order (group_rounds.py cofactor_program), acc out.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    g2_cofactor_kernel(const int32_t* __restrict__ in,
                       int32_t* __restrict__ out, long long n, FpModulus M,
                       bls::Segments segs, PsiConsts k, Fp one) {
  using Prog = bls::group::G2CofactorProgram;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(
      in, n, i, 6, [](int c) { return Prog::kSlot_p + c; }, S, lane);
  bls::group::store_const<G>(S, Prog::kSlot_one, one, lane);
  bls::group::store_const<G>(S, Prog::kSlot_cx, k.cx.c0, lane);
  bls::group::store_const<G>(S, Prog::kSlot_cx + 1, k.cx.c1, lane);
  bls::group::store_const<G>(S, Prog::kSlot_cy, k.cy.c0, lane);
  bls::group::store_const<G>(S, Prog::kSlot_cy + 1, k.cy.c1, lane);
  bls::group::store_const<G>(S, Prog::kSlot_c2, k.c2, lane);
  __syncwarp(mask);
  bls::group::run_script<Prog, G>(segs, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, 6, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
}

// -------------------------------------------------------------- sswu_map2

// Replaces _sswu_kernel (kernels.py:1023): map_to_curve for both hash field
// elements u0, u1 of a message, their 3-isogeny and the complete addition
// q0 + q1, in one launch.  in (4, n) = u0 (2), u1 (2); out (6, n) = X, Y,
// Z; tab the (46, 24) device table of the SSWU constants.
// On a group of G threads with SswuMap2Program (group_rounds.py
// sswu_program): u, the Montgomery one and a raw 1 (sgn0's products out of
// Montgomery form) into their slots, then the program's script, which keeps
// the fractions' and the point's representatives of the one-thread
// formulas (_sswu_kernel's): both maps side by side in every phase; the
// table's rows loaded where the script needs them; e1, the sqrt candidate
// (with found1) and sgn0 as branches that the whole group takes on flags it
// reads from the element's slots (pick_case); the two maps' sqrt chains b^k,
// k = (p - 11)/16, and the Fermat inverse of the four denominators' norms'
// product (Montgomery's trick) in lockstep, window by window (pow_step:
// 3-bit windows, a window 3 squaring phases of 5 products and one product
// phase of 7), where the one-thread kernel ran them one after the other;
// the sum through the point programs' addition and add_case; acc out.
// Montgomery products per element: the bodies head 42, pre 213 (the
// chains' tables 36 among them), the windows 2,779 (126 of 22 after window
// 0's 7: every chain runs every window of the longer exponent, p - 2's
// 127, and a product by the one where its digit is 0), post1 52, post2 122
// and the sum 44 (61 in its doubling case): 3,252 (~116 ns of operations
// per element).
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    sswu_map2_kernel(const int32_t* __restrict__ in,
                     const int32_t* __restrict__ tab,
                     int32_t* __restrict__ out, long long n, FpModulus M,
                     SswuDigits dig, Fp one) {
  using Prog = bls::group::SswuMap2Program;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(
      in, n, i, 4, [](int c) { return Prog::kSlot_u + c; }, S, lane);
  Fp raw1 = {};
  raw1.w[0] = 1;
  bls::group::store_const<G>(S, Prog::kSlot_one, one, lane);
  bls::group::store_const<G>(S, Prog::kSlot_raw1, raw1, lane);
  __syncwarp(mask);
  const bls::group::ChainInputs env = {dig.sqrt_k, dig.inv, tab};
  bls::group::run_script<Prog, G>(env, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, 6, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
}

}  // namespace bls_kernels

namespace {

bls::Segments make_segments(const int* lens, const int* muls, int nseg) {
  bls::Segments segs = {};
  segs.count = nseg;
  for (int s = 0; s < nseg; ++s) {
    segs.len[s] = lens[s];
    segs.mul[s] = muls[s];
  }
  return segs;
}

bool make_digits(const unsigned char* d, int count, bls::PowDigits& e) {
  if (count < 1 || count > bls::kMaxDigits || d[0] == 0 || d[0] > 15) {
    return false;
  }
  e = {};
  e.count = count;
  for (int w = 0; w < count; ++w) {
    if (d[w] > 15) return false;
    e.d[w] = d[w];
  }
  return true;
}

}  // namespace

extern "C" {

int bls_pow_win(const int32_t* in, int32_t* out, long long n, int nc,
                const unsigned char* digits, int ndig, const uint32_t* p,
                unsigned n0, void* stream) {
  bls::PowDigits e;
  if ((nc != 1 && nc != 2) || !make_digits(digits, ndig, e)) {
    return (int)cudaErrorInvalidValue;
  }
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  constexpr int per = kThreads / kPowLanes;
  const unsigned grid = (unsigned)((n + per - 1) / per);
  if (nc == 1) {
    bls_kernels::pow_win_kernel<1, kPowLanes>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, n, M, e);
  } else {
    bls_kernels::pow_win_kernel<2, kPowLanes>
        <<<grid, kThreads, 0, (cudaStream_t)stream>>>(in, out, n, M, e);
  }
  return (int)cudaGetLastError();
}

int bls_pt_mul_const(const int32_t* in, int32_t* out, long long n, int nc,
                     const int* lens, const int* muls, int nseg,
                     const uint32_t* one, const uint32_t* p, unsigned n0,
                     void* stream) {
  if ((nc != 1 && nc != 2) || nseg < 0 || nseg > bls::kMaxSegments) {
    return (int)cudaErrorInvalidValue;
  }
  const bls::Segments segs = make_segments(lens, muls, nseg);
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const bls::Fp o = bls::make_fp(one);
  const cudaStream_t s = (cudaStream_t)stream;
  using G1 = bls::group::LadderG1Program;
  using G2 = bls::group::LadderG2Program;
  if (nc == 1) {
    return bls::group::launch<G1, kGroupG1>(
        bls_kernels::pt_mul_const_kernel<G1, kGroupG1>, n, s, in, out, n, M,
        segs, o);
  }
  return bls::group::launch<G2, kGroupG2>(
      bls_kernels::pt_mul_const_kernel<G2, kGroupG2>, n, s, in, out, n, M,
      segs, o);
}

// psi: cx (2 Fp), cy (2 Fp), c2 (1 Fp) as 5 x 12 host words
int bls_g2_cofactor(const int32_t* in, int32_t* out, long long n,
                    const int* lens, const int* muls, int nseg,
                    const uint32_t* psi, const uint32_t* one,
                    const uint32_t* p, unsigned n0, void* stream) {
  if (nseg < 0 || nseg > bls::kMaxSegments) return (int)cudaErrorInvalidValue;
  const bls::Segments segs = make_segments(lens, muls, nseg);
  constexpr int w = bls::kFpWords;
  const PsiConsts k = {{bls::make_fp(psi), bls::make_fp(psi + w)},
                       {bls::make_fp(psi + 2 * w), bls::make_fp(psi + 3 * w)},
                       bls::make_fp(psi + 4 * w)};
  return bls::group::launch<bls::group::G2CofactorProgram, kGroupCofactor>(
      bls_kernels::g2_cofactor_kernel<kGroupCofactor>, n, (cudaStream_t)stream,
      in, out, n, bls::make_modulus<w>(p, n0), segs, k, bls::make_fp(one));
}

// tab: the (46, 24) int32 device table of the SSWU constants
int bls_sswu_map2(const int32_t* in, const int32_t* tab, int32_t* out,
                  long long n, const unsigned char* sqrt_digits, int nsqrt,
                  const unsigned char* inv_digits, int ninv,
                  const uint32_t* one, const uint32_t* p, unsigned n0,
                  void* stream) {
  SswuDigits dig;
  if (!make_digits(sqrt_digits, nsqrt, dig.sqrt_k) ||
      !make_digits(inv_digits, ninv, dig.inv)) {
    return (int)cudaErrorInvalidValue;
  }
  return bls::group::launch<bls::group::SswuMap2Program, kGroupSswu>(
      bls_kernels::sswu_map2_kernel<kGroupSswu>, n, (cudaStream_t)stream, in,
      tab, out, n, bls::make_modulus<bls::kFpWords>(p, n0), dig,
      bls::make_fp(one));
}

}  // extern "C"

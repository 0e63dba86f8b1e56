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
// pt_mul_const and g2_cofactor (the TPU's _ptmulconst_kernel and
// _g2cofactor_kernel) run on group.cuh: a group of G threads per batch
// element, its state in shared memory, its doublings and additions as
// rounds of independent Montgomery products (group_rounds.cuh, traced from
// curve.cuh's pt_dbl and pt_add), the addition's exceptional cases as
// branches that the whole group takes together.  The one-thread design they
// replace ran a G2 ladder's 1,291 products one after another per element
// (2.3 ms at n = 1), behind __noinline__ calls with the state in an
// L1-backed stack, one warp per SM at 4096 elements.  A G2 doubling's 17
// products are 3 rounds here (7, 7, 3) and an addition's 44 are 5.  G per
// kernel and coordinate field is chosen on the card (PERF.md has the
// sweep).  pow_win and sswu_map2 keep one thread per element (curve.cuh):
// their redesign is later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "curve.cuh"
#include "group.cuh"

namespace {

// One warp per block for the one-thread kernels, as in pairing_kernels.cu.
constexpr int kThreads = 32;

// The group kernels' threads per element (a divisor of 32), from the sweep
// at 4096 elements (PERF.md): pt_mul_const over Fp (G1) and Fp2 (G2), and
// g2_cofactor.  chip_smoke.py builds the sweep's other values as
// throwaway copies of this unit with -DBLS_LADDER_GROUP=G, which sets all
// three.
#ifdef BLS_LADDER_GROUP
constexpr int kGroupG1 = BLS_LADDER_GROUP, kGroupG2 = BLS_LADDER_GROUP,
              kGroupCofactor = BLS_LADDER_GROUP;
#else
constexpr int kGroupG1 = 4, kGroupG2 = 8, kGroupCofactor = 8;
#endif

inline unsigned grid_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// SSWU constant table rows (Fp coordinates; an Fp2 is two rows): the
// columns of the JAX kernel's constant block (kernels.py:1015-1018).
constexpr int kSswuA = 0, kSswuB = 2, kSswuZ = 4, kSswuZA = 6;
constexpr int kSswuCZ3 = 10, kSswuSqI = 12, kSswuSqMI = 14;
constexpr int kSswuXNum = 16, kSswuXDen = 24, kSswuYNum = 30, kSswuYDen = 38;

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
using bls::Fp2;
using bls::FpModulus;
using bls::Jac;

// ---------------------------------------------------------------- pow_win

// Replaces _powwin_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:866):
// a^e for a host-constant e, Fp (F = Fp) or Fp2.  in (c, n), out (c, n),
// c = 1 or 2.  Montgomery products per element: 14 for the table, then per
// window after the first 4 squarings and one product where its digit is not
// zero (Fp2: 3 per product, 2 per square).  For the Fermat inverse p - 2:
// 14 + 380 + 91 = 485, ~17 ns of operations against ~0.06 ns of bytes.
template <class F>
__global__ void __launch_bounds__(kThreads)
    pow_win_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                   long long n, FpModulus M, bls::PowDigits e) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  F a;
  bls::load_c(a, in, 0, n, i);
  bls::store_c(out, 0, n, i, bls::pow_win(a, e, M));
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

__device__ __forceinline__ Fp2 tab_fp2(const int32_t* tab, int row) {
  return bls::load_fp2(tab, row, 1, 0);
}

// One SSWU map in fraction form: x = xn / xd, y = yn / yd.
struct SswuFrac {
  Fp2 xn, xd, yn, yd;
};

// Fraction-form sqrt candidate resolution (_cand_select_rows,
// kernels.py:974): y = z c for the first c in (1, u, sqrt(u), sqrt(-u))
// with (z c)^2 gxd == gxn yd^2, checked as X c^2 == R with X = z^2 gxd;
// 0 where target == 0 or nothing passes.  Returns whether one passed.
__device__ __forceinline__ bool cand_select(const Fp2& z, const Fp2& X,
                                            const Fp2& R, const Fp2& target,
                                            const int32_t* tab, Fp2& best,
                                            const FpModulus& M) {
  const Fp2 neg_x = bls::f2_neg(X, M);
  const bool ok[4] = {bls::f2_eq(X, R), bls::f2_eq(neg_x, R),
                      bls::f2_eq(bls::f2_muli(X, M), R),
                      bls::f2_eq(Fp2{X.c1, neg_x.c0}, R)};
  best = Fp2{};
  if (bls::f2_is_zero(target)) return true;
  if (ok[0]) {
    best = z;
  } else if (ok[1]) {
    best = bls::f2_muli(z, M);
  } else if (ok[2]) {
    best = bls::f2_mul(z, tab_fp2(tab, kSswuSqI), M);
  } else if (ok[3]) {
    best = bls::f2_mul(z, tab_fp2(tab, kSswuSqMI), M);
  } else {
    return false;
  }
  return true;
}

// gx numerator over gxd = xd^3: num^3 + A num xd^2 + B xd^3 (14 products).
__device__ __forceinline__ Fp2 gx_num(const Fp2& num, const Fp2& xd2,
                                      const Fp2& xd3, const Fp2& A,
                                      const Fp2& B, const FpModulus& M) {
  const Fp2 n3 = bls::f2_mul(bls::f2_sqr(num, M), num, M);
  const Fp2 anx = bls::f2_mul(A, bls::f2_mul(num, xd2, M), M);
  return bls::f2_add(bls::f2_add(n3, anx, M), bls::f2_mul(B, xd3, M), M);
}

// The first half of one map (_sswu_kernel, kernels.py:1065-1121): x and y
// as fractions, with one Frobenius-split sqrt chain W^((q+7)/16) =
// (conj(W) W^11)^k W^8 on W = gxn gxd^15.  112 Montgomery products beside
// the chain (its table 42, squares 8 per window, products 3 per nonzero
// digit).
__device__ __noinline__ SswuFrac sswu_fraction(const Fp2& u,
                                               const int32_t* tab,
                                               const bls::PowDigits& k,
                                               const Fp& one,
                                               const FpModulus& M) {
  const Fp2 A = tab_fp2(tab, kSswuA), B = tab_fp2(tab, kSswuB);
  const Fp2 tv1 = bls::f2_sqr(u, M);                        // u^2
  const Fp2 tv3 = bls::f2_mul(tab_fp2(tab, kSswuZ), tv1, M);  // Z u^2
  const Fp2 t = bls::f2_add(bls::f2_sqr(tv3, M), tv3, M);
  const bool e1 = bls::f2_is_zero(t);
  Fp2 t1 = t;
  t1.c0 = bls::fp_add(t.c0, one, M);
  // t == 0: x1 = B / (Z A); else x1 = -B (t + 1) / (A t)
  const Fp2 xn = e1 ? B : bls::f2_neg(bls::f2_mul(B, t1, M), M);
  const Fp2 xd = e1 ? tab_fp2(tab, kSswuZA) : bls::f2_mul(A, t, M);
  const Fp2 xd2 = bls::f2_sqr(xd, M);
  const Fp2 xd3 = bls::f2_mul(xd2, xd, M);
  const Fp2 gxn = gx_num(xn, xd2, xd3, A, B, M);
  const Fp2& gxd = xd3;
  const Fp2 g2 = bls::f2_sqr(gxd, M);
  const Fp2 g4 = bls::f2_sqr(g2, M);
  const Fp2 g8 = bls::f2_sqr(g4, M);
  const Fp2 W = bls::f2_mul(
      gxn, bls::f2_mul(bls::f2_mul(g8, g4, M), bls::f2_mul(g2, gxd, M), M), M);
  const Fp2 w2 = bls::f2_sqr(W, M);
  const Fp2 w8 = bls::f2_sqr(bls::f2_sqr(w2, M), M);
  const Fp2 w11 = bls::f2_mul(w8, bls::f2_mul(w2, W, M), M);
  const Fp2 b = bls::f2_mul(bls::f2_conj(W, M), w11, M);
  const Fp2 z1 = bls::f2_mul(bls::pow_win(b, k, M), w8, M);
  // y's denominator: gxd^(q+7) = gxd^8, since x^q = x in Fp2
  const Fp2& yd = g8;
  const Fp2 yd2 = bls::f2_sqr(yd, M);
  Fp2 yn1, yn2;
  const bool found1 = cand_select(z1, bls::f2_mul(bls::f2_sqr(z1, M), gxd, M),
                                  bls::f2_mul(gxn, yd2, M), gxn, tab, yn1, M);
  // x2 = Z u^2 x1, gx2 evaluated directly; z2 = z1 Cz3 u^3 reuses the chain
  // (its error factor is a 4th root of unity, absorbed by the candidates)
  const Fp2 x2n = bls::f2_mul(tv3, xn, M);
  const Fp2 gx2n = gx_num(x2n, xd2, xd3, A, B, M);
  const Fp2 u3 = bls::f2_mul(tv1, u, M);
  const Fp2 z2 = bls::f2_mul(bls::f2_mul(z1, tab_fp2(tab, kSswuCZ3), M), u3, M);
  cand_select(z2, bls::f2_mul(bls::f2_sqr(z2, M), gxd, M),
              bls::f2_mul(gx2n, yd2, M), gx2n, tab, yn2, M);
  return {found1 ? xn : x2n, xd, found1 ? yn1 : yn2, yd};
}

// RFC 9380 sgn0 (m = 2) on the canonical value: out of Montgomery form by a
// product with a raw 1 (_sgn0_rows, kernels.py:997).
__device__ __forceinline__ uint32_t sgn0(const Fp2& e, const FpModulus& M) {
  Fp raw1 = bls::fp_zero();
  raw1.w[0] = 1;
  const Fp r0 = bls::fp_mul(e.c0, raw1, M);
  const Fp r1 = bls::fp_mul(e.c1, raw1, M);
  return bls::fp_is_zero(r0) ? (r1.w[0] & 1u) : (r0.w[0] & 1u);
}

// sum coeffs[i] x^i for the table's coefficient rows (_horner_rows :1008)
__device__ __forceinline__ Fp2 horner(const int32_t* tab, int row, int ncoef,
                                      const Fp2& x, const FpModulus& M) {
  Fp2 acc = tab_fp2(tab, row + 2 * (ncoef - 1));
  for (int c = ncoef - 2; c >= 0; --c) {
    acc = bls::f2_add(bls::f2_mul(acc, x, M), tab_fp2(tab, row + 2 * c), M);
  }
  return acc;
}

// The second half of one map (_sswu_kernel, kernels.py:1151-1177): affine
// x, y from the inverted denominator norms, the sgn0 fix, then the
// 3-isogeny in Jacobian packing Z = xd' yd', X = xn' yd' Z, Y = y yn' xd'
// Z^2.  67 Montgomery products.
__device__ __noinline__ Jac<Fp2> sswu_finish(const Fp2& u, const SswuFrac& f,
                                             const Fp& inv_nxd,
                                             const Fp& inv_nyd,
                                             const int32_t* tab,
                                             const FpModulus& M) {
  const Fp2 x = bls::f2_mul(f.xn, bls::f2_muls(bls::f2_conj(f.xd, M), inv_nxd, M), M);
  Fp2 y = bls::f2_mul(f.yn, bls::f2_muls(bls::f2_conj(f.yd, M), inv_nyd, M), M);
  if (sgn0(u, M) != sgn0(y, M)) y = bls::f2_neg(y, M);
  const Fp2 xn = horner(tab, kSswuXNum, 4, x, M);
  const Fp2 xd = horner(tab, kSswuXDen, 3, x, M);
  const Fp2 yn = horner(tab, kSswuYNum, 4, x, M);
  const Fp2 yd = horner(tab, kSswuYDen, 4, x, M);
  const Fp2 z = bls::f2_mul(xd, yd, M);
  const Fp2 X = bls::f2_mul(bls::f2_mul(xn, yd, M), z, M);
  const Fp2 Y = bls::f2_mul(bls::f2_mul(yn, bls::f2_mul(y, xd, M), M),
                            bls::f2_sqr(z, M), M);
  return {X, Y, z};
}

__device__ __forceinline__ Fp norm(const Fp2& a, const FpModulus& M) {
  return bls::fp_add(bls::fp_mul(a.c0, a.c0, M), bls::fp_mul(a.c1, a.c1, M), M);
}

// Replaces _sswu_kernel (kernels.py:1023): map_to_curve for both hash field
// elements u0, u1 of a message, their 3-isogeny and the complete addition
// q0 + q1, in one launch.  The four denominators (xd, yd of each map) are
// inverted by one Fermat chain on the product of their Fp norms
// (Montgomery's trick, kernels.py:1138-1152).  The TPU kernel runs the two
// maps lane-concatenated through one sqrt chain; here one thread takes its
// element through both maps in turn.  in (4, n) = u0 (2), u1 (2); out
// (6, n) = X, Y, Z.  Montgomery products per element: per map 112 +
// 67 + the sqrt chain (42 + 8 x 94 + 3 x 90 = 1,064), then 8 + 3 for the
// norms, 14 + 380 + 91 for the inverse, 6 for the trick and 44 for the
// sum: 3,032 (~109 ns of operations), not counting the sqrt candidates'
// at most 3 products per check where a candidate sqrt(+-u) passes.
__global__ void __launch_bounds__(kThreads)
    sswu_map2_kernel(const int32_t* __restrict__ in,
                     const int32_t* __restrict__ tab,
                     int32_t* __restrict__ out, long long n, FpModulus M,
                     SswuDigits dig, Fp one) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Fp2 u[2] = {bls::load_fp2(in, 0, n, i), bls::load_fp2(in, 2, n, i)};
  SswuFrac f[2];
  Fp ns[4];
  for (int h = 0; h < 2; ++h) {
    f[h] = sswu_fraction(u[h], tab, dig.sqrt_k, one, M);
    ns[2 * h] = norm(f[h].xd, M);
    ns[2 * h + 1] = norm(f[h].yd, M);
  }
  const Fp pre1 = bls::fp_mul(ns[0], ns[1], M);
  const Fp pre2 = bls::fp_mul(pre1, ns[2], M);
  Fp tinv = bls::pow_win(bls::fp_mul(pre2, ns[3], M), dig.inv, M);
  Fp inv[4];
  inv[3] = bls::fp_mul(tinv, pre2, M);
  tinv = bls::fp_mul(tinv, ns[3], M);
  inv[2] = bls::fp_mul(tinv, pre1, M);
  tinv = bls::fp_mul(tinv, ns[2], M);
  inv[1] = bls::fp_mul(tinv, ns[0], M);
  inv[0] = bls::fp_mul(tinv, ns[1], M);
  Jac<Fp2> q[2];
  for (int h = 0; h < 2; ++h) {
    q[h] = sswu_finish(u[h], f[h], inv[2 * h], inv[2 * h + 1], tab, M);
  }
  bls::store_jac(out, 0, n, i, bls::pt_add(q[0], q[1], one, M));
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
  if (nc == 1) {
    bls_kernels::pow_win_kernel<bls::Fp>
        <<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(in, out, n, M, e);
  } else {
    bls_kernels::pow_win_kernel<bls::Fp2>
        <<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(in, out, n, M, e);
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
  bls_kernels::sswu_map2_kernel<<<grid_for(n), kThreads, 0,
                                  (cudaStream_t)stream>>>(
      in, tab, out, n, bls::make_modulus<bls::kFpWords>(p, n0), dig,
      bls::make_fp(one));
  return (int)cudaGetLastError();
}

}  // extern "C"

// The port's point kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by ops/kernels.py: Jacobian doubling repeated
// `count` times, the complete Jacobian addition, and the variable-scalar
// double-and-add ladder of keygen and signing, for G1 (coordinates in Fp)
// and G2 (Fp2) as template instances over group.cuh.
//
// Layout.  As in hash_kernels.cu: packed operand buffers in and one packed
// output buffer out, (c, n, 24) int32 16-bit Montgomery limbs, a Jacobian
// point X, Y, Z (3 coordinates in G1, 6 in G2); the addition takes P and Q
// through a pointer each.  The ladder also reads each element's scalar as
// a row of kScalarLimbs raw (non-Montgomery) 16-bit limbs, little-endian.
// The Montgomery one and the bit count ride by value in the parameter
// bank.
//
// What bounds them, and the design.  Device memory sees the operands and
// the results only: 96 bytes per Fp coordinate in or out, and 64 per
// scalar, against 7 / 17 Montgomery products per G1 / G2 doubling and 16
// / 44 per addition (~600 32-bit multiply-adds each).  The ladder is bound
// by operations (up to 5,865 / 15,555 products per element for 255 bits);
// a single addition or doubling at the 2,048 elements of a 4096-element
// aggregation tree's widest level is bound by operations too, at 1-3
// microseconds, about what a launch costs.
// pt_dbl, pt_add and pt_mul_var (the TPU's _ptdbl_kernel, _ptadd_kernel
// and _ptmulvar_kernel) run on group.cuh: a group of G threads per
// element, its state in shared memory, the doubling and the complete
// addition as rounds of independent Montgomery products (group_rounds.cuh,
// the bodies of pt_mul_const's ladders, group_rounds.py ladder_bodies),
// and the addition's case (and the ladder's scalar bit) as flags that
// every thread of the group reads from the element's slots: a group never
// diverges on its case.  The one-thread kernels they replace ran a G2
// addition's 44 products, or the ladder's 255 x (17 + 44), in series per
// thread, 32 threads per block, so that an aggregation tree's level took
// one thread's latency whatever its width, and branched per thread on the
// case and the bit.
#include <cuda_runtime.h>

#include <cstdint>

#include "group.cuh"

namespace {

constexpr int kScalarLimbs = 16;  // raw Fr scalar: 16 x 16-bit limbs

// The group kernels' threads per element (a divisor of 32) over Fp (G1)
// and Fp2 (G2): pt_mul_var's from the sweep at 4096 elements; pt_add's
// from the sweep at the aggregation trees' levels, 2048 elements down to 1
// (the keys run's 33 launches summed, H100 at 700 W: G1 G = 2 / 4 / 8 /
// 16 690.6 / 460.1 / 428.2 / 422.2 us, G = 8 ahead at 2048; G2 918.1 /
// 576.2 / 372.8 / 295.3 us; PERF.md); pt_dbl's from the sweep at 4096
// elements, count 1 and 63 (PERF.md).  chip_smoke.py builds the sweep's
// other values as throwaway copies of this unit with -DBLS_POINT_GROUP=G,
// which sets all six.
#ifdef BLS_POINT_GROUP
constexpr int kGroupVarG1 = BLS_POINT_GROUP, kGroupVarG2 = BLS_POINT_GROUP,
              kGroupAddG1 = BLS_POINT_GROUP, kGroupAddG2 = BLS_POINT_GROUP,
              kGroupDblG1 = BLS_POINT_GROUP, kGroupDblG2 = BLS_POINT_GROUP;
#else
constexpr int kGroupVarG1 = 4, kGroupVarG2 = 8, kGroupAddG1 = 8,
              kGroupAddG2 = 16, kGroupDblG1 = 4, kGroupDblG2 = 8;
#endif

}  // namespace

namespace bls_kernels {

using bls::Fp;
using bls::FpModulus;

// ----------------------------------------------------------------- pt_dbl

// Replaces _ptdbl_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:771):
// `count` Jacobian doublings (_pt_dbl_body; ops/curve.py pt_double) in one
// launch.  in and out (3c, n), c = 1 (G1) or 2 (G2).  7 (G1) or 17 (G2)
// Montgomery products per doubling: ~0.25 / ~0.61 ns of operations per
// element against ~0.17 / ~0.34 ns of bytes for one doubling.
// On a group of G threads with PtAddG1Program / PtAddG2Program: the point
// into acc, then `count` times the body dbl -- the ladders' doubling
// (group_rounds.py pt_dbl_rounds): 3 product phases, G1 3, 3, 1 products,
// G2 7, 7, 3, then acc in place -- and acc out.  Infinity stays infinity
// (Z3 = 2 Y Z), so no case is read.
template <class Prog, int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    pt_dbl_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                  long long n, int count, FpModulus M) {
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
      in, n, i, nc, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
  __syncwarp(mask);
  for (int r = 0; r < count; ++r) {
    bls::group::run<G>(Prog::kBody_dbl, Prog::kEnd_dbl, S, lane, mask, M);
  }
  bls::group::store_coords<G>(
      out, n, i, nc, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
}

// ----------------------------------------------------------------- pt_add

// Replaces _ptadd_kernel (kernels.py:795): the complete addition P + Q
// (_pt_add_body) with the JAX body's case order: P at infinity gives Q, Q
// at infinity gives P, P == Q doubles, P == -Q gives (1, 1, 0).  P and Q
// (3c, n) through a pointer each (no copy of both into one buffer per
// tree level), out (3c, n), c = 1 (G1) or 2 (G2).  16 (G1) or 44 (G2)
// Montgomery products per element, and a doubling's 7 / 17 more where P
// == Q: ~0.57 / ~1.6 ns of operations against ~0.26 / ~0.52 ns of bytes.
// On a group of G threads with PtAddG1Program / PtAddG2Program
// (group_rounds.py add_program): P into acc and Q into base from their own
// buffers, the Montgomery one into its slot, the script (one ADD step: the
// body add, 5 product phases -- G1 3, 4, 4, 3, 2 products, G2 7, 12, 11,
// 8, 6: one round each at G = 8 (G1) and 16 (G2) -- then the body of the
// case that add_case picks), acc out.  At one element a launch takes about
// 20 us in G1 and 23 us in G2 (PERF.md): each phase waits on mont_mul's
// latency in one thread and on its chain of table reads.  The
// elements of a warp may take different cases (an aggregation tree meets
// masked keys' infinities and equal points); the branch is per group.
template <class Prog, int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    pt_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ out, long long n, FpModulus M,
                  Fp one) {
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
      p, n, i, nc, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
  bls::group::load_coords<G>(
      q, n, i, nc, [](int c) { return Prog::kSlot_base + c; }, S, lane);
  bls::group::store_const<G>(S, Prog::kSlot_one, one, lane);
  __syncwarp(mask);
  bls::group::run_script<Prog, G>(0, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, nc, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
}

// ------------------------------------------------------------- pt_mul_var

// Replaces _ptmulvar_kernel (kernels.py:1329): [s]P for a per-element
// scalar s, MSB first over `nbits` bits from acc = (1, 1, 0): per bit
// acc = pt_dbl(acc), then acc = pt_add(acc, P) where the bit is set (the
// JAX body computes both and selects; the values are exact, so the limbs
// are the plain version's).  in and out (3c, n), scalars (n, 16) raw
// 16-bit limbs (the JAX wrapper's pre-aligned scalar rows are a TPU row
// layout and do not carry over).  Montgomery products per element: 255 x
// (7 + 16) = 5,865 for G1, 255 x (17 + 44) = 15,555 for G2, less the
// additions of the bits that are clear in every element of the warp
// (group.cuh run_script: at 4096 elements nearly none, for one element
// those of its clear bits).
// On a group of G threads with VarLadderG1Program / VarLadderG2Program:
// P into base, the Montgomery one and the element's scalar (8 words) into
// their slots, the script (one variable ladder step: set_inf, then per bit
// a doubling and the addition, whose case is none where the bit is clear),
// acc out.  A doubling is 3 product rounds (G1: 3, 3, 1 products; G2: 7,
// 7, 3), an addition 5 (G1 16 products, G2 44).  G = 4 in G1 and 8 in G2
// (G = 2, 4, 8 at 4096 elements: G1 9.10 / 5.42 / 7.28 ms, G2 22.32 /
// 12.16 / 10.37 on an H100 at 700 W; PERF.md).
template <class Prog, int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    pt_mul_var_kernel(const int32_t* __restrict__ in,
                      const int32_t* __restrict__ scalars,
                      int32_t* __restrict__ out, long long n, int nbits,
                      FpModulus M, Fp one) {
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
  const int32_t* s = scalars + i * kScalarLimbs;  // 8 words, then 4 of 0
  for (int k = lane; k < bls::kFpWords; k += G) {
    S[bls::kFpWords * Prog::kSlot_scalar + k] =
        2 * k < kScalarLimbs
            ? (uint32_t)__ldg(s + 2 * k) | ((uint32_t)__ldg(s + 2 * k + 1) << 16)
            : 0u;
  }
  __syncwarp(mask);
  bls::group::run_script<Prog, G>(nbits, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, nc, [](int c) { return Prog::kSlot_acc + c; }, S, lane);
}

}  // namespace bls_kernels

extern "C" {

int bls_pt_dbl(const int32_t* in, int32_t* out, long long n, int nc, int count,
               const uint32_t* p, unsigned n0, void* stream) {
  if ((nc != 1 && nc != 2) || count < 1) return (int)cudaErrorInvalidValue;
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const cudaStream_t s = (cudaStream_t)stream;
  using G1 = bls::group::PtAddG1Program;
  using G2 = bls::group::PtAddG2Program;
  if (nc == 1) {
    return bls::group::launch<G1, kGroupDblG1>(
        bls_kernels::pt_dbl_kernel<G1, kGroupDblG1>, n, s, in, out, n, count, M);
  }
  return bls::group::launch<G2, kGroupDblG2>(
      bls_kernels::pt_dbl_kernel<G2, kGroupDblG2>, n, s, in, out, n, count, M);
}

int bls_pt_add(const int32_t* pts, const int32_t* qts, int32_t* out,
               long long n, int nc, const uint32_t* one, const uint32_t* p,
               unsigned n0, void* stream) {
  if (nc != 1 && nc != 2) return (int)cudaErrorInvalidValue;
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const bls::Fp o = bls::make_fp(one);
  const cudaStream_t s = (cudaStream_t)stream;
  using G1 = bls::group::PtAddG1Program;
  using G2 = bls::group::PtAddG2Program;
  if (nc == 1) {
    return bls::group::launch<G1, kGroupAddG1>(
        bls_kernels::pt_add_kernel<G1, kGroupAddG1>, n, s, pts, qts, out, n, M,
        o);
  }
  return bls::group::launch<G2, kGroupAddG2>(
      bls_kernels::pt_add_kernel<G2, kGroupAddG2>, n, s, pts, qts, out, n, M,
      o);
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
  using G1 = bls::group::VarLadderG1Program;
  using G2 = bls::group::VarLadderG2Program;
  if (nc == 1) {
    return bls::group::launch<G1, kGroupVarG1>(
        bls_kernels::pt_mul_var_kernel<G1, kGroupVarG1>, n, s, in, scalars, out, n,
        nbits, M, o);
  }
  return bls::group::launch<G2, kGroupVarG2>(
      bls_kernels::pt_mul_var_kernel<G2, kGroupVarG2>, n, s, in, scalars, out, n, nbits,
      M, o);
}

}  // extern "C"

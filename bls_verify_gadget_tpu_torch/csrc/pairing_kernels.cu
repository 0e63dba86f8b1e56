// The port's pairing kernels for Hopper (sm_90a), with a plain C interface
// loaded through ctypes by ops/kernels.py: the Fp6 product (of the Fp12
// inverse), the Fp12 product and square,
// the Miller loop's doubling runs and addition blocks, and the final
// exponentiation's whole exp-by-|x| chain; and the launches of the
// step-wise configuration (config.fuse_miller / fuse_expx off): the sparse
// line product, one doubling or addition step, and a run of Granger-Scott
// squares.
//
// Layout.  Every kernel reads packed operand buffers and writes one
// packed output buffer, all (c, n, 24) int32: coordinate j of batch
// element i is the 24-limb row at ((j * n) + i) * 24, 16-bit Montgomery
// limbs as in field_kernels.cu.  An Fp6 is 6 coordinates and an Fp12 12,
// in coefficient-major order (c0.c0.re, c0.c0.im, ..., c1.c2.im).  The Miller
// kernels also take the pairs' valid masks as (k, n) int32.  The step
// kernels take each of their operands (T, the affine Q, the G1 point, a
// line) through its own pointer, so the step-wise Miller loop hands T and
// the line from one launch's output to the next without a copy.
//
// What bounds them, and the design.  Device memory sees only the operands
// and the results: 96 bytes per Fp coordinate in or out against ~600 32-bit
// multiply-adds per Montgomery product, so every kernel here is bound by
// operations, not bytes (the notes per kernel give the two bounds per
// element at 3.35 TB/s and 16.75 T int32 multiply-adds/s).  Fusing buys
// launches: the Miller loop is 11 launches and an x-chain one.
//
// Every kernel here (the TPU's _millerdbl_kernel, _milleradd_kernel,
// _expx_kernel, _fp12mul_kernel, _fp6mul_kernel, _fp12sqr_kernel,
// _mul014_kernel, _cyclo_sqr_kernel, _dblstep_kernel and _addstep_kernel)
// runs on group.cuh: a group of G threads per batch element, the element's
// state in shared memory, each body as rounds of independent Montgomery
// products dealt out over the group (group_rounds.cuh).  The design they
// replace ran one thread per element: every product after the one before it
// (1,404 in a row per exp_x element, ~2.5 us each), behind __noinline__
// calls with the state in an L1-backed stack, and at 4096 elements one warp
// on each SM, so nothing hid a product's latency.  The group cuts the serial
// chain per element to the rounds' depth (a Miller iteration: 176 products
// in 4 rounds; a Granger-Scott square: 18 in one), runs each product inlined
// in registers, and puts G times the warps on each SM.  G and the block are
// compile-time constants chosen on the card (kGroup, kGroupFp12Mul,
// kGroupFp6Mul, kGroupFp12Sqr, kGroupMul014, kGroupCycloSqr, kGroupDblStep,
// kGroupAddStep; PERF.md has the sweep).  What bounds the group kernels now
// is not one thread's latency: two products at once per thread ran slower.
// By instruction count most of a body is mont_mul's CIOS.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "group.cuh"

namespace {

// The group kernels' threads per batch element (a divisor of 32), from the
// sweep at the main path's counts (PERF.md): the Miller kernels and exp_x;
// fp12_mul, whose one phase of 54 products takes 4 rounds at 16 threads;
// fp6_mul, 18 products in 5 rounds at 4 threads (a little ahead of 8 at
// verify's 8192 elements; 8 and 16 are faster at a few elements);
// fp12_sqr, 36 products in 3 rounds at 16; mul014, 45 products in 3 rounds
// at 16 (ahead of 8 and 4 at 4096 elements and at 1); and cyclo_sqr, 18 in
// 3 rounds at 8, as exp_x's square (ahead of 4 and 16 on a run of 32 at
// 4096, the step-wise verify's count; 16 is faster at a few elements);
// dbl_step, 11 then 14 products at 8 (two rounds each; at 8192
// elements, the step-wise verify's 63 launches, G = 4 / 8 / 16 take 42.2 /
// 37.5 / 40.4 us, at 4096 36.1 / 26.4 / 23.2, at 1 30.7 / 20.0 / 13.4 on
// an H100 at 700 W); and add_step, product phases of 6, 14, 9 and 12 at
// 8 (the sweep at the step-wise verify's 8192 elements: PERF.md).
// chip_smoke.py builds the sweep's other values as throwaway copies of this
// unit with -DBLS_GROUP=G, which sets all eight.
#ifdef BLS_GROUP
constexpr int kGroup = BLS_GROUP, kGroupFp12Mul = BLS_GROUP,
              kGroupFp6Mul = BLS_GROUP, kGroupFp12Sqr = BLS_GROUP,
              kGroupMul014 = BLS_GROUP, kGroupCycloSqr = BLS_GROUP,
              kGroupDblStep = BLS_GROUP, kGroupAddStep = BLS_GROUP;
#else
constexpr int kGroup = 8, kGroupFp12Mul = 16, kGroupFp6Mul = 4,
              kGroupFp12Sqr = 16, kGroupMul014 = 16, kGroupCycloSqr = 8,
              kGroupDblStep = 8, kGroupAddStep = 8;
#endif

}  // namespace

namespace bls_kernels {

using bls::FpModulus;

// The tower products on a group of G threads per element (group.cuh): the
// input's `nin` coordinates into slots 0 and up, the body [p0, p1) of
// program Prog, and `nout` coordinates out from Prog's slots `out`.  A
// one-thread body runs a tower product's Montgomery products one after
// another per element, behind an L1-backed stack, with a warp or two on
// each SM; here the products are one phase dealt over the group, so the
// serial chain per element is that phase's rounds.
template <class Prog, int G>
__device__ __forceinline__ void tower_group(const int32_t* __restrict__ in,
                                            int32_t* __restrict__ out,
                                            long long n, int nin, int nout,
                                            int p0, int p1,
                                            const FpModulus& M) {
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(in, n, i, nin, [](int c) { return c; }, S, lane);
  __syncwarp(mask);
  bls::group::run<G>(p0, p1, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, nout, [](int c) { return Prog::kSlot_out + c; }, S, lane);
}

// Replaces _fp6mul_kernel (bls_verify_gadget_tpu/ops/pallas/kernels.py:291):
// in (12, n) = a then b, out (6, n).  18 Montgomery products (6 Fp2
// Karatsuba products) of ~600 multiply-adds, 18 Fp in or out per element:
// ~0.65 ns of operations at 16.75 T/s against ~0.5 ns of bytes.
// With Fp6MulProgram (group_rounds.py fp6_mul_program): a and b into slots
// 0-11, then the body mul -- the 18 products of f6_mul in one phase, the
// Karatsuba and Toom sums evaluated in their operands, then the Toom
// combination's 6 forms into out: 18 / G rounds.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    fp6_mul_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                   long long n, FpModulus M) {
  using Prog = bls::group::Fp6MulProgram;
  tower_group<Prog, G>(in, out, n, 12, 6, Prog::kBody_mul, Prog::kEnd_mul, M);
}

// Replaces _fp12mul_kernel (kernels.py:584):
// in (24, n) = a then b, out (12, n).  54 Montgomery products, 36 Fp in or
// out per element: ~1.9 ns of operations against ~1.0 ns of bytes.
// With Fp12MulProgram (group_rounds.py fp12_mul_program): a and b into
// slots 0-23, then the body mul -- the Karatsuba sums (12 forms), the 54
// products of f12_mul in one phase, the product's 12 forms -- and out.
// The one-thread kernel it replaces ran the 54 products one after another
// per element (~139 us at 4096 elements); here they take 54 / G rounds.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    fp12_mul_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                    long long n, FpModulus M) {
  using Prog = bls::group::Fp12MulProgram;
  tower_group<Prog, G>(in, out, n, 24, 12, Prog::kBody_mul, Prog::kEnd_mul,
                       M);
}

// Replaces _fp12sqr_kernel (kernels.py:596): in (12, n), out (12, n).  The
// generic square, 2 Fp6 products: 36 Montgomery products, 24 Fp per
// element: ~1.3 ns of operations against ~0.7 ns of bytes.
// With Fp12SqrProgram (group_rounds.py fp12_sqr_program): a into slots
// 0-11, then the body sqr -- s = a.c0 + a.c1 and t_in = a.c0 + v a.c1 (12
// forms), the 36 products a.c0 a.c1 and s t_in in one phase, the square's
// 12 forms -- and out: 36 / G rounds.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    fp12_sqr_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                    long long n, FpModulus M) {
  using Prog = bls::group::Fp12SqrProgram;
  tower_group<Prog, G>(in, out, n, 12, 12, Prog::kBody_sqr, Prog::kEnd_sqr,
                       M);
}

// The Miller kernels are templates over the pair count K, instantiated for
// K = 1 (aggregate_verify_distinct's one pair of n + 1 elements) and K = 2
// (verify's two pairs); the C entry points take k and refuse any other.

// Replaces _millerdbl_kernel (kernels.py:1494): `count` iterations of
// [f <- f^2; per pair in order: T, line <- dbl_step(T); f <- f * line].
// in (12 + 8k, n) = f, then per pair X, Y, Z (Fp2 each), xp, yp; out
// (12 + 6k, n) = f, then per pair X, Y, Z.  An invalid pair's line is the
// neutral (1, 0, 0), whose product leaves f's limbs as they are, so the
// group skips that product.  Montgomery products per iteration: 36 for
// f^2, per pair 25 for the step (19 for T, 6 for the line) and 45 for
// f * line where the pair is valid.  An invalid pair needs only its 19, so
// the bound counts 36 + 19k + 51 per valid pair (176 with both valid:
// ~6.3 ns per element and iteration of operations against ~1.5 ns of bytes
// for the whole launch; 106 for one valid pair).
// On a group of G threads (group.cuh) with the program of group_rounds.cuh
// (Miller1Program / Miller2Program): the input's coordinates are its first
// slots; an iteration is the body dbl (f^2 and each pair's first doubling
// round, 36 + 11k products, then the second round, 14k) and, per valid
// pair, the body line<p> (45).
template <int K, int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    miller_dbl_run_kernel(const int32_t* __restrict__ in,
                          const int32_t* __restrict__ valid,
                          int32_t* __restrict__ out, long long n, int count,
                          FpModulus M) {
  using Prog = std::conditional_t<K == 1, bls::group::Miller1Program,
                                  bls::group::Miller2Program>;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(in, n, i, 12 + 8 * K, [](int c) { return c; },
                             S, lane);
  bool ok[K];
#pragma unroll
  for (int p = 0; p < K; ++p) ok[p] = valid[p * n + i] != 0;
  __syncwarp(mask);
  for (int it = 0; it < count; ++it) {
    bls::group::run<G>(Prog::kBody_dbl, Prog::kEnd_dbl, S, lane, mask, M);
    if (ok[0]) {
      bls::group::run<G>(Prog::kBody_line0, Prog::kEnd_line0, S, lane, mask, M);
    }
    if constexpr (K == 2) {
      if (ok[1]) {
        bls::group::run<G>(Prog::kBody_line1, Prog::kEnd_line1, S, lane,
                           mask, M);
      }
    }
  }
  // out: f, then per pair T (slots 12 + 8p ..)
  bls::group::store_coords<G>(
      out, n, i, 12 + 6 * K,
      [](int c) { return c < 12 ? c : 12 + 8 * ((c - 12) / 6) + (c - 12) % 6; },
      S, lane);
}

// Replaces _milleradd_kernel (kernels.py:1537): per pair in order,
// T, line <- add_step(T, Q); f <- f * line (skipped where the pair is
// invalid, as above).  in (12 + 12k, n) = f, then per pair X, Y, Z, xq, yq
// (Fp2 each), xp, yp; out (12 + 6k, n).  Montgomery products per pair: 41
// for the step (31 for T, 10 for the line) and 45 for f * line where the
// pair is valid; the bound counts 31 per pair and 55 per valid pair (172
// with both valid: ~6.2 ns of operations against ~1.7 ns of bytes per
// element; 86 for one valid pair).
// On a group of G threads with MillerAdd1Program / MillerAdd2Program
// (group_rounds.py miller_add_program): the input's coordinates are its
// first slots; the body add runs the mixed addition step of ops/pairing.py
// _add_step for every pair at once (product phases of 6k, 14k, 9k and 12k products; the lines' c0
// stored after the third, T after the last), then, per valid pair, the
// body line<p> (45), as in miller_dbl_run.
template <int K, int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    miller_add_kernel(const int32_t* __restrict__ in,
                      const int32_t* __restrict__ valid,
                      int32_t* __restrict__ out, long long n, FpModulus M) {
  using Prog = std::conditional_t<K == 1, bls::group::MillerAdd1Program,
                                  bls::group::MillerAdd2Program>;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(in, n, i, 12 + 12 * K, [](int c) { return c; },
                             S, lane);
  bool ok[K];
#pragma unroll
  for (int p = 0; p < K; ++p) ok[p] = valid[p * n + i] != 0;
  __syncwarp(mask);
  bls::group::run<G>(Prog::kBody_add, Prog::kEnd_add, S, lane, mask, M);
  if (ok[0]) {
    bls::group::run<G>(Prog::kBody_line0, Prog::kEnd_line0, S, lane, mask, M);
  }
  if constexpr (K == 2) {
    if (ok[1]) {
      bls::group::run<G>(Prog::kBody_line1, Prog::kEnd_line1, S, lane, mask,
                         M);
    }
  }
  // out: f, then per pair T (slots 12 + 12p ..)
  bls::group::store_coords<G>(
      out, n, i, 12 + 6 * K,
      [](int c) { return c < 12 ? c : 12 + 12 * ((c - 12) / 6) + (c - 12) % 6; },
      S, lane);
}

// Replaces _expx_kernel (kernels.py:1446): m^e for the exponent whose runs
// are `segs`, from f = m at its top bit; per segment len Granger-Scott
// squares, then f <- f * m where it ends on a set bit (a uniform branch:
// every thread takes the same one).  Right only for cyclotomic m; the
// caller conjugates for x < 0.  in (12, n), out (12, n).  For |x|: 63
// squares and 5 products, 1,404 Montgomery products: ~50 ns of operations
// against ~0.7 ns of bytes per element.
// On a group of G threads (group.cuh) with ExpXProgram: the input into f,
// the body setup (m = f and m's Karatsuba sum), then per square the body
// square (18 products) and per product the body mul (54).
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    exp_x_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                 long long n, FpModulus M, bls::Segments segs) {
  using Prog = bls::group::ExpXProgram;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(in, n, i, 12, [](int c) { return c; }, S, lane);
  __syncwarp(mask);
  bls::group::run<G>(Prog::kBody_setup, Prog::kEnd_setup, S, lane, mask, M);
  for (int s = 0; s < segs.count; ++s) {
    for (int r = 0; r < segs.len[s]; ++r) {
      bls::group::run<G>(Prog::kBody_square, Prog::kEnd_square, S, lane,
                         mask, M);
    }
    if (segs.mul[s]) {
      bls::group::run<G>(Prog::kBody_mul, Prog::kEnd_mul, S, lane, mask, M);
    }
  }
  bls::group::store_coords<G>(out, n, i, 12, [](int c) { return c; }, S,
                              lane);
}

// ------------------------------------------- the step-wise configuration
// One launch per Miller step or line product.  Like the others they are
// bound by operations (per-kernel bounds below, per element at 16.75 T
// int32 multiply-adds/s against 3.35 TB/s), and run on the group layer as
// the run kernels' line, square, doubling and addition bodies.  What the
// step-wise form costs over the run kernels is launches and device-memory
// round trips of f and T, which is why the default configuration fuses
// them.

// Replaces _mul014_kernel (kernels.py:606): f * (c0 + c1 v + c4 v w).  f
// (12, n) and the line (6, n) = c0, c1, c4 in, through a pointer each (the
// step-wise Miller loop passes T's line as a view of dbl_step's output), f'
// (12, n) out.  No valid mask: the caller passes the neutral line (1, 0, 0)
// for an invalid pair, as the JAX package does, and every element runs its
// products.  45 Montgomery products: ~1.6 ns of operations against ~0.9 ns
// of bytes (30 Fp) per element.
// With Mul014Program (group_rounds.py mul014_program): f into slots 0-11 and
// the line into kSlot_line0 from their own buffers, then the body line0 --
// the Miller programs' f <- f * line (line_bodies): 45 products in one
// phase, then f -- and f out: 45 / G rounds.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    mul014_kernel(const int32_t* __restrict__ f,
                  const int32_t* __restrict__ line, int32_t* __restrict__ out,
                  long long n, FpModulus M) {
  using Prog = bls::group::Mul014Program;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(f, n, i, 12, [](int c) { return c; }, S, lane);
  bls::group::load_coords<G>(
      line, n, i, 6, [](int c) { return Prog::kSlot_line0 + c; }, S, lane);
  __syncwarp(mask);
  bls::group::run<G>(Prog::kBody_line0, Prog::kEnd_line0, S, lane, mask, M);
  bls::group::store_coords<G>(out, n, i, 12, [](int c) { return c; }, S,
                              lane);
}

// Replaces _dblstep_kernel (kernels.py:646): T (6, n) = X, Y, Z and the
// G1 point (2, n) = xp, yp in, through a pointer each; (12, n) = 2T, then
// the line (c0, c1, c4) out (mul014 reads the line as a view of it).  25
// Montgomery products (19 for T, 6 for the line): ~0.9 ns of operations
// against ~0.6 ns of bytes (20 Fp) per element.
// With DblStepProgram (group_rounds.py dbl_step_program): T and p into
// slots 0-7, then the body dbl -- the Miller programs' doubling without
// f^2: [11 products]; [the intermediates and the line's c0]; [14 products,
// c1 and c4 among them]; [T] -- and T, then the line out: 11 / G + 14 / G
// rounds, where the one-thread kernel it replaces ran the 25 products one
// after another.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    dbl_step_kernel(const int32_t* __restrict__ t,
                    const int32_t* __restrict__ p, int32_t* __restrict__ out,
                    long long n, FpModulus M) {
  using Prog = bls::group::DblStepProgram;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(
      t, n, i, 6, [](int c) { return Prog::kSlot_t0 + c; }, S, lane);
  bls::group::load_coords<G>(
      p, n, i, 2, [](int c) { return Prog::kSlot_p0 + c; }, S, lane);
  __syncwarp(mask);
  bls::group::run<G>(Prog::kBody_dbl, Prog::kEnd_dbl, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, 12,
      [](int c) { return c < 6 ? Prog::kSlot_t0 + c : Prog::kSlot_line0 + c - 6; },
      S, lane);
}

// Replaces _addstep_kernel (kernels.py:688): T (6, n) = X, Y, Z, the
// affine Q (4, n) = xq, yq and the G1 point (2, n) = xp, yp in, through a
// pointer each; (12, n) = T + Q, then the line (c0, c1, c4) out.  41
// Montgomery products (31 for T, 10 for the line): ~1.5 ns of operations
// against ~0.7 ns of bytes (24 Fp) per element.
// With MillerAdd1Program (group_rounds.py miller_add_program, one pair):
// T, Q and p into their slots, then the body add -- miller_add's step
// (ops/pairing.py _add_step): [6 products]; [14]; [9]; [the line's c0];
// [12]; [T] -- and T, then the line out: 4 product rounds of at most
// 14 / G where the one-thread kernel it replaces ran the 41 products one
// after another.  The body reads no slot of f, which stays unloaded.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    add_step_kernel(const int32_t* __restrict__ t,
                    const int32_t* __restrict__ q,
                    const int32_t* __restrict__ p, int32_t* __restrict__ out,
                    long long n, FpModulus M) {
  using Prog = bls::group::MillerAdd1Program;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(
      t, n, i, 6, [](int c) { return Prog::kSlot_t0 + c; }, S, lane);
  bls::group::load_coords<G>(
      q, n, i, 4, [](int c) { return Prog::kSlot_q0 + c; }, S, lane);
  bls::group::load_coords<G>(
      p, n, i, 2, [](int c) { return Prog::kSlot_p0 + c; }, S, lane);
  __syncwarp(mask);
  bls::group::run<G>(Prog::kBody_add, Prog::kEnd_add, S, lane, mask, M);
  bls::group::store_coords<G>(
      out, n, i, 12,
      [](int c) { return c < 6 ? Prog::kSlot_t0 + c : Prog::kSlot_line0 + c - 6; },
      S, lane);
}

// Replaces _cyclo_sqr_kernel (kernels.py:1412): `count` Granger-Scott
// squares of f (12, n) in one launch, f' (12, n) out.  The Fp12 is
// coefficient-major as everywhere in the port; the traced square reads the
// Granger-Scott z-ordering from it, so the TPU operand shuffle has no
// counterpart.  A square only for cyclotomic f (the same formula
// otherwise).  18 Montgomery products per square: ~0.64 ns of operations
// per element and square against ~0.7 ns of bytes per launch.
// With CycloSqrProgram (group_rounds.py cyclo_sqr_program): f into slots
// 0-11, then `count` times the body square, exp_x's (18 products in one
// phase, then f in place), and f out: 18 / G rounds per square.
template <int G>
__global__ void __launch_bounds__(bls::group::kThreads)
    cyclo_sqr_kernel(const int32_t* __restrict__ in, int32_t* __restrict__ out,
                     long long n, int count, FpModulus M) {
  using Prog = bls::group::CycloSqrProgram;
  extern __shared__ uint4 smem[];
  const int g = threadIdx.x / G, lane = threadIdx.x % G;
  const long long i =
      (long long)blockIdx.x * bls::group::elements_per_block<Prog, G>() + g;
  if (i >= n) return;  // the whole group: no barrier spans groups
  uint32_t* S = reinterpret_cast<uint32_t*>(smem) +
                (long long)g * Prog::kSlots * bls::kFpWords;
  const unsigned mask = bls::group::lane_mask<G>();
  bls::group::load_coords<G>(in, n, i, 12, [](int c) { return c; }, S, lane);
  __syncwarp(mask);
  for (int r = 0; r < count; ++r) {
    bls::group::run<G>(Prog::kBody_square, Prog::kEnd_square, S, lane, mask,
                       M);
  }
  bls::group::store_coords<G>(out, n, i, 12, [](int c) { return c; }, S,
                              lane);
}

}  // namespace bls_kernels

namespace {

template <int K>
int launch_miller(const int32_t* in, const int32_t* valid, int32_t* out,
                  long long n, int count, const bls::FpModulus& M,
                  cudaStream_t s) {
  using Prog = std::conditional_t<K == 1, bls::group::Miller1Program,
                                  bls::group::Miller2Program>;
  return bls::group::launch<Prog, kGroup>(
      bls_kernels::miller_dbl_run_kernel<K, kGroup>, n, s, in, valid, out, n,
      count, M);
}

}  // namespace

extern "C" {

int bls_fp6_mul(const int32_t* in, int32_t* out, long long n,
                const uint32_t* p, unsigned n0, void* stream) {
  return bls::group::launch<bls::group::Fp6MulProgram, kGroupFp6Mul>(
      bls_kernels::fp6_mul_kernel<kGroupFp6Mul>, n, (cudaStream_t)stream, in,
      out, n, bls::make_modulus<bls::kFpWords>(p, n0));
}

int bls_fp12_mul(const int32_t* in, int32_t* out, long long n,
                 const uint32_t* p, unsigned n0, void* stream) {
  return bls::group::launch<bls::group::Fp12MulProgram, kGroupFp12Mul>(
      bls_kernels::fp12_mul_kernel<kGroupFp12Mul>, n, (cudaStream_t)stream,
      in, out, n, bls::make_modulus<bls::kFpWords>(p, n0));
}

int bls_fp12_sqr(const int32_t* in, int32_t* out, long long n,
                 const uint32_t* p, unsigned n0, void* stream) {
  return bls::group::launch<bls::group::Fp12SqrProgram, kGroupFp12Sqr>(
      bls_kernels::fp12_sqr_kernel<kGroupFp12Sqr>, n, (cudaStream_t)stream,
      in, out, n, bls::make_modulus<bls::kFpWords>(p, n0));
}

int bls_miller_dbl_run(const int32_t* in, const int32_t* valid, int32_t* out,
                       long long n, int k, int count, const uint32_t* p,
                       unsigned n0, void* stream) {
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1) return launch_miller<1>(in, valid, out, n, count, M, s);
  if (k == 2) return launch_miller<2>(in, valid, out, n, count, M, s);
  return (int)cudaErrorInvalidValue;
}

int bls_miller_add(const int32_t* in, const int32_t* valid, int32_t* out,
                   long long n, int k, const uint32_t* p, unsigned n0,
                   void* stream) {
  const auto M = bls::make_modulus<bls::kFpWords>(p, n0);
  const cudaStream_t s = (cudaStream_t)stream;
  if (k == 1) {
    return bls::group::launch<bls::group::MillerAdd1Program, kGroup>(
        bls_kernels::miller_add_kernel<1, kGroup>, n, s, in, valid, out, n, M);
  }
  if (k == 2) {
    return bls::group::launch<bls::group::MillerAdd2Program, kGroup>(
        bls_kernels::miller_add_kernel<2, kGroup>, n, s, in, valid, out, n, M);
  }
  return (int)cudaErrorInvalidValue;
}

int bls_exp_x(const int32_t* in, int32_t* out, long long n, const int* lens,
              const int* muls, int nseg, const uint32_t* p, unsigned n0,
              void* stream) {
  if (nseg < 0 || nseg > bls::kMaxSegments) return (int)cudaErrorInvalidValue;
  bls::Segments segs = {};
  segs.count = nseg;
  for (int s = 0; s < nseg; ++s) {
    segs.len[s] = lens[s];
    segs.mul[s] = muls[s];
  }
  return bls::group::launch<bls::group::ExpXProgram, kGroup>(
      bls_kernels::exp_x_kernel<kGroup>, n, (cudaStream_t)stream, in, out, n,
      bls::make_modulus<bls::kFpWords>(p, n0), segs);
}

int bls_mul014(const int32_t* f, const int32_t* line, int32_t* out,
               long long n, const uint32_t* p, unsigned n0, void* stream) {
  return bls::group::launch<bls::group::Mul014Program, kGroupMul014>(
      bls_kernels::mul014_kernel<kGroupMul014>, n, (cudaStream_t)stream, f,
      line, out, n, bls::make_modulus<bls::kFpWords>(p, n0));
}

int bls_dbl_step(const int32_t* t, const int32_t* pts, int32_t* out,
                 long long n, const uint32_t* p, unsigned n0, void* stream) {
  return bls::group::launch<bls::group::DblStepProgram, kGroupDblStep>(
      bls_kernels::dbl_step_kernel<kGroupDblStep>, n, (cudaStream_t)stream, t,
      pts, out, n, bls::make_modulus<bls::kFpWords>(p, n0));
}

int bls_add_step(const int32_t* t, const int32_t* q, const int32_t* pts,
                 int32_t* out, long long n, const uint32_t* p, unsigned n0,
                 void* stream) {
  return bls::group::launch<bls::group::MillerAdd1Program, kGroupAddStep>(
      bls_kernels::add_step_kernel<kGroupAddStep>, n, (cudaStream_t)stream, t,
      q, pts, out, n, bls::make_modulus<bls::kFpWords>(p, n0));
}

int bls_cyclo_sqr(const int32_t* in, int32_t* out, long long n, int count,
                  const uint32_t* p, unsigned n0, void* stream) {
  if (count < 1) return (int)cudaErrorInvalidValue;
  return bls::group::launch<bls::group::CycloSqrProgram, kGroupCycloSqr>(
      bls_kernels::cyclo_sqr_kernel<kGroupCycloSqr>, n, (cudaStream_t)stream,
      in, out, n, count, bls::make_modulus<bls::kFpWords>(p, n0));
}

}  // extern "C"

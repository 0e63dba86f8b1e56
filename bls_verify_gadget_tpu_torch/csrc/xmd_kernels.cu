// expand_message_xmd with SHA-256 (RFC 9380 sec 5.3.1) for a batch of
// messages of per-element lengths, in one launch from the message bytes to
// the uniform bytes, for Hopper (sm_90a), with a plain C interface loaded
// through ctypes by ops/kernels.py.
//
// What it replaces.  No TPU kernel: the JAX package computes SHA-256
// (bls_verify_gadget_tpu/ops/sha256.py:28-163) and XMD
// (bls_verify_gadget_tpu/ops/hash_to_g2.py:143-212) in jnp, which XLA fuses.
// The port's eager int64 form of the same code (ops/sha256.py and
// ops/hash_to_g2.py xmd_plain, now this kernel's plain version) issued
// ~80,000 elementwise launches per batch of 4096 messages and set the wall
// of verify, sign and aggregate_verify_distinct.
//
// What bounds it.  Operations.  A compression whose state and block differ
// in every word between messages is 1,384 32-bit integer instructions: 64
// rounds of 14 (three funnel shifts and a three-input XOR per Sigma, a LOP3
// each for ch and maj, four three-input adds) and 48 schedule words of 10,
// then 8 adds.  Words that are the same for every message of a length need
// none of their own: each b_i's blocks past its first, and msg' past the
// message, have a schedule that could be computed once (this kernel still
// computes it per thread; each such block costs 904 at the fewest).  A
// 32-byte message with DST_G2 and 256 bytes out runs 18 compressions, of
// which the function needs ~20,000 instructions, and device memory sees
// ~300 bytes of it: at 4096 messages ~8.2e7 operations, ~4.9 us at 132 SMs
// x 64 integer lanes per clock (chip_smoke.py computes the bound from each
// call's lengths).
//
// The design.  One thread per message, its 8-word state and 16-word schedule
// window in registers.  Rounds and schedule are unrolled, so the window is
// indexed by constants only (a runtime index would send it to local memory;
// ptxas must report no stack and no spill).
//   - The first 64 bytes of msg' are Z_pad's zeros whatever the message, so
//     a thread starts b0 from that block's constant midstate: a 32-byte
//     message takes 2 compressions for b0 and 2 for each of b1..b8.
//   - b0's blocks are assembled in registers by the element's own length:
//     byte q of msg' past Z_pad is the message's while q < len, then the
//     table's I2OSP(len_in_bytes, 2) || 0 || DST' || 0x80 || zeros, and the
//     last 8 bytes of the element's final block are the bit length.  Nothing
//     padded is written to device memory.  Elements of a warp with other
//     block counts diverge only at the end of b0's loop.
//   - b_i = H((b0 ^ b_{i-1}) || i || DST') stays in the same thread; all of
//     its blocks past the first 33 bytes are the same for every element and
//     come from the table's padded template.
// The staged table (656 bytes) is the only shared memory.  A round's
// dependent chain (SHF -> LOP3 -> IADD3 -> IADD3) sets the time, and 4096
// messages are 128 warps, fewer than the 132 SMs: blocks of kThreads = 32
// put one warp on each SM, where larger blocks would park the batch on a
// fraction of them (64 and 128 ran within 1.5% of 32 on the H100: PERF.md).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 32;

// Words of the table (ops/hash_to_g2.py xmd_table): b0's bytes past the
// message, I2OSP(len_in_bytes, 2) || 0 || DST' || 0x80 || zeros, in memory
// order, then b_i's padded input as big-endian words, its first 33 bytes
// zero.
constexpr int kExtWords = 84, kTmplWords = 80;
// b0's last block reads up to 72 bytes past the tail (its bit length among them)
constexpr int kMaxTail = 4 * kExtWords - 72;
constexpr int kMaxBlocksB = kTmplWords / 16;  // blocks of a b_i, DST' <= 256 bytes

}  // namespace

namespace bls_kernels {

// SHA-256's round constants and initial state (FIPS 180-4 sec 4.2.2, 5.3.3).
static __constant__ uint32_t kSha256K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208, 0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};
static __constant__ uint32_t kSha256IV[8] = {
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a, 0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
};
// The state after msg''s first block, Z_pad's 64 zero bytes: the
// compression of the initial state with a zero block, the same for every
// message (tests/test_torch_xmd.py recomputes it).
static __constant__ uint32_t kZeroPadMidstate[8] = {
    0xda5698be, 0x17b9b469, 0x62335799, 0x779fbeca, 0x8ce5d491, 0xc0d26243, 0xbafef9ea, 0x1837a9d8,
};

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) { return __funnelshift_r(x, x, n); }

// One SHA-256 compression of the block w into the state s; w is the
// schedule's sliding window, overwritten.
__device__ __forceinline__ void compress(uint32_t (&s)[8], uint32_t (&w)[16]) {
  uint32_t a = s[0], b = s[1], c = s[2], d = s[3], e = s[4], f = s[5], g = s[6], h = s[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) {
      const uint32_t w15 = w[(t - 15) & 15], w2 = w[(t - 2) & 15];
      w[t & 15] += (rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3)) + w[(t - 7) & 15] +
                   (rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10));
    }
    const uint32_t t1 = h + (rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25)) + ((e & f) ^ (~e & g)) +
                        kSha256K[t] + w[t & 15];
    const uint32_t t2 = (rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22)) + ((a & b) | (c & (a | b)));
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  s[0] += a;
  s[1] += b;
  s[2] += c;
  s[3] += d;
  s[4] += e;
  s[5] += f;
  s[6] += g;
  s[7] += h;
}

// Block `blk` (>= 1; block 0 is Z_pad) of one element's padded msg': byte q
// past Z_pad is row[q] while q < len, else ext[q - len]; the final block
// (blk == nb - 1) ends with the 64-bit bit length.
__device__ __forceinline__ void b0_block(uint32_t (&w)[16], const uint8_t* __restrict__ row,
                                         int len, const uint8_t* ext, int blk, int nb,
                                         unsigned long long bits) {
  const int base = (blk - 1) * 64;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    uint32_t word = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = base + 4 * i + j;
      uint32_t byte;
      if (q < len) {
        byte = __ldg(row + q);
      } else {
        byte = ext[q - len];
      }
      word = (word << 8) | byte;
    }
    w[i] = word;
  }
  if (blk == nb - 1) {
    w[14] = (uint32_t)(bits >> 32);
    w[15] = (uint32_t)bits;
  }
}

__device__ __forceinline__ uint32_t bswap(uint32_t x) { return __byte_perm(x, 0, 0x0123); }

// The first `nbytes` (<= 32) bytes of the digest s at dst, big-endian: as
// 16-byte stores where every row and digest starts on a 16-byte boundary
// (vec: len_in_bytes a multiple of 16), else byte by byte.
__device__ __forceinline__ void store_digest(uint8_t* dst, int nbytes, const uint32_t (&s)[8],
                                             bool vec) {
  if (vec) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    d[0] = make_uint4(bswap(s[0]), bswap(s[1]), bswap(s[2]), bswap(s[3]));
    if (nbytes > 16) d[1] = make_uint4(bswap(s[4]), bswap(s[5]), bswap(s[6]), bswap(s[7]));
    return;
  }
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if (k < nbytes) dst[k] = (uint8_t)(s[k / 4] >> (24 - 8 * (k % 4)));
  }
}

// One thread per message: msg (n, width) bytes, lens (n,) or null for
// width each, table as above, out (n, len_in_bytes).
__global__ void __launch_bounds__(kThreads)
    xmd_kernel(const uint8_t* __restrict__ msg, const int32_t* __restrict__ lens, long long n,
               int width, const uint32_t* __restrict__ table, int tlen, int nbi,
               int len_in_bytes, uint8_t* __restrict__ out) {
  __shared__ uint32_t tab[kExtWords + kTmplWords];
  for (int i = threadIdx.x; i < kExtWords + kTmplWords; i += kThreads) tab[i] = table[i];
  __syncthreads();
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= n) return;
  const uint8_t* ext = reinterpret_cast<const uint8_t*>(tab);
  const uint32_t* tmpl = tab + kExtWords;
  const int len = lens ? lens[e] : width;
  const uint8_t* row = msg + e * width;

  // b0 = H(Z_pad || msg || tail), from Z_pad's midstate
  uint32_t b0[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) b0[k] = kZeroPadMidstate[k];
  const long long total = 64LL + len + tlen;
  const int nb = (int)((total + 8) / 64) + 1;
  for (int blk = 1; blk < nb; ++blk) {
    uint32_t w[16];
    b0_block(w, row, len, ext, blk, nb, 8ull * (unsigned long long)total);
    compress(b0, w);
  }

  // b_i = H((b0 ^ b_{i-1}) || i || DST'), b_0 taken as zero
  uint32_t prev[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int ell = (len_in_bytes + 31) / 32;
  const bool vec = (len_in_bytes & 15) == 0;
  uint8_t* dst = out + e * len_in_bytes;
  for (int i = 1; i <= ell; ++i) {
    uint32_t s[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k] = kSha256IV[k];
    for (int blk = 0; blk < nbi; ++blk) {
      uint32_t w[16];
      if (blk == 0) {
#pragma unroll
        for (int k = 0; k < 8; ++k) w[k] = b0[k] ^ prev[k];
        w[8] = ((uint32_t)i << 24) | tmpl[8];
#pragma unroll
        for (int k = 9; k < 16; ++k) w[k] = tmpl[k];
      } else {
#pragma unroll
        for (int k = 0; k < 16; ++k) w[k] = tmpl[16 * blk + k];
      }
      compress(s, w);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) prev[k] = s[k];
    const int done = 32 * (i - 1);
    store_digest(dst + done, min(32, len_in_bytes - done), s, vec);
  }
}

}  // namespace bls_kernels

extern "C" {

// msg (n, width) uint8, lens (n,) int32 in 0..width or null, table the
// (164,) words of ops/hash_to_g2.py xmd_table for this DST and
// len_in_bytes, tlen its tail's length (3 + DST' bytes), nbi the blocks of a
// b_i; out (n, len_in_bytes) uint8.
int bls_xmd(const uint8_t* msg, const int32_t* lens, long long n, int width,
            const uint32_t* table, int tlen, int nbi, int len_in_bytes, uint8_t* out,
            void* stream) {
  if (n < 0 || width < 0 || tlen < 4 || tlen > kMaxTail || nbi < 1 || nbi > kMaxBlocksB ||
      len_in_bytes < 1 || len_in_bytes > 255 * 32) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  bls_kernels::xmd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      msg, lens, n, width, table, tlen, nbi, len_in_bytes, out);
  return (int)cudaGetLastError();
}

}  // extern "C"

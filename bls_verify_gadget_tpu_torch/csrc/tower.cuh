// The words and parameter-bank structs that every kernel unit shares, over
// field.cuh's 32-bit words: the Fp modulus and an Fp (12 words) or Fp2
// value, the packed operands' row width, the runs of a host-constant
// exponent or scalar (Segments: exp_x, the ladders) and its 4-bit windows
// (PowDigits: pow_win, sswu_map2's chains).  The arithmetic itself runs on
// group.cuh (the group kernels) and lanes.cuh (pow_win and the field
// kernels' lane products).
#pragma once

#include "field.cuh"

namespace bls {

constexpr int kFpWords = 12;
using FpModulus = Modulus<kFpWords>;

struct Fp {
  uint32_t w[kFpWords];
};
struct Fp2 {
  Fp c0, c1;
};

// The runs of a host-constant exponent or scalar after its top bit, by
// value in the parameter bank: segment s squares (doubles) len[s] times,
// then multiplies (adds) the base iff mul[s].
constexpr int kMaxSegments = 64;  // runs of a 64-bit exponent
struct Segments {
  int count;
  int len[kMaxSegments];
  int mul[kMaxSegments];
};

constexpr int kMaxDigits = 192;  // 4-bit digits of a 768-bit exponent

// The MSB-first 4-bit digits of a positive host-constant exponent, by
// value in the parameter bank; d[0] (the top digit) is not zero.
struct PowDigits {
  int count;
  unsigned char d[kMaxDigits];
};

// Host side: an Fp from 12 host words (a Montgomery constant).
inline Fp make_fp(const uint32_t* w) {
  Fp r;
  for (int j = 0; j < kFpWords; ++j) r.w[j] = w[j];
  return r;
}

// A packed (c, n, 24) operand's row: coordinate j of batch element i is
// the 24-limb row at ((j * n) + i) * 24.
constexpr int kLimbs = 2 * kFpWords;

}  // namespace bls

// Bit-exact device counterparts of the repro.core multipliers, shared by the
// conv kernels' `recurse` variants (one __device__ function per method of
// repro.core.kcm.METHODS, plus mitchell_ecc{k} with k a runtime argument).
//
// Operands are the non-negative magnitudes |tap| and |coeff| (< 2**nbits,
// nbits <= 16). Every product is carried in uint32_t and returned as the
// int32 bit pattern, which is what the reference's tap_multiplier yields:
// its 16-bit products are uint32 (REFMLM) or wrapping int32 (Mitchell
// family) and are cast with a wrap to int32. For in-range operands no
// intermediate exceeds 2**32, and every comparison (Mitchell's m < lead)
// sees values below 2**31, so signed and unsigned lanes agree.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro {

enum Method : int {
  kExact = 0,
  kRefmlm = 1,      // flattened kom4 digit planes on the error-free 2x2 base
  kRefmlmNc = 2,    // the same on the uncorrected 2x2 Mitchell base
  kMitchell = 3,
  kMitchellEcc = 4, // Babic BB + num_ecc correction stages
  kOdma = 5,
};

// Largest kh or kw a pass accepts; the coefficient table rides by value.
constexpr int kMaxK = 15;
struct Coeffs {
  int32_t v[kMaxK * kMaxK];
};
struct Coeffs1d {
  int32_t v[kMaxK];
};

// Leading-one position by the reference's binary search; 0 for x <= 0.
__device__ __forceinline__ int leading_one(int32_t x) {
  int k = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1) {
    if (x >= (1 << s)) {
      k += s;
      x >>= s;
    }
  }
  return k;
}

__device__ __forceinline__ int32_t mantissa(int32_t x, int k) {
  return x - (x > 0 ? (1 << k) : 0);
}

// Mitchell's algorithm with the case split (repro.core.mitchell.mitchell).
__device__ __forceinline__ uint32_t mitchell(int32_t a, int32_t b) {
  if (a == 0 || b == 0) return 0u;
  const int k1 = leading_one(a), k2 = leading_one(b);
  const uint32_t x1 = static_cast<uint32_t>(mantissa(a, k1));
  const uint32_t x2 = static_cast<uint32_t>(mantissa(b, k2));
  const uint32_t m = (x1 << k2) + (x2 << k1);
  const uint32_t lead = 1u << (k1 + k2);
  return m < lead ? lead + m : 2u * m;
}

// Babic basic block, no case split (repro.core.mitchell.babic_bb).
__device__ __forceinline__ uint32_t babic_bb(int32_t a, int32_t b) {
  if (a == 0 || b == 0) return 0u;
  const int k1 = leading_one(a), k2 = leading_one(b);
  const uint32_t x1 = static_cast<uint32_t>(mantissa(a, k1));
  const uint32_t x2 = static_cast<uint32_t>(mantissa(b, k2));
  return (1u << (k1 + k2)) + (x1 << k2) + (x2 << k1);
}

// BB + num_ecc stages on the mantissa residues (repro.core.mitchell.babic_ecc).
__device__ __forceinline__ uint32_t babic_ecc(int32_t a, int32_t b, int num_ecc) {
  uint32_t total = 0u;
  for (int s = 0; s <= num_ecc; ++s) {
    total += babic_bb(a, b);
    a = mantissa(a, leading_one(a));
    b = mantissa(b, leading_one(b));
  }
  return total;
}

// ODMA: (a&b)*(a|b) + (a&~b)*(~a&b), each by Mitchell (repro.core.odma).
__device__ __forceinline__ uint32_t odma(int32_t a, int32_t b, int nbits) {
  const int32_t mask = (1 << nbits) - 1;
  a &= mask;
  b &= mask;
  return mitchell(a & b, a | b) + mitchell(a & (~b & mask), (~a & mask) & b);
}

// 2x2 Mitchell product on 2-bit operands (repro.core.refmlm.mlm2).
__device__ __forceinline__ int32_t mlm2(int32_t a, int32_t b) {
  const int k1 = (a >> 1) & 1, k2 = (b >> 1) & 1;
  const int32_t x1 = a - (a > 0 ? (1 << k1) : 0);
  const int32_t x2 = b - (b > 0 ? (1 << k2) : 0);
  const int32_t m = (x1 << k2) + (x2 << k1);
  const int32_t lead = 1 << (k1 + k2);
  const int32_t p = m < lead ? lead + m : 2 * m;
  return (a == 0 || b == 0) ? 0 : p;
}

// Error-free 2x2 base: mlm2 plus the a1&a0&b1&b0 correction (eq. 23).
__device__ __forceinline__ int32_t efmlm2(int32_t a, int32_t b) {
  return mlm2(a, b) + ((a >> 1) & a & (b >> 1) & b & 1);
}

// Flattened kom4 REFMLM: the recursion is linear in its 2x2 leaves, and leaf
// (i, j) -- 2-bit digit i of a times digit j of b -- enters with weight
// 4**(i + j). Sums wrap modulo 2**32 like the reference's uint32 lane.
template <bool kCorrected>
__device__ __forceinline__ uint32_t refmlm(int32_t a, int32_t b, int nbits) {
  if (nbits == 2)  // the reference applies the base to unmasked operands
    return static_cast<uint32_t>(kCorrected ? efmlm2(a, b) : mlm2(a, b));
  const int digits = nbits >> 1;
  uint32_t acc = 0u;
  for (int i = 0; i < digits; ++i) {
    const int32_t ai = (a >> (2 * i)) & 3;
    for (int j = 0; j < digits; ++j) {
      const int32_t bj = (b >> (2 * j)) & 3;
      const int32_t p = kCorrected ? efmlm2(ai, bj) : mlm2(ai, bj);
      acc += static_cast<uint32_t>(p) << (2 * (i + j));
    }
  }
  return acc;
}

// mult(|t|, |c|) as repro.core.kcm.tap_multiplier returns it (int32, wrapped).
template <int kMethod>
__device__ __forceinline__ int32_t tap_product(int32_t a, int32_t b, int nbits,
                                               int num_ecc) {
  uint32_t p;
  if constexpr (kMethod == kExact) {
    p = static_cast<uint32_t>(a) * static_cast<uint32_t>(b);
  } else if constexpr (kMethod == kRefmlm) {
    p = refmlm<true>(a, b, nbits);
  } else if constexpr (kMethod == kRefmlmNc) {
    p = refmlm<false>(a, b, nbits);
  } else if constexpr (kMethod == kMitchell) {
    p = mitchell(a, b);
  } else if constexpr (kMethod == kMitchellEcc) {
    p = babic_ecc(a, b, num_ecc);
  } else {
    p = odma(a, b, nbits);
  }
  return static_cast<int32_t>(p);
}

// |x| and sgn(x) of an int32 the way jnp.abs / jnp.sign see it.
__device__ __forceinline__ int32_t magnitude(int32_t x) {
  return static_cast<int32_t>(x < 0 ? 0u - static_cast<uint32_t>(x)
                                    : static_cast<uint32_t>(x));
}
__device__ __forceinline__ int sign_of(int32_t x) { return (x > 0) - (x < 0); }

// sgn * p as a wrapping uint32 term of the int32 accumulator (signed
// overflow is undefined in C++, so every sum is taken in uint32_t).
__device__ __forceinline__ uint32_t signed_term(int s, int32_t p) {
  const uint32_t u = static_cast<uint32_t>(p);
  return s > 0 ? u : (s < 0 ? 0u - u : 0u);
}

// KCM gather: ROM row `tap` at |x|, sign of x applied. Operands beyond the
// ROM are outside the pass's contract (|x| < 2**nbits); they read no memory
// and add nothing, and the plain version does the same.
__device__ __forceinline__ uint32_t kcm_term(const int32_t* rom, int rom_len,
                                             int tap, int32_t x) {
  const uint32_t mag = static_cast<uint32_t>(magnitude(x));
  if (mag == 0u || mag >= static_cast<uint32_t>(rom_len)) return 0u;
  const int32_t p = rom[static_cast<size_t>(tap) * rom_len + mag];
  return x > 0 ? static_cast<uint32_t>(p) : 0u - static_cast<uint32_t>(p);
}

// The reference's apply_post on the int32 sum: post 0 = raw ('none'),
// 1 = 'clip', 2 = 'abs'; then the rounding shift (add wraps like int32,
// the shift is arithmetic) and the clip to 0..255.
__device__ __forceinline__ int32_t apply_post(uint32_t acc_bits, int post, int shift) {
  int32_t acc = static_cast<int32_t>(acc_bits);
  if (post == 0) return acc;
  if (post == 2) acc = magnitude(acc);
  if (shift > 0)
    acc = static_cast<int32_t>(static_cast<uint32_t>(acc) + (1u << (shift - 1))) >> shift;
  return acc < 0 ? 0 : (acc > 255 ? 255 : acc);
}

// Stage an (rows x cols) window of image `img` (h x w) whose top-left pixel
// is (y0, x0) into shared memory, with zeros outside the image: that zero
// fill is the reference's zero padding.
__device__ __forceinline__ void stage_window(int32_t* win, const int32_t* __restrict__ img,
                                             int h, int w, int y0, int x0,
                                             int rows, int cols) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < rows * cols; i += nthreads) {
    const int y = y0 + i / cols, x = x0 + i % cols;
    win[i] = (y >= 0 && y < h && x >= 0 && x < w)
                 ? __ldg(&img[static_cast<size_t>(y) * w + x]) : 0;
  }
}

// Copy `count` int32 ROM entries to shared memory.
__device__ __forceinline__ void stage_rom(int32_t* dst, const int32_t* __restrict__ src,
                                         int count) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < count; i += nthreads) dst[i] = __ldg(&src[i]);
}

}  // namespace repro

// Message for a cudaError_t returned by one of this library's entry points.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

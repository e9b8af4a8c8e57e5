// Bit-exact device counterparts of the repro.core multipliers, shared by the
// conv kernels' `recurse` variants (one __device__ function per method of
// repro.core.kcm.METHODS, plus mitchell_ecc{k} with k a runtime argument),
// and the per-tap plans with which the persistent recurse kernels evaluate
// the same products (the tap policies at the end of this file).
//
// Operands are the non-negative magnitudes |tap| and |coeff| (< 2**nbits,
// nbits <= 16). Every product is carried in uint32_t and returned as the
// int32 bit pattern, which is what the reference's tap_multiplier yields:
// its 16-bit products are uint32 (REFMLM) or wrapping int32 (Mitchell
// family) and are cast with a wrap to int32. The Mitchell family follows
// the reference's int32 lane for any int32 operand, |x| >= 2**30 and
// |-2**31| = -2**31 included: the characteristic of x <= 0 is 0, a shift
// by 32 or more gives 0 (shl32), and the case split compares m and
// 2**(k1+k2) as signed int32.
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

// XLA's int32 x << s: the low 32 bits of x * 2**s, and 0 for s >= 32 (PTX
// shl.b32 clamps the amount; a C++ shift that wide is undefined).
__device__ __forceinline__ uint32_t shl32(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// Mitchell's case split on the int32 values of m and lead.
__device__ __forceinline__ uint32_t case_split(uint32_t m, uint32_t lead) {
  return static_cast<int32_t>(m) < static_cast<int32_t>(lead) ? lead + m : 2u * m;
}

// Mitchell's algorithm with the case split (repro.core.mitchell.mitchell).
__device__ __forceinline__ uint32_t mitchell(int32_t a, int32_t b) {
  if (a == 0 || b == 0) return 0u;
  const int k1 = leading_one(a), k2 = leading_one(b);
  const uint32_t x1 = static_cast<uint32_t>(mantissa(a, k1));
  const uint32_t x2 = static_cast<uint32_t>(mantissa(b, k2));
  return case_split(shl32(x1, k2) + shl32(x2, k1), shl32(1u, k1 + k2));
}

// Babic basic block, no case split (repro.core.mitchell.babic_bb).
__device__ __forceinline__ uint32_t babic_bb(int32_t a, int32_t b) {
  if (a == 0 || b == 0) return 0u;
  const int k1 = leading_one(a), k2 = leading_one(b);
  const uint32_t x1 = static_cast<uint32_t>(mantissa(a, k1));
  const uint32_t x2 = static_cast<uint32_t>(mantissa(b, k2));
  return shl32(1u, k1 + k2) + shl32(x1, k2) + shl32(x2, k1);
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

// KCM gather: ROM row `tap` at |x|, sign of x applied. An operand at or
// past the ROM (|x| >= rom_len, x = -2**31 too) reads no memory and gives
// sgn(x) * fill: the reference's jnp.take fill, the minimum of its narrow
// ROM dtype (-2**15 for an int16 stack, -2**31 for int32). Written as one
// guarded load (0 < |x| < rom_len) and a select, which compiles to a
// predicated load with no branch: faster on the H100 than an early return
// for either case (PERF.md).
__device__ __forceinline__ uint32_t kcm_term(const int32_t* rom, int rom_len,
                                             int tap, int32_t x, int32_t fill) {
  const uint32_t mag = static_cast<uint32_t>(magnitude(x));
  const uint32_t last = static_cast<uint32_t>(rom_len - 1);
  const int32_t entry = mag - 1u < last ? rom[static_cast<size_t>(tap) * rom_len + mag] : 0;
  const int32_t p = mag > last ? fill : entry;
  return x > 0 ? static_cast<uint32_t>(p) : 0u - static_cast<uint32_t>(p);
}

// True, on every lane, when every lane of the warp holds an operand below
// `len`. Every lane of the warp calls it.
__device__ __forceinline__ bool warp_below(uint32_t mag, int len) {
  return __all_sync(0xffffffffu, mag < static_cast<uint32_t>(len));
}

// The reference's int16 carry (a direct kcm pass whose ROM bound is below
// 2**15): the low 16 bits of the wrapping sum, sign-extended; the sum of
// wrapping int16 adds is the same modulo 2**16. carry_bits 32: unchanged.
__device__ __forceinline__ uint32_t narrow_carry(uint32_t acc, int carry_bits) {
  return carry_bits == 16
             ? static_cast<uint32_t>(static_cast<int32_t>(static_cast<int16_t>(acc & 0xffffu)))
             : acc;
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

// ------------------------------------------------------ per-tap plans
//
// The persistent recurse kernels take the coefficient side of every tap
// product from a plan built once on the host
// (repro_torch.filters.recurse_plan, whose docstring defines the words), so
// a tap costs only its pixel-side work. Each window element is split once
// per tap column (its digits, or its leading one and mantissa) and reused
// for the KH taps of that column. The products are those of tap_product
// above, bit for bit.

constexpr int kPlanSlots = 16;                    // recurse_plan.SLOTS
constexpr int kPlanWords = 2 + 2 * kPlanSlots;    // recurse_plan.WORDS

// The plan of up to T taps, a kernel parameter: per tap the signed
// coefficient, the count of live entries and their words a, b.
template <int T>
struct TapPlan {
  int32_t coeff[T];
  int32_t count[T];
  uint32_t a[T][kPlanSlots];
  uint32_t b[T][kPlanSlots];
};

// Fill `plan` from `taps` taps of host words; false if they do not fit.
// -> the largest count (the stage loop's bound of the staged policy).
template <int T>
inline bool load_plan(TapPlan<T>& plan, int& max_count, const int32_t* words, int taps) {
  if (words == nullptr || taps < 1 || taps > T) return false;
  plan = TapPlan<T>{};
  max_count = 0;
  for (int t = 0; t < taps; ++t) {
    const int32_t* tw = words + t * kPlanWords;
    plan.coeff[t] = tw[0];
    plan.count[t] = tw[1];
    if (tw[1] < 0 || tw[1] > kPlanSlots) return false;
    max_count = tw[1] > max_count ? tw[1] : max_count;
    for (int k = 0; k < kPlanSlots; ++k) {
      plan.a[t][k] = static_cast<uint32_t>(tw[2 + k]);
      plan.b[t][k] = static_cast<uint32_t>(tw[2 + kPlanSlots + k]);
    }
  }
  return true;
}

// leading_one by the count-leading-zeros instruction: the same value for
// every int32 (0 for x <= 0).
__device__ __forceinline__ int msb(int32_t x) { return x > 0 ? 31 - __clz(x) : 0; }

// mitchell() with msb(): the same products.
__device__ __forceinline__ uint32_t mitchell_msb(int32_t a, int32_t b) {
  if (a == 0 || b == 0) return 0u;
  const int k1 = msb(a), k2 = msb(b);
  const uint32_t x1 = static_cast<uint32_t>(mantissa(a, k1));
  const uint32_t x2 = static_cast<uint32_t>(mantissa(b, k2));
  return case_split(shl32(x1, k2) + shl32(x2, k1), shl32(1u, k1 + k2));
}

// 0 or ~0: the sign of x. with_sign(p, m) is p, or -p for m = ~0.
__device__ __forceinline__ uint32_t sign_mask(int32_t x) {
  return static_cast<uint32_t>(x >> 31);
}
__device__ __forceinline__ uint32_t with_sign(uint32_t p, uint32_t m) { return (p ^ m) - m; }

// A tap policy: Elem split(t, mask), the pixel side of window element t
// (`mask` is 2**nbits - 1); either term(elem, plan, tap), the signed term
// sgn(t) sgn(c) mult(|t|, |c|) of a live tap as a wrapping uint32, or, for
// the REFMLM policies (kDigits), leaves(word, elem), the weight-1 sum of one
// coefficient digit's leaves, the digit loop then running once for a
// column of rows; a staged policy (kStaged) splits per stage instead (see
// recurse_rows). kChunk: rows whose elements a thread holds at once (0:
// one element at a time, see element_rows), each the fastest of 4, 8, 16,
// 32 and 0 in timings on the H100 (PERF.md); Base2Taps, off the
// bank's path, takes 4 as MitchellTaps does.

// exact: t * c is sgn(t) sgn(c) |t| |c| modulo 2**32.
struct ExactTaps {
  static constexpr bool kStaged = false, kDigits = false, kRefmlm = false;
  static constexpr int kChunk = 16;
  using Elem = int32_t;
  __device__ static Elem split(int32_t t, uint32_t) { return t; }
  template <int T>
  __device__ static uint32_t term(const Elem& t, const TapPlan<T>& plan, int tap) {
    return static_cast<uint32_t>(t) * static_cast<uint32_t>(plan.coeff[tap]);
  }
};

// REFMLM, packed truth tables: the pixel's D digits as byte selectors; for
// a non-zero coefficient digit c_j (entry k: a = row bytes base(v, c_j),
// b = 2j) every leaf is one byte permute and one shifted add. D = 4 serves
// nbits 4 and 8 (digits past nbits/2 are masked to 0, and base(0, c) = 0),
// D = 8 nbits 16.
template <int D>
struct TableTaps {
  static constexpr bool kStaged = false, kDigits = true, kRefmlm = true;
  static constexpr int kChunk = D <= 4 ? 8 : 0;
  struct Elem {
    uint32_t sign;
    uint32_t sel[D];
  };
  __device__ static Elem split(int32_t t, uint32_t mask) {
    Elem e;
    e.sign = sign_mask(t);
    const uint32_t a = static_cast<uint32_t>(magnitude(t)) & mask;
#pragma unroll
    for (int i = 0; i < D; ++i) e.sel[i] = ((a >> (2 * i)) & 3u) | 0x4440u;
    return e;
  }
  __device__ static uint32_t leaves(uint32_t row, const Elem& e) {
    uint32_t sum = 0u;
#pragma unroll
    for (int i = 0; i < D; ++i) sum += __byte_perm(row, 0u, e.sel[i]) << (2 * i);
    return sum;
  }
};

// REFMLM at nbits == 2: the base on the unmasked operands, as refmlm()
// applies it; the plan holds (k2, x2) of |c| and the correction bit a[1].
struct Base2Taps {
  static constexpr bool kStaged = false, kDigits = false, kRefmlm = true;
  static constexpr int kChunk = 4;
  struct Elem {
    uint32_t sign;
    int32_t a, k1, x1, a11;
  };
  __device__ static Elem split(int32_t t, uint32_t) {
    Elem e;
    e.sign = sign_mask(t);
    e.a = magnitude(t);
    e.k1 = (e.a >> 1) & 1;
    e.x1 = e.a - (e.a > 0 ? (1 << e.k1) : 0);
    e.a11 = (e.a >> 1) & e.a & 1;
    return e;
  }
  template <int T>
  __device__ static uint32_t term(const Elem& e, const TapPlan<T>& plan, int tap) {
    const int32_t k2 = static_cast<int32_t>(plan.a[tap][0]);
    const int32_t x2 = static_cast<int32_t>(plan.b[tap][0]);
    const int32_t m = (e.x1 << k2) + (x2 << e.k1);
    const int32_t lead = 1 << (e.k1 + k2);
    int32_t p = m < lead ? lead + m : 2 * m;
    p = (e.a == 0 ? 0 : p) + (e.a11 & static_cast<int32_t>(plan.a[tap][1]));
    return with_sign(static_cast<uint32_t>(p), e.sign ^ sign_mask(plan.coeff[tap]));
  }
};

// Mitchell with the case split; the plan holds (k2, x2) of |c|.
struct MitchellTaps {
  static constexpr bool kStaged = false, kDigits = false, kRefmlm = false;
  static constexpr int kChunk = 4;
  struct Elem {
    uint32_t sign, nz, x1;
    int k1;
  };
  __device__ static Elem split(int32_t t, uint32_t) {
    Elem e;
    e.sign = sign_mask(t);
    const int32_t a = magnitude(t);
    e.k1 = msb(a);
    e.x1 = static_cast<uint32_t>(mantissa(a, e.k1));
    e.nz = a != 0 ? ~0u : 0u;
    return e;
  }
  template <int T>
  __device__ static uint32_t term(const Elem& e, const TapPlan<T>& plan, int tap) {
    const uint32_t k2 = plan.a[tap][0], x2 = plan.b[tap][0];
    const uint32_t p = case_split(shl32(e.x1, k2) + shl32(x2, e.k1), shl32(1u, e.k1 + k2)) & e.nz;
    return with_sign(p, e.sign ^ sign_mask(plan.coeff[tap]));
  }
};

// Babic BB + num_ecc stages, staged: the pixel's residue advances one stage
// at a time and each stage is applied to every tap whose coefficient chain
// reaches it (entry s: k2, x2 of the coefficient's stage s).
struct EccTaps {
  static constexpr bool kStaged = true, kDigits = false, kRefmlm = false;
  static constexpr int kChunk = 8;
  struct Elem {
    uint32_t sign;
    int32_t r;
  };
  struct Part {
    uint32_t x, nz;
    int k;
  };
  __device__ static Elem split(int32_t t, uint32_t) { return {sign_mask(t), magnitude(t)}; }
  __device__ static Part stage(Elem& e) {
    Part p;
    p.k = msb(e.r);
    const int32_t x = mantissa(e.r, p.k);
    p.x = static_cast<uint32_t>(x);
    p.nz = e.r != 0 ? ~0u : 0u;
    e.r = x;
    return p;
  }
  // Stage s of a tap whose chain reaches it.
  template <int T>
  __device__ static uint32_t term(const Part& p, uint32_t sign, const TapPlan<T>& plan,
                                  int tap, int s) {
    const uint32_t k2 = plan.a[tap][s], x2 = plan.b[tap][s];
    const uint32_t bb = (shl32(1u, p.k + k2) + shl32(p.x, k2) + shl32(x2, p.k)) & p.nz;
    return with_sign(bb, sign ^ sign_mask(plan.coeff[tap]));
  }
};

// ODMA: its sub-products pair pixel and coefficient bits, so only the masks
// are hoisted (the plan holds b = |c| & mask and ~b & mask).
struct OdmaTaps {
  static constexpr bool kStaged = false, kDigits = false, kRefmlm = false;
  static constexpr int kChunk = 16;
  struct Elem {
    uint32_t sign;
    int32_t a, na;
  };
  __device__ static Elem split(int32_t t, uint32_t mask) {
    const int32_t a = magnitude(t) & static_cast<int32_t>(mask);
    return {sign_mask(t), a, ~a & static_cast<int32_t>(mask)};
  }
  template <int T>
  __device__ static uint32_t term(const Elem& e, const TapPlan<T>& plan, int tap) {
    const int32_t b = static_cast<int32_t>(plan.a[tap][0]);
    const int32_t nb = static_cast<int32_t>(plan.b[tap][0]);
    const uint32_t p = mitchell_msb(e.a & b, e.a | b) + mitchell_msb(e.a & nb, e.na & b);
    return with_sign(p, e.sign ^ sign_mask(plan.coeff[tap]));
  }
};

// The signed terms of tap `tap` for RC consecutive output rows, whose
// elements are e[di .. di + RC): a tap with no live entry adds nothing; the
// REFMLM policies run the coefficient's digit loop once for all RC rows.
template <class Taps, int RC, int N, int T>
__device__ __forceinline__ void tap_column(uint32_t (&out)[RC],
                                           const typename Taps::Elem (&e)[N], int di,
                                           const TapPlan<T>& plan, int tap) {
  const int count = plan.count[tap];
  if constexpr (Taps::kDigits) {
    uint32_t p[RC] = {};
#pragma unroll 1
    for (int k = 0; k < count; ++k) {
      const uint32_t word = plan.a[tap][k], shift = plan.b[tap][k];
#pragma unroll
      for (int i = 0; i < RC; ++i) p[i] += Taps::leaves(word, e[i + di]) << shift;
    }
    const uint32_t mc = sign_mask(plan.coeff[tap]);
#pragma unroll
    for (int i = 0; i < RC; ++i) out[i] = with_sign(p[i], e[i + di].sign ^ mc);
  } else {
#pragma unroll
    for (int i = 0; i < RC; ++i) out[i] = count ? Taps::term(e[i + di], plan, tap) : 0u;
  }
}

// Output rows [R0, R) of a thread's R sums for a KH x KW tap shape, its
// first output row at window row 0 of `win` (row stride `cols`), Taps::kChunk
// rows at a time: for each tap column the chunk's RC + KH - 1 window
// elements are split once and held in registers, then every tap of the
// column adds its terms for the RC rows. Every loop over taps and rows
// unrolls. `stages` bounds a staged policy's stage loop (the plan's largest
// count).
template <int KH, int KW, int R, int R0, class Taps, int T>
__device__ __forceinline__ void recurse_chunk(uint32_t (&acc)[R], const int32_t* win, int cols,
                                              const TapPlan<T>& plan, uint32_t mask,
                                              int stages) {
  if constexpr (R0 < R) {
    constexpr int RC = R - R0 < Taps::kChunk ? R - R0 : Taps::kChunk;
    constexpr int N = RC + KH - 1;
#pragma unroll
    for (int dj = 0; dj < KW; ++dj) {
      typename Taps::Elem e[N];
#pragma unroll
      for (int r = 0; r < N; ++r) e[r] = Taps::split(win[(R0 + r) * cols + dj], mask);
      if constexpr (Taps::kStaged) {
#pragma unroll 1
        for (int s = 0; s < stages; ++s) {
          typename Taps::Part part[N];
#pragma unroll
          for (int r = 0; r < N; ++r) part[r] = Taps::stage(e[r]);
#pragma unroll
          for (int di = 0; di < KH; ++di) {
            const int tap = di * KW + dj;
            if (s < plan.count[tap]) {
#pragma unroll
              for (int i = 0; i < RC; ++i)
                acc[R0 + i] += Taps::term(part[i + di], e[i + di].sign, plan, tap, s);
            }
          }
        }
      } else {
#pragma unroll
        for (int di = 0; di < KH; ++di) {
          uint32_t terms[RC];
          tap_column<Taps>(terms, e, di, plan, di * KW + dj);
#pragma unroll
          for (int i = 0; i < RC; ++i) acc[R0 + i] += terms[i];
        }
      }
    }
    recurse_chunk<KH, KW, R, R0 + RC, Taps>(acc, win, cols, plan, mask, stages);
  }
}

// The R sums of one thread for a KH x KW tap shape, one window element at a
// time (kChunk 0): window row wr holds tap row wr - i of output row i, so
// each element is split once per tap column and its terms go to the rows
// that read it. Fewer registers than recurse_chunk; the REFMLM digit loop
// then runs once per element and tap.
template <int KH, int KW, int R, class Taps, int T>
__device__ __forceinline__ void element_rows(uint32_t (&acc)[R], const int32_t* win, int cols,
                                             const TapPlan<T>& plan, uint32_t mask) {
  static_assert(!Taps::kStaged, "a staged policy runs in chunks");
#pragma unroll
  for (int wr = 0; wr < R + KH - 1; ++wr) {
#pragma unroll
    for (int dj = 0; dj < KW; ++dj) {
      const typename Taps::Elem e[1] = {Taps::split(win[wr * cols + dj], mask)};
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int di = wr - i;
        if (di >= 0 && di < KH) {
          uint32_t term[1];
          tap_column<Taps>(term, e, 0, plan, di * KW + dj);
          acc[i] += term[0];
        }
      }
    }
  }
}

// The R sums of one thread for a KH x KW tap shape, by the policy's layout.
template <int KH, int KW, int R, class Taps, int T>
__device__ __forceinline__ void recurse_rows(uint32_t (&acc)[R], const int32_t* win, int cols,
                                             const TapPlan<T>& plan, uint32_t mask,
                                             int stages) {
  if constexpr (Taps::kChunk == 0)
    element_rows<KH, KW, R, Taps>(acc, win, cols, plan, mask);
  else
    recurse_chunk<KH, KW, R, 0, Taps>(acc, win, cols, plan, mask, stages);
}

// Host dispatch from (method, nbits) to a tap policy: f(Tag<Policy>{}).
template <class P>
struct Tag {
  using type = P;
};

template <class F>
int refmlm_taps(int nbits, F&& f) {
  if (nbits == 2) return f(Tag<Base2Taps>{});
  if (nbits <= 8) return f(Tag<TableTaps<4>>{});
  return f(Tag<TableTaps<8>>{});
}

template <class F>
int method_taps(int method, int nbits, F&& f) {
  switch (method) {
    case kExact: return f(Tag<ExactTaps>{});
    case kRefmlm:
    case kRefmlmNc: return refmlm_taps(nbits, f);
    case kMitchell: return f(Tag<MitchellTaps>{});
    case kMitchellEcc: return f(Tag<EccTaps>{});
    case kOdma: return f(Tag<OdmaTaps>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// A tap policy with its kChunk replaced by C: the chunk menu the tuner
// sweeps (repro_torch.tuning.autotune), the same products at any chunk.
template <class Taps, int C>
struct Chunked : Taps {
  static constexpr int kChunk = C;
};

// f(Tag<Taps>{}) for chunk -1 (the policy's own) or Taps::kChunk; where
// kSwept, f(Tag<Chunked<Taps, C>>{}) for any other C of 0, 4, 8 and 16;
// any other chunk is refused.
template <class Taps, bool kSwept, class F>
int with_chunk(int chunk, F&& f) {
  if (chunk == -1 || chunk == Taps::kChunk) return f(Tag<Taps>{});
  if constexpr (kSwept) {
    if constexpr (Taps::kChunk != 0) {
      if (chunk == 0) return f(Tag<Chunked<Taps, 0>>{});
    }
    if constexpr (Taps::kChunk != 4) {
      if (chunk == 4) return f(Tag<Chunked<Taps, 4>>{});
    }
    if constexpr (Taps::kChunk != 8) {
      if (chunk == 8) return f(Tag<Chunked<Taps, 8>>{});
    }
    if constexpr (Taps::kChunk != 16) {
      if (chunk == 16) return f(Tag<Chunked<Taps, 16>>{});
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace repro

// Message for a cudaError_t returned by one of this library's entry points.
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

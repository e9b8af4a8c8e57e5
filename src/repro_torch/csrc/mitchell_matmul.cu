// Signed-magnitude LNS (Mitchell-family) matmul on int32 operands:
//   out[m, n] = sum over k of sgn(a[m,k]) * sgn(b[k,n]) * P(|a[m,k]|, |b[k,n]|)
// with a wrapping int32 sum. P is Mitchell's algorithm with its case split
// (num_ecc = 0, case_split = 1) or the Babic basic block plus num_ecc
// error-correction stages (case_split = 0); both are run-time arguments.
//
// Replaces the Pallas kernel `mitchell_matmul_kernel`
// (src/repro/kernels/mitchell_matmul.py:141; body `_signed_block_product`,
// :57, leading-one detector `_clz_k`, :42). The TPU grid arguments
// block_m/block_n/block_k and accum have no counterpart: the K reduction is a
// loop inside the block, and the kernel masks the ragged M/N/K edges itself
// (the zeros it stages there add 0 to every sum).
//
// Bit-exact for every int32 input, with XLA's integer semantics: |x| is
// jnp.abs (|INT_MIN| stays INT_MIN), the leading-one detector finds nothing
// below 1, every sum and product wraps modulo 2**32 (carried in uint32_t,
// since signed overflow is undefined in C++), Mitchell's m < lead compares
// as int32, and a left shift by 32 or more gives 0 (PTX shl.b32 clamps the
// amount; a C++ shift that wide is undefined). Operands of the reference's
// datapath are below 2**16, where no shift reaches 32 bits.
//
// What bounds it on an H100: integer operations. The method is free of
// multiplies by design, so it runs on the CUDA cores, not the tensor cores:
// about 6 operations a product for each stage (the exponent add, three
// shifts, two adds), 3 more for the case split and 2 for the sign and the
// accumulate, against 132 SMs x 64 INT32 lanes a clock. Bytes are small
// beside that (a K-step tile of A and B serves 64 x 64 outputs).
//
// Design: a 16 x 16 thread block owns a 64 x 64 output tile, 4 x 4 outputs a
// thread (rows ty + 16i, columns tx + 16j, so shared-memory reads broadcast
// or fall on distinct banks and the stores coalesce). Over a K loop the
// block stages a 64 x 32 tile of A and a 32 x 64 tile of B in shared memory.
// Every value a product needs that depends on one operand only (its
// magnitude, and each stage's characteristic and mantissa residue) is formed
// once per operand and reused across the thread's 4 columns or 4 rows; the
// per-stage product totals and the int32 accumulators stay in registers.
#include "multipliers.cuh"

namespace repro {
namespace {

constexpr int kThreadsX = 16, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMicro = 4;
constexpr int kTileM = kThreadsY * kMicro;
constexpr int kTileN = kThreadsX * kMicro;
constexpr int kTileK = 32;

// x << s with XLA's semantics: 0 once s >= 32.
__device__ __forceinline__ uint32_t shl(uint32_t x, uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(x), "r"(s));
  return r;
}

// The characteristic of a stage operand r: floor(log2 r) for r > 0 and 0 for
// r < 0 (the reference's LOD), and 32 for r == 0, which makes every shift of
// the stage product give 0 and so the product 0 -- the reference's zero mask.
__device__ __forceinline__ uint32_t stage_k(int32_t r) {
  return r > 0 ? 31u - static_cast<uint32_t>(__clz(r)) : (r == 0 ? 32u : 0u);
}

// r - 2**k for r > 0, else r: the mantissa, which is the next stage's operand.
__device__ __forceinline__ int32_t stage_x(int32_t r, uint32_t k) {
  return r > 0 ? r - (1 << k) : r;
}

// Adds sgn(a) sgn(b) P(|a|, |b|) for the thread's 4 x 4 (a, b) pairs.
template <bool kCaseSplit>
__device__ __forceinline__ void accumulate(const int32_t (&av)[kMicro],
                                           const int32_t (&bv)[kMicro],
                                           int num_ecc,
                                           uint32_t (&acc)[kMicro][kMicro]) {
  int32_t ra[kMicro], rb[kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i) ra[i] = magnitude(av[i]);
#pragma unroll
  for (int j = 0; j < kMicro; ++j) rb[j] = magnitude(bv[j]);
  uint32_t tot[kMicro][kMicro] = {};
  for (int s = 0; s <= num_ecc; ++s) {
    uint32_t ka[kMicro], kb[kMicro];
    int32_t xa[kMicro], xb[kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      ka[i] = stage_k(ra[i]);
      xa[i] = stage_x(ra[i], ka[i]);
    }
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      kb[j] = stage_k(rb[j]);
      xb[j] = stage_x(rb[j], kb[j]);
    }
    const bool split = kCaseSplit && s == num_ecc;
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const uint32_t m = shl(static_cast<uint32_t>(xa[i]), kb[j])
                         + shl(static_cast<uint32_t>(xb[j]), ka[i]);
        const uint32_t lead = shl(1u, ka[i] + kb[j]);
        // Mitchell's case split compares as int32: lead + m if m < lead, else 2m.
        const bool carry = split && static_cast<int32_t>(m) >= static_cast<int32_t>(lead);
        tot[i][j] += carry ? 2u * m : lead + m;
      }
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) ra[i] = xa[i];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) rb[j] = xb[j];
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      // sgn(a) sgn(b) is -1 exactly when the sign bits differ and neither is
      // 0; a zero operand has a zero total, so the xor's sign bit suffices.
      const uint32_t neg = static_cast<uint32_t>((av[i] ^ bv[j]) >> 31);
      acc[i][j] += (tot[i][j] ^ neg) - neg;
    }
  }
}

template <bool kCaseSplit>
__global__ void __launch_bounds__(kThreads)
mitchell_matmul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                       int32_t* __restrict__ out, int m, int k, int n, int num_ecc) {
  __shared__ int32_t as[kTileM][kTileK + 1];
  __shared__ int32_t bs[kTileK][kTileN];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kThreadsX + tx;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  uint32_t acc[kMicro][kMicro] = {};
  for (int k0 = 0; k0 < k; k0 += kTileK) {
    for (int i = tid; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK, c = i % kTileK;
      const int gm = m0 + r, gk = k0 + c;
      as[r][c] = (gm < m && gk < k) ? __ldg(&a[static_cast<size_t>(gm) * k + gk]) : 0;
    }
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int r = i / kTileN, c = i % kTileN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < k && gn < n) ? __ldg(&b[static_cast<size_t>(gk) * n + gn]) : 0;
    }
    __syncthreads();
    const int steps = min(kTileK, k - k0);
    for (int kk = 0; kk < steps; ++kk) {
      int32_t av[kMicro], bv[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) av[i] = as[ty + kThreadsY * i][kk];
#pragma unroll
      for (int j = 0; j < kMicro; ++j) bv[j] = bs[kk][tx + kThreadsX * j];
      accumulate<kCaseSplit>(av, bv, num_ecc, acc);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gm = m0 + ty + kThreadsY * i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gn = n0 + tx + kThreadsX * j;
      if (gn < n) out[static_cast<size_t>(gm) * n + gn] = static_cast<int32_t>(acc[i][j]);
    }
  }
}

}  // namespace
}  // namespace repro

// a: device (m, k) int32, b: device (k, n) int32, out: device (m, n) int32,
// all row-major and contiguous. Returns cudaGetLastError() after the launch.
extern "C" int mitchell_matmul(const int32_t* a, const int32_t* b, int32_t* out,
                               int m, int k, int n, int num_ecc, int case_split,
                               cudaStream_t stream) {
  using namespace repro;
  if (m < 1 || n < 1 || k < 0 || num_ecc < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kThreadsY);
  if (case_split)
    mitchell_matmul_kernel<true><<<grid, block, 0, stream>>>(a, b, out, m, k, n, num_ecc);
  else
    mitchell_matmul_kernel<false><<<grid, block, 0, stream>>>(a, b, out, m, k, n, num_ecc);
  return static_cast<int>(cudaGetLastError());
}

// Limb-decomposed wide-integer matmul: the three int32 partial matmuls of
// balanced limbs a = a_hi * 2^w + a_lo, b = b_hi * 2^w + b_lo:
//   hh  = a_hi @ b_hi,   ll = a_lo @ b_lo,
//   mid = (a_hi + a_lo) @ (b_hi + b_lo) - hh - ll       (karatsuba = 1, 3 products)
//   mid = a_hi @ b_lo + a_lo @ b_hi                     (karatsuba = 0, 4 products)
// with every sum wrapping like int32 (carried in uint32_t, since signed
// overflow is undefined in C++), so the outputs are bit-identical to the
// reference's for any int32 limbs, not only int8-valued ones.
//
// Replaces the Pallas kernel `karatsuba_matmul_kernel`
// (src/repro/kernels/karatsuba_matmul.py:122; body `_block_products`, :42).
// The TPU grid arguments block_m/block_n/block_k and accum have no
// counterpart: the K reduction is a loop inside the block, and the kernel
// masks the ragged M/N/K edges itself (the zeros it stages there add 0).
// The Karatsuba middle product is accumulated whole and hh and ll are taken
// off once at the end: modulo 2**32 that equals the reference's per-K-block
// subtraction.
//
// What bounds it on an H100: on int8 tensor cores the work (3 or 4 passes of
// 2*M*K*N int8 operations) would take less time than the bytes (four int32
// limb arrays in, three int32 arrays out), so the bound is bytes. This first
// kernel runs on the CUDA cores (one 32-bit multiply-add per partial product
// on the 64 INT32 lanes of each SM), so it is far from that bound; int8
// mma/wgmma is later work and needs the limbs range-checked to int8 first.
//
// Design: a 16 x 16 thread block owns a 64 x 64 output tile, 4 x 4 outputs a
// thread (rows ty + 16i, columns tx + 16j). Over a K loop it stages 64 x 32
// tiles of both A limbs and 32 x 64 tiles of both B limbs in shared memory,
// each loaded from device memory once per block, and keeps the three int32
// accumulators of its 16 outputs in registers.
#include "multipliers.cuh"

namespace repro {
namespace {

constexpr int kThreadsX = 16, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMicro = 4;
constexpr int kTileM = kThreadsY * kMicro;
constexpr int kTileN = kThreadsX * kMicro;
constexpr int kTileK = 32;

// Stage a (kTileM x kTileK) tile of a row-major (m, k) matrix, zeros outside.
__device__ __forceinline__ void stage_a(int32_t (*dst)[kTileK + 1],
                                       const int32_t* __restrict__ src,
                                       int m0, int k0, int m, int k, int tid) {
  for (int i = tid; i < kTileM * kTileK; i += kThreads) {
    const int r = i / kTileK, c = i % kTileK;
    const int gm = m0 + r, gk = k0 + c;
    dst[r][c] = (gm < m && gk < k) ? __ldg(&src[static_cast<size_t>(gm) * k + gk]) : 0;
  }
}

// Stage a (kTileK x kTileN) tile of a row-major (k, n) matrix, zeros outside.
__device__ __forceinline__ void stage_b(int32_t (*dst)[kTileN],
                                       const int32_t* __restrict__ src,
                                       int k0, int n0, int k, int n, int tid) {
  for (int i = tid; i < kTileK * kTileN; i += kThreads) {
    const int r = i / kTileN, c = i % kTileN;
    const int gk = k0 + r, gn = n0 + c;
    dst[r][c] = (gk < k && gn < n) ? __ldg(&src[static_cast<size_t>(gk) * n + gn]) : 0;
  }
}

template <bool kKaratsuba>
__global__ void __launch_bounds__(kThreads)
karatsuba_matmul_kernel(const int32_t* __restrict__ a_hi, const int32_t* __restrict__ a_lo,
                        const int32_t* __restrict__ b_hi, const int32_t* __restrict__ b_lo,
                        int32_t* __restrict__ hh, int32_t* __restrict__ mid,
                        int32_t* __restrict__ ll, int m, int k, int n) {
  __shared__ int32_t ahs[kTileM][kTileK + 1], als[kTileM][kTileK + 1];
  __shared__ int32_t bhs[kTileK][kTileN], bls[kTileK][kTileN];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kThreadsX + tx;
  const int m0 = blockIdx.x * kTileM, n0 = blockIdx.y * kTileN;
  uint32_t acc_hh[kMicro][kMicro] = {}, acc_mid[kMicro][kMicro] = {},
           acc_ll[kMicro][kMicro] = {};
  for (int k0 = 0; k0 < k; k0 += kTileK) {
    stage_a(ahs, a_hi, m0, k0, m, k, tid);
    stage_a(als, a_lo, m0, k0, m, k, tid);
    stage_b(bhs, b_hi, k0, n0, k, n, tid);
    stage_b(bls, b_lo, k0, n0, k, n, tid);
    __syncthreads();
    const int steps = min(kTileK, k - k0);
    for (int kk = 0; kk < steps; ++kk) {
      uint32_t ah[kMicro], al[kMicro], bh[kMicro], bl[kMicro];
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
        ah[i] = static_cast<uint32_t>(ahs[ty + kThreadsY * i][kk]);
        al[i] = static_cast<uint32_t>(als[ty + kThreadsY * i][kk]);
      }
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        bh[j] = static_cast<uint32_t>(bhs[kk][tx + kThreadsX * j]);
        bl[j] = static_cast<uint32_t>(bls[kk][tx + kThreadsX * j]);
      }
#pragma unroll
      for (int i = 0; i < kMicro; ++i) {
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
          acc_hh[i][j] += ah[i] * bh[j];
          acc_ll[i][j] += al[i] * bl[j];
          if constexpr (kKaratsuba)
            acc_mid[i][j] += (ah[i] + al[i]) * (bh[j] + bl[j]);
          else
            acc_mid[i][j] += ah[i] * bl[j] + al[i] * bh[j];
        }
      }
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
      if (gn >= n) continue;
      const size_t o = static_cast<size_t>(gm) * n + gn;
      uint32_t cross = acc_mid[i][j];
      if constexpr (kKaratsuba) cross -= acc_hh[i][j] + acc_ll[i][j];
      hh[o] = static_cast<int32_t>(acc_hh[i][j]);
      mid[o] = static_cast<int32_t>(cross);
      ll[o] = static_cast<int32_t>(acc_ll[i][j]);
    }
  }
}

}  // namespace
}  // namespace repro

// a_hi, a_lo: device (m, k) int32; b_hi, b_lo: device (k, n) int32;
// hh, mid, ll: device (m, n) int32; all row-major and contiguous.
// Returns cudaGetLastError() after the launch.
extern "C" int karatsuba_matmul(const int32_t* a_hi, const int32_t* a_lo,
                                const int32_t* b_hi, const int32_t* b_lo,
                                int32_t* hh, int32_t* mid, int32_t* ll,
                                int m, int k, int n, int karatsuba,
                                cudaStream_t stream) {
  using namespace repro;
  if (m < 1 || n < 1 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(kThreadsX, kThreadsY);
  if (karatsuba)
    karatsuba_matmul_kernel<true><<<grid, block, 0, stream>>>(
        a_hi, a_lo, b_hi, b_lo, hh, mid, ll, m, k, n);
  else
    karatsuba_matmul_kernel<false><<<grid, block, 0, stream>>>(
        a_hi, a_lo, b_hi, b_lo, hh, mid, ll, m, k, n);
  return static_cast<int>(cudaGetLastError());
}

// Limb-decomposed wide-integer matmul on Hopper's int8 tensor cores, for
// limbs that fit int8: the same three int32 partial matmuls as
// karatsuba_matmul.cu,
//   hh  = a_hi @ b_hi,   ll = a_lo @ b_lo,
//   mid = (a_hi + a_lo) @ (b_hi + b_lo) - hh - ll       (karatsuba = 1, 3 products)
//   mid = a_hi @ b_lo + a_lo @ b_hi                     (karatsuba = 0, 4 products)
// every sum wrapping like int32, so the outputs are bit-identical to the
// reference's. It takes limbs in [-128, 127] (and, for Karatsuba, hi + lo in
// [-128, 127] too); wider limbs go to karatsuba_matmul.cu (its thin route on
// the CUDA cores, or its digit route on the same int8 mma.sync).
//
// Replaces the Pallas kernel `karatsuba_matmul_kernel`
// (src/repro/kernels/karatsuba_matmul.py:122; body `_block_products`, :42)
// for the int8-valued limbs the quantizers produce.
//
// What bounds it on an H100: the bytes. Four int32 limb arrays in and three
// int32 partials out move 169 MB at 2048 x 896 x 4864 (0.05 ms at 3.35
// TB/s); the 3 passes of 2*M*K*N int8 operations take 0.027 ms at the int8
// tensor-core peak.
//
// Design, two launches on one stream:
//  1. Pack (`pack_rows`, `pack_cols_t`). Each int32 limb is read once and
//     written as int8: A to (2, M, Kp) with K contiguous, B transposed to
//     (2, N, Kp) with K contiguous, Kp = K rounded up to kBK with zeros, so
//     the product reads 4x fewer bytes from L2 than int32 tiles would and
//     its K loop has no ragged edge. The pass also range-checks every limb
//     (and hi + lo for Karatsuba) and sets bit 0 of *flag if one does not
//     fit, and bits 1 / 2 if an operand of the wide route's products (a
//     limb, or for Karatsuba the wrapped hi + lo) needs 3 / 4 balanced int8
//     digits; the caller reads the flag (one host sync) before it launches
//     step 2 or the wide route. Only a thread whose limbs do not fit works
//     out their digit count, and it raises its bits with an atomicOr only
//     when the flag lacks them (no atomic storm on wide limbs); a thread
//     whose limbs fit runs the check alone, as before the digit count. The
//     copies are written in any case: skipping them once the flag is up
//     saved 0.014 of 0.35 ms at M = 2**20, K = 9 on the H100 but made every
//     thread wait on the flag (PERF.md §6).
//  2. Product (`i8_product_kernel`). A 64 x 64 output tile a block, 4 warps
//     of 32 x 32, two blocks an SM so that one's epilogue overlaps the
//     other's loads; cp.async with 16-byte copies fills a 3-stage ring of
//     (hi, lo) tiles of 128 bytes of K, zero-filled past M and N, so the
//     next tiles' loads overlap the current tile's mma; ldmatrix feeds
//     mma.sync.m16n8k32 s8.s8.s32 (no .satfinite: the accumulation wraps).
//     The Karatsuba sums hi + lo are formed in registers from the hi and lo
//     fragments (__vadd4, exact since the pack checked their range). Three
//     accumulator sets stay in registers (96 a thread) and mid -= hh + ll
//     once at the end, modulo 2**32.
#include "multipliers.cuh"

namespace repro {
namespace {

constexpr int kBM = 64, kBN = 64, kBK = 128;      // block tile; K in bytes
constexpr int kWarpsM = 2, kWarpsN = 2;           // warp tile 32 x 32
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kStages = 3;
constexpr int kRowBytes = kBK + 16;               // padded: ldmatrix conflict-free
constexpr int kATileBytes = kBM * kRowBytes;
constexpr int kBTileBytes = kBN * kRowBytes;
constexpr int kStageBytes = 2 * (kATileBytes + kBTileBytes);
constexpr int kSmemBytes = kStages * kStageBytes;

__device__ __forceinline__ bool limb_out_of_range(int32_t hi, int32_t lo, int karatsuba) {
  const bool bad = hi < -128 || hi > 127 || lo < -128 || lo > 127;
  return bad || (karatsuba && (hi + lo < -128 || hi + lo > 127));
}

// Bits 1 and 2 of the flag for one operand of the wide route's products:
// v needs 3 balanced int8 digits (past [-128 * 257, 127 * 257]), or 4 (past
// [-128 * 65793, 127 * 65793]).
__device__ __forceinline__ int width_bits(int32_t v) {
  return (v < -32896 || v > 32639 ? 2 : 0) | (v < -8421504 || v > 8355711 ? 4 : 0);
}

// For a thread whose 4 limb pairs do not all fit: bit 0 and the width bits
// of each pair's operands (for Karatsuba the wrapped hi + lo too), ORed
// into *flag when it lacks some of them (a plain load: a stale value only
// costs an atomic).
__device__ __forceinline__ void raise_flag(int* flag, const int32_t (&h)[4],
                                           const int32_t (&l)[4], int karatsuba) {
  int bits = 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bits |= width_bits(h[j]) | width_bits(l[j]);
    if (karatsuba)
      bits |= width_bits(static_cast<int32_t>(static_cast<uint32_t>(h[j]) +
                                              static_cast<uint32_t>(l[j])));
  }
  if (bits & ~*flag) atomicOr(flag, bits);
}

__device__ __forceinline__ uint32_t byte_of(int32_t v, int j) {
  return (static_cast<uint32_t>(v) & 0xffu) << (8 * j);
}

// A (rows, k) int32 limb pair -> (2, rows, kp) int8, zeros for k <= c < kp.
// One thread packs 4 consecutive K entries of one row.
__global__ void pack_rows(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
                          int8_t* __restrict__ out, int rows, int k, int kp,
                          int karatsuba, int* __restrict__ flag) {
  const int quads = kp / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * quads) return;
  const int r = static_cast<int>(idx / quads);
  const int c0 = static_cast<int>(idx % quads) * 4;
  uint32_t wh = 0u, wl = 0u;
  int32_t h[4], l[4];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    h[j] = l[j] = 0;
    if (c < k) {
      const size_t o = static_cast<size_t>(r) * k + c;
      h[j] = __ldg(&hi[o]);
      l[j] = __ldg(&lo[o]);
    }
    bad |= limb_out_of_range(h[j], l[j], karatsuba);
    wh |= byte_of(h[j], j);
    wl |= byte_of(l[j], j);
  }
  const size_t o = (static_cast<size_t>(r) * kp + c0) / 4;
  reinterpret_cast<uint32_t*>(out)[o] = wh;
  reinterpret_cast<uint32_t*>(out + static_cast<size_t>(rows) * kp)[o] = wl;
  if (bad) raise_flag(flag, h, l, karatsuba);
}

// A (k, cols) int32 limb pair -> transposed (2, cols, kp) int8, zeros for
// k <= r < kp, through a 32 x 32 shared-memory tile; block (32, 8).
__global__ void pack_cols_t(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
                            int8_t* __restrict__ out, int k, int cols, int kp,
                            int karatsuba, int* __restrict__ flag) {
  __shared__ int32_t th[32][33], tl[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  int32_t h[4], l[4];
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int i = ty + 8 * j, r = k0 + i, c = n0 + tx;
    h[j] = l[j] = 0;
    if (r < k && c < cols) {
      const size_t o = static_cast<size_t>(r) * cols + c;
      h[j] = __ldg(&hi[o]);
      l[j] = __ldg(&lo[o]);
    }
    bad |= limb_out_of_range(h[j], l[j], karatsuba);
    th[i][tx] = h[j];
    tl[i][tx] = l[j];
  }
  if (bad) raise_flag(flag, h, l, karatsuba);
  __syncthreads();
  const int tid = ty * 32 + tx;
  const int nl = tid / 8, q = tid % 8;             // column of the tile, K quad
  const int c = n0 + nl;
  if (c >= cols) return;
  uint32_t wh = 0u, wl = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    wh |= byte_of(th[4 * q + j][nl], j);
    wl |= byte_of(tl[4 * q + j][nl], j);
  }
  const size_t o = (static_cast<size_t>(c) * kp + k0 + 4 * q) / 4;
  reinterpret_cast<uint32_t*>(out)[o] = wh;
  reinterpret_cast<uint32_t*>(out + static_cast<size_t>(cols) * kp)[o] = wl;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 x s8 -> s32, wrapping.
__device__ __forceinline__ void mma_s8(uint32_t (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Issue the cp.async copies of K tile `kt` (both limbs of A and B) into
// `stage`; rows past m (or n) are zero-filled.
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* __restrict__ a8,
                                           const int8_t* __restrict__ b8, int m, int n,
                                           int kp, int m0, int n0, int kt, int tid) {
  const int k0 = kt * kBK;
  constexpr int kChunksRow = kBK / 16;
  constexpr int kAChunks = 2 * kBM * kChunksRow, kBChunks = 2 * kBN * kChunksRow;
#pragma unroll
  for (int c = tid; c < kAChunks; c += kThreads) {
    const int limb = c / (kBM * kChunksRow), r = (c / kChunksRow) % kBM, q = c % kChunksRow;
    const bool in = m0 + r < m;
    const int8_t* src = a8 + static_cast<size_t>(limb) * m * kp
                        + static_cast<size_t>(in ? m0 + r : 0) * kp + k0 + q * 16;
    cp_async16(stage + limb * kATileBytes + r * kRowBytes + q * 16, src, in ? 16 : 0);
  }
  int8_t* bstage = stage + 2 * kATileBytes;
#pragma unroll
  for (int c = tid; c < kBChunks; c += kThreads) {
    const int limb = c / (kBN * kChunksRow), r = (c / kChunksRow) % kBN, q = c % kChunksRow;
    const bool in = n0 + r < n;
    const int8_t* src = b8 + static_cast<size_t>(limb) * n * kp
                        + static_cast<size_t>(in ? n0 + r : 0) * kp + k0 + q * 16;
    cp_async16(bstage + limb * kBTileBytes + r * kRowBytes + q * 16, src, in ? 16 : 0);
  }
}

template <bool kKaratsuba>
__global__ void __launch_bounds__(kThreads, 2)
i8_product_kernel(const int8_t* __restrict__ a8, const int8_t* __restrict__ b8,
                  int32_t* __restrict__ hh, int32_t* __restrict__ mid,
                  int32_t* __restrict__ ll, int m, int kp, int n) {
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = kp / kBK;

  uint32_t acc_hh[2][4][4] = {}, acc_mid[2][4][4] = {}, acc_ll[2][4][4] = {};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(smem + s * kStageBytes, a8, b8, m, n, kp, m0, n0, s, tid);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane: A (16 rows x 32 bytes) as matrices
  // (rows 0-7 | 8-15) x (bytes 0-15 | 16-31); B (two n8 tiles x 32 bytes)
  // as (tile 0 | 1) x (bytes 0-15 | 16-31).
  const int a_row = wm * 32 + lane % 16, a_col = (lane / 16) * 16;
  const int b_row = wn * 32 + (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < ktiles)
      load_stage(smem + (next % kStages) * kStageBytes, a8, b8, m, n, kp, m0, n0, next, tid);
    cp_async_commit();

    const int8_t* st = smem + (kt % kStages) * kStageBytes;
    const int8_t* sb = st + 2 * kATileBytes;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int off = (a_row + mi * 16) * kRowBytes + kk + a_col;
        ldmatrix_x4(ah[mi], st + off);
        ldmatrix_x4(al[mi], st + kATileBytes + off);
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (b_row + np * 16) * kRowBytes + kk + b_col;
        uint32_t r[4];
        ldmatrix_x4(r, sb + off);
        bh[2 * np][0] = r[0]; bh[2 * np][1] = r[1];
        bh[2 * np + 1][0] = r[2]; bh[2 * np + 1][1] = r[3];
        ldmatrix_x4(r, sb + kBTileBytes + off);
        bl[2 * np][0] = r[0]; bl[2 * np][1] = r[1];
        bl[2 * np + 1][0] = r[2]; bl[2 * np + 1][1] = r[3];
      }
      uint32_t bs[4][2];
      if constexpr (kKaratsuba) {
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bs[ni][0] = __vadd4(bh[ni][0], bl[ni][0]);
          bs[ni][1] = __vadd4(bh[ni][1], bl[ni][1]);
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t as[4];
        if constexpr (kKaratsuba) {
#pragma unroll
          for (int i = 0; i < 4; ++i) as[i] = __vadd4(ah[mi][i], al[mi][i]);
        }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          mma_s8(acc_hh[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
          mma_s8(acc_ll[mi][ni], al[mi], bl[ni][0], bl[ni][1]);
          if constexpr (kKaratsuba) {
            mma_s8(acc_mid[mi][ni], as, bs[ni][0], bs[ni][1]);
          } else {
            mma_s8(acc_mid[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
            mma_s8(acc_mid[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Accumulator c[i] of tile (mi, ni): row g (+8 for i >= 2), column 2t + i % 2.
  const int g = lane / 4, t = lane % 4;
  const bool pairs = n % 2 == 0;                    // 8-byte aligned column pairs
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mi * 16 + g + 8 * half;
        if (row >= m || col >= n) continue;
        int32_t vh[2], vm[2], vl[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          uint32_t cross = acc_mid[mi][ni][i];
          if constexpr (kKaratsuba) cross -= acc_hh[mi][ni][i] + acc_ll[mi][ni][i];
          vh[e] = static_cast<int32_t>(acc_hh[mi][ni][i]);
          vm[e] = static_cast<int32_t>(cross);
          vl[e] = static_cast<int32_t>(acc_ll[mi][ni][i]);
        }
        const size_t o = static_cast<size_t>(row) * n + col;
        if (pairs) {               // col is even and n is even, so col + 1 < n
          *reinterpret_cast<int2*>(hh + o) = make_int2(vh[0], vh[1]);
          *reinterpret_cast<int2*>(mid + o) = make_int2(vm[0], vm[1]);
          *reinterpret_cast<int2*>(ll + o) = make_int2(vl[0], vl[1]);
        } else {
          hh[o] = vh[0]; mid[o] = vm[0]; ll[o] = vl[0];
          if (col + 1 < n) { hh[o + 1] = vh[1]; mid[o + 1] = vm[1]; ll[o + 1] = vl[1]; }
        }
      }
    }
  }
}

}  // namespace
}  // namespace repro

using namespace repro;

// Step 1. a_hi, a_lo: device (m, k) int32; b_hi, b_lo: device (k, n) int32;
// a8: device (2, m, kp) int8; b8: device (2, n, kp) int8, kp = k rounded up
// to kBK; flag: a device int32, set to 0, then bit 0 set if a limb (or a
// Karatsuba sum) falls outside int8 and bits 1 / 2 if an operand of the wide
// route needs 3 / 4 int8 digits.
extern "C" int karatsuba_i8_pack(const int32_t* a_hi, const int32_t* a_lo,
                                 const int32_t* b_hi, const int32_t* b_lo,
                                 int8_t* a8, int8_t* b8, int* flag, int m, int k,
                                 int n, int kp, int karatsuba, cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 0 || kp < k || kp % kBK) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaMemsetAsync(flag, 0, sizeof(int), stream);
  if (err != cudaSuccess || kp == 0) return static_cast<int>(err);
  const long long quads = static_cast<long long>(m) * (kp / 4);
  const long long blocks = (quads + 255) / 256;
  if (blocks > 0x7fffffffLL || kp / 32 > 65535) return static_cast<int>(cudaErrorInvalidValue);
  pack_rows<<<static_cast<unsigned>(blocks), 256, 0, stream>>>(a_hi, a_lo, a8, m, k, kp,
                                                              karatsuba, flag);
  const dim3 grid((n + 31) / 32, kp / 32);
  pack_cols_t<<<grid, dim3(32, 8), 0, stream>>>(b_hi, b_lo, b8, k, n, kp, karatsuba, flag);
  return static_cast<int>(cudaGetLastError());
}

// Step 2, after the flag read 0: hh, mid, ll: device (m, n) int32 from the
// packed limbs of step 1.
extern "C" int karatsuba_matmul_i8(const int8_t* a8, const int8_t* b8, int32_t* hh,
                                   int32_t* mid, int32_t* ll, int m, int kp, int n,
                                   int karatsuba, cudaStream_t stream) {
  if (m < 1 || n < 1 || kp < 0 || kp % kBK) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = karatsuba ? i8_product_kernel<true> : i8_product_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(a8, b8, hh, mid, ll, m, kp, n);
  return static_cast<int>(cudaGetLastError());
}

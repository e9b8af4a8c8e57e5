// Signed-magnitude LNS (Mitchell-family) matmul on int32 operands:
//   out[m, n] = sum over k of sgn(a[m,k]) * sgn(b[k,n]) * P(|a[m,k]|, |b[k,n]|)
// with a wrapping int32 sum. P is Mitchell's algorithm with its case split
// (num_ecc = 0, case_split = 1) or the Babic basic block plus num_ecc
// error-correction stages (case_split = 0); both are run-time arguments.
//
// Replaces the Pallas kernel `mitchell_matmul_kernel`
// (src/repro/kernels/mitchell_matmul.py:141; body `_signed_block_product`,
// :57, leading-one detector `_clz_k`, :42). The TPU grid arguments
// block_m/block_n/block_k and accum have no counterpart: the host picks a
// launch plan from the shape (kernels/mitchell_matmul.py `launch_plan`), and
// the kernels mask the ragged M/N/K edges themselves (the zeros they stage
// there add 0 to every sum).
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
// 11 operations a product for Mitchell (per stage the exponent add, three
// shifts and two adds; the case split's compare and select; the sign and
// the accumulate) against 132 SMs x 64 INT32 lanes x 1.98 GHz = 16.7e12 a
// second. At the shapes the Qwen2-0.5B path launches:
//   decode, M = 4:   (4,896)x(896,896) 2.1 us, (896,128) 0.3 us,
//                    (896,4864) and (4,4864)x(4864,896) 11.5 us each, with
//                    B's int32 bytes at 1.0 / 0.14 / 5.2 / 5.2 us;
//                    7 calls a layer, 0.94 ms a 24-layer step;
//   prefill, M = 128: (896,896) 68 us, (896,4864) and (4864,896) 0.37 ms;
//   2048 x 896 x 4864 (the infer / benchmark shape): 5.87 ms.
//
// Two routes, chosen on the host by shape, each run on gridDim.z K splits:
//
// * tiled (M > 1024: the 2048 x 896 x 4864 shape, the infer path's large
//   calls): a 16 x 16 thread block owns a 64 x 64 output tile, 4 x 4
//   outputs a thread (rows ty + 16i, columns tx + 16j, so shared-memory
//   reads broadcast or fall on distinct banks and the stores coalesce). Over
//   its K range the block stages a 64 x 32 tile of A and a 32 x 64 tile of B
//   in shared memory. Every value a product needs that depends on one
//   operand only (its magnitude, each stage's characteristic and mantissa
//   residue) is formed once per operand and reused across the thread's 4
//   columns or 4 rows: the first design of this kernel, with the K split.
// * thin (M <= 1024; decode has M = batch, prefill batch x prompt): at M = 4
//   the 64-row tile would leave 15/16 of its threads on padding rows. A
//   block of 4 warps owns kRows (1, 2, 4, 8 or 16, the smallest that covers
//   M; 16-row tiles past 16) x 128 columns; each lane owns 4 adjacent
//   columns and all kRows rows. B is read straight from device memory,
//   coalesced, as one 16-byte load a lane and K step where N and the
//   pointer allow, each group of kUnroll K steps loaded while the previous
//   group is computed; each B element is read once a row tile and
//   decomposed once a stage for all kRows rows. The block's slice of A is
//   staged in shared memory already decomposed, one (characteristic,
//   residue) entry a stage, so every lane reads the same address (a
//   broadcast). The 4 warps take quarters of the block's K range and meet in
//   a shared-memory sum at the end. With 16 rows a lane forms 64 products a
//   K step from 4 B decompositions and 16 shared-memory reads, where the
//   tiled thread forms 16 from 8 decompositions and 8 reads: that is why it
//   also wins at large M (PERF.md, the [route] timings behind the cut).
//
// Split rule (launch_plan): K is cut into `splits` ranges, in K tiles of 32
// on the tiled route, so that (M, N) tiles x splits reach 6 x 132 blocks,
// and no range is shorter than 16 K steps (thin) or one K tile (tiled).
// With splits > 1 every block adds its partial sums into an output the
// caller zeroed, with atomicAdd on unsigned int; with one split it stores
// them.
//
// Why the atomics are exact: the reference's sum is int32 addition modulo
// 2**32 (jnp.sum at src/repro/kernels/mitchell_matmul.py:82), and that
// addition is associative and commutative, so the partial sums added in any
// order give the same bits, wraps included. This is unlike a float split-K,
// whose sum changes with the order of the atomics from run to run.
//
// Stage entries of A: a residue loses its leading one a stage, so every
// operand x >= 0 reaches 0 by stage 31 and stays there ((32, 0) from then
// on), and |INT_MIN| = INT_MIN is a fixed point ((0, INT_MIN)). Stage s >= 31
// therefore reads the entry of stage 31, and a block stages at most 32
// entries an element, whatever num_ecc is.
#include "multipliers.cuh"

namespace repro {
namespace {

constexpr int kThreadsX = 16, kThreadsY = 16;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kMicro = 4;
constexpr int kTileM = kThreadsY * kMicro;
constexpr int kTileN = kThreadsX * kMicro;
constexpr int kTileK = 32;

constexpr int kThinWarps = 4;
constexpr int kThinThreads = 32 * kThinWarps;
constexpr int kThinCols = 4;                       // adjacent columns a lane
constexpr int kThinTileN = 32 * kThinCols;         // columns a block
constexpr int kUnroll = 4;                         // K steps of B in flight a lane
constexpr int kMaxStaged = 32;                     // stage entries that can differ
constexpr int kThinSmemBytes = 48 * 1024;          // without the opt-in attribute

enum Route { kTiled = 0, kThin = 1 };

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

// One stage's product term: lead + m, or Mitchell's case split, which
// compares as int32: lead + m if m < lead, else 2m.
__device__ __forceinline__ uint32_t stage_term(uint32_t ka, int32_t xa, uint32_t kb,
                                               int32_t xb, bool split) {
  const uint32_t m = shl(static_cast<uint32_t>(xa), kb) + shl(static_cast<uint32_t>(xb), ka);
  const uint32_t lead = shl(1u, ka + kb);
  const bool carry = split && static_cast<int32_t>(m) >= static_cast<int32_t>(lead);
  return carry ? 2u * m : lead + m;
}

// sgn(a) sgn(b) tot, with neg = (a ^ b) >> 31: -1 exactly when the sign
// bits differ; a zero operand has a zero total, so the xor's sign suffices.
__device__ __forceinline__ uint32_t signed_total(uint32_t tot, uint32_t neg) {
  return (tot ^ neg) - neg;
}

// Block z's K range [begin, end) of a split into gridDim.z ranges in steps
// of `step`: of T = ceil(k / step) steps, split z takes [z T / splits,
// (z + 1) T / splits), the last range ending at k (launch_plan's k_ranges).
__device__ __forceinline__ void k_range(int k, int step, int& begin, int& end) {
  const long long z = blockIdx.z, splits = gridDim.z, steps = (k + step - 1) / step;
  begin = static_cast<int>(min(static_cast<long long>(k), z * steps / splits * step));
  end = static_cast<int>(min(static_cast<long long>(k), (z + 1) * steps / splits * step));
}

// Writes one sum: a store with one split, an exact wrapping add with more.
__device__ __forceinline__ void emit(int32_t* out, size_t i, uint32_t v) {
  if (gridDim.z > 1)
    atomicAdd(reinterpret_cast<unsigned int*>(out) + i, v);
  else
    out[i] = static_cast<int32_t>(v);
}

// ------------------------------------------------------------------ tiled

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
      for (int j = 0; j < kMicro; ++j) tot[i][j] += stage_term(ka[i], xa[i], kb[j], xb[j], split);
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i) ra[i] = xa[i];
#pragma unroll
    for (int j = 0; j < kMicro; ++j) rb[j] = xb[j];
  }
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
#pragma unroll
    for (int j = 0; j < kMicro; ++j)
      acc[i][j] += signed_total(tot[i][j], static_cast<uint32_t>((av[i] ^ bv[j]) >> 31));
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
  int kb, ke;
  k_range(k, kTileK, kb, ke);
  uint32_t acc[kMicro][kMicro] = {};
  for (int k0 = kb; k0 < ke; k0 += kTileK) {
    for (int i = tid; i < kTileM * kTileK; i += kThreads) {
      const int r = i / kTileK, c = i % kTileK;
      const int gm = m0 + r, gk = k0 + c;
      as[r][c] = (gm < m && gk < ke) ? __ldg(&a[static_cast<size_t>(gm) * k + gk]) : 0;
    }
    for (int i = tid; i < kTileK * kTileN; i += kThreads) {
      const int r = i / kTileN, c = i % kTileN;
      const int gk = k0 + r, gn = n0 + c;
      bs[r][c] = (gk < ke && gn < n) ? __ldg(&b[static_cast<size_t>(gk) * n + gn]) : 0;
    }
    __syncthreads();
    const int steps = min(kTileK, ke - k0);
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
      if (gn < n) emit(out, static_cast<size_t>(gm) * n + gn, acc[i][j]);
    }
  }
}

// ------------------------------------------------------------------- thin

// One stage of an element of A, as the thin kernel stages it.
struct StageEntry {
  uint32_t k;
  int32_t x;
};

// Shared memory of a thin block: the block's sums, then a piece of A of
// `piece` K steps: `staged` entries a stage and the sign word an element.
__host__ __device__ constexpr int thin_sum_bytes(int rows) {
  return rows * kThinTileN * 4;
}
__host__ __device__ constexpr int thin_bytes_per_k(int rows, int staged) {
  return rows * (staged * static_cast<int>(sizeof(StageEntry)) + 4);
}

// The 4 B values of a lane's columns at K row gk; zeros past n.
template <bool kVec>
__device__ __forceinline__ void load_b(const int32_t* __restrict__ b, int n, int gk,
                                       int col, int32_t (&v)[kThinCols]) {
  const int32_t* row = b + static_cast<size_t>(gk) * n;
  if (kVec) {
    if (col < n) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(row + col));
      v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kThinCols; ++j) v[j] = col + j < n ? __ldg(row + col + j) : 0;
  }
}

// B's values of K steps k0 .. k0 + kUnroll - 1 at the lane's columns; zeros
// from step `end` on, which are not read.
template <bool kVec>
__device__ __forceinline__ void load_b_group(const int32_t* __restrict__ b, int n, int p0,
                                             int k0, int end, int col,
                                             int32_t (&v)[kUnroll][kThinCols]) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (k0 + u < end) {
      load_b<kVec>(b, n, p0 + k0 + u, col, v[u]);
    } else {
#pragma unroll
      for (int j = 0; j < kThinCols; ++j) v[u][j] = 0;
    }
  }
}

// Adds sgn(a) sgn(b) P(|a|, |b|) of one K step for the lane's kRows x 4
// pairs: B's 4 values bv, A's staged entries of that step. The sign goes on
// each stage's term: sgn * (p0 + p1) = sgn * p0 + sgn * p1 modulo 2**32, so
// no per-pair stage total is held (Mitchell has one stage).
template <int kRows, bool kCaseSplit>
__device__ __forceinline__ void thin_step(const int32_t (&bv)[kThinCols],
                                          const StageEntry* __restrict__ ent,
                                          const uint32_t* __restrict__ neg_a,
                                          int num_ecc, uint32_t (&acc)[kRows][kThinCols]) {
  int32_t rb[kThinCols];
  uint32_t nb[kThinCols];
#pragma unroll
  for (int j = 0; j < kThinCols; ++j) {
    rb[j] = magnitude(bv[j]);
    nb[j] = static_cast<uint32_t>(bv[j] >> 31);
  }
  uint32_t na[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) na[i] = neg_a[i];
  for (int s = 0; s <= num_ecc; ++s) {
    uint32_t kb[kThinCols];
    int32_t xb[kThinCols];
#pragma unroll
    for (int j = 0; j < kThinCols; ++j) {
      kb[j] = stage_k(rb[j]);
      xb[j] = stage_x(rb[j], kb[j]);
    }
    const bool split = kCaseSplit && s == num_ecc;
    const StageEntry* e = ent + min(s, kMaxStaged - 1) * kRows;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const StageEntry ea = e[i];
#pragma unroll
      for (int j = 0; j < kThinCols; ++j)
        acc[i][j] += signed_total(stage_term(ea.k, ea.x, kb[j], xb[j], split), na[i] ^ nb[j]);
    }
#pragma unroll
    for (int j = 0; j < kThinCols; ++j) rb[j] = xb[j];
  }
}

template <int kRows, bool kCaseSplit, bool kVec>
__global__ void __launch_bounds__(kThinThreads)
mitchell_matmul_thin(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                     int32_t* __restrict__ out, int m, int k, int n, int num_ecc,
                     int staged, int piece) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sums = reinterpret_cast<uint32_t*>(smem);                      // [kRows][128]
  StageEntry* ent = reinterpret_cast<StageEntry*>(smem + thin_sum_bytes(kRows));
  uint32_t* neg_a = reinterpret_cast<uint32_t*>(ent + static_cast<size_t>(piece) * staged * kRows);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kThinTileN + kThinCols * lane;
  int kb, ke;
  k_range(k, 1, kb, ke);
  for (int i = tid; i < kRows * kThinTileN; i += kThinThreads) sums[i] = 0u;
  uint32_t acc[kRows][kThinCols] = {};
  for (int p0 = kb; p0 < ke; p0 += piece) {
    const int len = min(piece, ke - p0);
    // this warp's quarter of the piece; its first B loads fly while A is staged
    const int quarter = (len + kThinWarps - 1) / kThinWarps;
    const int begin = warp * quarter, end = min(len, begin + quarter);
    int32_t cur[kUnroll][kThinCols];
    load_b_group<kVec>(b, n, p0, begin, end, col, cur);
    __syncthreads();                       // the previous piece is read
    // A's (kRows, len) slice, decomposed: entry [kk][s][i], sign word [kk][i]
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int gm = row0 + i;
      for (int kk = tid; kk < len; kk += kThinThreads) {
        const int32_t v = gm < m ? __ldg(&a[static_cast<size_t>(gm) * k + p0 + kk]) : 0;
        neg_a[kk * kRows + i] = static_cast<uint32_t>(v >> 31);
        int32_t r = magnitude(v);
        StageEntry* e = ent + static_cast<size_t>(kk) * staged * kRows + i;
        for (int s = 0; s < staged; ++s) {
          const uint32_t ks = stage_k(r);
          const int32_t xs = stage_x(r, ks);
          e[s * kRows] = StageEntry{ks, xs};
          r = xs;
        }
      }
    }
    __syncthreads();
    // kUnroll K steps at a time, the next group's B loads in flight meanwhile
    for (int kk = begin; kk < end; kk += kUnroll) {
      int32_t next[kUnroll][kThinCols];
      load_b_group<kVec>(b, n, p0, kk + kUnroll, end, col, next);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (kk + u < end)
          thin_step<kRows, kCaseSplit>(cur[u], ent + static_cast<size_t>(kk + u) * staged * kRows,
                                       neg_a + (kk + u) * kRows, num_ecc, acc);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int j = 0; j < kThinCols; ++j) cur[u][j] = next[u][j];
      }
    }
  }
  __syncthreads();                         // sums zeroed on every path
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
#pragma unroll
    for (int j = 0; j < kThinCols; ++j)
      atomicAdd(&sums[i * kThinTileN + kThinCols * lane + j], acc[i][j]);
  }
  __syncthreads();
  const int col0 = blockIdx.x * kThinTileN;
  for (int i = tid; i < kRows * kThinTileN; i += kThinThreads) {
    const int gm = row0 + i / kThinTileN, gn = col0 + i % kThinTileN;
    if (gm < m && gn < n) emit(out, static_cast<size_t>(gm) * n + gn, sums[i]);
  }
}

template <int kRows, bool kCaseSplit>
int launch_thin(const int32_t* a, const int32_t* b, int32_t* out, int m, int k, int n,
                int num_ecc, dim3 grid, cudaStream_t stream) {
  const int staged = num_ecc < kMaxStaged ? num_ecc + 1 : kMaxStaged;
  const int longest = static_cast<int>((static_cast<long long>(k) + grid.z - 1) / grid.z);
  const int fit = (kThinSmemBytes - thin_sum_bytes(kRows)) / thin_bytes_per_k(kRows, staged);
  const int piece = max(1, min(longest, fit));
  const size_t smem = thin_sum_bytes(kRows) + static_cast<size_t>(piece) *
                      thin_bytes_per_k(kRows, staged);
  const bool vec = n % kThinCols == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  if (vec)
    mitchell_matmul_thin<kRows, kCaseSplit, true><<<grid, kThinThreads, smem, stream>>>(
        a, b, out, m, k, n, num_ecc, staged, piece);
  else
    mitchell_matmul_thin<kRows, kCaseSplit, false><<<grid, kThinThreads, smem, stream>>>(
        a, b, out, m, k, n, num_ecc, staged, piece);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCaseSplit>
int launch_thin_rows(int rows, const int32_t* a, const int32_t* b, int32_t* out, int m,
                     int k, int n, int num_ecc, dim3 grid, cudaStream_t stream) {
  switch (rows) {
    case 1: return launch_thin<1, kCaseSplit>(a, b, out, m, k, n, num_ecc, grid, stream);
    case 2: return launch_thin<2, kCaseSplit>(a, b, out, m, k, n, num_ecc, grid, stream);
    case 4: return launch_thin<4, kCaseSplit>(a, b, out, m, k, n, num_ecc, grid, stream);
    case 8: return launch_thin<8, kCaseSplit>(a, b, out, m, k, n, num_ecc, grid, stream);
    case 16: return launch_thin<16, kCaseSplit>(a, b, out, m, k, n, num_ecc, grid, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace repro

// a: device (m, k) int32, b: device (k, n) int32, out: device (m, n) int32,
// all row-major and contiguous. The launch plan (kernels/mitchell_matmul.py
// `launch_plan`): route 0 (tiled, a 64 x 64 tile) or 1 (thin, tile_m rows of
// 1, 2, 4, 8 or 16 by 128 columns), and `splits` K ranges, 1 <= splits <=
// max(k, 1). With splits > 1, out must hold zeros: the blocks add into it.
// Returns cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// plan or shape it does not take.
extern "C" int mitchell_matmul(const int32_t* a, const int32_t* b, int32_t* out,
                               int m, int k, int n, int num_ecc, int case_split,
                               int route, int tile_m, int tile_n, int splits,
                               cudaStream_t stream) {
  using namespace repro;
  if (m < 1 || n < 1 || k < 0 || num_ecc < 0 || splits < 1 || splits > max(k, 1) ||
      splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == kTiled) {
    if (tile_m != kTileM || tile_n != kTileN) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, splits);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 block(kThreadsX, kThreadsY);
    if (case_split)
      mitchell_matmul_kernel<true><<<grid, block, 0, stream>>>(a, b, out, m, k, n, num_ecc);
    else
      mitchell_matmul_kernel<false><<<grid, block, 0, stream>>>(a, b, out, m, k, n, num_ecc);
    return static_cast<int>(cudaGetLastError());
  }
  if (route != kThin || tile_n != kThinTileN || tile_m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n + kThinTileN - 1) / kThinTileN, (m + tile_m - 1) / tile_m, splits);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return case_split
      ? launch_thin_rows<true>(tile_m, a, b, out, m, k, n, num_ecc, grid, stream)
      : launch_thin_rows<false>(tile_m, a, b, out, m, k, n, num_ecc, grid, stream);
}

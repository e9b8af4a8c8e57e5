// Limb-decomposed wide-integer matmul for limbs that do not fit int8: the
// three int32 partial matmuls of balanced limbs a = a_hi * 2^w + a_lo,
// b = b_hi * 2^w + b_lo:
//   hh  = a_hi @ b_hi,   ll = a_lo @ b_lo,
//   mid = (a_hi + a_lo) @ (b_hi + b_lo) - hh - ll       (karatsuba = 1, 3 products)
//   mid = a_hi @ b_lo + a_lo @ b_hi                     (karatsuba = 0, 4 products)
// with every sum wrapping like int32 (carried in uint32_t, since signed
// overflow is undefined in C++), so the outputs are bit-identical to the
// reference's for any int32 limbs. Limbs that fit int8 take
// karatsuba_matmul_i8.cu instead; its pack step reads the limbs once, and
// the flag it raises carries the digit count that the digit route below
// needs (kernels/karatsuba_matmul_i8.py `flag_digits`).
//
// Replaces the Pallas kernel `karatsuba_matmul_kernel`
// (src/repro/kernels/karatsuba_matmul.py:122; body `_block_products`, :42)
// for limbs past int8. The TPU grid arguments block_m/block_n/block_k and
// accum have no counterpart: the host picks a route, a tile and K splits
// from the shape and the digit count (kernels/karatsuba_matmul.py
// `launch_plan`), and the kernels mask the ragged edges themselves. The
// Karatsuba middle product is accumulated whole and hh and ll are taken off
// once at the end: modulo 2**32 that equals the reference's per-K-block
// subtraction.
//
// Two routes, by N:
//
// * thin (N <= 32: every limb call of the inference path, whose N is a
//   layer's output channels): bytes bound it (four int32 limb arrays in,
//   three out; at M = 2**20, K = 9, N = 4 the 1.1e8 multiply-adds take
//   0.007 ms on the INT32 lanes, the 126 MB 0.038 ms). A block of 256
//   threads owns a tile of rows and all N columns: each thread one row and
//   4 adjacent columns, so tile_m = 256 / (tile_n / 4). B's limbs for the
//   block's K range sit in shared memory for the whole block; A_hi and A_lo
//   stream through a two-stage cp.async ring, in 16-byte copies (one
//   contiguous span of whole rows when K % 4 != 0 and the tile holds all of
//   K: the 9-wide conv rows), the next (row tile, K chunk) copied while the
//   current one is computed; the grid is persistent over row tiles. Each
//   thread keeps the three int32 accumulator sets of its 4 outputs in
//   registers. Few row tiles (M = 256, K = 2048 / 4096) split K over
//   gridDim.y; the splits add into outputs the caller zeroed with 32-bit
//   atomics, exact because int32 addition modulo 2**32 is associative and
//   commutative.
// * digits (N > 32): the paper's own move, a wide multiplier decomposed
//   down to an exact base multiplier, here Hopper's int8 mma.sync. Each
//   int32 operand X (a_hi, a_lo, and for Karatsuba the wrapped a_hi + a_lo;
//   the same for B) is split into d balanced int8 digits,
//   X = sum_i x_i 2^(8i) (mod 2^32), x_i in [-128, 127], the top digit taken
//   modulo 256 when d = 4. Then X Y mod 2^32 is the sum over i + j <= 3 of
//   2^(8(i+j)) x_i y_j: 4 digit products for d = 2, 8 for d = 3, 10 for
//   d = 4, each an int8 mma.sync whose int32 accumulation wraps (no
//   .satfinite). d is the call's, from the pack step's flag. Launches: a
//   digit pack of A (row-major, K contiguous) and of B (transposed), d
//   planes an operand, K padded to 128 with zeros; then one product launch
//   a limb product (3 Karatsuba, 4 schoolbook), 64 x 64 output tiles on 4
//   warps of 32 x 32 (the int8 kernel's tiling, ldmatrix, cp.async ring),
//   one accumulator set per digit shift 8(i + j), summed with their shifts
//   in the epilogue, which also forms mid: Karatsuba's (S - hh - ll) reads
//   hh and ll, schoolbook's second cross product adds the first. Bound:
//   the larger of the bytes and passes x pairs(d) x 2 M K N int8 operations
//   at the int8 tensor-core peak.
#include "multipliers.cuh"

namespace repro {
namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// ------------------------------------------------------------------ thin

constexpr int kThinThreads = 256;
constexpr int kThinMaxTileN = 32;
constexpr int kSmemMax = 232448;                  // an H100 block's shared memory

struct ThinArgs {
  int m, k, n;
  int tile_n;       // 4, 8, 16 or 32 columns; tile_m = 256 / (tile_n / 4) rows
  int splits;       // K ranges, cut in steps of 4 (gridDim.y)
  int kc;           // K chunk of one ring stage
  int stride;       // shared-memory row stride of a staged A tile, elements
  int span;         // 1: a stage is whole rows, copied as one span (kc == stride == k)
  int b_rows;       // the longest split's K range: B rows in shared memory
  int vec;          // 1: 16-byte copies of A (16-byte aligned, and k % 4 == 0 unless span)
  int vec_out;      // 1: 16-byte stores (16-byte aligned outputs, n % 4 == 0)
};

// The [kb, ke) K range of split s: steps of 4, as launch_plan's k_ranges.
__device__ __forceinline__ int split_begin(int s, int splits, int k) {
  const int steps = (k + 3) / 4;
  return min(k, static_cast<int>(static_cast<long long>(s) * steps / splits) * 4);
}

template <bool kKaratsuba>
__global__ void __launch_bounds__(kThinThreads)
karatsuba_thin_kernel(const int32_t* __restrict__ a_hi, const int32_t* __restrict__ a_lo,
                      const int32_t* __restrict__ b_hi, const int32_t* __restrict__ b_lo,
                      int32_t* __restrict__ hh, int32_t* __restrict__ mid,
                      int32_t* __restrict__ ll, ThinArgs p) {
  extern __shared__ __align__(16) int32_t thin_smem[];
  const int groups = p.tile_n / 4, rows = kThinThreads / groups;
  const int tid = threadIdx.x, g = tid % groups, r = tid / groups;
  const int kb = split_begin(blockIdx.y, p.splits, p.k);
  const int ke = split_begin(blockIdx.y + 1, p.splits, p.k);
  int32_t* bh_s = thin_smem;
  int32_t* bl_s = thin_smem + p.b_rows * p.tile_n;
  int32_t* ring = thin_smem + 2 * p.b_rows * p.tile_n;
  const int stage = 2 * rows * p.stride;          // A_hi then A_lo, elements

  // B's limbs over [kb, ke), zeros past n; read once a block (the first
  // __syncthreads of the loop publishes them).
  for (int i = tid; i < (ke - kb) * p.tile_n; i += kThinThreads) {
    const int kk = i / p.tile_n, c = i % p.tile_n;
    const size_t o = static_cast<size_t>(kb + kk) * p.n + c;
    bh_s[i] = c < p.n ? __ldg(&b_hi[o]) : 0;
    bl_s[i] = c < p.n ? __ldg(&b_lo[o]) : 0;
  }

  const int row_tiles = (p.m + rows - 1) / rows;
  const int my_tiles = static_cast<int>(blockIdx.x) < row_tiles
                           ? (row_tiles - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1 : 0;
  const int chunks = max(1, (ke - kb + p.kc - 1) / p.kc);
  const int items = my_tiles * chunks;

  // Copy A's rows of item `it` (row tile, K chunk) into ring stage it % 2.
  auto issue = [&](int it) {
    const int tile = blockIdx.x + (it / chunks) * gridDim.x;
    const int k0 = kb + (it % chunks) * p.kc;
    const int klen = min(p.kc, ke - k0);
    const int m0 = tile * rows, nrows = min(rows, p.m - m0);
    int32_t* dst = ring + (it & 1) * stage;
#pragma unroll
    for (int limb = 0; limb < 2; ++limb) {
      const int32_t* a = limb ? a_lo : a_hi;
      int32_t* d = dst + limb * rows * p.stride;
      if (p.span) {                 // rows [m0, m0 + nrows) x all K: one span
        const int32_t* src = a + static_cast<size_t>(m0) * p.k;
        const int count = nrows * p.k;
        const int quads = p.vec ? count / 4 : 0;  // m0 % 4 == 0: the span is aligned
        for (int q = tid; q < quads; q += kThinThreads) cp_async16(d + 4 * q, src + 4 * q, 16);
        for (int e = 4 * quads + tid; e < count; e += kThinThreads) cp_async4(d + e, src + e);
      } else if (p.vec) {           // k % 4 == 0: klen and k0 are multiples of 4
        const int quads = klen / 4;
        for (int i = tid; i < nrows * quads; i += kThinThreads) {
          const int rr = i / quads, q = i % quads;
          cp_async16(d + rr * p.stride + 4 * q,
                     a + static_cast<size_t>(m0 + rr) * p.k + k0 + 4 * q, 16);
        }
      } else {
        for (int i = tid; i < nrows * klen; i += kThinThreads) {
          const int rr = i / klen, c = i % klen;
          cp_async4(d + rr * p.stride + c, a + static_cast<size_t>(m0 + rr) * p.k + k0 + c);
        }
      }
    }
  };

  uint32_t acc_h[4] = {}, acc_m[4] = {}, acc_l[4] = {};
  auto step = [&](uint32_t ah, uint32_t al, const int32_t* bh_row, const int32_t* bl_row) {
    const int4 h4 = *reinterpret_cast<const int4*>(bh_row);
    const int4 l4 = *reinterpret_cast<const int4*>(bl_row);
    const uint32_t bh[4] = {static_cast<uint32_t>(h4.x), static_cast<uint32_t>(h4.y),
                            static_cast<uint32_t>(h4.z), static_cast<uint32_t>(h4.w)};
    const uint32_t bl[4] = {static_cast<uint32_t>(l4.x), static_cast<uint32_t>(l4.y),
                            static_cast<uint32_t>(l4.z), static_cast<uint32_t>(l4.w)};
    const uint32_t as = ah + al;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc_h[j] += ah * bh[j];
      acc_l[j] += al * bl[j];
      if constexpr (kKaratsuba)
        acc_m[j] += as * (bh[j] + bl[j]);
      else
        acc_m[j] += ah * bl[j] + al * bh[j];
    }
  };

  if (items > 0) issue(0);
  cp_async_commit();
  for (int it = 0; it < items; ++it) {
    if (it + 1 < items) issue(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int c = it % chunks;
    const int k0 = kb + c * p.kc;
    const int klen = max(0, min(p.kc, ke - k0));
    const int32_t* sah = ring + (it & 1) * stage + r * p.stride;
    const int32_t* sal = sah + rows * p.stride;
    const int32_t* sbh = bh_s + (k0 - kb) * p.tile_n + 4 * g;
    const int32_t* sbl = bl_s + (k0 - kb) * p.tile_n + 4 * g;
    if (p.stride % 4 == 0 && klen % 4 == 0) {       // 16-byte reads of A
      for (int kk = 0; kk < klen; kk += 4) {
        const int4 h4 = *reinterpret_cast<const int4*>(sah + kk);
        const int4 l4 = *reinterpret_cast<const int4*>(sal + kk);
        const int32_t* bh = sbh + kk * p.tile_n;
        const int32_t* bl = sbl + kk * p.tile_n;
        step(h4.x, l4.x, bh, bl);
        step(h4.y, l4.y, bh + p.tile_n, bl + p.tile_n);
        step(h4.z, l4.z, bh + 2 * p.tile_n, bl + 2 * p.tile_n);
        step(h4.w, l4.w, bh + 3 * p.tile_n, bl + 3 * p.tile_n);
      }
    } else {
      for (int kk = 0; kk < klen; ++kk)
        step(sah[kk], sal[kk], sbh + kk * p.tile_n, sbl + kk * p.tile_n);
    }
    if (c == chunks - 1) {                          // the row tile's K range is done
      const int gm = (blockIdx.x + (it / chunks) * gridDim.x) * rows + r;
      const int c0 = 4 * g;
      if (gm < p.m && c0 < p.n) {
        uint32_t vm[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          vm[j] = kKaratsuba ? acc_m[j] - (acc_h[j] + acc_l[j]) : acc_m[j];
        const size_t o = static_cast<size_t>(gm) * p.n + c0;
        if (p.splits > 1) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c0 + j >= p.n) break;
            atomicAdd(reinterpret_cast<unsigned int*>(hh) + o + j, acc_h[j]);
            atomicAdd(reinterpret_cast<unsigned int*>(mid) + o + j, vm[j]);
            atomicAdd(reinterpret_cast<unsigned int*>(ll) + o + j, acc_l[j]);
          }
        } else if (p.vec_out) {                     // n % 4 == 0, so c0 + 3 < n
          *reinterpret_cast<uint4*>(hh + o) = make_uint4(acc_h[0], acc_h[1], acc_h[2], acc_h[3]);
          *reinterpret_cast<uint4*>(mid + o) = make_uint4(vm[0], vm[1], vm[2], vm[3]);
          *reinterpret_cast<uint4*>(ll + o) = make_uint4(acc_l[0], acc_l[1], acc_l[2], acc_l[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (c0 + j >= p.n) break;
            hh[o + j] = static_cast<int32_t>(acc_h[j]);
            mid[o + j] = static_cast<int32_t>(vm[j]);
            ll[o + j] = static_cast<int32_t>(acc_l[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_h[j] = acc_m[j] = acc_l[j] = 0u;
    }
    __syncthreads();                                // the stage is free for item it + 2
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------- digits

constexpr int kBM = 64, kBN = 64;                 // output tile
constexpr int kWarpsM = 2, kWarpsN = 2;           // warp tile 32 x 32
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kKAlign = 128;                      // the planes' K padding

template <int D>
struct DigitCfg {
  static constexpr int kBK = D == 2 ? 128 : 64;   // K bytes a stage
  static constexpr int kStages = D == 4 ? 2 : 3;
  static constexpr int kRowBytes = kBK + 16;      // padded: ldmatrix conflict-free
  static constexpr int kTileBytes = kBM * kRowBytes;
  static constexpr int kStageBytes = 2 * D * kTileBytes;   // D planes of A, D of B
  static constexpr int kSmemBytes = kStages * kStageBytes;
  static constexpr int kShifts = D == 2 ? 3 : 4;  // digit shifts 8(i + j) below 32
};

// The low balanced int8 digit of r as a byte, and r advanced past it:
// x = ((r & 0xff) ^ 0x80) - 128 and r = (r - x) / 2**8, exact in 64 bits.
__device__ __forceinline__ uint32_t next_digit(long long& r) {
  const uint32_t b = static_cast<uint32_t>(r) & 0xffu;
  r = (r - (static_cast<int>(b ^ 0x80u) - 128)) >> 8;
  return b;
}

// The value of operand op (0: hi, 1: lo, 2: the wrapped hi + lo).
__device__ __forceinline__ int32_t operand(int op, int32_t h, int32_t l) {
  return op == 0 ? h : op == 1 ? l
                 : static_cast<int32_t>(static_cast<uint32_t>(h) + static_cast<uint32_t>(l));
}

// A (rows, k) int32 limb pair -> (nops, D, rows, kp) int8 digit planes,
// zeros for k <= c < kp. One thread packs 4 consecutive K entries of one row.
template <int D>
__global__ void digit_pack_rows(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
                                int8_t* __restrict__ out, int rows, int k, int kp, int nops) {
  const int quads = kp / 4;
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(rows) * quads) return;
  const int r = static_cast<int>(idx / quads);
  const int c0 = static_cast<int>(idx % quads) * 4;
  int32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + j;
    const size_t o = static_cast<size_t>(r) * k + c;
    h[j] = c < k ? __ldg(&hi[o]) : 0;
    l[j] = c < k ? __ldg(&lo[o]) : 0;
  }
  const size_t plane = static_cast<size_t>(rows) * kp / 4;
  const size_t o = (static_cast<size_t>(r) * kp + c0) / 4;
  for (int op = 0; op < nops; ++op) {
    uint32_t w[D] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long long v = operand(op, h[j], l[j]);
#pragma unroll
      for (int i = 0; i < D; ++i) w[i] |= next_digit(v) << (8 * j);
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
      reinterpret_cast<uint32_t*>(out)[(op * D + i) * plane + o] = w[i];
  }
}

// A (k, cols) int32 limb pair -> transposed (nops, D, cols, kp) int8 digit
// planes, zeros for k <= r < kp, through a 32 x 32 shared-memory tile;
// block (32, 8).
template <int D>
__global__ void digit_pack_cols_t(const int32_t* __restrict__ hi, const int32_t* __restrict__ lo,
                                  int8_t* __restrict__ out, int k, int cols, int kp, int nops) {
  __shared__ int32_t th[32][33], tl[32][33];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int k0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  for (int i = ty; i < 32; i += 8) {
    const int r = k0 + i, c = n0 + tx;
    const bool in = r < k && c < cols;
    const size_t o = static_cast<size_t>(r) * cols + c;
    th[i][tx] = in ? __ldg(&hi[o]) : 0;
    tl[i][tx] = in ? __ldg(&lo[o]) : 0;
  }
  __syncthreads();
  const int tid = ty * 32 + tx;
  const int nl = tid / 8, q = tid % 8;            // column of the tile, K quad
  const int c = n0 + nl;
  if (c >= cols) return;
  const size_t plane = static_cast<size_t>(cols) * kp / 4;
  const size_t o = (static_cast<size_t>(c) * kp + k0 + 4 * q) / 4;
  for (int op = 0; op < nops; ++op) {
    uint32_t w[D] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      long long v = operand(op, th[4 * q + j][nl], tl[4 * q + j][nl]);
#pragma unroll
      for (int i = 0; i < D; ++i) w[i] |= next_digit(v) << (8 * j);
    }
#pragma unroll
    for (int i = 0; i < D; ++i)
      reinterpret_cast<uint32_t*>(out)[(op * D + i) * plane + o] = w[i];
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
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

// Issue the cp.async copies of K tile kt of the D planes of x (rows past m
// zero-filled) and of y (rows past n) into `stage`.
template <int D>
__device__ __forceinline__ void digit_stage(int8_t* stage, const int8_t* __restrict__ x,
                                            const int8_t* __restrict__ y, size_t x_plane,
                                            size_t y_plane, int m, int n, int kp, int m0,
                                            int n0, int kt, int tid) {
  using C = DigitCfg<D>;
  const int k0 = kt * C::kBK;
  constexpr int kChunks = C::kBK / 16, kPlane = kBM * kChunks;
#pragma unroll
  for (int c = tid; c < 2 * D * kPlane; c += kThreads) {
    const int p = c / kPlane, r = (c / kChunks) % kBM, q = c % kChunks;
    const bool is_a = p < D;
    const int row = (is_a ? m0 : n0) + r;
    const bool in = row < (is_a ? m : n);
    const int8_t* src = (is_a ? x + p * x_plane : y + (p - D) * y_plane)
                        + static_cast<size_t>(in ? row : 0) * kp + k0 + q * 16;
    cp_async16(stage + p * C::kTileBytes + r * C::kRowBytes + q * 16, src, in ? 16 : 0);
  }
}

// out = X @ Y mod 2**32 (+ add) (- sub0) (- sub1) from the D digit planes of
// X (plane i at x + i * m * kp) and of Y (transposed, at y + i * n * kp).
// out may alias add.
template <int D>
__global__ void __launch_bounds__(kThreads, D == 2 ? 2 : 1)
digit_product_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ y,
                     int32_t* out, const int32_t* add, const int32_t* sub0,
                     const int32_t* sub1, int m, int kp, int n) {
  using C = DigitCfg<D>;
  extern __shared__ __align__(16) int8_t smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % kWarpsM, wn = warp / kWarpsM;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = kp / C::kBK;
  const size_t x_plane = static_cast<size_t>(m) * kp, y_plane = static_cast<size_t>(n) * kp;

  uint32_t acc[C::kShifts][2][4][4] = {};

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < ktiles)
      digit_stage<D>(smem + s * C::kStageBytes, x, y, x_plane, y_plane, m, n, kp, m0, n0, s, tid);
    cp_async_commit();
  }
  // ldmatrix row addresses of this lane, as in karatsuba_matmul_i8.cu.
  const int a_row = wm * 32 + lane % 16, a_col = (lane / 16) * 16;
  const int b_row = wn * 32 + (lane / 16) * 8 + lane % 8, b_col = ((lane / 8) % 2) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();
    const int next = kt + C::kStages - 1;
    if (next < ktiles)
      digit_stage<D>(smem + (next % C::kStages) * C::kStageBytes, x, y, x_plane, y_plane, m, n,
                     kp, m0, n0, next, tid);
    cp_async_commit();

    const int8_t* st = smem + (kt % C::kStages) * C::kStageBytes;
    const int8_t* sb = st + D * C::kTileBytes;
#pragma unroll
    for (int kk = 0; kk < C::kBK; kk += 32) {
      uint32_t b[D][4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        const int off = (b_row + np * 16) * C::kRowBytes + kk + b_col;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          uint32_t r[4];
          ldmatrix_x4(r, sb + i * C::kTileBytes + off);
          b[i][2 * np][0] = r[0]; b[i][2 * np][1] = r[1];
          b[i][2 * np + 1][0] = r[2]; b[i][2 * np + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        uint32_t a[D][4];
        const int off = (a_row + mi * 16) * C::kRowBytes + kk + a_col;
#pragma unroll
        for (int i = 0; i < D; ++i) ldmatrix_x4(a[i], st + i * C::kTileBytes + off);
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
          for (int i = 0; i < D; ++i) {
#pragma unroll
            for (int j = 0; j < D; ++j) {
              if (i + j < C::kShifts) mma_s8(acc[i + j][mi][ni], a[i], b[j][ni][0], b[j][ni][1]);
            }
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
        const size_t o = static_cast<size_t>(row) * n + col;
        const int cnt = pairs ? 2 : (col + 1 < n ? 2 : 1);
        uint32_t v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * half + e;
          uint32_t s = 0u;
#pragma unroll
          for (int sh = 0; sh < C::kShifts; ++sh) s += acc[sh][mi][ni][i] << (8 * sh);
          v[e] = s;
        }
        for (int e = 0; e < cnt; ++e) {
          if (add) v[e] += static_cast<uint32_t>(add[o + e]);
          if (sub0) v[e] -= static_cast<uint32_t>(sub0[o + e]);
          if (sub1) v[e] -= static_cast<uint32_t>(sub1[o + e]);
        }
        if (pairs) {               // col is even and n is even, so col + 1 < n
          *reinterpret_cast<uint2*>(out + o) = make_uint2(v[0], v[1]);
        } else {
          for (int e = 0; e < cnt; ++e) out[o + e] = static_cast<int32_t>(v[e]);
        }
      }
    }
  }
}

template <int D>
int run_digits(const int32_t* a_hi, const int32_t* a_lo, const int32_t* b_hi,
               const int32_t* b_lo, int8_t* a_dig, int8_t* b_dig, int32_t* hh, int32_t* mid,
               int32_t* ll, int m, int k, int n, int kp, int karatsuba, cudaStream_t stream) {
  using C = DigitCfg<D>;
  const int nops = karatsuba ? 3 : 2;
  cudaError_t err;
  if (kp > 0) {
    const long long quads = static_cast<long long>(m) * (kp / 4);
    digit_pack_rows<D><<<static_cast<unsigned>((quads + 255) / 256), 256, 0, stream>>>(
        a_hi, a_lo, a_dig, m, k, kp, nops);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    digit_pack_cols_t<D><<<dim3((n + 31) / 32, kp / 32), dim3(32, 8), 0, stream>>>(
        b_hi, b_lo, b_dig, k, n, kp, nops);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(digit_product_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  const size_t a_op = static_cast<size_t>(D) * m * kp, b_op = static_cast<size_t>(D) * n * kp;
  auto product = [&](int xa, int yb, int32_t* out, const int32_t* add, const int32_t* s0,
                     const int32_t* s1) {
    digit_product_kernel<D><<<grid, kThreads, C::kSmemBytes, stream>>>(
        a_dig + xa * a_op, b_dig + yb * b_op, out, add, s0, s1, m, kp, n);
    return cudaGetLastError();
  };
  if ((err = product(0, 0, hh, nullptr, nullptr, nullptr)) != cudaSuccess) return static_cast<int>(err);
  if ((err = product(1, 1, ll, nullptr, nullptr, nullptr)) != cudaSuccess) return static_cast<int>(err);
  if (karatsuba) return static_cast<int>(product(2, 2, mid, nullptr, hh, ll));
  if ((err = product(0, 1, mid, nullptr, nullptr, nullptr)) != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(product(1, 0, mid, mid, nullptr, nullptr));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace
}  // namespace repro

using namespace repro;

// The thin route (kernels/karatsuba_matmul.py `launch_plan`, route 'thin').
// a_hi, a_lo: device (m, k) int32; b_hi, b_lo: device (k, n) int32; hh,
// mid, ll: device (m, n) int32, zeroed by the caller when splits > 1; all
// row-major and contiguous. tile_n, splits, kc, stride, span and blocks
// (gridDim.x) come from the plan. Returns cudaGetLastError() after the
// launch.
extern "C" int karatsuba_thin(const int32_t* a_hi, const int32_t* a_lo, const int32_t* b_hi,
                              const int32_t* b_lo, int32_t* hh, int32_t* mid, int32_t* ll,
                              int m, int k, int n, int karatsuba, int tile_n, int splits,
                              int kc, int stride, int span, int blocks, cudaStream_t stream) {
  const bool tile_ok = tile_n == 4 || tile_n == 8 || tile_n == 16 || tile_n == kThinMaxTileN;
  if (m < 1 || n < 1 || k < 0 || !tile_ok || n > tile_n || splits < 1 || splits > 65535 ||
      kc < 1 || stride < kc || blocks < 1 || (span && (splits != 1 || kc != k || stride != k)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int steps = (k + 3) / 4;
  if (steps > 0 && splits > steps) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = kThinThreads / (tile_n / 4);
  const int b_rows = min(k, (steps + splits - 1) / splits * 4);
  const long long smem = 4LL * (2LL * b_rows * tile_n + 4LL * rows * stride);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  const bool ptrs = aligned16(a_hi) && aligned16(a_lo);
  const bool outs = aligned16(hh) && aligned16(mid) && aligned16(ll);
  const ThinArgs args{m, k, n, tile_n, splits, kc, stride, span, b_rows,
                      ptrs && (span || (k % 4 == 0 && kc % 4 == 0 && stride % 4 == 0)) ? 1 : 0,
                      outs && n % 4 == 0 ? 1 : 0};
  auto kernel = karatsuba ? karatsuba_thin_kernel<true> : karatsuba_thin_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(blocks, splits), kThinThreads, static_cast<size_t>(smem), stream>>>(
      a_hi, a_lo, b_hi, b_lo, hh, mid, ll, args);
  return static_cast<int>(cudaGetLastError());
}

// The digit route (route 'digits'). a_dig: device (nops, digits, m, kp)
// int8 and b_dig: device (nops, digits, n, kp) int8 scratch, nops = 3
// (Karatsuba) or 2, kp = k rounded up to 128; digits 2, 3 or 4, enough for
// every operand (the pack step's flag). Returns cudaGetLastError() after
// the last launch.
extern "C" int karatsuba_digits(const int32_t* a_hi, const int32_t* a_lo, const int32_t* b_hi,
                                const int32_t* b_lo, int8_t* a_dig, int8_t* b_dig, int32_t* hh,
                                int32_t* mid, int32_t* ll, int m, int k, int n, int kp,
                                int digits, int karatsuba, cudaStream_t stream) {
  if (m < 1 || n < 1 || k < 0 || kp < k || kp % kKAlign || (n + kBN - 1) / kBN > 65535 ||
      kp / 32 > 65535 || static_cast<long long>(m) * (kp / 4) / 256 >= 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (digits) {
    case 2: return run_digits<2>(a_hi, a_lo, b_hi, b_lo, a_dig, b_dig, hh, mid, ll, m, k, n,
                                 kp, karatsuba, stream);
    case 3: return run_digits<3>(a_hi, a_lo, b_hi, b_lo, a_dig, b_dig, hh, mid, ll, m, k, n,
                                 kp, karatsuba, stream);
    case 4: return run_digits<4>(a_hi, a_lo, b_hi, b_lo, a_dig, b_dig, hh, mid, ll, m, k, n,
                                 kp, karatsuba, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

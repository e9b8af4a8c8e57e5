// Both passes of a separable filter in one kernel:
// (N, H, W) int32 -> (N, H, W) int32,
//   r[y, x]   = sum over kw row taps of sgn(t) * sgn(c) * mult(|t|, |c|)   at nbits
//   out[y, x] = post( sum over kh column taps of the same on r )           at nbits2
// with zero padding and wrapping int32 sums. Bit-identical to a row pass with
// post='none' followed by a column pass in an int32 carry; in the kcm
// variant an operand at or past a ROM adds sgn(t) * that ROM's fill, the
// reference's jnp.take fill (kcm_term).
//
// Replaces the Pallas kernel `_fused_kernel` (src/repro/filters/conv.py:383),
// launched by `_fused_call` (src/repro/filters/conv.py:446), in both of its
// tap-product variants:
//   fused_separable_kcm      -- per-tap product ROMs (row ROM at nbits, column
//                               ROM at nbits2, signs baked in);
//   fused_separable_recurse  -- the selected multiplier per tap.
//
// What bounds it on an H100: the kcm variant moves about 8 bytes of HBM per
// pixel (int32 in, int32 out) -- the row-pass intermediate never leaves the
// SM -- so it is bound by memory bandwidth, with the gathers served by
// shared memory; the recurse variant is bound by integer operations per tap
// (the column pass runs at 16 bits: up to 64 2x2 leaves a REFMLM tap, of
// which the plan keeps only the non-zero digits' ones).
//
// Both variants at 3x3 and 5x5 taps (the bank's) run on the persistent grid
// and double-buffered cp.async window of staging.cuh over the library's
// TileShape (the menu: 32 x 64 and 16 x 64, rows x columns, one library
// each). The block's threads compute the row pass for the tile's
// rows + kh - 1 band rows into shared memory, a thread half the band rows
// of one column (no divide per element); after a barrier each thread runs
// the column pass for its R rows (16 or 8) of its column, each band element
// read once and reused for the kh tap rows from registers.
//
// fused_separable_kcm_tiles_kernel stages once a block the 8-bit row ROMs
// (<= 16 KB) and, of each 16-bit column ROM (65,536 entries a tap, more than
// shared memory holds), only the prefix the row pass can reach: |row sum|
// <= the row stack's bound (4080 for the bank's refmlm and exact tables),
// computed on the host from the row ROMs (column_prefix in
// repro_torch.filters.conv) and stored as int16 when every entry in it
// fits, else int32. A band row whose values lie within the prefix on every
// lane of the warp (a vote) gathers from shared memory alone; otherwise a
// value past the prefix (an operand past the row ROM) is gathered from
// global memory, and one past the column ROM gets the fill, so the bytes
// do not depend on the prefix.
//
// fused_separable_recurse_tiles_kernel takes every coefficient-only part
// of a product from a host plan (repro_torch.filters.recurse_plan) through
// the tap policies of multipliers.cuh, compiled per shape and per policy
// pair; a band element is split once and reused for the kh tap rows. For
// REFMLM's 8-bit rows with 16-bit columns the column policy is compiled
// also per chunk of the menu (with_chunk), for the tuner's sweep.
//
// Other tap shapes run the tiled kernels of the first design: grid =
// (tiles_x, tiles_y, N) over 32 x 16 output tiles, one output pixel per
// thread, the (16 + kh - 1) x (32 + kw - 1) window staged with stage_window
// for every tile, an int32 band in shared memory; an 8-bit ROM (<= 16 KB)
// staged for every tile, a 16-bit one read from global memory. Each entry
// runs its tiled kernel at any shape when it is given no plans (recurse)
// or a zero prefix length (kcm): measurement variant 0.
#include <tuple>
#include <type_traits>
#include <utility>

#include "staging.cuh"

namespace repro {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr size_t kSmemRomBytes = 16 * 1024;

// Row pass for band entry i (band row r = image row y0 - kh/2 + r).
template <class RowTerm>
__device__ __forceinline__ void row_pass(int32_t* band, const int32_t* win, int h,
                                         int w, int x0, int y0, int kh, int kw,
                                         RowTerm row_term) {
  const int ww = kTileW + kw - 1, bh = kTileH + kh - 1;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < bh * kTileW; i += nthreads) {
    const int r = i / kTileW, c = i % kTileW;
    const int y = y0 - kh / 2 + r;
    uint32_t acc = 0u;
    if (y >= 0 && y < h && x0 + c < w)
      for (int dj = 0; dj < kw; ++dj) acc += row_term(dj, win[r * ww + c + dj]);
    band[i] = static_cast<int32_t>(acc);
  }
}

template <bool kRowInSmem, bool kColInSmem>
__global__ void __launch_bounds__(kTileW * kTileH)
fused_separable_kcm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ row_rom,
                           int row_len, int32_t row_fill, const int32_t* __restrict__ col_rom,
                           int col_len, int32_t col_fill, int32_t* __restrict__ out, int h,
                           int w, int kh, int kw, int shift, int post) {
  extern __shared__ int32_t smem[];
  const int ww = kTileW + kw - 1, bh = kTileH + kh - 1;
  int32_t* win = smem;
  int32_t* band = win + bh * ww;
  int32_t* next = band + bh * kTileW;
  const int32_t* rtab = row_rom;
  const int32_t* ctab = col_rom;
  if constexpr (kRowInSmem) {
    stage_rom(next, row_rom, kw * row_len);
    rtab = next;
    next += kw * row_len;
  }
  if constexpr (kColInSmem) {
    stage_rom(next, col_rom, kh * col_len);
    ctab = next;
  }
  const size_t plane = static_cast<size_t>(h) * w;
  const int32_t* img = x + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  stage_window(win, img, h, w, y0 - kh / 2, x0 - kw / 2, bh, ww);
  __syncthreads();
  row_pass(band, win, h, w, x0, y0, kh, kw,
           [&](int dj, int32_t t) { return kcm_term(rtab, row_len, dj, t, row_fill); });
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = x0 + tx, oy = y0 + ty;
  if (ox >= w || oy >= h) return;
  uint32_t acc = 0u;
  for (int di = 0; di < kh; ++di)
    acc += kcm_term(ctab, col_len, di, band[(ty + di) * kTileW + tx], col_fill);
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] = apply_post(acc, post, shift);
}

template <int kMethod>
__global__ void __launch_bounds__(kTileW * kTileH)
fused_separable_recurse_kernel(const int32_t* __restrict__ x, Coeffs1d row, Coeffs1d col,
                               int nbits, int nbits2, int num_ecc,
                               int32_t* __restrict__ out, int h, int w, int kh, int kw,
                               int shift, int post) {
  extern __shared__ int32_t smem[];
  const int ww = kTileW + kw - 1, bh = kTileH + kh - 1;
  int32_t* win = smem;
  int32_t* band = win + bh * ww;
  const size_t plane = static_cast<size_t>(h) * w;
  const int32_t* img = x + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  stage_window(win, img, h, w, y0 - kh / 2, x0 - kw / 2, bh, ww);
  __syncthreads();
  row_pass(band, win, h, w, x0, y0, kh, kw, [&](int dj, int32_t t) {
    const int32_t c = row.v[dj];
    const int s = sign_of(c) * sign_of(t);
    return s == 0 ? 0u
                  : signed_term(s, tap_product<kMethod>(magnitude(t), magnitude(c), nbits, num_ecc));
  });
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = x0 + tx, oy = y0 + ty;
  if (ox >= w || oy >= h) return;
  uint32_t acc = 0u;
  for (int di = 0; di < kh; ++di) {
    const int32_t c = col.v[di];
    const int32_t t = band[(ty + di) * kTileW + tx];
    const int s = sign_of(c) * sign_of(t);
    if (s != 0)
      acc += signed_term(s, tap_product<kMethod>(magnitude(t), magnitude(c), nbits2, num_ecc));
  }
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] = apply_post(acc, post, shift);
}

inline dim3 fused_grid(int n, int h, int w) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
}

inline size_t fused_smem(int kh, int kw) {
  const size_t bh = kTileH + kh - 1;
  return (bh * (kTileW + kw - 1) + bh * kTileW) * sizeof(int32_t);
}

template <int kMethod>
void launch_recurse(dim3 grid, size_t smem, cudaStream_t stream, const int32_t* x,
                    const Coeffs1d& row, const Coeffs1d& col, int nbits, int nbits2,
                    int num_ecc, int32_t* out, int h, int w, int kh, int kw, int shift,
                    int post) {
  fused_separable_recurse_kernel<kMethod><<<grid, dim3(kTileW, kTileH), smem, stream>>>(
      x, row, col, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post);
}

constexpr int kSepTaps = 5;                 // taps of a pass of the largest bank shape
template <class TS>
__host__ __device__ constexpr int band_rows(int kh) { return TS::kHeight + kh - 1; }

// fused_separable_recurse on the bank's tap shapes (3x3, 5x5) over TS
// tiles; the row pass by RowTaps at nbits, the column pass by ColTaps at
// nbits2.
template <class TS, int KH, int KW, class RowTaps, class ColTaps>
__global__ void __launch_bounds__(TS::kThreads)
fused_separable_recurse_tiles_kernel(const int32_t* __restrict__ x,
                                     const __grid_constant__ TapPlan<kSepTaps> row,
                                     const __grid_constant__ TapPlan<kSepTaps> col,
                                     uint32_t mask, uint32_t mask2, int row_stages,
                                     int col_stages, int32_t* __restrict__ out, int n, int h,
                                     int w, int shift, int post, int vec) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr int kW = TS::kWidth;
  const KcmWindow<TS> ws(KH, KW);
  int32_t* band = smem + 2 * ws.elems();
  const int tx = threadIdx.x, r0 = threadIdx.y * TS::kRows;
  const int c = tx + ws.pad_l - KW / 2;              // window column of tap column 0
  const size_t plane = static_cast<size_t>(h) * w;
  persistent_tiles<TS, KH, KW>(x, n, h, w, vec, smem,
                               [&](const int32_t* win, int img, int y0, int x0) {
    // band row r = image row y0 - KH/2 + r; rows outside the image read a
    // zero window row, and every multiplier gives 0 on it. A staged policy
    // takes half the rows a thread group in chunks (one stage loop for
    // many rows); the others a row at a time in a loop, which keeps the
    // code small (faster on the H100, PERF.md).
    if constexpr (RowTaps::kStaged) {
      constexpr int kHalf = band_rows<TS>(KH) / TS::kGroups;
      const int b0 = threadIdx.y * kHalf;
      uint32_t sums[kHalf] = {};
      recurse_rows<1, KW, kHalf, RowTaps>(sums, win + b0 * ws.cols + c, ws.cols, row, mask,
                                          row_stages);
#pragma unroll
      for (int r = 0; r < kHalf; ++r)
        band[(b0 + r) * kW + tx] = static_cast<int32_t>(sums[r]);
    } else {
#pragma unroll 1
      for (int r = threadIdx.y; r < band_rows<TS>(KH); r += TS::kGroups) {
        uint32_t sum[1] = {0u};
        recurse_rows<1, KW, 1, RowTaps>(sum, win + r * ws.cols + c, ws.cols, row, mask,
                                        row_stages);
        band[r * kW + tx] = static_cast<int32_t>(sum[0]);
      }
    }
    __syncthreads();
    uint32_t acc[TS::kRows] = {};
    recurse_rows<KH, 1, TS::kRows, ColTaps>(acc, band + r0 * kW + tx, kW, col, mask2,
                                            col_stages);
    store_rows(out + img * plane, acc, h, w, x0 + tx, y0 + r0, shift, post);
  });
}

// The column ROMs as the persistent fused kcm kernel reads them: entries
// [0, len) of each tap from the prefix in shared memory (int16 or int32, as
// column_prefix chose from the data), the rest of the ROM from global
// memory, and the fill past it.
template <class Prefix>
struct ColumnRoms {
  const Prefix* prefix;                // KH x len, shared memory
  int len;
  const int32_t* __restrict__ rom;     // KH x rom_len, global memory
  int rom_len;
  int32_t fill;

  __device__ __forceinline__ int32_t at(int tap, uint32_t mag) const {
    if (mag < static_cast<uint32_t>(len)) return prefix[tap * len + mag];
    return mag < static_cast<uint32_t>(rom_len) ? __ldg(rom + static_cast<size_t>(tap) * rom_len + mag)
                                                : fill;
  }
};

// fused_separable_kcm on the bank's tap shapes (3x3, 5x5) over TS tiles.
// kRowInSmem: the
// row ROM stack (8-bit) is staged in shared memory once a block, else read
// from global memory; Prefix: the column prefix's element type.
template <class TS, int KH, int KW, bool kRowInSmem, class Prefix>
__global__ void __launch_bounds__(TS::kThreads)
fused_separable_kcm_tiles_kernel(const int32_t* __restrict__ x,
                                 const int32_t* __restrict__ row_rom, int row_len,
                                 int32_t row_fill, const int32_t* __restrict__ col_rom,
                                 int col_len, int32_t col_fill, int prefix_len,
                                 int32_t* __restrict__ out, int n, int h, int w, int shift,
                                 int post, int vec) {
  static_assert(band_rows<TS>(KH) % TS::kGroups == 0, "band rows split evenly over the groups");
  extern __shared__ __align__(16) int32_t smem[];
  constexpr int kW = TS::kWidth;
  const KcmWindow<TS> ws(KH, KW);
  int32_t* band = smem + 2 * ws.elems();
  int32_t* srow = band + band_rows<TS>(KH) * kW;
  Prefix* prefix = reinterpret_cast<Prefix*>(srow + (kRowInSmem ? KW * row_len : 0));
  // once a block: the row ROMs and the column prefix (persistent_tiles
  // synchronises before the first tile)
  if constexpr (kRowInSmem) stage_rom(srow, row_rom, KW * row_len);
  const int tid = threadIdx.y * kW + threadIdx.x;
  for (int t = 0; t < KH; ++t)
    for (int i = tid; i < prefix_len; i += TS::kThreads)
      prefix[t * prefix_len + i] =
          static_cast<Prefix>(__ldg(col_rom + static_cast<size_t>(t) * col_len + i));
  const int32_t* rtab = kRowInSmem ? srow : row_rom;
  const ColumnRoms<Prefix> cols{prefix, prefix_len, col_rom, col_len, col_fill};
  const int tx = threadIdx.x, r0 = threadIdx.y * TS::kRows;
  const int c = tx + ws.pad_l - KW / 2;              // window column of tap column 0
  const size_t plane = static_cast<size_t>(h) * w;
  persistent_tiles<TS, KH, KW>(x, n, h, w, vec, smem,
                               [&](const int32_t* win, int img, int y0, int x0) {
    // row pass: band row r = window row r = image row y0 - KH/2 + r (a
    // zero window row outside the image gives a zero band row); a thread
    // takes half the band rows of its column
    constexpr int kHalf = band_rows<TS>(KH) / TS::kGroups;
    const int b0 = threadIdx.y * kHalf;
#pragma unroll
    for (int r = 0; r < kHalf; ++r) {
      const int32_t* wrow = win + (b0 + r) * ws.cols + c;
      uint32_t sum = 0u;
#pragma unroll
      for (int dj = 0; dj < KW; ++dj) sum += kcm_term(rtab, row_len, dj, wrow[dj], row_fill);
      band[(b0 + r) * kW + tx] = static_cast<int32_t>(sum);
    }
    __syncthreads();
    // column pass: band row r0 + br holds tap di = br - i of output row i,
    // so each band element is read once and its |v|, sgn(v) reused for
    // every tap from registers; int32 carry, as the reference's fused pass.
    // A band row within the prefix on every lane of the warp gathers from
    // shared memory alone.
    uint32_t acc[TS::kRows] = {};
#pragma unroll
    for (int br = 0; br < TS::kRows + KH - 1; ++br) {
      const int32_t v = band[(r0 + br) * kW + tx];
      const uint32_t mag = static_cast<uint32_t>(magnitude(v));
      const int s = sign_of(v);
      auto taps = [&](auto product) {
#pragma unroll
        for (int i = 0; i < TS::kRows; ++i) {
          const int di = br - i;
          if (di >= 0 && di < KH) acc[i] += signed_term(s, product(di));
        }
      };
      if (warp_below(mag, prefix_len))
        taps([&](int di) { return static_cast<int32_t>(prefix[di * prefix_len + mag]); });
      else
        taps([&](int di) { return cols.at(di, mag); });
    }
    store_rows(out + img * plane, acc, h, w, x0 + tx, y0 + r0, shift, post);
  });
}

// The arguments of one fused kcm pass, as the C entry point takes them.
struct FusedKcm {
  const int32_t* x;
  const int32_t* row_rom;
  int row_len;
  int32_t row_fill;
  const int32_t* col_rom;
  int col_len;
  int32_t col_fill;
  int prefix_len, prefix_int16;
  int32_t* out;
  int n, h, w, kh, kw, shift, post;

  bool row_in_smem() const {
    return static_cast<size_t>(kw) * row_len * sizeof(int32_t) <= kSmemRomBytes;
  }
  // dynamic shared memory of the persistent kernel on TS tiles: two
  // windows, the band, the row ROMs (when staged) and the column prefix
  template <class TS>
  size_t smem() const {
    const size_t words = 2 * KcmWindow<TS>(kh, kw).elems() + band_rows<TS>(kh) * TS::kWidth +
                         (row_in_smem() ? static_cast<size_t>(kw) * row_len : 0);
    return words * sizeof(int32_t) +
           static_cast<size_t>(kh) * prefix_len * (prefix_int16 ? sizeof(int16_t) : sizeof(int32_t));
  }
};

// f(kernel) with the persistent instance on the library's tile for a's
// shape, row ROM placement and prefix type; any other shape is refused.
template <class F>
int fused_kcm_instance(const FusedKcm& a, F&& f) {
  using TS = LibTile;
  auto pick = [&](auto shape) {
    constexpr int K = decltype(shape)::value;
    if (a.row_in_smem())
      return a.prefix_int16 ? f(fused_separable_kcm_tiles_kernel<TS, K, K, true, int16_t>)
                            : f(fused_separable_kcm_tiles_kernel<TS, K, K, true, int32_t>);
    return a.prefix_int16 ? f(fused_separable_kcm_tiles_kernel<TS, K, K, false, int16_t>)
                          : f(fused_separable_kcm_tiles_kernel<TS, K, K, false, int32_t>);
  };
  if (a.kh == 3 && a.kw == 3) return pick(std::integral_constant<int, 3>{});
  if (a.kh == 5 && a.kw == 5) return pick(std::integral_constant<int, 5>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

int fused_kcm_persistent(const FusedKcm& a, cudaStream_t stream) {
  const size_t smem = a.smem<LibTile>();
  const int vec = a.w % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  return fused_kcm_instance(a, [&](auto kernel) {
    return launch_persistent<LibTile>(kernel, smem, stream, a.n, a.h, a.w, a.x, a.row_rom, a.row_len,
                             a.row_fill, a.col_rom, a.col_len, a.col_fill, a.prefix_len, a.out,
                             a.n, a.h, a.w, a.shift, a.post, vec);
  });
}

// The tiled kcm kernel (the first design, variant 0): any shape.
int fused_kcm_tiled(const FusedKcm& a, cudaStream_t stream) {
  const size_t row_bytes = static_cast<size_t>(a.kw) * a.row_len * sizeof(int32_t);
  const size_t col_bytes = static_cast<size_t>(a.kh) * a.col_len * sizeof(int32_t);
  const bool row_smem = row_bytes <= kSmemRomBytes, col_smem = col_bytes <= kSmemRomBytes;
  const size_t smem =
      fused_smem(a.kh, a.kw) + (row_smem ? row_bytes : 0) + (col_smem ? col_bytes : 0);
  const dim3 grid = fused_grid(a.n, a.h, a.w), block(kTileW, kTileH);
  const auto args = std::make_tuple(a.x, a.row_rom, a.row_len, a.row_fill, a.col_rom,
                                    a.col_len, a.col_fill, a.out, a.h, a.w, a.kh, a.kw,
                                    a.shift, a.post);
  auto run = [&](auto kernel) {
    std::apply([&](auto... v) { kernel<<<grid, block, smem, stream>>>(v...); }, args);
    return static_cast<int>(cudaGetLastError());
  };
  if (row_smem && col_smem) return run(fused_separable_kcm_kernel<true, true>);
  if (row_smem) return run(fused_separable_kcm_kernel<true, false>);
  if (col_smem) return run(fused_separable_kcm_kernel<false, true>);
  return run(fused_separable_kcm_kernel<false, false>);
}

// The arguments of one fused recurse pass, as the C entry points take them.
struct FusedPass {
  const int32_t* x;
  const int32_t* row;
  const int32_t* col;
  const int32_t* row_plan;
  const int32_t* col_plan;
  int method, num_ecc, nbits, nbits2;
  int32_t* out;
  int n, h, w, kh, kw, shift, post, chunk;
  cudaStream_t stream;
};

struct FusedPlans {
  TapPlan<kSepTaps> row, col;
  int row_stages, col_stages;
};

template <class TS, int KH, int KW, class RowTaps, class ColTaps>
int launch_fused_tiles(const FusedPass& a, const FusedPlans& p) {
  const size_t smem = (2 * KcmWindow<TS>(KH, KW).elems() + band_rows<TS>(KH) * TS::kWidth) *
                      sizeof(int32_t);
  const uint32_t mask = static_cast<uint32_t>((1ull << a.nbits) - 1);
  const uint32_t mask2 = static_cast<uint32_t>((1ull << a.nbits2) - 1);
  const int vec = a.w % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  return launch_persistent<TS>(fused_separable_recurse_tiles_kernel<TS, KH, KW, RowTaps, ColTaps>,
                               smem, a.stream, a.n, a.h, a.w, a.x, p.row, p.col, mask, mask2,
                               p.row_stages, p.col_stages, a.out, a.n, a.h, a.w, a.shift,
                               a.post, vec);
}

// The column policy's chunks of the menu (with_chunk) are compiled for
// REFMLM's 8-bit rows and 16-bit columns, the bank's, which the tuner sweeps.
template <class RowTaps, class ColTaps>
constexpr bool kChunkSwept =
    std::is_same_v<RowTaps, TableTaps<4>> && std::is_same_v<ColTaps, TableTaps<8>>;

template <int KH, int KW>
int fused_shape(const FusedPass& a, const FusedPlans& p) {
  return method_taps(a.method, a.nbits, [&](auto row_tag) {
    using RowTaps = typename decltype(row_tag)::type;
    if constexpr (RowTaps::kRefmlm) {
      return refmlm_taps(a.nbits2, [&](auto col_tag) {
        using ColTaps = typename decltype(col_tag)::type;
        return with_chunk<ColTaps, kChunkSwept<RowTaps, ColTaps>>(a.chunk, [&](auto ctag) {
          return launch_fused_tiles<LibTile, KH, KW, RowTaps, typename decltype(ctag)::type>(
              a, p);
        });
      });
    } else {
      return with_chunk<RowTaps, false>(a.chunk, [&](auto) {
        return launch_fused_tiles<LibTile, KH, KW, RowTaps, RowTaps>(a, p);
      });
    }
  });
}

// The persistent kernel, for 3x3 and 5x5 taps; any other shape is refused.
int fused_persistent(const FusedPass& a) {
  FusedPlans p;
  if (!load_plan(p.row, p.row_stages, a.row_plan, a.kw) ||
      !load_plan(p.col, p.col_stages, a.col_plan, a.kh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.kh == 3 && a.kw == 3) return fused_shape<3, 3>(a, p);
  if (a.kh == 5 && a.kw == 5) return fused_shape<5, 5>(a, p);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tiled recurse kernel (the first design): any shape.
int fused_tiled(const FusedPass& a) {
  Coeffs1d r{}, c{};
  for (int i = 0; i < a.kw; ++i) r.v[i] = a.row[i];
  for (int i = 0; i < a.kh; ++i) c.v[i] = a.col[i];
  const size_t smem = fused_smem(a.kh, a.kw);
  const dim3 grid = fused_grid(a.n, a.h, a.w);
#define REPRO_TILED(M)                                                                   \
  case M:                                                                                \
    launch_recurse<M>(grid, smem, a.stream, a.x, r, c, a.nbits, a.nbits2, a.num_ecc,     \
                      a.out, a.h, a.w, a.kh, a.kw, a.shift, a.post);                     \
    break;
  switch (a.method) {
    REPRO_TILED(kExact)
    REPRO_TILED(kRefmlm)
    REPRO_TILED(kRefmlmNc)
    REPRO_TILED(kMitchell)
    REPRO_TILED(kMitchellEcc)
    REPRO_TILED(kOdma)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_TILED
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

using namespace repro;

// x, out: device (n, h, w) int32; row_rom: device (kw, row_len) int32 at
// nbits; col_rom: device (kh, col_len) int32 at nbits2; signs baked in;
// row_fill, col_fill: what a gather past each ROM gives (both passes carry
// int32). prefix_len > 0: the persistent kernel, for 3x3 and 5x5 taps
// (repro_torch.filters.conv.kernel_route says which), with entries [0,
// prefix_len) of each column ROM staged in shared memory, as int16 when
// prefix_int16 (column_prefix); prefix_len 0: the tiled kernel of the first
// design, for any shape. tile_rows x tile_cols: this library's tile
// (LibTile) for the persistent kernel, kTileH x kTileW for the tiled one.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_separable_kcm(const int32_t* x, const int32_t* row_rom, int row_len,
                                   int32_t row_fill, const int32_t* col_rom, int col_len,
                                   int32_t col_fill, int prefix_len, int prefix_int16,
                                   int32_t* out, int n, int h, int w, int kh, int kw, int shift,
                                   int post, int tile_rows, int tile_cols,
                                   cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK || n < 1 || h < 1 || w < 1 ||
      row_len < 1 || col_len < 1 || prefix_len < 0 || prefix_len > col_len)
    return static_cast<int>(cudaErrorInvalidValue);
  if (prefix_len > 0 ? !is_lib_tile(tile_rows, tile_cols)
                     : (tile_rows != kTileH || tile_cols != kTileW))
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedKcm a{x, row_rom, row_len, row_fill, col_rom, col_len, col_fill, prefix_len,
                   prefix_int16, out, n, h, w, kh, kw, shift, post};
  return prefix_len == 0 ? fused_kcm_tiled(a, stream) : fused_kcm_persistent(a, stream);
}

// What the persistent fused kcm kernel on this library's tile takes for
// these arguments (as fused_separable_kcm gets them, no tensor needed):
// info[0] its dynamic
// shared memory a block in bytes, info[1] the blocks an SM holds at once,
// info[2] its registers a thread, info[3] its local memory a thread in
// bytes (spills). The stream is not used.
extern "C" int fused_separable_kcm_info(int row_len, int col_len, int prefix_len,
                                        int prefix_int16, int kh, int kw, int* info,
                                        cudaStream_t) {
  if (prefix_len < 1 || prefix_len > col_len || info == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedKcm a{nullptr, nullptr, row_len, 0, nullptr, col_len, 0, prefix_len,
                   prefix_int16, nullptr, 1, 1, 1, kh, kw, 0, 0};
  return fused_kcm_instance(
      a, [&](auto kernel) { return persistent_info<LibTile>(kernel, a.smem<LibTile>(), info); });
}

// The same for the persistent fused recurse instance on this library's tile
// for 3x3 or 5x5 taps, the row policy of (method, nbits), the column
// policy of nbits2 at the chunk (-1: its own).
extern "C" int fused_separable_recurse_info(int kh, int kw, int method, int nbits, int nbits2,
                                            int chunk, int* info, cudaStream_t) {
  if (info == nullptr || kh != kw || (kh != 3 && kh != 5))
    return static_cast<int>(cudaErrorInvalidValue);
  auto shape = [&](auto kc) -> int {
    constexpr int K = decltype(kc)::value;
    const size_t smem = (2 * KcmWindow<LibTile>(K, K).elems() +
                         band_rows<LibTile>(K) * LibTile::kWidth) * sizeof(int32_t);
    auto run = [&](auto row_tag, auto col_tag) {
      return persistent_info<LibTile>(
          fused_separable_recurse_tiles_kernel<LibTile, K, K, typename decltype(row_tag)::type,
                                               typename decltype(col_tag)::type>,
          smem, info);
    };
    return method_taps(method, nbits, [&](auto row_tag) {
      using RowTaps = typename decltype(row_tag)::type;
      if constexpr (RowTaps::kRefmlm) {
        return refmlm_taps(nbits2, [&](auto col_tag) {
          using ColTaps = typename decltype(col_tag)::type;
          return with_chunk<ColTaps, kChunkSwept<RowTaps, ColTaps>>(
              chunk, [&](auto ctag) { return run(row_tag, ctag); });
        });
      } else {
        return with_chunk<RowTaps, false>(chunk, [&](auto) { return run(row_tag, row_tag); });
      }
    });
  };
  return kh == 3 ? shape(std::integral_constant<int, 3>{}) : shape(std::integral_constant<int, 5>{});
}

// row: host (kw,) and col: host (kh,) int32 coefficients; row_plan, col_plan:
// host plan words of each (repro_torch.filters.recurse_plan.plan_words, at
// nbits and nbits2), or both null. With plans the persistent kernel runs,
// for 3x3 and 5x5 taps (repro_torch.filters.conv.kernel_route says
// which); with none the tiled kernel of the first design, for any shape.
// method: repro::Method; num_ecc is read by the tiled kMitchellEcc only
// (the plans hold the stages). chunk: the column policy's rows a thread
// holds at once, -1 for its own, another of 0, 4, 8, 16 only where
// kChunkSwept. tile_rows x tile_cols: this library's tile with plans,
// kTileH x kTileW without.
extern "C" int fused_separable_recurse(const int32_t* x, const int32_t* row,
                                       const int32_t* col, const int32_t* row_plan,
                                       const int32_t* col_plan, int method, int num_ecc,
                                       int nbits, int nbits2, int32_t* out, int n, int h,
                                       int w, int kh, int kw, int shift, int post, int chunk,
                                       int tile_rows, int tile_cols, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK || n < 1 || h < 1 || w < 1 || nbits < 1 ||
      nbits > 16 || nbits2 < 1 || nbits2 > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool plans = row_plan != nullptr || col_plan != nullptr;
  if (plans ? !is_lib_tile(tile_rows, tile_cols)
            : (tile_rows != kTileH || tile_cols != kTileW || chunk != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  const FusedPass a{x, row, col, row_plan, col_plan, method, num_ecc, nbits, nbits2, out,
                    n, h, w, kh, kw, shift, post, chunk, stream};
  if (!plans) return fused_tiled(a);
  return fused_persistent(a);
}

// One direct convolution pass of the integer filter datapath:
// (N, H, W) int32 -> (N, H, W) int32,
//   out[p] = post( sum over kh x kw taps of sgn(t) * sgn(c) * mult(|t|, |c|) )
// with zero padding and a wrapping int32 sum. For an operand at or past the
// ROM the kcm variant adds sgn(t) * fill, and its sum is the reference's
// carry: int16 (the low 16 bits, sign-extended) when the ROM stack's bound
// is below 2**15, as `_tables_for` picks it (kcm_term, narrow_carry).
//
// Replaces the Pallas kernel `_kernel` (src/repro/filters/conv.py:215),
// launched by `_pass_call` (src/repro/filters/conv.py:263), in both of its
// tap-product variants:
//   conv_pass_kcm      -- mult comes from a per-tap product ROM, sign baked in
//                         (repro.core.kcm); `mult_impl='kcm'`;
//   conv_pass_recurse  -- mult is evaluated per tap by the selected multiplier
//                         (multipliers.cuh); `mult_impl='recurse'`.
//
// What bounds it on an H100: the kcm variant moves about 8 bytes of HBM per
// pixel (int32 in, int32 out) and does kh*kw shared-memory gathers, so it is
// bound by memory bandwidth; the recurse variant is bound by integer
// operations: per tap, its pixel-side work (the coefficient side comes from
// a host plan), e.g. 2 operations a non-zero 2x2 leaf for REFMLM.
//
// conv_pass_kcm: a persistent grid (as many blocks as the SMs hold at once)
// walks over the output tiles of the library's TileShape (staging.cuh; the
// menu is 32 x 64 and 16 x 64, rows x columns, one library each). Each block stages an 8-bit
// ROM stack (<= 32 KB) in shared memory once, not once per tile; a 16-bit
// one (65,536 entries per tap, the two-pass second pass) is read from
// global memory through the read-only path and stays in L2. A tile's input
// window, with its halo and zeros outside the image (the reference's zero
// padding, so no batch fold and no halo views), is copied row by row with
// cp.async into one of two shared buffers while the block computes the
// tile before it: 16-byte copies from a 4-aligned column where the rows
// allow it (W % 4 == 0), else 4-byte copies, with no divide per element.
// A thread owns R rows of one column (16 or 8), so each window element it needs is
// read from shared memory kw times (once per tap column) and reused over
// the kh tap rows from registers, not read kh * kw times.
//
// conv_pass_recurse: the same persistent grid, cp.async window and R rows
// a thread, compiled per bank tap shape and per tap policy (multipliers.cuh);
// for REFMLM's 8-bit policy at 3x3 taps also per chunk of the menu
// (with_chunk), which the C entry takes for the tuner's sweep.
// Every coefficient-only part of a product is a launch constant, worked out
// once on the host (repro_torch.filters.recurse_plan): REFMLM's non-zero
// coefficient digits with the packed truth table of each 2x2 leaf, the
// Mitchell family's (k2, x2) per stage. A window element is split once per
// tap column (its digits as byte selectors, or its leading one and
// mantissa) and reused for the kh tap rows; a non-zero REFMLM leaf is then
// one byte permute and one shifted add, and zero digits cost nothing.
//
// Tap shapes other than the bank's (3x3, 5x5, 1x3, 3x1, 1x5, 5x1) run the
// tiled kernels: one output pixel a thread on a 32 x 16 tile, the window
// staged for every tile with stage_window (the first design). The recurse
// entry runs its tiled kernel when it is given no plan, at any shape.
//
// conv_pass_kcm_variant runs the 3x3 kcm pass through the design above with
// its parts switched one at a time (ROM once or per tile, cp.async window
// or stage_window, no taps), or through the tiled kernel, so that one run
// can time where the difference lies. No entry point of the port calls it.
#include <tuple>
#include <type_traits>

#include "staging.cuh"

namespace repro {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr size_t kSmemRomBytes = 32 * 1024;
constexpr int kPlanTaps = 25;                        // taps of the largest bank shape, 5x5

// The tiled kcm kernel: one output pixel a thread on a 32 x 16 tile, the
// ROM stack and the window staged for every tile. It runs the tap shapes
// the persistent kernel is not compiled for, and is measurement variant 0.
template <bool kRomInSmem>
__global__ void __launch_bounds__(kTileW * kTileH)
conv_pass_kcm_tiled_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rom,
                     int rom_len, int32_t fill, int carry_bits, int32_t* __restrict__ out,
                     int h, int w, int kh, int kw, int shift, int post) {
  extern __shared__ int32_t smem[];
  const int ww = kTileW + kw - 1, wh = kTileH + kh - 1;
  int32_t* win = smem;
  const int32_t* table = rom;
  if constexpr (kRomInSmem) {
    int32_t* srom = smem + wh * ww;
    stage_rom(srom, rom, kh * kw * rom_len);
    table = srom;
  }
  const size_t plane = static_cast<size_t>(h) * w;
  const int32_t* img = x + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  stage_window(win, img, h, w, y0 - kh / 2, x0 - kw / 2, wh, ww);
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = x0 + tx, oy = y0 + ty;
  if (ox >= w || oy >= h) return;
  uint32_t acc = 0u;
  for (int di = 0; di < kh; ++di)
    for (int dj = 0; dj < kw; ++dj)
      acc += kcm_term(table, rom_len, di * kw + dj, win[(ty + di) * ww + tx + dj], fill);
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] =
      apply_post(narrow_carry(acc, carry_bits), post, shift);
}

// The TS::kRows sums of one thread for a KH x KW tap shape: window row wr
// (from the thread's first row) holds tap row wr - i of output row i, so
// each element is read once per tap column and reused for every tap row
// from a register. Every loop unrolls and the tap-row tests fold away.
template <class TS, int KH, int KW>
__device__ __forceinline__ void kcm_rows(uint32_t (&acc)[TS::kRows], const int32_t* win,
                                         int cols, const int32_t* table, int rom_len,
                                         int32_t fill) {
#pragma unroll
  for (int wr = 0; wr < TS::kRows + KH - 1; ++wr) {
    int32_t v[KW];
#pragma unroll
    for (int dj = 0; dj < KW; ++dj) v[dj] = win[wr * cols + dj];
#pragma unroll
    for (int i = 0; i < TS::kRows; ++i) {
      const int di = wr - i;
      if (di >= 0 && di < KH) {
#pragma unroll
        for (int dj = 0; dj < KW; ++dj)
          acc[i] += kcm_term(table, rom_len, di * KW + dj, v[dj], fill);
      }
    }
  }
}

// TS: the tile; KH x KW: the tap shape; kRomInSmem: the ROM stack is copied to shared
// memory (8-bit ROMs); kRomEachTile: copied again for every tile (a
// measurement variant); kAsync: the next tile's window is copied with
// cp.async during this one's compute, else each tile stages its window with
// stage_window (a variant); kTaps false: no tap products, the output is the
// window's centre pixel (a variant that times the staging and the stores
// alone).
template <class TS, int KH, int KW, bool kRomInSmem, bool kRomEachTile, bool kAsync, bool kTaps>
__global__ void __launch_bounds__(TS::kThreads)
conv_pass_kcm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rom,
                     int rom_len, int32_t fill, int carry_bits, int32_t* __restrict__ out,
                     int n, int h, int w, int shift, int post, int vec) {
  extern __shared__ __align__(16) int32_t smem[];
  const KcmWindow<TS> ws(KH, KW);
  int32_t* srom = smem + (kAsync ? 2 : 1) * ws.elems();
  const int32_t* table = kRomInSmem ? srom : rom;
  const int rom_count = KH * KW * rom_len;
  if constexpr (kRomInSmem && !kRomEachTile) stage_rom(srom, rom, rom_count);
  const int tx = threadIdx.x, r0 = threadIdx.y * TS::kRows;
  const int c = tx + ws.pad_l - KW / 2;              // window column of tap column 0
  const size_t plane = static_cast<size_t>(h) * w;
  persistent_tiles<TS, KH, KW, kAsync>(x, n, h, w, vec, smem,
                                   [&](const int32_t* win, int img, int y0, int x0) {
    if constexpr (kRomInSmem && kRomEachTile) {
      stage_rom(srom, rom, rom_count);
      __syncthreads();
    }
    uint32_t acc[TS::kRows] = {};
    if constexpr (!kTaps) {           // a variant: the window's centre pixel, no taps
#pragma unroll
      for (int i = 0; i < TS::kRows; ++i) acc[i] = win[(r0 + i + KH / 2) * ws.cols + c + KW / 2];
    } else {
      kcm_rows<TS, KH, KW>(acc, win + r0 * ws.cols + c, ws.cols, table, rom_len, fill);
#pragma unroll
      for (int i = 0; i < TS::kRows; ++i) acc[i] = narrow_carry(acc[i], carry_bits);
    }
    store_rows(out + img * plane, acc, h, w, x0 + tx, y0 + r0, shift, post);
  });
}

template <int kMethod>
__global__ void __launch_bounds__(kTileW * kTileH)
conv_pass_recurse_kernel(const int32_t* __restrict__ x, Coeffs coeffs, int nbits,
                         int num_ecc, int32_t* __restrict__ out, int h, int w,
                         int kh, int kw, int shift, int post) {
  extern __shared__ int32_t smem[];
  const int ww = kTileW + kw - 1, wh = kTileH + kh - 1;
  int32_t* win = smem;
  const size_t plane = static_cast<size_t>(h) * w;
  const int32_t* img = x + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  stage_window(win, img, h, w, y0 - kh / 2, x0 - kw / 2, wh, ww);
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = x0 + tx, oy = y0 + ty;
  if (ox >= w || oy >= h) return;
  uint32_t acc = 0u;
  for (int di = 0; di < kh; ++di) {
    for (int dj = 0; dj < kw; ++dj) {
      const int32_t c = coeffs.v[di * kw + dj];
      const int32_t t = win[(ty + di) * ww + tx + dj];
      const int s = sign_of(c) * sign_of(t);
      if (s != 0)
        acc += signed_term(s, tap_product<kMethod>(magnitude(t), magnitude(c), nbits, num_ecc));
    }
  }
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] = apply_post(acc, post, shift);
}

inline dim3 pass_grid(int n, int h, int w) {
  return dim3((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
}

template <int kMethod>
void launch_recurse(dim3 grid, size_t smem, cudaStream_t stream, const int32_t* x,
                    const Coeffs& coeffs, int nbits, int num_ecc, int32_t* out,
                    int h, int w, int kh, int kw, int shift, int post) {
  conv_pass_recurse_kernel<kMethod><<<grid, dim3(kTileW, kTileH), smem, stream>>>(
      x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post);
}

// Launch the persistent kcm kernel on TS tiles: as many blocks as the SMs
// hold at once at this shared-memory size, at most one per tile.
template <class TS, int KH, int KW, bool kRomInSmem, bool kRomEachTile, bool kAsync,
          bool kTaps = true>
int launch_kcm(const int32_t* x, const int32_t* rom, int rom_len, int32_t fill, int carry_bits,
               int32_t* out, int n, int h, int w, int shift, int post, cudaStream_t stream) {
  const KcmWindow<TS> win(KH, KW);
  const size_t rom_bytes =
      kRomInSmem ? static_cast<size_t>(KH) * KW * rom_len * sizeof(int32_t) : 0;
  const size_t smem = (kAsync ? 2 : 1) * win.elems() * sizeof(int32_t) + rom_bytes;
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  return launch_persistent<TS>(
      conv_pass_kcm_kernel<TS, KH, KW, kRomInSmem, kRomEachTile, kAsync, kTaps>, smem, stream, n, h, w, x, rom, rom_len, fill, carry_bits, out, n, h,
                           w, shift, post, vec);
}

template <bool kRomInSmem>
int launch_tiled(const int32_t* x, const int32_t* rom, int rom_len, int32_t fill, int carry_bits,
                 int32_t* out, int n, int h, int w, int kh, int kw, int shift, int post,
                 cudaStream_t stream) {
  const size_t win = static_cast<size_t>(kTileH + kh - 1) * (kTileW + kw - 1) * sizeof(int32_t);
  const size_t rom_bytes =
      kRomInSmem ? static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t) : 0;
  conv_pass_kcm_tiled_kernel<kRomInSmem><<<pass_grid(n, h, w), dim3(kTileW, kTileH),
                                           win + rom_bytes, stream>>>(
      x, rom, rom_len, fill, carry_bits, out, h, w, kh, kw, shift, post);
  return static_cast<int>(cudaGetLastError());
}

// Whether a kh x kw tap shape runs the persistent kernel: the bank's shapes
// (repro_torch.tuning.blocks.PERSISTENT_SHAPES); any other runs the tiled one.
inline bool kcm_persistent_shape(int kh, int kw) {
  return (kh == 3 && kw == 3) || (kh == 5 && kw == 5) || (kh == 1 && (kw == 3 || kw == 5)) ||
         (kw == 1 && (kh == 3 || kh == 5));
}

// The bank's tap shapes (3x3 direct, 3 and 5 taps a separable pass) run the
// persistent kernel compiled for their shape on the library's tile; any
// other shape the tiled one.
template <bool kRomInSmem>
int launch_kcm_shape(const int32_t* x, const int32_t* rom, int rom_len, int32_t fill,
                     int carry_bits, int32_t* out, int n, int h, int w, int kh, int kw,
                     int shift, int post, cudaStream_t stream) {
#define REPRO_KCM_SHAPE(KH, KW)                                                             \
  if (kh == KH && kw == KW)                                                                 \
    return launch_kcm<LibTile, KH, KW, kRomInSmem, false, true>(x, rom, rom_len, fill,     \
                                                                carry_bits, out, n, h, w,  \
                                                                shift, post, stream);
  REPRO_KCM_SHAPE(3, 3)
  REPRO_KCM_SHAPE(5, 5)
  REPRO_KCM_SHAPE(1, 3)
  REPRO_KCM_SHAPE(3, 1)
  REPRO_KCM_SHAPE(1, 5)
  REPRO_KCM_SHAPE(5, 1)
#undef REPRO_KCM_SHAPE
  return launch_tiled<kRomInSmem>(x, rom, rom_len, fill, carry_bits, out, n, h, w, kh, kw,
                                  shift, post, stream);
}

// conv_pass_recurse on the bank's tap shapes: the staging of the persistent
// kcm kernel (persistent_tiles, staging.cuh), TS::kRows rows a thread, and
// every product from the host plan by the tap policy `Taps` (multipliers.cuh).
template <class TS, int KH, int KW, class Taps>
__global__ void __launch_bounds__(TS::kThreads)
conv_pass_recurse_tiles_kernel(const int32_t* __restrict__ x,
                               const __grid_constant__ TapPlan<kPlanTaps> plan, uint32_t mask,
                               int stages, int32_t* __restrict__ out, int n, int h, int w,
                               int shift, int post, int vec) {
  extern __shared__ __align__(16) int32_t smem[];
  const KcmWindow<TS> ws(KH, KW);
  const int tx = threadIdx.x, r0 = threadIdx.y * TS::kRows;
  const int c = tx + ws.pad_l - KW / 2;              // window column of tap column 0
  const size_t plane = static_cast<size_t>(h) * w;
  persistent_tiles<TS, KH, KW>(x, n, h, w, vec, smem,
                               [&](const int32_t* win, int img, int y0, int x0) {
    uint32_t acc[TS::kRows] = {};
    recurse_rows<KH, KW, TS::kRows, Taps>(acc, win + r0 * ws.cols + c, ws.cols, plan, mask,
                                          stages);
    store_rows(out + img * plane, acc, h, w, x0 + tx, y0 + r0, shift, post);
  });
}

// The arguments of one recurse pass, as the C entry points take them.
struct RecursePass {
  const int32_t* x;
  const int32_t* taps;
  const int32_t* plan;
  int method, num_ecc, nbits;
  int32_t* out;
  int n, h, w, kh, kw, shift, post, chunk;
  cudaStream_t stream;
};

template <class TS, int KH, int KW, class Taps>
int launch_recurse_tiles(const RecursePass& a, const TapPlan<kPlanTaps>& plan, int stages) {
  const size_t smem = 2 * KcmWindow<TS>(KH, KW).elems() * sizeof(int32_t);
  const uint32_t mask = static_cast<uint32_t>((1ull << a.nbits) - 1);
  const int vec = a.w % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  return launch_persistent<TS>(conv_pass_recurse_tiles_kernel<TS, KH, KW, Taps>, smem,
                               a.stream, a.n, a.h, a.w, a.x, plan, mask, stages, a.out, a.n,
                               a.h, a.w, a.shift, a.post, vec);
}

// The chunks of the menu (with_chunk) are compiled for REFMLM's 8-bit
// policy at 3x3 taps, the Fig. 9 table's shape, which the tuner sweeps.
template <int KH, int KW, class Taps>
constexpr bool kChunkSwept = KH == 3 && KW == 3 && std::is_same_v<Taps, TableTaps<4>>;

template <int KH, int KW>
int recurse_shape(const RecursePass& a, const TapPlan<kPlanTaps>& plan, int stages) {
  return method_taps(a.method, a.nbits, [&](auto tag) {
    using Taps = typename decltype(tag)::type;
    return with_chunk<Taps, kChunkSwept<KH, KW, Taps>>(a.chunk, [&](auto ctag) {
      return launch_recurse_tiles<LibTile, KH, KW, typename decltype(ctag)::type>(a, plan,
                                                                                 stages);
    });
  });
}

// The persistent kernel, for the tap shapes it is compiled for; any other
// shape is refused.
int recurse_persistent(const RecursePass& a) {
  TapPlan<kPlanTaps> plan;
  int stages = 0;
  if (!load_plan(plan, stages, a.plan, a.kh * a.kw))
    return static_cast<int>(cudaErrorInvalidValue);
#define REPRO_RECURSE_SHAPE(KH, KW) \
  if (a.kh == KH && a.kw == KW) return recurse_shape<KH, KW>(a, plan, stages);
  REPRO_RECURSE_SHAPE(3, 3)
  REPRO_RECURSE_SHAPE(5, 5)
  REPRO_RECURSE_SHAPE(1, 3)
  REPRO_RECURSE_SHAPE(3, 1)
  REPRO_RECURSE_SHAPE(1, 5)
  REPRO_RECURSE_SHAPE(5, 1)
#undef REPRO_RECURSE_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tiled recurse kernel (the first design): any shape.
int recurse_tiled(const RecursePass& a) {
  Coeffs coeffs{};
  for (int i = 0; i < a.kh * a.kw; ++i) coeffs.v[i] = a.taps[i];
  const size_t smem =
      static_cast<size_t>(kTileH + a.kh - 1) * (kTileW + a.kw - 1) * sizeof(int32_t);
  const dim3 grid = pass_grid(a.n, a.h, a.w);
#define REPRO_TILED(M)                                                                  \
  case M:                                                                               \
    launch_recurse<M>(grid, smem, a.stream, a.x, coeffs, a.nbits, a.num_ecc, a.out, a.h, \
                      a.w, a.kh, a.kw, a.shift, a.post);                                \
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

// x, out: device (n, h, w) int32; rom: device (kh*kw, rom_len) int32 with the
// coefficient signs baked in; fill: what a gather past the ROM gives;
// carry_bits: 16 or 32, the reference's carry (RomStack in
// repro_torch.filters.conv). tile_rows x tile_cols: the tile to run, this
// library's (LibTile) for the persistent shapes, kTileH x kTileW for the
// tiled kernel's. Returns cudaGetLastError() after the launch.
extern "C" int conv_pass_kcm(const int32_t* x, const int32_t* rom, int rom_len, int32_t fill,
                             int carry_bits, int32_t* out, int n, int h, int w, int kh, int kw,
                             int shift, int post, int tile_rows, int tile_cols,
                             cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK || n < 1 || h < 1 || w < 1 ||
      (carry_bits != 16 && carry_bits != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (kcm_persistent_shape(kh, kw) ? !is_lib_tile(tile_rows, tile_cols)
                                   : (tile_rows != kTileH || tile_cols != kTileW))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rom_bytes = static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t);
  return rom_bytes <= kSmemRomBytes
             ? launch_kcm_shape<true>(x, rom, rom_len, fill, carry_bits, out, n, h, w, kh, kw,
                                      shift, post, stream)
             : launch_kcm_shape<false>(x, rom, rom_len, fill, carry_bits, out, n, h, w, kh, kw,
                                       shift, post, stream);
}

// conv_pass_kcm at 3x3 taps and an 8-bit ROM stack (in shared memory)
// through one of the measurement variants, on the library's tile: 0 the tiled kernel; the
// persistent kernel with 1 ROM per tile and stage_window, 2 ROM per tile and
// cp.async, 3 ROM once and stage_window, 4 ROM once and cp.async (=
// conv_pass_kcm); 5 as 4 without the taps (the window's centre pixel out:
// staging and stores alone, other bytes by design).
extern "C" int conv_pass_kcm_variant(const int32_t* x, const int32_t* rom, int rom_len,
                                     int32_t fill, int carry_bits, int32_t* out, int n, int h,
                                     int w, int kh, int kw, int shift, int post, int variant,
                                     cudaStream_t stream) {
  const size_t rom_bytes = static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t);
  if (kh != 3 || kw != 3 || n < 1 || h < 1 || w < 1 || rom_bytes > kSmemRomBytes ||
      (carry_bits != 16 && carry_bits != 32))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args =
      std::make_tuple(x, rom, rom_len, fill, carry_bits, out, n, h, w, shift, post, stream);
  switch (variant) {
    case 0:
      return launch_tiled<true>(x, rom, rom_len, fill, carry_bits, out, n, h, w, kh, kw, shift,
                                post, stream);
    case 1: return std::apply(launch_kcm<LibTile, 3, 3, true, true, false>, args);
    case 2: return std::apply(launch_kcm<LibTile, 3, 3, true, true, true>, args);
    case 3: return std::apply(launch_kcm<LibTile, 3, 3, true, false, false>, args);
    case 4: return std::apply(launch_kcm<LibTile, 3, 3, true, false, true>, args);
    case 5: return std::apply(launch_kcm<LibTile, 3, 3, true, false, true, false>, args);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// What the persistent instance on this library's tile for these arguments
// takes on this card (persistent_info: shared memory a block, blocks an
// SM, registers, local bytes into info[0..3]): kernel 0 conv_pass_kcm with
// a rom_len ROM stack, 1 conv_pass_recurse by (method, nbits)'s policy at
// the chunk (-1: its own). A shape without a persistent instance is
// refused. The stream is not used.
extern "C" int conv_pass_info(int kernel, int kh, int kw, int rom_len, int method, int nbits,
                              int chunk, int* info, cudaStream_t) {
  if (info == nullptr || !kcm_persistent_shape(kh, kw) || (kernel != 0 && kernel != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto shape = [&](auto khc, auto kwc) -> int {
    constexpr int KH = decltype(khc)::value, KW = decltype(kwc)::value;
    const size_t win = KcmWindow<LibTile>(KH, KW).elems() * sizeof(int32_t);
    if (kernel == 0) {
      const size_t rom = static_cast<size_t>(KH) * KW * rom_len * sizeof(int32_t);
      return rom <= kSmemRomBytes
                 ? persistent_info<LibTile>(
                       conv_pass_kcm_kernel<LibTile, KH, KW, true, false, true, true>,
                       2 * win + rom, info)
                 : persistent_info<LibTile>(
                       conv_pass_kcm_kernel<LibTile, KH, KW, false, false, true, true>,
                       2 * win, info);
    }
    return method_taps(method, nbits, [&](auto tag) {
      using Taps = typename decltype(tag)::type;
      return with_chunk<Taps, kChunkSwept<KH, KW, Taps>>(chunk, [&](auto ctag) {
        return persistent_info<LibTile>(
            conv_pass_recurse_tiles_kernel<LibTile, KH, KW, typename decltype(ctag)::type>,
            2 * win, info);
      });
    });
  };
  using I1 = std::integral_constant<int, 1>;
  using I3 = std::integral_constant<int, 3>;
  using I5 = std::integral_constant<int, 5>;
  if (kh == 3 && kw == 3) return shape(I3{}, I3{});
  if (kh == 5 && kw == 5) return shape(I5{}, I5{});
  if (kh == 1 && kw == 3) return shape(I1{}, I3{});
  if (kh == 3 && kw == 1) return shape(I3{}, I1{});
  if (kh == 1 && kw == 5) return shape(I1{}, I5{});
  return shape(I5{}, I1{});
}

// taps: host (kh*kw) int32 coefficient table; plan: host (kh*kw,
// kPlanWords) int32 plan words (repro_torch.filters.recurse_plan.plan_words)
// or null. With a plan the persistent kernel runs, for the tap shapes it is
// compiled for (repro_torch.filters.conv.kernel_route says which); with
// none the tiled kernel of the first design, for any shape. method:
// repro::Method; num_ecc is read by the tiled kMitchellEcc only (the plan
// holds the stages). chunk: the persistent kernel's rows a thread holds at
// once (Taps::kChunk), -1 for the policy's own, another of 0, 4, 8, 16 only
// where kChunkSwept. tile_rows x tile_cols: this library's tile with a plan,
// kTileH x kTileW without.
extern "C" int conv_pass_recurse(const int32_t* x, const int32_t* taps, const int32_t* plan,
                                 int method, int num_ecc, int nbits, int32_t* out, int n,
                                 int h, int w, int kh, int kw, int shift, int post, int chunk,
                                 int tile_rows, int tile_cols, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK || n < 1 || h < 1 || w < 1 || nbits < 1 ||
      nbits > 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (plan != nullptr ? !is_lib_tile(tile_rows, tile_cols)
                      : (tile_rows != kTileH || tile_cols != kTileW || chunk != -1))
    return static_cast<int>(cudaErrorInvalidValue);
  const RecursePass a{x, taps, plan, method, num_ecc, nbits, out, n, h, w, kh, kw,
                      shift, post, chunk, stream};
  return plan == nullptr ? recurse_tiled(a) : recurse_persistent(a);
}

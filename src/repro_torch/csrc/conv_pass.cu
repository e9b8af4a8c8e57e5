// One direct convolution pass of the integer filter datapath:
// (N, H, W) int32 -> (N, H, W) int32,
//   out[p] = post( sum over kh x kw taps of sgn(t) * sgn(c) * mult(|t|, |c|) )
// with zero padding and a wrapping int32 sum.
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
// operations per tap (16 2x2 base products per tap for 8-bit REFMLM, 64 at
// 16 bits).
//
// conv_pass_kcm: a persistent grid (as many 128-thread blocks as the SMs
// hold at once) walks over 64 x 32 output tiles. Each block stages an 8-bit
// ROM stack (<= 32 KB) in shared memory once, not once per tile; a 16-bit
// one (65,536 entries per tap, the two-pass second pass) is read from
// global memory through the read-only path and stays in L2. A tile's input
// window, with its halo and zeros outside the image (the reference's zero
// padding, so no batch fold and no halo views), is copied row by row with
// cp.async into one of two shared buffers while the block computes the
// tile before it: 16-byte copies from a 4-aligned column where the rows
// allow it (W % 4 == 0), else 4-byte copies, with no divide per element.
// A thread owns 16 rows of one column, so each window element it needs is
// read from shared memory kw times (once per tap column) and reused over
// the kh tap rows from registers, not read kh * kw times.
//
// conv_pass_recurse: grid = (tiles_x, tiles_y, N), one output pixel per
// thread on a 32 x 16 tile; the block stages its (16 + kh - 1) x (32 + kw -
// 1) window in shared memory (stage_window) before computing.
//
// Tap shapes other than the bank's (3x3, 5x5, 1x3, 3x1, 1x5, 5x1) run the
// tiled kcm kernel, which stages like conv_pass_recurse below.
//
// conv_pass_kcm_variant runs the 3x3 kcm pass through the design above with
// its parts switched one at a time (ROM once or per tile, cp.async window
// or stage_window, no taps), or through the tiled kernel, so that one run
// can time where the difference lies; no entry point of the port calls it.
#include <algorithm>
#include <mutex>
#include <tuple>

#include "multipliers.cuh"

namespace repro {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr size_t kSmemRomBytes = 32 * 1024;

// The tiled kcm kernel: one output pixel a thread on a 32 x 16 tile, the
// ROM stack and the window staged for every tile. It runs the tap shapes
// the persistent kernel is not compiled for, and is measurement variant 0.
template <bool kRomInSmem>
__global__ void __launch_bounds__(kTileW * kTileH)
conv_pass_kcm_tiled_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rom,
                     int rom_len, int32_t* __restrict__ out, int h, int w, int kh,
                     int kw, int shift, int post) {
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
      acc += kcm_term(table, rom_len, di * kw + dj, win[(ty + di) * ww + tx + dj]);
  out[blockIdx.z * plane + static_cast<size_t>(oy) * w + ox] = apply_post(acc, post, shift);
}

constexpr int kKcmTileW = 64;
constexpr int kKcmRows = 16;                         // output rows a thread
constexpr int kKcmGroups = 2;                        // threads per column
constexpr int kKcmTileH = kKcmRows * kKcmGroups;
constexpr int kKcmThreads = kKcmTileW * kKcmGroups;

// Window of a kcm tile: rows from y0 - kh/2, `cols` (a multiple of 4)
// columns from x0 - pad_l, pad_l = kw/2 rounded up to 4 so that the window
// starts 16-byte aligned when the rows do.
struct KcmWindow {
  int pad_l, cols, rows;
  __host__ __device__ KcmWindow(int kh, int kw)
      : pad_l((kw / 2 + 3) & ~3),
        cols((((kw / 2 + 3) & ~3) + kKcmTileW + kw - 1 - kw / 2 + 3) & ~3),
        rows(kKcmTileH + kh - 1) {}
  __host__ __device__ int elems() const { return rows * cols; }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// cp.async of 16 or 4 bytes; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

// Issue the copies of an (rows x cols) window whose top-left pixel is
// (y0, xs) into `win`, zeros outside the image: a warp a row, a lane a
// 16-byte chunk (vec: w % 4 == 0, xs % 4 == 0, img 16-byte aligned) or an
// element.
__device__ __forceinline__ void issue_window(int32_t* win, const int32_t* __restrict__ img,
                                             int h, int w, int y0, int xs, int rows,
                                             int cols, bool vec) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid % 32, nwarps = blockDim.x * blockDim.y / 32;
  for (int r = tid / 32; r < rows; r += nwarps) {
    const int y = y0 + r;
    const bool row_in = y >= 0 && y < h;
    const int32_t* src = img + static_cast<size_t>(row_in ? y : 0) * w;
    int32_t* dst = win + r * cols;
    if (vec) {
      for (int q = lane; q < cols / 4; q += 32) {
        const int xq = xs + 4 * q;
        const bool in = row_in && xq >= 0 && xq < w;
        cp_async16(dst + 4 * q, in ? src + xq : img, in ? 16 : 0);
      }
    } else {
      for (int c = lane; c < cols; c += 32) {
        const int xc = xs + c;
        const bool in = row_in && xc >= 0 && xc < w;
        cp_async4(dst + c, in ? src + xc : img, in ? 4 : 0);
      }
    }
  }
}

// The kKcmRows sums of one thread for a KH x KW tap shape: window row wr
// (from the thread's first row) holds tap row wr - i of output row i, so
// each element is read once per tap column and reused for every tap row
// from a register. Every loop unrolls and the tap-row tests fold away.
template <int KH, int KW>
__device__ __forceinline__ void kcm_rows(uint32_t (&acc)[kKcmRows], const int32_t* win,
                                         int cols, const int32_t* table, int rom_len) {
#pragma unroll
  for (int wr = 0; wr < kKcmRows + KH - 1; ++wr) {
    int32_t v[KW];
#pragma unroll
    for (int dj = 0; dj < KW; ++dj) v[dj] = win[wr * cols + dj];
#pragma unroll
    for (int i = 0; i < kKcmRows; ++i) {
      const int di = wr - i;
      if (di >= 0 && di < KH) {
#pragma unroll
        for (int dj = 0; dj < KW; ++dj) acc[i] += kcm_term(table, rom_len, di * KW + dj, v[dj]);
      }
    }
  }
}

// KH x KW: the tap shape; kRomInSmem: the ROM stack is copied to shared
// memory (8-bit ROMs); kRomEachTile: copied again for every tile (a measurement variant);
// kAsync: the next tile's window is copied with cp.async during this one's
// compute, else each tile stages its window with stage_window (a variant);
// kTaps false: no tap products, the output is the window's centre pixel
// (a variant that times the staging and the stores alone).
template <int KH, int KW, bool kRomInSmem, bool kRomEachTile, bool kAsync, bool kTaps>
__global__ void __launch_bounds__(kKcmThreads)
conv_pass_kcm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rom,
                     int rom_len, int32_t* __restrict__ out, int n, int h, int w,
                     int shift, int post, int vec) {
  extern __shared__ __align__(16) int32_t smem[];
  constexpr int kh = KH, kw = KW;
  const KcmWindow win_shape(kh, kw);
  const int cols = win_shape.cols, rows = win_shape.rows;
  const int win_elems = win_shape.elems();
  int32_t* srom = smem + (kAsync ? 2 : 1) * win_elems;
  const int32_t* table = kRomInSmem ? srom : rom;
  const int rom_count = kh * kw * rom_len;
  if constexpr (kRomInSmem && !kRomEachTile) stage_rom(srom, rom, rom_count);

  const size_t plane = static_cast<size_t>(h) * w;
  const int tiles_x = (w + kKcmTileW - 1) / kKcmTileW;
  const int tiles_y = (h + kKcmTileH - 1) / kKcmTileH;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  const long long stride = gridDim.x;
  auto origin = [&](long long t, int& img, int& y0, int& x0) {
    x0 = static_cast<int>(t % tiles_x) * kKcmTileW;
    const long long rest = t / tiles_x;
    y0 = static_cast<int>(rest % tiles_y) * kKcmTileH;
    img = static_cast<int>(rest / tiles_y);
  };

  long long t = blockIdx.x;
  int buf = 0;
  if constexpr (kAsync) {
    if (t < tiles) {
      int img, y0, x0;
      origin(t, img, y0, x0);
      issue_window(smem, x + img * plane, h, w, y0 - kh / 2, x0 - win_shape.pad_l,
                   rows, cols, vec);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  const int tx = threadIdx.x, r0 = threadIdx.y * kKcmRows;
  const int c = tx + win_shape.pad_l - kw / 2;       // window column of tap column 0
  for (; t < tiles; t += stride) {
    int img, y0, x0;
    origin(t, img, y0, x0);
    const int32_t* win = smem + buf * win_elems;
    if constexpr (kAsync) {
      if (t + stride < tiles) {
        int nimg, ny0, nx0;
        origin(t + stride, nimg, ny0, nx0);
        issue_window(smem + (buf ^ 1) * win_elems, x + nimg * plane, h, w, ny0 - kh / 2,
                     nx0 - win_shape.pad_l, rows, cols, vec);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      stage_window(smem, x + img * plane, h, w, y0 - kh / 2, x0 - win_shape.pad_l, rows, cols);
    }
    if constexpr (kRomInSmem && kRomEachTile) stage_rom(srom, rom, rom_count);
    __syncthreads();

    uint32_t acc[kKcmRows] = {};
    if constexpr (!kTaps) {           // a variant: the window's centre pixel, no taps
#pragma unroll
      for (int i = 0; i < kKcmRows; ++i) acc[i] = win[(r0 + i + kh / 2) * cols + c + kw / 2];
    } else {
      kcm_rows<KH, KW>(acc, win + r0 * cols + c, cols, table, rom_len);
    }
    const int ox = x0 + tx;
    if (ox < w) {
      int32_t* dst = out + img * plane + ox;
#pragma unroll
      for (int i = 0; i < kKcmRows; ++i) {
        const int oy = y0 + r0 + i;
        if (oy < h) dst[static_cast<size_t>(oy) * w] = apply_post(acc[i], post, shift);
      }
    }
    __syncthreads();
    if constexpr (kAsync) buf ^= 1;
  }
  if constexpr (kAsync) asm volatile("cp.async.wait_group 0;\n" ::);
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

// Launch the persistent kcm kernel: as many blocks as the SMs hold at once
// at this shared-memory size, at most one per tile.
template <int KH, int KW, bool kRomInSmem, bool kRomEachTile, bool kAsync,
          bool kTaps = true>
int launch_kcm(const int32_t* x, const int32_t* rom, int rom_len, int32_t* out, int n,
               int h, int w, int shift, int post, cudaStream_t stream) {
  const KcmWindow win(KH, KW);
  const size_t rom_bytes =
      kRomInSmem ? static_cast<size_t>(KH) * KW * rom_len * sizeof(int32_t) : 0;
  const size_t smem = (kAsync ? 2 : 1) * win.elems() * sizeof(int32_t) + rom_bytes;
  auto kernel = conv_pass_kcm_kernel<KH, KW, kRomInSmem, kRomEachTile, kAsync, kTaps>;
  // The shared-memory limit and the resident block count, queried once per
  // device and size: the queries cost more host time than a small launch.
  static std::mutex mu;
  static int cached_dev = -1, cached_blocks = 0;
  static size_t cached_smem = 0;
  int dev = 0, resident = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && (dev != cached_dev || smem != cached_smem)) {
      int sms = 0, per_sm = 0;
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kKcmThreads, smem);
      if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
      if (err == cudaSuccess) {
        cached_dev = dev;
        cached_smem = smem;
        cached_blocks = per_sm * sms;
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = cached_blocks;
  }
  const long long tiles = static_cast<long long>(n) * ((w + kKcmTileW - 1) / kKcmTileW) *
                          ((h + kKcmTileH - 1) / kKcmTileH);
  const int blocks = static_cast<int>(std::min<long long>(tiles, resident));
  const int vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<blocks, dim3(kKcmTileW, kKcmGroups), smem, stream>>>(
      x, rom, rom_len, out, n, h, w, shift, post, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kRomInSmem>
int launch_tiled(const int32_t* x, const int32_t* rom, int rom_len, int32_t* out, int n,
                 int h, int w, int kh, int kw, int shift, int post, cudaStream_t stream) {
  const size_t win = static_cast<size_t>(kTileH + kh - 1) * (kTileW + kw - 1) * sizeof(int32_t);
  const size_t rom_bytes =
      kRomInSmem ? static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t) : 0;
  conv_pass_kcm_tiled_kernel<kRomInSmem><<<pass_grid(n, h, w), dim3(kTileW, kTileH),
                                           win + rom_bytes, stream>>>(
      x, rom, rom_len, out, h, w, kh, kw, shift, post);
  return static_cast<int>(cudaGetLastError());
}

// The bank's tap shapes (3x3 direct, 3 and 5 taps a separable pass) run the
// persistent kernel compiled for their shape; any other shape the tiled one.
template <bool kRomInSmem>
int launch_kcm_shape(const int32_t* x, const int32_t* rom, int rom_len, int32_t* out, int n,
                     int h, int w, int kh, int kw, int shift, int post, cudaStream_t stream) {
#define REPRO_KCM_SHAPE(KH, KW)                                                           \
  if (kh == KH && kw == KW)                                                               \
    return launch_kcm<KH, KW, kRomInSmem, false, true>(x, rom, rom_len, out, n, h, w,    \
                                                       shift, post, stream);
  REPRO_KCM_SHAPE(3, 3)
  REPRO_KCM_SHAPE(5, 5)
  REPRO_KCM_SHAPE(1, 3)
  REPRO_KCM_SHAPE(3, 1)
  REPRO_KCM_SHAPE(1, 5)
  REPRO_KCM_SHAPE(5, 1)
#undef REPRO_KCM_SHAPE
  return launch_tiled<kRomInSmem>(x, rom, rom_len, out, n, h, w, kh, kw, shift, post, stream);
}

}  // namespace repro

using namespace repro;

// x, out: device (n, h, w) int32; rom: device (kh*kw, rom_len) int32 with the
// coefficient signs baked in. Returns cudaGetLastError() after the launch.
extern "C" int conv_pass_kcm(const int32_t* x, const int32_t* rom, int rom_len,
                             int32_t* out, int n, int h, int w, int kh, int kw,
                             int shift, int post, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK || n < 1 || h < 1 || w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rom_bytes = static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t);
  return rom_bytes <= kSmemRomBytes
             ? launch_kcm_shape<true>(x, rom, rom_len, out, n, h, w, kh, kw, shift, post, stream)
             : launch_kcm_shape<false>(x, rom, rom_len, out, n, h, w, kh, kw, shift, post, stream);
}

// conv_pass_kcm at 3x3 taps and an 8-bit ROM stack (in shared memory)
// through one of the measurement variants: 0 the tiled kernel; the
// persistent kernel with 1 ROM per tile and stage_window, 2 ROM per tile and
// cp.async, 3 ROM once and stage_window, 4 ROM once and cp.async (=
// conv_pass_kcm); 5 as 4 without the taps (the window's centre pixel out:
// staging and stores alone, other bytes by design).
extern "C" int conv_pass_kcm_variant(const int32_t* x, const int32_t* rom, int rom_len,
                                     int32_t* out, int n, int h, int w, int kh, int kw,
                                     int shift, int post, int variant,
                                     cudaStream_t stream) {
  const size_t rom_bytes = static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t);
  if (kh != 3 || kw != 3 || n < 1 || h < 1 || w < 1 || rom_bytes > kSmemRomBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto args = std::make_tuple(x, rom, rom_len, out, n, h, w, shift, post, stream);
  switch (variant) {
    case 0: return launch_tiled<true>(x, rom, rom_len, out, n, h, w, kh, kw, shift, post, stream);
    case 1: return std::apply(launch_kcm<3, 3, true, true, false>, args);
    case 2: return std::apply(launch_kcm<3, 3, true, true, true>, args);
    case 3: return std::apply(launch_kcm<3, 3, true, false, false>, args);
    case 4: return std::apply(launch_kcm<3, 3, true, false, true>, args);
    case 5: return std::apply(launch_kcm<3, 3, true, false, true, false>, args);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// taps: host (kh*kw) int32 coefficient table, passed to the kernel by value.
// method: repro::Method; num_ecc is read by kMitchellEcc only.
extern "C" int conv_pass_recurse(const int32_t* x, const int32_t* taps, int method,
                                 int num_ecc, int nbits, int32_t* out, int n, int h,
                                 int w, int kh, int kw, int shift, int post,
                                 cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  Coeffs coeffs{};
  for (int i = 0; i < kh * kw; ++i) coeffs.v[i] = taps[i];
  const size_t smem = static_cast<size_t>(kTileH + kh - 1) * (kTileW + kw - 1) * sizeof(int32_t);
  const dim3 grid = pass_grid(n, h, w);
  switch (method) {
    case kExact: launch_recurse<kExact>(grid, smem, stream, x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kRefmlm: launch_recurse<kRefmlm>(grid, smem, stream, x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kRefmlmNc: launch_recurse<kRefmlmNc>(grid, smem, stream, x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kMitchell: launch_recurse<kMitchell>(grid, smem, stream, x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kMitchellEcc: launch_recurse<kMitchellEcc>(grid, smem, stream, x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kOdma: launch_recurse<kOdma>(grid, smem, stream, x, coeffs, nbits, num_ecc, out, h, w, kh, kw, shift, post); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

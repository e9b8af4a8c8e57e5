// Window staging of the persistent conv kernels (conv_pass.cu,
// fused_separable.cu): a persistent grid walks over output tiles of a
// TileShape (W columns x 2R rows); a tile's input window, with its halo and zeros outside the image (the
// reference's zero padding), is copied with cp.async into one of two shared
// buffers while the block computes the tile before it: 16-byte copies from
// a 4-aligned column where the rows allow it (W % 4 == 0), else 4-byte
// copies, with no divide per element. A block has two groups of W threads;
// a thread owns R output rows of one column.
#pragma once

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "multipliers.cuh"

namespace repro {

// The output tile of one block of a persistent kernel, a template
// parameter of all four: R output rows a thread, W columns, kGroups threads
// a column, so W * kGroups threads compute kHeight = R * kGroups rows.
template <int R, int W>
struct TileShape {
  static constexpr int kRows = R, kWidth = W, kGroups = 2;
  static constexpr int kHeight = R * kGroups, kThreads = W * kGroups;
};

// The tile a library is compiled for: repro_torch.kernels.build compiles
// conv_pass.cu and fused_separable.cu once per tile of the persistent menu
// (repro_torch.tuning.blocks.TILE_MENU), each into its own library, with
// -DREPRO_TILE_ROWS and -DREPRO_TILE_COLS; the default is the first tile.
#ifndef REPRO_TILE_ROWS
#define REPRO_TILE_ROWS 32
#endif
#ifndef REPRO_TILE_COLS
#define REPRO_TILE_COLS 64
#endif
using LibTile = TileShape<REPRO_TILE_ROWS / 2, REPRO_TILE_COLS>;
static_assert(LibTile::kHeight == REPRO_TILE_ROWS && LibTile::kWidth % 32 == 0,
              "a tile is an even number of rows and whole warps wide");

// Whether (rows, cols), as a C entry takes them, is this library's tile.
inline bool is_lib_tile(int rows, int cols) {
  return rows == LibTile::kHeight && cols == LibTile::kWidth;
}

// Window of a TS tile: rows from y0 - kh/2, `cols` (a multiple of 4)
// columns from x0 - pad_l, pad_l = kw/2 rounded up to 4 so that the window
// starts 16-byte aligned when the rows do.
template <class TS>
struct KcmWindow {
  int pad_l, cols, rows;
  __host__ __device__ KcmWindow(int kh, int kw)
      : pad_l((kw / 2 + 3) & ~3),
        cols((((kw / 2 + 3) & ~3) + TS::kWidth + kw - 1 - kw / 2 + 3) & ~3),
        rows(TS::kHeight + kh - 1) {}
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

// Walk this block over its TS tiles of the (n, h, w) batch x for a KH x KW
// tap shape: `tile(win, img, y0, x0)` computes and stores the tile whose window
// is `win` (every thread calls it; it may synchronise the block). kAsync:
// the windows live in smem[0, 2 * window elems), the next tile's copied
// with cp.async while this one computes; else (a measurement variant) each
// tile stages its window into smem[0, window elems) with stage_window.
template <class TS, int KH, int KW, bool kAsync = true, class Tile>
__device__ __forceinline__ void persistent_tiles(const int32_t* __restrict__ x, int n, int h,
                                                 int w, int vec, int32_t* smem, Tile&& tile) {
  const KcmWindow<TS> ws(KH, KW);
  const int win_elems = ws.elems();
  const size_t plane = static_cast<size_t>(h) * w;
  const int tiles_x = (w + TS::kWidth - 1) / TS::kWidth;
  const int tiles_y = (h + TS::kHeight - 1) / TS::kHeight;
  const long long tiles = static_cast<long long>(n) * tiles_x * tiles_y;
  const long long stride = gridDim.x;
  auto origin = [&](long long t, int& img, int& y0, int& x0) {
    x0 = static_cast<int>(t % tiles_x) * TS::kWidth;
    const long long rest = t / tiles_x;
    y0 = static_cast<int>(rest % tiles_y) * TS::kHeight;
    img = static_cast<int>(rest / tiles_y);
  };
  long long t = blockIdx.x;
  int buf = 0;
  if constexpr (kAsync) {
    if (t < tiles) {
      int img, y0, x0;
      origin(t, img, y0, x0);
      issue_window(smem, x + img * plane, h, w, y0 - KH / 2, x0 - ws.pad_l, ws.rows, ws.cols,
                   vec);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (; t < tiles; t += stride) {
    int img, y0, x0;
    origin(t, img, y0, x0);
    if constexpr (kAsync) {
      if (t + stride < tiles) {
        int nimg, ny0, nx0;
        origin(t + stride, nimg, ny0, nx0);
        issue_window(smem + (buf ^ 1) * win_elems, x + nimg * plane, h, w, ny0 - KH / 2,
                     nx0 - ws.pad_l, ws.rows, ws.cols, vec);
      }
      asm volatile("cp.async.commit_group;\n" ::);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      stage_window(smem, x + img * plane, h, w, y0 - KH / 2, x0 - ws.pad_l, ws.rows, ws.cols);
    }
    __syncthreads();
    tile(smem + buf * win_elems, img, y0, x0);
    __syncthreads();
    if constexpr (kAsync) buf ^= 1;
  }
  if constexpr (kAsync) asm volatile("cp.async.wait_group 0;\n" ::);
}

// Store a thread's R sums of output column ox from row oy0 through the
// epilogue, inside the image only.
template <int R>
__device__ __forceinline__ void store_rows(int32_t* __restrict__ img_out, const uint32_t (&acc)[R],
                                           int h, int w, int ox, int oy0, int shift, int post) {
  if (ox >= w) return;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int oy = oy0 + i;
    if (oy < h) img_out[static_cast<size_t>(oy) * w + ox] = apply_post(acc[i], post, shift);
  }
}

// Blocks of `kernel` (of `threads` threads) that one SM holds at once at
// `smem` bytes of dynamic shared memory, and the SMs of the current device. The limit is raised to
// the largest size asked for (never lowered: an instance may run at several
// sizes) and the counts are cached per kernel, device and size: the
// queries cost more host time than a small launch.
template <class Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem, int& per_sm, int& sms) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, std::pair<int, int>> resident;
  static std::map<std::pair<const void*, int>, size_t> limit;
  const void* key = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  auto it = resident.find({key, dev, smem});
  if (it == resident.end()) {
    size_t& set = limit[{key, dev}];
    if (smem > set) {
      err = cudaFuncSetAttribute(key, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err == cudaSuccess) set = smem;
    }
    int count = 0, sm_count = 0;
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, key, threads, smem);
    if (err == cudaSuccess && count < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return err;
    it = resident.emplace(std::make_tuple(key, dev, smem), std::make_pair(count, sm_count)).first;
  }
  per_sm = it->second.first;
  sms = it->second.second;
  return cudaSuccess;
}

// What a persistent instance takes on this card at `smem` bytes of dynamic
// shared memory: info[0] those bytes, info[1] the blocks an SM holds at
// once, info[2] registers a thread, info[3] local (spill) bytes a thread.
template <class TS, class Kernel>
int persistent_info(Kernel kernel, size_t smem, int* info) {
  int per_sm = 0, sms = 0;
  cudaFuncAttributes attr{};
  cudaError_t err = resident_blocks(kernel, TS::kThreads, smem, per_sm, sms);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  info[0] = static_cast<int>(smem);
  info[1] = per_sm;
  info[2] = attr.numRegs;
  info[3] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(err);
}

// Launch a persistent kernel with `kernel_args` over the TS tiles of an
// (n, h, w) batch: as many blocks as the SMs hold at once at this
// shared-memory size, at most one a tile.
template <class TS, class Kernel, class... Args>
int launch_persistent(Kernel kernel, size_t smem, cudaStream_t stream, int n, int h, int w,
                      Args... kernel_args) {
  int per_sm = 0, sms = 0;
  const cudaError_t err = resident_blocks(kernel, TS::kThreads, smem, per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(n) * ((w + TS::kWidth - 1) / TS::kWidth) *
                          ((h + TS::kHeight - 1) / TS::kHeight);
  const int blocks = static_cast<int>(std::min<long long>(tiles, 1ll * per_sm * sms));
  kernel<<<blocks, dim3(TS::kWidth, TS::kGroups), smem, stream>>>(kernel_args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

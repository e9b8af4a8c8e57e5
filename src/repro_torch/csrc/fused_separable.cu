// Both passes of a separable filter in one kernel:
// (N, H, W) int32 -> (N, H, W) int32,
//   r[y, x]   = sum over kw row taps of sgn(t) * sgn(c) * mult(|t|, |c|)   at nbits
//   out[y, x] = post( sum over kh column taps of the same on r )           at nbits2
// with zero padding and wrapping int32 sums. Bit-identical to a row pass with
// post='none' followed by a column pass (the two-pass dataflow).
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
// SM -- so it is bound by memory bandwidth, with the column pass's gathers
// from the 16-bit ROMs served by L2; the recurse variant is bound by integer
// operations per tap (the column pass runs REFMLM at 16 bits: 64 2x2 base
// products per tap).
//
// Design: grid = (tiles_x, tiles_y, N) over 32 x 16 output tiles, one output
// pixel per thread. The block stages its (16 + kh - 1) x (32 + kw - 1) input
// window in shared memory (zeros outside the image), computes the row pass
// for its 16 rows plus kh - 1 halo rows into an int32 band in shared memory,
// synchronises, then runs the column pass and the epilogue. Band rows
// outside the image are 0, exactly what the reference's zero-padded input
// gives. An 8-bit ROM (<= 16 KB) is staged in shared memory; a 16-bit ROM
// (65,536 entries per tap, too large for the 227 KB of shared memory) is
// read from global memory through the read-only path and stays in L2.
#include "multipliers.cuh"

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
                           int row_len, const int32_t* __restrict__ col_rom, int col_len,
                           int32_t* __restrict__ out, int h, int w, int kh, int kw,
                           int shift, int post) {
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
           [&](int dj, int32_t t) { return kcm_term(rtab, row_len, dj, t); });
  __syncthreads();

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ox = x0 + tx, oy = y0 + ty;
  if (ox >= w || oy >= h) return;
  uint32_t acc = 0u;
  for (int di = 0; di < kh; ++di)
    acc += kcm_term(ctab, col_len, di, band[(ty + di) * kTileW + tx]);
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

}  // namespace repro

using namespace repro;

// x, out: device (n, h, w) int32; row_rom: device (kw, row_len) int32 at
// nbits; col_rom: device (kh, col_len) int32 at nbits2; signs baked in.
// Returns cudaGetLastError() after the launch.
extern "C" int fused_separable_kcm(const int32_t* x, const int32_t* row_rom, int row_len,
                                   const int32_t* col_rom, int col_len, int32_t* out,
                                   int n, int h, int w, int kh, int kw, int shift,
                                   int post, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t row_bytes = static_cast<size_t>(kw) * row_len * sizeof(int32_t);
  const size_t col_bytes = static_cast<size_t>(kh) * col_len * sizeof(int32_t);
  const bool row_smem = row_bytes <= kSmemRomBytes, col_smem = col_bytes <= kSmemRomBytes;
  const size_t smem = fused_smem(kh, kw) + (row_smem ? row_bytes : 0) + (col_smem ? col_bytes : 0);
  const dim3 grid = fused_grid(n, h, w), block(kTileW, kTileH);
  if (row_smem && col_smem)
    fused_separable_kcm_kernel<true, true><<<grid, block, smem, stream>>>(
        x, row_rom, row_len, col_rom, col_len, out, h, w, kh, kw, shift, post);
  else if (row_smem)
    fused_separable_kcm_kernel<true, false><<<grid, block, smem, stream>>>(
        x, row_rom, row_len, col_rom, col_len, out, h, w, kh, kw, shift, post);
  else if (col_smem)
    fused_separable_kcm_kernel<false, true><<<grid, block, smem, stream>>>(
        x, row_rom, row_len, col_rom, col_len, out, h, w, kh, kw, shift, post);
  else
    fused_separable_kcm_kernel<false, false><<<grid, block, smem, stream>>>(
        x, row_rom, row_len, col_rom, col_len, out, h, w, kh, kw, shift, post);
  return static_cast<int>(cudaGetLastError());
}

// row: host (kw,) and col: host (kh,) int32 coefficients, passed by value.
// method: repro::Method; num_ecc is read by kMitchellEcc only.
extern "C" int fused_separable_recurse(const int32_t* x, const int32_t* row,
                                       const int32_t* col, int method, int num_ecc,
                                       int nbits, int nbits2, int32_t* out, int n, int h,
                                       int w, int kh, int kw, int shift, int post,
                                       cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  Coeffs1d r{}, c{};
  for (int i = 0; i < kw; ++i) r.v[i] = row[i];
  for (int i = 0; i < kh; ++i) c.v[i] = col[i];
  const size_t smem = fused_smem(kh, kw);
  const dim3 grid = fused_grid(n, h, w);
  switch (method) {
    case kExact: launch_recurse<kExact>(grid, smem, stream, x, r, c, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kRefmlm: launch_recurse<kRefmlm>(grid, smem, stream, x, r, c, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kRefmlmNc: launch_recurse<kRefmlmNc>(grid, smem, stream, x, r, c, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kMitchell: launch_recurse<kMitchell>(grid, smem, stream, x, r, c, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kMitchellEcc: launch_recurse<kMitchellEcc>(grid, smem, stream, x, r, c, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post); break;
    case kOdma: launch_recurse<kOdma>(grid, smem, stream, x, r, c, nbits, nbits2, num_ecc, out, h, w, kh, kw, shift, post); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

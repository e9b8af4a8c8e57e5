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
// Design: grid = (tiles_x, tiles_y, N), one output pixel per thread on a
// 32 x 16 tile. The block stages its (16 + kh - 1) x (32 + kw - 1) input
// window in shared memory with zeros outside the image (the reference's zero
// padding, so no batch fold and no halo views), so every input pixel is read
// from HBM about once. An 8-bit ROM stack (<= 32 KB) is staged in shared
// memory; a 16-bit one (65,536 entries per tap, the two-pass second pass) is
// read from global memory through the read-only path and stays in L2.
#include "multipliers.cuh"

namespace repro {

constexpr int kTileW = 32;
constexpr int kTileH = 16;
constexpr size_t kSmemRomBytes = 32 * 1024;

template <bool kRomInSmem>
__global__ void __launch_bounds__(kTileW * kTileH)
conv_pass_kcm_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ rom,
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

}  // namespace repro

using namespace repro;

// x, out: device (n, h, w) int32; rom: device (kh*kw, rom_len) int32 with the
// coefficient signs baked in. Returns cudaGetLastError() after the launch.
extern "C" int conv_pass_kcm(const int32_t* x, const int32_t* rom, int rom_len,
                             int32_t* out, int n, int h, int w, int kh, int kw,
                             int shift, int post, cudaStream_t stream) {
  if (kh < 1 || kw < 1 || kh > kMaxK || kw > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t win = static_cast<size_t>(kTileH + kh - 1) * (kTileW + kw - 1) * sizeof(int32_t);
  const size_t rom_bytes = static_cast<size_t>(kh) * kw * rom_len * sizeof(int32_t);
  const dim3 grid = pass_grid(n, h, w), block(kTileW, kTileH);
  if (rom_bytes <= kSmemRomBytes)
    conv_pass_kcm_kernel<true><<<grid, block, win + rom_bytes, stream>>>(
        x, rom, rom_len, out, h, w, kh, kw, shift, post);
  else
    conv_pass_kcm_kernel<false><<<grid, block, win, stream>>>(
        x, rom, rom_len, out, h, w, kh, kw, shift, post);
  return static_cast<int>(cudaGetLastError());
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

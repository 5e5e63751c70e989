// General 2-D Richardson-Lucy iterations on one image, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel built by thz_image_explorer_tpu/ops/
// pallas_rl.py:_make_kernel (launched by richardson_lucy_pallas). Same
// function: starting from u = P, the (h2, w2) padded image, n_iter times
//     u <- u * corr(P / (corr(u, K) + 1e-12), K mirrored)
// with the (kr, kc) PSF K and the zero-boundary correlation
//     corr(x, K)[i, j] = sum_{a, b} K[a, b] x[i + a - kr / 2, j + b - kc / 2]
// (x = 0 outside the image). The mirror pass reads tap (kr-1-a, kc-1-b). For
// odd kr and kc this is XLA's "SAME" correlation; for an even one the window
// sits one sample further down than "SAME" puts it, as in the TPU kernel.
//
// Bound on this card: operations. The function reads P and writes u once
// (8 bytes a pixel), but does 2 kr kc FMAs plus a division and a multiply a
// pixel and iteration: n_iter * h2 * w2 * (4 kr kc + 3) operations, ~4e9 at a
// 246 x 256 canvas, 9 x 9 taps and 200 iterations (~0.06 ms at the 67 TFLOP/s
// f32 peak). The iterations are dependent, so launch latency dominates at
// small images.
//
// What the design does about it. Two launches per iteration, each over the
// whole image: the first writes rel = P / (corr(u, K) + 1e-12) to a scratch
// buffer, the second multiplies u in place by corr(rel, K mirrored) (it reads
// rel with halos and u only at its own pixel). Each block stages a tile of
// 32 columns x tile_h rows of its source with a (kr/2, kc/2) halo in shared
// memory, beside the kr kc taps (read as broadcasts; lane j reads tile column
// j + b, so no bank conflicts), and every thread sums its pixels' taps in
// registers. The tile height shrinks from 32 rows to 1 until the taps and
// the tile fit a block's shared memory; only when even one row does not fit
// does the launch fail. The TPU's 81-tap cap (a Mosaic limit) does not
// apply. Built without --use_fast_math: the division is IEEE. No atomics:
// reruns are bit-identical.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTileW = 32;   // columns per block: one warp wide
constexpr int kRowsY = 8;    // threadIdx.y extent; block = 32 x 8 threads
constexpr int kThreads = kTileW * kRowsY;

// SECOND == false: dst = rel = padded / (corr(src, K) + 1e-12), src = u.
// SECOND == true:  dst = u   = u * corr(src, K mirrored),      src = rel.
template <bool SECOND>
__global__ void __launch_bounds__(kThreads)
rl2d_half(const float* __restrict__ src, const float* __restrict__ padded,
          float* __restrict__ dst, const float* __restrict__ psf,
          int h2, int w2, int kr, int kc, int tile_h) {
  extern __shared__ float smem[];
  const int ntaps = kr * kc;
  const int pr = kr / 2, pc = kc / 2;
  const int stride = kTileW + 2 * pc;
  float* taps = smem;           // ntaps, mirrored in the second half
  float* tile = smem + ntaps;   // (tile_h + 2 pr) x stride

  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < ntaps; i += kThreads) taps[i] = SECOND ? psf[ntaps - 1 - i] : psf[i];

  const int r0 = blockIdx.y * tile_h;
  const int c0 = blockIdx.x * kTileW;
  const int rows = tile_h + 2 * pr;
  for (int i = threadIdx.y; i < rows; i += kRowsY) {
    const int r = r0 - pr + i;
    for (int j = threadIdx.x; j < stride; j += kTileW) {
      const int c = c0 - pc + j;
      tile[i * stride + j] =
          (r >= 0 && r < h2 && c >= 0 && c < w2) ? src[(size_t)r * w2 + c] : 0.0f;
    }
  }
  __syncthreads();

  const int c = c0 + threadIdx.x;
  if (c >= w2) return;
  for (int i = threadIdx.y; i < tile_h; i += kRowsY) {
    const int r = r0 + i;
    if (r >= h2) break;
    float acc = 0.0f;
    for (int a = 0; a < kr; ++a) {
      const float* row = tile + (i + a) * stride + threadIdx.x;
      const float* t = taps + a * kc;
      for (int b = 0; b < kc; ++b) acc = fmaf(t[b], row[b], acc);
    }
    const size_t idx = (size_t)r * w2 + c;
    if (SECOND)
      dst[idx] = dst[idx] * acc;
    else
      dst[idx] = padded[idx] / (acc + 1e-12f);
  }
}

size_t smem_bytes(int kr, int kc, int tile_h) {
  return sizeof(float) * ((size_t)kr * kc +
                          ((size_t)tile_h + 2 * (kr / 2)) * (kTileW + 2 * (size_t)(kc / 2)));
}

}  // namespace

// u: (h2, w2) f32, the running estimate, updated in place (the caller
// starts it as a copy of padded); rel: (h2, w2) f32 scratch; padded: (h2, w2)
// f32; psf: (kr, kc) f32; all on the device. Runs n_iter iterations, two
// launches each, on `stream`; does not synchronize. Returns 0, or the CUDA
// error of the first launch that was refused (cudaErrorInvalidValue for
// arguments it does not take, or when the taps and a one-row tile do not fit
// a block's shared memory).
extern "C" int thz_rl2d(void* u, void* rel, const void* padded, const void* psf, int n_iter,
                        int h2, int w2, int kr, int kc, void* stream) {
  if (n_iter < 0 || h2 < 1 || w2 < 1 || kr < 1 || kc < 1) return (int)cudaErrorInvalidValue;
  if (n_iter == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int tile_h = 32;
  while (tile_h > 1 && smem_bytes(kr, kc, tile_h) > (size_t)optin) tile_h /= 2;
  const size_t bytes = smem_bytes(kr, kc, tile_h);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int grid_y = (h2 + tile_h - 1) / tile_h;
  if (grid_y > 65535) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(rl2d_half<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rl2d_half<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  float* uu = static_cast<float*>(u);
  float* rr = static_cast<float*>(rel);
  const float* pp = static_cast<const float*>(padded);
  const float* kk = static_cast<const float*>(psf);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((w2 + kTileW - 1) / kTileW, grid_y);
  const dim3 block(kTileW, kRowsY);
  for (int it = 0; it < n_iter; ++it) {
    rl2d_half<false><<<grid, block, bytes, st>>>(uu, pp, rr, kk, h2, w2, kr, kc, tile_h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rl2d_half<true><<<grid, block, bytes, st>>>(rr, pp, uu, kk, h2, w2, kr, kc, tile_h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

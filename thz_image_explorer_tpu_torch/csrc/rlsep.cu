// Separable Richardson-Lucy iterations over a stack of bands, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel thz_image_explorer_tpu/ops/pallas_rl.py
// :_sep_kernel (launched by rl_bands_separable) for canvases whose estimate
// no thread-block cluster holds (csrc/rlsep_cluster.cu takes the others).
// Same function: for every band b, n_iter[b] times,
//     u <- u * R^T (P / (R u C^T + 1e-12)) C
// on the band's (h2, w2) reflect-padded canvas P, where R and C are the
// banded correlation matrices of the band's row and column profiles:
//     R[i, k] = px[b, k - i + cr],  C[j, k] = py[b, k - j + cc],
//     cr = kr / 2, cc = kc / 2, zero outside the profile.
// So R u C^T is a zero-boundary correlation with px along rows and py along
// columns, and R^T X C is the same with the taps read at -d instead of +d.
// Nothing here builds R or C: each product is a direct 1-D tap loop.
//
// Bound on this card: operations. The function reads P and writes u once
// (B * h2 * w2 * 8 bytes, ~12.6 MB at the reference Apply: 25 bands of
// ~246 x 256), but per iteration and pixel it does (2 kr_b + 2 kc_b) FMAs
// plus a division and a multiply, over sum(n_iter) ~ 2.3k band iterations:
// ~2e10 operations, ~0.3 ms at the 67 TFLOP/s f32 peak, against ~4 us for
// the bytes. In practice the iteration count makes it latency-bound: 500
// dependent iterations, each a full pass over all active bands.
//
// What the design does about it. One launch per half-iteration covers all
// bands still iterating (blockIdx.z = slot in a band order sorted by
// descending n_iter, so the host launches exactly counts[it] bands at
// iteration it and no block idles on a finished band). The host loops over
// iterations with no device synchronization. Each block owns a tile of
// kTileW columns x tile_h rows of one band: the row pass reads its source
// rows straight from global memory (coalesced along the row; the whole
// working set of all bands, ~13 MB, stays in the 50 MB L2) into a
// shared-memory strip that carries the column halo, and the column pass
// reads that strip. The first half writes rel = P / (R u C^T + 1e-12) to a
// scratch buffer; the second half multiplies u in place (it reads rel with
// halos, u only at its own pixel). A band's tap reach (the outermost
// non-zero tap) is found in the kernel, so zero padding of the profile
// canvas costs nothing. No atomics on data: reruns are bit-identical.
//
// The 1e-12 guard keeps 0 / (0 + 1e-12) = 0, so the all-zero rows and
// columns outside a band's own reflect-padded region stay zero, as on the
// TPU. Built without --use_fast_math: the division is IEEE.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;    // columns per block: one warp wide
constexpr int kRowsY = 8;     // threadIdx.y extent; block = 32 x 8 threads
constexpr int kThreads = kTileW * kRowsY;

// tap at offset d of a profile of length k with centre k / 2; MIRROR reads
// it at -d (the transposed matrix). Zero outside the profile.
template <bool MIRROR>
__device__ __forceinline__ float tap(const float* __restrict__ prof, int k, int d) {
  const int i = k / 2 + (MIRROR ? -d : d);
  return (i >= 0 && i < k) ? prof[i] : 0.0f;
}

// One half-iteration of band b on the block's tile.
// SECOND == false: dst = rel = padded / (R src C^T + 1e-12), src = u.
// SECOND == true:  dst = u   = u * (R^T src C),               src = rel.
// Every thread of the block calls it (it synchronizes the block); a thread
// past the canvas's last column returns before the column pass.
template <bool SECOND>
__device__ __forceinline__ void band_half(
    int b, const float* __restrict__ src, const float* __restrict__ padded,
    float* __restrict__ dst, const float* __restrict__ px, const float* __restrict__ py,
    int h2, int w2, int kr, int kc, int tile_h, int strip_stride, float* smem, int* reach) {
  float* taps_r = smem;             // 2 * hr + 1 <= kr + 1
  float* taps_c = smem + kr + 1;    // 2 * hc + 1 <= kc + 1
  float* strip = taps_c + kc + 1;   // tile_h x strip_stride

  const float* pxb = px + (size_t)b * kr;
  const float* pyb = py + (size_t)b * kc;
  const int tid = threadIdx.y * kTileW + threadIdx.x;

  // the band's reach: the largest |offset| of a non-zero tap
  if (tid < 2) reach[tid] = 0;
  __syncthreads();
  for (int i = tid; i < kr; i += kThreads)
    if (pxb[i] != 0.0f) atomicMax(&reach[0], abs(i - kr / 2));
  for (int i = tid; i < kc; i += kThreads)
    if (pyb[i] != 0.0f) atomicMax(&reach[1], abs(i - kc / 2));
  __syncthreads();
  const int hr = reach[0], hc = reach[1];
  for (int i = tid; i <= 2 * hr; i += kThreads) taps_r[i] = tap<SECOND>(pxb, kr, i - hr);
  for (int i = tid; i <= 2 * hc; i += kThreads) taps_c[i] = tap<SECOND>(pyb, kc, i - hc);
  __syncthreads();

  const size_t base = (size_t)b * h2 * w2;
  const int r0 = blockIdx.y * tile_h;
  const int c0 = blockIdx.x * kTileW;
  const int width = kTileW + 2 * hc;

  // row pass: strip[i][j] = sum_d taps_r[d] src[r0 + i + d][c0 - hc + j],
  // zero outside the canvas
  for (int i = threadIdx.y; i < tile_h; i += kRowsY) {
    const int r = r0 + i;
    const int dlo = max(-hr, -r);
    const int dhi = min(hr, h2 - 1 - r);
    for (int j = threadIdx.x; j < width; j += kTileW) {
      const int c = c0 - hc + j;
      float acc = 0.0f;
      if (r < h2 && c >= 0 && c < w2) {
        const float* col = src + base + c;
        for (int d = dlo; d <= dhi; ++d)
          acc = fmaf(taps_r[d + hr], col[(size_t)(r + d) * w2], acc);
      }
      strip[i * strip_stride + j] = acc;
    }
  }
  __syncthreads();

  // column pass and the pointwise epilogue
  const int c = c0 + threadIdx.x;
  if (c >= w2) return;
  for (int i = threadIdx.y; i < tile_h; i += kRowsY) {
    const int r = r0 + i;
    if (r >= h2) break;
    const float* row = strip + i * strip_stride + threadIdx.x;
    float acc = 0.0f;
    for (int d = 0; d <= 2 * hc; ++d) acc = fmaf(taps_c[d], row[d], acc);
    const size_t idx = base + (size_t)r * w2 + c;
    if (SECOND)
      dst[idx] = dst[idx] * acc;
    else
      dst[idx] = padded[idx] / (acc + 1e-12f);
  }
}

// One half-iteration for the bands order[0 .. nb): block z takes band
// order[z].
template <bool SECOND>
__global__ void __launch_bounds__(kThreads)
rl_half(const float* __restrict__ src, const float* __restrict__ padded,
        float* __restrict__ dst, const float* __restrict__ px,
        const float* __restrict__ py, const int* __restrict__ order,
        int h2, int w2, int kr, int kc, int tile_h, int strip_stride) {
  extern __shared__ float smem[];
  __shared__ int reach[2];
  band_half<SECOND>(order[blockIdx.z], src, padded, dst, px, py, h2, w2, kr, kc, tile_h,
                    strip_stride, smem, reach);
}

size_t smem_bytes(int kr, int kc, int tile_h, int strip_stride) {
  return sizeof(float) * ((size_t)kr + 1 + kc + 1 + (size_t)tile_h * strip_stride);
}

}  // namespace

// u: (b, h2, w2) f32, the running estimate, updated in place (the caller
// starts it as a copy of padded); rel: (b, h2, w2) f32 scratch; padded:
// (b, h2, w2) f32; px: (b, kr) f32; py: (b, kc) f32; order: (b,) int32 on
// the device, the bands by descending n_iter; counts: HOST (it1,) int32,
// counts[it] = number of bands with n_iter > it (non-increasing). Runs
// iterations it0 .. it1-1, two launches each, on
// `stream`; does not synchronize. Returns 0, or the CUDA error of the first
// launch that was refused (cudaErrorInvalidValue for arguments it does not
// take).
extern "C" int thz_rlsep(void* u, void* rel, const void* padded, const void* px,
                         const void* py, const void* order, const int* counts,
                         int it0, int it1, int b, int h2, int w2, int kr, int kc,
                         void* stream) {
  if (b < 1 || b > 65535 || h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || it0 < 0 || it1 < it0)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // the strip carries the widest column halo any band can have
  const int strip_stride = kTileW + 2 * (kc / 2);
  int tile_h = 32;
  while (tile_h > kRowsY && smem_bytes(kr, kc, tile_h, strip_stride) > (size_t)optin)
    tile_h /= 2;
  const size_t bytes = smem_bytes(kr, kc, tile_h, strip_stride);
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const void* fns[] = {(const void*)rl_half<false>, (const void*)rl_half<true>};
    for (const void* fn : fns) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
    }
  }
  float* uu = static_cast<float*>(u);
  float* rr = static_cast<float*>(rel);
  const float* pp = static_cast<const float*>(padded);
  const float* pxx = static_cast<const float*>(px);
  const float* pyy = static_cast<const float*>(py);
  const int* ord = static_cast<const int*>(order);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kTileW, kRowsY);
  for (int it = it0; it < it1; ++it) {
    const int nb = counts[it];
    if (nb < 1 || nb > b) return (int)cudaErrorInvalidValue;
    const dim3 grid((w2 + kTileW - 1) / kTileW, (h2 + tile_h - 1) / tile_h, nb);
    rl_half<false><<<grid, block, bytes, st>>>(uu, pp, rr, pxx, pyy, ord, h2, w2, kr, kc, tile_h,
                                               strip_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rl_half<true><<<grid, block, bytes, st>>>(rr, pp, uu, pxx, pyy, ord, h2, w2, kr, kc, tile_h,
                                              strip_stride);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

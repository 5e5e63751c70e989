// Per-trace envelope and min-max normalization of the 3-D voxel view, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel thz_image_explorer_tpu/ops/voxel.py
// :_envelope_kernel (launched by _envelope_pallas). It computes the function
// of the JAX package's f32 XLA path (_normalized_opacities): for each trace
// v = x[n, :] of length T,
//     p[t]   = powf(v[t] * v[t], c)                 (0^0 = 1)
//     env[t] = sum_k taps[k] * p[t + k - r]          (k = 0..2r; p = 0 outside 0..T-1)
//     out[t] = (env[t] - min env) / (max env - min env)
// and out = 0 for the whole trace where max env < thr or |max - min| <= 1e-6.
// It is a correlation: the taps are not flipped. The TPU kernel multiplied by
// a bf16 banded (T, T) matrix (a VMEM workaround that leaves ~1e-3 error);
// here the taps are applied directly in f32.
//
// Bound on this card: bytes. The function reads the (N, T) f32 traces once
// and writes the (N, T) f32 opacities once, 8 bytes a sample (0.098 ms at
// 200 x 200 x 1024 at 3.35 TB/s), against 2 (2r + 1) + 6 operations a sample
// (0.027 ms at r = 9 at the 67 TFLOP/s f32 peak).
//
// What the design does about it. One warp per trace. The warp reads its trace
// once (coalesced), keeps p with an r-wide zero halo on each side in shared
// memory, computes env into a second shared-memory buffer while each lane
// tracks its min and max, reduces those by warp shuffles, and writes the
// normalized trace once (coalesced). Nothing but the input and the output
// touches device memory; the taps sit in shared memory (read as broadcasts,
// and lane i reads p[i + k], so no bank conflicts). Any T and any r >= 0
// (2r + 1 > T included), 64-bit offsets. Built without --use_fast_math:
// powf(0, 0) = 1 and the division is IEEE. No atomics: reruns are
// bit-identical.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxWarps = 8;  // traces per block

__global__ void __launch_bounds__(kWarp * kMaxWarps)
envelope_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ taps, long long n, int t, int r,
                float contrast, float thr) {
  extern __shared__ float smem[];
  const int k = 2 * r + 1;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  float* taps_s = smem;                                        // k
  float* p = smem + k + (size_t)warp * (2 * (size_t)t + 2 * r);  // t + 2r
  float* env = p + t + 2 * r;                                  // t

  for (int i = threadIdx.x; i < k; i += blockDim.x) taps_s[i] = taps[i];
  __syncthreads();
  const long long row = (long long)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= n) return;  // the whole warp: no block-wide sync below
  const float* xr = x + (size_t)row * t;
  float* orow = out + (size_t)row * t;

  for (int i = lane; i < r; i += kWarp) {
    p[i] = 0.0f;
    p[r + t + i] = 0.0f;
  }
  for (int i = lane; i < t; i += kWarp) {
    const float v = xr[i];
    p[r + i] = powf(v * v, contrast);
  }
  __syncwarp();

  float mn = INFINITY, mx = -INFINITY;
  for (int i = lane; i < t; i += kWarp) {
    const float* s = p + i;
    float acc = 0.0f;
    for (int j = 0; j < k; ++j) acc = fmaf(taps_s[j], s[j], acc);
    env[i] = acc;
    mn = fminf(mn, acc);
    mx = fmaxf(mx, acc);
  }
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  __syncwarp();
  const float rng = mx - mn;
  const bool keep = (mx >= thr) && (fabsf(rng) > 1e-6f);
  for (int i = lane; i < t; i += kWarp) orow[i] = keep ? (env[i] - mn) / rng : 0.0f;
}

}  // namespace

// x: (n, t) f32 traces; out: (n, t) f32; taps: (2r + 1,) f32, all on the
// device. Launches one kernel on `stream`; does not synchronize. Returns 0,
// or the CUDA error of the refused launch (cudaErrorInvalidValue for
// arguments it does not take, or when one trace with its halo does not fit
// the shared memory of a block).
extern "C" int thz_envelope(const void* x, void* out, const void* taps, long long n,
                            int t, int r, float contrast, float thr, void* stream) {
  if (n < 0 || t < 1 || r < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t taps_bytes = sizeof(float) * (2 * (size_t)r + 1);
  const size_t warp_bytes = sizeof(float) * (2 * (size_t)t + 2 * (size_t)r);
  int warps = kMaxWarps;
  while (warps > 1 && taps_bytes + warps * warp_bytes > (size_t)optin) warps /= 2;
  const size_t bytes = taps_bytes + warps * warp_bytes;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(envelope_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  envelope_kernel<<<(unsigned)blocks, warps * kWarp, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float*>(taps),
      n, t, r, contrast, thr);
  return (int)cudaGetLastError();
}

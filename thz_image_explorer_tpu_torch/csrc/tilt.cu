// Tilt compensation for NVIDIA Hopper (sm_90a): each pixel's shift, the
// window and the insertion of its windowed trace into the extended time
// axis, in one pass.
//
// Replaces no TPU kernel: the JAX package computes the shifts in XLA and
// inserts the traces with a gather (thz_image_explorer_tpu/ops/tilt.py); the
// port's plain version is that gather in PyTorch, with the shifts made on
// the host (ops/tilt.py:tilt_insert_plain). Added because on the card that
// form made, every tilt step, the (W, H) shifts in numpy on the host (tens
// of ms at 512 x 512), about 35 small launches for the window, and then an
// int64 (W, H, T') index, its clamped copy, two masks, the windowed cube and
// two selects: ~30 GB of traffic at 512 x 512 x 1024 -> 1648, where the
// function needs the cube read once and the extended cube written once
// (2.8 GB, ~0.84 ms at 3.35 TB/s).
//
// For the pixel p = i * height + j of a block whose pixel (0, 0) lies at
// (ox, oy) in the grid, with the valid region (vw, vh):
//     x_pre = ((float(ox + i) - vw * 0.5) * dx) * tsx,  tsx = tilt_x * deg
//     y_pre = ((float(oy + j) - vh * 0.5) * dy) * tsy,  tsy = tilt_y * deg
//     s     = max(num_steps + floor(fma(y_pre, inv_c, x_pre * inv_c) * inv_dt), 0)
//     out[p, k] = raw[p, 0]                          k < s
//               = raw[p, k - s] * win[k - s]         s <= k < s + T
//               = 0                                  otherwise
// where win is the adapted Blackman of the input axis `time` over its first
// `lower` and last `upper` ps (ops/windows.py:adapted_blackman_window).
// Every f32 operation is written as its rounding intrinsic, in the order of
// the host function ops/tilt.py:pixel_shifts (which follows the compiled JAX
// program) and of PyTorch's elementwise kernels for the window (each a
// separate rounding; the divisions by a device scalar IEEE divisions; cosf):
// nvcc contracts a * b + c into one fused multiply-add by default, and a
// contracted product flips a pixel's step at a step boundary. So the shifts
// equal pixel_shifts bit for bit, and the output the plain version's.
//
// Bound on this card: bytes. Persistent blocks each compute the window once
// into shared memory (where it fits; else each sample's weight is computed
// where it is used), then a warp owns a pixel at a time: its lanes run along
// the extended trace, 32 consecutive samples an instruction (coalesced, at
// any shift and any T), four such in flight a lane before their stores. The
// raw trace is read once and the extended one written once; no index
// tensor, no host shifts. If `shifts` is not null, lane 0 of each pixel's
// warp also writes the shift it used (the check against pixel_shifts).
// Built without --use_fast_math, f32 CUDA cores only. No atomics: reruns are
// bit-identical.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;          // warps per block, a pixel each at a time
constexpr int kUnroll = 4;         // samples in flight a lane
constexpr int kSmemWindow = 12288; // the longest window kept in shared memory (48 KB)
constexpr int kBlocksPerSm = 8;    // resident blocks an SM (2048 threads)

struct Args {
  const float* raw;   // (n, t) f32
  const float* time;  // (t,) f32, the input axis
  float* out;         // (n, t_out) f32
  long long* shifts;  // (n,) int64 or null
  long long n;
  int height, t, t_out, ox, oy, vw, vh, num_steps;
  float dx, dy, tilt_x, tilt_y, deg, inv_c, inv_dt, lower, upper;
};

// The pixel's insert offset, operation for operation as ops/tilt.py:pixel_shifts.
__device__ __forceinline__ long long shift_of(const Args& a, long long p) {
  const long long i = p / a.height, j = p - i * a.height;
  const float tsx = __fmul_rn(a.tilt_x, a.deg);
  const float tsy = __fmul_rn(a.tilt_y, a.deg);
  const float x_pre = __fmul_rn(
      __fmul_rn(__fsub_rn((float)(a.ox + i), __fmul_rn((float)a.vw, 0.5f)), a.dx), tsx);
  const float y_pre = __fmul_rn(
      __fmul_rn(__fsub_rn((float)(a.oy + j), __fmul_rn((float)a.vh, 0.5f)), a.dy), tsy);
  const float x_off = __fmul_rn(x_pre, a.inv_c);
  const float total = __fmaf_rn(y_pre, a.inv_c, x_off);
  const long long s = (long long)a.num_steps + (long long)floorf(__fmul_rn(total, a.inv_dt));
  return s < 0 ? 0 : s;
}

// ops/windows.py:_blackman_value: 0.42 - 0.5 cos(2 pi n / m) + 0.08 cos(4 pi n / m),
// NaN -> 1, clamped to [0, 1]; the Python constants are f32 as PyTorch passes them.
__device__ __forceinline__ float blackman(float n, float m) {
  const float c1 = cosf(__fdiv_rn(__fmul_rn(n, (float)6.283185307179586), m));
  const float c2 = cosf(__fdiv_rn(__fmul_rn(n, (float)12.566370614359172), m));
  const float r = __fadd_rn(__fsub_rn((float)0.42, __fmul_rn(c1, 0.5f)),
                            __fmul_rn(c2, (float)0.08));
  if (isnan(r)) return 1.f;
  return r < 0.f ? 0.f : (r > 1.f ? 1.f : r);
}

// ops/windows.py:adapted_blackman_window at sample q: the head taper where
// time <= lower + t0 (it wins), the tail taper where time >= t_end - upper.
__device__ __forceinline__ float window_at(const Args& a, int q) {
  const float t0 = a.time[0], t_end = a.time[a.t - 1], x = a.time[q];
  if (x <= __fadd_rn(a.lower, t0)) return blackman(__fsub_rn(x, t0), __fmul_rn(a.lower, 2.f));
  if (x >= __fsub_rn(t_end, a.upper)) {
    const float m = __fmul_rn(a.upper, 2.f);
    return blackman(__fsub_rn(x, __fsub_rn(t_end, m)), m);
  }
  return 1.f;
}

template <bool kShared>
__global__ void __launch_bounds__(kWarps * kWarp, kBlocksPerSm) tilt_insert_kernel(Args a) {
  extern __shared__ float win_s[];  // (t,) when kShared
  if (kShared) {
    for (int q = threadIdx.x; q < a.t; q += blockDim.x) win_s[q] = window_at(a, q);
    __syncthreads();
  }
  const int lane = threadIdx.x % kWarp;
  const long long stride = (long long)gridDim.x * kWarps;
  for (long long p = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp; p < a.n; p += stride) {
    const long long s_full = shift_of(a, p);
    if (a.shifts != nullptr && lane == 0) a.shifts[p] = s_full;
    // past the end of the extended trace the pixel is all head
    const int s = s_full > a.t_out ? a.t_out : (int)s_full;
    const float* __restrict__ src = a.raw + p * a.t;
    float* __restrict__ dst = a.out + p * a.t_out;
    const float first = src[0];
    for (int k0 = 0; k0 < a.t_out; k0 += kUnroll * kWarp) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = k0 + u * kWarp + lane - s;
        if (q < 0) {
          v[u] = first;
        } else if (q < a.t) {
          v[u] = __fmul_rn(src[q], kShared ? win_s[q] : window_at(a, q));
        } else {
          v[u] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kWarp + lane;
        if (k < a.t_out) dst[k] = v[u];
      }
    }
  }
}

}  // namespace

// raw: (n, t) f32, pixel p = i * height + j at grid position (ox + i, oy + j);
// time: (t,) f32; out: (n, t_out) f32; shifts: (n,) int64 or null; all on
// the device. `blocks` lies in [1, ceil(n / warps a block)]. Launches one
// kernel on `stream`; does not synchronize. Returns 0,
// cudaErrorInvalidValue for arguments the kernel does not take, or the CUDA
// error of the refused launch.
extern "C" int thz_tilt_insert(const void* raw, const void* time, void* out, void* shifts,
                               long long n, int height, int t, int t_out, int ox, int oy,
                               int vw, int vh, int num_steps, float dx, float dy, float tilt_x,
                               float tilt_y, float deg, float inv_c, float inv_dt, float lower,
                               float upper, long long blocks, void* stream) {
  if (n < 0 || height < 1 || n % height || t < 1 || t_out < t || num_steps < 0 || ox < 0 ||
      oy < 0 || !raw || !time || !out)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (blocks < 1 || blocks > (n + kWarps - 1) / kWarps || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(raw), static_cast<const float*>(time),
               static_cast<float*>(out), static_cast<long long*>(shifts), n, height, t, t_out,
               ox, oy, vw, vh, num_steps, dx, dy, tilt_x, tilt_y, deg, inv_c, inv_dt,
               lower, upper};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (t <= kSmemWindow)
    tilt_insert_kernel<true><<<(unsigned)blocks, kWarps * kWarp, (size_t)t * 4, st>>>(a);
  else
    tilt_insert_kernel<false><<<(unsigned)blocks, kWarps * kWarp, 0, st>>>(a);
  return (int)cudaGetLastError();
}

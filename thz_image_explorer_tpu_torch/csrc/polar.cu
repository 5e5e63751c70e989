// The FFT stage's amplitude and unwrapped phase for NVIDIA Hopper (sm_90a):
// |z|, arg z, the wrapped phase steps and their running sum along each row of
// the spectrum, in one pass.
//
// Replaces no TPU kernel: the JAX package computes these values in XLA
// (thz_image_explorer_tpu/ops/fourier.py:forward_fft, whose blocked-matmul
// cumsum, :73-107, was a TPU workaround); the port's plain version is
// torch.abs, torch.angle and ops/fourier.py:unwrap in PyTorch
// (ops/polar.py:amplitude_phase_plain). Added because on the card that form
// is 13 PyTorch operations, each at least one pass over the spectrum (the
// absolute value, the angle, the strided difference, the wrap's comparisons,
// casts, products and sums, a cat and the cumsum): ~15 GB and 7.4 ms at
// 512 x 512 x 1024 (F = 513 bins), where the function needs
// the (R, F) complex64 spectrum read once and the two (R, F) f32 planes
// written once, 16 bytes a bin: 2.15 GB, ~0.64 ms at 3.35 TB/s.
//
// For each row r of R and bin k of F:
//     amp[r, k]   = hypotf(re, im)                      (torch.abs of complex64)
//     ang         = atan2f(im, re)                      (torch.angle)
//     inc[r, 0]   = ang[0]
//     inc[r, k]   = w(ang[k] - ang[k - 1]),  w(d) = (d - 2pi [d > pi]) + 2pi [d < -pi]
//     phase[r, k] = sum_{j <= k} inc[r, j]
// with pi and 2pi the f32 values of ops/fourier.py (PI_F32, TWO_PI_F32), the
// difference rounded once and the wrap's subtraction and addition each
// rounded once in that order, as PyTorch's separate kernels do (written as
// rounding intrinsics: a contracted form would differ, in the sign of a zero
// too). The sum is torch.cumsum's own order on the card wherever PyTorch
// scans a row in chunks of 32 (ATen's tensor_kernel_scan_innermost_dim with
// 16 threads a row, which it takes for R > 1 rows when R rounded up to a
// power of two lies between F rounded up to one and 512 times that: every
// slider step's shape):
// each chunk of 32 bins is scanned by the Sklansky tree, its first
// bin having the previous chunks' total added first. So a row's bits depend
// on the row alone, and equal the plain version's on the card wherever
// PyTorch takes that order. A NaN bin gives NaN from there on, as the plain
// version does.
//
// Bound on this card: bytes (16 a bin: ~0.64 ms at 512 x 512 x 1024), with
// the accurate hypotf and atan2f, the wrap and the scan close behind (~150
// SASS instructions a bin, static count: an issue floor of ~0.6 ms there).
// The design keeps both pipes busy: persistent blocks of warps, a warp a row
// at a time, its lanes on 32 consecutive bins (8-byte loads and 4-byte
// stores, each warp instruction one contiguous run). A warp walks its rows
// r, r + stride, ... as one sequence of batches of kUnroll chunks, and loads
// its next batch (of the same row or the next) into registers before the
// current batch's arithmetic, so its reads are in flight while it and the
// others compute; at the row's start the running sum and the previous angle
// are reset. The previous bin's angle comes from the lane before (a shuffle;
// lane 0 keeps the last chunk's), the Sklansky tree takes five shuffles, and
// the chunk's total is carried to the next. Rows of any length, no shared
// memory. If `inc` is not null, the kernel also writes the wrapped steps (the
// check against the plain version). Built without --use_fast_math, f32 CUDA
// cores only. No atomics: reruns are bit-identical.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; scripts/torch_polar_sweep.py):
// 512 x 512 at F = 513, a row loop with 4 chunks loaded ahead and 6 blocks an
// SM took 1.10 ms; the batches prefetched across rows, 8 chunks ahead, 3
// blocks an SM (64 registers) 0.94 ms, 68 % of the bound. Without hypotf and
// atan2f the same loads, scan and stores take 0.96 ms: the memory side, not
// the arithmetic (0.88 ms alone), sets the pace.

#include <cuda_runtime.h>

#include <cstdint>

#ifndef POLAR_WARPS
#define POLAR_WARPS 8
#endif
#ifndef POLAR_BLOCKS_PER_SM
#define POLAR_BLOCKS_PER_SM 3
#endif
#ifndef POLAR_UNROLL
#define POLAR_UNROLL 8
#endif

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = POLAR_WARPS;             // warps a block, a row each at a time
constexpr int kBlocksPerSm = POLAR_BLOCKS_PER_SM;  // resident blocks an SM
constexpr int kUnroll = POLAR_UNROLL;           // chunks of 32 bins loaded ahead
constexpr float kPi = 0x1.921fb6p+1f;           // float32(pi), ops/fourier.py:PI_F32
constexpr float kTwoPi = 0x1.921fb6p+2f;        // float32(2 pi), TWO_PI_F32

struct Args {
  const float2* spec;  // (rows, f) complex64
  float* amp;          // (rows, f) f32
  float* phase;        // (rows, f) f32
  float* inc;          // (rows, f) f32 or null
  long long rows;
  int f;
};

// ops/fourier.py:wrap_adjust: d - 2pi [d > pi], then + 2pi [d < -pi].
__device__ __forceinline__ float wrap_step(float d) {
  const float down = d > kPi ? kTwoPi : 0.f;
  const float up = d < -kPi ? kTwoPi : 0.f;
  return __fadd_rn(__fsub_rn(d, down), up);
}

template <bool kInc>
__global__ void __launch_bounds__(kWarps * kWarp, kBlocksPerSm) polar_unwrap_kernel(Args a) {
  const int lane = threadIdx.x % kWarp;
  const long long stride = (long long)gridDim.x * kWarps;
  // the warp's rows r, r + stride, ... as one sequence of batches of kUnroll
  // chunks; the next batch (of this row or the next) is loaded before the
  // current one's arithmetic
  long long r = (long long)blockIdx.x * kWarps + threadIdx.x / kWarp;
  int k0 = 0;
  float2 next[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int k = u * kWarp + lane;
    next[u] = r < a.rows && k < a.f ? a.spec[r * a.f + k] : make_float2(0.f, 0.f);
  }
  float carry = 0.f;  // the total of the row's chunks so far (cumsum's init 0)
  float last = 0.f;   // the angle of the bin before the chunk
  while (r < a.rows) {
    float2 z[kUnroll];
    long long r1 = r;
    int k1 = k0 + kUnroll * kWarp;
    if (k1 >= a.f) {
      k1 = 0;
      r1 += stride;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      z[u] = next[u];
      const int k = k1 + u * kWarp + lane;
      next[u] = r1 < a.rows && k < a.f ? a.spec[r1 * a.f + k] : make_float2(0.f, 0.f);
    }
    if (k0 == 0) carry = last = 0.f;
    float* __restrict__ amp = a.amp + r * a.f;
    float* __restrict__ phase = a.phase + r * a.f;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k0 + u * kWarp >= a.f) break;  // the same for the whole warp
      const int k = k0 + u * kWarp + lane;
      const float m = hypotf(z[u].x, z[u].y);
      const float g = atan2f(z[u].y, z[u].x);
      float before = __shfl_up_sync(kFull, g, 1);
      if (lane == 0) before = last;
      const float d = k == 0 ? g : wrap_step(__fsub_rn(g, before));
      // cumsum's chunk: the previous chunks' total into its first bin, then
      // the Sklansky tree (a bin with bit s set adds the last bin of the
      // lower half of its group of 2s; the others keep their value)
      float v = lane == 0 ? __fadd_rn(d, carry) : d;
#pragma unroll
      for (int s = 1; s < kWarp; s <<= 1) {
        const float sum = __fadd_rn(v, __shfl_sync(kFull, v, (lane & ~(2 * s - 1)) + s - 1));
        v = lane & s ? sum : v;
      }
      carry = __shfl_sync(kFull, v, kWarp - 1);
      last = __shfl_sync(kFull, g, kWarp - 1);
      if (k < a.f) {
        amp[k] = m;
        phase[k] = v;
        if (kInc) a.inc[r * a.f + k] = d;
      }
    }
    r = r1;
    k0 = k1;
  }
}

}  // namespace

// The compiled shape: out[0..2] = warps a block, resident blocks an SM,
// chunks of 32 bins loaded ahead.
extern "C" void thz_polar_config(long long* out) {
  out[0] = kWarps;
  out[1] = kBlocksPerSm;
  out[2] = kUnroll;
}

// spec: (rows, f) complex64; amp, phase: (rows, f) f32; inc: (rows, f) f32 or
// null; all on the device, contiguous. `blocks` lies in [1, ceil(rows / warps
// a block)]. Launches one kernel on `stream`; does not synchronize. Returns
// 0, cudaErrorInvalidValue for arguments the kernel does not take, or the
// CUDA error of the refused launch.
extern "C" int thz_polar_unwrap(const void* spec, void* amp, void* phase, void* inc,
                                long long rows, int f, long long blocks, void* stream) {
  if (rows < 0 || f < 1 || !spec || !amp || !phase || (uintptr_t)spec % 8 ||
      (uintptr_t)amp % 4 || (uintptr_t)phase % 4 || (uintptr_t)inc % 4)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  if (blocks < 1 || blocks > (rows + kWarps - 1) / kWarps || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float2*>(spec), static_cast<float*>(amp),
               static_cast<float*>(phase), static_cast<float*>(inc), rows, f};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (inc != nullptr)
    polar_unwrap_kernel<true><<<(unsigned)blocks, kWarps * kWarp, 0, st>>>(a);
  else
    polar_unwrap_kernel<false><<<(unsigned)blocks, kWarps * kWarp, 0, st>>>(a);
  return (int)cudaGetLastError();
}

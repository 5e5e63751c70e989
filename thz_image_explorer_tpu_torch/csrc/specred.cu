// One-pass spectral publish reduction for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel thz_image_explorer_tpu/ops/pallas_specred.py
// :_kernel (launched by _specred_call through spectral_reduction_sums). Same
// function: for every pixel row n of the (N, F) complex64 spectrum and every
// frequency column k
//     amp[n,k] = sqrt(c^2 + s^2),   ang[n,k] = atan2(s, c),
//     inc[n,0] = ang[n,0],  inc[n,k] = wrap_adjust(ang[n,k] - ang[n,k-1]),
// then the masked row sums over an (M <= 16, N) f32 mask stack:
//     out[o][r][k] = sum_n masks[r][n] * x_o[n,k],  x_o in (amp, inc[, c, s]).
// wrap_adjust is the strict "> pi" / "< -pi" rule of ops/fourier.wrap_adjust
// with pi rounded to f32, so a jump of exactly pi is kept.
//
// Bound on this card: memory. The function must read the spectrum once
// (N*F*8 bytes) and the masks once (M*N*4 bytes) and writes only (M, F)
// sums: at N = 40000, F = 513, M = 5 that is ~165 MB, ~49 us at the H100
// SXM's 3.35 TB/s (use the bandwidth of the card at hand on a PCIe part).
//
// What the design does about the bound: it reads the interleaved complex64
// spectrum directly as float2 (no real/imag planes are materialized, which
// is what cost the TPU version its place on the path), reads it once, and
// writes nothing cube-sized. Each thread owns one frequency column and walks
// the rows of one row chunk; the angle at k-1 comes from the neighbouring
// lane by a warp shuffle (lane 0 recomputes it from the previous column),
// so each element's atan2f is computed about once. The chunk's mask values
// are staged in shared memory tile by tile. Per-chunk partial sums go to a
// (P, n_out, M, F) scratch tensor and a second kernel adds them in a fixed
// order: no float atomics, so the result is bit-identical from run to run.
// The arithmetic (one atan2f per element) is far below the f32 peak.
//
// Built without --use_fast_math: atan2f and the strict comparisons must
// agree with torch.atan2 and ops/fourier.wrap_adjust on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // frequency columns per block
constexpr int kTileRows = 64;   // mask rows staged in shared memory at once
constexpr float kPi = 3.14159274101257324219f;      // (float)M_PI
constexpr float kTwoPi = 6.28318548202514648438f;   // (float)(2*M_PI)

__device__ __forceinline__ float wrap_adjust(float d) {
  if (d > kPi) return d - kTwoPi;
  if (d < -kPi) return d + kTwoPi;
  return d;
}

template <int M, bool WITH_COMPLEX>
__global__ void __launch_bounds__(kThreads)
specred_partial(const float2* __restrict__ spec, const float* __restrict__ masks,
                float* __restrict__ partial, int n, int f, int rows_per_chunk) {
  constexpr int n_out = WITH_COMPLEX ? 4 : 2;
  __shared__ float tile[M][kTileRows];

  const int k = blockIdx.x * kThreads + threadIdx.x;
  const int p = blockIdx.y;
  const int row0 = p * rows_per_chunk;
  const int row1 = min(row0 + rows_per_chunk, n);
  const bool active = k < f;
  // columns past F compute on a clamped column (every lane must take part
  // in the warp shuffle) and store nothing
  const int kc = min(k, f - 1);
  const int lane = threadIdx.x & 31;

  float acc[n_out][M];
#pragma unroll
  for (int o = 0; o < n_out; ++o)
#pragma unroll
    for (int r = 0; r < M; ++r) acc[o][r] = 0.0f;

  for (int base = row0; base < row1; base += kTileRows) {
    const int rows = min(kTileRows, row1 - base);
    __syncthreads();  // the previous tile is fully consumed
    for (int i = threadIdx.x; i < M * kTileRows; i += kThreads) {
      const int r = i / kTileRows;
      const int j = i - r * kTileRows;
      tile[r][j] = j < rows ? masks[(size_t)r * n + base + j] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const size_t row = (size_t)(base + j) * f;
      const float2 z = spec[row + kc];
      // __fmul_rn/__fadd_rn: no contraction into an fma, so amp is the
      // same rounding as the plain version's sqrt(c*c + s*s)
      const float amp = sqrtf(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)));
      const float ang = atan2f(z.y, z.x);
      // the angle at k-1 is the left lane's; lane 0 recomputes it
      float prev = __shfl_up_sync(0xffffffffu, ang, 1);
      if (lane == 0 && kc > 0) {
        const float2 zp = spec[row + kc - 1];
        prev = atan2f(zp.y, zp.x);
      }
      const float inc = kc > 0 ? wrap_adjust(ang - prev) : ang;
#pragma unroll
      for (int r = 0; r < M; ++r) {
        const float w = tile[r][j];
        acc[0][r] = fmaf(w, amp, acc[0][r]);
        acc[1][r] = fmaf(w, inc, acc[1][r]);
        if constexpr (WITH_COMPLEX) {
          acc[n_out - 2][r] = fmaf(w, z.x, acc[n_out - 2][r]);
          acc[n_out - 1][r] = fmaf(w, z.y, acc[n_out - 1][r]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int o = 0; o < n_out; ++o)
#pragma unroll
    for (int r = 0; r < M; ++r)
      partial[(((size_t)p * n_out + o) * M + r) * f + k] = acc[o][r];
}

// out[i] = sum_p partial[p][i], p in ascending order: a fixed order, so
// repeated runs give bit-identical sums.
__global__ void specred_finish(const float* __restrict__ partial,
                               float* __restrict__ out, int chunks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int p = 0; p < chunks; ++p) s += partial[(size_t)p * total + i];
  out[i] = s;
}

template <int M, bool WITH_COMPLEX>
cudaError_t launch_partial(const float2* spec, const float* masks, float* partial,
                           int n, int f, int rows_per_chunk, int chunks,
                           cudaStream_t stream) {
  const dim3 grid((f + kThreads - 1) / kThreads, chunks);
  specred_partial<M, WITH_COMPLEX><<<grid, kThreads, 0, stream>>>(
      spec, masks, partial, n, f, rows_per_chunk);
  return cudaGetLastError();
}

template <int M>
cudaError_t launch_m(bool with_complex, const float2* spec, const float* masks,
                     float* partial, int n, int f, int rows_per_chunk, int chunks,
                     cudaStream_t stream) {
  return with_complex
             ? launch_partial<M, true>(spec, masks, partial, n, f, rows_per_chunk, chunks, stream)
             : launch_partial<M, false>(spec, masks, partial, n, f, rows_per_chunk, chunks, stream);
}

}  // namespace

// spec: (n, f) complex64 as interleaved float2; masks: (m, n) f32;
// partial: (chunks, n_out, m, f) f32 scratch; out: (n_out, m, f) f32, with
// n_out = 4 if with_complex else 2 and chunks = ceil(n / rows_per_chunk).
// Launches on `stream`, does not synchronize, returns cudaGetLastError()
// of the first launch that failed (0 when both were accepted).
extern "C" int thz_specred(const void* spec, const void* masks, void* partial,
                           void* out, int n, int f, int m, int with_complex,
                           int rows_per_chunk, int chunks, void* stream) {
  if (m < 1 || m > 16 || n < 1 || f < 1 || rows_per_chunk < 1 || chunks < 1 ||
      (long long)rows_per_chunk * chunks < n)
    return (int)cudaErrorInvalidValue;
  const float2* s = static_cast<const float2*>(spec);
  const float* mk = static_cast<const float*>(masks);
  float* part = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wc = with_complex != 0;
  cudaError_t err;
  switch (m) {
#define THZ_SPECRED_CASE(MM) \
  case MM:                   \
    err = launch_m<MM>(wc, s, mk, part, n, f, rows_per_chunk, chunks, st); \
    break;
    THZ_SPECRED_CASE(1) THZ_SPECRED_CASE(2) THZ_SPECRED_CASE(3) THZ_SPECRED_CASE(4)
    THZ_SPECRED_CASE(5) THZ_SPECRED_CASE(6) THZ_SPECRED_CASE(7) THZ_SPECRED_CASE(8)
    THZ_SPECRED_CASE(9) THZ_SPECRED_CASE(10) THZ_SPECRED_CASE(11) THZ_SPECRED_CASE(12)
    THZ_SPECRED_CASE(13) THZ_SPECRED_CASE(14) THZ_SPECRED_CASE(15) THZ_SPECRED_CASE(16)
#undef THZ_SPECRED_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int total = (with_complex ? 4 : 2) * m * f;
  specred_finish<<<(total + 255) / 256, 256, 0, st>>>(part, static_cast<float*>(out),
                                                      chunks, total);
  return (int)cudaGetLastError();
}

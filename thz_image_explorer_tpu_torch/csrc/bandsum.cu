// The deconvolution's band sum for NVIDIA Hopper (sm_90a): the per-pixel
// gains, the weight W = sum_b g_b T_b and its product with the spectrum, in
// one pass ahead of cuFFT's inverse transform.
//
// Replaces no TPU kernel: the JAX package computes this step as two einsums
// and elementwise products in XLA (thz_image_explorer_tpu/ops/
// deconvolution.py:_spectral_band_sum); the port's plain version is those
// products in PyTorch (ops/bandsum.py:weighted_spectrum_plain). Added
// because on the card that form moves ~27 GB at 512 x 512 x 1024 (two
// (N, m) f32 weights, the strided products and the complex copy) where the
// function needs 3.2 GB. For a block of N pixels (pixel n = i * cols + j),
// m bins (odd: the half spectrum of an even-length transform) and B bands:
//     g_b(n)  = sqrt(max(u[b, pr + i, pc + j], 0) / img[n, b])   (0/0 = NaN)
//     W(n, f) = sum_b g_b(n) T_b(f)            (b ascending, fmaf: a fixed order)
//     spec(n, f) <- spec(n, f) * W(n, f)       (in place)
// A NaN in u stays NaN (the clamp is `v < 0 ? 0 : v`, not fmaxf).
//
// Bound on this card: bytes. The pass must read the (N, m) complex64
// spectrum and write it back, 16 bytes a bin (3.2 GB, ~0.96 ms at 512 x 512
// x 1024 at 3.35 TB/s), against 2B + 4 multiply-adds a bin (~50 at B = 25,
// ~0.3 ms of the f32 peak): it stays bound by bytes only if the taps and
// gains are read from shared memory without exceeding its bandwidth.
//
// The design. A block of kWarps warps owns 64 consecutive pixels (starting
// at an even pixel), as blocks of kWarpRows rows, i.e. kWarpRows / 2 pairs
// of rows (A even, B odd). A pair's slice of the flat spectrum, 2m bins,
// starts 16-byte aligned for any odd m and is m 16-byte vectors: for i < h =
// (m - 1) / 2 the vector (A, 2i..2i+1), the vector (B, 2i+1..2i+2), and one
// straddling vector (A, m-1 | B, 0). A work item is a block of kWarpRows
// rows and a step of 32 indices i; lane l takes i = i0 + 32 s + l for all of
// the item's pairs, so a warp reads and writes each row in 512 contiguous
// bytes (16-byte vectors) and each thread holds a tile of 4 pairs x 4 bins
// (16 complex weights) in registers:
//   - per band, the lane reads its 3 taps (T[2i..2i+2]) from shared memory
//     (conflict-free) and its 8 rows' gains as two float4 broadcasts, for
//     32 multiply-adds;
//   - the taps come into shared memory in chunks of `ci` indices (2 ci + 2
//     bins of every band), reused by all 64 rows; the gains of the rows are
//     computed once, with the first chunk;
//   - the warps take a chunk's items in turn, so the warps at work at one
//     time share a block of rows and each row moves in runs of up to 4 KB;
//   - each warp copies its next item's spectrum into a shared buffer
//     (cp.async, two buffers a warp) while it computes the current item's
//     weights, so every warp keeps 4 KB of reads in flight; the products go
//     to device memory with plain stores (a row's 512-byte runs start 16
//     bytes off a 32-byte sector for half the rows: streaming hints, which
//     evict the sector before the next run completes it, measured slower);
//   - where the bands' gains and one chunk of taps do not fit (B above 64),
//     the bands come in chunks of `bc` (one step of 32 a chunk of taps), the
//     weights staying in registers across them;
//   - the straddling bins, one per row, are done last, 8-byte accesses, with
//     the same gains (from shared memory, or recomputed by the same
//     expression where the bands came in chunks: bit for bit the same).
// The plan (ci, bc, shared memory, blocks) is made by ops/bandsum.py from
// (N, m, B) and passed in; the launch refuses a plan that does not fit the
// layout below. Built without --use_fast_math (IEEE division and sqrtf),
// f32 CUDA cores only. No atomics: reruns are bit-identical, and a pixel's
// result does not depend on N or on the block that computes it.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                       // warps per block
constexpr int kWarpRows = 8;                    // rows of a work item
constexpr int kPairs = kWarpRows / 2;           // row pairs of a work item
constexpr int kRows = kWarps * kWarpRows;       // rows a block
constexpr int kMinBlocks = 2;                   // blocks an SM (the register budget)
constexpr int kBufBytes = 2 * kWarpRows * kWarp * 16;  // a warp's two spectrum buffers
constexpr int kSmemLimit = 232448;              // shared memory a block may use (227 KB)
static_assert(kWarpRows % 4 == 0 && kRows == 64, "float4 gains; ops/bandsum.BLOCK_ROWS");

struct Args {
  float2* spec;         // (n, m) complex, overwritten
  const float* u;       // (bands, h2, w2)
  const float* img;     // (n, bands)
  const float2* taps;   // (bands, m) complex
  long long n;
  int m, bands, cols, h2, w2, pr, pc;
  int ci;  // vector indices a chunk of taps (a multiple of 32)
  int bc;  // bands a chunk of bands
};

// Shared-memory bytes of a block: the chunk of taps (bc rows of 2 ci + 2
// bins), the gains (bc rows of kRows pixels), then each warp's two spectrum
// buffers. ops/bandsum.py mirrors it.
__host__ __device__ constexpr long long layout_bytes(int ci, int bc) {
  return (long long)bc * (2 * ci + 2) * 8 + (long long)bc * kRows * 4 +
         (long long)kWarps * kBufBytes;
}

__device__ __forceinline__ float gain(const Args& a, long long n, int b) {
  const long long i = n / a.cols, j = n - i * a.cols;
  const float v = a.u[((long long)b * a.h2 + a.pr + i) * a.w2 + a.pc + j];
  return sqrtf((v < 0.f ? 0.f : v) / a.img[n * a.bands + b]);
}

__device__ __forceinline__ float2 cmul(float2 s, float2 w) {
  return make_float2(fmaf(s.x, w.x, -(s.y * w.y)), fmaf(s.x, w.y, s.y * w.x));
}

__device__ __forceinline__ void acc(float2& w, float g, float re, float im) {
  w.x = fmaf(g, re, w.x);
  w.y = fmaf(g, im, w.y);
}

// Bands b0..b0+bn-1 of the taps for the vector indices from i0 into shared
// memory: a warp a band, its lanes along the bins, four loads in flight.
__device__ __forceinline__ void fill_taps(float2* taps_s, const Args& a, int ts, int i0, int b0,
                                          int bn, int warp, int lane) {
  for (int b = warp; b < bn; b += kWarps) {
    const float2* src = a.taps + (long long)(b0 + b) * a.m + 2 * i0;
    const int left = a.m - 2 * i0;  // bins of the band from 2 i0 on
    for (int q0 = 0; q0 < ts; q0 += 4 * kWarp) {
      float2 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j * kWarp + lane;
        v[j] = q < ts && q < left ? src[q] : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + j * kWarp + lane;
        if (q < ts) taps_s[b * ts + q] = v[j];
      }
    }
  }
}

// The gains of bands b0..b0+bn-1 for the block's rows into shared memory: a
// warp a band, its lanes along the rows.
__device__ __forceinline__ void fill_gains(float* gains_s, const Args& a, long long row0, int b0,
                                           int bn, int warp, int lane) {
  for (int b = warp; b < bn; b += kWarps) {
    float g[kRows / kWarp];
#pragma unroll
    for (int j = 0; j < kRows / kWarp; ++j) {
      const long long n = row0 + j * kWarp + lane;
      g[j] = n < a.n ? gain(a, n, b0 + b) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRows / kWarp; ++j) gains_s[b * kRows + j * kWarp + lane] = g[j];
  }
}

__global__ void __launch_bounds__(kWarps * kWarp, kMinBlocks) bandsum_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ts = 2 * a.ci + 2;  // bins of a band's chunk of taps
  float2* taps_s = reinterpret_cast<float2*>(smem_raw);
  float* gains_s = reinterpret_cast<float*>(taps_s + (size_t)a.bc * ts);
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  float4* buf = reinterpret_cast<float4*>(gains_s + (size_t)a.bc * kRows) +
                warp * 2 * kWarpRows * kWarp;  // [slot][row of the item][lane]
  float4* spec4 = reinterpret_cast<float4*>(a.spec);
  const long long row0 = (long long)blockIdx.x * kRows;
  const int h = (a.m - 1) / 2;
  const int chunks_b = (a.bands + a.bc - 1) / a.bc;

  for (int i0 = 0; i0 < h; i0 += a.ci) {
    if (chunks_b == 1) {  // all bands at once: a new chunk of taps, and the gains once
      __syncthreads();    // every warp is done with the previous chunk
      fill_taps(taps_s, a, ts, i0, 0, a.bands, warp, lane);
      if (i0 == 0) fill_gains(gains_s, a, row0, 0, a.bands, warp, lane);
      __syncthreads();
    }
    const int steps = (min(a.ci, h - i0) + kWarp - 1) / kWarp;
    // the chunk's work items, (a block of kWarpRows rows, a step of 32 vector
    // indices), taken by the warps in turn: the warps at work at one time
    // share a block of rows, so each row is read and written in runs of up
    // to kWarps x 512 contiguous bytes. Every warp takes as many items.
    const int items = kRows / kWarpRows * steps;
    // an item's spectrum into the warp's buffer `slot`, one commit group
    auto fetch = [&](int t, int slot) {
      const long long ra0 = row0 + t / steps * kWarpRows;
      const long long i = i0 + (t % steps) * kWarp + lane;
      if (i < h) {
#pragma unroll
        for (int p = 0; p < kPairs; ++p) {
          const long long ra = ra0 + 2 * p, rb = ra + 1;
          if (ra < a.n)
            __pipeline_memcpy_async(buf + (slot * kWarpRows + 2 * p) * kWarp + lane,
                                    spec4 + (ra * a.m + 2 * i) / 2, 16);
          if (rb < a.n)
            __pipeline_memcpy_async(buf + (slot * kWarpRows + 2 * p + 1) * kWarp + lane,
                                    spec4 + (rb * a.m + 2 * i + 1) / 2, 16);
        }
      }
      __pipeline_commit();
    };
    fetch(warp, 0);
    int slot = 0;
    for (int t = warp; t < items; t += kWarps, slot ^= 1) {
      if (t + kWarps < items) {
        fetch(t + kWarps, slot ^ 1);
      } else {
        __pipeline_commit();  // an empty group: the wait below counts alike
      }
      const int rl = t / steps * kWarpRows;      // the item's first row in the block
      const int k = (t % steps) * kWarp + lane;  // vector index within the chunk
      const long long ra0 = row0 + rl;           // even
      const long long i = i0 + k;
      const bool live = i < h;
      float2 wa0[kPairs], wa1[kPairs], wb0[kPairs], wb1[kPairs];
#pragma unroll
      for (int p = 0; p < kPairs; ++p)
        wa0[p] = wa1[p] = wb0[p] = wb1[p] = make_float2(0.f, 0.f);
      for (int c = 0; c < chunks_b; ++c) {
        const int b0 = c * a.bc, bn = min(a.bc, a.bands - b0);
        if (chunks_b > 1) {  // a chunk of bands (one item a warp: ci = 32)
          __syncthreads();
          fill_taps(taps_s, a, ts, i0, b0, bn, warp, lane);
          fill_gains(gains_s, a, row0, b0, bn, warp, lane);
          __syncthreads();
        }
        const float2* tk = taps_s + 2 * k;
        const float* gk = gains_s + rl;
        for (int b = 0; b < bn; ++b) {
          const float4 t01 = *reinterpret_cast<const float4*>(tk + b * ts);
          const float2 t2 = tk[b * ts + 2];
          float gr[kWarpRows];  // rows A, B of pair 0, then of pair 1, ...
#pragma unroll
          for (int q = 0; q < kWarpRows; q += 4) {
            const float4 v = *reinterpret_cast<const float4*>(gk + b * kRows + q);
            gr[q] = v.x;
            gr[q + 1] = v.y;
            gr[q + 2] = v.z;
            gr[q + 3] = v.w;
          }
#pragma unroll
          for (int p = 0; p < kPairs; ++p) {
            acc(wa0[p], gr[2 * p], t01.x, t01.y);      // A, bin 2i
            acc(wa1[p], gr[2 * p], t01.z, t01.w);      // A, bin 2i + 1
            acc(wb0[p], gr[2 * p + 1], t01.z, t01.w);  // B, bin 2i + 1
            acc(wb1[p], gr[2 * p + 1], t2.x, t2.y);    // B, bin 2i + 2
          }
        }
      }
      __pipeline_wait_prior(1);  // this item's spectrum is in the buffer
#pragma unroll
      for (int p = 0; p < kPairs; ++p) {
        const long long ra = ra0 + 2 * p, rb = ra + 1;
        if (live && ra < a.n) {
          const float4 s = buf[(slot * kWarpRows + 2 * p) * kWarp + lane];
          const float2 x = cmul(make_float2(s.x, s.y), wa0[p]);
          const float2 y = cmul(make_float2(s.z, s.w), wa1[p]);
          spec4[(ra * a.m + 2 * i) / 2] = make_float4(x.x, x.y, y.x, y.y);
        }
        if (live && rb < a.n) {
          const float4 s = buf[(slot * kWarpRows + 2 * p + 1) * kWarp + lane];
          const float2 x = cmul(make_float2(s.x, s.y), wb0[p]);
          const float2 y = cmul(make_float2(s.z, s.w), wb1[p]);
          spec4[(rb * a.m + 2 * i + 1) / 2] = make_float4(x.x, x.y, y.x, y.y);
        }
      }
    }
  }

  // the straddling bins: m - 1 of an even row, 0 of an odd row (row0 is
  // even); the gains from shared memory where all bands' are there
  const bool kept = chunks_b == 1 && h > 0;
  for (int r = tid; r < kRows && row0 + r < a.n; r += blockDim.x) {
    const long long n = row0 + r;
    const int bin = (r & 1) ? 0 : a.m - 1;
    float2 w = make_float2(0.f, 0.f);
#pragma unroll 5
    for (int b = 0; b < a.bands; ++b) {
      const float2 t = a.taps[(long long)b * a.m + bin];
      acc(w, kept ? gains_s[b * kRows + r] : gain(a, n, b), t.x, t.y);
    }
    float2* x = a.spec + n * a.m + bin;
    *x = cmul(*x, w);
  }
}

}  // namespace

// Shared-memory bytes of a block at `ci` vector indices a chunk of taps and
// `bc` bands a chunk; ops/bandsum.py mirrors it.
extern "C" long long thz_bandsum_smem(int ci, int bc) {
  if (ci < 1 || bc < 1) return -1;
  return layout_bytes(ci, bc);
}

// The compiled shape: out[0..2] = warps a block, rows a block, shared memory
// a block may use.
extern "C" void thz_bandsum_config(long long* out) {
  out[0] = kWarps;
  out[1] = kRows;
  out[2] = kSmemLimit;
}

// spec: (n, m) complex64, 16-byte aligned, overwritten; u: (bands, h2, w2)
// f32; img: (n, bands) f32; taps: (bands, m) complex64; all on the device.
// Pixel p = i * cols + j of the block reads u at (pr + i, pc + j). `plan`
// holds ci, bc, blocks and shared-memory bytes (ops/bandsum.py). Launches
// one kernel on `stream`; does not synchronize. Returns 0,
// cudaErrorInvalidValue for arguments or a plan the kernel does not take,
// or the CUDA error of the refused launch.
extern "C" int thz_bandsum(void* spec, const void* u, const void* img, const void* taps,
                           long long n, int m, int bands, int cols, int h2, int w2, int pr,
                           int pc, const long long* plan, void* stream) {
  if (n < 0 || m < 1 || m % 2 == 0 || bands < 1 || cols < 1 || n % cols || pr < 0 || pc < 0 ||
      pr + n / cols > h2 || pc + cols > w2 || !plan || (uintptr_t)spec % 16)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const long long ci = plan[0], bc = plan[1], blocks = plan[2], smem = plan[3];
  if (ci < kWarp || ci % kWarp || ci > (1 << 20) || bc < 1 || bc > bands ||
      (bc < bands && ci != kWarp) || smem > kSmemLimit || smem != layout_bytes((int)ci, (int)bc) ||
      blocks != (n + kRows - 1) / kRows || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      bandsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const Args a{static_cast<float2*>(spec), static_cast<const float*>(u),
               static_cast<const float*>(img), static_cast<const float2*>(taps), n, m, bands,
               cols, h2, w2, pr, pc, (int)ci, (int)bc};
  bandsum_kernel<<<(unsigned)blocks, kWarps * kWarp, (size_t)smem,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

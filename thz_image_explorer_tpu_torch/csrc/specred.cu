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
// SXM's 3.35 TB/s. The accurate atan2f and sqrtf put the instruction issue
// close to that (PERF.md gives the issue floor).
//
// The design. One launch. The work is a grid of items, each a contiguous
// range of row tiles (`rows` rows, an even number) and a chunk of at most
// kMaxCols columns (one chunk for F <= kMaxCols); persistent blocks, all
// resident, take the items in turn (one item each unless the column chunks
// outnumber the blocks the card holds):
//   - Tiles come into a ring of `stages` shared-memory buffers by one 1-D
//     bulk copy each (cp.async.bulk, completion on an mbarrier), issued by
//     thread 0 `stages` tiles ahead. A tile starts at an even row, so its
//     bytes (a multiple of two rows, 16 * F) are 16-byte aligned for any F;
//     an odd last row of the spectrum, and a spectrum whose pointer is not
//     16-byte aligned, are read with plain loads. Where whole rows do not fit
//     a block (F above ~6 600 columns: the wide route) a tile holds only its
//     chunk's columns and the one left of them, read with plain loads. The
//     caller picks the route from the shapes and the pointer.
//   - A flat element-parallel pass over the staged tile computes each
//     element's amp and angle exactly once (no idle lanes at a ragged F, no
//     recomputed halo) into a shared (amp, angle) buffer; each chunk also
//     takes the angle of the column left of it.
//   - A column-owner pass (one thread per column) adds the tile's rows into
//     register accumulators: the increment reads the left neighbour's angle
//     from shared memory, the tile's mask values are staged beside it and read
//     as float4 broadcasts. Two (amp, angle) and mask buffers alternate, so
//     one __syncthreads per tile separates the passes.
//   - Each item writes its partial sums (one row of the partial scratch per
//     row range). The launch is cooperative (every block resident), so the
//     blocks meet at a grid barrier (integer atomics that leave the counters
//     as they found them, no float atomics), and then each block sums a
//     slice of the output over all partial rows in a fixed order: reruns are
//     bit-identical, and no second kernel runs.
// The work plan (chunks, tile shape, ranges, blocks, shared memory) is
// chosen by ops/specred.py and passed in; the launch checks it against the
// layout below and refuses a plan that does not fit it.
// Built without --use_fast_math: atan2f and the strict comparisons must
// agree with torch.atan2 and ops/fourier.wrap_adjust on the card.
// Compile-time shape knobs (-D) for scripts/torch_envelope_specred_sweep.py:
// SR_ROWS, SR_STAGES (the preferred tile shape, thz_specred_config).

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#ifndef SR_ROWS
#define SR_ROWS 4
#endif
#ifndef SR_STAGES
#define SR_STAGES 4
#endif

namespace {

constexpr int kRows = SR_ROWS;      // spectrum rows per tile (even), preferred
constexpr int kStages = SR_STAGES;  // tile buffers in the ring, preferred
constexpr int kMaxCols = 640;       // columns of one block (threads <= this)
constexpr int kMaxRows = 8;         // rows per tile at most
constexpr int kSmemLimit = 232448;  // shared memory a block may use (227 KB)
constexpr float kPi = 3.14159274101257324219f;      // (float)M_PI
constexpr float kTwoPi = 6.28318548202514648438f;   // (float)(2*M_PI)

static_assert(kRows >= 2 && kRows % 2 == 0 && kRows <= kMaxRows, "tiles hold row pairs");
static_assert(kStages >= 2, "two tile buffers at least");
static_assert(16 * kMaxRows <= kMaxCols, "a thread for each mask value of a tile");

__device__ __forceinline__ float wrap_adjust(float d) {
  if (d > kPi) return d - kTwoPi;
  if (d < -kPi) return d + kTwoPi;
  return d;
}

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// barriers (stages * 8, rounded to 16) | `stages` tiles of rows x ts float2
// (ts = f: whole rows; ts = cw + 1 on the wide route) | two (amp, angle)
// buffers of rows x (cw + 1) float2 | two mask buffers of rows x round4(m) f32
__host__ __device__ inline long long layout_bytes(int f, int cw, int m, int rows, int stages,
                                                  bool wide) {
  const long long ts = wide ? cw + 1 : f;
  return round_up(stages * 8, 16) + (long long)stages * rows * ts * 8 +
         2LL * rows * (cw + 1) * 8 + 2LL * rows * round_up(m, 4) * 4;
}

// The plan as ops/specred.py passes it (thz_specred's `plan` array).
struct Plan {
  long long chunks, cw, rows, stages, wide, ranges, grid, threads, smem;
};

struct Args {
  const float2* spec;
  const float* masks;
  float* partial;  // (ranges, n_out, m, f)
  int* counters;   // the grid barrier's {arrivals (0 between launches), generation}
  float* out;      // (n_out, m, f)
  int n, f, chunks, cw, rows, stages, ranges, bulk, wide;
  long long n_tiles;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// thread 0: the tile's whole row pairs into buffer `dst`, completion on `bar`
// (an arrival with no bytes where the tile has none, or on a plain route)
__device__ __forceinline__ void issue_tile(const Args& a, long long tile, float2* dst,
                                           uint32_t bar) {
  const long long r0 = tile * a.rows;
  const int rows = (int)min((long long)a.rows, a.n - r0);
  const uint32_t bytes = a.bulk ? (uint32_t)(rows & ~1) * (uint32_t)a.f * 8u : 0u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(a.spec + r0 * a.f), "r"(bytes), "r"(bar)
        : "memory");
}

// Every block of the (cooperative, so co-resident) grid waits here until
// all have arrived: `counters` = {arrivals, generation}; the last arrival
// resets the arrivals and moves the generation on.
__device__ __forceinline__ void grid_barrier(int* counters) {
  if (threadIdx.x == 0) {
    volatile int* gen = counters + 1;
    const int g0 = *gen;
    __threadfence();
    if (atomicAdd(counters, 1) == (int)gridDim.x - 1) {
      counters[0] = 0;
      __threadfence();
      atomicAdd(counters + 1, 1);
    } else {
      while (*gen == g0) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// out[i] = sum of partial[q * items + i] over q = 0 .. rows - 1 in a fixed
// tree, for this block's slice of the items, at most blockDim items at a
// time: `segs` threads an item each sum a run of rows in order into `red`,
// then one thread an item sums the runs in order.
__device__ __forceinline__ void sum_slice(const float* partial, int rows, size_t items,
                                          float* out, float* red) {
  const size_t per = (items + gridDim.x - 1) / gridDim.x;
  const size_t lo = blockIdx.x * per, hi = min(items, lo + per);
  const int nt = blockDim.x, tid = threadIdx.x;
  for (size_t i0 = lo; i0 < hi; i0 += nt) {
    const int ni = (int)min((size_t)nt, hi - i0);
    const int segs = max(1, min(rows, nt / ni));
    const int len = (rows + segs - 1) / segs;
    if (tid < ni * segs) {
      const int item = tid % ni, seg = tid / ni;
      const float* src = partial + i0 + item;
      float sum = 0.0f;
#pragma unroll 8
      for (int q = seg * len; q < min(rows, (seg + 1) * len); ++q)
        sum += __ldcg(src + (size_t)q * items);
      red[seg * ni + item] = sum;
    }
    __syncthreads();
    if (tid < ni) {
      float sum = 0.0f;
      for (int seg = 0; seg < segs; ++seg) sum += red[seg * ni + tid];
      out[i0 + tid] = sum;
    }
    __syncthreads();
  }
}

// Two blocks an SM where the accumulators are few (the publish's 5 masks
// without the complex sums): one block of ~17 warps cannot hide the element
// pass's dependent atan2f chains (three spill).
template <int M, bool WITH_COMPLEX>
__global__ void __launch_bounds__(kMaxCols, (WITH_COMPLEX ? 4 : 2) * M <= 16 ? 2 : 1)
    specred_kernel(const Args a) {
  constexpr int n_out = WITH_COMPLEX ? 4 : 2;
  constexpr int M4 = round_up(M, 4);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int f = a.f;
  const int trows = a.rows, stages = a.stages;
  const int ts = a.wide ? a.cw + 1 : f;  // a tile's row stride
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float2* tiles = reinterpret_cast<float2*>(smem_raw + round_up(stages * 8, 16));
  float2* aa = tiles + (size_t)stages * trows * ts;
  float* ms = reinterpret_cast<float*>(aa + 2 * (size_t)trows * (a.cw + 1));

  if (tid == 0)
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bars + s))
                   : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  // the thread that stages mask value (row mr, mask mm) of each tile
  const bool stager = tid < M * trows;
  const int mr = tid % trows, mm = tid / trows;
  const size_t items = (size_t)n_out * M * f;
  long long q0 = 0;  // tiles this block took before this item: ring slot and phase
  for (int w = blockIdx.x; w < a.ranges * a.chunks; w += gridDim.x) {
    const int p = w / a.chunks;
    const int k0 = (w % a.chunks) * a.cw;
    const int cw = min(a.cw, f - k0);
    const int w1 = cw + 1;  // the chunk's columns and the one left of it
    const int c0 = a.wide ? max(k0 - 1, 0) : 0;     // a tile's first column
    const int width = a.wide ? cw + (k0 > 0) : f;  // and its columns
    const long long t_lo = p * a.n_tiles / a.ranges;
    const long long ntl = (p + 1) * a.n_tiles / a.ranges - t_lo;
    // every thread is done with the buffers of the block's previous item
    __syncthreads();
    if (tid == 0)
      for (int s = 0; s < stages && s < ntl; ++s) {
        const int slot = (int)((q0 + s) % stages);
        issue_tile(a, t_lo + s, tiles + (size_t)slot * trows * ts, smem_addr(bars + slot));
      }

    float acc[n_out][M];
#pragma unroll
    for (int o = 0; o < n_out; ++o)
#pragma unroll
      for (int r = 0; r < M; ++r) acc[o][r] = 0.0f;
    // the element pass's row of flat index i is umulhi(i, ceil(2^32 / w1)):
    // exact while i < 2^32 / w1^2, which holds for i < rows * w1 <= 8 * 641
    const unsigned inv_w1 = (unsigned)((0x100000000ull + w1 - 1) / w1);
    // tile j's mask value is loaded during tile j - 1
    auto mask_value = [&](long long j) {
      const long long row = (t_lo + j) * trows + mr;
      return stager && j < ntl && row < a.n ? a.masks[(size_t)mm * a.n + row] : 0.0f;
    };
    float mv_next = mask_value(0);

    for (long long j = 0; j < ntl; ++j) {
      const long long q = q0 + j;
      const int s = (int)(q % stages);
      const int b = (int)(q & 1);
      const long long r0 = (t_lo + j) * trows;
      const int rows = (int)min((long long)trows, a.n - r0);
      float2* st = tiles + (size_t)s * trows * ts;
      float2* aab = aa + (size_t)b * trows * (a.cw + 1);
      float* msb = ms + b * trows * M4;
      const float mv = mv_next;
      mv_next = mask_value(j + 1);
      mbar_wait(smem_addr(bars + s), (uint32_t)((q / stages) & 1));
      const int first = a.bulk ? (rows & ~1) : 0;  // rows the bulk copy brought
      if (first < rows) {
        const float2* src = a.spec + (r0 + first) * f + c0;
        for (int i = tid; i < (rows - first) * width; i += nt) {
          const int r = i / width, c = i - r * width;
          st[(first + r) * ts + c] = src[(size_t)r * f + c];
        }
        __syncthreads();
      }
      // element pass: amp and angle once per element
      // (the first chunk's slot 0 has no left column: it takes column 0 and
      // is never read)
#pragma unroll 2
      for (int i = tid; i < rows * w1; i += nt) {
        const int r = (int)__umulhi((unsigned)i, inv_w1);
        const float2 z = st[r * ts + max(k0 - 1 + i - r * w1, 0) - c0];
        // __fmul_rn/__fadd_rn: no contraction into an fma, so amp is the
        // same rounding as the plain version's sqrt(c*c + s*s)
        const float amp = sqrtf(__fadd_rn(__fmul_rn(z.x, z.x), __fmul_rn(z.y, z.y)));
        aab[i] = make_float2(amp, atan2f(z.y, z.x));
      }
      if (stager) msb[mr * M4 + mm] = mv;
      // generic writes to the tile (plain rows) come before the next bulk copy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      // every thread is done with tile q - 1: refill its buffer
      if (tid == 0 && j >= 1 && j - 1 + stages < ntl) {
        const int sp = (int)((q - 1) % stages);
        issue_tile(a, t_lo + j - 1 + stages, tiles + (size_t)sp * trows * ts,
                   smem_addr(bars + sp));
      }
      // column pass: one thread per column
      if (tid < cw) {
        const int k = k0 + tid;
        for (int r = 0; r < rows; ++r) {
          const float2 v = aab[r * w1 + tid + 1];
          const float left = aab[r * w1 + tid].y;
          const float inc = k > 0 ? wrap_adjust(v.y - left) : v.y;
          float2 z;
          if constexpr (WITH_COMPLEX) z = st[r * ts + k - c0];
          const float4* w4 = reinterpret_cast<const float4*>(msb + r * M4);
#pragma unroll
          for (int qq = 0; qq < M4 / 4; ++qq) {
            const float4 wq = w4[qq];
            const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (4 * qq + i < M) {
                const int mi = 4 * qq + i;
                acc[0][mi] = fmaf(wv[i], v.x, acc[0][mi]);
                acc[1][mi] = fmaf(wv[i], inc, acc[1][mi]);
                if constexpr (WITH_COMPLEX) {
                  acc[2][mi] = fmaf(wv[i], z.x, acc[2][mi]);
                  acc[3][mi] = fmaf(wv[i], z.y, acc[3][mi]);
                }
              }
            }
          }
        }
      }
    }
    q0 += ntl;

    // this item's partial sums
    if (tid < cw) {
#pragma unroll
      for (int o = 0; o < n_out; ++o)
#pragma unroll
        for (int r = 0; r < M; ++r)
          a.partial[(size_t)p * items + ((size_t)o * M + r) * f + k0 + tid] = acc[o][r];
    }
  }

  // after a grid barrier every block sums its slice of all partials in a
  // fixed order
  __threadfence();
  __syncthreads();
  grid_barrier(a.counters);
  sum_slice(a.partial, a.ranges, items, a.out, reinterpret_cast<float*>(tiles));
}

using KernelFn = void (*)(const Args);

KernelFn pick(int m, bool wc) {
  switch (m) {
#define THZ_SPECRED_CASE(MM) \
  case MM:                   \
    return wc ? specred_kernel<MM, true> : specred_kernel<MM, false>;
    THZ_SPECRED_CASE(1) THZ_SPECRED_CASE(2) THZ_SPECRED_CASE(3) THZ_SPECRED_CASE(4)
    THZ_SPECRED_CASE(5) THZ_SPECRED_CASE(6) THZ_SPECRED_CASE(7) THZ_SPECRED_CASE(8)
    THZ_SPECRED_CASE(9) THZ_SPECRED_CASE(10) THZ_SPECRED_CASE(11) THZ_SPECRED_CASE(12)
    THZ_SPECRED_CASE(13) THZ_SPECRED_CASE(14) THZ_SPECRED_CASE(15) THZ_SPECRED_CASE(16)
#undef THZ_SPECRED_CASE
    default:
      return nullptr;
  }
}

// Whether the plan fits the kernel and the layout: every column in one
// chunk, a thread per column and per mask value of a tile, even rows, the
// shared memory of the layout, no more blocks than items.
bool plan_fits(const Plan& p, int n, int f, int m) {
  if (p.cw < 1 || p.cw > kMaxCols || p.chunks < 1 || p.chunks * p.cw < f ||
      (p.chunks - 1) * p.cw >= f)
    return false;
  if (p.rows < 2 || p.rows % 2 || p.rows > kMaxRows || p.stages < 2 || p.stages > 64)
    return false;
  if (p.threads % 32 || p.threads < p.cw || p.threads < m * p.rows || p.threads > kMaxCols)
    return false;
  if (p.smem > kSmemLimit ||
      p.smem != layout_bytes(f, (int)p.cw, m, (int)p.rows, (int)p.stages, p.wide != 0))
    return false;
  // sum_slice's scratch (a float a thread) lies past the barriers
  if (4 * p.threads > p.smem - round_up((int)p.stages * 8, 16)) return false;
  const long long n_tiles = (n + p.rows - 1) / p.rows;
  return p.ranges >= 1 && p.ranges <= n_tiles && p.grid >= 1 &&
         p.grid <= p.ranges * p.chunks && p.ranges * p.chunks <= 0x7fffffffLL;
}

}  // namespace

// Shared-memory bytes of one block for f columns, chunks of cw columns, m
// masks, tiles of `rows` rows in `stages` buffers, whole rows or (wide) the
// chunk's columns; ops/specred.py mirrors it.
extern "C" long long thz_specred_smem(int f, int cw, int m, int rows, int stages, int wide) {
  if (f < 1 || cw < 1 || m < 1 || rows < 1 || stages < 1) return -1;
  return layout_bytes(f, cw, m, rows, stages, wide != 0);
}

// The compiled shape: out[0..3] = preferred rows per tile, preferred tile
// buffers, columns of one block at most, shared memory a block may use.
extern "C" void thz_specred_config(long long* out) {
  out[0] = kRows;
  out[1] = kStages;
  out[2] = kMaxCols;
  out[3] = kSmemLimit;
}

// Blocks of `threads` threads and `smem` shared-memory bytes one SM of the
// current device holds at once for m masks; lets the kernel use up to the
// block limit of shared memory first (once per device and kernel: the
// launch relies on it). Returns the count, or -(CUDA error).
extern "C" int thz_specred_blocks_per_sm(int m, int with_complex, int threads, long long smem) {
  const KernelFn fn = pick(m, with_complex != 0);
  if (!fn || threads < 1 || smem < 0 || smem > kSmemLimit) return -(int)cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, (size_t)smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// spec: (n, f) complex64 as interleaved float2; masks: (m, n) f32; partial:
// ranges * n_out * m * f f32 scratch; counters: 2 int32, zero before the
// first launch (each launch leaves them so), one pair per stream; out:
// (n_out, m, f) f32, with n_out = 4 if with_complex else 2. `plan` holds
// chunks, cw, rows, stages, wide, ranges, grid, threads, smem (ops/specred.
// plan); `bulk`: whole row pairs by bulk copies (not wide, spec 16-byte
// aligned). One cooperative launch on `stream`, no synchronization; returns
// 0, cudaErrorInvalidValue for a plan that does not fit, or the CUDA error
// of the refused launch.
extern "C" int thz_specred(const void* spec, const void* masks, void* partial, void* counters,
                           void* out, int n, int f, int m, int with_complex,
                           const long long* plan, int bulk, void* stream) {
  const KernelFn fn = pick(m, with_complex != 0);
  if (!fn || n < 1 || f < 1 || !plan) return (int)cudaErrorInvalidValue;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6], plan[7], plan[8]};
  if (!plan_fits(p, n, f, m)) return (int)cudaErrorInvalidValue;
  if (bulk && (p.wide || (uintptr_t)spec % 16)) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float2*>(spec), static_cast<const float*>(masks),
         static_cast<float*>(partial), static_cast<int*>(counters), static_cast<float*>(out),
         n, f, (int)p.chunks, (int)p.cw, (int)p.rows, (int)p.stages, (int)p.ranges,
         bulk != 0, p.wide != 0, (n + p.rows - 1) / p.rows};
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fn), dim3((unsigned)p.grid),
                                          dim3((unsigned)p.threads), args, (size_t)p.smem,
                                          static_cast<cudaStream_t>(stream));
}

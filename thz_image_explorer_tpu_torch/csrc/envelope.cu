// Per-trace envelope and min-max normalization of the 3-D voxel view, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel thz_image_explorer_tpu/ops/voxel.py
// :_envelope_kernel (launched by _envelope_pallas). It computes the function
// of the JAX package's f32 XLA path (_normalized_opacities): for each trace
// v = x[n, :] of length T,
//     p[t]   = (v[t] * v[t])^c                      (0^0 = 1)
//     env[t] = sum_k taps[k] * p[t + k - r]          (k = 0..2r; p = 0 outside 0..T-1)
//     out[t] = (env[t] - min env) / (max env - min env)
// and out = 0 for the whole trace where max env < thr or |max - min| <= 1e-6.
// It is a correlation: the taps are not flipped.
//
// Bound on this card: bytes. The function reads the (N, T) f32 traces once
// and writes the (N, T) f32 opacities once, 8 bytes a sample (0.098 ms at
// 200 x 200 x 1024 at 3.35 TB/s), against 2 (2r + 1) + 8 operations a sample.
//
// The design. Persistent blocks of kWarps warps; each warp walks the traces
// n = g, g + G, ... (g its global warp index, G the warps of the grid) on its
// own, with no block-wide synchronization after the set-up:
//   - Bulk route (T a multiple of 4 and 16-byte aligned rows): whole traces
//     come into a ring of kStages shared-memory buffers by 1-D bulk copies
//     (cp.async.bulk, completion on one mbarrier per buffer), issued by lane 0
//     kStages traces ahead, so the next traces' bytes are in flight while one
//     computes. The normalized trace leaves by a bulk store from shared memory
//     (two output buffers, so a store's read overlaps the next trace; fewer
//     warps and buffers where a long trace needs the room).
//   - Plain route (any other T or alignment, chosen from the shapes and the
//     pointers before the launch): the warp reads and writes its trace with
//     4-byte coalesced accesses, through the same buffers.
//   - Where no output buffer fits a block (traces of more than ~29 000
//     samples), the raw envelope goes to the output row in device memory
//     and is normalized there.
//   - p is computed once per sample, in place in the buffer: q * q with
//     q = v * v at c == 2 (what torch.pow(q, 2.0) computes), powf otherwise.
//   - The correlation is register-blocked: each lane computes kRun
//     consecutive outputs from one window of kRun + 2r values loaded as
//     float4s, with the taps in registers for r <= kMaxR (one instantiation
//     per radius) and a loop over the taps (read through the L1) above.
//   - Min and max stay in registers and are reduced by shuffles; the raw
//     envelope is written once to the output buffer and normalized there.
// Each buffer carries a zero halo of round4(r) floats on the left and at
// least r on the right, written once, which the copies never touch. The
// block shape and the routes are chosen by ops/envelope.py and passed in;
// the launch checks them against the layout below. Built without
// --use_fast_math: powf(0, 0) = 1 and the division is IEEE. No atomics:
// reruns are bit-identical. Compile-time shape knobs (-D) for
// scripts/torch_envelope_specred_sweep.py: ENV_WARPS, ENV_STAGES (the
// preferred block shape, thz_envelope_config).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#ifndef ENV_WARPS
#define ENV_WARPS 4
#endif
#ifndef ENV_STAGES
#define ENV_STAGES 2
#endif

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = ENV_WARPS;    // warps (trace walkers) per block
constexpr int kStages = ENV_STAGES;  // input buffers per warp (bulk route)
constexpr int kRun = 8;              // consecutive outputs per lane
constexpr int kMaxR = 12;            // radii with their own instantiation
constexpr int kSmemLimit = 232448;   // shared memory a block may use (227 KB)

static_assert(kWarps >= 1 && kStages >= 1, "one warp and one stage at least");

__host__ __device__ constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Floats of one input buffer: the left halo, the trace rounded up to kRun
// outputs, and the right halo the last run's float4 window reaches.
__host__ __device__ constexpr int stage_floats(int t, int r) {
  return (t + kRun - 1) / kRun * kRun - kRun + round4(round4(r) + r + kRun);
}
__host__ __device__ constexpr int out_floats(int t) { return (t + kRun - 1) / kRun * kRun; }

// barriers (warps * stages * 8, rounded to 16) | per warp: `stages` input
// buffers, `outs` output buffers
__host__ __device__ inline long long layout_bytes(int warps, int stages, int outs, int t, int r) {
  const long long bars = ((long long)warps * stages * 8 + 15) / 16 * 16;
  const long long per_warp =
      (long long)stages * stage_floats(t, r) + (long long)outs * out_floats(t);
  return bars + 4LL * warps * per_warp;
}

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

// lane 0: expect `bytes` on `bar` and copy them from global `src` to shared `dst`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// p = (v*v)^c in place over buf[0 .. t)
__device__ __forceinline__ void power_in_place(float* buf, int t, float c, bool vec, int lane) {
  float4* b4 = reinterpret_cast<float4*>(buf);
  if (vec && c == 2.0f) {
    for (int i = lane; i < t / 4; i += kWarp) {
      const float4 v = b4[i];
      const float q0 = v.x * v.x, q1 = v.y * v.y, q2 = v.z * v.z, q3 = v.w * v.w;
      b4[i] = make_float4(q0 * q0, q1 * q1, q2 * q2, q3 * q3);
    }
  } else if (vec) {
    for (int i = lane; i < t / 4; i += kWarp) {
      const float4 v = b4[i];
      b4[i] = make_float4(powf(v.x * v.x, c), powf(v.y * v.y, c), powf(v.z * v.z, c),
                          powf(v.w * v.w, c));
    }
  } else {
    const bool square = c == 2.0f;
    for (int i = lane; i < t; i += kWarp) {
      const float q = buf[i] * buf[i];
      buf[i] = square ? q * q : powf(q, c);
    }
  }
}

// The kRun outputs t0 .. t0 + kRun - 1 of the correlation; `win` points at
// p[t0 - lh] (16-byte aligned), taps in registers.
template <int R>
__device__ __forceinline__ void correlate_run(const float* win, const float (&tap)[2 * R + 1],
                                              float (&acc)[kRun]) {
  constexpr int kLh = round4(R);
  constexpr int kN4 = round4(kLh + R + kRun) / 4;
  float w[4 * kN4];
  const float4* w4 = reinterpret_cast<const float4*>(win);
#pragma unroll
  for (int i = 0; i < kN4; ++i) {
    const float4 v = w4[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int i = 0; i < kRun; ++i) {
    float a = 0.0f;
#pragma unroll
    for (int k = 0; k < 2 * R + 1; ++k) a = fmaf(tap[k], w[kLh - R + i + k], a);
    acc[i] = a;
  }
}

// The same for a radius above kMaxR: taps read through the L1.
__device__ __forceinline__ void correlate_run_generic(const float* win,
                                                      const float* __restrict__ taps, int r,
                                                      float (&acc)[kRun]) {
  const float* b = win + round4(r) - r;
#pragma unroll
  for (int i = 0; i < kRun; ++i) acc[i] = 0.0f;
  for (int k = 0; k <= 2 * r; ++k) {
    const float tk = __ldg(taps + k);
#pragma unroll
    for (int i = 0; i < kRun; ++i) acc[i] = fmaf(tk, b[i + k], acc[i]);
  }
}

// R >= 0: that radius with taps in registers; R < 0: any radius r.
template <int R>
__global__ void __launch_bounds__(kWarp * kWarps)
envelope_kernel(const float* __restrict__ x, float* __restrict__ out,
                const float* __restrict__ taps, long long n, int t, int r, float contrast,
                float thr, int warps, int stages, int outs, int bulk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int lh = round4(r);
  const int sf = stage_floats(t, r);
  const int of = out_floats(t);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  float* mine = reinterpret_cast<float*>(smem_raw + ((size_t)warps * stages * 8 + 15) / 16 * 16) +
                (size_t)warp * ((size_t)stages * sf + (size_t)outs * of);
  float* outbuf = mine + (size_t)stages * sf;
  uint64_t* my_bars = bars + warp * stages;

  // set-up: zeroed buffers (the halos stay zero), barriers
  for (int i = lane; i < stages * sf; i += kWarp) mine[i] = 0.0f;
  if (lane == 0 && bulk)
    for (int s = 0; s < stages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(my_bars + s))
                   : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const long long g = (long long)blockIdx.x * warps + warp;
  const long long gstride = (long long)gridDim.x * warps;
  if (g >= n) return;  // the whole warp: no block-wide sync below
  const long long nj = (n - 1 - g) / gstride + 1;

  float tap[R >= 0 ? 2 * R + 1 : 1];
  if constexpr (R >= 0) {
#pragma unroll
    for (int i = 0; i < 2 * R + 1; ++i) tap[i] = __ldg(taps + i);
  }
  const uint32_t row_bytes = (uint32_t)t * 4u;

  if (bulk && lane == 0)
    for (int s = 0; s < stages && s < nj; ++s)
      bulk_load(mine + (size_t)s * sf + lh, x + (size_t)(g + s * gstride) * t, row_bytes,
                smem_addr(my_bars + s));

  for (long long j = 0; j < nj; ++j) {
    const long long row = g + j * gstride;
    const int s = (int)(j % stages);
    float* buf = mine + (size_t)s * sf;  // p[i] at buf[lh + i]
    float* orow = out + (size_t)row * t;
    // the output buffer of this trace (none where outs == 0: the raw
    // envelope then goes to orow); a shared-memory pointer on every route
    float* ob = outbuf + (outs == 2 ? (size_t)(j & 1) * of : 0);
    if (bulk) {
      mbar_wait(smem_addr(my_bars + s), (uint32_t)((j / stages) & 1));
    } else {
      const float* xr = x + (size_t)row * t;
      for (int i = lane; i < t; i += kWarp) buf[lh + i] = xr[i];
      __syncwarp();
    }
    power_in_place(buf + lh, t, contrast, bulk != 0, lane);
    // the bulk store that last used ob has read it
    if (bulk && lane == 0) {
      if (outs == 2) {
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      } else {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
    __syncwarp();

    float mn = INFINITY, mx = -INFINITY;
    for (int q = lane; q * kRun < t; q += kWarp) {
      const int t0 = q * kRun;
      float acc[kRun];
      if constexpr (R >= 0) {
        correlate_run<R>(buf + t0 + lh - round4(R), tap, acc);
      } else {
        correlate_run_generic(buf + t0, taps, r, acc);
      }
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        if (t0 + i < t) {
          mn = fminf(mn, acc[i]);
          mx = fmaxf(mx, acc[i]);
        }
      }
      if (outs) {
        float4* o4 = reinterpret_cast<float4*>(ob + t0);
        o4[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o4[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      } else {
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          if (t0 + i < t) orow[t0 + i] = acc[i];
      }
    }
    // every lane is done with buf; its generic writes (p) come before the
    // next bulk copy into it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (bulk && lane == 0 && j + stages < nj)
      bulk_load(buf + lh, x + (size_t)(row + stages * gstride) * t, row_bytes,
                smem_addr(my_bars + s));
    for (int off = kWarp / 2; off > 0; off >>= 1) {
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    const float rng = mx - mn;
    const bool keep = (mx >= thr) && (fabsf(rng) > 1e-6f);
    if (bulk && outs) {
      float4* o4 = reinterpret_cast<float4*>(ob);
      if (keep) {
        for (int i = lane; i < t / 4; i += kWarp) {
          const float4 v = o4[i];
          o4[i] = make_float4((v.x - mn) / rng, (v.y - mn) / rng, (v.z - mn) / rng,
                              (v.w - mn) / rng);
        }
      } else {
        for (int i = lane; i < t / 4; i += kWarp) o4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) bulk_store(out + (size_t)row * t, ob, row_bytes);
    } else if (outs) {
      for (int i = lane; i < t; i += kWarp) orow[i] = keep ? (ob[i] - mn) / rng : 0.0f;
      __syncwarp();
    } else {
      // (__syncwarp above orders the lanes' envelope writes before these reads)
      for (int i = lane; i < t; i += kWarp) orow[i] = keep ? (orow[i] - mn) / rng : 0.0f;
      __syncwarp();
    }
  }
  if (bulk && lane == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using KernelFn = void (*)(const float*, float*, const float*, long long, int, int, float, float,
                          int, int, int, int);

template <int R>
KernelFn pick(int r) {
  if constexpr (R > kMaxR) {
    return envelope_kernel<-1>;
  } else {
    return r == R ? envelope_kernel<R> : pick<R + 1>(r);
  }
}

// The plan as ops/envelope.py passes it (thz_envelope's `plan` array).
struct Plan {
  long long warps, stages, outs, bulk, grid, smem;
};

}  // namespace

// Shared-memory bytes of one block of `warps` warps, each with `stages`
// input and `outs` output buffers, at trace length t and radius r;
// ops/envelope.py mirrors it.
extern "C" long long thz_envelope_smem(int warps, int stages, int outs, int t, int r) {
  if (warps < 1 || stages < 1 || outs < 0 || t < 1 || r < 0) return -1;
  return layout_bytes(warps, stages, outs, t, r);
}

// The compiled shape: out[0..4] = preferred warps per block, preferred
// input buffers per warp, outputs per lane run, the largest radius with
// taps in registers, shared memory a block may use.
extern "C" void thz_envelope_config(long long* out) {
  out[0] = kWarps;
  out[1] = kStages;
  out[2] = kRun;
  out[3] = kMaxR;
  out[4] = kSmemLimit;
}

// Blocks of `threads` threads and `smem` shared-memory bytes one SM of the
// current device holds at once at radius r; lets the kernel use up to the
// block limit of shared memory first (once per device and kernel: the
// launch relies on it). Returns the count, or -(CUDA error).
extern "C" int thz_envelope_blocks_per_sm(int r, int threads, long long smem) {
  if (r < 0 || threads < 1 || threads > kWarp * kWarps || smem < 0 || smem > kSmemLimit)
    return -(int)cudaErrorInvalidValue;
  const KernelFn fn = pick<0>(r);
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, (size_t)smem);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// x: (n, t) f32 traces; out: (n, t) f32; taps: (2r + 1,) f32, all on the
// device. `plan` holds warps, input and output buffers per warp, the bulk
// route (T a multiple of 4, x and out 16-byte aligned), blocks and
// shared-memory bytes (ops/envelope.py). Launches one kernel on `stream`;
// does not synchronize. Returns 0, cudaErrorInvalidValue for arguments or a
// plan the kernel does not take, or the CUDA error of the refused launch.
extern "C" int thz_envelope(const void* x, void* out, const void* taps, long long n, int t,
                            int r, float contrast, float thr, const long long* plan,
                            void* stream) {
  if (n < 0 || t < 1 || r < 0 || !plan) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const Plan p{plan[0], plan[1], plan[2], plan[3], plan[4], plan[5]};
  if (p.warps < 1 || p.warps > kWarps || p.stages < 1 || p.stages > 64 || p.outs < 0 ||
      p.outs > 2 || p.smem > kSmemLimit ||
      p.smem != layout_bytes((int)p.warps, (int)p.stages, (int)p.outs, t, r) || p.grid < 1 ||
      p.grid > 0x7fffffffLL || p.grid > (n + p.warps - 1) / p.warps)
    return (int)cudaErrorInvalidValue;
  if (p.bulk && (t % 4 || (uintptr_t)x % 16 || (uintptr_t)out % 16))
    return (int)cudaErrorInvalidValue;
  const KernelFn fn = pick<0>(r);
  fn<<<(unsigned)p.grid, (unsigned)(p.warps * kWarp), (size_t)p.smem,
       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), static_cast<const float*>(taps), n,
      t, r, contrast, thr, (int)p.warps, (int)p.stages, (int)p.outs, (int)p.bulk);
  return (int)cudaGetLastError();
}

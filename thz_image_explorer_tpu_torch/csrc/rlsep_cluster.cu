// Separable Richardson-Lucy iterations over a stack of bands with each
// band's estimate held on chip, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel thz_image_explorer_tpu/ops/pallas_rl.py
// :_sep_kernel (launched by rl_bands_separable), which keeps one band's
// whole recurrence in VMEM. Same function as csrc/rlsep.cu: for every band
// b, n_iter[b] times,
//     u <- u * R^T (P / (R u C^T + 1e-12)) C
// a zero-boundary correlation with the band's row profile px along axis 0
// and its column profile py along axis 1 (R^T and C read the taps mirrored).
//
// Bound on this card: operations. At the reference Apply (25 bands, a
// 246 x 256 canvas, sum(n_iter) = 2249) the band-limited work is 3.28e10
// operations, 0.490 ms at the 67 TFLOP/s f32 peak of the whole card. The
// bands are independent, but band 0 alone iterates 408 times in sequence:
// its 1.08e10 operations on the S SMs of one cluster take at least 1.33 ms
// at S = 16 (the card's peak times 16 / 132). That critical path is the
// floor of this design.
//
// What the design does about it.
// - One launch per host checkpoint: iterations it0 .. it1-1 of every band
//   still iterating, each band stopping at min(it1, n_iter[b]). Nothing
//   crosses device memory between iterations.
// - One thread-block cluster of S CTAs per band (grid S x bands, band slots
//   in the host's order of descending n_iter, so the longest band's cluster
//   is scheduled first). CTA q owns a contiguous slab of the canvas rows and
//   keeps u and rel for them in its shared memory for the whole launch.
// - Axis 0 reads the rows within the band's reach from whichever CTA owns
//   them, through distributed shared memory: a per-CTA table maps each row
//   of the CTA's halo window to its owner's slab (or to a zero row outside
//   the canvas), so a reach longer than one slab works. A pass covers
//   kStrips strips of kSR rows; each thread keeps one strip's kSR outputs of
//   one column in registers, so each loaded value feeds kSR FMAs.
// - Axis 1 is local (each CTA owns whole rows): the pass's axis-0 result
//   sits column-major in shared memory with a zero halo, and each thread
//   keeps kCB consecutive outputs of one row in registers.
// - The taps are found and laid out once per launch, zero-padded so that
//   the register-blocked loops run fixed trip counts with no bounds checks.
// - cluster.sync() after each half: the first half reads u and writes rel,
//   the second reads rel and multiplies u in place.
// f32 FMA on the CUDA cores, IEEE division (no --use_fast_math), no atomics
// on data: reruns are bit-identical. The sums run in another order than
// csrc/rlsep.cu's, so the two agree within rounding, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>


namespace cg = cooperative_groups;

namespace {

// The block's shape; scripts/torch_rlsep_cluster_sweep.py builds others
// with -DRL_STRIPS=... -DRL_SR=... to compare them.
#ifndef RL_STRIPS
#define RL_STRIPS 2
#endif
#ifndef RL_SR
#define RL_SR 8
#endif
constexpr int kStrips = RL_STRIPS;    // strips a pass: 256 threads each
constexpr int kThreads = 256 * kStrips;
constexpr int kSR = RL_SR;            // rows per strip: the axis-0 register block
constexpr int kPass = kSR * kStrips;  // rows per pass
constexpr int kCB = 8;              // consecutive columns per thread in the axis-1 pass
constexpr int kTile = 256;          // columns per tile: one a thread on axis 0, 8 warps x 32 on axis 1
constexpr int kMaxCluster = 16;
constexpr size_t kStaticBytes = 2 * sizeof(int);  // rl_cluster's reach[2]

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one CTA: two tables of nwin row pointers (u, rel: each
// row of the CTA's halo window in its owner's slab), then floats: four tap
// arrays (rows and columns, each plain and mirrored), the u and rel slabs
// (rows x ws, ws = 1 mod 32 so the epilogue's 8 rows x 4 column groups hit
// 32 banks), the strip (tcols columns of kPass + 1 floats, column-major)
// and one zero row; the static reach[2] last.
struct Layout {
  int rows, ws, hr, hc, nwin, tlr, tlc, tcols;
  size_t slab_u, slab_rel, strip, zero, bytes;  // float offsets; total bytes
};

__host__ __device__ inline Layout layout(int h2, int w2, int kr, int kc, int s) {
  Layout l;
  l.rows = (h2 + s - 1) / s;
  l.ws = w2 + ((1 - w2) % 32 + 32) % 32;
  l.hr = kr / 2;
  l.hc = kc / 2;
  l.nwin = l.rows + 2 * l.hr + 3 * kSR;
  l.tlr = round_up(2 * l.hr + 3 * kSR, 4);
  l.tlc = round_up(2 * l.hc + 3 * kCB, 4);
  l.tcols = 2 * l.hc + w2 + 2 * kCB;
  l.slab_u = 2 * (size_t)l.tlr + 2 * (size_t)l.tlc;
  l.slab_rel = l.slab_u + (size_t)l.rows * l.ws;
  l.strip = l.slab_rel + (size_t)l.rows * l.ws;
  l.zero = l.strip + (size_t)l.tcols * (kPass + 1);
  l.bytes = 2 * (size_t)l.nwin * sizeof(float*) + sizeof(float) * (l.zero + l.ws) +
            kStaticBytes;
  return l;
}

// rows of CTA q of s: [lo, lo + n), the first h2 % s CTAs one row more
__device__ __forceinline__ void slab(int h2, int s, int q, int& lo, int& n) {
  const int base = h2 / s, rem = h2 % s;
  lo = q * base + min(q, rem);
  n = base + (q < rem ? 1 : 0);
}

__device__ __forceinline__ int owner(int h2, int s, int j) {
  const int base = h2 / s, rem = h2 % s, cut = rem * (base + 1);
  return j < cut ? j / (base + 1) : rem + (j - cut) / base;
}

struct Args {
  float* u;
  const float* padded;
  const float* px;
  const float* py;
  const int* order;   // band slots by descending n_iter
  const int* n_iter;  // by band
  int it0, it1, h2, w2, kr, kc, s;
};

// acc[i] += sum_m t[m - i] v(m) for m in [0, m_end), with tq[k] = t[k - K]
// zero-padded: the register window w holds tq[m0 + 1 .. m0 + 2K - 1].
// LOAD(m) returns v(m). m_end is a multiple of K.
template <int K, typename Load>
__device__ __forceinline__ void blocked_correlation(const float* tq, int m_end, float (&acc)[K],
                                                    Load load) {
  static_assert(K % 4 == 0, "the taps are loaded as float4");
  float w[2 * K];
#pragma unroll
  for (int k = 0; k < K - 1; ++k) w[k] = tq[1 + k];
  float v[K];
#pragma unroll
  for (int a = 0; a < K; ++a) v[a] = load(a);
  for (int m0 = 0; m0 < m_end; m0 += K) {
#pragma unroll
    for (int j = 0; j < K / 4; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(tq + m0 + K + 4 * j);
      w[K - 1 + 4 * j] = t.x;
      w[K + 4 * j] = t.y;
      w[K + 1 + 4 * j] = t.z;
      w[K + 2 + 4 * j] = t.w;
    }
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int i = 0; i < K; ++i) acc[i] = fmaf(w[a - i + K - 1], v[a], acc[i]);
#pragma unroll
    for (int k = 0; k < K - 1; ++k) w[k] = w[k + K];
    if (m0 + K < m_end) {
#pragma unroll
      for (int a = 0; a < K; ++a) v[a] = load(m0 + K + a);
    }
  }
}

// One half-iteration on the CTA's slab. SECOND == false: dst = rel =
// P / (R src C^T + 1e-12) with src = u; SECOND == true: dst = u *= R^T src C
// with src = rel (the taps tqr, tqc are then the mirrored ones). rows[w]
// points at src's canvas row lo - L.hr + w wherever it lives; pb at P's
// row lo.
template <bool SECOND>
__device__ __forceinline__ void half(const float* const* rows, float* dst, const float* pb,
                                     const float* tqr, const float* tqc, float* strip, int n,
                                     int hr, int hc, const Layout& L, int w2) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r = lane & 7, g = lane >> 3;
  const int mr = round_up(2 * hr + kSR, kSR);
  const int mc = round_up(2 * hc + kCB, kCB);
  // axis 0: thread tid takes strip tid / 256 of the pass, one column
  const int sub = tid / kTile, col = tid % kTile;
  for (int p0 = 0; p0 < n; p0 += kPass) {
    // window row m of this thread's strip is canvas row lo + s0 - hr + m
    const int s0 = p0 + sub * kSR;
    if (s0 < n) {
      const float* const* win = rows + s0 + (L.hr - hr);
      for (int cb = 0; cb < w2; cb += kTile) {
        const int c = cb + col;
        if (c < w2) {
          float acc[kSR] = {};
          blocked_correlation<kSR>(tqr, mr, acc, [&](int m) { return win[m][c]; });
          float* out = strip + (size_t)(L.hc + c) * (kPass + 1) + sub * kSR;
#pragma unroll
          for (int i = 0; i < kSR; ++i) out[i] = acc[i];
        }
      }
    }
    __syncthreads();
    // axis 1 and the pointwise epilogue: a warp takes 8 rows x 32 columns,
    // a thread row 8 rg + r of the pass and columns c0 .. c0 + 7
    for (int unit = warp; unit < kPass / 8 * (kTile / 32); unit += kThreads / 32) {
      const int rg = unit / (kTile / 32), cw = unit % (kTile / 32);
      const int row = p0 + rg * 8 + r;
      if (p0 + rg * 8 >= n) continue;
      for (int cb = 0; cb < w2; cb += kTile) {
        const int c0 = cb + cw * 32 + g * kCB;
        if (c0 >= w2) continue;
        const float* sp = strip + (size_t)(L.hc - hc + c0) * (kPass + 1) + rg * 8 + r;
        float acc[kCB] = {};
        blocked_correlation<kCB>(tqc, mc, acc, [&](int m) { return sp[m * (kPass + 1)]; });
        if (row < n) {
          float* d = dst + (size_t)row * L.ws + c0;
          const float* p = pb + (size_t)row * w2 + c0;
#pragma unroll
          for (int i = 0; i < kCB; ++i) {
            if (c0 + i < w2) {
              if (SECOND)
                d[i] = d[i] * acc[i];
              else
                d[i] = p[i] / (acc[i] + 1e-12f);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) rl_cluster(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int reach[2];
  const Layout L = layout(a.h2, a.w2, a.kr, a.kc, a.s);
  const float** rows_u = reinterpret_cast<const float**>(smem_raw);
  const float** rows_rel = rows_u + L.nwin;
  float* fs = reinterpret_cast<float*>(rows_rel + L.nwin);
  float* tr_a = fs;
  float* tr_b = tr_a + L.tlr;
  float* tc_a = tr_b + L.tlr;
  float* tc_b = tc_a + L.tlc;
  float* su = fs + L.slab_u;
  float* srel = fs + L.slab_rel;
  float* strip = fs + L.strip;
  float* zero = fs + L.zero;

  const int tid = threadIdx.x;
  const int q = (int)cluster.block_rank();
  const int band = a.order[blockIdx.y];
  const int n_it = min(a.it1, a.n_iter[band]) - a.it0;
  const int h2 = a.h2, w2 = a.w2, kr = a.kr, kc = a.kc;
  int lo, n;
  slab(h2, a.s, q, lo, n);
  const float* pxb = a.px + (size_t)band * kr;
  const float* pyb = a.py + (size_t)band * kc;
  const size_t plane = (size_t)h2 * w2;
  float* ub = a.u + (size_t)band * plane + (size_t)lo * w2;
  const float* pb = a.padded + (size_t)band * plane + (size_t)lo * w2;

  // the band's reach: the largest |offset| of a non-zero tap
  if (tid < 2) reach[tid] = 0;
  __syncthreads();
  for (int i = tid; i < kr; i += kThreads)
    if (pxb[i] != 0.0f) atomicMax(&reach[0], abs(i - kr / 2));
  for (int i = tid; i < kc; i += kThreads)
    if (pyb[i] != 0.0f) atomicMax(&reach[1], abs(i - kc / 2));
  __syncthreads();
  const int hr = reach[0], hc = reach[1];

  // taps, zero-padded: tq[k] holds the tap at offset d = k - K - h (the
  // mirrored array the tap at -d), zero outside the profile
  for (int k = tid; k < L.tlr; k += kThreads) {
    const int d = k - kSR - hr;
    const bool in = d >= -hr && d <= hr;
    const int ia = kr / 2 + d, ib = kr / 2 - d;
    tr_a[k] = in && ia >= 0 && ia < kr ? pxb[ia] : 0.0f;
    tr_b[k] = in && ib >= 0 && ib < kr ? pxb[ib] : 0.0f;
  }
  for (int k = tid; k < L.tlc; k += kThreads) {
    const int d = k - kCB - hc;
    const bool in = d >= -hc && d <= hc;
    const int ia = kc / 2 + d, ib = kc / 2 - d;
    tc_a[k] = in && ia >= 0 && ia < kc ? pyb[ia] : 0.0f;
    tc_b[k] = in && ib >= 0 && ib < kc ? pyb[ib] : 0.0f;
  }
  // the halo window's row tables: canvas row lo - L.hr + w lives in its
  // owner's slab; rows outside the canvas read the zero row
  for (int w = tid; w < L.nwin; w += kThreads) {
    const int j = lo - L.hr + w;
    if (j < 0 || j >= h2) {
      rows_u[w] = zero;
      rows_rel[w] = zero;
    } else {
      const int o = owner(h2, a.s, j);
      int olo, on;
      slab(h2, a.s, o, olo, on);
      const size_t off = (size_t)(j - olo) * L.ws;
      rows_u[w] = cluster.map_shared_rank(su, o) + off;
      rows_rel[w] = cluster.map_shared_rank(srel, o) + off;
    }
  }
  for (int i = tid; i < L.ws; i += kThreads) zero[i] = 0.0f;
  for (int i = tid; i < L.tcols * (kPass + 1); i += kThreads) strip[i] = 0.0f;
  for (int l = 0; l < n; ++l)
    for (int c = tid; c < w2; c += kThreads) su[(size_t)l * L.ws + c] = ub[(size_t)l * w2 + c];
  // every slab loaded, and every CTA of the cluster running, before any
  // remote read
  cluster.sync();

  for (int it = 0; it < n_it; ++it) {
    half<false>(rows_u, srel, pb, tr_a, tc_a, strip, n, hr, hc, L, w2);
    cluster.sync();
    half<true>(rows_rel, su, pb, tr_b, tc_b, strip, n, hr, hc, L, w2);
    // also keeps this CTA's slabs alive until the others have read them
    cluster.sync();
  }
  for (int l = 0; l < n; ++l)
    for (int c = tid; c < w2; c += kThreads) ub[(size_t)l * w2 + c] = su[(size_t)l * L.ws + c];
}

}  // namespace

// Shared-memory bytes of one CTA at cluster size s, static and dynamic
// (the wrapper's routing rule computes the same in Python).
extern "C" long long thz_rlsep_cluster_smem(int h2, int w2, int kr, int kc, int s) {
  if (h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || s < 1) return -1;
  return (long long)layout(h2, w2, kr, kc, s).bytes;
}

// u: (b, h2, w2) f32, the running estimate, updated in place (the caller
// starts it as a copy of padded); padded: (b, h2, w2) f32; px: (b, kr) f32;
// py: (b, kc) f32; order: (b,) int32 on the device, the bands by descending
// n_iter; n_iter: (b,) int32 on the device, by band; nb: the bands with
// n_iter > it0 (the first nb of the order). Runs iterations it0 .. it1-1 of
// those bands in one launch of nb clusters of s CTAs, on `stream`; does not
// synchronize. Returns 0, or the CUDA error of the refused launch
// (cudaErrorInvalidValue for arguments it does not take: s outside 1..16
// or above h2, or more shared memory than a block may use).
extern "C" int thz_rlsep_cluster(void* u, const void* padded, const void* px, const void* py,
                                 const void* order, const void* n_iter, int nb, int it0, int it1,
                                 int b, int h2, int w2, int kr, int kc, int s, void* stream) {
  if (b < 1 || nb < 1 || nb > b || nb > 65535 || h2 < 1 || w2 < 1 || kr < 1 || kc < 1 ||
      it0 < 0 || it1 <= it0 || s < 1 || s > kMaxCluster || s > h2)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = layout(h2, w2, kr, kc, s).bytes;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int dynamic = (int)(bytes - kStaticBytes);
  err = cudaFuncSetAttribute(rl_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rl_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return (int)err;

  Args a;
  a.u = static_cast<float*>(u);
  a.padded = static_cast<const float*>(padded);
  a.px = static_cast<const float*>(px);
  a.py = static_cast<const float*>(py);
  a.order = static_cast<const int*>(order);
  a.n_iter = static_cast<const int*>(n_iter);
  a.it0 = it0;
  a.it1 = it1;
  a.h2 = h2;
  a.w2 = w2;
  a.kr = kr;
  a.kc = kc;
  a.s = s;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s, nb, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rl_cluster, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

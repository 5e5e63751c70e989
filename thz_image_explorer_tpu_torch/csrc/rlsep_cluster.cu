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
//
// The wide route (rl_cluster_wide) takes the late checkpoint launches, where
// few bands still iterate: at the 512x512 Apply the clusters of the last
// four bands or fewer hold at most 64 of an H100's 132 SMs (16 for band 0's
// last 58 iterations), while each CTA of band 0's cluster makes three passes
// a half over its 35-row slab. One cooperative launch (every block
// resident) runs each band on more blocks than a cluster holds, in
// proportion to its iterations left (ops/rlsep.launch_plan): one pass a
// half at 512x512. u and rel live in device memory, which L2 holds: each
// half stages the block's slab and halo with one bulk copy, runs half<>
// into device memory and passes a band-wide barrier, a counter in device
// memory (release on arrival, acquire while waiting). That staging and
// those barriers cost about a quarter of a wide iteration at 512x512, paid
// for by the passes the route saves; a canvas whose cluster CTAs make one
// pass a half keeps the cluster route. Each output meets the same taps and
// values in the same order as on the cluster route: the two agree bit for
// bit.
//
// The grouped mode replaces :_sep_kernel_group (launched by
// rl_bands_separable_grouped), which interleaves the serial chains of G
// bands in one TPU program to hide each chain's latency. Here it is the G
// instantiation of the same kernel: one cluster holds G consecutive slots
// of the descending-n_iter order (their slabs, row tables, taps and
// reaches; one strip), each half-iteration runs the G bands' halves back to
// back, skipping a band past its own n_iter (the work, never the barrier),
// and one cluster.sync() follows for all G. So the G bands share the
// barriers, and one band's distributed-shared-memory reads can overlap
// another's FMAs. Each band's arithmetic is half<>'s, so the output equals
// the G = 1 kernel's bit for bit; G = 1 is the cluster route's own kernel.

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
constexpr int kMaxGroup = 8;                               // bands a cluster holds
constexpr size_t kStaticBytesPerBand = 2 * sizeof(int);    // rl_cluster's reach[2 G]

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one CTA holding g bands: per band two tables of nwin row
// pointers (u, rel: each row of the CTA's halo window in its owner's slab),
// then floats: per band four tap arrays (rows and columns, each plain and
// mirrored), per band the u and rel slabs (rows x ws, ws = 1 mod 32 so the
// epilogue's 8 rows x 4 column groups hit 32 banks), the strip (tcols
// columns of kPass + 1 floats, column-major) and one zero row; the static
// reach[2 g] last. Band i's tables, taps and slabs sit i strides after band
// 0's; at g = 1 this is the cluster route's layout.
struct Layout {
  int rows, ws, hr, hc, nwin, tlr, tlc, tcols;
  size_t taps, slab_u, slab_rel, slabs, strip, zero, bytes;  // float offsets; total bytes
};

__host__ __device__ inline Layout layout(int h2, int w2, int kr, int kc, int s, int g) {
  Layout l;
  l.rows = (h2 + s - 1) / s;
  l.ws = w2 + ((1 - w2) % 32 + 32) % 32;
  l.hr = kr / 2;
  l.hc = kc / 2;
  l.nwin = l.rows + 2 * l.hr + 3 * kSR;
  l.tlr = round_up(2 * l.hr + 3 * kSR, 4);
  l.tlc = round_up(2 * l.hc + 3 * kCB, 4);
  l.tcols = 2 * l.hc + w2 + 2 * kCB;
  l.taps = 2 * (size_t)l.tlr + 2 * (size_t)l.tlc;  // a band's stride of taps
  l.slabs = 2 * (size_t)l.rows * l.ws;               // a band's stride of slabs
  l.slab_u = g * l.taps;
  l.slab_rel = l.slab_u + (size_t)l.rows * l.ws;
  l.strip = l.slab_u + g * l.slabs;
  l.zero = l.strip + (size_t)l.tcols * (kPass + 1);
  l.bytes = 2 * (size_t)g * l.nwin * sizeof(float*) + sizeof(float) * (l.zero + l.ws) +
            g * kStaticBytesPerBand;
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
  int nb, it0, it1, h2, w2, kr, kc, s;
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
// row lo. PREFETCH loads the epilogue's operand (P, or u) before the axis-1
// correlation instead of after it: the wide route, whose dst lies in
// device memory. The arithmetic is the same either way. The cluster route,
// whose dst lies in shared memory, keeps the load after: prefetched there
// it ran 8 % slower at 200x200 and 0.7 % at 512x512 (H100).
template <bool SECOND, bool PREFETCH = false>
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
        float* d = dst + (size_t)row * L.ws + c0;
        const float* p = pb + (size_t)row * w2 + c0;
        float pre[kCB];
        if (PREFETCH) {
#pragma unroll
          for (int i = 0; i < kCB; ++i)
            pre[i] = row < n && c0 + i < w2 ? (SECOND ? d[i] : p[i]) : 0.0f;
        }
        float acc[kCB] = {};
        blocked_correlation<kCB>(tqc, mc, acc, [&](int m) { return sp[m * (kPass + 1)]; });
        if (row < n) {
#pragma unroll
          for (int i = 0; i < kCB; ++i) {
            if (c0 + i < w2) {
              if (SECOND)
                d[i] = (PREFETCH ? pre[i] : d[i]) * acc[i];
              else
                d[i] = (PREFETCH ? pre[i] : p[i]) / (acc[i] + 1e-12f);
            }
          }
        }
      }
    }
    __syncthreads();
  }
}

// Cluster y holds the slots G y .. G y + G - 1 of the descending order,
// those below nb (the bands with n_iter > it0).
template <int G>
__global__ void __launch_bounds__(kThreads) rl_cluster(Args a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int reach[2 * G];
  const Layout L = layout(a.h2, a.w2, a.kr, a.kc, a.s, G);
  const float** rows_u = reinterpret_cast<const float**>(smem_raw);
  const float** rows_rel = rows_u + G * L.nwin;
  float* fs = reinterpret_cast<float*>(rows_rel + G * L.nwin);
  float* strip = fs + L.strip;
  float* zero = fs + L.zero;

  const int tid = threadIdx.x;
  const int q = (int)cluster.block_rank();
  const int h2 = a.h2, w2 = a.w2, kr = a.kr, kc = a.kc;
  int lo, n;
  slab(h2, a.s, q, lo, n);
  const size_t plane = (size_t)h2 * w2;
  // the group's bands and their iterations in this launch (0 for a slot
  // past nb); the first slot has the most
  int band[G], n_it[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int slot = blockIdx.y * G + g;
    band[g] = slot < a.nb ? a.order[slot] : -1;
    n_it[g] = band[g] < 0 ? 0 : min(a.it1, a.n_iter[band[g]]) - a.it0;
  }

  // each band's reach: the largest |offset| of a non-zero tap
  if (tid < 2 * G) reach[tid] = 0;
  __syncthreads();
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    if (band[g] < 0) continue;
    const float* pxb = a.px + (size_t)band[g] * kr;
    const float* pyb = a.py + (size_t)band[g] * kc;
    for (int i = tid; i < kr; i += kThreads)
      if (pxb[i] != 0.0f) atomicMax(&reach[2 * g], abs(i - kr / 2));
    for (int i = tid; i < kc; i += kThreads)
      if (pyb[i] != 0.0f) atomicMax(&reach[2 * g + 1], abs(i - kc / 2));
  }
  __syncthreads();

#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    if (band[g] < 0) continue;
    const int hr = reach[2 * g], hc = reach[2 * g + 1];
    const float* pxb = a.px + (size_t)band[g] * kr;
    const float* pyb = a.py + (size_t)band[g] * kc;
    float* tr_a = fs + g * L.taps;
    float* tr_b = tr_a + L.tlr;
    float* tc_a = tr_b + L.tlr;
    float* tc_b = tc_a + L.tlc;
    float* su = fs + L.slab_u + g * L.slabs;
    float* srel = fs + L.slab_rel + g * L.slabs;
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
    const float** ru = rows_u + g * L.nwin;
    const float** rr = rows_rel + g * L.nwin;
    for (int w = tid; w < L.nwin; w += kThreads) {
      const int j = lo - L.hr + w;
      if (j < 0 || j >= h2) {
        ru[w] = zero;
        rr[w] = zero;
      } else {
        const int o = owner(h2, a.s, j);
        int olo, on;
        slab(h2, a.s, o, olo, on);
        const size_t off = (size_t)(j - olo) * L.ws;
        ru[w] = cluster.map_shared_rank(su, o) + off;
        rr[w] = cluster.map_shared_rank(srel, o) + off;
      }
    }
    const float* ub = a.u + (size_t)band[g] * plane + (size_t)lo * w2;
    for (int l = 0; l < n; ++l)
      for (int c = tid; c < w2; c += kThreads) su[(size_t)l * L.ws + c] = ub[(size_t)l * w2 + c];
  }
  for (int i = tid; i < L.ws; i += kThreads) zero[i] = 0.0f;
  for (int i = tid; i < L.tcols * (kPass + 1); i += kThreads) strip[i] = 0.0f;
  // every slab loaded, and every CTA of the cluster running, before any
  // remote read
  cluster.sync();

  // the G bands' halves back to back, one barrier after each half for all
  // of them; a band past its own n_iter skips its work, not the barrier
  for (int it = 0; it < n_it[0]; ++it) {
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      if (it < n_it[g]) {
        const float* pb = a.padded + (size_t)band[g] * plane + (size_t)lo * w2;
        const float* tr = fs + g * L.taps;
        half<false>(rows_u + g * L.nwin, fs + L.slab_rel + g * L.slabs, pb, tr,
                    tr + 2 * L.tlr, strip, n, reach[2 * g], reach[2 * g + 1], L, w2);
      }
    }
    cluster.sync();
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      if (it < n_it[g]) {
        const float* pb = a.padded + (size_t)band[g] * plane + (size_t)lo * w2;
        const float* tr = fs + g * L.taps;
        half<true>(rows_rel + g * L.nwin, fs + L.slab_u + g * L.slabs, pb, tr + L.tlr,
                   tr + 2 * L.tlr + L.tlc, strip, n, reach[2 * g], reach[2 * g + 1], L, w2);
      }
    }
    // also keeps this CTA's slabs alive until the others have read them
    cluster.sync();
  }
#pragma unroll 1
  for (int g = 0; g < G; ++g) {
    if (band[g] < 0) continue;
    const float* su = fs + L.slab_u + g * L.slabs;
    float* ub = a.u + (size_t)band[g] * plane + (size_t)lo * w2;
    for (int l = 0; l < n; ++l)
      for (int c = tid; c < w2; c += kThreads) ub[(size_t)l * w2 + c] = su[(size_t)l * L.ws + c];
  }
}

constexpr int kMaxWide = 8;                              // bands a wide launch holds
constexpr size_t kWideStaticBytes = 2 * sizeof(int) + 8;  // reach[2], the staging mbarrier

// The wide route's shared memory: two tables of nwin row pointers (the
// halo window's rows of u and of rel: staged copies, or the zero row), the
// taps as the cluster route lays them out, the staged rows (the slab and
// its halo of L.hr rows a side, stride w2, 4 floats of slack so a copy can
// keep its source's 16-byte phase), the strip and one zero row; the static
// reach[2] and the staging mbarrier last. L is what half<> reads: the halo
// window's geometry, and ws = w2, the stride of the device-memory rows it
// writes.
struct WideLayout {
  Layout L;
  int table;                    // pointers a table (nwin rounded up to even)
  size_t stage, strip, zero, bytes;  // float offsets; total bytes
};

__host__ __device__ inline WideLayout wide_layout(int h2, int w2, int kr, int kc, int rows) {
  WideLayout l;
  Layout& L = l.L;
  L.rows = rows;
  L.ws = w2;
  L.hr = kr / 2;
  L.hc = kc / 2;
  L.nwin = rows + 2 * L.hr + 3 * kSR;
  L.tlr = round_up(2 * L.hr + 3 * kSR, 4);
  L.tlc = round_up(2 * L.hc + 3 * kCB, 4);
  L.tcols = 2 * L.hc + w2 + 2 * kCB;
  L.taps = 2 * (size_t)L.tlr + 2 * (size_t)L.tlc;
  l.table = round_up(L.nwin, 2);
  l.stage = L.taps;
  l.strip = l.stage + (size_t)(rows + 2 * L.hr) * w2 + 4;
  l.zero = l.strip + (size_t)L.tcols * (kPass + 1);
  l.bytes = 2 * (size_t)l.table * sizeof(float*) + sizeof(float) * (l.zero + w2) +
            kWideStaticBytes;
  return l;
}

struct WideArgs {
  float* u;
  float* rel;  // (nb, h2, w2) scratch, by slot
  const float* padded;
  const float* px;
  const float* py;
  const int* order;
  const int* n_iter;
  unsigned* arrivals;  // by slot: the band barrier's counter
  int nb, it0, it1, h2, w2, kr, kc, rows;
  int first[kMaxWide + 1];  // slot j owns blocks first[j] .. first[j + 1] - 1
  unsigned base[kMaxWide];  // arrivals[j] before this launch
};

// Copy floats src[0 .. count) to dst[0 .. count), where dst and src lie at
// the same offset from a 16-byte boundary: the 16-byte-aligned body in one
// bulk copy (the copy engine, through L2: another block wrote those rows),
// completing on the mbarrier `bar` at parity `phase`, which it flips; the
// ragged ends by L2 loads. Every thread returns with the rows in place for
// itself; the caller's __syncthreads() makes the ends visible to all.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int count, unsigned bar,
                                           unsigned& phase) {
  const int head = min((int)((16 - ((size_t)src & 15)) & 15) / 4, count);
  const int body = (count - head) / 4;
  const int tid = threadIdx.x;
  if (tid == 0) {
    // the rows came from generic stores, and the last generic reads of dst
    // precede this copy: order both against the async proxy
    asm volatile("fence.proxy.async;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                 "r"(body * 16)
                 : "memory");
    if (body > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"((unsigned)__cvta_generic_to_shared(dst + head)),
          "l"(src + head), "r"(body * 16), "r"(bar)
          : "memory");
  }
  if (tid < head) dst[tid] = __ldcg(src + tid);
  const int tail = head + 4 * body;
  if (tid < count - tail) dst[tail + tid] = __ldcg(src + tail + tid);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(phase)
      : "memory");
  phase ^= 1;
}

// Every block of the band has arrived: a counter in device memory that only
// grows, so a launch starts from the count the host passes and nothing
// resets it. The block's writes precede thread 0's release (the first
// __syncthreads), its reads follow thread 0's acquire (the second).
__device__ __forceinline__ void band_barrier(unsigned* count, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(count) : "memory");
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
    } while ((int)(seen - target) < 0);
  }
  __syncthreads();
}

// The wide route: one cooperative launch in which slot j's band runs on
// first[j + 1] - first[j] blocks, each owning a row slab. u and rel live in
// device memory (L2); each half stages the slab's window, runs half<> into
// device memory and passes the band's barrier. Per output the same taps
// meet the same values in the same order as in rl_cluster, so the two
// routes agree bit for bit.
__global__ void __launch_bounds__(kThreads, 1) rl_cluster_wide(WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int reach[2];
  __shared__ __align__(8) unsigned long long stage_bar;
  const unsigned bar = (unsigned)__cvta_generic_to_shared(&stage_bar);
  unsigned phase = 0;
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  const int h2 = a.h2, w2 = a.w2, kr = a.kr, kc = a.kc;
  const WideLayout W = wide_layout(h2, w2, kr, kc, a.rows);
  const Layout& L = W.L;
  const float** rows_u = reinterpret_cast<const float**>(smem_raw);
  const float** rows_rel = rows_u + W.table;
  float* fs = reinterpret_cast<float*>(rows_rel + W.table);
  float* strip = fs + W.strip;
  float* zero = fs + W.zero;
  const int tid = threadIdx.x;

  int slot = 0;
  while (slot + 1 < a.nb && (int)blockIdx.x >= a.first[slot + 1]) ++slot;
  const int s = a.first[slot + 1] - a.first[slot], q = (int)blockIdx.x - a.first[slot];
  int lo, n;
  slab(h2, s, q, lo, n);
  const int band = a.order[slot];
  const int n_it = min(a.it1, a.n_iter[band]) - a.it0;
  const size_t plane = (size_t)h2 * w2;
  float* ub = a.u + (size_t)band * plane;
  float* rb = a.rel + (size_t)slot * plane;
  const float* pxb = a.px + (size_t)band * kr;
  const float* pyb = a.py + (size_t)band * kc;

  if (tid < 2) reach[tid] = 0;
  __syncthreads();
  for (int i = tid; i < kr; i += kThreads)
    if (pxb[i] != 0.0f) atomicMax(&reach[0], abs(i - kr / 2));
  for (int i = tid; i < kc; i += kThreads)
    if (pyb[i] != 0.0f) atomicMax(&reach[1], abs(i - kc / 2));
  __syncthreads();
  const int hr = reach[0], hc = reach[1];
  float* tr_a = fs;
  float* tr_b = tr_a + L.tlr;
  float* tc_a = tr_b + L.tlr;
  float* tc_b = tc_a + L.tlc;
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
  // the staged canvas rows j0 .. j1 - 1: every row a stored output meets
  // with a non-zero tap. The window's other rows read the zero row; there
  // the taps are zero, as they are for the real rows rl_cluster reads.
  const int j0 = max(lo - hr, 0), j1 = min(lo + n + hr, h2);
  const int count = (j1 - j0) * w2;
  const float* src_u = ub + (size_t)j0 * w2;
  const float* src_rel = rb + (size_t)j0 * w2;
  float* stage_u = fs + W.stage + (((size_t)src_u >> 2) & 3);
  float* stage_rel = fs + W.stage + (((size_t)src_rel >> 2) & 3);
  for (int w = tid; w < L.nwin; w += kThreads) {
    const int j = lo - L.hr + w;
    const bool in = j >= j0 && j < j1;
    rows_u[w] = in ? stage_u + (size_t)(j - j0) * w2 : zero;
    rows_rel[w] = in ? stage_rel + (size_t)(j - j0) * w2 : zero;
  }
  for (int i = tid; i < w2; i += kThreads) zero[i] = 0.0f;
  for (int i = tid; i < L.tcols * (kPass + 1); i += kThreads) strip[i] = 0.0f;

  const float* pb = a.padded + (size_t)band * plane + (size_t)lo * w2;
  unsigned* arrivals = a.arrivals + slot;
  unsigned target = a.base[slot];
  for (int it = 0; it < n_it; ++it) {
    stage_rows(stage_u, src_u, count, bar, phase);
    __syncthreads();
    half<false, true>(rows_u, rb + (size_t)lo * w2, pb, tr_a, tc_a, strip, n, hr, hc, L, w2);
    target += s;
    band_barrier(arrivals, target);
    stage_rows(stage_rel, src_rel, count, bar, phase);
    __syncthreads();
    half<true, true>(rows_rel, ub + (size_t)lo * w2, pb, tr_b, tc_b, strip, n, hr, hc, L, w2);
    target += s;
    band_barrier(arrivals, target);
  }
}

template <int G>
cudaError_t launch(const Args& a, int dynamic, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(rl_cluster<G>, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rl_cluster<G>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.s, (a.nb + G - 1) / G, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rl_cluster<G>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int launch_group(void* u, const void* padded, const void* px, const void* py, const void* order,
                 const void* n_iter, int nb, int it0, int it1, int b, int h2, int w2, int kr,
                 int kc, int s, int g, void* stream) {
  if (b < 1 || nb < 1 || nb > b || h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || it0 < 0 ||
      it1 <= it0 || s < 1 || s > kMaxCluster || s > h2 || g < 1 || g > kMaxGroup ||
      (nb + g - 1) / g > 65535)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = layout(h2, w2, kr, kc, s, g).bytes;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int dynamic = (int)(bytes - g * kStaticBytesPerBand);

  Args a;
  a.u = static_cast<float*>(u);
  a.padded = static_cast<const float*>(padded);
  a.px = static_cast<const float*>(px);
  a.py = static_cast<const float*>(py);
  a.order = static_cast<const int*>(order);
  a.n_iter = static_cast<const int*>(n_iter);
  a.nb = nb;
  a.it0 = it0;
  a.it1 = it1;
  a.h2 = h2;
  a.w2 = w2;
  a.kr = kr;
  a.kc = kc;
  a.s = s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (g) {
    case 1: err = launch<1>(a, dynamic, st); break;
    case 2: err = launch<2>(a, dynamic, st); break;
    case 3: err = launch<3>(a, dynamic, st); break;
    case 4: err = launch<4>(a, dynamic, st); break;
    case 5: err = launch<5>(a, dynamic, st); break;
    case 6: err = launch<6>(a, dynamic, st); break;
    case 7: err = launch<7>(a, dynamic, st); break;
    default: err = launch<8>(a, dynamic, st); break;
  }
  return (int)err;
}

int launch_wide(WideArgs& a, int b, const int* first, const unsigned* base, cudaStream_t stream) {
  if (b < 1 || a.nb < 1 || a.nb > b || a.nb > kMaxWide || a.h2 < 1 || a.w2 < 1 || a.kr < 1 ||
      a.kc < 1 || a.it0 < 0 || a.it1 <= a.it0 || first[0] != 0)
    return (int)cudaErrorInvalidValue;
  a.rows = 0;
  for (int j = 0; j < a.nb; ++j) {
    const int s = first[j + 1] - first[j];
    if (s < 1 || s > a.h2) return (int)cudaErrorInvalidValue;
    a.rows = max(a.rows, (a.h2 + s - 1) / s);
    a.first[j] = first[j];
    a.base[j] = base[j];
  }
  a.first[a.nb] = first[a.nb];
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes = wide_layout(a.h2, a.w2, a.kr, a.kc, a.rows).bytes;
  if (bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  const int dynamic = (int)(bytes - kWideStaticBytes);
  err = cudaFuncSetAttribute(rl_cluster_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dynamic);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(first[a.nb], 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = dynamic;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, rl_cluster_wide, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one CTA at cluster size s, static and dynamic
// (the wrapper's routing rule computes the same in Python); with g bands a
// cluster, the grouped mode's.
extern "C" long long thz_rlsep_cluster_smem(int h2, int w2, int kr, int kc, int s) {
  if (h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || s < 1) return -1;
  return (long long)layout(h2, w2, kr, kc, s, 1).bytes;
}

extern "C" long long thz_rlsep_grouped_smem(int h2, int w2, int kr, int kc, int s, int g) {
  if (h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || s < 1 || g < 1) return -1;
  return (long long)layout(h2, w2, kr, kc, s, g).bytes;
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
  return launch_group(u, padded, px, py, order, n_iter, nb, it0, it1, b, h2, w2, kr, kc, s, 1,
                      stream);
}

// Shared-memory bytes of one block of the wide route whose largest slab
// holds `rows` rows (ops/rlsep.wide_smem_bytes computes the same).
extern "C" long long thz_rlsep_wide_smem(int h2, int w2, int kr, int kc, int rows) {
  if (h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || rows < 1) return -1;
  return (long long)wide_layout(h2, w2, kr, kc, rows).bytes;
}

// The wide route: iterations it0 .. it1-1 of the first nb (1..8) slots of
// the order in one cooperative launch, slot j on blocks first[j] ..
// first[j + 1] - 1 (host int array of nb + 1 entries, first[0] = 0, each
// band's share 1..h2 blocks, every block resident on the card or the
// launch is refused). rel: (nb, h2, w2) f32 scratch; arrivals: (8,) u32 on
// the device, the band barriers' counters, which only grow: base (host u32
// array of nb) holds slot j's count before this launch, and the launch
// adds 2 (first[j + 1] - first[j]) (min(it1, n_iter) - it0) to it. The
// other arguments and the result are thz_rlsep_cluster's; u ends equal to
// the cluster route's bit for bit.
extern "C" int thz_rlsep_wide(void* u, void* rel, const void* padded, const void* px,
                              const void* py, const void* order, const void* n_iter,
                              void* arrivals, int nb, int it0, int it1, int b, int h2, int w2,
                              int kr, int kc, const int* first, const unsigned* base,
                              void* stream) {
  WideArgs a;
  a.u = static_cast<float*>(u);
  a.rel = static_cast<float*>(rel);
  a.padded = static_cast<const float*>(padded);
  a.px = static_cast<const float*>(px);
  a.py = static_cast<const float*>(py);
  a.order = static_cast<const int*>(order);
  a.n_iter = static_cast<const int*>(n_iter);
  a.arrivals = static_cast<unsigned*>(arrivals);
  a.nb = nb;
  a.it0 = it0;
  a.it1 = it1;
  a.h2 = h2;
  a.w2 = w2;
  a.kr = kr;
  a.kc = kc;
  return launch_wide(a, b, first, base, static_cast<cudaStream_t>(stream));
}

// The grouped mode: as thz_rlsep_cluster with g (1..8) consecutive slots of
// the order a cluster, ceil(nb / g) clusters.
extern "C" int thz_rlsep_grouped(void* u, const void* padded, const void* px, const void* py,
                                 const void* order, const void* n_iter, int nb, int it0, int it1,
                                 int b, int h2, int w2, int kr, int kc, int s, int g,
                                 void* stream) {
  return launch_group(u, padded, px, py, order, n_iter, nb, it0, it1, b, h2, w2, kr, kc, s, g,
                      stream);
}

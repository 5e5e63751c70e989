// General 2-D Richardson-Lucy iterations on one image with the estimate held
// on chip, for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel built by thz_image_explorer_tpu/ops/
// pallas_rl.py:_make_kernel (launched by richardson_lucy_pallas), which
// keeps the image's whole recurrence in VMEM. Same function as
// csrc/rl2d.cu: starting from u = P, the (h2, w2) padded image,
//     u <- u * corr(P / (corr(u, K) + 1e-12), K mirrored)
// with the (kr, kc) PSF K and the zero-boundary correlation
//     corr(x, K)[i, j] = sum_{a, b} K[a, b] x[i + a - kr / 2, j + b - kc / 2]
// (for an even kr or kc the window sits one sample below XLA's "SAME").
//
// Bound on this card: operations, n_iter * h2 * w2 * (4 kr kc + 3): at a
// 246 x 256 canvas, 9 x 9 taps and 408 iterations 8.40e9, 0.125 ms at the
// 67 TFLOP/s f32 peak of the whole card. The iterations are dependent and
// one cluster holds the image, so the floor of this design is that work on
// the cluster's S SMs: 1.035 ms at S = 16.
//
// What the design does about it (the structure of csrc/rlsep_cluster.cu).
// - One launch runs a host checkpoint group of iterations; nothing crosses
//   device memory between them.
// - One thread-block cluster of S CTAs. CTA q owns a contiguous slab of the
//   image's rows and keeps u, rel and P for them in shared memory, each row
//   with a zero column halo on both sides.
// - The rows within the PSF's reach come from whichever CTA owns them,
//   through distributed shared memory: a per-CTA table maps each row of the
//   CTA's halo window to its owner's slab (or to a zero row outside the
//   image), so a reach longer than one slab works. Columns are local.
// - The taps are laid out once per launch, plain and mirrored, in tiles of
//   T x T (zero-padded; 9 x 9 where the bank is at most 9 columns wide, else
//   8 x 8), with the bank shifted right so that the left column halo is a
//   multiple of 4 floats: every window load and every store of a thread's
//   outputs is a 16-byte vector.
// - Register blocking: a thread keeps kR rows x 4 columns of outputs; per
//   tile it holds the T x T taps in registers and walks the kR + T - 1
//   source rows of its window once, each loaded row of 4 + T - 1 values
//   feeding up to T x 4 FMAs of each of its rows.
// - cluster.sync() after each half: the first reads u and writes rel, the
//   second reads rel and multiplies u in place.
// f32 FMA on the CUDA cores, IEEE division (no --use_fast_math), no atomics:
// reruns are bit-identical. The sums run in another order than the plain
// version's, so the two agree within rounding.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// rows of outputs a thread keeps; scripts/torch_rl2d_grouped_sweep.py builds
// others with -DRL2_ROWS=... to compare them
#ifndef RL2_ROWS
#define RL2_ROWS 4
#endif
constexpr int kR = RL2_ROWS;
constexpr int kThreads = 256;
constexpr int kMaxCluster = 16;
// the widest tap bank (after the shift) that takes the 9 x 9 tiles
constexpr int kSmallCols = 9;

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int cdiv(int x, int m) { return (x + m - 1) / m; }

// Shared memory of one CTA: two tables of nwin row pointers (u, rel: each
// row of the CTA's halo window in its owner's slab), then floats: the plain
// and the mirrored tap banks (ntr x ntc tiles of t rows x tp floats), the u,
// rel and P slabs (rows x ws: a left halo of lh zeros, the w2 columns, a
// right halo) and one zero row.
struct Layout {
  int t, tp, rows, pr, lh, kcs, ntr, ntc, nwin, ws;
  size_t bank, slab_u, slab_rel, slab_p, zero, bytes;  // float offsets; total bytes
};

__host__ __device__ inline Layout layout(int h2, int w2, int kr, int kc, int s) {
  Layout l;
  l.pr = kr / 2;
  l.lh = round_up(kc / 2, 4);
  l.kcs = kc + l.lh - kc / 2;  // the bank's width once shifted right by lh - kc / 2
  l.t = l.kcs <= kSmallCols ? 9 : 8;
  l.tp = round_up(l.t, 4);
  l.ntr = cdiv(kr, l.t);
  l.ntc = cdiv(l.kcs, l.t);
  l.rows = cdiv(h2, s);
  l.nwin = round_up(l.rows, kR) + l.ntr * l.t - 1;
  // a window row is 4 + t - 1 values read as float4s from column j0 + tb t
  const int reach = round_up(w2, 4) - 4 + (l.ntc - 1) * l.t + round_up(4 + l.t - 1, 4);
  l.ws = round_up(reach > l.lh + round_up(w2, 4) ? reach : l.lh + round_up(w2, 4), 4);
  l.bank = (size_t)l.ntr * l.ntc * l.t * l.tp;
  l.slab_u = 2 * l.bank;
  l.slab_rel = l.slab_u + (size_t)l.rows * l.ws;
  l.slab_p = l.slab_rel + (size_t)l.rows * l.ws;
  l.zero = l.slab_p + (size_t)l.rows * l.ws;
  l.bytes = 2 * (size_t)l.nwin * sizeof(float*) + sizeof(float) * (l.zero + l.ws);
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
  const float* psf;
  int n_iter, h2, w2, kr, kc, s;
};

// One half-iteration on the CTA's slab of n rows. SECOND == false: dst =
// rel = P / (corr(src, K) + 1e-12) with src = u; SECOND == true: dst = u *=
// corr(src, K mirrored) with src = rel (the bank is then the mirrored one).
// rows[w] points at src's image row lo - pr + w wherever it lives; ps at the
// P slab.
template <int T, bool SECOND>
__device__ __forceinline__ void half(const float* const* rows, float* dst, const float* ps,
                                     const float* bank, int n, int w2, const Layout& L) {
  constexpr int TP = (T + 3) / 4 * 4;
  constexpr int NW = (4 + T - 1 + 3) / 4;  // float4s of a window row
  const int nbc = cdiv(w2, 4);
  const int nblk = cdiv(n, kR) * nbc;
  for (int blk = threadIdx.x; blk < nblk; blk += kThreads) {
    const int i0 = blk / nbc * kR, j0 = blk % nbc * 4;
    float acc[kR][4] = {};
    for (int ta = 0; ta < L.ntr; ++ta) {
      for (int tb = 0; tb < L.ntc; ++tb) {
        const float* tq = bank + (size_t)(ta * L.ntc + tb) * T * TP;
        float t[T][TP];
#pragma unroll
        for (int a = 0; a < T; ++a)
#pragma unroll
          for (int k = 0; k < TP / 4; ++k) {
            const float4 v = *reinterpret_cast<const float4*>(tq + a * TP + 4 * k);
            t[a][4 * k] = v.x;
            t[a][4 * k + 1] = v.y;
            t[a][4 * k + 2] = v.z;
            t[a][4 * k + 3] = v.w;
          }
        // window row r of this tile is image row lo + i0 + ta T + r - pr,
        // its value k padded column j0 + tb T + k (image column j0 + tb T
        // + k - lh): 16-byte aligned, since lh, j0 and (with T = 8) tb T are
        // multiples of 4 and T = 9 comes with one column tile
        const float* const* win = rows + i0 + ta * T;
        const int col = j0 + tb * T;
#pragma unroll
        for (int r = 0; r < kR + T - 1; ++r) {
          const float* src = win[r] + col;
          float w[4 * NW];
#pragma unroll
          for (int k = 0; k < NW; ++k) {
            const float4 v = *reinterpret_cast<const float4*>(src + 4 * k);
            w[4 * k] = v.x;
            w[4 * k + 1] = v.y;
            w[4 * k + 2] = v.z;
            w[4 * k + 3] = v.w;
          }
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const int a = r - i;
            if (a >= 0 && a < T) {
#pragma unroll
              for (int b = 0; b < T; ++b)
#pragma unroll
                for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(t[a][b], w[c + b], acc[i][c]);
            }
          }
        }
      }
    }
    // the epilogue: whole float4s where the 4 columns lie in the image
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = i0 + i;
      if (row >= n) break;
      float* d = dst + (size_t)row * L.ws + L.lh + j0;
      const float* p = ps + (size_t)row * L.ws + L.lh + j0;
      if (j0 + 4 <= w2) {
        float4 o;
        if (SECOND) {
          o = *reinterpret_cast<const float4*>(d);
          o.x *= acc[i][0];
          o.y *= acc[i][1];
          o.z *= acc[i][2];
          o.w *= acc[i][3];
        } else {
          const float4 pv = *reinterpret_cast<const float4*>(p);
          o.x = pv.x / (acc[i][0] + 1e-12f);
          o.y = pv.y / (acc[i][1] + 1e-12f);
          o.z = pv.z / (acc[i][2] + 1e-12f);
          o.w = pv.w / (acc[i][3] + 1e-12f);
        }
        *reinterpret_cast<float4*>(d) = o;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (j0 + c < w2) {
            if (SECOND)
              d[c] = d[c] * acc[i][c];
            else
              d[c] = p[c] / (acc[i][c] + 1e-12f);
          }
        }
      }
    }
  }
}

template <int T>
__global__ void __launch_bounds__(kThreads, 1) rl2d_cluster(Args a) {
  constexpr int TP = (T + 3) / 4 * 4;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout L = layout(a.h2, a.w2, a.kr, a.kc, a.s);
  const float** rows_u = reinterpret_cast<const float**>(smem_raw);
  const float** rows_rel = rows_u + L.nwin;
  float* fs = reinterpret_cast<float*>(rows_rel + L.nwin);
  float* bank_a = fs;
  float* bank_b = fs + L.bank;
  float* su = fs + L.slab_u;
  float* srel = fs + L.slab_rel;
  float* sp = fs + L.slab_p;
  float* zero = fs + L.zero;

  const int tid = threadIdx.x;
  const int q = (int)cluster.block_rank();
  const int h2 = a.h2, w2 = a.w2, kr = a.kr, kc = a.kc;
  int lo, n;
  slab(h2, a.s, q, lo, n);
  float* ub = a.u + (size_t)lo * w2;
  const float* pb = a.padded + (size_t)lo * w2;

  // the banks, tile by tile: entry (a', b') of tile (ta, tb) is tap row
  // ta T + a' and shifted column tb T + b', i.e. PSF column tb T + b' -
  // (lh - kc / 2); zero outside the PSF and in the tiles' padding
  const int shift = L.lh - kc / 2;
  for (int k = tid; k < (int)L.bank; k += kThreads) {
    const int tile = k / (T * TP), e = k % (T * TP);
    const int ar = tile / L.ntc * T + e / TP;
    const int bc = tile % L.ntc * T + e % TP - shift;
    const bool in = e % TP < T && ar < kr && bc >= 0 && bc < kc;
    bank_a[k] = in ? a.psf[ar * kc + bc] : 0.0f;
    bank_b[k] = in ? a.psf[(kr - 1 - ar) * kc + (kc - 1 - bc)] : 0.0f;
  }
  // the halo window's row tables: image row lo - pr + w lives in its
  // owner's slab; rows outside the image read the zero row
  for (int w = tid; w < L.nwin; w += kThreads) {
    const int j = lo - L.pr + w;
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
  // the slabs with their zero halos, and the zero row
  for (int i = tid; i < L.rows * L.ws; i += kThreads) {
    const int l = i / L.ws, c = i % L.ws - L.lh;
    const bool in = l < n && c >= 0 && c < w2;
    su[i] = in ? ub[(size_t)l * w2 + c] : 0.0f;
    sp[i] = in ? pb[(size_t)l * w2 + c] : 0.0f;
    srel[i] = 0.0f;
  }
  for (int i = tid; i < L.ws; i += kThreads) zero[i] = 0.0f;
  // every slab loaded, and every CTA of the cluster running, before any
  // remote read
  cluster.sync();

  for (int it = 0; it < a.n_iter; ++it) {
    half<T, false>(rows_u, srel, sp, bank_a, n, w2, L);
    cluster.sync();
    half<T, true>(rows_rel, su, sp, bank_b, n, w2, L);
    // also keeps this CTA's slabs alive until the others have read them
    cluster.sync();
  }
  for (int i = tid; i < n * w2; i += kThreads)
    ub[i] = su[(size_t)(i / w2) * L.ws + L.lh + i % w2];
}

template <int T>
cudaError_t launch(const Args& a, int dynamic, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(rl2d_cluster<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, dynamic);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rl2d_cluster<T>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.s, 1, 1);
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
  err = cudaLaunchKernelEx(&cfg, rl2d_cluster<T>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Shared-memory bytes of one CTA at cluster size s (the wrapper's layout
// mirror computes the same in Python), or -1 for arguments it does not take.
extern "C" long long thz_rl2d_cluster_smem(int h2, int w2, int kr, int kc, int s) {
  if (h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || s < 1) return -1;
  return (long long)layout(h2, w2, kr, kc, s).bytes;
}

// The tap tile the launch takes for a kc-column PSF: 9 or 8.
extern "C" int thz_rl2d_cluster_tile(int kc) {
  if (kc < 1) return -1;
  return layout(1, 1, 1, kc, 1).t;
}

// u: (h2, w2) f32, the running estimate, updated in place (the caller starts
// it as a copy of padded); padded: (h2, w2) f32; psf: (kr, kc) f32; all on
// the device. Runs n_iter iterations in one launch of one cluster of s CTAs,
// on `stream`; does not synchronize. Returns 0, or the CUDA error of the
// refused launch (cudaErrorInvalidValue for arguments it does not take: s
// outside 1..16 or above h2, or more shared memory than a block may use).
extern "C" int thz_rl2d_cluster(void* u, const void* padded, const void* psf, int n_iter, int h2,
                                int w2, int kr, int kc, int s, void* stream) {
  if (n_iter < 1 || h2 < 1 || w2 < 1 || kr < 1 || kc < 1 || s < 1 || s > kMaxCluster || s > h2)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const Layout L = layout(h2, w2, kr, kc, s);
  if (L.bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
  Args a;
  a.u = static_cast<float*>(u);
  a.padded = static_cast<const float*>(padded);
  a.psf = static_cast<const float*>(psf);
  a.n_iter = n_iter;
  a.h2 = h2;
  a.w2 = w2;
  a.kr = kr;
  a.kc = kc;
  a.s = s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(L.t == 9 ? launch<9>(a, (int)L.bytes, st) : launch<8>(a, (int)L.bytes, st));
}

// Viewshed resampler: the contract raster of ops/viewshed.py, each output
// cell's own elevation tangent against the horizon of its polar column
// strictly nearer than the cell, for a batch of B viewpoints.
//
// It replaces no TPU kernel. The JAX package evaluates these masked maxima
// as gather-free contractions over quarter arcs
// (horizonator_tpu/ops/viewshed.py:582-898), jnp glue that XLA fuses on the
// TPU; the port evaluated them in ~50 torch passes (frame, cell tangents,
// a radix sort, searchsorted tables, gathers), 99% of a cumulative
// viewshed's device time.
//
// Two launches, each the port's float32 arithmetic op for op:
//
//   the columns: each (viewpoint, column)'s K sample distances sorted (a
//     bitonic network padded to a power of two with +inf; a NaN distance,
//     which no radius exceeds, sorts as +inf), the tangents carried, and
//     their running max (NaN-propagating, as torch.cummax), written as
//     (B, W, ks) float32. viewshed_columns_warp_kernel takes a column of
//     up to 1024 samples in one warp's registers; viewshed_columns_kernel
//     a longer one in a block, in shared memory up to 16384 samples, else
//     in the outputs themselves. Ties may end up in any order: run[cnt -
//     1] with cnt = #{d < r} is the masked max over {d < r} whatever their
//     order, since equal distances are all in the set or all out of it.
//   viewshed_cells_kernel, one thread per output cell: for each viewpoint
//     in turn the cell's offsets, azimuth (atan2f, unwrapped), polar
//     column, range and window masks, bilinear (or triangulated) terrain
//     and tangent, exactly as _frame and _cell_tangent compute them; its
//     own radius along its column, nn / cos(az_x) - half_x in region A
//     (|north| >= |east|), else ee / sin(az_x) - half_x: the same float32
//     operations on the same inputs as the table entry the torch passes
//     gather, so the same bits; a binary search of that radius in the
//     column's sorted distances (a NaN radius: no entry); the quarter-arc
//     coverage under full_circle, from 8 arc starts per viewpoint computed
//     here from its azimuth window (no table upload, no host sync); then
//     t_cell >= th under the mask. Epilogues: add the visible viewpoints
//     into an (2hw, 2hw) int32 count (one add per cell, no atomics: the
//     viewpoint loop is inside the thread), or write the (B, 2hw, 2hw)
//     bool raster and, under full_circle, the uncovered count per
//     viewpoint (a warp ballot, a shared-memory sum, one atomic per block
//     and viewpoint; integer sums are exact in any order).
//
// Every float32 operation is rounded once, as torch's separate passes
// round it: __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn
// (never contracted), sums in the torch expression's left-to-right order;
// atan2f and rintf / floorf are the CUDA library's own. cos, sin and half
// of each column come from torch (colv), as do the RenderParams.
//
// What bounds it on the H100. A batch of 64 viewpoints over an 800 x 800
// frame at W 720, K 324 must move ~0.13 GB (the march's tangents and
// distances read, the DEM, the count read and written), ~0.039 ms at
// 3.35 TB/s; the two-kernel design adds ~0.24 GB, the sorted columns
// written and read back (~0.071 ms). Every cell-viewpoint does 16 float32
// operations up to its range test (a square root among them), and the
// ~28% that reach the search 48 more (atan2f, two IEEE divisions, the
// bilinear tap, a 9-step binary search, the tangent): ~1.2 G operations,
// ~0.018 ms at 67 TFLOP/s. So the bound is the bytes, but what holds the
// kernels is their instruction streams: the sort's network does
// ~K log^2 K compare-exchanges a column, and each cell's binary search
// is a chain of dependent loads. The design: a warp keeps its column in
// registers and trades partners by shuffles, with no barrier (a block a
// column with a barrier a stage took 4x as long on the H100); cells
// outside [znear, zfar] or the grid skip everything after their distance
// (about 70% of a cumulative viewshed's cell-viewpoints); a warp holds 32
// cells of one output row, so its viewpoint loop, its masks and its
// columns agree across the warp and its binary searches walk the same
// sorted column (broadcast loads from L1); each block stages 32
// viewpoints' own values (window, offsets, taps, arc starts) in shared
// memory once.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -3.0e38f;                   // the empty masked max
constexpr float PI32 = (float)3.14159265358979323846;
constexpr float TWO_PI32 = (float)(2.0 * 3.14159265358979323846);
constexpr double QA = 3.14159265358979323846 / 4.0;
constexpr int OBS = 11;          // RenderParams fields a viewpoint
constexpr int SORT_SMEM_MAX = 16384;   // longest column sorted in shared
constexpr int TILE_B = 32;       // viewpoints a block stages at once
constexpr int TX = 32, TY = 8;   // a block's cells: 8 rows of 32

// max as torch.cummax takes it: a NaN on either side wins
__device__ __forceinline__ float maxp(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}

__global__ void __launch_bounds__(512) viewshed_columns_kernel(
    const float* __restrict__ tanel, const float* __restrict__ d, int K,
    int kp, int ks, float* dsorted, float* run) {
  extern __shared__ float smem[];
  __shared__ float wtot[16];
  const long long col = blockIdx.x;
  const float* tc = tanel + col * K;
  const float* dc = d + col * K;
  const bool shared = kp <= SORT_SMEM_MAX;
  float* key = shared ? smem : dsorted + col * ks;
  float* val = shared ? smem + kp : run + col * ks;
  const int T = blockDim.x, tid = threadIdx.x;
  for (int k = tid; k < kp; k += T) {
    const float dk = k < K ? dc[k] : INFINITY;
    key[k] = isnan(dk) ? INFINITY : dk;
    val[k] = k < K ? tc[k] : NEG;
  }
  __syncthreads();
  for (int size = 2; size <= kp; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < (kp >> 1); t += T) {
        const int lo = 2 * t - (t & (stride - 1)), hi = lo + stride;
        const float kl = key[lo], kh = key[hi];
        if ((kl > kh) == ((lo & size) == 0)) {
          key[lo] = kh;
          key[hi] = kl;
          const float v = val[lo];
          val[lo] = val[hi];
          val[hi] = v;
        }
      }
      __syncthreads();
    }
  }
  // running max: each thread a contiguous chunk, then the chunks' maxima
  // by warp shuffles and one exchange between the warps
  const int c = kp / T, base = tid * c, lane = tid & 31, warp = tid >> 5;
  float m = val[base];
  for (int q = 1; q < c; ++q) {
    m = maxp(m, val[base + q]);
    val[base + q] = m;
  }
  float incl = m;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = maxp(y, incl);
  }
  if (lane == 31) wtot[warp] = incl;
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  __syncthreads();
  float excl = -INFINITY;
  for (int w = 0; w < warp; ++w) excl = maxp(excl, wtot[w]);
  if (lane > 0) excl = maxp(excl, prev);
  if (tid > 0)
    for (int q = 0; q < c; ++q) val[base + q] = maxp(excl, val[base + q]);
  if (shared) {
    __syncthreads();
    for (int k = tid; k < K; k += T) {
      dsorted[col * ks + k] = key[k];
      run[col * ks + k] = val[k];
    }
  }
}

// The same for kp = 32 R <= 1024 samples, one warp a column and no
// barrier: lane l holds samples l R .. l R + R - 1 in registers, so the
// network's strides below R swap registers and the longer ones exchange
// with lane l ^ (stride / R) by shuffles; the running max scans each
// lane's R samples, then the lanes' totals. The column comes in and goes
// out through the warp's shared memory, so that the device reads and
// writes are coalesced: sample e at e + e / 32, where the lanes' blocked
// and strided accesses meet no bank conflict.
template <int R>
__global__ void __launch_bounds__(128) viewshed_columns_warp_kernel(
    const float* __restrict__ tanel, const float* __restrict__ d,
    long long ncol, int K, float* __restrict__ dsorted,
    float* __restrict__ run) {
  __shared__ float stage[4][2][33 * R];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long col = (long long)blockIdx.x * 4 + warp;
  if (col >= ncol) return;
  const float* tc = tanel + col * K;
  const float* dc = d + col * K;
  float* sk = stage[warp][0];
  float* sv = stage[warp][1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    const float dk = e < K ? dc[e] : INFINITY;
    sk[r * 33 + lane] = isnan(dk) ? INFINITY : dk;
    sv[r * 33 + lane] = e < K ? tc[e] : NEG;
  }
  __syncwarp();
  float key[R], val[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    key[r] = sk[e + e / 32];
    val[r] = sv[e + e / 32];
  }
  constexpr int LOG_KP = R == 2 ? 6 : R == 4 ? 7 : R == 8 ? 8 : R == 16 ? 9
                                                                 : 10;
#pragma unroll
  for (int ls = 1; ls <= LOG_KP; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls, stride = 1 << lt;
      if (stride < R) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & stride) continue;
          const int q = r | stride;
          if ((key[r] > key[q]) == (((lane * R + r) & size) == 0)) {
            const float k = key[r], v = val[r];
            key[r] = key[q];
            val[r] = val[q];
            key[q] = k;
            val[q] = v;
          }
        }
      } else {
        const int lx = stride / R;
        const bool lower = (lane & lx) == 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float ko = __shfl_xor_sync(0xffffffffu, key[r], lx);
          const float vo = __shfl_xor_sync(0xffffffffu, val[r], lx);
          const float kl = lower ? key[r] : ko, kh = lower ? ko : key[r];
          if ((kl > kh) == (((lane * R + r) & size) == 0)) {
            key[r] = ko;
            val[r] = vo;
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 1; r < R; ++r) val[r] = maxp(val[r - 1], val[r]);
  float incl = val[R - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = maxp(y, incl);
  }
  const float prev = __shfl_up_sync(0xffffffffu, incl, 1);
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    sk[e + e / 32] = key[r];
    sv[e + e / 32] = lane > 0 ? maxp(prev, val[r]) : val[r];
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < K) {
      dsorted[col * K + e] = sk[r * 33 + lane];
      run[col * K + e] = sv[r * 33 + lane];
    }
  }
}

template <int R>
int launch_warp(const void* tanel, const void* d, long long ncol, int K,
                void* dsorted, void* run, cudaStream_t stream) {
  viewshed_columns_warp_kernel<R><<<(unsigned)((ncol + 3) / 4), 128, 0,
                                    stream>>>(
      (const float*)tanel, (const float*)d, ncol, K, (float*)dsorted,
      (float*)run);
  return (int)cudaGetLastError();
}

struct CellArgs {
  const float* dem;
  const float* obs;       // (B, OBS) RenderParams fields
  const float4* colv;     // (B, W): cos az, sin az, half, unused
  const float* dsorted;   // (B, W, ks)
  const float* run;
  int* total;             // (P2, P2) or null
  uint8_t* vis;           // (B, P2, P2) or null
  int* uncovered;         // (B,) or null
  int n0, n1, B, W, K, ks, hw, centered, triangulated, full_circle;
  float cell_n, ci, cj, recip_2pi;
};

// A viewpoint's own values, as _frame and _cell_tangent derive them.
struct Obs {
  float vci, vcj, vz, cell_e, azc, ndc, znear, zfar, curv;
  float fi, fj, c00, c01, c10, c11;
  int js, is;
  int start[8];           // the quarter arcs' first columns
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

__device__ __forceinline__ float arc_theta(int arc) {
  // _arc_covered's first azimuths: by region (A, B), north, east
  switch (arc) {
    case 0: return (float)3.14159265358979323846;
    case 1: return (float)(3.14159265358979323846 - QA);
    case 2: return (float)(-QA);
    case 3: return 0.0f;
    case 4: return (float)(-3.0 * QA);
    case 5: return (float)(3.14159265358979323846 / 2.0);
    case 6: return (float)(-3.14159265358979323846 / 2.0);
    default: return (float)QA;
  }
}

__device__ Obs observer(const CellArgs& a, int b) {
  const float* p = a.obs + (long long)b * OBS;
  Obs o;
  o.vci = p[0];
  o.vcj = p[1];
  o.vz = p[2];
  const float az0 = p[4], az1 = p[5];
  o.znear = p[6];
  o.zfar = p[7];
  o.curv = p[10];
  // geometry.az_window_rad: az1 unwrapped near az0 + pi
  const float dd = __fmul_rn(__fsub_rn(__fsub_rn(az1, az0), PI32),
                             a.recip_2pi);
  float a1 = __fadd_rn(
      __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(dd, rintf(dd)), 2.0f), PI32),
                PI32), az0);
  if (a1 <= az0) a1 = __fadd_rn(az0, TWO_PI32);
  o.azc = __fmul_rn(__fadd_rn(az0, a1), 0.5f);
  o.ndc = __fdiv_rn(2.0f, __fsub_rn(a1, az0));
  o.cell_e = __fmul_rn(a.cell_n, p[3]);
  // _cell_tangent's window from the frame's first row and column
  const float off0 = __fadd_rn((float)(-a.hw), 0.5f);
  const float dj0 = a.centered ? __fsub_rn(__fadd_rn(off0, a.cj), o.vcj)
                               : off0;
  const float di0 = a.centered ? __fsub_rn(__fadd_rn(off0, a.ci), o.vci)
                               : off0;
  const float pj0 = __fadd_rn(o.vcj, dj0), pi0 = __fadd_rn(o.vci, di0);
  const float j0 = floorf(pj0), i0 = floorf(pi0);
  o.fj = __fsub_rn(pj0, j0);
  o.fi = __fsub_rn(pi0, i0);
  const int pad = a.hw + 2, s = 2 * a.hw + 2;
  o.js = (int)fminf(fmaxf(__fadd_rn(j0, (float)pad), 0.0f),
                    (float)(a.n0 + 2 * pad - s));
  o.is = (int)fminf(fmaxf(__fadd_rn(i0, (float)pad), 0.0f),
                    (float)(a.n1 + 2 * pad - s));
  const float gj = __fsub_rn(1.0f, o.fj), gi = __fsub_rn(1.0f, o.fi);
  o.c00 = __fmul_rn(gj, gi);
  o.c01 = __fmul_rn(gj, o.fi);
  o.c10 = __fmul_rn(o.fj, gi);
  o.c11 = __fmul_rn(o.fj, o.fi);
  // _arc_covered: floor(xf) - 2 mod W, xf from the window's centre
  for (int q = 0; q < 8; ++q) {
    const float xf = __fsub_rn(
        __fmul_rn(__fmul_rn(__fadd_rn(__fsub_rn(arc_theta(q), o.azc), PI32),
                            (float)a.W), a.recip_2pi), 0.5f);
    const int st = ((int)floorf(xf) - 2) % a.W;
    o.start[q] = st < 0 ? st + a.W : st;
  }
  return o;
}

__global__ void __launch_bounds__(TX * TY) viewshed_cells_kernel(
    const CellArgs a) {
  __shared__ Obs so[TILE_B];
  __shared__ int sunc[TILE_B];
  const int p2 = 2 * a.hw, pad = a.hw + 2;
  const int i = blockIdx.x * TX + threadIdx.x;
  const int j = blockIdx.y * TY + threadIdx.y;
  const int tid = threadIdx.y * TX + threadIdx.x;
  const bool inside = i < p2 && j < p2;
  const int sq = min(a.W, a.W / 8 + 8);
  // _frame's offsets (off + the frame centre where one is fixed)
  const float offi = __fadd_rn((float)(i - a.hw), 0.5f);
  const float offj = __fadd_rn((float)(j - a.hw), 0.5f);
  const float ei = a.centered ? __fadd_rn(offi, a.ci) : offi;
  const float ej = a.centered ? __fadd_rn(offj, a.cj) : offj;
  const float top_j = (float)(a.n0 - 1), top_i = (float)(a.n1 - 1);
  int count = 0;
  for (int b0 = 0; b0 < a.B; b0 += TILE_B) {
    const int nb = min(TILE_B, a.B - b0);
    __syncthreads();
    if (tid < nb) {
      so[tid] = observer(a, b0 + tid);
      sunc[tid] = 0;
    }
    __syncthreads();
    for (int t = 0; t < nb; ++t) {
      const Obs& o = so[t];
      const int b = b0 + t;
      bool v = false, unc = false;
      const float di = a.centered ? __fsub_rn(ei, o.vci) : offi;
      const float dj = a.centered ? __fsub_rn(ej, o.vcj) : offj;
      const float nn = __fmul_rn(dj, a.cell_n);
      const float ee = __fmul_rn(di, o.cell_e);
      const float dist = __fsqrt_rn(__fadd_rn(__fmul_rn(ee, ee),
                                              __fmul_rn(nn, nn)));
      const float pj = __fadd_rn(o.vcj, dj), pi = __fadd_rn(o.vci, di);
      if (inside && dist >= o.znear && dist <= o.zfar && pj >= 0.0f &&
          pj <= top_j && pi >= 0.0f && pi <= top_i) {
        const float dd = __fmul_rn(__fsub_rn(atan2f(ee, nn), o.azc),
                                   a.recip_2pi);
        const float az = __fadd_rn(
            __fmul_rn(__fmul_rn(__fsub_rn(dd, rintf(dd)), 2.0f), PI32),
            o.azc);
        const float x_ndc = __fmul_rn(__fsub_rn(az, o.azc), o.ndc);
        if (x_ndc >= -1.0f && x_ndc <= 1.0f) {
          const float xcol = rintf(__fsub_rn(
              __fmul_rn(__fmul_rn(__fadd_rn(x_ndc, 1.0f), 0.5f),
                        (float)a.W), 0.5f));
          const int xc = (int)fminf(fmaxf(xcol, 0.0f), (float)(a.W - 1));
          const bool region_a = fabsf(nn) >= fabsf(ee);
          bool covered = true;
          if (a.full_circle) {
            const int arc = (region_a ? 0 : 4) + (nn >= 0.0f ? 2 : 0) +
                            (ee >= 0.0f ? 1 : 0);
            const int rel = (xc - o.start[arc]) % a.W;
            covered = (rel < 0 ? rel + a.W : rel) < sq;
            unc = !covered;
          }
          float th = NEG;
          if (covered) {
            const long long cb = ((long long)b * a.W + xc) * a.ks;
            const float4 c = __ldg(a.colv + (long long)b * a.W + xc);
            const float r = region_a
                                ? __fsub_rn(__fdiv_rn(nn, c.x), c.z)
                                : __fsub_rn(__fdiv_rn(ee, c.y), c.z);
            int lo = 0, hi = isnan(r) ? 0 : a.K;
            while (lo < hi) {
              const int mid = (lo + hi) >> 1;
              if (__ldg(a.dsorted + cb + mid) < r)
                lo = mid + 1;
              else
                hi = mid;
            }
            if (lo > 0) th = __ldg(a.run + cb + lo - 1);
          }
          // the cell's own tangent from the window's 4 taps
          const int r0 = clampi(o.js + j - pad, 0, a.n0 - 1);
          const int r1 = clampi(o.js + j + 1 - pad, 0, a.n0 - 1);
          const int q0 = clampi(o.is + i - pad, 0, a.n1 - 1);
          const int q1 = clampi(o.is + i + 1 - pad, 0, a.n1 - 1);
          const float w00 = __ldg(a.dem + (long long)r0 * a.n1 + q0);
          const float w01 = __ldg(a.dem + (long long)r0 * a.n1 + q1);
          const float w10 = __ldg(a.dem + (long long)r1 * a.n1 + q0);
          const float w11 = __ldg(a.dem + (long long)r1 * a.n1 + q1);
          float z;
          if (a.triangulated) {
            const float zl = __fadd_rn(
                __fadd_rn(w00, __fmul_rn(__fsub_rn(w01, w00), o.fi)),
                __fmul_rn(__fsub_rn(w11, w01), o.fj));
            const float zu = __fadd_rn(
                __fadd_rn(w00, __fmul_rn(__fsub_rn(w11, w10), o.fi)),
                __fmul_rn(__fsub_rn(w10, w00), o.fj));
            z = o.fj <= o.fi ? zl : zu;
          } else {
            z = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(o.c00, w00),
                                              __fmul_rn(o.c01, w01)),
                                    __fmul_rn(o.c10, w10)),
                          __fmul_rn(o.c11, w11));
          }
          const float t_cell = __fsub_rn(
              __fdiv_rn(__fsub_rn(z, o.vz), dist), __fmul_rn(dist, o.curv));
          v = t_cell >= th;
        }
      }
      count += v;
      if (a.vis && inside)
        a.vis[((long long)b * p2 + j) * p2 + i] = v;
      if (a.uncovered) {
        const unsigned m = __ballot_sync(0xffffffffu, unc);
        if (threadIdx.x == 0 && m) atomicAdd(&sunc[t], __popc(m));
      }
    }
    if (a.uncovered) {
      __syncthreads();
      if (tid < nb && sunc[tid]) atomicAdd(a.uncovered + b0 + tid, sunc[tid]);
    }
  }
  if (a.total && inside) a.total[(long long)j * p2 + i] += count;
}

}  // namespace

extern "C" int hz_viewshed_columns(const void* tanel, const void* d, int B,
                                   int W, int K, int kp, int ks,
                                   void* dsorted, void* run, void* stream) {
  const long long ncol = (long long)B * W;
  const cudaStream_t st = (cudaStream_t)stream;
  if (ncol > 0 && kp <= 1024) {
    switch (kp) {
      case 64: return launch_warp<2>(tanel, d, ncol, K, dsorted, run, st);
      case 128: return launch_warp<4>(tanel, d, ncol, K, dsorted, run, st);
      case 256: return launch_warp<8>(tanel, d, ncol, K, dsorted, run, st);
      case 512: return launch_warp<16>(tanel, d, ncol, K, dsorted, run, st);
      default: return launch_warp<32>(tanel, d, ncol, K, dsorted, run, st);
    }
  }
  const int threads = kp / 2 < 32 ? 32 : kp / 2 > 512 ? 512 : kp / 2;
  const size_t smem = kp <= SORT_SMEM_MAX ? 2 * sizeof(float) * kp : 0;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        viewshed_columns_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (long long)B * W;
  if (blocks > 0) {
    viewshed_columns_kernel<<<(unsigned)blocks, threads, smem,
                              (cudaStream_t)stream>>>(
        (const float*)tanel, (const float*)d, K, kp, ks, (float*)dsorted,
        (float*)run);
  }
  return (int)cudaGetLastError();
}

extern "C" int hz_viewshed_cells(
    const void* dem, int n0, int n1, const void* obs, const void* colv,
    const void* dsorted, const void* run, int B, int W, int K, int ks,
    int hw, float cell_n, int centered, float ci, float cj, float recip_2pi,
    int triangulated, int full_circle, void* total, void* vis,
    void* uncovered, void* stream) {
  CellArgs a;
  a.dem = (const float*)dem;
  a.obs = (const float*)obs;
  a.colv = (const float4*)colv;
  a.dsorted = (const float*)dsorted;
  a.run = (const float*)run;
  a.total = (int*)total;
  a.vis = (uint8_t*)vis;
  a.uncovered = (int*)uncovered;
  a.n0 = n0;
  a.n1 = n1;
  a.B = B;
  a.W = W;
  a.K = K;
  a.ks = ks;
  a.hw = hw;
  a.centered = centered;
  a.triangulated = triangulated;
  a.full_circle = full_circle;
  a.cell_n = cell_n;
  a.ci = ci;
  a.cj = cj;
  a.recip_2pi = recip_2pi;
  const int p2 = 2 * hw;
  if (p2 > 0 && B > 0) {
    const dim3 grid((p2 + TX - 1) / TX, (p2 + TY - 1) / TY);
    viewshed_cells_kernel<<<grid, dim3(TX, TY), 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

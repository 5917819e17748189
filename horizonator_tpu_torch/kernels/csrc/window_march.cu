// Window march: the far-field crossing samples of every image column.
//
// Replaces horizonator_tpu/render/window.py::_window_kernel, both its
// untextured and its textured branch. The TPU kernel staged a (window,
// 128-step) slab of a per-render crossing table into VMEM and evaluated the
// 2-tap lerp as a dense hat contraction, because gathers were the TPU's
// slow path. On Hopper a gather from L2 is cheap, so each thread reads its
// two taps straight from the (n, n) DEM:
//
//   pos = fma(m, t, a), axis = axis0 + m*sign, d = (m + e) * scale
//   z   = fma(h_hi, dem[floor(pos) + 1], h_lo * dem[floor(pos)])
//         (along row `axis` for row-dominant columns, j_dom, and along
//         column `axis` for the others)
//   out = fma(-d, curv, (z - vz)/d), or NEG_BIG outside the grid or
//         [znear, zfar]
//
// Every operation is the JAX kernel's, in its order, with explicit
// round-to-nearest intrinsics; the build passes --fmad=false so that the
// only fused multiply-adds are the ones written here, the ones that XLA
// contracts in the JAX kernel (its `a + mf*t`, its hat accumulations
// `acc + hat*w` and its curvature term `q - dm*curv`). The hat form's
// non-support terms are exact zeros, so the sample equals the JAX kernel's
// sum bit for bit. The position is fma(m, t, a) from the integer step at
// every sample, never a running sum.
//
// Textured entry: the same sample also reads two texels of a packed
// 0x00RRGGBB (s*n, s*n) int32 plane, s = 1 (cell) or 2 (half-cell), at
// line s*axis and cross positions floor(s*pos) + {0, 1}, weighted by the
// hats at s*pos, and writes the rounded (half to even), clipped u8 channels
// packed again; 0 where the sample is invalid. The TPU kernel's hats are
// window-relative (s*(pos - o) - r); with o an integer both subtractions are
// exact, so the absolute form here gives the same weights.
//
// Thread mapping. A thread owns one image column; a warp is 32 adjacent
// columns at ONE step. A block of 4 warps computes a tile of 32 columns x
// 64 steps, warp w taking steps w, w + 4, ... of the tile. Adjacent columns
// share axis0 and sign within an octant, so at step m a warp reads one
// grid line: for row-dominant columns (address axis*n + r) its 32 taps lie
// within a few cells of each other on one DEM row, one to eight 32-byte
// sectors; for column-dominant columns (address r*n + axis) they lie on
// one DEM column, one sector per distinct r (about a dozen at mid range).
// A warp along 32 steps of one column would read 32 DEM rows per load for
// the row-dominant half. The column's eight constants
// are two 16-byte loads, made once and kept in registers for all 16 of the
// thread's steps; the grid is 2-D (column tiles x step tiles), so no
// thread divides. A thread takes its steps four at a time: first the four
// positions, validity tests and (predicated) loads, then the arithmetic,
// so eight DEM loads (sixteen with colors) are in flight per thread and no
// sample's load waits behind another sample's division.
//
// Stores. The samples of a tile go into a padded shared array [64][33]
// (a second one of int for the colors); after one barrier each warp writes
// 32 consecutive steps of one column, 128 contiguous bytes per warp store
// (whole 32-byte sectors wherever K allows), reading the array down a
// column: the padding keeps both the row-wise writes and the column-wise
// reads free of bank conflicts. Partial tiles (W % 32, K % 64) are
// predicated: a thread outside W loads nothing and stores nothing but
// reaches the barrier.
//
// Batch. A launch marches B viewpoints: the viewpoint rides on gridDim.z,
// and each block offsets its column constants (B, W, 8), its scalars (B, 4)
// and its outputs (B, W, K) by its viewpoint, in 64-bit arithmetic (B*W*K
// passes 2^31 at a few hundred 4096-column viewpoints). The DEM and the
// color plane have batch strides of their own: 0 for one grid that every
// viewpoint marches (the window sampler), n*n and (s*n)^2 for a crop per
// viewpoint (the LOD levels). Within a viewpoint the mapping below is the
// single march's. Batches above 65535 viewpoints go out as several
// launches of at most 65535 each. A batch of one launches the kernel
// without the offsets (BATCH false): with them the single march ran 9%
// slower on an NVIDIA H100 80GB HBM3 at 700 W (0.0092 against 0.0084 ms
// at 4096 x 576, textured 0.0189 against 0.0174; chip_smoke.py
// --time-march, the two forms in turns in one run), so the single render
// keeps its code as it was.
//
// Bands. The banded entries march a rectangular (nj, ni) grid, a row band
// of a larger one (region sharding): its rows are band-local, global row =
// local row + j_off, and the validity bounds are global, as in the TPU
// kernel's per-column bounds (window.py:822-834): the row coordinate in
// [j_off, j_off + j_hi] (the axis of row-dominant columns, the cross
// position of column-dominant ones), the column coordinate in [0, ni-1].
// Positions, hats and distances stay global, so a band's samples are bitwise
// the whole grid's; only the addresses shift by j_off rows (s*j_off rows of
// the color plane), and the row stride is ni. The square entries keep
// their code (BAND false): the band's bounds and offsets cost them nothing.
//
// What bounds it on the H100. The function's bytes (the DEM cells within
// zfar, the columns' constants, the (W, K) outputs) are a few microseconds
// at 3.35 TB/s, and the kernel is not held by them: variants without the
// DEM loads or without the stores ran about as long. It is held by
// instruction throughput and the length of a thread's dependent chain:
// about 65 machine instructions per sample (six bounds tests, the hats,
// the IEEE division, 64-bit index arithmetic), 16 samples per thread in
// four rounds, behind a launch and a first load of the constants that
// cost as much as a write-only pass over the outputs. PERF.md has the
// times. A transposed copy of the DEM and the color plane for the
// column-dominant half would take out sectors, which are not what holds
// the kernel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -3.0e38f;
constexpr int COLS = 32;            // columns of a tile: the lanes of a warp
constexpr int STEPS = 64;           // steps of a tile
constexpr int WARPS = 4;            // warps of a block
constexpr int U = 4;                // steps whose loads are in flight together
constexpr int PCOL = 8;             // floats of a column's constants
constexpr unsigned MAX_Z = 65535;   // viewpoints of one launch (gridDim.z)
static_assert(STEPS % 32 == 0 && STEPS % (WARPS * U) == 0, "tile shape");

__device__ __forceinline__ void hats(float x, float& fl, float& h_lo,
                                     float& h_hi) {
  fl = floorf(x);
  h_lo = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(x, fl))), 0.0f);
  h_hi = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(x, __fadd_rn(fl, 1.0f)))),
               0.0f);
}

// pcol: (W, 8) float32 per column: a, t, e, scale, axis0, sign, j_dom, 0.
// fscal: (4,) float32: viewer z, znear, zfar, curvature coefficient.
// n: the grid's columns (its edge, square); BAND: nj rows from global row
// j_off, valid up to j_off + j_hi.
template <bool TEX, bool BATCH, bool BAND>
__global__ void __launch_bounds__(32 * WARPS)
window_march_kernel(const float* __restrict__ dem, int n, int nj, int j_off,
                    float j_hi, long long dem_bstride,
                    const int* __restrict__ colors,
                    int s, long long color_bstride,
                    const float* __restrict__ pcol,
                    const float* __restrict__ fscal, int W, int K,
                    float* __restrict__ out, int* __restrict__ tex_out) {
  __shared__ float s_out[STEPS][COLS + 1];
  __shared__ int s_tex[TEX ? STEPS : 1][COLS + 1];
  if (BATCH) {  // the block's viewpoint
    const long long b = blockIdx.z;
    dem += b * dem_bstride;
    pcol += b * W * PCOL;
    fscal += b * 4;
    out += b * W * K;
    if (TEX) {
      colors += b * color_bstride;
      tex_out += b * W * K;
    }
  }
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int w0 = blockIdx.x * COLS, m0 = blockIdx.y * STEPS;
  const int w = w0 + lane;

  // the thread's column, for all of its steps
  float4 c0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c1 = c0;
  if (w < W) {
    c0 = __ldg(reinterpret_cast<const float4*>(pcol) + 2 * w);
    c1 = __ldg(reinterpret_cast<const float4*>(pcol) + 2 * w + 1);
  }
  const float a = c0.x, t = c0.y, e = c0.z, scale = c0.w;
  const float axis0 = c1.x, sgn = c1.y;
  const bool j_dom = c1.z != 0.0f;
  const float vz = __ldg(fscal), znear = __ldg(fscal + 1);
  const float zfar = __ldg(fscal + 2), curv = __ldg(fscal + 3);
  const float hi = (float)(n - 1);
  const unsigned nc = (unsigned)(s * n);
  const unsigned step = j_dom ? 1u : (unsigned)n, cstep = j_dom ? 1u : nc;
  // a band's global bounds: the row coordinate in [jlo, jhi]
  float ax_lo = 0.0f, ax_hi = hi, cr_lo = 0.0f, cr_hi = hi;
  if (BAND) {
    const float jlo = (float)j_off, jhi = __fadd_rn(jlo, j_hi);
    ax_lo = j_dom ? jlo : 0.0f;
    ax_hi = j_dom ? jhi : hi;
    cr_lo = j_dom ? 0.0f : jlo;
    cr_hi = j_dom ? hi : jhi;
  }
  // the cross axis's extent: columns for row-dominant columns, else rows
  const unsigned n_cross = BAND && !j_dom ? (unsigned)nj : (unsigned)n;
  const unsigned off = BAND ? (unsigned)j_off : 0u;

  // U steps at a time: first every step's position, validity and loads
  // (no load waits for another), then the arithmetic on what arrived
#pragma unroll 1
  for (int i0 = 0; i0 < STEPS / WARPS; i0 += U) {
    float pos[U], dm[U], z_lo[U], z_hi[U];
    int c_lo[TEX ? U : 1], c_hi[TEX ? U : 1];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + warp + (i0 + u) * WARPS;
      const float mf = (float)m;
      pos[u] = __fmaf_rn(mf, t, a);
      const float axis_m = __fadd_rn(axis0, __fmul_rn(mf, sgn));
      dm[u] = __fmul_rn(__fadd_rn(mf, e), scale);
      if (BAND)
        valid[u] = w < W && m < K && axis_m >= ax_lo && axis_m <= ax_hi &&
                   pos[u] >= cr_lo && pos[u] <= cr_hi && dm[u] >= znear &&
                   dm[u] <= zfar;
      else
        valid[u] = w < W && m < K && axis_m >= 0.0f && axis_m <= hi &&
                   pos[u] >= 0.0f && pos[u] <= hi && dm[u] >= znear &&
                   dm[u] <= zfar;
      // the addresses of an invalid step are never used; a band's rows are
      // local (the global row less j_off)
      const unsigned r = (unsigned)(int)floorf(pos[u]) - (j_dom ? 0u : off);
      const unsigned ax = (unsigned)(int)axis_m - (j_dom ? off : 0u);
      const unsigned long long i_lo =
          (unsigned long long)(j_dom ? ax : r) * (unsigned)n +
          (j_dom ? r : ax);
      z_lo[u] = valid[u] ? __ldg(dem + i_lo) : 0.0f;
      // pos on the last line exactly: the upper tap lies outside the grid
      // with weight 0
      z_hi[u] = (valid[u] && r + 1u < n_cross) ? __ldg(dem + i_lo + step)
                                               : 0.0f;
      if (TEX) {
        const unsigned rc =
            (unsigned)(int)floorf(__fmul_rn(pos[u], (float)s)) -
            (j_dom ? 0u : (unsigned)s * off);
        const unsigned axc = (unsigned)s * ax;
        const unsigned long long ci =
            (unsigned long long)(j_dom ? axc : rc) * nc + (j_dom ? rc : axc);
        c_lo[u] = valid[u] ? __ldg(colors + ci) : 0;
        // at s = 1 the tap past the last line is outside, as for the DEM
        c_hi[u] = (valid[u] && rc + 1u < (unsigned)s * n_cross)
                      ? __ldg(colors + ci + cstep)
                      : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int sl = warp + (i0 + u) * WARPS;
      float fl, h_lo, h_hi;
      hats(pos[u], fl, h_lo, h_hi);
      const float z = __fmaf_rn(h_hi, z_hi[u], __fmul_rn(h_lo, z_lo[u]));
      // an invalid step divides by 1 and its result is dropped
      const float d = valid[u] ? dm[u] : 1.0f;
      const float res = __fmaf_rn(-d, curv, __fdiv_rn(__fsub_rn(z, vz), d));
      s_out[sl][lane] = valid[u] ? res : NEG_BIG;
      if (TEX) {
        float flc, hc_lo, hc_hi;
        hats(__fmul_rn(pos[u], (float)s), flc, hc_lo, hc_hi);
        int texv = 0;
#pragma unroll
        for (int sh = 0; sh <= 16; sh += 8) {                 // B, G, R
          const float v =
              __fmaf_rn(hc_hi, (float)((c_hi[u] >> sh) & 0xff),
                        __fmul_rn(hc_lo, (float)((c_lo[u] >> sh) & 0xff)));
          texv |= (int)fminf(fmaxf(rintf(v), 0.0f), 255.0f) << sh;
        }
        s_tex[sl][lane] = valid[u] ? texv : 0;
      }
    }
  }
  __syncthreads();

  // the transpose: a warp writes 32 consecutive steps of one column
  for (int c = warp; c < COLS && w0 + c < W; c += WARPS) {
    const long long row = (long long)(w0 + c) * K;
#pragma unroll
    for (int sb = 0; sb < STEPS; sb += 32) {
      const int m = m0 + sb + lane;
      if (m < K) {
        out[row + m] = s_out[sb + lane][c];
        if (TEX) tex_out[row + m] = s_tex[sb + lane][c];
      }
    }
  }
}

template <bool TEX, bool BAND>
int launch(const void* dem, int n, int nj, int j_off, float j_hi,
           long long dem_bstride, const void* colors, int s,
           long long color_bstride, const void* pcol, const void* fscal,
           int B, int W, int K, void* out, void* tex, void* stream) {
  if (B <= 0 || W <= 0 || K <= 0) return (int)cudaGetLastError();
  const unsigned col_tiles = ((unsigned)W + COLS - 1) / COLS;
  const unsigned step_tiles = ((unsigned)K + STEPS - 1) / STEPS;
  // the step tiles ride on gridDim.y; the columns' constants are read as
  // two 16-byte vectors
  if (step_tiles > 65535u || ((uintptr_t)pcol & 15u))
    return (int)cudaErrorInvalidValue;
  // the viewpoints ride on gridDim.z, at most MAX_Z a launch
  auto kernel = B > 1 ? window_march_kernel<TEX, true, BAND>
                      : window_march_kernel<TEX, false, BAND>;
  for (long long b0 = 0; b0 < B; b0 += MAX_Z) {
    const unsigned nb = (unsigned)(B - b0 < MAX_Z ? B - b0 : MAX_Z);
    const long long wk = b0 * W * K;
    kernel<<<dim3(col_tiles, step_tiles, nb), dim3(32, WARPS), 0,
           (cudaStream_t)stream>>>(
            (const float*)dem + b0 * dem_bstride, n, nj, j_off, j_hi,
            dem_bstride,
            TEX ? (const int*)colors + b0 * color_bstride : nullptr, s,
            color_bstride, (const float*)pcol + b0 * W * PCOL,
            (const float*)fscal + b0 * 4, W, K, (float*)out + wk,
            TEX ? (int*)tex + wk : nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

}  // namespace

// dem: (n, n) float32 at dem + b * dem_bstride for viewpoint b (0: shared);
// pcol (B, W, 8), fscal (B, 4), out (B, W, K)
extern "C" int hz_window_march(const void* dem, int n, long long dem_bstride,
                               const void* pcol, const void* fscal, int B,
                               int W, int K, void* out, void* stream) {
  return launch<false, false>(dem, n, n, 0, 0.0f, dem_bstride, nullptr, 1, 0,
                              pcol, fscal, B, W, K, out, nullptr, stream);
}

// colors: (s*n, s*n) int32 at colors + b * color_bstride; tex (B, W, K)
extern "C" int hz_window_march_tex(const void* dem, int n,
                                   long long dem_bstride, const void* colors,
                                   int s, long long color_bstride,
                                   const void* pcol, const void* fscal, int B,
                                   int W, int K, void* out, void* tex,
                                   void* stream) {
  return launch<true, false>(dem, n, n, 0, 0.0f, dem_bstride, colors, s,
                             color_bstride, pcol, fscal, B, W, K, out, tex,
                             stream);
}

// a band: dem (nj, ni) float32, global rows j_off .. j_off + nj - 1, valid
// up to global row j_off + j_hi; at dem + b * dem_bstride for viewpoint b
extern "C" int hz_window_march_band(const void* dem, int nj, int ni,
                                    int j_off, float j_hi,
                                    long long dem_bstride, const void* pcol,
                                    const void* fscal, int B, int W, int K,
                                    void* out, void* stream) {
  return launch<false, true>(dem, ni, nj, j_off, j_hi, dem_bstride, nullptr,
                             1, 0, pcol, fscal, B, W, K, out, nullptr,
                             stream);
}

// colors: the band's (s*nj, s*ni) int32 plane, its rows from global 2x row
// s*j_off
extern "C" int hz_window_march_band_tex(
    const void* dem, int nj, int ni, int j_off, float j_hi,
    long long dem_bstride, const void* colors, int s, long long color_bstride,
    const void* pcol, const void* fscal, int B, int W, int K, void* out,
    void* tex, void* stream) {
  return launch<true, true>(dem, ni, nj, j_off, j_hi, dem_bstride, colors, s,
                            color_bstride, pcol, fscal, B, W, K, out, tex,
                            stream);
}

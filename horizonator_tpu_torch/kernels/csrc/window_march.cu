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
// thread of the square march divides (a band's tile order costs one). A
// thread takes its steps four at a time: first the four
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
// the color plane), and the row stride is ni.
//
// A band launch still covers the whole (W, K) grid of samples, but of R
// bands around a viewer most tiles hold no valid sample: a band beyond
// zfar holds none, and a band beside the viewer holds the columns that head
// into it. So a band's tile first votes. Each thread computes the validity
// of its 16 samples (the same positions and the six bounds tests that
// decide each sample in the march, so the vote is exact) into a 16-bit
// mask, and __syncthreads_or decides whether the tile is live. A dead tile
// issues no DEM or color load, no hat and no division, and skips the
// shared-memory transpose, which exists only to turn the column-per-lane
// samples into contiguous stores: its outputs are constants, so its warps
// store NEG_BIG (and 0 colors) straight from registers, 16 bytes a thread,
// two columns' 256 contiguous bytes a warp store. A live tile runs the
// march as below, reading each sample's validity from the mask; where no
// lane of a warp has a valid sample among a group of U steps (the tiles a
// band's edge cuts), the warp skips the group's loads and arithmetic and
// writes NEG_BIG into the shared array. The TPU kernel skipped inactive
// (tile, direction) instances the same way, from flags computed before the
// launch (window.py:836-931); here the vote costs about a quarter of a
// live sample's instructions and needs no pass before the launch. A band
// walks its tiles in column-major order, so that the blocks the hardware
// starts side by side spread a band's live columns over the SMs. The
// square entries keep their code (window_march_kernel): the band's bounds,
// offsets and vote live in the band kernels alone.
//
// What bounds it on the H100. The function's bytes (the DEM cells within
// zfar, the columns' constants, the (W, K) outputs) are a few microseconds
// at 3.35 TB/s, and the square kernel is not held by them: variants
// without the DEM loads or without the stores ran about as long. It is
// held by instruction throughput and the length of a thread's dependent
// chain: about 65 machine instructions per sample (six bounds tests, the
// hats, the IEEE division, 64-bit index arithmetic), 16 samples per thread
// in four rounds, behind a launch and a first load of the constants that
// cost as much as a write-only pass over the outputs. A band launch pays
// that chain only in its live tiles, but a live tile's chain is as long as
// ever (the constants, the vote, four rounds, the transpose), and with
// fewer live blocks on an SM less of it is hidden: a band beside the
// viewer, with two fifths of its tiles live, runs about as long as the
// square march, held by its slowest live blocks. Its dead tiles cost the
// vote and the write of their outputs: a band beyond zfar runs at a little
// more than a write-only pass. Splitting a tile over more warps or fewer
// steps, loading more steps at once or a round ahead, a bounds-only
// liveness test and other tile orders did not shorten a live band
// (PERF.md). A transposed copy of the DEM and the color
// plane for the column-dominant half would take out sectors, which are not
// what holds the kernel. Nor do tensor cores or TMA serve it: each sample
// is a two-tap gather and a division, with no matrix product, and the
// stores are already whole sectors.

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

// A dead tile's outputs: NEG_BIG, and 0 for the colors, written straight
// from registers over the tile's (<= COLS, <= STEPS) block of (W, K), 16
// bytes a thread where K and the outputs' alignment allow (a warp then
// writes two columns' 256 contiguous bytes), else 4 (half a column's 128).
template <bool TEX>
__device__ __forceinline__ void store_dead(float* __restrict__ out,
                                           int* __restrict__ tex_out,
                                           int w0, int m0, int W, int K) {
  const int tid = threadIdx.y * 32 + threadIdx.x;
  const int nc = W - w0 < COLS ? W - w0 : COLS;
  const bool vec = (K & 3) == 0 && ((uintptr_t)out & 15u) == 0 &&
                   (!TEX || ((uintptr_t)tex_out & 15u) == 0);
  if (vec) {
    constexpr int V = STEPS / 4;    // 16-byte vectors of a tile's column
    const float4 nb = make_float4(NEG_BIG, NEG_BIG, NEG_BIG, NEG_BIG);
#pragma unroll
    for (int i = tid; i < COLS * V; i += 32 * WARPS) {
      const int c = i / V, m = m0 + 4 * (i % V);
      if (c < nc && m < K) {
        const long long o = (long long)(w0 + c) * K + m;
        *reinterpret_cast<float4*>(out + o) = nb;
        if (TEX) *reinterpret_cast<int4*>(tex_out + o) = make_int4(0, 0, 0, 0);
      }
    }
  } else {
#pragma unroll 4
    for (int i = tid; i < COLS * STEPS; i += 32 * WARPS) {
      const int c = i / STEPS, m = m0 + i % STEPS;
      if (c < nc && m < K) {
        const long long o = (long long)(w0 + c) * K + m;
        out[o] = NEG_BIG;
        if (TEX) tex_out[o] = 0;
      }
    }
  }
}

// pcol: (W, 8) float32 per column: a, t, e, scale, axis0, sign, j_dom, 0.
// fscal: (4,) float32: viewer z, znear, zfar, curvature coefficient.
// n: the grid's columns (its edge, square); BAND: nj rows from global row
// j_off, valid up to j_off + j_hi.
template <bool TEX, bool BATCH, bool BAND>
__device__ __forceinline__ void march_tile(
    const float* __restrict__ dem, int n, int nj, int j_off, float j_hi,
    long long dem_bstride, const int* __restrict__ colors, int s,
    long long color_bstride, const float* __restrict__ pcol,
    const float* __restrict__ fscal, int W, int K, float* __restrict__ out,
    int* __restrict__ tex_out) {
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
  int tile_w = blockIdx.x, tile_m = blockIdx.y;
  if (BAND) {
    // the tiles in column-major order: the blocks that the hardware hands
    // out together take the step tiles of one column tile, so a band's
    // live tiles (a range of columns) spread over the SMs instead of
    // filling some of them
    const unsigned l = blockIdx.y * gridDim.x + blockIdx.x;
    tile_w = l / gridDim.y;
    tile_m = l % gridDim.y;
  }
  const int w0 = tile_w * COLS, m0 = tile_m * STEPS;
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

  // a band's liveness: bit i of `live` is the validity of the thread's
  // step m0 + warp + i*WARPS, by the same operations and tests as the
  // march below. A tile with no valid sample writes its outputs and stops.
  unsigned live = 0;
  if (BAND) {
#pragma unroll
    for (int i = 0; i < STEPS / WARPS; ++i) {
      const int m = m0 + warp + i * WARPS;
      const float mf = (float)m;
      const float p = __fmaf_rn(mf, t, a);
      const float axis_m = __fadd_rn(axis0, __fmul_rn(mf, sgn));
      const float d = __fmul_rn(__fadd_rn(mf, e), scale);
      live |= (unsigned)(w < W && m < K && axis_m >= ax_lo &&
                         axis_m <= ax_hi && p >= cr_lo && p <= cr_hi &&
                         d >= znear && d <= zfar)
              << i;
    }
    if (!__syncthreads_or(live != 0)) {
      store_dead<TEX>(out, tex_out, w0, m0, W, K);
      return;
    }
  }

  // U steps at a time: first every step's position, validity and loads
  // (no load waits for another), then the arithmetic on what arrived
#pragma unroll 1
  for (int i0 = 0; i0 < STEPS / WARPS; i0 += U) {
    if (BAND && !__any_sync(0xffffffffu, (live >> i0) & ((1u << U) - 1))) {
      // no lane of the warp has a valid sample among these U steps
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int sl = warp + (i0 + u) * WARPS;
        s_out[sl][lane] = NEG_BIG;
        if (TEX) s_tex[sl][lane] = 0;
      }
      continue;
    }
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
        valid[u] = (live >> (i0 + u)) & 1u;
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

#define MARCH_PARAMS                                                        \
  const float *__restrict__ dem, int n, int nj, int j_off, float j_hi,      \
      long long dem_bstride, const int *__restrict__ colors, int s,         \
      long long color_bstride, const float *__restrict__ pcol,              \
      const float *__restrict__ fscal, int W, int K, float *__restrict__ out, \
      int *__restrict__ tex_out
#define MARCH_ARGS                                                          \
  dem, n, nj, j_off, j_hi, dem_bstride, colors, s, color_bstride, pcol,     \
      fscal, W, K, out, tex_out

template <bool TEX, bool BATCH>
__global__ void __launch_bounds__(32 * WARPS)
window_march_kernel(MARCH_PARAMS) {
  march_tile<TEX, BATCH, false>(MARCH_ARGS);
}

template <bool BATCH>
__global__ void __launch_bounds__(32 * WARPS)
window_march_band_kernel(MARCH_PARAMS) {
  march_tile<false, BATCH, true>(MARCH_ARGS);
}

// A band's 1152 tiles at 4096 x 576 are resident in one wave at 9 blocks
// an SM: 56 registers a thread, which the textured band's vote would pass
// otherwise (64 registers, two waves, slower: PERF.md).
template <bool BATCH>
__global__ void __launch_bounds__(32 * WARPS, 9)
window_march_band_tex_kernel(MARCH_PARAMS) {
  march_tile<true, BATCH, true>(MARCH_ARGS);
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
  auto kernel = !BAND ? (B > 1 ? window_march_kernel<TEX, true>
                               : window_march_kernel<TEX, false>)
                : TEX ? (B > 1 ? window_march_band_tex_kernel<true>
                               : window_march_band_tex_kernel<false>)
                      : (B > 1 ? window_march_band_kernel<true>
                               : window_march_band_kernel<false>);
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

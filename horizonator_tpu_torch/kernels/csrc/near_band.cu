// Near band: the n_near bilinear samples of every image column between
// znear and the column's first surviving grid crossing.
//
// It replaces no TPU kernel. The JAX package samples the near band in jnp
// glue (horizonator_tpu/render/window.py:1024-1114) that XLA fuses on the
// TPU; the port did it in ~145 torch passes a render or a batch (the
// float64 emulation of fmaf, int64 index casts, four gathers), then
// copied the whole (W, n_near + K) field with torch.cat to put the band in
// front of the march's crossings. Here one launch computes the band and
// writes it into lanes [0, n_near) of the field whose lanes [n_near,
// n_near + K) the window march writes (its entries take a row stride), so
// the field is assembled in place and nothing is copied.
//
// Per viewpoint b and column w, the plain version's float32 operations in
// its order (kernels/near_band.py::near_band_plain), each rounded once:
//
//   near_hi = max((max(ceil(znear / scale - e), 0) + e) * scale, znear)
//   d_q     = max(znear + q * ((near_hi - znear) * (1/n_near)), 1e-3)
//   i_q     = vci + d_q * sin(az) / cell_e,  j_q = vcj + d_q * cos(az) * (1/cell_n)
//   valid   = the grid's (or band's) bounds, [znear, zfar], d_q < near_hi
//   z_q     = the patch form: the 2 x 2 taps of the viewer-centred patch
//             around (i_q, j_q), each rint(2 z) * 0.5, hat-weighted as
//             fma(hat_j1, acc1, hat_j0 * acc0) with acc = hat_i0 * c0 +
//             hat_i1 * c1; or the gather form (patch_n 0, a patch that
//             would not fit): the 2 x 2 cells around it, each
//             clip(rint(2 z), -32768, 32767) * 0.5, lerped in i, then j
//   out     = fma(-d_q, curv, (z_q - vz) / d_q), or NEG_BIG where invalid
//
// fmaf is __fmaf_rn (the build passes --fmad=false, so no other product
// is fused), divisions are IEEE (__fdiv_rn), rint is torch.round, sinf and
// cosf are the CUDA library's own as in torch's sin and cos; torch.clamp
// and torch.maximum keep a NaN, so their counterparts here do too. In the
// patch form the samples that are valid but outside the patch are counted
// into dropped[b] and made invalid. A grid below ALIGN_MIN_N rows or
// columns (kernels/near_band.py) reads zeros past its last row and column,
// out to (nj_pad, ni_pad), as the plain version's zero padding.
//
// Forms, from the inputs alone: one (nj, ni) grid that every viewpoint
// reads (dem_bstride 0) or one per viewpoint (the LOD levels' crops); a
// row band (region sharding) whose row 0 is global row j_off, rows valid
// up to j_off + j_hi, so i_q, j_q and d_q stay global and only the
// addresses and the row bounds shift; the patch form or the gather form.
// Textured marches also get d_q, i_q and the global j_q as (B, W, n_near)
// outputs, for the near band's colours and the hybrid near field.
//
// Thread mapping. One block per viewpoint, a thread per column (a block of
// up to 1024 threads loops over the columns), so dropped[b] is one block
// reduction (warp shuffles, then one warp over the warps' sums): no
// memset, no atomics, the same count every run. A thread's n_near samples
// share the column's trigonometry and near_hi; at n_near 4 and a 16-byte
// aligned row they leave as one 16-byte store.
//
// What bounds it on the H100. At pano-single's shape (B 1, W 4096, n_near
// 4, a 16 x 16 patch) it must move ~0.15 MB: the columns' az, e and scale,
// the patch's cells, near_hi and the (W, 4) tangents, 0.05 us at 3.35
// TB/s; ~150 float32 operations a sample (two library trig calls a
// column, three IEEE divisions a sample) are ~10 M, 0.15 us at 67 TFLOP/s.
// Neither holds it: one block on one SM runs the whole single render, so
// it is latency, a chain of ~600 dependent instructions a column over
// four columns a thread, a few microseconds. That is what the design
// accepts: a render is held by the host's launches (the device idles
// ~90%), and what this kernel removes is ~145 of them; more blocks a
// viewpoint would need a second pass or a zeroed counter for dropped.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the per-viewpoint scalars: a pointer and a stride in elements between
// viewpoints each (0: one value for the batch), the C interface's struct
enum { VCI, VCJ, VZ, ZNEAR, ZFAR, CURV, CELL_E, CELL_N, N_SCALARS };

struct Scalars {
  const float* ptr[N_SCALARS];
  long long stride[N_SCALARS];
};

namespace {

constexpr float NEG_BIG = -3.0e38f;
constexpr int MAX_THREADS = 1024;

// torch.clamp(x, min=lo) and torch.maximum: a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float maximum(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}
// relu(1 - |x - r|)
__device__ __forceinline__ float hat(float x, float r) {
  return clamp_min(__fsub_rn(1.0f, fabsf(__fsub_rn(x, r))), 0.0f);
}

struct Band {
  const float* dem;   // this viewpoint's (nj, ni) grid
  int nj, ni;         // its rows and columns; zeros past them
  int j_off;          // global row of row 0
  float j_hi;         // rows valid up to j_off + j_hi (band-local j_hi)
  int patch_n;        // the patch's edge, 0: the gather form
  int oi, oj;         // the patch's corner (band-local rows)
};

__device__ __forceinline__ float cell(const Band& g, int row, int col) {
  return (row < g.nj && col < g.ni)
             ? __ldg(g.dem + (long long)row * g.ni + col) : 0.0f;
}

// One sample: its tangent (NEG_BIG where invalid) and whether it was valid
// but outside the patch.
__device__ __forceinline__ float sample(const Band& g, float d, float iq,
                                        float jl, float nh, float znear,
                                        float zfar, float vz, float curv,
                                        bool& drop) {
  bool vq = iq >= 0.0f && iq <= (float)(g.ni - 1) && jl >= 0.0f &&
            jl <= g.j_hi && d >= znear && d <= zfar && d < nh;
  drop = false;
  float zq;
  if (g.patch_n) {
    const float ir = __fsub_rn(iq, (float)g.oi);
    const float jr = __fsub_rn(jl, (float)g.oj);
    const float last = (float)(g.patch_n - 1);
    const bool in_patch = ir >= 0.0f && ir <= last && jr >= 0.0f &&
                          jr <= last;
    drop = vq && !in_patch;
    vq = vq && in_patch;
    if (!vq) return NEG_BIG;
    const float u0 = floorf(ir), v0 = floorf(jr);
    const float u1 = __fadd_rn(u0, 1.0f), v1 = __fadd_rn(v0, 1.0f);
    // in the patch the clamps of the plain version's indices are no-ops
    const int r0 = g.oj + (int)v0, c0 = g.oi + (int)u0;
    const int r1 = g.oj + (int)clamp(v1, 0.0f, last);
    const int c1 = g.oi + (int)clamp(u1, 0.0f, last);
    const float z00 = __fmul_rn(rintf(__fmul_rn(cell(g, r0, c0), 2.0f)), 0.5f);
    const float z01 = __fmul_rn(rintf(__fmul_rn(cell(g, r0, c1), 2.0f)), 0.5f);
    const float z10 = __fmul_rn(rintf(__fmul_rn(cell(g, r1, c0), 2.0f)), 0.5f);
    const float z11 = __fmul_rn(rintf(__fmul_rn(cell(g, r1, c1), 2.0f)), 0.5f);
    const float hx0 = hat(ir, u0), hx1 = hat(ir, u1);
    const float acc0 = __fadd_rn(__fmul_rn(hx0, z00), __fmul_rn(hx1, z01));
    const float acc1 = __fadd_rn(__fmul_rn(hx0, z10), __fmul_rn(hx1, z11));
    zq = __fmaf_rn(hat(jr, v1), acc1, __fmul_rn(hat(jr, v0), acc0));
  } else {
    if (!vq) return NEG_BIG;
    // torch's clamp to [0, n - 2]; a grid of one row or column indexes -1,
    // which torch wraps to the last
    int i0 = (int)clamp(floorf(iq), 0.0f, (float)(g.ni - 2));
    int j0 = (int)clamp(floorf(jl), 0.0f, (float)(g.nj - 2));
    const float fi = clamp(__fsub_rn(iq, (float)i0), 0.0f, 1.0f);
    const float fj = clamp(__fsub_rn(jl, (float)j0), 0.0f, 1.0f);
    const int i1 = i0 + 1, j1 = j0 + 1;
    if (i0 < 0) i0 += g.ni;
    if (j0 < 0) j0 += g.nj;
    auto q16 = [&](int row, int col) {
      return __fmul_rn(clamp(rintf(__fmul_rn(cell(g, row, col), 2.0f)),
                             -32768.0f, 32767.0f), 0.5f);
    };
    const float z00 = q16(j0, i0), z01 = q16(j0, i1);
    const float z10 = q16(j1, i0), z11 = q16(j1, i1);
    const float ztop = __fadd_rn(z00, __fmul_rn(__fsub_rn(z01, z00), fi));
    const float zbot = __fadd_rn(z10, __fmul_rn(__fsub_rn(z11, z10), fi));
    zq = __fadd_rn(ztop, __fmul_rn(__fsub_rn(zbot, ztop), fj));
  }
  return __fmaf_rn(-d, curv, __fdiv_rn(__fsub_rn(zq, vz), d));
}

// N: n_near known at compile time (4, the 16-byte stores), or 0 (any).
template <int N>
__global__ void __launch_bounds__(MAX_THREADS) near_band_kernel(
    const float* __restrict__ dem, int nj, int ni, long long dem_bstride,
    int nj_pad, int ni_pad, int j_off, float j_hi, int patch_n,
    const float* __restrict__ az, const float* __restrict__ e,
    const float* __restrict__ scale, Scalars s, int W, int n_near,
    float recip_q, float* __restrict__ out, long long ld,
    float* __restrict__ near_hi, int* __restrict__ dropped,
    float* __restrict__ dq_out, float* __restrict__ iq_out,
    float* __restrict__ jq_out) {
  const long long b = blockIdx.x;
  float v[N_SCALARS];
#pragma unroll
  for (int k = 0; k < N_SCALARS; ++k)
    v[k] = __ldg(s.ptr[k] + b * s.stride[k]);
  const float vci = v[VCI], vcj = v[VCJ], vz = v[VZ], znear = v[ZNEAR];
  const float zfar = v[ZFAR], curv = v[CURV], cell_e = v[CELL_E];
  const float recip_n = __fdiv_rn(1.0f, v[CELL_N]);
  const int nq = N ? N : n_near;

  Band g;
  g.dem = dem + b * dem_bstride;
  g.nj = nj;
  g.ni = ni;
  g.j_off = j_off;
  g.j_hi = j_hi;
  g.patch_n = patch_n;
  g.oi = g.oj = 0;
  if (patch_n) {
    // the viewer-centred patch's corner, clipped into the padded grid; a
    // band's row is band-local
    const float vj = j_off ? __fsub_rn(vcj, (float)j_off) : vcj;
    const int half = patch_n / 2 - 1;
    g.oi = min(max((int)floorf(vci) - half, 0), ni_pad - patch_n);
    g.oj = min(max((int)floorf(vj) - half, 0), nj_pad - patch_n);
  }
  const long long col0 = b * W;
  out += col0 * ld;
  const bool vec = N == 4 && (ld & 3) == 0 && ((uintptr_t)out & 15u) == 0;
  const bool tex = dq_out != nullptr;

  int drops = 0;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const long long c = col0 + w;
    const float a = __ldg(az + c), ee = __ldg(e + c), sc = __ldg(scale + c);
    const float s_az = sinf(a), c_az = cosf(a);
    const float m_star =
        clamp_min(ceilf(__fsub_rn(__fdiv_rn(znear, sc), ee)), 0.0f);
    const float nh = maximum(__fmul_rn(__fadd_rn(m_star, ee), sc), znear);
    near_hi[c] = nh;
    const float step = __fmul_rn(__fsub_rn(nh, znear), recip_q);
    float t[N ? N : 1];
    for (int q = 0; q < nq; ++q) {
      const float d =
          clamp_min(__fadd_rn(znear, __fmul_rn((float)q, step)), 1e-3f);
      const float iq = __fadd_rn(vci, __fdiv_rn(__fmul_rn(d, s_az), cell_e));
      const float jq = __fadd_rn(vcj, __fmul_rn(__fmul_rn(d, c_az), recip_n));
      const float jl = __fsub_rn(jq, (float)j_off);
      bool drop;
      const float r = sample(g, d, iq, jl, nh, znear, zfar, vz, curv, drop);
      drops += drop;
      if (N)
        t[q] = r;
      else
        out[(long long)w * ld + q] = r;
      if (tex) {
        const long long o = c * nq + q;
        dq_out[o] = d;
        iq_out[o] = iq;
        jq_out[o] = jq;
      }
    }
    if (N) {
      if (vec) {
        *reinterpret_cast<float4*>(out + (long long)w * ld) =
            make_float4(t[0], t[1], t[2], t[3]);
      } else {
#pragma unroll
        for (int q = 0; q < (N ? N : 1); ++q) out[(long long)w * ld + q] = t[q];
      }
    }
  }

  // dropped[b]: the block's sum
  __shared__ int warp_sums[MAX_THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) drops += __shfl_down_sync(0xffffffffu, drops, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = drops;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    int x = lane < nw ? warp_sums[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) dropped[b] = x;
  }
}

}  // namespace

// dem: (nj, ni) float32 at dem + b * dem_bstride for viewpoint b (0:
// shared), read as zeros out to (nj_pad, ni_pad); az, e, scale: (B, W);
// out: lanes [0, n_near) of rows with stride ld, viewpoint b's W rows from
// out + b * W * ld; near_hi (B, W); dropped (B,) int32; dq, iq, jq: (B, W,
// n_near) or null.
extern "C" int hz_near_band(const void* dem, int nj, int ni,
                            long long dem_bstride, int nj_pad, int ni_pad,
                            int j_off, float j_hi, int patch_n,
                            const void* az, const void* e, const void* scale,
                            Scalars s, int B, int W, int n_near,
                            float recip_q, void* out, long long ld,
                            void* near_hi, void* dropped, void* dq, void* iq,
                            void* jq, void* stream) {
  if (B <= 0 || W <= 0 || n_near <= 0) return (int)cudaErrorInvalidValue;
  const int threads =
      W >= MAX_THREADS ? MAX_THREADS : (W + 31) / 32 * 32;
  auto kernel = n_near == 4 ? near_band_kernel<4> : near_band_kernel<0>;
  kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      (const float*)dem, nj, ni, dem_bstride, nj_pad, ni_pad, j_off, j_hi,
      patch_n, (const float*)az, (const float*)e, (const float*)scale, s, W,
      n_near, recip_q, (float*)out, ld, (float*)near_hi, (int*)dropped,
      (float*)dq, (float*)iq, (float*)jq);
  return (int)cudaGetLastError();
}

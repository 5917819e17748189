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
//         (along row `axis` for N/S rays, column `axis` for E/W rays)
//   out = fma(-d, curv, (z - vz)/d), or NEG_BIG outside the grid or
//         [znear, zfar]
//
// Every operation is the JAX kernel's, in its order, with explicit
// round-to-nearest intrinsics; the build passes --fmad=false so that the
// only fused multiply-adds are the ones written here, the ones that XLA
// contracts in the JAX kernel (its `a + mf*t`, its hat accumulations
// `acc + hat*w` and its curvature term `q - dm*curv`). The hat form's
// non-support terms are exact zeros, so the sample equals the JAX kernel's
// sum bit for bit.
//
// Textured entry: the same sample also reads two texels of a packed
// 0x00RRGGBB (s*n, s*n) int32 plane, s = 1 (cell) or 2 (half-cell), at
// line s*axis and cross positions floor(s*pos) + {0, 1}, weighted by the
// hats at s*pos, and writes the rounded (half to even), clipped u8 channels
// packed again; 0 where the sample is invalid. The TPU kernel's hats are
// window-relative (s*(pos - o) - r); with o an integer both subtractions are
// exact, so the absolute form here gives the same weights.
//
// What bounds it on the H100: two 4-byte reads per sample from a DEM that
// stays in the 50 MB L2 (46 MB at a 3400^2 grid), two more from the color
// plane when textured (185 MB at the 6800^2 half-cell plane: those miss
// L2); ~20 flops (textured: ~40). Threads run along the step axis of one
// column, so N/S rays read along a row (near-contiguous) while E/W rays
// stride by a whole row per step. A transposed copy for the E/W directions
// is the later fix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -3.0e38f;

__device__ __forceinline__ void hats(float x, float& fl, float& h_lo,
                                     float& h_hi) {
  fl = floorf(x);
  h_lo = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(x, fl))), 0.0f);
  h_hi = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(x, __fadd_rn(fl, 1.0f)))),
               0.0f);
}

// pcol: (W, 8) float32 per column: a, t, e, scale, axis0, sign, j_dom, 0.
// fscal: (4,) float32: viewer z, znear, zfar, curvature coefficient.
template <bool TEX>
__global__ void window_march_kernel(const float* __restrict__ dem, int n,
                                    const int* __restrict__ colors, int s,
                                    const float* __restrict__ pcol,
                                    const float* __restrict__ fscal, int W,
                                    int K, float* __restrict__ out,
                                    int* __restrict__ tex_out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)W * K) return;
  const int w = (int)(idx / K);
  const int m = (int)(idx - (long long)w * K);
  const float* pc = pcol + 8 * w;
  const float a = pc[0], t = pc[1], e = pc[2], scale = pc[3];
  const float axis0 = pc[4], sgn = pc[5];
  const bool j_dom = pc[6] != 0.0f;
  const float vz = fscal[0], znear = fscal[1], zfar = fscal[2];
  const float curv = fscal[3];

  const float mf = (float)m;
  const float pos = __fmaf_rn(mf, t, a);
  const float axis_m = __fadd_rn(axis0, __fmul_rn(mf, sgn));
  const float dm = __fmul_rn(__fadd_rn(mf, e), scale);
  const float hi = (float)(n - 1);
  const bool valid = axis_m >= 0.0f && axis_m <= hi && pos >= 0.0f &&
                     pos <= hi && dm >= znear && dm <= zfar;
  float res = NEG_BIG;
  int texv = 0;
  if (valid) {
    float fl, h_lo, h_hi;
    hats(pos, fl, h_lo, h_hi);
    const int r = (int)fl;
    const int ax = (int)axis_m;
    const long long step = j_dom ? 1 : n;
    const long long i_lo =
        j_dom ? (long long)ax * n + r : (long long)r * n + ax;
    const float z_lo = __ldg(dem + i_lo);
    // pos == n-1 exactly: the upper tap lies outside the grid with weight 0
    const float z_hi = (r + 1 < n) ? __ldg(dem + i_lo + step) : 0.0f;
    const float z = __fmaf_rn(h_hi, z_hi, __fmul_rn(h_lo, z_lo));
    res = __fmaf_rn(-dm, curv, __fdiv_rn(__fsub_rn(z, vz), dm));
    if (TEX) {
      const int nc = s * n;
      float flc, hc_lo, hc_hi;
      hats(__fmul_rn(pos, (float)s), flc, hc_lo, hc_hi);
      const int rc = (int)flc;
      const int axc = s * ax;
      const long long cstep = j_dom ? 1 : nc;
      const long long c_lo_i =
          j_dom ? (long long)axc * nc + rc : (long long)rc * nc + axc;
      const int c_lo = __ldg(colors + c_lo_i);
      // at s = 1 the tap past pos == n-1 is outside, as for the DEM
      const int c_hi = (rc + 1 < nc) ? __ldg(colors + c_lo_i + cstep) : 0;
#pragma unroll
      for (int sh = 0; sh <= 16; sh += 8) {                 // B, G, R
        const float v =
            __fmaf_rn(hc_hi, (float)((c_hi >> sh) & 0xff),
                      __fmul_rn(hc_lo, (float)((c_lo >> sh) & 0xff)));
        texv |= (int)fminf(fmaxf(rintf(v), 0.0f), 255.0f) << sh;
      }
    }
  }
  out[idx] = res;
  if (TEX) tex_out[idx] = texv;
}

template <bool TEX>
int launch(const void* dem, int n, const void* colors, int s,
           const void* pcol, const void* fscal, int W, int K, void* out,
           void* tex, void* stream) {
  const int threads = 256;
  const long long total = (long long)W * K;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (total > 0) {
    window_march_kernel<TEX><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)dem, n, (const int*)colors, s, (const float*)pcol,
        (const float*)fscal, W, K, (float*)out, (int*)tex);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hz_window_march(const void* dem, int n, const void* pcol,
                               const void* fscal, int W, int K, void* out,
                               void* stream) {
  return launch<false>(dem, n, nullptr, 1, pcol, fscal, W, K, out, nullptr,
                       stream);
}

extern "C" int hz_window_march_tex(const void* dem, int n,
                                   const void* colors, int s,
                                   const void* pcol, const void* fscal, int W,
                                   int K, void* out, void* tex,
                                   void* stream) {
  return launch<true>(dem, n, colors, s, pcol, fscal, W, K, out, tex,
                      stream);
}

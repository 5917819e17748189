// Window march: the far-field crossing samples of every image column.
//
// Replaces horizonator_tpu/render/window.py::_window_kernel (untextured).
// The TPU kernel staged a (window, 128-step) slab of a per-render crossing
// table into VMEM and evaluated the 2-tap lerp as a dense hat contraction,
// because gathers were the TPU's slow path. On Hopper a gather from L2 is
// cheap, so each thread reads its two taps straight from the (n, n) DEM:
//
//   pos = fma(m, t, a), axis = axis0 + m*sign, d = (m + e) * scale
//   z   = fma(h_hi, dem[floor(pos) + 1], h_lo * dem[floor(pos)])
//         (along row `axis` for N/S rays, column `axis` for E/W rays)
//   out = fma(-d, curv, (z - vz)/d), or NEG_BIG outside the grid or
//         [znear, zfar]
//
// Every operation is the JAX kernel's, in its order, with explicit
// round-to-nearest intrinsics; the build passes --fmad=false so that the
// only fused multiply-adds are the three written here, the three that XLA
// contracts in the JAX kernel (its `a + mf*t`, its hat accumulation
// `acc + hat*w` and its curvature term `q - dm*curv`). The hat form's
// non-support terms are exact zeros, so the sample equals the JAX kernel's
// sum bit for bit.
//
// What bounds it on the H100: two 4-byte reads per sample from a DEM that
// stays in the 50 MB L2 (46 MB at a 3400^2 grid); the arithmetic is ~20
// flops. Threads run along the step axis of one column, so N/S rays read
// along a row (near-contiguous) while E/W rays stride by a whole row per
// step. A transposed DEM copy for the E/W directions is the later fix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_BIG = -3.0e38f;

// pcol: (W, 8) float32 per column: a, t, e, scale, axis0, sign, j_dom, 0.
// fscal: (4,) float32: viewer z, znear, zfar, curvature coefficient.
__global__ void window_march_kernel(const float* __restrict__ dem, int n,
                                    const float* __restrict__ pcol,
                                    const float* __restrict__ fscal, int W,
                                    int K, float* __restrict__ out) {
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
  if (valid) {
    const float fl = floorf(pos);
    const int r = (int)fl;
    const int ax = (int)axis_m;
    const float h_lo = fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, fl))), 0.0f);
    const float h_hi =
        fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(pos, __fadd_rn(fl, 1.0f)))),
              0.0f);
    const long long step = j_dom ? 1 : n;
    const long long i_lo =
        j_dom ? (long long)ax * n + r : (long long)r * n + ax;
    const float z_lo = __ldg(dem + i_lo);
    // pos == n-1 exactly: the upper tap lies outside the grid with weight 0
    const float z_hi = (r + 1 < n) ? __ldg(dem + i_lo + step) : 0.0f;
    const float z = __fmaf_rn(h_hi, z_hi, __fmul_rn(h_lo, z_lo));
    res = __fmaf_rn(-dm, curv, __fdiv_rn(__fsub_rn(z, vz), dm));
  }
  out[idx] = res;
}

}  // namespace

extern "C" int hz_window_march(const void* dem, int n, const void* pcol,
                               const void* fscal, int W, int K, void* out,
                               void* stream) {
  const int threads = 256;
  const long long total = (long long)W * K;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (total > 0) {
    window_march_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)dem, n, (const float*)pcol, (const float*)fscal, W, K,
        (float*)out);
  }
  return (int)cudaGetLastError();
}

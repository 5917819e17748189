// Roll-ceiling probes: `stages` rounds of a circular compare-exchange on
// every row of a (W, m) int32 array.
//
// Replaces benchmarks/profile_roll_ceiling.py::make_minmax (:38) and
// ::make_kv (:62), the TPU's per-stage ceiling probes for a merge-based
// resolve. Per row, for stage s (lane i in [0, m)):
//
//   d   = 1 << (s % 10)
//   fwd = x[(i + d % m) % m], bwd = x[(i - d % m) % m]  (pltpu.roll with
//         jnp.roll semantics: circular within the row)
//   low = (i & d) == 0                                  (d itself, not d % m)
//   minmax: x = low ? min(x, fwd) : max(x, bwd)
//   kv:     k_other, v_other = low ? (fk, fv) : (bk, bv)
//           k_new = low ? min(k, k_other) : max(k, k_other)
//           v = (k_new != k) ? v_other : v; k = k_new   (a tie keeps v)
//
// A lane needs only one partner per stage, fwd when low and bwd otherwise,
// so the partner index is j = low ? i + d % m : i - d % m, wrapped once.
// Compares are signed int32; the result equals the plain version bit for
// bit.
//
// The TPU block of 64 rows served its VMEM; here one block owns one row,
// double-buffered in shared memory (8 bytes per lane, 16 with values), its
// threads striding the lanes, one __syncthreads() per stage: a stage reads
// buffer `cur` and writes `cur ^ 1`, and the barrier after it orders both
// that stage's reads before the next stage's writes into `cur` and its
// writes before the next stage's reads.
//
// What bounds it on the H100: per element-stage the function needs 4 int32
// operations (the lane mask, its test, the min or max and the select
// between them; kv 6: it adds the compare of the new key with the old and
// the select of the value) against only 8 bytes of device memory per
// element for the whole run, so it is bound by operations. This simple
// form spends more than those again on its own bookkeeping (the strided
// loop, the partner index and its wrap, shared-memory addresses) and makes
// three shared-memory accesses per element-stage (own value, partner,
// store; kv five), so it runs several times above the bound (PERF.md's
// kernel table). Register-resident lanes, the wrap hoisted out of the
// lanes that cannot wrap, and warp shuffles for d < 32 are the later fix.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <bool KV>
__global__ void roll_kernel(const int* __restrict__ k_in,
                            const int* __restrict__ v_in,
                            int* __restrict__ k_out, int* __restrict__ v_out,
                            int m, int stages) {
  // keys in [0, 2m) (buffer b at b*m), values in [2m, 4m)
  extern __shared__ int smem[];
  int* const vals = smem + 2 * m;
  const long long row = (long long)blockIdx.x * m;
  for (int i = threadIdx.x; i < m; i += THREADS) {
    smem[i] = k_in[row + i];
    if (KV) vals[i] = v_in[row + i];
  }
  __syncthreads();
  int cur = 0;
  for (int s = 0; s < stages; ++s) {
    const int d = 1 << (s % 10);
    const int dm = d % m;
    const int* kc = smem + cur * m;
    int* kn = smem + (cur ^ 1) * m;
    const int* vc = vals + cur * m;
    int* vn = vals + (cur ^ 1) * m;
    for (int i = threadIdx.x; i < m; i += THREADS) {
      const bool low = (i & d) == 0;
      int j = low ? i + dm : i - dm;
      if (j >= m) j -= m;
      if (j < 0) j += m;
      const int x = kc[i];
      const int o = kc[j];
      const int y = low ? min(x, o) : max(x, o);
      kn[i] = y;
      if (KV) vn[i] = y != x ? vc[j] : vc[i];
    }
    __syncthreads();
    cur ^= 1;
  }
  for (int i = threadIdx.x; i < m; i += THREADS) {
    k_out[row + i] = smem[cur * m + i];
    if (KV) v_out[row + i] = vals[cur * m + i];
  }
}

template <bool KV>
int launch(const void* k, const void* v, void* ok, void* ov, int W, int m,
           int stages, void* stream) {
  const size_t smem = sizeof(int) * (size_t)m * (KV ? 4 : 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roll_kernel<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0) {
    roll_kernel<KV><<<W, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)k, (const int*)v, (int*)ok, (int*)ov, m, stages);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hz_roll_minmax(const void* x, void* out, int W, int m,
                              int stages, void* stream) {
  return launch<false>(x, nullptr, out, nullptr, W, m, stages, stream);
}

extern "C" int hz_roll_kv(const void* k, const void* v, void* ok, void* ov,
                          int W, int m, int stages, void* stream) {
  return launch<true>(k, v, ok, ov, W, m, stages, stream);
}

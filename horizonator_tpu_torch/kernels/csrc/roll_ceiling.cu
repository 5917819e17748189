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
// A lane needs only one partner per stage, fwd when low and bwd otherwise:
// j = low ? i + d % m : i - d % m, wrapped once. Every stage reads the
// values from before it. Compares are signed int32; the result equals the
// plain version bit for bit.
//
// What bounds it on the H100: operations. Once the stage and a lane's
// place are known when the code is compiled, the lane mask and its test
// are constants, and the two lanes of a pair (i, i + d) need one min and
// one max: 1 int32 operation per lane-stage. kv needs one key compare per
// pair and four selects (two keys, two values): 2.5. At 64 int32 results
// per SM per clock that is 0.0163 / 0.0407 ms at W 4096, m 1664, 40
// stages, against 8 / 16 bytes of device memory per lane for the whole
// run (0.0163 / 0.0326 ms at 3.35 TB/s).
//
// The register kernels (`roll_regs`, m = 32 R with R in kRegRows):
// - A block is one warp and owns a row. Lane i = r*32 + t lives in
//   register r of thread t; R is a template parameter, so every register
//   index is fixed when the code is compiled. Loads and stores are 128
//   contiguous bytes per warp and register. No shared memory, no barrier.
//   At R 52 that is 116 registers (minmax) and 168 (kv), no spills (with
//   four warps a block ptxas chose 96 for minmax and spilled).
// - d >= 32 (d = 32 D): d % m = 32 (D % R), a multiple of 32, so the
//   partner is register (r +- D % R) mod R of the same thread and `low` is
//   (r & D) == 0: both constants. The five stage bodies are unrolled over
//   r. A pair whose lanes point at each other takes one min and one max
//   (kv: swap keys and values when the low key is strictly greater, so a
//   tie keeps both values); a lane whose partner wraps and does not point
//   back takes a one-sided min or max of the old values (m 1664: 128 lanes
//   at d 128 and at d 256, 384 at d 512; m <= 512: every lane at d >= m).
// - d < 32: the partner is always i ^ d, in thread t ^ d, and never wraps
//   (m is a multiple of 32): one __shfl_xor_sync per register (kv: two),
//   then the thread's own (t & d) picks min or max.
// - All ten stage bodies of a round are unrolled (`round_of_ten`), so a
//   stage's results take new registers and no moves run between stages.
// What is left over: the shuffle stages are half of all stages. SHFL runs
// at 32 results per SM per clock against 64 for the integer pipe, so
// minmax needs 0.0163 ms of shuffles alone and kv 0.0326 ms. And a
// thread's choice of min or max there is not a constant: ptxas emits a
// min and a predicated max (two integer instructions per lane), so minmax
// issues 1.5 integer instructions per lane-stage and kv 3.3 (key min/max,
// compare, value select). That integer pipe, not memory, holds the
// kernels: at 0 stages they take what moving the rows takes, and each
// further stage adds its instructions' time (chip_smoke.py phase 11).
//
// The shared-memory kernels (`roll_smem`) take every other m (the general
// path; the wrappers choose by shape only): one block owns one row,
// double-buffered in shared memory (8 bytes per lane, 16 with values), its
// threads striding the lanes, one __syncthreads() per stage: a stage reads
// buffer `cur` and writes `cur ^ 1`, and the barrier after it orders both
// that stage's reads before the next stage's writes into `cur` and its
// writes before the next stage's reads. It spends a strided loop, the
// partner index and its wrap, three shared-memory accesses (kv five) and a
// barrier per lane-stage: several times the register kernels' time
// (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;       // shared-memory kernels: a block per row
// rows of m = 32 R lanes that take the register kernels: the probe's
// m 1664 (R 52), the powers of two up to 2048 and the edge shapes 96, 416
constexpr int kRegRows[] = {1, 2, 3, 4, 8, 13, 16, 32, 52, 64};
constexpr int kNumRegRows = sizeof(kRegRows) / sizeof(kRegRows[0]);

// One stage with d = 32 << E on this thread's lanes r*32 + t: every
// partner is a register of the same thread.
template <int R, int E, bool KV>
__device__ __forceinline__ void thread_stage(int (&k)[R], int (&v)[R]) {
  constexpr int D = 1 << E;        // d / 32
  constexpr int DM = D % R;        // (d % m) / 32
  int nk[R], nv[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool low = (r & D) == 0;
    const int p = low ? (r + DM) % R : (r + R - DM) % R;
    const bool plow = (p & D) == 0;
    const int pp = plow ? (p + DM) % R : (p + R - DM) % R;
    if (!KV) {
      nk[r] = low ? min(k[r], k[p]) : max(k[r], k[p]);
    } else if (p == r) {           // d % m == 0: the lane meets itself
      nk[r] = k[r];
      nv[r] = v[r];
    } else if (pp == r && plow != low) {
      if (low) {                   // the pair (r, p), written once
        const bool swap = k[r] > k[p];
        nk[r] = min(k[r], k[p]);
        nk[p] = max(k[r], k[p]);
        nv[r] = swap ? v[p] : v[r];
        nv[p] = swap ? v[r] : v[p];
      }
    } else {                       // one-sided: p's partner is not r
      const bool take = low ? k[p] < k[r] : k[p] > k[r];
      nk[r] = take ? k[p] : k[r];
      nv[r] = take ? v[p] : v[r];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k[r] = nk[r];
    if (KV) v[r] = nv[r];
  }
}

// One stage with d = 1 << E < 32: the partner of lane r*32 + t is
// r*32 + (t ^ d), in thread t ^ d.
template <int R, int E, bool KV>
__device__ __forceinline__ void lane_stage(int (&k)[R], int (&v)[R], int t) {
  constexpr int d = 1 << E;
  const bool low = (t & d) == 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int o = __shfl_xor_sync(~0u, k[r], d);
    const int y = low ? min(k[r], o) : max(k[r], o);
    if (KV) {
      const int ov = __shfl_xor_sync(~0u, v[r], d);
      v[r] = y != k[r] ? ov : v[r];
    }
    k[r] = y;
  }
}

// Stages S, S+1, ... 9 of a round of ten, the first `left` of them; every
// stage is unrolled, so no register moves between stages.
template <int R, bool KV, int S = 0>
__device__ __forceinline__ void round_of_ten(int (&k)[R], int (&v)[R], int t,
                                             int left) {
  if constexpr (S < 5) {
    lane_stage<R, S, KV>(k, v, t);
  } else {
    thread_stage<R, S - 5, KV>(k, v);
  }
  if constexpr (S < 9) {
    if (left > S + 1) round_of_ten<R, KV, S + 1>(k, v, t, left);
  }
}

// A block is one warp and owns one row.
template <int R, bool KV>
__global__ void __launch_bounds__(32)
    roll_regs(const int* __restrict__ k_in, const int* __restrict__ v_in,
              int* __restrict__ k_out, int* __restrict__ v_out, int stages) {
  const int t = threadIdx.x;
  const long long base = (long long)blockIdx.x * (R * 32) + t;
  int k[R], v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k[r] = k_in[base + 32 * r];
    if (KV) v[r] = v_in[base + 32 * r];
  }
  for (int s = 0; s < stages; s += 10) {
    round_of_ten<R, KV>(k, v, t, stages - s);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    k_out[base + 32 * r] = k[r];
    if (KV) v_out[base + 32 * r] = v[r];
  }
}

template <bool KV>
__global__ void roll_smem(const int* __restrict__ k_in,
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
int launch_smem(const void* k, const void* v, void* ok, void* ov, int W,
                int m, int stages, void* stream) {
  const size_t smem = sizeof(int) * (size_t)m * (KV ? 4 : 2);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        roll_smem<KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0) {
    roll_smem<KV><<<W, THREADS, smem, (cudaStream_t)stream>>>(
        (const int*)k, (const int*)v, (int*)ok, (int*)ov, m, stages);
  }
  return (int)cudaGetLastError();
}

// The register kernel for m = 32 * kRegRows[I] or a later entry's.
template <bool KV, int I = 0>
int launch_regs(const void* k, const void* v, void* ok, void* ov, int W,
                int m, int stages, void* stream) {
  if constexpr (I == kNumRegRows) {
    return (int)cudaErrorInvalidValue;
  } else {
    constexpr int R = kRegRows[I];
    if (m != 32 * R) {
      return launch_regs<KV, I + 1>(k, v, ok, ov, W, m, stages, stream);
    }
    if (W > 0) {
      roll_regs<R, KV><<<W, 32, 0, (cudaStream_t)stream>>>(
          (const int*)k, (const int*)v, (int*)ok, (int*)ov, stages);
    }
    return (int)cudaGetLastError();
  }
}

}  // namespace

// 1 if rows of m lanes take the register kernels, else 0.
extern "C" int hz_roll_regs(int m) {
  for (int i = 0; i < kNumRegRows; ++i) {
    if (m == 32 * kRegRows[i]) return 1;
  }
  return 0;
}

// The register kernels: m = 32 R with R in kRegRows (hz_roll_regs), else
// cudaErrorInvalidValue.
extern "C" int hz_roll_minmax(const void* x, void* out, int W, int m,
                              int stages, void* stream) {
  return launch_regs<false>(x, nullptr, out, nullptr, W, m, stages, stream);
}

extern "C" int hz_roll_kv(const void* k, const void* v, void* ok, void* ov,
                          int W, int m, int stages, void* stream) {
  return launch_regs<true>(k, v, ok, ov, W, m, stages, stream);
}

// The shared-memory kernels: any m whose row (and values) fits a block.
extern "C" int hz_roll_minmax_smem(const void* x, void* out, int W, int m,
                                   int stages, void* stream) {
  return launch_smem<false>(x, nullptr, out, nullptr, W, m, stages, stream);
}

extern "C" int hz_roll_kv_smem(const void* k, const void* v, void* ok,
                               void* ov, int W, int m, int stages,
                               void* stream) {
  return launch_smem<true>(k, v, ok, ov, W, m, stages, stream);
}

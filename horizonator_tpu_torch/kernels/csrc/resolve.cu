// Resolve: the first march sample that covers each pixel row of a column.
//
// Replaces horizonator_tpu/render/resolve_window.py::_resolve_kernel,
// both its untextured and its textured branch. Same (idx, alpha, ok)
// contract, decoded as at resolve_window.py:381-387; the TPU's bitonic
// valley merge and butterfly router existed to avoid gathers and sorts on
// the TPU, and are replaced by a scan, a scatter and a second scan:
//
//   1. key_k = clip(rint(y_k * 256)): horizon rows quantized to 1/256 px;
//   2. inclusive running min over k (the running max horizon in row space);
//   3. per pixel row h: idx = #keys > 256h (an equal key counts as a
//      crossing). The thresholds rise with h and the keys fall with k, so
//      idx falls as h rises and every sample owns one run of rows: sample
//      k with key[k] < key[k-1] (key[-1] = +inf) has idx == k exactly on
//      ceil(key[k] / 256) <= h < ceil(key[k-1] / 256), clipped to [0, H);
//      the rows above ceil(key[K-1] / 256) are sky, idx = K; a sample on
//      a plateau of the running min owns nothing. Each owner writes k at
//      the first row of its run into a (H,) array preset to K, and a
//      running min over the rows fills the runs;
//   4. y_cur = key[idx] (or -2^30), y_prev = key[idx-1] (or 2^30),
//      ok = idx in (0, K) (then y_prev > y_cur, because idx owns its row),
//      alpha = clip((y_prev - 256h) / (y_prev - y_cur), 0, 1)
//      quantized as rint(alpha * amax) * inv_amax (XLA decodes the
//      packed field's `/ amax` as a product with the float32 reciprocal).
//
// ``int_first`` selects where alpha's numerator is rounded: 1 takes the
// difference in int32 and converts it (the fused TPU kernel), 0 converts
// both operands first (raymarch._resolve_rows, the path the JAX package
// takes where the fused kernel does not fit).
//
// Textured entry: each pixel row also gets the packed color of its
// first-crossing sample, tex[idx], or 0 for sky (idx == K). The TPU kernel
// carries the running min's ARGMIN color (ties to the earlier sample)
// through its merge, because the merge loses the samples' positions. Here
// idx is kept, and the argmin of keys[0..idx] is idx itself: idx is the
// first key <= 256h and key[idx-1] > 256h, so the running min first takes
// its value key[idx] at sample idx. The block stages the colors in shared
// memory beside the keys.
//
// What bounds it on the H100: the bytes it writes, 9 per pixel row (13
// textured), through instructions of the int32 pipe, which runs at half
// the float32 rate. The design, each point measured against the per-row
// binary search of the port's first kernel:
//
// - One block of 128 threads per column, 32 registers a thread, so 16
//   blocks share an SM: one column's loads and barriers hide behind
//   another's arithmetic, with no pipeline inside the block. 256 threads
//   wait longer at each barrier, one warp a column serializes too much.
// - The rows y are read with neighbouring threads on neighbouring samples.
//   Each thread then scans an odd-length chunk of consecutive keys in
//   shared memory (an odd stride meets no bank conflict); the chunks'
//   minima are combined by warp shuffles and one exchange between the four
//   warps; the pass that writes the final keys scatters the owners.
// - In the row phase a thread owns 4 consecutive rows of a 512-row tile:
//   one 16-byte read of the row array, the same two-level running min,
//   two key reads per row between sentinels (key[-1] = 2^30, key[K] =
//   -2^30, color[K] = 0: no selects), and one 16-byte store each of idx,
//   alpha (and color) and one 4-byte store of ok, so that a warp's store
//   covers whole 32-byte sectors. More rows a thread leave gaps between
//   the threads' stores, and every such variant measured slower.
// - The stores are streaming (evict-first): the outputs, 38 to 55 MB, do
//   not fit the 50 MB L2 beside the rows y, which the row map has just
//   written and which then stay there.
// - Three block barriers per column plus one per tile, five at H 1024.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;         // above every key: +inf for the keys
constexpr int INF = 2147483647;      // above every index
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;              // pixel rows per thread and tile
constexpr int TILE = THREADS * ROWS;
constexpr int BLOCKS_PER_SM = 16;    // caps the registers at 32 a thread
constexpr unsigned FULL = 0xffffffffu;

// ceil(x / 256) for either sign: >> on a negative int rounds down
__device__ __forceinline__ int ceil256(int x) { return (x + 255) >> 8; }

// The min of `v` over all threads before this one in the block (`none` for
// thread 0); with want_total, `total` gets the min over the whole block.
// `wtot`: WARPS ints of shared memory, not written again before the next
// barrier but one. Contains one __syncthreads(): every thread calls it.
__device__ __forceinline__ int block_min_before(int v, int none, int* wtot,
                                                int lane, int warp,
                                                bool want_total, int& total) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v = min(v, u);
  }
  int pre = __shfl_up_sync(FULL, v, 1);
  if (lane == 0) pre = none;
  if (lane == 31) wtot[warp] = v;
  __syncthreads();
  const int t = lane < WARPS ? wtot[lane] : none;
  pre = min(pre, __reduce_min_sync(FULL, lane < warp ? t : none));
  if (want_total) total = __reduce_min_sync(FULL, t);
  return pre;
}

template <bool TEX, bool INT_FIRST>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    resolve_kernel(const float* __restrict__ y, const int* __restrict__ tex,
                   int K, int H, float amax, float inv_amax,
                   int* __restrict__ idx_out, float* __restrict__ alpha_out,
                   uint8_t* __restrict__ ok_out, int* __restrict__ tex_out) {
  extern __shared__ int4 smem4[];
  const int Hp = (H + ROWS - 1) & ~(ROWS - 1);
  int* mark = reinterpret_cast<int*>(smem4);  // Hp rows, 16-byte aligned
  int* wtot = mark + Hp;                      // 3 x WARPS warp minima
  int* key = wtot + 3 * WARPS + 1;            // key[-1] = BIG, K keys, -BIG
  int* col = key + K + 1;                     // K sample colors, 0 (textured)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long w = blockIdx.x;
  const float* yw = y + w * K;

  // 1: quantize, neighbouring threads on neighbouring samples; preset the
  // row array to "sky"
  for (int k = tid; k < K; k += THREADS) {
    float v = rintf(__fmul_rn(yw[k], 256.0f));
    v = fminf(fmaxf(v, -1073741824.0f), 1073741824.0f);
    const int q = (int)v;
    key[k] = min(max(q, -(BIG - 1)), BIG - 1);
    if (TEX) col[k] = tex[w * K + k];
  }
  for (int h = tid * ROWS; h < Hp; h += TILE)
    *reinterpret_cast<int4*>(mark + h) = make_int4(K, K, K, K);
  if (tid == 0) {
    key[-1] = BIG;
    key[K] = -BIG;
    if (TEX) col[K] = 0;
  }
  __syncthreads();

  // 2: inclusive running min over k; each strictly lower key marks the
  // first row of the run it owns
  const int chunk = ((K + THREADS - 1) / THREADS) | 1;
  const int lo = min(tid * chunk, K);
  const int hi = min(lo + chunk, K);
  int run = BIG;
  for (int k = lo; k < hi; ++k) run = min(run, key[k]);
  int total = 0;
  int prev = block_min_before(run, BIG, wtot, lane, warp, false, total);
  for (int k = lo; k < hi; ++k) {
    const int cur = min(prev, key[k]);
    key[k] = cur;
    if (cur < prev) {
      const int r0 = max(ceil256(cur), 0);
      const int r1 = min(ceil256(prev), H);  // ceil256(BIG) >= any H
      if (r0 < r1) mark[r0] = k;
    }
    prev = cur;
  }
  __syncthreads();

  // 3-4: running min over the rows, 4 rows per thread and tile, then each
  // row's brackets, alpha and ok
  const bool vec = (H & (ROWS - 1)) == 0;  // w * H + h0: 16-byte aligned
  int carry = INF;
  int tile = 0;
  for (int base = 0; base < Hp; base += TILE, ++tile) {
    const int h0 = base + tid * ROWS;
    int4 m = make_int4(INF, INF, INF, INF);
    if (h0 < Hp) m = *reinterpret_cast<const int4*>(mark + h0);
    int l[ROWS];
    l[0] = m.x;
    l[1] = min(l[0], m.y);
    l[2] = min(l[1], m.z);
    l[3] = min(l[2], m.w);
    const bool more = base + TILE < Hp;
    const int pre = min(
        carry, block_min_before(l[3], INF, wtot + WARPS * (1 + (tile & 1)),
                                lane, warp, more, total));
    if (more) carry = min(carry, total);
    if (h0 >= H) continue;

    float alpha[ROWS];
    int color[ROWS];
    uint8_t ok[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) {
      const int i = min(l[j], pre);
      l[j] = i;
      const int thr = (h0 + j) << 8;
      const int y_prev = key[i - 1];
      const int y_cur = key[i];
      const float denom = __int2float_rn(y_prev - y_cur);  // > 0
      ok[j] = (unsigned)(i - 1) < (unsigned)(K - 1);
      const float num =
          INT_FIRST
              ? __int2float_rn(y_prev - thr)
              : __fsub_rn(__int2float_rn(y_prev), __int2float_rn(thr));
      float a = __fdiv_rn(num, denom);
      a = fminf(fmaxf(a, 0.0f), 1.0f);
      alpha[j] = __fmul_rn(rintf(__fmul_rn(a, amax)), inv_amax);
      if (TEX) color[j] = col[i];
    }
    const long long o = w * H + h0;
    if (vec) {
      __stcs(reinterpret_cast<int4*>(idx_out + o),
             make_int4(l[0], l[1], l[2], l[3]));
      __stcs(reinterpret_cast<float4*>(alpha_out + o),
             make_float4(alpha[0], alpha[1], alpha[2], alpha[3]));
      __stcs(reinterpret_cast<uchar4*>(ok_out + o),
             make_uchar4(ok[0], ok[1], ok[2], ok[3]));
      if (TEX)
        __stcs(reinterpret_cast<int4*>(tex_out + o),
               make_int4(color[0], color[1], color[2], color[3]));
    } else {
#pragma unroll
      for (int j = 0; j < ROWS; ++j) {
        if (h0 + j < H) {
          idx_out[o + j] = l[j];
          alpha_out[o + j] = alpha[j];
          ok_out[o + j] = ok[j];
          if (TEX) tex_out[o + j] = color[j];
        }
      }
    }
  }
}

template <bool TEX, bool INT_FIRST>
int launch(const void* y, const void* tex, int W, int K, int H, float amax,
           float inv_amax, void* idx, void* alpha, void* ok, void* tex_out,
           void* stream) {
  // the row array, the warps' exchange words, the keys between their
  // sentinels and, textured, the colors and theirs
  const size_t rows = ((size_t)H + ROWS - 1) & ~(size_t)(ROWS - 1);
  const size_t smem = sizeof(int) * (rows + 3 * WARPS + ((size_t)K + 2) +
                                     (TEX ? (size_t)K + 1 : 0));
  auto kernel = resolve_kernel<TEX, INT_FIRST>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0) {
    kernel<<<W, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)y, (const int*)tex, K, H, amax, inv_amax, (int*)idx,
        (float*)alpha, (uint8_t*)ok, (int*)tex_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hz_resolve(const void* y, int W, int K, int H, float amax,
                          float inv_amax, int int_first, void* idx,
                          void* alpha, void* ok, void* stream) {
  return (int_first ? launch<false, true> : launch<false, false>)(
      y, nullptr, W, K, H, amax, inv_amax, idx, alpha, ok, nullptr, stream);
}

extern "C" int hz_resolve_tex(const void* y, const void* tex, int W, int K,
                              int H, float amax, float inv_amax,
                              int int_first, void* idx, void* alpha,
                              void* ok, void* tex_out, void* stream) {
  return (int_first ? launch<true, true> : launch<true, false>)(
      y, tex, W, K, H, amax, inv_amax, idx, alpha, ok, tex_out, stream);
}

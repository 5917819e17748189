// Resolve: the first march sample that covers each pixel row of a column.
//
// Replaces horizonator_tpu/render/resolve_window.py::_resolve_kernel,
// both its untextured and its textured branch. Same (idx, alpha, ok)
// contract, decoded as at
// resolve_window.py:381-387; the TPU's bitonic valley merge and butterfly
// router existed to avoid gathers and sorts on the TPU, and are replaced by
// a search:
//
//   1. key_k = clip(rint(y_k * 256)): horizon rows quantized to 1/256 px;
//   2. inclusive running min over k (the running max horizon in row space);
//   3. per pixel row h: idx = #keys > 256h (binary search on the
//      non-increasing keys; an equal key counts as a crossing),
//      y_cur = key[idx] (or -2^30), y_prev = key[idx-1] (or 2^30),
//      ok = idx in (0, K) and y_prev > y_cur,
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
// through its merge, because the merge loses the samples' positions. The
// search keeps idx, and the argmin of keys[0..idx] is idx itself: idx is
// the first key <= 256h and key[idx-1] > 256h, so the running min first
// takes its value key[idx] at sample idx. The argmin color there is the
// sample's own color, which the block stages in shared memory beside the
// keys (so the textured K limit is half the untextured one).
//
// One block per image column; the keys live in shared memory (4 bytes per
// sample, 2.3 KB at K = 580; 8 bytes textured). What bounds it on the
// H100: the ~log2(K) dependent shared-memory reads of each row's search,
// ~10 per output element at the 4096x1024 shape, against 9 bytes written
// per element (13 textured).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int THREADS = 128;

template <bool TEX>
__global__ void resolve_kernel(const float* __restrict__ y,
                               const int* __restrict__ tex, int K, int H,
                               float amax, float inv_amax, int int_first,
                               int* __restrict__ idx_out,
                               float* __restrict__ alpha_out,
                               uint8_t* __restrict__ ok_out,
                               int* __restrict__ tex_out) {
  extern __shared__ int smem[];
  int* key = smem;            // K keys
  int* part = smem + K;       // THREADS chunk minima
  int* col = part + THREADS;  // K sample colors (textured)
  const int tid = threadIdx.x;
  const long long w = blockIdx.x;
  const float* yw = y + w * K;

  // 1-2: quantize, then a chunked inclusive running min
  const int chunk = (K + THREADS - 1) / THREADS;
  const int lo = min(tid * chunk, K);
  const int hi = min(lo + chunk, K);
  int run = 2147483647;
  for (int k = lo; k < hi; ++k) {
    float v = rintf(__fmul_rn(yw[k], 256.0f));
    v = fminf(fmaxf(v, -1073741824.0f), 1073741824.0f);
    int q = (int)v;
    q = min(max(q, -(BIG - 1)), BIG - 1);
    run = min(run, q);
    key[k] = run;
    if (TEX) col[k] = tex[w * K + k];
  }
  part[tid] = run;
  __syncthreads();
  for (int d = 1; d < THREADS; d <<= 1) {
    const int v = tid >= d ? part[tid - d] : 2147483647;
    __syncthreads();
    part[tid] = min(part[tid], v);
    __syncthreads();
  }
  const int pre = tid > 0 ? part[tid - 1] : 2147483647;
  for (int k = lo; k < hi; ++k) key[k] = min(key[k], pre);
  __syncthreads();

  // 3: one binary search per pixel row
  for (int h = tid; h < H; h += THREADS) {
    const int thr = h << 8;
    int l = 0, r = K;
    while (l < r) {
      const int mid = (l + r) >> 1;
      if (key[mid] > thr) l = mid + 1; else r = mid;
    }
    const int y_cur = l < K ? key[l] : -BIG;
    const int y_prev = l > 0 ? key[l - 1] : BIG;
    const float denom = __int2float_rn(y_prev - y_cur);
    const bool ok = y_cur > -BIG && y_prev < BIG && denom > 0.0f;
    const float num =
        int_first ? __int2float_rn(y_prev - thr)
                  : __fsub_rn(__int2float_rn(y_prev), __int2float_rn(thr));
    float alpha = __fdiv_rn(num, denom > 0.0f ? denom : 1.0f);
    alpha = fminf(fmaxf(alpha, 0.0f), 1.0f);
    const long long o = w * H + h;
    idx_out[o] = l;
    alpha_out[o] = __fmul_rn(rintf(__fmul_rn(alpha, amax)), inv_amax);
    ok_out[o] = ok ? 1 : 0;
    if (TEX) tex_out[o] = l < K ? col[l] : 0;
  }
}

template <bool TEX>
int launch(const void* y, const void* tex, int W, int K, int H, float amax,
           float inv_amax, int int_first, void* idx, void* alpha, void* ok,
           void* tex_out, void* stream) {
  const size_t smem = sizeof(int) * ((size_t)K * (TEX ? 2 : 1) + THREADS);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        resolve_kernel<TEX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (W > 0) {
    resolve_kernel<TEX><<<W, THREADS, smem, (cudaStream_t)stream>>>(
        (const float*)y, (const int*)tex, K, H, amax, inv_amax, int_first,
        (int*)idx, (float*)alpha, (uint8_t*)ok, (int*)tex_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hz_resolve(const void* y, int W, int K, int H, float amax,
                          float inv_amax, int int_first, void* idx,
                          void* alpha, void* ok, void* stream) {
  return launch<false>(y, nullptr, W, K, H, amax, inv_amax, int_first, idx,
                       alpha, ok, nullptr, stream);
}

extern "C" int hz_resolve_tex(const void* y, const void* tex, int W, int K,
                              int H, float amax, float inv_amax,
                              int int_first, void* idx, void* alpha,
                              void* ok, void* tex_out, void* stream) {
  return launch<true>(y, tex, W, K, H, amax, inv_amax, int_first, idx,
                      alpha, ok, tex_out, stream);
}

// K6: read-only full-width ancestry attention for a list of items, and K7:
// the same attention for every item.
//
// K6 replaces deephumor_tpu/ops/pallas_attention.py:ancestry_attention_ids
// (kernel _kernel_native4d_ids, whose body is the read-only
// _kernel_native4d). K7 replaces pallas_attention.py:ancestry_attention
// (kernels _kernel_native4d, _kernel and _kernel_blockdiag: three TPU
// layouts of one function, K1's attention without the cache write); its
// entry point runs this kernel with no id list, one block per item, over
// the first p_eff positions (the wrapper passes P for the layouts that read
// the whole cache). The canonical-prefix path (K5) gives straggler items
// -- live branches that still disagree below c -- outputs from a stale
// shared path; this kernel recomputes exactly those items over the full
// per-slot caches [0, p_eff) with the step's flat ancestry bias
// [items, beam, beam * P]. The grid walks the first max(n_sel, 1) entries
// of an item-id list (the TPU grid is clamped the same way); rows of other
// items are not written.
//
// Bound on the H100: bytes (at the char config's last phase, beam 7 x
// p_eff 128 x D 512 bf16, ~1.8 MB of K+V per item). Design: K1's
// (item, head) blocks cannot stage all beam * p_eff rows here (896 rows:
// ~257 KB in bf16, ~480 KB in f32, over the 227 KB a block may use), so
// the positions are tiled in two passes. Pass 1 stages K a tile of rows at
// a time and leaves every energy (beam x 896 f32 = 25 KB) in shared memory;
// one softmax per branch follows, with weights rounded to the cache dtype;
// pass 2 stages V tile by tile and each thread adds its own (branch,
// column) sums in shared memory, in the same row order as K1. K7 reads the
// same rows at the char shapes (beam 7 x P 136 = 952 rows for the layouts
// that read the whole cache), so it takes this kernel, not K1's.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 256;

// Row r0 + r of one item's (slot, position) rows in one head's columns:
// slot (r0 + r) / pe, position (r0 + r) % pe.
template <typename T>
struct TileRows {
  const T* cache;
  size_t row0;
  int r0, P, pe, D, col0;
  __device__ const uint4* operator()(int r) const {
    const int i = (r0 + r) / pe, p = (r0 + r) % pe;
    return reinterpret_cast<const uint4*>(
        cache + ((row0 + i) * P + p) * D + col0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ancestry_attention_ids_kernel(
    const T* __restrict__ q, const T* __restrict__ ck,
    const T* __restrict__ cv, const float* __restrict__ bias,
    const int* __restrict__ ids, T* __restrict__ out, int items, int beam,
    int P, int pe, int D, int hd, int tile, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int n = beam * pe;
  const int wpr = hd * (int)sizeof(T) / 4;
  const int ld = wpr + 1;
  uint32_t* ts = smem_w;                                   // [tile][ld]
  float* qs = reinterpret_cast<float*>(ts + tile * ld);    // [beam][hd]
  float* acc = qs + beam * hd;                             // [beam][hd]
  float* e = acc + beam * hd;                              // [beam][n]
  // K7 passes no id list: block x computes item x
  const int item = ids ? ids[blockIdx.x] : (int)blockIdx.x;
  if (item < 0 || item >= items) return;
  const size_t row0 = (size_t)item * beam;
  const int col0 = blockIdx.y * hd;

  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    qs[t] = dh::to_f32(q[(row0 + t / hd) * D + col0 + t % hd]);
    acc[t] = 0.f;
  }
  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nt = min(tile, n - r0);
    __syncthreads();  // the previous tile is consumed; q is staged
    dh::stage_rows(ts, ld, nt, wpr / 4,
                   TileRows<T>{ck, row0, r0, P, pe, D, col0});
    __syncthreads();
    for (int t = threadIdx.x; t < beam * nt; t += blockDim.x) {
      const int j = t / nt, r = r0 + t % nt, i = r / pe, p = r % pe;
      const T* krow = reinterpret_cast<const T*>(ts + (t % nt) * ld);
      const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
      e[j * n + r] = s + bias[((row0 + j) * beam + i) * P + p];
    }
  }
  __syncthreads();

  for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5)
    dh::warp_softmax_round<T>(e + j * n, n);

  for (int r0 = 0; r0 < n; r0 += tile) {
    const int nt = min(tile, n - r0);
    __syncthreads();  // weights are final; the previous tile is consumed
    dh::stage_rows(ts, ld, nt, wpr / 4,
                   TileRows<T>{cv, row0, r0, P, pe, D, col0});
    __syncthreads();
    for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
      const int j = t / hd, d = t % hd;
      const float* wt = e + j * n + r0;
      float a = acc[t];
      for (int r = 0; r < nt; ++r)
        a = fmaf(wt[r], dh::to_f32(reinterpret_cast<const T*>(ts + r * ld)[d]),
                 a);
      acc[t] = a;
    }
  }
  // each thread wrote only its own acc entries
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x)
    out[(row0 + t / hd) * D + col0 + t % hd] = dh::from_f32<T>(acc[t]);
}

template <typename T>
cudaError_t launch(const void* q, const void* ck, const void* cv,
                   const void* bias, const void* ids, void* out, int items,
                   int n_sel, int beam, int P, int pe, int D, int H,
                   float inv_scale, cudaStream_t stream) {
  const int hd = D / H, n = beam * pe;
  const int tile = n < kTileRows ? n : kTileRows;
  const size_t smem = 4 * ((size_t)tile * (hd * sizeof(T) / 4 + 1)
                           + 2 * (size_t)beam * hd + (size_t)beam * n);
  auto kernel = ancestry_attention_ids_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_sel, H), kThreads, smem, stream>>>(
      (const T*)q, (const T*)ck, (const T*)cv, (const float*)bias,
      (const int*)ids, (T*)out, items, beam, P, pe, D, hd, tile, inv_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_ancestry_attention_ids(
    int dtype, const void* q, const void* ck, const void* cv,
    const void* bias, const void* ids, void* out, int items, int n_sel,
    int beam, int P, int pe, int D, int H, float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ck, cv, bias, ids, out, items, n_sel,
                                 beam, P, pe, D, H, inv_scale, s);
  return launch<float>(q, ck, cv, bias, ids, out, items, n_sel, beam, P, pe,
                       D, H, inv_scale, s);
}

extern "C" int dh_ancestry_attention(int dtype, const void* q, const void* ck,
                                     const void* cv, const void* bias,
                                     void* out, int items, int beam, int P,
                                     int pe, int D, int H, float inv_scale,
                                     void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ck, cv, bias, nullptr, out, items, items,
                                 beam, P, pe, D, H, inv_scale, s);
  return launch<float>(q, ck, cv, bias, nullptr, out, items, items, beam, P,
                       pe, D, H, inv_scale, s);
}

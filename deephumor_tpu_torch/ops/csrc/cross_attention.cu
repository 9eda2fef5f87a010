// K2: grouped single-query cross-attention.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:grouped_cross_attention
// (kernel _kernel_cross). The r = beam query rows of item g attend to
// item g's encoder keys/values [T, D] (pre-projected once per
// generation), with an optional additive f32 mask bias [G, 1, T] (0 or
// -1e8 for masked encoder rows). A group whose rows are all masked gets
// the uniform average: -1e8 is a fill, not -inf, so the softmax never
// sees an all--inf row and gives no NaN.
//
// Bound on the H100: bytes. At the serving shape (1792 items, T 49,
// D 512, bf16) one launch reads ~180 MB of ek + ev and does ~0.1 GFLOP.
// Design: one block per (item, head) copies the item's T x head_dim K and
// V tiles into shared memory once, with batched 16-byte loads (rows padded
// by one word against bank conflicts), and serves all r query rows from
// there, so each encoder byte leaves device memory once per launch.

#include "common.cuh"

namespace {

// Row t of group g's encoder keys or values in one head's columns, as
// 16-byte vectors.
template <typename T>
struct EncoderRows {
  const T* base;  // group g's first row, at the head's first column
  int D;
  __device__ const uint4* operator()(int t) const {
    return reinterpret_cast<const uint4*>(base + (size_t)t * D);
  }
};

template <typename T>
__global__ void __launch_bounds__(128) grouped_cross_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ ek,
    const T* __restrict__ ev, const float* __restrict__ bias,
    T* __restrict__ out, int r, int Tn, int D, int hd, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int wpr = hd * (int)sizeof(T) / 4;  // 4-byte words per row
  const int ld = wpr + 1;                   // odd: conflict-free columns
  uint32_t* ks = smem_w;                    // [Tn][ld]
  uint32_t* vs = ks + Tn * ld;              // [Tn][ld]
  float* qs = reinterpret_cast<float*>(vs + Tn * ld);  // [r][hd]
  float* e = qs + r * hd;                   // [r][Tn]
  const int g = blockIdx.x, col0 = blockIdx.y * hd;
  const size_t kv0 = (size_t)g * Tn * D + col0;
  const size_t q0 = (size_t)g * r;

  dh::stage_rows(ks, ld, Tn, wpr / 4, EncoderRows<T>{ek + kv0, D});
  dh::stage_rows(vs, ld, Tn, wpr / 4, EncoderRows<T>{ev + kv0, D});
  for (int t = threadIdx.x; t < r * hd; t += blockDim.x)
    qs[t] = dh::to_f32(q[(q0 + t / hd) * D + col0 + t % hd]);
  __syncthreads();

  for (int t = threadIdx.x; t < r * Tn; t += blockDim.x) {
    const int j = t / Tn, tt = t % Tn;
    const T* krow = reinterpret_cast<const T*>(ks + tt * ld);
    const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
    e[t] = s + (bias ? bias[(size_t)g * Tn + tt] : 0.f);
  }
  __syncthreads();

  for (int j = threadIdx.x >> 5; j < r; j += blockDim.x >> 5)
    dh::warp_softmax_round<T>(e + j * Tn, Tn);
  __syncthreads();

  for (int t = threadIdx.x; t < r * hd; t += blockDim.x) {
    const int j = t / hd, d = t % hd;
    float acc = 0.f;
    for (int tt = 0; tt < Tn; ++tt)
      acc = fmaf(e[j * Tn + tt],
                 dh::to_f32(reinterpret_cast<const T*>(vs + tt * ld)[d]),
                 acc);
    out[(q0 + j) * D + col0 + d] = dh::from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* ek, const void* ev,
                   const void* bias, void* out, int G, int r, int Tn, int D,
                   int H, float inv_scale, cudaStream_t stream) {
  const int hd = D / H;
  const size_t smem = 4 * ((size_t)2 * Tn * (hd * sizeof(T) / 4 + 1) +
                           (size_t)r * (hd + Tn));
  auto kernel = grouped_cross_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(G, H), 128, smem, stream>>>(
      (const T*)q, (const T*)ek, (const T*)ev, (const float*)bias, (T*)out,
      r, Tn, D, hd, inv_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_grouped_cross_attention(int dtype, const void* q,
                                          const void* ek, const void* ev,
                                          const void* bias, void* out, int G,
                                          int r, int Tn, int D, int H,
                                          float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ek, ev, bias, out, G, r, Tn, D, H,
                                 inv_scale, s);
  return launch<float>(q, ek, ev, bias, out, G, r, Tn, D, H, inv_scale, s);
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

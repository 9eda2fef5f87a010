// K9: grouped single-query cross-attention, ng items per block.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:_cross_packed (kernel
// _kernel_cross_packed), the DH_CROSS_PACK form of K2. The r rows of item g
// attend, per head, to item g's first t_real encoder keys/values of a
// store padded to Tp rows, with the additive f32 bias [G, 1, Tp] (0 or
// -1e8) on the scaled energies. The pad rows and every other item's rows
// get exactly zero weight; an item whose t_real rows are all masked
// averages them uniformly (-1e8 is a fill, not -inf: no NaN).
//
// The TPU kernel fuses ng items into one block-diagonal product, masking
// the cross-item energies, so that its matrix unit works on full tiles.
// Those masked energies contribute nothing, so here a block takes ng items
// of one head and computes only the diagonal.
//
// Bound on the H100: bytes. At the word shape (G 1792, r 5, T 49 of 56,
// D 512, bf16) one launch needs the 49 real rows of K and V, the queries
// and the output, ~198 MB (0.059 ms at 3.35 TB/s), and ~0.1 GFLOP.
// Design: one block of 256 threads per (group of ng items, head) copies
// the group's live items' t_real x head_dim K and V rows into shared memory
// with cp.async (every copy in flight at once, no registers held), K in
// 16-byte chunks XOR-swizzled by row so that threads reading one chunk of 8
// consecutive rows hit distinct banks. Then every phase spreads over all
// the block's threads, across its items: a thread scores one (item,
// encoder row) pair against up to 8 query rows at once, so each K element
// leaves shared memory once per 8 rows; one warp softmax per query row;
// then a thread sums the weighted V rows of one 4-byte word of head_dim for
// up to 4 query rows of one item. Pad rows are never read. Items at or past
// `live` write zero rows and read nothing.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowChunk = 8;  // query rows one energy unit scores at once
constexpr int kAvRows = 4;    // query rows one weighted-V unit sums at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cross_attention_packed_kernel(
    const T* __restrict__ q, const T* __restrict__ ek,
    const T* __restrict__ ev, const float* __restrict__ bias,
    T* __restrict__ out, int live, int r, int Tp, int t_real, int ng, int D,
    int hd, int sw, float inv_scale) {
  constexpr int kVpc = 16 / sizeof(T);  // values per 16-byte chunk
  constexpr int kVpw = 4 / sizeof(T);   // values per 4-byte word
  extern __shared__ __align__(16) uint4 smem_v[];
  const int nch = hd / kVpc;            // 16-byte chunks per row
  const int wpr = hd / kVpw;            // 4-byte words per row
  const int item_chunks = t_real * nch;
  uint4* ks = smem_v;                                   // [ng][t_real][nch]
  uint4* vs = ks + (size_t)ng * item_chunks;            // [ng][t_real][nch]
  float* qs = reinterpret_cast<float*>(vs + (size_t)ng * item_chunks);
  float* es = qs + (size_t)ng * r * hd;                 // [ng][r][t_real]
  const int g0 = blockIdx.x * ng, col0 = blockIdx.y * hd;
  const int n_live = min(max(live - g0, 0), ng);

  for (int i = threadIdx.x; i < (ng - n_live) * r * hd; i += blockDim.x) {
    const size_t row = (size_t)(g0 + n_live) * r + i / hd;
    out[row * D + col0 + i % hd] = dh::from_f32<T>(0.f);
  }
  if (n_live == 0) return;

  // stage the live items' K/V rows (swizzled) and queries
  const int total = n_live * item_chunks;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int n = i / item_chunks, rem = i - n * item_chunks;
    const int t = rem / nch, c = rem - t * nch;
    const size_t src = ((size_t)(g0 + n) * Tp + t) * D + col0 + c * kVpc;
    const int dst = n * item_chunks + t * nch + (c ^ (t & sw));
    cp_async16(ks + dst, ek + src);
    cp_async16(vs + dst, ev + src);
  }
  for (int i = threadIdx.x; i < n_live * r * hd; i += blockDim.x) {
    const int row = i / hd, d = i - row * hd;
    qs[i] = dh::to_f32(q[((size_t)g0 * r + row) * D + col0 + d]);
  }
  cp_async_wait_all();
  __syncthreads();

  // energies: one unit per (item, encoder row t)
  for (int u = threadIdx.x; u < n_live * t_real; u += blockDim.x) {
    const int n = u / t_real, t = u - n * t_real;
    const uint4* krow = ks + (size_t)n * item_chunks + t * nch;
    const float bt = bias ? bias[(size_t)(g0 + n) * Tp + t] : 0.f;
    for (int j0 = 0; j0 < r; j0 += kRowChunk) {
      const int nr = min(kRowChunk, r - j0);
      const float* qn = qs + ((size_t)n * r + j0) * hd;
      float acc[kRowChunk];
#pragma unroll
      for (int jj = 0; jj < kRowChunk; ++jj) acc[jj] = 0.f;
      for (int c = 0; c < nch; ++c) {
        const uint4 raw = krow[c ^ (t & sw)];
        const T* kv = reinterpret_cast<const T*>(&raw);
        float kf[kVpc];
#pragma unroll
        for (int v = 0; v < kVpc; ++v) kf[v] = dh::to_f32(kv[v]);
#pragma unroll
        for (int jj = 0; jj < kRowChunk; ++jj) {
          if (jj < nr) {
            const float* qr = qn + jj * hd + c * kVpc;
#pragma unroll
            for (int v = 0; v < kVpc; ++v) acc[jj] = fmaf(qr[v], kf[v], acc[jj]);
          }
        }
      }
      float* en = es + ((size_t)n * r + j0) * t_real + t;
#pragma unroll
      for (int jj = 0; jj < kRowChunk; ++jj)
        if (jj < nr) en[jj * t_real] = acc[jj] * inv_scale + bt;
    }
  }
  __syncthreads();

  for (int row = threadIdx.x >> 5; row < n_live * r; row += kWarps)
    dh::warp_softmax_round<T>(es + (size_t)row * t_real, t_real);
  __syncthreads();

  // weighted V rows: one unit per (item, group of kAvRows rows, word w)
  const int groups = (r + kAvRows - 1) / kAvRows;
  for (int u = threadIdx.x; u < n_live * groups * wpr; u += blockDim.x) {
    const int w = u % wpr, ig = u / wpr;
    const int n = ig / groups, j0 = (ig - n * groups) * kAvRows;
    const int nr = min(kAvRows, r - j0);
    const uint32_t* vn =
        reinterpret_cast<const uint32_t*>(vs + (size_t)n * item_chunks);
    const float* en = es + ((size_t)n * r + j0) * t_real;
    float acc[kAvRows][kVpw];
#pragma unroll
    for (int jj = 0; jj < kAvRows; ++jj)
#pragma unroll
      for (int v = 0; v < kVpw; ++v) acc[jj][v] = 0.f;
    for (int t = 0; t < t_real; ++t) {
      const int pw = (((w >> 2) ^ (t & sw)) << 2) | (w & 3);
      const uint32_t raw = vn[t * wpr + pw];
      const T* vv = reinterpret_cast<const T*>(&raw);
      float vf[kVpw];
#pragma unroll
      for (int v = 0; v < kVpw; ++v) vf[v] = dh::to_f32(vv[v]);
#pragma unroll
      for (int jj = 0; jj < kAvRows; ++jj) {
        if (jj < nr) {
          const float pr = en[jj * t_real + t];
#pragma unroll
          for (int v = 0; v < kVpw; ++v) acc[jj][v] = fmaf(pr, vf[v], acc[jj][v]);
        }
      }
    }
    const size_t row0 = (size_t)(g0 + n) * r + j0;
#pragma unroll
    for (int jj = 0; jj < kAvRows; ++jj) {
      if (jj < nr) {
        T* dst = out + (row0 + jj) * D + col0 + w * kVpw;
#pragma unroll
        for (int v = 0; v < kVpw; ++v) dst[v] = dh::from_f32<T>(acc[jj][v]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* ek, const void* ev,
                   const void* bias, void* out, int G, int live, int r,
                   int Tp, int t_real, int ng, int D, int H, float inv_scale,
                   cudaStream_t stream) {
  const int hd = D / H;
  const int nch = hd * (int)sizeof(T) / 16;
  // XOR-swizzle the chunk index by the row's low bits: the largest power
  // of two (at most 8) that divides the chunk count keeps it in the row
  const int sw = min(8, nch & -nch) - 1;
  const size_t smem = (size_t)2 * ng * t_real * hd * sizeof(T) +
                      sizeof(float) * ((size_t)ng * r * (hd + t_real));
  auto kernel = cross_attention_packed_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(G / ng, H), kThreads, smem, stream>>>(
      (const T*)q, (const T*)ek, (const T*)ev, (const float*)bias, (T*)out,
      live, r, Tp, t_real, ng, D, hd, sw, inv_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_cross_attention_packed(int dtype, const void* q,
                                         const void* ek, const void* ev,
                                         const void* bias, void* out, int G,
                                         int live, int r, int Tp, int t_real,
                                         int ng, int D, int H,
                                         float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ek, ev, bias, out, G, live, r, Tp,
                                 t_real, ng, D, H, inv_scale, s);
  return launch<float>(q, ek, ev, bias, out, G, live, r, Tp, t_real, ng, D,
                       H, inv_scale, s);
}

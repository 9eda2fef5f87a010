// K1: beam self-attention over ancestry-indexed KV caches, fused with the
// in-place write of this position's K/V column.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:ancestry_attention_update
// (kernel _kernel_native4d_update). Per decode step and layer the caches
// are never reordered: each branch j of item g attends over every
// (slot i, position p < p_eff) of its item, and an additive f32 bias
// [items, beam, beam * P] (0 or -1e8, shared by all layers) selects the
// ancestor slot per position and masks invalid positions. Softmax runs in
// f32 over the flat (slot, position) axis; the weights are rounded to the
// cache dtype before the AV product, as the TPU kernel does.
//
// Bound on the H100: bytes. At the serving shape (8960 rows, p_eff 32,
// D 512, bf16) one launch reads ~587 MB of K + V; the arithmetic is
// ~0.2 GFLOP. Design: one block per (item, head) owns the item's beam
// slots in that head's columns, so the blocks partition the caches and
// no block ever reads what another writes. The fresh column at `pos` is
// taken from k_new / v_new (never from the cache row), and the block
// writes it into the caches in place. The block first copies its K and V
// tiles (beam * p_eff rows of head_dim) into shared memory with
// coalesced loads, so each cache byte leaves device memory once; energies
// and weights stay in shared memory too. wgmma / TMA staging is later
// work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Row r = (slot r / pe, position r % pe) of one item's cache in one head's
// columns, as 16-byte vectors; position `pos` comes from `fresh`.
template <typename T>
struct CacheRows {
  const T* cache;
  const T* fresh;
  size_t row0;
  int P, pe, D, col0, pos;
  __device__ const uint4* operator()(int r) const {
    const int i = r / pe, p = r % pe;
    const T* base = p == pos ? fresh + (row0 + i) * D
                             : cache + ((row0 + i) * P + p) * D;
    return reinterpret_cast<const uint4*>(base + col0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ancestry_attention_update_kernel(
    const T* __restrict__ q, T* __restrict__ ck, T* __restrict__ cv,
    const T* __restrict__ knew, const T* __restrict__ vnew,
    const float* __restrict__ bias, T* __restrict__ out, int beam, int P,
    int pe, int D, int hd, int pos, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int n = beam * pe;                  // (slot, position) rows
  const int wpr = hd * (int)sizeof(T) / 4;  // 4-byte words per row
  const int ld = wpr + 1;  // odd row stride: row-parallel reads hit
                           // distinct banks
  uint32_t* ks = smem_w;                    // [n][ld]
  uint32_t* vs = ks + n * ld;               // [n][ld]
  float* qs = reinterpret_cast<float*>(vs + n * ld);  // [beam][hd]
  float* e = qs + beam * hd;                // [beam][n]
  const size_t row0 = (size_t)blockIdx.x * beam;
  const int col0 = blockIdx.y * hd;

  // stage this (item, head)'s K/V rows; the fresh column comes from
  // k_new / v_new
  dh::stage_rows(ks, ld, n, wpr / 4,
                 CacheRows<T>{ck, knew, row0, P, pe, D, col0, pos});
  dh::stage_rows(vs, ld, n, wpr / 4,
                 CacheRows<T>{cv, vnew, row0, P, pe, D, col0, pos});
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x)
    qs[t] = dh::to_f32(q[(row0 + t / hd) * D + col0 + t % hd]);
  __syncthreads();

  for (int t = threadIdx.x; t < beam * n; t += blockDim.x) {
    const int j = t / n, r = t % n, i = r / pe, p = r % pe;
    const T* krow = reinterpret_cast<const T*>(ks + r * ld);
    const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
    e[t] = s + bias[((row0 + j) * beam + i) * P + p];
  }
  __syncthreads();

  for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5)
    dh::warp_softmax_round<T>(e + j * n, n);
  __syncthreads();

  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int j = t / hd, d = t % hd;
    const float* w = e + j * n;
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(w[r], dh::to_f32(reinterpret_cast<const T*>(vs + r * ld)[d]),
                 acc);
    out[(row0 + j) * D + col0 + d] = dh::from_f32<T>(acc);
  }

  // the cache column at `pos` was never read above, so the write needs
  // no barrier
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int i = t / hd, d = t % hd;
    const size_t src = (row0 + i) * D + col0 + d;
    const size_t dst = ((row0 + i) * P + pos) * D + col0 + d;
    ck[dst] = knew[src];
    cv[dst] = vnew[src];
  }
}

template <typename T>
cudaError_t launch(const void* q, void* ck, void* cv, const void* kn,
                   const void* vn, const void* bias, void* out, int items,
                   int beam, int P, int pe, int D, int H, int pos,
                   float inv_scale, cudaStream_t stream) {
  const int hd = D / H;
  const size_t n = (size_t)beam * pe;
  const size_t smem = 4 * (2 * n * (hd * sizeof(T) / 4 + 1) + beam * hd
                           + beam * n);
  auto kernel = ancestry_attention_update_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(items, H), kThreads, smem, stream>>>(
      (const T*)q, (T*)ck, (T*)cv, (const T*)kn, (const T*)vn,
      (const float*)bias, (T*)out, beam, P, pe, D, hd, pos,
      inv_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_ancestry_attention_update(
    int dtype, const void* q, void* ck, void* cv, const void* kn,
    const void* vn, const void* bias, void* out, int items, int beam, int P,
    int pe, int D, int H, int pos, float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ck, cv, kn, vn, bias, out, items, beam,
                                 P, pe, D, H, pos, inv_scale, s);
  return launch<float>(q, ck, cv, kn, vn, bias, out, items, beam, P, pe, D,
                       H, pos, inv_scale, s);
}

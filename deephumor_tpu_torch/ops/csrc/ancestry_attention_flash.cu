// K8: K1's contract (write this position's K/V column in place, then
// ancestry self-attention) with the caches streamed in 8-position tiles and
// an online softmax across the tiles.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:
// ancestry_attention_update_flash (kernel _kernel_native4d_flash). The TPU
// kernel is a negative result there: its per-tile bookkeeping cost more
// than the early steps' saved reads. It is ported so that the question can
// be asked again on this card, beside K1.
//
// What it computes: each branch j of item g attends, per head, over every
// (slot i, position p <= pos) of its item with the flat ancestry bias
// [items, beam, beam * P] added to the scaled energies. Tiles are the
// positions [8t, 8t + 8) for t <= pos / 8, so the positions past pos in the
// last tile are read (and masked by the bias) and no tile past it leaves
// device memory. The fresh column at `pos` comes from k_new / v_new and is
// written into the caches at the end.
//
// Bound on the H100: bytes (the same K/V bytes as K1 at p_eff =
// 8 * (pos / 8 + 1)). Design: one block per (item, head), as K1, but the
// block stages one tile at a time (beam * 8 rows of K and of V, ~10 KB at
// beam 5 in bf16) instead of the whole prefix, so its shared memory does not
// grow with P. Per tile: energies for (branch, row) pairs, then one warp
// per branch rescales the branch's running max m and sum l, turns the
// tile's energies into weights exp(e - m) rounded to the cache dtype (as
// the TPU kernel rounds them before its AV product), and each thread
// rescales and accumulates its own (branch, column) sums in shared memory.
// The output is the sum over l. Four barriers per tile and no overlap of a
// tile's loads with the previous tile's arithmetic: the simple form first.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;  // positions per tile, as the TPU kernel's

// Row r of the tile at positions [p0, p0 + kTile) in one head's columns:
// slot r / kTile, position p0 + r % kTile; position `pos` comes from
// `fresh`.
template <typename T>
struct TileRows {
  const T* cache;
  const T* fresh;
  size_t row0;
  int P, D, col0, p0, pos;
  __device__ const uint4* operator()(int r) const {
    const int i = r / kTile, p = p0 + r % kTile;
    const T* base = p == pos ? fresh + (row0 + i) * D
                             : cache + ((row0 + i) * P + p) * D;
    return reinterpret_cast<const uint4*>(base + col0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ancestry_attention_flash_kernel(
    const T* __restrict__ q, T* __restrict__ ck, T* __restrict__ cv,
    const T* __restrict__ knew, const T* __restrict__ vnew,
    const float* __restrict__ bias, T* __restrict__ out, int beam, int P,
    int D, int hd, int pos, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int n = beam * kTile;               // (slot, position) rows a tile
  const int wpr = hd * (int)sizeof(T) / 4;  // 4-byte words per row
  const int ld = wpr + 1;                   // odd: conflict-free columns
  uint32_t* ks = smem_w;                    // [n][ld]
  uint32_t* vs = ks + n * ld;               // [n][ld]
  float* qs = reinterpret_cast<float*>(vs + n * ld);  // [beam][hd]
  float* acc = qs + beam * hd;              // [beam][hd]
  float* e = acc + beam * hd;               // [beam][n]
  float* m = e + beam * n;                  // [beam] running max
  float* l = m + beam;                      // [beam] running sum
  float* alpha = l + beam;                  // [beam] this tile's rescale
  const size_t row0 = (size_t)blockIdx.x * beam;
  const int col0 = blockIdx.y * hd;
  const int lane = threadIdx.x & 31;

  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    qs[t] = dh::to_f32(q[(row0 + t / hd) * D + col0 + t % hd]);
    acc[t] = 0.f;
  }
  for (int j = threadIdx.x; j < beam; j += blockDim.x) {
    m[j] = -1e30f;
    l[j] = 0.f;
  }

  for (int p0 = 0; p0 <= pos; p0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q, m, l are set
    dh::stage_rows(ks, ld, n, wpr / 4,
                   TileRows<T>{ck, knew, row0, P, D, col0, p0, pos});
    dh::stage_rows(vs, ld, n, wpr / 4,
                   TileRows<T>{cv, vnew, row0, P, D, col0, p0, pos});
    __syncthreads();

    for (int t = threadIdx.x; t < beam * n; t += blockDim.x) {
      const int j = t / n, r = t % n, i = r / kTile, p = p0 + r % kTile;
      const T* krow = reinterpret_cast<const T*>(ks + r * ld);
      const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
      e[t] = s + bias[((row0 + j) * beam + i) * P + p];
    }
    __syncthreads();

    // one warp per branch: rescale the running max and sum, weights in e
    for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5) {
      float* ej = e + j * n;
      float mt = -INFINITY;
      for (int r = lane; r < n; r += 32) mt = fmaxf(mt, ej[r]);
      mt = dh::warp_max(mt);
      const float mo = m[j], mn = fmaxf(mo, mt);
      float s = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float w = expf(ej[r] - mn);
        ej[r] = dh::to_f32(dh::from_f32<T>(w));
        s += w;
      }
      s = dh::warp_sum(s);  // every lane has read m[j] before this
      if (lane == 0) {
        const float a = expf(mo - mn);
        alpha[j] = a;
        l[j] = l[j] * a + s;
        m[j] = mn;
      }
    }
    __syncthreads();

    for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
      const int j = t / hd, d = t % hd;
      const float* w = e + j * n;
      float a = acc[t] * alpha[j];
      for (int r = 0; r < n; ++r)
        a = fmaf(w[r], dh::to_f32(reinterpret_cast<const T*>(vs + r * ld)[d]),
                 a);
      acc[t] = a;
    }
  }

  // each thread reads only its own acc entries; l is final since the last
  // tile's softmax barrier
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int j = t / hd;
    out[(row0 + j) * D + col0 + t % hd] = dh::from_f32<T>(acc[t] / l[j]);
  }

  // the cache column at `pos` was never read (it came from k_new / v_new),
  // so the write needs no barrier
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
                   int beam, int P, int D, int H, int pos, float inv_scale,
                   cudaStream_t stream) {
  const int hd = D / H;
  const size_t n = (size_t)beam * kTile;
  const size_t smem = 4 * (2 * n * (hd * sizeof(T) / 4 + 1) + 2 * beam * hd
                           + beam * n + 3 * beam);
  auto kernel = ancestry_attention_flash_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(items, H), kThreads, smem, stream>>>(
      (const T*)q, (T*)ck, (T*)cv, (const T*)kn, (const T*)vn,
      (const float*)bias, (T*)out, beam, P, D, hd, pos, inv_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_ancestry_attention_update_flash(
    int dtype, const void* q, void* ck, void* cv, const void* kn,
    const void* vn, const void* bias, void* out, int items, int beam, int P,
    int D, int H, int pos, float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ck, cv, kn, vn, bias, out, items, beam,
                                 P, D, H, pos, inv_scale, s);
  return launch<float>(q, ck, cv, kn, vn, bias, out, items, beam, P, D, H,
                       pos, inv_scale, s);
}

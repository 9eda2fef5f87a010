// K5: canonical-prefix ancestry attention, fused with the in-place write
// of this position's K/V column.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:
// ancestry_attention_update_canon (kernel _kernel_native4d_update_canon).
// Beam ancestries coalesce under survivor sampling: below a canonical
// length c, every live branch of most items descends from one path. The
// engine gathers that path once per phase into a per-item shared cache
// [items, c, D] (models/caption_models.py _canonicalize_state), so each
// branch j of item g attends over
//   * the shared rows [0, c) -- one row per position, bias [items, 1, c]
//     (validity only: all live branches agree there), and
//   * its item's per-slot window [c, p_eff) -- beam * w rows, w = p_eff - c,
//     with the flat ancestry bias [items, beam, beam * w],
// with one softmax over the joined support. The weights are rounded to the
// cache dtype before the AV product, as K1 does. The fresh column at `pos`
// (c <= pos < p_eff) comes from k_new / v_new and is written into the
// per-slot caches in place. Items whose live branches disagree below c
// (stragglers) get outputs from a stale shared path here; the engine
// recomputes their rows with K6. Their cache write is right all the same.
// Items at or past `live` (retired by early-EOS compaction) get zero rows
// and no cache write.
//
// Bound on the H100: bytes. At the char serving shape at p_eff 120
// (c 104, w 16, 768 items, beam 7, D 512, bf16) one launch reads ~164 MB
// of shared K+V and ~176 MB of window K+V, against 1.32 GB for K1 at the
// same p_eff. Design: K1's, over c + beam * w rows: one block per
// (item, head) stages the shared and the window rows of its head in shared
// memory with coalesced 16-byte loads, so each byte leaves device memory
// once, and writes its own slots' columns at `pos`; no block reads what
// another writes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Row r of one (item, head)'s joined support, as 16-byte vectors: r < c is
// shared position r; r >= c is window row (slot i, position c + p') with
// r - c = i * w + p'. Position `pos` of the window comes from `fresh`.
template <typename T>
struct CanonRows {
  const T* shared;
  const T* cache;
  const T* fresh;
  size_t item, row0;
  int cs, c, w, P, D, col0, pos;
  __device__ const uint4* operator()(int r) const {
    const T* base;
    if (r < c) {
      base = shared + (item * cs + r) * D;
    } else {
      const int i = (r - c) / w, p = c + (r - c) % w;
      base = p == pos ? fresh + (row0 + i) * D
                      : cache + ((row0 + i) * P + p) * D;
    }
    return reinterpret_cast<const uint4*>(base + col0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) canon_attention_update_kernel(
    const T* __restrict__ q, T* __restrict__ ck, T* __restrict__ cv,
    const T* __restrict__ sk, const T* __restrict__ sv,
    const T* __restrict__ knew, const T* __restrict__ vnew,
    const float* __restrict__ bias_sh, const float* __restrict__ bias_win,
    T* __restrict__ out, int live, int beam, int P, int cs, int c, int w,
    int D, int hd, int pos, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int n = c + beam * w;               // joined support
  const int wpr = hd * (int)sizeof(T) / 4;  // 4-byte words per row
  const int ld = wpr + 1;                   // odd: conflict-free columns
  uint32_t* ks = smem_w;                    // [n][ld]
  uint32_t* vs = ks + n * ld;               // [n][ld]
  float* qs = reinterpret_cast<float*>(vs + n * ld);  // [beam][hd]
  float* e = qs + beam * hd;                // [beam][n]
  const size_t item = blockIdx.x, row0 = item * beam;
  const int col0 = blockIdx.y * hd;
  if ((int)item >= live) {
    dh::zero_rows(out + row0 * D + col0, beam, hd, D);
    return;
  }

  dh::stage_rows(ks, ld, n, wpr / 4,
                 CanonRows<T>{sk, ck, knew, item, row0, cs, c, w, P, D, col0,
                              pos});
  dh::stage_rows(vs, ld, n, wpr / 4,
                 CanonRows<T>{sv, cv, vnew, item, row0, cs, c, w, P, D, col0,
                              pos});
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x)
    qs[t] = dh::to_f32(q[(row0 + t / hd) * D + col0 + t % hd]);
  __syncthreads();

  const int bw = beam * w;
  for (int t = threadIdx.x; t < beam * n; t += blockDim.x) {
    const int j = t / n, r = t % n;
    const T* krow = reinterpret_cast<const T*>(ks + r * ld);
    const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
    e[t] = s + (r < c ? bias_sh[item * c + r]
                      : bias_win[(row0 + j) * bw + (r - c)]);
  }
  __syncthreads();

  for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5)
    dh::warp_softmax_round<T>(e + j * n, n);
  __syncthreads();

  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int j = t / hd, d = t % hd;
    const float* wt = e + j * n;
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(wt[r],
                 dh::to_f32(reinterpret_cast<const T*>(vs + r * ld)[d]), acc);
    out[(row0 + j) * D + col0 + d] = dh::from_f32<T>(acc);
  }

  // the cache column at `pos` was never read above (it came from k_new /
  // v_new), so the write needs no barrier
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int i = t / hd, d = t % hd;
    const size_t src = (row0 + i) * D + col0 + d;
    const size_t dst = ((row0 + i) * P + pos) * D + col0 + d;
    ck[dst] = knew[src];
    cv[dst] = vnew[src];
  }
}

template <typename T>
cudaError_t launch(const void* q, void* ck, void* cv, const void* sk,
                   const void* sv, const void* kn, const void* vn,
                   const void* bias_sh, const void* bias_win, void* out,
                   int items, int live, int beam, int P, int cs, int c,
                   int pe, int D, int H, int pos, float inv_scale,
                   cudaStream_t stream) {
  const int hd = D / H, w = pe - c;
  const size_t n = (size_t)c + (size_t)beam * w;
  const size_t smem = 4 * (2 * n * (hd * sizeof(T) / 4 + 1) + beam * hd
                           + beam * n);
  auto kernel = canon_attention_update_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(items, H), kThreads, smem, stream>>>(
      (const T*)q, (T*)ck, (T*)cv, (const T*)sk, (const T*)sv, (const T*)kn,
      (const T*)vn, (const float*)bias_sh, (const float*)bias_win, (T*)out,
      live, beam, P, cs, c, w, D, hd, pos, inv_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_ancestry_attention_update_canon(
    int dtype, const void* q, void* ck, void* cv, const void* sk,
    const void* sv, const void* kn, const void* vn, const void* bias_sh,
    const void* bias_win, void* out, int items, int live, int beam, int P,
    int cs, int c, int pe, int D, int H, int pos, float inv_scale,
    void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(q, ck, cv, sk, sv, kn, vn, bias_sh,
                                 bias_win, out, items, live, beam, P, cs, c,
                                 pe, D, H, pos, inv_scale, s);
  return launch<float>(q, ck, cv, sk, sv, kn, vn, bias_sh, bias_win, out,
                       items, live, beam, P, cs, c, pe, D, H, pos,
                       inv_scale, s);
}

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
// and no cache write; the grid covers every item, and `live` is a launch
// argument or an int32 in device memory (dh::Count).
//
// Bound on the H100: bytes. At the char serving shape at p_eff 120
// (c 104, w 16, 768 items, beam 7, D 512, bf16) one launch must move
// ~364 MB (shared K+V 164 MB, the window's w - 1 cached positions K+V
// 165 MB, k_new / v_new read and written at `pos` 22 MB, q and the output
// 11 MB, the biases 3 MB): 0.109 ms at 3.35 TB/s. Its 6.2 GFLOP take the
// tensor cores ~6 us.
//
// bf16 (the serving dtype): the tensor-core body of attention_mma.cuh, one
// block of four warps per (item, head) over the c + beam * w rows (per chunk of
// 32 branches, for a beam above 32). The shared-load limit of a scalar design
// (each energy a 64-long dot of f32 q against bf16 K read one element at a
// time, each output a loop over every V row, a few hundred shared loads per 16
// rows) goes: each 16 rows cost one ldmatrix.x4 and one mma per 16 of head_dim
// in each product. Rows arrive by 16-byte cp.async into a ring of three 64-row
// tiles, so loads overlap the products and the softmax; a table of row codes
// keeps the divisions by w out of the copy loops. ~37 KB of shared memory at
// this shape keeps six blocks on an SM, and the grid (6144 blocks) fills the
// card many times over, so no cluster is needed. Heads vary fastest in the
// grid, so an item's eight heads read its 1 KB rows together. The block writes
// its own slots' columns at `pos` after its reads; no block reads what another
// writes.
//
// f32: exact f32 arithmetic on the CUDA cores (TF32 tensor cores would
// round q and K to 10 bits): one block per (item, head) stages the joined
// support in shared memory at an odd word stride and computes each energy
// and output element as a scalar loop.

#include "ancestry_update.cuh"
#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;  // the f32 kernel's block

// The joined support of one (item, head) and its biases, as both kernels
// read them. Row r < c is shared position r; row r >= c is window row
// (slot i, position c + p') with r - c = i * w + p', and position `pos` of
// the window comes from k_new / v_new. A row's code is its row in the
// shared caches [items * cs], in the per-slot caches [rows * P] (tag
// kCache) or in k_new / v_new [rows] (tag kFresh, rows `ldk` / `ldv`
// elements apart); the launcher refuses rows * P of 2^30 or more. `qrow0`
// is the row of the block's first query (the bf16 blocks take the branches
// in chunks).
constexpr uint32_t kCache = 1u << 30, kFresh = 2u << 30;
template <typename T>
struct CanonSupport {
  const T *sk, *sv, *ck, *cv, *knew, *vnew;
  const float *bias_sh, *bias_win;
  size_t item, row0, qrow0;
  int cs, c, w, P, D, col0, pos, bw, ldk, ldv;  // bw = beam * w
  __device__ uint32_t index(int r) const {
    if (r < c) return (uint32_t)(item * cs + r);
    const int i = (r - c) / w, p = c + (r - c) - i * w;
    return p == pos ? kFresh | (uint32_t)(row0 + i)
                    : kCache | (uint32_t)((row0 + i) * P + p);
  }
  __device__ const T* pick(const T* shared, const T* cache, const T* fresh,
                           int ldf, uint32_t x) const {
    const size_t row = x & (kCache - 1);
    return x >= kFresh ? fresh + row * ldf + col0
                       : (x >= kCache ? cache : shared) + row * D + col0;
  }
  __device__ const T* k(uint32_t x) const {
    return pick(sk, ck, knew, ldk, x);
  }
  __device__ const T* v(uint32_t x) const {
    return pick(sv, cv, vnew, ldv, x);
  }
  __device__ const float* bias(int j, int r, uint32_t) const {
    return r < c ? bias_sh + item * c + r
                 : bias_win + (qrow0 + j) * bw + (r - c);
  }
};

template <int NT>
__global__ void __launch_bounds__(dh::mma_attn::kThreads)
    canon_attention_mma_kernel(
        const bf16* __restrict__ q, bf16* __restrict__ ck,
        bf16* __restrict__ cv, const bf16* __restrict__ sk,
        const bf16* __restrict__ sv, const bf16* __restrict__ knew,
        const bf16* __restrict__ vnew, const float* __restrict__ bias_sh,
        const float* __restrict__ bias_win, bf16* __restrict__ out,
        dh::Count live, int beam, int P, int cs, int c, int w, int D,
        int hd, int pos, float inv_scale, int ldq, int ldk, int ldv) {
  extern __shared__ __align__(16) unsigned char smem[];
  // heads vary fastest, so an item's heads read its 1 KB rows together;
  // then the item's chunks of at most kMaxBeam branches
  const int H = D / hd, col0 = blockIdx.x % H * hd;
  const dh::mma_attn::Chunk<NT> ch(blockIdx.x, H, beam);
  const int nq = ch.nq;
  const size_t item = ch.sel, row0 = item * beam, qrow0 = row0 + ch.j0;
  if ((int)item >= live.get()) {
    dh::zero_rows(out + qrow0 * D + col0, nq, hd, D);
    return;
  }
  const CanonSupport<bf16> rows{sk, sv, ck, cv, knew, vnew, bias_sh,
                                bias_win, item, row0, qrow0, cs, c, w, P, D,
                                col0, pos, beam * w, ldk, ldv};
  dh::mma_attn::attend<NT>(rows, q + qrow0 * ldq + col0, ldq,
                           out + qrow0 * D + col0, D, c + beam * w, nq, hd,
                           inv_scale, 1, smem);
  // the cache column at `pos` was never read (it came from k_new / v_new)
  dh::write_column(ck, cv, knew, ldk, vnew, ldv, qrow0, nq, P, D, hd, col0,
                   pos);
}

__global__ void __launch_bounds__(kThreads) canon_attention_f32_kernel(
    const float* __restrict__ q, float* __restrict__ ck,
    float* __restrict__ cv, const float* __restrict__ sk,
    const float* __restrict__ sv, const float* __restrict__ knew,
    const float* __restrict__ vnew, const float* __restrict__ bias_sh,
    const float* __restrict__ bias_win, float* __restrict__ out,
    dh::Count live, int beam, int P, int cs, int c, int w, int D, int hd,
    int pos, float inv_scale, int ldq, int ldk, int ldv) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int n = c + beam * w;  // joined support
  const int ld = hd + 1;       // odd: conflict-free columns
  uint32_t* ks = smem_w;       // [n][ld]
  uint32_t* vs = ks + n * ld;  // [n][ld]
  float* qs = reinterpret_cast<float*>(vs + n * ld);  // [beam][hd]
  float* e = qs + beam * hd;                          // [beam][n]
  const size_t item = blockIdx.x, row0 = item * beam;
  const int col0 = blockIdx.y * hd;
  if ((int)item >= live.get()) {
    dh::zero_rows(out + row0 * D + col0, beam, hd, D);
    return;
  }

  const CanonSupport<float> rows{sk, sv, ck, cv, knew, vnew, bias_sh,
                                 bias_win, item, row0, row0, cs, c, w, P, D,
                                 col0, pos, beam * w, ldk, ldv};
  dh::stage_rows(ks, ld, n, hd / 4, [&](int r) {
    return reinterpret_cast<const uint4*>(rows.k(rows.index(r)));
  });
  dh::stage_rows(vs, ld, n, hd / 4, [&](int r) {
    return reinterpret_cast<const uint4*>(rows.v(rows.index(r)));
  });
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x)
    qs[t] = q[(row0 + t / hd) * ldq + col0 + t % hd];
  __syncthreads();

  for (int t = threadIdx.x; t < beam * n; t += blockDim.x) {
    const int j = t / n, r = t % n;
    const float* krow = reinterpret_cast<const float*>(ks + r * ld);
    const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
    e[t] = s + *rows.bias(j, r, 0);
  }
  __syncthreads();

  for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5)
    dh::warp_softmax_round<float>(e + j * n, n);
  __syncthreads();

  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int j = t / hd, d = t % hd;
    const float* wt = e + j * n;
    float acc = 0.f;
    for (int r = 0; r < n; ++r)
      acc = fmaf(wt[r], reinterpret_cast<const float*>(vs + r * ld)[d], acc);
    out[(row0 + j) * D + col0 + d] = acc;
  }
  // the cache column at `pos` was never read above, so the write needs no
  // barrier
  dh::write_column(ck, cv, knew, ldk, vnew, ldv, row0, beam, P, D, hd, col0,
                   pos);
}

template <int NT>
cudaError_t launch_mma(const void* q, void* ck, void* cv, const void* sk,
                       const void* sv, const void* kn, const void* vn,
                       const void* bias_sh, const void* bias_win, void* out,
                       int items, dh::Count live, int beam, int P, int cs,
                       int c, int pe, int D, int H, int pos, float inv_scale,
                       int ldq, int ldk, int ldv, cudaStream_t stream) {
  namespace ma = dh::mma_attn;
  const int hd = D / H, w = pe - c, n = c + beam * w;
  return ma::launch<&canon_attention_mma_kernel<NT>>(
      items * H * ma::beam_chunks(beam), 1,
      ma::smem_bytes(n, 1, ma::chunk_beam(beam), hd, NT), stream,
      (const bf16*)q, (bf16*)ck, (bf16*)cv, (const bf16*)sk, (const bf16*)sv,
      (const bf16*)kn, (const bf16*)vn, (const float*)bias_sh,
      (const float*)bias_win, (bf16*)out, live, beam, P, cs, c, w, D, hd,
      pos, inv_scale, ldq, ldk, ldv);
}

cudaError_t launch_f32(const void* q, void* ck, void* cv, const void* sk,
                       const void* sv, const void* kn, const void* vn,
                       const void* bias_sh, const void* bias_win, void* out,
                       int items, dh::Count live, int beam, int P, int cs,
                       int c, int pe, int D, int H, int pos, float inv_scale,
                       int ldq, int ldk, int ldv, cudaStream_t stream) {
  const int hd = D / H, w = pe - c;
  const size_t n = (size_t)c + (size_t)beam * w;
  const size_t smem = 4 * (2 * n * (hd + 1) + beam * hd + beam * n);
  auto kernel = canon_attention_f32_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(items, H), kThreads, smem, stream>>>(
      (const float*)q, (float*)ck, (float*)cv, (const float*)sk,
      (const float*)sv, (const float*)kn, (const float*)vn,
      (const float*)bias_sh, (const float*)bias_win, (float*)out, live, beam,
      P, cs, c, w, D, hd, pos, inv_scale, ldq, ldk, ldv);
  return cudaGetLastError();
}

}  // namespace

// live_ptr: NULL (`live_items` items are computed) or a device int32 that
// the kernel reads (a captured step's live count). q, k_new and v_new rows
// lie ldq, ldk and ldv elements apart (3 D for the views of a fused QKV
// product), each a multiple of 16 bytes; every other operand is contiguous.
extern "C" int dh_ancestry_attention_update_canon(
    int dtype, const void* q, int ldq, void* ck, void* cv, const void* sk,
    const void* sv, const void* kn, int ldk, const void* vn, int ldv,
    const void* bias_sh, const void* bias_win, void* out, int items,
    int live_items, const void* live_ptr, int beam, int P, int cs, int c,
    int pe, int D, int H, int pos, float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  const dh::Count live{(const int*)live_ptr, live_items};
  if (dtype != dh::kBFloat16)
    return launch_f32(q, ck, cv, sk, sv, kn, vn, bias_sh, bias_win, out,
                      items, live, beam, P, cs, c, pe, D, H, pos, inv_scale,
                      ldq, ldk, ldv, s);
  if ((size_t)items * beam * P >= kCache) return cudaErrorInvalidValue;
  return dh::mma_attn::dispatch(beam, D / H, [&](auto nt) {
    return launch_mma<decltype(nt)::value>(
        q, ck, cv, sk, sv, kn, vn, bias_sh, bias_win, out, items, live, beam,
        P, cs, c, pe, D, H, pos, inv_scale, ldq, ldk, ldv, s);
  });
}

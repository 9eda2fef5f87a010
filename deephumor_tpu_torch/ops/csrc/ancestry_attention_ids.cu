// K6: read-only full-width ancestry attention for a list of items, and K7:
// the same attention for every item.
//
// K6 replaces deephumor_tpu/ops/pallas_attention.py:ancestry_attention_ids
// (kernel _kernel_native4d_ids, whose body is the read-only
// _kernel_native4d). K7 replaces pallas_attention.py:ancestry_attention
// (kernels _kernel_native4d, _kernel and _kernel_blockdiag: three TPU
// layouts of one function, K1's attention without the cache write); its
// entry point, dh_ancestry_attention, runs K6's kernels (the same bf16
// body) with no id list, over the first p_eff positions of every item (the
// wrapper passes P for the layouts that read the whole cache). The
// canonical-prefix path (K5) gives straggler items -- live branches that
// still disagree below c -- outputs from a stale shared path; K6
// recomputes exactly those items over the full per-slot caches
// [0, p_eff) with the step's flat ancestry bias [items, beam, beam * P].
// The grid computes the first max(n_sel, 1) entries of an item-id list (the
// TPU grid is clamped the same way); rows of other items are not written.
// n_sel is a launch argument, and the grid then has max(n_sel, 1) entries,
// or an int32 in device memory (dh::Count) that the canonical-prefix
// boundary sets: the grid then covers the whole list (a captured step
// bakes it in, and the engine launches K6 on every canon step) and the
// blocks of entries at or past the count return at once.
//
// Bound on the H100: bytes. At the char config's last phase (beam 7 x
// p_eff 128 x D 512, bf16) each item moves ~1.87 MB: K+V 1.84 MB, its
// bias 25 KB, q and the output. 96 items: 180 MB, 0.054 ms at 3.35 TB/s;
// K7 over all 768 items: 1.44 GB, 0.430 ms (1.53 GB, 0.456 ms, for the
// layouts that read all 136 positions).
//
// bf16 (the serving dtype): the tensor-core body of attention_mma.cuh over an
// item's beam * p_eff rows (per chunk of 32 branches, for a beam above 32). The
// shared-load limit of a scalar design goes: each 16 rows cost one ldmatrix.x4
// and one mma per 16 of head_dim in each product, where the scalar loops spent
// a few hundred shared loads. K then V stream through a ring of three 64-row
// cp.async tiles, loads overlapping the products and the softmax, while every
// energy (<= 7 x 964 f32 = 27 KB) stays in shared memory for the exact two-pass
// softmax: ~56 KB a block at this shape. The grid is small on the real path:
// the char leg's boundaries leave 0-10 stragglers, n_sel x 8 working blocks on
// 132 SMs, each walking 28 tiles in turn. So a small grid spreads each (item,
// head) over a cluster of up to four blocks on four SMs, each taking a quarter
// of the tiles (a grid over the whole list of 768 items, the device count's,
// keeps one block per (item, head)); the blocks exchange each branch's max and sum through
// distributed shared memory (weights still normalised before rounding), then
// their partial outputs. K7's grids fill the card and keep one block per (item,
// head).
//
// f32: the two-pass CUDA-core body of attention_simt.cuh
// (ancestry_attention_f32_kernel): exact f32 arithmetic, K and V staged 256
// rows at a time, every energy in shared memory.

#include "attention_mma.cuh"
#include "attention_simt.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Row r of one item's (slot, position) rows in one head's columns: slot
// i = r / pe, position r % pe; its code is its row (row0 + i) * P + r % pe
// of the caches [rows * P] (the launcher refuses 2^32 or more). `anc` is
// the flat ancestry bias [items, beam, beam * P]; `qrow0` is the row of
// the block's first query (the bf16 blocks take the branches in chunks).
template <typename T>
struct CacheRows {
  const T* ck;
  const T* cv;
  const float* anc;
  size_t row0, qrow0;
  int beam, P, pe, D, col0;
  __device__ uint32_t index(int r) const {
    const int i = r / pe;
    return (uint32_t)((row0 + i) * P + (r - i * pe));
  }
  __device__ const T* k(uint32_t x) const { return ck + (size_t)x * D + col0; }
  __device__ const T* v(uint32_t x) const { return cv + (size_t)x * D + col0; }
  __device__ const float* bias(int j, int r, uint32_t x) const {
    return anc + (qrow0 + j) * beam * P + (x - row0 * P);
  }
};

// The item of block b (the b-th of the list, or item b for K7's NULL
// list), heads varying fastest so that an item's heads read its 1 KB rows
// together; -1 for an entry at or past max(n_sel, 1).
__device__ __forceinline__ int block_item(const int* ids, dh::Count n_sel,
                                          int b) {
  if (!ids) return b;
  return b < max(n_sel.get(), 1) ? ids[b] : -1;
}

// Clusters of `cs` consecutive blocks share one (item, head, chunk of at
// most kMaxBeam branches), heads varying fastest, then chunks.
template <int NT>
__global__ void __launch_bounds__(dh::mma_attn::kThreads)
    ancestry_attention_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ ck,
        const bf16* __restrict__ cv, const float* __restrict__ bias,
        const int* __restrict__ ids, dh::Count n_sel, bf16* __restrict__ out,
        int items, int beam, int P, int pe, int D, int hd, float inv_scale,
        int cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = D / hd, b = blockIdx.x / cs, col0 = b % H * hd;
  const dh::mma_attn::Chunk<NT> ch(b, H, beam);
  const int item = block_item(ids, n_sel, ch.sel), nq = ch.nq;
  if (item < 0 || item >= items) return;  // the whole cluster returns
  const size_t row0 = (size_t)item * beam, qrow0 = row0 + ch.j0;
  const CacheRows<bf16> rows{ck,   cv, bias, row0, qrow0,
                             beam, P,  pe,   D,    col0};
  dh::mma_attn::attend<NT>(rows, q + qrow0 * D + col0, D,
                           out + qrow0 * D + col0, D, beam * pe, nq, hd,
                           inv_scale, cs, smem);
}

__global__ void __launch_bounds__(dh::simt::kThreads)
    ancestry_attention_f32_kernel(
        const float* __restrict__ q, const float* __restrict__ ck,
        const float* __restrict__ cv, const float* __restrict__ bias,
        const int* __restrict__ ids, dh::Count n_sel, float* __restrict__ out,
        int items, int beam, int P, int pe, int D, int hd, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int item = block_item(ids, n_sel, blockIdx.x / (D / hd));
  if (item < 0 || item >= items) return;
  const size_t row0 = (size_t)item * beam;
  const int col0 = blockIdx.x % (D / hd) * hd;
  const CacheRows<float> rows{ck,   cv, bias, row0, row0,
                              beam, P,  pe,   D,    col0};
  dh::simt::attend<float>(rows, q + row0 * D + col0, D,
                          out + row0 * D + col0, D, beam * pe, beam, hd,
                          inv_scale, smem_w);
}

template <int NT>
cudaError_t launch_mma(const void* q, const void* ck, const void* cv,
                       const void* bias, const void* ids, dh::Count n_sel,
                       int entries, void* out, int items, int beam, int P,
                       int pe, int D, int H, float inv_scale,
                       cudaStream_t stream) {
  namespace ma = dh::mma_attn;
  const int hd = D / H, n = beam * pe;
  const int blocks = entries * H * ma::beam_chunks(beam);
  const int cs = ma::cluster_size(blocks, n);
  return ma::launch<&ancestry_attention_mma_kernel<NT>>(
      blocks * cs, cs, ma::smem_bytes(n, cs, ma::chunk_beam(beam), hd, NT),
      stream, (const bf16*)q, (const bf16*)ck, (const bf16*)cv,
      (const float*)bias, (const int*)ids, n_sel, (bf16*)out, items, beam, P,
      pe, D, hd, inv_scale, cs);
}

cudaError_t launch_f32(const void* q, const void* ck, const void* cv,
                       const void* bias, const void* ids, dh::Count n_sel,
                       int entries, void* out, int items, int beam, int P,
                       int pe, int D, int H, float inv_scale,
                       cudaStream_t stream) {
  const int hd = D / H;
  return dh::mma_attn::launch<&ancestry_attention_f32_kernel,
                              dh::simt::kThreads>(
      entries * H, 1, dh::simt::smem_bytes(beam * pe, beam, hd, 4), stream,
      (const float*)q, (const float*)ck, (const float*)cv,
      (const float*)bias, (const int*)ids, n_sel, (float*)out, items, beam,
      P, pe, D, hd, inv_scale);
}

// bf16 through the tensor-core kernel (n-tiles by beam), f32 through the
// CUDA-core kernel, over `entries` entries of the list `ids` (NULL for K7:
// item b for entry b).
int launch(int dtype, const void* q, const void* ck, const void* cv,
           const void* bias, const void* ids, dh::Count n_sel, int entries,
           void* out, int items, int beam, int P, int pe, int D, int H,
           float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if ((size_t)items * beam * P > UINT32_MAX) return cudaErrorInvalidValue;
  if (entries < 1) return cudaErrorInvalidValue;
  if (dtype != dh::kBFloat16)
    return launch_f32(q, ck, cv, bias, ids, n_sel, entries, out, items, beam,
                      P, pe, D, H, inv_scale, s);
  return dh::mma_attn::dispatch(beam, D / H, [&](auto nt) {
    return launch_mma<decltype(nt)::value>(q, ck, cv, bias, ids, n_sel,
                                           entries, out, items, beam, P, pe,
                                           D, H, inv_scale, s);
  });
}

}  // namespace

// n_sel_ptr: NULL (the grid computes the first n_sel >= 1 ids) or a device
// int32 that the kernel reads (a captured step's straggler count); the
// grid then walks n_sel entries of the list (its length, at most items),
// and those at or past max(count, 1) return.
extern "C" int dh_ancestry_attention_ids(
    int dtype, const void* q, const void* ck, const void* cv,
    const void* bias, const void* ids, void* out, int items, int n_sel,
    const void* n_sel_ptr, int beam, int P, int pe, int D, int H,
    float inv_scale, void* stream) {
  return launch(dtype, q, ck, cv, bias, ids,
                dh::Count{(const int*)n_sel_ptr, n_sel}, n_sel, out, items,
                beam, P, pe, D, H, inv_scale, stream);
}

// K7: the same kernels over every item (block x computes item x).
extern "C" int dh_ancestry_attention(int dtype, const void* q, const void* ck,
                                     const void* cv, const void* bias,
                                     void* out, int items, int beam, int P,
                                     int pe, int D, int H, float inv_scale,
                                     void* stream) {
  return launch(dtype, q, ck, cv, bias, nullptr, dh::Count{nullptr, items},
                items, out, items, beam, P, pe, D, H, inv_scale, stream);
}

// K1: beam self-attention over ancestry-indexed KV caches, fused with the
// in-place write of this position's K/V column.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:ancestry_attention_update
// (kernel _kernel_native4d_update). Per decode step and layer the caches
// are never reordered: each branch j of item g attends over every
// (slot i, position p < p_eff) of its item, and an additive f32 bias
// [items, beam, beam * P] (0 or -1e8, shared by all layers) selects the
// ancestor slot per position and masks invalid positions. Softmax runs in
// f32 over the flat (slot, position) axis; the weights are normalised and
// then rounded to the cache dtype before the AV product, as the TPU kernel
// does. The fresh column at `pos` is taken from k_new / v_new (never from
// the cache row), so each block writes its slots' columns into the caches
// in place before its reads; no block reads what another writes.
//
// Bound on the H100: bytes. At the word serving shape (8960 rows, p_eff
// 32, D 512, bf16) one launch must move ~630 MB (K + V of 31 cached
// positions 569 MB, q, k_new, v_new, the output and the two written
// columns 55 MB, the biases 5.7 MB): 0.188 ms at 3.35 TB/s; the arithmetic
// is ~0.2 GFLOP.
//
// bf16 (the serving dtype) at a head_dim of 16k up to 256: the tensor-core
// body `attend` of attention_mma.cuh (ancestry_attention_update_mma_kernel
// in a profile) over the beam * p_eff rows of one (item, head, chunk of
// at most 32 branches), its rows named by `UpdateRows` (ancestry_update.cuh:
// K7's rows with the column at `pos` tagged as a fresh row). K and V
// stream through a ring of three 64-row cp.async tiles, both products run
// as mma.sync on ldmatrix fragments, and only the f32 energies (7 x 900 x
// 4 bytes at char p_eff 128) stay in shared memory, so the shared memory
// of a block grows with the prefix by 4 bytes per (branch, row), not by
// its rows of K and V (~57 KB a block at that shape). Heads vary fastest
// in the grid, so an item's heads read its 1 KB rows together; a grid too
// small to fill the card spreads each (item, head) over a cluster of 2-4
// blocks.
//
// f32, and bf16 at any other head_dim: the two-pass CUDA-core body of
// attention_simt.cuh (ancestry_attention_update_simt_kernel), exact f32
// arithmetic, K and V staged 256 rows at a time. The launcher picks the
// kernel by dtype and head_dim before any launch.
//
// Early-EOS compaction keeps the live items first: blocks of items at or
// past `live` write zero output rows and neither read nor write the
// caches (the TPU kernel shrinks its grid and leaves those rows stale).
// The grid covers every item, and `live` is a launch argument or an int32
// in device memory (dh::Count) that a compaction boundary sets, so a
// captured step reads each call's own count.

#include "ancestry_update.cuh"
#include "attention_mma.cuh"
#include "attention_simt.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace ma = dh::mma_attn;

// Clusters of `cs` consecutive blocks share one (item, head, chunk of at
// most kMaxBeam branches), heads varying fastest, then chunks.
template <int NT>
__global__ void __launch_bounds__(ma::kThreads)
    ancestry_attention_update_mma_kernel(
        const bf16* __restrict__ q, bf16* __restrict__ ck,
        bf16* __restrict__ cv, const bf16* __restrict__ knew,
        const bf16* __restrict__ vnew, const float* __restrict__ bias,
        bf16* __restrict__ out, dh::Count live, int beam, int P, int pe,
        int D, int hd, int pos, float inv_scale, int cs, int ldq, int ldk,
        int ldv) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  const int H = D / hd, b = blockIdx.x / cs, col0 = b % H * hd;
  const ma::Chunk<NT> ch(b, H, beam);
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row0 = (size_t)ch.sel * beam, qrow0 = row0 + ch.j0;
  if (ch.sel >= live.get()) {  // the whole cluster returns
    if (rank == 0) dh::zero_rows(out + qrow0 * D + col0, ch.nq, hd, D);
    return;
  }
  // the cache column at `pos` is never read (it comes from k_new / v_new),
  // so it is written first, its latency under the reads
  dh::write_column(ck, cv, knew, ldk, vnew, ldv, qrow0, ch.nq, P, D, hd,
                   col0, pos, rank, cs);
  const dh::UpdateRows<bf16> rows{ck,   cv, knew, vnew, bias, row0, qrow0,
                                  beam, P,  pe,   D,    col0, pos,  ldk,
                                  ldv};
  ma::attend<NT>(rows, q + qrow0 * ldq + col0, ldq, out + qrow0 * D + col0,
                 D, beam * pe, ch.nq, hd, inv_scale, cs, smem);
}

template <typename T>
__global__ void __launch_bounds__(dh::simt::kThreads)
    ancestry_attention_update_simt_kernel(
        const T* __restrict__ q, T* __restrict__ ck, T* __restrict__ cv,
        const T* __restrict__ knew, const T* __restrict__ vnew,
        const float* __restrict__ bias, T* __restrict__ out, dh::Count live,
        int beam, int P, int pe, int D, int hd, int pos, float inv_scale,
        int ldq, int ldk, int ldv) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int H = D / hd, item = blockIdx.x / H, col0 = blockIdx.x % H * hd;
  const size_t row0 = (size_t)item * beam;
  if (item >= live.get()) {
    dh::zero_rows(out + row0 * D + col0, beam, hd, D);
    return;
  }
  dh::write_column(ck, cv, knew, ldk, vnew, ldv, row0, beam, P, D, hd, col0,
                   pos);
  const dh::UpdateRows<T> rows{ck,   cv, knew, vnew, bias, row0, row0,
                               beam, P,  pe,   D,    col0, pos,  ldk, ldv};
  dh::simt::attend<T>(rows, q + row0 * ldq + col0, ldq, out + row0 * D + col0,
                      D, beam * pe, beam, hd, inv_scale, smem_w);
}

bool use_mma(int dtype, int hd) {
  return dtype == dh::kBFloat16 && ma::takes(hd);
}

// The blocks (heads fastest) and cluster size of the tensor-core kernel.
void mma_grid(int items, int beam, int pe, int H, int* blocks, int* cs) {
  *blocks = items * H * ma::beam_chunks(beam);
  *cs = ma::cluster_size(*blocks, beam * pe);
}

size_t smem_bytes(int dtype, int items, int beam, int pe, int D, int H) {
  const int hd = D / H;
  if (!use_mma(dtype, hd))
    return dh::simt::smem_bytes(beam * pe, beam, hd,
                                dtype == dh::kBFloat16 ? 2 : 4);
  int blocks, cs;
  mma_grid(items, beam, pe, H, &blocks, &cs);
  return ma::smem_bytes(beam * pe, cs, ma::chunk_beam(beam), hd,
                        ma::n_tiles(beam));
}

template <typename T>
cudaError_t launch_simt(const void* q, void* ck, void* cv, const void* kn,
                        const void* vn, const void* bias, void* out,
                        int items, dh::Count live, int beam, int P, int pe,
                        int D, int H, int pos, float inv_scale, int ldq,
                        int ldk, int ldv, cudaStream_t stream) {
  const int hd = D / H;
  return ma::launch<&ancestry_attention_update_simt_kernel<T>,
                    dh::simt::kThreads>(
      items * H, 1, dh::simt::smem_bytes(beam * pe, beam, hd, sizeof(T)),
      stream, (const T*)q, (T*)ck, (T*)cv, (const T*)kn, (const T*)vn,
      (const float*)bias, (T*)out, live, beam, P, pe, D, hd, pos, inv_scale,
      ldq, ldk, ldv);
}

}  // namespace

// live_ptr: NULL (`live` items are computed) or a device int32 that the
// kernel reads (a captured step's live count). q, k_new and v_new rows lie
// ldq, ldk and ldv elements apart (D when contiguous; 3 D for the views of
// a fused QKV product), each a multiple of 16 bytes; the caches, the bias
// and the output are contiguous.
extern "C" int dh_ancestry_attention_update(
    int dtype, const void* q, int ldq, void* ck, void* cv, const void* kn,
    int ldk, const void* vn, int ldv, const void* bias, void* out, int items,
    int live_items, const void* live_ptr, int beam, int P, int pe, int D,
    int H, int pos, float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  const dh::Count live{(const int*)live_ptr, live_items};
  if ((size_t)items * beam * P >= dh::kFresh) return cudaErrorInvalidValue;
  if (!use_mma(dtype, D / H)) {
    if (dtype == dh::kBFloat16)
      return launch_simt<bf16>(q, ck, cv, kn, vn, bias, out, items, live,
                               beam, P, pe, D, H, pos, inv_scale, ldq, ldk,
                               ldv, s);
    return launch_simt<float>(q, ck, cv, kn, vn, bias, out, items, live, beam,
                              P, pe, D, H, pos, inv_scale, ldq, ldk, ldv, s);
  }
  return ma::dispatch(beam, D / H, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    int blocks, cs;
    mma_grid(items, beam, pe, H, &blocks, &cs);
    return ma::launch<&ancestry_attention_update_mma_kernel<NT>>(
        blocks * cs, cs,
        ma::smem_bytes(beam * pe, cs, ma::chunk_beam(beam), D / H, NT), s,
        (const bf16*)q, (bf16*)ck, (bf16*)cv, (const bf16*)kn,
        (const bf16*)vn, (const float*)bias, (bf16*)out, live, beam, P, pe,
        D, D / H, pos, inv_scale, cs, ldq, ldk, ldv);
  });
}

// The dynamic shared memory a block of dh_ancestry_attention_update needs
// at this shape (the wrapper compares it with the card's opt-in limit
// before the launch).
extern "C" long long dh_ancestry_attention_update_smem(int dtype, int items,
                                                       int beam, int pe,
                                                       int D, int H) {
  return (long long)smem_bytes(dtype, items, beam, pe, D, H);
}

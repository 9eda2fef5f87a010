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
// The tensor-core blocks read only the rows that some branch selects. Each
// block first lists its item's (slot, position < p_eff) rows that at least
// one of its branches' biases keeps (row_list.cuh: a scan of the block's
// bias rows, which it reads anyway, into a list of row codes in shared
// memory; the column at `pos` is a row like any other), then attends over
// the list. The dropped rows -- positions past `pos`, which every branch
// masks, and slots off every branch's ancestry -- had weight exactly 0, so
// the output is the dense rows' in another summation order. A block whose
// branch selects no row keeps the dense rows.
//
// Bound on the H100: bytes. At the word serving shape (8960 rows, p_eff
// 32, D 512, bf16) the dense rows are ~630 MB a launch (K + V of 31 cached
// positions 569 MB, q, k_new, v_new, the output and the two written
// columns 55 MB, the biases 5.7 MB): 0.188 ms at 3.35 TB/s. A beam search's
// ancestries keep ~26% of them (the word cell's searches: 1.3 distinct
// slots a position of 5 at the last step, and the masked positions of the
// p_eff 16 / 24 / 32 phases), so a launch moves ~209 MB (K + V 148 MB):
// 0.062 ms. The arithmetic is ~0.2 GFLOP dense.
//
// bf16 (the serving dtype) at a head_dim of 16k up to 256: the tensor-core
// body `attend` of attention_mma.cuh (ancestry_attention_update_mma_kernel
// in a profile) over the listed rows of one (item, head, chunk of at most
// 32 branches), its rows named by `UpdateRows` (ancestry_update.cuh:
// K7's rows with the column at `pos` tagged as a fresh row) through the
// list. K and V stream through a ring of three 64-row cp.async tiles, both
// products run as mma.sync on ldmatrix fragments, and only the f32
// energies (at most 7 x 900 x 4 bytes at char p_eff 128) stay in shared
// memory, so the shared memory of a block grows with the prefix by 4
// bytes per (branch, row) and 4 bytes a row of the list, not by its rows
// of K and V (~61 KB a block at that shape, sized for the dense rows).
// A list costs its block one more wait on memory (the biases, before the
// first K tile can load), and under the load of the other blocks' tiles
// that wait cost about as much as a tile. The list does not depend on the
// head, so a block takes up to four of an item's heads (as many as leave
// the grid 16 blocks an SM), lists once, writes their columns while the
// biases land, and attends the heads in turn; head groups vary fastest in
// the grid, so an item's heads read its 1 KB rows together. A grid too
// small to fill the card spreads each unit over a cluster of 2-4 blocks,
// whose list is padded to a tile a block.
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
#include "row_list.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace ma = dh::mma_attn;

// Clusters of `cs` consecutive blocks share one unit: an item, a chunk of
// at most kMaxBeam of its branches, and `hpb` of its heads, head groups
// varying fastest, then chunks. A block lists the rows its branches select
// (row_list.cuh) at the start of its shared memory, then attends each of
// its heads in turn over that one list in the rest. The list's code would
// take the one-n-tile kernel to 96 registers, five blocks an SM where the
// word shape's shared memory holds six: it is held to six (80 registers, a
// few spills), and the wider kernels to the blocks they held before.
template <int NT>
__global__ void __launch_bounds__(ma::kThreads, NT == 1 ? 6 : NT == 2 ? 5 : 3)
    ancestry_attention_update_mma_kernel(
        const bf16* __restrict__ q, bf16* __restrict__ ck,
        bf16* __restrict__ cv, const bf16* __restrict__ knew,
        const bf16* __restrict__ vnew, const float* __restrict__ bias,
        bf16* __restrict__ out, unsigned long long* __restrict__ tally,
        dh::Count live, int beam, int P, int pe, int D, int hd, int pos,
        float inv_scale, int cs, int ldq, int ldk, int ldv, int hpb) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  const int groups = D / hd / hpb, b = blockIdx.x / cs;
  const ma::Chunk<NT> ch(b, groups, beam);
  const int h0 = b % groups * hpb, col0 = h0 * hd;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const size_t row0 = (size_t)ch.sel * beam, qrow0 = row0 + ch.j0;
  if (ch.sel >= live.get()) {  // the whole cluster returns
    if (rank == 0)
      dh::zero_rows(out + qrow0 * D + col0, ch.nq, hpb * hd, D);
    return;
  }
  const int n = beam * pe;
  const bool vec = pe % 4 == 0 && P % 4 == 0
                   && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  uint32_t* list = reinterpret_cast<uint32_t*>(smem);
  unsigned char* body = smem + dh::row_list_bytes(n);
  const int stage_bytes = ma::kStages * ma::kTile * dh::padded_ld(hd) * 2;
  dh::UpdateRows<bf16> rows{ck,   cv, knew, vnew, bias, row0, qrow0,
                            beam, P,  pe,   D,    col0, pos,  ldk,
                            ldv};
  // the block's heads' cache columns at `pos` are never read (they come
  // from k_new / v_new), so they are written while the list's biases land
  const int walk = dh::build_row_list<ma::kThreads>(
      rows, n, ch.nq, (cs - 1) * ma::kTile + 1, vec, cs, list,
      reinterpret_cast<float*>(body), stage_bytes, [&] {
        dh::write_column(ck, cv, knew, ldk, vnew, ldv, qrow0, ch.nq, P, D,
                         hpb * hd, col0, pos, rank, cs);
      });
  if (h0 == 0 && rank == 0 && threadIdx.x == 0)
    dh::tally_rows(tally, ch.sel, walk, n);
  // `attend` ends on a barrier after its last read of shared memory, so
  // the next head may refill it; the list stays
  for (int h = h0; h < h0 + hpb; ++h) {
    rows.col0 = h * hd;
    ma::attend<NT>(dh::ListRows<dh::UpdateRows<bf16>>{rows, list},
                   q + qrow0 * ldq + rows.col0, ldq,
                   out + qrow0 * D + rows.col0, D, walk, ch.nq, hd,
                   inv_scale, cs, body);
  }
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

// The heads a block of the tensor-core kernel attends over its one list:
// the most of 1, 2 and 4 that divides the heads and leaves the grid at
// least 16 blocks an SM, so that a list's scan is paid once for several
// heads while the card stays full.
int heads_per_block(int units, int H) {
  int hpb = 1;
  while (2 * hpb <= 4 && H % (2 * hpb) == 0
         && units / (2 * hpb) >= 16 * dh::sm_count())
    hpb *= 2;
  return hpb;
}

// The blocks (head groups fastest), heads a block and cluster size of the
// tensor-core kernel.
void mma_grid(int items, int beam, int pe, int H, int* blocks, int* hpb,
              int* cs) {
  const int units = items * H * ma::beam_chunks(beam);
  *hpb = heads_per_block(units, H);
  *blocks = units / *hpb;
  *cs = ma::cluster_size(*blocks, beam * pe);
}

size_t smem_bytes(int dtype, int items, int beam, int pe, int D, int H) {
  const int hd = D / H;
  if (!use_mma(dtype, hd))
    return dh::simt::smem_bytes(beam * pe, beam, hd,
                                dtype == dh::kBFloat16 ? 2 : 4);
  int blocks, hpb, cs;
  mma_grid(items, beam, pe, H, &blocks, &hpb, &cs);
  return dh::row_list_bytes(beam * pe)
         + ma::smem_bytes(beam * pe, cs, ma::chunk_beam(beam), hd,
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
// kernel reads (a captured step's live count). tally: NULL or the device's
// int64 [2, kTallySlots] to which each head-0 block of the tensor-core
// kernel adds its rows read and its dense rows (row_list.cuh). q, k_new
// and v_new rows lie ldq, ldk and ldv elements apart (D when contiguous;
// 3 D for the views of a fused QKV product), each a multiple of 16 bytes;
// the caches, the bias and the output are contiguous.
extern "C" int dh_ancestry_attention_update(
    int dtype, const void* q, int ldq, void* ck, void* cv, const void* kn,
    int ldk, const void* vn, int ldv, const void* bias, void* out,
    void* tally, int items, int live_items, const void* live_ptr, int beam,
    int P, int pe, int D, int H, int pos, float inv_scale, void* stream) {
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
    int blocks, hpb, cs;
    mma_grid(items, beam, pe, H, &blocks, &hpb, &cs);
    return ma::launch<&ancestry_attention_update_mma_kernel<NT>>(
        blocks * cs, cs,
        dh::row_list_bytes(beam * pe)
            + ma::smem_bytes(beam * pe, cs, ma::chunk_beam(beam), D / H, NT),
        s, (const bf16*)q, (bf16*)ck, (bf16*)cv, (const bf16*)kn,
        (const bf16*)vn, (const float*)bias, (bf16*)out,
        (unsigned long long*)tally, live, beam, P, pe, D, D / H, pos,
        inv_scale, cs, ldq, ldk, ldv, hpb);
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

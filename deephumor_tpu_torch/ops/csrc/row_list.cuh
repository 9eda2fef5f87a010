// The row list of the ancestry kernels' tensor-core blocks: K1
// (ancestry_attention.cu), K6 and K7 (ancestry_attention_ids.cu).
//
// Their caches are never reordered: each branch of an item attends over
// every (slot i, position p < p_eff) row of its item, and the ancestry bias
// (0 or MASK_FILL = -1e8, ops/attention.py ancestry_bias) leaves it one slot
// a position. Most rows thus get weight exp(-1e8 - m) = 0 in f32 from every
// branch: the positions past `pos`, which every branch masks, and the slots
// that no branch's ancestry passes through (branches coalesce onto a few
// ancestors). Before its ring starts, a block lists the rows that at least
// one of its branches selects, and `attend` walks that list in place of the
// dense rows. The dropped rows had weight exactly 0, so the softmax and both
// products see the same numbers, summed in another order.
//
//   * A row is kept where some branch's bias there is above MASK_FILL (0 on
//     the real path, but any other value keeps it too).
//   * A branch selects a row where its bias is above MASK_FILL / 2. Where
//     some branch of the block selects none (all MASK_FILL: a branch valid
//     at no position), that branch's softmax runs over the -1e8-shifted
//     energies of every row, so the block keeps the dense rows. Otherwise
//     each branch's max is at least -5e7, and a dropped row's weight
//     exp(-1e8 + s - m) underflows to 0 for any energy s that a head can
//     give.
//   * A cluster of `cs` blocks splits tiles_of(n) among its ranks, and a
//     rank with no tile would miss the barriers of `attend`'s softmax. So
//     a list shorter than (cs - 1) * kTile + 1 rows is padded with dropped
//     rows (weight 0) to that length.
//
// The list is built from the bias rows that the block reads anyway (beam x
// beam * p_eff f32: 3.3 KB at the word config, 25 KB at char), staged in
// the shared memory that `attend` takes after it: one pass marks each kept
// row in 32-row words, and a second writes each kept row's 32-bit code at
// its place. The list lives in shared memory before `attend`'s region and
// is sized on the host for the dense rows.
#pragma once

#include <cooperative_groups.h>

#include "common.cuh"

namespace dh {

constexpr float kMaskFill = -1e8f;
// the tally's slots: rows read at [s], dense rows at [kTallySlots + s]
constexpr int kTallySlots = 32;

// Bytes of the list of up to `n` rows (a multiple of 16, so that the
// region after it keeps 16-byte alignment): n codes, two 32-row words of
// marks per 32 rows (this block's, and the cluster's), and a word of
// flags a warp.
__host__ __device__ inline size_t row_list_bytes(int n) {
  const size_t words = (n + 31) / 32;
  return (4 * (n + 2 * words + 4) + 15) / 16 * 16;
}

// `Dense`'s rows named by the list in shared memory: row r is the list's
// r-th code. Both dense sources (UpdateRows, CacheRows) key a row's K, V
// and bias by its code alone, so those pass through.
template <typename Dense>
struct ListRows {
  Dense d;
  const uint32_t* list;
  __device__ uint32_t index(int r) const { return list[r]; }
  __device__ auto k(uint32_t x) const { return d.k(x); }
  __device__ auto v(uint32_t x) const { return d.v(x); }
  __device__ const float* bias(int j, int r, uint32_t x) const {
    return d.bias(j, r, x);
  }
};

// Issues (and does not commit) the cp.async copies of the biases of rows
// [ra, rb) of every one of `nq` queries into `stage` ([nq][span] f32): 16
// bytes a copy with `vec` (every slot's p_eff positions a multiple of 4
// and their biases 16-byte aligned), else 4.
template <int Threads, typename Dense>
__device__ void stage_biases(const Dense& rows, int ra, int rb, int nq,
                             bool vec, float* stage, int span) {
  if (vec) {
    const int units = (rb - ra) / 4;
    for (int c = threadIdx.x; c < nq * units; c += Threads) {
      const int j = c / units, r = ra + 4 * (c - j * units);
      cp_async16(stage + j * span + (r - ra), rows.bias(j, r, rows.index(r)),
                 true);
    }
  } else {
    for (int c = threadIdx.x; c < nq * (rb - ra); c += Threads) {
      const int j = c / (rb - ra), r = ra + c - j * (rb - ra);
      cp_async4(stage + j * span + (r - ra), rows.bias(j, r, rows.index(r)));
    }
  }
}

// Builds the list of the dense rows [0, n) of `rows` (codes
// rows.index(r)) in `list` (row_list_bytes(n) bytes of shared memory, at
// the same offset in every block of a cluster of `cs`; 1: the block
// alone) for the block's `nq` queries, by all `Threads` threads of each
// block of the cluster; returns the rows the walk reads: the kept rows,
// padded to at least `min_rows` (at most n), or n where some query selects
// no row. Every block of the cluster computes the same list. Ends on a
// barrier.
//
// Block rank k of the cluster marks the rows of the 32-row words [k W /
// cs, (k + 1) W / cs) of the W = ceil(n / 32). Their biases of every query
// pass through `stage` (`stage_bytes` of shared memory that nothing uses
// until the list is built) in chunks of whole words, each chunk's copies
// all in flight at once, and `during()` runs while the first lands. Each
// warp then marks a word a lane a row from shared memory. After a cluster
// barrier each block reads every word and each warp's selecting queries
// from their owners, and each warp places the rows of its words: a row's
// place is the count of kept rows before it.
template <int Threads, typename Dense, typename During>
__device__ int build_row_list(const Dense& rows, int n, int nq, int min_rows,
                              bool vec, int cs, uint32_t* list, float* stage,
                              int stage_bytes, During&& during) {
  namespace cg = cooperative_groups;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int words = (n + 31) / 32;
  uint32_t* own = list + n;       // this block's words (others': stale)
  uint32_t* all = own + words;    // every word of the cluster
  uint32_t* flag = all + words;   // each warp's selecting queries
  const int r0 = 32 * (rank * words / cs);
  const int r1 = min(32 * ((rank + 1) * words / cs), n);
  // rows a chunk holds: whole words of every query's biases
  const int span = max(32, stage_bytes / (4 * nq) / 32 * 32);
  uint32_t live = 0;
  bool first = true;
  for (int ra = r0; ra < r1 || first; ra += span) {
    const int rb = min(ra + span, r1);
    stage_biases<Threads>(rows, ra, rb, nq, vec, stage, span);
    cp_async_commit();
    if (first) during();
    first = false;
    cp_async_wait<0>();
    __syncthreads();
    for (int w = ra / 32 + warp; 32 * w < rb; w += Threads / 32) {
      const int r = 32 * w + lane;
      bool keep = false;
      if (r < rb)
        for (int j = 0; j < nq; ++j) {
          const float b = stage[j * span + (r - ra)];
          keep |= b > kMaskFill;
          if (b > 0.5f * kMaskFill) live |= 1u << j;
        }
      const uint32_t m = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) own[w] = m;
    }
    __syncthreads();  // the stage is read: refilled next, or by the caller
  }
  live = __reduce_or_sync(0xffffffffu, live);
  if (lane == 0) flag[warp] = live;
  const uint32_t* marks = own;
  uint32_t selecting = 0;
  if (cs > 1) {
    cg::this_cluster().sync();
    for (int w = threadIdx.x; w < words; w += Threads) {
      int k = 0;
      while ((k + 1) * words / cs <= w) ++k;  // the word's owner
      all[w] = k == rank ? own[w]
                         : cg::this_cluster().map_shared_rank(own, k)[w];
    }
    for (int k = 0; k < cs; ++k)
      for (int i = 0; i < Threads / 32; ++i)
        selecting |= cg::this_cluster().map_shared_rank(flag, k)[i];
    __syncthreads();
    marks = all;
  } else {
    __syncthreads();
    for (int i = 0; i < Threads / 32; ++i) selecting |= flag[i];
  }

  // every warp counts the kept rows; warp k places the rows of words k,
  // k + warps, ...
  int kept = 0;
  for (int w = lane; w < words; w += 32) kept += __popc(marks[w]);
  kept = __reduce_add_sync(0xffffffffu, kept);
  const uint32_t want = nq >= 32 ? 0xffffffffu : (1u << nq) - 1;
  const bool listed = (selecting & want) == want;
  const int walk = listed ? min(max(kept, min_rows), n) : n;
  const int pad = walk - kept;
  for (int w = warp; w < words; w += Threads / 32) {
    const int r = 32 * w + lane;
    if (!listed) {
      if (r < n) list[r] = rows.index(r);
      continue;
    }
    int before = 0;
    for (int v = lane; v < w; v += 32) before += __popc(marks[v]);
    before = __reduce_add_sync(0xffffffffu, before);
    const uint32_t m = marks[w];
    const int s = before + __popc(m & ((1u << lane) - 1));
    const int u = r - s;  // dropped rows before r
    if (r >= n) continue;
    if (m >> lane & 1)
      list[s + min(u, pad)] = rows.index(r);
    else if (u < pad)
      list[s + u] = rows.index(r);
  }
  __syncthreads();
  return walk;
}

// Adds a block's rows read and dense rows to the tally (NULL: none), from
// one thread: `slot` spreads the blocks over kTallySlots addresses.
__device__ __forceinline__ void tally_rows(unsigned long long* tally,
                                           int slot, int read, int dense) {
  if (tally == nullptr) return;
  slot &= kTallySlots - 1;
  atomicAdd(tally + slot, (unsigned long long)read);
  atomicAdd(tally + kTallySlots + slot, (unsigned long long)dense);
}

}  // namespace dh

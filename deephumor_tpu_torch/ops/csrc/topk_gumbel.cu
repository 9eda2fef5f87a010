// K3: exact keep-ties top-k filter + Gumbel-top-k draw without
// replacement, one row of logits at a time per team of four warps.
//
// Replaces deephumor_tpu/ops/pallas_sampler.py:fused_topk_gumbel_sample
// (kernel _kernel + _sample_body). Per row:
//   1. the exact k-th largest value, by a bitwise threshold search on the
//      monotone int32 image of f32 ("order key"): t := the largest key
//      with count(key >= t) >= k. bf16 values occupy the key's top 16
//      bits, so the search stops at bit 15 (bit 0 for f32). Ties at the
//      threshold are kept.
//   2. UNK is masked; kept columns get Gumbel noise added to logit * 1/T.
//      The TPU's on-core PRNG becomes a counter-based hash of
//      (seed, row, column) -- the same integer ops run in the plain
//      PyTorch twin, so kernel and twin draw the same tokens. 24 high bits
//      give the uniform, floored at 1e-10. The seed is a launch argument
//      or an int32 in device memory that the kernel reads (dh::Seed): a
//      captured decode step keeps its seed there, and each replay draws
//      anew.
//   3. num_draws strictly decreasing maxima of the packed (perturbed order
//      key, flipped column) int32 -- ties go to the smallest column,
//      non-kept columns are unreachable, and an exhausted support yields
//      column 0.
//
// Bound on the H100: bytes (8960 x 29184 bf16 = 523 MB per step, 0.156 ms
// at 3.35 TB/s). The work per row is a few operations per logit, so the
// kernel keeps rows in flight and keeps barriers and serial searches off
// the per-row path.
//
// Design: persistent blocks (as many as fit on the card) of up to four
// teams of 128 threads; each team owns a row buffer in shared memory and
// walks the rows team, team + teams, ... Its next row streams in by bulk
// copy (cp.async.bulk, completing on the team's mbarrier) while its last
// row's draws run, and the other teams of the SM compute meanwhile: at
// V 29184 in bf16 (58 KB a row) three teams fit, in f32 (117 KB) one. A
// row too long for the vector table and a full list beside it (f32 past
// ~49.7K logits, bf16 past ~99K) drops the table, and its list shrinks to
// what fits: the gather then reads every vector, and a shorter list
// overflows sooner to the whole-row search, with the same result. A
// bulk copy needs 16-byte aligned addresses and sizes, so the row's aligned
// interior comes in bulk and its first and last few logits (rows of an odd
// V start unaligned) by plain loads. Per row, with four barriers of the
// team's own (bar.sync with a team id) and no search bit by bit:
//   * one pass over the staged row gives each thread its largest key, and
//     a table of each 16-byte vector's largest key (its high 16 bits);
//   * the top_k-th largest of the 128 thread maxima (distinct elements,
//     so at least top_k keys reach it) is a lower bound of the threshold:
//     each thread counts the maxima above its own (16-byte broadcast
//     reads), and the bound is the least maximum that fewer than top_k
//     others exceed;
//   * the keys >= that bound go into a list (~90 at the serving shape),
//     read from only the vectors whose table entry reaches the bound;
//     the buffer is then free for the next row's bulk copy;
//   * a list entry is kept when fewer than top_k list keys exceed it (the
//     list holds every key above the bound, so this is the row's exact
//     keep-ties top-k, the same set as the bitwise threshold); each kept
//     entry's packed draw key is computed once, and draw j is the entry
//     that exactly j packed keys exceed (ranks counted the same way).
// A list over its capacity (kCap, or less at the longest rows; massive
// ties) sends the team through the bitwise threshold search and the draws
// over the whole staged row, with team-wide reductions; that path is part
// of the kernel's definition.
//
// The row body lives in topk_rows.cuh: K4's streamed path runs it too,
// over the logits its product kernel writes.
//
// Early-EOS compaction keeps the live rows first: the teams walk only the
// first `live_rows` rows and the kernel gives the others id 0 (the wrapper
// gives them value 0). The noise hashes the global row, so a live row
// draws the same tokens whatever `live_rows` is. `live_rows` and 1/T are
// launch arguments or values in device memory (dh::Count, dh::InvT): a
// captured step reads each call's own; with a device count the grid is
// planned for every row.

#include "topk_rows.cuh"

namespace {

using namespace dh::topk;

template <typename T>
__global__ void __launch_bounds__(kTeam* kMaxTeams) topk_gumbel_kernel(
    const T* __restrict__ logits, int* __restrict__ ids, int rows,
    dh::Count live_rows, int V, int top_k, int num_draws, int unk,
    dh::Seed seed, dh::InvT invt, int low_bit, int col_bits,
    TeamLayout lay) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int live = min(max(live_rows.get(), 0), rows);
  // rows past `live`: id 0 (every block takes a share)
  for (size_t o = (size_t)live * num_draws + blockIdx.x * blockDim.x
                  + threadIdx.x;
       o < (size_t)rows * num_draws; o += (size_t)gridDim.x * blockDim.x)
    ids[o] = 0;
  sample_rows(smem, logits, V, live, V, 0, top_k, num_draws, unk, seed,
              invt.get(), low_bit, col_bits, lay, [=](int r, int j, int id) {
                ids[(size_t)r * num_draws + j] = id;
              });
}

template <typename T>
cudaError_t launch(const void* logits, void* ids, int rows,
                   dh::Count live_rows, int V, int top_k, int num_draws,
                   int unk, dh::Seed seed, dh::InvT invt,
                   cudaStream_t stream) {
  Plan p;
  cudaError_t err = plan<&topk_gumbel_kernel<T>>(
      V, sizeof(T), live_rows.ptr ? rows : live_rows.value, &p);
  if (err != cudaSuccess) return err;
  const int low_bit = sizeof(T) == 2 ? 15 : 0;
  int col_bits = 13;
  while ((1 << col_bits) < V) ++col_bits;
  topk_gumbel_kernel<T><<<p.blocks, p.threads, p.smem, stream>>>(
      (const T*)logits, (int*)ids, rows, live_rows, V, top_k, num_draws, unk,
      seed, invt, low_bit, col_bits, p.lay);
  return cudaGetLastError();
}

}  // namespace

// ids: int32 [rows, num_draws]. live_ptr, seed_ptr, invt_ptr: NULL (the
// value beside it is used) or a device int32 / int32 / f32 that the kernel
// reads at launch (a captured step's live rows, seed and 1/T).
extern "C" int dh_topk_gumbel_sample(int dtype, const void* logits, void* ids,
                                     int rows, int live_rows,
                                     const void* live_ptr, int V, int top_k,
                                     int num_draws, int unk, unsigned seed,
                                     const void* seed_ptr, float invt,
                                     const void* invt_ptr, void* stream) {
  auto s = (cudaStream_t)stream;
  const dh::Seed sd{(const int*)seed_ptr, seed};
  const dh::Count live{(const int*)live_ptr, live_rows};
  const dh::InvT it{(const float*)invt_ptr, invt};
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(logits, ids, rows, live, V, top_k,
                                 num_draws, unk, sd, it, s);
  return launch<float>(logits, ids, rows, live, V, top_k, num_draws, unk, sd,
                       it, s);
}

// The least dynamic shared memory a block needs at V logits: one team, no
// table, an empty list (the wrapper compares it with the card's opt-in
// limit before the launch).
extern "C" long long dh_topk_gumbel_sample_smem(int dtype, int V) {
  return (long long)smem_for(
      TeamLayout(V, dtype == dh::kBFloat16 ? 2 : 4, 0, false), 1);
}

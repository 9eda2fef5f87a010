// K4: the classifier product fused with K3's exact keep-ties top-k filter
// and Gumbel-top-k draw; the [rows, V] logits never reach device memory
// (on the resident path they never leave the block, on the streamed path
// they pass through L2).
//
// Replaces deephumor_tpu/ops/pallas_sampler.py:
// fused_classifier_topk_gumbel_sample (kernel _kernel_fused_classifier +
// _sample_body). Per row of hidden states x [D]:
//   1. logits = x @ W^T + b with bf16 x and W, f32 accumulation and an f32
//      bias, then rounded to bf16 (as the TPU kernel rounds them);
//   2. K3's draw over those logits: the exact k-th largest (ties kept),
//      UNK masked, the counter-hash noise of (seed, global row, column)
//      from common.cuh (the seed by value or read from device memory,
//      dh::Seed), num_draws strictly decreasing maxima of the packed
//      (perturbed key, flipped column); an exhausted support gives id 0;
//   3. the drawn ids (int64) and the rounded logits at those ids.
// Rows at or past `live_rows` (items retired by early-EOS compaction) are
// not computed; they get id 0 and value 0, so no stale id reaches a
// gather.
//
// Bound on the H100: bytes, and barely. At the char serving shape (5376
// rows, D 512, V 128, top_k 50, 7 draws) one launch reads 5.5 MB of
// hidden states and the 128 KB weight (~1.7 us at 3.35 TB/s); the product
// is 0.7 GFLOP (~0.7 us at the bf16 peak). What a kernel spends beyond
// that goes to reading W and the x tiles out of shared memory for the
// tensor cores (~16 KB a row with 16-row tiles) and to each row's search
// and draws.
//
// Resident path (classifier_resident_kernel; V up to kMaxV = 256 and W
// within the shared memory beside two x tiles: the char path). A block of
// 16 warps:
//   * W stays in shared memory: each block copies it once (cp.async, 16
//     bytes a thread and copy, into rows padded by 16 bytes so that
//     ldmatrix hits distinct banks; rows past V zero) and walks 16-row
//     tiles of the live rows, blockIdx.x, + gridDim.x, ...; the grid is
//     the live tiles' count, capped at the blocks that fit on the card, so
//     a late char step (~1,120 live rows) runs 70 blocks of one tile and
//     the full step 132 blocks of 2-3. The x tiles are double-buffered:
//     tile i + 2 is copied in while tile i is sampled.
//   * The product on mma.sync m16n8k16: warp u takes the 16 columns
//     [16u, 16u + 16) of V; per 16 of D one ldmatrix.x4 of the x tile (A),
//     one of W (B, two n-tiles), two mma. The f32 sums take the bias and
//     are rounded to bf16 into a [16, V] logits tile.
//   * Warp r samples row r of the tile with the row in registers (V / 32
//     values a lane, as 16-bit keys): the exact threshold by a count a bit
//     over the register-held keys, one warp reduction each (the earlier
//     body re-read and converted the row from shared memory for each of
//     its counts); the kept columns are compacted by ballots into a list
//     and perturbed once each (the hash and two logf of dh::packed_draw,
//     as the TPU kernel perturbs once, where the earlier body perturbed
//     every column again for each draw); the num_draws maxima are warp max
//     reductions over the register-held packed keys, and lane j % 32
//     writes draw j.
// The time goes to the row's serial reductions and the instructions
// around them, to the product's shared-memory reads (16 KB a row) and to
// each block's copy of W. Measured slower on the H100 and not kept
// (PERF.md keeps the record): bulk copies of W's and x's rows on
// mbarriers with 8 warps of two rows each; W by bulk copies multicast to
// clusters of 2 or 4 blocks; the threshold two bits a step with three
// counts packed in one reduction, or counted by ballots; the draws by rank
// counts over a list of the packed keys.
// Streamed path (any V above 256 up to 16384, or a W too large to stay
// resident: the 300-template sweep at V 2,006 and the demo's word leg at
// V 506 run it every decode step). Bound on the H100: operations at the
// sweep (x [1280, 512], W [2006, 512]: 2.6 GFLOP, ~2.7 us at the bf16
// peak) and up to V 16,384 (~22 us). Two kernels on the caller's stream
// per chunk of the live rows whose bf16 logits fit the scratch the wrapper
// allocates (kScratchBytes; one chunk up to 1,536 rows at V 16,384):
//   * classifier_product_kernel: a block takes a 64-row x 128-column tile
//     of the logits. A producer warp brings x's and W's 64-wide slices of
//     D into a ring of three stages by TMA (the 128-byte swizzle that
//     wgmma reads; rows past the chunk or V and columns past D arrive as
//     zeros, so W is never padded); one warpgroup multiplies each slice
//     with four wgmma m64n128k16, one slice in flight while the next
//     issues. The epilogue adds the bias and stores the bf16-rounded
//     logits, rows V rounded up to 8 apart (16-byte aligned rows). Each
//     W byte is read once per 64 rows.
//   * the draws from those rows. Up to V 1,024 a warp takes a row
//     (classifier_warp_draw_kernel): the row in registers as 16-bit keys
//     two a word, the exact k-th largest by a count a bit (paired compares
//     and popc, one warp reduction each), the kept columns compacted into
//     the warp's list and perturbed once each, the draws as warp max
//     reductions over it. Above, K3's teams of 128 threads
//     (classifier_draw_kernel over topk_rows.cuh: the per-vector max
//     table, the candidate list and its whole-row overflow path, one
//     perturbation per kept column, rank-count draws). The first chunk's
//     draw launch zeroes the rows past live_rows.
// Measured on the H100 and not kept (PERF.md keeps the record): the
// product on mma.sync m16n8k16 from ldmatrix fragments, 64 x 128 x 32
// tiles in four cp.async stages (0.0244 ms at the sweep, 0.191 ms at V
// 16,384 and 1,280 rows, against 0.0126 / 0.0837 kept); on wgmma from
// cp.async-filled swizzled tiles of 64 x 128 to 128 x 256, 3-5 stages
// (0.018-0.034 / 0.120-0.198 ms); TMA with 128 x 256 or 64 x 256 tiles
// or four stages (0.016-0.022 / 0.094-0.144 ms); chunks whose logits L2
// holds beside W (three launches at V 16,384: 0.093-0.101 ms); at V 257
// and 506 with top_k 64 and 70, K3's teams (fewer 16-byte vectors than
// top_k, so the whole row enters the list and is ranked pair by pair:
// 0.054 / 0.096 ms against the warp's 0.008); at V 2,006 the warp body
// (0.026-0.031 ms against the teams' 0.018). The product is bound by its
// loads (the four-stage variant took 0.0826 ms of its 0.100 at V 16,384
// without its stores, 0.0965 without its products), and persistent
// blocks, whose next tile's loads run under this tile's epilogue, did not
// help: 0.094 ms with 128 x 256 tiles, 0.082 with 64 x 128.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <algorithm>

#include "common.cuh"
#include "topk_rows.cuh"

namespace {

constexpr int kRows = 16;    // rows of one tensor-core row tile
constexpr int kMaxV = 256;   // the resident path's largest (padded) V

using bf16 = __nv_bfloat16;

// The bits of a packed draw key's column field at V columns.
int col_bits_of(int V) {
  int bits = 13;
  while ((1 << bits) < V) ++bits;
  return bits;
}

// ---- resident path ----

constexpr int kResWarps = kRows;  // a warp per row of a tile
constexpr int kResThreads = 32 * kResWarps;

// Shared memory of the resident kernel at (padded) V and D: W [Vp][D + 8],
// two x tiles [kRows][D + 8] and the logits tile [kRows][Vp + 8] in bf16,
// then each warp's list of kept columns [kMaxV].
struct ResidentLayout {
  int vp, ld, ldl;
  size_t w, x, lg, list, total;
  __host__ __device__ explicit ResidentLayout(int V, int D)
      : vp((V + 15) / 16 * 16), ld(D + 8), ldl(vp + 8) {
    w = 0;
    x = w + 2 * (size_t)vp * ld;
    lg = x + 2 * 2 * (size_t)kRows * ld;
    list = lg + 2 * (size_t)kRows * ldl;
    total = list + 4 * (size_t)kResWarps * kMaxV;
  }
};

// Copies rows [0, n) of a [*, D] bf16 matrix at `src` into `dst` (row
// stride ld) by cp.async, 16 bytes a thread and copy, and zero-fills rows
// [n, rows).
__device__ __forceinline__ void copy_rows(bf16* dst, int ld, const bf16* src,
                                          int D, int n, int rows) {
  const int chunks = D / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += kResThreads) {
    const int r = i / chunks, c = i % chunks * 8;
    dh::cp_async16(dst + r * ld + c, src + (size_t)(r < n ? r : 0) * D + c,
                   r < n);
  }
}

// kPer: a row's values per lane (4 up to V 128, else 8).
template <int kPer>
__global__ void __launch_bounds__(kResThreads, 1) classifier_resident_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ b, long long* __restrict__ ids,
    float* __restrict__ vals, int rows, int live, int V, int D, int top_k,
    int num_draws, int unk, dh::Seed seed, float invt, int col_bits) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ResidentLayout lay(V, D);
  const int vp = lay.vp, ld = lay.ld, ldl = lay.ldl;
  bf16* ws = reinterpret_cast<bf16*>(smem + lay.w);
  bf16* xs = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* lg = reinterpret_cast<bf16*>(smem + lay.lg);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* list =
      reinterpret_cast<uint32_t*>(smem + lay.list) + warp * kMaxV;

  // rows past `live`: id 0, value 0 (every block takes a share)
  for (size_t o = (size_t)live * num_draws + blockIdx.x * kResThreads
                  + threadIdx.x;
       o < (size_t)rows * num_draws; o += (size_t)gridDim.x * kResThreads) {
    ids[o] = 0;
    vals[o] = 0.f;
  }
  const int tiles = (live + kRows - 1) / kRows;
  if ((int)blockIdx.x >= tiles) return;

  // W (rows past V zero: never read, but finite for the tensor cores) and
  // the first tile in one group, the block's second tile in the next
  auto stage = [&](int tile, int buf) {
    copy_rows(xs + buf * kRows * ld, ld, x + (size_t)tile * kRows * D, D,
              min(kRows, live - tile * kRows), kRows);
  };
  copy_rows(ws, ld, w, D, V, vp);
  stage(blockIdx.x, 0);
  dh::cp_async_commit();
  if ((int)(blockIdx.x + gridDim.x) < tiles) stage(blockIdx.x + gridDim.x, 1);
  dh::cp_async_commit();

  // this warp's 16 columns u (if u < vp / 16) and their biases
  const int g = lane >> 2, t = lane & 3, u = warp;
  const bool has_unit = u < vp / 16;
  float bias[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * u + 8 * nt + 2 * t + h;
      bias[nt][h] = c < V ? b[c] : 0.f;
    }
  const int cmask = (1 << col_bits) - 1;

  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++it) {
    dh::cp_async_wait<1>();  // this tile's group (and W) is in
    __syncthreads();
    if (has_unit) {
      // logits [16 rows] x [16 columns]: per 16 of D one ldmatrix.x4 of x
      // (A), one of W (B: two n-tiles), two mma
      const bf16* xt = xs + (it & 1) * kRows * ld;
      float acc[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[nt][h] = 0.f;
      const bf16* arow = xt + (lane & 15) * ld + (lane >> 4) * 8;
      const bf16* brow =
          ws + (16 * u + (lane & 7) + (lane >> 4) * 8) * ld + (lane & 8);
#pragma unroll 4
      for (int k0 = 0; k0 < D; k0 += 16) {
        uint32_t a[4], bb[4];
        dh::ldmatrix_x4(a, arow + k0);
        dh::ldmatrix_x4(bb, brow + k0);
        const uint32_t b0[2] = {bb[0], bb[1]}, b1[2] = {bb[2], bb[3]};
        dh::mma_bf16_16816(acc[0], a, b0);
        dh::mma_bf16_16816(acc[1], a, b1);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<__nv_bfloat162*>(
              lg + (g + 8 * hh) * ldl + 16 * u + 8 * nt + 2 * t) =
              __floats2bfloat162_rn(acc[nt][2 * hh] + bias[nt][0],
                                    acc[nt][2 * hh + 1] + bias[nt][1]);
    }
    __syncthreads();  // the logits are in; the x buffer is free
    if (tile + 2 * (int)gridDim.x < tiles) stage(tile + 2 * gridDim.x, it & 1);
    dh::cp_async_commit();  // (an empty group past the last tile)

    if (warp < min(kRows, live - tile * kRows)) {
      const bf16* lr = lg + warp * ldl;
      const size_t rg = (size_t)tile * kRows + warp;
      // the row as unsigned 16-bit keys (order key's high half + 2^15);
      // -1 past V
      int key[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = 32 * i + lane;
        key[i] = c < V
                     ? (dh::order_key(__bfloat162float(lr[c])) >> 16) + 32768
                     : -1;
      }
      // p := the largest key with count(key >= p) >= top_k: the exact
      // k-th largest, a bit a step, each count over the register-held
      // keys and one warp reduction
      int p = 0;
#pragma unroll
      for (int bit = 15; bit >= 0; --bit) {
        const int cand = p | (1 << bit);
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < kPer; ++i) cnt += key[i] >= cand;
        if (__reduce_add_sync(0xffffffffu, cnt) >= top_k) p = cand;
      }
      // the kept columns, compacted: (bf16 bits << 16) | column
      int n = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int c = 32 * i + lane;
        const bool keep = key[i] >= p && c != unk;
        const uint32_t bal = __ballot_sync(0xffffffffu, keep);
        if (keep)
          list[n + __popc(bal & ((1u << lane) - 1))] =
              ((uint32_t)__bfloat16_as_ushort(lr[c]) << 16) | (uint32_t)c;
        n += __popc(bal);
      }
      __syncwarp();
      const uint32_t rh = dh::row_hash(seed.get(), (uint32_t)rg);
      int pk[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        pk[j] = INT32_MIN;
        if (32 * j + lane < n) {
          const uint32_t e = list[32 * j + lane];
          pk[j] = dh::packed_draw(
              __bfloat162float(__ushort_as_bfloat16((unsigned short)(e >> 16))),
              invt, rh, (int)(e & 0xFFFFu), cmask);
        }
      }
      int m = INT32_MAX;
      for (int d = 0; d < num_draws; ++d) {
        int best = INT32_MIN;
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          if (pk[j] < m) best = max(best, pk[j]);
        m = __reduce_max_sync(0xffffffffu, best);
        if (lane == (d & 31)) {
          const int id = m == INT32_MIN ? 0 : cmask - (m & cmask);
          ids[rg * num_draws + d] = id;
          vals[rg * num_draws + d] = __bfloat162float(lr[id]);
        }
      }
    }
    __syncthreads();  // the logits tile and the lists are read
  }
}

// Whether (V, D) runs the resident path on the current device.
bool resident(int V, int D) {
  return V <= kMaxV && ResidentLayout(V, D).total <= (size_t)dh::smem_optin();
}

template <int kPer>
cudaError_t launch_resident(const void* x, const void* w, const void* b,
                            void* ids, void* vals, int rows, int live, int V,
                            int D, int top_k, int num_draws, int unk,
                            dh::Seed seed, float invt, cudaStream_t stream) {
  const auto kernel = &classifier_resident_kernel<kPer>;
  const size_t smem = ResidentLayout(V, D).total;
  cudaError_t err = dh::prepare<&classifier_resident_kernel<kPer>>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kResThreads, smem);
  if (err != cudaSuccess) return err;
  const int tiles = (live + kRows - 1) / kRows;
  const int fit = (per_sm > 1 ? per_sm : 1) * dh::sm_count();
  kernel<<<std::max(1, std::min(tiles, fit)), kResThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (long long*)ids,
      (float*)vals, rows, live, V, D, top_k, num_draws, unk, seed, invt,
      col_bits_of(V));
  return cudaGetLastError();
}

// ---- streamed path ----

// The product's block tile: kBM rows x kBN columns of the logits (one
// warpgroup's m64n128 products), D in slices of kBK (one 128-byte swizzle
// row) through a ring of kStages stages, each x's rows, then W's rows; a
// producer warp beside the warpgroup fills the ring by TMA.
constexpr int kBM = 64, kBN = 128, kBK = 64, kStages = 3;
constexpr int kProductThreads = 128 + 32;
constexpr int kStageBytes = (kBM + kBN) * kBK * 2;
// the stages, their full and empty mbarriers, 1024 bytes of alignment
constexpr size_t kProductSmem =
    (size_t)kStages * kStageBytes + 16 * kStages + 1024;
// the bf16 logits of a chunk of rows: 1,280 rows at V 16,384 in one (a
// chunk of 512 rows, whose logits L2 holds beside W, measured slower)
constexpr size_t kScratchBytes = 48u << 20;

// The scratch's row stride: V rounded up to 8 (16-byte aligned rows).
int scratch_ld(int V) { return (V + 7) / 8 * 8; }

// Rows of one chunk: as many whole row tiles as kScratchBytes holds.
int chunk_rows(int V) {
  const int r = (int)(kScratchBytes / (2 * (size_t)scratch_ld(V))) / kBM * kBM;
  return std::max(kBM, r);
}

// A TMA copy of the box at (c0 along D, c1 along rows) of `map` into
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dh::smem_addr(dst)),
      "l"(map), "r"(c0), "r"(c1), "r"(dh::smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   dh::smem_addr(bar))
               : "memory");
}

// lg[r][c] = bf16(x[r] . W[c] + b[c]) for rows [0, m) and columns [0, V)
// of one tile of the grid (blockIdx.x: rows, blockIdx.y: columns), on
// wgmma from shared-memory tiles that TMA fills with the 128-byte swizzle
// (rows past m or V and columns past D arrive as zeros).
__global__ void __launch_bounds__(kProductThreads) classifier_product_kernel(
    const __grid_constant__ CUtensorMap xmap,
    const __grid_constant__ CUtensorMap wmap, const float* __restrict__ b,
    bf16* __restrict__ lg, int ld, int m, int V, int D) {
  extern __shared__ __align__(128) unsigned char tile_smem[];
  // the stages, 1024-byte aligned (the swizzle's atoms)
  unsigned char* tiles =
      tile_smem + ((1024 - (dh::smem_addr(tile_smem) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int ktiles = (D + kBK - 1) / kBK;
  if (threadIdx.x == 0)
    for (int s = 0; s < kStages; ++s) {
      dh::mbar_init(&full[s], 1);
      dh::mbar_init(&empty[s], 1);
    }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // the producer: slice kt into stage kt % kStages once the warpgroup
    // has released the slice before it there
    if (threadIdx.x == 128)
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) dh::mbar_wait(&empty[s], (kt / kStages - 1) & 1);
        unsigned char* st = tiles + s * kStageBytes;
        dh::mbar_expect_tx(&full[s], kStageBytes);
        tma_load(st, &xmap, kt * kBK, m0, &full[s]);
        tma_load(st + kBM * 128, &wmap, kt * kBK, n0, &full[s]);
      }
    return;
  }

  // the warpgroup: one slice's products in flight while it issues the
  // next slice's
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % kStages;
    dh::mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* st = tiles + s * kStageBytes;
    const uint64_t da = dh::wgmma_desc(st), db = dh::wgmma_desc(st + kBM * 128);
    dh::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      dh::wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    dh::wgmma_commit();
    // slice kt - 1's products are done: its stage goes back
    dh::wgmma_wait<1>();
    if (kt > 0 && threadIdx.x == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
  }
  dh::wgmma_wait<0>();

  // thread t: rows 16 (t / 32) + (t % 32) / 4 and + 8, columns 8 j +
  // 2 (t % 4) and + 1; a pair past V's odd edge writes the row's pad column
  const int lane = threadIdx.x & 31;
  const int r0 = m0 + 16 * (threadIdx.x >> 5) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (lane & 3);
    if (c >= V) continue;
    const float b0 = b[c], b1 = c + 1 < V ? b[c + 1] : 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (r0 + 8 * hh < m)
        *reinterpret_cast<__nv_bfloat162*>(lg + (size_t)(r0 + 8 * hh) * ld
                                           + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hh] + b0,
                                  acc[4 * j + 2 * hh + 1] + b1);
  }
}

// The TMA map of a bf16 [rows, D] matrix at `base` in boxes of 64 x
// `box_rows`, 128-byte swizzled, zeros outside (cuTensorMapEncodeTiled,
// reached through the runtime, so that nothing links the driver).
cudaError_t tensor_map(CUtensorMap* map, const void* base, int rows, int D,
                       int box_rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The draws of rows [row0, row0 + n) from their logits lg (row r at lg + r
// * ld), by K3's row body; ids and vals of rows [zero_from, rows) are set
// to 0 first.
__global__ void __launch_bounds__(dh::topk::kTeam* dh::topk::kMaxTeams)
    classifier_draw_kernel(const bf16* __restrict__ lg, int ld,
                           long long* __restrict__ ids,
                           float* __restrict__ vals, int row0, int n,
                           int zero_from, int rows, int V, int top_k,
                           int num_draws, int unk, dh::Seed seed, float invt,
                           int col_bits, dh::topk::TeamLayout lay) {
  for (size_t o = (size_t)zero_from * num_draws + blockIdx.x * blockDim.x
                  + threadIdx.x;
       o < (size_t)rows * num_draws; o += (size_t)gridDim.x * blockDim.x) {
    ids[o] = 0;
    vals[o] = 0.f;
  }
  extern __shared__ __align__(16) unsigned char team_smem[];
  dh::topk::sample_rows(
      team_smem, lg, ld, n, V, row0, top_k, num_draws, unk, seed, invt, 15,
      col_bits, lay, [=](int r, int j, int id) {
        const size_t o = (size_t)(row0 + r) * num_draws + j;
        ids[o] = id;
        vals[o] = __bfloat162float(lg[(size_t)r * ld + id]);
      });
}

// Rows of up to kWarpRowV logits draw by a warp each (below); longer rows
// by K3's teams. A warp's row is 16-byte vectors 32 u + lane, u < kVec.
constexpr int kWarpRowWarps = 8;
constexpr int kWarpRowV = 1024;

// The unsigned 16-bit order keys of a word of two bf16 logits (the low
// half is the lower column): a positive value's bits with the sign set, a
// negative value's bits flipped.
__device__ __forceinline__ uint32_t key_pair(uint32_t w) {
  return w ^ ((((w >> 15) & 0x10001u) * 0x7FFFu) | 0x80008000u);
}
// A mask of a word's low and high halves.
__device__ __forceinline__ uint32_t halves(bool lo, bool hi) {
  return (lo ? 0x0000FFFFu : 0u) | (hi ? 0xFFFF0000u : 0u);
}
// The logit of a 16-bit order key.
__device__ __forceinline__ float key_logit(uint32_t k) {
  return __uint_as_float((k ^ (k & 0x8000u ? 0x8000u : 0xFFFFu)) << 16);
}

// The draws of rows [row0, row0 + n) from their logits lg (row r at lg + r
// * ld, V <= 256 kVec), a warp a row with the row in registers: the exact
// k-th largest key by a count a bit (16-bit keys two a register, compared
// in pairs), the kept columns' packed draw keys computed once into the
// warp's list, then num_draws warp max reductions over the list. Ids and
// vals of rows [zero_from, rows) are set to 0 first.
template <int kVec>
__global__ void __launch_bounds__(32 * kWarpRowWarps)
    classifier_warp_draw_kernel(const bf16* __restrict__ lg, int ld,
                                long long* __restrict__ ids,
                                float* __restrict__ vals, int row0, int n,
                                int zero_from, int rows, int V, int top_k,
                                int num_draws, int unk, dh::Seed seed,
                                float invt, int col_bits) {
  for (size_t o = (size_t)zero_from * num_draws + blockIdx.x * blockDim.x
                  + threadIdx.x;
       o < (size_t)rows * num_draws; o += (size_t)gridDim.x * blockDim.x) {
    ids[o] = 0;
    vals[o] = 0.f;
  }
  extern __shared__ __align__(16) int warp_lists[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* list = warp_lists + warp * 256 * kVec;
  const int cmask = (1 << col_bits) - 1;
  for (int r = blockIdx.x * kWarpRowWarps + warp; r < n;
       r += gridDim.x * kWarpRowWarps) {
    const bf16* lr = lg + (size_t)r * ld;
    // key word 4 u + e holds columns 8 (32 u + lane) + 2 e and + 1; a
    // column past V keys 0 and is never kept
    uint32_t key[4 * kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const int c0 = 8 * (32 * u + lane);
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      if (c0 < V) q = reinterpret_cast<const uint4*>(lr)[32 * u + lane];
      const uint32_t wd[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        key[4 * u + e] = key_pair(wd[e]) & halves(c0 + 2 * e < V,
                                                  c0 + 2 * e + 1 < V);
    }
    // p := the largest key with count(key >= p) >= top_k (a matching
    // half counts 16 in the popc)
    uint32_t p = 0;
#pragma unroll
    for (int bit = 15; bit >= 0; --bit) {
      const uint32_t cand = p | (1u << bit);
      int cnt = 0;
#pragma unroll
      for (int i = 0; i < 4 * kVec; ++i)
        cnt += __popc(__vcmpgeu2(key[i], cand * 0x10001u));
      if (__reduce_add_sync(0xffffffffu, cnt) >= 16 * top_k) p = cand;
    }
    // the kept columns (key >= p, not UNK, before V): each lane's count,
    // its offset by a warp scan, then their packed draw keys in the list
    uint32_t keep[4 * kVec];
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) {
      const int c = 8 * (32 * (i / 4) + lane) + 2 * (i % 4);
      keep[i] = __vcmpgeu2(key[i], p * 0x10001u)
                & halves(c < V && c != unk, c + 1 < V && c + 1 != unk);
      cnt += __popc(keep[i]) >> 4;
    }
    int at = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(0xffffffffu, at, o);
      if (lane >= o) at += t;
    }
    const int total = __shfl_sync(0xffffffffu, at, 31);
    at -= cnt;
    // (key << 16) | column into the list, then each entry's packed draw
    // key in its place, the warp's lanes over consecutive entries
#pragma unroll
    for (int i = 0; i < 4 * kVec; ++i) {
      const int c = 8 * (32 * (i / 4) + lane) + 2 * (i % 4);
      if (keep[i] & 0xFFFFu) list[at++] = (int)(key[i] << 16 | c);
      if (keep[i] >> 16) list[at++] = (int)((key[i] & 0xFFFF0000u) | (c + 1));
    }
    __syncwarp();
    const uint32_t rh = dh::row_hash(seed.get(), (uint32_t)(row0 + r));
    for (int j = lane; j < total; j += 32) {
      const uint32_t e = (uint32_t)list[j];
      list[j] = dh::packed_draw(key_logit(e >> 16), invt, rh,
                                (int)(e & 0xFFFFu), cmask);
    }
    __syncwarp();
    int m = INT32_MAX;
    for (int d = 0; d < num_draws; ++d) {
      int best = INT32_MIN;
      for (int j = lane; j < total; j += 32)
        if (list[j] < m) best = max(best, list[j]);
      m = __reduce_max_sync(0xffffffffu, best);
      if (lane == (d & 31)) {
        const int id = m == INT32_MIN ? 0 : cmask - (m & cmask);
        const size_t o = (size_t)(row0 + r) * num_draws + d;
        ids[o] = id;
        vals[o] = __bfloat162float(lr[id]);
      }
    }
    __syncwarp();  // the list is read before the next row's
  }
}

template <int kVec>
cudaError_t launch_warp_draw(const bf16* lg, int ld, void* ids, void* vals,
                             int row0, int n, int zero_from, int rows, int V,
                             int top_k, int num_draws, int unk, dh::Seed seed,
                             float invt, cudaStream_t stream) {
  const auto kernel = &classifier_warp_draw_kernel<kVec>;
  const size_t smem = (size_t)4 * kWarpRowWarps * 256 * kVec;
  cudaError_t err = dh::prepare<&classifier_warp_draw_kernel<kVec>>();
  int per_sm = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, 32 * kWarpRowWarps, smem);
  if (err != cudaSuccess) return err;
  const int want = (n + kWarpRowWarps - 1) / kWarpRowWarps;
  const int fit = (per_sm > 1 ? per_sm : 1) * dh::sm_count();
  kernel<<<std::max(1, std::min(want, fit)), 32 * kWarpRowWarps, smem,
           stream>>>(lg, ld, (long long*)ids, (float*)vals, row0, n,
                     zero_from, rows, V, top_k, num_draws, unk, seed, invt,
                     col_bits_of(V));
  return cudaGetLastError();
}

// The draws of one chunk: a warp a row up to kWarpRowV logits, else K3's
// teams.
cudaError_t launch_draw(const bf16* lg, int ld, void* ids, void* vals,
                        int row0, int n, int zero_from, int rows, int V,
                        int top_k, int num_draws, int unk, dh::Seed seed,
                        float invt, cudaStream_t stream) {
  const auto warp_draw = V <= 256   ? &launch_warp_draw<1>
                         : V <= 512 ? &launch_warp_draw<2>
                         : V <= kWarpRowV ? &launch_warp_draw<4>
                                          : nullptr;
  if (warp_draw)
    return warp_draw(lg, ld, ids, vals, row0, n, zero_from, rows, V, top_k,
                     num_draws, unk, seed, invt, stream);
  dh::topk::Plan p;
  cudaError_t err = dh::topk::plan<&classifier_draw_kernel>(V, 2, n, &p);
  if (err != cudaSuccess) return err;
  classifier_draw_kernel<<<p.blocks, p.threads, p.smem, stream>>>(
      lg, ld, (long long*)ids, (float*)vals, row0, n, zero_from, rows, V,
      top_k, num_draws, unk, seed, invt, col_bits_of(V), p.lay);
  return cudaGetLastError();
}

// Per chunk of the live rows: the product into the scratch, then the
// draws from it; the first chunk's draws zero the rows past `live` (with
// no live row, that is the one launch).
cudaError_t launch_streamed(const void* x, const void* w, const void* b,
                            void* ids, void* vals, void* scratch, int rows,
                            int live, int V, int D, int top_k, int num_draws,
                            int unk, dh::Seed seed, float invt,
                            cudaStream_t stream) {
  cudaError_t err = dh::prepare<&classifier_product_kernel>();
  if (err != cudaSuccess) return err;
  const int ld = scratch_ld(V), chunk = chunk_rows(V);
  auto* lg = (bf16*)scratch;
  for (int r0 = 0;; r0 += chunk) {
    const int n = std::min(chunk, live - r0);
    if (n > 0) {
      CUtensorMap xmap, wmap;
      if ((err = tensor_map(&xmap, (const bf16*)x + (size_t)r0 * D, n, D,
                            kBM)) != cudaSuccess
          || (err = tensor_map(&wmap, w, V, D, kBN)) != cudaSuccess)
        return err;
      const dim3 grid((n + kBM - 1) / kBM, (V + kBN - 1) / kBN);
      classifier_product_kernel<<<grid, kProductThreads, kProductSmem,
                                  stream>>>(
          xmap, wmap, (const float*)b, lg, ld, n, V, D);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    err = launch_draw(lg, ld, ids, vals, r0, std::max(n, 0),
                      r0 == 0 ? live : rows, rows, V, top_k, num_draws, unk,
                      seed, invt, stream);
    if (err != cudaSuccess) return err;
    if (r0 + chunk >= live) return cudaSuccess;
  }
}

}  // namespace

// The scratch bytes (bf16 logits) that a call at (V, D) with `live` live
// rows needs on the current device: none on the resident path.
extern "C" long long dh_classifier_topk_gumbel_sample_scratch(int V, int D,
                                                              int live) {
  if (resident(V, D)) return 0;
  return 2LL * scratch_ld(V) * std::min(std::max(live, 0), chunk_rows(V));
}

// x: bf16 [rows, D]; w: bf16 [V, D], both 16-byte aligned, D a multiple of
// 16; b: f32 [V]; ids: int64 [rows, num_draws]; vals: f32 [rows,
// num_draws]; scratch: the bytes dh_classifier_topk_gumbel_sample_scratch
// gives (NULL if none).
extern "C" int dh_classifier_topk_gumbel_sample(
    const void* x, const void* w, const void* b, void* ids, void* vals,
    void* scratch, int rows, int live_rows, int V, int D, int top_k,
    int num_draws, int unk, unsigned seed, const void* seed_ptr, float invt,
    void* stream) {
  auto s = (cudaStream_t)stream;
  const dh::Seed sd{(const int*)seed_ptr, seed};
  if (resident(V, D) && V <= 128)
    return launch_resident<4>(x, w, b, ids, vals, rows, live_rows, V, D,
                              top_k, num_draws, unk, sd, invt, s);
  if (resident(V, D))
    return launch_resident<8>(x, w, b, ids, vals, rows, live_rows, V, D,
                              top_k, num_draws, unk, sd, invt, s);
  return launch_streamed(x, w, b, ids, vals, scratch, rows, live_rows, V, D,
                         top_k, num_draws, unk, sd, invt, s);
}

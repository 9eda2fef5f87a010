// K4: the classifier product fused with K3's exact keep-ties top-k filter
// and Gumbel-top-k draw; the [rows, V] logits never leave the block.
//
// Replaces deephumor_tpu/ops/pallas_sampler.py:
// fused_classifier_topk_gumbel_sample (kernel _kernel_fused_classifier +
// _sample_body). Per row of hidden states x [D]:
//   1. logits = x @ W^T + b with bf16 x and W, f32 accumulation and an f32
//      bias, then rounded to bf16 (as the TPU kernel rounds them);
//   2. K3's draw over those logits: the exact k-th largest (ties kept),
//      UNK masked, the counter-hash noise of (seed, global row, column)
//      from common.cuh, num_draws strictly decreasing maxima of the packed
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
// Streamed path (classifier_streamed_kernel; any larger V up to 16384, or
// a W too large to stay resident): the earlier body. A block takes up to
// 16 rows (fewer at large V, where their logits must still fit in shared
// memory), its 8 warps multiply 16-column slices of W on the tensor cores
// (wmma, W's fragments from global memory: W must be padded to 16 rows),
// and one warp samples one row over the logits in shared memory (the
// 16-step bitwise threshold search and a perturbation per draw pass). No
// serving leg runs it.

#include <mma.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;    // rows of one tensor-core row tile
constexpr int kMaxV = 256;   // the resident path's largest (padded) V

using bf16 = __nv_bfloat16;

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
    int num_draws, int unk, uint32_t seed, float invt, int col_bits) {
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
      const uint32_t rh = dh::row_hash(seed, (uint32_t)rg);
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

// ---- streamed path ----

constexpr int kTileN = 16 * kWarps;  // columns per pass of the warps
constexpr int kLowBit = 15;  // bf16 logits: keys differ above bit 15

// Row r of a [*, D] bf16 matrix, as 16-byte vectors.
struct MatRows {
  const bf16* base;
  int D;
  __device__ const uint4* operator()(int r) const {
    return reinterpret_cast<const uint4*>(base + (size_t)r * D);
  }
};

// This warp's count of keys >= cand over one row of bf16 logits.
__device__ __forceinline__ int warp_count_ge(const bf16* row, int V,
                                             int cand) {
  int k = 0;
  for (int c = threadIdx.x & 31; c < V; c += 32)
    k += dh::order_key(__bfloat162float(row[c])) >= cand;
  return __reduce_add_sync(0xffffffffu, k);
}

__global__ void __launch_bounds__(kThreads) classifier_streamed_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const float* __restrict__ b, long long* __restrict__ ids,
    float* __restrict__ vals, int rows, int live_rows, int V, int D, int R,
    int top_k, int num_draws, int unk, uint32_t seed, float invt,
    int col_bits) {
  extern __shared__ __align__(128) uint32_t smem_w[];
  // bf16 row stride D + 8: rows stay 16-byte aligned and a multiple of 8
  // elements, as wmma's loads want
  const int ld = D + 8, ldw = ld / 2;  // in bf16 values / 4-byte words
  constexpr int ldc = kTileN + 4;      // f32 sums
  uint32_t* xs = smem_w;                              // [kRows][ldw]
  float* cs = reinterpret_cast<float*>(xs + kRows * ldw);   // [kRows][ldc]
  bf16* lg = reinterpret_cast<bf16*>(cs + kRows * ldc);     // [R][V] logits
  const int row0 = blockIdx.x * R;
  const int n_rows = min(R, rows - row0);
  const int n_live = max(0, min(n_rows, live_rows - row0));
  const int warp = threadIdx.x >> 5;

  for (int t = threadIdx.x; t < (n_rows - n_live) * num_draws;
       t += blockDim.x) {
    const size_t o = (size_t)(row0 + n_live) * num_draws + t;
    ids[o] = 0;
    vals[o] = 0.f;
  }
  if (n_live == 0) return;

  // rows past n_live are zero, so their products are zero (and never read)
  for (int t = threadIdx.x; t < (kRows - n_live) * ldw; t += blockDim.x)
    xs[n_live * ldw + t] = 0u;
  dh::stage_rows(xs, ldw, n_live, D / 8, MatRows{x + (size_t)row0 * D, D});
  const auto* xb = reinterpret_cast<const bf16*>(xs);
  for (int n0 = 0; n0 < V; n0 += kTileN) {
    const int nt = min(kTileN, V - n0);
    __syncthreads();  // x is staged; the previous sums are read out of cs
    // warp `warp` multiplies columns [n0 + 16 * warp, +16): logits[r][n] =
    // sum_k x[r][k] * W[n][k], so W's rows are the column-major B operand
    if (16 * warp < nt) {
      const bf16* wt = w + (size_t)(n0 + 16 * warp) * D;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, xb + k0, ld);
        wmma::load_matrix_sync(fb, wt + k0, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(cs + 16 * warp, acc, ldc, wmma::mem_row_major);
    }
    __syncthreads();
    for (int o = threadIdx.x; o < n_live * nt; o += blockDim.x) {
      const int r = o / nt, n = o % nt;
      lg[r * V + n0 + n] = __float2bfloat16_rn(cs[r * ldc + n] + b[n0 + n]);
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int cmask = (1 << col_bits) - 1;
  for (int r = threadIdx.x >> 5; r < n_live; r += kWarps) {
    const bf16* row = lg + r * V;
    const size_t rg = (size_t)row0 + r;
    // t := the largest key (bits below kLowBit zero) with
    // count(key >= t) >= top_k: the exact k-th largest logit
    int t = warp_count_ge(row, V, 0) >= top_k ? 0 : INT32_MIN;
    for (int bit = 30; bit >= kLowBit; --bit) {
      const int cand = t | (1 << bit);
      if (warp_count_ge(row, V, cand) >= top_k) t = cand;
    }
    const uint32_t rh = dh::row_hash(seed, (uint32_t)rg);
    int m = INT32_MIN;
    for (int j = 0; j < num_draws; ++j) {
      int best = INT32_MIN;
      for (int c = lane; c < V; c += 32) {
        const float xv = __bfloat162float(row[c]);
        if (dh::order_key(xv) < t || c == unk) continue;
        const int packed = dh::packed_draw(xv, invt, rh, c, cmask);
        if (j == 0 || packed < m) best = max(best, packed);
      }
      m = __reduce_max_sync(0xffffffffu, best);
      if (lane == 0) {
        const int id = m == INT32_MIN ? 0 : cmask - (m & cmask);
        ids[rg * num_draws + j] = id;
        vals[rg * num_draws + j] = __bfloat162float(row[id]);
      }
    }
  }
}

int col_bits_of(int V) {
  int bits = 13;
  while ((1 << bits) < V) ++bits;
  return bits;
}

// Whether (V, D) runs the resident path on the current device.
bool resident(int V, int D) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) != cudaSuccess)
    return false;
  return V <= kMaxV && ResidentLayout(V, D).total <= (size_t)optin;
}

template <int kPer>
cudaError_t launch_resident(const void* x, const void* w, const void* b,
                            void* ids, void* vals, int rows, int live, int V,
                            int D, int top_k, int num_draws, int unk,
                            uint32_t seed, float invt, cudaStream_t stream) {
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

cudaError_t launch_streamed(const void* x, const void* w, const void* b,
                            void* ids, void* vals, int rows, int live, int V,
                            int D, int top_k, int num_draws, int unk,
                            uint32_t seed, float invt, cudaStream_t stream) {
  // rows per block: up to 16, with at most 32 KB of logits; a D or V too
  // large for one block fails at the attribute call below
  const int R = std::max(1, std::min(kRows, 16384 / V));
  const size_t smem = (size_t)2 * kRows * (D + 8) +
                      (size_t)4 * kRows * (kTileN + 4) + (size_t)2 * R * V;
  auto kernel = classifier_streamed_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (rows + R - 1) / R;
  kernel<<<blocks, kThreads, smem, stream>>>(
      (const bf16*)x, (const bf16*)w, (const float*)b, (long long*)ids,
      (float*)vals, rows, live, V, D, R, top_k, num_draws, unk, seed, invt,
      col_bits_of(V));
  return cudaGetLastError();
}

}  // namespace

// ids: int64 [rows, num_draws]; w: [V, D] padded to a multiple of 16 rows
// (the streamed kernel reads 16-row fragments) and 32-byte aligned.
extern "C" int dh_classifier_topk_gumbel_sample(
    const void* x, const void* w, const void* b, void* ids, void* vals,
    int rows, int live_rows, int V, int D, int top_k, int num_draws, int unk,
    unsigned seed, float invt, void* stream) {
  auto s = (cudaStream_t)stream;
  if (resident(V, D) && V <= 128)
    return launch_resident<4>(x, w, b, ids, vals, rows, live_rows, V, D,
                              top_k, num_draws, unk, seed, invt, s);
  if (resident(V, D))
    return launch_resident<8>(x, w, b, ids, vals, rows, live_rows, V, D,
                              top_k, num_draws, unk, seed, invt, s);
  return launch_streamed(x, w, b, ids, vals, rows, live_rows, V, D, top_k,
                         num_draws, unk, seed, invt, s);
}

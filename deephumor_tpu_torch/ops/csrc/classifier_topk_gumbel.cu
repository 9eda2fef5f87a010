// K4: the classifier product fused with K3's exact keep-ties top-k filter
// and Gumbel-top-k draw; the [rows, V] logits never leave the block.
//
// Replaces deephumor_tpu/ops/pallas_sampler.py:
// fused_classifier_topk_gumbel_sample (kernel _kernel_fused_classifier +
// _sample_body). Per row of hidden states x [D]:
//   1. logits = x @ W^T + b with bf16 x and W, f32 accumulation and an f32
//      bias, then rounded to bf16 (as the TPU kernel rounds them, so the
//      threshold search stops at bit 15);
//   2. K3's draw over those logits: the exact k-th largest order key by a
//      bitwise search (ties kept), UNK masked, the counter-hash noise of
//      (seed, global row, column) from common.cuh, num_draws strictly
//      decreasing maxima of the packed (perturbed key, flipped column);
//   3. the drawn ids and the rounded logits at those ids.
// Rows at or past `live_rows` (items retired by early-EOS compaction) are
// not computed; they get id 0 and value 0, so no stale id reaches a
// gather.
//
// Bound on the H100: bytes, and barely. At the char serving shape (5376
// rows, D 512, V 128, top_k 50, 7 draws) one launch reads 5.5 MB of
// hidden states and the 128 KB weight (~1.8 us at 3.35 TB/s); the product
// is 0.7 GFLOP. Design: a block owns up to 16 rows (one tensor-core row
// tile; fewer at large V, where their logits must still fit in shared
// memory, and the rest of the tile is zero). It stages their hidden
// states in shared memory (16-byte loads); its 8 warps each multiply one
// 16-column slice of W on the tensor cores (wmma, bf16 in, f32
// accumulate), loading W's fragments straight from global memory: the
// 128 KB weight stays in L1/L2 for every block, and the block stays small
// (~29 KB at V = 128), so several blocks per SM hide the latency of the
// sampling that follows. The sums go back through shared memory, take the
// f32 bias and are rounded to bf16 there: the logits never leave the
// block. One warp then samples one row: at V = 128 a row is 4 values per
// lane, so every count and maximum is a warp reduction with no block
// barrier.

#include <mma.h>

#include <algorithm>

#include "common.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;               // rows of one wmma tile
constexpr int kTileN = 16 * kWarps;     // columns per pass of the warps
constexpr int kLowBit = 15;  // bf16 logits: keys differ above bit 15

// Row r of a [*, D] bf16 matrix, as 16-byte vectors.
struct MatRows {
  const __nv_bfloat16* base;
  int D;
  __device__ const uint4* operator()(int r) const {
    return reinterpret_cast<const uint4*>(base + (size_t)r * D);
  }
};

// This warp's count of keys >= cand over one row of bf16 logits.
__device__ __forceinline__ int warp_count_ge(const __nv_bfloat16* row, int V,
                                             int cand) {
  int k = 0;
  for (int c = threadIdx.x & 31; c < V; c += 32)
    k += dh::order_key(__bfloat162float(row[c])) >= cand;
  return __reduce_add_sync(0xffffffffu, k);
}

__global__ void __launch_bounds__(kThreads) classifier_topk_gumbel_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ b, int* __restrict__ ids,
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
  __nv_bfloat16* lg = reinterpret_cast<__nv_bfloat16*>(cs + kRows * ldc);
                                                      // [R][V] logits
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
  const auto* xb = reinterpret_cast<const __nv_bfloat16*>(xs);
  for (int n0 = 0; n0 < V; n0 += kTileN) {
    const int nt = min(kTileN, V - n0);
    __syncthreads();  // x is staged; the previous sums are read out of cs
    // warp `warp` multiplies columns [n0 + 16 * warp, +16): logits[r][n] =
    // sum_k x[r][k] * W[n][k], so W's rows are the column-major B operand
    if (16 * warp < nt) {
      const __nv_bfloat16* wt = w + (size_t)(n0 + 16 * warp) * D;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int k0 = 0; k0 < D; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> fb;
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
    const __nv_bfloat16* row = lg + r * V;
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

}  // namespace

extern "C" int dh_classifier_topk_gumbel_sample(
    const void* x, const void* w, const void* b, void* ids, void* vals,
    int rows, int live_rows, int V, int D, int top_k, int num_draws, int unk,
    unsigned seed, float invt, void* stream) {
  // rows per block: up to 16, with at most 32 KB of logits; a D or V too
  // large for one block fails at the attribute call below
  const int R = std::max(1, std::min(kRows, 16384 / V));
  const size_t smem = (size_t)2 * kRows * (D + 8) +
                      (size_t)4 * kRows * (kTileN + 4) + (size_t)2 * R * V;
  int col_bits = 13;
  while ((1 << col_bits) < V) ++col_bits;
  auto kernel = classifier_topk_gumbel_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int blocks = (rows + R - 1) / R;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)b,
      (int*)ids, (float*)vals, rows, live_rows, V, D, R, top_k, num_draws,
      unk, seed, invt, col_bits);
  return cudaGetLastError();
}

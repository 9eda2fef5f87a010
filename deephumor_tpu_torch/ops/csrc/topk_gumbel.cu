// K3: exact keep-ties top-k filter + Gumbel-top-k draw without
// replacement, one row of logits per block.
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
//      give the uniform, floored at 1e-10.
//   3. num_draws strictly decreasing block-wide maxima of the packed
//      (perturbed order key, flipped column) int32 -- ties go to the
//      smallest column, non-kept columns are unreachable, and an exhausted
//      support yields column 0.
//
// Bound on the H100: bytes (8960 x 29184 bf16 = 523 MB per step). Design:
// the row is copied once into dynamic shared memory (58 KB for bf16 at
// V = 29184, above the 48 KB static limit). The copy also gives each
// thread its own maximum; the k-th largest of those maxima bounds the
// threshold from below, and one more pass gathers the few keys above the
// bound into a short list. The bitwise search and the draws then run over
// that list (over the whole row only if the list overflows, e.g. for
// massive ties). Noise is computed for kept columns only, since non-kept
// columns can never win.

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kCap = 1024;  // candidate-list capacity (keys >= the bound)

__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i < 0 ? i ^ 0x7FFFFFFF : i;
}

// "lowbias32" integer finaliser; the plain twin implements the same ops
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Local count of order keys >= cand: over the candidate list (keys[0, n))
// or over the whole row (row[0, n)).
template <typename T>
struct KeyCount {
  const T* row;
  const int* keys;
  int n;
  bool list;
  __device__ int operator()(int cand) const {
    int k = 0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      k += (list ? keys[i] : order_key(dh::to_f32(row[i]))) >= cand;
    return k;
  }
};

// The largest t (bits below low_bit zero) with count(key >= t) >= top_k,
// MSB first; `count` returns this thread's share of the count.
template <typename Count>
__device__ int kth_threshold(const Count& count, int top_k, int low_bit,
                             int* scratch) {
  int t = dh::block_sum(count(0), scratch) >= top_k ? 0 : INT32_MIN;
  for (int bit = 30; bit >= low_bit; --bit) {
    const int cand = t | (1 << bit);
    if (dh::block_sum(count(cand), scratch) >= top_k) t = cand;
  }
  return t;
}

struct OwnMax {  // one element per thread: its own maximum
  int key;
  __device__ int operator()(int cand) const { return key >= cand; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) topk_gumbel_kernel(
    const T* __restrict__ logits, int* __restrict__ ids, int V, int top_k,
    int num_draws, int unk, uint32_t seed, float invt, int low_bit,
    int col_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* row = reinterpret_cast<T*>(smem_raw);
  __shared__ int scratch[32];
  __shared__ int list_keys[kCap], list_cols[kCap], list_len;
  const size_t r = blockIdx.x;
  const T* src = logits + r * V;
  int own_max = INT32_MIN;
  if (threadIdx.x == 0) list_len = 0;
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    row[c] = src[c];
    own_max = max(own_max, order_key(dh::to_f32(row[c])));
  }
  __syncthreads();

  // lower bound: the k-th largest of the per-thread maxima (those are
  // distinct elements, so at least k keys are >= it). Every key >= the
  // true threshold is also >= the bound, so the exact search may run over
  // the (short) list of keys >= the bound -- its counts differ from the
  // row's only below the bound, where both reach k. A list that
  // overflows falls back to searching the whole row.
  const int bound = kth_threshold(OwnMax{own_max}, top_k, low_bit, scratch);
  for (int c = threadIdx.x; c < V; c += blockDim.x) {
    const int key = order_key(dh::to_f32(row[c]));
    if (key >= bound) {
      const int at = atomicAdd(&list_len, 1);
      if (at < kCap) {
        list_keys[at] = key;
        list_cols[at] = c;
      }
    }
  }
  __syncthreads();
  const bool use_list = list_len <= kCap;
  const int n = use_list ? list_len : V;
  const int t = kth_threshold(KeyCount<T>{row, list_keys, n, use_list},
                              top_k, low_bit, scratch);

  const int cmask = (1 << col_bits) - 1;
  const uint32_t row_hash = mix32(mix32(seed ^ 0x9e3779b9U) ^ (uint32_t)r);
  int m = INT32_MIN;
  for (int j = 0; j < num_draws; ++j) {
    int best = INT32_MIN;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int c = use_list ? list_cols[i] : i;
      const float x = dh::to_f32(row[c]);
      if (order_key(x) < t || c == unk) continue;
      const uint32_t bits = mix32(row_hash ^ (uint32_t)c);
      const float u = fmaxf((float)(bits >> 8) * (1.0f / 16777216.0f), 1e-10f);
      const float pert = __fadd_rn(__fmul_rn(x, invt), -logf(-logf(u)));
      const int packed = (order_key(pert) & ~cmask) | (cmask - c);
      if (j == 0 || packed < m) best = max(best, packed);
    }
    m = dh::block_max(best, scratch);
    if (threadIdx.x == 0)
      ids[r * num_draws + j] = m == INT32_MIN ? 0 : cmask - (m & cmask);
  }
}

template <typename T>
cudaError_t launch(const void* logits, void* ids, int rows, int V, int top_k,
                   int num_draws, int unk, uint32_t seed, float invt,
                   cudaStream_t stream) {
  const size_t smem = sizeof(T) * (size_t)V;
  const int low_bit = sizeof(T) == 2 ? 15 : 0;
  int col_bits = 13;
  while ((1 << col_bits) < V) ++col_bits;
  auto kernel = topk_gumbel_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<rows, kThreads, smem, stream>>>((const T*)logits, (int*)ids, V,
                                           top_k, num_draws, unk, seed, invt,
                                           low_bit, col_bits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dh_topk_gumbel_sample(int dtype, const void* logits, void* ids,
                                     int rows, int V, int top_k,
                                     int num_draws, int unk, unsigned seed,
                                     float invt, void* stream) {
  auto s = (cudaStream_t)stream;
  if (dtype == dh::kBFloat16)
    return launch<__nv_bfloat16>(logits, ids, rows, V, top_k, num_draws, unk,
                                 seed, invt, s);
  return launch<float>(logits, ids, rows, V, top_k, num_draws, unk, seed,
                       invt, s);
}

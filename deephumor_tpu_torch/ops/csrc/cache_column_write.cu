// K11: in-place write of one position's K/V column into both caches, cast
// to the cache dtype.
//
// Replaces deephumor_tpu/ops/pallas_cache.py:cache_column_write. The TPU
// kernel cannot address one position of a tiled (P, D) slab, so it reads,
// patches and writes back the whole 8-position tile around `pos`, in
// blocks of rows whose count must divide the rows and be a multiple of 8.
// Here a row's column is contiguous in device memory and any row count
// works: one thread writes one 16-byte chunk of one row's column, reading
// the matching values of k_new / v_new (f32 or bf16) and converting them
// with round-to-nearest-even, as PyTorch's own casts do.
//
// Bound on the H100: bytes (read k_new and v_new once, write two columns
// once; no arithmetic to speak of). blockIdx.y selects the cache.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename TC, typename TN>
__global__ void __launch_bounds__(kThreads) cache_column_write_kernel(
    TC* __restrict__ ck, TC* __restrict__ cv, const TN* __restrict__ kn,
    const TN* __restrict__ vn, int rows, int P, int D, int pos) {
  constexpr int kPer = 16 / sizeof(TC);  // cache values per chunk
  const int chunks = D / kPer;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)rows * chunks) return;
  const int r = (int)(t / chunks), c = (int)(t % chunks);
  TC* cache = blockIdx.y ? cv : ck;
  const TN* src = (blockIdx.y ? vn : kn) + (size_t)r * D + c * kPer;
  uint4 v;
  TC* vals = reinterpret_cast<TC*>(&v);
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    vals[k] = dh::from_f32<TC>(dh::to_f32(src[k]));
  *reinterpret_cast<uint4*>(cache + ((size_t)r * P + pos) * D + c * kPer) = v;
}

template <typename TC, typename TN>
cudaError_t launch(void* ck, void* cv, const void* kn, const void* vn,
                   int rows, int P, int D, int pos, cudaStream_t stream) {
  const long long n = (long long)rows * (D / (16 / sizeof(TC)));
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  if (blocks)
    cache_column_write_kernel<TC, TN><<<dim3(blocks, 2), kThreads, 0, stream>>>(
        (TC*)ck, (TC*)cv, (const TN*)kn, (const TN*)vn, rows, P, D, pos);
  return cudaGetLastError();
}

}  // namespace

// cache_dtype, new_dtype: 0 = float32, 1 = bfloat16
extern "C" int dh_cache_column_write(int cache_dtype, int new_dtype, void* ck,
                                     void* cv, const void* kn, const void* vn,
                                     int rows, int P, int D, int pos,
                                     void* stream) {
  auto s = (cudaStream_t)stream;
  if (cache_dtype == dh::kBFloat16) {
    if (new_dtype == dh::kBFloat16)
      return launch<__nv_bfloat16, __nv_bfloat16>(ck, cv, kn, vn, rows, P, D,
                                                  pos, s);
    return launch<__nv_bfloat16, float>(ck, cv, kn, vn, rows, P, D, pos, s);
  }
  if (new_dtype == dh::kBFloat16)
    return launch<float, __nv_bfloat16>(ck, cv, kn, vn, rows, P, D, pos, s);
  return launch<float, float>(ck, cv, kn, vn, rows, P, D, pos, s);
}

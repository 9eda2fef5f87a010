// Shared helpers for the deephumor_tpu_torch kernels: element loads in
// either storage type, warp reductions, the dtype codes the Python
// wrappers pass (0 = float32, 1 = bfloat16), the cp.async, ldmatrix and
// mma.sync wrappers of the tensor-core kernels, the bulk copies and
// mbarriers of K3, and the launch preparation (SM count, shared-memory
// limits) of the kernels that size their own grids.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace dh {

enum DType { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Softmax of one row of `n` f32 energies in place, by one warp. Each
// weight is rounded to the value storage type T (the attention kernels
// cast their weights to the cache dtype before the AV product).
template <typename T>
__device__ __forceinline__ void warp_softmax_round(float* e, int n) {
  const int lane = threadIdx.x & 31;
  float m = -INFINITY;
  for (int i = lane; i < n; i += 32) m = fmaxf(m, e[i]);
  m = warp_max(m);
  float s = 0.f;
  for (int i = lane; i < n; i += 32) {
    const float w = expf(e[i] - m);
    e[i] = w;
    s += w;
  }
  s = warp_sum(s);
  for (int i = lane; i < n; i += 32) e[i] = to_f32(from_f32<T>(e[i] / s));
}

// Copies `rows` rows of `vecs` 16-byte vectors each into shared memory
// at a row stride of `ld` 4-byte words (odd, so that threads reading one
// column of consecutive rows hit distinct banks). `src(r)` is row r's
// first vector in device memory. Each thread issues up to kUnroll loads
// before it stores any, so the copy is not one memory latency per vector.
template <typename Src>
__device__ __forceinline__ void stage_rows(uint32_t* dst, int ld, int rows,
                                           int vecs, const Src& src) {
  constexpr int kUnroll = 8;
  const int total = rows * vecs;
  for (int base = threadIdx.x; base < total; base += kUnroll * blockDim.x) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * blockDim.x;
      if (t < total) v[u] = src(t / vecs)[t % vecs];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u * blockDim.x;
      if (t < total) {
        uint32_t* d = dst + (t / vecs) * ld + 4 * (t % vecs);
        d[0] = v[u].x;
        d[1] = v[u].y;
        d[2] = v[u].z;
        d[3] = v[u].w;
      }
    }
  }
}

// Monotone f32 -> int32 map: signed-int order == float order ("order
// key"). bf16 values occupy a key's top 16 bits.
__device__ __forceinline__ int order_key(float x) {
  const int i = __float_as_int(x);
  return i < 0 ? i ^ 0x7FFFFFFF : i;
}

// The samplers' counter-based noise. "lowbias32" integer finaliser;
// ops/sampler.py's mix32 / noise_bits run the same integer ops, so the
// kernels and their plain twins draw the same tokens.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352dU;
  x ^= x >> 15;
  x *= 0x846ca68bU;
  x ^= x >> 16;
  return x;
}

// Per-row hash of (seed, global row); the noise of a column is
// mix32(row_hash ^ column).
__device__ __forceinline__ uint32_t row_hash(uint32_t seed, uint32_t row) {
  return mix32(mix32(seed ^ 0x9e3779b9U) ^ row);
}

// The packed draw key of column c of a kept logit x: the order key of
// x * invt + Gumbel(c) in the high bits, (cmask - c) in the low col_bits,
// so one max yields both the winner and its column (ties to the smallest
// column). 24 high noise bits give the uniform, floored at 1e-10.
__device__ __forceinline__ int packed_draw(float x, float invt, uint32_t rh,
                                           int c, int cmask) {
  const uint32_t bits = mix32(rh ^ (uint32_t)c);
  const float u = fmaxf((float)(bits >> 8) * (1.0f / 16777216.0f), 1e-10f);
  const float pert = __fadd_rn(__fmul_rn(x, invt), -logf(-logf(u)));
  return (order_key(pert) & ~cmask) | (cmask - c);
}

// Zeroes `rows` rows of `cols` values at a row stride of `ld` values: the
// output rows of items that early-EOS compaction has retired.
template <typename T>
__device__ __forceinline__ void zero_rows(T* dst, int rows, int cols,
                                          int ld) {
  for (int t = threadIdx.x; t < rows * cols; t += blockDim.x)
    dst[(size_t)(t / cols) * ld + t % cols] = from_f32<T>(0.f);
}

// Dot product of `n` f32 values in shared memory with `n` values of T.
template <typename T>
__device__ __forceinline__ float dot(const float* a, const T* b, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = fmaf(a[d], to_f32(b[d]), acc);
  return acc;
}

// ---- Tensor-core and asynchronous-copy primitives (sm_80 and later) ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned), bypassing L1. With `valid` false nothing is read and the 16
// bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4-byte asynchronous copy from device to shared memory (through L1).
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- Bulk copies and mbarriers (sm_90) ----

// Initialises the mbarrier at `bar` for `count` arrivals; then a fence makes
// the initialisation visible to the bulk-copy unit (a barrier must follow
// before other threads use it).
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile(
      "mbarrier.init.shared::cta.b64 [%0], %1;\n"
      "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar)),
      "r"(count)
      : "memory");
}
// One arrival that also announces `bytes` of bulk copies to complete in
// the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits until the phase of parity `parity` has completed; the bytes its
// bulk copies wrote are then visible to the waiting thread.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// Bulk copy of `bytes` (a multiple of 16) from device memory to shared
// memory, both 16-byte aligned, completing on the mbarrier `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
// Orders this thread's earlier shared-memory writes before later bulk
// copies into the same memory.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ldmatrix: lanes 8i..8i+7 give the 16-byte row addresses of 8x8 bf16
// matrix i; lane l receives row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1
// of each matrix (of its transpose with .trans), one 32-bit register each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a * b on the tensor cores: a 16x16 bf16 (row-major fragments), b
// 16x8 bf16 (column-major), d 16x8 f32. Lane l = 4 g + t holds d rows g
// and g + 8, columns 2t and 2t + 1, as {d[0], d[1]} and {d[2], d[3]}.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The shared-memory row stride, in bf16 values, of a staged tile of
// `hd`-wide rows (hd a multiple of 8): 16 bytes of padding put the eight
// row addresses of an ldmatrix (or eight cp.async destinations) in eight
// distinct groups of four banks, and keep every row 16-byte aligned.
__host__ __device__ __forceinline__ int padded_ld(int hd) { return hd + 8; }

// The SM count of the current device, read once (it only sizes grids).
inline int sm_count() {
  static const int sms = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return sms;
}

// Once per kernel and device (the first 32 devices; past them on every
// call) prefers the whole of the SM's unified memory as shared memory
// (several blocks fit) and raises the block's limit to the device's opt-in
// maximum, so later launches set no attribute.
template <auto Kernel>
cudaError_t prepare() {
  static std::atomic<uint32_t> ready{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (ready.load(std::memory_order_acquire) & bit) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(Kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess) ready.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace dh

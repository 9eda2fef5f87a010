// Shared helpers for the deephumor_tpu_torch kernels: element loads in
// either storage type, warp reductions, the dtype codes the Python
// wrappers pass (0 = float32, 1 = bfloat16), the cp.async, ldmatrix and
// mma.sync wrappers of the tensor-core kernels, the bulk copies and
// mbarriers of K3 and K4, and the launch preparation (SM count,
// shared-memory limits) of the kernels that size their own grids.
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

// A draw's seed: the int32 at `ptr` when it is given (a decode step's seed
// in device memory, so that a captured graph replays with new draws), else
// `value`. Either way the same value draws the same noise.
struct Seed {
  const int* ptr;
  uint32_t value;
  __device__ __forceinline__ uint32_t get() const {
    return ptr ? (uint32_t)__ldg(ptr) : value;
  }
};

// A count that a kernel takes (live items or rows after early-EOS
// compaction, straggler items of a canonical-prefix boundary): the int32
// at `ptr` when it is given, else `value`. A boundary sets it in device
// memory and the kernels of the next phase read it, as the TPU kernels
// read a prefetched scalar, so a captured graph replays with each call's
// own count. With a pointer the launcher sizes the grid for every item
// (a graph bakes the grid in), and blocks at or past the count return at
// once.
struct Count {
  const int* ptr;
  int value;
  __device__ __forceinline__ int get() const {
    return ptr ? __ldg(ptr) : value;
  }
};

// A draw's 1/T: the f32 at `ptr` when it is given (a captured call's
// temperature, written into device memory on every call, so that one
// graph serves every temperature), else `value`. The same f32 draws the
// same noise either way.
struct InvT {
  const float* ptr;
  float value;
  __device__ __forceinline__ float get() const {
    return ptr ? __ldg(ptr) : value;
  }
};

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

// ---- Warpgroup products (sm_90a) ----

// The descriptor of a K-major bf16 tile in shared memory whose rows are 64
// values (128 bytes), stored in 1024-byte atoms of 8 rows with the 128-byte
// swizzle: 16-byte chunk c of row r at r * 128 + 16 (c ^ (r % 8)). The
// atom at `tile` must be 1024-byte aligned; adding 2 to the descriptor
// moves its start 32 bytes (16 values) along K.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4)
         | (uint64_t)1 << 16            // leading offset (unused here)
         | (uint64_t)(1024 >> 4) << 32  // 8-row atoms 1024 bytes apart
         | (uint64_t)1 << 62;           // 128-byte swizzle
}
// Orders the warpgroup's register and shared-memory accesses before the
// products that follow; groups the products issued so far; waits until at
// most N groups are in flight.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// d += a * b over 16 of K by the warpgroup: a [64 x 16] and b [128 x 16]
// bf16 (K-major tiles, descriptors above), d [64 x 128] f32. Thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8 for d[4j + 2],
// d[4j + 3]), columns 8 j + 2 (t % 4) and + 1.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 1, 1, 1, 0, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b));
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

// The current device's opt-in limit of a block's dynamic shared memory,
// read once per device (the first 32; past them on every call).
inline int smem_optin() {
  static std::atomic<int> cached[32];  // 0: not read yet
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 32 && (optin = cached[dev].load(std::memory_order_relaxed)))
    return optin;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (dev < 32) cached[dev].store(optin, std::memory_order_relaxed);
  return optin;
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

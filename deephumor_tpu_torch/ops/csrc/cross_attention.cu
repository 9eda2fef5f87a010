// K2: grouped single-query cross-attention; and K9, its form over a
// tile-padded store.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:grouped_cross_attention
// (kernel _kernel_cross). The r = beam query rows of item g attend to
// item g's encoder keys/values [T, D] (pre-projected once per
// generation), with an optional additive f32 mask bias [G, 1, T] (0 or
// -1e8 for masked encoder rows). The softmax runs in f32 and the weights
// are normalised, then rounded to the value dtype, as the TPU kernel does.
// A group whose rows are all masked gets the uniform average: -1e8 is a
// fill, not -inf, so the softmax never sees an all--inf row and gives no
// NaN. Groups at or past `live` (compacted, all-ended items) write zero
// rows and read nothing; the grid covers every group, and `live` is a
// launch argument or an int32 in device memory (dh::Count) that a
// compaction boundary sets.
//
// Bound on the H100: bytes. At the word serving shape (1792 items, T 49,
// D 512, bf16) one launch must read ~180 MB of ek + ev (0.059 ms at 3.35
// TB/s) for ~0.1 GFLOP. Each (item, head) is small: 49 rows of K and of V,
// 6 KB each, so the time goes to keeping enough of those loads in flight
// and to the work between them, not to arithmetic.
//
// bf16 at a head_dim of 16k up to 256 (grouped_cross_attention_mma_kernel
// in a profile): the two-pass tensor-core body `attend` of
// attention_mma.cuh over the item's T rows (`EncoderRows`): T in M as
// 16-row tiles (rows past T zero-filled, weight 0), the beam in N (5 or 7,
// padded to 8), both products mma.sync on ldmatrix fragments of cp.async
// tiles. One block per (item, head, chunk of <= 32 branches), heads
// fastest; its ring holds two tiles, so at T 49 the K tile and the V tile
// are both in flight from the start and V lands while Sᵀ and the softmax
// run. A block is short and its two loads are all it keeps in flight, so
// the design packs blocks: ~21 KB of shared memory and registers capped
// so that eight share an SM. (A persistent grid, each block walking pairs
// and asking L2 for its next pair's rows, was slower on the H100; PERF.md
// keeps its times.)
//
// f32, and bf16 at any other head_dim (grouped_cross_attention_simt_kernel):
// the two-pass CUDA-core body of attention_simt.cuh over the same rows, one
// block per (item, head), exact f32 arithmetic. The launcher picks the
// kernel by dtype and head_dim before any launch.
//
// K9 (dh_cross_attention_packed) replaces
// deephumor_tpu/ops/pallas_attention.py:_cross_packed (kernel
// _kernel_cross_packed), the DH_CROSS_PACK form: the same function over
// each item's first t_real rows of a store padded to Tp rows (its bias
// [G, 1, Tp]); the pad rows and every other item's rows get zero weight.
// The TPU kernel fuses ng items into one block-diagonal product, masking
// the cross-item energies, so that its matrix unit sees full tiles; on
// Hopper an mma tile's M already runs over an item's rows, so K9 runs K2's
// kernels with the rows read in place at a stride of Tp and stopping at
// t_real: one block per (item, head, chunk), a group's ng items neighbours
// in the grid, and ng sizes nothing. (A block per (group of ng items,
// head), walking its items through one ring of four tiles so that the
// next item's K and V land while the current item computes, was slower at
// every ng on the H100; PERF.md keeps its times.)

#include "attention_mma.cuh"
#include "attention_simt.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace ma = dh::mma_attn;

// The bias of every row when the caller passes none.
__device__ float kZeroBias = 0.f;

// Row r of one item's encoder rows in one head's columns: its code is r;
// `k0` / `v0` point at the item's row 0 at the head's first column, `b0`
// at the item's bias row (stride 1) or at kZeroBias (stride 0). Items lie
// Tn rows apart (K2: T; K9: the padded Tp).
template <typename T>
struct EncoderRows {
  const T *k0, *v0;
  const float* b0;
  int bstride, D;
  __device__ uint32_t index(int r) const { return (uint32_t)r; }
  __device__ const T* k(uint32_t x) const { return k0 + (size_t)x * D; }
  __device__ const T* v(uint32_t x) const { return v0 + (size_t)x * D; }
  __device__ const float* bias(int, int, uint32_t x) const {
    return b0 + (size_t)x * bstride;
  }
};

template <typename T>
__device__ __forceinline__ EncoderRows<T> encoder_rows(
    const T* ek, const T* ev, const float* bias, int g, int Tn, int D,
    int col0) {
  const size_t kv0 = (size_t)g * Tn * D + col0;
  return {ek + kv0, ev + kv0, bias ? bias + (size_t)g * Tn : &kZeroBias,
          bias ? 1 : 0, D};
}

// The ring of `attend` holds two tiles: an item's rows are one tile at
// the serving shape (T 49), so K and V are both in flight from the start.
// A tensor-core kernel of one n-tile (a beam up to 8) keeps at least
// kMinBlocks blocks on an SM (its registers capped to fit, ~21 KB of shared
// memory each): a block is short and its two loads are all it keeps in
// flight, so more blocks keep more bytes in flight. Wider beams keep the
// compiler's choice.
constexpr int kRingTiles = 2;
template <int NT>
constexpr int kMinBlocks = NT == 1 ? 8 : 1;

// One block per pair b = blockIdx.x (heads fastest, then chunks of at most
// kMaxBeam branches, then items).
template <int NT>
__global__ void __launch_bounds__(ma::kThreads, kMinBlocks<NT>)
    grouped_cross_attention_mma_kernel(
        const bf16* __restrict__ q, const bf16* __restrict__ ek,
        const bf16* __restrict__ ev, const float* __restrict__ bias,
        bf16* __restrict__ out, dh::Count live, int r, int Tn, int n, int D,
        int hd, float inv_scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = D / hd, b = blockIdx.x;
  const ma::Chunk<NT> ch(b, H, r);
  const int col0 = b % H * hd;
  const size_t qrow0 = (size_t)ch.sel * r + ch.j0;
  if (ch.sel >= live.get()) {
    dh::zero_rows(out + qrow0 * D + col0, ch.nq, hd, D);
    return;
  }
  ma::attend<NT, kRingTiles>(
      encoder_rows(ek, ev, bias, ch.sel, Tn, D, col0), q + qrow0 * D + col0,
      D, out + qrow0 * D + col0, D, n, ch.nq, hd, inv_scale, 1, smem);
}

template <typename T>
__global__ void __launch_bounds__(dh::simt::kThreads)
    grouped_cross_attention_simt_kernel(
        const T* __restrict__ q, const T* __restrict__ ek,
        const T* __restrict__ ev, const float* __restrict__ bias,
        T* __restrict__ out, dh::Count live, int r, int Tn, int n, int D,
        int hd, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int H = D / hd, g = blockIdx.x / H, col0 = blockIdx.x % H * hd;
  const size_t q0 = (size_t)g * r * D + col0;
  if (g >= live.get()) {
    dh::zero_rows(out + q0, r, hd, D);
    return;
  }
  dh::simt::attend<T>(encoder_rows(ek, ev, bias, g, Tn, D, col0), q + q0, D,
                      out + q0, D, n, r, hd, inv_scale, smem_w);
}

bool use_mma(int dtype, int hd) {
  return dtype == dh::kBFloat16 && ma::takes(hd);
}

// A block's dynamic shared memory over n rows.
size_t smem_bytes(int dtype, int r, int n, int D, int H) {
  const int hd = D / H;
  if (!use_mma(dtype, hd))
    return dh::simt::smem_bytes(n, r, hd, dtype == dh::kBFloat16 ? 2 : 4);
  return ma::smem_bytes(n, 1, ma::chunk_beam(r), hd, ma::n_tiles(r),
                        kRingTiles);
}

template <typename T>
cudaError_t launch_simt(const void* q, const void* ek, const void* ev,
                        const void* bias, void* out, int G, dh::Count live,
                        int r, int Tn, int n, int D, int H, float inv_scale,
                        cudaStream_t stream) {
  const int hd = D / H;
  return ma::launch<&grouped_cross_attention_simt_kernel<T>,
                    dh::simt::kThreads>(
      G * H, 1, dh::simt::smem_bytes(n, r, hd, sizeof(T)), stream,
      (const T*)q, (const T*)ek, (const T*)ev, (const float*)bias, (T*)out,
      live, r, Tn, n, D, hd, inv_scale);
}

template <int NT>
cudaError_t launch_mma(const void* q, const void* ek, const void* ev,
                       const void* bias, void* out, int G, dh::Count live,
                       int r, int Tn, int n, int D, int H, float inv_scale,
                       cudaStream_t stream) {
  const int hd = D / H;
  return ma::launch<&grouped_cross_attention_mma_kernel<NT>>(
      G * H * ma::beam_chunks(r), 1,
      ma::smem_bytes(n, 1, ma::chunk_beam(r), hd, NT, kRingTiles), stream,
      (const bf16*)q, (const bf16*)ek, (const bf16*)ev, (const float*)bias,
      (bf16*)out, live, r, Tn, n, D, hd, inv_scale);
}

// Items Tn rows apart, each attending over its first n rows.
cudaError_t launch(int dtype, const void* q, const void* ek, const void* ev,
                   const void* bias, void* out, int G, dh::Count live, int r,
                   int Tn, int n, int D, int H, float inv_scale,
                   cudaStream_t s) {
  if (!use_mma(dtype, D / H)) {
    if (dtype == dh::kBFloat16)
      return launch_simt<bf16>(q, ek, ev, bias, out, G, live, r, Tn, n, D, H,
                               inv_scale, s);
    return launch_simt<float>(q, ek, ev, bias, out, G, live, r, Tn, n, D, H,
                              inv_scale, s);
  }
  return ma::dispatch(r, D / H, [&](auto nt) {
    return launch_mma<decltype(nt)::value>(q, ek, ev, bias, out, G, live, r,
                                           Tn, n, D, H, inv_scale, s);
  });
}

}  // namespace

// live_ptr: NULL (`live` groups are computed) or a device int32 that the
// kernel reads (a captured step's live count).
extern "C" int dh_grouped_cross_attention(int dtype, const void* q,
                                          const void* ek, const void* ev,
                                          const void* bias, void* out, int G,
                                          int live, const void* live_ptr,
                                          int r, int Tn, int D, int H,
                                          float inv_scale, void* stream) {
  return launch(dtype, q, ek, ev, bias, out, G,
                dh::Count{(const int*)live_ptr, live}, r, Tn, Tn, D, H,
                inv_scale, (cudaStream_t)stream);
}

extern "C" int dh_cross_attention_packed(int dtype, const void* q,
                                         const void* ek, const void* ev,
                                         const void* bias, void* out, int G,
                                         int live, const void* live_ptr,
                                         int r, int Tp, int t_real, int D,
                                         int H, float inv_scale,
                                         void* stream) {
  return launch(dtype, q, ek, ev, bias, out, G,
                dh::Count{(const int*)live_ptr, live}, r, Tp, t_real, D, H,
                inv_scale, (cudaStream_t)stream);
}

// The dynamic shared memory a block of dh_grouped_cross_attention (or of
// dh_cross_attention_packed, n = t_real) needs at this shape (the wrappers
// compare it with the card's opt-in limit before the launch).
extern "C" long long dh_grouped_cross_attention_smem(int dtype, int r, int n,
                                                     int D, int H) {
  return (long long)smem_bytes(dtype, r, n, D, H);
}

extern "C" const char* dh_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The most dynamic shared memory a block may take on `device` (0 if the
// attribute cannot be read).
extern "C" int dh_smem_optin(int device) {
  int optin = 0;
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         device);
  return optin;
}

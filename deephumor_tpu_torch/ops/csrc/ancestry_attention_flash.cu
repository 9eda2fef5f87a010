// K8: K1's contract (write this position's K/V column in place, then
// ancestry self-attention) with the caches read only through the
// 8-position tile that holds `pos` and an online softmax across tiles.
//
// Replaces deephumor_tpu/ops/pallas_attention.py:
// ancestry_attention_update_flash (kernel _kernel_native4d_flash). The TPU
// kernel is a negative result there: its per-tile bookkeeping cost more
// than the early steps' saved reads. It is ported so that the question can
// be asked again on this card, beside K1.
//
// What it computes: each branch j of item g attends, per head, over every
// (slot i, position p < 8 * (pos / 8 + 1)) of its item with the flat
// ancestry bias [items, beam, beam * P] added to the scaled energies, so
// the positions past pos in the last tile are read (and masked by the bias)
// and no tile past it leaves device memory. The fresh column at `pos` comes
// from k_new / v_new, so it is written into the caches before the reads. The
// weights exp(e - m_running) are rounded to the cache dtype before they are
// normalised, and the output is the weighted sum over the sum of the
// unrounded weights: the TPU kernel's order.
//
// Bound on the H100: bytes, the same as K1's at p_eff = 8 * (pos / 8 + 1)
// (0.188 ms at word pos 31, 0.433 ms at char pos 127, at 3.35 TB/s).
//
// bf16 at a head_dim of 16k up to 256: the one-pass tensor-core body
// `attend_online` of attention_mma.cuh (ancestry_attention_flash_mma_kernel
// in a profile) over the beam * p_eff rows of one (item, head, chunk of at
// most 32 branches), K1's row source (ancestry_update.cuh). Each ring
// stage holds one 64-row tile's K, V and biases, loaded two tiles ahead;
// no energy is kept past its tile, so a block holds ~64 KB at head_dim 64
// whatever the cache length, and a grid too small to fill the card spreads
// each (item, head) over a cluster of 2-4 blocks that merge their running
// max, sum and partial outputs at the end.
//
// f32, and bf16 at any other head_dim: a CUDA-core kernel
// (ancestry_attention_flash_simt_kernel), one block per (item, head) that
// stages one 8-position tile of K and V at a time (beam * 8 rows) and keeps
// each (branch, column) sum in shared memory, exact in f32.

#include "ancestry_update.cuh"
#include "attention_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace ma = dh::mma_attn;

constexpr int kThreads = 256;  // the CUDA-core kernel's block
constexpr int kTile = 8;       // positions per tile, as the TPU kernel's

// The read length: the positions of the tiles through the one holding pos.
__host__ __device__ inline int read_length(int pos) {
  return kTile * (pos / kTile + 1);
}

template <int NT>
__global__ void __launch_bounds__(ma::kThreads)
    ancestry_attention_flash_mma_kernel(
        const bf16* __restrict__ q, bf16* __restrict__ ck,
        bf16* __restrict__ cv, const bf16* __restrict__ knew,
        const bf16* __restrict__ vnew, const float* __restrict__ bias,
        bf16* __restrict__ out, int beam, int P, int D, int hd, int pos,
        float inv_scale, int cs) {
  extern __shared__ __align__(16) unsigned char smem[];
  namespace cg = cooperative_groups;
  const int H = D / hd, b = blockIdx.x / cs, col0 = b % H * hd;
  const ma::Chunk<NT> ch(b, H, beam);
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int pe = read_length(pos);
  const size_t row0 = (size_t)ch.sel * beam, qrow0 = row0 + ch.j0;
  // the cache column at `pos` is never read (it comes from k_new / v_new),
  // so it is written first, its latency under the reads
  dh::write_column(ck, cv, knew, D, vnew, D, qrow0, ch.nq, P, D, hd, col0,
                   pos, rank, cs);
  const dh::UpdateRows<bf16> rows{ck,   cv, knew, vnew, bias, row0, qrow0,
                                  beam, P,  pe,   D,    col0, pos,  D, D};
  ma::attend_online<NT>(rows, q + qrow0 * D + col0, D,
                        out + qrow0 * D + col0, D, beam * pe, ch.nq, hd,
                        inv_scale, cs, smem);
}

// Row r of the tile at positions [p0, p0 + kTile) in one head's columns:
// slot r / kTile, position p0 + r % kTile; position `pos` comes from
// `fresh`.
template <typename T>
struct TileRows {
  const T* cache;
  const T* fresh;
  size_t row0;
  int P, D, col0, p0, pos;
  __device__ const uint4* operator()(int r) const {
    const int i = r / kTile, p = p0 + r % kTile;
    const T* base = p == pos ? fresh + (row0 + i) * D
                             : cache + ((row0 + i) * P + p) * D;
    return reinterpret_cast<const uint4*>(base + col0);
  }
};

// Per tile: energies for (branch, row) pairs, then one warp per branch
// rescales the branch's running max m and sum l and turns the tile's
// energies into rounded weights, and each thread rescales and accumulates
// its own (branch, column) sums in shared memory.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    ancestry_attention_flash_simt_kernel(
        const T* __restrict__ q, T* __restrict__ ck, T* __restrict__ cv,
        const T* __restrict__ knew, const T* __restrict__ vnew,
        const float* __restrict__ bias, T* __restrict__ out, int beam,
        int P, int D, int hd, int pos, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int n = beam * kTile;               // (slot, position) rows a tile
  const int wpr = hd * (int)sizeof(T) / 4;  // 4-byte words per row
  const int ld = wpr + 1;                   // odd: conflict-free columns
  uint32_t* ks = smem_w;                    // [n][ld]
  uint32_t* vs = ks + n * ld;               // [n][ld]
  float* qs = reinterpret_cast<float*>(vs + n * ld);  // [beam][hd]
  float* acc = qs + beam * hd;              // [beam][hd]
  float* e = acc + beam * hd;               // [beam][n]
  float* m = e + beam * n;                  // [beam] running max
  float* l = m + beam;                      // [beam] running sum
  float* alpha = l + beam;                  // [beam] this tile's rescale
  const int H = D / hd;
  const size_t row0 = (size_t)(blockIdx.x / H) * beam;
  const int col0 = blockIdx.x % H * hd;
  const int lane = threadIdx.x & 31;

  // the cache column at `pos` is never read (it comes from k_new / v_new)
  dh::write_column(ck, cv, knew, D, vnew, D, row0, beam, P, D, hd, col0,
                   pos);
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    qs[t] = dh::to_f32(q[(row0 + t / hd) * D + col0 + t % hd]);
    acc[t] = 0.f;
  }
  for (int j = threadIdx.x; j < beam; j += blockDim.x) {
    m[j] = -1e30f;
    l[j] = 0.f;
  }

  for (int p0 = 0; p0 <= pos; p0 += kTile) {
    __syncthreads();  // the previous tile is consumed; q, m, l are set
    dh::stage_rows(ks, ld, n, wpr / 4,
                   TileRows<T>{ck, knew, row0, P, D, col0, p0, pos});
    dh::stage_rows(vs, ld, n, wpr / 4,
                   TileRows<T>{cv, vnew, row0, P, D, col0, p0, pos});
    __syncthreads();

    for (int t = threadIdx.x; t < beam * n; t += blockDim.x) {
      const int j = t / n, r = t % n, i = r / kTile, p = p0 + r % kTile;
      const T* krow = reinterpret_cast<const T*>(ks + r * ld);
      const float s = dh::dot(qs + j * hd, krow, hd) * inv_scale;
      e[t] = s + bias[((row0 + j) * beam + i) * P + p];
    }
    __syncthreads();

    // one warp per branch: rescale the running max and sum, weights in e
    for (int j = threadIdx.x >> 5; j < beam; j += blockDim.x >> 5) {
      float* ej = e + j * n;
      float mt = -INFINITY;
      for (int r = lane; r < n; r += 32) mt = fmaxf(mt, ej[r]);
      mt = dh::warp_max(mt);
      const float mo = m[j], mn = fmaxf(mo, mt);
      float s = 0.f;
      for (int r = lane; r < n; r += 32) {
        const float w = expf(ej[r] - mn);
        ej[r] = dh::to_f32(dh::from_f32<T>(w));
        s += w;
      }
      s = dh::warp_sum(s);  // every lane has read m[j] before this
      if (lane == 0) {
        const float a = expf(mo - mn);
        alpha[j] = a;
        l[j] = l[j] * a + s;
        m[j] = mn;
      }
    }
    __syncthreads();

    for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
      const int j = t / hd, d = t % hd;
      const float* w = e + j * n;
      float a = acc[t] * alpha[j];
      for (int r = 0; r < n; ++r)
        a = fmaf(w[r], dh::to_f32(reinterpret_cast<const T*>(vs + r * ld)[d]),
                 a);
      acc[t] = a;
    }
  }

  // each thread reads only its own acc entries; l is final since the last
  // tile's softmax barrier
  for (int t = threadIdx.x; t < beam * hd; t += blockDim.x) {
    const int j = t / hd;
    out[(row0 + j) * D + col0 + t % hd] = dh::from_f32<T>(acc[t] / l[j]);
  }
}

bool use_mma(int dtype, int hd) {
  return dtype == dh::kBFloat16 && ma::takes(hd);
}

size_t simt_smem_bytes(int beam, int hd, int elt) {
  const size_t n = (size_t)beam * kTile;
  return 4 * (2 * n * (hd * elt / 4 + 1) + 2 * (size_t)beam * hd
              + beam * n + 3 * (size_t)beam);
}

size_t smem_bytes(int dtype, int beam, int D, int H) {
  const int hd = D / H;
  if (!use_mma(dtype, hd))
    return simt_smem_bytes(beam, hd, dtype == dh::kBFloat16 ? 2 : 4);
  return ma::smem_bytes_online(hd, ma::n_tiles(beam));
}

template <typename T>
cudaError_t launch_simt(const void* q, void* ck, void* cv, const void* kn,
                        const void* vn, const void* bias, void* out,
                        int items, int beam, int P, int D, int H, int pos,
                        float inv_scale, cudaStream_t stream) {
  const int hd = D / H;
  return ma::launch<&ancestry_attention_flash_simt_kernel<T>, kThreads>(
      items * H, 1, simt_smem_bytes(beam, hd, sizeof(T)), stream,
      (const T*)q, (T*)ck, (T*)cv, (const T*)kn, (const T*)vn,
      (const float*)bias, (T*)out, beam, P, D, hd, pos, inv_scale);
}

}  // namespace

extern "C" int dh_ancestry_attention_update_flash(
    int dtype, const void* q, void* ck, void* cv, const void* kn,
    const void* vn, const void* bias, void* out, int items, int beam, int P,
    int D, int H, int pos, float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if ((size_t)items * beam * P >= dh::kFresh) return cudaErrorInvalidValue;
  if (!use_mma(dtype, D / H)) {
    if (dtype == dh::kBFloat16)
      return launch_simt<bf16>(q, ck, cv, kn, vn, bias, out, items, beam, P,
                               D, H, pos, inv_scale, s);
    return launch_simt<float>(q, ck, cv, kn, vn, bias, out, items, beam, P,
                              D, H, pos, inv_scale, s);
  }
  return ma::dispatch(beam, D / H, [&](auto nt) {
    constexpr int NT = decltype(nt)::value;
    const int blocks = items * H * ma::beam_chunks(beam);
    const int cs = ma::cluster_size(blocks, beam * read_length(pos));
    return ma::launch<&ancestry_attention_flash_mma_kernel<NT>>(
        blocks * cs, cs, ma::smem_bytes_online(D / H, NT), s,
        (const bf16*)q, (bf16*)ck, (bf16*)cv, (const bf16*)kn,
        (const bf16*)vn, (const float*)bias, (bf16*)out, beam, P, D, D / H,
        pos, inv_scale, cs);
  });
}

// The dynamic shared memory a block of dh_ancestry_attention_update_flash
// needs at this shape; it does not depend on the cache length.
extern "C" long long dh_ancestry_attention_update_flash_smem(int dtype,
                                                             int beam, int D,
                                                             int H) {
  return (long long)smem_bytes(dtype, beam, D, H);
}

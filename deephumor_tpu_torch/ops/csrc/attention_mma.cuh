// The bf16 tensor-core bodies of the attention kernels: the two-pass
// `attend` (K1 in ancestry_attention.cu, K2 in cross_attention.cu, K5 in
// ancestry_attention_canon.cu, K6 and K7 in ancestry_attention_ids.cu) and
// the one-pass `attend_online` (K8 in ancestry_attention_flash.cu). One
// (item, head) per block of four warps, or per cluster of 2-4 such blocks,
// both products on the tensor cores, rows staged by cp.async.
//
// A block attends up to kMaxBeam queries of one item and head (an item's
// `beam` branches in chunks of kMaxBeam, one chunk per block) over `n` rows
// that a `Rows` source names one at a time, so one body serves K5's three
// row sources (shared cache, per-slot window, fresh column), K6's item
// list, K2's encoder rows and K1's and K8's per-slot caches with the fresh
// column at `pos`:
//   rows.index(r)          a 32-bit code of row r (its source and row in
//                          it); `attend` computes it once per row into
//                          shared memory, so the integer divisions it may
//                          take stay out of the copy loops;
//   rows.k(x), rows.v(x)   pointer to the head columns of K and V of the
//                          row with code x (16-byte aligned);
//   rows.bias(j, r, x)     pointer to the additive bias of the block's
//                          query j, row r.
// `attend` takes two passes, as the twins compute: every energy of the
// block stays in shared memory in f32 until each branch's max and sum are
// known; weights are normalised and then rounded to bf16, and those
// rounded weights are the operand of the second product.
//   * Sᵀ = K·Qᵀ: rows in M (16 per warp and tile), the beam in N (8 per
//     n-tile, zero columns past `beam`), head_dim in K. A fragments come
//     from the staged K tile by ldmatrix, B fragments from the staged q.
//   * Oᵀ = Vᵀ·Pᵀ: head_dim in M (16-column m-tiles spread over the four
//     warps, so each warp owns its output columns and nothing is reduced
//     across warps), the beam in N, rows in K. A fragments come from the
//     row-major V tile by ldmatrix.trans; B fragments are 32-bit pairs of
//     the rounded weights.
// Each 16 rows thus cost one ldmatrix.x4 and one mma per 16 of head_dim in
// each product. K and V tiles of kTile rows go through one ring of
// kStages buffers padded by 16 bytes a row (conflict-free ldmatrix): the
// K tiles, then the V tiles, each loaded kStages - 1 steps ahead of its
// product, so the first V tiles load while the softmax runs. Each K tile's
// biases land by cp.async in the energy rows, in the same group as the
// tile, so the product adds to them and the softmax reads shared memory
// only. Rows past `n` are zero-filled and get weight 0.
//
// `attend_online` (flash style) keeps no energies, so its shared memory
// does not grow with `n`: each ring stage holds one tile's K rows, V rows
// and biases, loaded kStages - 1 steps ahead. Per tile, each warp takes Sᵀ
// for its 16 rows; a warp-shuffle max over those rows and a four-entry
// exchange in shared memory give each branch's tile max, so every warp
// holds the same running max m; the weights exp(e - m) are rounded to bf16
// before any normalisation (the TPU kernel's order) and pass through shared
// memory, since Oᵀ = Vᵀ·Pᵀ needs every row of the tile in each warp. The
// branch is the N column of both products, so rescaling Oᵀ by
// exp(m_old - m_new) is register-local. The output is Oᵀ over the sum of
// the unrounded weights.
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"

namespace dh {
namespace mma_attn {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 64;     // rows per staged tile: 16 per warp in Sᵀ
constexpr int kStages = 3;    // tiles in the ring
constexpr int kMaxHd = 256;   // head_dim: up to 4 m-tiles per warp in Oᵀ
constexpr int kMaxMt = kMaxHd / 16 / kWarps;
constexpr int kMaxBeam = 32;  // queries per block: four n-tiles
constexpr int kMaxCluster = 4;

// Blocks per (item, head): the item's `beam` branches in chunks of
// kMaxBeam; and the queries of the widest chunk.
__host__ __device__ inline int beam_chunks(int beam) {
  return (beam + kMaxBeam - 1) / kMaxBeam;
}
inline int chunk_beam(int beam) { return beam < kMaxBeam ? beam : kMaxBeam; }

// The head_dims the bodies take: a multiple of 16 up to kMaxHd.
inline bool takes(int hd) { return hd > 0 && hd % 16 == 0 && hd <= kMaxHd; }

// n-tiles of 8 queries (1, 2 or 4) that a block of `beam` branches needs.
inline int n_tiles(int beam) {
  const int b = chunk_beam(beam);
  return b <= 8 ? 1 : b <= 16 ? 2 : 4;
}

// The chunk of block index b (heads varying fastest, then chunks): its
// first branch j0 and its query count nq, and the item's position in the
// grid. Only the four-n-tile kernels (beams above 16) can see a beam above
// kMaxBeam; the others take their item's beam whole, and their code keeps
// no chunk arithmetic (nor the registers it would hold).
template <int NT>
struct Chunk {
  int j0, nq, sel;
  __device__ Chunk(int b, int H, int beam) {
    const int nch = NT == 4 ? beam_chunks(beam) : 1;
    j0 = NT == 4 ? b / H % nch * kMaxBeam : 0;
    nq = NT == 4 ? min(beam - j0, kMaxBeam) : beam;
    sel = b / (H * nch);
  }
};

// Calls f(std::integral_constant<int, NT>()) with the n-tiles that a block
// of `beam` branches needs; returns cudaErrorInvalidValue for a head_dim
// the bodies do not take or no branch. The launchers of K1, K5, K6, K7 and
// K8 share it.
template <typename F>
cudaError_t dispatch(int beam, int hd, F&& f) {
  if (!takes(hd) || beam < 1) return cudaErrorInvalidValue;
  switch (n_tiles(beam)) {
    case 1: return f(std::integral_constant<int, 1>());
    case 2: return f(std::integral_constant<int, 2>());
    default: return f(std::integral_constant<int, 4>());
  }
}

__host__ __device__ inline int tiles_of(int n) {
  return (n + kTile - 1) / kTile;
}

// Row stride of the energies of `tiles` tiles of rows, in f32: plus 4,
// which is 4 modulo 32, so that the fragment stores of Sᵀ and the weight
// loads of Pᵀ hit 32 distinct banks.
__host__ __device__ inline int energy_ld(int tiles) {
  return tiles * kTile + 4;
}

// Dynamic shared memory of a block of a cluster of `cs` over `n` rows:
// the ring, q (8 rows per n-tile), each branch's max and sum (at the same
// offset in every block of a cluster, which reads the others'), then, for
// the block's share of the tiles, the row codes and the energies.
inline size_t smem_bytes(int n, int cs, int beam, int hd, int nt,
                         int stages = kStages) {
  const int tiles = (tiles_of(n) + cs - 1) / cs;
  return 2 * (size_t)padded_ld(hd) * (stages * kTile + 8 * nt)
         + 4 * 2 * kMaxBeam + 4 * (size_t)tiles * kTile
         + 4 * (size_t)beam * energy_ld(tiles);
}

// attend_online's layout: per ring stage a K tile, a V tile and the K
// tile's biases [8 NT][kLdb] (row stride 4 modulo 32 words: the fragment
// reads hit 32 banks); then q, one tile's bf16 weights [8 NT][kLdp] (36
// words a row), the warps' column maxima or sums, and three rows of
// per-branch statistics (max, sum, final sum) that a cluster exchanges.
constexpr int kLdb = kTile + 4;
constexpr int kLdp = kTile + 8;
inline size_t smem_bytes_online(int hd, int nt) {
  const size_t ld = padded_ld(hd);
  return kStages * (2 * 2 * kTile * ld + 4 * 8 * nt * (size_t)kLdb)
         + 2 * 8 * nt * ld + 2 * 8 * nt * (size_t)kLdp
         + 4 * (kWarps + 3) * (size_t)kMaxBeam;
}

// The cluster size for `blocks` blocks (one per (item, head)) over `n`
// rows each: doubled, up to kMaxCluster, while the grid stays within four
// blocks per SM and each block keeps at least one tile. A small grid (a
// few straggler items) then spreads each (item, head) over 2-4 SMs; a
// grid that fills the card keeps one block per (item, head) and no
// exchange.
inline int cluster_size(int blocks, int n) {
  const int sms = sm_count();
  int cs = 1;
  while (2 * cs <= kMaxCluster && 2 * cs <= tiles_of(n)
         && (long long)blocks * 2 * cs <= 4LL * sms)
    cs *= 2;
  return cs;
}

// Attention of the queries q[j * ldq + d] (j < beam <= kMaxBeam, d < hd) over
// the `n` rows of `rows`; writes out[j * ldo + d]. Called by all kThreads
// threads of each block of a cluster of `cs` (1: no cluster) with `smem` of
// smem_bytes(n, cs, beam, hd, NT, Stages) bytes (a ring of Stages tiles).
// Block rank k of the cluster takes the tiles [k T / cs, (k + 1) T / cs) of
// the T = tiles_of(n); the blocks exchange each branch's max and sum, so the
// weights are normalised over all n rows before they are rounded, then their
// partial outputs, which are summed in rank order.
template <int NT, int Stages = kStages, typename Rows>
__device__ __forceinline__ void attend(const Rows& rows,
                                       const __nv_bfloat16* q, int ldq,
                                       __nv_bfloat16* out, int ldo, int n,
                                       int beam, int hd, float inv_scale,
                                       int cs, unsigned char* smem) {
  namespace cg = cooperative_groups;
  using bf16 = __nv_bfloat16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = padded_ld(hd), chunks = hd / 8;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int t0 = rank * tiles_of(n) / cs;
  const int tiles = (rank + 1) * tiles_of(n) / cs - t0, steps = 2 * tiles;
  const int base = t0 * kTile;                    // this block's first row
  const int nl = min(n - base, tiles * kTile);    // and its row count
  const int lde = energy_ld(tiles);
  bf16* ring = reinterpret_cast<bf16*>(smem);      // [Stages][kTile][ld]
  bf16* qs = ring + Stages * kTile * ld;           // [8 NT][ld]
  float* stat = reinterpret_cast<float*>(qs + 8 * NT * ld);  // max, sum
  uint32_t* code = reinterpret_cast<uint32_t*>(stat + 2 * kMaxBeam);
  float* e = reinterpret_cast<float*>(code + tiles * kTile);  // [beam][lde]
  // every block of the cluster passes, and its shared memory is visible
  auto barrier = [&] {
    if (cs > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };

  for (int i = threadIdx.x; i < 8 * NT * chunks; i += kThreads) {
    const int j = i / chunks, col = i % chunks * 8;
    cp_async16(qs + j * ld + col, q + (size_t)min(j, beam - 1) * ldq + col,
               j < beam);
  }
  // rows past n copy the first row's code: their copies are zero-filled
  for (int r = threadIdx.x; r < tiles * kTile; r += kThreads)
    code[r] = rows.index(base + (r < nl ? r : 0));
  __syncthreads();

  // Each thread copies one 16-byte column chunk of every rpp-th row of a
  // tile (threads past rpp whole rows idle when chunks does not divide
  // kThreads). Step s < tiles stages K tile s and its biases, step
  // tiles + s V tile s.
  const int rpp = kThreads / chunks;
  const int lrow = threadIdx.x / chunks, lcol = threadIdx.x % chunks * 8;
  auto load = [&](int step) {
    const bool is_v = step >= tiles;
    const int r0 = (is_v ? step - tiles : step) * kTile;
    bf16* dst = ring + step % Stages * kTile * ld + lcol;
    if (lrow < rpp)
      for (int rr = lrow; rr < kTile; rr += rpp) {
        const uint32_t x = code[r0 + rr];
        cp_async16(dst + rr * ld, (is_v ? rows.v(x) : rows.k(x)) + lcol,
                   r0 + rr < nl);
      }
    if (!is_v)
      for (int i = threadIdx.x; i < beam * kTile; i += kThreads) {
        const int j = i / kTile, r = r0 + i % kTile;
        if (r < nl) cp_async4(e + j * lde + r, rows.bias(j, base + r, code[r]));
      }
  };
  load(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < Stages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  const int mtiles = hd / 16;
  float acc[kMaxMt][NT][4];  // Oᵀ: m-tiles warp, warp + kWarps, ...
#pragma unroll
  for (int mi = 0; mi < kMaxMt; ++mi)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][nt][h] = 0.f;

  for (int step = 0; step < steps; ++step) {
    if (step + Stages - 1 < steps) load(step + Stages - 1);
    cp_async_commit();  // an empty group past the last load keeps the count
    cp_async_wait<Stages - 1>();
    __syncthreads();  // this step's tile (and q) has landed for every thread
    const bf16* tile = ring + step % Stages * kTile * ld;
    if (step < tiles) {
      // Sᵀ for this warp's 16 rows of the tile, added to their biases
      const int r0 = step * kTile + 16 * warp;
      if (r0 < nl) {
        float s[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) s[nt][h] = 0.f;
        const bf16* arow = tile + (16 * warp + (lane & 7) + (lane & 8)) * ld
                           + (lane >> 4) * 8;
        const bf16* brow = qs + (lane & 7) * ld + (lane & 8);
        for (int k0 = 0; k0 < hd; k0 += 16) {
          uint32_t a[4];
          ldmatrix_x4(a, arow + k0);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t b[2];
            ldmatrix_x2(b, brow + 8 * nt * ld + k0);
            mma_bf16_16816(s[nt], a, b);
          }
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = 8 * nt + 2 * t + (h & 1), r = r0 + g + 8 * (h >> 1);
            if (j < beam && r < nl) e[j * lde + r] += s[nt][h] * inv_scale;
          }
      }
    } else {
      if (step == tiles) {
        // every energy is in: one softmax per branch over the cluster's
        // rows; the weights are rounded to bf16 in place (row j's bf16
        // weights over the first half of its f32 energies), zero past nl
        // up to the tile edge
        for (int j = warp; j < beam; j += kWarps) {
          float m = -INFINITY;
          for (int r = lane; r < nl; r += 32) m = fmaxf(m, e[j * lde + r]);
          m = warp_max(m);
          if (lane == 0) stat[j] = m;
        }
        barrier();
        for (int j = warp; j < beam; j += kWarps) {
          float* ej = e + j * lde;
          float m = stat[j];
          for (int k = 0; k < cs; ++k)
            if (k != rank)
              m = fmaxf(m, cg::this_cluster().map_shared_rank(stat, k)[j]);
          float sum = 0.f;
          for (int r = lane; r < nl; r += 32) {
            const float w = expf(ej[r] - m);
            ej[r] = w;
            sum += w;
          }
          sum = warp_sum(sum);
          if (lane == 0) stat[kMaxBeam + j] = sum;
        }
        barrier();
        for (int j = warp; j < beam; j += kWarps) {
          float* ej = e + j * lde;
          float sum = 0.f;  // in rank order, the same in every block
          for (int k = 0; k < cs; ++k)
            sum += k == rank
                       ? stat[kMaxBeam + j]
                       : cg::this_cluster().map_shared_rank(stat, k)[kMaxBeam + j];
          bf16* pj = reinterpret_cast<bf16*>(ej);
          for (int r0 = 0; r0 < tiles * kTile; r0 += 32) {
            const int r = r0 + lane;
            const float w = r < nl ? ej[r] / sum : 0.f;
            __syncwarp();  // chunk r0's energies are read before any write
            pj[r] = __float2bfloat16_rn(w);
          }
        }
        __syncthreads();
      }
      // Oᵀ += Vᵀ·Pᵀ over this tile's rows, for this warp's m-tiles
      const int r0 = (step - tiles) * kTile;
      for (int k0 = 0; k0 < kTile && r0 + k0 < nl; k0 += 16) {
        uint32_t b[NT][2];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = 8 * nt + g;
          const bf16* p =
              reinterpret_cast<const bf16*>(e + min(j, beam - 1) * lde)
              + r0 + k0 + 2 * t;
          b[nt][0] = j < beam ? *reinterpret_cast<const uint32_t*>(p) : 0u;
          b[nt][1] = j < beam ? *reinterpret_cast<const uint32_t*>(p + 8) : 0u;
        }
        const bf16* vrow = tile + (k0 + (lane & 7) + (lane >> 4) * 8) * ld
                           + (lane & 8);
#pragma unroll
        for (int mi = 0; mi < kMaxMt; ++mi) {
          const int mt = warp + kWarps * mi;
          if (mt < mtiles) {
            uint32_t a[4];
            ldmatrix_x4_trans(a, vrow + 16 * mt);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mi][nt], a, b[nt]);
          }
        }
      }
    }
    __syncthreads();  // the tile is consumed before the ring reuses it
  }

  // with a cluster, the partial Oᵀ go through the (now idle) ring, and
  // rank k sums the outputs k, k + cs, ... (in kThreads chunks)
  float* part = reinterpret_cast<float*>(ring);  // [beam][hd]
#pragma unroll
  for (int mi = 0; mi < kMaxMt; ++mi) {
    const int mt = warp + kWarps * mi;
    if (mt < mtiles) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int j = 8 * nt + 2 * t + (h & 1);
          const int d = 16 * mt + g + 8 * (h >> 1);
          if (j >= beam) continue;
          if (cs > 1)
            part[j * hd + d] = acc[mi][nt][h];
          else
            out[(size_t)j * ldo + d] = __float2bfloat16_rn(acc[mi][nt][h]);
        }
    }
  }
  if (cs > 1) {
    barrier();
    for (int i = (rank * kThreads) + threadIdx.x; i < beam * hd;
         i += cs * kThreads) {
      float o = 0.f;
      for (int k = 0; k < cs; ++k)
        o += cg::this_cluster().map_shared_rank(part, k)[i];
      out[(size_t)(i / hd) * ldo + i % hd] = __float2bfloat16_rn(o);
    }
    barrier();  // no block leaves while another reads its partials
  }
}

// One-pass attention of the queries q[j * ldq + d] (j < beam <= kMaxBeam,
// d < hd) over the `n` rows of `rows`, with an online softmax; writes
// out[j * ldo + d]. Called by all kThreads threads of each block of a
// cluster of `cs` (1: no cluster) with `smem` of smem_bytes_online(hd, NT)
// bytes. Block rank k takes the tiles [k T / cs, (k + 1) T / cs) of the
// T = tiles_of(n); the blocks then bring their running max, sum and partial
// outputs to the cluster's max, and the outputs are summed in rank order.
template <int NT, typename Rows>
__device__ __forceinline__ void attend_online(const Rows& rows,
                                              const __nv_bfloat16* q, int ldq,
                                              __nv_bfloat16* out, int ldo,
                                              int n, int beam, int hd,
                                              float inv_scale, int cs,
                                              unsigned char* smem) {
  namespace cg = cooperative_groups;
  using bf16 = __nv_bfloat16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ld = padded_ld(hd), chunks = hd / 8;
  const int rank = cs > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int t0 = rank * tiles_of(n) / cs;
  const int tiles = (rank + 1) * tiles_of(n) / cs - t0;
  const int base = t0 * kTile;                    // this block's first row
  const int nl = min(n - base, tiles * kTile);    // and its row count
  bf16* ring = reinterpret_cast<bf16*>(smem);      // [kStages][K, V][kTile][ld]
  float* bias = reinterpret_cast<float*>(ring + kStages * 2 * kTile * ld);
                                                   // [kStages][8 NT][kLdb]
  bf16* qs = reinterpret_cast<bf16*>(bias + kStages * 8 * NT * kLdb);
                                                   // [8 NT][ld]
  bf16* pw = qs + 8 * NT * ld;                     // [8 NT][kLdp]
  float* red = reinterpret_cast<float*>(pw + 8 * NT * kLdp);
                                                   // [kWarps][kMaxBeam]
  float* stat = red + kWarps * kMaxBeam;           // [max, sum, total][kMaxBeam]
  auto barrier = [&] {
    if (cs > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };

  for (int i = threadIdx.x; i < 8 * NT * chunks; i += kThreads) {
    const int j = i / chunks, col = i % chunks * 8;
    cp_async16(qs + j * ld + col, q + (size_t)min(j, beam - 1) * ldq + col,
               j < beam);
  }
  // Each thread copies one 16-byte column chunk of K and of V of every
  // rpp-th row of a tile, and the biases of the branches j = its chunk,
  // + chunks, ... of those rows.
  const int rpp = kThreads / chunks;
  const int lrow = threadIdx.x / chunks, lcol = threadIdx.x % chunks * 8;
  auto load = [&](int s) {
    bf16* kd = ring + s % kStages * 2 * kTile * ld + lcol;
    bf16* vd = kd + kTile * ld;
    float* bd = bias + s % kStages * 8 * NT * kLdb;
    if (lrow < rpp)
      for (int rr = lrow; rr < kTile; rr += rpp) {
        const int r = s * kTile + rr;
        const bool ok = r < nl;
        const uint32_t x = rows.index(base + (ok ? r : 0));
        cp_async16(kd + rr * ld, rows.k(x) + lcol, ok);
        cp_async16(vd + rr * ld, rows.v(x) + lcol, ok);
        if (ok)
          for (int j = lcol / 8; j < beam; j += chunks)
            cp_async4(bd + j * kLdb + rr, rows.bias(j, base + r, x));
      }
  };
  load(0);
  cp_async_commit();
#pragma unroll
  for (int s = 1; s < kStages - 1; ++s) {
    if (s < tiles) load(s);
    cp_async_commit();
  }

  const int mtiles = hd / 16;
  float acc[kMaxMt][NT][4];  // Oᵀ: m-tiles warp, warp + kWarps, ...
  // each lane's two branch columns 2t, 2t + 1 of each n-tile: running max
  // (finite, so that a column past `beam` or a tile of padding rows gives
  // weights exp(-inf) = 0 and a rescale of exp(0) = 1) and this lane's
  // share of the running sum
  float m[NT][2], l[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      m[nt][c] = -1e30f;
      l[nt][c] = 0.f;
    }
#pragma unroll
    for (int mi = 0; mi < kMaxMt; ++mi)
#pragma unroll
      for (int h = 0; h < 4; ++h) acc[mi][nt][h] = 0.f;
  }

  for (int step = 0; step < tiles; ++step) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // this step's tile (and q) has landed for every
                      // thread, and every warp is done with the last one
    if (step + kStages - 1 < tiles) load(step + kStages - 1);
    cp_async_commit();  // an empty group past the last load keeps the count
    const bf16* kt = ring + step % kStages * 2 * kTile * ld;
    const bf16* vt = kt + kTile * ld;
    const float* bt = bias + step % kStages * 8 * NT * kLdb;

    // Sᵀ for this warp's 16 rows of the tile
    const int r0 = step * kTile + 16 * warp;
    float s[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) s[nt][h] = 0.f;
    if (r0 < nl) {
      const bf16* arow = kt + (16 * warp + (lane & 7) + (lane & 8)) * ld
                         + (lane >> 4) * 8;
      const bf16* brow = qs + (lane & 7) * ld + (lane & 8);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + k0);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[2];
          ldmatrix_x2(b, brow + 8 * nt * ld + k0);
          mma_bf16_16816(s[nt], a, b);
        }
      }
    }
    // scaled energies plus biases (-inf past `beam` and `nl`), and each
    // column's max over the warp's rows
    float cm[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      cm[nt][0] = cm[nt][1] = -INFINITY;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int j = 8 * nt + 2 * t + (h & 1);
        const int rt = 16 * warp + g + 8 * (h >> 1);
        s[nt][h] = j < beam && step * kTile + rt < nl
                       ? s[nt][h] * inv_scale + bt[j * kLdb + rt]
                       : -INFINITY;
        cm[nt][h & 1] = fmaxf(cm[nt][h & 1], s[nt][h]);
      }
#pragma unroll
      for (int c = 0; c < 2; ++c) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          cm[nt][c] = fmaxf(cm[nt][c], __shfl_xor_sync(0xffffffffu, cm[nt][c], o));
        if (g == 0) red[warp * kMaxBeam + 8 * nt + 2 * t + c] = cm[nt][c];
      }
    }
    __syncthreads();
    // every warp reads the same four maxima: one running max per branch
    float alpha[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int j = 8 * nt + 2 * t + c;
        float mt = red[j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) mt = fmaxf(mt, red[w * kMaxBeam + j]);
        const float mn = fmaxf(m[nt][c], mt);
        alpha[nt][c] = expf(m[nt][c] - mn);
        m[nt][c] = mn;
        l[nt][c] *= alpha[nt][c];
      }
    // weights exp(e - m), summed unrounded and rounded to bf16 for Pᵀ
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float w = expf(s[nt][h] - m[nt][h & 1]);
        l[nt][h & 1] += w;
        pw[(8 * nt + 2 * t + (h & 1)) * kLdp + 16 * warp + g + 8 * (h >> 1)] =
            __float2bfloat16_rn(w);
      }
    __syncthreads();  // the tile's weights are in

    // Oᵀ = Oᵀ alpha + Vᵀ·Pᵀ over this tile's rows, for this warp's m-tiles
#pragma unroll
    for (int mi = 0; mi < kMaxMt; ++mi)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) acc[mi][nt][h] *= alpha[nt][h & 1];
    for (int k0 = 0; k0 < kTile && step * kTile + k0 < nl; k0 += 16) {
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const bf16* p = pw + (8 * nt + g) * kLdp + k0 + 2 * t;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
      const bf16* vrow = vt + (k0 + (lane & 7) + (lane >> 4) * 8) * ld
                         + (lane & 8);
#pragma unroll
      for (int mi = 0; mi < kMaxMt; ++mi) {
        const int mt = warp + kWarps * mi;
        if (mt < mtiles) {
          uint32_t a[4];
          ldmatrix_x4_trans(a, vrow + 16 * mt);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mi][nt], a, b[nt]);
        }
      }
    }
  }

  // each branch's sum over the block's rows: over a column's lanes, then
  // over the warps (every warp has read the last maxima: no barrier)
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        l[nt][c] += __shfl_xor_sync(0xffffffffu, l[nt][c], o);
      if (g == 0) red[warp * kMaxBeam + 8 * nt + 2 * t + c] = l[nt][c];
    }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * nt + 2 * t + c;
      float sum = red[j];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) sum += red[w * kMaxBeam + j];
      l[nt][c] = sum;
    }

  if (cs == 1) {
#pragma unroll
    for (int mi = 0; mi < kMaxMt; ++mi) {
      const int mt = warp + kWarps * mi;
      if (mt < mtiles) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int j = 8 * nt + 2 * t + (h & 1);
            const int d = 16 * mt + g + 8 * (h >> 1);
            if (j < beam)
              out[(size_t)j * ldo + d] =
                  __float2bfloat16_rn(acc[mi][nt][h] / l[nt][h & 1]);
          }
      }
    }
    return;
  }

  // a cluster: the blocks' running max and sum, brought to the cluster's
  // max M; each block writes its Oᵀ exp(m - M) through the (now idle)
  // ring, and rank k sums the outputs k, k + cs, ... (in kThreads chunks)
  if (warp == 0 && g == 0)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        stat[8 * nt + 2 * t + c] = m[nt][c];
        stat[kMaxBeam + 8 * nt + 2 * t + c] = l[nt][c];
      }
  cp_async_wait<0>();
  barrier();
  float f[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = 8 * nt + 2 * t + c;
      float mx = m[nt][c];
      for (int k = 0; k < cs; ++k)
        mx = fmaxf(mx, cg::this_cluster().map_shared_rank(stat, k)[j]);
      float sum = 0.f;  // in rank order, the same in every block
      for (int k = 0; k < cs; ++k) {
        const float* sk = cg::this_cluster().map_shared_rank(stat, k);
        sum += sk[kMaxBeam + j] * expf(sk[j] - mx);
      }
      f[nt][c] = expf(m[nt][c] - mx);
      if (warp == 0 && g == 0) stat[2 * kMaxBeam + j] = sum;
    }
  float* part = reinterpret_cast<float*>(ring);  // [beam][hd]
#pragma unroll
  for (int mi = 0; mi < kMaxMt; ++mi) {
    const int mt = warp + kWarps * mi;
    if (mt < mtiles) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int j = 8 * nt + 2 * t + (h & 1);
          const int d = 16 * mt + g + 8 * (h >> 1);
          if (j < beam) part[j * hd + d] = acc[mi][nt][h] * f[nt][h & 1];
        }
    }
  }
  barrier();
  for (int i = (rank * kThreads) + threadIdx.x; i < beam * hd;
       i += cs * kThreads) {
    float o = 0.f;
    for (int k = 0; k < cs; ++k)
      o += cg::this_cluster().map_shared_rank(part, k)[i];
    out[(size_t)(i / hd) * ldo + i % hd] =
        __float2bfloat16_rn(o / stat[2 * kMaxBeam + i / hd]);
  }
  barrier();  // no block leaves while another reads its partials
}

// Launches `Kernel` (a kernel of `Threads` threads taking `smem` bytes of
// dynamic shared memory) on `blocks` blocks in clusters of `cs`, after
// prepare<Kernel>().
template <auto Kernel, int Threads = kThreads, typename... Args>
cudaError_t launch(int blocks, int cs, size_t smem, cudaStream_t stream,
                   Args... args) {
  cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, Kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace mma_attn
}  // namespace dh

// K12: the absorbed multi-head latent attention (MLA) of one decode step
// over the beam's ancestry.
//
// In DeepSeek-V3's block (the language model of Kimi-VL) every position
// caches one latent row [c | k_pe]: the normalised 512-wide latent and the
// 64-wide rotated key, 576 bf16 values shared by all heads. Absorbing the
// key half of kv_b_proj into the query (q_lat = W_k,hᵀ q_nope) and its value
// half into the output (models/mla_moe.py) leaves, per head h and branch j,
//     e = (q_lat · c + q_pe · k_pe) * scale,   out = Σ softmax(e) · c,
// a 576-wide query against 576-wide rows and a 512-wide output against the
// first 512 columns of the same rows. So every head and branch of an item
// reads the same rows: one block takes an item's beam x H queries (16 heads
// x 5 branches at the published shape) and reads each row once for all of
// them.
//
// An item's rows are its prefix rows (the image prefix, `T0` per item,
// written once per item by the prefill and read by every branch) and the
// generated rows of its beam slots ([items * beam, S, 576], positions
// below `pe`), of which branch j reads (slot i, position p) where its
// additive bias (0 or -1e8, [items, beam, beam * S], as K1's
// ops/attention.py ancestry_bias) is 0. The block first lists the
// generated rows that some branch selects (row_list.cuh, as K1 does; a
// dropped row had weight exactly 0 in every branch), then attends over the
// prefix rows and the list. Softmax runs in f32 over the flat row axis;
// the weights are normalised and then rounded to bf16 before the second
// product, as the twin computes.
//
// Design: one block of sixteen warps an item. The queries (M = beam x H
// rows of 576, query m = j * H + h: q_lat from the head-major product of
// the absorbed key half, q_pe from the rotated projection) are staged once
// in shared memory by cp.async while the list's biases land. Rows stream through a ring of
// three 16-row tiles, two in flight; the first value tiles land during the
// softmax.
//   * S = Q·Kᵀ: queries in M (16-row m-tiles), rows in N (two 8-row
//     n-tiles a tile), the 576 columns in K; each (m-tile, n-tile) pair is
//     a warp's (ten of the sixteen at 80 queries). A fragments by ldmatrix from the staged
//     queries, B fragments by ldmatrix from the row-major tile. Every
//     energy stays in shared memory in f32 (M x the rows: 72 KB at 224
//     rows), with the branch's bias added.
//   * A warp per query row takes the softmax; the rounded weights P
//     (bf16) overwrite the staged queries.
//   * O = P·V: queries in M, the 512 output columns in N (32 a warp, so
//     each warp owns its outputs and nothing is reduced across warps), the
//     rows in K; A fragments from P, B fragments by ldmatrix.trans from the
//     tile's first 512 columns. The rows are read a second time here (the
//     block's rows, 74-250 KB, are mostly still in L2). The output is
//     head-major, the operand of the absorbed value half's product.
// At 80 queries and 224 rows a block takes ~218 KB of shared memory: one
// block an SM, 768 items in about six waves.
//
// Bound on the H100: bytes. Per item the rows read once, (T0 + listed rows)
// x 1152 bytes, the queries in (80 x 1152) and the output out (80 x 1024):
// at the Kimi-VL cell's shape (768 items, beam 5, 16 heads, T0 64, pe 16)
// ~75 + 71 + 63 MB a launch, ~62 us at 3.35 TB/s; the products are 2 x 80 x
// (576 + 512) FLOPs a row read, ~11 GFLOP.

#include "row_list.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int kDk = 576;            // latent (512) + rotary key (64)
constexpr int kDv = 512;            // the latent: the output's width
constexpr int kLdk = kDk + 8;       // staged row stride (bf16): 16-byte pad
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;           // rows a staged tile
constexpr int kStages = 3;          // tiles in the ring
constexpr int kMaxMt = 5;           // m-tiles of 16 queries: 80 queries
constexpr int kColsPerWarp = kDv / kWarps;  // 32: four n-tiles
constexpr int kRope = kDk - kDv;

// The dense generated rows of one item for row_list.cuh: row r is (slot r
// / pe, position r % pe), coded slot * S + position, which is also its
// bias column; branch j's bias row is `b + j * beam * S`.
struct GenRows {
  const float* b;
  int S, pe, bstride;
  __device__ uint32_t index(int r) const {
    return (uint32_t)((r / pe) * S + r % pe);
  }
  __device__ const float* bias(int j, int, uint32_t x) const {
    return b + (size_t)j * bstride + x;
  }
};

// Rows of the energies (f32) and of the weights (bf16) for up to `n`
// rows: whole tiles, plus 4 and 8 values so rows start on distinct banks.
__host__ __device__ inline int rows_padded(int n) {
  return (n + kRows - 1) / kRows * kRows;
}

struct Layout {
  size_t list, q, e, ring, total;
  int lde, ldp;
  __host__ __device__ Layout(int beam, int H, int T0, int pe) {
    const int m = beam * H, n = rows_padded(T0 + beam * pe);
    lde = n + 4;
    ldp = n + 8;
    list = 0;
    // row_list.cuh sizes a word of flags for four warps; a block of
    // sixteen writes twelve more
    q = dh::row_list_bytes(beam * pe) + 4 * (kWarps - 4);
    e = q + (size_t)m * kLdk * 2;
    ring = e + (size_t)m * lde * 4;
    total = ring + kStages * (size_t)kRows * kLdk * 2;
  }
};

template <int MT>
__global__ void __launch_bounds__(kThreads, 1) mla_attention_kernel(
    const bf16* __restrict__ q_lat, const bf16* __restrict__ q_pe,
    const bf16* __restrict__ prefix, const bf16* __restrict__ gen,
    const float* __restrict__ bias, bf16* __restrict__ out,
    unsigned long long* __restrict__ tally, int rows, int beam, int H,
    int T0, int S, int pe, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int g = blockIdx.x, M = MT * 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Layout lay(beam, H, T0, pe);
  uint32_t* list = reinterpret_cast<uint32_t*>(smem + lay.list);
  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  bf16* ps = qs;  // the weights overwrite the queries after S
  float* es = reinterpret_cast<float*>(smem + lay.e);
  bf16* ring = reinterpret_cast<bf16*>(smem + lay.ring);
  const float* bias_g = bias + (size_t)g * beam * beam * S;
  const size_t r0 = (size_t)g * beam;  // the item's first row

  // the list of generated rows that some branch selects; the queries land
  // meanwhile
  const GenRows dense{bias_g, S, pe, beam * S};
  const int walk = dh::build_row_list<kThreads>(
      dense, beam * pe, beam, 1, false, 1, list, es,
      (int)(lay.ring - lay.e), [&] {
        for (int c = threadIdx.x; c < M * (kDk / 8); c += kThreads) {
          const int m = c / (kDk / 8), v = c % (kDk / 8);
          const size_t r = r0 + m / H;
          const int h = m % H;
          const bf16* src =
              v < kDv / 8 ? q_lat + ((size_t)h * rows + r) * kDv + 8 * v
                          : q_pe + (r * H + h) * kRope + 8 * v - kDv;
          dh::cp_async16(qs + m * kLdk + 8 * v, src, true);
        }
        dh::cp_async_commit();
      });
  if (threadIdx.x == 0) dh::tally_rows(tally, g, walk, beam * pe);
  const int n = T0 + walk, tiles = (n + kRows - 1) / kRows;

  auto row_ptr = [&](int r) -> const bf16* {
    return r < T0 ? prefix + ((size_t)g * T0 + r) * kDk
                  : gen + ((size_t)g * beam * S + list[r - T0]) * kDk;
  };
  // tile t's rows (their first `vecs` 16-byte vectors) into ring stage st;
  // rows past n are zero-filled
  auto load = [&](int t, int st, int vecs) {
    bf16* dst = ring + st * kRows * kLdk;
    for (int c = threadIdx.x; c < kRows * vecs; c += kThreads) {
      const int rr = c / vecs, v = c % vecs, r = t * kRows + rr;
      const bool ok = r < n;
      dh::cp_async16(dst + rr * kLdk + 8 * v, ok ? row_ptr(r) + 8 * v : prefix,
                     ok);
    }
    dh::cp_async_commit();
  };

  // the ring: tile t in stage t % kStages, loaded kStages - 1 tiles ahead;
  // the barrier before a tile's product also ends every warp's reads of the
  // stage that the next load refills
  auto prime = [&](int vecs) {
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < tiles) load(t, t, vecs);
      else dh::cp_async_commit();
    }
  };
  auto next = [&](int t, int vecs) {
    dh::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int u = t + kStages - 1;
    if (u < tiles) load(u, u % kStages, vecs);
    else dh::cp_async_commit();
    return ring + (t % kStages) * kRows * kLdk;
  };

  // S = Q·Kᵀ, scaled, plus each query's branch bias, into the energies
  prime(kDk / 8);
  for (int t = 0; t < tiles; ++t) {
    const bf16* kt = next(t, kDk / 8);
    if (warp < MT * 2) {
      const int job = warp;
      const int mt = job >> 1, nt = job & 1;
      // two chains of products (even and odd k), summed at the end
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, odd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 3
      for (int k = 0; k < kDk / 16; k += 2) {
        uint32_t a[4], b[2], a1[4], b1[2];
        dh::ldmatrix_x4(a, qs + (mt * 16 + (lane & 15)) * kLdk + k * 16
                               + (lane >> 4) * 8);
        dh::ldmatrix_x2(b, kt + (nt * 8 + (lane & 7)) * kLdk + k * 16
                               + ((lane >> 3) & 1) * 8);
        dh::ldmatrix_x4(a1, qs + (mt * 16 + (lane & 15)) * kLdk + k * 16 + 16
                                + (lane >> 4) * 8);
        dh::ldmatrix_x2(b1, kt + (nt * 8 + (lane & 7)) * kLdk + k * 16 + 16
                                + ((lane >> 3) & 1) * 8);
        dh::mma_bf16_16816(acc, a, b);
        dh::mma_bf16_16816(odd, a1, b1);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += odd[u];
      const int c0 = t * kRows + nt * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = mt * 16 + (lane >> 2) + 8 * h2, j = m / H;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = c0 + u;
          float v = acc[2 * h2 + u] * scale;
          if (c >= n)
            v = -INFINITY;
          else if (c >= T0)
            v += __ldg(bias_g + (size_t)j * beam * S + list[c - T0]);
          es[m * lay.lde + c] = v;
        }
      }
    }
  }
  __syncthreads();
  // the first value tiles land during the softmax
  prime(kDv / 8);

  // softmax of each query row; the rounded weights (0 past n) into P
  const int npad = tiles * kRows;
  for (int m = warp; m < M; m += kWarps) {
    const float* e = es + m * lay.lde;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, e[c]);
    mx = dh::warp_max(mx);
    float s = 0.f;
    for (int c = lane; c < n; c += 32) s += expf(e[c] - mx);
    s = dh::warp_sum(s);
    const float inv = 1.f / s;
    bf16* p = ps + m * lay.ldp;
    for (int c = lane; c < npad; c += 32)
      p[c] = __float2bfloat16_rn(c < n ? expf(e[c] - mx) * inv : 0.f);
  }

  // O = P·V over the tiles' first 512 columns, 64 output columns a warp
  constexpr int kNt = kColsPerWarp / 8;
  float acc[MT][kNt][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mt][nt][u] = 0.f;
  const int col0 = warp * kColsPerWarp;
  for (int t = 0; t < tiles; ++t) {
    const bf16* vt = next(t, kDv / 8);
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      dh::ldmatrix_x4(a[mt], ps + (mt * 16 + (lane & 15)) * lay.ldp
                                 + t * kRows + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kNt / 2; ++np) {
      uint32_t b[4];
      dh::ldmatrix_x4_trans(b, vt + (((lane >> 3) & 1) * 8 + (lane & 7)) * kLdk
                                   + col0 + np * 16 + (lane >> 4) * 8);
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        dh::mma_bf16_16816(acc[mt][2 * np], a[mt], b0);
        dh::mma_bf16_16816(acc[mt][2 * np + 1], a[mt], b1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = mt * 16 + (lane >> 2) + 8 * h2;
        const int c = col0 + nt * 8 + 2 * (lane & 3);
        const size_t o = ((size_t)(m % H) * rows + r0 + m / H) * kDv + c;
        *reinterpret_cast<__nv_bfloat162*>(out + o) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h2],
                                  acc[mt][nt][2 * h2 + 1]);
      }
}

template <int MT>
cudaError_t launch(const void* q_lat, const void* q_pe, const void* prefix,
                   const void* gen, const void* bias, void* out,
                   void* tally, int items, int beam, int H, int T0, int S,
                   int pe, float scale, cudaStream_t stream) {
  constexpr auto kernel = &mla_attention_kernel<MT>;
  cudaError_t err = dh::prepare<kernel>();
  if (err != cudaSuccess) return err;
  const Layout lay(beam, H, T0, pe);
  kernel<<<items, kThreads, lay.total, stream>>>(
      (const bf16*)q_lat, (const bf16*)q_pe, (const bf16*)prefix,
      (const bf16*)gen, (const float*)bias, (bf16*)out,
      (unsigned long long*)tally, items * beam, beam, H, T0, S, pe, scale);
  return cudaGetLastError();
}

}  // namespace

// q_lat: [H, items * beam, 512] (head-major), q_pe: [items * beam, H, 64],
// prefix: [items, T0, 576], gen: [items * beam, S, 576], bias: f32 [items,
// beam, beam * S], out: [H, items * beam, 512] (head-major), all bf16 but
// the bias and contiguous; query m = j * H + h of item g reads row g * beam
// + j. tally: NULL or the device's rows tally (row_list.cuh), to which each
// block adds its listed generated rows and its dense beam x pe (the prefix
// rows, read by every block, are not counted). beam * H a multiple of 16
// up to 80, beam <= 32, 1 <= pe <= S and T0 + beam * pe <= 576 (the
// wrapper checks them).
extern "C" int dh_mla_attention(const void* q_lat, const void* q_pe,
                                const void* prefix, const void* gen,
                                const void* bias, void* out, void* tally,
                                int items, int beam, int H, int T0, int S,
                                int pe, float scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if (items < 1) return cudaSuccess;
#define DH_MLA(MT)                                                        \
  case MT:                                                                \
    return launch<MT>(q_lat, q_pe, prefix, gen, bias, out, tally, items,  \
                      beam, H, T0, S, pe, scale, s)
  switch (beam * H / 16) {
    DH_MLA(1);
    DH_MLA(2);
    DH_MLA(3);
    DH_MLA(4);
    DH_MLA(kMaxMt);
    default: return cudaErrorInvalidValue;
  }
#undef DH_MLA
}

// The dynamic shared memory of a block at this shape.
extern "C" long long dh_mla_attention_smem(int beam, int H, int T0, int pe) {
  return (long long)Layout(beam, H, T0, pe).total;
}

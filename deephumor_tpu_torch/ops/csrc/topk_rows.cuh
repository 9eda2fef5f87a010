// The row body of the exact keep-ties top-k filter and Gumbel-top-k draw,
// shared by K3 (topk_gumbel.cu, over logits in device memory) and K4's
// streamed path (classifier_topk_gumbel.cu, over the bf16 logits its
// product kernel wrote). topk_gumbel.cu's header describes the design.
//
// A kernel declares the dynamic shared memory, calls `sample_rows` with a
// layout from `plan`, and says where draw j of row r goes through `out(r,
// j, id)`; `plan` sizes the grid as K3 does.
#pragma once

#include "common.cuh"

namespace dh {
namespace topk {

constexpr int kTeam = 128;  // threads of a team: one row at a time
constexpr int kTeamWarps = kTeam / 32;
constexpr int kMaxTeams = 4;
constexpr int kCap = 1024;        // candidate-list capacity
constexpr int kChunk = 16 << 10;  // bytes per bulk copy instruction
// the team's small shared values: the list's length, reduction scratch
constexpr int kLen = 0, kScratch = 4, kMisc = 8;

// A team's shared memory: the row buffer (the row plus up to 16 bytes of
// alignment slack), the list's keys and columns (`cap` each, a multiple of
// 4), the maxima, kMisc ints, and with `table` the high 16 bits of each
// 16-byte vector's largest key; every part a multiple of 16 bytes. The
// teams' mbarriers follow the teams.
struct TeamLayout {
  int cap, buf, vhi, team;
  bool table;
  TeamLayout() = default;
  __host__ __device__ TeamLayout(int V, int elt, int cap, bool table)
      : cap(cap),
        buf((V * elt + 31) / 16 * 16),
        vhi(buf + 8 * cap + 4 * kTeam + 4 * kMisc),
        team(vhi + (table ? (buf / 8 + 15) / 16 * 16 : 0)),
        table(table) {}
};

// The layout of a team at V logits of `elt` bytes under `optin` bytes: the
// table and a list of kCap where that fits, else no table and the longest
// list that fits (its `team + 8` is past `optin` if not even a block of one
// team with an empty list fits).
inline TeamLayout layout_for(int V, int elt, int optin) {
  const TeamLayout full(V, elt, kCap, true), bare(V, elt, 0, false);
  if (full.team + 8 <= optin) return full;
  const int cap = (optin - 8 - bare.team) / 8 / 4 * 4;
  return cap > 0 ? TeamLayout(V, elt, cap < kCap ? cap : kCap, false) : bare;
}

// Teams of layout `lay` a block holds under `optin` bytes of shared memory
// (at most kMaxTeams; 0 if none fits), and their bytes.
inline int teams_for(const TeamLayout& lay, int optin) {
  const int t = optin / (lay.team + 8);
  return t < kMaxTeams ? t : kMaxTeams;
}
inline size_t smem_for(const TeamLayout& lay, int teams) {
  return (size_t)teams * (lay.team + 8);
}

// A launch of a kernel that runs `sample_rows`: its teams' layout, the
// teams of a block, the block's shared memory and the grid.
struct Plan {
  TeamLayout lay;
  int teams, threads, blocks;
  size_t smem;
};

// The plan of `Kernel` over `live` rows of V logits of `elt` bytes: as many
// teams a block as fit (up to kMaxTeams), as many blocks as the rows need
// and the card holds at once (at least one, which may only zero rows).
template <auto Kernel>
cudaError_t plan(int V, int elt, int live, Plan* p) {
  cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return err;
  const int optin = smem_optin();
  const TeamLayout lay = layout_for(V, elt, optin);
  const int teams = teams_for(lay, optin);
  if (teams < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_for(lay, teams);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                      teams * kTeam, smem);
  if (err != cudaSuccess) return err;
  const int want = (live + teams - 1) / teams;
  const int fit = (per_sm > 1 ? per_sm : 1) * sm_count();
  *p = Plan{lay, teams, teams * kTeam, want < 1 ? 1 : want < fit ? want : fit,
            smem};
  return cudaSuccess;
}

// Whether a row of V bf16 logits is past every team's buffer under `optin`
// bytes, so that K3 reads it where it lies (sample_rows_streamed); an f32
// row that no buffer holds is refused.
inline bool streams(int V, int elt, int optin) {
  return elt == 2 && teams_for(layout_for(V, elt, optin), optin) < 1;
}
// The layout of a team that stages no row: the list, the maxima, kMisc ints.
inline TeamLayout streamed_layout(int elt) {
  return TeamLayout(0, elt, kCap, false);
}

// The plan of a kernel that runs `sample_rows_streamed` over `live` rows:
// kMaxTeams teams a block, as many blocks as the rows need and the card
// holds at once.
template <auto Kernel>
cudaError_t plan_streamed(int elt, int live, Plan* p) {
  cudaError_t err = prepare<Kernel>();
  if (err != cudaSuccess) return err;
  const TeamLayout lay = streamed_layout(elt);
  const size_t smem = smem_for(lay, kMaxTeams);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, Kernel, kMaxTeams * kTeam, smem);
  if (err != cudaSuccess) return err;
  const int want = (live + kMaxTeams - 1) / kMaxTeams;
  const int fit = (per_sm > 1 ? per_sm : 1) * sm_count();
  *p = Plan{lay, kMaxTeams, kMaxTeams * kTeam,
            want < 1 ? 1 : want < fit ? want : fit, smem};
  return cudaSuccess;
}

// Where row `src` of V logits lies in its buffer: element 0 at byte `off`
// (src's offset from 16-byte alignment); the aligned interior, `nvec`
// 16-byte vectors from buffer byte `ib`, holds elements [head, tail); the
// elements outside it come by plain loads.
template <typename T>
struct RowSpan {
  int off, ib, head, nvec, tail;
  const char* interior;  // device address of the interior
  __device__ RowSpan(const T* src, int V) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = (a + 15) & ~uintptr_t(15);
    const uintptr_t a1 = (a + (size_t)V * sizeof(T)) & ~uintptr_t(15);
    off = (int)(a & 15);
    ib = off ? 16 : 0;
    interior = reinterpret_cast<const char*>(a0);
    if (a1 > a0) {
      head = (int)(a0 - a) / (int)sizeof(T);
      nvec = (int)((a1 - a0) / 16);
      tail = head + nvec * 16 / (int)sizeof(T);
    } else {
      head = tail = V;
      nvec = 0;
    }
  }
};

// The bulk copies of row `src`'s interior into `buf`, on `bar` (one thread).
template <typename T>
__device__ void stage_row(const T* src, int V, unsigned char* buf,
                          uint64_t* bar) {
  const RowSpan<T> sp(src, V);
  const uint32_t bytes = 16u * sp.nvec;
  mbar_expect_tx(bar, bytes);
  for (uint32_t o = 0; o < bytes; o += kChunk)
    bulk_copy(buf + sp.ib + o, sp.interior + o,
              bytes - o < kChunk ? bytes - o : kChunk, bar);
}

// The order key of f32 bits (order_key without the float).
__device__ __forceinline__ int bits_key(uint32_t b) {
  return (int)(b ^ ((uint32_t)((int)b >> 31) >> 1));
}
__device__ __forceinline__ float key_value(int key) {
  return __int_as_float(key < 0 ? key ^ 0x7FFFFFFF : key);
}

// 32-bit word j of a 16-byte vector (selects, so a runtime j stays in
// registers).
__device__ __forceinline__ uint32_t word(const uint4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// Element u of a 16-byte vector of T, as an order key; and the largest
// key of the vector (a tree, so the maxima do not form one long chain).
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static int key(const uint4& v, int u) {
    const uint32_t w = word(v, u >> 1);
    return bits_key(u & 1 ? w & 0xFFFF0000u : w << 16);
  }
  __device__ static int max(const uint4& v) {
    const int a = ::max(::max(key(v, 0), key(v, 1)), ::max(key(v, 2), key(v, 3)));
    const int b = ::max(::max(key(v, 4), key(v, 5)), ::max(key(v, 6), key(v, 7)));
    return ::max(a, b);
  }
};
template <> struct Vec<float> {
  static constexpr int kPer = 4;
  __device__ static int key(const uint4& v, int u) {
    return bits_key(word(v, u));
  }
  __device__ static int max(const uint4& v) {
    return ::max(::max(key(v, 0), key(v, 1)), ::max(key(v, 2), key(v, 3)));
  }
};

// The barrier of one team (ids 1 to kMaxTeams; 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(team + 1), "n"(kTeam) : "memory");
}

// Sum or max over the team (two team barriers; `scratch` holds
// kTeamWarps ints).
template <bool kMax>
__device__ __forceinline__ int team_reduce(int v, int* scratch, int team) {
  v = kMax ? __reduce_max_sync(0xffffffffu, v)
           : __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x % kTeam >> 5] = v;
  team_sync(team);
  int t = scratch[0];
  for (int w = 1; w < kTeamWarps; ++w)
    t = kMax ? ::max(t, scratch[w]) : t + scratch[w];
  team_sync(team);
  return t;
}

// How many of a[0, n) (16-byte aligned in shared memory) exceed x: the
// rank of x among them, read as 16-byte vectors that every thread of a
// warp reads at once (broadcast).
__device__ __forceinline__ int count_above(const int* a, int n, int x) {
  int c = 0;
  const int4* a4 = reinterpret_cast<const int4*>(a);
#pragma unroll 4
  for (int i = 0; i < n / 4; ++i) {
    const int4 w = a4[i];
    c += (w.x > x) + (w.y > x) + (w.z > x) + (w.w > x);
  }
  for (int i = n & ~3; i < n; ++i) c += a[i] > x;
  return c;
}

struct Draw {
  int top_k, num_draws, unk, low_bit, cmask;
  float invt;
  uint32_t rh;  // the row's hash
};

// The draws over the list keys[0, n), cols[0, n) by the team: an entry is
// kept when fewer than top_k keys of the list exceed its key (the list
// holds every key >= a lower bound of the threshold, so this is the row's
// keep-ties top-k); its packed draw key replaces its column, and draw j is
// the entry that exactly j packed keys exceed. `put(j, id)` stores draw j.
template <typename Put>
__device__ void list_draws(const int* keys, int* cols, int n, int team,
                           const Draw& d, const Put& put) {
  const int tid = threadIdx.x % kTeam;
  for (int i = tid; i < n; i += kTeam) {
    const int key = keys[i], c = cols[i];
    cols[i] = count_above(keys, n, key) < d.top_k && c != d.unk
                  ? packed_draw(key_value(key), d.invt, d.rh, c, d.cmask)
                  : INT32_MIN;
  }
  // 0 for draws past an exhausted support; the barrier orders these
  // writes before the winners'
  for (int j = tid; j < d.num_draws; j += kTeam) put(j, 0);
  team_sync(team);
  for (int i = tid; i < n; i += kTeam) {
    const int p = cols[i];
    if (p == INT32_MIN) continue;
    const int j = count_above(cols, n, p);
    if (j < d.num_draws) put(j, d.cmask - (p & d.cmask));
  }
}

// The largest t (bits below low_bit zero) with count(key >= t) >= top_k
// over the whole staged row, MSB first, by the team.
template <typename T>
__device__ int row_threshold(const T* row, int V, int* scratch, int team,
                             int top_k, int low_bit) {
  const int tid = threadIdx.x % kTeam;
  auto count = [&](int cand) {
    int k = 0;
    for (int c = tid; c < V; c += kTeam)
      k += order_key(to_f32(row[c])) >= cand;
    return team_reduce<false>(k, scratch, team);
  };
  int t = count(0) >= top_k ? 0 : INT32_MIN;
  for (int bit = 30; bit >= low_bit; --bit) {
    const int cand = t | (1 << bit);
    if (count(cand) >= top_k) t = cand;
  }
  return t;
}

// The draws over the whole staged row, by the team (the list overflowed):
// num_draws strictly decreasing team-wide maxima of the packed keys.
template <typename T, typename Put>
__device__ void row_draws(const T* row, int V, int* scratch, int team,
                          const Draw& d, const Put& put) {
  const int tid = threadIdx.x % kTeam;
  const int t = row_threshold(row, V, scratch, team, d.top_k, d.low_bit);
  int m = INT32_MIN;
  for (int j = 0; j < d.num_draws; ++j) {
    int best = INT32_MIN;
    for (int c = tid; c < V; c += kTeam) {
      const float x = to_f32(row[c]);
      if (order_key(x) < t || c == d.unk) continue;
      const int p = packed_draw(x, d.invt, d.rh, c, d.cmask);
      if (j == 0 || p < m) best = ::max(best, p);
    }
    m = team_reduce<true>(best, scratch, team);
    if (tid == 0) put(j, m == INT32_MIN ? 0 : d.cmask - (m & d.cmask));
  }
}

// Appends (key, c) to the list of `cap` entries if key >= bound.
__device__ __forceinline__ void gather(int key, int c, int bound, int* keys,
                                       int* cols, int* len, int cap) {
  if (key < bound) return;
  const int at = atomicAdd(len, 1);
  if (at < cap) {
    keys[at] = key;
    cols[at] = c;
  }
}

// The rows [0, live) of V logits each, `ld` apart from `logits`, in the
// dynamic shared memory `smem` of a block of teams: team `team` walks the
// rows blockIdx.x * teams + team, + gridDim.x * teams, ...; its mbarrier
// completes one phase per row. Row r's noise hashes row0 + r; `out(r, j,
// id)` stores its draw j.
template <typename T, typename Out>
__device__ __forceinline__ void sample_rows(
    unsigned char* smem, const T* __restrict__ logits, size_t ld, int live,
    int V, int row0, int top_k, int num_draws, int unk, dh::Seed seed,
    float invt, int low_bit, int col_bits, const TeamLayout& lay,
    const Out& out) {
  using VK = Vec<T>;
  const int teams = blockDim.x / kTeam, team = threadIdx.x / kTeam;
  const int tid = threadIdx.x % kTeam, warp = tid >> 5, lane = tid & 31;
  unsigned char* buf = smem + team * lay.team;
  int* keys = reinterpret_cast<int*>(buf + lay.buf);
  int* cols = keys + lay.cap;
  int* maxima = cols + lay.cap;
  int* misc = maxima + kTeam;
  short* vhi = reinterpret_cast<short*>(buf + lay.vhi);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + teams * lay.team) + team;
  if (tid == 0) mbar_init(bar, 1);
  __syncthreads();

  const int stride = gridDim.x * teams;
  int r = blockIdx.x * teams + team;
  if (tid == 0 && r < live) stage_row(logits + (size_t)r * ld, V, buf, bar);
  Draw d{top_k, num_draws, unk, low_bit, (1 << col_bits) - 1, invt, 0u};
  for (uint32_t phase = 0; r < live; r += stride, phase ^= 1) {
    const T* src = logits + (size_t)r * ld;
    const RowSpan<T> sp(src, V);
    T* row = reinterpret_cast<T*>(buf + sp.off);
    const int extra = sp.head + V - sp.tail;
    auto extra_col = [&](int i) {
      return i < sp.head ? i : sp.tail + i - sp.head;
    };
    int own = INT32_MIN;
    for (int i = tid; i < extra; i += kTeam) {
      const int c = extra_col(i);
      const T x = src[c];
      row[c] = x;
      own = ::max(own, order_key(to_f32(x)));
    }
    // these plain stores land before a later bulk copy into the same bytes
    if (tid < extra) fence_proxy_async();
    mbar_wait(bar, phase);

    // each thread's largest key, and each vector's (its high half)
    const uint4* vec = reinterpret_cast<const uint4*>(buf + sp.ib);
#pragma unroll 4
    for (int i = tid; i < sp.nvec; i += kTeam) {
      const int m = VK::max(vec[i]);
      if (lay.table) vhi[i] = (short)(m >> 16);
      own = ::max(own, m);
    }
    maxima[tid] = own;
    team_sync(team);

    // the lower bound: the top_k-th largest of the team's maxima (distinct
    // elements), the least maximum that fewer than top_k others exceed
    {
      const int q = count_above(maxima, kTeam, own) < top_k ? own : INT32_MAX;
      const int m = __reduce_min_sync(0xffffffffu, q);
      if (lane == 0) misc[kScratch + warp] = m;
      if (tid == 0) misc[kLen] = 0;
    }
    team_sync(team);

    int bound = misc[kScratch];
    for (int w = 1; w < kTeamWarps; ++w)
      bound = ::min(bound, misc[kScratch + w]);
    if (top_k > kTeam) bound = INT32_MIN;  // fewer maxima than top_k
    for (int i = tid; i < extra; i += kTeam) {
      const int c = extra_col(i);
      gather(order_key(to_f32(row[c])), c, bound, keys, cols, misc + kLen,
             lay.cap);
    }
    // only the vectors whose largest key may reach the bound (its high
    // half does) are read again, eight table entries per 16-byte load;
    // the few hits are walked bit by bit (a branch, not predication).
    // Without the table every vector is read again.
    const short hb = (short)(bound >> 16);
    for (int i8 = tid; 8 * i8 < sp.nvec; i8 += kTeam) {
      uint32_t hits = 0xFFu;
      if (lay.table) {
        const uint4 h = reinterpret_cast<const uint4*>(vhi)[i8];
        hits = 0;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const uint32_t w = word(h, u >> 1);
          hits |= (uint32_t)((short)(u & 1 ? w >> 16 : w & 0xFFFF) >= hb)
                  << u;
        }
      }
      if (8 * i8 + 8 > sp.nvec) hits &= (1u << (sp.nvec - 8 * i8)) - 1;
      while (hits) {
        const int i = 8 * i8 + __ffs(hits) - 1;
        hits &= hits - 1;
        const uint4 v = vec[i];
        uint32_t keep = 0;
#pragma unroll
        for (int e = 0; e < VK::kPer; ++e)
          keep |= (uint32_t)(VK::key(v, e) >= bound) << e;
        while (keep) {
          const int e = __ffs(keep) - 1;
          keep &= keep - 1;
          gather(VK::key(v, e), sp.head + i * VK::kPer + e, bound, keys,
                 cols, misc + kLen, lay.cap);
        }
      }
    }
    team_sync(team);

    const int n = misc[kLen];
    const int next = r + stride;
    d.rh = row_hash(seed.get(), (uint32_t)(row0 + r));
    const auto put = [&](int j, int id) { out(r, j, id); };
    if (n <= lay.cap) {
      // the row buffer is free: the next row streams in during the draws
      if (tid == 0 && next < live)
        stage_row(src + (size_t)stride * ld, V, buf, bar);
      list_draws(keys, cols, n, team, d, put);
    } else {
      row_draws(row, V, misc + kScratch, team, d, put);
      team_sync(team);
      if (tid == 0 && next < live)
        stage_row(src + (size_t)stride * ld, V, buf, bar);
    }
  }
}

// The rows of a kernel whose row is too long for any team's buffer (bf16
// past ~115.9K logits): the same body over the row where it lies in device
// memory, in two passes of 16-byte loads (each thread's largest key, then
// the list of the keys at or above the bound), with no bulk copy and no
// vector table. `lay` is a layout of no buffer (TeamLayout(0, ...)): the
// list, the maxima and kMisc ints a team. A list over its capacity sends
// the team through the bitwise search over the row in device memory.
template <typename T, typename Out>
__device__ __forceinline__ void sample_rows_streamed(
    unsigned char* smem, const T* __restrict__ logits, size_t ld, int live,
    int V, int row0, int top_k, int num_draws, int unk, dh::Seed seed,
    float invt, int low_bit, int col_bits, const TeamLayout& lay,
    const Out& out) {
  using VK = Vec<T>;
  const int teams = blockDim.x / kTeam, team = threadIdx.x / kTeam;
  const int tid = threadIdx.x % kTeam, warp = tid >> 5, lane = tid & 31;
  unsigned char* base = smem + team * lay.team;
  int* keys = reinterpret_cast<int*>(base + lay.buf);
  int* cols = keys + lay.cap;
  int* maxima = cols + lay.cap;
  int* misc = maxima + kTeam;
  Draw d{top_k, num_draws, unk, low_bit, (1 << col_bits) - 1, invt, 0u};
  for (int r = blockIdx.x * teams + team; r < live;
       r += gridDim.x * teams) {
    const T* src = logits + (size_t)r * ld;
    const RowSpan<T> sp(src, V);
    const uint4* vec = reinterpret_cast<const uint4*>(sp.interior);
    const int extra = sp.head + V - sp.tail;
    auto extra_col = [&](int i) {
      return i < sp.head ? i : sp.tail + i - sp.head;
    };
    int own = INT32_MIN;
    for (int i = tid; i < extra; i += kTeam)
      own = ::max(own, order_key(to_f32(src[extra_col(i)])));
#pragma unroll 4
    for (int i = tid; i < sp.nvec; i += kTeam)
      own = ::max(own, VK::max(__ldg(vec + i)));
    maxima[tid] = own;
    team_sync(team);
    {
      const int q = count_above(maxima, kTeam, own) < top_k ? own : INT32_MAX;
      const int m = __reduce_min_sync(0xffffffffu, q);
      if (lane == 0) misc[kScratch + warp] = m;
      if (tid == 0) misc[kLen] = 0;
    }
    team_sync(team);
    int bound = misc[kScratch];
    for (int w = 1; w < kTeamWarps; ++w)
      bound = ::min(bound, misc[kScratch + w]);
    if (top_k > kTeam) bound = INT32_MIN;  // fewer maxima than top_k
    for (int i = tid; i < extra; i += kTeam) {
      const int c = extra_col(i);
      gather(order_key(to_f32(src[c])), c, bound, keys, cols, misc + kLen,
             lay.cap);
    }
#pragma unroll 4
    for (int i = tid; i < sp.nvec; i += kTeam) {
      const uint4 v = __ldg(vec + i);
      if (VK::max(v) < bound) continue;
#pragma unroll
      for (int e = 0; e < VK::kPer; ++e)
        gather(VK::key(v, e), sp.head + i * VK::kPer + e, bound, keys, cols,
               misc + kLen, lay.cap);
    }
    team_sync(team);
    const int n = misc[kLen];
    d.rh = row_hash(seed.get(), (uint32_t)(row0 + r));
    const auto put = [&](int j, int id) { out(r, j, id); };
    if (n <= lay.cap) {
      list_draws(keys, cols, n, team, d, put);
    } else {
      row_draws(src, V, misc + kScratch, team, d, put);
      team_sync(team);
    }
  }
}

}  // namespace topk
}  // namespace dh

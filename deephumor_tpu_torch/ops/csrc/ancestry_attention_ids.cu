// K6: read-only full-width ancestry attention for a list of items, and K7:
// the same attention for every item.
//
// K6 replaces deephumor_tpu/ops/pallas_attention.py:ancestry_attention_ids
// (kernel _kernel_native4d_ids, whose body is the read-only
// _kernel_native4d). K7 replaces pallas_attention.py:ancestry_attention
// (kernels _kernel_native4d, _kernel and _kernel_blockdiag: three TPU
// layouts of one function, K1's attention without the cache write); its
// entry point, dh_ancestry_attention, runs K6's kernels (the same bf16
// body) with no id list, over the first p_eff positions of every item (the
// wrapper passes P for the layouts that read the whole cache). The
// canonical-prefix path (K5) gives straggler items -- live branches that
// still disagree below c -- outputs from a stale shared path; K6
// recomputes exactly those items over the full per-slot caches
// [0, p_eff) with the step's flat ancestry bias [items, beam, beam * P].
//
// K6 computes the first max(n_sel, 1) entries of an item-id list (the TPU
// grid is clamped the same way), or, with `min_sel` 0 (the engine's call,
// writing into K5's output), the first n_sel: none at 0, where the TPU
// kernel computes one entry that the engine's merge discards. Rows of
// other items are not written. The TPU grid is (n_sel,), a traced value;
// here the grid holds G list entries, G as many as the card holds at once
// at the kernel's occupancy, and the blocks of grid entry e compute list
// entries e, e + G, e + 2 G, ... below the count (or, past G entries, each
// block of the entry's cluster its own: below), so any count up to the
// whole list is computed.
// n_sel is a launch argument (the grid then has min(max(n_sel, 1), G)
// entries) or an int32 in device memory (dh::Count) that the
// canonical-prefix boundary sets (a captured step bakes the launch in,
// and the engine launches K6 on every canon step: the grid then has G
// entries, and those past the count return at once). Both forms launch
// the clusters of the G-entry grid and choose between sharing and parting
// by the count alone, so they compute every entry alike, bit for bit.
//
// A block that computes an entry alone reads only the rows that some
// branch selects: it first lists the item's (slot, position < p_eff) rows
// that at least one of its branches' biases keeps (row_list.cuh), then
// attends over the list. The dropped rows had weight exactly 0; a block
// whose branch selects no row keeps the dense rows.
//
// Bound on the H100: bytes. At the char config's last phase (beam 7 x
// p_eff 128 x D 512, bf16) an item's dense rows are ~1.87 MB: K+V 1.84
// MB, its bias 25 KB, q and the output. A beam search's stragglers keep
// ~16% of them (the char cell's searches at p_eff 128), so an item moves
// ~0.33 MB: 96 items 32 MB, 0.0095 ms at 3.35 TB/s (dense: 180 MB, 0.054
// ms). K7 over all 768 items: 1.44 GB dense, 0.430 ms (1.53 GB, 0.456 ms,
// for the layouts that read all 136 positions), a sixth of it listed.
//
// bf16 (the serving dtype): the tensor-core body of attention_mma.cuh over an
// item's listed rows (per chunk of 32 branches, for a beam above 32). The
// shared-load limit of a scalar design goes: each 16 rows cost one ldmatrix.x4
// and one mma per 16 of head_dim in each product, where the scalar loops spent
// a few hundred shared loads. K then V stream through a ring of three 64-row
// cp.async tiles, loads overlapping the products and the softmax, while every
// energy (<= 7 x 964 f32 = 27 KB) stays in shared memory for the exact two-pass
// softmax: ~61 KB a block at this shape, its list included, sized for the
// dense rows. K6's grid holds one resident wave of list entries, and each
// (item, head) of an entry has a cluster of up to four blocks (as many as
// the dense rows have tiles). While the count is at most the wave's entries
// (a few stragglers: n_sel x 8 working clusters on 132 SMs), a cluster
// shares its entry over the dense rows: its blocks take a quarter of the
// tiles each and exchange each branch's max and sum through distributed
// shared memory (weights still normalised before rounding), then their
// partial outputs. Such a launch is latency-bound, and a list would add a
// wait on memory before the first tile. Past that count (batches of
// hundreds of long char captions leave that many stragglers) every block
// takes entries of its own, alone, over its list: a short list on one
// block beats a cluster's exchanges. K7's grids fill the card and size their
// clusters by the grid (ma::cluster_size): one block per (item, head),
// each over its list, there.
//
// q rows lie `ldq` elements apart (3 D for the view of a fused QKV product);
// the caches, the bias and the output are contiguous.
//
// f32: the two-pass CUDA-core body of attention_simt.cuh
// (ancestry_attention_f32_kernel): exact f32 arithmetic, K and V staged 256
// rows at a time, every energy in shared memory.

#include <map>
#include <mutex>
#include <tuple>

#include "attention_mma.cuh"
#include "attention_simt.cuh"
#include "row_list.cuh"

namespace {

using bf16 = __nv_bfloat16;

// Row r of one item's (slot, position) rows in one head's columns: slot
// i = r / pe, position r % pe; its code is its row (row0 + i) * P + r % pe
// of the caches [rows * P] (the launcher refuses 2^32 or more). `anc` is
// the flat ancestry bias [items, beam, beam * P]; `qrow0` is the row of
// the block's first query (the bf16 blocks take the branches in chunks).
template <typename T>
struct CacheRows {
  const T* ck;
  const T* cv;
  const float* anc;
  size_t row0, qrow0;
  int beam, P, pe, D, col0;
  __device__ uint32_t index(int r) const {
    const int i = r / pe;
    return (uint32_t)((row0 + i) * P + (r - i * pe));
  }
  __device__ const T* k(uint32_t x) const { return ck + (size_t)x * D + col0; }
  __device__ const T* v(uint32_t x) const { return cv + (size_t)x * D + col0; }
  __device__ const float* bias(int j, int r, uint32_t x) const {
    return anc + (qrow0 + j) * beam * P + (x - row0 * P);
  }
};

// The list entries that a block walks: grid entry e computes entries e,
// e + stride, ... below bound() (every block of a cluster walks alike, so
// their barriers match); the item of entry e is ids[e], or e for K7's NULL
// list.
struct Walk {
  const int* ids;
  dh::Count n;   // the count of entries to compute
  int min_n;     // computed at least (1: the TPU grid's clamp; 0: none)
  int len;       // the list's length
  int stride;    // the grid's entries
  __device__ __forceinline__ int bound() const {
    return min(max(n.get(), min_n), len);
  }
  __device__ __forceinline__ int item(int e) const { return ids ? ids[e] : e; }
};

// The blocks of `Kernel` (`Threads` threads, `smem` bytes of dynamic
// shared memory, clusters of `cs`) that the current card holds at once,
// from the occupancy calculator (cluster placement included), asked once
// per device and shape.
template <auto Kernel, int Threads>
cudaError_t resident_blocks(int cs, size_t smem, int* blocks) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, size_t>, int> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, cs, smem);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *blocks = it->second;
    return cudaSuccess;
  }
  err = dh::prepare<Kernel>();  // the opt-in shared memory limit
  int n = 0;
  if (err == cudaSuccess && cs > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs);
    cfg.blockDim = dim3(Threads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(
        &n, reinterpret_cast<const void*>(Kernel), &cfg);
    n *= cs;
  } else if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, Kernel, Threads,
                                                        smem);
    n *= dh::sm_count();
  }
  if (err != cudaSuccess) return err;
  seen[key] = *blocks = n;
  return cudaSuccess;
}

// K6's grid: as many list entries, of `per` clusters of `cs` blocks each,
// as the card holds at once (`resident` blocks), at least one, at most the
// list's `len`; the walk strides by it. An int count launches only the
// entries it computes, a device count the whole grid.
void size_list_grid(Walk* walk, int resident, int per, int cs,
                    bool count_ptr, int n_sel, int* entries) {
  int g = resident / (per * cs);
  g = g < 1 ? 1 : g < walk->len ? g : walk->len;
  walk->stride = g;
  const int want = n_sel > 1 ? n_sel : 1;
  *entries = count_ptr || want > g ? g : want;
}

// Clusters of `cs` consecutive blocks share one (item, head, chunk of at
// most kMaxBeam branches), heads varying fastest, then chunks. While the
// count is at most the grid's entries (`walk.stride`), a cluster of two or
// more computes each of its entries together over the dense rows. Past
// it, or in clusters of one, each block computes entries of its own, alone
// (every block's shared memory holds an entry's dense rows), over the rows
// its branches select, listed (row_list.cuh) at the start of its shared
// memory.
template <int NT>
__global__ void __launch_bounds__(dh::mma_attn::kThreads)
    ancestry_attention_mma_kernel(
        const bf16* __restrict__ q, int ldq, const bf16* __restrict__ ck,
        const bf16* __restrict__ cv, const float* __restrict__ bias,
        Walk walk, bf16* __restrict__ out,
        unsigned long long* __restrict__ tally, int items, int beam, int P,
        int pe, int D, int hd, float inv_scale, int cs) {
  namespace ma = dh::mma_attn;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = D / hd, b = blockIdx.x / cs, col0 = b % H * hd;
  const ma::Chunk<NT> ch(b, H, beam);
  const int rank = cs > 1 ? (int)cooperative_groups::this_cluster().block_rank()
                          : 0;
  const int end = walk.bound(), n = beam * pe;
  const bool vec = pe % 4 == 0 && P % 4 == 0
                   && reinterpret_cast<uintptr_t>(bias) % 16 == 0;
  const bool shared = cs > 1 && end <= walk.stride;
  const int first = shared ? ch.sel : ch.sel * cs + rank;
  const int stride = shared ? walk.stride : walk.stride * cs;
  uint32_t* list = reinterpret_cast<uint32_t*>(smem);
  unsigned char* body = smem + dh::row_list_bytes(n);
  const int stage_bytes = ma::kStages * ma::kTile * dh::padded_ld(hd) * 2;
  // `attend` ends on a barrier after its last read of shared memory, so the
  // next entry may refill it
  for (int e = first; e < end; e += stride) {
    const int item = walk.item(e);
    if (item < 0 || item >= items) continue;  // its block or cluster skips it
    const size_t row0 = (size_t)item * beam, qrow0 = row0 + ch.j0;
    const CacheRows<bf16> dense{ck,   cv, bias, row0, qrow0,
                                beam, P,  pe,   D,    col0};
    const bf16* qe = q + qrow0 * ldq + col0;
    bf16* oe = out + qrow0 * D + col0;
    if (shared) {
      if (b % H == 0 && rank == 0 && threadIdx.x == 0)
        dh::tally_rows(tally, item, n, n);
      ma::attend<NT>(dense, qe, ldq, oe, D, n, ch.nq, hd, inv_scale, cs,
                     body);
      continue;
    }
    const int rows = dh::build_row_list<ma::kThreads>(
        dense, n, ch.nq, 1, vec, 1, list, reinterpret_cast<float*>(body),
        stage_bytes, [] {});
    if (b % H == 0 && threadIdx.x == 0) dh::tally_rows(tally, item, rows, n);
    ma::attend<NT>(dh::ListRows<CacheRows<bf16>>{dense, list}, qe, ldq, oe,
                   D, rows, ch.nq, hd, inv_scale, 1, body);
  }
}

__global__ void __launch_bounds__(dh::simt::kThreads)
    ancestry_attention_f32_kernel(
        const float* __restrict__ q, int ldq, const float* __restrict__ ck,
        const float* __restrict__ cv, const float* __restrict__ bias,
        Walk walk, float* __restrict__ out, int items, int beam, int P,
        int pe, int D, int hd, float inv_scale) {
  extern __shared__ __align__(16) uint32_t smem_w[];
  const int H = D / hd, col0 = blockIdx.x % H * hd, end = walk.bound();
  for (int e = blockIdx.x / H; e < end; e += walk.stride) {
    const int item = walk.item(e);
    if (item < 0 || item >= items) continue;
    __syncthreads();  // the previous entry's reads of shared memory are done
    const size_t row0 = (size_t)item * beam;
    const CacheRows<float> rows{ck,   cv, bias, row0, row0,
                                beam, P,  pe,   D,    col0};
    dh::simt::attend<float>(rows, q + row0 * ldq + col0, ldq,
                            out + row0 * D + col0, D, beam * pe, beam, hd,
                            inv_scale, smem_w);
  }
}

// How a launch covers its list: K7 (`list` false) every item in one
// grid, its clusters sized by that grid (ma::cluster_size); K6 one
// resident wave of list entries (size_list_grid), each (item, head) on a
// cluster of as many blocks, up to four, as its rows have tiles, whatever
// the count, so that an int and a device count compute alike.
struct Cover {
  bool list, count_ptr;
  int n_sel;
};

template <int NT>
cudaError_t launch_mma(const void* q, int ldq, const void* ck,
                       const void* cv, const void* bias, Walk walk,
                       const Cover& cover, void* out, void* tally, int items,
                       int beam, int P, int pe, int D, int H, float inv_scale,
                       cudaStream_t stream) {
  namespace ma = dh::mma_attn;
  constexpr auto kernel = &ancestry_attention_mma_kernel<NT>;
  const int hd = D / H, n = beam * pe, per = H * ma::beam_chunks(beam);
  int cs = 1, entries = walk.stride;
  if (cover.list) {
    while (2 * cs <= ma::kMaxCluster && 2 * cs <= ma::tiles_of(n)) cs *= 2;
  } else {
    cs = ma::cluster_size(walk.stride * per, n);
  }
  // a K6 block may compute an entry alone: its energies for every row
  const size_t smem =
      dh::row_list_bytes(n)
      + ma::smem_bytes(n, cover.list ? 1 : cs, ma::chunk_beam(beam), hd, NT);
  if (cover.list) {
    int resident = 0;
    const cudaError_t err =
        resident_blocks<kernel, ma::kThreads>(cs, smem, &resident);
    if (err != cudaSuccess) return err;
    size_list_grid(&walk, resident, per, cs, cover.count_ptr, cover.n_sel,
                   &entries);
  }
  return ma::launch<kernel>(
      entries * per * cs, cs, smem, stream, (const bf16*)q, ldq,
      (const bf16*)ck, (const bf16*)cv, (const float*)bias, walk, (bf16*)out,
      (unsigned long long*)tally, items, beam, P, pe, D, hd, inv_scale, cs);
}

cudaError_t launch_f32(const void* q, int ldq, const void* ck, const void* cv,
                       const void* bias, Walk walk, const Cover& cover,
                       void* out, int items, int beam, int P, int pe, int D,
                       int H, float inv_scale, cudaStream_t stream) {
  constexpr auto kernel = &ancestry_attention_f32_kernel;
  const int hd = D / H;
  const size_t smem = dh::simt::smem_bytes(beam * pe, beam, hd, 4);
  int entries = walk.stride;
  if (cover.list) {
    int resident = 0;
    const cudaError_t err =
        resident_blocks<kernel, dh::simt::kThreads>(1, smem, &resident);
    if (err != cudaSuccess) return err;
    size_list_grid(&walk, resident, H, 1, cover.count_ptr, cover.n_sel,
                   &entries);
  }
  return dh::mma_attn::launch<kernel, dh::simt::kThreads>(
      entries * H, 1, smem, stream, (const float*)q, ldq, (const float*)ck,
      (const float*)cv, (const float*)bias, walk, (float*)out, items, beam,
      P, pe, D, hd, inv_scale);
}

// bf16 through the tensor-core kernel (n-tiles by beam), f32 through the
// CUDA-core kernel.
int launch(int dtype, const void* q, int ldq, const void* ck, const void* cv,
           const void* bias, const Walk& walk, const Cover& cover, void* out,
           void* tally, int items, int beam, int P, int pe, int D, int H,
           float inv_scale, void* stream) {
  auto s = (cudaStream_t)stream;
  if ((size_t)items * beam * P > UINT32_MAX) return cudaErrorInvalidValue;
  if (walk.len < 1 || H < 1 || beam < 1) return cudaErrorInvalidValue;
  if (dtype != dh::kBFloat16)
    return launch_f32(q, ldq, ck, cv, bias, walk, cover, out, items, beam, P,
                      pe, D, H, inv_scale, s);
  return dh::mma_attn::dispatch(beam, D / H, [&](auto nt) {
    return launch_mma<decltype(nt)::value>(q, ldq, ck, cv, bias, walk, cover,
                                           out, tally, items, beam, P, pe, D,
                                           H, inv_scale, s);
  });
}

}  // namespace

// K6 over the list ids[:len]: n_sel_ptr NULL (the first max(n_sel, min_sel)
// entries) or a device int32 that the kernel reads (a captured step's
// straggler count, in place of n_sel); min_sel 1 computes at least one
// entry, 0 none at a count of 0. q rows lie ldq elements apart. tally:
// NULL or the device's int64 [2, kTallySlots] to which each head-0 block of
// the tensor-core kernel adds its rows read and its dense rows
// (row_list.cuh); K7 takes it too.
extern "C" int dh_ancestry_attention_ids(
    int dtype, const void* q, int ldq, const void* ck, const void* cv,
    const void* bias, const void* ids, void* out, void* tally, int items,
    int len, int n_sel, const void* n_sel_ptr, int min_sel, int beam, int P,
    int pe, int D, int H, float inv_scale, void* stream) {
  const Walk walk{(const int*)ids, dh::Count{(const int*)n_sel_ptr, n_sel},
                  min_sel, len, len};
  return launch(dtype, q, ldq, ck, cv, bias, walk,
                Cover{true, n_sel_ptr != nullptr, n_sel}, out, tally, items,
                beam, P, pe, D, H, inv_scale, stream);
}

// K7: the same kernels over every item (block x computes item x).
extern "C" int dh_ancestry_attention(int dtype, const void* q, const void* ck,
                                     const void* cv, const void* bias,
                                     void* out, void* tally, int items,
                                     int beam, int P, int pe, int D, int H,
                                     float inv_scale, void* stream) {
  const Walk walk{nullptr, dh::Count{nullptr, items}, 0, items, items};
  return launch(dtype, q, D, ck, cv, bias, walk, Cover{false, false, items},
                out, tally, items, beam, P, pe, D, H, inv_scale, stream);
}

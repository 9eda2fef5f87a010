// The row source and the cache write shared by the two kernels that write
// this position's K/V column and then attend over the per-slot caches: K1
// (ancestry_attention.cu) and K8 (ancestry_attention_flash.cu); K5
// (ancestry_attention_canon.cu) shares the write.
#pragma once

#include "common.cuh"

namespace dh {

// Row r of one item's (slot, position) rows in one head's columns: slot
// i = r / pe, position p = r % pe. Its code is its row (row0 + i) * P + p
// of the caches [rows * P], or, at p == pos, kFresh | (row0 + i), its row
// of k_new / v_new [rows]: the column at `pos` is never read from the
// caches, so the block may write it whenever it likes (the launchers refuse
// rows * P of 2^31 or more). k_new / v_new rows lie `ldk` / `ldv` elements
// apart (row-strided views of a fused QKV product: 3 D). `anc` is the flat
// ancestry bias [items, beam, beam * P]; `qrow0` is the row of the block's
// first query (the bf16 blocks take the branches in chunks).
constexpr uint32_t kFresh = 1u << 31;
template <typename T>
struct UpdateRows {
  const T *ck, *cv, *knew, *vnew;
  const float* anc;
  size_t row0, qrow0;
  int beam, P, pe, D, col0, pos, ldk, ldv;
  __device__ uint32_t index(int r) const {
    const int i = r / pe, p = r - i * pe;
    return p == pos ? kFresh | (uint32_t)(row0 + i)
                    : (uint32_t)((row0 + i) * P + p);
  }
  __device__ const T* pick(const T* cache, const T* fresh, int ldf,
                           uint32_t x) const {
    return x & kFresh ? fresh + (size_t)(x & ~kFresh) * ldf + col0
                      : cache + (size_t)x * D + col0;
  }
  __device__ const T* k(uint32_t x) const { return pick(ck, knew, ldk, x); }
  __device__ const T* v(uint32_t x) const { return pick(cv, vnew, ldv, x); }
  __device__ const float* bias(int j, int, uint32_t x) const {
    const size_t off = x & kFresh ? ((x & ~kFresh) - row0) * P + pos
                                  : x - row0 * P;
    return anc + (qrow0 + j) * beam * P + off;
  }
};

// Writes the `beam` slots' columns at `pos` from k_new / v_new (rows `ldk`
// / `ldv` elements apart), rows from row0, in 16-byte vectors (head_dim *
// sizeof(T) and each row stride in bytes multiples of 16, as the wrappers
// check), by the threads of one block (or, with `part` of `parts`, its
// share among several).
template <typename T>
__device__ __forceinline__ void write_column(T* ck, T* cv, const T* knew,
                                             int ldk, const T* vnew, int ldv,
                                             size_t row0, int beam, int P,
                                             int D, int hd, int col0, int pos,
                                             int part = 0, int parts = 1) {
  const int vecs = hd * (int)sizeof(T) / 16;
  for (int t = part * blockDim.x + threadIdx.x; t < beam * vecs;
       t += parts * blockDim.x) {
    const int i = t / vecs, c = t % vecs;
    const size_t dst = ((row0 + i) * P + pos) * D + col0;
    reinterpret_cast<uint4*>(ck + dst)[c] =
        reinterpret_cast<const uint4*>(knew + (row0 + i) * ldk + col0)[c];
    reinterpret_cast<uint4*>(cv + dst)[c] =
        reinterpret_cast<const uint4*>(vnew + (row0 + i) * ldv + col0)[c];
  }
}

}  // namespace dh

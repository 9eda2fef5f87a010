// K10: the beam-search survivor update in one launch.
//
// Replaces deephumor_tpu/ops/pallas_engine.py:fused_survivor_update. After
// the survivor draw, for item b and survivor j with
// (branch, cand) = divmod(surv[b, j], beam) and e = ended[b, branch]:
//   chosen[b, j] = e ? pad : new_idx[b, branch, cand]
//   val[b, j]    = val[b, branch] + (e ? 0 : new_val[b, branch, cand])
//   ended[b, j]  = e | (chosen[b, j] == eos)
//   seq[b, j]    = seq[b, branch], with chosen[b, j] at column pos
//   anc[b, j]    = anc[b, branch];  valid[b, j] = valid[b, branch]
// This replaces about ten small launches of the engine's default update.
//
// Bound on the H100: bytes (there is no arithmetic to speak of). At the
// word shape (1792 items, beam 5, L 32, P 33) one launch reads ~5.6 MB and
// writes ~5.1 MB, ~3.2 us at 3.35 TB/s.
// Design: one block per item updates the item IN PLACE. The update permutes
// rows within the item, so the block copies all of the item's beam rows of
// seq, anc and valid (and its val/ended entries) into shared memory or
// registers before it writes any of them. Items at or past `live` (retired
// by early-EOS compaction) are left as they are; only their chosen tokens
// are written, as pad. `live` is a launch argument or an int32 in device
// memory (dh::Count); the grid covers every item either way.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) fused_survivor_update_kernel(
    const int64_t* __restrict__ new_idx, const float* __restrict__ new_val,
    const int64_t* __restrict__ surv, bool* ended, float* val, int64_t* seq,
    int64_t* anc, bool* valid, int64_t* __restrict__ chosen, dh::Count live,
    int beam, int L, int P, int pos, int eos, int pad) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* seq_s = reinterpret_cast<int64_t*>(smem);  // [beam][L]
  int64_t* anc_s = seq_s + beam * L;                   // [beam][P]
  int64_t* tok_s = anc_s + beam * P;                   // [beam]
  int* branch_s = reinterpret_cast<int*>(tok_s + beam);              // [beam]
  bool* valid_s = reinterpret_cast<bool*>(branch_s + beam);          // [beam][P]
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t row0 = (size_t)b * beam;
  if (b >= live.get()) {
    for (int j = tid; j < beam; j += blockDim.x) chosen[row0 + j] = pad;
    return;
  }

  int64_t tok = 0;
  float v = 0.f;
  bool e_out = false;
  if (tid < beam) {
    const int s = (int)surv[row0 + tid];
    const int i = s / beam, c = s - i * beam;
    const bool e = ended[row0 + i];
    const size_t cand = (row0 + i) * beam + c;
    tok = e ? (int64_t)pad : new_idx[cand];
    v = val[row0 + i] + (e ? 0.f : new_val[cand]);
    e_out = e || tok == eos;
    branch_s[tid] = i;
    tok_s[tid] = tok;
  }
  const int64_t* seq_b = seq + row0 * L;
  for (int t = tid; t < beam * L; t += blockDim.x) seq_s[t] = seq_b[t];
  const size_t p0 = row0 * P;
  for (int t = tid; t < beam * P; t += blockDim.x) {
    anc_s[t] = anc[p0 + t];
    valid_s[t] = valid[p0 + t];
  }
  __syncthreads();

  if (tid < beam) {
    chosen[row0 + tid] = tok;
    val[row0 + tid] = v;
    ended[row0 + tid] = e_out;
  }
  for (int t = tid; t < beam * L; t += blockDim.x) {
    const int j = t / L, l = t - j * L;
    seq[row0 * L + t] = l == pos ? tok_s[j] : seq_s[branch_s[j] * L + l];
  }
  for (int t = tid; t < beam * P; t += blockDim.x) {
    const int j = t / P, p = t - j * P;
    const int src = branch_s[j] * P + p;
    anc[p0 + t] = anc_s[src];
    valid[p0 + t] = valid_s[src];
  }
}

}  // namespace

extern "C" int dh_fused_survivor_update(
    const void* new_idx, const void* new_val, const void* surv, void* ended,
    void* val, void* seq, void* anc, void* valid, void* chosen, int B,
    int live, const void* live_ptr, int beam, int L, int P, int pos, int eos,
    int pad, void* stream) {
  const size_t smem = sizeof(int64_t) * ((size_t)beam * (L + P + 1)) +
                      sizeof(int) * beam + (size_t)beam * P;
  auto kernel = fused_survivor_update_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int64_t*)new_idx, (const float*)new_val, (const int64_t*)surv,
      (bool*)ended, (float*)val, (int64_t*)seq, (int64_t*)anc, (bool*)valid,
      (int64_t*)chosen, dh::Count{(const int*)live_ptr, live}, beam, L, P,
      pos, eos, pad);
  return cudaGetLastError();
}

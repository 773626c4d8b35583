// D assembled on the card: the tiled scheduler's tile-pair blocks written into
// a device-resident [K, K] fp32 matrix, written by hand for Hopper (sm_90a).
//
// Replaces no pallas_call.  It replaces the reference's host scatter,
// native/apd_native.cc:433 (apd_scatter_block_direct), which the scheduler
// ran on one host thread: per block a normalized temporary, then
// D[perm[r], perm[c]] and its transpose through the length sort's
// permutation, ~105 M scattered 4-byte host stores a config-4 job (1.6-2.1 s).
// Plain twins and wrappers: audio_pattern_discovery_tpu_torch/ops/dtw_scatter.py.
//
// What it computes.  apd_dtw_scatter: for U tile-pair blocks blocks[u] =
// [ti, ti] f32 of tiles (ti_idx[u], tj_idx[u]) of the length-sorted, padded
// corpus (a DTW kernel's unnormalized output), the entry (r, c) of a block
// normalized as blocks[u, r, c] / (len[r0 + r] + len[c0 + c]) (IEEE division
// in fp32, in that order, when `normalize`, else as it is), with
// r0 = ti_idx[u]*ti and c0 = tj_idx[u]*ti, is written to
// out[perm[r0 + r], c0 + c] and to out[perm[c0 + c], r0 + r]: rows in the
// original order, columns in the sorted order.  On a diagonal tile
// (I == J) the strict upper part is written and mirrored and the diagonal
// is exactly 0.  Rows and columns past K (the last tile's padding) are never
// written, and a block that repeats the one before it (the scheduler pads a
// chunk's tail by repeating its last tile-pair) is skipped.
// apd_dtw_scatter_unpermute then takes each row i in place to
// out[i, j] = out[i, inv[j]], inv the inverse of perm: D in the original
// order on both axes, bit for bit the host scatter's.
//
// What bounds it on the H100.  Memory alone: no arithmetic but a division
// an entry.  The least traffic is the blocks read once (0.21 GB a config-4
// job of 3,240 blocks of 128 x 128) and D written once (0.42 GB at
// K = 10,240): 0.19 ms at 3.35 TB/s.  Written straight through perm on both
// axes, every 4-byte store of D lands on its own 32-byte sector, which HBM
// takes as a read-modify-write once D (0.42 GB) has left the 50 MB L2:
// ~105 M sectors a job.
//
// What the design does about it.  Every store is part of a whole 128-byte
// line: the scatter writes whole row segments, the columns in sorted
// order, through perm on rows only (a row segment of 32 floats per warp
// store), and the transpose goes through a 32 x 33 shared-memory tile so
// that it too stores 32 consecutive floats a warp.  One CUDA block of 256
// threads takes one 32 x 32 sub-tile of a block; on a diagonal tile the
// sub-tiles below the diagonal are skipped (the mirror of the one above
// writes them).  The column un-permute is then one pass over D, a CUDA block
// a row: the row is read whole into shared memory, coalesced, and written
// back gathered through inv, coalesced, where K floats fit a block's 227 KB
// (K <= 58,112; 41 KB at config 4, 164 KB at K = 40,960).  Past that,
// apd_dtw_scatter_unpermute_rows gathers each row through inv into a row of
// a scratch buffer in global memory that its block owns, then copies it
// back, coalesced: twice the un-permute's traffic, any K.  Traffic: 0.21 GB
// read and 0.42 GB written by the scatter, 0.42 GB read and written by the
// un-permute, 1.47 GB a job (0.44 ms at 3.35 TB/s), in one [K, K] buffer,
// where writing in the sorted order on both axes and gathering into a
// second buffer would need two.  The
// scatter runs on the scheduler's stream behind each chunk's DTW launch,
// the un-permute once behind the last.  Measured on the H100 (chip_smoke.py
// phase 33): 0.90 ms a config-4 job, 21 % of the 0.19 ms bound.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSub = 32;   // sub-tile edge
constexpr int kRows = 8;   // threads.y: each thread takes kSub / kRows rows

__global__ void __launch_bounds__(kSub * kRows) scatter_kernel(
    const float* __restrict__ blocks,      // [U, ti, ti]
    const int* __restrict__ ti_idx,        // [U]
    const int* __restrict__ tj_idx,        // [U]
    const int* __restrict__ lengths,       // [nT*ti] sorted lengths (pad 1)
    const int64_t* __restrict__ perm,      // [K] sorted position -> original index
    float* __restrict__ out,               // [K, K]
    int ti, int K, int nsub, int normalize) {
  __shared__ float tile[kSub][kSub + 1];
  const int u = blockIdx.y;
  const int I = ti_idx[u], J = tj_idx[u];
  if (u > 0 && ti_idx[u - 1] == I && tj_idx[u - 1] == J) return;   // a padded repeat
  const int rb = (blockIdx.x / nsub) * kSub, cb = (blockIdx.x % nsub) * kSub;
  const bool diag = I == J;
  if (diag && rb > cb) return;             // the mirror of sub-tile (cb, rb) writes it
  const int r0 = I * ti, c0 = J * ti;      // < K: a tile holds at least one sequence
  const int nr = min(ti, K - r0), nc = min(ti, K - c0);
  if (rb >= nr || cb >= nc) return;
  const float* blk = blocks + (size_t)u * ti * ti;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // Row segments: out[perm[r0 + r], c0 + c], the strict upper part and a
  // zero diagonal on a diagonal tile.
  for (int k = ty; k < kSub; k += kRows) {
    const int r = rb + k, c = cb + tx;
    float v = 0.f;
    if (r < nr && c < nc) {
      v = blk[(size_t)r * ti + c];
      if (normalize)
        v = __fdiv_rn(v, __fadd_rn((float)lengths[r0 + r], (float)lengths[c0 + c]));
      if (diag && r == c) v = 0.f;
      if (!diag || r <= c) out[perm[r0 + r] * K + c0 + c] = v;
    }
    tile[k][tx] = v;
  }
  __syncthreads();
  // The transpose: out[perm[c0 + c], r0 + r] = v(r, c), the lower part of a
  // diagonal tile.
  for (int k = ty; k < kSub; k += kRows) {
    const int c = cb + k, r = rb + tx;
    if (r < nr && c < nc && (!diag || r < c)) out[perm[c0 + c] * K + r0 + r] = tile[tx][k];
  }
}

__global__ void __launch_bounds__(512) unpermute_kernel(
    float* __restrict__ out,               // [K, K], rows done, columns sorted
    const int64_t* __restrict__ inv,       // [K] original index -> sorted position
    int K) {
  extern __shared__ float row[];
  float* o = out + (size_t)blockIdx.x * K;
  for (int j = threadIdx.x; j < K; j += blockDim.x) row[j] = o[j];
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += blockDim.x) o[j] = row[inv[j]];
}

// Past the shared memory: block b takes rows b, b + gridDim.x, ... through
// its own scratch row.  A thread reads back only the scratch entries it
// wrote, so the one barrier is the one that keeps every read of row i
// before the first write to it.
__global__ void __launch_bounds__(512) unpermute_rows_kernel(
    float* out,                            // [K, K], rows done, columns sorted
    const int64_t* __restrict__ inv,       // [K] original index -> sorted position
    float* scratch,                        // [gridDim.x, K]
    int K) {
  float* s = scratch + (size_t)blockIdx.x * K;
  for (size_t i = blockIdx.x; i < (size_t)K; i += gridDim.x) {
    float* o = out + i * K;
    for (int j = threadIdx.x; j < K; j += blockDim.x) s[j] = o[inv[j]];
    __syncthreads();
    for (int j = threadIdx.x; j < K; j += blockDim.x) o[j] = s[j];
  }
}

}  // namespace

extern "C" int apd_dtw_scatter(
    const float* blocks, const int* ti_idx, const int* tj_idx, const int* lengths,
    const int64_t* perm, float* out, int ti, int U, int K, int normalize, void* stream) {
  const int nsub = (ti + kSub - 1) / kSub;
  const dim3 grid((unsigned)(nsub * nsub), (unsigned)U), block(kSub, kRows);
  scatter_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      blocks, ti_idx, tj_idx, lengths, perm, out, ti, K, nsub, normalize);
  return (int)cudaGetLastError();
}

extern "C" int apd_dtw_scatter_unpermute(float* out, const int64_t* inv, int K, void* stream) {
  const size_t smem = (size_t)K * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      unpermute_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  unpermute_kernel<<<(unsigned)K, 512, smem, (cudaStream_t)stream>>>(out, inv, K);
  return (int)cudaGetLastError();
}

extern "C" int apd_dtw_scatter_unpermute_rows(float* out, const int64_t* inv, float* scratch,
                                              int K, int nblocks, void* stream) {
  unpermute_rows_kernel<<<(unsigned)nblocks, 512, 0, (cudaStream_t)stream>>>(
      out, inv, scratch, K);
  return (int)cudaGetLastError();
}

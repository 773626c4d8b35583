// K3: exact unbanded DTW over tile-pairs with full-width DP rows (long
// sequences, 256 < S <= 4096), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_lane_full_kernel
// (entry dtw_tile_lane_full_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a padded
// corpus (a: [K, S, d] f32, lengths: [K] i32, pad entries length 1) it writes
// out[u, r, c] = the UNNORMALIZED, unbanded DTW distance of sequence
// ti_idx[u]*ti + r against sequence tj_idx[u]*ti + c (oracle/dtw.py).  Slot s
// of DP row i is column j = s; the start cell D[-1, -1] = 0 enters at slot 0
// of row 0.  Two class contracts, each shortfall +inf and never a truncated
// distance: `width` W (a multiple of 8, <= S) must cover every real lb, and
// `rows` every real la.
//
// What bounds it on the H100.  A DP row of up to 4096 floats per pair does
// not fit one thread's share of shared memory (128 pairs x 16 KB = 2 MB
// against a block's 227 KB), so K2's thread-per-pair layout does not carry
// over.  Per cell the work is d loads of B, d FMAs and a sqrt (the cost) plus
// six shared-memory accesses; B ([K, d, S], 64 KB per sequence at S=1024,
// d=16) is re-read by every A row of its tile and stays in L2.  At S=1024 a
// warp's two rows take 8.4 KB of shared memory, so a block of 8 warps takes
// 67 KB and three blocks share an SM; the bound is the load and issue rate
// of the cost build and the serial chunk walks, not device memory.
//
// What the design does about it.  One warp per pair, a block of `warps`
// warps per (tile-pair, A row), so la is uniform across the block; a pair
// that breaks a contract exits at once with +inf.  Each DP row i < la takes
// four warp-synchronous steps over the pair's lb columns:
//   1. costs, lane l taking columns l, l+32, ... (one coalesced 128-byte
//      line per channel from B laid out [K, d, S]), into a cost row;
//   2. lane l walks its contiguous chunk [l*CW, (l+1)*CW) of columns,
//      forming e_j = c_j + min(up, diag) in place and composing the maps
//      x -> min(x + c_j, e_j) of its chunk into one map x -> min(x + P, Q);
//   3. a warp-wide inclusive scan of those maps with __shfl_up_sync (the GPU
//      form of the TPU kernel's Hillis-Steele row scan) gives each lane the
//      value D[i, l*CW - 1] left of its chunk;
//   4. lane l walks its chunk again: D[i, j] = min(e_j, D[i, j-1] + c_j).
// Both rows live in shared memory with chunk l at offset l*SC, SC = CW
// rounded up to an odd number: lanes walking their chunks in steps 2 and 4
// then hit 32 distinct banks, and step 1's 32 consecutive columns span
// fewer than 64 words (at most 2-way conflicts).  The scan reassociates the
// additions along a row, so the kernel differs from the cell-by-cell plain
// twin by rounding only: at most about 2 (la + lb) 2^-24 of a distance,
// relative.  Left to later work: several pairs per warp for short rows, B
// staged by TMA, tensor cores for the cross term at full fp32.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kCosine = 2;
constexpr unsigned kFull = 0xffffffffu;

__global__ void lane_full_kernel(
    const float* __restrict__ a,         // [K, S, d]
    const float* __restrict__ bt,        // [K, d, S]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int d, int ti, int rows, int W, int row_len, int metric) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* cost = smem + (size_t)warp * (2 * row_len + d);   // [row_len]
  float* dp = cost + row_len;                               // [row_len]
  float* a_s = dp + row_len;                                // [d]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * warps + warp;
  if (c >= ti) return;
  const int arow = ti_idx[u] * ti + r;
  const int bseq = tj_idx[u] * ti + c;
  const int la = lengths[arow];
  const int lb = lengths[bseq];
  float* o = out + ((size_t)u * ti + r) * ti + c;
  if (la < 1 || lb < 1 || la > rows || lb > W) {   // warp-uniform
    if (lane == 0) *o = CUDART_INF_F;
    return;
  }
  const int cw = (lb + 31) >> 5;                  // columns per lane chunk
  const int sc = cw | 1;                          // chunk stride in smem
  const int j0 = lane * cw;
  const int j1 = j0 + cw < lb ? j0 + cw : lb;
  float* cost_l = cost + lane * sc;               // this lane's chunk
  float* dp_l = dp + lane * sc;
  const float* ar = a + (size_t)arow * S * d;
  const float* b = bt + (size_t)bseq * d * S;

  for (int i = 0; i < la; ++i) {
    // 1. Costs of row i.  The previous row's readers of a_s and of the cost
    //    row finished before the __syncwarp closing that row.
    for (int ch = lane; ch < d; ch += 32) a_s[ch] = ar[(size_t)i * d + ch];
    __syncwarp();
    for (int j = lane; j < lb; j += 32) {
      const float* bj = b + j;
      float acc = 0.f;
      float cj;
      if (metric == kCosine) {
        for (int ch = 0; ch < d; ++ch) acc = fmaf(a_s[ch], bj[(size_t)ch * S], acc);
        cj = 1.f - acc;
      } else {
        for (int ch = 0; ch < d; ++ch) {
          const float diff = a_s[ch] - bj[(size_t)ch * S];
          acc = fmaf(diff, diff, acc);
        }
        cj = metric == kEuclidean ? sqrtf(acc) : acc;
      }
      const int l = j / cw;
      cost[l * sc + (j - l * cw)] = cj;
    }
    // 2. e_j = c_j + min(up, diag) in place, and this chunk's map.  The
    //    diagonal predecessor of the chunk's first column is read before
    //    any lane overwrites row i-1.
    float diag = CUDART_INF_F;
    if (j0 == 0) {
      diag = i == 0 ? 0.f : CUDART_INF_F;        // D[-1, -1] = 0
    } else if (i > 0 && j0 < lb) {
      diag = dp[(lane - 1) * sc + cw - 1];
    }
    __syncwarp();
    float P = 0.f, Q = CUDART_INF_F;
    for (int t = 0; t < j1 - j0; ++t) {
      const float up = i == 0 ? CUDART_INF_F : dp_l[t];
      const float cj = cost_l[t];
      const float e = cj + fminf(diag, up);
      dp_l[t] = e;
      diag = up;
      P += cj;
      Q = fminf(Q + cj, e);
    }
    // 3. Inclusive scan of the maps x -> min(x + P, Q), earlier lanes first.
    for (int off = 1; off < 32; off <<= 1) {
      const float Pp = __shfl_up_sync(kFull, P, off);
      const float Qp = __shfl_up_sync(kFull, Q, off);
      if (lane >= off) {
        Q = fminf(Qp + P, Q);
        P = Pp + P;
      }
    }
    float left = __shfl_up_sync(kFull, Q, 1);     // D[i, j0 - 1]
    if (lane == 0) left = CUDART_INF_F;
    // 4. D[i, j] = min(e_j, D[i, j-1] + c_j).
    for (int t = 0; t < j1 - j0; ++t) {
      const float v = fminf(dp_l[t], left + cost_l[t]);
      dp_l[t] = v;
      left = v;
    }
    __syncwarp();
  }
  if (lane == 0) {
    const int l = (lb - 1) / cw;
    *o = dp[l * sc + (lb - 1 - l * cw)];
  }
}

}  // namespace

extern "C" int apd_dtw_lane_full(
    const float* a, const float* bt, const int* lengths, const int* ti_idx,
    const int* tj_idx, float* out, int S, int d, int ti, int U, int rows,
    int W, int metric, int warps, void* stream) {
  // Chunk strides are odd and at most ceil(W/32) + 1.
  const int row_len = 32 * (((W + 31) / 32) + 1);
  const size_t smem = (size_t)warps * (2 * row_len + d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + warps - 1) / warps));
  lane_full_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      a, bt, lengths, ti_idx, tj_idx, out, S, d, ti, rows, W, row_len, metric);
  return (int)cudaGetLastError();
}

// K1: diag-corridor banded DTW over tile-pairs, written by hand for Hopper
// (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_lane_diag_kernel
// (entry dtw_tile_lane_diag_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a
// length-sorted, padded corpus (a: [K, S, d] f32, lengths: [K] i32, pad
// entries length 1) it writes out[u, r, c] = the UNNORMALIZED DTW distance
// of sequence ti_idx[u]*ti + r against sequence tj_idx[u]*ti + c, over the
// cells of the scaled corridor |j*(la-1) - i*(lb-1)| <= max(band,1) *
// max(la-1, lb-1) (an exact integer predicate).  Each DP row i is held in a
// sheared stripe frame of W = 2*wv+2 slots centred on
// c(i) = min(floor((i*numm + den/2) / den), numm), den = max(la-1, 1),
// numm = tile_rep[tj]-1; slot s holds column j = c(i) + s - (wv+1).  Cells
// outside the frame do not exist, and a pair whose corner cell falls
// outside the frame comes back +inf.  With the class contract met (rows >=
// every A length, wv >= diag_class_bounds) every corridor cell is in the
// frame, so the distance is exact.
//
// What bounds it on the H100.  Per DP cell a thread does d loads of B, d
// FMAs, a sqrt and a three-way min, and the cells of one pair form a serial
// chain (row by row, slot by slot).  No data leaves the SM except one float
// per pair, and one B tile ([d, S, ti] f32, 1 MB at S=128, d=16, ti=128) is
// read by ti blocks, so device memory is not the limit: the d
// B loads per cell (L1/L2 traffic) and the instruction rate of the serial
// chain are.
//
// What the design does about it.  One block per (tile-pair, A row, lane
// group) and one thread per B sequence ("pairs on lanes", as on the TPU).
// Every thread of a block shares the A row, so the frame centre and hence
// the column j of slot s are uniform across the block: B is laid out
// [tile, d, S, ti] by the wrapper and neighbouring threads read neighbouring
// addresses (one 128-byte line per warp per channel).  The A row is staged
// in shared memory and read as a broadcast.  The stripe lives in shared
// memory as [W][lanes] (conflict-free) and is updated in place, slot by
// slot, with the diagonal predecessor carried in a register.  The frame
// cost is the sum of squared differences, not the Gram expansion, so it is
// exact near zero and matches the plain twin's formula.  Not done yet, and
// left to later work: register-resident stripes, wgmma-built cost tiles,
// TMA staging of B.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kSqEuclidean = 1;
constexpr int kCosine = 2;

__global__ void lane_diag_kernel(
    const float* __restrict__ a,         // [K, S, d]
    const float* __restrict__ b,         // [nT, d, S, ti]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ tile_rep,    // [nT]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int d, int ti, int rows, int r_band, int W, int off, int metric,
    int a_chunk) {
  extern __shared__ float smem[];
  const int lanes = blockDim.x;
  float* stripe = smem + threadIdx.x;            // stride `lanes`
  float* a_s = smem + W * lanes;                 // [a_chunk, d]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * lanes + threadIdx.x;
  const bool active = c < ti;
  const int tile_i = ti_idx[u];
  const int tile_j = tj_idx[u];
  const int arow = tile_i * ti + r;

  const int la = lengths[arow];
  const int lb = active ? lengths[tile_j * ti + c] : 1;
  const int numm = tile_rep[tile_j] - 1;
  const int den_t = la - 1;
  const int den = den_t > 1 ? den_t : 1;
  const int half = den / 2;
  const int num = lb - 1;
  const long long thresh =
      (long long)r_band * (long long)(den_t > num ? den_t : num);
  const int ex = lb - 1 - numm + off;            // corner slot of row la-1

  const float* bt = b + (size_t)tile_j * d * S * ti + c;
  const float* ar = a + (size_t)arow * S * d;

  for (int s = 0; s < W; ++s) stripe[s * lanes] = (s == off) ? 0.f : CUDART_INF_F;

  float result = CUDART_INF_F;
  int c_prev = -1;                               // virtual row -1: D[-1,-1] = 0
  const int n_rows = rows < la ? rows : la;
  for (int i0 = 0; i0 < n_rows; i0 += a_chunk) {
    const int nr = (n_rows - i0) < a_chunk ? (n_rows - i0) : a_chunk;
    __syncthreads();
    for (int t = threadIdx.x; t < nr * d; t += lanes) a_s[t] = ar[(size_t)i0 * d + t];
    __syncthreads();
    for (int ii = 0; ii < nr; ++ii) {
      const int i = i0 + ii;
      int ci = (i * numm + half) / den;
      ci = ci < numm ? ci : numm;
      const int k = ci - c_prev;                 // centre step, >= 0
      c_prev = ci;
      const float* arow_s = a_s + ii * d;
      // Carry realignment: up[s] = prev[s+k], diag[s] = prev[s+k-1].  Slots
      // are overwritten in ascending order and read at s+k >= s, so the
      // diagonal value is the previous slot's `up`, kept in a register.
      float diag = (k >= 1 && k - 1 < W) ? stripe[(k - 1) * lanes] : CUDART_INF_F;
      float left = CUDART_INF_F;
      const long long i_num = (long long)i * num;
      for (int s = 0; s < W; ++s) {
        const float up = (s + k < W) ? stripe[(s + k) * lanes] : CUDART_INF_F;
        const int j = ci + s - off;
        float cost = CUDART_INF_F;
        if (active && j >= 0 && j < lb) {
          long long dev = (long long)j * den_t - i_num;
          dev = dev < 0 ? -dev : dev;
          if (dev <= thresh) {
            const float* bj = bt + (size_t)j * ti;
            float acc = 0.f;
            if (metric == kCosine) {
              for (int ch = 0; ch < d; ++ch) acc = fmaf(arow_s[ch], bj[(size_t)ch * S * ti], acc);
              cost = 1.f - acc;
            } else {
              for (int ch = 0; ch < d; ++ch) {
                const float diff = arow_s[ch] - bj[(size_t)ch * S * ti];
                acc = fmaf(diff, diff, acc);
              }
              cost = metric == kEuclidean ? sqrtf(acc) : acc;
            }
          }
        }
        const float v = cost + fminf(fminf(diag, up), left);
        stripe[s * lanes] = v;
        left = v;
        diag = up;
      }
      if (i == la - 1 && ex >= 0 && ex < W) result = stripe[ex * lanes];
    }
  }
  if (active) out[((size_t)u * ti + r) * ti + c] = result;
}

}  // namespace

extern "C" int apd_dtw_lane_diag(
    const float* a, const float* b, const int* lengths, const int* tile_rep,
    const int* ti_idx, const int* tj_idx, float* out,
    int S, int d, int ti, int U, int rows, int band, int wv, int metric,
    int lanes, int a_chunk, void* stream) {
  const int W = 2 * wv + 2;
  const int off = wv + 1;
  const int r_band = band > 1 ? band : 1;
  const size_t smem = (size_t)(W * lanes + a_chunk * d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + lanes - 1) / lanes));
  lane_diag_kernel<<<grid, lanes, smem, (cudaStream_t)stream>>>(
      a, b, lengths, tile_rep, ti_idx, tj_idx, out, S, d, ti, rows, r_band, W,
      off, metric, a_chunk);
  return (int)cudaGetLastError();
}

// K4: widen-banded DTW over tile-pairs in an unsheared stripe frame, written
// by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_lane_kernel
// (entry dtw_tile_lane_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a padded
// corpus (a: [K, S, d] f32, lengths: [K] i32, pad entries length 1) it writes
// out[u, r, c] = the UNNORMALIZED DTW distance of sequence ti_idx[u]*ti + r
// against sequence tj_idx[u]*ti + c over the cells i < la, j < lb,
// |j - i| <= pw, with the pair's half-width pw = max(band, |la - lb|) under
// auto_widen, else band.  Each DP row i is held in a stripe frame of
// W = 2*wv+2 slots, wv the class bound (>= band): slot s holds column
// j = i + s - (wv+1).  Contracts, each shortfall +inf and never a truncated
// distance: `rows` >= every A length, and wv >= every real pair's pw (a pair
// with pw > wv comes back +inf).  A pair whose corner lies outside its own
// band (auto_widen off, |la - lb| > band) is +inf, as in the reference.
//
// What bounds it on the H100.  K1's kernel without the shear: per DP cell a
// thread does d loads of B, d FMAs, a sqrt and a three-way min, and the cells
// of one pair form a serial chain.  One B tile ([d, S, ti] f32, 1 MB at
// S=128, d=16, ti=128) is read by ti blocks and stays in L2, so the d loads
// per cell (L1/L2) and the instruction rate of the serial chain bound it,
// not device memory.  Unlike K1's diag corridor, a widen stripe grows with
// the tile-pair's length spread, so distant tiles cost more per row.
//
// What the design does about it.  One block per (tile-pair, A row, lane
// group) and one thread per B sequence.  The frame is not sheared, so the
// column of slot s is uniform across the block: B is laid out
// [tile, d, S, ti] by the wrapper and a warp's loads at one (channel, frame)
// are one 128-byte line.  The A rows are staged in shared memory in chunks
// and read as broadcasts.  The stripe lives in shared memory as [W][lanes]
// (conflict-free) and is updated in place, slot by slot: D[i-1, j] sits at
// slot s+1 of the previous row, D[i-1, j-1] at slot s, and the latter is the
// previous slot's `up`, kept in a register.  Costs are sums of squared
// differences (exact at 0), the plain twin's formula.  Left to later work:
// per-thread slot ranges clipped to the pair's own band, register-resident
// stripes.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kCosine = 2;

__global__ void lane_kernel(
    const float* __restrict__ a,         // [K, S, d]
    const float* __restrict__ b,         // [nT, d, S, ti]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int d, int ti, int rows, int band, int wv, int auto_widen,
    int metric, int a_chunk) {
  extern __shared__ float smem[];
  const int lanes = blockDim.x;
  const int W = 2 * wv + 2;
  const int off = wv + 1;
  float* stripe = smem + threadIdx.x;            // stride `lanes`
  float* a_s = smem + W * lanes;                 // [a_chunk, d]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * lanes + threadIdx.x;
  const bool active = c < ti;
  const int tile_j = tj_idx[u];
  const int arow = ti_idx[u] * ti + r;
  const int la = lengths[arow];
  const int lb = active ? lengths[tile_j * ti + c] : 1;
  float* o = out + ((size_t)u * ti + r) * ti + c;

  // la is uniform across the block: a broken `rows` contract (or an empty
  // A sequence) leaves the whole block +inf without touching the DP.
  if (la < 1 || la > rows) {
    if (active) *o = CUDART_INF_F;
    return;
  }
  const int diff = la > lb ? la - lb : lb - la;
  const int pw = (auto_widen && diff > band) ? diff : band;
  // Past the class frame (pw > wv) or with the corner outside the pair's
  // own band, the pair is +inf; its thread still takes part in staging.
  const bool ok = active && lb >= 1 && lb <= S && pw <= wv && diff <= pw;
  const float* bt = b + (size_t)tile_j * d * S * ti + c;
  const float* ar = a + (size_t)arow * S * d;

  // Virtual row -1: +inf except D[-1, -1] = 0 at slot `off`.
  for (int s = 0; s < W; ++s) stripe[s * lanes] = (s == off) ? 0.f : CUDART_INF_F;

  for (int i0 = 0; i0 < la; i0 += a_chunk) {
    const int nr = (la - i0) < a_chunk ? (la - i0) : a_chunk;
    __syncthreads();
    for (int t = threadIdx.x; t < nr * d; t += lanes) a_s[t] = ar[(size_t)i0 * d + t];
    __syncthreads();
    for (int ii = 0; ii < nr; ++ii) {
      const int i = i0 + ii;
      const float* arow_s = a_s + ii * d;
      // up[s] = prev[s+1], diag[s] = prev[s]: slots are overwritten in
      // ascending order, so diag is the previous slot's up.
      float diag = stripe[0];
      float left = CUDART_INF_F;
      for (int s = 0; s < W; ++s) {
        const float up = (s + 1 < W) ? stripe[(s + 1) * lanes] : CUDART_INF_F;
        const int j = i + s - off;
        const int dj = s - off;
        float cost = CUDART_INF_F;
        if (ok && j >= 0 && j < lb && dj <= pw && -dj <= pw) {
          const float* bj = bt + (size_t)j * ti;
          float acc = 0.f;
          if (metric == kCosine) {
            for (int ch = 0; ch < d; ++ch) acc = fmaf(arow_s[ch], bj[(size_t)ch * S * ti], acc);
            cost = 1.f - acc;
          } else {
            for (int ch = 0; ch < d; ++ch) {
              const float dd = arow_s[ch] - bj[(size_t)ch * S * ti];
              acc = fmaf(dd, dd, acc);
            }
            cost = metric == kEuclidean ? sqrtf(acc) : acc;
          }
        }
        const float v = cost + fminf(fminf(diag, up), left);
        stripe[s * lanes] = v;
        left = v;
        diag = up;
      }
    }
  }
  // The corner (la-1, lb-1) sits at slot lb - la + off, inside [1, W-1]
  // whenever ok holds.
  if (active) *o = ok ? stripe[(lb - la + off) * lanes] : CUDART_INF_F;
}

}  // namespace

extern "C" int apd_dtw_lane(
    const float* a, const float* b, const int* lengths, const int* ti_idx,
    const int* tj_idx, float* out, int S, int d, int ti, int U, int rows,
    int band, int wv, int auto_widen, int metric, int lanes, int a_chunk,
    void* stream) {
  const size_t smem = (size_t)((2 * wv + 2) * lanes + a_chunk * d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + lanes - 1) / lanes));
  lane_kernel<<<grid, lanes, smem, (cudaStream_t)stream>>>(
      a, b, lengths, ti_idx, tj_idx, out, S, d, ti, rows, band, wv, auto_widen,
      metric, a_chunk);
  return (int)cudaGetLastError();
}

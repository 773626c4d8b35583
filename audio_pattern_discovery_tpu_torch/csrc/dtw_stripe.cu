// K7: per-pair widen-banded DTW over gathered pairs in a stripe frame (long
// buckets, S <= 4096), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_stripe_kernel
// (entry _dtw_batch_stripe).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For B gathered pairs (a laid out [d, R, B] and b
// [d, S, B] by the wrapper; len_a, len_b: [B] i32) it writes out[p] = the
// UNNORMALIZED DTW distance of pair p over the cells i < la, j < lb,
// |j - i| <= pw, pw = max(band, |la - lb|) under auto_widen, else band.  DP
// row i is a stripe of W = 2*wv+2 slots, wv = max(band, max_len_diff) under
// auto_widen (else band): slot s holds column j = i + s - (wv+1).  The
// max_len_diff contract: a pair with pw > wv comes back +inf, never a
// truncated distance; so does a pair with la > R or its corner outside its
// own band.  The wrapper divides by la + lb for path_len normalization.
//
// What bounds it on the H100.  A stripe row is narrow (W = 2*wv+2, at most
// 1024 where the route applies: 4 W <= S), so one thread can own a pair and
// keep its row in shared memory, K4's layout over gathered pairs.  Per cell
// a thread does d loads of B, d FMAs, a sqrt and a three-way min; the cells
// of a pair form a serial chain.  Gathered pairs share no frames, so each
// B frame is read from device memory once per pair and row band; the bound
// is that load traffic and the serial chain's issue rate.
//
// What the design does about it.  One thread per pair, one warp per block:
// a launch holds a few thousand pairs at most, and one-warp blocks spread
// them over the most SMs.  The channel loop is unrolled so that a cell's d
// loads are in flight together rather than one L2 latency each.  The frame
// is not sheared, so the column of slot s in row i is the same for every
// pair: with the pair index innermost ([d, S, B]) a warp's loads at one
// (channel, frame) are one 128-byte line.  Each thread stages
// its A row in shared memory ([d][lanes], its own column, no barrier) and
// keeps its stripe there as [W][lanes] (conflict-free), updated in place
// slot by slot: D[i-1, j] is slot s+1 of the previous row and D[i-1, j-1]
// slot s, the previous slot's `up`, carried in a register.  Costs are sums
// of squared differences (exact at 0), the plain twin's formula.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kCosine = 2;

__global__ void stripe_kernel(
    const float* __restrict__ at,        // [d, R, B]
    const float* __restrict__ bt,        // [d, S, B]
    const int* __restrict__ len_a,       // [B]
    const int* __restrict__ len_b,       // [B]
    float* __restrict__ out,             // [B]
    int n_pairs, int R, int S, int d, int band, int wv, int auto_widen,
    int metric) {
  extern __shared__ float smem[];
  const int lanes = blockDim.x;
  const int W = 2 * wv + 2;
  const int off = wv + 1;
  float* stripe = smem + threadIdx.x;            // [W][lanes]
  float* a_s = smem + W * lanes + threadIdx.x;   // [d][lanes]

  const int p = blockIdx.x * lanes + threadIdx.x;
  if (p >= n_pairs) return;                      // no block-wide barrier below
  const int la = len_a[p];
  const int lb = len_b[p];
  const int diff = la > lb ? la - lb : lb - la;
  const int pw = (auto_widen && diff > band) ? diff : band;
  if (la < 1 || lb < 1 || la > R || lb > S || pw > wv || diff > pw) {
    out[p] = CUDART_INF_F;
    return;
  }
  const size_t B = (size_t)n_pairs;
  const float* bp = bt + p;
  const float* ap = at + p;

  // Virtual row -1: +inf except D[-1, -1] = 0 at slot `off`.
  for (int s = 0; s < W; ++s) stripe[s * lanes] = (s == off) ? 0.f : CUDART_INF_F;

  for (int i = 0; i < la; ++i) {
    for (int ch = 0; ch < d; ++ch) a_s[ch * lanes] = ap[((size_t)ch * R + i) * B];
    float diag = stripe[0];
    float left = CUDART_INF_F;
    for (int s = 0; s < W; ++s) {
      const float up = (s + 1 < W) ? stripe[(s + 1) * lanes] : CUDART_INF_F;
      const int j = i + s - off;
      const int dj = s - off;
      float cost = CUDART_INF_F;
      if (j >= 0 && j < lb && dj <= pw && -dj <= pw) {
        const float* bj = bp + (size_t)j * B;
        float acc = 0.f;
        if (metric == kCosine) {
#pragma unroll 8
          for (int ch = 0; ch < d; ++ch) acc = fmaf(a_s[ch * lanes], bj[(size_t)ch * S * B], acc);
          cost = 1.f - acc;
        } else {
#pragma unroll 8
          for (int ch = 0; ch < d; ++ch) {
            const float dd = a_s[ch * lanes] - bj[(size_t)ch * S * B];
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
  out[p] = stripe[(lb - la + off) * lanes];      // the corner, in [1, W-1]
}

}  // namespace

extern "C" int apd_dtw_stripe(
    const float* at, const float* bt, const int* len_a, const int* len_b,
    float* out, int n_pairs, int R, int S, int d, int band, int wv,
    int auto_widen, int metric, int lanes, void* stream) {
  const size_t smem = (size_t)((2 * wv + 2) + d) * lanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_pairs + lanes - 1) / lanes);
  stripe_kernel<<<grid, lanes, smem, (cudaStream_t)stream>>>(
      at, bt, len_a, len_b, out, n_pairs, R, S, d, band, wv, auto_widen, metric);
  return (int)cudaGetLastError();
}

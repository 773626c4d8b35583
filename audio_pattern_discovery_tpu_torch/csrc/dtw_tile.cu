// K2: square-tile DTW over tile-pairs (unbanded or widen-banded), written by
// hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_tile_kernel
// (entry dtw_tile_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a padded
// corpus (x: the strip layout of dtw_strip.cuh, lengths: [K] i32, pad
// entries length 1) it writes out[u, r, c] = the UNNORMALIZED DTW distance
// of sequence ti_idx[u]*ti + r against sequence tj_idx[u]*ti + c
// (oracle/dtw.py's recurrence, read out at (la-1, lb-1)) over the cells
// i < la, j < lb, |j - i| <= wv, with wv = S for band < 0 (unbanded),
// max(band, |la - lb|) with auto_widen, else band.  Contract: `rows` must
// cover every A length of the call; an A sequence longer than `rows` (or a
// B sequence longer than S) comes back +inf, never truncated.  The TPU
// kernel's `scan_steps` (the depth of its Hillis-Steele row scan) has no
// counterpart: each row is walked left to right here.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations
// (d subtractions, d FMAs, a sqrt, two mins and an add); the cells of one
// pair form a serial chain, and no data leaves the SM but one float per
// pair, so the FP32 issue rate bounds it, provided the loads keep out of
// its way: built one cell at a time, a cell costs d scalar loads of B, d
// shared loads of A and a shared load and store of the DP row, about 34
// load/store instructions for 32 FP ones, and the load/store pipe sets the
// pace (measured at 2.6 % of the FP32 bound on config 4).
//
// What the design does about it.  One block per (tile-pair, A row, lane
// group) and one thread per B sequence, so la and every A frame are
// uniform across the block.  Each thread walks its DP in strips of R
// consecutive A rows, column by column.  At column j it loads B's frame j
// once (nc4 16-byte loads, neighbouring threads on neighbouring addresses)
// and builds the R costs of the strip from it; the strip's A frames sit in
// registers (dtw_strip.cuh), read once per strip.  The R cells of the column
// update as a short chain whose left and diagonal carries stay in
// registers.  Only the strip's boundary row lives in shared memory ([S][lanes],
// conflict-free): row i0-1 is read once a column and row i0+R-1 written
// back.  That is (nc4 + 2)/R load/store instructions a cell, and R
// independent cost builds a column give the instruction-level parallelism
// that the few resident warps (the boundary row caps residency) do not.
// Rows at or past la in the last strip read zero frames and are never read
// back; the result is taken at row la-1 from its register.  Each cost
// is the same fmaf chain over channels 0..d-1 and each cell
// cost + min(diag, up, left), so the result is bitwise that of a
// cell-at-a-time walk.  The cost is the sum of squared differences, not
// the TPU's Gram expansion: it is exact near zero (self pairs are exactly 0)
// and is the plain twin's formula.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"

namespace {

using namespace apd_strip;

template <int R, int D4>
__global__ void __launch_bounds__(128) tile_kernel(
    const float4* __restrict__ x,        // [nT, S, ti, nc4]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int nc4, int ti, int rows, int band, int auto_widen, int metric) {
  extern __shared__ float4 smem4[];
  const int lanes = blockDim.x;
  float4* a_s = smem4;                                               // [R][nc4]
  float* dp = reinterpret_cast<float*>(smem4 + R * nc4) + threadIdx.x;   // [S][lanes]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * lanes + threadIdx.x;
  const bool active = c < ti;
  const int tile_i = ti_idx[u];
  const int tile_j = tj_idx[u];
  const int la = lengths[tile_i * ti + r];
  const int lb = active ? lengths[tile_j * ti + c] : 0;
  float* o = out + ((size_t)u * ti + r) * ti + c;

  // la is uniform across the block: a broken `rows` contract (or an empty
  // A sequence) leaves the whole block +inf without touching the DP.
  if (la < 1 || la > rows) {
    if (active) *o = CUDART_INF_F;
    return;
  }
  const bool banded = band >= 0;
  int wv = S;
  if (banded) {
    const int diff = la > lb ? la - lb : lb - la;
    wv = (auto_widen && diff > band) ? diff : band;
  }
  const int n_cols = (lb >= 1 && lb <= S) ? lb : 0;
  const size_t fstride = (size_t)ti * nc4;          // float4s from frame j to j+1
  const float4* xa = x + (size_t)tile_i * S * fstride + (size_t)r * nc4;
  const float4* xb = x + (size_t)tile_j * S * fstride + (size_t)(active ? c : 0) * nc4;

  StripA<R, D4> a;
  float res = CUDART_INF_F;
  for (int i0 = 0; i0 < la; i0 += R) {
    __syncthreads();                                 // the last strip is done with a_s
    stage_strip<R>(a_s, xa, fstride, i0, la, nc4);
    __syncthreads();
    a.load(a_s, nc4);
    // left[k] = D[i0+k, j-1]; bdiag = D[i0-1, j-1], +inf at j = 0 except
    // the virtual start D[-1, -1] = 0.
    float left[R];
#pragma unroll
    for (int k = 0; k < R; ++k) left[k] = CUDART_INF_F;
    float bdiag = i0 == 0 ? 0.f : CUDART_INF_F;
    for (int j = 0; j < n_cols; ++j) {
      float acc[R];
      strip_sums<R, D4>(acc, a, xb + (size_t)j * fstride, metric);
      float up = i0 == 0 ? CUDART_INF_F : dp[j * lanes];
      float diag = bdiag;
      bdiag = up;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int i = i0 + k;
        float cost = cost_of(acc[k], metric);
        if (banded && (j - i > wv || i - j > wv)) cost = CUDART_INF_F;
        const float v = cost + fminf(fminf(diag, up), left[k]);
        diag = left[k];
        left[k] = v;
        up = v;
      }
      dp[j * lanes] = up;
    }
    if (i0 + R >= la && n_cols > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (i0 + k == la - 1) res = left[k];
    }
  }
  if (active) *o = res;
}

template <int R, int D4>
int launch(const float* x, const int* lengths, const int* ti_idx, const int* tj_idx,
           float* out, int S, int nc4, int ti, int U, int rows, int band,
           int auto_widen, int metric, int lanes, void* stream) {
  const size_t smem = (size_t)R * nc4 * sizeof(float4) + (size_t)S * lanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel<R, D4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + lanes - 1) / lanes));
  tile_kernel<R, D4><<<grid, lanes, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), lengths, ti_idx, tj_idx, out, S, nc4, ti, rows,
      band, auto_widen, metric);
  return (int)cudaGetLastError();
}

}  // namespace

// strip_rows: R as ops/dtw_cuda.py:_tile_strip_rows picks it from S and nc4:
// 8 below 4 float4s a frame and at 4 past S=128, else 4.  nc4: float4s per
// frame; the listed widths keep the strip's A frames in registers (at most
// 128 floats a strip), any other width reads them from shared memory.
extern "C" int apd_dtw_tile(
    const float* x, const int* lengths, const int* ti_idx, const int* tj_idx, float* out,
    int S, int nc4, int ti, int U, int rows, int band, int auto_widen, int metric,
    int lanes, int strip_rows, void* stream) {
#define APD_K2(R, D4)                                                              \
  return launch<R, D4>(x, lengths, ti_idx, tj_idx, out, S, nc4, ti, U, rows, band, \
                       auto_widen, metric, lanes, stream)
  if (strip_rows == 8) {
    switch (nc4) {
      case 1: APD_K2(8, 1);
      case 2: APD_K2(8, 2);
      case 4: APD_K2(8, 4);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (nc4) {
    case 1:
    case 2: return (int)cudaErrorInvalidValue;
    case 4: APD_K2(4, 4);
    case 8: APD_K2(4, 8);
    default: APD_K2(4, 0);
  }
#undef APD_K2
}

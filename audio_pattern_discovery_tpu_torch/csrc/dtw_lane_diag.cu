// K1: diag-corridor banded DTW over tile-pairs, written by hand for Hopper
// (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_lane_diag_kernel
// (entry dtw_tile_lane_diag_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a
// length-sorted, padded corpus (x: the strip layout of dtw_strip.cuh,
// lengths: [K] i32, pad entries length 1) it writes out[u, r, c] = the
// UNNORMALIZED DTW distance of sequence ti_idx[u]*ti + r against sequence
// tj_idx[u]*ti + c, over the cells of the scaled corridor
// |j*(la-1) - i*(lb-1)| <= max(band,1) * max(la-1, lb-1) (an exact integer
// predicate).  Each DP row i is held in a sheared stripe frame of
// W = 2*wv+2 slots centred on c(i) = min(floor((i*numm + den/2) / den), numm),
// den = max(la-1, 1), numm = tile_rep[tj]-1; slot s holds column
// j = c(i) + s - (wv+1).  Cells outside the frame do not exist (+inf), and
// the result is read at slot ex = lb-1-numm+(wv+1) of row la-1's frame; a
// pair whose corner slot falls outside the frame comes back +inf.  With the
// class contract met (rows >= every A length, wv >= diag_class_bounds)
// every corridor cell is in the frame, so the distance is exact.  For
// la == 1 the corridor is the whole of row 0 (oracle/dtw.py: den = 0),
// which a frame centred on column 0 cannot hold past wv+1 columns, and the
// frame's corner slot would read column lb-1-numm (the reference reads
// that truncated value); such a pair takes its own branch instead: the
// row's running sum D[0, j] = c_j + D[0, j-1], what a frame wide enough
// would give, whatever the tile size.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations;
// the cells of a pair form a serial chain, and no data leaves the SM but one
// float per pair, so the FP32 issue rate bounds it, provided the loads keep
// out of its way: built one slot at a time, a cell costs d scalar loads of
// B, d shared loads of A and a shared load and store of the stripe, and the
// load/store pipe sets the pace (measured at 7 % of the FP32 bound on
// config 4).
//
// What the design does about it.  One block per (tile-pair, A row, lane
// group) and one thread per B sequence ("pairs on lanes", as on the TPU), so
// la, numm and every frame centre c(i) are uniform across the block.  Each
// thread walks its DP in strips of R consecutive rows: the strip walks the
// union of its rows' frames, columns c(i0)-off .. c(i0+R-1)-off+W-1, and
// each row takes +inf outside its own frame.  At column j it loads B's
// frame j once (dtw_strip.cuh) and builds the costs of the rows whose cell
// is in the corridor, each gated by the exact predicate, here the column
// range [ceil((i*num - t)/den_t), floor((i*num + t)/den_t)] worked out once
// a strip.  The strip's A frames, the left and diagonal carries sit in
// registers; only the boundary stripe between strips lives in shared memory
// ([W][lanes], conflict-free), in its own row's frame: row i0-1 is read once
// a column, row i0+R-1 written back in place (its slots never run ahead of
// the reads).  Each cost is the same fmaf chain over channels 0..d-1 and
// each cell cost + min(diag, up, left), so the result is bitwise that of a
// slot-at-a-time walk.  The cost is the sum of squared differences,
// not the Gram expansion, so it is exact near zero and matches the plain
// twin's formula.

#include <climits>

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"

namespace {

using namespace apd_strip;

__device__ __forceinline__ long long floor_div(long long a, long long b) {   // b > 0
  const long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

template <int R, int D4>
__global__ void __launch_bounds__(128) lane_diag_kernel(
    const float4* __restrict__ x,        // [nT, S, ti, nc4]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ tile_rep,    // [nT]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int nc4, int ti, int rows, int r_band, int W, int off, int metric) {
  extern __shared__ float4 smem4[];
  const int lanes = blockDim.x;
  float4* a_s = smem4;                                                   // [R][nc4]
  float* stripe = reinterpret_cast<float*>(smem4 + R * nc4) + threadIdx.x;   // [W][lanes]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * lanes + threadIdx.x;
  const bool active = c < ti;
  const int tile_i = ti_idx[u];
  const int tile_j = tj_idx[u];

  const int la = lengths[tile_i * ti + r];
  const int lb = active ? lengths[tile_j * ti + c] : 1;
  const int numm = tile_rep[tile_j] - 1;
  const int den_t = la - 1;
  const int den = den_t > 1 ? den_t : 1;
  const int half = den / 2;
  const int num = lb - 1;
  const long long thresh = (long long)r_band * (long long)(den_t > num ? den_t : num);
  const int ex = lb - 1 - numm + off;            // corner slot of row la-1
  const int j_end = (lb < S ? lb : S) - 1;       // last column with a B frame
  const int n_rows = rows < la ? rows : la;

  // The column of the corner cell, or INT_MIN when it is never reached.
  int jt = INT_MIN;
  if (la <= rows && ex >= 0 && ex < W) {
    const int cl = ((la - 1) * numm + half) / den;
    jt = (cl < numm ? cl : numm) + ex - off;
  }

  const size_t fstride = (size_t)ti * nc4;
  const float4* xa = x + (size_t)tile_i * S * fstride + (size_t)r * nc4;
  const float4* xb = x + (size_t)tile_j * S * fstride + (size_t)(active ? c : 0) * nc4;

  StripA<R, D4> a;
  if (la == 1) {                                 // block-uniform: one A row
    stage_strip<R>(a_s, xa, fstride, 0, 1, nc4);
    __syncthreads();
    a.load(a_s, nc4);
    float v = 0.f;                               // D[-1, -1]
    for (int j = 0; j <= (active ? j_end : -1); ++j) {
      float acc[R];
      strip_sums<R, D4>(acc, a, xb + (size_t)j * fstride, metric);
      v = cost_of(acc[0], metric) + v;
    }
    if (active) out[((size_t)u * ti + r) * ti + c] = v;
    return;
  }

  for (int s = 0; s < W; ++s) stripe[s * lanes] = (s == off) ? 0.f : CUDART_INF_F;

  float result = CUDART_INF_F;
  int cb = -1;                                   // centre of the row above the strip
  for (int i0 = 0; i0 < n_rows; i0 += R) {
    __syncthreads();                             // the last strip is done with a_s
    stage_strip<R>(a_s, xa, fstride, i0, n_rows, nc4);
    __syncthreads();
    a.load(a_s, nc4);
    const bool last = i0 + R >= n_rows;
    // Per strip row: frame centre (uniform), and the columns [lo, hi] of
    // cells in the corridor, the frame and j < lb.  Rows past n_rows take
    // the last real row's centre and no cells.
    int ck[R], lo[R], hi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + k < n_rows ? i0 + k : n_rows - 1;
      const int ci = (i * numm + half) / den;
      ck[k] = ci < numm ? ci : numm;
      long long l = ck[k] - off, h = ck[k] - off + W - 1;
      if (den_t > 0) {
        const long long m = (long long)i * num;
        const long long cl = -floor_div(thresh - m, den_t);   // ceil((m - t) / den_t)
        const long long ch = floor_div(m + thresh, den_t);
        l = l > cl ? l : cl;
        h = h < ch ? h : ch;
      }
      l = l > 0 ? l : 0;
      h = h < j_end ? h : j_end;
      lo[k] = i0 + k < n_rows ? (int)l : 1;
      hi[k] = i0 + k < n_rows ? (int)h : 0;
    }
    const int j_lo = ck[0] - off;
    const int j_hi = ck[R - 1] - off + W - 1;
    // left[k] = D[i0+k, j-1]; bdiag = D[i0-1, j-1] from the boundary stripe.
    float left[R];
#pragma unroll
    for (int k = 0; k < R; ++k) left[k] = CUDART_INF_F;
    int sb = j_lo - 1 - cb + off;                // boundary slot of column j - 1
    float bdiag = (sb >= 0 && sb < W) ? stripe[sb * lanes] : CUDART_INF_F;
    for (int j = j_lo; j <= j_hi; ++j) {
      ++sb;                                      // >= 0: c(i0) >= cb
      const float up0 = sb < W ? stripe[sb * lanes] : CUDART_INF_F;
      bool any = false;
#pragma unroll
      for (int k = 0; k < R; ++k) any |= (j >= lo[k]) & (j <= hi[k]);
      float acc[R];
      if (any) {
        strip_sums<R, D4>(acc, a, xb + (size_t)j * fstride, metric);
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = 0.f;
      }
      float up = up0;
      float diag = bdiag;
      bdiag = up0;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int s = j - ck[k] + off;
        const float cost = (j >= lo[k] && j <= hi[k]) ? cost_of(acc[k], metric) : CUDART_INF_F;
        float v = cost + fminf(fminf(diag, up), left[k]);
        if (s < 0 || s >= W) v = CUDART_INF_F;  // no such cell
        diag = left[k];
        left[k] = v;
        up = v;
      }
      if (!last) {
        const int sw = j - ck[R - 1] + off;
        if (sw >= 0 && sw < W) stripe[sw * lanes] = up;
      } else if (j == jt) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (i0 + k == la - 1) result = left[k];
      }
    }
    cb = ck[R - 1];
  }
  if (active) out[((size_t)u * ti + r) * ti + c] = result;
}

template <int R, int D4>
int launch(const float* x, const int* lengths, const int* tile_rep, const int* ti_idx,
           const int* tj_idx, float* out, int S, int nc4, int ti, int U, int rows,
           int r_band, int W, int off, int metric, int lanes, void* stream) {
  const size_t smem = (size_t)R * nc4 * sizeof(float4) + (size_t)W * lanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_diag_kernel<R, D4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + lanes - 1) / lanes));
  lane_diag_kernel<R, D4><<<grid, lanes, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), lengths, tile_rep, ti_idx, tj_idx, out, S, nc4,
      ti, rows, r_band, W, off, metric);
  return (int)cudaGetLastError();
}

}  // namespace

// Strips of 4 rows (ops/dtw_cuda.py:STRIP_ROWS sizes the launch for them).
// nc4: float4s per frame; the listed widths keep the strip's A frames in
// registers, any other width reads them from shared memory.
extern "C" int apd_dtw_lane_diag(
    const float* x, const int* lengths, const int* tile_rep, const int* ti_idx,
    const int* tj_idx, float* out, int S, int nc4, int ti, int U, int rows, int band,
    int wv, int metric, int lanes, void* stream) {
  const int W = 2 * wv + 2;
  const int off = wv + 1;
  const int r_band = band > 1 ? band : 1;
#define APD_K1(D4)                                                                    \
  return launch<4, D4>(x, lengths, tile_rep, ti_idx, tj_idx, out, S, nc4, ti, U, rows, \
                       r_band, W, off, metric, lanes, stream)
  switch (nc4) {
    case 1: APD_K1(1);
    case 2: APD_K1(2);
    case 4: APD_K1(4);
    case 8: APD_K1(8);
    default: APD_K1(0);
  }
#undef APD_K1
}

// K5: widen-banded DTW over tile-pairs with one warp per pair, for the wide
// widen classes (the scheduler sends classes wider than LANE_MAX_W stripe
// slots here, narrower ones to K4), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_tile_stripe_kernel
// (entry dtw_tile_stripe_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  K4's function and contracts: for U tile-pairs over a
// padded corpus (x: the frame layout [K, S, 4*nc4] f32 of
// ops/dtw_cuda.py:frame_layout, lengths: [K] i32, pad entries length 1),
// out[u, r, c] = the UNNORMALIZED DTW distance of sequence ti_idx[u]*ti + r
// against sequence tj_idx[u]*ti + c over the cells i < la, j < lb,
// |j - i| <= pw, pw = max(band, |la - lb|) under auto_widen, else band.
// Contracts, each shortfall +inf and never a truncated distance: `rows` >=
// every A length, wv (the class bound, >= band) >= every real pair's pw.  A
// pair whose corner lies outside its own band is +inf.
//
// What bounds it on the H100.  As for K4, the FP32 issue rate of the cost
// build (3d + 4 operations a cell) and of the DP, provided the loads and
// the per-row overhead keep out of its way.  The first design spent per
// row: an A frame staged through shared memory, d scalar loads of B and d
// shared loads of A per cell, a cost store, two walks of shared memory, a
// warp scan and two __syncwarps, over only 3-5 cells a lane on config 4's
// wide classes (1.7 % of the bound).
//
// What the design does about it.  One warp per pair, a block of `warps`
// warps per (tile-pair, A row), each pair walking only its own band, in
// strips of R rows.  The strip's window is the columns
// [i0 - pw, i0+R-1 + pw] ∩ [0, lb-1], cut into panels of 32*cw columns
// (cw <= CW columns a lane, as few as the window needs); lane l owns the
// contiguous run of cw columns starting at l*cw in its panel.  Per panel:
//   1. each lane loads each B frame of its run once (float4s of the frame
//      layout, one sequence's frames consecutive) and builds the R costs of
//      the strip from it (dtw_strip.cuh; the strip's A frames in registers);
//      a cell outside its row's band costs +inf;
//   2. row by row, in column coordinates: D[i-1, j] is the lane's own
//      register from the row above (the boundary row, from shared memory,
//      for the strip's first row), D[i-1, j-1] the neighbouring register or
//      one __shfl_up_sync from lane l-1; e_j = c_j + min(diag, up), and the
//      run's map x -> min(x + sum c, composed e) feeds a warp-wide inclusive
//      min-plus scan (5 steps of __shfl_up_sync); the exclusive prefix
//      applied to the row's carry from the panel before gives the lane's
//      left value, and D[i, j] = min(e_j, D[i, j-1] + c_j) along the run;
//   3. each row's last value (lane 31) is the carry `left` of the next
//      panel, as K2 carries its columns, and the row above's the diagonal.
// Between strips, the boundary row (row i0+R-1) sits in shared memory per
// warp, in its own band's frame (slot j - i + pw, 2*wv+1 slots), read for
// row i0-1 and written R rows later; a slot outside the band of its row
// reads as +inf.  Nothing per row touches shared memory or needs a
// __syncwarp.  The scan reassociates additions along a row, so the kernel
// differs from the cell-by-cell twin by rounding only: about
// 2 (la + lb) 2^-24 relative.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"

namespace {

using namespace apd_strip;

constexpr unsigned kFull = 0xffffffffu;

template <int R, int D4, int CW>
__global__ void __launch_bounds__(128) tile_stripe_kernel(
    const float4* __restrict__ x,        // [K, S, nc4]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int nc4, int ti, int rows, int band, int wv, int auto_widen, int metric,
    int warp_floats) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float4* a_s = smem4 + (size_t)warp * (warp_floats / 4);                // [R][nc4]
  float* bnd = reinterpret_cast<float*>(a_s + R * nc4);                  // [2*wv+1]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * warps + warp;
  if (c >= ti) return;                                                   // warp-uniform
  const int arow = ti_idx[u] * ti + r;
  const int bseq = tj_idx[u] * ti + c;
  const int la = lengths[arow];
  const int lb = lengths[bseq];
  float* o = out + ((size_t)u * ti + r) * ti + c;
  const int diff = la > lb ? la - lb : lb - la;
  const int pw = (auto_widen && diff > band) ? diff : band;
  if (la < 1 || lb < 1 || la > rows || lb > S || pw > wv || diff > pw) {   // warp-uniform
    if (lane == 0) *o = CUDART_INF_F;
    return;
  }
  const float4* xa = x + (size_t)arow * S * nc4;
  const float4* xb = x + (size_t)bseq * S * nc4;

  StripA<R, D4> a;
  for (int i0 = 0; i0 < la; i0 += R) {
    // The last strip's readers of a_s and writers of the boundary row are
    // done; stage this strip's A frames (rows past la zero).
    __syncwarp();
    for (int t = lane; t < R * nc4; t += 32) {
      const int k = t / nc4;
      a_s[t] = i0 + k < la ? xa[(size_t)(i0 + k) * nc4 + (t - k * nc4)]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    a.load(a_s, nc4);
    const bool last = i0 + R >= la;
    const int kn = la - i0 < R ? la - i0 : R;    // live rows of the strip
    int lo[R], hi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + k;
      lo[k] = i - pw > 0 ? i - pw : 0;
      hi[k] = i + pw < lb - 1 ? i + pw : lb - 1;
    }
    // The band of row i0-1, held in the boundary row at slot j + sb.
    const int ulo = i0 > 0 ? (i0 - 1 - pw > 0 ? i0 - 1 - pw : 0) : 1;
    const int uhi = i0 > 0 ? (i0 - 1 + pw < lb - 1 ? i0 - 1 + pw : lb - 1) : 0;
    const int sb = pw - i0 + 1;
    const int w_lo = i0 - pw > 0 ? i0 - pw : 0;
    const int w_hi = i0 + R - 1 + pw < lb - 1 ? i0 + R - 1 + pw : lb - 1;
    // carry[k] = D[i0+k, p0-1], the row's value left of the panel: +inf left
    // of the window (outside every strip row's band, or column -1).
    float carry[R];
#pragma unroll
    for (int k = 0; k < R; ++k) carry[k] = CUDART_INF_F;
    for (int p0 = w_lo; p0 <= w_hi;) {
      const int n = w_hi - p0 + 1;
      const int cw = n >= 32 * CW ? CW : (n + 31) >> 5;
      const int j0 = p0 + lane * cw;             // the lane's first column
      // 1. Costs of the strip rows at the lane's columns.
      float cst[R][CW];
#pragma unroll
      for (int t = 0; t < CW; ++t) {
        const int j = j0 + t;
        bool any = false;
#pragma unroll
        for (int k = 0; k < R; ++k) any |= (j >= lo[k]) & (j <= hi[k]) & (k < kn);
        float acc[R];
        if (t < cw && any) {
          strip_sums<R, D4>(acc, a, xb + (size_t)j * nc4, metric);
        } else {
#pragma unroll
          for (int k = 0; k < R; ++k) acc[k] = 0.f;
        }
#pragma unroll
        for (int k = 0; k < R; ++k)
          cst[k][t] = (t < cw && j >= lo[k] && j <= hi[k] && k < kn) ? cost_of(acc[k], metric)
                                                                     : CUDART_INF_F;
      }
      // 2. Rows.  dv[t]: D[i-1, j0+t] on entry to a row, D[i, j0+t] after.
      float dv[CW];
#pragma unroll
      for (int t = 0; t < CW; ++t) {
        const int j = j0 + t;
        dv[t] = (t < cw && j >= ulo && j <= uhi) ? bnd[j + sb] : CUDART_INF_F;
      }
      // D[i0-1, p0-1]: the virtual start D[-1, -1] = 0 above row 0.
      float dg = i0 == 0 ? (p0 == 0 ? 0.f : CUDART_INF_F)
                         : ((p0 - 1 >= ulo && p0 - 1 <= uhi) ? bnd[p0 - 1 + sb] : CUDART_INF_F);
#pragma unroll
      for (int k = 0; k < R; ++k) {
        if (k >= kn) break;                      // warp-uniform
        float prev_last = dv[0];
#pragma unroll
        for (int t = 1; t < CW; ++t)
          if (t < cw) prev_last = dv[t];
        float dl = __shfl_up_sync(kFull, prev_last, 1);
        if (lane == 0) dl = dg;
        float e[CW];
        float P = 0.f, Q = CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < CW; ++t) {
          if (t < cw) {
            const float diag = t == 0 ? dl : dv[t > 0 ? t - 1 : 0];
            e[t] = cst[k][t] + fminf(diag, dv[t]);
            P += cst[k][t];
            Q = fminf(Q + cst[k][t], e[t]);
          }
        }
        // Inclusive scan of the runs' maps x -> min(x + P, Q), earlier
        // lanes first; the exclusive prefix takes the row's carry.
#pragma unroll
        for (int sh = 1; sh < 32; sh <<= 1) {
          const float Pp = __shfl_up_sync(kFull, P, sh);
          const float Qp = __shfl_up_sync(kFull, Q, sh);
          if (lane >= sh) {
            Q = fminf(Qp + P, Q);
            P = Pp + P;
          }
        }
        const float Pe = __shfl_up_sync(kFull, P, 1);
        const float Qe = __shfl_up_sync(kFull, Q, 1);
        const float old = carry[k];
        float left = lane == 0 ? old : fminf(old + Pe, Qe);
#pragma unroll
        for (int t = 0; t < CW; ++t) {
          if (t < cw) {
            const float v = fminf(e[t], left + cst[k][t]);
            dv[t] = v;
            left = v;
            if (i0 + k == la - 1 && j0 + t == lb - 1) *o = v;   // the corner
          }
        }
        carry[k] = __shfl_sync(kFull, left, 31);   // D[i0+k, p0 + 32*cw - 1]
        dg = old;                                  // the next row's D[i-1, p0-1]
      }
      // 3. The strip's last row into the boundary row, in its band's frame,
      //    R slots behind any slot a later panel reads; every lane's reads
      //    of this panel are done.
      if (!last) {
        __syncwarp();
        const int i = i0 + R - 1;
#pragma unroll
        for (int t = 0; t < CW; ++t) {
          const int j = j0 + t;
          if (t < cw && j >= lo[R - 1] && j <= hi[R - 1]) bnd[j - i + pw] = dv[t];
        }
      }
      p0 += 32 * cw;
    }
  }
}

template <int R, int D4, int CW>
int launch(const float* x, const int* lengths, const int* ti_idx, const int* tj_idx,
           float* out, int S, int nc4, int ti, int U, int rows, int band, int wv,
           int auto_widen, int metric, int warps, void* stream) {
  // Per warp: the strip's A frames, then the boundary row, rounded up to
  // whole float4s.
  const int warp_floats = 4 * R * nc4 + 4 * ((2 * wv + 1 + 3) / 4);
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_stripe_kernel<R, D4, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + warps - 1) / warps));
  tile_stripe_kernel<R, D4, CW><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), lengths, ti_idx, tj_idx, out, S, nc4, ti, rows,
      band, wv, auto_widen, metric, warp_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// Strips of 4 rows and panels of up to 8 columns a lane (4 at 8 float4s a
// frame, whose A frames take 128 registers); ops/dtw_cuda.py:STRIP_ROWS sizes
// the launch.  nc4: float4s per frame; the listed widths keep the strip's A
// frames in registers, any other width reads them from shared memory.
extern "C" int apd_dtw_tile_stripe(
    const float* x, const int* lengths, const int* ti_idx, const int* tj_idx, float* out,
    int S, int nc4, int ti, int U, int rows, int band, int wv, int auto_widen, int metric,
    int warps, void* stream) {
#define APD_K5(D4, CW)                                                                \
  return launch<4, D4, CW>(x, lengths, ti_idx, tj_idx, out, S, nc4, ti, U, rows, band, \
                           wv, auto_widen, metric, warps, stream)
  switch (nc4) {
    case 1: APD_K5(1, 8);
    case 2: APD_K5(2, 8);
    case 4: APD_K5(4, 8);
    case 8: APD_K5(8, 4);
    default: APD_K5(0, 8);
  }
#undef APD_K5
}

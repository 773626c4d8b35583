// K4: widen-banded DTW over tile-pairs in an unsheared stripe frame, written
// by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_lane_kernel
// (entry dtw_tile_lane_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a padded
// corpus (x: the strip layout of dtw_strip.cuh, lengths: [K] i32, pad
// entries length 1) it writes out[u, r, c] = the UNNORMALIZED DTW distance
// of sequence ti_idx[u]*ti + r against sequence tj_idx[u]*ti + c over the
// cells i < la, j < lb, |j - i| <= pw, with the pair's half-width
// pw = max(band, |la - lb|) under auto_widen, else band.  The class frame
// has W = 2*wv+2 slots, wv the class bound (>= band): slot s of row i is
// column j = i + s - (wv+1).  Contracts, each shortfall +inf and never a
// truncated distance: `rows` >= every A length, and wv >= every real pair's
// pw (a pair with pw > wv comes back +inf).  A pair whose corner lies
// outside its own band (auto_widen off, |la - lb| > band) is +inf, as in
// the reference.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations
// and the cells of one pair form a serial chain; no data leaves the SM but
// one float per pair, so the FP32 issue rate bounds it, provided the loads
// keep out of its way.  Built one slot at a time over the whole class
// stripe (the first design), a cell cost d scalar loads of B, d shared loads
// of A and a shared load and store of the stripe, and every pair paid for
// the class's W slots whatever its own band: 2 % of the bound on config 4.
//
// What the design does about it.  K1's strips (dtw_strip.cuh) without the
// shear.  One block per (tile-pair, A row, lane group) and one thread per
// B sequence, so la and the A frames are uniform across the block.  Each
// thread walks its DP in strips of R consecutive rows, column by column;
// row i takes only the columns [max(0, i-pw), min(lb-1, i+pw)] of its own
// band, and +inf elsewhere.  A warp walks the union of its threads' bands:
// the warp's largest pw and lb, reduced once per pair
// (__reduce_max_sync), give the columns [i0 - pw_w, i0+R-1 + pw_w] of a
// strip; tiles are length-sorted, so neighbouring threads' bands nearly
// coincide.  At column j a thread loads B's frame j once as float4s and
// builds the costs of the strip rows whose band holds j.  The strip's A
// frames and the left and diagonal carries sit in registers; only the
// boundary row between strips lives in shared memory ([W][lanes],
// conflict-free), in the class frame: row i0-1 is read once a column (a
// slot outside the thread's band of that row reads as +inf, so stale slots
// never leak in) and row i0+R-1 written back in place R slots behind the
// reads.  Each cost is the first design's fmaf chain over channels
// 0..d-1 (the zero channels of the layout add fmaf(0, 0, acc) = acc) and
// each cell cost + min(min(diag, up), left), so the result is bitwise the
// first design's.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"

namespace {

using namespace apd_strip;

// At one float4 a frame ptxas left to itself spills a register at 72; asking
// for 4 resident blocks gives it 80 and no spill (phase 1 of chip_smoke.py).
template <int R, int D4>
__global__ void __launch_bounds__(128, D4 == 1 ? 4 : 1) lane_kernel(
    const float4* __restrict__ x,        // [nT, S, ti, nc4]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int nc4, int ti, int rows, int band, int wv, int auto_widen, int metric) {
  extern __shared__ float4 smem4[];
  const int lanes = blockDim.x;
  const int off = wv + 1;
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
  // own band, the pair is +inf; its thread walks no cell but still takes
  // part in staging.
  const bool ok = active && lb >= 1 && lb <= S && pw <= wv && diff <= pw;

  // The warp's union of bands: its largest half-width and last column.
  const int wbase = threadIdx.x & ~31;
  const int nw = lanes - wbase < 32 ? lanes - wbase : 32;
  const unsigned mask = nw == 32 ? 0xffffffffu : (1u << nw) - 1u;
  const int pw_w = __reduce_max_sync(mask, ok ? pw : 0);
  const int jmax_w = __reduce_max_sync(mask, ok ? lb - 1 : -1);

  const size_t fstride = (size_t)ti * nc4;       // float4s from frame j to j+1
  const float4* xa = x + (size_t)tile_i * S * fstride + (size_t)r * nc4;
  const float4* xb = x + (size_t)tile_j * S * fstride + (size_t)(active ? c : 0) * nc4;

  StripA<R, D4> a;
  float result = CUDART_INF_F;
  for (int i0 = 0; i0 < la; i0 += R) {
    __syncthreads();                             // the last strip is done with a_s
    stage_strip<R>(a_s, xa, fstride, i0, la, nc4);
    __syncthreads();
    a.load(a_s, nc4);
    const bool last = i0 + R >= la;
    // Per strip row, the columns [lo, hi] of its band; empty past la and
    // for a pair out of contract.
    int lo[R], hi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + k;
      const bool live = ok && i < la;
      lo[k] = live ? (i - pw > 0 ? i - pw : 0) : 1;
      hi[k] = live ? (i + pw < lb - 1 ? i + pw : lb - 1) : 0;
    }
    // The band of row i0-1 (empty above row 0), whose values the boundary
    // row holds at slot j + sb.
    const int ulo = (ok && i0 > 0) ? (i0 - 1 - pw > 0 ? i0 - 1 - pw : 0) : 1;
    const int uhi = (ok && i0 > 0) ? (i0 - 1 + pw < lb - 1 ? i0 - 1 + pw : lb - 1) : 0;
    const int sb = off - i0 + 1;
    const int j_lo = i0 - pw_w > 0 ? i0 - pw_w : 0;
    const int j_hi = i0 + R - 1 + pw_w < jmax_w ? i0 + R - 1 + pw_w : jmax_w;
    // left[k] = D[i0+k, j-1]; bdiag = D[i0-1, j-1], the virtual start
    // D[-1, -1] = 0 above row 0 (j_lo is then 0).
    float left[R];
#pragma unroll
    for (int k = 0; k < R; ++k) left[k] = CUDART_INF_F;
    float bdiag = i0 == 0 ? 0.f
                          : ((j_lo - 1 >= ulo && j_lo - 1 <= uhi) ? stripe[(j_lo - 1 + sb) * lanes]
                                                                : CUDART_INF_F);
    for (int j = j_lo; j <= j_hi; ++j) {
      const float up0 = (j >= ulo && j <= uhi) ? stripe[(j + sb) * lanes] : CUDART_INF_F;
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
        const float cost = (j >= lo[k] && j <= hi[k]) ? cost_of(acc[k], metric) : CUDART_INF_F;
        const float v = cost + fminf(fminf(diag, up), left[k]);
        diag = left[k];
        left[k] = v;
        up = v;
      }
      if (!last) {
        // Row i0+R-1 at its class slot, R slots behind this column's read.
        const int sw = j - (i0 + R - 1) + off;
        if (sw >= 0) stripe[sw * lanes] = up;
      } else if (j == lb - 1) {
#pragma unroll
        for (int k = 0; k < R; ++k)
          if (i0 + k == la - 1) result = left[k];
      }
    }
  }
  if (active) *o = ok ? result : CUDART_INF_F;
}

template <int R, int D4>
int launch(const float* x, const int* lengths, const int* ti_idx, const int* tj_idx,
           float* out, int S, int nc4, int ti, int U, int rows, int band, int wv,
           int auto_widen, int metric, int lanes, void* stream) {
  const int W = 2 * wv + 2;
  const size_t smem = (size_t)R * nc4 * sizeof(float4) + (size_t)W * lanes * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_kernel<R, D4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + lanes - 1) / lanes));
  lane_kernel<R, D4><<<grid, lanes, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), lengths, ti_idx, tj_idx, out, S, nc4, ti, rows,
      band, wv, auto_widen, metric);
  return (int)cudaGetLastError();
}

}  // namespace

// Strips of 4 rows (ops/dtw_cuda.py:STRIP_ROWS sizes the launch for them).
// nc4: float4s per frame; the listed widths keep the strip's A frames in
// registers, any other width reads them from shared memory.
extern "C" int apd_dtw_lane(
    const float* x, const int* lengths, const int* ti_idx, const int* tj_idx, float* out,
    int S, int nc4, int ti, int U, int rows, int band, int wv, int auto_widen, int metric,
    int lanes, void* stream) {
#define APD_K4(D4)                                                                 \
  return launch<4, D4>(x, lengths, ti_idx, tj_idx, out, S, nc4, ti, U, rows, band, \
                       wv, auto_widen, metric, lanes, stream)
  switch (nc4) {
    case 1: APD_K4(1);
    case 2: APD_K4(2);
    case 4: APD_K4(4);
    case 8: APD_K4(8);
    default: APD_K4(0);
  }
#undef APD_K4
}

// K3: exact unbanded DTW over tile-pairs with full-width DP rows (long
// sequences, 256 < S <= 4096), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_lane_full_kernel
// (entry dtw_tile_lane_full_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a padded
// corpus (x: the frame layout [K, S, 4*nc4] f32 of ops/dtw_cuda.py:frame_layout,
// lengths: [K] i32, pad entries length 1) it writes out[u, r, c] = the
// UNNORMALIZED, unbanded DTW distance of sequence ti_idx[u]*ti + r against
// sequence tj_idx[u]*ti + c (oracle/dtw.py).  Two class contracts, each
// shortfall +inf and never a truncated distance: `width` W (a multiple of 8,
// <= S) must cover every real lb, and `rows` every real la.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations
// and no data leaves the SM but one float per pair, so the FP32 issue rate
// bounds it, provided the loads and the per-row overhead keep out of its
// way.  The first design (a warp per pair with a min-plus row scan) spent
// per DP row a cost row written to and read back from shared memory, two
// walks of the lane's chunk, a 5-step __shfl_up_sync scan (10 shuffles in a
// dependent chain) and six shared-memory accesses a cell: 6.9 % of the
// bound at S=1024.
//
// What the design does about it.  One warp per pair, a block of `warps`
// warps per (tile-pair, A row), so the block's pairs share their A sequence
// and la; the systolic walk of dtw_systolic.cuh over passes of 32R rows:
// each pass's A frames are staged once per block in shared memory, lane l
// keeps its R rows in registers, and each step costs one B frame load
// (32 neighbouring frames a warp), R cost builds, R cells of
// cost + min(diag, up, left) in registers and one shuffle.  The pass
// boundary, row i0+32R-1, sits per warp in shared memory ([W] floats),
// written by lane 31 in place 31 columns behind lane 0's reads.  A pair
// that breaks a contract skips the walk (warp-uniform) but keeps to the
// block's barriers.  Each cell adds in the plain twin's order, so kernel
// and twin differ only in each cost's rounding (the order of the d-term
// sum, the sqrt).  A pass is c + 31 steps for c = lb columns, so the
// pipeline's fill and drain cost 31 / (lb + 31) of the steps.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"
#include "dtw_systolic.cuh"

namespace {

using namespace apd_strip;

template <int R, int D4>
__global__ void __launch_bounds__(256) lane_full_kernel(
    const float4* __restrict__ x,        // [K, S, nc4]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int nc4, int ti, int rows, int W, int metric) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float4* a_s = smem4;                                                   // [32R][nc4]
  float* bnd = reinterpret_cast<float*>(a_s + 32 * R * nc4) + (size_t)warp * W;   // [W]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * warps + warp;
  const int arow = ti_idx[u] * ti + r;
  const int la = lengths[arow];
  const int lb = c < ti ? lengths[tj_idx[u] * ti + c] : 0;
  const bool live = c < ti && la >= 1 && la <= rows && lb >= 1 && lb <= W;   // warp-uniform
  float* o = out + ((size_t)u * ti + r) * ti + c;
  if (c < ti && !live && lane == 0) *o = CUDART_INF_F;
  if (la < 1 || la > rows) return;                                       // block-uniform
  const float4* xa = x + (size_t)arow * S * nc4;
  const float4* xb = x + (size_t)(tj_idx[u] * ti + (c < ti ? c : 0)) * S * nc4;

  StripA<R, D4> a;
  float left[R];
  for (int i0 = 0; i0 < la; i0 += 32 * R) {
    __syncthreads();                             // the last pass is done with a_s
    stage_strip<32 * R>(a_s, xa, nc4, i0, la, nc4);
    __syncthreads();
    if (!live) continue;
    a.load(a_s + lane * R * nc4, nc4);
    // Rows past la see zero frames and never reach a live row: no checks.
    const int none[R] = {};
    const bool next = i0 + 32 * R < la;
    const apd_systolic::Boundary bd{bnd, i0 > 0 ? 0 : 1, i0 > 0 ? lb - 1 : 0, 0,
                                    next ? 0 : 1, next ? lb - 1 : 0, 0};
    apd_systolic::pass<R, D4, false>(a, xb, nc4, metric, 0, lb - 1, none, none,
                                     i0 == 0 ? 0.f : CUDART_INF_F, bd, left);
    const int corner = la - 1 - i0;              // the corner's row, in the last pass
    if (!next && lane == corner / R) *o = apd_systolic::pick(left, corner % R);
  }
}

template <int R, int D4>
int launch(const float* x, const int* lengths, const int* ti_idx, const int* tj_idx,
           float* out, int S, int nc4, int ti, int U, int rows, int W, int metric, int warps,
           void* stream) {
  const size_t smem = (size_t)32 * R * nc4 * sizeof(float4) + (size_t)warps * W * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lane_full_kernel<R, D4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + warps - 1) / warps));
  lane_full_kernel<R, D4><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), lengths, ti_idx, tj_idx, out, S, nc4, ti, rows, W,
      metric);
  return (int)cudaGetLastError();
}

}  // namespace

// R rows a lane (ops/dtw_cuda.py:_systolic_rows): 4, or 2 at 8 float4s a
// frame, whose 4 rows would take 128 registers of A frames.  nc4: float4s
// per frame; the listed widths keep a lane's A frames in registers, any
// other width reads them from shared memory.
extern "C" int apd_dtw_lane_full(
    const float* x, const int* lengths, const int* ti_idx, const int* tj_idx, float* out,
    int S, int nc4, int ti, int U, int rows, int W, int metric, int warps, void* stream) {
#define APD_K3(RR, D4)                                                                    \
  return launch<RR, D4>(x, lengths, ti_idx, tj_idx, out, S, nc4, ti, U, rows, W, metric, \
                        warps, stream)
  switch (nc4) {
    case 8: APD_K3(2, 8);
    case 1: APD_K3(4, 1);
    case 2: APD_K3(4, 2);
    case 4: APD_K3(4, 4);
    default: APD_K3(4, 0);
  }
#undef APD_K3
}

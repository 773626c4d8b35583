// K7: per-pair widen-banded DTW over gathered pairs (long buckets,
// S <= 4096), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_stripe_kernel
// (entry _dtw_batch_stripe).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For B gathered pairs (xa [B, Ra, 4*nc4] and
// xb [B, S, 4*nc4] f32, one pair's frames consecutive, channels past d zero;
// len_a, len_b: [B] i32) it writes out[p] = the UNNORMALIZED DTW distance of
// pair p over the cells i < la, j < lb, |j - i| <= pw, pw = max(band,
// |la - lb|) under auto_widen, else band.  The class half-width is
// wv = max(band, max_len_diff) under auto_widen (else band).  The
// max_len_diff contract: a pair with pw > wv comes back +inf, never a
// truncated distance; so does a pair with la > Ra or its corner outside
// its own band.  The wrapper divides by la + lb for path_len normalization.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations
// and a pair's cells form one dependent chain per DP row; gathered pairs
// share no frames.  The first design (a thread per pair in one-warp
// blocks, each row walking all 2*wv+2 slots of the class frame, d channel
// loads 2 MB apart per cell) kept 16 of 132 SMs busy at 512 pairs and ran
// at 0.02 % of the bound: latency, with almost no warps to hide it.
//
// What the design does about it.  One warp per pair (a block of `warps`
// warps, one pair each), the systolic walk of dtw_systolic.cuh over passes
// of 32R rows: a pass walks only the columns of its rows' own bands,
// [max(0, i0 - pw), min(lb-1, i_last + pw)], cells outside |j - i| <= pw
// are +inf, and a lane is busy in 2pw + R of the pass's 32R + 2pw + 31
// steps.  R = 2: at the per-pair route's classes (a hard band 16, widen
// 63-255) and launch sizes (512-8,192 pairs) one row a lane was slower,
// but for 3 % at band 16 and 8,192 pairs (PERF.md).  The pass's A frames
// are staged per warp in shared memory and held per lane in registers;
// B's frames at one step are 32
// neighbouring frames of the pair.  The pass boundary, row i0+32R-1, sits
// per warp in shared memory in its band's frame (slot j - i + pw, 2*wv+1
// slots), rewritten in place 32R + 31 steps behind the reads of its slots.
// Each cost is the same fmaf chain over channels 0..d-1, and each cell
// cost + min(min(diag, up), left), as in the first design: the distances
// are bitwise equal to it.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"
#include "dtw_systolic.cuh"

namespace {

using namespace apd_strip;

// At least 4 blocks an SM (16 warps): without the bound ptxas keeps the
// small instantiations under 56 registers by spilling to the stack.
template <int R, int D4>
__global__ void __launch_bounds__(128, D4 == 8 ? 1 : 4) stripe_kernel(
    const float4* __restrict__ xa,       // [B, Ra, nc4]
    const float4* __restrict__ xb,       // [B, S, nc4]
    const int* __restrict__ len_a,       // [B]
    const int* __restrict__ len_b,       // [B]
    float* __restrict__ out,             // [B]
    int n_pairs, int Ra, int S, int nc4, int band, int wv, int auto_widen, int metric,
    int warp_floats) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* a_s = smem4 + (size_t)warp * (warp_floats / 4);               // [32R][nc4]
  float* bnd = reinterpret_cast<float*>(a_s + 32 * R * nc4);            // [2*wv+1]

  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= n_pairs) return;                      // warp-uniform; no block barrier below
  const int la = len_a[p];
  const int lb = len_b[p];
  const int diff = la > lb ? la - lb : lb - la;
  const int pw = (auto_widen && diff > band) ? diff : band;
  if (la < 1 || lb < 1 || la > Ra || lb > S || pw > wv || diff > pw) {   // warp-uniform
    if (lane == 0) out[p] = CUDART_INF_F;
    return;
  }
  const float4* pa = xa + (size_t)p * Ra * nc4;
  const float4* pb = xb + (size_t)p * S * nc4;

  StripA<R, D4> a;
  float left[R];
  for (int i0 = 0; i0 < la; i0 += 32 * R) {
    // The last pass's readers of a_s and of the boundary row are done.
    __syncwarp();
    for (int t = lane; t < 32 * R * nc4; t += 32) {
      const int k = t / nc4;
      a_s[t] = i0 + k < la ? pa[(size_t)(i0 + k) * nc4 + (t - k * nc4)]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    a.load(a_s + lane * R * nc4, nc4);
    int lo[R], hi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + lane * R + k;
      lo[k] = i < la ? (i - pw > 0 ? i - pw : 0) : 1;
      hi[k] = i < la ? (i + pw < lb - 1 ? i + pw : lb - 1) : 0;
    }
    const int i_last = i0 + 32 * R - 1 < la - 1 ? i0 + 32 * R - 1 : la - 1;
    const int c_lo = i0 - pw > 0 ? i0 - pw : 0;
    const int c_hi = i_last + pw < lb - 1 ? i_last + pw : lb - 1;   // lb-1 in the last pass
    // Row i0-1's band, read at slot j - (i0-1) + pw; the virtual row -1 is
    // +inf but for D[-1, -1] = 0, lane 0's first diagonal.  Row i0+32R-1's
    // band, written at slot j - (i0+32R-1) + pw where another pass follows.
    const bool next = i0 + 32 * R < la;
    const int ib = i0 + 32 * R - 1;
    const apd_systolic::Boundary bd{
        bnd,
        i0 > 0 ? (i0 - 1 - pw > 0 ? i0 - 1 - pw : 0) : 1,
        i0 > 0 ? (i0 - 1 + pw < lb - 1 ? i0 - 1 + pw : lb - 1) : 0,
        pw - i0 + 1,
        next ? (ib - pw > 0 ? ib - pw : 0) : 1,
        next ? (ib + pw < lb - 1 ? ib + pw : lb - 1) : 0,
        pw - ib};
    apd_systolic::pass<R, D4, true>(a, pb, nc4, metric, c_lo, c_hi, lo, hi,
                                    i0 == 0 ? 0.f : bd.read(c_lo - 1), bd, left);
    const int corner = la - 1 - i0;              // the corner's row, in the last pass
    if (!next && lane == corner / R) out[p] = apd_systolic::pick(left, corner % R);
  }
}

template <int R, int D4>
int launch(const float* xa, const float* xb, const int* len_a, const int* len_b, float* out,
           int n_pairs, int Ra, int S, int nc4, int band, int wv, int auto_widen, int metric,
           int warps, void* stream) {
  // Per warp: the pass's A frames, then the boundary row, rounded up to
  // whole float4s.
  const int warp_floats = 4 * 32 * R * nc4 + 4 * ((2 * wv + 1 + 3) / 4);
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      stripe_kernel<R, D4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_pairs + warps - 1) / warps);
  stripe_kernel<R, D4><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(xa), reinterpret_cast<const float4*>(xb), len_a, len_b,
      out, n_pairs, Ra, S, nc4, band, wv, auto_widen, metric, warp_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// 2 rows a lane (ops/dtw_cuda.py:STRIPE_LANE_ROWS).  nc4: float4s per
// frame; the listed widths keep a lane's A frames in registers, any other
// width reads them from shared memory.
extern "C" int apd_dtw_stripe(
    const float* xa, const float* xb, const int* len_a, const int* len_b, float* out,
    int n_pairs, int Ra, int S, int nc4, int band, int wv, int auto_widen, int metric,
    int warps, void* stream) {
#define APD_K7(D4)                                                                        \
  return launch<2, D4>(xa, xb, len_a, len_b, out, n_pairs, Ra, S, nc4, band, wv,         \
                       auto_widen, metric, warps, stream)
  switch (nc4) {
    case 1: APD_K7(1);
    case 2: APD_K7(2);
    case 4: APD_K7(4);
    case 8: APD_K7(8);
    default: APD_K7(0);
  }
#undef APD_K7
}

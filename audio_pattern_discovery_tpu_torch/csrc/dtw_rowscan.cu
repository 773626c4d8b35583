// K6: per-pair DTW over gathered pairs, unbanded or banded (widen or hard),
// with full rows (S <= 1024), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_rowscan_kernel
// (entry dtw_batch_pallas).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For B gathered pairs (xa [B, Ra, 4*nc4] and
// xb [B, S, 4*nc4] f32, one pair's frames consecutive, channels past d zero,
// shorter side first; len_a, len_b: [B] i32) it writes out[p] = the
// UNNORMALIZED DTW distance of pair p over the cells i < la, j < lb,
// |j - i| <= pw: pw = S unbanded (band < 0), max(band, |la - lb|) under
// auto_widen, else band.  There is no class bound: pw may reach S.  A pair
// with la > Ra, an empty side, lb > S or its corner outside its band comes
// back +inf.  The wrapper divides by la + lb for path_len normalization, as
// the reference's wrapper does.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations,
// a pair's cells one dependent chain per DP row, and gathered pairs share no
// frames: at the route's shapes (S=128, widen band 16) the bound is the
// gathered pairs' bytes, read once, and the operations of the cells inside
// each band close behind.  The first design (a warp per pair and per DP row
// a cost row in shared memory, two walks of each lane's chunk and a 5-step
// __shfl_up_sync min-plus scan between them) spent some 200-330 warp
// instructions a row on its bookkeeping and ran at 3.2 % of the bound.
//
// What the design does about it.  The systolic walk of dtw_systolic.cuh
// (K3's and K7's) with a lane group of G lanes per pair, 32/G pairs a warp:
// lane l holds R rows of a pass of G*R rows and computes column j at step
// j + l, one B frame load, R cost builds, R cells in registers and one
// shuffle a step.  A pass walks only its rows' band,
// [max(0, i0 - pw), min(lb-1, i_last + pw)], so a lane is busy in about
// 2pw + R of the pass's G*R + 2pw + G - 1 steps: with pw = 16-64 a warp-wide
// group idles three quarters of its steps, and narrower groups (more pairs
// a warp) cut the idle share where the band is narrow
// (ops/dtw_cuda.py:_rowscan_geometry picks G and R per class).  The groups
// of a warp step together to the longest window among them; the per-pair
// route's blocks hold neighbouring pairs of one shorter sequence, so their
// windows nearly agree.  Each group's pass boundary row sits in shared
// memory in absolute columns ([S] floats: pw has no class bound), rewritten
// in place G-1 steps behind its reads.  Each cell is cost + min(min(diag,
// up), left) in the twin's order, the costs from apd_systolic::cost_of.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"
#include "dtw_systolic.cuh"

namespace {

using namespace apd_strip;

// At least 4 blocks an SM where a lane's A frames take under 64 registers:
// without the bound ptxas keeps the small instantiations under 56 registers
// by spilling to the stack (as for K7).
template <int G, int R, int D4, bool kBand>
__global__ void __launch_bounds__(128, R * D4 >= 16 ? 1 : 4) rowscan_kernel(
    const float4* __restrict__ xa,       // [B, Ra, nc4]
    const float4* __restrict__ xb,       // [B, S, nc4]
    const int* __restrict__ len_a,       // [B]
    const int* __restrict__ len_b,       // [B]
    float* __restrict__ out,             // [B]
    int n_pairs, int Ra, int S, int nc4, int band, int auto_widen, int metric,
    int warp_floats) {
  constexpr int kGroups = 32 / G;
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);                 // the lane in its group
  const int grp = lane / G;
  const int warp_id = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (warp_id * kGroups >= n_pairs) return;      // warp-uniform; no block barrier below
  float4* w_s = smem4 + (size_t)(threadIdx.x >> 5) * (warp_floats / 4);
  float4* a_s = w_s + grp * G * R * nc4;                                      // [G*R][nc4]
  float* bnd = reinterpret_cast<float*>(w_s + 32 * R * nc4) + grp * S;        // [S]

  const int p = warp_id * kGroups + grp;
  int la = 0, lb = 0, pw = S;
  bool live = false;
  if (p < n_pairs) {
    la = len_a[p];
    lb = len_b[p];
    const int diff = la > lb ? la - lb : lb - la;
    if constexpr (kBand) pw = (auto_widen && diff > band) ? diff : band;
    live = la >= 1 && lb >= 1 && la <= Ra && lb <= S && diff <= pw;
    if (!live && gl == 0) out[p] = CUDART_INF_F;
  }
  // Passes of this group, and of the warp (group-uniform, then warp-uniform).
  const int passes = live ? (la + G * R - 1) / (G * R) : 0;
  int n_pass = passes;
  if constexpr (kGroups > 1) n_pass = __reduce_max_sync(apd_systolic::kFull, passes);
  const float4* pa = xa + (size_t)(live ? p : 0) * Ra * nc4;
  const float4* pb = xb + (size_t)(live ? p : 0) * S * nc4;

  StripA<R, D4> a;
  float left[R];
  for (int q = 0; q < n_pass; ++q) {
    const int i0 = q * G * R;
    const bool act = q < passes;                 // the group has rows in this pass
    // The last pass's readers of a_s and of the boundary row are done.
    __syncwarp();
    for (int t = gl; t < G * R * nc4; t += G) {
      const int k = t / nc4;
      a_s[t] = act && i0 + k < la ? pa[(size_t)(i0 + k) * nc4 + (t - k * nc4)]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    a.load(a_s + gl * R * nc4, nc4);
    int lo[R], hi[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      const int i = i0 + gl * R + k;
      lo[k] = i < la ? (i - pw > 0 ? i - pw : 0) : 1;
      hi[k] = i < la ? (i + pw < lb - 1 ? i + pw : lb - 1) : 0;
    }
    // The pass's window (empty for a group without rows in it); unbanded,
    // pw = S makes it every column of B.
    const int i_last = i0 + G * R - 1 < la - 1 ? i0 + G * R - 1 : la - 1;
    const int c_lo = act ? (i0 - pw > 0 ? i0 - pw : 0) : 1;
    const int c_hi = act ? (i_last + pw < lb - 1 ? i_last + pw : lb - 1) : 0;
    // Row i0-1's band, read at column j; the virtual row -1 is +inf but for
    // D[-1, -1] = 0, lane 0's first diagonal.  Row i0+G*R-1's band, written
    // at column j where another pass follows.
    const bool next = act && i0 + G * R < la;
    const int ib = i0 + G * R - 1;
    const apd_systolic::Boundary bd{
        bnd,
        i0 > 0 ? (i0 - 1 - pw > 0 ? i0 - 1 - pw : 0) : 1,
        i0 > 0 ? (i0 - 1 + pw < lb - 1 ? i0 - 1 + pw : lb - 1) : 0,
        0,
        next ? (ib - pw > 0 ? ib - pw : 0) : 1,
        next ? (ib + pw < lb - 1 ? ib + pw : lb - 1) : 0,
        0};
    apd_systolic::pass<R, D4, kBand, G>(a, pb, nc4, metric, c_lo, c_hi, lo, hi,
                                        i0 == 0 ? 0.f : bd.read(c_lo - 1), bd, left);
    const int corner = la - 1 - i0;              // the corner's row, in the last pass
    if (act && !next && gl == corner / R) out[p] = apd_systolic::pick(left, corner % R);
  }
}

template <int G, int R, int D4, bool kBand>
int launch(const float* xa, const float* xb, const int* len_a, const int* len_b, float* out,
           int n_pairs, int Ra, int S, int nc4, int band, int auto_widen, int metric, int warps,
           void* stream) {
  // Per warp: the pass's A frames of its 32/G groups, then a boundary row of
  // S floats a group, rounded up to whole float4s.
  const int warp_floats = 4 * 32 * R * nc4 + 4 * ((32 / G * S + 3) / 4);
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(rowscan_kernel<G, R, D4, kBand>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = warps * (32 / G);
  const unsigned grid = (unsigned)((n_pairs + per_block - 1) / per_block);
  rowscan_kernel<G, R, D4, kBand><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(xa), reinterpret_cast<const float4*>(xb), len_a, len_b,
      out, n_pairs, Ra, S, nc4, band, auto_widen, metric, warp_floats);
  return (int)cudaGetLastError();
}

// Frame widths (float4s) at which a lane's A frames sit in registers; 0
// stands for any other width (read from shared memory).
constexpr int width_of(int nc4) { return nc4 == 1 || nc4 == 2 || nc4 == 4 || nc4 == 8 ? nc4 : 0; }

// Sets of built widths: bit D4 for width D4.
constexpr unsigned kAllWidths = 1u | 1u << 1 | 1u << 2 | 1u << 4 | 1u << 8;
constexpr unsigned kOnly8 = 1u << 8;
constexpr unsigned kNot8 = kAllWidths & ~kOnly8;

template <int G, int R, bool kBand, unsigned kWidths>
int by_width(int w, const float* xa, const float* xb, const int* len_a, const int* len_b,
             float* out, int n_pairs, int Ra, int S, int nc4, int band, int auto_widen,
             int metric, int warps, void* stream) {
#define APD_K6(D4)                                                                           \
  if constexpr ((kWidths >> D4) & 1u) {                                                      \
    if (w == D4)                                                                             \
      return launch<G, R, D4, kBand>(xa, xb, len_a, len_b, out, n_pairs, Ra, S, nc4, band,  \
                                     auto_widen, metric, warps, stream);                     \
  }
  APD_K6(1)
  APD_K6(2)
  APD_K6(4)
  APD_K6(8)
  APD_K6(0)
#undef APD_K6
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// G lanes a pair and R rows a lane as ops/dtw_cuda.py:_rowscan_geometry
// picks them (measured on the H100 at the per-pair route's classes and
// launch sizes, PERF.md), band < 0 unbanded; only those geometries are
// built.  nc4: float4s per frame; the listed widths keep a lane's A frames
// in registers, any other width reads them from shared memory.  Returns
// cudaErrorInvalidValue for a geometry that is not built.
extern "C" int apd_dtw_rowscan(
    const float* xa, const float* xb, const int* len_a, const int* len_b, float* out,
    int n_pairs, int Ra, int S, int nc4, int band, int auto_widen, int metric, int warps,
    int G, int R, void* stream) {
  const int w = width_of(nc4);
#define APD_K6_GEOMETRY(GG, RR, BAND, WIDTHS)                                                \
  if (G == GG && R == RR && (band >= 0) == BAND && ((WIDTHS >> w) & 1u))                     \
    return by_width<GG, RR, BAND, WIDTHS>(w, xa, xb, len_a, len_b, out, n_pairs, Ra, S, nc4, \
                                          band, auto_widen, metric, warps, stream);
  // Banded: 8 lanes a pair up to S=128, 16 up to 256, else 32; 2 rows a lane.
  APD_K6_GEOMETRY(8, 2, true, kAllWidths)
  APD_K6_GEOMETRY(16, 2, true, kAllWidths)
  APD_K6_GEOMETRY(32, 2, true, kAllWidths)
  // Unbanded: 8 lanes a pair up to S=256, else 32; 4 rows a lane, but 2 at 8
  // float4s a frame, whose 4 rows would take 128 registers of A frames.
  APD_K6_GEOMETRY(8, 4, false, kNot8)
  APD_K6_GEOMETRY(8, 2, false, kOnly8)
  APD_K6_GEOMETRY(32, 4, false, kNot8)
  APD_K6_GEOMETRY(32, 2, false, kOnly8)
#undef APD_K6_GEOMETRY
  return (int)cudaErrorInvalidValue;
}

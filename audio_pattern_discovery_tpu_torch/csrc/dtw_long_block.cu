// K8: blocked long-sequence DTW, one block anti-diagonal a launch, written
// by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_long.py:dtw_block_kernel in
// dtw_long_batch (an XLA scan over block diagonals, no Pallas kernel).  Plain
// twin and wrapper: audio_pattern_discovery_tpu_torch/ops/dtw_long.py.
//
// What it computes.  For B pairs of padded sequences (xa, xb [B, S, 4*nc4]
// f32, the frame layout of ops/dtw_cuda.py:frame_layout; len_a, len_b [B]
// i32) the DP grid of each pair is cut into nB x nB blocks of BLK x BLK
// cells (S = nB * BLK).  Block (I, J) needs only D[row0-1, col0..] (the
// bottom row of block (I-1, J)), D[row0.., col0-1] (the right column of
// block (I, J-1)) and the corner D[row0-1, col0-1], so every block of one
// block anti-diagonal k = I + J is independent: one launch computes them
// all, for every pair.  Boundaries live in device memory:
//   H [B, nJ, BLK]: the bottom row of the latest block of each block column
//     J0 <= J < J0 + nJ, read as block (I, J)'s top and rewritten with its
//     bottom row;
//   V [B, nB, BLK]: the right column of the latest block of each block row,
//     read as block (I, J)'s left column and rewritten with its right one;
//   C [2, B, nJ + 1]: corners by the parity of k.  Block (I, J) reads its
//     corner from C[(k-1)&1][b][J-J0] and writes its top's last value, the
//     corner of block (I, J+1) on the next diagonal, to C[k&1][b][J-J0+1].
//     H[b, J-1] cannot serve: block (I, J-1) rewrote it one diagonal back.
// Block (I, J) touches only H[b, J], V[b, I] and its two corner slots, and
// I + J = k fixes one from the other, so no two blocks of a launch share a
// boundary.  Every entry of H, V and C is written before it is read.  The
// block holding (la-1, lb-1) writes out[b] (unnormalized; +inf where that
// cell is outside the band); out starts at +inf, so a pair with an empty
// side or a side past S stays +inf.  Cells outside i < la, j < lb and the
// band are +inf: unbanded (mode 0), widen |i - j| <= pw with pw =
// max(band, |la - lb|) under auto_widen (mode 1), or the diag corridor
// |j(la-1) - i(lb-1)| <= max(band, 1) max(la-1, lb-1) (mode 2) in 64-bit
// products, so exact at any length.  The virtual origin D[-1, -1] = 0 is
// the corner of block (0, 0) only; row-0 blocks see a +inf top and
// column-0 blocks a +inf left column.  A launch covers block columns
// [J0, J0 + nJ); `halo` (or null: +inf) holds the right columns of block
// column J0 - 1 [B, nB, BLK], so a stripe of block columns on one device
// can run with its left neighbour's columns as input.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations,
// and a block's cells are one dependent chain along each row and column;
// its boundaries (2 BLK floats in, 2 BLK out per block) are a few percent
// of the bytes of its frames.  The FP32 issue rate bounds it, provided
// enough blocks are in flight: one diagonal offers at most nB blocks a
// pair, and the first and last diagonals one.
//
// What the design does about it.  One warp per active block and pair (a
// CUDA block of `warps` warps, each with its own item), the systolic walk of
// dtw_systolic.cuh over passes of 32R rows of the block: the pass's A frames
// staged per warp in shared memory and held per lane in registers, B's
// frames at one step 32 neighbouring frames; the pass boundary row, BLK
// floats per warp in shared memory, holds the block's top at first and is
// rewritten in place by each pass (absolute columns, offset by col0).  Each
// pass walks only the columns its rows' bands reach inside the block, and
// a pass none of whose cells is in the band writes +inf boundaries without
// walking.  Where the pass starts at the block's first column, each lane's
// `left` comes seeded with its rows of the left column (kSeeded) and lane
// 0's first diagonal is the corner (first pass) or the left column's row
// above; otherwise everything left of the walk is +inf.  Each cell adds
// cost + min(min(diag, up), left) from the costs of apd_systolic::cost_of,
// as the plain twin does cell by cell.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"
#include "dtw_systolic.cuh"

namespace {

using namespace apd_strip;

constexpr int kWiden = 1;
constexpr int kDiag = 2;

// floor(a / b) for b > 0.
__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// Row i's columns [lo, hi] in the pair's grid and band (lo > hi: none).
struct PairBand {
  int la, lb, mode, pw;
  long long den, num, thresh;

  __device__ __forceinline__ void range(int i, int& lo, int& hi) const {
    if (i >= la) {
      lo = 1;
      hi = 0;
      return;
    }
    long long l = 0, h = lb - 1;
    if (mode == kWiden) {
      l = i - pw;
      h = (long long)i + pw;
    } else if (mode == kDiag && den > 0) {
      l = -floor_div(thresh - (long long)i * num, den);
      h = floor_div((long long)i * num + thresh, den);
    }
    lo = (int)(l > 0 ? l : 0);
    hi = (int)(h < lb - 1 ? h : lb - 1);
  }
};

// At least 4 blocks an SM (16 warps), as K7.
template <int R, int D4>
__global__ void __launch_bounds__(128, D4 == 8 ? 1 : 4) long_block_kernel(
    const float4* __restrict__ xa,       // [B, S, nc4]
    const float4* __restrict__ xb,       // [B, S, nc4]
    const int* __restrict__ len_a,       // [B]
    const int* __restrict__ len_b,       // [B]
    float* __restrict__ H,               // [B, nJ, BLK]
    float* __restrict__ V,               // [B, nB, BLK]
    float* __restrict__ C,               // [2, B, nJ + 1]
    const float* __restrict__ halo,      // [B, nB, BLK] or null
    float* __restrict__ out,             // [B]
    int n_pairs, int S, int nc4, int BLK, int nB, int k, int J_lo, int n_act, int J0, int nJ,
    int mode, int band, int auto_widen, int metric, int warp_floats) {
  extern __shared__ float4 smem4[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* a_s = smem4 + (size_t)warp * (warp_floats / 4);               // [32R][nc4]
  float* row = reinterpret_cast<float*>(a_s + 32 * R * nc4);            // [BLK]

  const int item = blockIdx.x * (blockDim.x >> 5) + warp;
  if (item >= n_pairs * n_act) return;           // warp-uniform; no block barrier below
  const int p = item / n_act;
  const int J = J_lo + (item - p * n_act);
  const int I = k - J;
  const int row0 = I * BLK, col0 = J * BLK, c_end = col0 + BLK - 1;
  PairBand pb;
  pb.la = len_a[p];
  pb.lb = len_b[p];
  pb.mode = mode;
  const int diff = pb.la > pb.lb ? pb.la - pb.lb : pb.lb - pb.la;
  pb.pw = (auto_widen && diff > band) ? diff : band;
  pb.den = pb.la - 1;
  pb.num = pb.lb - 1;
  pb.thresh = (long long)(band > 1 ? band : 1) * (pb.den > pb.num ? pb.den : pb.num);

  float* h = H + ((size_t)p * nJ + (J - J0)) * BLK;
  float* v = V + ((size_t)p * nB + I) * BLK;
  const float* vin = J > J0 ? v : (halo != nullptr ? halo + ((size_t)p * nB + I) * BLK : nullptr);
  float* c_next = C + ((size_t)(k & 1) * n_pairs + p) * (nJ + 1);
  const float* c_prev = C + ((size_t)((k + 1) & 1) * n_pairs + p) * (nJ + 1);

  // D[row0-1, col0-1]: the origin at block (0, 0); at the first column of a
  // stripe the halo's row above; else the snapshot of the last diagonal.
  float diag_above;
  if (J > J0) {
    diag_above = c_prev[J - J0];
  } else if (J == 0) {
    diag_above = I == 0 ? 0.f : CUDART_INF_F;
  } else {
    diag_above = (I > 0 && halo != nullptr)
                     ? halo[((size_t)p * nB + I - 1) * BLK + BLK - 1] : CUDART_INF_F;
  }
  // The top into the boundary row; its last value is the corner of block
  // (I, J+1) on the next diagonal.
  int rlo = 1, rhi = 0;                          // the row's known columns
  if (I > 0) {
    for (int c = lane; c < BLK; c += 32) row[c] = h[c];
    rlo = col0;
    rhi = c_end;
  }
  if (lane == 0) c_next[J - J0 + 1] = I > 0 ? h[BLK - 1] : CUDART_INF_F;

  const float4* pa = xa + (size_t)p * S * nc4;
  const float4* pbx = xb + (size_t)p * S * nc4;
  StripA<R, D4> a;
  float left[R];
  for (int i0 = 0; i0 < BLK; i0 += 32 * R) {
    // The last pass's readers of a_s and of the boundary row are done.
    __syncwarp();
    int lo[R], hi[R];
    int mn = INT_MAX, mx = INT_MIN;
    float seed[R];
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int r = i0 + lane * R + q;
      pb.range(row0 + r, lo[q], hi[q]);
      lo[q] = lo[q] > col0 ? lo[q] : col0;
      hi[q] = hi[q] < c_end ? hi[q] : c_end;
      if (lo[q] <= hi[q]) {
        mn = lo[q] < mn ? lo[q] : mn;
        mx = hi[q] > mx ? hi[q] : mx;
      }
      seed[q] = vin != nullptr ? vin[r] : CUDART_INF_F;   // D[row0 + r, col0 - 1]
    }
    // The next pass's lane 0 diagonal on the left column: this pass's last
    // row's seed (the lane's own read, so no lane rewrites it first).
    const float seed_last = __shfl_sync(apd_systolic::kFull, seed[R - 1], 31);
    const int c_lo = __reduce_min_sync(apd_systolic::kFull, mn);
    const int c_hi = __reduce_max_sync(apd_systolic::kFull, mx);
    if (c_lo > c_hi) {                           // no cell of these rows in the band
#pragma unroll
      for (int q = 0; q < R; ++q) v[i0 + lane * R + q] = CUDART_INF_F;
      rlo = 1;
      rhi = 0;
      diag_above = seed_last;
      continue;
    }
    for (int t = lane; t < 32 * R * nc4; t += 32) {
      const int q = t / nc4;
      const int i = row0 + i0 + q;
      a_s[t] = i < pb.la ? pa[(size_t)i * nc4 + (t - q * nc4)] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();
    a.load(a_s + lane * R * nc4, nc4);
    // Started at the block's first column, the walk continues the left
    // column; started further right, every value left of it is +inf.
    const bool seeded = c_lo == col0;
#pragma unroll
    for (int q = 0; q < R; ++q) left[q] = seeded ? seed[q] : CUDART_INF_F;
    const apd_systolic::Boundary bd{row, rlo, rhi, -col0, c_lo, c_hi, -col0};
    const float diag0 = seeded ? diag_above : bd.read(c_lo - 1);
    apd_systolic::pass<R, D4, true, 32, true>(a, pbx, nc4, metric, c_lo, c_hi, lo, hi, diag0,
                                              bd, left);
    rlo = c_lo;
    rhi = c_hi;
    diag_above = seed_last;
#pragma unroll
    for (int q = 0; q < R; ++q) v[i0 + lane * R + q] = c_hi == c_end ? left[q] : CUDART_INF_F;
    // The terminal cell, where this pass holds it: each lane's `left` is its
    // rows at column c_hi, and the cell is in the band only if c_hi reached
    // lb - 1.
    const int corner = pb.la - 1 - row0 - i0;
    if (corner >= 0 && corner < 32 * R && pb.lb - 1 >= col0 && pb.lb - 1 <= c_end &&
        lane == corner / R) {
      out[p] = c_hi == pb.lb - 1 ? apd_systolic::pick(left, corner % R) : CUDART_INF_F;
    }
  }
  // The last pass's bottom row is the block's.
  __syncwarp();
  for (int c = lane; c < BLK; c += 32)
    h[c] = col0 + c >= rlo && col0 + c <= rhi ? row[c] : CUDART_INF_F;
}

template <int R, int D4>
int launch(const float* xa, const float* xb, const int* len_a, const int* len_b, float* H,
           float* V, float* C, const float* halo, float* out, int n_pairs, int S, int nc4,
           int BLK, int nB, int k_begin, int k_end, int J0, int nJ, int mode, int band,
           int auto_widen, int metric, int warps, void* stream) {
  // Per warp: the pass's A frames, then the boundary row, rounded up to
  // whole float4s.
  const int warp_floats = 4 * 32 * R * nc4 + 4 * ((BLK + 3) / 4);
  const size_t smem = (size_t)warps * warp_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      long_block_kernel<R, D4>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int k = k_begin; k < k_end; ++k) {
    // The diagonal's blocks in the launch's block columns.
    const int j_lo = k - (nB - 1) > J0 ? k - (nB - 1) : J0;
    const int j_hi = k < J0 + nJ - 1 ? k : J0 + nJ - 1;
    if (j_hi < j_lo) continue;
    const int n_act = j_hi - j_lo + 1;
    const long long items = (long long)n_pairs * n_act;
    const unsigned grid = (unsigned)((items + warps - 1) / warps);
    long_block_kernel<R, D4><<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(xa), reinterpret_cast<const float4*>(xb), len_a, len_b,
        H, V, C, halo, out, n_pairs, S, nc4, BLK, nB, k, j_lo, n_act, J0, nJ, mode, band,
        auto_widen, metric, warp_floats);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Launches block diagonals k_begin <= k < k_end in order on `stream`, one
// launch each.  R rows a lane (ops/dtw_long.py:_long_rows): 4, or 2 at 8
// float4s a frame, with a pass of 32R rows dividing the block (so 2 at
// BLK = 64 and 1 at 32).  nC4: float4s per frame; at R = 4 the listed
// widths keep a lane's A frames in registers, and blocks of 32 and 64
// frames (off the scheduler's path: its blocks are 256) read them from
// shared memory at any width but 8.
extern "C" int apd_dtw_long_block(
    const float* xa, const float* xb, const int* len_a, const int* len_b, float* H, float* V,
    float* C, const float* halo, float* out, int n_pairs, int S, int nc4, int BLK, int nB,
    int k_begin, int k_end, int J0, int nJ, int mode, int band, int auto_widen, int metric,
    int warps, int R, void* stream) {
#define APD_K8(RR, D4)                                                                     \
  return launch<RR, D4>(xa, xb, len_a, len_b, H, V, C, halo, out, n_pairs, S, nc4, BLK, nB, \
                        k_begin, k_end, J0, nJ, mode, band, auto_widen, metric, warps, stream)
  if (R == 4) {
    switch (nc4) {
      case 1: APD_K8(4, 1);
      case 2: APD_K8(4, 2);
      case 4: APD_K8(4, 4);
      default: APD_K8(4, 0);
    }
  }
  if (R == 2) {
    if (nc4 == 8) APD_K8(2, 8);
    APD_K8(2, 0);
  }
  APD_K8(1, 0);
#undef APD_K8
}

// K5: widen-banded DTW over tile-pairs with one warp per pair, for the wide
// widen classes (the scheduler sends classes of more than 64 stripe slots
// here, narrower ones to K4), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_tile_stripe_kernel
// (entry dtw_tile_stripe_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  K4's function and contracts: for U tile-pairs over a
// padded corpus (a: [K, S, d] f32, lengths: [K] i32, pad entries length 1),
// out[u, r, c] = the UNNORMALIZED DTW distance of sequence ti_idx[u]*ti + r
// against sequence tj_idx[u]*ti + c over the cells i < la, j < lb,
// |j - i| <= pw, pw = max(band, |la - lb|) under auto_widen, else band.
// Contracts, each shortfall +inf and never a truncated distance: `rows` >=
// every A length, wv (the class bound, >= band) >= every real pair's pw.  A
// pair whose corner lies outside its own band is +inf.
//
// What bounds it on the H100.  A wide class stripe (2*wv+2 slots, up to 8194
// at S=4096) does not fit one thread's share of shared memory at 128 pairs
// per block, so K4's layout does not carry over; the reference's 128-lane
// Gram panels are a TPU layout.  Per cell the work is d loads of B, d FMAs
// and a sqrt plus six shared-memory accesses; B ([K, d, S]) is re-read by
// every A row of its tile and stays in L2.  The bound is the load and issue
// rate of the cost build and the serial chunk walks, not device memory.
//
// What the design does about it.  K3's warp-per-pair row scan confined to
// the pair's own band (measured on the H100: 2.2x K4 at a 130-slot class
// stripe, 7.7x at 496 slots; K4 stays faster up to about 58 slots).  One
// warp per pair, a block of `warps` warps per (tile-pair, A row).  Slot t of
// row i holds column j = i + t - pw; only the slots some row can use, t in
// [max(0, pw-la+1), min(2pw+1, pw+lb)), are kept, so a pair pays for its own
// band and not for the class's.  Each DP row takes four warp-synchronous
// steps:
//   1. costs, lane l taking slots l, l+32, ... (consecutive columns: one
//      coalesced line per channel from B laid out [K, d, S]);
//   2. lane l walks its contiguous chunk of slots, forming
//      e_t = c_t + min(D[i-1, j], D[i-1, j-1]) in place (D[i-1, j] is slot
//      t+1 of the previous row, D[i-1, j-1] slot t; the first slot of the
//      next chunk is read before any lane writes), and composes the maps
//      x -> min(x + c_t, e_t) of its chunk into one;
//   3. a warp-wide inclusive min-plus scan of those maps (__shfl_up_sync);
//   4. a second walk: D[i, j] = min(e_t, D[i, j-1] + c_t).
// Chunks sit at an odd stride in shared memory, so the walks hit 32 banks.
// The scan reassociates additions along a row, so the kernel differs from
// the cell-by-cell twin by rounding only: about 2 (la + lb) 2^-24 relative.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kCosine = 2;
constexpr unsigned kFull = 0xffffffffu;

__global__ void tile_stripe_kernel(
    const float* __restrict__ a,         // [K, S, d]
    const float* __restrict__ bt,        // [K, d, S]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int d, int ti, int rows, int band, int wv, int auto_widen,
    int metric, int row_len) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* cost = smem + (size_t)warp * (2 * row_len + d);   // [row_len]
  float* dp = cost + row_len;                               // [row_len]
  float* a_s = dp + row_len;                                // [d]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * warps + warp;
  if (c >= ti) return;
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
  // Slot t = q + t_lo of row i holds column j = i + q - base.
  const int t_lo = pw - la + 1 > 0 ? pw - la + 1 : 0;
  const int t_hi = 2 * pw + 1 < pw + lb ? 2 * pw + 1 : pw + lb;
  const int n = t_hi - t_lo;
  const int base = pw - t_lo;
  const int cw = (n + 31) >> 5;                   // slots per lane chunk
  const int sc = cw | 1;                          // chunk stride in smem
  const int q0 = lane * cw;
  const int q1 = q0 + cw < n ? q0 + cw : n;
  const int len = q1 > q0 ? q1 - q0 : 0;
  float* cost_l = cost + lane * sc;
  float* dp_l = dp + lane * sc;
  const float* ar = a + (size_t)arow * S * d;
  const float* b = bt + (size_t)bseq * d * S;

  // Virtual row -1: +inf except D[-1, -1] = 0 at slot t = pw (q = base).
  for (int t = 0; t < len; ++t) dp_l[t] = (q0 + t == base) ? 0.f : CUDART_INF_F;

  for (int i = 0; i < la; ++i) {
    // 1. Costs of row i.  The previous row's readers of a_s and of the cost
    //    row finished before the __syncwarp closing that row.
    for (int ch = lane; ch < d; ch += 32) a_s[ch] = ar[(size_t)i * d + ch];
    __syncwarp();
    for (int q = lane; q < n; q += 32) {
      const int j = i + q - base;
      float cq = CUDART_INF_F;
      if (j >= 0 && j < lb) {
        const float* bj = b + j;
        float acc = 0.f;
        if (metric == kCosine) {
          for (int ch = 0; ch < d; ++ch) acc = fmaf(a_s[ch], bj[(size_t)ch * S], acc);
          cq = 1.f - acc;
        } else {
          for (int ch = 0; ch < d; ++ch) {
            const float dd = a_s[ch] - bj[(size_t)ch * S];
            acc = fmaf(dd, dd, acc);
          }
          cq = metric == kEuclidean ? sqrtf(acc) : acc;
        }
      }
      const int l = q / cw;
      cost[l * sc + (q - l * cw)] = cq;
    }
    // 2. e_t = c_t + min(up, diag) in place, and this chunk's map.  The up
    //    value of the chunk's last slot is the next chunk's first slot of
    //    row i-1, read before any lane overwrites it.
    const float nxt = (len > 0 && q1 < n) ? dp[(lane + 1) * sc] : CUDART_INF_F;
    __syncwarp();
    float P = 0.f, Q = CUDART_INF_F;
    for (int t = 0; t < len; ++t) {
      const float diag = dp_l[t];
      const float up = t + 1 < len ? dp_l[t + 1] : nxt;
      const float cq = cost_l[t];
      const float e = cq + fminf(diag, up);
      dp_l[t] = e;
      P += cq;
      Q = fminf(Q + cq, e);
    }
    // 3. Inclusive scan of the maps x -> min(x + P, Q), earlier lanes first
    //    (an empty chunk is the identity map).
    for (int sh = 1; sh < 32; sh <<= 1) {
      const float Pp = __shfl_up_sync(kFull, P, sh);
      const float Qp = __shfl_up_sync(kFull, Q, sh);
      if (lane >= sh) {
        Q = fminf(Qp + P, Q);
        P = Pp + P;
      }
    }
    float left = __shfl_up_sync(kFull, Q, 1);     // D[i, j] left of the chunk
    if (lane == 0) left = CUDART_INF_F;
    // 4. D[i, j] = min(e_t, D[i, j-1] + c_t).
    for (int t = 0; t < len; ++t) {
      const float v = fminf(dp_l[t], left + cost_l[t]);
      dp_l[t] = v;
      left = v;
    }
    __syncwarp();
  }
  if (lane == 0) {
    const int q = lb - la + base;                 // the corner's slot
    const int l = q / cw;
    *o = dp[l * sc + (q - l * cw)];
  }
}

}  // namespace

extern "C" int apd_dtw_tile_stripe(
    const float* a, const float* bt, const int* lengths, const int* ti_idx,
    const int* tj_idx, float* out, int S, int d, int ti, int U, int rows,
    int band, int wv, int auto_widen, int metric, int warps, void* stream) {
  // A pair keeps at most 2*wv+1 slots; chunk strides are odd, at most
  // ceil(n/32) + 1.
  const int row_len = 32 * (((2 * wv + 1 + 31) / 32) + 1);
  const size_t smem = (size_t)warps * (2 * row_len + d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_stripe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + warps - 1) / warps));
  tile_stripe_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      a, bt, lengths, ti_idx, tj_idx, out, S, d, ti, rows, band, wv, auto_widen,
      metric, row_len);
  return (int)cudaGetLastError();
}

// K6: per-pair DTW over gathered pairs, unbanded or widen-banded, with full
// DP rows (S <= 1024), written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_rowscan_kernel
// (entry dtw_batch_pallas).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For B gathered pairs (a: [B, R, d] f32, shorter side
// first; b laid out [B, d, S] by the wrapper; len_a, len_b: [B] i32) it
// writes out[p] = the UNNORMALIZED DTW distance of a[p, :la] against
// b[p, :lb] over the cells |j - i| <= pw: pw = S unbanded (band < 0),
// max(band, |la - lb|) under auto_widen, else band.  A pair with la > R, or
// whose corner lies outside its band, comes back +inf.  The wrapper divides
// by la + lb for path_len normalization, as the reference's wrapper does.
//
// What bounds it on the H100.  Each pair is gathered, so no B frame is
// shared between pairs the way a tile shares it: the d loads per cell come
// from device memory once per pair and then L1/L2.  A DP row of up to 1024
// floats per pair does not fit one thread's share of shared memory, and K2's
// thread-per-pair row (measured on the H100 at about a quarter of K3's cells
// per second) would leave few warps resident at S=1024.  The bound is the
// load and issue rate of the cost build and the serial chunk walks.
//
// What the design does about it.  K3's row scan over gathered pairs: one warp
// per pair, `warps` pairs per block.  Each DP row i < la takes four
// warp-synchronous steps over the pair's lb columns: coalesced costs (B laid
// out [B, d, S]), a chunked walk per lane composing the maps
// x -> min(x + c_j, e_j), a warp-wide min-plus scan of the chunks' maps
// (__shfl_up_sync), and a second walk.  Cells outside the band get +inf
// costs without a build.  Chunks sit at an odd stride, so the walks hit 32
// banks.  The scan reassociates additions along a row, so the kernel
// differs from the cell-by-cell twin by about 2 (la + lb) 2^-24 relative.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kCosine = 2;
constexpr unsigned kFull = 0xffffffffu;

__global__ void rowscan_kernel(
    const float* __restrict__ a,         // [B, R, d]
    const float* __restrict__ bt,        // [B, d, S]
    const int* __restrict__ len_a,       // [B]
    const int* __restrict__ len_b,       // [B]
    float* __restrict__ out,             // [B]
    int n_pairs, int R, int S, int d, int band, int auto_widen, int metric,
    int row_len) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  float* cost = smem + (size_t)warp * (2 * row_len + d);   // [row_len]
  float* dp = cost + row_len;                               // [row_len]
  float* a_s = dp + row_len;                                // [d]

  const int p = blockIdx.x * warps + warp;
  if (p >= n_pairs) return;
  const int la = len_a[p];
  const int lb = len_b[p];
  const int diff = la > lb ? la - lb : lb - la;
  int pw = S;
  if (band >= 0) pw = (auto_widen && diff > band) ? diff : band;
  if (la < 1 || lb < 1 || la > R || lb > S || diff > pw) {   // warp-uniform
    if (lane == 0) out[p] = CUDART_INF_F;
    return;
  }
  const int cw = (lb + 31) >> 5;                  // columns per lane chunk
  const int sc = cw | 1;                          // chunk stride in smem
  const int j0 = lane * cw;
  const int j1 = j0 + cw < lb ? j0 + cw : lb;
  float* cost_l = cost + lane * sc;
  float* dp_l = dp + lane * sc;
  const float* ar = a + (size_t)p * R * d;
  const float* b = bt + (size_t)p * d * S;

  for (int i = 0; i < la; ++i) {
    // 1. Costs of row i (+inf outside the band).
    for (int ch = lane; ch < d; ch += 32) a_s[ch] = ar[(size_t)i * d + ch];
    __syncwarp();
    for (int j = lane; j < lb; j += 32) {
      float cj = CUDART_INF_F;
      if (j - i <= pw && i - j <= pw) {
        const float* bj = b + j;
        float acc = 0.f;
        if (metric == kCosine) {
          for (int ch = 0; ch < d; ++ch) acc = fmaf(a_s[ch], bj[(size_t)ch * S], acc);
          cj = 1.f - acc;
        } else {
          for (int ch = 0; ch < d; ++ch) {
            const float dd = a_s[ch] - bj[(size_t)ch * S];
            acc = fmaf(dd, dd, acc);
          }
          cj = metric == kEuclidean ? sqrtf(acc) : acc;
        }
      }
      const int l = j / cw;
      cost[l * sc + (j - l * cw)] = cj;
    }
    // 2. e_j = c_j + min(up, diag) in place, and this chunk's map.  The
    //    diagonal predecessor of the chunk's first column is read before
    //    any lane overwrites row i-1.
    float diag = CUDART_INF_F;
    if (j0 == 0) {
      diag = i == 0 ? 0.f : CUDART_INF_F;        // D[-1, -1] = 0
    } else if (i > 0 && j0 < lb) {
      diag = dp[(lane - 1) * sc + cw - 1];
    }
    __syncwarp();
    float P = 0.f, Q = CUDART_INF_F;
    for (int t = 0; t < j1 - j0; ++t) {
      const float up = i == 0 ? CUDART_INF_F : dp_l[t];
      const float cj = cost_l[t];
      const float e = cj + fminf(diag, up);
      dp_l[t] = e;
      diag = up;
      P += cj;
      Q = fminf(Q + cj, e);
    }
    // 3. Inclusive scan of the maps x -> min(x + P, Q), earlier lanes first.
    for (int sh = 1; sh < 32; sh <<= 1) {
      const float Pp = __shfl_up_sync(kFull, P, sh);
      const float Qp = __shfl_up_sync(kFull, Q, sh);
      if (lane >= sh) {
        Q = fminf(Qp + P, Q);
        P = Pp + P;
      }
    }
    float left = __shfl_up_sync(kFull, Q, 1);     // D[i, j0 - 1]
    if (lane == 0) left = CUDART_INF_F;
    // 4. D[i, j] = min(e_j, D[i, j-1] + c_j).
    for (int t = 0; t < j1 - j0; ++t) {
      const float v = fminf(dp_l[t], left + cost_l[t]);
      dp_l[t] = v;
      left = v;
    }
    __syncwarp();
  }
  if (lane == 0) {
    const int l = (lb - 1) / cw;
    out[p] = dp[l * sc + (lb - 1 - l * cw)];
  }
}

}  // namespace

extern "C" int apd_dtw_rowscan(
    const float* a, const float* bt, const int* len_a, const int* len_b,
    float* out, int n_pairs, int R, int S, int d, int band, int auto_widen,
    int metric, int warps, void* stream) {
  // Chunk strides are odd and at most ceil(S/32) + 1.
  const int row_len = 32 * (((S + 31) / 32) + 1);
  const size_t smem = (size_t)warps * (2 * row_len + d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rowscan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)((n_pairs + warps - 1) / warps);
  rowscan_kernel<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>(
      a, bt, len_a, len_b, out, n_pairs, R, S, d, band, auto_widen, metric,
      row_len);
  return (int)cudaGetLastError();
}

// K2: square-tile DTW over tile-pairs (unbanded or widen-banded), written by
// hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_pallas.py:_dtw_tile_kernel
// (entry dtw_tile_pairs).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/dtw_cuda.py.
//
// What it computes.  For U tile-pairs (ti_idx[u], tj_idx[u]) over a padded
// corpus (a: [K, S, d] f32, lengths: [K] i32, pad entries length 1) it writes
// out[u, r, c] = the UNNORMALIZED DTW distance of sequence ti_idx[u]*ti + r
// against sequence tj_idx[u]*ti + c (oracle/dtw.py's recurrence, read out at
// (la-1, lb-1)) over the cells i < la, j < lb, |j - i| <= wv, with wv = S
// for band < 0 (unbanded), max(band, |la - lb|) with auto_widen, else band.
// Contract: `rows` must cover every A length of the call; an A sequence
// longer than `rows` (or a B sequence longer than S) comes back +inf, never
// truncated.  The TPU kernel's `scan_steps` (the depth of its Hillis-Steele
// row scan) has no counterpart: each row is walked left to right here.
//
// What bounds it on the H100.  Per DP cell a thread does d loads of B, d
// FMAs, a sqrt and a three-way min, and the cells of one pair form a serial
// chain.  One B tile ([d, S, ti] f32, 2 MB at S=256, d=16, ti=128) is read by
// ti blocks and stays in L2, so device memory is not the limit: the d loads
// per cell (L1/L2) and the latency of the serial chain are.  The DP row
// (S floats per pair) lives in shared memory, which caps an SM at about 220
// resident threads at S=256 (440 at S=128), so few warps hide that latency:
// measured on the H100, 4 -> 6 resident warps gave 1.46x, while building
// four or eight columns' costs together to overlap their loads was 1.3-1.5x
// slower, so each cell is built on its own.
//
// What the design does about it.  One block per (tile-pair, A row, lane
// group) and one thread per B sequence.  Every thread of a block shares the
// A row, so la and the A frame of row i are uniform across the block: the A
// rows are staged in shared memory in chunks and read as broadcasts, and a
// block whose A sequence breaks the `rows` contract exits at once.  B is laid
// out [tile, d, S, ti] by the wrapper, so a warp's loads at one (channel,
// frame) are one 128-byte line.  The wrapper picks the block width (128, 64
// or 32 threads) and a 4 KB A chunk so that the most threads stay resident.
// Each thread's DP row sits in shared memory as [S][lanes] (conflict-free)
// and is updated in place, the diagonal predecessor carried in a register.
// The cost is the sum of squared differences, not the TPU's Gram expansion:
// it is exact near zero (self pairs are exactly 0) and is the plain twin's
// formula.  Left to later work: K3's warp-per-pair row scan, which needs no
// per-thread row and built several times more cells per second on the
// card, or several A rows per block sharing each B load; tensor cores for
// the cross term at full fp32.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kEuclidean = 0;
constexpr int kSqEuclidean = 1;
constexpr int kCosine = 2;

__global__ void tile_kernel(
    const float* __restrict__ a,         // [K, S, d]
    const float* __restrict__ b,         // [nT, d, S, ti]
    const int* __restrict__ lengths,     // [K]
    const int* __restrict__ ti_idx,      // [U]
    const int* __restrict__ tj_idx,      // [U]
    float* __restrict__ out,             // [U, ti, ti]
    int S, int d, int ti, int rows, int band, int auto_widen, int metric,
    int a_chunk) {
  extern __shared__ float smem[];
  const int lanes = blockDim.x;
  float* dp = smem + threadIdx.x;                // [S][lanes], stride `lanes`
  float* a_s = smem + S * lanes;                 // [a_chunk, d]

  const int u = blockIdx.x / ti;
  const int r = blockIdx.x - u * ti;
  const int c = blockIdx.y * lanes + threadIdx.x;
  const bool active = c < ti;
  const int tile_j = tj_idx[u];
  const int arow = ti_idx[u] * ti + r;
  const int la = lengths[arow];
  const int lb = active ? lengths[tile_j * ti + c] : 0;
  float* o = out + ((size_t)u * ti + r) * ti + c;

  // la is uniform across the block: a broken `rows` contract (or an empty
  // A sequence) leaves the whole block +inf without touching the DP.
  if (la < 1 || la > rows) {
    if (active) *o = CUDART_INF_F;
    return;
  }
  int wv = S;
  if (band >= 0) {
    const int diff = la > lb ? la - lb : lb - la;
    wv = (auto_widen && diff > band) ? diff : band;
  }
  const int n_cols = (lb >= 1 && lb <= S) ? lb : 0;
  const float* bt = b + (size_t)tile_j * d * S * ti + c;
  const float* ar = a + (size_t)arow * S * d;

  for (int i0 = 0; i0 < la; i0 += a_chunk) {
    const int nr = (la - i0) < a_chunk ? (la - i0) : a_chunk;
    __syncthreads();
    for (int t = threadIdx.x; t < nr * d; t += lanes) a_s[t] = ar[(size_t)i0 * d + t];
    __syncthreads();
    for (int ii = 0; ii < nr; ++ii) {
      const int i = i0 + ii;
      const float* arow_s = a_s + ii * d;
      // D[i-1, -1] is +inf except the virtual start D[-1, -1] = 0.
      float diag = i == 0 ? 0.f : CUDART_INF_F;
      float left = CUDART_INF_F;
      for (int j = 0; j < n_cols; ++j) {
        const float up = i == 0 ? CUDART_INF_F : dp[j * lanes];
        float cost = CUDART_INF_F;
        if (j - i <= wv && i - j <= wv) {
          const float* bj = bt + (size_t)j * ti;
          float acc = 0.f;
          if (metric == kCosine) {
            for (int ch = 0; ch < d; ++ch) acc = fmaf(arow_s[ch], bj[(size_t)ch * S * ti], acc);
            cost = 1.f - acc;
          } else {
            for (int ch = 0; ch < d; ++ch) {
              const float diff = arow_s[ch] - bj[(size_t)ch * S * ti];
              acc = fmaf(diff, diff, acc);
            }
            cost = metric == kEuclidean ? sqrtf(acc) : acc;
          }
        }
        const float v = cost + fminf(fminf(diag, up), left);
        dp[j * lanes] = v;
        left = v;
        diag = up;
      }
    }
  }
  if (active) *o = n_cols > 0 ? dp[(n_cols - 1) * lanes] : CUDART_INF_F;
}

}  // namespace

extern "C" int apd_dtw_tile(
    const float* a, const float* b, const int* lengths, const int* ti_idx,
    const int* tj_idx, float* out, int S, int d, int ti, int U, int rows,
    int band, int auto_widen, int metric, int lanes, int a_chunk, void* stream) {
  const size_t smem = (size_t)(S * lanes + a_chunk * d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)U * (unsigned)ti, (unsigned)((ti + lanes - 1) / lanes));
  tile_kernel<<<grid, lanes, smem, (cudaStream_t)stream>>>(
      a, b, lengths, ti_idx, tj_idx, out, S, d, ti, rows, band, auto_widen,
      metric, a_chunk);
  return (int)cudaGetLastError();
}

// The feature scaler's statistics on the card: each bin's mean and
// population std of [n, d] fp32 frames, bit for bit NumPy's, written by hand
// for Hopper (sm_90a).
//
// Replaces no pallas_call.  It replaces FeatureScaler.fit's NumPy reductions
// (models/autoencoder.py; the JAX package's is the same NumPy code), which
// the PCA embedding ran on one host thread over frames copied to the host
// and back (2.3-2.5 s of a longunits.discover job beside an H100).  Plain twin and wrapper:
// audio_pattern_discovery_tpu_torch/ops/scaler_stats.py.
//
// What it computes.  For each column j of x [n, d] (row-major), exactly what
// NumPy's frames.mean(axis=0) and np.maximum(frames.std(axis=0), 1e-6) give
// on float32: NumPy reduces axis 0 of a C-contiguous array row after row, so
// its sum of a column is the sequential fp32 sum
//     S = (((x[0] + x[1]) + x[2]) + ... + x[n-1]),
// then mean = fp32(S / n) (the division in float64), then
// S2 = the sequential fp32 sum of fp32(t * t), t = fp32(x[i] - mean),
// var = fp32(S2 / n), std = fp32 sqrt(var), floored at 1e-6f (NaN kept).
// Every addition, product, division and square root is IEEE round to
// nearest (the __f*_rn intrinsics, so that nvcc contracts nothing into an
// FMA).  out[0, j] = mean, out[1, j] = std.
//
// Why sequential and not a tree.  A tree or Welford reduction in fp32 lands
// closer to the exact statistics, but NumPy's fp32 sum strays from them by
// up to ~5e-5 of a bin's std at n = 300k, and the PCA's components turn by
// that over their eigengaps: fitted from other statistics than the plain
// reference's (benchmark/reference: NumPy's scaler), longunits.discover's
// latents moved 4e-4 to 8e-4 of their RMS on the H100, against the check's
// limit of 3e-4.  Bit for
// bit NumPy's statistics give the standardized frames, the covariance and
// the latents of the host path bit for bit.
//
// What bounds it on the H100.  The order: each column is two chains of n
// dependent fp32 additions (4 cycles each), 2n x 4 cycles = 1.2 ms at
// n = 300k and 1.98 GHz, however many columns run beside it.  The bytes,
// x read twice (0.62 GB at n = 300k, d = 513), take 0.37 ms at 3.35 TB/s.
//
// What the design does about it.  One CUDA block takes 32 columns; its warp
// 0 runs the 32 chains, a lane a column, from shared memory.  All 8 warps
// stage the rows ahead by cp.async (4 bytes a copy: a row of d = 513 floats
// is not 16-byte aligned) into a ring of kStages tiles of kTile rows of the
// block's 32 columns, each row a warp's one coalesced line, kStages - 1
// tiles in flight, so that the chains wait on shared memory and not on HBM.
// A column's two passes run in the one block, the mean held in its lane
// between them.  d = 513 gives 17 blocks; 5 x 8 KiB of ring each.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;     // columns a block: warp 0's lanes
constexpr int kWarps = 8;     // warp 0 adds; all 8 stage
constexpr int kTile = 64;     // rows a tile
constexpr int kStages = 5;    // tiles in the ring

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the calling thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The calling thread's share of tile t (rows t * kTile ..) of the block's
// columns into slot, as one copy group (empty past the last row or column,
// so that every thread commits one group a tile).
__device__ __forceinline__ void stage(const float* __restrict__ x, float (*slot)[kCols],
                                      int64_t t, int64_t n, int d, int c0) {
  const int lane = threadIdx.x % kCols, c = c0 + lane;
  if (c < d) {
    for (int k = threadIdx.x / kCols; k < kTile; k += kWarps) {
      const int64_t r = t * kTile + k;
      if (r < n) cp_async4(&slot[k][lane], x + r * d + c);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kCols * kWarps) scaler_stats_kernel(
    const float* __restrict__ x,   // [n, d]
    float* __restrict__ out,       // [2, d]: mean, std
    int64_t n, int d) {
  __shared__ float ring[kStages][kTile][kCols];
  const int lane = threadIdx.x % kCols, w = threadIdx.x / kCols;
  const int c0 = blockIdx.x * kCols;
  const int64_t tiles = (n + kTile - 1) / kTile;
  float mean = 0.f, acc = 0.f;
  for (int pass = 0; pass < 2; ++pass) {
    // -0 + v == v for every v, so the chain starts at x[0] as NumPy's does.
    acc = -0.f;
    for (int s = 0; s < kStages - 1; ++s) stage(x, ring[s], s, n, d, c0);
    for (int64_t t = 0; t < tiles; ++t) {
      // Into the slot that tile t - 1 left (the barrier below freed it).
      stage(x, ring[(t + kStages - 1) % kStages], t + kStages - 1, n, d, c0);
      cp_async_wait<kStages - 1>();
      __syncthreads();
      if (w == 0) {
        const float (*b)[kCols] = ring[t % kStages];
        const int64_t left = n - t * kTile;
        const int rows = left < kTile ? (int)left : kTile;
        if (pass == 0) {
#pragma unroll 8
          for (int k = 0; k < rows; ++k) acc = __fadd_rn(acc, b[k][lane]);
        } else {
#pragma unroll 8
          for (int k = 0; k < rows; ++k) {
            const float dv = __fsub_rn(b[k][lane], mean);
            acc = __fadd_rn(acc, __fmul_rn(dv, dv));
          }
        }
      }
      __syncthreads();
    }
    if (pass == 0) mean = (float)((double)acc / (double)n);
  }
  const int c = c0 + lane;
  if (w == 0 && c < d) {
    const float sd = __fsqrt_rn((float)((double)acc / (double)n));
    out[c] = mean;
    out[d + c] = (isnan(sd) || sd > 1e-6f) ? sd : 1e-6f;
  }
}

}  // namespace

extern "C" int apd_scaler_stats(const float* x, float* out, int n, int d, void* stream) {
  const unsigned blocks = (unsigned)((d + kCols - 1) / kCols);
  scaler_stats_kernel<<<blocks, kCols * kWarps, 0, (cudaStream_t)stream>>>(x, out, n, d);
  return (int)cudaGetLastError();
}

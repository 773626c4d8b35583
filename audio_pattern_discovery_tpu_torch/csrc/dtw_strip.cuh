// Row strips for K1 (dtw_lane_diag.cu), K2 (dtw_tile.cu), K4 (dtw_lane.cu)
// and K5 (dtw_tile_stripe.cu): the frame costs of R consecutive A rows
// against one B frame, with B's frame loaded once.
//
// K1, K2 and K4 (a thread per pair) read the corpus in the layout
// [nT, S, ti, 4*nc4] f32 that ops/dtw_cuda.py:strip_layout builds: frame j
// of sequence t*ti + c is nc4 float4s at ((t*S + j)*ti + c)*nc4, channels
// past d zero.  A warp's threads (neighbouring c) read one B frame as 32
// neighbouring 16-byte chunks per float4.  K5 (a warp per pair) reads
// ops/dtw_cuda.py:frame_layout, [K, S, 4*nc4]: one sequence's frames
// consecutive.  A zero channel adds fmaf(0, 0, acc) = acc, so a cost equals
// the sum over the d real channels, taken in channel order 0..d-1: the same
// fmaf chain, bit for bit, as one cell at a time.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace apd_strip {

constexpr int kEuclidean = 0;
constexpr int kSqEuclidean = 1;
constexpr int kCosine = 2;

// The strip's A frames.  With a frame width known at compile time (D4 > 0
// float4s) they sit in registers, loaded once per strip; otherwise (wide
// frames, D4 == 0) every column reads them from the staged copy in shared
// memory as broadcasts.
template <int R, int D4>
struct StripA {
  float4 v[R][D4 > 0 ? D4 : 1];
  const float4* s;   // [R][nc4] in shared memory
  int nc4;

  __device__ __forceinline__ void load(const float4* a_s, int n) {
    s = a_s;
    nc4 = n;
    if constexpr (D4 > 0) {
#pragma unroll
      for (int k = 0; k < R; ++k)
#pragma unroll
        for (int q = 0; q < D4; ++q) v[k][q] = a_s[k * D4 + q];
    }
  }

  __device__ __forceinline__ float4 get(int k, int q) const {
    if constexpr (D4 > 0) {
      return v[k][q];
    } else {
      return s[k * nc4 + q];
    }
  }
};

// Channels 4q..4q+3 of every strip row against one B float4.
template <int R, int D4, bool kCos>
__device__ __forceinline__ void strip_chunk(float (&acc)[R], const StripA<R, D4>& a,
                                            const float4 b, int q) {
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float4 x = a.get(k, q);
    if constexpr (kCos) {
      acc[k] = fmaf(x.x, b.x, acc[k]);
      acc[k] = fmaf(x.y, b.y, acc[k]);
      acc[k] = fmaf(x.z, b.z, acc[k]);
      acc[k] = fmaf(x.w, b.w, acc[k]);
    } else {
      float t = x.x - b.x;
      acc[k] = fmaf(t, t, acc[k]);
      t = x.y - b.y;
      acc[k] = fmaf(t, t, acc[k]);
      t = x.z - b.z;
      acc[k] = fmaf(t, t, acc[k]);
      t = x.w - b.w;
      acc[k] = fmaf(t, t, acc[k]);
    }
  }
}

template <int R, int D4, bool kCos>
__device__ __forceinline__ void strip_sums_of(float (&acc)[R], const StripA<R, D4>& a,
                                              const float4* __restrict__ bj) {
  if constexpr (D4 > 0) {
#pragma unroll
    for (int q = 0; q < D4; ++q) strip_chunk<R, D4, kCos>(acc, a, __ldg(bj + q), q);
  } else {
    for (int q = 0; q < a.nc4; ++q) strip_chunk<R, D4, kCos>(acc, a, __ldg(bj + q), q);
  }
}

// acc[k] = the metric's channel sum of strip row k against the B frame at bj:
// sum (a - b)^2 (euclidean, sqeuclidean) or sum a*b (cosine on unit frames).
template <int R, int D4>
__device__ __forceinline__ void strip_sums(float (&acc)[R], const StripA<R, D4>& a,
                                           const float4* __restrict__ bj, int metric) {
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.f;
  if (metric == kCosine) {
    strip_sums_of<R, D4, true>(acc, a, bj);
  } else {
    strip_sums_of<R, D4, false>(acc, a, bj);
  }
}

// A cell's cost from its channel sum.
__device__ __forceinline__ float cost_of(float acc, int metric) {
  if (metric == kCosine) return 1.f - acc;
  return metric == kEuclidean ? sqrtf(acc) : acc;
}

// Stage the strip's A frames, rows i0..i0+R-1 of the sequence whose frame 0
// is at xa (consecutive frames fstride float4s apart), into a_s; rows at or
// past n_rows are zero.  Every thread of the block takes part.
template <int R>
__device__ __forceinline__ void stage_strip(float4* a_s, const float4* __restrict__ xa,
                                            size_t fstride, int i0, int n_rows, int nc4) {
  for (int t = threadIdx.x; t < R * nc4; t += blockDim.x) {
    const int k = t / nc4;
    a_s[t] = i0 + k < n_rows ? xa[(size_t)(i0 + k) * fstride + (t - k * nc4)]
                             : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

}  // namespace apd_strip

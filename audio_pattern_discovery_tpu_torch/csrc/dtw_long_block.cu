// K8: blocked long-sequence DTW over a list of pairs, one block
// anti-diagonal of every pair a launch, written by hand for Hopper (sm_90a).
//
// Replaces audio_pattern_discovery_tpu/ops/dtw_long.py:dtw_block_kernel in
// dtw_long_batch (an XLA scan over block diagonals, no Pallas kernel).  Plain
// twin and wrapper: audio_pattern_discovery_tpu_torch/ops/dtw_long.py.
//
// What it computes.  For P pairs of sequences given by index into two frame
// layouts (xa [Ka, Sa, 4*nc4], xb [Kb, Sb, 4*nc4] f32, ops/dtw_cuda.py:
// frame_layout; pair p is sequence ia of xa, of la frames, against sequence ib
// of xb, of lb frames) the DP grid of each pair is cut into blocks of
// BLK x BLK cells: nBa x nBb blocks of its own (ceil(la/BLK) x ceil(lb/BLK)
// in a merged call, or every pair nB x nB for a stripe, ops/dtw_long.py:
// _long_plan).  Block (I, J) needs only D[row0-1, col0..] (the bottom row of
// block (I-1, J)), D[row0.., col0-1] (the right column of block (I, J-1)) and
// the corner D[row0-1, col0-1], so every block of one block anti-diagonal
// k = I + J is independent: launch k computes them all, for every pair that
// has one, and a call takes max_p(nBa + nBb - 1) launches.  Blocks past a
// pair's terminal cell cannot reach it, so its distance does not depend on
// the grid.  The wrapper lists launch k's blocks as a prefix sum over pairs
// (`items` [nK, P+1]); a CUDA block finds its pair by binary search and its
// block column as the pair's first on the diagonal plus its rank.
// Boundaries live in device memory, per pair at offsets in `meta`:
//   H: the bottom row of the latest block of each block column J0 <= J,
//     read as block (I, J)'s top and rewritten with its bottom row;
//   V: the right column of the latest block of each block row, read as
//     block (I, J)'s left column and rewritten with its right one;
//   C [2, totC]: corners by the parity of k.  Block (I, J) reads its corner
//     from slot J-J0 of the previous parity and writes its top's last value,
//     the corner of block (I, J+1) on the next diagonal, to slot J-J0+1 of
//     its own.  H[J-1] cannot serve: block (I, J-1) rewrote it one diagonal
//     back.
// Block (I, J) touches only H[J], V[I] and its two corner slots of its pair,
// and I + J = k fixes one from the other, so no two blocks of a launch share
// a boundary.  Every entry of H, V and C is written before it is read.  The
// block holding (la-1, lb-1) writes out[p] (unnormalized; +inf where that
// cell is outside the band); out starts at +inf.  Cells outside i < la,
// j < lb and the band are +inf: unbanded (mode 0), widen |i - j| <= pw with
// pw = max(band, |la - lb|) under auto_widen (mode 1), or the diag corridor
// |j(la-1) - i(lb-1)| <= max(band, 1) max(la-1, lb-1) (mode 2) in 64-bit
// products, so exact at any length.  The virtual origin D[-1, -1] = 0 is the
// corner of block (0, 0) only; row-0 blocks see a +inf top and column-0
// blocks a +inf left column.  Block columns start at J0; `halo` (or null:
// +inf) holds the right columns of block column J0 - 1 in V's layout, so a
// stripe of block columns on one device can run with its left neighbour's
// columns as input.
//
// What bounds it on the H100.  A Euclidean cell is 3d + 4 fp32 operations,
// and a block's cells are one dependent chain along each row and column;
// its boundaries (2 BLK floats in, 2 BLK out per block) are a few percent of
// the bytes of its frames.  The FP32 issue rate bounds it, provided enough
// blocks are in flight and no step of the walk waits on device memory.
//
// What the design does about it.  One launch chain per call, not per
// block of pairs: the per-pair scheduler merges all of a job's pairs into a
// call, so every launch holds one diagonal of every pair's grid (thousands
// of DP blocks on the long diagonals).  A CUDA block per (pair, DP block),
// of W warps, one per pass of 32R of its rows (warp w takes passes w, w+W,
// ... where W is capped).  The block's top row and left column come into
// shared memory by cp.async.  Each warp walks its pass with the systolic
// walk of dtw_systolic.cuh (lane l holds R rows and computes column j at
// step j + l): the pass's A frames in registers, loaded once (or, for wide
// frames, staged by cp.async in the warp's own buffer), and B's frames,
// one contiguous span of the layout, through a ring of three chunks of 32
// columns in the warp's shared memory: at step 32m the warp issues the
// cp.async of chunk m+1 into the slot chunk m-2 left and waits for chunk m,
// so a chunk has 32 steps to land and no step waits on device memory.  The
// frames are summed by apd_strip::strip_chunk in the same order as
// strip_sums, so every cell is the same float as in K3, K6 and K7.  The
// ring and the A buffer are a warp's only shared memory that grows with
// the frame width; where the ring would leave fewer than 8 warps resident
// on an SM, or not fit at all (wide frames), the wrapper picks the
// instantiation that reads B through the read-only cache, as K3, K6 and K7
// do (ops/dtw_long.py:_long_config).  Pass q reads its top from row slot
// q mod (W+1) and writes its bottom row to the next slot, publishing every
// 32 columns (and its last) through a counter in shared memory; the warp of
// pass q+1 waits on that counter before it reads a column, so it trails
// the warp above by a chunk, and a pass that reuses a slot first waits
// until the pass that last wrote it is done.  All of a block's warps are resident
// together, and a pass waits only on lower passes, so the wait cannot
// deadlock.  Each pass walks only the columns its rows' bands reach inside
// the block, and a pass none of whose cells is in the band writes +inf
// boundaries without walking.  Where the pass starts at the block's first
// column, each lane's `left` comes seeded with its rows of the left column
// (kSeeded) and lane 0's first diagonal is the corner (first pass) or the
// left column's row above; otherwise everything left of the walk is +inf.
// Each cell adds cost + min(min(diag, up), left) from the costs of
// apd_systolic::cost_of, as the plain twin does cell by cell.
//
// The Gram instantiation (kGram, dtw.dtype=bfloat16; the reference's
// ops/dtw.py:pairwise_cost under matmul_dtype=bfloat16 in dtw_block_kernel).
// The layouts then hold the frames rounded to bf16 (cosine's unit frames
// after their fp32 normalization), kept as fp32, and `na`/`nb` ([Ka, Sa],
// [Kb, Sb]) the squared norms of the unrounded frames (ops/dtw_long.py:
// gram_layout, built once a job).  A cell's channel sum is the cosine
// chunk's dot product of the rounded frames: each product of two bf16 values
// is exact in fp32, and the fmaf chain sums them in channel order.  Its cost
// is 1 - dot (cosine), or max((na_i + nb_j) - 2 dot, 0) and the IEEE sqrt of
// that (Euclidean): 2d + 6 operations a cell.  A lane holds its R rows'
// norms in registers, loaded once per pass, and reads nb_j beside B's frame,
// a coalesced span of the warp's 32 columns.  This first instantiation keeps
// the fp32 frame layouts and their shared memory; these instantiations take
// a register budget of their own, so their extra registers never spill.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "dtw_strip.cuh"
#include "dtw_systolic.cuh"

namespace {

using namespace apd_strip;
using apd_systolic::kFull;

constexpr int kWiden = 1;
constexpr int kDiag = 2;
// Fields of a pair's row of `meta` (int64).
constexpr int kMetaFields = 8;   // ia, ib, la, lb, nBa, H offset, V offset, C offset

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

// B's frames a warp holds staged: kRing chunks of 32 consecutive columns.
constexpr int kRing = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of the calling thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Waits (the whole warp) until *flag >= need; returns the value it saw.
__device__ __forceinline__ int wait_at_least(const volatile int* flag, int need) {
  int seen;
  for (;;) {
    seen = __shfl_sync(kFull, (threadIdx.x & 31) == 0 ? *flag : 0, 0);
    if (seen >= need) break;
    __nanosleep(32);
  }
  __threadfence_block();
  return seen;
}

// A Gram cell's cost from the dot product of its rounded frames and the
// squared norms of the unrounded ones, in the reference's order.
__device__ __forceinline__ float gram_cost(float dot, float na, float nb, int metric) {
  if (metric == kCosine) return 1.f - dot;
  const float sq = fmaxf(__fsub_rn(__fadd_rn(na, nb), __fmul_rn(2.f, dot)), 0.f);
  return metric == kEuclidean ? apd_systolic::sqrt_rn(sq) : sq;
}

// apd_strip::strip_sums against a B frame in shared memory (plain loads in
// place of __ldg): the same chunks in the same order.
template <int R, int D4>
__device__ __forceinline__ void strip_sums_shared(float (&acc)[R], const StripA<R, D4>& a,
                                                  const float4* bj, int metric) {
#pragma unroll
  for (int k = 0; k < R; ++k) acc[k] = 0.f;
  const int n = D4 > 0 ? D4 : a.nc4;
  if (metric == kCosine) {
#pragma unroll
    for (int q = 0; q < n; ++q) strip_chunk<R, D4, true>(acc, a, bj[q], q);
  } else {
#pragma unroll
    for (int q = 0; q < n; ++q) strip_chunk<R, D4, false>(acc, a, bj[q], q);
  }
}

// Chunk m of a walk from c_lo, columns c_lo + 32m .. (at most c_hi, and
// below b_end, the frames the layout holds), into its ring slot: one
// contiguous span of the layout, copied by the warp's lanes.  A chunk past
// c_hi copies nothing.
__device__ __forceinline__ void stage_chunk(float4* ring, const float4* __restrict__ xbp,
                                            int stride, int c_lo, int c_hi, int b_end, int m) {
  const int c0 = c_lo + 32 * m;
  const int c1 = c_hi < b_end - 1 ? c_hi : b_end - 1;
  const int n = c1 - c0 + 1 < 32 ? c1 - c0 + 1 : 32;
  float4* dst = ring + (size_t)(m % kRing) * 32 * stride;
  const float4* src = xbp + (size_t)c0 * stride;
  for (int t = threadIdx.x & 31; t < n * stride; t += 32) cp_async16(dst + t, src + t);
}

// One pass of the calling warp over columns [c_lo, c_hi]: apd_systolic::pass
// with kBand, kSeeded and G = 32.  B's frames (sequence frame 0 at xbp,
// `stride` float4s apart) come from the warp's ring in shared memory
// (kStageB: chunk m + 1 copied while chunk m is walked) or from the layout
// through the read-only cache.  The row above comes from `in_row` (columns
// [rlo, rhi] valid, published `avail` at a time through `in_done`), and the
// bottom row goes to `out_row`, published through `out_done`.  Rows are
// offset by col0 in both.  kGram: `na` holds the lane's rows' squared norms
// and `nbp` B's (sequence frame 0 at nbp).
template <int R, int D4, bool kStageB, bool kGram>
__device__ __forceinline__ void walk(const StripA<R, D4>& a, const float4* __restrict__ xbp,
                                     const float (&na)[R], const float* __restrict__ nbp,
                                     int stride, int b_end, float4* ring, int metric, int col0,
                                     int c_lo, int c_hi, const int (&lo)[R], const int (&hi)[R],
                                     float diag0, const float* in_row, int rlo, int rhi,
                                     const volatile int* in_done, int avail, float* out_row,
                                     volatile int* out_done, float (&left)[R]) {
  const int lane = threadIdx.x & 31;
  if constexpr (kStageB) {
    __syncwarp();                                // the last pass's reads of the ring are done
    stage_chunk(ring, xbp, stride, c_lo, c_hi, b_end, 0);
    cp_async_commit();
  }
  float bottom = left[R - 1];                    // D[last row, the lane's last column]
  float up_prev = lane == 0 ? diag0 : CUDART_INF_F;
  const int steps = c_hi - c_lo + 32;
  int j = c_lo - lane;
  for (int t = 0; t < steps; ++t, ++j) {
    if constexpr (kStageB) {
      if ((t & 31) == 0) {
        // Lane 31 last read chunk m - 2 two steps ago: its slot takes chunk
        // m + 1 while the warp walks chunk m, which must have landed.
        __syncwarp();
        stage_chunk(ring, xbp, stride, c_lo, c_hi, b_end, (t >> 5) + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncwarp();
      }
    }
    // Lane 0's column c_lo + t, where the row above holds it, once published.
    const int jn = c_lo + t;
    if (jn <= c_hi && jn >= rlo && jn <= rhi && jn - rlo >= avail)
      avail = wait_at_least(in_done, jn - rlo + 1);
    const bool on = j >= c_lo && j <= c_hi;
    const float shuffled = __shfl_up_sync(kFull, bottom, 1);
    const float from_row =
        (lane == 0 && on && j >= rlo && j <= rhi) ? in_row[j - col0] : CUDART_INF_F;
    float up = lane == 0 ? from_row : shuffled;
    float diag = up_prev;
    up_prev = up;
    if (on) {
      bool any = false;
#pragma unroll
      for (int k = 0; k < R; ++k) any |= (j >= lo[k]) & (j <= hi[k]);
      // The Gram cells' channel sum is the dot product of the rounded frames.
      const int sum_metric = kGram ? kCosine : metric;
      float acc[R];
      float nbj = 0.f;
      if (any) {
        if constexpr (kStageB) {
          const int r = j - c_lo;
          strip_sums_shared<R, D4>(acc, a, ring + (size_t)((r >> 5) % kRing * 32 + (r & 31)) * stride,
                                   sum_metric);
        } else {
          strip_sums<R, D4>(acc, a, xbp + (size_t)j * stride, sum_metric);
        }
        if constexpr (kGram) nbj = __ldg(nbp + j);
      } else {
#pragma unroll
        for (int k = 0; k < R; ++k) acc[k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < R; ++k) {
        float cost = kGram ? gram_cost(acc[k], na[k], nbj, metric)
                           : apd_systolic::cost_of(acc[k], metric);
        cost = (j >= lo[k] && j <= hi[k]) ? cost : CUDART_INF_F;
        const float v = cost + fminf(fminf(diag, up), left[k]);
        diag = left[k];
        left[k] = v;
        up = v;
      }
      bottom = up;
      if (lane == 31) {
        out_row[j - col0] = bottom;
        if (((j - c_lo + 1) & 31) == 0 || j == c_hi) {
          __threadfence_block();
          *out_done = j - c_lo + 1;
        }
      }
    }
  }
}

// float4s of one warp's own shared memory: its pass's A frames where they
// do not sit in registers (D4 == 0), and its ring of B frames (kStageB).
__host__ __device__ inline size_t warp_float4s(int R, int D4, bool stage_b, int nc4) {
  return (D4 > 0 ? 0 : (size_t)32 * R * nc4) + (stage_b ? (size_t)kRing * 32 * nc4 : 0);
}

// Shared memory of a CUDA block of W warps, in bytes: each warp's own
// float4s, then W + 1 row buffers (pass boundaries, reused in turn) and the
// left column (BLK floats each), and per pass boundary its published count
// and column range, and per pass a flag that it is done.
__host__ __device__ inline size_t smem_bytes(int R, int D4, bool stage_b, int BLK, int nc4,
                                             int n_pass, int W) {
  const size_t words = (size_t)(W + 2) * BLK + 3 * (n_pass + 1) + n_pass;
  return 16 * W * warp_float4s(R, D4, stage_b, nc4) + ((words * 4 + 15) / 16) * 16;
}

// The cached-B instantiations run where shared memory, not registers, limits
// the warps an SM holds, so they take a register budget of their own, as do
// the Gram ones.
template <int R, int D4, bool kStageB, bool kGram>
__global__ void __launch_bounds__(256, (kGram || D4 == 8 || !kStageB) ? 1 : 2) long_block_kernel(
    const float4* __restrict__ xa,       // [Ka, Sa, nc4]
    const float4* __restrict__ xb,       // [Kb, Sb, nc4]
    const float* __restrict__ na_all,    // kGram: [Ka, Sa] squared norms, else unused
    const float* __restrict__ nb_all,    // kGram: [Kb, Sb]
    const long long* __restrict__ meta,  // [P, kMetaFields]
    const int* __restrict__ items,       // [P + 1]: launch k's row of the prefix sums
    float* __restrict__ H, float* __restrict__ V, float* __restrict__ C,
    const float* __restrict__ halo,      // V's layout, or null
    float* __restrict__ out,             // [P]
    int n_pairs, int Sa, int Sb, int nc4, int BLK, int k, int J0, int totC, int mode,
    int band, int auto_widen, int metric) {
  extern __shared__ float4 smem4[];
  const int n_pass = BLK / (32 * R);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_slot = n_warps + 1;
  const size_t own = warp_float4s(R, D4, kStageB, nc4);
  float4* aw = smem4 + (size_t)warp * own;                                // [32R][nc4]
  float4* ring = aw + (D4 > 0 ? 0 : (size_t)32 * R * nc4);                // [kRing][32][nc4]
  float* rows = reinterpret_cast<float*>(smem4 + (size_t)n_warps * own);  // [n_slot][BLK]
  float* lcol = rows + (size_t)n_slot * BLK;                              // [BLK]
  int* done = reinterpret_cast<int*>(lcol + BLK);                         // [n_pass + 1]
  int* rng = done + n_pass + 1;                                           // [n_pass + 1][2]
  int* fin = rng + 2 * (n_pass + 1);                                      // [n_pass]

  // The pair: the last whose prefix sum is at most this item.
  const int item = blockIdx.x;
  int p = 0, p_hi = n_pairs;
  while (p_hi - p > 1) {
    const int mid = (p + p_hi) >> 1;
    if (items[mid] <= item) p = mid; else p_hi = mid;
  }
  const long long* m = meta + (size_t)p * kMetaFields;
  const int nBa = (int)m[4];
  const int J = (k - nBa + 1 > J0 ? k - nBa + 1 : J0) + (item - items[p]);
  const int I = k - J;
  const int row0 = I * BLK, col0 = J * BLK, c_end = col0 + BLK - 1;
  PairBand pb;
  pb.la = (int)m[2];
  pb.lb = (int)m[3];
  pb.mode = mode;
  const int diff = pb.la > pb.lb ? pb.la - pb.lb : pb.lb - pb.la;
  pb.pw = (auto_widen && diff > band) ? diff : band;
  pb.den = pb.la - 1;
  pb.num = pb.lb - 1;
  pb.thresh = (long long)(band > 1 ? band : 1) * (pb.den > pb.num ? pb.den : pb.num);

  float* h = H + m[5] + (size_t)(J - J0) * BLK;
  float* v = V + m[6] + (size_t)I * BLK;
  const float* vin = J > J0 ? v : (halo != nullptr ? halo + m[6] + (size_t)I * BLK : nullptr);
  float* c_next = C + (size_t)(k & 1) * totC + m[7];
  const float* c_prev = C + (size_t)((k + 1) & 1) * totC + m[7];
  const float4* pa = xa + (size_t)m[0] * Sa * nc4;
  const float4* pbx = xb + (size_t)m[1] * Sb * nc4;
  const float* nap = kGram ? na_all + (size_t)m[0] * Sa : nullptr;
  const float* nbp = kGram ? nb_all + (size_t)m[1] * Sb : nullptr;
  const int la_end = pb.la < Sa ? pb.la : Sa;
  const int lb_end = pb.lb < Sb ? pb.lb : Sb;

  // The block's top (row buffer 0) and left column, by asynchronous copies.
  for (int t = threadIdx.x; t < BLK / 4; t += blockDim.x) {
    if (I > 0) cp_async16(rows + 4 * t, h + 4 * t);
    if (vin != nullptr) {
      cp_async16(lcol + 4 * t, vin + 4 * t);
    } else {
      reinterpret_cast<float4*>(lcol)[t] =
          make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
    }
  }
  cp_async_commit();
  for (int t = threadIdx.x; t <= n_pass; t += blockDim.x) {
    done[t] = t == 0 ? INT_MAX : -1;
    if (t < n_pass) fin[t] = 0;
  }
  if (threadIdx.x == 0) {
    rng[0] = I > 0 ? col0 : 1;
    rng[1] = I > 0 ? c_end : 0;
    // The top's last value is the corner of block (I, J+1) next diagonal.
    c_next[J - J0 + 1] = I > 0 ? h[BLK - 1] : CUDART_INF_F;
  }
  // D[row0-1, col0-1]: the origin at block (0, 0); at the first column of a
  // stripe the halo's row above; else the snapshot of the last diagonal.
  float corner_in;
  if (J > J0) {
    corner_in = c_prev[J - J0];
  } else if (J == 0) {
    corner_in = I == 0 ? 0.f : CUDART_INF_F;
  } else {
    corner_in = (I > 0 && halo != nullptr) ? halo[m[6] + (size_t)(I - 1) * BLK + BLK - 1]
                                           : CUDART_INF_F;
  }
  cp_async_wait<0>();
  __syncthreads();

  const int stride = D4 > 0 ? D4 : nc4;
  StripA<R, D4> a;
  float left[R];
  float na[R];
  for (int q = warp; q < n_pass; q += n_warps) {
    const int i0 = q * 32 * R;
    int lo[R], hi[R];
    int mn = INT_MAX, mx = INT_MIN;
    float seed[R];
#pragma unroll
    for (int s = 0; s < R; ++s) {
      const int r = i0 + lane * R + s;
      pb.range(row0 + r, lo[s], hi[s]);
      lo[s] = lo[s] > col0 ? lo[s] : col0;
      hi[s] = hi[s] < c_end ? hi[s] : c_end;
      if (lo[s] <= hi[s]) {
        mn = lo[s] < mn ? lo[s] : mn;
        mx = hi[s] > mx ? hi[s] : mx;
      }
      seed[s] = lcol[r];                         // D[row0 + r, col0 - 1]
    }
    const int c_lo = __reduce_min_sync(kFull, mn);
    const int c_hi = __reduce_max_sync(kFull, mx);
    // The row above: the block's top, or the pass above's bottom row with
    // the range it published.
    volatile int* in_done = done + q;
    int avail = INT_MAX;
    if (q > 0) avail = wait_at_least(in_done, 0);
    const float* in_row = rows + (size_t)(q % n_slot) * BLK;
    const int rlo = reinterpret_cast<volatile int*>(rng)[2 * q];
    const int rhi = reinterpret_cast<volatile int*>(rng)[2 * q + 1];
    // This pass's bottom row goes to the slot that pass q - W read (this
    // warp, done) and pass q - W - 1 wrote: wait until that one is done.
    if (q > n_warps) wait_at_least(fin + q - n_warps - 1, 1);
    const bool skip = c_lo > c_hi;               // no cell of these rows in the band
    if (lane == 0) {
      rng[2 * q + 2] = skip ? 1 : c_lo;
      rng[2 * q + 3] = skip ? 0 : c_hi;
      __threadfence_block();
      done[q + 1] = 0;
    }
    __syncwarp();                                // lane 31's counts come after this one
    if (!skip) {
      // The pass's A frames: rows at or past la are zero.
      const int r0 = row0 + i0;
      if constexpr (D4 > 0) {
#pragma unroll
        for (int s = 0; s < R; ++s) {
          const int r = r0 + lane * R + s;
#pragma unroll
          for (int c = 0; c < D4; ++c)
            a.v[s][c] = r < la_end ? __ldg(pa + (size_t)r * D4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        a.nc4 = D4;
      } else {
        const int na = la_end - r0 < 32 * R ? la_end - r0 : 32 * R;
        for (int t = lane; t < 32 * R * nc4; t += 32) {
          if (t < na * nc4) cp_async16(aw + t, pa + (size_t)r0 * nc4 + t);
          else aw[t] = make_float4(0.f, 0.f, 0.f, 0.f);
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncwarp();
        a.load(aw + (size_t)lane * R * nc4, nc4);
      }
#pragma unroll
      for (int s = 0; s < R; ++s) {
        const int r = r0 + lane * R + s;
        na[s] = kGram && r < la_end ? __ldg(nap + r) : 0.f;
      }
      // Started at the block's first column, the walk continues the left
      // column; started further right, every value left of it is +inf.
      const bool seeded = c_lo == col0;
#pragma unroll
      for (int s = 0; s < R; ++s) left[s] = seeded ? seed[s] : CUDART_INF_F;
      float diag0;
      if (seeded) {
        diag0 = q == 0 ? corner_in : lcol[i0 - 1];
      } else {
        const int jd = c_lo - 1;
        if (jd >= rlo && jd <= rhi && jd - rlo >= avail) avail = wait_at_least(in_done, jd - rlo + 1);
        diag0 = jd >= rlo && jd <= rhi ? in_row[jd - col0] : CUDART_INF_F;
      }
      walk<R, D4, kStageB, kGram>(a, pbx, na, nbp, stride, lb_end, ring, metric, col0, c_lo, c_hi,
                                  lo, hi, diag0,
                           in_row, rlo, rhi, in_done, avail,
                           rows + (size_t)((q + 1) % n_slot) * BLK, done + q + 1, left);
      // The terminal cell, where this pass holds it: each lane's `left` is
      // its rows at column c_hi, and the cell is in the band only if c_hi
      // reached lb - 1.
      const int corner = pb.la - 1 - row0 - i0;
      if (corner >= 0 && corner < 32 * R && pb.lb - 1 >= col0 && pb.lb - 1 <= c_end &&
          lane == corner / R) {
        out[p] = c_hi == pb.lb - 1 ? apd_systolic::pick(left, corner % R) : CUDART_INF_F;
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s)
      v[i0 + lane * R + s] = !skip && c_hi == c_end ? left[s] : CUDART_INF_F;
    __syncwarp();                                // lane 31's bottom row is written
    if (lane == 31) {
      __threadfence_block();
      fin[q] = 1;
    }
  }
  // The last pass's bottom row is the block's.
  __syncthreads();
  const int blo = rng[2 * n_pass], bhi = rng[2 * n_pass + 1];
  const float* last = rows + (size_t)(n_pass % n_slot) * BLK;
  for (int c = threadIdx.x; c < BLK; c += blockDim.x)
    h[c] = col0 + c >= blo && col0 + c <= bhi ? last[c] : CUDART_INF_F;
}

template <int R, int D4, bool kStageB, bool kGram>
int launch(const float* xa, const float* xb, const float* na, const float* nb,
           const long long* meta, const int* items, const int* totals, float* H, float* V,
           float* C, const float* halo, float* out, int n_pairs, int Sa, int Sb, int nc4, int BLK,
           int nK, int J0, int totC, int mode, int band, int auto_widen, int metric, int warps,
           void* stream) {
  const size_t smem = smem_bytes(R, D4, kStageB, BLK, nc4, BLK / (32 * R), warps);
  cudaError_t err = cudaFuncSetAttribute(long_block_kernel<R, D4, kStageB, kGram>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  for (int k = 0; k < nK; ++k) {
    if (totals[k] == 0) continue;
    long_block_kernel<R, D4, kStageB, kGram>
        <<<(unsigned)totals[k], 32 * warps, smem, (cudaStream_t)stream>>>(
            reinterpret_cast<const float4*>(xa), reinterpret_cast<const float4*>(xb), na, nb, meta,
            items + (size_t)k * (n_pairs + 1), H, V, C, halo, out, n_pairs, Sa, Sb, nc4, BLK, k,
            J0, totC, mode, band, auto_widen, metric);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Launches block diagonals 0 <= k < nK in order on `stream`, one launch each
// where `totals` (host memory, [nK]) lists blocks, a CUDA block of `warps`
// warps per DP block.  R rows a lane (ops/dtw_long.py:_long_rows): 4, or 2
// at 8 float4s a frame, with a pass of 32R rows dividing the block (so 2 at
// BLK = 64 and 1 at 32).  nc4: float4s per frame.  stage_b (the wrapper's
// choice, ops/dtw_long.py:_long_config): B's frames through each warp's ring
// in shared memory, where at R = 4 the listed widths (and 8 at R = 2) keep a
// lane's A frames in registers and any other width reads them from the
// warp's staged pass; without it (wide frames), B through the read-only
// cache and A from the staged pass at any width.  gram: the Gram
// instantiation of each, on the rounded layouts and the norms na, nb (null
// otherwise).
extern "C" int apd_dtw_long_block(
    const float* xa, const float* xb, const float* na, const float* nb, const long long* meta,
    const int* items, const int* totals, float* H, float* V, float* C, const float* halo,
    float* out, int n_pairs, int Sa, int Sb, int nc4, int BLK, int nK, int J0, int totC,
    int mode, int band, int auto_widen, int metric, int warps, int R, int stage_b, int gram,
    void* stream) {
#define APD_K8(RR, D4, ST)                                                                     \
  return gram ? launch<RR, D4, ST, true>(xa, xb, na, nb, meta, items, totals, H, V, C, halo, \
                                         out, n_pairs, Sa, Sb, nc4, BLK, nK, J0, totC, mode,  \
                                         band, auto_widen, metric, warps, stream)             \
              : launch<RR, D4, ST, false>(xa, xb, na, nb, meta, items, totals, H, V, C, halo, \
                                          out, n_pairs, Sa, Sb, nc4, BLK, nK, J0, totC, mode, \
                                          band, auto_widen, metric, warps, stream)
  if (!stage_b) {
    if (R == 4) APD_K8(4, 0, false);
    if (R == 2) APD_K8(2, 0, false);
    APD_K8(1, 0, false);
  }
  if (R == 4) {
    switch (nc4) {
      case 1: APD_K8(4, 1, true);
      case 2: APD_K8(4, 2, true);
      case 4: APD_K8(4, 4, true);
      default: APD_K8(4, 0, true);
    }
  }
  if (R == 2) {
    if (nc4 == 8) APD_K8(2, 8, true);
    APD_K8(2, 0, true);
  }
  APD_K8(1, 0, true);
#undef APD_K8
}

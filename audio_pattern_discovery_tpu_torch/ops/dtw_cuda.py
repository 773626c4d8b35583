"""The DTW kernels on Hopper: the tile-pair kernels K1 (diag corridor), K2
(square tile), K3 (full-width rows), K4 (widen stripe, thread per pair) and
K5 (widen stripe, warp per pair), and the per-pair kernels K6 (full rows,
any band) and K7 (widen stripe) over gathered pairs.

Port of ``audio_pattern_discovery_tpu/ops/dtw_pallas.py``:
``dtw_tile_lane_diag_pairs`` (kernel ``_dtw_lane_diag_kernel``, plus the
pure-math helpers ``diag_class_bounds`` and ``tile_rep_lengths``),
``dtw_tile_pairs`` (``_dtw_tile_kernel``), ``dtw_tile_lane_full_pairs``
(``_dtw_lane_full_kernel``), ``dtw_tile_lane_pairs`` (``_dtw_lane_kernel``),
``dtw_tile_stripe_pairs`` (``_dtw_tile_stripe_kernel``), ``dtw_batch_pallas``
(``_dtw_rowscan_kernel``) and ``_dtw_batch_stripe`` (``_dtw_stripe_kernel``),
with the host helpers ``stripe_width``, ``scan_len_diff_classes`` and
``pallas_supported``.  Each wrapper launches its CUDA C++ kernel
(``csrc/<name>.cu``) on CUDA tensors, counts the launch in its ``launches``
attribute, and runs its plain PyTorch twin (``*_ref``) on CPU tensors; it
never falls back from one to the other.  The tile-pair kernels return
UNNORMALIZED distances; the per-pair wrappers normalize as the reference's
do.  A pair outside its class contract comes back +inf, never a truncated
distance.

K1: ``dtw_tile_lane_diag_pairs`` computes, for U tile-pairs
``(ti_idx[u], tj_idx[u])`` of a length-sorted, padded corpus, the
UNNORMALIZED diag-corridor DTW of A sequence ``ti_idx[u]*ti + r`` against B
sequence ``tj_idx[u]*ti + c`` as ``out[u, r, c]``, each DP row held in a
sheared stripe frame of ``W = 2*wv+2`` slots around the centre line
``c(i) = round(i*(lbm-1)/(la-1))`` (``lbm`` = the B tile's representative
length).  Class contracts, as in the JAX kernel: ``rows`` >= every A length
in the call, ``wv_max`` >= the stripe half-width from ``diag_class_bounds``.
With them met every corridor cell lies in the frame and the distance is
exact; a pair whose corner cell falls outside the frame comes back +inf.
An A sequence of length 1 has the whole of row 0 in its corridor, which
no frame centred on column 0 holds: the kernel and the twin give it the
row's running sum, the oracle's value, where the reference reads a
truncated corner whose column depends on the tile size.

K1, K2, K4 and K5 walk each pair's DP in strips of rows
(``csrc/dtw_strip.cuh``): each B frame is loaded once per strip and feeds
the strip's cost builds.  K1, K2 and K4 (a thread per pair) read the corpus
in ``strip_layout`` ([nT, S, ti, 4*nc4]), K5 (a warp per pair) in
``frame_layout`` ([K, S, 4*nc4]); the scheduler builds each once a job and
passes it as ``frames=``.  K3, K6 and K7 run a group of G lanes per pair
as a systolic pipeline (``csrc/dtw_systolic.cuh``): lane l holds R rows of
a pass of G*R rows and computes column j at step j + l, taking the row
above from lane l-1 by one shuffle a step.  K3 and K7 take a warp per pair
(G = 32), K6 32/G pairs a warp (``_rowscan_geometry``).  K3 reads
``frame_layout`` (``frames=``), K6 and K7 their gathered pairs, which are
that layout already where d is 4, 8, 16 or 32.

K2 and K3 are exact DTW over the rectangle i < la, j < lb (K2 optionally
banded).  Their twins evaluate the recurrence cell by cell (an
anti-diagonal wavefront vectorized over the gathered pairs) from the same
squared-difference costs as the kernels, so a twin and its kernel differ
only by rounding.

K4 holds each DP row in an unsheared stripe frame (slot s of row i is
column i + s - (wv+1)) of the exact width 2*wv+2, and K5 and K7 a pair's
own band (2*wv+1 slots at most), where the reference rounds the stripe up
to 8 or 128 slots: a pair whose half-width exceeds the class bound wv
comes back +inf, where the reference's rounded frame could read a
truncated value.  K6 walks each pair's own band too, with no class bound
(its boundary rows hold whole rows).  Their twins, and K6's, evaluate the
same banded recurrence cell by cell.

Not ported (TPU-only levers, measured null on the TPU): ``stack``,
``bgroup``, ``hoist_build``, ``dyn_roll=False`` with its ``kmax``, and the
8-sublane / 128-lane padding; K2's ``su``, ``sv``, ``gram_precision``,
``cmat_dtype``, ``build_repeats``, ``dp_repeats`` and ``hoist_masks``; K3's
and K4's ``unroll_rows``; K5's ``su``, ``sv``, ``panel_rows``,
``build_repeats``, ``dp_repeats`` and ``unroll_rows``; K6's and K7's
``pair_block``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

INF = float("inf")
METRICS = {"euclidean": 0, "sqeuclidean": 1, "cosine": 2}

# Shared-memory budget of one block (H100: 227 KB usable).
_SMEM_BUDGET = 200 * 1024
# Shared memory of one H100 SM, and what the hardware reserves per block.
_SM_SMEM = 228 * 1024
_BLOCK_RESERVED = 1024
# The plain twins build [pairs, W, d] costs per DP row (K1) or per
# anti-diagonal (K2-K7); pairs go in groups that keep that under this many
# elements.
_REF_MAX_ELEMS = 1 << 25


def diag_class_bounds(
    band: int,
    tmin_i: int,
    tmax_i: int,
    tmin_j: int,
    tmax_j: int,
) -> tuple[int, int]:
    """(wv_req, kmax) static contracts of the diag lane kernel for a
    tile-pair whose REAL lengths lie in [tmin_i, tmax_i] x [tmin_j, tmax_j]
    with tile_rep = (tmin_j + tmax_j + 1) // 2.

    Exact port of the JAX function (its docstring holds the derivation):
    a corridor cell's slot offset from the frame centre is bounded by
    corridor + spread, with corridor = ceil(r*max(den_min, num_max)/den_min)
    and spread the B tile's distance from its representative length.  kmax
    (the per-row centre-step bound) only sized TPU-only levers; the port's
    kernel needs no step bound and the scheduler ignores it."""
    r = max(int(band), 1)
    den_min = max(int(tmin_i) - 1, 1)
    num_max = max(int(tmax_j) - 1, 0)
    lbm = (int(tmin_j) + int(tmax_j) + 1) // 2
    corridor = -(-r * max(den_min, num_max) // den_min)   # ceil
    spread = max(int(tmax_j) - lbm, lbm - int(tmin_j), 0)
    wv_req = corridor + spread
    kmax = max(1, -(-max(lbm - 1, 0) // den_min))
    return wv_req, kmax


def tile_rep_lengths(lens_sorted: np.ndarray, nT: int, ti: int,
                     n_real: int) -> np.ndarray:
    """[nT] representative B length per tile (mid-range of REAL entries;
    all-pad tiles fall back to the raw range), the ``tile_rep`` input of
    dtw_tile_lane_diag_pairs.  Must match diag_class_bounds' lbm."""
    rep = np.empty(nT, np.int32)
    for t in range(nT):
        real = lens_sorted[t * ti : min((t + 1) * ti, n_real)]
        if len(real) == 0:
            real = lens_sorted[t * ti : (t + 1) * ti]
        rep[t] = (int(real.min()) + int(real.max()) + 1) // 2
    return rep


def stripe_frame(band: int, wv_max: int) -> tuple[int, int, int]:
    """(wv, off, W) of the K1, K4, K5 and K7 stripe frames: the half-width
    actually used (never below the band), the slot of the frame centre, and
    the frame width 2*wv+2."""
    wv = max(int(band), int(wv_max))
    return wv, wv + 1, 2 * wv + 2


def _check_args(feats, lengths, tile_rep, ti_idx, tj_idx, ti, metric):
    """(K, S, d) after checking shapes, dtypes and devices; ``tile_rep`` is
    None for the kernels that take none (K2, K3)."""
    if feats.dim() != 3 or feats.dtype != torch.float32:
        raise ValueError(f"feats must be [K, S, d] float32, got {tuple(feats.shape)} {feats.dtype}")
    K, S, d = feats.shape
    if K % ti:
        raise ValueError(f"K={K} must be padded to a multiple of ti={ti}")
    nT = K // ti
    named = [("lengths", lengths, K), ("ti_idx", ti_idx, None), ("tj_idx", tj_idx, None)]
    if tile_rep is not None:
        named.append(("tile_rep", tile_rep, nT))
    for name, t, n in named:
        if t.dim() != 1 or t.dtype != torch.int32:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got {tuple(t.shape)} {t.dtype}")
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, want {n}")
        if t.device != feats.device:
            raise ValueError(f"{name} is on {t.device}, feats on {feats.device}")
    if ti_idx.shape != tj_idx.shape:
        raise ValueError("ti_idx and tj_idx must have the same length")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    return K, S, d


def _unit_frames(feats: torch.Tensor, metric: str) -> torch.Tensor:
    """Cosine runs on L2-normalized frames (cost = 1 - a.b)."""
    if metric != "cosine":
        return feats
    return feats / torch.clamp(torch.linalg.vector_norm(feats, dim=-1, keepdim=True), min=1e-12)


def strip_channels(d: int) -> int:
    """float4s per frame in K1's and K2's corpus layout: ceil(d/4), rounded
    up to 1, 2, 4 or 8 (the widths at which the kernels keep a strip's A
    frames in registers) when it is at most 8."""
    n = -(-int(d) // 4)
    return 1 << (n - 1).bit_length() if n <= 8 else n


def strip_layout(feats: torch.Tensor, ti: int, metric: str = "euclidean") -> torch.Tensor:
    """[nT, S, ti, 4*strip_channels(d)] f32: the corpus as K1 and K2 read it
    (``csrc/dtw_strip.cuh``).  Element [t, j, c, ch] is frame j, channel ch
    of sequence t*ti + c (of its unit frame for cosine); channels past d are
    zero, which adds nothing to a cost.  A thread's frame is 16-byte chunks
    beside its neighbours'.  The scheduler builds it once a job and passes
    it to every launch (``frames=``)."""
    K, S, d = feats.shape
    nT = K // ti
    x = _unit_frames(feats, metric).reshape(nT, ti, S, d).permute(0, 2, 1, 3)
    out = torch.zeros((nT, S, ti, 4 * strip_channels(d)), dtype=torch.float32,
                      device=feats.device)
    out[..., :d] = x
    return out


def _check_layout(frames: torch.Tensor | None, feats: torch.Tensor, name: str,
                  want: tuple[int, ...], build) -> torch.Tensor:
    """``frames`` (a prebuilt layout called ``name`` of shape ``want``) after
    checking it against the corpus, or ``build()`` when None."""
    if frames is None:
        return build()
    if (tuple(frames.shape) != want or frames.dtype != torch.float32
            or frames.device != feats.device or not frames.is_contiguous()):
        raise ValueError(f"frames must be a contiguous float32 {name} {want} on "
                         f"{feats.device}, got {tuple(frames.shape)} {frames.dtype} "
                         f"on {frames.device}")
    return frames


def _check_frames(frames: torch.Tensor | None, feats: torch.Tensor, ti: int,
                  metric: str) -> torch.Tensor:
    """``frames`` (a prebuilt ``strip_layout``) after checking it against the
    corpus, or the layout built here."""
    K, S, d = feats.shape
    return _check_layout(frames, feats, "strip_layout", (K // ti, S, ti, 4 * strip_channels(d)),
                         lambda: strip_layout(feats, ti, metric))


def frame_layout(feats: torch.Tensor, metric: str = "euclidean") -> torch.Tensor:
    """[K, S, 4*strip_channels(d)] f32: the corpus as K3, K5, K6 and K7 read it.
    Element [k, j, ch] is frame j, channel ch of sequence k (of its unit
    frame for cosine); channels past d are zero.  One sequence's frames are
    consecutive, so a warp's lanes, each on neighbouring columns, read one
    contiguous span.  ``feats`` itself where it already is that layout
    (contiguous and 16-byte aligned, no padding channels, not cosine).  The
    tiled scheduler builds it once a job and passes it to every K3 and K5
    launch (``frames=``); K6 and K7 take gathered pairs, whose gather is
    already this layout at d = 4, 8, 16 or 32."""
    K, S, d = feats.shape
    n4 = 4 * strip_channels(d)
    if n4 == d and metric != "cosine" and feats.is_contiguous() and feats.data_ptr() % 16 == 0:
        return feats
    out = torch.zeros((K, S, n4), dtype=torch.float32, device=feats.device)
    out[..., :d] = _unit_frames(feats, metric)
    return out


def _check_frame_layout(frames: torch.Tensor | None, feats: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """``frames`` (a prebuilt ``frame_layout``) after checking it against
    the corpus, or the layout built here."""
    K, S, d = feats.shape
    return _check_layout(frames, feats, "frame_layout", (K, S, 4 * strip_channels(d)),
                         lambda: frame_layout(feats, metric))


# Rows per strip of K1, K4 and K5 (fixed in csrc/dtw_lane_diag.cu,
# dtw_lane.cu and dtw_tile_stripe.cu): each B frame is loaded once per strip
# and feeds this many cost builds.
STRIP_ROWS = 4


def _tile_strip_rows(S: int, nc4: int) -> int:
    """K2's rows per strip: 8 while the strip's 8 x 4*nc4 A values fit in
    registers (up to 16 channels), else 4.  At 16 channels 8 rows take ~210
    registers, which caps residency below what a short boundary row allows:
    there 4 rows where S <= 128.  On the H100 at d=16, 8 rows beat 4 at
    S=256 and lost in the config-4 job (S=128); below 16 channels
    4 rows gain no residency (ptxas gives 8 rows at most 119 registers)."""
    return 8 if nc4 < 4 or (nc4 == 4 and S > 128) else 4


def _strip_lanes(ti: int, state: int, nc4: int, R: int) -> int:
    """Threads per block for K1, K2 and K4: a block holds ``state`` floats of
    DP state per thread (K2's boundary row of S floats, K1's and K4's stripe
    of W) and the strip's staged A frames.  Bound by the serial chain's
    latency at low occupancy, the launch keeps the most threads resident on
    an SM: the width (128, 64 or 32) that fits the most, the widest on a
    tie."""
    best = None
    for lanes in sorted({min(ti, w) for w in (128, 64, 32)}, reverse=True):
        smem = 4 * (state * lanes + 4 * R * nc4)
        if smem > _SMEM_BUDGET:
            continue
        resident = min(_SM_SMEM // (smem + _BLOCK_RESERVED), 32, 2048 // lanes) * lanes
        if best is None or resident > best[0]:
            best = (resident, lanes)
    if best is None:
        raise ValueError(
            f"a DP state of {state} floats per thread does not fit one block's shared "
            f"memory ({_SMEM_BUDGET} bytes at 32 lanes)"
        )
    return best[1]


def _stripe_warps(ti: int, wv: int, nc4: int) -> int:
    """Warps (one pair each) per block of K5: each holds the strip's A frames
    (STRIP_ROWS x nc4 float4s) and a boundary row of 2*wv+1 floats rounded up
    to whole float4s; at most 4 warps (the kernel's launch bound)."""
    per_warp = 4 * (4 * STRIP_ROWS * nc4 + 4 * -(-(2 * int(wv) + 1) // 4))
    warps = min(4, ti, _SMEM_BUDGET // per_warp)
    if warps < 1:
        raise ValueError(
            f"a boundary row of {2 * int(wv) + 1} floats does not fit one block's shared "
            f"memory ({_SMEM_BUDGET} bytes)"
        )
    return warps


def dtw_tile_lane_diag_pairs(
    feats: torch.Tensor,       # [K, S, d] f32 padded, length-sorted corpus
    lengths: torch.Tensor,     # [K] i32 (pad entries: length 1)
    tile_rep: torch.Tensor,    # [nT] i32 representative B length per tile
    ti_idx: torch.Tensor,      # [U] i32 tile-row (A) indices
    tj_idx: torch.Tensor,      # [U] i32 tile-col (B) indices
    *,
    ti: int,
    band: int,
    wv_max: int,
    metric: str = "euclidean",
    rows: int | None = None,
    frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """Diag-corridor DTW for U tile-pairs -> [U, ti, ti] f32 (unnormalized).

    ``frames``: the corpus's ``strip_layout(feats, ti, metric)``, built once
    by a caller that launches many times; built here when None.  CUDA
    tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin.  Any other device raises."""
    K, S, d = _check_args(feats, lengths, tile_rep, ti_idx, tj_idx, ti, metric)
    if band is None:
        raise ValueError("the diag lane kernel requires a band")
    if feats.device.type == "cpu":
        return dtw_tile_lane_diag_pairs_ref(
            feats, lengths, tile_rep, ti_idx, tj_idx,
            ti=ti, band=band, wv_max=wv_max, metric=metric, rows=rows,
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if not 1 <= ti <= 1024:
        raise ValueError(f"ti={ti} must be in [1, 1024] (one thread per B lane)")
    wv, _, W = stripe_frame(band, wv_max)
    rows = S if rows is None else min(int(rows), S)
    U = ti_idx.shape[0]
    out = torch.empty((U, ti, ti), dtype=torch.float32, device=feats.device)
    if U == 0:
        return out
    x = _check_frames(frames, feats, ti, metric)
    nc4 = strip_channels(d)
    lanes = _strip_lanes(ti, W, nc4, STRIP_ROWS)
    lengths, tile_rep = lengths.contiguous(), tile_rep.contiguous()
    ti_idx, tj_idx = ti_idx.contiguous(), tj_idx.contiguous()
    _launch(
        "dtw_lane_diag", 6, 9,
        x.data_ptr(), lengths.data_ptr(), tile_rep.data_ptr(),
        ti_idx.data_ptr(), tj_idx.data_ptr(), out.data_ptr(),
        S, nc4, ti, U, rows, int(band), wv, METRICS[metric], lanes,
        device=feats.device,
    )
    dtw_tile_lane_diag_pairs.launches += 1
    return out


dtw_tile_lane_diag_pairs.launches = 0


def _launch(name: str, n_ptrs: int, n_ints: int, *args, device: torch.device,
            entry: str | None = None) -> None:
    """Call ``apd_<entry>`` (``entry`` defaults to ``name``) of
    ``lib<name>.so`` (built at first use): n_ptrs pointers, n_ints ints, then
    ``device``'s current stream, with ``device`` (that of the tensors
    launched on) the thread's current device, so that the launch and any
    attribute the entry sets reach that card; raise on a CUDA error."""
    from audio_pattern_discovery_tpu_torch.ops import _build

    entry = entry or name
    if len(args) != n_ptrs + n_ints:
        raise TypeError(f"apd_{entry} takes {n_ptrs} pointers and {n_ints} ints, got {len(args)} arguments")
    fn = getattr(_build.load(name), f"apd_{entry}")
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {err}")


def dtw_tile_lane_diag_pairs_ref(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    tile_rep: torch.Tensor,
    ti_idx: torch.Tensor,
    tj_idx: torch.Tensor,
    *,
    ti: int,
    band: int,
    wv_max: int,
    metric: str = "euclidean",
    rows: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the K1 kernel, on the device of ``feats``.

    Vectorized over the U*ti*ti pairs with a loop over DP rows; the same
    frame, corridor and +inf frame rule as the kernel.  Within a row the
    valid slots are one contiguous run (frame, corridor and length bounds
    are all intervals in j), so the left-to-right recurrence
    v[s] = c[s] + min(diag[s], up[s], v[s-1]) is evaluated in closed form:
    v[s] = P[s] + min_{t<=s}(m[t] + c[t] - P[t]) with P the running sum of
    c and m = min(diag, up).  That reorders float additions relative to the
    kernel's slot-by-slot chain (a few ulps of the row sum).  An A row of
    length 1 takes the kernel's own branch: its corridor is the whole of
    row 0, so its distance is the running sum of its costs (``_single_row``)."""
    K, S, d = _check_args(feats, lengths, tile_rep, ti_idx, tj_idx, ti, metric)
    wv, off, W = stripe_frame(band, wv_max)
    rows = S if rows is None else min(int(rows), S)
    x = _unit_frames(feats, metric)
    U = ti_idx.shape[0]
    out = torch.full((U, ti, ti), INF, dtype=torch.float32, device=feats.device)
    step = max(1, _REF_MAX_ELEMS // (ti * ti * W * d))
    for u0 in range(0, U, step):
        out[u0 : u0 + step] = _ref_group(
            x, lengths.long(), tile_rep.long(), ti_idx[u0 : u0 + step].long(),
            tj_idx[u0 : u0 + step].long(), ti=ti, band=band, off=off, W=W,
            metric=metric, rows=rows,
        )
    lane = torch.arange(ti, device=feats.device)
    a_rows = ti_idx.long()[:, None] * ti + lane                         # [U, ti]
    u1, r1 = torch.nonzero(lengths.long()[a_rows] == 1, as_tuple=True)
    if len(u1):
        out[u1, r1] = _single_row(x, lengths.long(), a_rows[u1, r1],
                                  tj_idx.long()[u1, None] * ti + lane, metric)
    return out


def _single_row(x, lens, a_ids, b_ids, metric):
    """[n, ti] DTW of the length-1 A sequences ``a_ids`` [n] against the B
    sequences ``b_ids`` [n, ti]: every cell of row 0 lies in the diag
    corridor (``oracle/dtw.py``: den = 0), so D[0, lb-1] is the sum of the
    costs of a_0 against b_0..b_{lb-1}, added left to right as K1 adds them."""
    a = x[a_ids, 0][:, None, None, :]                                   # [n, 1, 1, d]
    b = x[b_ids]                                                        # [n, ti, S, d]
    if metric == "cosine":
        cost = 1.0 - torch.sum(a * b, dim=-1)
    else:
        cost = torch.sum((a - b) ** 2, dim=-1)
        if metric == "euclidean":
            cost = torch.sqrt(cost)
    lb = lens[b_ids]                                                    # [n, ti]
    run = torch.cumsum(cost, dim=-1)
    return torch.gather(run, -1, torch.clamp(lb - 1, 0, x.shape[1] - 1)[..., None])[..., 0]


def _ref_group(x, lens, rep, ti_idx, tj_idx, *, ti, band, off, W, metric, rows):
    dev = x.device
    n = ti_idx.shape[0]
    lane = torch.arange(ti, device=dev)
    a_rows = ti_idx[:, None] * ti + lane                     # [n, ti]
    b_rows = tj_idx[:, None] * ti + lane
    la = lens[a_rows][:, :, None]                            # [n, ti, 1]
    lb = lens[b_rows][:, None, :]                            # [n, 1, ti]
    numm = (rep[tj_idx] - 1)[:, None, None]                  # [n, 1, 1]
    den_t = la - 1
    den = torch.clamp(den_t, min=1)
    half = den // 2
    num = lb - 1
    thresh = max(int(band), 1) * torch.maximum(den_t, num)   # [n, ti, ti]
    ex = lb - 1 - numm + off                                 # [n, 1, ti]
    ex_ok = (ex >= 0) & (ex < W)
    ex_idx = torch.clamp(ex, 0, W - 1)[..., None].expand(n, ti, ti, 1)
    A = x[a_rows]                                            # [n, ti, S, d]
    Bt = x[b_rows].permute(0, 2, 1, 3)                       # [n, S, ti, d]
    slot = torch.arange(W, device=dev)
    n_idx = torch.arange(n, device=dev)[:, None, None]

    prev = torch.full((n, ti, ti, W), INF, device=dev)
    prev[..., off] = 0.0
    c_prev = torch.full((n, ti, 1), -1, device=dev, dtype=torch.long)
    res = torch.full((n, ti, ti), INF, device=dev)
    for i in range(min(rows, int(la.max()))):
        ci = torch.minimum((i * numm + half) // den, numm)   # [n, ti, 1]
        k = (ci - c_prev)[..., None]                         # [n, ti, 1, 1]
        c_prev = ci
        up_i = slot + k                                      # [n, ti, 1, W]
        up = _gather_or_inf(prev, up_i, W)
        diag = _gather_or_inf(prev, up_i - 1, W)
        j = ci + slot - off                                  # [n, ti, W]
        jj = j[..., None]                                    # [n, ti, W, 1]
        valid = (
            (jj >= 0)
            & (jj < lb[:, :, None, :])
            & (i < la[..., None])
            & (torch.abs(jj * den_t[..., None] - i * num[:, :, None, :])
               <= thresh[:, :, None, :])
        )                                                    # [n, ti, W, ti]
        b = Bt[n_idx, torch.clamp(j, 0, x.shape[1] - 1)]     # [n, ti, W, ti, d]
        a = A[:, :, i][:, :, None, None, :]                  # [n, ti, 1, 1, d]
        if metric == "cosine":
            cost = 1.0 - torch.sum(a * b, dim=-1)
        else:
            cost = torch.sum((a - b) ** 2, dim=-1)
            if metric == "euclidean":
                cost = torch.sqrt(cost)
        valid = valid.transpose(2, 3)                        # [n, ti, ti, W]
        cost = cost.transpose(2, 3)
        c0 = torch.where(valid, cost, 0.0)
        P = torch.cumsum(c0, dim=-1)
        g = torch.where(valid, torch.minimum(diag, up) + c0 - P, INF)
        prev = torch.where(valid, P + torch.cummin(g, dim=-1).values, INF)
        done = (la - 1 == i) & ex_ok                         # [n, ti, ti]
        res = torch.where(done, torch.gather(prev, -1, ex_idx)[..., 0], res)
    return res


def _gather_or_inf(prev, idx, W):
    ok = (idx >= 0) & (idx < W)
    shape = prev.shape
    g = torch.gather(prev, -1, torch.clamp(idx, 0, W - 1).expand(shape))
    return torch.where(ok.expand(shape), g, INF)


# ------------------------------------------------------------------ K2, K3


def dtw_tile_pairs(
    feats: torch.Tensor,       # [K, S, d] f32 padded corpus
    lengths: torch.Tensor,     # [K] i32 (pad entries: length 1)
    ti_idx: torch.Tensor,      # [U] i32 tile-row (A) indices
    tj_idx: torch.Tensor,      # [U] i32 tile-col (B) indices
    *,
    ti: int = 128,
    band: int | None = None,
    auto_widen: bool = True,
    metric: str = "euclidean",
    rows: int | None = None,
    scan_steps: int | None = None,
    frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """K2: square-tile DTW for U tile-pairs -> [U, ti, ti] f32 (unnormalized).

    ``out[u, r, c]`` is the DTW of A sequence ``ti_idx[u]*ti + r`` against B
    sequence ``tj_idx[u]*ti + c`` over the cells i < la, j < lb,
    |j - i| <= wv, with wv = S unbanded, ``max(band, |la - lb|)`` with
    ``auto_widen``, else ``band``.  ``rows`` must cover every A length of
    the call: a longer A sequence comes back +inf.  ``scan_steps`` is
    accepted so the signature matches the JAX kernel, and ignored: it bounds
    the depth of the TPU kernel's Hillis-Steele row scan, while the CUDA
    kernel and the twin walk each row cell by cell, which needs no depth.
    ``frames``: the corpus's ``strip_layout(feats, ti, metric)``, built once
    by a caller that launches many times; built here when None.

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin.  Any other device raises."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    if band is not None and int(band) < 0:
        raise ValueError(f"band={band} must be >= 0 or None")
    if feats.device.type == "cpu":
        return dtw_tile_pairs_ref(
            feats, lengths, ti_idx, tj_idx, ti=ti, band=band,
            auto_widen=auto_widen, metric=metric, rows=rows,
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if not 1 <= ti <= 1024:
        raise ValueError(f"ti={ti} must be in [1, 1024] (one thread per B lane)")
    rows = S if rows is None else min(int(rows), S)
    U = ti_idx.shape[0]
    out = torch.empty((U, ti, ti), dtype=torch.float32, device=feats.device)
    if U == 0:
        return out
    x = _check_frames(frames, feats, ti, metric)
    nc4 = strip_channels(d)
    R = _tile_strip_rows(S, nc4)
    lanes = _strip_lanes(ti, S, nc4, R)
    lengths, ti_idx, tj_idx = lengths.contiguous(), ti_idx.contiguous(), tj_idx.contiguous()
    _launch(
        "dtw_tile", 5, 10,
        x.data_ptr(), lengths.data_ptr(), ti_idx.data_ptr(), tj_idx.data_ptr(), out.data_ptr(),
        S, nc4, ti, U, rows, -1 if band is None else int(band), int(bool(auto_widen)),
        METRICS[metric], lanes, R,
        device=feats.device,
    )
    dtw_tile_pairs.launches += 1
    return out


dtw_tile_pairs.launches = 0


def dtw_tile_pairs_ref(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    ti_idx: torch.Tensor,
    tj_idx: torch.Tensor,
    *,
    ti: int = 128,
    band: int | None = None,
    auto_widen: bool = True,
    metric: str = "euclidean",
    rows: int | None = None,
    scan_steps: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K2 on the device of ``feats``: the same
    signature and contracts (``scan_steps`` ignored, +inf past ``rows``)."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    rows = S if rows is None else min(int(rows), S)
    return _tile_pairs_wavefront(
        feats, lengths, ti_idx, tj_idx, ti=ti, rows=rows, cols=S, metric=metric,
        band=band, auto_widen=auto_widen,
    )


def lane_full_width(width: int, S: int) -> int:
    """K3's class width W: ``width`` rounded up to a multiple of 8, at most S."""
    W = 8 * -(-int(width) // 8)
    if not 1 <= W <= S:
        raise ValueError(f"width={width} must be in [1, S={S}]")
    return W


def _systolic_rows(nc4: int) -> int:
    """K3's A rows a lane (fixed in csrc/dtw_lane_full.cu): 4, or 2 at 8
    float4s a frame, whose 4 rows would take 128 registers of A frames."""
    return 2 if nc4 == 8 else 4


def _lane_full_warps(ti: int, W: int, nc4: int, R: int) -> int:
    """Warps (one pair each) per block of K3: the block stages a pass's A
    frames (32R x nc4 float4s) once and each warp keeps a boundary row of W
    floats.  The launch keeps the most warps resident on an SM within its
    shared memory: 8, 4, 2 or 1 warps a block (at most ti), the widest on a
    tie."""
    best = None
    for warps in sorted({min(ti, w) for w in (8, 4, 2, 1)}, reverse=True):
        smem = 16 * 32 * R * nc4 + 4 * W * warps
        if smem > _SMEM_BUDGET:
            continue
        resident = min(_SM_SMEM // (smem + _BLOCK_RESERVED), 32, 64 // warps) * warps
        if best is None or resident > best[0]:
            best = (resident, warps)
    if best is None:
        raise ValueError(
            f"a boundary row of {W} floats does not fit one block's shared memory "
            f"({_SMEM_BUDGET} bytes)"
        )
    return best[1]


def dtw_tile_lane_full_pairs(
    feats: torch.Tensor,       # [K, S, d] f32 padded corpus
    lengths: torch.Tensor,     # [K] i32 (pad entries: length 1)
    ti_idx: torch.Tensor,      # [U] i32 tile-row (A) indices
    tj_idx: torch.Tensor,      # [U] i32 tile-col (B) indices
    *,
    ti: int,
    width: int,
    metric: str = "euclidean",
    rows: int | None = None,
    frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """K3: exact unbanded DTW for U tile-pairs with full-width DP rows ->
    [U, ti, ti] f32 (unnormalized).

    Class contracts: ``width`` (rounded up to a multiple of 8, at most S)
    must cover every B length and ``rows`` every A length of the call; a
    pair beyond either comes back +inf.  ``frames``: the corpus's
    ``frame_layout(feats, metric)``, built once by a caller that launches
    many times (checked on any device); built here when None.

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin.  Any other device raises."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    W = lane_full_width(width, S)
    if frames is not None:
        _check_frame_layout(frames, feats, metric)
    if feats.device.type == "cpu":
        return dtw_tile_lane_full_pairs_ref(
            feats, lengths, ti_idx, tj_idx, ti=ti, width=width, metric=metric, rows=rows,
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    rows = S if rows is None else min(int(rows), S)
    U = ti_idx.shape[0]
    out = torch.empty((U, ti, ti), dtype=torch.float32, device=feats.device)
    if U == 0:
        return out
    x = _check_frame_layout(frames, feats, metric)
    nc4 = strip_channels(d)
    warps = _lane_full_warps(ti, W, nc4, _systolic_rows(nc4))
    lengths, ti_idx, tj_idx = lengths.contiguous(), ti_idx.contiguous(), tj_idx.contiguous()
    _launch(
        "dtw_lane_full", 5, 8,
        x.data_ptr(), lengths.data_ptr(), ti_idx.data_ptr(), tj_idx.data_ptr(), out.data_ptr(),
        S, nc4, ti, U, rows, W, METRICS[metric], warps,
        device=feats.device,
    )
    dtw_tile_lane_full_pairs.launches += 1
    return out


dtw_tile_lane_full_pairs.launches = 0


def dtw_tile_lane_full_pairs_ref(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    ti_idx: torch.Tensor,
    tj_idx: torch.Tensor,
    *,
    ti: int,
    width: int,
    metric: str = "euclidean",
    rows: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K3 on the device of ``feats``: the same
    signature and contracts (+inf past ``width`` or ``rows``)."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    rows = S if rows is None else min(int(rows), S)
    return _tile_pairs_wavefront(
        feats, lengths, ti_idx, tj_idx, ti=ti, rows=rows, cols=lane_full_width(width, S),
        metric=metric, band=None, auto_widen=False,
    )


def _tile_pairs_wavefront(feats, lengths, ti_idx, tj_idx, *, ti, rows, cols, metric,
                          band, auto_widen):
    """[U, ti, ti]: the DTW of A sequence ti_idx[u]*ti + r against B
    sequence tj_idx[u]*ti + c on a grid of ``rows`` x ``cols`` cells; a pair
    that does not fit the grid (or has an empty sequence) is +inf.  Each
    tile-pair runs in blocks of A rows sized to keep the per-diagonal cost
    build under _REF_MAX_ELEMS elements."""
    x = _unit_frames(feats, metric)
    d = x.shape[2]
    lens = lengths.long()
    dev = x.device
    U = ti_idx.shape[0]
    out = torch.full((U, ti, ti), INF, dtype=torch.float32, device=dev)
    lane = torch.arange(ti, device=dev)
    for u, (I, J) in enumerate(zip(ti_idx.tolist(), tj_idx.tolist())):
        a_ids, b_ids = I * ti + lane, J * ti + lane
        la_all, lb = lens[a_ids], lens[b_ids]
        n_c = min(cols, int(lb.max()))
        if n_c < 1:
            continue
        b_seq = x[b_ids, :n_c]                                    # [ti, n_c, d]
        r_step = max(1, _REF_MAX_ELEMS // (ti * n_c * d))
        for r0 in range(0, ti, r_step):
            la = la_all[r0 : r0 + r_step]
            n_r = min(rows, int(la.max()))
            if n_r < 1:
                continue
            out[u, r0 : r0 + r_step] = _wavefront_block(
                x[a_ids[r0 : r0 + r_step], :n_r], b_seq, la, lb, rows=rows, cols=cols,
                metric=metric, band=band, auto_widen=auto_widen,
            )
    return out


def _wavefront_block(a_seq, b_seq, la, lb, *, rows, cols, metric, band, auto_widen):
    """[R, C] DTW of every A sequence (a_seq [R, N, d]) against every B
    sequence (b_seq [C, M, d]), evaluated cell by cell along anti-diagonals
    k = i + j: D[i, j] = c[i, j] + min(D[i-1, j-1], D[i-1, j], D[i, j-1]),
    with the costs of diagonal k built from squared differences as the
    kernels build them.  Cells outside i < la, j < lb (and the band) are
    +inf; pairs beyond ``rows`` or ``cols`` are +inf."""
    R, N, _ = a_seq.shape
    C, M, _ = b_seq.shape
    dev = a_seq.device
    la2, lb2 = la[:, None], lb[None, :]
    ok = (la2 >= 1) & (lb2 >= 1) & (la2 <= rows) & (lb2 <= cols)
    res = torch.full((R, C), INF, dtype=torch.float32, device=dev)
    if not bool(ok.any()):
        return res
    k_star = la2 + lb2 - 2
    if band is None:
        wv = None
    elif auto_widen:
        wv = torch.clamp(torch.abs(la2 - lb2), min=int(band))[..., None]
    else:
        wv = int(band)
    read = torch.clamp(lb - 1, 0, M - 1)[None, :, None].expand(R, C, 1)
    inf_col = torch.full((R, C, 1), INF, device=dev)
    prev = torch.full((R, C, M), INF, device=dev)
    prev2 = prev
    cols_all = torch.arange(M, device=dev)
    for k in range(int(k_star[ok].max()) + 1):
        j_lo, j_hi = max(0, k - N + 1), min(M, k + 1)
        jj = cols_all[j_lo:j_hi]
        ii = k - jj
        a_k = a_seq[:, ii][:, None]                               # [R, 1, m, d]
        b_k = b_seq[:, j_lo:j_hi][None]                           # [1, C, m, d]
        if metric == "cosine":
            cost = 1.0 - torch.sum(a_k * b_k, dim=-1)
        else:
            cost = torch.sum((a_k - b_k) ** 2, dim=-1)
            if metric == "euclidean":
                cost = torch.sqrt(cost)
        valid = (ii < la[:, None, None]) & (jj < lb[None, :, None])   # [R, C, m]
        if wv is not None:
            valid = valid & (torch.abs(jj - ii) <= wv)
        c = torch.full((R, C, M), INF, device=dev)
        c[..., j_lo:j_hi] = torch.where(valid, cost, INF)
        diag = torch.cat([inf_col, prev2[..., :-1]], dim=-1)
        left = torch.cat([inf_col, prev[..., :-1]], dim=-1)
        pred = torch.minimum(torch.minimum(diag, prev), left)
        if k == 0:
            pred[..., 0] = 0.0                                    # D[-1, -1] = 0
        cur = c + pred
        res = torch.where(k_star == k, torch.gather(cur, -1, read)[..., 0], res)
        prev2, prev = prev, cur
    return torch.where(ok, res, INF)


# ------------------------------------------------------------------ K4, K5


def _check_widen(band, wv_max):
    if band is None or int(band) < 0:
        raise ValueError(f"band={band}: the widen stripe kernels require a band >= 0")
    return stripe_frame(band, wv_max)


def dtw_tile_lane_pairs(
    feats: torch.Tensor,       # [K, S, d] f32 padded corpus
    lengths: torch.Tensor,     # [K] i32 (pad entries: length 1)
    ti_idx: torch.Tensor,      # [U] i32 tile-row (A) indices
    tj_idx: torch.Tensor,      # [U] i32 tile-col (B) indices
    *,
    ti: int,
    band: int,
    wv_max: int,
    auto_widen: bool = True,
    metric: str = "euclidean",
    rows: int | None = None,
    frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """K4: widen-banded DTW for U tile-pairs -> [U, ti, ti] f32 (unnormalized).

    ``out[u, r, c]`` is the DTW of A sequence ``ti_idx[u]*ti + r`` against B
    sequence ``tj_idx[u]*ti + c`` over the cells i < la, j < lb,
    |j - i| <= pw, pw = ``max(band, |la - lb|)`` with ``auto_widen``, else
    ``band``.  Class contracts: ``rows`` >= every A length and ``wv_max`` >=
    every real pair's pw; a pair beyond either comes back +inf.
    ``frames``: the corpus's ``strip_layout(feats, ti, metric)``, built once
    by a caller that launches many times (checked on any device); built here
    when None.

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin.  Any other device raises."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    wv, _, W = _check_widen(band, wv_max)
    if frames is not None:
        _check_frames(frames, feats, ti, metric)
    if feats.device.type == "cpu":
        return dtw_tile_lane_pairs_ref(
            feats, lengths, ti_idx, tj_idx, ti=ti, band=band, wv_max=wv_max,
            auto_widen=auto_widen, metric=metric, rows=rows,
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    if not 1 <= ti <= 1024:
        raise ValueError(f"ti={ti} must be in [1, 1024] (one thread per B lane)")
    rows = S if rows is None else min(int(rows), S)
    U = ti_idx.shape[0]
    out = torch.empty((U, ti, ti), dtype=torch.float32, device=feats.device)
    if U == 0:
        return out
    x = _check_frames(frames, feats, ti, metric)
    nc4 = strip_channels(d)
    lanes = _strip_lanes(ti, W, nc4, STRIP_ROWS)
    lengths, ti_idx, tj_idx = lengths.contiguous(), ti_idx.contiguous(), tj_idx.contiguous()
    _launch(
        "dtw_lane", 5, 10,
        x.data_ptr(), lengths.data_ptr(), ti_idx.data_ptr(), tj_idx.data_ptr(), out.data_ptr(),
        S, nc4, ti, U, rows, int(band), wv, int(bool(auto_widen)), METRICS[metric], lanes,
        device=feats.device,
    )
    dtw_tile_lane_pairs.launches += 1
    return out


dtw_tile_lane_pairs.launches = 0


def dtw_tile_lane_pairs_ref(
    feats: torch.Tensor,
    lengths: torch.Tensor,
    ti_idx: torch.Tensor,
    tj_idx: torch.Tensor,
    *,
    ti: int,
    band: int,
    wv_max: int,
    auto_widen: bool = True,
    metric: str = "euclidean",
    rows: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K4, and of K5 (the same function and
    contracts): the banded recurrence cell by cell over each tile-pair, then
    +inf for every pair whose half-width exceeds the class bound."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    wv, _, _ = _check_widen(band, wv_max)
    rows = S if rows is None else min(int(rows), S)
    out = _tile_pairs_wavefront(
        feats, lengths, ti_idx, tj_idx, ti=ti, rows=rows, cols=S, metric=metric,
        band=int(band), auto_widen=auto_widen,
    )
    if auto_widen:
        lens = lengths.long()
        lane = torch.arange(ti, device=feats.device)
        la = lens[ti_idx.long()[:, None] * ti + lane][:, :, None]
        lb = lens[tj_idx.long()[:, None] * ti + lane][:, None, :]
        out = torch.where(torch.abs(la - lb) > wv, INF, out)
    return out


def dtw_tile_stripe_pairs(
    feats: torch.Tensor,       # [K, S, d] f32 padded corpus
    lengths: torch.Tensor,     # [K] i32 (pad entries: length 1)
    ti_idx: torch.Tensor,      # [U] i32 tile-row (A) indices
    tj_idx: torch.Tensor,      # [U] i32 tile-col (B) indices
    *,
    ti: int,
    band: int,
    wv_max: int,
    auto_widen: bool = True,
    metric: str = "euclidean",
    rows: int | None = None,
    frames: torch.Tensor | None = None,
) -> torch.Tensor:
    """K5: K4's function and contracts with one warp per pair, each pair
    walking only its own band: faster than K4 for wide class stripes ->
    [U, ti, ti] f32 (unnormalized).  ``frames``: the corpus's
    ``frame_layout(feats, metric)``, built once by a caller that launches
    many times (checked on any device); built here when None.

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin (K4's).  Any other device raises."""
    K, S, d = _check_args(feats, lengths, None, ti_idx, tj_idx, ti, metric)
    wv, _, _ = _check_widen(band, wv_max)
    if frames is not None:
        _check_frame_layout(frames, feats, metric)
    if feats.device.type == "cpu":
        return dtw_tile_lane_pairs_ref(
            feats, lengths, ti_idx, tj_idx, ti=ti, band=band, wv_max=wv_max,
            auto_widen=auto_widen, metric=metric, rows=rows,
        )
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device {feats.device}")
    rows = S if rows is None else min(int(rows), S)
    U = ti_idx.shape[0]
    out = torch.empty((U, ti, ti), dtype=torch.float32, device=feats.device)
    if U == 0:
        return out
    x = _check_frame_layout(frames, feats, metric)
    nc4 = strip_channels(d)
    warps = _stripe_warps(ti, wv, nc4)
    lengths, ti_idx, tj_idx = lengths.contiguous(), ti_idx.contiguous(), tj_idx.contiguous()
    _launch(
        "dtw_tile_stripe", 5, 10,
        x.data_ptr(), lengths.data_ptr(), ti_idx.data_ptr(), tj_idx.data_ptr(), out.data_ptr(),
        S, nc4, ti, U, rows, int(band), wv, int(bool(auto_widen)), METRICS[metric], warps,
        device=feats.device,
    )
    dtw_tile_stripe_pairs.launches += 1
    return out


dtw_tile_stripe_pairs.launches = 0


# ------------------------------------------------------------------ K6, K7

# The per-pair kernels' ranges (reference: the square kernel's VMEM ceiling
# and the stripe kernel's ceiling).
MAX_KERNEL_SEQ_LEN = 1024
MAX_STRIPE_SEQ_LEN = 4096


def stripe_width(seq_len: int, band: int | None, auto_widen: bool,
                 max_len_diff: int | None) -> int | None:
    """Stripe width (a multiple of 128) of the per-pair stripe route, or
    None where it does not apply (exact port of the reference's routing
    rule): it needs a band with a static widen bound and a stripe at most a
    quarter of the row (``4*W <= seq_len``).  The port's K7 holds the exact
    width 2*wv+2 inside it."""
    if band is None:
        return None
    if auto_widen:
        if max_len_diff is None:
            return None
        wv_max = max(int(band), int(max_len_diff))
    else:
        wv_max = int(band)
    w = 128 * (-(-(2 * wv_max + 2) // 128))
    if 4 * w > seq_len:
        return None
    return w


def scan_len_diff_classes(seq_len: int, band: int | None, auto_widen: bool) -> list[int]:
    """Upper-inclusive |len_a - len_b| thresholds that split a bucket's pairs
    into groups with one per-pair route each (exact port): the class bound
    is the ``max_len_diff`` the per-pair scheduler passes."""
    if band is None or not auto_widen:
        return [seq_len]
    bounds: list[int] = []
    prev = stripe_width(seq_len, band, auto_widen, 0)
    for dd in range(1, seq_len + 1):
        w = stripe_width(seq_len, band, auto_widen, dd)
        if w != prev:
            bounds.append(dd - 1)
            prev = w
    bounds.append(seq_len)
    return bounds


def pallas_supported(seq_len: int, band: int | None, auto_widen: bool,
                     max_len_diff: int | None) -> bool:
    """Whether ``dtw_batch_pallas`` takes this bucket: K6 up to
    MAX_KERNEL_SEQ_LEN, K7 where the stripe applies up to MAX_STRIPE_SEQ_LEN."""
    if seq_len <= MAX_KERNEL_SEQ_LEN:
        return True
    w = stripe_width(seq_len, band, auto_widen, max_len_diff)
    return w is not None and seq_len <= MAX_STRIPE_SEQ_LEN


def _check_pairs(a, b, len_a, len_b, metric, normalize) -> tuple[int, int, int, int]:
    """(B, R, S, d) of a gathered pair batch after checking it."""
    if a.dim() != 3 or b.dim() != 3 or a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"a, b must be [B, R, d] and [B, S, d] float32, got "
                         f"{tuple(a.shape)} {a.dtype}, {tuple(b.shape)} {b.dtype}")
    B, R, d = a.shape
    if b.shape[0] != B or b.shape[2] != d:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} disagree on B or d")
    for name, t in (("len_a", len_a), ("len_b", len_b)):
        if t.shape != (B,) or t.dtype != torch.int32:
            raise ValueError(f"{name} must be [{B}] int32, got {tuple(t.shape)} {t.dtype}")
        if t.device != a.device or b.device != a.device:
            raise ValueError(f"{name} and b must be on {a.device}")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if normalize not in ("none", "path_len"):
        raise ValueError(f"unknown normalize {normalize!r}")
    return B, R, b.shape[1], d


def _normalized(dist, len_a, len_b, normalize):
    """path_len divides by la + lb (an out-of-frame +inf stays +inf)."""
    if normalize == "path_len":
        return dist / (len_a + len_b).to(torch.float32)
    return dist


def _rowscan_geometry(S: int, band: int | None, nc4: int) -> tuple[int, int]:
    """(G, R) of a K6 launch: G lanes a pair (32/G pairs a warp) and R rows a
    lane, the fastest of G in {8, 16, 32} x R in {1, 2, 4} on the H100 at the
    per-pair route's classes and launch sizes (S=128, 256, 512 and 1024;
    PERF.md).  Narrow groups idle less in a narrow band's short windows,
    but each holds a boundary row of S floats, which caps residency at long
    S.  Banded: 8 lanes up to S=128, 16 up to 256, else 32, 2 rows a lane.
    Unbanded: 8 lanes up to S=256, else 32, 4 rows a lane.  At 8 float4s a
    frame at most 2 rows: 4 would take 128 registers of A frames
    (csrc/dtw_rowscan.cu builds exactly these)."""
    if band is None:
        G, R = (8, 4) if S <= 256 else (32, 4)
    else:
        G, R = (8, 2) if S <= 128 else (16, 2) if S <= 256 else (32, 2)
    return G, min(R, 2) if nc4 == 8 else R


def _rowscan_warps(G: int, R: int, S: int, nc4: int) -> int:
    """Warps per block of K6 (32/G pairs each): each holds a pass's A frames
    (32R x nc4 float4s) and a boundary row of S floats a group, rounded up to
    whole float4s; at most 4 warps (the kernel's launch bound)."""
    per_warp = 4 * (4 * 32 * R * nc4 + 4 * -(-(32 // G) * int(S) // 4))
    warps = min(4, _SMEM_BUDGET // per_warp)
    if warps < 1:
        raise ValueError(
            f"{32 // G} boundary rows of {S} floats do not fit one block's shared memory "
            f"({_SMEM_BUDGET} bytes)"
        )
    return warps


def dtw_batch_pallas(
    a: torch.Tensor,           # [B, R, d] f32, the shorter side of each pair
    b: torch.Tensor,           # [B, S, d] f32, R <= S
    len_a: torch.Tensor,       # [B] i32 (every len_a <= R)
    len_b: torch.Tensor,       # [B] i32
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    max_len_diff: int | None = None,
) -> torch.Tensor:
    """K6: per-pair DTW over gathered pairs -> [B] f32, normalized as
    ``normalize`` says (the reference's drop-in for ``dtw_batch``).

    Unbanded or widen-banded (pw = ``max(band, |la - lb|)`` with
    ``auto_widen``).  Where ``stripe_width`` applies and S <= 4096 it routes
    to K7 (``_dtw_batch_stripe``), as the reference does; otherwise S must be
    at most 1024.  ``max_len_diff`` is a static bound on |la - lb| over the
    batch: a pair beyond it comes back +inf on the stripe route.

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin.  Any other device raises."""
    B, R, S, d = _check_pairs(a, b, len_a, len_b, metric, normalize)
    if R > S:
        raise ValueError("pass the shorter sequence first (R <= S)")
    if band is not None and int(band) < 0:
        raise ValueError(f"band={band} must be >= 0 or None")
    if stripe_width(S, band, auto_widen, max_len_diff) is not None and S <= MAX_STRIPE_SEQ_LEN:
        return _dtw_batch_stripe(
            a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen,
            normalize=normalize, max_len_diff=max_len_diff,
        )
    if S > MAX_KERNEL_SEQ_LEN:
        raise ValueError(
            f"padded length {S} > {MAX_KERNEL_SEQ_LEN} and the stripe route does not "
            "apply (it needs a band with a static max_len_diff bound)"
        )
    if a.device.type == "cpu":
        return dtw_batch_pallas_ref(
            a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen,
            normalize=normalize,
        )
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty((B,), dtype=torch.float32, device=a.device)
    if B == 0:
        return out
    nc4 = strip_channels(d)
    G, rows = _rowscan_geometry(S, band, nc4)
    warps = _rowscan_warps(G, rows, S, nc4)
    # The gathered pairs are the kernel's layout already (one pair's frames
    # consecutive) unless their channels need padding or unit frames.
    xa, xb = frame_layout(a, metric), frame_layout(b, metric)
    len_a, len_b = len_a.contiguous(), len_b.contiguous()
    _launch(
        "dtw_rowscan", 5, 10,
        xa.data_ptr(), xb.data_ptr(), len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(),
        B, R, S, nc4, -1 if band is None else int(band), int(bool(auto_widen)),
        METRICS[metric], warps, G, rows,
        device=a.device,
    )
    dtw_batch_pallas.launches += 1
    return _normalized(out, len_a, len_b, normalize)


dtw_batch_pallas.launches = 0


def dtw_batch_pallas_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    len_a: torch.Tensor,
    len_b: torch.Tensor,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
) -> torch.Tensor:
    """Plain PyTorch twin of K6 on the device of ``a``: the same contracts
    (+inf past R rows), cell by cell."""
    _check_pairs(a, b, len_a, len_b, metric, normalize)
    dist = _pairs_wavefront(a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen)
    return _normalized(dist, len_a, len_b, normalize)


def _stripe_half_width(band, auto_widen, max_len_diff) -> int:
    """K7's class half-width wv, with its frame check."""
    if band is None or int(band) < 0:
        raise ValueError(f"band={band}: the stripe kernel requires a band >= 0")
    if auto_widen:
        if max_len_diff is None:
            raise ValueError("the stripe kernel with auto_widen needs max_len_diff")
        return max(int(band), int(max_len_diff))
    return int(band)


# K7's A rows a lane (fixed in csrc/dtw_stripe.cu; PERF.md has the
# measurement against 1 row).
STRIPE_LANE_ROWS = 2


def _stripe_pair_warps(wv: int, nc4: int) -> int:
    """Warps (one pair each) per block of K7: each holds a pass's A frames
    (32R x nc4 float4s, R = STRIPE_LANE_ROWS) and a boundary row of 2*wv+1
    floats rounded up to whole float4s; at most 4 warps (the kernel's launch
    bound)."""
    per_warp = 4 * (4 * 32 * STRIPE_LANE_ROWS * nc4 + 4 * -(-(2 * int(wv) + 1) // 4))
    warps = min(4, _SMEM_BUDGET // per_warp)
    if warps < 1:
        raise ValueError(
            f"a boundary row of {2 * int(wv) + 1} floats does not fit one block's shared "
            f"memory ({_SMEM_BUDGET} bytes)"
        )
    return warps


def _dtw_batch_stripe(
    a: torch.Tensor,           # [B, R, d] f32
    b: torch.Tensor,           # [B, S, d] f32
    len_a: torch.Tensor,       # [B] i32
    len_b: torch.Tensor,       # [B] i32
    *,
    metric: str = "euclidean",
    band: int,
    auto_widen: bool = True,
    normalize: str = "none",
    max_len_diff: int | None = None,
) -> torch.Tensor:
    """K7: per-pair widen-banded DTW in a stripe frame over gathered pairs
    -> [B] f32, normalized as ``normalize`` says.

    Only where ``stripe_width`` applies.  The class half-width is
    wv = ``max(band, max_len_diff)`` with ``auto_widen``, else ``band``; a
    pair whose own half-width exceeds it comes back +inf.

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
    tensors take the plain twin.  Any other device raises."""
    B, R, S, d = _check_pairs(a, b, len_a, len_b, metric, normalize)
    wv = _stripe_half_width(band, auto_widen, max_len_diff)
    if stripe_width(S, band, auto_widen, max_len_diff) is None:
        raise ValueError(f"the stripe route does not apply at S={S}, band={band}, "
                         f"max_len_diff={max_len_diff}")
    if a.device.type == "cpu":
        return _dtw_batch_stripe_ref(
            a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen,
            normalize=normalize, max_len_diff=max_len_diff,
        )
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.empty((B,), dtype=torch.float32, device=a.device)
    if B == 0:
        return out
    nc4 = strip_channels(d)
    warps = _stripe_pair_warps(wv, nc4)
    # The gathered pairs are the kernel's layout already (one pair's frames
    # consecutive) unless their channels need padding or unit frames.
    xa, xb = frame_layout(a, metric), frame_layout(b, metric)
    len_a, len_b = len_a.contiguous(), len_b.contiguous()
    _launch(
        "dtw_stripe", 5, 9,
        xa.data_ptr(), xb.data_ptr(), len_a.data_ptr(), len_b.data_ptr(), out.data_ptr(),
        B, R, S, nc4, int(band), wv, int(bool(auto_widen)), METRICS[metric], warps,
        device=a.device,
    )
    _dtw_batch_stripe.launches += 1
    return _normalized(out, len_a, len_b, normalize)


_dtw_batch_stripe.launches = 0


def _dtw_batch_stripe_ref(
    a: torch.Tensor,
    b: torch.Tensor,
    len_a: torch.Tensor,
    len_b: torch.Tensor,
    *,
    metric: str = "euclidean",
    band: int,
    auto_widen: bool = True,
    normalize: str = "none",
    max_len_diff: int | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of K7 on the device of ``a``: the banded
    recurrence cell by cell, +inf where a pair's half-width exceeds wv."""
    _check_pairs(a, b, len_a, len_b, metric, normalize)
    wv = _stripe_half_width(band, auto_widen, max_len_diff)
    dist = _pairs_wavefront(a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen)
    if auto_widen:
        dist = torch.where(torch.abs(len_a.long() - len_b.long()) > wv, INF, dist)
    return _normalized(dist, len_a, len_b, normalize)


def _pairs_wavefront(a, b, len_a, len_b, *, metric, band, auto_widen):
    """[B] unnormalized DTW of a[p, :la] against b[p, :lb] over the banded
    cells (``_wavefront_block``'s recurrence and costs, one pair per row of
    the wavefront), in groups of pairs that keep the per-diagonal cost build
    under _REF_MAX_ELEMS elements.  A pair longer than its padded sequence
    (or empty) is +inf."""
    a, b = _unit_frames(a, metric), _unit_frames(b, metric)
    B, N, d = a.shape
    M = b.shape[1]
    dev = a.device
    la_all, lb_all = len_a.long(), len_b.long()
    out = torch.full((B,), INF, dtype=torch.float32, device=dev)
    step = max(1, _REF_MAX_ELEMS // (max(N, M) * d))
    cols = torch.arange(M, device=dev)
    for p0 in range(0, B, step):
        la, lb = la_all[p0 : p0 + step], lb_all[p0 : p0 + step]
        G = la.shape[0]
        ok = (la >= 1) & (lb >= 1) & (la <= N) & (lb <= M)
        if not bool(ok.any()):
            continue
        k_star = la + lb - 2
        if band is None:
            wv = None
        elif auto_widen:
            wv = torch.clamp(torch.abs(la - lb), min=int(band))[:, None]
        else:
            wv = int(band)
        read = torch.clamp(lb - 1, 0, M - 1)[:, None]
        inf_col = torch.full((G, 1), INF, device=dev)
        prev = torch.full((G, M), INF, device=dev)
        prev2 = prev
        res = torch.full((G,), INF, device=dev)
        a_g, b_g = a[p0 : p0 + step], b[p0 : p0 + step]
        for k in range(int(k_star[ok].max()) + 1):
            j_lo, j_hi = max(0, k - N + 1), min(M, k + 1)
            jj = cols[j_lo:j_hi]
            ii = k - jj
            if metric == "cosine":
                cost = 1.0 - torch.sum(a_g[:, ii] * b_g[:, j_lo:j_hi], dim=-1)
            else:
                cost = torch.sum((a_g[:, ii] - b_g[:, j_lo:j_hi]) ** 2, dim=-1)
                if metric == "euclidean":
                    cost = torch.sqrt(cost)
            valid = (ii < la[:, None]) & (jj < lb[:, None])             # [G, m]
            if wv is not None:
                valid = valid & (torch.abs(jj - ii) <= wv)
            c = torch.full((G, M), INF, device=dev)
            c[:, j_lo:j_hi] = torch.where(valid, cost, INF)
            diag = torch.cat([inf_col, prev2[:, :-1]], dim=-1)
            left = torch.cat([inf_col, prev[:, :-1]], dim=-1)
            pred = torch.minimum(torch.minimum(diag, prev), left)
            if k == 0:
                pred[:, 0] = 0.0                                        # D[-1, -1] = 0
            cur = c + pred
            res = torch.where(k_star == k, torch.gather(cur, 1, read)[:, 0], res)
            prev2, prev = prev, cur
        out[p0 : p0 + step] = torch.where(ok, res, INF)
    return out

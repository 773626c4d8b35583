"""K1 on Hopper: diag-corridor banded DTW over tile-pairs.

Port of ``audio_pattern_discovery_tpu/ops/dtw_pallas.py``
(``dtw_tile_lane_diag_pairs`` and its kernel ``_dtw_lane_diag_kernel``,
plus the pure-math helpers ``diag_class_bounds`` and ``tile_rep_lengths``).

``dtw_tile_lane_diag_pairs`` launches the CUDA C++ kernel in
``csrc/dtw_lane_diag.cu`` on CUDA tensors and runs the plain PyTorch twin
``dtw_tile_lane_diag_pairs_ref`` on CPU tensors; it never falls back from
one to the other.  Both compute the same thing: for U tile-pairs
``(ti_idx[u], tj_idx[u])`` of a length-sorted, padded corpus, the
UNNORMALIZED diag-corridor DTW of A sequence ``ti_idx[u]*ti + r`` against B
sequence ``tj_idx[u]*ti + c`` as ``out[u, r, c]``, each DP row held in a
sheared stripe frame of ``W = 2*wv+2`` slots around the centre line
``c(i) = round(i*(lbm-1)/(la-1))`` (``lbm`` = the B tile's representative
length).  Class contracts, as in the JAX kernel: ``rows`` >= every A length
in the call, ``wv_max`` >= the stripe half-width from ``diag_class_bounds``.
With them met every corridor cell lies in the frame and the distance is
exact; a pair whose corner cell falls outside the frame comes back +inf.

Not ported (TPU-only levers, measured null on the TPU): ``stack``,
``bgroup``, ``hoist_build``, ``dyn_roll=False`` with its ``kmax``, and the
8-sublane / 128-lane padding.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

INF = float("inf")
METRICS = {"euclidean": 0, "sqeuclidean": 1, "cosine": 2}

# Shared-memory budget of one block (H100: 227 KB usable); the stripe takes
# W * lanes floats and the staged A rows A_CHUNK_BYTES.
_SMEM_BUDGET = 200 * 1024
_A_CHUNK_BYTES = 16 * 1024
# The plain twin builds [pairs, W, d] costs per row; tile-pairs go in
# groups that keep that under this many elements.
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


def lane_diag_frame(band: int, wv_max: int) -> tuple[int, int, int]:
    """(wv, off, W): the stripe half-width actually used (never below the
    band), the slot of the frame centre, and the frame width 2*wv+2."""
    wv = max(int(band), int(wv_max))
    return wv, wv + 1, 2 * wv + 2


def _check_args(feats, lengths, tile_rep, ti_idx, tj_idx, ti, metric):
    if feats.dim() != 3 or feats.dtype != torch.float32:
        raise ValueError(f"feats must be [K, S, d] float32, got {tuple(feats.shape)} {feats.dtype}")
    K, S, d = feats.shape
    if K % ti:
        raise ValueError(f"K={K} must be padded to a multiple of ti={ti}")
    nT = K // ti
    for name, t, n in (("lengths", lengths, K), ("tile_rep", tile_rep, nT),
                       ("ti_idx", ti_idx, None), ("tj_idx", tj_idx, None)):
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


def _lanes(ti: int, W: int, d: int) -> tuple[int, int]:
    """(threads per block, A rows staged per shared-memory chunk)."""
    a_chunk = max(1, _A_CHUNK_BYTES // (4 * d))
    lanes = min(ti, 128)
    while lanes > 32 and 4 * (W * lanes + a_chunk * d) > _SMEM_BUDGET:
        lanes //= 2
    if 4 * (W * lanes + a_chunk * d) > _SMEM_BUDGET:
        raise ValueError(
            f"diag stripe of W={W} slots does not fit one block's shared "
            f"memory ({_SMEM_BUDGET} bytes at {lanes} lanes)"
        )
    return lanes, a_chunk


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
) -> torch.Tensor:
    """Diag-corridor DTW for U tile-pairs -> [U, ti, ti] f32 (unnormalized).

    CUDA tensors launch the kernel (``launches`` counts the launches); CPU
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
    wv, _, W = lane_diag_frame(band, wv_max)
    rows = S if rows is None else min(int(rows), S)
    U = ti_idx.shape[0]
    out = torch.empty((U, ti, ti), dtype=torch.float32, device=feats.device)
    if U == 0:
        return out
    lanes, a_chunk = _lanes(ti, W, d)
    a = _unit_frames(feats, metric).contiguous()
    nT = K // ti
    b = a.reshape(nT, ti, S, d).permute(0, 3, 2, 1).contiguous()   # [nT, d, S, ti]
    lengths, tile_rep = lengths.contiguous(), tile_rep.contiguous()
    ti_idx, tj_idx = ti_idx.contiguous(), tj_idx.contiguous()
    err = _kernel()(
        a.data_ptr(), b.data_ptr(), lengths.data_ptr(), tile_rep.data_ptr(),
        ti_idx.data_ptr(), tj_idx.data_ptr(), out.data_ptr(),
        S, d, ti, U, rows, int(band), wv, METRICS[metric], lanes, a_chunk,
        torch.cuda.current_stream(feats.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"dtw_lane_diag kernel launch failed: CUDA error {err}")
    dtw_tile_lane_diag_pairs.launches += 1
    return out


dtw_tile_lane_diag_pairs.launches = 0


def _kernel():
    from audio_pattern_discovery_tpu_torch.ops import _build

    lib = _build.load("dtw_lane_diag")
    fn = lib.apd_dtw_lane_diag
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    return fn


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
    kernel's slot-by-slot chain (a few ulps of the row sum)."""
    K, S, d = _check_args(feats, lengths, tile_rep, ti_idx, tj_idx, ti, metric)
    wv, off, W = lane_diag_frame(band, wv_max)
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
    return out


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

"""Blocked long-sequence DTW: the DP grid in [BLK, BLK] blocks, walked in
block anti-diagonal order with only boundary vectors in memory (K8).

Port of ``audio_pattern_discovery_tpu/ops/dtw_long.py``.  Block (I, J)
depends only on blocks (I-1, J), (I, J-1) and (I-1, J-1), so every block of
one block anti-diagonal k = I + J is independent.  Memory holds, per pair,
the bottom row of the latest block of every block column (``H``
[B, nB, BLK]), the right column of the latest block of every block row
(``V`` [B, nB, BLK]) and the bottom-right corners of the blocks one
diagonal back, never the [S, S] cost matrix, so sequences of tens of
thousands of frames fit.  The per-pair scheduler sends every bucket that
K6 and K7 do not take here, and so does a diag bucket past
``MAX_KERNEL_SEQ_LEN``.

``dtw_long_batch`` launches K8 (``csrc/dtw_long_block.cu``) on CUDA
tensors: one launch per block anti-diagonal, a warp per active block and
pair (``launches`` counts the launches), and runs the plain twin
``dtw_long_batch_ref`` on CPU tensors; it never falls back from one to the
other.  The twin is the reference's loop over the 2*nB-1 block diagonals,
vectorized over pairs and the diagonal's blocks, with each block walked
cell by cell along its own anti-diagonals (``dtw_block_kernel``), so twin
and kernel add every cell's terms in the same order and differ only in
each cost's rounding.  The reference resolves each block row with a
min-plus Hillis-Steele scan, which reassociates the additions along the
row.

Costs are the port's kernels' (unit frames for cosine, squared differences
and their sqrt), not the reference's Gram expansion.  The diag corridor is
the reference's |j(la-1) - i(lb-1)| <= max(band, 1) max(la-1, lb-1), in
64-bit products: equal to the reference's int32 ones below 2^15 frames a
side, and exact past them.
"""

from __future__ import annotations

import torch

from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
    _REF_MAX_ELEMS,
    _SMEM_BUDGET,
    INF,
    METRICS,
    _check_pairs,
    _launch,
    _normalized,
    _unit_frames,
    frame_layout,
    strip_channels,
)

BAND_MODES = {"widen": 1, "diag": 2}   # csrc/dtw_long_block.cu; 0 is unbanded


def long_block_shape(bucket: int, cap: int = 256) -> tuple[int, int]:
    """(block, padded_len) of the blocked path for a bucket: a block of
    ``min(cap, next power of two)`` frames and the bucket padded up to a
    multiple of it (the reference's ``_long_block_shape``: the +inf length
    masks make the padding free, and an odd bucket never gets a 1-frame
    block)."""
    blk = min(cap, 1 << max(bucket - 1, 1).bit_length())
    padded = -(-bucket // blk) * blk
    return int(blk), int(padded)


def _band_width(band, auto_widen, len_a, len_b):
    """The widen band's half-width per pair, or None without a band."""
    if band is None:
        return None
    w = torch.full_like(len_a, int(band), dtype=torch.int64)
    if auto_widen:
        w = torch.maximum(w, (len_a.long() - len_b.long()).abs())
    return w


def dtw_block_kernel(
    a_blk: torch.Tensor,       # [..., BLK, d] rows row0.. of sequence a
    b_blk: torch.Tensor,       # [..., BLK, d] columns col0.. of sequence b
    top: torch.Tensor,         # [..., BLK] D[row0-1, col0 + :]
    left: torch.Tensor,        # [..., BLK] D[row0 + :, col0-1]
    corner: torch.Tensor,      # [...]      D[row0-1, col0-1]
    row0,                      # [...] or int: global row of the block's first row
    col0,                      # [...] or int: global column of its first column
    len_a,                     # [...] or int
    len_b,                     # [...] or int
    *,
    metric: str = "euclidean",
    band: int | None = None,
    band_width=None,           # [...] or int: widen half-width (>= |la-lb| if widened)
    band_mode: str = "widen",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DP block -> (bottom row [..., BLK], right column [..., BLK], hit
    value [...], hit mask [...]): the reference's contract, batched over the
    leading dimensions.  The hit is D[la-1, lb-1] where the block holds that
    cell (value 0 elsewhere).  Cells outside i < la, j < lb and the band are
    +inf; the virtual origin D[-1, -1] = 0 is the caller's corner of block
    (0, 0).  The block is walked along its own anti-diagonals, each cell
    cost + min(diag, up, left) from squared-difference costs, as K8 walks
    it."""
    *lead, BLK, d = a_blk.shape
    dev = a_blk.device
    n = 1
    for s in lead:
        n *= s

    def flat(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype).expand(*lead).reshape(n)

    bw = None if band_width is None else flat(band_width, torch.int64)
    bottom, right, hit_val, has_hit = _block_walk(
        _unit_frames(a_blk.float(), metric).reshape(n, BLK, d),
        _unit_frames(b_blk.float(), metric).reshape(n, BLK, d),
        top.float().reshape(n, BLK), left.float().reshape(n, BLK), flat(corner, torch.float32),
        flat(row0, torch.int64), flat(col0, torch.int64), flat(len_a, torch.int64),
        flat(len_b, torch.int64), metric=metric, band=band, band_width=bw, band_mode=band_mode,
    )
    return (bottom.reshape(*lead, BLK), right.reshape(*lead, BLK), hit_val.reshape(lead),
            has_hit.reshape(lead))


def _row_ranges(gi, la, lb, *, band, band_width, band_mode):
    """Each row's columns [lo, hi] in its pair's grid and band (lo > hi:
    none): rows gi [N, n] of pairs with lengths la, lb [N].  The band's
    cells form one run per row, so the reference's cell masks are these
    ranges: |i - j| <= band_width (widen), or the diag corridor
    ceil((i num - t) / den) <= j <= floor((i num + t) / den) with
    den = la-1, num = lb-1, t = max(band, 1) max(den, num) (every column
    where den = 0)."""
    la, lb = la[:, None], lb[:, None]
    lo = torch.zeros_like(gi)
    hi = (lb - 1).expand_as(gi)
    if band is not None and band_mode == "diag":
        den, num = la - 1, lb - 1
        thresh = max(int(band), 1) * torch.maximum(den, num)
        d1 = den.clamp(min=1)
        lo = torch.where(den > 0, -torch.div(thresh - gi * num, d1, rounding_mode="floor"), lo)
        hi = torch.where(den > 0, torch.div(gi * num + thresh, d1, rounding_mode="floor"), hi)
    elif band is not None:
        lo, hi = gi - band_width[:, None], gi + band_width[:, None]
    lo, hi = lo.clamp(min=0), torch.minimum(hi, lb - 1)
    return torch.where(gi < la, lo, 1), torch.where(gi < la, hi, 0)


def _block_walk(a, b, top, left, corner, row0, col0, la, lb, *, metric, band, band_width,
                band_mode):
    """``dtw_block_kernel`` on N flat blocks (a, b [N, BLK, d] already unit
    frames for cosine; the rest [N]).  The DP runs on the block extended by
    its boundary row and column: ext[R, C] = D[row0 + R - 1, col0 + C - 1]
    with ext[0, 0] the corner, ext[0, 1:] the top and ext[1:, 0] the left
    column, one extended anti-diagonal T = R + C a step, each held as a
    vector over R.  A step reads only entries its two predecessors wrote."""
    N, BLK, _ = a.shape
    dev = a.device
    rows = torch.arange(BLK + 1, device=dev)
    # Each row's valid columns, block-local: cell (R, C) is valid iff
    # lo[R-1] <= C-1 <= hi[R-1].
    lo_r, hi_r = _row_ranges(row0[:, None] + rows[None, :BLK], la, lb, band=band,
                             band_width=band_width, band_mode=band_mode)
    lo_r, hi_r = lo_r - col0[:, None], hi_r - col0[:, None]
    b_rev = b.flip(1)                                       # B frame C-1 at BLK - C
    e2, e1, cur = (torch.empty((N, BLK + 1), device=dev) for _ in range(3))
    e2[:, 0] = corner
    e1[:, 0], e1[:, 1] = top[:, 0], left[:, 0]
    bottom = torch.empty((N, BLK), device=dev)
    right = torch.empty((N, BLK), device=dev)
    # The terminal cell in extended coordinates, where this block holds it.
    r_hit, c_hit = la - row0, lb - col0
    has_hit = (r_hit >= 1) & (r_hit <= BLK) & (c_hit >= 1) & (c_hit <= BLK)
    t_hit = torch.where(has_hit, r_hit + c_hit, -1)
    hit_steps = set(t_hit[has_hit].tolist())
    hit_val = torch.zeros((N,), device=dev)
    for T in range(2, 2 * BLK + 1):
        lo, hi = max(1, T - BLK), min(T - 1, BLK)
        a_t = a[:, lo - 1 : hi]                             # A frames R-1
        b_t = b_rev[:, BLK - T + lo : BLK - T + hi + 1]     # B frames C-1 = T-R-1
        if metric == "cosine":
            cost = 1.0 - torch.sum(a_t * b_t, dim=-1)
        else:
            cost = torch.sum((a_t - b_t) ** 2, dim=-1)
            if metric == "euclidean":
                cost = torch.sqrt(cost)
        cc = T - 1 - rows[lo : hi + 1]
        valid = (cc >= lo_r[:, lo - 1 : hi]) & (cc <= hi_r[:, lo - 1 : hi])
        pred = torch.minimum(torch.minimum(e2[:, lo - 1 : hi], e1[:, lo - 1 : hi]),
                             e1[:, lo : hi + 1])
        torch.add(torch.where(valid, cost, INF), pred, out=cur[:, lo : hi + 1])
        if T <= BLK:                                        # the boundary cells of diagonal T
            cur[:, 0], cur[:, T] = top[:, T - 1], left[:, T - 1]
        else:
            bottom[:, T - BLK - 1] = cur[:, BLK]
            right[:, T - BLK - 1] = cur[:, T - BLK]
        if T in hit_steps:
            hit_val = torch.where(t_hit == T, cur.gather(1, r_hit.clamp(0, BLK)[:, None])[:, 0],
                                  hit_val)
        e2, e1, cur = e1, cur, e2
    return bottom, right, hit_val, has_hit


def _check_long(a, b, len_a, len_b, metric, normalize, block, band_mode):
    """(B, S, d, BLK, nB) after the reference's preconditions."""
    B, R, S, d = _check_pairs(a, b, len_a, len_b, metric, normalize)
    if R != S:
        raise ValueError("dtw_long_batch requires equal padded lengths")
    if band_mode not in BAND_MODES:
        raise ValueError(f"unknown band_mode {band_mode!r}")
    BLK = min(int(block), S)
    if BLK < 1 or S % BLK:
        raise ValueError(f"padded length {S} not a multiple of block {BLK}")
    return B, S, d, BLK, S // BLK


def dtw_long_batch_ref(
    a: torch.Tensor,           # [B, S, d] padded (S a multiple of block)
    b: torch.Tensor,           # [B, S, d]
    len_a: torch.Tensor,       # [B] i32
    len_b: torch.Tensor,       # [B] i32
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    block: int = 256,
    band_mode: str = "widen",
) -> torch.Tensor:
    """Plain PyTorch twin of ``dtw_long_batch`` on the device of ``a``: the
    reference's scan over the 2*nB-1 block anti-diagonals with boundary
    rows H, right columns V and the corner snapshot, each step's blocks
    walked by ``dtw_block_kernel`` for all pairs and active blocks at once,
    the pairs in groups that keep a step's cost build under
    ``_REF_MAX_ELEMS`` elements."""
    B, S, d, BLK, nB = _check_long(a, b, len_a, len_b, metric, normalize, block, band_mode)
    dev = a.device
    xa, xb = _unit_frames(a.float(), metric), _unit_frames(b.float(), metric)
    la_all, lb_all = len_a.long(), len_b.long()
    bw_all = _band_width(band, auto_widen, len_a, len_b)
    out = torch.full((B,), INF, dtype=torch.float32, device=dev)
    step = max(1, _REF_MAX_ELEMS // (nB * BLK * d))
    for p0 in range(0, B, step):
        P = min(step, B - p0)
        la, lb = la_all[p0 : p0 + P], lb_all[p0 : p0 + P]
        bw = None if bw_all is None else bw_all[p0 : p0 + P]
        ab = xa[p0 : p0 + P].reshape(P, nB, BLK, d)
        bb = xb[p0 : p0 + P].reshape(P, nB, BLK, d)
        H = torch.full((P, nB, BLK), INF, device=dev)
        V = torch.full((P, nB, BLK), INF, device=dev)
        snap = torch.full((P, nB), INF, device=dev)       # H[..., -1] one step back
        res = torch.full((P,), INF, device=dev)
        for k in range(2 * nB - 1):
            new_snap = H[:, :, -1].clone()
            Js = torch.arange(max(0, k - nB + 1), min(k, nB - 1) + 1, device=dev)
            Is = k - Js
            W = len(Js)
            top = torch.where((Is == 0)[None, :, None], INF, H[:, Js])
            left = torch.where((Js == 0)[None, :, None], INF, V[:, Is])
            corner = torch.where(Js == 0, torch.where(Is == 0, 0.0, INF)[None, :],
                                 snap[:, (Js - 1).clamp(min=0)])
            bottom, right, hit_val, has_hit = dtw_block_kernel(
                ab[:, Is], bb[:, Js], top, left, corner,
                (Is * BLK)[None, :].expand(P, W), (Js * BLK)[None, :].expand(P, W),
                la[:, None].expand(P, W), lb[:, None].expand(P, W), metric=metric, band=band,
                band_width=None if bw is None else bw[:, None].expand(P, W),
                band_mode=band_mode,
            )
            H[:, Js], V[:, Is] = bottom, right
            res = torch.where(has_hit.any(1), torch.where(has_hit, hit_val, 0.0).sum(1), res)
            snap = new_snap
        out[p0 : p0 + P] = res
    return _normalized(out, len_a, len_b, normalize)


def _long_rows(BLK: int, nc4: int) -> int:
    """K8's A rows a lane (R): 4, or 2 at 8 float4s a frame (K3's rule), and
    fewer where the block is not a multiple of a pass of 32R rows (blocks
    of 64 and 32 frames); a block must be a multiple of 32 frames."""
    for R in (4, 2, 1):
        if R <= (2 if nc4 == 8 else 4) and BLK % (32 * R) == 0:
            return R
    raise ValueError(f"K8 takes blocks of a multiple of 32 frames, got {BLK}")


def _long_warps(R: int, nc4: int, BLK: int) -> int:
    """Warps (one block of one pair each) per CUDA block of K8: each stages
    a pass's A frames (32R x nc4 float4s) and the block's boundary row (BLK
    floats); at most 4 warps (the kernel's launch bound)."""
    per_warp = 4 * (4 * 32 * R * nc4 + 4 * -(-BLK // 4))
    warps = min(4, _SMEM_BUDGET // per_warp)
    if warps < 1:
        raise ValueError(f"a pass of {32 * R} rows of {4 * nc4} channels does not fit one "
                         f"block's shared memory ({_SMEM_BUDGET} bytes)")
    return warps


def dtw_long_batch(
    a: torch.Tensor,           # [B, S, d] f32 padded (S a multiple of block)
    b: torch.Tensor,           # [B, S, d] f32
    len_a: torch.Tensor,       # [B] i32
    len_b: torch.Tensor,       # [B] i32
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    block: int = 256,
    band_mode: str = "widen",
) -> torch.Tensor:
    """Batched DTW over long padded sequences with boundary-only memory ->
    [B] f32, normalized as ``normalize`` says (the reference's drop-in for
    ``dtw_batch`` at equal padded lengths).  A pair with an empty side or a
    side past S is +inf.

    CUDA tensors launch K8 once per block anti-diagonal (``launches``
    counts the launches; the block must be a multiple of 32 frames there);
    CPU tensors take the plain twin.  Any other device raises."""
    B, S, d, BLK, nB = _check_long(a, b, len_a, len_b, metric, normalize, block, band_mode)
    if band is not None and int(band) < 0:
        raise ValueError(f"band={band} must be >= 0 or None")
    kw = dict(metric=metric, band=band, auto_widen=auto_widen, normalize=normalize, block=block,
              band_mode=band_mode)
    if a.device.type == "cpu":
        return dtw_long_batch_ref(a, b, len_a, len_b, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    out = torch.full((B,), INF, dtype=torch.float32, device=a.device)
    if B == 0:
        return out
    xa, xb = frame_layout(a, metric), frame_layout(b, metric)
    long_block_columns(xa, xb, len_a.contiguous(), len_b.contiguous(), out, block=BLK, J0=0,
                       nJ=nB, metric=metric, band=band, auto_widen=auto_widen,
                       band_mode=band_mode)
    dtw_long_batch.launches += 2 * nB - 1
    return _normalized(out, len_a, len_b, normalize)


def long_block_columns(
    xa: torch.Tensor,          # [B, S, 4 nc4] f32: frame_layout of the padded A sides
    xb: torch.Tensor,          # [B, S, 4 nc4] f32: of the B sides
    len_a: torch.Tensor,       # [B] i32 contiguous
    len_b: torch.Tensor,       # [B] i32 contiguous
    out: torch.Tensor,         # [B] f32: the terminal cells land here
    *,
    block: int,
    J0: int,
    nJ: int,
    halo: torch.Tensor | None = None,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    band_mode: str = "widen",
) -> torch.Tensor:
    """K8 on block columns [J0, J0 + nJ) of every pair's grid, on the card:
    the 2*nB-1 block anti-diagonals in order on the current stream, one
    launch each (the wrapper that calls this counts them).  ``halo``
    [B, nB, BLK] holds the right columns of block column J0 - 1 (None: +inf,
    the grid's left edge); the stripe's blocks that hold a pair's terminal
    cell write it (unnormalized) into ``out``.  Returns the right columns of
    block column J0 + nJ - 1, [B, nB, BLK]: the next stripe's halo.  The
    whole grid is J0 = 0, nJ = nB; a stripe of block columns on each device
    with its left neighbour's returned columns as ``halo`` gives the same
    distances."""
    B, S, c4 = xa.shape
    nc4, BLK = c4 // 4, int(block)
    nB = S // BLK
    if not (0 <= J0 and 1 <= nJ and J0 + nJ <= nB):
        raise ValueError(f"block columns [{J0}, {J0 + nJ}) outside the grid's {nB}")
    if halo is not None and (halo.shape != (B, nB, BLK) or not halo.is_contiguous()):
        raise ValueError(f"halo must be a contiguous [{B}, {nB}, {BLK}] tensor")
    R = _long_rows(BLK, nc4)
    warps = _long_warps(R, nc4, BLK)
    # Boundaries: every entry is written before it is read.
    H = torch.empty((B, nJ, BLK), dtype=torch.float32, device=xa.device)
    V = torch.empty((B, nB, BLK), dtype=torch.float32, device=xa.device)
    corners = torch.empty((2, B, nJ + 1), dtype=torch.float32, device=xa.device)
    mode = 0 if band is None else BAND_MODES[band_mode]
    _launch(
        "dtw_long_block", 9, 15,
        xa.data_ptr(), xb.data_ptr(), len_a.data_ptr(), len_b.data_ptr(), H.data_ptr(),
        V.data_ptr(), corners.data_ptr(), 0 if halo is None else halo.data_ptr(), out.data_ptr(),
        B, S, nc4, BLK, nB, 0, 2 * nB - 1, J0, nJ, mode, 0 if band is None else int(band),
        int(bool(auto_widen)), METRICS[metric], warps, R,
        stream=torch.cuda.current_stream(xa.device).cuda_stream,
    )
    return V


dtw_long_batch.launches = 0

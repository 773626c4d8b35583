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

``dtw_long_pairs`` is the merged call: any list of pairs by index into a
corpus (on the card its ``frame_layout``, built once a job), each pair on
its own grid of ceil(la/BLK) x ceil(lb/BLK) blocks, and every launch one
block anti-diagonal of every pair that has one, so a call takes
max_p(nBa + nBb - 1) launches however many pairs it holds.  The per-pair
scheduler sends all of a job's K8 pairs through it.  ``dtw_long_batch``
is its case ia = ib = arange(B) on two padded batches.  On CUDA tensors
both launch K8 (``csrc/dtw_long_block.cu``: a CUDA block per DP block
and pair, its frames staged in shared memory; ``dtw_long_batch.launches``
counts the launches of both), and on CPU tensors they run the plain twins
``dtw_long_pairs_ref`` and ``dtw_long_batch_ref``; they never fall back
from one to the other.  The batch twin is the reference's loop over the
2*nB-1 block diagonals, vectorized over pairs and the diagonal's blocks,
with each block walked cell by cell along its own anti-diagonals (``dtw_block_kernel``), so twin
and kernel add every cell's terms in the same order and differ only in
each cost's rounding.  The reference resolves each block row with a
min-plus Hillis-Steele scan, which reassociates the additions along the
row.

Costs are the port's kernels' (unit frames for cosine, squared differences
and their sqrt), not the reference's Gram expansion.  Under
``matmul_dtype="bfloat16"`` they are the reference's bf16 Gram recipe
instead (``ops/dtw.pairwise_cost``): the dot product of the frames rounded
to bf16, summed in fp32, and for the Euclidean metrics
max(|a|^2 + |b|^2 - 2 a.b, 0) with the squared norms of the unrounded
frames (``gram_layout``; K8's Gram instantiation on the card).  The diag corridor is
the reference's |j(la-1) - i(lb-1)| <= max(band, 1) max(la-1, lb-1), in
64-bit products: equal to the reference's int32 ones below 2^15 frames a
side, and exact past them.
"""

from __future__ import annotations

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import (
    _BLOCK_RESERVED,
    _REF_MAX_ELEMS,
    _SM_SMEM,
    INF,
    METRICS,
    _check_frame_layout,
    _check_pairs,
    _launch,
    _normalized,
    _unit_frames,
    frame_layout,
)
from audio_pattern_discovery_tpu_torch.ops.dtw import round_bf16

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
    matmul_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One DP block -> (bottom row [..., BLK], right column [..., BLK], hit
    value [...], hit mask [...]): the reference's contract, batched over the
    leading dimensions.  The hit is D[la-1, lb-1] where the block holds that
    cell (value 0 elsewhere).  Cells outside i < la, j < lb and the band are
    +inf; the virtual origin D[-1, -1] = 0 is the caller's corner of block
    (0, 0).  The block is walked along its own anti-diagonals, each cell
    cost + min(diag, up, left) from squared-difference costs (the bf16 Gram
    recipe under ``matmul_dtype="bfloat16"``), as K8 walks it."""
    *lead, BLK, d = a_blk.shape
    dev = a_blk.device
    n = 1
    for s in lead:
        n *= s

    def flat(x, dtype):
        return torch.as_tensor(x, device=dev).to(dtype).expand(*lead).reshape(n)

    bw = None if band_width is None else flat(band_width, torch.int64)
    xa, xb = _unit_frames(a_blk.float(), metric), _unit_frames(b_blk.float(), metric)
    norms = None
    if matmul_dtype == "bfloat16":
        norms = (torch.sum(xa * xa, dim=-1).reshape(n, BLK),
                 torch.sum(xb * xb, dim=-1).reshape(n, BLK))
        xa, xb = round_bf16(xa), round_bf16(xb)
    bottom, right, hit_val, has_hit = _block_walk(
        xa.reshape(n, BLK, d), xb.reshape(n, BLK, d),
        top.float().reshape(n, BLK), left.float().reshape(n, BLK), flat(corner, torch.float32),
        flat(row0, torch.int64), flat(col0, torch.int64), flat(len_a, torch.int64),
        flat(len_b, torch.int64), metric=metric, band=band, band_width=bw, band_mode=band_mode,
        norms=norms,
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
                band_mode, norms=None):
    """``dtw_block_kernel`` on N flat blocks (a, b [N, BLK, d] already unit
    frames for cosine; the rest [N]).  ``norms`` (the A and B frames'
    squared norms, [N, BLK] each) selects the bf16 Gram costs: a and b are
    then the rounded frames, and each cell costs 1 - a.b (cosine) or
    max((|a|^2 + |b|^2) - 2 a.b, 0) and its sqrt.  The DP runs on the block extended by
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
    if norms is not None:
        na, nb_rev = norms[0], norms[1].flip(1)
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
            if norms is None:
                cost = torch.sum((a_t - b_t) ** 2, dim=-1)
            else:
                cost = torch.clamp(
                    (na[:, lo - 1 : hi] + nb_rev[:, BLK - T + lo : BLK - T + hi + 1])
                    - 2.0 * torch.sum(a_t * b_t, dim=-1), min=0.0)
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
    matmul_dtype: str | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of ``dtw_long_batch`` on the device of ``a``: the
    reference's scan over the 2*nB-1 block anti-diagonals with boundary
    rows H, right columns V and the corner snapshot, each step's blocks
    walked by ``dtw_block_kernel`` for all pairs and active blocks at once,
    the pairs in groups that keep a step's cost build under
    ``_REF_MAX_ELEMS`` elements."""
    B, S, d, BLK, nB = _check_long(a, b, len_a, len_b, metric, normalize, block, band_mode)
    dev = a.device
    xa, xb = a.float(), b.float()        # dtw_block_kernel normalizes cosine's frames
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
                band_mode=band_mode, matmul_dtype=matmul_dtype,
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


# K8's own shared-memory budget per CUDA block: the H100's opt-in maximum.
_LONG_SMEM_BUDGET = 227 * 1024
# B frames a warp holds staged (csrc/dtw_long_block.cu: kRing chunks of 32).
_LONG_RING = 3 * 32
# The fewest warps an SM must keep resident for K8 to stage B in rings.
_LONG_MIN_RESIDENT = 8


def _long_d4(R: int, nc4: int, stage_b: bool) -> int:
    """The instantiation's compile-time frame width (``apd_dtw_long_block``):
    the float4s a lane's A frames hold in registers, 0 where they are read
    from the warp's staged pass."""
    if stage_b and ((R == 4 and nc4 in (1, 2, 4)) or (R == 2 and nc4 == 8)):
        return nc4
    return 0


def _long_smem(BLK: int, nc4: int, R: int, warps: int, stage_b: bool) -> int:
    """Shared memory of one K8 CUDA block, in bytes (``smem_bytes`` of
    ``csrc/dtw_long_block.cu``): per warp its pass's A frames (where they
    are not in registers) and its ring of B frames (``stage_b``), then
    warps + 1 row buffers and the left column, and per pass its counters."""
    n_pass = BLK // (32 * R)
    own = (0 if _long_d4(R, nc4, stage_b) else 32 * R * nc4) + (_LONG_RING * nc4 if stage_b
                                                                 else 0)
    words = (warps + 2) * BLK + 3 * (n_pass + 1) + n_pass
    return 16 * warps * own + -(-words * 4 // 16) * 16


def _long_config(R: int, nc4: int, BLK: int) -> tuple[int, bool]:
    """(warps, stage_b) of a K8 CUDA block (one DP block): a warp per pass
    of 32R rows, at most 8 (the kernel's launch bound), with B's frames
    staged in rings where that keeps at least ``_LONG_MIN_RESIDENT`` warps
    resident on an SM.  Otherwise B goes through the read-only cache, and
    the warps drop until their staged A passes fit.  Raises where one warp's
    does not."""
    n_pass = BLK // (32 * R)
    warps = min(n_pass, 8)
    smem = _long_smem(BLK, nc4, R, warps, True)
    resident = warps * min(32, _SM_SMEM // (smem + _BLOCK_RESERVED))
    if smem <= _LONG_SMEM_BUDGET and resident >= _LONG_MIN_RESIDENT:
        return warps, True
    while warps > 1 and _long_smem(BLK, nc4, R, warps, False) > _LONG_SMEM_BUDGET:
        warps -= 1
    smem = _long_smem(BLK, nc4, R, warps, False)
    if smem > _LONG_SMEM_BUDGET:
        raise ValueError(f"a K8 pass of {32 * R} rows of {4 * nc4} channels needs {smem} bytes "
                         f"of shared memory (budget {_LONG_SMEM_BUDGET})")
    return warps, False


def _long_plan(ia, ib, la, lb, Sa: int, Sb: int, BLK: int, *, nB: int | None = None,
               J0: int = 0, nJ: int | None = None) -> dict:
    """K8's launch plan for P pairs (host arrays): each pair's grid, its
    boundaries' offsets and the blocks of every block anti-diagonal.

    ``nB`` None: each pair its own grid of ceil(la/BLK) x ceil(lb/BLK)
    blocks, none where a side is empty or past its layout (Sa, Sb frames:
    the distance stays +inf).  ``nB`` given: every pair the nB x nB grid,
    block columns [J0, J0 + nJ) of it (a stripe; V in ``[P, nB, BLK]``,
    the halo's layout).  Returns ``meta`` [P, 8] int64 (ia, ib, la, lb,
    nBa, then the pair's offsets into H, V and the corners), ``items``
    [nK, P+1] int32 (per diagonal k, the prefix sum over pairs of their
    blocks on it), ``totals`` [nK] int32 (blocks a launch), the sizes of H,
    V and one parity of the corners, and ``launches`` (diagonals with a
    block)."""
    ia, ib = np.asarray(ia, np.int64), np.asarray(ib, np.int64)
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    P = len(la)
    if nB is None:
        ok = (la > 0) & (lb > 0) & (la <= Sa) & (lb <= Sb)
        nBa = np.where(ok, -(-la // BLK), 0)
        Je = np.where(ok, -(-lb // BLK), 0)
        J0 = 0
    else:
        nBa = np.full(P, nB, np.int64)
        Je = np.full(P, min(J0 + nJ, nB), np.int64)
    nJp = np.maximum(Je - J0, 0)
    nBa = np.where(nJp > 0, nBa, 0)
    nK = int(max(int((nBa + Je - 1).max(initial=0)), 0))
    k = np.arange(nK, dtype=np.int64)[:, None]
    lo = np.maximum(J0, k - nBa[None, :] + 1)
    hi = np.minimum(k, Je[None, :] - 1)
    cnt = np.clip(hi - lo + 1, 0, None)
    items = np.zeros((nK, P + 1), np.int64)
    np.cumsum(cnt, axis=1, out=items[:, 1:])
    if items.size and items[:, -1].max() >= 2**31:
        raise ValueError("too many DP blocks on one block diagonal for one K8 launch")

    def starts(n):
        return np.concatenate([[0], np.cumsum(n)[:-1]]).astype(np.int64) if P else n

    meta = np.stack([ia, ib, la, lb, nBa, BLK * starts(nJp),
                     BLK * (starts(nBa) if nB is None else nB * np.arange(P)),
                     starts(nJp + 1)], axis=1).astype(np.int64)
    totals = np.ascontiguousarray(items[:, -1], dtype=np.int32)
    return dict(meta=np.ascontiguousarray(meta), items=np.ascontiguousarray(items, np.int32),
                totals=totals, nK=nK, n_h=int(BLK * nJp.sum()),
                n_v=int(BLK * (nBa.sum() if nB is None else P * nB)),
                n_c=int((nJp + 1).sum()), launches=int((totals > 0).sum()))


def long_boundary_bytes(la, lb, BLK: int) -> np.ndarray:
    """Device bytes of each pair's boundaries in a merged K8 call: H and V
    (ceil(lb/BLK) + ceil(la/BLK) rows of BLK floats) and its corners."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    nBa, nBb = -(-la // BLK), -(-lb // BLK)
    return 4 * (BLK * (nBa + nBb) + 2 * (nBb + 1))


def gram_layout(feats: torch.Tensor, metric: str = "euclidean") -> tuple[torch.Tensor, torch.Tensor]:
    """K8's inputs for the bf16 Gram costs of a corpus [K, S, d]: the
    ``frame_layout`` of its frames (cosine's unit frames, normalized in
    fp32) rounded to bf16 and held as fp32, and [K, S] fp32 the squared
    norms of the unrounded frames.  The per-pair scheduler builds it once a
    job, beside where the fp32 path builds ``frame_layout``."""
    x = _unit_frames(feats.float(), metric)
    return frame_layout(round_bf16(x)), torch.sum(x * x, dim=-1).contiguous()


def _check_gram_layout(frames, feats, metric) -> tuple[torch.Tensor, torch.Tensor]:
    """``frames`` (a prebuilt ``gram_layout``) after checking it against the
    corpus, or the layout built here."""
    if frames is None:
        return gram_layout(feats, metric)
    layout, norms = frames
    layout = _check_frame_layout(layout, feats, metric)
    if (norms.shape != feats.shape[:2] or norms.dtype != torch.float32
            or norms.device != feats.device or not norms.is_contiguous()):
        raise ValueError(f"gram_layout norms must be a contiguous {tuple(feats.shape[:2])} "
                         f"float32 tensor on {feats.device}, got {tuple(norms.shape)} "
                         f"{norms.dtype} on {norms.device}")
    return layout, norms


def _launch_plan(fa, fb, plan: dict, out, *, BLK: int, J0: int, halo, metric, band, auto_widen,
                 band_mode, events=None, config: tuple[int, bool] | None = None,
                 norms: tuple[torch.Tensor, torch.Tensor] | None = None) -> torch.Tensor:
    """Run a plan of K8 on the card on the current stream: one launch per
    block anti-diagonal with blocks (``plan["launches"]``).  ``norms`` (the
    A and B corpora's squared norms from ``gram_layout``, whose rounded
    frames are then ``fa`` and ``fb``) selects the Gram instantiation.  ``events``
    (two CUDA events, or None) are recorded around the launches alone;
    ``config`` overrides ``_long_config``'s (warps, stage_b) (a timing
    comparison's).  Returns V, the right columns of every pair's last block
    column."""
    dev = fa.device
    nc4 = fa.shape[2] // 4
    R = _long_rows(BLK, nc4)
    warps, stage_b = config or _long_config(R, nc4, BLK)
    # Boundaries: every entry is written before it is read.
    H = torch.empty(max(plan["n_h"], 1), dtype=torch.float32, device=dev)
    V = torch.empty(max(plan["n_v"], 1), dtype=torch.float32, device=dev)
    C = torch.empty(2 * max(plan["n_c"], 1), dtype=torch.float32, device=dev)
    meta = torch.from_numpy(plan["meta"]).to(dev)
    items = torch.from_numpy(plan["items"]).to(dev)
    if events:
        events[0].record()
    if plan["launches"]:
        _launch(
            "dtw_long_block", 12, 16,
            fa.data_ptr(), fb.data_ptr(), 0 if norms is None else norms[0].data_ptr(),
            0 if norms is None else norms[1].data_ptr(), meta.data_ptr(), items.data_ptr(),
            plan["totals"].ctypes.data, H.data_ptr(), V.data_ptr(), C.data_ptr(),
            0 if halo is None else halo.data_ptr(), out.data_ptr(), len(plan["meta"]),
            fa.shape[1], fb.shape[1], nc4, BLK, plan["nK"], J0, plan["n_c"],
            0 if band is None else BAND_MODES[band_mode], 0 if band is None else int(band),
            int(bool(auto_widen)), METRICS[metric], warps, R, int(stage_b), int(norms is not None),
            stream=torch.cuda.current_stream(dev).cuda_stream,
        )
    if events:
        events[1].record()
    return V


def _check_corpus(feats, lengths, name: str) -> tuple[int, int, int]:
    """(K, L, d) of a corpus [K, L, d] f32 with lengths [K] i32 beside it."""
    if feats.dim() != 3 or feats.dtype != torch.float32:
        raise ValueError(f"{name} must be [K, L, d] float32, got {tuple(feats.shape)} "
                         f"{feats.dtype}")
    K = feats.shape[0]
    if lengths.shape != (K,) or lengths.dtype != torch.int32 or lengths.device != feats.device:
        raise ValueError(f"the lengths of {name} must be [{K}] int32 on {feats.device}, got "
                         f"{tuple(lengths.shape)} {lengths.dtype} on {lengths.device}")
    return feats.shape


def dtw_long_pairs(
    feats: torch.Tensor,       # [Ka, La, d] f32: the A sides' corpus
    lengths: torch.Tensor,     # [Ka] i32
    ia,                        # [P] indices into feats (numpy or a tensor)
    ib,                        # [P] indices into feats_b
    *,
    feats_b: torch.Tensor | None = None,     # [Kb, Lb, d]; None: feats
    lengths_b: torch.Tensor | None = None,   # [Kb] i32; None: lengths
    frames=None,                             # frame_layout(feats) (gram_layout), prebuilt
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    block: int = 256,
    band_mode: str = "widen",
    events: list | None = None,              # two CUDA events around the launches
    matmul_dtype: str | None = None,
) -> torch.Tensor:
    """Blocked DTW of the P pairs (feats[ia[p]], feats_b[ib[p]]) -> [P] f32,
    normalized as ``normalize`` says: the merged K8 call.  Each pair runs on
    its own grid of ceil(la/block) x ceil(lb/block) blocks, so a short pair
    costs its own blocks only, and a call takes max_p(nBa + nBb - 1)
    launches whatever the number of pairs.  A pair with an empty side or a
    side past its corpus's L is +inf.

    ``matmul_dtype="bfloat16"``: the bf16 Gram costs (the module docstring).

    CUDA tensors launch K8 on the frame layouts (``frames``, the layout of
    ``feats`` built once a job by the caller, or built here: its
    ``frame_layout``, or under bf16 its ``gram_layout``), count the
    launches in ``dtw_long_batch.launches`` and record ``events``, where
    given, before the first launch and after the last, so that they time
    the kernel alone; the block must be a multiple of 32 frames there.  CPU tensors take the
    plain twin ``dtw_long_pairs_ref``.  Any other device raises."""
    if feats_b is None:
        feats_b, lengths_b = feats, lengths
    Ka, La, d = _check_corpus(feats, lengths, "feats")
    Kb, Lb, db = _check_corpus(feats_b, lengths_b, "feats_b")
    if db != d or feats_b.device != feats.device:
        raise ValueError(f"feats {tuple(feats.shape)} and feats_b {tuple(feats_b.shape)} differ "
                         "in frame width or device")
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}")
    if normalize not in ("none", "path_len"):
        raise ValueError(f"unknown normalize {normalize!r}")
    if band_mode not in BAND_MODES:
        raise ValueError(f"unknown band_mode {band_mode!r}")
    if band is not None and int(band) < 0:
        raise ValueError(f"band={band} must be >= 0 or None")
    BLK = int(block)
    if BLK < 1:
        raise ValueError(f"block={block} must be >= 1")
    ia_np = (ia.cpu().numpy() if isinstance(ia, torch.Tensor) else np.asarray(ia)).astype(np.int64)
    ib_np = (ib.cpu().numpy() if isinstance(ib, torch.Tensor) else np.asarray(ib)).astype(np.int64)
    if ia_np.shape != ib_np.shape or ia_np.ndim != 1:
        raise ValueError(f"ia {ia_np.shape} and ib {ib_np.shape} must be one [P] each")
    if len(ia_np) and not (0 <= ia_np.min() and ia_np.max() < Ka and 0 <= ib_np.min()
                           and ib_np.max() < Kb):
        raise ValueError(f"pair indices outside the corpora ({Ka}, {Kb} sequences)")
    kw = dict(metric=metric, band=band, auto_widen=auto_widen, band_mode=band_mode)
    dev = feats.device
    gram = matmul_dtype == "bfloat16"
    if dev.type == "cpu":
        return dtw_long_pairs_ref(feats, lengths, ia_np, ib_np, feats_b=feats_b,
                                  lengths_b=lengths_b, normalize=normalize, block=BLK,
                                  matmul_dtype=matmul_dtype, **kw)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    ia_t, ib_t = torch.from_numpy(ia_np).to(dev), torch.from_numpy(ib_np).to(dev)
    la, lb = lengths[ia_t], lengths_b[ib_t]
    out = torch.full((len(ia_np),), INF, dtype=torch.float32, device=dev)
    if len(ia_np) == 0:
        return out
    norms = None
    if gram:
        fa, na = _check_gram_layout(frames, feats, metric)
        fb, nb = (fa, na) if feats_b is feats else gram_layout(feats_b, metric)
        norms = (na, nb)
    else:
        fa = _check_frame_layout(frames, feats, metric)
        fb = fa if feats_b is feats else _check_frame_layout(None, feats_b, metric)
    plan = _long_plan(ia_np, ib_np, la.cpu().numpy(), lb.cpu().numpy(), La, Lb, BLK)
    _launch_plan(fa, fb, plan, out, BLK=BLK, J0=0, halo=None, events=events, norms=norms, **kw)
    dtw_long_batch.launches += plan["launches"]
    return _normalized(out, la, lb, normalize)


def dtw_long_pairs_ref(feats, lengths, ia, ib, *, feats_b, lengths_b, metric, band, auto_widen,
                       normalize, block, band_mode, matmul_dtype=None) -> torch.Tensor:
    """Plain twin of ``dtw_long_pairs`` on the device of ``feats``: the pairs
    grouped by their padded grid (the longer side rounded up to whole
    blocks), each group gathered, zero-padded to it and run through
    ``dtw_long_batch_ref``.  The twin is elementwise over pairs, so a pair's
    distance does not depend on the group it lands in."""
    La, Lb = feats.shape[1], feats_b.shape[1]
    ia_t, ib_t = torch.from_numpy(ia).to(feats.device), torch.from_numpy(ib).to(feats.device)
    la, lb = lengths[ia_t], lengths_b[ib_t]
    out = torch.full((len(ia),), INF, dtype=torch.float32, device=feats.device)
    la_np, lb_np = la.cpu().numpy().astype(np.int64), lb.cpu().numpy().astype(np.int64)
    ok = (la_np > 0) & (lb_np > 0) & (la_np <= La) & (lb_np <= Lb)
    grid = -(-np.maximum(la_np, lb_np) // block) * block
    for S in np.unique(grid[ok]):
        sel = torch.from_numpy(np.nonzero(ok & (grid == S))[0]).to(feats.device)

        def side(f, idx, L):
            x = f[idx, : min(int(S), L)]
            return torch.nn.functional.pad(x, (0, 0, 0, int(S) - x.shape[1]))

        out[sel] = dtw_long_batch_ref(
            side(feats, ia_t[sel], La), side(feats_b, ib_t[sel], Lb), la[sel], lb[sel],
            metric=metric, band=band, auto_widen=auto_widen, block=block, band_mode=band_mode,
            matmul_dtype=matmul_dtype)
    return _normalized(out, la, lb, normalize)


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
    matmul_dtype: str | None = None,
) -> torch.Tensor:
    """Batched DTW over long padded sequences with boundary-only memory ->
    [B] f32, normalized as ``normalize`` says (the reference's drop-in for
    ``dtw_batch`` at equal padded lengths).  A pair with an empty side or a
    side past S is +inf.

    The case ia = ib = arange(B) of ``dtw_long_pairs``, with ``a`` and ``b``
    as the two corpora: CUDA tensors launch K8 once per block anti-diagonal
    of the largest pair grid (``launches`` counts the launches of both
    entries, of either instantiation; ``matmul_dtype="bfloat16"`` selects
    the Gram one; the block must be a multiple of 32 frames there), CPU
    tensors take the plain twin.  Any other device
    raises."""
    B, _, _, BLK, _ = _check_long(a, b, len_a, len_b, metric, normalize, block, band_mode)
    idx = np.arange(B, dtype=np.int64)
    return dtw_long_pairs(a, len_a, idx, idx, feats_b=b, lengths_b=len_b, metric=metric,
                          band=band, auto_widen=auto_widen, normalize=normalize, block=BLK,
                          band_mode=band_mode, matmul_dtype=matmul_dtype)


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
    """K8 on block columns [J0, J0 + nJ) of every pair's nB x nB grid, on
    the card: the block anti-diagonals in order on the current stream, one
    launch each (not counted: the stripe interface of the multi-device
    wavefront).  ``halo`` [B, nB, BLK] holds the right columns of block
    column J0 - 1 (None: +inf, the grid's left edge); the stripe's blocks
    that hold a pair's terminal cell write it (unnormalized) into ``out``.
    Returns the right columns of block column J0 + nJ - 1, [B, nB, BLK]:
    the next stripe's halo.  The whole grid is J0 = 0, nJ = nB; a stripe of
    block columns on each device with its left neighbour's returned columns
    as ``halo`` gives the same distances."""
    B, S, c4 = xa.shape
    BLK = int(block)
    nB = S // BLK
    if not (0 <= J0 and 1 <= nJ and J0 + nJ <= nB):
        raise ValueError(f"block columns [{J0}, {J0 + nJ}) outside the grid's {nB}")
    if halo is not None and (halo.shape != (B, nB, BLK) or not halo.is_contiguous()
                             or halo.data_ptr() % 16):
        raise ValueError(f"halo must be a contiguous, 16-byte aligned [{B}, {nB}, {BLK}] tensor")
    idx = np.arange(B, dtype=np.int64)
    plan = _long_plan(idx, idx, len_a.cpu().numpy(), len_b.cpu().numpy(), S, S, BLK, nB=nB,
                      J0=J0, nJ=nJ)
    V = _launch_plan(xa, xb, plan, out, BLK=BLK, J0=J0, halo=halo, metric=metric, band=band,
                     auto_widen=auto_widen, band_mode=band_mode)
    return V[: B * nB * BLK].view(B, nB, BLK)


dtw_long_batch.launches = 0

"""Checkpointed exact DTW backtrace in O(B * sqrt(N) * M) memory.

Port of ``audio_pattern_discovery_tpu/ops/backtrace_ckpt.py`` in plain
torch, on the device of the inputs.  The DP grid's rows are processed in
segments of ``row_chunk`` rows.  A forward pass keeps only each segment's
carry-in row (the previous segment's last row).  The backward pass then
re-materializes one segment's direction block at a time ([B, rows+M-1, M]
instead of [B, N+M-1, M]) and walks the path through it on the host,
hopping segment to segment.

Exactness: every cell is c[i, j] + min(three neighbours), a function of
neighbour VALUES only, and the costs come from the same ``pairwise_cost``
as ``ops.dtw.dtw_batch_with_dirs``, so any split of the sweep into row
segments gives the same cell values and the same tie-breaks (diag > up >
left): the paths equal those of ``dtw_batch_with_dirs`` +
``ops.backtrace.walk_path`` (tested).
"""

from __future__ import annotations

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.ops.dtw import INF, pairwise_cost


def _segment_pass(a, b, len_a, len_b, carry, corner, s0, rows, *, metric, band,
                  auto_widen, band_mode, with_dirs):
    """Anti-diagonal scan over absolute rows [s0, s0+rows) with a row carry.

    Subgrid cell (i', j) sits on diagonal k = i' + j; cells with i' == 0
    take their up/diag predecessors from ``carry`` (up = carry[j], diag =
    carry[j-1], with ``corner`` = D[s0-1, -1] at j = 0).  Returns the
    segment's last row [B, M] and, with ``with_dirs``, the [B, rows+M-1, M]
    uint8 directions in diagonal-major layout."""
    B, M = carry.shape
    dev = carry.device
    C = pairwise_cost(a[:, s0 : s0 + rows], b, metric)              # [B, rows, M]
    n_diag = rows + M - 1
    k = torch.arange(n_diag, device=dev)[:, None, None]
    j = torch.arange(M, device=dev)[None, None, :]
    i_abs = k - j + s0
    la = len_a.long()[None, :, None]
    lb = len_b.long()[None, :, None]
    valid = (k - j >= 0) & (k - j < rows) & (i_abs < la) & (j < lb)
    if band is not None and band_mode == "diag":
        den, num = la - 1, lb - 1
        valid &= torch.abs(j * den - i_abs * num) <= max(int(band), 1) * torch.maximum(den, num)
    elif band is not None:
        w = torch.full_like(la, int(band))
        if auto_widen:
            w = torch.maximum(w, torch.abs(la - lb))
        valid &= torch.abs(i_abs - j) <= w
    i_idx = torch.clamp(k[:, 0] - j[0], 0, rows - 1)                # [n_diag, M]
    Cs = torch.gather(C, 1, i_idx[None].expand(B, -1, -1)).permute(1, 0, 2)
    Cs = torch.where(valid, Cs, INF)                                # [n_diag, B, M]

    j_idx = torch.arange(M, device=dev)[None, :]
    inf_col = torch.full((B, 1), INF, device=dev)
    carry_diag = torch.cat([corner[:, None], carry[:, :-1]], dim=1)
    prev = torch.full((B, M), INF, device=dev)
    prev2 = prev
    last_row = prev
    dirs = []
    for kk in range(n_diag):
        top = j_idx == kk                 # lanes where this diagonal hits i' == 0
        d_up = torch.where(top, carry, prev)
        d_diag = torch.where(top, carry_diag, torch.cat([inf_col, prev2[:, :-1]], dim=1))
        d_left = torch.cat([inf_col, prev[:, :-1]], dim=1)
        if with_dirs:
            best01 = torch.where(d_diag <= d_up, 0, 1).to(torch.uint8)
            val01 = torch.minimum(d_diag, d_up)
            dirs.append(torch.where(val01 <= d_left, best01, 2).to(torch.uint8))
            pred = torch.minimum(val01, d_left)
        else:
            pred = torch.minimum(torch.minimum(d_diag, d_up), d_left)
        cur = Cs[kk] + pred
        # The segment's last row: cell (rows-1, j) sits on diagonal rows-1+j.
        last_row = torch.where(j_idx == kk - (rows - 1), cur, last_row)
        prev2, prev = prev, cur
    return last_row, (torch.stack(dirs, dim=1) if with_dirs else None)


def dtw_paths_checkpointed(
    a: torch.Tensor,           # [B, N, d] padded
    b: torch.Tensor,           # [B, M, d]
    len_a: np.ndarray,         # [B]
    len_b: np.ndarray,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    row_chunk: int | None = None,
    band_mode: str = "widen",
) -> list[list[tuple[int, int]]]:
    """Exact warping paths for B pairs in O(B * row_chunk * M) memory on the
    device of ``a``.  ``calls`` counts the calls.

    Default row_chunk ~ sqrt(8N) rounded up to a multiple of 8, as in the
    reference: it balances the carry store (N/row_chunk rows) against the
    per-segment dirs block."""
    dtw_paths_checkpointed.calls += 1
    dev = a.device
    a, b = a.float(), b.to(dev).float()
    la_np = np.asarray(len_a, dtype=np.int64)
    lb_np = np.asarray(len_b, dtype=np.int64)
    la = torch.from_numpy(la_np).to(dev)
    lb = torch.from_numpy(lb_np).to(dev)
    B, N, _ = a.shape
    M = b.shape[1]
    if row_chunk is None:
        row_chunk = int(max(8, min(N, -(-int((8 * N) ** 0.5) // 8) * 8)))
    n_seg = -(-N // row_chunk)
    common = dict(metric=metric, band=band, auto_widen=auto_widen, band_mode=band_mode)

    # Forward: keep each segment's carry-in row and corner on the device.
    carries, corners = [], []
    carry = torch.full((B, M), INF, device=dev)
    corner = torch.zeros((B,), device=dev)           # virtual D[-1, -1] = 0
    for s in range(n_seg):
        s0 = s * row_chunk
        rows = min(row_chunk, N - s0)
        carries.append(carry)
        corners.append(corner)
        carry, _ = _segment_pass(a, b, la, lb, carry, corner, s0, rows,
                                 with_dirs=False, **common)
        corner = torch.full((B,), INF, device=dev)   # later segments see no corner

    # Backward: re-materialize one segment's dirs block at a time and walk.
    pos = [(int(la_np[p]) - 1, int(lb_np[p]) - 1) for p in range(B)]
    paths: list[list[tuple[int, int]]] = [[p] for p in pos]
    for s in range(n_seg - 1, -1, -1):
        s0 = s * row_chunk
        rows = min(row_chunk, N - s0)
        if all(i < s0 for i, _ in pos):
            continue
        _, dirs = _segment_pass(a, b, la, lb, carries[s], corners[s], s0, rows,
                                with_dirs=True, **common)
        dirs_np = dirs.cpu().numpy()                 # [B, rows+M-1, M]
        for p in range(B):
            i, j = pos[p]
            if i < s0:
                continue
            guard = rows + M + 2
            while i >= s0 and (i > 0 or j > 0) and guard > 0:
                d = int(dirs_np[p, (i - s0) + j, j])
                if d == 0:
                    i, j = i - 1, j - 1
                elif d == 1:
                    i -= 1
                else:
                    j -= 1
                # Clamp against corrupt directions at the true grid edges
                # (as ops.backtrace.walk_path does).
                if s == 0 and i < 0:
                    i = 0
                if j < 0:
                    j = 0
                paths[p].append((i, j))
                guard -= 1
            pos[p] = (i, j)
    for p in range(B):
        paths[p].reverse()
    return paths


dtw_paths_checkpointed.calls = 0

"""D assembled on the device: the tiled scheduler's tile-pair blocks written
into a device-resident [K, K] matrix (``csrc/dtw_scatter.cu``), the one way
every tiled job builds D.

Replaces no kernel of the reference: it replaces the reference's host
scatter (its direct block scatter, ``native/apd_native.cc:433``), which
normalizes each block and writes both triangles through the length sort's
permutation on one host thread.  ``scatter_tile_blocks`` writes a chunk's
blocks with rows in the original order and columns in the sorted order, and
``unpermute_columns`` then puts each row's columns in the original order, in
place: D bit for bit the host scatter's (the same IEEE fp32 division, in the
same order, and copies otherwise).  Each wrapper launches its CUDA kernel on
CUDA tensors, counts the launch in its ``launches`` attribute, and runs its
plain PyTorch twin (``*_ref``) on CPU tensors.  The un-permute's kernel
holds a row in one block's shared memory; past that (K > 58,112) a second
kernel takes each row through a scratch row in global memory, a panel of at
most ``_PANEL_BYTES`` of scratch rows at a time, as the twin takes its rows
on the CPU.
"""

from __future__ import annotations

import torch

from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import _launch

# Shared memory one CUDA block of the H100 can take: the un-permute's
# kernel holds a row of K floats, so K <= 58,112.
_MAX_ROW_BYTES = 227 * 1024
# Past that limit, and in the twin, the un-permute gathers this many bytes
# of rows at a time (a panel), so a D of many GB needs no second copy of
# itself.
_PANEL_BYTES = 256 * 1024**2


def _check(blocks, ti_idx, tj_idx, lengths, perm, out) -> tuple[int, int, int]:
    """(U, ti, K) after checking shapes, dtypes, devices and contiguity (the
    tile indices are the caller's, as for the DTW kernels: reading them
    here would wait for the device)."""
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2] or blocks.dtype != torch.float32:
        raise ValueError(f"blocks must be [U, ti, ti] float32, got {tuple(blocks.shape)} "
                         f"{blocks.dtype}")
    U, ti, _ = blocks.shape
    if out.dim() != 2 or out.shape[0] != out.shape[1] or out.dtype != torch.float32:
        raise ValueError(f"out must be [K, K] float32, got {tuple(out.shape)} {out.dtype}")
    K = out.shape[0]
    nT = -(-K // ti)
    for name, t, dtype, n in (("ti_idx", ti_idx, torch.int32, U), ("tj_idx", tj_idx, torch.int32, U),
                              ("lengths", lengths, torch.int32, nT * ti),
                              ("perm", perm, torch.int64, K)):
        if t.dim() != 1 or t.dtype != dtype or t.shape[0] != n:
            raise ValueError(f"{name} must be a 1-D {dtype} tensor of {n} entries, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name, t in (("blocks", blocks), ("ti_idx", ti_idx), ("tj_idx", tj_idx),
                    ("lengths", lengths), ("perm", perm), ("out", out)):
        if t.device != out.device:
            raise ValueError(f"{name} is on {t.device}, out on {out.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return U, ti, K


def scatter_tile_blocks(
    blocks: torch.Tensor,     # [U, ti, ti] f32 unnormalized DTW of tile-pairs
    ti_idx: torch.Tensor,     # [U] i32 row tiles
    tj_idx: torch.Tensor,     # [U] i32 column tiles
    lengths: torch.Tensor,    # [nT*ti] i32 sorted lengths (pad entries 1)
    perm: torch.Tensor,       # [K] i64 sorted position -> original index
    out: torch.Tensor,        # [K, K] f32, written in place
    *,
    normalize: bool,
) -> None:
    """Write block u's entry (r, c), over (len[r0+r] + len[c0+c]) when
    ``normalize``, to ``out[perm[r0 + r], c0 + c]`` and
    ``out[perm[c0 + c], r0 + r]`` (r0 = ti_idx[u]*ti, c0 = tj_idx[u]*ti):
    rows in the original order, columns in the sorted order.  A diagonal
    tile (ti_idx[u] == tj_idx[u]) gives its strict upper part mirrored and
    a zero diagonal; rows and columns past K are not written, and a block
    that repeats the one before it is skipped.  ``unpermute_columns`` with
    perm's inverse finishes D once every block of a job is written."""
    U, ti, K = _check(blocks, ti_idx, tj_idx, lengths, perm, out)
    if out.device.type == "cpu":
        scatter_tile_blocks_ref(blocks, ti_idx, tj_idx, lengths, perm, out, normalize=normalize)
        return
    if out.device.type != "cuda":
        raise ValueError(f"unsupported device {out.device}")
    if U > 65535:
        raise ValueError(f"{U} blocks in one launch: at most 65,535")
    if U == 0:
        return
    _launch(
        "dtw_scatter", 6, 4,
        blocks.data_ptr(), ti_idx.data_ptr(), tj_idx.data_ptr(), lengths.data_ptr(),
        perm.data_ptr(), out.data_ptr(), ti, U, K, int(bool(normalize)),
        device=out.device,
    )
    scatter_tile_blocks.launches += 1


scatter_tile_blocks.launches = 0


def scatter_tile_blocks_ref(blocks, ti_idx, tj_idx, lengths, perm, out, *, normalize) -> None:
    """Plain PyTorch twin of ``scatter_tile_blocks``, on the device of
    ``out``: the same entries, the same fp32 division."""
    U, ti, _ = blocks.shape
    K = out.shape[0]
    ii, jj = ti_idx.tolist(), tj_idx.tolist()
    lens = lengths.to(torch.float32)
    for u in range(U):
        I, J = ii[u], jj[u]
        if u and (I, J) == (ii[u - 1], jj[u - 1]):
            continue
        r0, c0 = I * ti, J * ti
        nr, nc = min(ti, K - r0), min(ti, K - c0)
        v = blocks[u, :nr, :nc]
        if normalize:
            v = v / (lens[r0 : r0 + nr, None] + lens[None, c0 : c0 + nc])
        if I == J:
            upper = torch.ones((nr, nr), dtype=torch.bool, device=v.device).triu(1)
            v = torch.where(upper, v, v.T)
            v.fill_diagonal_(0.0)
        out[perm[r0 : r0 + nr], c0 : c0 + nc] = v
        if I != J:
            out[perm[c0 : c0 + nc], r0 : r0 + nr] = v.T


def unpermute_columns(out: torch.Tensor, inv: torch.Tensor) -> None:
    """In place, every row: ``out[i, j] = out[i, inv[j]]`` (``inv`` [K] i64,
    the inverse of the scatter's ``perm``): on the card, a row in shared
    memory where K floats fit ``_MAX_ROW_BYTES``, else through a
    ``[rows, K]`` scratch of at most ``_PANEL_BYTES`` (at least one row)."""
    if out.dim() != 2 or out.shape[0] != out.shape[1] or out.dtype != torch.float32:
        raise ValueError(f"out must be [K, K] float32, got {tuple(out.shape)} {out.dtype}")
    K = out.shape[0]
    if inv.shape != (K,) or inv.dtype != torch.int64 or inv.device != out.device:
        raise ValueError(f"inv must be [{K}] int64 on {out.device}, got {tuple(inv.shape)} "
                         f"{inv.dtype} on {inv.device}")
    if not (out.is_contiguous() and inv.is_contiguous()):
        raise ValueError("out and inv must be contiguous")
    if out.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {out.device}")
    if out.device.type == "cpu":
        unpermute_columns_ref(out, inv)
        return
    if K == 0:
        return
    if 4 * K <= _MAX_ROW_BYTES:
        _launch("dtw_scatter", 2, 1, out.data_ptr(), inv.data_ptr(), K, device=out.device,
                entry="dtw_scatter_unpermute")
    else:
        rows = panel_rows(K)
        scratch = torch.empty((rows, K), dtype=torch.float32, device=out.device)
        _launch("dtw_scatter", 3, 2, out.data_ptr(), inv.data_ptr(), scratch.data_ptr(), K,
                rows, device=out.device, entry="dtw_scatter_unpermute_rows")
    unpermute_columns.launches += 1


unpermute_columns.launches = 0


def panel_rows(K: int) -> int:
    """Rows of K floats in a panel of at most ``_PANEL_BYTES`` (1 to K): the
    un-permute's panel, and the scheduler's for seeding D under known=."""
    return min(max(1, K), max(1, _PANEL_BYTES // max(1, 4 * K)))


def unpermute_columns_ref(out: torch.Tensor, inv: torch.Tensor) -> None:
    """Plain PyTorch twin of ``unpermute_columns``, on the device of ``out``,
    a panel of ``panel_rows(K)`` rows at a time."""
    K = out.shape[0]
    rows = panel_rows(K)
    for r0 in range(0, K, rows):
        panel = out[r0 : r0 + rows]
        panel.copy_(panel[:, inv])

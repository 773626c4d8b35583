"""Batched anti-diagonal wavefront DTW in plain PyTorch.

Port of ``audio_pattern_discovery_tpu/ops/dtw.py``.  Same recurrence and
the same masks: the O(N*M) DP is serialized only across anti-diagonals
(cells on diagonal k = i+j depend on diagonals k-1 and k-2), each step
updates a [B, M] wavefront for B pairs at once, ragged lengths and the band
are +inf masks over a padded grid, and each distance is read at its pair's
true terminal cell.  Frame costs come from one batched fp32 Gram matmul
(TF32 is off, see the package ``__init__``); under
``matmul_dtype="bfloat16"`` its operands are rounded to bf16 first, the
reference's reduced-precision recipe (``pairwise_cost``).

This module is the plain twin every DTW kernel of the port is held against,
and it is the alignment path (``dtw_batch_with_dirs``) of ``discover()``.
"""

from __future__ import annotations

import torch

INF = float("inf")


# --------------------------------------------------------------------- costs
def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to bf16 (to nearest, ties to even, as JAX's
    ``astype``) and held as fp32: a product of two such values is exact in
    fp32."""
    return x.to(torch.bfloat16).float()


def pairwise_cost(
    a: torch.Tensor,           # [B, N, d]
    b: torch.Tensor,           # [B, M, d]
    metric: str = "euclidean",
    matmul_dtype: str | None = None,
) -> torch.Tensor:
    """Batched frame-to-frame cost matrices [B, N, M] (fp32 Gram matmul).

    ``matmul_dtype="bfloat16"``: the reference's bf16 recipe.  The Gram
    products take the operands rounded to bf16 (for cosine after their
    normalization in fp32) and sum in fp32; the squared norms come from the
    unrounded frames.  The rounded operands stay fp32 tensors and multiply
    with TF32 off, so the products are exact and only the fp32 sums' order
    differs from the reference's (a bf16 ``bmm`` would round its output to
    bf16)."""
    a = a.float()
    b = b.float()
    if metric == "cosine":
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=1e-12)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True), min=1e-12)
    am, bm = (round_bf16(a), round_bf16(b)) if matmul_dtype == "bfloat16" else (a, b)
    gram = torch.bmm(am, bm.transpose(1, 2))                     # [B, N, M]
    if metric == "cosine":
        return 1.0 - gram
    sq_a = torch.sum(a * a, dim=-1)                              # [B, N]
    sq_b = torch.sum(b * b, dim=-1)                              # [B, M]
    sq = torch.clamp(sq_a[:, :, None] + sq_b[:, None, :] - 2.0 * gram, min=0.0)
    if metric == "sqeuclidean":
        return sq
    if metric == "euclidean":
        return torch.sqrt(sq)
    raise ValueError(f"unknown metric {metric!r}")


def _skew_to_diagonals(C: torch.Tensor) -> torch.Tensor:
    """[B, N, M] cost -> [K=N+M-1, B, M] diagonal-major: out[k,b,j] = C[b,k-j,j].

    Out-of-grid entries (k-j outside [0,N)) are clamped garbage; callers mask
    them with the validity grid before use."""
    B, N, M = C.shape
    k = torch.arange(N + M - 1, device=C.device)
    j = torch.arange(M, device=C.device)
    i_idx = torch.clamp(k[:, None] - j[None, :], 0, N - 1)           # [K, M]
    Cs = torch.gather(C, 1, i_idx[None].expand(B, -1, -1))           # [B, K, M]
    return Cs.permute(1, 0, 2)                                       # [K, B, M]


def _validity_grid(
    N: int,
    M: int,
    len_a: torch.Tensor,       # [B]
    len_b: torch.Tensor,       # [B]
    band: int | None,
    auto_widen: bool,
    band_mode: str = "widen",
) -> torch.Tensor:
    """[K, B, M] bool: cell (i=k-j, j) is inside both sequences and the band.

    ``band_mode="diag"`` is the scaled corridor
    |j*(la-1) - i*(lb-1)| <= max(band,1)*max(la-1, lb-1) as an exact
    integer predicate (oracle/dtw.py module docstring)."""
    dev = len_a.device
    k = torch.arange(N + M - 1, device=dev)[:, None, None]            # [K, 1, 1]
    j = torch.arange(M, device=dev)[None, None, :]                    # [1, 1, M]
    i = k - j                                                         # [K, 1, M]
    la = len_a.long()[None, :, None]
    lb = len_b.long()[None, :, None]
    valid = (i >= 0) & (i < la) & (j < lb)
    if band is None:
        return valid
    if band_mode == "diag":
        den = la - 1
        num = lb - 1
        r = max(int(band), 1)
        valid &= torch.abs(j * den - i * num) <= r * torch.maximum(den, num)
    elif band_mode == "widen":
        w = torch.full_like(la, int(band))
        if auto_widen:
            w = torch.maximum(w, torch.abs(la - lb))
        valid &= torch.abs(i - j) <= w
    else:
        raise ValueError(f"unknown band_mode {band_mode!r}")
    return valid


def _wavefront(
    a, b, len_a, len_b, *, metric, band, auto_widen, normalize, band_mode,
    with_dirs: bool, matmul_dtype=None,
):
    if a.dim() != 3 or b.dim() != 3 or a.shape[2] != b.shape[2]:
        raise ValueError(f"want a [B,N,d], b [B,M,d]; got {tuple(a.shape)}, {tuple(b.shape)}")
    if len_a.shape != (a.shape[0],) or len_b.shape != (b.shape[0],):
        raise ValueError("len_a / len_b must be [B] and match a / b")
    if normalize not in ("none", "path_len"):
        raise ValueError(f"unknown normalize {normalize!r}")
    B, N, _ = a.shape
    M = b.shape[1]
    dev = a.device
    len_a = len_a.to(dev)
    len_b = len_b.to(dev)
    valid = _validity_grid(N, M, len_a, len_b, band, auto_widen, band_mode)
    Cs = torch.where(valid, _skew_to_diagonals(pairwise_cost(a, b, metric, matmul_dtype)), INF)

    j_idx = torch.arange(M, device=dev)[None, :]                     # [1, M]
    k_star = (len_a + len_b - 2).long()                              # [B]
    hit_j = j_idx == (len_b.long() - 1)[:, None]                     # [B, M]
    inf_col = torch.full((B, 1), INF, device=dev)

    def shift_j(x):
        # x[:, j-1] with +inf shifted in at j=0.
        return torch.cat([inf_col, x[:, :-1]], dim=1)

    prev = torch.full((B, M), INF, device=dev)
    prev2 = torch.full((B, M), INF, device=dev)
    out = torch.full((B,), INF, device=dev)
    dirs = [] if with_dirs else None
    for k in range(N + M - 1):
        d_diag = shift_j(prev2)
        d_up = prev
        d_left = shift_j(prev)
        if with_dirs:
            best01 = torch.where(d_diag <= d_up, 0, 1).to(torch.uint8)
            val01 = torch.minimum(d_diag, d_up)
            dirs.append(torch.where(val01 <= d_left, best01, 2).to(torch.uint8))
            pred = torch.minimum(val01, d_left)
        else:
            pred = torch.minimum(d_up, torch.minimum(d_left, d_diag))
        if k == 0:
            pred = pred.clone()
            pred[:, 0] = 0.0
        cur = Cs[k] + pred                                           # [B, M]
        hit = (k_star == k)[:, None] & hit_j
        out = torch.where(hit.any(dim=1), torch.where(hit, cur, 0.0).sum(dim=1), out)
        prev2, prev = prev, cur
    if normalize == "path_len":
        out = out / (len_a + len_b).float()
    if with_dirs:
        return out, torch.stack(dirs, dim=1)                         # [B, K, M]
    return out


def dtw_batch(
    a: torch.Tensor,           # [B, N, d] padded
    b: torch.Tensor,           # [B, M, d] padded
    len_a: torch.Tensor,       # [B] int
    len_b: torch.Tensor,       # [B] int
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    band_mode: str = "widen",
    matmul_dtype: str | None = None,
) -> torch.Tensor:
    """All B DTW distances, [B] float32, on the device of ``a``;
    ``matmul_dtype="bfloat16"`` takes the frame costs from the bf16 Gram
    (``pairwise_cost``)."""
    return _wavefront(
        a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen,
        normalize=normalize, band_mode=band_mode, with_dirs=False, matmul_dtype=matmul_dtype,
    )


def dtw_batch_with_dirs(
    a: torch.Tensor,
    b: torch.Tensor,
    len_a: torch.Tensor,
    len_b: torch.Tensor,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    band_mode: str = "widen",
    matmul_dtype: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Distances + per-cell step directions for backtrace.

    Returns ([B] distances, [B, K, M] uint8 dirs in diagonal-major layout:
    dirs[b, i+j, j] is the argmin predecessor of cell (i, j):
    0 = diag (i-1,j-1), 1 = up (i-1,j), 2 = left (i,j-1).  Tie-break
    diag > up > left matches oracle/dtw.py.  Memory is O(B*K*M): use it
    only for the few within-cluster pairs that need paths."""
    return _wavefront(
        a, b, len_a, len_b, metric=metric, band=band, auto_widen=auto_widen,
        normalize=normalize, band_mode=band_mode, with_dirs=True, matmul_dtype=matmul_dtype,
    )


def dtw_pair(
    a: torch.Tensor,
    b: torch.Tensor,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    band_mode: str = "widen",
) -> torch.Tensor:
    """Single unbatched pair (convenience / tests). a: [N, d], b: [M, d]."""
    a = torch.atleast_2d(a)
    b = torch.atleast_2d(b)
    return dtw_batch(
        a[None],
        b[None],
        torch.tensor([a.shape[0]], device=a.device),
        torch.tensor([b.shape[0]], device=a.device),
        metric=metric,
        band=band,
        auto_widen=auto_widen,
        normalize=normalize,
        band_mode=band_mode,
    )[0]

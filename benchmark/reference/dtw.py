"""Plain-PyTorch DTW, the yardstick for every distance the program reports.

The recurrence, the two band semantics and the path-length normalization
are those of the port's NumPy oracle (``oracle/dtw.py``), vectorized over
pairs and stepped one anti-diagonal at a time:

    R[i, j] = cost(a_i, b_j) + min(R[i-1, j-1], R[i-1, j], R[i, j-1])

with R[-1, -1] = 0, +inf outside the band.  ``precision="fp64"`` computes
the costs from differences in float64 and the recurrence in float64 (the
reference); ``precision="bf16"`` is the control, the same recurrence in
fp32 over costs from a Gram matrix of the frames rounded to bfloat16 with
fp32 accumulation (the reference package's bf16 recipe), and
``precision="tf32"`` the same with the frames rounded to TF32.  Imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import LOWER, rounded


def band_mask(la, lb, N: int, M: int, band: int | None, band_mode: str,
              auto_widen: bool = True) -> torch.Tensor | None:
    """[P, N, M] bool: the cells inside each pair's band (None: all)."""
    if band is None:
        return None
    i = torch.arange(N, device=la.device)[None, :, None]
    j = torch.arange(M, device=la.device)[None, None, :]
    la, lb = la.long()[:, None, None], lb.long()[:, None, None]
    if band_mode == "diag":
        den, num = la - 1, lb - 1
        return (j * den - i * num).abs() <= max(int(band), 1) * torch.maximum(den, num)
    if band_mode != "widen":
        raise ValueError(f"unknown band_mode {band_mode!r}")
    w = torch.clamp((la - lb).abs(), min=int(band)) if auto_widen else torch.full_like(la, band)
    return (i - j).abs() <= w


def costs(a: torch.Tensor, b: torch.Tensor, metric: str, precision: str) -> torch.Tensor:
    """[P, N, M] frame costs of a [P, N, d] against b [P, M, d]."""
    if precision == "fp64":
        a, b = a.double(), b.double()
        if metric == "cosine":
            dot = torch.bmm(a, b.transpose(1, 2))
            na, nb = a.norm(dim=-1), b.norm(dim=-1)
            den = na[:, :, None] * nb[:, None, :]
            return torch.where(den > 0, 1.0 - dot / torch.where(den > 0, den, 1.0), 1.0)
        d = torch.cdist(a, b, compute_mode="donot_use_mm_for_euclid_dist")
        return d * d if metric == "sqeuclidean" else d
    if precision not in LOWER:
        raise ValueError(f"unknown precision {precision!r}")
    a, b = rounded(a, precision), rounded(b, precision)
    dot = torch.bmm(a, b.transpose(1, 2))
    na, nb = (a * a).sum(-1), (b * b).sum(-1)
    if metric == "cosine":
        den = torch.sqrt(na)[:, :, None] * torch.sqrt(nb)[:, None, :]
        return torch.where(den > 0, 1.0 - dot / torch.where(den > 0, den, 1.0), 1.0)
    sq = torch.clamp(na[:, :, None] + nb[:, None, :] - 2.0 * dot, min=0.0)
    return sq if metric == "sqeuclidean" else torch.sqrt(sq)


def accumulate(C: torch.Tensor, valid: torch.Tensor | None) -> torch.Tensor:
    """[P, N+1, M+1] accumulated costs over C [P, N, M] (row and column 0
    the virtual start: R[i, j] sits at [i+1, j+1]), +inf outside ``valid``."""
    P, N, M = C.shape
    if valid is not None:
        C = torch.where(valid, C, torch.inf)
    R = torch.full((P, N + 1, M + 1), torch.inf, dtype=C.dtype, device=C.device)
    R[:, 0, 0] = 0.0
    for k in range(N + M - 1):
        ii = torch.arange(max(0, k - M + 1), min(N - 1, k) + 1, device=C.device)
        jj = k - ii
        best = torch.minimum(torch.minimum(R[:, ii, jj], R[:, ii, jj + 1]), R[:, ii + 1, jj])
        R[:, ii + 1, jj + 1] = C[:, ii, jj] + best
    return R


def _blocks(la: np.ndarray, lb: np.ndarray, budget: int):
    """Pair indices in blocks of like sizes, each block's cost and
    accumulation arrays within ``budget`` bytes."""
    order = np.argsort(np.maximum(la, lb), kind="stable")
    n, m = int(la.max()), int(lb.max())
    size = max(1, budget // (24 * n * m))
    for s in range(0, len(order), size):
        yield order[s:s + size]


def dtw_distances(feats_a: torch.Tensor, feats_b: torch.Tensor, la: np.ndarray,
                  lb: np.ndarray, *, metric: str = "euclidean", band: int | None = None,
                  band_mode: str = "diag", normalize: str = "path_len",
                  auto_widen: bool = True, precision: str = "fp64",
                  budget: int = 1 << 31) -> np.ndarray:
    """[P] float64 distances of pairs (feats_a[p, :la[p]], feats_b[p, :lb[p]]),
    in blocks on the features' device."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    out = np.empty(len(la), np.float64)
    dev = feats_a.device
    for idx in _blocks(la, lb, budget):
        n, m = int(la[idx].max()), int(lb[idx].max())
        sel = torch.from_numpy(idx).to(dev)
        a, b = feats_a[sel, :n], feats_b[sel, :m]
        ta, tb = torch.from_numpy(la[idx]).to(dev), torch.from_numpy(lb[idx]).to(dev)
        R = accumulate(costs(a, b, metric, precision), band_mask(ta, tb, n, m, band, band_mode,
                                                                auto_widen))
        d = R[torch.arange(len(idx), device=dev), ta, tb].double()
        if normalize == "path_len":
            d = d / (ta + tb).double()
        elif normalize != "none":
            raise ValueError(f"unknown normalize {normalize!r}")
        out[idx] = d.cpu().numpy()
    return out


def path_excess(feats_a: torch.Tensor, feats_b: torch.Tensor, la: np.ndarray, lb: np.ndarray,
                paths: list, *, metric: str = "euclidean", band: int | None = None,
                band_mode: str = "diag", auto_widen: bool = True,
                budget: int = 1 << 30) -> np.ndarray:
    """[P] the cost of each given warping path over the least cost, less 1,
    in float64: 0 for an optimal path, +inf for one that is no warping path
    (not from (0, 0) to (la-1, lb-1) by unit steps, or outside the band)."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    out = np.full(len(la), np.inf)
    dev = feats_a.device
    for idx in _blocks(la, lb, budget):
        n, m = int(la[idx].max()), int(lb[idx].max())
        sel = torch.from_numpy(idx).to(dev)
        ta, tb = torch.from_numpy(la[idx]).to(dev), torch.from_numpy(lb[idx]).to(dev)
        C = costs(feats_a[sel, :n], feats_b[sel, :m], metric, "fp64")
        valid = band_mask(ta, tb, n, m, band, band_mode, auto_widen)
        R = accumulate(C, valid)
        best = R[torch.arange(len(idx), device=dev), ta, tb].cpu().numpy()
        C_np = C.cpu().numpy()
        valid_np = None if valid is None else valid.cpu().numpy()
        for r, p in enumerate(idx):
            pth = np.asarray(paths[p], np.int64).reshape(-1, 2)
            steps = np.diff(pth, axis=0)
            ok = (len(pth) > 0 and tuple(pth[0]) == (0, 0)
                  and tuple(pth[-1]) == (la[p] - 1, lb[p] - 1)
                  and bool(np.all((steps >= 0) & (steps <= 1)))
                  and bool(np.all(steps.sum(1) >= 1)))
            if not ok or (valid_np is not None and not valid_np[r, pth[:, 0], pth[:, 1]].all()):
                continue
            out[p] = C_np[r, pth[:, 0], pth[:, 1]].sum() / best[r] - 1.0 if best[r] > 0 else (
                0.0 if C_np[r, pth[:, 0], pth[:, 1]].sum() == 0 else np.inf)
    return out


def warping_paths(feats_a: torch.Tensor, feats_b: torch.Tensor, la: np.ndarray, lb: np.ndarray,
                  *, metric: str = "euclidean", band: int | None = None,
                  band_mode: str = "diag", auto_widen: bool = True, precision: str = "fp64",
                  budget: int = 1 << 30) -> list:
    """Each pair's least-cost warping path [(i, j), ...] from (0, 0), by
    backtrace; ties break diagonal, then up (i-1, j), then left (i, j-1),
    as the oracle's ``dtw_path_oracle``."""
    la, lb = np.asarray(la, np.int64), np.asarray(lb, np.int64)
    out: list = [None] * len(la)
    dev = feats_a.device
    for idx in _blocks(la, lb, budget):
        n, m = int(la[idx].max()), int(lb[idx].max())
        sel = torch.from_numpy(idx).to(dev)
        ta, tb = torch.from_numpy(la[idx]).to(dev), torch.from_numpy(lb[idx]).to(dev)
        R = accumulate(costs(feats_a[sel, :n], feats_b[sel, :m], metric, precision),
                       band_mask(ta, tb, n, m, band, band_mode, auto_widen)).cpu().numpy()
        for r, p in enumerate(idx):
            i, j = int(la[p]), int(lb[p])       # R's indices are one past the cell's
            path = [(i - 1, j - 1)]
            while (i, j) != (1, 1):
                cand = ((R[r, i - 1, j - 1], i - 1, j - 1), (R[r, i - 1, j], i - 1, j),
                        (R[r, i, j - 1], i, j - 1))
                _, i, j = min(cand, key=lambda c: c[0])
                path.append((i - 1, j - 1))
            out[p] = path[::-1]
    return out

"""NumPy oracle for DTW (SURVEY.md SS4.3): naive O(N*M) double loop.

Recurrence (inf-initialized, virtual D[-1,-1] = 0):
    D[i,j] = cost(a[i], b[j]) + min(D[i-1,j], D[i,j-1], D[i-1,j-1])
Distance is D[N-1,M-1], optionally normalized by path-length proxy (N+M).

Two band semantics (`band_mode`):

* "widen" — Sakoe-Chiba band |i-j| <= w with w auto-widened to
  max(band, |N-M|) so a path always exists.  For length-mismatched pairs
  the effective band balloons to the length difference.
* "diag" — the scaled Sakoe-Chiba corridor around the corner-to-corner
  diagonal: cell (i, j) is valid iff

      |j*(N-1) - i*(M-1)| <= max(band, 1) * max(N-1, M-1)

  i.e. the band half-width is measured along the LONGER axis around the
  line from (0,0) to (N-1,M-1).  Properties (all exercised in
  tests/test_dtw.py + test_properties.py): symmetric under (a,b) swap,
  both corners always valid, step-connected for any band >= 1 (so a path
  always exists without widening), exact integer predicate (no float
  rounding at corridor edges), and for N == M identical to "widen".
  Degenerate N == 1 or M == 1 pairs keep every cell valid, matching the
  only possible warping.  This is the production semantic for banded
  all-pairs jobs: it keeps the lane kernel's stripe width at
  O(band * len_ratio) instead of O(|N-M|) (ops/dtw_pallas.py).

Copy of ``audio_pattern_discovery_tpu/oracle/dtw.py``; only the import paths differ.
"""

from __future__ import annotations

import numpy as np


def _cost(a: np.ndarray, b: np.ndarray, metric: str) -> float:
    if metric == "sqeuclidean":
        d = a - b
        return float(np.dot(d, d))
    if metric == "euclidean":
        d = a - b
        return float(np.sqrt(np.dot(d, d)))
    if metric == "cosine":
        na = np.linalg.norm(a)
        nb = np.linalg.norm(b)
        if na == 0.0 or nb == 0.0:
            return 1.0
        return float(1.0 - np.dot(a, b) / (na * nb))
    raise ValueError(f"unknown metric {metric!r}")


def _effective_band(n: int, m: int, band: int | None, auto_widen: bool) -> int:
    if band is None:
        return max(n, m)
    if auto_widen:
        return max(band, abs(n - m))
    return band


def band_valid(
    i: int,
    j: int,
    n: int,
    m: int,
    band: int | None,
    auto_widen: bool = True,
    band_mode: str = "widen",
) -> bool:
    """Is cell (i, j) of an n x m DP grid inside the band?  The single
    source of truth for both band semantics (module docstring)."""
    if band is None:
        return True
    if band_mode == "diag":
        den, num = n - 1, m - 1
        r = max(int(band), 1)
        return abs(j * den - i * num) <= r * max(den, num)
    if band_mode != "widen":
        raise ValueError(f"unknown band_mode {band_mode!r}")
    return abs(i - j) <= _effective_band(n, m, band, auto_widen)


def dtw_cost_matrix(
    a: np.ndarray,
    b: np.ndarray,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    band_mode: str = "widen",
) -> np.ndarray:
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    n, m = len(a), len(b)
    D = np.full((n, m), np.inf, dtype=np.float64)
    for i in range(n):
        for j in range(m):
            if not band_valid(i, j, n, m, band, auto_widen, band_mode):
                continue
            c = _cost(a[i], b[j], metric)
            if i == 0 and j == 0:
                pred = 0.0
            else:
                pred = min(
                    D[i - 1, j] if i > 0 else np.inf,
                    D[i, j - 1] if j > 0 else np.inf,
                    D[i - 1, j - 1] if (i > 0 and j > 0) else np.inf,
                )
            D[i, j] = c + pred
    return D


def dtw_oracle(
    a: np.ndarray,
    b: np.ndarray,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    band_mode: str = "widen",
) -> float:
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    D = dtw_cost_matrix(a, b, metric, band, auto_widen, band_mode)
    dist = D[-1, -1]
    if normalize == "path_len":
        dist = dist / (len(a) + len(b))
    elif normalize != "none":
        raise ValueError(f"unknown normalize {normalize!r}")
    return float(dist)


def dtw_path_oracle(
    a: np.ndarray,
    b: np.ndarray,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    band_mode: str = "widen",
) -> tuple[float, list[tuple[int, int]]]:
    """Distance + warping path via backtrace.

    Ties break in the order diag > up (i-1,j) > left (i,j-1), matching the
    device backtrace kernel; see ops/dtw.py.
    """
    a = np.atleast_2d(np.asarray(a, dtype=np.float64))
    b = np.atleast_2d(np.asarray(b, dtype=np.float64))
    D = dtw_cost_matrix(a, b, metric, band, auto_widen, band_mode)
    i, j = len(a) - 1, len(b) - 1
    path = [(i, j)]
    while i > 0 or j > 0:
        cand = [
            (D[i - 1, j - 1] if (i > 0 and j > 0) else np.inf, (i - 1, j - 1)),
            (D[i - 1, j] if i > 0 else np.inf, (i - 1, j)),
            (D[i, j - 1] if j > 0 else np.inf, (i, j - 1)),
        ]
        best = min(range(3), key=lambda k: cand[k][0])
        i, j = cand[best][1]
        path.append((i, j))
    path.reverse()
    return float(D[-1, -1]), path

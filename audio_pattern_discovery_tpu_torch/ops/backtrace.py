"""Warping-path extraction (SURVEY.md SS3 row 8, SS8 'backtrace memory').

Strategy: the all-pairs phase computes distances only (O(S) memory per pair).
Paths are materialized *after* clustering, re-running just the within-cluster
pairs through `dtw_batch_with_dirs` and walking the direction tensor on the
host — full direction matrices for 50M pairs would be impossible, but the
handful of exemplar<->member pairs is trivial.

Copy of ``audio_pattern_discovery_tpu/ops/backtrace.py``; only the import paths differ.
"""

from __future__ import annotations

import numpy as np


def walk_path(
    dirs: np.ndarray,    # [K, M] uint8 diagonal-major (dirs[i+j, j] for cell (i,j))
    n: int,
    m: int,
) -> list[tuple[int, int]]:
    """Backtrace from (n-1, m-1) to (0, 0). 0=diag, 1=up, 2=left."""
    i, j = n - 1, m - 1
    path = [(i, j)]
    guard = n + m + 2
    while (i > 0 or j > 0) and guard > 0:
        d = int(dirs[i + j, j])
        if d == 0:
            i, j = i - 1, j - 1
        elif d == 1:
            i -= 1
        else:
            j -= 1
        # Clamp against corrupt directions at the grid edge.
        i, j = max(i, 0), max(j, 0)
        path.append((i, j))
        guard -= 1
    path.reverse()
    return path


def paths_from_dirs(
    dirs_batch: np.ndarray,  # [B, K, M]
    len_a: np.ndarray,       # [B]
    len_b: np.ndarray,       # [B]
) -> list[list[tuple[int, int]]]:
    return [
        walk_path(np.asarray(dirs_batch[p]), int(len_a[p]), int(len_b[p]))
        for p in range(dirs_batch.shape[0])
    ]

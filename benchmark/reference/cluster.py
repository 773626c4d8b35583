"""Agglomerative clustering by SciPy, and the configuration's automatic cut.

The cut is the port's documented rule (``cluster.auto_cut="gap"``): the
first gap between consecutive finite merge heights at least
``auto_cut_min_rel_gap`` times the lower one and at least 5 % of the
heights' range to their 0.9 quantile; without one, the
``auto_cut_quantile`` quantile capped below the last three merges.  Merges
at or below the cut are applied.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform


def auto_cut(h: np.ndarray, quantile: float, min_rel_gap: float) -> float:
    h = np.asarray(h, np.float64)
    h = h[np.isfinite(h)]
    n = len(h)
    if n == 0:
        return 0.0
    if n <= 4:
        return float(np.median(h))
    tiny = max(h[-1], 1.0) * 1e-12
    ratios = h[1:] / np.maximum(h[:-1], tiny)
    span = max(float(np.quantile(h, 0.9)) - float(h[0]), tiny)
    over = np.flatnonzero((ratios >= min_rel_gap) & ((h[1:] - h[:-1]) >= 0.05 * span))
    if len(over):
        i = int(over[0])
        return float(0.5 * (h[i] + h[i + 1]))
    return float(np.quantile(h, min(quantile, 1.0 - 3.0 / n)))


def cluster(D: np.ndarray, cl: dict) -> np.ndarray:
    """Flat labels of D under the configuration's linkage and cut."""
    Z = linkage(squareform(np.asarray(D, np.float64), checks=False), method=cl["linkage"])
    thr = cl["distance_threshold"]
    if thr is None:
        if cl["n_clusters"] is not None:
            return fcluster(Z, t=cl["n_clusters"], criterion="maxclust") - 1
        thr = auto_cut(Z[:, 2], cl["auto_cut_quantile"],
                       cl["auto_cut_min_rel_gap"] if cl["auto_cut"] == "gap" else np.inf)
    return fcluster(Z, t=thr, criterion="distance") - 1


def partition_gap(labels_a: np.ndarray, labels_b: np.ndarray) -> int:
    """Segments that do not share their cluster with the same segments in
    both labelings (0 when the two partitions are equal)."""
    a, b = np.asarray(labels_a), np.asarray(labels_b)
    same_a = a[:, None] == a[None, :]
    same_b = b[:, None] == b[None, :]
    return int((same_a != same_b).any(axis=1).sum())

"""Cluster-quality metrics over the precomputed DTW distance matrix
(SURVEY.md SS3 row 8 reporting surface).

Host-side NumPy: K is at most tens of thousands and the [K, K] matrix is
already on host after the DTW stage — a device round trip would cost more
than the O(K^2) arithmetic it saves.  Verified against
sklearn.metrics.silhouette_* (tests/test_metrics.py).

Copy of ``audio_pattern_discovery_tpu/cluster/metrics.py``; only the import paths differ.
"""

from __future__ import annotations

import numpy as np


def silhouette_samples(D: np.ndarray, labels: np.ndarray) -> np.ndarray:
    """Per-segment silhouette s(i) = (b - a) / max(a, b) from a precomputed
    symmetric distance matrix.

    a = mean distance to the OTHER members of i's cluster; b = the smallest
    mean distance to any other cluster.  Singleton clusters score 0 (the
    sklearn convention: cohesion is undefined with no co-members).
    """
    D = np.asarray(D, np.float64)
    labels = np.asarray(labels)
    K = len(labels)
    if D.shape != (K, K):
        raise ValueError(f"D shape {D.shape} != ({K}, {K})")
    uniq = np.unique(labels)
    if len(uniq) < 2:
        return np.zeros(K)
    members = {int(c): np.where(labels == c)[0] for c in uniq}
    # Mean distance from every segment to every cluster in one [K, C] pass.
    sums = np.stack([D[:, idx].sum(axis=1) for idx in members.values()], axis=1)
    sizes = np.array([len(idx) for idx in members.values()], dtype=np.float64)
    col = {int(c): j for j, c in enumerate(members)}
    own = np.array([col[int(l)] for l in labels])
    own_size = sizes[own]
    multi = own_size > 1
    a = np.where(multi, sums[np.arange(K), own] / np.maximum(own_size - 1, 1), 0.0)
    mean_to = sums / sizes[None, :]
    mean_to[np.arange(K), own] = np.inf          # exclude own cluster from b
    b = mean_to.min(axis=1)
    denom = np.maximum(a, b)
    s = np.where(multi & (denom > 0), (b - a) / np.where(denom > 0, denom, 1.0), 0.0)
    return s


def cluster_quality(D: np.ndarray, labels: np.ndarray) -> dict:
    """Manifest-ready summary: overall mean silhouette plus per-cluster
    mean silhouette, mean intra-cluster distance, and size."""
    labels = np.asarray(labels)
    s = silhouette_samples(D, labels)
    per = {}
    for c in np.unique(labels):
        idx = np.where(labels == c)[0]
        intra = (
            float(D[np.ix_(idx, idx)].sum() / (len(idx) * (len(idx) - 1)))
            if len(idx) > 1
            else 0.0
        )
        per[int(c)] = {
            "size": int(len(idx)),
            "silhouette": round(float(s[idx].mean()), 4),
            "mean_intra_distance": round(intra, 6),
        }
    return {
        "silhouette_mean": round(float(s.mean()), 4),
        "clusters": per,
    }

"""Oracle for agglomerative clustering: scipy.cluster.hierarchy (SURVEY.md SS5.2).

The production implementation (cluster/agglomerative.py, NumPy NN-chain +
optional C++ native) must produce merges equivalent to scipy's `linkage` for
single/complete/average/weighted linkage on a condensed distance matrix.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage
from scipy.spatial.distance import squareform


def linkage_oracle(dist_matrix: np.ndarray, method: str = "average") -> np.ndarray:
    """scipy linkage matrix Z for a square symmetric distance matrix."""
    condensed = squareform(np.asarray(dist_matrix, dtype=np.float64), checks=False)
    return linkage(condensed, method=method)


def cut_oracle(
    Z: np.ndarray,
    distance_threshold: float | None = None,
    n_clusters: int | None = None,
) -> np.ndarray:
    """0-based flat cluster labels from a linkage matrix."""
    if distance_threshold is not None:
        labels = fcluster(Z, t=distance_threshold, criterion="distance")
    elif n_clusters is not None:
        labels = fcluster(Z, t=n_clusters, criterion="maxclust")
    else:
        raise ValueError("need distance_threshold or n_clusters")
    return np.asarray(labels) - 1

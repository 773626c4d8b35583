"""Copy of ``audio_pattern_discovery_tpu/cluster/__init__.py``; only the import paths differ."""

from audio_pattern_discovery_tpu_torch.cluster.agglomerative import (  # noqa: F401
    cluster_distance_matrix,
    cut_linkage,
    linkage,
)

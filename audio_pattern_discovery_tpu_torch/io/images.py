"""Per-cluster spectrogram images (SURVEY.md SS3 row 8, SS1.2).

The reference's typical auxiliary output for human inspection of discovered
motifs is per-cluster audio snippets and/or spectrogram images; snippets are
written by pipeline.write_artifacts, images here.  Host-side only — render
time is trivial next to DTW, and matplotlib's Agg backend needs no display.

Copy of ``audio_pattern_discovery_tpu/io/images.py``; only the import paths differ.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_cluster_images(
    out_dir: str | Path,
    clusters,                      # list[ClusterReport]
    seg_spectrograms: np.ndarray,  # [K, L, bins] raw (log) spectrogram segments
    seg_lengths: np.ndarray,       # [K]
    *,
    max_per_cluster: int = 8,
    cmap: str = "magma",
    dpi: int = 80,
) -> list[Path]:
    """One PNG per cluster: members' spectrograms side by side, exemplar first.

    Returns the written paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written: list[Path] = []
    for rep in clusters:
        members = [rep.exemplar] + [m for m in rep.members if m != rep.exemplar]
        members = members[:max_per_cluster]
        n = len(members)
        fig, axes = plt.subplots(
            1, n, figsize=(2.2 * n, 2.6), squeeze=False, dpi=dpi
        )
        vmin = min(
            float(seg_spectrograms[m, : seg_lengths[m]].min()) for m in members
        )
        vmax = max(
            float(seg_spectrograms[m, : seg_lengths[m]].max()) for m in members
        )
        for ax, m in zip(axes[0], members):
            spec = seg_spectrograms[m, : seg_lengths[m]]        # [T, bins]
            ax.imshow(
                spec.T,
                origin="lower",
                aspect="auto",
                cmap=cmap,
                vmin=vmin,
                vmax=vmax,
                interpolation="nearest",
            )
            tag = "exemplar" if m == rep.exemplar else f"seg {m}"
            ax.set_title(tag, fontsize=8)
            ax.set_xticks([])
            ax.set_yticks([])
        fig.suptitle(f"cluster {rep.cluster_id} ({len(rep.members)} members)")
        fig.tight_layout()
        path = out / f"cluster{rep.cluster_id:03d}.png"
        fig.savefig(path)
        plt.close(fig)
        written.append(path)
    return written

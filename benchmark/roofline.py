"""Work and roofline arithmetic of the all-pairs DTW, frozen with the benchmark.

Copies of ``chip_smoke.py``'s ``cell_ops``, ``bound``, ``pair_cells``,
``pair_bytes`` and ``job_cells``, and the H100's published peaks.  The
counts come from a job's shapes alone (the lengths, the band, the frame
width), so a share of the bound reads the same work whatever kernel does it.
"""

from __future__ import annotations

import numpy as np
import torch

# One NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet: fp32
# outside the tensor cores, and device memory.
FP32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12


def cell_ops(d: int) -> int:
    """fp32 operations of one Euclidean DP cell: d subtractions, d FMAs (2
    each), a sqrt, two mins and an add."""
    return 3 * d + 4


def bound(cells: float, d: int, nbytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the least time the card could take for the
    cells and the bytes (each input read once, each output written once)."""
    t_ops, t_bytes = cells * cell_ops(d) / FP32_OPS_S, nbytes / HBM_BYTES_S
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def pair_cells(la, lb, kind: str, band: int | None = None):
    """DP cells each pair's distance needs (int64 tensor like la): "full"
    every cell of the la x lb rectangle; "widen" |j - i| <= max(band, |la-lb|);
    "diag" the corridor |j(la-1) - i(lb-1)| <= max(band,1) max(la-1, lb-1)."""
    la, lb = la.long(), lb.long()
    if kind == "full":
        return la * lb
    total = torch.zeros_like(la)
    if kind == "widen":
        pw = torch.clamp((la - lb).abs(), min=int(band))
    else:
        den_t, num = la - 1, lb - 1
        thresh = max(int(band), 1) * torch.maximum(den_t, num)
    for i in range(int(la.max())):
        if kind == "widen":
            lo, hi = torch.clamp(i - pw, min=0), torch.minimum(lb - 1, i + pw)
        else:
            m = i * num
            lo = torch.where(den_t > 0, -torch.div(thresh - m, den_t.clamp(min=1),
                                                   rounding_mode="floor"), 0).clamp(min=0)
            hi = torch.where(den_t > 0, torch.div(m + thresh, den_t.clamp(min=1),
                                                  rounding_mode="floor"), lb - 1)
            hi = torch.minimum(hi, lb - 1)
        total += torch.where(i < la, (hi - lo + 1).clamp(min=0), 0)
    return total


def pair_bytes(la, lb, d: int) -> float:
    """Bytes of one call on gathered pairs: each pair's live frames (la and
    lb of d floats; the padding past them is never read), its two lengths
    and its output."""
    return float((la.long() + lb.long()).sum()) * d * 4.0 + len(la) * 12.0


def job_cells(lens_np, kind: str, band: int | None = None) -> float:
    """Cells of all K(K-1)/2 pairs of a job, from its length histogram (the
    cell counts are symmetric in the two lengths)."""
    vals, counts = np.unique(lens_np, return_counts=True)
    la = torch.from_numpy(np.repeat(vals, len(vals)).astype(np.int64))
    lb = torch.from_numpy(np.tile(vals, len(vals)).astype(np.int64))
    cells = pair_cells(la, lb, kind, band).numpy().reshape(len(vals), len(vals))
    w = np.outer(counts, counts).astype(np.float64)
    np.fill_diagonal(w, counts * (counts - 1.0))
    return float((w * cells).sum() / 2)


def job_bound_s(lens_np, S: int, d: int, kind: str, band: int | None = None) -> float:
    """The least time of one all-pairs job: its cells' operations, or its
    padded features [K, S, d] and lengths read once and its [K, K] fp32 D
    written once, whichever takes longer."""
    K = len(lens_np)
    nbytes = K * (S * d + 1) * 4.0 + K * K * 4.0
    ms, _ = bound(job_cells(lens_np, kind, band), d, nbytes)
    return ms / 1e3

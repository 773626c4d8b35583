"""roofline.pair_cells and job_cells against a brute-force count on small
lengths, for the diag, widen and full kinds; the reference's band mask
agrees with the same count."""

import numpy as np
import pytest
import torch

from benchmark import roofline
from benchmark.reference.dtw import band_mask


def brute(n: int, m: int, kind: str, band: int) -> int:
    count = 0
    for i in range(n):
        for j in range(m):
            if kind == "full":
                ok = True
            elif kind == "widen":
                ok = abs(i - j) <= max(band, abs(n - m))
            else:
                ok = abs(j * (n - 1) - i * (m - 1)) <= max(band, 1) * max(n - 1, m - 1)
            count += ok
    return count


@pytest.mark.parametrize("kind", ["diag", "widen", "full"])
@pytest.mark.parametrize("band", [0, 1, 3])
def test_pair_cells_brute_force(kind, band):
    lens = [1, 2, 3, 5, 8, 13]
    la = torch.tensor([a for a in lens for _ in lens])
    lb = torch.tensor([b for _ in lens for b in lens])
    got = roofline.pair_cells(la, lb, kind, band).tolist()
    want = [brute(a, b, kind, band) for a, b in zip(la.tolist(), lb.tolist())]
    assert got == want
    if kind != "full":
        mask = band_mask(la, lb, 13, 13, band, kind)
        i = torch.arange(13)[None, :, None] < la[:, None, None]
        j = torch.arange(13)[None, None, :] < lb[:, None, None]
        assert (mask & i & j).sum((1, 2)).tolist() == want


def test_job_cells_sums_the_pairs():
    lens = np.array([3, 5, 5, 8, 2])
    want = sum(brute(lens[i], lens[j], "diag", 1) for i in range(5) for j in range(i + 1, 5))
    assert roofline.job_cells(lens, "diag", 1) == want


def test_bound_picks_the_larger():
    ms, by = roofline.bound(1e9, 16, 0.0)
    assert by == "operations" and ms == pytest.approx(1e9 * 52 / 67e12 * 1e3)
    ms, by = roofline.bound(0.0, 16, 3.35e12)
    assert by == "bytes" and ms == pytest.approx(1e3)

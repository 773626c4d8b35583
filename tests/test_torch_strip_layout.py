"""The host side of the strip kernels K1 and K2 (``csrc/dtw_strip.cuh``) on
the CPU: the corpus layout they read (``strip_layout``), its channel width
(``strip_channels``), the check of a prebuilt layout, and the launch widths.
The kernels themselves run only on the card (``chip_smoke.py`` phases 2 and
6 hold them against their twins); exact indexing here, no tolerance."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)


@pytest.mark.parametrize("d,nc4", [(1, 1), (4, 1), (5, 2), (8, 2), (9, 4), (16, 4),
                                   (17, 8), (32, 8), (33, 9), (64, 16)])
def test_strip_channels(d, nc4):
    # Register widths 1, 2, 4 and 8 float4s; wider frames take ceil(d/4).
    assert tk.strip_channels(d) == nc4


@pytest.mark.parametrize("d", [1, 5, 16, 33])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_strip_layout_indexing(d, metric):
    # Element [t, j, c, ch] is frame j, channel ch of sequence t*ti + c (its
    # unit frame for cosine); the padding channels are zero.
    rng = np.random.default_rng(40 + d)
    ti, nT, S = 4, 3, 7
    feats = torch.from_numpy(rng.normal(0, 1, (nT * ti, S, d)).astype(np.float32))
    x = tk._unit_frames(feats, metric)
    lay = tk.strip_layout(feats, ti, metric)
    dp = 4 * tk.strip_channels(d)
    assert lay.shape == (nT, S, ti, dp) and lay.dtype == torch.float32 and lay.is_contiguous()
    for t in range(nT):
        for j in range(S):
            for c in range(ti):
                np.testing.assert_array_equal(lay[t, j, c, :d].numpy(),
                                              x[t * ti + c, j].numpy())
    assert bool((lay[..., d:] == 0).all())
    # A thread's frame is dp consecutive floats; neighbouring threads' frames
    # are neighbours in memory.
    flat = lay.reshape(-1)
    assert flat[((1 * S + 2) * ti + 3) * dp] == lay[1, 2, 3, 0]


def test_prebuilt_frames_are_checked():
    feats = torch.zeros((8, 6, 5))
    good = tk.strip_layout(feats, 4)
    assert tk._check_frames(good, feats, 4, "euclidean") is good
    assert tk._check_frames(None, feats, 4, "euclidean").shape == good.shape
    strided = torch.zeros((2, 6, 8, 4)).transpose(2, 3)     # right shape, not contiguous
    for bad in (good[:, :5], good.double(), good.transpose(1, 2).contiguous(), strided):
        with pytest.raises(ValueError, match="strip_layout"):
            tk._check_frames(bad, feats, 4, "euclidean")


@pytest.mark.parametrize("ti,state,nc4,R", [(128, 256, 4, 4), (128, 128, 4, 4), (128, 60, 4, 4),
                                            (16, 32, 2, 8), (128, 4096, 4, 4)])
def test_strip_launch_widths(ti, state, nc4, R):
    # The block width keeps the most threads resident within the shared
    # memory of an SM; a state beyond one block's budget raises.
    def resident(lanes):
        smem = 4 * (state * lanes + 4 * R * nc4)
        if smem > tk._SMEM_BUDGET:
            return -1
        return min(tk._SM_SMEM // (smem + tk._BLOCK_RESERVED), 32, 2048 // lanes) * lanes

    widths = sorted({min(ti, w) for w in (128, 64, 32)}, reverse=True)
    if max(resident(w) for w in widths) < 0:
        with pytest.raises(ValueError, match="shared"):
            tk._strip_lanes(ti, state, nc4, R)
        return
    lanes = tk._strip_lanes(ti, state, nc4, R)
    assert lanes in widths
    assert resident(lanes) == max(resident(w) for w in widths)


def test_strip_rows_fit_registers():
    # K2 takes 8 rows where its A frames stay within 128 registers, but 4 at
    # 16 channels with a short boundary row (S <= 128); K1 always takes 4.
    assert tk._tile_strip_rows(256, 4) == 8 and tk._tile_strip_rows(256, 8) == 4
    assert tk._tile_strip_rows(128, 1) == 8 and tk._tile_strip_rows(128, 2) == 8
    assert tk._tile_strip_rows(128, 4) == 4 and tk._tile_strip_rows(128, 8) == 4
    assert tk._tile_strip_rows(512, 9) == 4 and tk.K1_ROWS == 4

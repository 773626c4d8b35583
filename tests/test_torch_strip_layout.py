"""The host side of the strip kernels K1, K2, K4 and K5
(``csrc/dtw_strip.cuh``) and of the systolic kernels K3, K6 and K7
(``csrc/dtw_systolic.cuh``) on the CPU: the corpus layouts they read
(``strip_layout`` for K1, K2 and K4, ``frame_layout`` for K3, K5, K6 and
K7), their channel width (``strip_channels``), the checks of a prebuilt
layout, and the launch widths, lane groups and rows a lane.  The kernels
themselves run only on the card (``chip_smoke.py`` phases 2, 6, 7, 12, 13
and 16 hold them against their twins); exact indexing here, no tolerance."""

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


@pytest.mark.parametrize("d", [1, 5, 16, 33])
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_frame_layout_indexing(d, metric):
    # K5's layout: element [k, j, ch] is frame j, channel ch of sequence k
    # (its unit frame for cosine), one sequence's frames consecutive; the
    # padding channels are zero.
    rng = np.random.default_rng(50 + d)
    K, S = 6, 7
    feats = torch.from_numpy(rng.normal(0, 1, (K, S, d)).astype(np.float32))
    x = tk._unit_frames(feats, metric)
    lay = tk.frame_layout(feats, metric)
    dp = 4 * tk.strip_channels(d)
    assert lay.shape == (K, S, dp) and lay.dtype == torch.float32 and lay.is_contiguous()
    for k in range(K):
        for j in range(S):
            np.testing.assert_array_equal(lay[k, j, :d].numpy(), x[k, j].numpy())
    assert bool((lay[..., d:] == 0).all())
    flat = lay.reshape(-1)
    assert flat[(4 * S + 5) * dp + 2] == lay[4, 5, 2]
    assert flat[(4 * S + 6) * dp] == lay[4, 6, 0] and flat[(5 * S) * dp] == lay[5, 0, 0]


def test_prebuilt_frames_are_checked():
    feats = torch.zeros((8, 6, 5))
    good = tk.strip_layout(feats, 4)
    assert tk._check_frames(good, feats, 4, "euclidean") is good
    assert tk._check_frames(None, feats, 4, "euclidean").shape == good.shape
    strided = torch.zeros((2, 6, 8, 4)).transpose(2, 3)     # right shape, not contiguous
    for bad in (good[:, :5], good.double(), good.transpose(1, 2).contiguous(), strided):
        with pytest.raises(ValueError, match="strip_layout"):
            tk._check_frames(bad, feats, 4, "euclidean")
    good5 = tk.frame_layout(feats)
    assert tk._check_frame_layout(good5, feats, "euclidean") is good5
    assert tk._check_frame_layout(None, feats, "euclidean").shape == good5.shape
    for bad in (good5[:, :5], good5.double(), good5.transpose(0, 1).contiguous(), good):
        with pytest.raises(ValueError, match="frame_layout"):
            tk._check_frame_layout(bad, feats, "euclidean")


@pytest.mark.parametrize("kernel,layout,name", [
    (tk.dtw_tile_lane_pairs, lambda f: tk.strip_layout(f, 4), "strip_layout"),
    (tk.dtw_tile_stripe_pairs, tk.frame_layout, "frame_layout"),
])
def test_widen_wrappers_check_prebuilt_frames(kernel, layout, name):
    # K4 and K5 check a prebuilt layout on any device, the CPU included: the
    # right one runs (the twin, here), the other kernel's or a mis-shaped one
    # raises.
    rng = np.random.default_rng(60)
    feats = torch.from_numpy(rng.normal(0, 1, (8, 6, 5)).astype(np.float32))
    n = torch.from_numpy(rng.integers(2, 7, 8).astype(np.int32))
    u = torch.tensor([0, 1], dtype=torch.int32)
    kw = dict(ti=4, band=2, wv_max=5)
    want = kernel(feats, n, u, u, **kw)
    np.testing.assert_array_equal(kernel(feats, n, u, u, frames=layout(feats), **kw), want)
    other = tk.frame_layout(feats) if name == "strip_layout" else tk.strip_layout(feats, 4)
    for bad in (other, layout(feats)[:1], layout(feats[:, :5])):
        with pytest.raises(ValueError, match=name):
            kernel(feats, n, u, u, frames=bad, **kw)


@pytest.mark.parametrize("ti,state,nc4,R", [(128, 256, 4, 4), (128, 128, 4, 4), (128, 60, 4, 4),
                                            (16, 32, 2, 8), (128, 4096, 4, 4),
                                            # K4's class stripes W = 2*wv+2
                                            (128, 34, 4, 4), (128, 130, 1, 4), (128, 258, 8, 4),
                                            (128, 1026, 4, 4), (8, 66, 10, 4)])
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


@pytest.mark.parametrize("ti,wv,nc4", [(128, 64, 4), (128, 758, 4), (128, 2047, 8), (2, 16, 1),
                                       (128, 30_000, 4)])
def test_stripe_warps(ti, wv, nc4):
    # K5: at most 4 warps (its launch bound) and ti, within one block's
    # shared memory at the strip's A frames and a boundary row of 2*wv+1
    # floats a warp; a row beyond one block's budget raises.
    per_warp = 4 * (4 * tk.STRIP_ROWS * nc4 + 4 * -(-(2 * wv + 1) // 4))
    if per_warp > tk._SMEM_BUDGET:
        with pytest.raises(ValueError, match="shared"):
            tk._stripe_warps(ti, wv, nc4)
        return
    warps = tk._stripe_warps(ti, wv, nc4)
    assert 1 <= warps <= min(4, ti) and warps * per_warp <= tk._SMEM_BUDGET
    assert warps == min(4, ti) or (warps + 1) * per_warp > tk._SMEM_BUDGET


@pytest.mark.parametrize("d,metric,same", [(16, "euclidean", True), (8, "sqeuclidean", True),
                                           (16, "cosine", False), (5, "euclidean", False),
                                           (20, "euclidean", False)])
def test_frame_layout_is_the_input_where_it_can_be(d, metric, same):
    # K7 takes gathered pairs as they are where they already are the frame
    # layout (d = 4*strip_channels(d), not cosine): no copy at a launch.
    rng = np.random.default_rng(70 + d)
    feats = torch.from_numpy(rng.normal(0, 1, (3, 6, d)).astype(np.float32))
    lay = tk.frame_layout(feats, metric)
    assert (lay is feats) == same
    np.testing.assert_array_equal(lay[..., :d].numpy(), tk._unit_frames(feats, metric).numpy())
    assert not (tk.frame_layout(feats[:, 1:], metric) is feats)    # not contiguous


@pytest.mark.parametrize("ti,W,nc4", [(128, 1024, 4), (128, 4096, 4), (128, 4096, 8), (4, 64, 1),
                                      (128, 1024, 10), (128, 60_000, 4)])
def test_lane_full_warps(ti, W, nc4):
    # K3: 8, 4, 2 or 1 warps a block (at most ti), the most resident on an
    # SM within its shared memory: the block's pass strip of 32R frames and
    # a boundary row of W floats a warp; a row beyond one block raises.
    R = tk._systolic_rows(nc4)
    assert R == (2 if nc4 == 8 else 4)

    def resident(w):
        smem = 16 * 32 * R * nc4 + 4 * W * w
        if smem > tk._SMEM_BUDGET:
            return -1
        return min(tk._SM_SMEM // (smem + tk._BLOCK_RESERVED), 32, 64 // w) * w

    choices = sorted({min(ti, w) for w in (8, 4, 2, 1)}, reverse=True)
    if max(resident(w) for w in choices) < 0:
        with pytest.raises(ValueError, match="shared"):
            tk._lane_full_warps(ti, W, nc4, R)
        return
    warps = tk._lane_full_warps(ti, W, nc4, R)
    assert warps in choices and resident(warps) == max(resident(w) for w in choices)


@pytest.mark.parametrize("wv,nc4", [(16, 4), (63, 4), (64, 4), (127, 4), (511, 8), (100, 10),
                                    (30_000, 4)])
def test_stripe_pair_rows_and_warps(wv, nc4):
    # K7: 2 rows a lane at every class; at most 4 warps (its launch bound)
    # within one block's shared memory at a pass's A frames (32R x nc4
    # float4s) and a boundary row of 2*wv+1 floats a warp; a row beyond one
    # block raises.
    R = tk.STRIPE_LANE_ROWS
    assert R == 2
    per_warp = 4 * (4 * 32 * R * nc4 + 4 * -(-(2 * wv + 1) // 4))
    if per_warp > tk._SMEM_BUDGET:
        with pytest.raises(ValueError, match="shared"):
            tk._stripe_pair_warps(wv, nc4)
        return
    warps = tk._stripe_pair_warps(wv, nc4)
    assert 1 <= warps <= 4 and warps * per_warp <= tk._SMEM_BUDGET
    assert warps == 4 or (warps + 1) * per_warp > tk._SMEM_BUDGET


def test_k3_wrapper_checks_prebuilt_frames():
    # K3 takes the frame layout as frames= and checks it on any device.
    rng = np.random.default_rng(61)
    feats = torch.from_numpy(rng.normal(0, 1, (8, 16, 5)).astype(np.float32))
    n = torch.from_numpy(rng.integers(2, 17, 8).astype(np.int32))
    u = torch.tensor([0, 1], dtype=torch.int32)
    kw = dict(ti=4, width=16)
    want = tk.dtw_tile_lane_full_pairs(feats, n, u, u, **kw)
    np.testing.assert_array_equal(
        tk.dtw_tile_lane_full_pairs(feats, n, u, u, frames=tk.frame_layout(feats), **kw), want)
    for bad in (tk.strip_layout(feats, 4), tk.frame_layout(feats)[:1]):
        with pytest.raises(ValueError, match="frame_layout"):
            tk.dtw_tile_lane_full_pairs(feats, n, u, u, frames=bad, **kw)


def test_strip_rows_fit_registers():
    # K2 takes 8 rows where its A frames stay within 128 registers, but 4 at
    # 16 channels with a short boundary row (S <= 128); K1 always takes 4.
    assert tk._tile_strip_rows(256, 4) == 8 and tk._tile_strip_rows(256, 8) == 4
    assert tk._tile_strip_rows(128, 1) == 8 and tk._tile_strip_rows(128, 2) == 8
    assert tk._tile_strip_rows(128, 4) == 4 and tk._tile_strip_rows(128, 8) == 4
    assert tk._tile_strip_rows(512, 9) == 4 and tk.STRIP_ROWS == 4


@pytest.mark.parametrize("S,band,nc4,want", [
    (128, 16, 4, (8, 2)), (96, 3, 1, (8, 2)), (128, None, 4, (8, 4)), (256, 16, 4, (16, 2)),
    (160, 0, 2, (16, 2)), (256, None, 4, (8, 4)), (288, 16, 4, (32, 2)), (512, None, 4, (32, 4)),
    (1024, 16, 10, (32, 2)), (1024, None, 10, (32, 4)), (128, None, 8, (8, 2)),
    (1024, None, 8, (32, 2)), (256, 16, 8, (16, 2))])
def test_rowscan_geometry(S, band, nc4, want):
    # K6's lane group G and rows a lane R per class, as measured on the card
    # (banded: G=8 to S=128, 16 to 256, else 32, R=2; unbanded: G=8 to
    # S=256, else 32, R=4), and at most 2 rows at 8 float4s a frame.
    assert tk._rowscan_geometry(S, band, nc4) == want


@pytest.mark.parametrize("S,nc4", [(128, 4), (256, 8), (1024, 1), (1024, 4), (1024, 8),
                                   (1024, 10), (1024, 64), (1024, 160)])
@pytest.mark.parametrize("G,R", [(8, 2), (8, 4), (16, 2), (32, 2), (32, 4)])
def test_rowscan_warps_fit_shared_memory(S, nc4, G, R):
    # K6: at most 4 warps a block (its launch bound), each with a pass's A
    # frames (32R x nc4 float4s) and 32/G boundary rows of S floats rounded
    # up to whole float4s, within one block's shared memory; every lane group
    # fits at S=1024 (the longest bucket K6 takes) at the frame widths the
    # port runs, and a warp beyond the budget raises.
    per_warp = 4 * (4 * 32 * R * nc4 + 4 * -(-(32 // G) * S // 4))
    if per_warp > tk._SMEM_BUDGET:
        assert nc4 == 160
        with pytest.raises(ValueError, match="shared"):
            tk._rowscan_warps(G, R, S, nc4)
        return
    warps = tk._rowscan_warps(G, R, S, nc4)
    assert 1 <= warps <= 4 and warps * per_warp <= tk._SMEM_BUDGET
    assert warps == 4 or (warps + 1) * per_warp > tk._SMEM_BUDGET
    if S == 1024 and nc4 <= 10:
        assert warps >= 2

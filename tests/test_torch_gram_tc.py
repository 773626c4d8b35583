"""K8's Gram instantiation on the tensor cores (``dtw.dtype=bfloat16``), on
the CPU: its bf16 frame layout (``gram_layout``), the sizing of its shared
memory (``_gram_config``), the entry points taking the layout as
``frames=``, and the derived bound that ``chip_smoke.py`` phase 31 holds the
kernel to, checked here against a CPU model of the tensor cores' order of
summation.

The model (``_tc_dots``): every product of two bf16 frames' channels is
exact in fp32; the tensor core sums each k-step's 16 products (one
``mma.sync`` m16n8k16), and the k-steps add into the accumulator in turn.
Its two variants sum in channel order and in reverse (within each k-step
and across them), each addition rounded to nearest in fp32; the bound is
carried at one ulp, 2^-23, an addition (``TC_UNIT``), since the tensor
cores' fp32 accumulation is not documented as rounded to nearest.  The
model's costs then go through ``gram_cost``'s order of operations and a
cell-by-cell fp32 DTW, and the distances are held to the twin
(``dtw_long_batch_ref``) within ``tests/test_torch_bf16.py``'s per-pair
bound.  The kernel itself runs only on the card."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch.ops import dtw_long as tdl
from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import frame_layout
from test_torch_bf16 import TC_UNIT, _assert_within, _unit, _valid

torch.set_num_threads(1)

METRICS = ["euclidean", "sqeuclidean", "cosine"]
BANDS = {"unbanded": (None, "widen"), "widen": (8, "widen"), "diag": (8, "diag")}


@pytest.mark.parametrize("d", [5, 16, 20, 64])
def test_gram_layout_is_bf16_padded_to_16(d):
    rng = np.random.default_rng(d)
    feats = torch.from_numpy(rng.normal(0, 1, (3, 24, d)).astype(np.float32))
    d16 = -(-d // 16) * 16
    assert tdl.gram_channels(d) == d16
    for metric in ("euclidean", "cosine"):
        layout, norms = tdl.gram_layout(feats, metric)
        x = feats if metric == "euclidean" else torch.from_numpy(_unit(feats.numpy()))
        assert layout.shape == (3, 24, d16) and layout.dtype == torch.bfloat16
        assert layout.is_contiguous()
        assert bool((layout[..., d:] == 0).all())
        # Rounded to nearest even from the fp32 (unit) frames.
        torch.testing.assert_close(layout[..., :d], x.to(torch.bfloat16), rtol=0, atol=0)
        torch.testing.assert_close(layout[..., :d].float(), tdl.round_bf16(x), rtol=0, atol=0)
        # The norms are those of the unrounded frames, in fp32.
        assert norms.dtype == torch.float32 and norms.shape == (3, 24)
        torch.testing.assert_close(norms, torch.sum(x * x, dim=-1), rtol=0, atol=0)
        assert not torch.equal(norms, torch.sum(layout.float() ** 2, dim=-1))


@pytest.mark.parametrize("d", [5, 16, 20, 64])
def test_check_gram_layout_refuses_other_layouts(d):
    rng = np.random.default_rng(100 + d)
    feats = torch.from_numpy(rng.normal(0, 1, (2, 12, d)).astype(np.float32))
    layout, norms = tdl.gram_layout(feats, "euclidean")
    got = tdl._check_gram_layout((layout, norms), feats, "euclidean")
    assert got[0] is layout and got[1] is norms
    # The fp32 layout K8's Gram instantiation took before the tensor cores.
    old = frame_layout(tdl.round_bf16(feats), "euclidean")
    with pytest.raises(ValueError, match="bfloat16 gram_layout"):
        tdl._check_gram_layout((old, norms), feats, "euclidean")
    with pytest.raises(ValueError, match="bfloat16 gram_layout"):
        tdl._check_gram_layout((layout.float(), norms), feats, "euclidean")
    wide = torch.zeros((2, 12, layout.shape[2] + 16), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 gram_layout"):
        tdl._check_gram_layout((wide, norms), feats, "euclidean")
    with pytest.raises(ValueError, match="norms"):
        tdl._check_gram_layout((layout, norms[:, :5]), feats, "euclidean")
    with pytest.raises(ValueError, match="norms"):
        tdl._check_gram_layout((layout, norms.double()), feats, "euclidean")
    if layout.shape[2] > d:
        dirty = layout.clone()
        dirty[..., d] = 1.0
        with pytest.raises(ValueError, match="past the frame width"):
            tdl._check_gram_layout((dirty, norms), feats, "euclidean")


def _tc_dots(xa: np.ndarray, xb: np.ndarray, reverse: bool) -> np.ndarray:
    """[N, M] fp32 dot products of the bf16 frames xa [N, d16] and xb
    [M, d16] (held as fp32) in the tensor cores' order: 16 channels a
    k-step, the k-steps added into the accumulator in turn; ``reverse``
    reverses both orders."""
    n_steps = xa.shape[1] // 16
    parts = []
    for s in range(n_steps):
        chans = range(16 * s, 16 * s + 16)
        part = np.zeros((len(xa), len(xb)), np.float32)
        for c in reversed(chans) if reverse else chans:
            part = part + xa[:, c, None] * xb[None, :, c]
        parts.append(part)
    acc = np.zeros((len(xa), len(xb)), np.float32)
    for part in reversed(parts) if reverse else parts:
        acc = acc + part
    return acc


def _model_dtw(a, b, la, lb, metric, band, band_mode, reverse):
    """The Gram instantiation's distance of one pair on the CPU: the layout
    of ``gram_layout``, the dot products of ``_tc_dots``, ``gram_cost``'s
    order of operations and a cell-by-cell fp32 DP over the band."""
    (xa, na), (xb, nb) = (tdl.gram_layout(torch.from_numpy(x[None, :n]), metric)
                          for x, n in ((a, la), (b, lb)))
    xa, xb = xa[0].float().numpy(), xb[0].float().numpy()
    na, nb = na[0].numpy(), nb[0].numpy()
    dot = _tc_dots(xa, xb, reverse)
    if metric == "cosine":
        cost = np.float32(1.0) - dot
    else:
        cost = np.maximum((na[:, None] + nb[None, :]) - np.float32(2.0) * dot, np.float32(0.0))
        if metric == "euclidean":
            cost = np.sqrt(cost)
    cost = np.where(_valid(la, lb, band, band_mode), cost, np.float32(np.inf)).astype(np.float32)
    D = np.full((la + 1, lb + 1), np.inf, np.float32)
    D[0, 0] = 0.0
    for t in range(2, la + lb + 1):
        i = np.arange(max(1, t - lb), min(la, t - 1) + 1)
        j = t - i
        D[i, j] = cost[i - 1, j - 1] + np.minimum(np.minimum(D[i - 1, j - 1], D[i - 1, j]),
                                                  D[i, j - 1])
    return D[la, lb]


@pytest.mark.parametrize("band_name", list(BANDS))
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("d", [16, 64])
def test_tensor_core_order_within_the_derived_bound(d, metric, band_name):
    band, band_mode = BANDS[band_name]
    rng = np.random.default_rng(7 * d + len(metric) + len(band_name))
    B, S = 3, 96
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(40, S + 1, B).astype(np.int32)
    lb = rng.integers(40, S + 1, B).astype(np.int32)
    kw = dict(metric=metric, band=band, band_mode=band_mode)
    want = tdl.dtw_long_batch_ref(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(la),
                                  torch.from_numpy(lb), block=32, matmul_dtype="bfloat16",
                                  **kw).numpy()
    for reverse in (False, True):
        got = np.array([_model_dtw(a[p], b[p], int(la[p]), int(lb[p]), metric, band, band_mode,
                                   reverse) for p in range(B)])
        _assert_within(got, want, a, b, la, lb, unit=TC_UNIT, **kw)


# (d, BLK) -> (R, warps, stage_b, bytes), counted by hand: per warp its A
# pass (32R frames) and, staged, B's ring (64 frames and their 64 fp32
# norms), each frame nc4 + 1 = d16 / 8 + 1 units of 16 bytes, and a
# [32R x 32] fp32 ring of costs; then (warps + 2) BLK floats of rows and
# 3 (n_pass + 1) + n_pass counters, rounded up to 16 bytes.
GRAM_SIZES = {
    (16, 256): (4, 2, True, 2 * (128 * 3 * 16 + 64 * 3 * 16 + 256 + 128 * 32 * 4) + 4144),
    # Staged, 3 blocks (6 warps) an SM: B through the cache instead.
    (20, 256): (4, 2, False, 2 * (128 * 5 * 16 + 128 * 32 * 4) + 4144),
    (64, 256): (4, 2, False, 2 * (128 * 9 * 16 + 16384) + 4144),
    (128, 256): (4, 2, False, 2 * (128 * 17 * 16 + 16384) + 4144),
    (444, 256): (4, 1, False, 1 * (128 * 57 * 16 + 16384) + 3120),
    (16, 128): (4, 1, True, 1 * (128 * 3 * 16 + 64 * 3 * 16 + 256 + 16384) + 1568),
    (16, 64): (2, 1, True, 1 * (64 * 3 * 16 + 64 * 3 * 16 + 256 + 64 * 32 * 4) + 800),
    (16, 32): (1, 1, True, 1 * (32 * 3 * 16 + 64 * 3 * 16 + 256 + 32 * 32 * 4) + 416),
}


@pytest.mark.parametrize("d,BLK", list(GRAM_SIZES), ids=[f"d{d}-blk{b}" for d, b in GRAM_SIZES])
def test_gram_config_matches_hand_counted_bytes(d, BLK):
    R, warps, stage_b, nbytes = GRAM_SIZES[(d, BLK)]
    nc4 = tdl.gram_channels(d) // 8
    assert tdl._gram_config(nc4, BLK) == (R, warps, stage_b)
    assert tdl._gram_smem(BLK, nc4, R, warps, stage_b) == nbytes <= tdl._LONG_SMEM_BUDGET
    if stage_b:
        # Staged only where 8 warps stay resident on an SM.
        blocks = tdl._SM_SMEM // (nbytes + tdl._BLOCK_RESERVED)
        assert warps * blocks >= tdl._LONG_MIN_RESIDENT


def test_gram_config_candidates_and_its_limit():
    # The candidates phase 31 times against the chosen R = 4 at d=16: two
    # rows a lane (4 warps a CUDA block, 3 blocks an SM) and one (8 warps,
    # 2 blocks).
    for R, warps, nbytes, blocks in (
            (2, 4, 4 * (64 * 3 * 16 + 64 * 3 * 16 + 256 + 64 * 32 * 4) + 6224, 3),
            (1, 8, 8 * (32 * 3 * 16 + 64 * 3 * 16 + 256 + 32 * 32 * 4) + 10384, 2)):
        assert tdl._gram_smem(256, 2, R, warps, True) == nbytes
        assert tdl._SM_SMEM // (nbytes + tdl._BLOCK_RESERVED) == blocks
    # Past the budget one warp's A pass does not fit: raises, never falls back.
    with pytest.raises(ValueError, match="Gram pass"):
        tdl._gram_config(tdl.gram_channels(1200) // 8, 256)
    with pytest.raises(ValueError, match="multiple of 32"):
        tdl._gram_rows(48)


def _long_inputs(seed, d, metric):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(0, 1, (3, 128, d)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 1, (3, 128, d)).astype(np.float32))
    la = torch.from_numpy(rng.integers(50, 129, 3).astype(np.int32))
    lb = torch.from_numpy(rng.integers(50, 129, 3).astype(np.int32))
    return a, b, la, lb


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_long_pairs_accepts_the_layout(metric):
    a, _, la, _ = _long_inputs(11, 20, metric)
    ia, ib = np.array([0, 1, 2, 0]), np.array([1, 2, 0, 0])
    kw = dict(metric=metric, band=None, block=32, matmul_dtype="bfloat16")
    want = tdl.dtw_long_pairs(a, la, ia, ib, **kw)
    got = tdl.dtw_long_pairs(a, la, ia, ib, frames=tdl.gram_layout(a, metric), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="bfloat16 gram_layout"):
        tdl.dtw_long_pairs(a, la, ia, ib, frames=(frame_layout(a, metric), la.float()), **kw)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_long_batch_accepts_the_layout(metric):
    a, b, la, lb = _long_inputs(12, 16, metric)
    kw = dict(metric=metric, band=8, band_mode="diag", block=32, matmul_dtype="bfloat16")
    want = tdl.dtw_long_batch_ref(a, b, la, lb, **kw)
    got = tdl.dtw_long_batch(a, b, la, lb, frames=tdl.gram_layout(a, metric), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # An fp32 job refuses the bf16 layout.
    with pytest.raises(ValueError, match="float32 frame_layout"):
        tdl.dtw_long_batch(a, b, la, lb, frames=tdl.gram_layout(a, metric)[0], metric=metric,
                           block=32)


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_long_stripe_accepts_the_layouts(metric):
    a, b, la, lb = _long_inputs(13, 64, metric)
    kw = dict(metric=metric, band=8, auto_widen=True, band_mode="widen", matmul_dtype="bfloat16")
    want = tdl.dtw_long_batch_ref(a, b, la, lb, block=32, **kw)
    frames = (tdl.gram_layout(a, metric), tdl.gram_layout(b, metric))
    stripe = tdl.LongStripe(a, b, la, lb, block=32, J0=0, nJ=4, frames=frames, **kw)
    assert stripe.advance(0, stripe.n_diag) == 0          # the twin on the CPU
    torch.testing.assert_close(stripe.out, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="norms"):
        tdl.LongStripe(a, b, la, lb, block=32, J0=0, nJ=4,
                       frames=(frames[0], (frames[1][0], frames[1][1][:2])), **kw)

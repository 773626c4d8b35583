"""The port's blocked long-sequence DTW
(audio_pattern_discovery_tpu_torch/ops/dtw_long.py) against the JAX
package's ``ops/dtw_long.py`` and the NumPy oracle on the same seeded
inputs, and the per-pair scheduler's long buckets (K8's route) against the
JAX scheduler.  K8 itself (csrc/dtw_long_block.cu) runs only on the card:
``chip_smoke.py`` phase 27 holds it against the plain twin tested here.

Tolerances.  Both sides compute each cell as cost + min(diag, up, left) in
fp32, the port from squared differences, the reference from a Gram
expansion (HIGHEST precision), and the reference resolves each block row
with a min-plus Hillis-Steele scan, which reassociates the additions along
the row.  Over the <= 2S terms of a path both stay within a few ulps of the
path sum per term: 1e-4 at S <= 64 (the reference's own tests' tolerance),
1e-3 at S=1024 (its S=1024 test's).  Against the float64 oracle the same
bounds hold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_long as jdl
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu.parallel import pair_scheduler as jps
from audio_pattern_discovery_tpu.config import DTWConfig as JCfg
from audio_pattern_discovery_tpu_torch.config import DTWConfig
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tdc
from audio_pattern_discovery_tpu_torch.ops import dtw_long as tdl
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

torch.set_num_threads(1)


def _batch(seed, B, S, d=4, lo=None):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    lo = S // 2 if lo is None else lo
    la = rng.integers(lo, S + 1, B).astype(np.int32)
    lb = rng.integers(lo, S + 1, B).astype(np.int32)
    return a, b, la, lb


def _both(a, b, la, lb, **kw):
    want = np.asarray(jdl.dtw_long_batch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                                         jnp.asarray(lb), **kw))
    got = tdl.dtw_long_batch(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(la),
                             torch.from_numpy(lb), **kw).numpy()
    return got, want


def _close(got, want, tol):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("block", [8, 16, 32])
def test_long_batch_matches_jax_by_block(block):
    # The reference's test_matches_scan_wavefront case (B=5, S=32), plus an
    # empty side and a side past S (+inf on both sides).
    a, b, la, lb = _batch(1, B=5, S=32)
    la[3], lb[4] = 0, 40
    got, want = _both(a, b, la, lb, block=block)
    assert np.isinf(got[3:]).all()
    _close(got, want, 1e-4)


def test_long_batch_single_block_matches_oracle():
    # block >= S collapses to one block (the reference's degenerate case).
    a, b, la, lb = _batch(2, B=3, S=8)
    got, want = _both(a, b, la, lb, block=8)
    _close(got, want, 1e-4)
    for i in range(3):
        np.testing.assert_allclose(got[i], dtw_oracle(a[i, : la[i]], b[i, : lb[i]]),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("band,band_mode,auto_widen", [
    (3, "widen", True), (3, "widen", False), (0, "widen", True), (3, "diag", True),
    (1, "diag", True),
])
def test_long_batch_banded_matches_jax(band, band_mode, auto_widen):
    # A hard band gives +inf where the corner leaves it, on both sides.
    a, b, la, lb = _batch(3, B=6, S=32, lo=10)
    kw = dict(band=band, band_mode=band_mode, auto_widen=auto_widen, block=8)
    got, want = _both(a, b, la, lb, **kw)
    _close(got, want, 1e-4)
    for i in range(6):
        exp = dtw_oracle(a[i, : la[i]], b[i, : lb[i]], band=band, band_mode=band_mode,
                         auto_widen=auto_widen)
        if np.isinf(exp):
            assert np.isinf(got[i])
        else:
            np.testing.assert_allclose(got[i], exp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_long_batch_metrics_and_path_len(metric):
    a, b, la, lb = _batch(4, B=4, S=32)
    got, want = _both(a, b, la, lb, metric=metric, normalize="path_len", block=16)
    _close(got, want, 1e-4)
    raw = tdl.dtw_long_batch(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(la),
                             torch.from_numpy(lb), metric=metric, block=16).numpy()
    np.testing.assert_allclose(got, raw / (la + lb).astype(np.float32), rtol=1e-6)


def test_long_batch_matches_oracle_unpadded():
    # The reference's test_matches_oracle_unpadded (S=24, block 8).
    a, b, la, lb = _batch(5, B=4, S=24)
    got, want = _both(a, b, la, lb, block=8)
    _close(got, want, 1e-4)
    for i in range(4):
        np.testing.assert_allclose(got[i], dtw_oracle(a[i, : la[i]], b[i, : lb[i]]),
                                   rtol=1e-4, atol=1e-4)


def test_long_batch_s1024_band32_block256():
    # The reference's own long case (S=1024 past its per-pair kernel, band 32,
    # block 256): 4 x 4 blocks, so corners cross two diagonals.
    a, b, la, lb = _batch(6, B=2, S=1024, d=3)
    got, want = _both(a, b, la, lb, band=32, block=256)
    _close(got, want, 1e-3)
    for i in range(2):
        np.testing.assert_allclose(got[i], dtw_oracle(a[i, : la[i]], b[i, : lb[i]], band=32),
                                   rtol=1e-3, atol=1e-3)


def test_long_batch_self_distance_is_zero_across_block_corners():
    # Each sequence against itself on a 3 x 3 grid of blocks: the optimal path
    # is the main diagonal, which crosses from block (I-1, I-1) into (I, I)
    # only through the corner, so the distance is exactly 0; a corner taken
    # from the wrong diagonal gives a positive distance.
    a, _, la, _ = _batch(7, B=4, S=48, lo=33)
    x, n = torch.from_numpy(a), torch.from_numpy(la)
    assert (tdl.dtw_long_batch(x, x, n, n, block=16) == 0).all()


@pytest.mark.parametrize("band,band_mode", [(None, "widen"), (3, "widen"), (2, "diag")])
def test_block_kernel_matches_jax(band, band_mode):
    # One block from random boundaries, at offsets that are and are not 0,
    # with and without the terminal cell inside it; the port's kernel is
    # batched over leading dimensions, so all cases go in one call.
    rng = np.random.default_rng(8)
    BLK, d = 16, 4
    cases = [(0, 0, 10, 12), (16, 0, 20, 9), (16, 32, 25, 40), (32, 16, 40, 33),
             (16, 16, 60, 60), (0, 16, 5, 30)]
    n = len(cases)
    a = rng.normal(0, 1, (n, BLK, d)).astype(np.float32)
    b = rng.normal(0, 1, (n, BLK, d)).astype(np.float32)
    top = rng.uniform(0, 30, (n, BLK)).astype(np.float32)
    left = rng.uniform(0, 30, (n, BLK)).astype(np.float32)
    corner = rng.uniform(0, 30, n).astype(np.float32)
    top[0] = np.inf                   # block (0, 0): the virtual origin
    left[0] = np.inf
    corner[0] = 0.0
    row0, col0, la, lb = (np.array(c, np.int32) for c in zip(*cases))
    bw = np.maximum(band or 0, np.abs(la - lb)).astype(np.int32)
    got = tdl.dtw_block_kernel(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(top), torch.from_numpy(left),
        torch.from_numpy(corner), torch.from_numpy(row0), torch.from_numpy(col0),
        torch.from_numpy(la), torch.from_numpy(lb), band=band,
        band_width=None if band is None else torch.from_numpy(bw), band_mode=band_mode)
    got = [t.numpy() for t in got]
    assert got[3].any() and not got[3].all()
    for u in range(n):
        want = [np.asarray(x) for x in jdl.dtw_block_kernel(
            jnp.asarray(a[u]), jnp.asarray(b[u]), jnp.asarray(top[u]), jnp.asarray(left[u]),
            jnp.asarray(corner[u]), jnp.int32(row0[u]), jnp.int32(col0[u]), jnp.int32(la[u]),
            jnp.int32(lb[u]), metric="euclidean", band=band,
            band_width=None if band is None else jnp.int32(bw[u]), band_mode=band_mode)]
        _close(got[0][u], want[0], 1e-4)
        _close(got[1][u], want[1], 1e-4)
        assert bool(got[3][u]) == bool(want[3])
        if want[3]:
            _close(np.array([got[2][u]]), np.array([want[2]]), 1e-4)


def test_long_block_shape_equals_reference():
    for bucket in range(1, 9001):
        assert tdl.long_block_shape(bucket) == jps._long_block_shape(bucket), bucket


def test_k8_launch_geometry_and_devices():
    # Rows a lane: a pass of 32R rows must divide the block (K3's R=4, 2 at 8
    # float4s a frame); blocks that are not a multiple of 32 frames raise.
    assert [tdl._long_rows(blk, 4) for blk in (256, 128, 64, 32)] == [4, 4, 2, 1]
    assert tdl._long_rows(256, 8) == 2 and tdl._long_rows(96, 4) == 1
    with pytest.raises(ValueError, match="multiple of 32"):
        tdl._long_rows(16, 4)
    # A warp per pass of 32R rows (a CUDA block per DP block), B's frames
    # staged in a ring of 96 a warp where that leaves 8 warps resident on an
    # SM (A in registers at 1, 2 and 4 float4s, or 8 at R = 2); wider frames
    # read B through the cache, with fewer warps where their staged A passes
    # need it, and a pass whose A frames do not fit raises.
    assert [tdl._long_config(4, 4, 256), tdl._long_config(2, 8, 256),
            tdl._long_config(4, 4, 128), tdl._long_config(1, 10, 96),
            tdl._long_config(4, 16, 256), tdl._long_config(4, 99, 256)] == [
        (2, True), (4, True), (1, True), (3, True), (2, False), (1, False)]
    assert tdl._long_smem(256, 4, 4, 2, True) == 2 * 96 * 4 * 16 + 4144
    assert tdl._long_smem(256, 16, 4, 2, False) == 2 * 128 * 16 * 16 + 4144
    with pytest.raises(ValueError, match="shared memory"):
        tdl._long_config(4, 120, 256)
    a = torch.zeros((2, 64, 4))
    n = torch.full((2,), 64, dtype=torch.int32)
    with pytest.raises(ValueError, match="equal padded lengths"):
        tdl.dtw_long_batch(a, a[:, :32], n, n)
    with pytest.raises(ValueError, match="multiple of block"):
        tdl.dtw_long_batch(a, a, n, n, block=48)
    meta = a.to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tdl.dtw_long_batch(meta, meta, n.to("meta"), n.to("meta"), block=32)


@pytest.mark.parametrize("BLK", [32, 64, 96, 128, 256, 512, 1024, 2048])
def test_k8_takes_every_width_one_staged_pass_fits(BLK):
    # K8 runs every frame width at which one warp's staged A pass (32R frames)
    # and one boundary row fit the port's shared-memory budget, as the walk
    # that reads B from the cache needs; its block then fits K8's budget.
    for nc4 in range(1, 200):
        R = tdl._long_rows(BLK, nc4)
        if 16 * 32 * R * nc4 + 4 * BLK > tdc._SMEM_BUDGET:
            break
        warps, stage_b = tdl._long_config(R, nc4, BLK)
        assert 1 <= warps <= min(BLK // (32 * R), 8), (nc4, warps)
        assert tdl._long_smem(BLK, nc4, R, warps, stage_b) <= tdl._LONG_SMEM_BUDGET, nc4
    assert nc4 > 90


def _long_case(seed, K, L, lo, d=3):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, L + 1, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    return feats, lengths


@pytest.mark.parametrize("band_mode", ["widen", "diag"])
def test_overlong_bucket_per_pair_matches_jax(band_mode):
    # The reference's test_overlong_bucket_routes_to_blocked_path case: K=5,
    # L=1088 (past K6's 1024), band 24, one bucket; widen goes to K7, diag to
    # K8 in the port.
    feats, lengths = _long_case(9, K=5, L=1088, lo=1040)
    kw = dict(pair_batch=4, max_seq_len=1088, band=24, length_bucketing=False,
              band_mode=band_mode)
    want = jps.all_pairs_distances(feats, lengths, JCfg(use_pallas=False, **kw))
    got = tps.all_pairs_distances(feats, lengths, DTWConfig(**kw), tiled=False, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for i, j in ((0, 1), (2, 4)):
        np.testing.assert_allclose(got[i, j], dtw_oracle(
            feats[i, : lengths[i]], feats[j, : lengths[j]], band=24, normalize="path_len",
            band_mode=band_mode), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("L,band", [(1101, 24), (1100, None)])
def test_odd_and_unbanded_long_buckets_match_jax(L, band):
    # The odd bucket 1101 pads to whole blocks of 256 (never 1-frame blocks);
    # an unbanded bucket past 1024 raised in the port before K8.
    feats, lengths = _long_case(10, K=4, L=L, lo=1040)
    kw = dict(pair_batch=4, max_seq_len=L, band=band, length_bucketing=False)
    want = jps.all_pairs_distances(feats, lengths, JCfg(use_pallas=False, **kw))
    stats = {}
    got = tps.all_pairs_distances(feats, lengths, DTWConfig(**kw), tiled=False, device="cpu",
                                  stats=stats)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    assert stats["pad_pairs"] == 0   # K8's blocks are not padded


def test_long_blocks_known_and_block_dir_equal_full(tmp_path):
    # Long buckets (K8) under known= and block_dir give the full job's D; a
    # rerun reads every block back.
    feats, lengths = _long_case(11, K=5, L=1100, lo=1030)
    cfg = DTWConfig(band=None, length_bucketing=False)
    full = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu")
    got = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu",
                                  known=(3, full[:3, :3]))
    np.testing.assert_array_equal(got, full)
    for n in range(2):
        stats = {}
        got = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu",
                                      block_dir=tmp_path, stats=stats)
        np.testing.assert_array_equal(got, full)
        assert stats["blocks_resumed"] == (stats["blocks"] if n else 0)


def test_long_block_cap_gives_the_reference_blocks(monkeypatch, tmp_path):
    # The reference caps blocks past its per-pair kernels at 512 pairs; the
    # port's enumerate + cap must give its blocks (recorded where each loop
    # keys a block for block_dir; the DTW calls are stubbed out, so only the
    # blocking runs).  40 sequences of 1090 frames (780 pairs at bucket 1100:
    # 512 + 268) and 5 of 60 (a block of 200 pairs at bucket 1100, 10 at 64).
    lengths = np.concatenate([np.full(5, 60), np.full(40, 1090)]).astype(np.int32)
    feats = np.zeros((len(lengths), 1100, 2), np.float32)
    kw = dict(band=None, max_seq_len=1100)
    keyed = {"jax": [], "torch": []}

    def recorder(mod, name):
        real = mod._block_key

        def record(ii, jj, tag=b""):
            keyed[name].append((np.asarray(ii).tolist(), np.asarray(jj).tolist()))
            return real(ii, jj, tag)
        return record

    monkeypatch.setattr(jps, "_block_key", recorder(jps, "jax"))
    monkeypatch.setattr(jps, "_dtw_block", lambda f, l, ii, jj, **k: jnp.zeros(len(ii)))
    jps.all_pairs_distances(feats, lengths, JCfg(use_pallas=False, **kw),
                            block_dir=tmp_path / "jax")
    monkeypatch.setattr(tps, "_block_key", recorder(tps, "torch"))
    calls = []
    monkeypatch.setattr(tps, "dtw_long_pairs",
                        lambda f, n, ia, ib, **k: calls.append((ia, ib, k["block"])) or
                        torch.zeros(len(ia)))
    tps.all_pairs_distances(feats, lengths, DTWConfig(**kw), tiled=False, device="cpu",
                            block_dir=tmp_path / "torch")
    assert keyed["torch"] == keyed["jax"]
    assert sorted(len(ii) for ii, _ in keyed["torch"]) == [10, 200, 268, 512]
    # K8 takes the three long blocks' 980 pairs unpadded in one merged call,
    # by index into the corpus, in the blocks' order, with blocks of 256.
    long = [(ii, jj) for ii, jj in keyed["torch"] if len(ii) != 10]
    assert len(calls) == 1 and calls[0][2] == 256
    assert calls[0][0].tolist() == sum((ii for ii, _ in long), [])
    assert calls[0][1].tolist() == sum((jj for _, jj in long), [])


def test_diag_route_halves_the_tile_until_k1_takes_it():
    # K1 holds a diag class's whole stripe per thread in shared memory: 48
    # units of 4,300-7,750 frames in one tile of 128 need a ~3,500-slot
    # stripe, which no block holds, so the tiled scheduler halves the tile
    # until the widest class fits (tiles of 16: ~1,200 slots).  Every diag
    # job stays on the tiled route (K1), whatever its lengths.
    cfg = DTWConfig(band=16, band_mode="diag", max_seq_len=8192)
    lengths = np.linspace(4300, 7750, 48).astype(np.int32)
    assert tps.route_for(8192, cfg) == "diag"
    ti, perm, lens_p, pairs, by_class = tps._tile_classes("diag", lengths, 8192, cfg, 128, 16,
                                                          None)
    assert ti == 16 and len(lens_p) == 48 and len(pairs) == 3 * 4 // 2
    assert all(tps._k1_fits(16, c[1], 16, 16) for c in by_class)
    assert tps._tile_classes("diag", lengths, 8192, cfg, 32, 16, None)[0] == 16
    # Under known= only the tile-pairs with a new sequence count, but one new
    # sequence beside 47 old ones still meets all of them.
    assert tps._tile_classes("diag", lengths, 8192, cfg, 128, 16,
                             (47, np.zeros((47, 47), np.float32)))[0] == 16
    # A 768-frame job keeps the tile it was given.
    assert tps._tile_classes("diag", np.array([1, 768], np.int32), 768, cfg, 128, 16,
                             None)[0] == 128
    # Unbanded and widen: per pair only past 4096 frames.
    for c in (DTWConfig(band=None), DTWConfig(band=16, band_mode="widen")):
        assert tps.route_for(4096, c) != "per_pair"
        assert tps.route_for(4097, c) == "per_pair"


def test_long_block_columns_checks_its_range():
    # The stripe interface refuses block columns outside the grid and a
    # halo of the wrong shape before it launches anything.
    x = torch.zeros((2, 512, 16))
    n = torch.full((2,), 400, dtype=torch.int32)
    out = torch.empty(2)
    for J0, nJ in ((0, 3), (2, 1), (-1, 1), (0, 0)):
        with pytest.raises(ValueError, match="block columns"):
            tdl.long_block_columns(x, x, n, n, out, block=256, J0=J0, nJ=nJ)
    with pytest.raises(ValueError, match="halo"):
        tdl.long_block_columns(x, x, n, n, out, block=256, J0=1, nJ=1,
                               halo=torch.zeros((2, 2, 128)))


def _ref_pairs(feats, lengths, ia, ib, S, **kw):
    """dtw_long_batch_ref on the pairs gathered, cut or zero-padded to S
    frames."""
    x = torch.from_numpy(feats[:, :S])
    x = torch.nn.functional.pad(x, (0, 0, 0, S - x.shape[1]))
    n = torch.from_numpy(lengths)
    return tdl.dtw_long_batch_ref(x[ia], x[ib], n[ia], n[ib], **kw)


@pytest.mark.parametrize("kw", [dict(band=None), dict(band=16, band_mode="widen"),
                                dict(band=16, band_mode="diag", normalize="path_len")],
                         ids=["unbanded", "widen", "diag"])
def test_merged_pairs_twin_equals_batch_ref_pair_by_pair(kw):
    # Pairs of mixed buckets (1,100-1,400 frames, blocks of 256: grids of 5 x 5
    # to 6 x 6 blocks) in one merged call: each distance bitwise the batch
    # twin's on that pair alone, at the corpus's padded length.
    feats, lengths = _long_case(12, K=5, L=1400, lo=1100)
    ia = np.array([0, 1, 2, 3, 4, 0], np.int64)
    ib = np.array([1, 2, 3, 4, 0, 3], np.int64)
    got = tdl.dtw_long_pairs(torch.from_numpy(feats), torch.from_numpy(lengths), ia, ib,
                             block=256, **kw)
    for p in range(len(ia)):
        want = _ref_pairs(feats, lengths, ia[p : p + 1], ib[p : p + 1], 1536, block=256, **kw)
        assert torch.equal(got[p : p + 1], want), p


def test_merged_pairs_give_each_pair_its_own_grid():
    # A pair far below the call's largest (300 and 280 frames beside 1,300)
    # runs on its own 2 x 2 blocks, with the distance it has alone; empty
    # sides and sides past the corpus's L are +inf.
    rng = np.random.default_rng(13)
    feats = rng.normal(0, 1, (4, 1300, 3)).astype(np.float32)
    lengths = np.array([1300, 1250, 300, 280], np.int32)
    ia, ib = np.array([0, 2, 3, 1]), np.array([1, 3, 2, 0])
    x, n = torch.from_numpy(feats), torch.from_numpy(lengths)
    got = tdl.dtw_long_pairs(x, n, ia, ib, block=256)
    short = _ref_pairs(feats, lengths, ia[1:3], ib[1:3], 512, block=256)
    assert torch.equal(got[1:3], short)
    assert torch.equal(got[[0, 3]], _ref_pairs(feats, lengths, ia[[0, 3]], ib[[0, 3]], 1536,
                                               block=256))
    np.testing.assert_allclose(got[1].item(), dtw_oracle(feats[2, :300], feats[3, :280]),
                               rtol=1e-4)
    n_odd = torch.tensor([1300, 0, 300, 280], dtype=torch.int32)
    odd = tdl.dtw_long_pairs(x, n_odd, np.array([0, 1, 2]), np.array([1, 2, 3]), block=256)
    assert torch.isinf(odd[:2]).all() and torch.equal(odd[2:], got[1:2])
    assert torch.isinf(tdl.dtw_long_pairs(x, torch.tensor([1301, 9, 9, 9], dtype=torch.int32),
                                          np.array([0]), np.array([1]))).all()
    with pytest.raises(ValueError, match="outside the corpora"):
        tdl.dtw_long_pairs(x, n, np.array([4]), np.array([0]))


def _per_block_ref(feats, lengths, cfg):
    """The per-pair route's D as the blocks ran before the merged call: each
    enumerated K8 block padded to long_block_shape(bucket) and run through
    dtw_long_batch_ref."""
    K, L, _ = feats.shape
    D = np.zeros((K, K), np.float32)
    for _, bucket, _, ii, jj in tps.enumerate_pair_blocks(
            lengths, 512, min(32, L), L, band=cfg.band, auto_widen=cfg.auto_widen_band):
        blk, S = tdl.long_block_shape(bucket)
        D[ii, jj] = _ref_pairs(feats, lengths, ii, jj, S, block=blk, metric=cfg.metric,
                               band=cfg.band, auto_widen=cfg.auto_widen_band,
                               normalize=cfg.normalize, band_mode=cfg.band_mode).numpy()
    return D + D.T


@pytest.mark.parametrize("band,band_mode", [(None, "widen"), (24, "diag")])
def test_merged_route_matches_jax_and_per_block_twin(band, band_mode):
    # Six sequences of 1,100-1,400 frames, bucketed by 32 frames: K8's blocks
    # of several buckets run as one merged call, within 1e-4 of the JAX
    # package's per-pair route and bitwise the per-block twin calls.
    feats, lengths = _long_case(14, K=6, L=1400, lo=1100)
    kw = dict(max_seq_len=1400, band=band, band_mode=band_mode)
    stats = {}
    got = tps.all_pairs_distances(feats, lengths, DTWConfig(**kw), tiled=False, device="cpu",
                                  stats=stats)
    assert stats["blocks"] > 1 and stats["long_calls"] == 1 and stats["pad_pairs"] == 0
    want = jps.all_pairs_distances(feats, lengths, JCfg(use_pallas=False, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got, _per_block_ref(feats, lengths, DTWConfig(**kw)))


def test_merged_route_under_budget_retries_and_resume(monkeypatch, tmp_path):
    # A boundary budget below one call's pairs splits the job into several
    # merged calls; a merged call that fails once is run again from its
    # indices; a rerun with block_dir resumes every block: all give the full
    # D bitwise.
    feats, lengths = _long_case(15, K=5, L=1300, lo=1100)
    cfg = DTWConfig(band=None, max_seq_len=1300)
    stats = {}
    full = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu", stats=stats)
    assert stats["long_calls"] == 1
    monkeypatch.setattr(tps, "LONG_BOUNDARY_BUDGET", 1)
    stats = {}
    got = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu", stats=stats)
    assert stats["long_calls"] == stats["blocks"] > 1
    np.testing.assert_array_equal(got, full)
    monkeypatch.setattr(tps, "LONG_BOUNDARY_BUDGET", 1 << 30)
    real, failed = tps.dtw_long_pairs, []

    def flaky(*args, **kw):
        if not failed:
            failed.append(1)
            raise RuntimeError("transient launch failure")
        return real(*args, **kw)

    monkeypatch.setattr(tps, "dtw_long_pairs", flaky)
    np.testing.assert_array_equal(
        tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu"), full)
    assert failed
    failed.clear()
    with pytest.raises(RuntimeError, match="transient"):
        tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu", max_retries=0)
    monkeypatch.setattr(tps, "dtw_long_pairs", real)
    for n in range(2):
        stats = {}
        got = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu",
                                      block_dir=tmp_path, stats=stats)
        np.testing.assert_array_equal(got, full)
        assert stats["long_calls"] == 1 - n and stats["blocks_resumed"] == n * stats["blocks"]
    np.testing.assert_array_equal(tps.all_pairs_distances(
        feats, lengths, cfg, tiled=False, device="cpu", known=(2, full[:2, :2])), full)


@pytest.mark.parametrize("stripe", [None, (0, 4), (1, 2)], ids=["merged", "whole", "stripe"])
def test_k8_plan_lists_every_block_once(stripe):
    # K8's launch plan, decoded as the kernel decodes it (a CUDA block's
    # pair by binary search over launch k's prefix sums, its block column
    # the pair's first on the diagonal plus its rank): every block of every
    # pair's grid (its own in a merged call; the nB x nB grid's columns
    # [J0, J0 + nJ) in a stripe) once, on diagonal I + J; the boundaries'
    # offsets disjoint; empty and overlong sides no block.
    la = np.array([1300, 300, 0, 1024, 1025, 7], np.int64)
    lb = np.array([280, 1300, 50, 1024, 1100, 9], np.int64)
    ia, ib = np.arange(6), np.arange(6)[::-1].copy()
    BLK, S = 256, 1100 if stripe is None else 1024
    kw = {} if stripe is None else dict(nB=4, J0=stripe[0], nJ=stripe[1])
    plan = tdl._long_plan(ia, ib, la, lb, S + 200, S, BLK, **kw)
    meta, items = plan["meta"], plan["items"]
    if stripe is None:
        ok = (la > 0) & (lb > 0) & (la <= S + 200) & (lb <= S)
        nBa, nBb = np.where(ok, -(-la // BLK), 0), np.where(ok, -(-lb // BLK), 0)
        J0 = 0
    else:
        nBa, nBb, J0 = np.full(6, 4), np.full(6, stripe[0] + stripe[1]), stripe[0]
    want = {(p, i, j) for p in range(6) for i in range(nBa[p]) for j in range(J0, nBb[p])}
    got = []
    for k in range(plan["nK"]):
        assert items[k, -1] == plan["totals"][k]
        for item in range(items[k, -1]):
            p = int(np.searchsorted(items[k], item, side="right")) - 1
            J = max(J0, k - int(meta[p, 4]) + 1) + item - items[k, p]
            got.append((p, k - J, J))
    assert sorted(got) == sorted(want) and len(got) == len(want)
    assert plan["launches"] == int((plan["totals"] > 0).sum())
    assert plan["nK"] == max(int(nBa[p] + nBb[p] - 1) for p in range(6) if nBa[p])
    assert (meta[:, :4] == np.stack([ia, ib, la, lb], 1)).all()
    for col, size, per in ((5, plan["n_h"], BLK * (nBb - J0).clip(0)),
                           (6, plan["n_v"], BLK * (nBa if stripe is None else np.full(6, 4))),
                           (7, plan["n_c"], (nBb - J0).clip(0) + 1)):
        ends = meta[:, col] + per
        assert (meta[1:, col] == ends[:-1]).all() and ends[-1] == size

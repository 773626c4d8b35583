"""``dtw.dtype=bfloat16`` in the port against the JAX package's bf16 run on
the same seeded inputs: ``pairwise_cost``, ``dtw_batch``, the blocked twin
(``dtw_long_batch_ref``, ``dtw_long_pairs_ref``), the per-pair scheduler and
``discover()``.  K8's Gram instantiation itself runs only on the card
(``chip_smoke.py`` phase 31 holds it against the twin tested here).

The tolerance, derived per cell and per pair (``_cell_bounds``,
``_path_bound``).  Both sides round the same fp32 operands to bf16 to
nearest even (for cosine after normalizing them in fp32 by the same
formula, which ``_rounded_frames_agree`` checks on each input), so every
product a_c b_c of the Gram is exact in fp32: the two Gram entries differ
only in the order of their fp32 sums, each within (d-1) 2^-24 sum_c |a_c b_c|
of the exact sum, and the squared norms of the unrounded frames likewise.
So a cell's squared distance |a|^2 + |b|^2 - 2 a.b differs between the
sides by at most eps = 2 (d+2) 2^-24 (|a|^2 + |b|^2 + 2 sum_c |a_c b_c|)
(the last terms for the adds), the cosine cost 1 - a.b by
2 (d-1) 2^-24 sum_c |a_c b_c| + 2^-23.  The Euclidean cost's square root
amplifies eps where the squared distance nears 0: |sqrt(x) - sqrt(y)| <=
2 eps / sqrt(max(x, eps)) for x the exact value and y within eps of it.
This is not bf16's 2^-8 against fp32: both sides round alike.  A DTW
distance is the min over monotone paths of its cells' costs, so two runs
whose costs differ by at most e per cell differ by at most the largest sum
of e over a path through the valid cells (``_path_bound``, a max-plus DTW),
plus each side's fp32 rounding of the path's sum, 2 (la + lb) 2^-24 of the
distance (the reference's blocked scan reassociates its row additions).
Every 2^-24 above is the unit of one fp32 addition rounded to nearest
(``unit``); K8's Gram instantiation sums its dot products on the tensor
cores, whose fp32 accumulation NVIDIA does not document as rounded to
nearest, so a check of it carries the bound with one ulp, 2^-23, per
addition (``TC_UNIT``; ``tests/test_torch_gram_tc.py``, ``chip_smoke.py``
phase 31)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import DTWConfig as JCfg
from audio_pattern_discovery_tpu.ops import dtw as jdtw
from audio_pattern_discovery_tpu.ops import dtw_long as jdl
from audio_pattern_discovery_tpu.parallel import pair_scheduler as jps
from audio_pattern_discovery_tpu_torch.config import DTWConfig, PipelineConfig
from audio_pattern_discovery_tpu_torch.ops import dtw as tdtw
from audio_pattern_discovery_tpu_torch.ops import dtw_long as tdl
from audio_pattern_discovery_tpu_torch.ops.dtw_cuda import pallas_supported
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

torch.set_num_threads(1)

U = 2.0 ** -24
TC_UNIT = 2.0 ** -23       # an addition on the tensor cores: one ulp
METRICS = ["euclidean", "sqeuclidean", "cosine"]


def _unit(x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(np.array(x, np.float32))
    return (t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)).numpy()


def _rounded(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.array(x, np.float32)).to(torch.bfloat16).double().numpy()


def _rounded_frames_agree(x: np.ndarray) -> None:
    """Cosine's precondition: the port's and the reference's unit frames
    round to the same bf16 values on these inputs."""
    j = np.asarray(jnp.asarray(x) / jnp.maximum(jnp.linalg.norm(jnp.asarray(x), axis=-1,
                                                                keepdims=True), 1e-12))
    np.testing.assert_array_equal(_rounded(j), _rounded(_unit(x)))


def _cell_bounds(a: np.ndarray, b: np.ndarray, metric: str, unit: float = U) -> np.ndarray:
    """[N, M] bound on the two sides' difference in each cell's cost, for
    the frames a [N, d] and b [M, d] (the module docstring), with ``unit``
    the error of one fp32 addition."""
    d = a.shape[1]
    if metric == "cosine":
        a, b = _unit(a), _unit(b)
    ar, br = _rounded(a), _rounded(b)
    absdot = np.abs(ar) @ np.abs(br).T
    if metric == "cosine":
        return 2 * (d - 1) * unit * absdot + 2 * unit
    na = np.sum(a.astype(np.float64) ** 2, axis=1)[:, None]
    nb = np.sum(b.astype(np.float64) ** 2, axis=1)[None, :]
    eps = 2 * (d + 2) * unit * (na + nb + 2 * absdot)
    if metric == "sqeuclidean":
        return eps
    sq = np.maximum(na + nb - 2 * ar @ br.T, 0.0)
    return 2 * eps / np.sqrt(np.maximum(sq, eps)) + 2 * unit * np.sqrt(sq)


def _valid(la: int, lb: int, band, band_mode: str, auto_widen: bool = True) -> np.ndarray:
    """[la, lb] cells inside the band (the oracle's predicates)."""
    i = np.arange(la)[:, None]
    j = np.arange(lb)[None, :]
    if band is None:
        return np.ones((la, lb), bool)
    if band_mode == "diag":
        return np.abs(j * (la - 1) - i * (lb - 1)) <= max(band, 1) * max(la - 1, lb - 1)
    w = max(band, abs(la - lb)) if auto_widen else band
    return np.abs(i - j) <= w


def _path_bound(e: np.ndarray, valid: np.ndarray) -> float:
    """The largest sum of e over the monotone paths from (0, 0) to the last
    cell through valid cells: M[i, j] = e + max(M[i-1, j-1], M[i-1, j],
    M[i, j-1]), each row's valid run [lo, hi] resolved with a running max
    (M[i, j] = S_j + max_{k <= j} (U_k - S_{k-1}), S the run's prefix
    sums, U_k the better of the two cells above)."""
    N, Mc = e.shape
    prev = np.full(Mc + 1, -np.inf)          # prev[j + 1] = M[i-1, j]; prev[0] the origin's column
    prev[0] = 0.0                            # D[-1, -1] = 0
    for i in range(N):
        cols = np.nonzero(valid[i])[0]
        cur = np.full(Mc + 1, -np.inf)
        if len(cols):
            lo, hi = cols[0], cols[-1]
            up = np.maximum(prev[lo : hi + 1], prev[lo + 1 : hi + 2])   # diag, up
            s = np.cumsum(e[i, lo : hi + 1])
            s_prev = np.concatenate([[0.0], s[:-1]])
            cur[lo + 1 : hi + 2] = s + np.maximum.accumulate(up - s_prev)
        prev = cur
        prev[0] = -np.inf
    return float(prev[Mc])


def _assert_within(got, want, a, b, la, lb, *, metric="euclidean", band=None,
                   band_mode="widen", auto_widen=True, normalize="none", unit=U):
    """got and want (one distance a pair) within each pair's bound, with
    ``unit`` the error of one fp32 addition."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    for p in range(len(got)):
        if not np.isfinite(want[p]):
            continue
        n_a, n_b = int(la[p]), int(lb[p])
        e = _cell_bounds(a[p, :n_a], b[p, :n_b], metric, unit)
        tol = _path_bound(e, _valid(n_a, n_b, band, band_mode, auto_widen))
        if normalize == "path_len":
            tol /= n_a + n_b
        tol += 2 * (n_a + n_b) * unit * abs(want[p])
        assert abs(got[p] - want[p]) <= tol, (p, got[p], want[p], tol)


def _batch(seed, B, S, d, lo):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(lo, S + 1, B).astype(np.int32)
    lb = rng.integers(lo, S + 1, B).astype(np.int32)
    return a, b, la, lb


def test_path_bound_is_the_max_plus_dtw():
    # _path_bound against a cell-by-cell max-plus DP on a banded grid.
    rng = np.random.default_rng(0)
    e = rng.uniform(0, 1, (9, 13))
    valid = _valid(9, 13, 2, "diag")
    M = np.full((10, 14), -np.inf)
    M[0, 0] = 0.0
    for i in range(9):
        for j in range(13):
            if valid[i, j]:
                M[i + 1, j + 1] = e[i, j] + max(M[i, j], M[i, j + 1], M[i + 1, j])
    assert np.isclose(_path_bound(e, valid), M[9, 13])


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_cost_matches_jax(metric):
    rng = np.random.default_rng(1)
    a = rng.normal(0, 1, (3, 40, 16)).astype(np.float32)
    b = rng.normal(0, 1, (3, 50, 16)).astype(np.float32)
    if metric == "cosine":
        _rounded_frames_agree(a)
        _rounded_frames_agree(b)
    want = np.asarray(jdtw.pairwise_cost(jnp.asarray(a), jnp.asarray(b), metric, jnp.bfloat16))
    got = tdtw.pairwise_cost(torch.from_numpy(a), torch.from_numpy(b), metric,
                             "bfloat16").numpy()
    f32 = tdtw.pairwise_cost(torch.from_numpy(a), torch.from_numpy(b), metric).numpy()
    for k in range(3):
        assert (np.abs(got[k] - want[k]) <= _cell_bounds(a[k], b[k], metric)).all()
    # Far from the fp32 costs: the bf16 rounding shows.
    assert np.abs(got - f32).max() > 100 * np.abs(got - want).max()
    # The fp32 path is the Gram of the unrounded frames.
    np.testing.assert_array_equal(
        f32, tdtw.pairwise_cost(torch.from_numpy(a), torch.from_numpy(b), metric, None).numpy())


@pytest.mark.parametrize("band,band_mode", [(3, "diag"), (4, "widen"), (None, "widen")],
                         ids=["diag", "widen", "unbanded"])
def test_dtw_batch_matches_jax(band, band_mode):
    a, b, la, lb = _batch(2, 12, 40, 4, 8)
    kw = dict(metric="euclidean", band=band, band_mode=band_mode, normalize="path_len")
    want = np.asarray(jdtw.dtw_batch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                                     jnp.asarray(lb), matmul_dtype="bfloat16", **kw))
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(la), torch.from_numpy(lb))
    got = tdtw.dtw_batch(*args, matmul_dtype="bfloat16", **kw).numpy()
    _assert_within(got, want, a, b, la, lb, **kw)
    dist, _ = tdtw.dtw_batch_with_dirs(*args, matmul_dtype="bfloat16", **kw)
    np.testing.assert_array_equal(dist.numpy(), got)
    assert not np.array_equal(got, tdtw.dtw_batch(*args, **kw).numpy())


@pytest.mark.parametrize("band,band_mode,metric", [
    (None, "widen", "euclidean"), (16, "widen", "sqeuclidean"), (16, "diag", "euclidean"),
    (None, "widen", "cosine"),
], ids=["unbanded", "widen-sqeuclidean", "diag", "cosine"])
def test_long_batch_twin_matches_jax(band, band_mode, metric):
    # Lengths past one block (4 blocks of 128 frames).
    a, b, la, lb = _batch(3, 4, 512, 4, 300)
    if metric == "cosine":
        _rounded_frames_agree(a)
        _rounded_frames_agree(b)
    kw = dict(metric=metric, band=band, band_mode=band_mode)
    want = np.asarray(jdl.dtw_long_batch(jnp.asarray(a), jnp.asarray(b), jnp.asarray(la),
                                         jnp.asarray(lb), block=128, matmul_dtype="bfloat16",
                                         **kw))
    args = (torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(la), torch.from_numpy(lb))
    got = tdl.dtw_long_batch_ref(*args, block=128, matmul_dtype="bfloat16", **kw).numpy()
    _assert_within(got, want, a, b, la, lb, **kw)
    np.testing.assert_array_equal(
        tdl.dtw_long_batch(*args, block=128, matmul_dtype="bfloat16", **kw).numpy(), got)


def test_long_pairs_twin_matches_jax():
    # The merged call's twin by index into one corpus, against the
    # reference's blocked DTW on the gathered, padded pairs.
    rng = np.random.default_rng(4)
    K, L, d = 6, 600, 4
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    lens = rng.integers(280, L + 1, K).astype(np.int32)
    ia, ib = np.array([0, 1, 2, 3, 5]), np.array([4, 5, 0, 1, 2])
    got = tdl.dtw_long_pairs(torch.from_numpy(feats), torch.from_numpy(lens), ia, ib, block=128,
                             band=16, matmul_dtype="bfloat16").numpy()
    pad = np.zeros((K, 640, d), np.float32)
    pad[:, :L] = feats
    want = np.asarray(jdl.dtw_long_batch(
        jnp.asarray(pad[ia]), jnp.asarray(pad[ib]), jnp.asarray(lens[ia]), jnp.asarray(lens[ib]),
        band=16, block=128, matmul_dtype="bfloat16"))
    _assert_within(got, want, pad[ia], pad[ib], lens[ia], lens[ib], band=16)


def test_block_kernel_matches_jax():
    # One block of the reference's dtw_block_kernel, at an offset that holds
    # the terminal cell, from random boundaries.
    rng = np.random.default_rng(5)
    BLK, d = 16, 4
    a = rng.normal(0, 1, (BLK, d)).astype(np.float32)
    b = rng.normal(0, 1, (BLK, d)).astype(np.float32)
    top = rng.uniform(0, 30, BLK).astype(np.float32)
    left = rng.uniform(0, 30, BLK).astype(np.float32)
    want = [np.asarray(x) for x in jdl.dtw_block_kernel(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(top), jnp.asarray(left), jnp.float32(7.0),
        jnp.int32(16), jnp.int32(32), jnp.int32(25), jnp.int32(40), metric="euclidean",
        band=None, band_width=None, matmul_dtype=jnp.bfloat16)]
    got = [t.numpy()[0] for t in tdl.dtw_block_kernel(
        torch.from_numpy(a[None]), torch.from_numpy(b[None]), torch.from_numpy(top[None]),
        torch.from_numpy(left[None]), torch.tensor([7.0]), 16, 32, 25, 40,
        matmul_dtype="bfloat16")]
    # Each boundary value is a path sum over at most 2 BLK cells.
    tol = 2 * BLK * _cell_bounds(a, b, "euclidean").max() + 4 * BLK * U * 100
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
    assert bool(got[3]) == bool(want[3]) is True


def test_gram_layout_rounds_frames_and_keeps_unrounded_norms():
    rng = np.random.default_rng(6)
    feats = torch.from_numpy(rng.normal(0, 1, (3, 20, 5)).astype(np.float32))
    for metric in ("euclidean", "cosine"):
        layout, norms = tdl.gram_layout(feats, metric)
        x = feats if metric == "euclidean" else torch.from_numpy(_unit(feats.numpy()))
        assert layout.shape == (3, 20, 16) and layout.dtype == torch.bfloat16
        torch.testing.assert_close(layout[..., :5].float(), x.to(torch.bfloat16).float(), rtol=0,
                                   atol=0)
        assert bool((layout[..., 5:] == 0).all())
        torch.testing.assert_close(norms, torch.sum(x * x, dim=-1), rtol=0, atol=0)
    with pytest.raises(ValueError, match="norms"):
        tdl._check_gram_layout((layout, norms[:, :4]), feats, "cosine")


def _mixed_corpus(seed):
    """Two sequences past K6's 1024 frames and three short ones: long x
    anything pairs fall in a bucket of 1120 (K8's twin, or K7's for widen
    pairs within its stripe), short x short in K6's bucket of 64."""
    rng = np.random.default_rng(seed)
    lens = np.array([1100, 1090, 60, 50, 40], np.int32)
    feats = rng.normal(0, 1, (5, 1100, 2)).astype(np.float32)
    for k, n in enumerate(lens):
        feats[k, n:] = 0.0
    return feats, lens


@pytest.mark.parametrize("band,band_mode", [(4, "diag"), (4, "widen"), (None, "widen")],
                         ids=["diag", "widen", "unbanded"])
def test_per_pair_route_matches_jax(band, band_mode):
    # Buckets K6 and K7 take stay fp32 (bitwise the fp32 run), as on the
    # reference's Pallas path; the others (K8's twin, the plain dtw_batch
    # for diag) take the bf16 Gram and match the JAX package's bf16 run.
    # The JAX package's per-pair route on the CPU runs every bucket up to
    # 1024 frames through its plain dtw_batch (bf16 there too), so K6's
    # bucket is held to the fp32 run only.
    feats, lens = _mixed_corpus(7)
    cfg = DTWConfig(band=band, band_mode=band_mode, normalize="path_len", max_seq_len=1100,
                    dtype="bfloat16")
    stats = {}
    got = tps.all_pairs_distances(feats, lens, cfg, device="cpu", stats=stats)
    assert stats["route"] == "per_pair"
    f32 = tps.all_pairs_distances(feats, lens, DTWConfig(**{**vars(cfg), "dtype": "float32"}),
                                  tiled=False, device="cpu")
    want = jps.all_pairs_distances(feats, lens, JCfg(band=band, band_mode=band_mode,
                                                     normalize="path_len", max_seq_len=1100,
                                                     dtype="bfloat16"))
    ii, jj = np.triu_indices(5, 1)
    fp32 = np.array([band_mode != "diag" and pallas_supported(
        32 * -(-int(max(lens[i], lens[j])) // 32), band, True, abs(int(lens[i] - lens[j])))
        for i, j in zip(ii, jj)])
    assert fp32.any() != (band_mode == "diag") and not fp32.all()
    np.testing.assert_array_equal(got[ii[fp32], jj[fp32]], f32[ii[fp32], jj[fp32]])
    b16 = ~fp32
    assert (got[ii[b16], jj[b16]] != f32[ii[b16], jj[b16]]).all()
    _assert_within(got[ii[b16], jj[b16]], want[ii[b16], jj[b16]], feats[ii[b16]],
                   feats[jj[b16]], lens[ii[b16]], lens[jj[b16]], band=band,
                   band_mode=band_mode, normalize="path_len")
    np.testing.assert_array_equal(got, got.T)


def test_bf16_job_runs_per_pair_and_forced_tiled_runs_fp32():
    # The reference's tiled gate: a bfloat16 job leaves the tiled route; a
    # job forced onto it runs there in fp32 (the tile kernels take no matmul
    # dtype), bitwise the fp32 job's D.
    rng = np.random.default_rng(8)
    feats = rng.normal(0, 1, (12, 32, 4)).astype(np.float32)
    lens = rng.integers(8, 33, 12).astype(np.int32)
    f32, b16 = DTWConfig(band=4), DTWConfig(band=4, dtype="bfloat16")
    assert tps.route_for(32, b16) == tps.route_for(32, f32) == "diag"
    st_f, st_b = {}, {}
    D_f = tps.all_pairs_distances(feats, lens, f32, device="cpu", stats=st_f)
    D_b = tps.all_pairs_distances(feats, lens, b16, device="cpu", stats=st_b)
    assert st_f["route"] == "diag" and st_b["route"] == "per_pair"
    assert not np.array_equal(D_f, D_b)
    np.testing.assert_array_equal(tps.all_pairs_distances(feats, lens, b16, device="cpu",
                                                          tiled=True), D_f)


def test_fp32_blocks_are_not_reused_under_bf16(tmp_path):
    # _cfg_tag hashes dtw.dtype: a bf16 run over an fp32 run's block_dir
    # computes every block again, and its own rerun resumes them all.
    feats, lens = _mixed_corpus(9)
    kw = dict(band=4, band_mode="diag", max_seq_len=1100)
    blocks = tmp_path / "blocks"
    st = {}
    tps.all_pairs_distances(feats, lens, DTWConfig(**kw), tiled=False, device="cpu",
                            block_dir=blocks, stats=st)
    n_f32 = len(list(blocks.glob("*.npz")))
    assert n_f32 == st["blocks"] > 0
    want = tps.all_pairs_distances(feats, lens, DTWConfig(**kw, dtype="bfloat16"), device="cpu")
    for resumed in (0, st["blocks"]):
        st_b = {}
        got = tps.all_pairs_distances(feats, lens, DTWConfig(**kw, dtype="bfloat16"),
                                      device="cpu", block_dir=blocks, stats=st_b)
        assert st_b["blocks_resumed"] == resumed
        np.testing.assert_array_equal(got, want)
    assert len(list(blocks.glob("*.npz"))) == 2 * n_f32


@pytest.fixture(scope="module")
def seed7(tmp_path_factory):
    d = tmp_path_factory.mktemp("seed7") / "corpus"
    make_corpus(d, n_clips=12, n_motifs=3, seed=7)
    return d


def _golden_overrides():
    return {"dtw.band": 16, "dtw.dtype": "bfloat16", "spectrogram.feature": "mfcc",
            "spectrogram.n_mels": 48, "spectrogram.n_mfcc": 16, "autoencoder.method": "pca",
            "autoencoder.latent_dim": 8, "output.write_snippets": False,
            "output.write_images": False, "output.write_html_report": False}


def test_discover_matches_jax_pipeline(seed7):
    # The seed-7 golden config with dtw.dtype=bfloat16 (diag band 16: every
    # bucket on the plain dtw_batch, bf16 on both sides): D within each
    # pair's bound on the JAX run's features, the partition exact.
    from audio_pattern_discovery_tpu.config import PipelineConfig as JPipelineConfig
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover

    from audio_pattern_discovery_tpu_torch.pipeline import discover

    got = discover(seed7, PipelineConfig().override(_golden_overrides()), device="cpu")
    want = jdiscover(seed7, JPipelineConfig().override(_golden_overrides()))
    assert got.counters.counts["dtw_tile_programs"] == 0
    n, f = want.seg_lengths, want.seg_features
    np.testing.assert_array_equal(got.seg_lengths, n)
    # The features themselves differ by the front ends' fp32 rounding
    # (1e-3, tests/test_torch_pipeline.py): the port's D is held to the
    # reference's distances recomputed in the port from the same features.
    ii, jj = np.triu_indices(len(n), 1)
    kw = dict(band=16, band_mode="diag", normalize="path_len")
    port_on_ref = tdtw.dtw_batch(torch.from_numpy(f[ii]), torch.from_numpy(f[jj]),
                                 torch.from_numpy(n[ii]), torch.from_numpy(n[jj]),
                                 matmul_dtype="bfloat16", **kw).numpy()
    _assert_within(port_on_ref, want.distance_matrix[ii, jj], f[ii], f[jj], n[ii], n[jj], **kw)
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix, rtol=1e-3, atol=1e-3)
    labels = [{tuple(np.nonzero(lab == c)[0]) for c in set(lab.tolist())}
              for lab in (np.asarray(got.labels), np.asarray(want.labels))]
    assert labels[0] == labels[1]

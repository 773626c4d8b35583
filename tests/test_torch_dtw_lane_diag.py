"""K1, the diag-corridor lane kernel, on the CPU: its plain twin
``dtw_tile_lane_diag_pairs_ref`` (what the wrapper runs for CPU tensors)
against the JAX kernel ``dtw_tile_lane_diag_pairs(..., interpret=True)``,
and the ported class-bound helpers against their JAX originals.  A pair
whose A sequence has length 1 is held against the NumPy oracle instead:
the JAX kernel reads a truncated corner there, which the port does not.

The CUDA kernel itself cannot run here (no nvcc, no card): it is held
against the same twin on the card by ``chip_smoke.py`` phase 2."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)


def _corpus(rng, K, S, d, len_lo, len_hi):
    lens = np.sort(rng.integers(len_lo, len_hi + 1, K)).astype(np.int32)
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    for k in range(K):
        feats[k, lens[k]:] = 0.0
    return feats, lens


def _both(feats, lens, rep, I, J, **kw):
    """(torch wrapper on CPU tensors, JAX kernel in interpret mode)."""
    got = tk.dtw_tile_lane_diag_pairs(
        torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(rep),
        torch.tensor(I, dtype=torch.int32), torch.tensor(J, dtype=torch.int32),
        ti=kw["ti"], band=kw["band"], wv_max=kw["wv_max"],
        metric=kw.get("metric", "euclidean"), rows=kw.get("rows"),
    ).numpy()
    want = np.asarray(jp.dtw_tile_lane_diag_pairs(
        jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(rep),
        jnp.asarray(I, np.int32), jnp.asarray(J, np.int32), interpret=True,
        kmax=kw.get("kmax", 1), **{k: v for k, v in kw.items() if k != "kmax"},
    ))
    return got, want


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_plain_k1_matches_jax_kernel(metric):
    # The case of tests/test_dtw_diag.py::test_lane_diag_kernel_vs_scan_path,
    # every tile-pair in both orientations; self-pairs skipped as there (the
    # JAX build's Gram residue at a true 0 is not a production surface).
    rng = np.random.default_rng(9)
    K, S, d, ti, band = 24, 32, 4, 8, 3
    feats, lens = _corpus(rng, K, S, d, 6, 32)
    nT = K // ti
    rep = jp.tile_rep_lengths(lens, nT, ti, K)
    tmin = [int(lens[t * ti:(t + 1) * ti].min()) for t in range(nT)]
    tmax = [int(lens[t * ti:(t + 1) * ti].max()) for t in range(nT)]
    for I in range(nT):
        for J in range(nT):
            wv, kmax = jp.diag_class_bounds(band, tmin[I], tmax[I], tmin[J], tmax[J])
            got, want = _both(feats, lens, rep, [I], [J], ti=ti, band=band,
                              wv_max=wv, kmax=kmax, rows=tmax[I], metric=metric)
            mask = ~np.eye(ti, dtype=bool) if I == J else np.ones((ti, ti), bool)
            np.testing.assert_allclose(got[0][mask], want[0][mask], rtol=1e-4, atol=1e-3)


def test_plain_k1_matches_oracle_batched_tile_pairs():
    # Several tile-pairs in one call, long side on rows as the scheduler
    # orients them, against the float64 oracle (self-pairs included: the
    # difference-based cost is exact at 0).
    rng = np.random.default_rng(31)
    K, S, d, ti, band = 16, 40, 3, 4, 4
    feats, lens = _corpus(rng, K, S, d, 10, 40)
    nT = K // ti
    rep = tk.tile_rep_lengths(lens, nT, ti, K)
    pairs = [(j, i) for i in range(nT) for j in range(i, nT)]
    tmin = [int(lens[t * ti:(t + 1) * ti].min()) for t in range(nT)]
    tmax = [int(lens[t * ti:(t + 1) * ti].max()) for t in range(nT)]
    wv = max(tk.diag_class_bounds(band, tmin[a], tmax[a], tmin[b], tmax[b])[0]
             for a, b in pairs)
    out = tk.dtw_tile_lane_diag_pairs(
        torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(rep),
        torch.tensor([p[0] for p in pairs], dtype=torch.int32),
        torch.tensor([p[1] for p in pairs], dtype=torch.int32),
        ti=ti, band=band, wv_max=wv, rows=S,
    ).numpy()
    for u, (A, B) in enumerate(pairs):
        for r in range(ti):
            for c in range(ti):
                ia, ib = A * ti + r, B * ti + c
                ref = dtw_oracle(feats[ia, : lens[ia]], feats[ib, : lens[ib]],
                                 band=band, band_mode="diag")
                assert np.isclose(out[u, r, c], ref, rtol=1e-4, atol=1e-4), (A, B, r, c)


def test_out_of_frame_is_inf():
    # tests/test_dtw_diag.py::test_lane_diag_out_of_frame_is_inf: a wv bound
    # below the pair's requirement comes back +inf, never truncated.
    rng = np.random.default_rng(11)
    K, S, d, ti = 8, 32, 3, 4
    lens = np.array([8, 8, 8, 8, 30, 30, 31, 32], np.int32)
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    rep = np.array([8, 8], np.int32)  # tile 1's rep deliberately wrong (31)
    got, want = _both(feats, lens, rep, [0], [1], ti=ti, band=2, wv_max=4, rows=8)
    assert np.isinf(got).all() and np.isinf(want).all()


def test_rows_below_length_is_inf():
    # rows < la: the corner row is never reached, so +inf (class contract).
    rng = np.random.default_rng(12)
    feats, lens = _corpus(rng, 8, 20, 2, 12, 20)
    rep = tk.tile_rep_lengths(lens, 2, 4, 8)
    got, want = _both(feats, lens, rep, [1], [0], ti=4, band=3, wv_max=12, rows=10)
    assert np.isinf(got).all() and np.isinf(want).all()


def test_length_one_rows_equal_oracle():
    # An A sequence of length 1 has the whole of row 0 in its corridor
    # (oracle/dtw.py: den = 0); the twin gives the oracle's distance, where
    # the reference's frame reads a truncated corner.  The other rows are
    # the JAX kernel's.
    rng = np.random.default_rng(15)
    K, S, d, ti, band = 8, 32, 4, 4, 2
    lens = np.array([1, 1, 5, 9, 20, 25, 30, 32], np.int32)
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    rep = tk.tile_rep_lengths(lens, 2, ti, K)
    wv = max(tk.diag_class_bounds(band, 1, 32, lo, hi)[0] for lo, hi in ((1, 9), (20, 32)))
    truncated = 0
    for I, J in ((0, 0), (0, 1), (1, 0)):
        got, want = _both(feats, lens, rep, [I], [J], ti=ti, band=band, wv_max=wv, rows=S)
        for r in range(ti):
            for c in range(ti):
                ia, ib = I * ti + r, J * ti + c
                if lens[ia] == 1:
                    ref = dtw_oracle(feats[ia, :1], feats[ib, : lens[ib]], band=band,
                                     band_mode="diag")
                    np.testing.assert_allclose(got[0, r, c], ref, rtol=1e-5, err_msg=(I, J, r, c))
                    truncated += not np.isclose(want[0, r, c], ref, rtol=1e-5)
                elif ia != ib:
                    np.testing.assert_allclose(got[0, r, c], want[0, r, c], rtol=1e-4, atol=1e-3)
    assert truncated >= 4          # the reference's corner, which the port does not keep


def test_length_one_job_does_not_depend_on_the_tile_size(monkeypatch):
    # The job that showed the reference's corner fault: D of every pair with
    # a length-1 side equals the oracle at ti = 4, 8 and 16, and every other
    # pair is bitwise what the job gives without the length-1 branch.
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import (
        all_pairs_distances_tiled,
    )

    rng = np.random.default_rng(16)
    lens = np.array([1, 5, 6, 7, 20, 21, 22, 23], np.int32)
    feats = rng.normal(0, 1, (8, 32, 4)).astype(np.float32)
    for k in range(8):
        feats[k, lens[k]:] = 0.0
    cfg = DTWConfig(band=2, band_mode="diag", normalize="none")
    one = (lens[:, None] == 1) | (lens[None, :] == 1)
    np.fill_diagonal(one, False)
    oracle = np.array([[dtw_oracle(feats[a, : lens[a]], feats[b, : lens[b]], band=2,
                                   band_mode="diag") for b in range(8)] for a in range(8)])
    for ti in (4, 8, 16):
        D = all_pairs_distances_tiled(feats, lens, cfg, ti=ti, device="cpu")
        np.testing.assert_allclose(D[one], oracle[one], rtol=1e-5)
        with monkeypatch.context() as m:
            m.setattr(tk, "_single_row", lambda x, lens, a_ids, b_ids, metric:
                      torch.full(b_ids.shape, float("nan")))
            unfixed = all_pairs_distances_tiled(feats, lens, cfg, ti=ti, device="cpu")
        np.testing.assert_array_equal(D[~one], unfixed[~one])


def test_class_bounds_and_tile_rep_equal_jax():
    rng = np.random.default_rng(13)
    for _ in range(300):
        band = int(rng.integers(0, 20))
        lo_i, lo_j = rng.integers(1, 200, 2)
        hi_i = lo_i + int(rng.integers(0, 60))
        hi_j = lo_j + int(rng.integers(0, 60))
        args = (band, int(lo_i), int(hi_i), int(lo_j), int(hi_j))
        assert tk.diag_class_bounds(*args) == jp.diag_class_bounds(*args)
    for _ in range(20):
        ti = int(rng.integers(1, 9))
        n_real = int(rng.integers(1, 40))
        nT = -(-n_real // ti)
        lens = np.ones(nT * ti, np.int32)
        lens[:n_real] = np.sort(rng.integers(1, 300, n_real))
        np.testing.assert_array_equal(
            tk.tile_rep_lengths(lens, nT, ti, n_real),
            jp.tile_rep_lengths(lens, nT, ti, n_real),
        )


def test_wrapper_checks_arguments():
    f = torch.zeros((8, 6, 2))
    n = torch.ones(8, dtype=torch.int32)
    rep = torch.ones(2, dtype=torch.int32)
    u = torch.zeros(1, dtype=torch.int32)
    kw = dict(ti=4, band=2, wv_max=2)
    with pytest.raises(ValueError, match="multiple of ti"):
        tk.dtw_tile_lane_diag_pairs(f, n, rep, u, u, ti=3, band=2, wv_max=2)
    with pytest.raises(ValueError, match="float32"):
        tk.dtw_tile_lane_diag_pairs(f.double(), n, rep, u, u, **kw)
    with pytest.raises(ValueError, match="int32"):
        tk.dtw_tile_lane_diag_pairs(f, n.long(), rep, u, u, **kw)
    with pytest.raises(ValueError, match="tile_rep"):
        tk.dtw_tile_lane_diag_pairs(f, n, rep[:1], u, u, **kw)
    with pytest.raises(ValueError, match="metric"):
        tk.dtw_tile_lane_diag_pairs(f, n, rep, u, u, metric="nope", **kw)
    with pytest.raises(ValueError, match="device"):
        tk.dtw_tile_lane_diag_pairs(f.to("meta"), n.to("meta"), rep.to("meta"),
                                    u.to("meta"), u.to("meta"), **kw)


def test_cpu_tensors_never_launch_the_kernel():
    rng = np.random.default_rng(14)
    feats, lens = _corpus(rng, 8, 12, 2, 4, 12)
    rep = tk.tile_rep_lengths(lens, 2, 4, 8)
    before = tk.dtw_tile_lane_diag_pairs.launches
    args = (torch.from_numpy(feats), torch.from_numpy(lens), torch.from_numpy(rep),
            torch.tensor([1], dtype=torch.int32), torch.tensor([0], dtype=torch.int32))
    out = tk.dtw_tile_lane_diag_pairs(*args, ti=4, band=2, wv_max=16)
    ref = tk.dtw_tile_lane_diag_pairs_ref(*args, ti=4, band=2, wv_max=16)
    assert tk.dtw_tile_lane_diag_pairs.launches == before
    np.testing.assert_array_equal(out.numpy(), ref.numpy())

"""Plain-torch DTW (audio_pattern_discovery_tpu_torch/ops/dtw.py) against
the NumPy oracle and the JAX reference ``dtw_batch`` on the same inputs.

Tolerances: rtol/atol 1e-4 against JAX (both fp32 Gram costs, summed in a
different order); 1e-3 against the float64 oracle, as tests/test_dtw.py."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw as jdtw
from audio_pattern_discovery_tpu.ops.backtrace import paths_from_dirs
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle, dtw_path_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw as tdtw

torch.set_num_threads(1)

BAND_CASES = [(None, "widen"), (5, "widen"), (5, "diag"), (1, "diag")]


def _batch(rng, B=10, N=24, M=31, d=5, lo=1):
    a = rng.normal(0, 1, (B, N, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, M, d)).astype(np.float32)
    la = rng.integers(lo, N + 1, B).astype(np.int32)
    lb = rng.integers(lo, M + 1, B).astype(np.int32)
    return a, b, la, lb


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
@pytest.mark.parametrize("band,band_mode", BAND_CASES)
def test_dtw_batch_matches_jax_and_oracle(metric, band, band_mode):
    rng = np.random.default_rng(21)
    a, b, la, lb = _batch(rng)
    kw = dict(metric=metric, band=band, band_mode=band_mode)
    got = tdtw.dtw_batch(*_t(a, b, la, lb), **kw).numpy()
    want = np.asarray(jdtw.dtw_batch(a, b, la, lb, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for k in range(len(la)):
        ref = dtw_oracle(a[k, : la[k]], b[k, : lb[k]], **kw)
        np.testing.assert_allclose(got[k], ref, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("band,band_mode", BAND_CASES)
def test_normalize_path_len_and_auto_widen(band, band_mode):
    rng = np.random.default_rng(22)
    a, b, la, lb = _batch(rng, B=6)
    for auto_widen in (True, False):
        kw = dict(band=band, band_mode=band_mode, normalize="path_len",
                  auto_widen=auto_widen)
        got = tdtw.dtw_batch(*_t(a, b, la, lb), **kw).numpy()
        want = np.asarray(jdtw.dtw_batch(a, b, la, lb, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("band,band_mode", BAND_CASES)
def test_paths_identical_to_jax(band, band_mode):
    rng = np.random.default_rng(23)
    a, b, la, lb = _batch(rng, B=8, lo=2)
    kw = dict(band=band, band_mode=band_mode)
    d_t, dirs_t = tdtw.dtw_batch_with_dirs(*_t(a, b, la, lb), **kw)
    d_j, dirs_j = jdtw.dtw_batch_with_dirs(a, b, la, lb, **kw)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=1e-4, atol=1e-4)
    assert dirs_t.dtype == torch.uint8
    p_t = paths_from_dirs(dirs_t.numpy(), la, lb)
    p_j = paths_from_dirs(np.asarray(dirs_j), la, lb)
    assert p_t == p_j
    for k in range(len(la)):
        dist, path = dtw_path_oracle(a[k, : la[k]], b[k, : lb[k]], **kw)
        assert p_t[k] == path
        np.testing.assert_allclose(d_t[k].item(), dist, rtol=1e-3, atol=1e-3)


def test_dtw_pair_and_pairwise_cost():
    rng = np.random.default_rng(24)
    x = rng.normal(0, 1, (13, 4)).astype(np.float32)
    y = rng.normal(0, 1, (9, 4)).astype(np.float32)
    got = tdtw.dtw_pair(torch.from_numpy(x), torch.from_numpy(y), band=3,
                        band_mode="diag").item()
    assert np.isclose(got, dtw_oracle(x, y, band=3, band_mode="diag"), rtol=1e-4)
    for metric in ("euclidean", "sqeuclidean", "cosine"):
        c_t = tdtw.pairwise_cost(torch.from_numpy(x[None]), torch.from_numpy(y[None]), metric)
        c_j = jdtw.pairwise_cost(x[None], y[None], metric)
        np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-4, atol=1e-4)


def test_rejects_unknown_modes():
    a = torch.zeros((1, 4, 2))
    n = torch.tensor([4])
    with pytest.raises(ValueError, match="band_mode"):
        tdtw.dtw_batch(a, a, n, n, band=2, band_mode="nope")
    with pytest.raises(ValueError, match="normalize"):
        tdtw.dtw_batch(a, a, n, n, normalize="nope")
    with pytest.raises(ValueError, match="metric"):
        tdtw.dtw_batch(a, a, n, n, metric="nope")

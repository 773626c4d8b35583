"""K3, the full-width lane kernel, on the CPU: its plain twin
``dtw_tile_lane_full_pairs_ref`` (what the wrapper runs for CPU tensors)
against the JAX kernel ``dtw_tile_lane_full_pairs(..., interpret=True)``
and the NumPy oracle, on the cases of tests/test_dtw_lane_full.py.

Tolerances are those of tests/test_dtw_lane_full.py (rtol 1e-4 / atol 1e-3
against the float64 oracle), and rtol 1e-4 / atol 1e-3 against the JAX
kernel, whose Gram-built costs leave a residue near 0 (self-pairs skipped
there as here).  The CUDA kernel is held against the same twin on the card
by ``chip_smoke.py`` phase 7."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)

TI = 4


def _mk(K, S=64, d=3, seed=0, lo=5):
    rng = np.random.default_rng(seed)
    lens = np.sort(rng.integers(lo, S + 1, K)).astype(np.int32)
    feats = rng.normal(0, 1, (K, S, d)).astype(np.float32)
    return feats, lens


def _both(feats, lens, ii, jj, **kw):
    """(torch wrapper on CPU tensors, JAX kernel in interpret mode)."""
    got = tk.dtw_tile_lane_full_pairs(
        torch.from_numpy(feats), torch.from_numpy(lens),
        torch.tensor(ii, dtype=torch.int32), torch.tensor(jj, dtype=torch.int32),
        ti=TI, **kw,
    ).numpy()
    want = np.asarray(jp.dtw_tile_lane_full_pairs(
        jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(ii, jnp.int32),
        jnp.asarray(jj, jnp.int32), ti=TI, interpret=True, **kw,
    ))
    return got, want


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
def test_plain_k3_matches_jax_and_oracle(metric):
    feats, lens = _mk(8, seed=11)
    W = 8 * -(-int(lens.max()) // 8)
    got, want = _both(feats, lens, [0, 0, 1], [0, 1, 1], width=W, metric=metric,
                      rows=int(lens.max()))
    for u, (I, J) in enumerate([(0, 0), (0, 1), (1, 1)]):
        for p in range(TI):
            for q in range(TI):
                ia, ib = I * TI + p, J * TI + q
                if ia == ib:
                    if metric != "cosine":
                        assert got[u, p, q] == 0.0
                    continue
                ref = dtw_oracle(feats[ia, : lens[ia]], feats[ib, : lens[ib]],
                                 metric=metric, band=None)
                np.testing.assert_allclose(got[u, p, q], ref, rtol=1e-4, atol=1e-3)
                np.testing.assert_allclose(got[u, p, q], want[u, p, q], rtol=1e-4, atol=1e-3)


def test_plain_k3_length1_and_pad_entries():
    feats, lens = _mk(8, seed=5)
    lens[0] = 1
    W = 8 * -(-int(lens.max()) // 8)
    got, want = _both(feats, lens, [0], [1], width=W, rows=int(lens.max()))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    for p in range(TI):
        for q in range(TI):
            ref = dtw_oracle(feats[p, : lens[p]], feats[TI + q, : lens[TI + q]], band=None)
            np.testing.assert_allclose(got[0, p, q], ref, rtol=1e-4, atol=1e-3)


def test_width_shortfall_is_inf():
    # A class width below a real pair's lb comes back +inf, never truncated.
    feats, lens = _mk(8, seed=7, lo=40)
    W = max(8 * (int(lens.max()) // 8), 8)       # quantized DOWN
    got, want = _both(feats, lens, [0], [1], width=W, rows=int(lens.max()))
    too_long = lens[TI:] > W
    assert too_long.any()
    assert np.isinf(got[0][:, too_long]).all() and np.isinf(want[0][:, too_long]).all()
    np.testing.assert_allclose(got[0][:, ~too_long], want[0][:, ~too_long], rtol=1e-4, atol=1e-3)


def test_rows_shortfall_is_inf():
    feats, lens = _mk(8, seed=9, lo=40)
    W = 8 * -(-int(lens.max()) // 8)
    rows_short = int(lens[:TI].max()) - 1
    got, want = _both(feats, lens, [0], [1], width=W, rows=rows_short)
    cut = lens[:TI] > rows_short
    assert cut.any()
    assert np.isinf(got[0][cut]).all() and np.isinf(want[0][cut]).all()
    np.testing.assert_allclose(got[0][~cut], want[0][~cut], rtol=1e-4, atol=1e-3)


def test_swap_symmetry():
    # DTW(a, b) == DTW(b, a): blocks of (I, J) and (J, I) are transposes.
    feats, lens = _mk(8, seed=13)
    W = 8 * -(-int(lens.max()) // 8)
    got, _ = _both(feats, lens, [0, 1], [1, 0], width=W, rows=int(lens.max()))
    np.testing.assert_allclose(got[0], got[1].T, rtol=1e-5, atol=1e-3)


def test_width_is_checked_and_cpu_never_launches():
    feats, lens = _mk(8, S=16, seed=15)
    args = (torch.from_numpy(feats), torch.from_numpy(lens),
            torch.tensor([0], dtype=torch.int32), torch.tensor([1], dtype=torch.int32))
    with pytest.raises(ValueError, match="width"):
        tk.dtw_tile_lane_full_pairs(*args, ti=TI, width=17)
    assert tk.lane_full_width(9, 16) == 16
    before = tk.dtw_tile_lane_full_pairs.launches
    a = tk.dtw_tile_lane_full_pairs(*args, ti=TI, width=16)
    b = tk.dtw_tile_lane_full_pairs_ref(*args, ti=TI, width=16)
    assert tk.dtw_tile_lane_full_pairs.launches == before
    np.testing.assert_array_equal(a.numpy(), b.numpy())

"""K2, the square-tile kernel, on the CPU: its plain twin
``dtw_tile_pairs_ref`` (what the wrapper runs for CPU tensors) against the
JAX kernel ``dtw_tile_pairs(..., interpret=True)`` on the cases of
tests/test_dtw_tile.py, and the +inf ``rows`` contract.

Tolerance rtol 1e-4 / atol 1e-4, as there: the JAX kernel builds costs from
a Gram expansion, the twin from squared differences.  Self-pairs are
skipped against JAX (the Gram leaves ~5e-3 at a true 0) and checked to be
exactly 0 in the twin.  The CUDA kernel itself cannot run here (no nvcc, no
card): it is held against the same twin on the card by ``chip_smoke.py``
phase 6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)

TI, SU, SV = 16, 4, 8
S, D = 32, 5


def _mk(K, seed=0, min_len=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (K, S, D)).astype(np.float32)
    lengths = rng.integers(min_len, S + 1, K).astype(np.int32)
    return feats, lengths


def _both(feats, lengths, I, J, **kw):
    """(torch wrapper on CPU tensors, JAX kernel in interpret mode)."""
    got = tk.dtw_tile_pairs(
        torch.from_numpy(feats), torch.from_numpy(lengths),
        torch.tensor(I, dtype=torch.int32), torch.tensor(J, dtype=torch.int32),
        ti=TI, **kw,
    ).numpy()
    want = np.asarray(jp.dtw_tile_pairs(
        jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(I, jnp.int32),
        jnp.asarray(J, jnp.int32), ti=TI, su=SU, sv=SV, interpret=True, **kw,
    ))
    return got, want


@pytest.mark.parametrize(
    "kw",
    [
        dict(band=8, auto_widen=True, metric="euclidean"),
        dict(band=8, auto_widen=False, metric="euclidean"),
        dict(band=None, metric="euclidean"),
        dict(band=8, auto_widen=True, metric="sqeuclidean"),
        dict(band=8, auto_widen=True, metric="cosine"),
    ],
)
def test_plain_k2_matches_jax_kernel(kw):
    feats, lengths = _mk(2 * TI, seed=1)
    got, want = _both(feats, lengths, [0, 0, 1], [0, 1, 1], **kw)
    for u, self_tile in enumerate([True, False, True]):
        g, w = got[u].copy(), want[u].copy()
        if self_tile:
            if kw["metric"] != "cosine":
                np.testing.assert_array_equal(np.diag(g), 0.0)
            np.fill_diagonal(g, 0.0)
            np.fill_diagonal(w, 0.0)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_plain_k2_extreme_lengths():
    # Shortest legal sequences (length 1-2, the padding convention) and
    # full-length ones in the same tile.
    feats, lengths = _mk(TI, seed=2)
    lengths[:3] = [1, 2, S]
    got, want = _both(feats, lengths, [0], [0], band=8)
    g, w = got[0].copy(), want[0].copy()
    np.fill_diagonal(g, 0.0)
    np.fill_diagonal(w, 0.0)
    np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
    for r in range(TI):
        for c in range(TI):
            ref = dtw_oracle(feats[r, : lengths[r]], feats[c, : lengths[c]], band=8)
            assert np.isclose(got[0, r, c], ref, rtol=1e-4, atol=1e-4), (r, c)


def test_rows_shortfall_is_inf():
    # rows below an A length: those A rows come back +inf, in JAX as here;
    # the other rows are exact.
    feats, lengths = _mk(2 * TI, seed=3, min_len=10)
    rows = int(np.sort(lengths[:TI])[TI // 2])
    got, want = _both(feats, lengths, [0], [1], band=None, rows=rows)
    cut = lengths[:TI] > rows
    assert cut.any() and (~cut).any()
    assert np.isinf(got[0][cut]).all() and np.isinf(want[0][cut]).all()
    np.testing.assert_allclose(got[0][~cut], want[0][~cut], rtol=1e-4, atol=1e-4)


def test_scan_steps_is_ignored_and_cpu_never_launches():
    feats, lengths = _mk(2 * TI, seed=4)
    args = (torch.from_numpy(feats), torch.from_numpy(lengths),
            torch.tensor([0, 1], dtype=torch.int32), torch.tensor([1, 1], dtype=torch.int32))
    before = tk.dtw_tile_pairs.launches
    a = tk.dtw_tile_pairs(*args, ti=TI, scan_steps=1)
    b = tk.dtw_tile_pairs_ref(*args, ti=TI)
    assert tk.dtw_tile_pairs.launches == before
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_checks_arguments():
    f = torch.zeros((8, 6, 2))
    n = torch.ones(8, dtype=torch.int32)
    u = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of ti"):
        tk.dtw_tile_pairs(f, n, u, u, ti=3)
    with pytest.raises(ValueError, match="int32"):
        tk.dtw_tile_pairs(f, n.long(), u, u, ti=4)
    with pytest.raises(ValueError, match="band"):
        tk.dtw_tile_pairs(f, n, u, u, ti=4, band=-1)
    with pytest.raises(ValueError, match="device"):
        tk.dtw_tile_pairs(f.to("meta"), n.to("meta"), u.to("meta"), u.to("meta"), ti=4)

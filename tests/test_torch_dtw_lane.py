"""K4 and K5, the widen-banded tile-pair kernels, on the CPU: their plain
twin (what both wrappers run for CPU tensors) against the JAX kernels
``dtw_tile_lane_pairs`` and ``dtw_tile_stripe_pairs`` in interpret mode, the
oracle on length-1 sequences, and the +inf contracts.

Tolerance rtol 1e-4 / atol 1e-4 off the diagonal, atol 1e-3 on self pairs:
the JAX kernels build costs from a Gram expansion, which leaves ~1e-3 near
a true 0, the twin from squared differences (self pairs exactly 0).  The
``wv_max`` shortfall is held against the contract, not against JAX: the
reference rounds its stripe up (to 8 or 128 slots), so for a small
shortfall its corner can stay in the frame and read a truncated value,
where the port's exact frame gives +inf.  The CUDA kernels themselves are
held against the same twin on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu.oracle.dtw import dtw_oracle
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)

TI, S, D = 8, 32, 4
PAIRS = ([0, 0, 1], [0, 1, 1])


def _mk(seed, lo=6):
    rng = np.random.default_rng(seed)
    feats = rng.normal(0, 1, (2 * TI, S, D)).astype(np.float32)
    lengths = rng.integers(lo, S + 1, 2 * TI).astype(np.int32)
    return feats, lengths


def _port(fn, feats, lengths, I, J, **kw):
    return fn(
        torch.from_numpy(feats), torch.from_numpy(lengths),
        torch.tensor(I, dtype=torch.int32), torch.tensor(J, dtype=torch.int32), ti=TI, **kw,
    ).numpy()


def _jax_lane(feats, lengths, I, J, **kw):
    # unroll_rows only batches the TPU kernel's row loop; 1 keeps the
    # interpret-mode compile short.
    return np.asarray(jp.dtw_tile_lane_pairs(
        jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(I, jnp.int32),
        jnp.asarray(J, jnp.int32), ti=TI, unroll_rows=1, interpret=True, **kw,
    ))


def _assert_blocks(got, want, I, J):
    for u in range(len(I)):
        g, w = got[u].copy(), want[u].copy()
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w))
        atol = 1e-4
        if I[u] == J[u]:
            # The Gram residue of a true 0 (up to ~1e-2 after the sqrt)
            # rides along every path of a self tile.
            np.fill_diagonal(g, 0.0)
            np.fill_diagonal(w, 0.0)
            atol = 1e-3
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol)


@pytest.mark.parametrize(
    "kw",
    [
        dict(band=4, auto_widen=True, metric="euclidean"),
        dict(band=4, auto_widen=False, metric="euclidean"),
        dict(band=4, auto_widen=True, metric="sqeuclidean"),
        dict(band=4, auto_widen=True, metric="cosine"),
    ],
)
def test_plain_k4_matches_jax_kernel(kw):
    feats, lengths = _mk(1)
    wv = int(np.ptp(lengths))           # covers every pair's widened band
    got = _port(tk.dtw_tile_lane_pairs, feats, lengths, *PAIRS, wv_max=wv, **kw)
    want = _jax_lane(feats, lengths, *PAIRS, wv_max=wv, **kw)
    _assert_blocks(got, want, *PAIRS)
    if not kw["auto_widen"]:
        # A hard band of 4 puts many corners out of band: +inf, as in JAX.
        la, lb = lengths[:TI, None], lengths[TI:][None, :]
        assert np.isinf(got[1][np.abs(la - lb) > 4]).all() and (np.abs(la - lb) > 4).any()
    if kw["metric"] != "cosine":
        np.testing.assert_array_equal(np.diag(got[0]), 0.0)


def test_k4_rows_and_wv_shortfalls_are_inf_on_exactly_the_cut_pairs():
    feats, lengths = _mk(2)
    wv = int(np.ptp(lengths))
    la, lb = lengths[:TI, None], lengths[TI:][None, :]
    # rows below some A lengths: those rows +inf, in JAX as in the port.
    rows = int(np.sort(lengths[:TI])[TI // 2])
    got = _port(tk.dtw_tile_lane_pairs, feats, lengths, [0], [1], band=4, wv_max=wv, rows=rows)
    want = _jax_lane(feats, lengths, [0], [1], band=4, wv_max=wv, rows=rows)
    cut = np.broadcast_to(la > rows, (TI, TI))
    assert cut.any() and (~cut).any()
    assert np.isinf(got[0][cut]).all() and np.isfinite(got[0][~cut]).all()
    _assert_blocks(got, want, [0], [1])
    # wv_max below some pairs' widened half-width: exactly those +inf, the
    # rest equal to the uncut run (against the contract, not JAX).
    full = _port(tk.dtw_tile_lane_pairs, feats, lengths, [0], [1], band=4, wv_max=wv)[0]
    short = int(np.median(np.abs(la - lb)))
    got = _port(tk.dtw_tile_lane_pairs, feats, lengths, [0], [1], band=4, wv_max=short)[0]
    cut = np.abs(la - lb) > short
    assert cut.any() and (~cut).any()
    assert np.isinf(got[cut]).all()
    np.testing.assert_array_equal(got[~cut], full[~cut])


def test_k4_length_one_sequences_match_oracle():
    # segmentation.min_len_frames=1: length-1 A and B sequences (K1's
    # carried fault of the reference is specific to its sheared frame).
    feats, lengths = _mk(3)
    lengths[[0, 1, TI, TI + 1]] = [1, 2, 1, 5]
    wv = int(np.ptp(lengths))
    got = _port(tk.dtw_tile_lane_pairs, feats, lengths, [0, 0], [0, 1], band=2, wv_max=wv)
    for u, J in enumerate([0, 1]):
        for r in range(TI):
            for c in range(TI):
                b = J * TI + c
                want = dtw_oracle(feats[r, : lengths[r]], feats[b, : lengths[b]], band=2,
                                  band_mode="widen")
                assert np.isclose(got[u, r, c], want, rtol=1e-5, atol=1e-5), (u, r, c)


def test_plain_k5_matches_jax_stripe_and_lane_kernels():
    # K5's wrapper on the CPU against the JAX tile-stripe kernel at
    # (ti, su, sv) = (8, 4, 8), and against the JAX lane kernel (K4) on the
    # same job: both TPU kernels compute K4's function.
    feats, lengths = _mk(4)
    wv = int(np.ptp(lengths))
    kw = dict(band=4, wv_max=wv)
    got = _port(tk.dtw_tile_stripe_pairs, feats, lengths, *PAIRS, **kw)
    want = np.asarray(jp.dtw_tile_stripe_pairs(
        jnp.asarray(feats), jnp.asarray(lengths), jnp.asarray(PAIRS[0], jnp.int32),
        jnp.asarray(PAIRS[1], jnp.int32), ti=TI, su=4, sv=8, interpret=True, **kw,
    ))
    _assert_blocks(got, want, *PAIRS)
    _assert_blocks(got, _jax_lane(feats, lengths, *PAIRS, **kw), *PAIRS)
    lane = _port(tk.dtw_tile_lane_pairs, feats, lengths, *PAIRS, **kw)
    np.testing.assert_array_equal(got, lane)


def test_cpu_never_launches_and_arguments_are_checked():
    feats, lengths = _mk(5)
    before = (tk.dtw_tile_lane_pairs.launches, tk.dtw_tile_stripe_pairs.launches)
    _port(tk.dtw_tile_lane_pairs, feats, lengths, [0], [1], band=4, wv_max=30)
    _port(tk.dtw_tile_stripe_pairs, feats, lengths, [0], [1], band=4, wv_max=30)
    assert (tk.dtw_tile_lane_pairs.launches, tk.dtw_tile_stripe_pairs.launches) == before
    f = torch.zeros((8, 6, 2))
    n = torch.ones(8, dtype=torch.int32)
    u = torch.zeros(1, dtype=torch.int32)
    for fn in (tk.dtw_tile_lane_pairs, tk.dtw_tile_stripe_pairs):
        with pytest.raises(ValueError, match="band"):
            fn(f, n, u, u, ti=4, band=None, wv_max=4)
        with pytest.raises(ValueError, match="device"):
            fn(f.to("meta"), n.to("meta"), u.to("meta"), u.to("meta"), ti=4, band=2, wv_max=4)

"""K6 and K7, the per-pair kernels over gathered pairs, on the CPU: their
plain twins (what ``dtw_batch_pallas`` and ``_dtw_batch_stripe`` run for
CPU tensors) against the JAX kernels in interpret mode, the routing helpers
against the reference's, and the +inf contracts.

Tolerance rtol 1e-4 / atol 1e-4: the JAX kernels build costs from a Gram
expansion, the twins from squared differences; no pair here is a self
pair.  The ``max_len_diff`` shortfall is held against the contract (+inf),
not against JAX, whose 128-slot rounding can keep a short stripe's corner in
frame.  The CUDA kernels are held against the same twins on the card by
``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops import dtw_pallas as jp
from audio_pattern_discovery_tpu_torch.ops import dtw_cuda as tk

torch.set_num_threads(1)


def _pairs(seed, B, R, S, d, lo_a, hi_a, lo_b, hi_b):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (B, R, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(lo_a, hi_a + 1, B).astype(np.int32)
    lb = rng.integers(lo_b, hi_b + 1, B).astype(np.int32)
    return a, b, la, lb


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


@pytest.mark.parametrize(
    "kw",
    [
        dict(band=None, normalize="none", metric="euclidean"),
        dict(band=None, normalize="path_len", metric="cosine"),
        dict(band=3, auto_widen=True, normalize="path_len", metric="euclidean"),
        dict(band=8, auto_widen=False, normalize="none", metric="sqeuclidean"),
    ],
)
def test_plain_k6_matches_jax_kernel(kw):
    # R < S: the shorter side on rows, as the per-pair scheduler passes it.
    a, b, la, lb = _pairs(1, 12, 16, 24, 4, 3, 16, 8, 24)
    got = tk.dtw_batch_pallas(*_t(a, b, la, lb), **kw).numpy()
    want = np.asarray(jp.dtw_batch_pallas(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), interpret=True, **kw))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert fin.sum() >= 4
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=1e-4)
    if kw.get("auto_widen") is False:
        assert np.isinf(got[np.abs(la - lb) > kw["band"]]).all()


@pytest.mark.parametrize("normalize", ["none", "path_len"])
def test_plain_k7_matches_jax_stripe_kernel(normalize):
    # S=512 with a max_len_diff class whose 128-slot stripe applies
    # (4*128 <= 512): dtw_batch_pallas routes to the stripe twin, as the
    # reference routes to its stripe kernel.
    a, b, la, _ = _pairs(2, 8, 256, 512, 3, 40, 90, 0, 0)
    rng = np.random.default_rng(3)
    lb = (la + rng.integers(0, 41, 8)).astype(np.int32)
    mld = 40
    assert tk.stripe_width(512, 8, True, mld) == 128
    kw = dict(band=8, auto_widen=True, normalize=normalize, max_len_diff=mld)
    got = tk.dtw_batch_pallas(*_t(a, b, la, lb), **kw).numpy()
    direct = tk._dtw_batch_stripe(*_t(a, b, la, lb), **kw).numpy()
    want = np.asarray(jp._dtw_batch_stripe(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(la), jnp.asarray(lb), metric="euclidean",
        pair_block=8, interpret=True, **kw))
    np.testing.assert_array_equal(got, direct)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.isfinite(got).all()


def test_k7_shortfall_rows_and_hard_band_are_inf():
    a, b, la, _ = _pairs(4, 8, 128, 512, 3, 30, 60, 0, 0)
    lb = (la + np.arange(0, 64, 8)).astype(np.int32)
    full = tk._dtw_batch_stripe(*_t(a, b, la, lb), band=8, max_len_diff=56).numpy()
    assert np.isfinite(full).all()
    # max_len_diff 30 below the pairs with |la - lb| > 30: exactly those +inf.
    short = tk._dtw_batch_stripe(*_t(a, b, la, lb), band=8, max_len_diff=30).numpy()
    cut = np.abs(la - lb) > 30
    assert cut.any() and (~cut).any()
    assert np.isinf(short[cut]).all()
    np.testing.assert_array_equal(short[~cut], full[~cut])
    # A hard band (auto_widen off) puts corners with |la - lb| > 8 out of band.
    hard = tk._dtw_batch_stripe(*_t(a, b, la, lb), band=8, auto_widen=False).numpy()
    assert np.isinf(hard[np.abs(la - lb) > 8]).all()
    np.testing.assert_array_equal(hard[np.abs(la - lb) <= 8], full[np.abs(la - lb) <= 8])
    # rows: a longer than its padded rows is +inf (K6's R contract).
    got = tk.dtw_batch_pallas(*_t(a[:, :40], b[:, :128], la, np.minimum(lb, 128)),
                              band=None).numpy()
    assert np.isinf(got[la > 40]).all() and np.isfinite(got[la <= 40]).all()


def test_routing_helpers_equal_reference():
    for S in (128, 256, 512, 1024, 2048, 4096, 8192):
        for band in (None, 0, 8, 16, 100):
            for auto in (True, False):
                assert tk.scan_len_diff_classes(S, band, auto) == jp.scan_len_diff_classes(
                    S, band, auto)
                for mld in (None, 0, 30, 63, 64, 200, 511):
                    assert tk.stripe_width(S, band, auto, mld) == jp.stripe_width(S, band, auto, mld)
                    assert tk.pallas_supported(S, band, auto, mld) == jp.pallas_supported(
                        S, band, auto, mld)


def test_cpu_never_launches_and_arguments_are_checked():
    a, b, la, lb = _t(*_pairs(5, 4, 8, 16, 2, 2, 8, 2, 16))
    before = (tk.dtw_batch_pallas.launches, tk._dtw_batch_stripe.launches)
    tk.dtw_batch_pallas(a, b, la, lb, band=2)
    assert (tk.dtw_batch_pallas.launches, tk._dtw_batch_stripe.launches) == before
    with pytest.raises(ValueError, match="shorter"):
        tk.dtw_batch_pallas(b, a, lb, la)
    with pytest.raises(ValueError, match="int32"):
        tk.dtw_batch_pallas(a, b, la.long(), lb)
    with pytest.raises(ValueError, match="normalize"):
        tk.dtw_batch_pallas(a, b, la, lb, normalize="mean")
    with pytest.raises(ValueError, match="stripe route does not apply"):
        tk._dtw_batch_stripe(a, b, la, lb, band=2, max_len_diff=4)
    with pytest.raises(ValueError, match="1024"):
        tk.dtw_batch_pallas(torch.zeros(1, 4, 2), torch.zeros(1, 2048, 2),
                            la[:1], lb[:1], band=None)
    with pytest.raises(ValueError, match="device"):
        tk.dtw_batch_pallas(a.to("meta"), b.to("meta"), la.to("meta"), lb.to("meta"))

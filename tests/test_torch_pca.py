"""The port's PCA embedder and feature scaler against the JAX reference.

Tolerances: 1e-4 relative on eigen-quantities and projections (both fit
an fp32 scatter matrix, summed in different orders, then solve it in
float64 on the host)."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.models.autoencoder import FeatureScaler as JScaler
from audio_pattern_discovery_tpu.models.pca import encode_pca as j_encode
from audio_pattern_discovery_tpu.models.pca import fit_pca as j_fit
from audio_pattern_discovery_tpu_torch.models.autoencoder import FeatureScaler
from audio_pattern_discovery_tpu_torch.ops import scaler_stats as ss
from audio_pattern_discovery_tpu_torch.models.pca import (
    PCAState,
    encode_pca,
    fit_pca,
    pca_state_from_numpy,
)

torch.set_num_threads(1)


def _frames(seed, n=1500, d=20, k=4):
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.normal(size=(d, d)))[0][:, :k]
    z = rng.normal(size=(n, k)) * np.array([5.0, 4.0, 3.0, 2.0])[:k]
    return (z @ basis.T + 0.05 * rng.normal(size=(n, d)) + 1.5).astype(np.float32)


@pytest.mark.parametrize("whiten", [True, False])
def test_fit_matches_jax(whiten):
    x = _frames(1)
    got, want = fit_pca(x, 4, whiten=whiten, device="cpu"), j_fit(x, 4, whiten=whiten)
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.components, want.components, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scale, want.scale, rtol=1e-4)
    np.testing.assert_allclose(got.explained, want.explained, rtol=1e-4, atol=1e-6)


def test_encode_through_state_from_numpy_matches_jax():
    x = _frames(2)
    st_j = j_fit(x, 3)
    st = pca_state_from_numpy(st_j.mean, st_j.components, st_j.scale, st_j.explained)
    assert isinstance(st, PCAState) and st.components.dtype == np.float32
    frames = x.reshape(30, 50, 20)                       # [K, L, d] like segments
    got = encode_pca(st, torch.from_numpy(frames)).numpy()
    want = j_encode(st_j, frames)
    assert got.shape == (30, 50, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_scaler_matches_jax_on_host_and_tensors():
    x = _frames(3)
    s, s_j = FeatureScaler.fit(x), JScaler.fit(x)
    np.testing.assert_array_equal(s.mean, s_j.mean)
    np.testing.assert_array_equal(s.std, s_j.std)
    np.testing.assert_array_equal(s.transform(x), s_j.transform(x))
    np.testing.assert_allclose(s.transform(torch.from_numpy(x)).numpy(), s_j.transform(x),
                               rtol=1e-6, atol=1e-6)


def test_fit_is_deterministic_and_validates():
    x = _frames(4)
    a, b = fit_pca(x, 5, device="cpu"), fit_pca(torch.from_numpy(x), 5, device="cpu")
    np.testing.assert_array_equal(a.components, b.components)
    with pytest.raises(ValueError, match="n_components"):
        fit_pca(x, 21, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        fit_pca(x[:1], 2, device="cpu")


def _scaler_frames(seed, n):
    """``_frames`` with bin 0 at a large mean and a small spread (log-power
    bins far from 0: the case where E[x^2] - E[x]^2 cancels) and bin 1
    constant (the 1e-6 floor)."""
    x = _frames(seed, n=n)
    rng = np.random.default_rng(seed)
    x[:, 0] = 300.0 + 0.5 * rng.normal(size=n)
    x[:, 1] = -7.25
    return x


def test_scaler_fit_on_a_tensor_matches_numpy_and_jax():
    # Bit for bit: a CPU tensor's statistics are NumPy's (a CUDA tensor's
    # are too: ops/scaler_stats.py).
    x = _scaler_frames(5, n=2000)
    got = FeatureScaler.fit(torch.from_numpy(x))
    for want in (FeatureScaler.fit(x), JScaler.fit(x)):
        np.testing.assert_array_equal(got.mean, want.mean)
        np.testing.assert_array_equal(got.std, want.std)
    for a in (got.mean, got.std):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32 and a.shape == (20,)
    assert got.std[1] == np.float32(1e-6)
    # Bin 0 is a cancellation case: fp32's one pass misses its std by far
    # more than a rounding.
    one_pass = np.sqrt(np.mean(x[:, 0] * x[:, 0]) - np.mean(x[:, 0]) ** 2)
    assert abs(one_pass / got.std[0] - 1) > 1e-3
    # transform sees the same scaler whichever input fitted it, and the
    # in-place standardization gives its bits.
    np.testing.assert_array_equal(got.transform(torch.from_numpy(x)).numpy(), got.transform(x))
    xt = torch.from_numpy(x.copy())
    assert got.transform_(xt) is xt
    np.testing.assert_array_equal(xt.numpy(), got.transform(x))


@pytest.mark.parametrize("bad,match", [
    (torch.zeros((64, 3), dtype=torch.float64), "float32"),
    (torch.zeros(64), "float32"),
    (torch.zeros((4, 64, 3)), "float32"),
    (torch.zeros((3, 64)).T, "contiguous"),
    (torch.zeros((0, 3)), "rows"),
    (torch.zeros((64, 3)), "CUDA"),
])
def test_scaler_stats_refuses_what_the_kernel_cannot_take(bad, match):
    # The kernel (csrc/scaler_stats.cu) reads contiguous [n, d] fp32 rows
    # on the card; anything else is refused before a launch.  A CPU
    # tensor's statistics are FeatureScaler.fit's NumPy branch.
    n0 = ss.scaler_stats.launches
    with pytest.raises(ValueError, match=match):
        ss.scaler_stats(bad)
    assert ss.scaler_stats.launches == n0

"""The port's checkpoints: the AE's ``ae_state.npz`` round trip (bitwise),
a reference AE carried into it, the PCA file shared with the JAX package
(bitwise in both directions), and the refusal of the reference's orbax
AE checkpoint."""

import jax
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import AutoencoderConfig as JCfg
from audio_pattern_discovery_tpu.models import autoencoder as jae
from audio_pattern_discovery_tpu.models.pca import fit_pca as j_fit_pca
from audio_pattern_discovery_tpu.utils import checkpoint as jckpt
from audio_pattern_discovery_tpu_torch.config import AutoencoderConfig, PipelineConfig
from audio_pattern_discovery_tpu_torch.models import autoencoder as tae
from audio_pattern_discovery_tpu_torch.models.pca import fit_pca
from audio_pattern_discovery_tpu_torch.pipeline import discover
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus
from audio_pattern_discovery_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)


def _cfg(**kw):
    return AutoencoderConfig(latent_dim=4, hidden_dims=(16,), epochs=3, batch_size=64, **kw)


def _assert_same_state(a, b):
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    for name in a.params:
        assert torch.equal(a.params[name], b.params[name]), name
        assert torch.equal(a.opt_state["mu"][name], b.opt_state["mu"][name]), name
        assert torch.equal(a.opt_state["nu"][name], b.opt_state["nu"][name]), name


def test_roundtrip_restores_exact_state(tmp_path, rng):
    frames = rng.normal(0, 1, (200, 12)).astype(np.float32)
    cfg = _cfg()
    scaler = tae.FeatureScaler.fit(frames)
    model, state, _ = tae.train_autoencoder(scaler.transform(frames), cfg, device="cpu")
    assert state.step == 3 * 3 and state.opt_state["count"] == 9

    assert not ckpt.has_ae_checkpoint(tmp_path)
    path = ckpt.save_ae_checkpoint(tmp_path, state, scaler)
    assert path.name == "ae_state.npz" and ckpt.has_ae_checkpoint(tmp_path)
    model2, state2, scaler2 = ckpt.restore_ae_checkpoint(tmp_path, cfg, 12, device="cpu")
    _assert_same_state(state, state2)
    np.testing.assert_array_equal(scaler2.mean, scaler.mean)
    np.testing.assert_array_equal(scaler2.std, scaler.std)
    # Encodings from the restored state are bit-identical.
    x = scaler.transform(frames[:32]).astype(np.float32)
    assert torch.equal(tae.encode_frames(model, state.params, x),
                       tae.encode_frames(model2, state2.params, x))
    # Flax layout on disk: kernel [in, out], the first hidden layer's width.
    with np.load(path) as z:
        assert z["params/enc_layers_0/kernel"].shape == (12, 16)
        assert int(z["count"]) == int(z["step"]) == 9


def test_roundtrip_without_scaler(tmp_path, rng):
    frames = rng.normal(0, 1, (100, 8)).astype(np.float32)
    cfg = _cfg()
    _, state, _ = tae.train_autoencoder(frames, cfg, device="cpu")
    ckpt.save_ae_checkpoint(tmp_path, state)
    _, state2, scaler2 = ckpt.restore_ae_checkpoint(tmp_path, cfg, 8, device="cpu")
    assert scaler2 is None
    _assert_same_state(state, state2)


def test_restore_shape_checks_the_config(tmp_path, rng):
    frames = rng.normal(0, 1, (100, 8)).astype(np.float32)
    _, state, _ = tae.train_autoencoder(frames, _cfg(), device="cpu")
    ckpt.save_ae_checkpoint(tmp_path, state)
    with pytest.raises(ValueError, match="input_dim=9"):
        ckpt.restore_ae_checkpoint(tmp_path, _cfg(), 9, device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        ckpt.restore_ae_checkpoint(
            tmp_path, AutoencoderConfig(latent_dim=4, hidden_dims=(32,)), 8, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_ae_checkpoint(tmp_path / "empty", _cfg(), 8, device="cpu")


def test_reference_state_carried_into_the_port_checkpoint(tmp_path, rng):
    # A JAX-trained state (parameters and Adam) saved in the port's format
    # restores to the reference's encodings (fp32 tolerance, as
    # test_torch_autoencoder) and its Adam moments bitwise.
    frames = rng.normal(0, 1, (300, 10)).astype(np.float32)
    jcfg = JCfg(latent_dim=4, hidden_dims=(16,), epochs=2, batch_size=64)
    jmodel, jstate, _ = jae.train_autoencoder(frames, jcfg)
    adam = tae.adam_state_from_optax(jax.device_get(jstate.opt_state))
    state = tae.TrainState(tae.params_from_flax(jax.device_get(jstate.params)), adam,
                           jstate.step)
    ckpt.save_ae_checkpoint(tmp_path, state)
    model, restored, _ = ckpt.restore_ae_checkpoint(tmp_path, _cfg(), 10, device="cpu")
    assert restored.step == jstate.step and restored.opt_state["count"] == adam["count"] == 8
    for name in adam["mu"]:
        assert torch.equal(restored.opt_state["mu"][name], adam["mu"][name])
        assert torch.equal(restored.opt_state["nu"][name], adam["nu"][name])
    np.testing.assert_allclose(tae.encode_frames(model, restored.params, frames).numpy(),
                               jae.encode_frames(jmodel, jstate.params, frames),
                               rtol=1e-5, atol=1e-6)


def test_reference_orbax_checkpoint_is_refused(tmp_path, rng):
    frames = rng.normal(0, 1, (100, 8)).astype(np.float32)
    jcfg = JCfg(latent_dim=4, hidden_dims=(16,), epochs=1, batch_size=64)
    _, jstate, _ = jae.train_autoencoder(frames, jcfg)
    jckpt.save_ae_checkpoint(tmp_path, jstate, jae.FeatureScaler.fit(frames))
    assert (tmp_path / "ae_state").is_dir()
    assert ckpt.has_ae_checkpoint(tmp_path)
    with pytest.raises(ValueError, match="written by the JAX package"):
        ckpt.restore_ae_checkpoint(tmp_path, _cfg(), 8, device="cpu")
    assert not (tmp_path / "ae_state.npz").exists()
    # discover() with autoencoder.checkpoint refuses it too, before training.
    out = tmp_path / "out"
    jckpt.save_ae_checkpoint(out / "ae_ckpt", jstate)
    make_corpus(tmp_path / "corpus", n_clips=4, n_motifs=2, clip_seconds=1.5, seed=3)
    cfg = PipelineConfig().override({"dtw.band": 8, "dtw.max_seq_len": 48,
                                     "autoencoder.checkpoint": True, "autoencoder.epochs": 1})
    with pytest.raises(ValueError, match="written by the JAX package"):
        discover(tmp_path / "corpus", cfg, out_dir=out, device="cpu")
    assert not (out / "ae_ckpt" / "ae_state.npz").exists()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pca_checkpoint_is_shared_with_the_reference(tmp_path, writer):
    x = np.random.default_rng(4).normal(size=(400, 12)).astype(np.float32)
    if writer == "jax":
        state, scaler = j_fit_pca(x, 3), jae.FeatureScaler.fit(x)
        jckpt.save_pca_checkpoint(tmp_path, state, scaler)
        got, got_scaler = ckpt.restore_pca_checkpoint(tmp_path)
    else:
        state, scaler = fit_pca(x, 3, device="cpu"), tae.FeatureScaler.fit(x)
        ckpt.save_pca_checkpoint(tmp_path, state, scaler)
        got, got_scaler = jckpt.restore_pca_checkpoint(tmp_path)
    assert ckpt.has_pca_checkpoint(tmp_path) and jckpt.has_pca_checkpoint(tmp_path)
    for field in ("mean", "components", "scale", "explained"):
        want = getattr(state, field)
        assert getattr(got, field).dtype == want.dtype
        np.testing.assert_array_equal(getattr(got, field), want)
    np.testing.assert_array_equal(got_scaler.mean, scaler.mean)
    np.testing.assert_array_equal(got_scaler.std, scaler.std)

"""The port's spectrogram (audio_pattern_discovery_tpu_torch/ops/
spectrogram.py) against the JAX reference and the float64 NumPy oracle.

Tolerances are those of tests/test_spectrogram.py and tests/test_features.py:
1e-4 on log-power bins against the oracle and against JAX (fp32 DFT
matmuls with different reduction orders), 1e-3 for mel/MFCC against the
oracle, 1e-5 between the port's corpus tiling and its single-shot call."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import SpectrogramConfig as JSpecCfg
from audio_pattern_discovery_tpu.io.corpus import pad_and_stack
from audio_pattern_discovery_tpu.ops import spectrogram as jsp
from audio_pattern_discovery_tpu.oracle.stft import mel_oracle, mfcc_oracle, stft_oracle
from audio_pattern_discovery_tpu_torch.config import SpectrogramConfig
from audio_pattern_discovery_tpu_torch.ops import spectrogram as tsp

torch.set_num_threads(1)


def _clips(seed, n=5, lo=300, hi=2500):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 0.3, int(k)).astype(np.float32) for k in rng.integers(lo, hi, n)]


@pytest.mark.parametrize("window", ["hann", "hamming", "rect"])
@pytest.mark.parametrize("fft_impl", ["matmul", "rfft"])
def test_bins_match_oracle_and_jax(window, fft_impl):
    sig = _clips(1, n=1, lo=4000, hi=4001)[0]
    kw = dict(win_length=512, hop_length=128, window=window, fft_impl=fft_impl)
    got, fc = tsp.batched_spectrogram(torch.from_numpy(sig[None]),
                                      torch.tensor([len(sig)]), **kw)
    ref = stft_oracle(sig, win_length=512, hop_length=128, window=window)
    assert int(fc[0]) == ref.shape[0]
    np.testing.assert_allclose(got[0].numpy(), ref, rtol=1e-4, atol=1e-4)
    want, _ = jsp.batched_spectrogram(sig[None], np.array([len(sig)], np.int32), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("feature", ["mel", "mfcc"])
def test_mel_mfcc_match_oracle_and_jax(feature):
    sig = _clips(2, n=1, lo=6000, hi=6001)[0]
    kw = dict(win_length=512, hop_length=128, sample_rate=16_000, feature=feature,
              n_mels=40, n_mfcc=13)
    got, fc, en = tsp.batched_spectrogram(
        torch.from_numpy(sig[None]), torch.tensor([len(sig)]), return_energy=True, **kw
    )
    lin = stft_oracle(sig, win_length=512, hop_length=128, log_scale=False)
    ref = (mel_oracle(lin, 16_000, 512, 40) if feature == "mel"
           else mfcc_oracle(lin, 16_000, 512, 40, 13))
    nf = int(fc[0])
    np.testing.assert_allclose(got[0, :nf].numpy(), ref, rtol=1e-3, atol=1e-3)
    want, _, en_j = jsp.batched_spectrogram(
        sig[None], np.array([len(sig)], np.int32), return_energy=True, **kw
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(en.numpy(), np.asarray(en_j), rtol=1e-5, atol=1e-5)


def test_host_tables_equal_jax():
    np.testing.assert_array_equal(tsp.mel_filterbank(257, 16_000, 512, 40),
                                  jsp.mel_filterbank(257, 16_000, 512, 40))
    np.testing.assert_array_equal(tsp.dct_ortho(40, 13), jsp.dct_ortho(40, 13))
    for name in ("hann", "hamming", "rect"):
        np.testing.assert_array_equal(tsp.window_array(name, 64), jsp.window_array(name, 64))
    with pytest.raises(ValueError, match="no FFT-bin support"):
        tsp.mel_filterbank(16, 16_000, 512, 64)


@pytest.mark.parametrize("feature", ["bins", "mfcc"])
def test_corpus_matches_jax_corpus(feature):
    # Ragged clips through both corpus functions: features, frame counts and
    # the segmentation energies agree.
    sigs = _clips(3, n=7)
    kw = dict(win_length=128, hop_length=32, feature=feature, n_mels=12, n_mfcc=8,
              sample_rate=16_000)
    got, fc, en = tsp.spectrogram_corpus(sigs, SpectrogramConfig(**kw), device="cpu",
                                         clip_batch=3, chunk_frames=10)
    want, fc_j, en_j = jsp.spectrogram_corpus(sigs, JSpecCfg(**kw),
                                              clip_batch=3, chunk_frames=10)
    np.testing.assert_array_equal(fc, fc_j)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    for i, n in enumerate(fc):
        np.testing.assert_allclose(en[i, :n], en_j[i, :n], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(en[fc[:, None] <= np.arange(en.shape[1])],
                                  en_j[fc_j[:, None] <= np.arange(en.shape[1])])


def test_corpus_tiling_matches_single_shot_and_device_assembly():
    sigs = _clips(4, n=6)
    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    specs, fcs, _ = tsp.spectrogram_corpus(sigs, cfg, device="cpu", clip_batch=4, chunk_frames=7)
    dev, fcs_d, _ = tsp.spectrogram_corpus(sigs, cfg, device="cpu", clip_batch=2, chunk_frames=1000,
                                           return_device=True)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(fcs, fcs_d)
    np.testing.assert_allclose(specs, dev.numpy(), rtol=1e-5, atol=1e-5)
    padded, lengths = pad_and_stack(sigs)
    want, want_fc = tsp.batched_spectrogram(torch.from_numpy(padded),
                                            torch.from_numpy(lengths), win_length=64,
                                            hop_length=16)
    np.testing.assert_array_equal(fcs, want_fc.numpy())
    for i, fc in enumerate(fcs):
        np.testing.assert_allclose(specs[i, :fc], want[i, :fc].numpy(), rtol=1e-5, atol=1e-5)


def test_int16_decode_equals_host_normalization():
    rng = np.random.default_rng(5)
    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    raw = [rng.integers(-30000, 30000, int(n)).astype(np.int16)
           for n in rng.integers(300, 1200, 5)]
    f32 = [r.astype(np.float32) / 32768.0 for r in raw]
    peaks = np.array([max(np.abs(s).max(), 1e-9) for s in f32], np.float32)
    want, fc_w, en_w = tsp.spectrogram_corpus([s / p for s, p in zip(f32, peaks)], cfg,
                                              device="cpu", clip_batch=3)
    got, fc_g, en_g = tsp.spectrogram_corpus(raw, cfg, device="cpu", clip_batch=3, scales=peaks)
    np.testing.assert_array_equal(fc_w, fc_g)
    np.testing.assert_array_equal(want, got)
    np.testing.assert_array_equal(en_w, en_g)


def test_short_clip_and_errors():
    cfg = SpectrogramConfig(win_length=64, hop_length=16)
    sigs = [np.ones(500, np.float32), np.ones(10, np.float32)]
    specs, fcs, _ = tsp.spectrogram_corpus(sigs, cfg, device="cpu")
    assert fcs[1] == 0 and fcs[0] > 0
    assert (specs[1] == tsp.feature_pad_fill(cfg)).all()
    with pytest.raises(ValueError, match="empty corpus"):
        tsp.spectrogram_corpus([], cfg, device="cpu")
    with pytest.raises(ValueError, match="share a dtype"):
        tsp.spectrogram_corpus([np.ones(100, np.float32), np.ones(100, np.int16)], cfg,
                               device="cpu")


def test_frame_energy_matches_jax():
    x = np.random.default_rng(6).normal(-3, 1, (3, 9, 17)).astype(np.float32)
    for log_scale, power in ((True, 2.0), (False, 1.0), (True, 1.0)):
        got = tsp.frame_energy(torch.from_numpy(x if log_scale else np.abs(x)),
                               log_scale=log_scale, power=power)
        want = jsp.frame_energy(x if log_scale else np.abs(x), log_scale=log_scale,
                                power=power)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

"""The port's copies of the NumPy oracles (audio_pattern_discovery_tpu_torch/
oracle/stft.py and cluster.py) against the JAX package's: the same NumPy and
SciPy code, so the same bits on the same inputs."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.oracle import cluster as jcluster
from audio_pattern_discovery_tpu.oracle import stft as jstft
from audio_pattern_discovery_tpu_torch.oracle import cluster as tcluster
from audio_pattern_discovery_tpu_torch.oracle import stft as tstft

torch.set_num_threads(1)


@pytest.mark.parametrize("power", [1.0, 2.0])
def test_stft_oracle_copy(power):
    sig = np.random.default_rng(0).normal(0, 0.5, 4000)
    kw = dict(win_length=256, hop_length=64, power=power)
    spec = tstft.stft_oracle(sig, **kw)
    np.testing.assert_array_equal(spec, jstft.stft_oracle(sig, **kw))
    lin = tstft.stft_oracle(sig, log_scale=False, **kw)
    mf = dict(sample_rate=16000, n_fft=256, n_mels=20, n_mfcc=13)
    np.testing.assert_array_equal(tstft.mfcc_oracle(lin, **mf), jstft.mfcc_oracle(lin, **mf))


@pytest.mark.parametrize("method", ["average", "complete"])
def test_cluster_oracle_copy(method):
    x = np.random.default_rng(1).normal(0, 1, (12, 3))
    D = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    Z = tcluster.linkage_oracle(D, method)
    np.testing.assert_array_equal(Z, jcluster.linkage_oracle(D, method))
    np.testing.assert_array_equal(tcluster.cut_oracle(Z, n_clusters=3),
                                  jcluster.cut_oracle(Z, n_clusters=3))

"""The port's checkpointed backtrace
(audio_pattern_discovery_tpu_torch/ops/backtrace_ckpt.py) against the JAX
``dtw_paths_checkpointed`` and the port's one-shot
``dtw_batch_with_dirs`` + ``walk_path`` on the same inputs, as
tests/test_backtrace_ckpt.py holds the reference.  Paths are compared
exactly: the cell values are the same fp32 sums, so are the tie-breaks."""

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.ops.backtrace_ckpt import (
    dtw_paths_checkpointed as j_paths_checkpointed,
)
from audio_pattern_discovery_tpu_torch.io.corpus import pad_and_stack
from audio_pattern_discovery_tpu_torch.ops.backtrace import paths_from_dirs
from audio_pattern_discovery_tpu_torch.ops.backtrace_ckpt import dtw_paths_checkpointed
from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch_with_dirs

torch.set_num_threads(1)


def _pairs(seed, n, lo, hi, pad, d):
    rng = np.random.default_rng(seed)
    sa = [rng.normal(0, 1, (rng.integers(lo, hi), d)).astype(np.float32) for _ in range(n)]
    sb = [rng.normal(0, 1, (rng.integers(lo, hi), d)).astype(np.float32) for _ in range(n)]
    a, la = pad_and_stack(sa, pad_to=pad)
    b, lb = pad_and_stack(sb, pad_to=pad)
    return a, b, la, lb


def _one_shot(a, b, la, lb, **kw):
    _, dirs = dtw_batch_with_dirs(torch.from_numpy(a), torch.from_numpy(b),
                                  torch.from_numpy(la), torch.from_numpy(lb), **kw)
    return paths_from_dirs(dirs.numpy(), la, lb)


@pytest.mark.parametrize("band,band_mode", [(None, "widen"), (6, "widen"), (6, "diag")])
@pytest.mark.parametrize("row_chunk", [8, 16, 64, None])
def test_paths_identical_to_one_shot_and_jax(band, band_mode, row_chunk):
    a, b, la, lb = _pairs(41, 6, 10, 60, 64, 5)
    kw = dict(band=band, band_mode=band_mode)
    got = dtw_paths_checkpointed(torch.from_numpy(a), torch.from_numpy(b), la, lb,
                                 row_chunk=row_chunk, **kw)
    assert got == _one_shot(a, b, la, lb, **kw)
    assert got == j_paths_checkpointed(a, b, la, lb, row_chunk=row_chunk, **kw)


@pytest.mark.parametrize("metric", ["sqeuclidean", "cosine"])
def test_paths_other_metrics_and_unequal_pads(metric):
    # a and b padded to different lengths; one segment (row_chunk >= N).
    a, _, la, _ = _pairs(42, 4, 5, 30, 32, 4)
    _, b, _, lb = _pairs(43, 4, 5, 40, 40, 4)
    for row_chunk in (32, 5):
        got = dtw_paths_checkpointed(torch.from_numpy(a), torch.from_numpy(b), la, lb,
                                     metric=metric, row_chunk=row_chunk)
        assert got == _one_shot(a, b, la, lb, metric=metric)


def test_paths_monotone_unit_steps_and_call_count():
    a, b, la, lb = _pairs(44, 1, 40, 41, 64, 3)
    before = dtw_paths_checkpointed.calls
    (path,) = dtw_paths_checkpointed(torch.from_numpy(a), torch.from_numpy(b), la, lb,
                                     band=10, row_chunk=16)
    assert dtw_paths_checkpointed.calls == before + 1
    assert path[0] == (0, 0) and path[-1] == (la[0] - 1, lb[0] - 1)
    steps = np.diff(np.asarray(path), axis=0)
    assert (steps >= 0).all() and (steps <= 1).all() and (steps.sum(1) >= 1).all()

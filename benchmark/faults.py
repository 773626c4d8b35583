"""Faults planted underneath the timed path, for showing that the check
fails them (``benchmark/tests`` on the CPU, ``control.py --fault`` on the
card).  Each is a context manager that patches the program's module and
restores it:

- ``answer``: the distances of a quarter of the sequences at each end of
  the corpus come out of the all-pairs call 0.1 % high;
- ``half``: half of the pairs of the all-pairs call are left out (zero);
- ``block``: the distances of one block of 128 x 128 pairs off the
  diagonal (in the middle of the index grid where it has three blocks a
  side or more), and its mirror, come out 0.1 % high;
- ``unchanged``: the AE's training step returns its loss and leaves the
  model unchanged;
- ``half_batch``: the AE's training step runs on half of its minibatch, the
  mean taken over that half;
- ``unwhitened``: the PCA embedding's scale is left at 1, so its latents
  come out unwhitened.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

FAULTS = ("answer", "half", "block", "unchanged", "half_batch", "unwhitened")
BLOCK = 128


def _altered(fn, fault: str):
    def wrapped(*args, **kw):
        D = np.array(fn(*args, **kw))
        K = D.shape[0]
        if fault == "answer":
            q = max(1, K // 4)
            rows = np.r_[0:q, K - q:K]
            D[rows, :] *= 1.001
            D[:, rows] *= 1.001
        elif fault == "block":
            nb = -(-K // BLOCK)
            bi, bj = (nb - 1) // 3, 2 * (nb - 1) // 3
            rows, cols = slice(bi * BLOCK, (bi + 1) * BLOCK), slice(bj * BLOCK, (bj + 1) * BLOCK)
            D[rows, cols] *= 1.001
            if bi != bj:
                D[cols, rows] *= 1.001
        else:
            iu = np.triu_indices(K, 1)
            half = np.arange(len(iu[0])) % 2 == 0
            D[iu[0][half], iu[1][half]] = 0.0
            D[iu[1][half], iu[0][half]] = 0.0
        return D

    return wrapped


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` underneath the timed path."""
    import audio_pattern_discovery_tpu_torch.pipeline as pipeline
    from audio_pattern_discovery_tpu_torch.models import autoencoder
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler

    saved = [(pair_scheduler, "all_pairs_distances", pair_scheduler.all_pairs_distances),
             (pipeline, "all_pairs_distances", pipeline.all_pairs_distances),
             (autoencoder, "train_step", autoencoder.train_step),
             (pipeline, "fit_pca", pipeline.fit_pca)]
    step, fit_pca = autoencoder.train_step, pipeline.fit_pca

    def broken_step(model, tx, batch, noise=None):
        if fault == "unchanged":
            tx.zero_grad(set_to_none=True)
            recon, _ = model(batch if noise is None else batch + noise)
            return torch.mean((recon.float() - batch) ** 2).detach()
        h = len(batch) // 2
        return step(model, tx, batch[:h], None if noise is None else noise[:h])

    def unwhitened_fit(*args, **kw):
        state = fit_pca(*args, **kw)
        state.scale = np.ones_like(state.scale)
        return state

    try:
        if fault in ("answer", "half", "block"):
            pair_scheduler.all_pairs_distances = _altered(pair_scheduler.all_pairs_distances,
                                                          fault)
            pipeline.all_pairs_distances = pair_scheduler.all_pairs_distances
        elif fault in ("unchanged", "half_batch"):
            autoencoder.train_step = broken_step
        elif fault == "unwhitened":
            pipeline.fit_pca = unwhitened_fit
        else:
            raise ValueError(f"unknown fault {fault!r}")
        yield
    finally:
        for mod, name, value in saved:
            setattr(mod, name, value)

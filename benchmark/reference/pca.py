"""Plain PCA(-whitening) of standardized frames, as the configuration states.

Written from the configuration alone (``autoencoder.method="pca"``,
``latent_dim`` components, ``pca_whiten``): the frames' mean and covariance
(over n - 1) in float64, ``numpy.linalg.eigh``, eigenvalues clipped at 0 and
taken in descending order, each component's sign fixed so that its
largest-|coefficient| entry is positive, and with whitening each latent
divided by sqrt(eigenvalue) + 1e-6.  A latent is ((x - mean) @ components)
/ scale.  These are the semantics of the port's PCA; the departure is the
precision, float64 throughout where the program builds the covariance and
projects in fp32.  Where eigenvalues nearly tie, as in the flat noise floor
of a spectrum, their components' directions are set by rounding alone:
``resolved`` names the components that are not.  ``precision="tf32"`` or
``"bf16"`` (the controls) rounds
the centred frames before the covariance, and the centred frames and the
components before the projection, fp32 sums.  Imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.precision import rounded

EPS = 1e-6


def fit(frames: torch.Tensor, n_components: int, whiten: bool,
        precision: str = "fp64") -> dict:
    """{"mean" [d], "components" [d, k], "scale" [k]} (float64, on the
    frames' device) of [N, d] standardized frames, and "eigenvalues", the
    k + 1 largest (NumPy, descending)."""
    n = frames.shape[0]
    if precision == "fp64":
        x = frames.double()
        mean = x.mean(0)
        xc = x - mean
    else:
        x = frames.float()
        mean = x.mean(0)
        xc = rounded(x - mean, precision)
    cov = (xc.T @ xc).double().cpu().numpy() / (n - 1)
    del xc
    w, v = np.linalg.eigh(cov)
    w, v = np.maximum(w[::-1], 0.0), v[:, ::-1]
    comps = v[:, :n_components]
    sign = np.sign(comps[np.argmax(np.abs(comps), axis=0), np.arange(n_components)])
    sign[sign == 0] = 1.0
    scale = np.sqrt(w[:n_components]) + EPS if whiten else np.ones(n_components)
    dev = frames.device
    return {"mean": mean.double(), "components": torch.from_numpy(comps * sign).to(dev),
            "scale": torch.from_numpy(scale).to(dev), "eigenvalues": w[:n_components + 1]}


def resolved(eigenvalues: np.ndarray, n_components: int, rel_gap: float) -> np.ndarray:
    """[k] bool: the components whose eigenvalue lies apart from each
    neighbour's (the (k+1)-th for the last) by ``rel_gap`` of itself or more,
    so that their directions do not turn with rounding; the first always."""
    w = np.asarray(eigenvalues, np.float64)[:n_components + 1]
    gaps = w[:-1] - w[1:]
    apart = np.minimum(np.r_[np.inf, gaps[:-1]], gaps) >= rel_gap * w[:-1]
    apart[0] = True
    return apart


def project(frames: torch.Tensor, state: dict, precision: str = "fp64") -> torch.Tensor:
    """Latents [..., k] (float64) of standardized frames [..., d]."""
    if precision == "fp64":
        return (frames.double() - state["mean"]) @ state["components"] / state["scale"]
    xc = rounded(frames.float() - state["mean"].float(), precision)
    return (xc @ rounded(state["components"], precision)).double() / state["scale"]

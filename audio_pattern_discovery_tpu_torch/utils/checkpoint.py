"""Checkpoint / resume of the embedders: the AE's train state and the PCA
projection, each with its fitted FeatureScaler.

Port of ``audio_pattern_discovery_tpu/utils/checkpoint.py``.  The reference
writes the AE through orbax, which imports JAX, so the port writes one
``<ckpt_dir>/ae_state.npz`` instead: the parameters under flax's leaf names
and layout (``params/enc_layers_0/kernel`` [in, out]), Adam's ``count``,
``mu`` and ``nu`` under the same names, ``step``, and the scaler when there
is one.  A directory holding only the reference's orbax ``ae_state/`` is
refused rather than retrained over.  The PCA checkpoint is the reference's
own plain ``pca_state.npz``, so either package restores the other's.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from audio_pattern_discovery_tpu_torch.config import AutoencoderConfig
from audio_pattern_discovery_tpu_torch.models.autoencoder import (
    AutoEncoder,
    FeatureScaler,
    TrainState,
    init_state,
    load_adam_state,
    params_from_flax,
    params_to_flax,
    state_of,
)
from audio_pattern_discovery_tpu_torch.models.pca import PCAState

_STATE_FILE = "ae_state.npz"
_REFERENCE_DIR = "ae_state"   # the JAX package's orbax checkpoint


def _flat(prefix: str, params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {f"{prefix}/{layer}/{leaf}": arr
            for layer, leaves in params_to_flax(params).items() for leaf, arr in leaves.items()}


def _tree(z, prefix: str) -> dict[str, dict[str, np.ndarray]]:
    tree: dict[str, dict[str, np.ndarray]] = {}
    for key in z.files:
        head, _, rest = key.partition("/")
        if head == prefix:
            layer, leaf = rest.split("/")
            tree.setdefault(layer, {})[leaf] = z[key]
    return tree


def save_ae_checkpoint(
    ckpt_dir: str | Path,
    state: TrainState,
    scaler: FeatureScaler | None = None,
) -> Path:
    """Persist the AE train state (+ feature scaler) under ``ckpt_dir``."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    arrays = {
        **_flat("params", state.params),
        **_flat("mu", state.opt_state["mu"]),
        **_flat("nu", state.opt_state["nu"]),
        "count": np.int64(state.opt_state["count"]),
        "step": np.int64(state.step),
    }
    if scaler is not None:
        arrays.update(scaler_mean=scaler.mean, scaler_std=scaler.std)
    path = d / _STATE_FILE
    np.savez(path, **arrays)
    return path


def has_ae_checkpoint(ckpt_dir: str | Path) -> bool:
    """True when ``ckpt_dir`` holds an AE checkpoint of either package (the
    reference's is refused by ``restore_ae_checkpoint``)."""
    d = Path(ckpt_dir)
    return (d / _STATE_FILE).is_file() or (d / _REFERENCE_DIR).is_dir()


def restore_ae_checkpoint(
    ckpt_dir: str | Path,
    cfg: AutoencoderConfig,
    input_dim: int,
    device: torch.device | str = "cuda",
) -> tuple[AutoEncoder, TrainState, FeatureScaler | None]:
    """Restore (model, state, scaler) saved by ``save_ae_checkpoint`` onto
    ``device``.  ``cfg``/``input_dim`` must match the saved run: the loaded
    parameters are shape-checked against the model they describe."""
    d = Path(ckpt_dir)
    if not (d / _STATE_FILE).is_file():
        if (d / _REFERENCE_DIR).is_dir():
            raise ValueError(
                f"{d / _REFERENCE_DIR} is an orbax checkpoint written by the JAX package "
                "(audio_pattern_discovery_tpu); this port reads only its own "
                f"{_STATE_FILE} and will not retrain over it: remove it or point "
                "autoencoder.checkpoint_dir elsewhere"
            )
        raise FileNotFoundError(f"no AE checkpoint under {d}")
    with np.load(d / _STATE_FILE) as z:
        try:
            model, _, tx = init_state(cfg, input_dim, device=device,
                                      params=params_from_flax(_tree(z, "params")))
        except RuntimeError as e:
            raise ValueError(f"{d / _STATE_FILE} does not match autoencoder config "
                             f"and input_dim={input_dim}: {e}") from None
        load_adam_state(model, tx, {"count": int(z["count"]),
                                    "mu": params_from_flax(_tree(z, "mu")),
                                    "nu": params_from_flax(_tree(z, "nu"))})
        step = int(z["step"])
        scaler = None
        if "scaler_mean" in z.files:
            scaler = FeatureScaler(np.asarray(z["scaler_mean"], np.float32),
                                   np.asarray(z["scaler_std"], np.float32))
    return model, state_of(model, tx, step), scaler


# ---------------------------------------------------------------- PCA
# The PCA embedder's "state" is four small arrays; the reference's plain
# .npz is the whole checkpoint, read and written here unchanged.

_PCA_FILE = "pca_state.npz"


def save_pca_checkpoint(ckpt_dir, state: PCAState, scaler: FeatureScaler) -> None:
    """Persist PCAState + FeatureScaler under ``ckpt_dir``."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    np.savez(
        d / _PCA_FILE,
        mean=state.mean,
        components=state.components,
        scale=state.scale,
        explained=state.explained,
        scaler_mean=scaler.mean,
        scaler_std=scaler.std,
    )


def has_pca_checkpoint(ckpt_dir) -> bool:
    return (Path(ckpt_dir) / _PCA_FILE).is_file()


def restore_pca_checkpoint(ckpt_dir) -> tuple[PCAState, FeatureScaler]:
    """-> (PCAState, FeatureScaler) saved by ``save_pca_checkpoint`` (or by
    the reference's)."""
    with np.load(Path(ckpt_dir) / _PCA_FILE) as z:
        state = PCAState(
            mean=z["mean"], components=z["components"],
            scale=z["scale"], explained=z["explained"],
        )
        scaler = FeatureScaler(z["scaler_mean"], z["scaler_std"])
    return state, scaler

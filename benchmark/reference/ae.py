"""Plain-PyTorch dense autoencoder, trained as the configuration states.

Written from the configuration alone: layers out_dim -> hidden... -> latent
-> ...hidden -> out_dim with the activation between layers; weights drawn
lecun-normal truncated to +-2 std (through the inverse CDF of a uniform
draw, in parameter order, from a CPU generator seeded with the AE's seed),
biases zero; the training pool padded up to a multiple of 4096 frames with
frames drawn from ``seed ^ 0x9E3779B9``; per-bin standardization; each epoch
a NumPy permutation of the pool (generator seeded with the AE's seed) in
minibatches; Adam (0.9, 0.999, 1e-8) on the mean squared reconstruction
error.  Float32 with TF32 off; ``dtype="bfloat16"`` (the control) casts
each layer's input, weight and bias to bfloat16, the loss in float32.
Imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_ACTS = {"relu": F.relu, "tanh": torch.tanh,
         "gelu": lambda x: F.gelu(x, approximate="tanh")}


def scaler(frames: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mean, std) per bin, std floored at 1e-6, as float32."""
    return (frames.mean(axis=0).astype(np.float32),
            np.maximum(frames.std(axis=0), 1e-6).astype(np.float32))


def init_layers(dims: list[int], gen: torch.Generator) -> list[list[torch.Tensor]]:
    """[[weight [out, in], bias [out]], ...] for consecutive ``dims``."""
    edge = math.erf(2.0 / math.sqrt(2.0))
    layers = []
    for fan_in, fan_out in zip(dims, dims[1:]):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w = torch.zeros(fan_out, fan_in).uniform_(-edge, edge, generator=gen).erfinv_()
        w.mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
        layers.append([w, torch.zeros(fan_out)])
    return layers


def mlp(h: torch.Tensor, layers, act, dtype=torch.float32) -> torch.Tensor:
    for i, (w, b) in enumerate(layers):
        h = F.linear(h.to(dtype), w.to(dtype), b.to(dtype))
        if i < len(layers) - 1:
            h = act(h)
    return h


def quantize_pool(frames: np.ndarray, seed: int) -> np.ndarray:
    n = frames.shape[0]
    if n < 4096 or n % 4096 == 0:
        return frames
    extra = np.random.default_rng(seed ^ 0x9E3779B9).integers(0, n, 4096 * -(-n // 4096) - n)
    return np.concatenate([frames, frames[extra]], axis=0)


def train(frames: np.ndarray, ae: dict, device, dtype: str = "float32") -> dict:
    """The AE trained on ``frames`` [N, dim] (already standardized):
    ``{"init", "final"}``, the leaves [enc weight, enc bias, ..., dec weight,
    dec bias, ...] before and after training; ``"enc"``, the trained
    encoder layers; ``"losses"``, each epoch's mean loss; ``"grad1"``, each
    leaf's gradient norm at the first step."""
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pool = quantize_pool(np.asarray(frames, np.float32), ae["seed"])
    n, dim = pool.shape
    enc_dims = [dim, *ae["hidden_dims"], ae["latent_dim"]]
    gen = torch.Generator().manual_seed(ae["seed"])
    layers = init_layers(enc_dims, gen) + init_layers(enc_dims[::-1], gen)
    params = [t.to(device).requires_grad_() for layer in layers for t in layer]
    init = [t.detach().clone() for t in params]
    n_enc = len(enc_dims) - 1
    enc = [params[2 * i:2 * i + 2] for i in range(n_enc)]
    dec = [params[2 * i:2 * i + 2] for i in range(n_enc, len(layers))]
    opt = torch.optim.Adam(params, lr=ae["learning_rate"], betas=(0.9, 0.999), eps=1e-8)
    act = _ACTS[ae["activation"]]
    bs = min(ae["batch_size"], n)
    n_batches = max(1, n // bs)
    pool_dev = torch.from_numpy(pool).to(device)
    rng = np.random.default_rng(ae["seed"])
    losses, grad1 = [], None
    for _ in range(ae["epochs"]):
        perm = rng.permutation(n)[: n_batches * bs].reshape(n_batches, bs)
        step = []
        for idx in torch.from_numpy(perm).to(device):
            batch = pool_dev[idx]
            opt.zero_grad(set_to_none=True)
            loss = torch.mean((mlp(mlp(batch, enc, act, dt), dec, act, dt).float() - batch) ** 2)
            loss.backward()
            if grad1 is None:
                grad1 = [float(t.grad.norm()) for t in params]
            opt.step()
            step.append(loss.detach())
        losses.append(float(torch.stack(step).mean()))
    final = [t.detach() for t in params]
    return {"init": init, "final": final, "enc": [final[2 * i:2 * i + 2] for i in range(n_enc)],
            "losses": losses, "grad1": grad1 or [0.0] * len(params)}


def encode(frames: torch.Tensor, enc, activation: str, dtype: str = "float32") -> torch.Tensor:
    """Latents [..., latent] (float32) of ``frames`` [..., dim] (already
    standardized) through the encoder layers ``enc``."""
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    with torch.no_grad():
        return mlp(frames.float(), enc, _ACTS[activation], dt).float()

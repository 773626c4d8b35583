"""Dense (optionally denoising) autoencoder over spectrogram frames, and the
feature scaler of the embedders.

Port of ``audio_pattern_discovery_tpu/models/autoencoder.py``: the encoder's
output is the per-frame latent embedding that DTW runs over.  The reference
computes the model with flax ``Dense`` layers (XLA matmuls, no Pallas kernel)
and trains it with optax; the port uses ``torch.nn.Linear`` and
``torch.optim.Adam`` with the same defaults:

* kernels drawn lecun-normal (a normal truncated to +-2 std), biases zero;
  drawn on the CPU from a ``torch.Generator`` seeded with ``cfg.seed`` and
  then moved to the device, so the card and the CPU start from the same bits
  (not JAX's: ``params_from_flax`` carries those across);
* ``dtype="bfloat16"`` computes each layer in bf16 from fp32 parameters, as
  ``Dense(dtype=bf16)`` does; the loss stays fp32;
* gelu is flax's tanh approximation, not torch's erf default;
* Adam with optax's ``b1=0.9, b2=0.999, eps=1e-8``;
* the minibatches are the reference's: the same NumPy permutation of the
  same (quantized) pool every epoch, gathered from frames resident on the
  device;
* over a mesh (``parallel/mesh.py``), the reference's data and model axes:
  each data slot runs forward and backward on its share of the minibatch
  with its own copy of the parameters, the gradients are summed on the
  primary device (weighted so that the loss is the global batch mean) and
  Adam steps once there; with ``param_shardings`` each layer's output
  columns are split over the slot's model devices and its activations
  gathered on the slot's first device before the next layer.  The sums run
  in another order than on one device, so a mesh run agrees with one device
  to rounding, not bit for bit.

The port's ``TrainState`` keeps the parameters under torch's names
(``enc_layers.0.weight`` [out, in]); the checkpoint (utils/checkpoint.py)
stores them under flax's leaf names and layout.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
from dataclasses import dataclass
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from audio_pattern_discovery_tpu_torch.config import AutoencoderConfig
from audio_pattern_discovery_tpu_torch.ops.scaler_stats import scaler_stats
from audio_pattern_discovery_tpu_torch.utils.device import resolve_device
from audio_pattern_discovery_tpu_torch.utils.logging import FIRST_USE, StageCounters
from audio_pattern_discovery_tpu_torch.utils.profiling import annotate

_ACTS = {"relu": F.relu, "tanh": torch.tanh, "gelu": partial(F.gelu, approximate="tanh")}

# optax.adam's defaults.
ADAM_BETAS, ADAM_EPS = (0.9, 0.999), 1e-8


@dataclass
class FeatureScaler:
    """Per-bin standardization fitted on the corpus; applied before encode."""

    mean: np.ndarray   # [dim]
    std: np.ndarray    # [dim]

    @classmethod
    def fit(cls, frames: np.ndarray | torch.Tensor) -> "FeatureScaler":
        """Per-bin mean and population std (floored at 1e-6) of [N, dim]
        frames, in two passes (the mean, then the mean of the centred
        squares).  A CUDA tensor reduces on its card
        (``ops/scaler_stats.py``), bit for bit as NumPy does; NumPy arrays
        and CPU tensors reduce on the host.  Either way the statistics come
        back as float32 NumPy arrays."""
        if isinstance(frames, torch.Tensor):
            if frames.device.type == "cuda":
                mean, std = scaler_stats(frames.float().contiguous()).cpu().numpy()
                return cls(mean, std)
            frames = frames.numpy()
        mean = frames.mean(axis=0)
        std = np.maximum(frames.std(axis=0), 1e-6)
        return cls(mean.astype(np.float32), std.astype(np.float32))

    def transform(self, frames):
        """NumPy arrays stay on the host; tensors are standardized on their
        own device."""
        if isinstance(frames, torch.Tensor):
            mean = torch.from_numpy(self.mean).to(frames.device)
            std = torch.from_numpy(self.std).to(frames.device)
            return (frames - mean) / std
        return (frames - self.mean) / self.std

    def transform_(self, frames: torch.Tensor) -> torch.Tensor:
        """``transform`` of a float32 tensor in place, on its own device:
        each element still (x - mean) / std in fp32, with no temporaries the
        size of ``frames``."""
        mean = torch.from_numpy(self.mean).to(frames.device)
        std = torch.from_numpy(self.std).to(frames.device)
        return frames.sub_(mean).div_(std)


def _mlp(h: torch.Tensor, layers, act, dtype: torch.dtype) -> torch.Tensor:
    """Dense layers ``[(weight, bias), ...]`` with ``act`` between them; each
    casts its input, weight and bias to ``dtype`` (flax ``Dense(dtype=...)``)."""
    for i, (w, b) in enumerate(layers):
        h = F.linear(h.to(dtype), w.to(dtype), b.to(dtype))
        if i < len(layers) - 1:
            h = act(h)
    return h


class AutoEncoder(nn.Module):
    """MLP encoder/decoder; bottleneck = latent_dim."""

    def __init__(self, hidden_dims: tuple[int, ...], latent_dim: int, out_dim: int,
                 activation: str = "relu", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.latent_dim, self.out_dim, self.dtype = latent_dim, out_dim, dtype
        self.act = _ACTS[activation]
        enc = (out_dim, *hidden_dims, latent_dim)
        dec = (latent_dim, *reversed(hidden_dims), out_dim)
        self.enc_layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(enc, enc[1:]))
        self.dec_layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dec, dec[1:]))

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return _mlp(x, [(m.weight, m.bias) for m in self.enc_layers], self.act, self.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return _mlp(z, [(m.weight, m.bias) for m in self.dec_layers], self.act, self.dtype)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        z = self.encode(x)
        return self.decode(z), z


@dataclass
class TrainState:
    params: dict[str, torch.Tensor]   # the model's state dict (torch names)
    opt_state: dict                   # Adam: {"count": int, "mu": {name: t}, "nu": {name: t}}
    step: int


def create_model(cfg: AutoencoderConfig, input_dim: int) -> AutoEncoder:
    """The model on the CPU, its parameters not yet initialized
    (``init_state`` sets them); building it leaves torch's global generator
    as it was."""
    with torch.random.fork_rng(devices=[]):
        return AutoEncoder(
            hidden_dims=cfg.hidden_dims,
            latent_dim=cfg.latent_dim,
            out_dim=input_dim,
            activation=cfg.activation,
            dtype=torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32,
        )


def init_params(model: AutoEncoder, seed: int) -> dict[str, torch.Tensor]:
    """flax ``Dense``'s default init on the CPU: each weight lecun-normal
    (std ``sqrt(1/fan_in) / 0.8796...``, truncated to +-2 std through the
    inverse CDF of a uniform draw, as ``jax.random.truncated_normal`` draws
    it), each bias zero, drawn in parameter order from a generator seeded
    with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    edge = math.erf(2.0 / math.sqrt(2.0))           # 1 - 2 Phi(-2)
    params = {}
    for name, p in model.named_parameters():
        t = torch.zeros(p.shape)
        if name.endswith("weight"):
            std = math.sqrt(1.0 / p.shape[1]) / 0.87962566103423978
            t.uniform_(-edge, edge, generator=g).erfinv_()
            t.mul_(std * math.sqrt(2.0)).clamp_(-2.0 * std, 2.0 * std)
        params[name] = t
    return params


def state_of(model: AutoEncoder, tx: torch.optim.Adam, step: int) -> TrainState:
    """TrainState over the live parameters and Adam moments (no copies)."""
    named = list(model.named_parameters())
    count = int(tx.state[named[0][1]]["step"])
    return TrainState(
        model.state_dict(),
        {"count": count,
         "mu": {n: tx.state[p]["exp_avg"] for n, p in named},
         "nu": {n: tx.state[p]["exp_avg_sq"] for n, p in named}},
        step,
    )


def load_adam_state(model: AutoEncoder, tx: torch.optim.Adam, opt_state: dict) -> None:
    """Set ``tx``'s moments and count from ``{"count", "mu", "nu"}``."""
    for name, p in model.named_parameters():
        tx.state[p] = {
            "step": torch.tensor(float(opt_state["count"])),
            "exp_avg": opt_state["mu"][name].to(p.device, torch.float32).clone(),
            "exp_avg_sq": opt_state["nu"][name].to(p.device, torch.float32).clone(),
        }


def init_state(
    cfg: AutoencoderConfig,
    input_dim: int,
    device: torch.device | str = "cuda",
    params: dict[str, torch.Tensor] | None = None,
) -> tuple[AutoEncoder, TrainState, torch.optim.Adam]:
    """(model, state, optimizer) on ``device`` (the card unless the caller
    asks for the CPU; no card raises), from ``params`` (a state dict, shape
    checked against ``cfg`` and ``input_dim``) or else ``init_params``;
    Adam's moments zero, as ``optax.adam().init`` gives them."""
    device = resolve_device(device)
    model = create_model(cfg, input_dim)
    model.load_state_dict(init_params(model, cfg.seed) if params is None else params)
    model.to(device)
    # The process's first optimizer imports torch._dynamo (torch.optim's
    # add_param_group is wrapped by torch._disable_dynamo): seconds, once.
    with FIRST_USE.first_use("optimizer_first_use"):
        tx = torch.optim.Adam(model.parameters(), lr=cfg.learning_rate, betas=ADAM_BETAS,
                              eps=ADAM_EPS)
    zeros = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    load_adam_state(model, tx, {"count": 0, "mu": zeros, "nu": zeros})
    return model, state_of(model, tx, 0), tx


def train_step(model: AutoEncoder, tx: torch.optim.Adam, batch: torch.Tensor,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """One Adam step on the reconstruction loss of ``batch`` [B, dim] from
    ``batch + noise`` (the denoising input; ``noise`` already scaled by
    ``denoising_std``).  Returns the loss as a 0-d tensor on the device (no
    sync)."""
    noisy = batch if noise is None else batch + noise
    tx.zero_grad(set_to_none=True)
    recon, _ = model(noisy)
    loss = torch.mean((recon.float() - batch) ** 2)
    loss.backward()
    tx.step()
    return loss.detach()


_POOL_GRID = 4096


def _quantize_pool(frames: np.ndarray, seed: int) -> np.ndarray:
    """Pad a >= 4096-frame training pool UP to the next 4096 multiple with
    repeated random frames, exactly as the reference does (there, to keep
    its compiled shapes recurring across corpora).  The port keeps it so
    that it trains on the reference's pool and minibatches: pools under 4096
    frames pass through untouched."""
    n = frames.shape[0]
    if n < _POOL_GRID or n % _POOL_GRID == 0:
        return frames
    n_q = _POOL_GRID * -(-n // _POOL_GRID)
    extra = np.random.default_rng(seed ^ 0x9E3779B9).integers(0, n, n_q - n)
    return np.concatenate([frames, frames[extra]], axis=0)


def _mesh_mlp(h: torch.Tensor, layers, act, dtype: torch.dtype, row) -> torch.Tensor:
    """``_mlp`` over one data slot's model devices ``row``: each layer
    ``(weights, biases)`` is a list of pieces of its output columns, piece m
    on ``row[m]``; each piece's output comes back to ``row[0]``, where the
    next layer reads the whole activation."""
    dev0 = row[0]
    for i, (ws, bs) in enumerate(layers):
        if len(ws) == 1:
            h = F.linear(h.to(dtype), ws[0].to(dtype), bs[0].to(dtype))
        else:
            h = torch.cat([
                F.linear(h.to(dev, dtype), w.to(dtype), b.to(dtype)).to(dev0)
                for w, b, dev in zip(ws, bs, row)
            ], dim=-1)
        if i < len(layers) - 1:
            h = act(h)
    return h


def _slot_params(params: dict[str, torch.Tensor], specs, row) -> dict[str, list[torch.Tensor]]:
    """Leaf copies of ``params`` for one data slot: each a list of pieces
    over the slot's model devices ``row`` (``split_over`` by its sharding in
    ``specs``; whole on ``row[0]`` without one), each requiring grad."""
    from audio_pattern_discovery_tpu_torch.parallel.mesh import split_over

    out = {}
    for name, p in params.items():
        if specs is None:
            parts = [p.detach().to(row[0])]
        else:
            parts = split_over(p.detach(), specs[name], 0, list(row))
        out[name] = [t.detach().requires_grad_() for t in parts]
    return out


def _mesh_step(model: AutoEncoder, tx: torch.optim.Adam, rows, specs, batch: torch.Tensor,
               noisy: torch.Tensor) -> torch.Tensor:
    """One Adam step over the data slots ``rows`` (each a row of model
    devices): slot r takes rows r of ``torch.tensor_split(batch, len(rows))``
    with its own copy of the parameters, and its loss is its squared error
    over the whole batch's element count, so the slots' losses sum to the
    global mean and their gradients to its gradient.  The gradients are
    summed on the primary device in slot order and Adam steps there.
    Returns the loss as a 0-d tensor on the primary device."""
    named = list(model.named_parameters())
    primary = named[0][1].device
    n_el = batch.numel()
    grads: dict[str, torch.Tensor] = {}
    loss = None
    n_enc = len(model.enc_layers)
    for r, (x, y) in enumerate(zip(torch.tensor_split(noisy, len(rows)),
                                   torch.tensor_split(batch, len(rows)))):
        row = list(rows[r])
        leaves = _slot_params({n: p for n, p in named}, specs, row)

        def layers(side, count):
            return [(leaves[f"{side}.{i}.weight"], leaves[f"{side}.{i}.bias"])
                    for i in range(count)]

        z = _mesh_mlp(x.to(row[0]), layers("enc_layers", n_enc), model.act, model.dtype, row)
        recon = _mesh_mlp(z, layers("dec_layers", len(model.dec_layers)), model.act, model.dtype,
                          row)
        part = torch.sum((recon.float() - y.to(row[0])) ** 2) / n_el
        flat = [t for n, _ in named for t in leaves[n]]
        gs = iter(torch.autograd.grad(part, flat))
        for n, _ in named:
            g = torch.cat([next(gs).to(primary) for _ in leaves[n]])
            grads[n] = g if n not in grads else grads[n] + g
        part = part.detach().to(primary)
        loss = part if loss is None else loss + part
    for n, p in named:
        p.grad = grads[n]
    tx.step()
    return loss


def train_autoencoder(
    frames: np.ndarray,            # [N, dim] standardized training frames
    cfg: AutoencoderConfig,
    log_every: int = 5,
    logger=None,
    sync_losses: bool = True,
    device: torch.device | str = "cuda",
    data_sharding=None,
    param_shardings=None,
    counters: StageCounters | None = None,
) -> tuple[AutoEncoder, TrainState, list]:
    """Train on spectrogram frames on ``device``; returns (model, state,
    per-epoch losses), each epoch's loss the mean of its steps' losses.

    The frames stay resident on the device and each minibatch is gathered
    there by an index tensor.  The host waits on the device only to log
    (every ``log_every`` epochs when a logger is given) and, with
    ``sync_losses``, once at the end; ``sync_losses=False`` returns the
    losses as 0-d device tensors, so the caller can overlap training with
    other work (pipeline.discover's two-phase corpus).

    ``data_sharding`` (``parallel.mesh.data_sharding``): data parallel over
    the mesh's data axis, on its first device (``device`` is then ignored).
    The minibatch is cut to a multiple of the mesh's size,
    ``max(size, bs - bs % size)``, as the reference cuts it, and a pool of
    fewer frames than that runs on the first data slot alone.  The
    denoising noise is drawn for the whole minibatch on the first device
    before it is split, so a seed gives the batches and noise of one
    device.  ``param_shardings``: a callable from the parameters to their
    layout (``parallel.mesh.ae_param_sharding``): each layer's output
    columns over the model axis.  The returned parameters are the whole
    ones, on the first device.

    ``counters``: the steps' host seconds go to
    ``timings_s["autoencoder_train.steps"]``, from the first step's enqueue
    to the losses on the host (with ``sync_losses=False``, to the last
    enqueue: ``"autoencoder_train.steps_enqueued"``), and their number
    (epochs x batches) to ``counts["ae_steps"]``.  Under a profiler each
    step is a range ``apd.ae.step``."""
    rows = None
    if data_sharding is not None:
        grid = data_sharding.mesh.devices
        device = grid.flat[0]
    device = resolve_device(device)
    frames = _quantize_pool(np.asarray(frames), cfg.seed)
    n, dim = frames.shape
    model, _, tx = init_state(cfg, dim, device=device)
    bs = min(cfg.batch_size, n)
    specs = None
    if data_sharding is not None:
        n_shards = grid.size
        if n < n_shards:
            # Too few frames to shard: the first data slot alone.
            rows = grid[:1]
        else:
            rows = grid
            bs = max(n_shards, bs - bs % n_shards)
        if param_shardings is not None:
            specs = param_shardings(dict(model.named_parameters()))
    n_batches = max(1, n // bs)
    frames_dev = torch.from_numpy(np.ascontiguousarray(frames, np.float32)).to(device)
    noise_gen = None
    if cfg.denoising_std > 0.0:
        noise_gen = torch.Generator(device=device).manual_seed(cfg.seed)

    shuffle_rng = np.random.default_rng(cfg.seed)
    loss_futs: list[torch.Tensor] = []
    steps = nullcontext()
    if counters is not None:
        counters.add("ae_steps", cfg.epochs * n_batches)
        steps = counters.time_stage(
            "autoencoder_train.steps" if sync_losses else "autoencoder_train.steps_enqueued")
    with steps:
        for epoch in range(cfg.epochs):
            perm = shuffle_rng.permutation(n)[: n_batches * bs].reshape(n_batches, bs)
            step_losses = []
            for idx in torch.from_numpy(perm).to(device):
                with annotate("apd.ae.step"):
                    batch = frames_dev[idx]
                    noise = None
                    if noise_gen is not None:
                        noise = cfg.denoising_std * torch.randn(
                            batch.shape, generator=noise_gen, device=device)
                    if rows is None:
                        step_losses.append(train_step(model, tx, batch, noise))
                    else:
                        noisy = batch if noise is None else batch + noise
                        step_losses.append(_mesh_step(model, tx, rows, specs, batch, noisy))
            epoch_loss = torch.stack(step_losses).mean()
            if log_every and logger and (epoch + 1) % log_every == 0:
                # Sync only when asked to log; otherwise epochs stay in flight.
                logger.info(f"AE epoch {epoch + 1}/{cfg.epochs} loss={float(epoch_loss):.5f}")
            loss_futs.append(epoch_loss)
        losses = torch.stack(loss_futs).tolist() if sync_losses and loss_futs else loss_futs
    return model, state_of(model, tx, cfg.epochs * n_batches), losses


def _params_device_span(params) -> set[torch.device]:
    """The devices the parameters' leaves lie on (a leaf placed over a
    mesh's model axis is a list of pieces on their devices).  No entry
    point of the port makes such pieces: ``train_autoencoder`` returns its
    parameters whole on the first device.  A caller that places them
    itself, as the reference's sharded parameters are placed, reads and
    encodes them through this, ``_gathered`` and ``params_to_flax``."""
    span: set[torch.device] = set()
    for leaf in params.values():
        span |= {t.device for t in (leaf if isinstance(leaf, (list, tuple)) else [leaf])}
    return span


def _gathered(leaf, dev: torch.device) -> torch.Tensor:
    """A leaf whole on ``dev``: its pieces (a list, split on dimension 0)
    concatenated there."""
    if isinstance(leaf, (list, tuple)):
        return torch.cat([t.to(dev) for t in leaf])
    return leaf.to(dev)


def encode_frames(
    model: AutoEncoder,
    params: dict[str, torch.Tensor],
    frames: np.ndarray | torch.Tensor,
    chunk: int = 1 << 16,
) -> torch.Tensor:
    """Encode [..., dim] frames -> latent [..., latent] float32, through the
    encoder layers of ``params`` (a state dict) on their device, ``chunk``
    rows at a time.  Parameters placed over several devices (leaves, or
    pieces of leaves, on different devices; ``_params_device_span``) are
    gathered on the device of the first layer's weight (its first piece).
    The result lies on the input's device (the CPU for a NumPy array), so a
    tensor on the card stays there."""
    out_device = frames.device if isinstance(frames, torch.Tensor) else torch.device("cpu")
    x = torch.as_tensor(frames)
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    if flat.shape[0] == 0:
        return torch.zeros((*lead, model.latent_dim), dtype=torch.float32, device=out_device)
    first = params["enc_layers.0.weight"]
    dev = (first[0] if isinstance(first, (list, tuple)) else first).device
    layers = [(_gathered(params[f"enc_layers.{i}.weight"], dev),
               _gathered(params[f"enc_layers.{i}.bias"], dev))
              for i in range(len(model.enc_layers))]
    with torch.no_grad():
        z = torch.cat([
            _mlp(flat[s:s + chunk].to(dev, torch.float32), layers, model.act, model.dtype).float()
            for s in range(0, flat.shape[0], chunk)
        ])
    return z.reshape(*lead, -1).to(out_device)


def params_from_flax(params) -> dict[str, torch.Tensor]:
    """The port's state dict from a flax ``AutoEncoder``'s parameter tree of
    NumPy arrays (``{"params": {"enc_layers_0": {"kernel", "bias"}, ...}}``,
    the outer key optional): kernel [in, out] -> weight [out, in]."""
    tree = params.get("params", params)
    out = {}
    for layer, leaves in tree.items():
        side, _, i = layer.rpartition("_")
        out[f"{side}.{i}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(leaves["kernel"], np.float32).T))
        out[f"{side}.{i}.bias"] = torch.from_numpy(np.array(leaves["bias"], np.float32))
    return out


def params_to_flax(params: dict[str, torch.Tensor]) -> dict[str, dict[str, np.ndarray]]:
    """Inverse of ``params_from_flax``: flax leaf names and layout, on the
    host.  A leaf placed over a mesh's model axis (a list of pieces) is
    gathered whole."""
    tree: dict[str, dict[str, np.ndarray]] = {}
    for name, t in params.items():
        side, i, kind = name.split(".")
        arr = _gathered(t, torch.device("cpu")).detach().numpy()
        tree.setdefault(f"{side}_{i}", {})["kernel" if kind == "weight" else "bias"] = (
            np.ascontiguousarray(arr.T) if kind == "weight" else arr)
    return tree


def adam_state_from_optax(opt_state) -> dict:
    """The port's Adam state ``{"count", "mu", "nu"}`` from ``optax.adam``'s
    state as NumPy arrays: ``(ScaleByAdamState(count, mu, nu), EmptyState())``."""
    adam = opt_state[0]
    return {"count": int(adam.count), "mu": params_from_flax(adam.mu),
            "nu": params_from_flax(adam.nu)}

"""The port's autoencoder against the JAX reference on the CPU.

JAX's parameters (and, for one denoising step, JAX's noise) are carried
across with ``params_from_flax`` / ``adam_state_from_optax``, so both
packages start from the same bits.  Tolerances:
- encode, fp32: rtol 1e-5 / atol 1e-6 (the same fp32 products summed in
  another order); bf16: rtol 2e-2 / atol 2e-2 (a bf16 ulp is 2^-8 relative;
  each layer rounds its product and activation to bf16, and the two
  backends may round a product's accumulator differently);
- one train step: the loss to rtol 1e-6, each parameter and Adam moment to
  1e-5 of its leaf's largest magnitude (one fp32 gradient, reduced in
  another order, through the same Adam formula);
- ``train_autoencoder`` over 5 epochs: see that test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu.config import AutoencoderConfig as JCfg
from audio_pattern_discovery_tpu.models import autoencoder as jae
from audio_pattern_discovery_tpu_torch.config import AutoencoderConfig
from audio_pattern_discovery_tpu_torch.models import autoencoder as tae

torch.set_num_threads(1)


def _toy_frames(rng, n=2048, dim=32, rank=4):
    """Low-rank data the AE can compress losslessly-ish."""
    basis = rng.normal(0, 1, (rank, dim))
    coeff = rng.normal(0, 1, (n, rank))
    return (coeff @ basis).astype(np.float32)


def _jax_init(jcfg, dim, key):
    model, state, tx = jae.init_state(jcfg, dim, key)
    return model, state, tx, jax.device_get(state.params)


def _carry_jax_init(monkeypatch, jcfg, dim):
    """The port's init replaced by JAX's own initial parameters for this
    config: ``init_state(cfg, dim, split(PRNGKey(seed))[1])``, as the
    reference's ``train_autoencoder`` draws them."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    carried = tae.params_from_flax(_jax_init(jcfg, dim, init_rng)[3])
    real = tae.init_state
    monkeypatch.setattr(
        tae, "init_state",
        lambda cfg, d, device="cuda", params=None:
            real(cfg, d, device=device, params=carried if params is None else params))


def _close_leaves(got: dict, want: dict, rel: float) -> None:
    assert got.keys() == want.keys()
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()), 1e-30), err_msg=name)


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-5, 1e-6),
                                             ("bfloat16", 2e-2, 2e-2)])
@pytest.mark.parametrize("activation", ["relu", "tanh", "gelu"])
def test_encode_matches_jax(activation, dtype, rtol, atol):
    # gelu: flax's default is the tanh approximation; torch's exact erf
    # form differs by up to ~1e-3 and fails the fp32 tolerance.
    kw = dict(latent_dim=4, hidden_dims=(24, 16), activation=activation, dtype=dtype)
    model, state, _, jparams = _jax_init(JCfg(**kw), 20, jax.random.PRNGKey(3))
    tmodel, tstate, _ = tae.init_state(AutoencoderConfig(**kw), 20, device="cpu",
                                       params=tae.params_from_flax(jparams))
    x = np.random.default_rng(3).normal(0, 1.5, (6, 50, 20)).astype(np.float32)
    want = jae.encode_frames(model, state.params, x)
    got = tae.encode_frames(tmodel, tstate.params, x)
    assert got.dtype == torch.float32 and got.shape == (6, 50, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=atol)
    # A tensor input gives the same as the NumPy array, chunked or not.
    np.testing.assert_array_equal(
        tae.encode_frames(tmodel, tstate.params, torch.from_numpy(x), chunk=64).numpy(),
        got.numpy())


@pytest.mark.parametrize("denoising_std", [0.0, 0.3])
def test_train_step_matches_jax(denoising_std):
    kw = dict(latent_dim=4, hidden_dims=(24, 16), learning_rate=3e-3)
    jcfg = JCfg(**kw, denoising_std=denoising_std)
    model, state, tx, jparams = _jax_init(jcfg, 20, jax.random.PRNGKey(5))
    batch = _toy_frames(np.random.default_rng(5), n=128, dim=20)
    key = jax.random.PRNGKey(9)
    step = jae.make_train_step(model, tx, denoising_std)
    p1, o1, loss = step(state.params, state.opt_state, jnp.asarray(batch), key)
    # JAX's own noise, as its step draws it from the same key.
    noise = None
    if denoising_std > 0:
        noise = torch.from_numpy(np.array(denoising_std * jax.random.normal(key, batch.shape)))

    tmodel, _, ttx = tae.init_state(AutoencoderConfig(**kw), 20, device="cpu",
                                    params=tae.params_from_flax(jparams))
    tloss = tae.train_step(tmodel, ttx, torch.from_numpy(batch), noise)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    got = tae.state_of(tmodel, ttx, 1)
    want = tae.adam_state_from_optax(jax.device_get(o1))
    assert got.opt_state["count"] == want["count"] == 1
    _close_leaves(got.params, tae.params_from_flax(jax.device_get(p1)), 1e-5)
    _close_leaves(got.opt_state["mu"], want["mu"], 1e-5)
    _close_leaves(got.opt_state["nu"], want["nu"], 1e-5)


def test_train_autoencoder_matches_jax(monkeypatch):
    # 4100 frames: just over the 4096 grid, so _quantize_pool pads the pool
    # to 8192 and both packages train 8 minibatches a run on the same pool.
    # Tolerance: per-epoch losses to rtol 1e-5 and final parameters to
    # 5e-3 of each leaf's largest magnitude, ~5x what this run measures
    # (1.3e-6 and 1.1e-3; after 1 epoch 2e-7 and 8e-6).  Adam turns a
    # gradient difference of a few ulps into an update difference of up to
    # lr where a gradient element is near 0, so the two runs drift apart
    # step by step, as the JAX package's own runs on 1 and on 8 devices do.
    frames = _toy_frames(np.random.default_rng(11), n=4100, dim=24)
    kw = dict(latent_dim=4, hidden_dims=(32, 16), epochs=5, batch_size=1024)
    jcfg, cfg = JCfg(**kw), AutoencoderConfig(**kw)
    _, jstate, jlosses = jae.train_autoencoder(frames, jcfg)
    _carry_jax_init(monkeypatch, jcfg, 24)
    _, state, losses = tae.train_autoencoder(frames, cfg, device="cpu")
    assert state.step == jstate.step == 5 * 8
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _close_leaves(state.params, tae.params_from_flax(jax.device_get(jstate.params)), 5e-3)


def test_quantize_pool_matches_reference():
    # The cases of tests/test_autoencoder.py::test_pool_quantization_grid.
    rng = np.random.default_rng(0)
    for n in (4095, 8192, 5000):
        x = rng.normal(0, 1, (n, 8)).astype(np.float32)
        got, want = tae._quantize_pool(x, seed=3), jae._quantize_pool(x, seed=3)
        assert got.dtype == want.dtype and (got is x) == (want is x)
        np.testing.assert_array_equal(got, want)
    assert tae._POOL_GRID == jae._POOL_GRID == 4096


def test_init_statistics():
    # flax Dense's lecun_normal: |w| <= 2 sigma and std sqrt(1/fan_in)
    # (the 0.8796 factor undoes the truncation's shrinkage); within 2 % on
    # 131,328 samples (the estimate's own spread is ~0.2 %); biases zero.
    model = tae.create_model(AutoencoderConfig(), 513)
    params = tae.init_params(model, seed=0)
    w = params["enc_layers.0.weight"]
    assert w.shape == (256, 513)
    sigma = np.sqrt(1.0 / 513) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * sigma
    assert abs(float(w.std()) / np.sqrt(1.0 / 513) - 1.0) < 0.02
    assert all(float(p.abs().max()) == 0.0 for n, p in params.items() if n.endswith("bias"))
    torch.manual_seed(1)
    before = torch.rand(1)
    torch.manual_seed(1)
    _, state, _ = tae.init_state(AutoencoderConfig(), 513, device="cpu")
    assert torch.equal(torch.rand(1), before)   # the global generator is untouched
    for name in params:
        assert torch.equal(state.params[name], params[name])


def test_training_reduces_loss(rng):
    frames = _toy_frames(rng)
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(32,), epochs=20, batch_size=256,
                            learning_rate=1e-2)
    _, _, losses = tae.train_autoencoder(frames, cfg, device="cpu")
    assert losses[-1] < 0.5 * losses[0]
    assert losses[-1] < 0.2  # low-rank data must compress well


def test_encode_shapes(rng):
    frames = _toy_frames(rng, n=512)
    cfg = AutoencoderConfig(latent_dim=6, hidden_dims=(16,), epochs=2, batch_size=128)
    model, state, _ = tae.train_autoencoder(frames, cfg, device="cpu")
    z = tae.encode_frames(model, state.params, frames)
    assert z.shape == (512, 6) and z.dtype == torch.float32
    z3 = tae.encode_frames(model, state.params, frames.reshape(8, 64, 32))
    assert z3.shape == (8, 64, 6)
    np.testing.assert_allclose(z3.reshape(512, 6).numpy(), z.numpy(), rtol=1e-5, atol=1e-5)


def test_determinism(rng):
    frames = _toy_frames(rng, n=512)
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(16,), epochs=3, batch_size=128,
                            denoising_std=0.2)
    _, s1, l1 = tae.train_autoencoder(frames, cfg, device="cpu")
    _, s2, l2 = tae.train_autoencoder(frames, cfg, device="cpu")
    assert l1 == l2
    for name in s1.params:
        assert torch.equal(s1.params[name], s2.params[name])


def test_denoising_mode_trains(rng):
    frames = _toy_frames(rng, n=512)
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(16,), epochs=5, batch_size=128,
                            denoising_std=0.3)
    _, _, losses = tae.train_autoencoder(frames, cfg, device="cpu")
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_encode_frames_empty_input():
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(8,))
    model, state, _ = tae.init_state(cfg, 16, device="cpu")
    out = tae.encode_frames(model, state.params, np.zeros((0, 16), np.float32))
    assert out.shape == (0, 4) and out.dtype == torch.float32
    assert tae.encode_frames(model, state.params, torch.zeros(3, 0, 16)).shape == (3, 0, 4)


def test_train_fewer_frames_than_a_batch(rng):
    frames = rng.normal(0, 1, (5, 12)).astype(np.float32)
    cfg = AutoencoderConfig(latent_dim=3, hidden_dims=(8,), epochs=2)
    _, state, losses = tae.train_autoencoder(frames, cfg, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert state.step == 2    # one minibatch of all 5 frames an epoch


def test_sync_losses_false_returns_device_tensors(rng):
    frames = _toy_frames(rng, n=256)
    cfg = AutoencoderConfig(latent_dim=4, hidden_dims=(16,), epochs=3, batch_size=64)
    _, _, synced = tae.train_autoencoder(frames, cfg, device="cpu")
    _, _, futs = tae.train_autoencoder(frames, cfg, sync_losses=False, device="cpu")
    assert all(isinstance(x, torch.Tensor) and x.ndim == 0 for x in futs)
    assert [float(x) for x in futs] == synced


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = AutoencoderConfig(latent_dim=3, hidden_dims=(8,), epochs=1)
    frames = np.zeros((16, 12), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tae.train_autoencoder(frames, cfg)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tae.init_state(cfg, 12, device="cuda")

"""The port's multi-device layer (parallel/mesh.py, parallel/wavefront.py,
the schedulers', the spectrogram's and the AE's device lists) against the
JAX package's on its 8 virtual CPU devices.

The port's stand-in for a mesh of cards is a list that repeats the CPU
(``[cpu] * n``): the multi-device code runs as it does over cards, each
slot its own copies, chunks and halos.  Tolerances:
- schedulers, spectrogram, wavefront and K8 stepped by ranges of diagonals:
  bit for bit the port on one device (the same twins on the same inputs);
- schedulers against JAX's multi-device D: rtol = atol = 1e-6 on
  path_len-normalized distances (the same DP in fp32, JAX's costs from a
  Gram expansion, the port's from squared differences); the wavefront
  against JAX's: rtol = atol = 1e-5, the reference's own tolerance
  against its one-device blocked DTW (unnormalized sums of hundreds of
  costs);
- the AE on a 4x2 mesh from JAX's initial parameters: losses to rtol 1e-5
  and parameters to 5e-3 of each leaf's largest magnitude against JAX's
  mesh run (the one-device test's tolerances, tests/test_torch_autoencoder.py),
  and losses to rtol 1e-5 and parameters to 1e-4 of each leaf's largest
  magnitude against the port on one device (the same steps, the gradient
  summed over the slots in another order; this run reads 6e-8 and 2.4e-7);
- ``discover()`` over four slots with a model axis: the partition of one
  device exactly, D within the AE's drift (``AE_D_ATOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from audio_pattern_discovery_tpu.config import AutoencoderConfig as JAECfg
from audio_pattern_discovery_tpu.config import DTWConfig as JCfg
from audio_pattern_discovery_tpu.config import ParallelConfig as JPar
from audio_pattern_discovery_tpu.models import autoencoder as jae
from audio_pattern_discovery_tpu.parallel import mesh as jmesh
from audio_pattern_discovery_tpu.parallel import pair_scheduler as jps
from audio_pattern_discovery_tpu_torch.config import (
    AutoencoderConfig,
    DTWConfig,
    ParallelConfig,
    PipelineConfig,
    SpectrogramConfig,
)
from audio_pattern_discovery_tpu_torch.models import autoencoder as tae
from audio_pattern_discovery_tpu_torch.ops.dtw_long import LongStripe, dtw_long_batch
from audio_pattern_discovery_tpu_torch.ops.spectrogram import spectrogram_corpus
from audio_pattern_discovery_tpu_torch.parallel import mesh as tmesh
from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps
from audio_pattern_discovery_tpu_torch.parallel.wavefront import (
    dtw_wavefront_sharded,
    shard_b_for_wavefront,
)
from audio_pattern_discovery_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual CPU mesh"
)

CPU = torch.device("cpu")
# D within this of one device's after a mesh-trained AE (the pipeline
# tests' drift bound for the AE's reduction order).
AE_D_ATOL = 0.3


def _cpus(n):
    return [CPU] * n


def _features(seed, K, L, d=6):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(L // 2, L + 1, K).astype(np.int32)
    feats = rng.normal(0, 1, (K, L, d)).astype(np.float32)
    return feats, lengths


# ---- mesh -----------------------------------------------------------------

@pytest.mark.parametrize("model_axis,want", [(2, {"data": 4, "model": 2}),
                                             (1, {"data": 8, "model": 1})])
def test_mesh_shapes(model_axis, want):
    mesh = tmesh.make_mesh(ParallelConfig(model_axis=model_axis), devices=_cpus(8))
    assert mesh.shape == want
    jm = jmesh.make_mesh(JPar(model_axis=model_axis), devices=jax.devices())
    assert dict(zip(jm.axis_names, jm.devices.shape)) == want
    assert all(d == CPU for d in mesh.device_list) and mesh.size == 8


def test_device_lists(monkeypatch):
    # "cuda" stands for every visible card (jax.devices()); a list is kept
    # as given, repeats and all.
    from audio_pattern_discovery_tpu_torch.utils.device import resolve_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert resolve_devices("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert resolve_devices("cuda:1") == [torch.device("cuda", 1)]
    assert resolve_devices("cpu") == [CPU] and resolve_devices(_cpus(2)) == _cpus(2)
    with pytest.raises(ValueError, match="empty device list"):
        resolve_devices([])


def test_mesh_too_large_raises():
    for make, devs, cfg in ((tmesh.make_mesh, _cpus(8), ParallelConfig(data_axis=5, model_axis=2)),
                            (jmesh.make_mesh, jax.devices(), JPar(data_axis=5, model_axis=2))):
        with pytest.raises(ValueError, match="mesh 5x2 exceeds 8 devices"):
            make(cfg, devices=devs)


def test_ae_param_sharding_splits_outputs_over_model():
    mesh = tmesh.make_mesh(ParallelConfig(model_axis=2), devices=_cpus(8))
    model = tae.create_model(AutoencoderConfig(latent_dim=4, hidden_dims=(6,)), 10)
    params = tae.init_params(model, 0)
    specs = tmesh.ae_param_sharding(mesh, params)
    assert {s.spec for s in specs.values()} == {("model",)}
    pieces = tmesh.split_over(params["enc_layers.0.weight"], specs["enc_layers.0.weight"], 0,
                              list(mesh.devices[0]))
    assert [p.shape for p in pieces] == [(3, 10), (3, 10)]
    assert tmesh.data_sharding(mesh).spec == ("data",) and tmesh.replicated(mesh).spec == ()


# ---- schedulers -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 8])
def test_per_pair_scheduler_over_devices(n):
    feats, lengths = _features(1, K=10, L=32)
    kw = dict(pair_batch=4, max_seq_len=32, normalize="path_len")
    one = tps.all_pairs_distances(feats, lengths, DTWConfig(**kw), tiled=False, bucket_step=8,
                                  device="cpu")
    stats = {}
    got = tps.all_pairs_distances(feats, lengths, DTWConfig(**kw), tiled=False, bucket_step=8,
                                  devices=_cpus(n), stats=stats)
    np.testing.assert_array_equal(got, one)
    jstats = {}
    want = jps.all_pairs_distances(feats, lengths, JCfg(**kw, use_pallas=False), tiled=False,
                                   bucket_step=8, devices=list(jax.devices()[:n]), stats=jstats)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # The reference's round robin: block bi on devices[bi % n].
    assert stats["blocks"] == jstats["blocks"]
    assert stats["device_blocks"] == [len(range(i, jstats["blocks"], n)) for i in range(n)]


@pytest.mark.parametrize("n", [1, 3, 8])
def test_tiled_scheduler_over_devices(n):
    feats, lengths = _features(2, K=40, L=32)
    cfg = DTWConfig(normalize="path_len")
    one = tps.all_pairs_distances_tiled(feats, lengths, cfg, ti=8, chunk_programs=1,
                                        device="cpu")
    stats = {}
    got = tps.all_pairs_distances_tiled(feats, lengths, cfg, ti=8, chunk_programs=1,
                                        devices=_cpus(n), stats=stats)
    np.testing.assert_array_equal(got, one)
    jstats = {}
    want = jps.all_pairs_distances_tiled(
        feats, lengths, JCfg(normalize="path_len"), interpret=True, geometry=(8, 4, 8),
        chunk_programs=1, devices=list(jax.devices()[:n]), stats=jstats)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert stats["device_blocks"] == jstats["device_blocks"]
    assert sum(stats["device_blocks"]) == stats["blocks"] > n


def test_tiled_widen_and_resume_over_devices(tmp_path):
    # The widen route's per-device layouts, and block_dir: a rerun over the
    # list reads every chunk back and dispatches none.
    feats, lengths = _features(3, K=40, L=32)
    cfg = DTWConfig(band=8, band_mode="widen")
    one = tps.all_pairs_distances_tiled(feats, lengths, cfg, ti=8, chunk_programs=4,
                                        device="cpu")
    kw = dict(ti=8, chunk_programs=4, devices=_cpus(3), block_dir=tmp_path)
    first, again = {}, {}
    np.testing.assert_array_equal(
        tps.all_pairs_distances_tiled(feats, lengths, cfg, stats=first, **kw), one)
    np.testing.assert_array_equal(
        tps.all_pairs_distances_tiled(feats, lengths, cfg, stats=again, **kw), one)
    assert again["blocks_resumed"] == first["blocks"] and again["device_blocks"] == [0, 0, 0]


def test_per_pair_known_over_devices():
    # Index reuse over a device list: only pairs touching a new sequence.
    feats, lengths = _features(4, K=12, L=32)
    cfg = DTWConfig(band=4, pair_batch=8)
    full = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, device="cpu")
    got = tps.all_pairs_distances(feats, lengths, cfg, tiled=False, devices=_cpus(4),
                                  known=(8, full[:8, :8]))
    np.testing.assert_array_equal(got, full)


# ---- spectrogram ------------------------------------------------------------

@pytest.mark.parametrize("return_device", [True, False])
def test_spectrogram_over_devices(return_device):
    rng = np.random.default_rng(5)
    sigs = [(rng.normal(0, 0.3, int(n)) * 32767).astype(np.int16)
            for n in rng.integers(2000, 9000, 11)]
    cfg = SpectrogramConfig(win_length=256, hop_length=128, n_fft=256, feature="mfcc",
                            sample_rate=16000, n_mels=20, n_mfcc=13)
    kw = dict(clip_batch=3, chunk_frames=16, return_device=return_device)
    one = spectrogram_corpus(sigs, cfg, device="cpu", **kw)
    got = spectrogram_corpus(sigs, cfg, devices=_cpus(4), **kw)
    for g, o in zip(got, one):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(o))


# ---- autoencoder ------------------------------------------------------------

def _carry_jax_init(monkeypatch, jcfg, dim):
    """The port's init replaced by JAX's initial parameters for ``jcfg``, as
    the reference's ``train_autoencoder`` draws them."""
    _, init_rng = jax.random.split(jax.random.PRNGKey(jcfg.seed))
    _, state, _ = jae.init_state(jcfg, dim, init_rng)
    carried = tae.params_from_flax(jax.device_get(state.params))
    real = tae.init_state
    monkeypatch.setattr(
        tae, "init_state",
        lambda cfg, d, device="cuda", params=None:
            real(cfg, d, device=device, params=carried if params is None else params))
    return carried


def _close_leaves(got: dict, want: dict, rel: float) -> None:
    assert got.keys() == want.keys()
    for name in want:
        w = want[name].numpy()
        np.testing.assert_allclose(got[name].numpy(), w, rtol=0,
                                   atol=rel * max(float(np.abs(w).max()), 1e-30), err_msg=name)


def test_ae_train_step_dp_tp():
    # One step over the 4x2 mesh: JAX's jitted step on its mesh and the
    # port's mesh step, from the same parameters and batch.
    jm = jmesh.make_mesh(JPar(model_axis=2), devices=jax.devices())
    BINS, BATCH = 32, 16
    jcfg = JAECfg(latent_dim=4, hidden_dims=(16,))
    model, state, tx = jae.init_state(jcfg, BINS, jax.random.PRNGKey(0))
    params = jax.device_put(state.params, jmesh.ae_param_sharding(jm, state.params))
    batch = np.random.default_rng(6).normal(0, 1, (BATCH, BINS)).astype(np.float32)
    step = jae.make_train_step(model, tx, 0.0)
    p1, _, loss = step(params, tx.init(params),
                       jax.device_put(jnp.asarray(batch), jmesh.data_sharding(jm)),
                       jax.random.PRNGKey(1))

    mesh = tmesh.make_mesh(ParallelConfig(model_axis=2), devices=_cpus(8))
    tmodel, _, ttx = tae.init_state(AutoencoderConfig(latent_dim=4, hidden_dims=(16,)), BINS,
                                    device="cpu",
                                    params=tae.params_from_flax(jax.device_get(state.params)))
    specs = tmesh.ae_param_sharding(mesh, dict(tmodel.named_parameters()))
    x = torch.from_numpy(batch)
    tloss = tae._mesh_step(tmodel, ttx, mesh.devices, specs, x, x)
    np.testing.assert_allclose(float(tloss), float(loss), rtol=1e-6)
    _close_leaves(tae.state_of(tmodel, ttx, 1).params,
                  tae.params_from_flax(jax.device_get(p1)), 1e-5)


def test_train_autoencoder_on_a_4x2_mesh(monkeypatch, tmp_path):
    frames = np.random.default_rng(7).normal(0, 1, (256, 32)).astype(np.float32)
    kw = dict(hidden_dims=(64,), latent_dim=8, epochs=4, batch_size=60)
    jm = jmesh.make_mesh(JPar(model_axis=2), devices=jax.devices())
    _, jstate, jlosses = jae.train_autoencoder(
        frames, JAECfg(**kw), data_sharding=jmesh.data_sharding(jm),
        param_shardings=lambda p: jmesh.ae_param_sharding(jm, p))
    _carry_jax_init(monkeypatch, JAECfg(**kw), 32)
    mesh = tmesh.make_mesh(ParallelConfig(model_axis=2), devices=_cpus(8))
    model, state, losses = tae.train_autoencoder(
        frames, AutoencoderConfig(**kw), data_sharding=tmesh.data_sharding(mesh),
        param_shardings=lambda p: tmesh.ae_param_sharding(mesh, p))
    # The batch is cut to a multiple of the mesh's 8 devices: 56, 4 a step.
    assert state.step == jstate.step == 4 * (256 // 56)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    _close_leaves(state.params, tae.params_from_flax(jax.device_get(jstate.params)), 5e-3)
    # Against the port on one device with the mesh's batch size.
    _, one, one_losses = tae.train_autoencoder(
        frames, AutoencoderConfig(**{**kw, "batch_size": 56}), device="cpu")
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)
    _close_leaves(state.params, one.params, 1e-4)
    # The checkpoint holds the whole parameters under flax's leaf names and
    # reads back on one device.
    ckpt.save_ae_checkpoint(tmp_path, state, tae.FeatureScaler.fit(frames))
    _, restored, _ = ckpt.restore_ae_checkpoint(tmp_path, AutoencoderConfig(**kw), 32,
                                                device="cpu")
    for name, t in state.params.items():
        assert torch.equal(restored.params[name], t), name


def test_train_autoencoder_fewer_frames_than_the_mesh():
    # 5 frames over 8 devices: the first data slot alone, as the reference
    # replicates; the model axis still splits the layers.
    frames = np.random.default_rng(8).normal(0, 1, (5, 12)).astype(np.float32)
    mesh = tmesh.make_mesh(ParallelConfig(model_axis=2), devices=_cpus(8))
    cfg = AutoencoderConfig(hidden_dims=(8,), latent_dim=3, epochs=2, batch_size=4)
    _, state, losses = tae.train_autoencoder(
        frames, cfg, data_sharding=tmesh.data_sharding(mesh),
        param_shardings=lambda p: tmesh.ae_param_sharding(mesh, p))
    _, one, one_losses = tae.train_autoencoder(frames, cfg, device="cpu")
    assert state.step == one.step == 2
    np.testing.assert_allclose(losses, one_losses, rtol=1e-5)


def test_encode_frames_with_params_over_the_mesh():
    mesh = tmesh.make_mesh(ParallelConfig(model_axis=2), devices=_cpus(8))
    cfg = AutoencoderConfig(hidden_dims=(16,), latent_dim=4)
    model, state, _ = tae.init_state(cfg, 12, device="cpu")
    specs = tmesh.ae_param_sharding(mesh, state.params)
    placed = {n: tmesh.split_over(t, specs[n], 0, list(mesh.devices[0]))
              for n, t in state.params.items()}
    assert tae._params_device_span(placed) == {CPU}
    x = np.random.default_rng(9).normal(0, 1, (3, 20, 12)).astype(np.float32)
    np.testing.assert_array_equal(tae.encode_frames(model, placed, x).numpy(),
                                  tae.encode_frames(model, state.params, x).numpy())


# ---- wavefront -------------------------------------------------------------

@pytest.mark.parametrize("band", [None, 10])
@pytest.mark.parametrize("S", [64, 128, 192])
def test_wavefront_over_eight_devices(S, band):
    # Block 8 on 8 devices: 1-3 block columns a stripe (3: the corner-mask
    # regime of the reference's test).
    from audio_pattern_discovery_tpu.parallel.wavefront import (
        dtw_wavefront_sharded as j_wavefront,
        shard_b_for_wavefront as j_shard_b,
    )

    rng = np.random.default_rng(S + (band or 0))
    B, d = 2, 4
    a = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    b = rng.normal(0, 1, (B, S, d)).astype(np.float32)
    la = rng.integers(S // 2, S + 1, B).astype(np.int32)
    lb = rng.integers(S // 2, S + 1, B).astype(np.int32)
    mesh = tmesh.Mesh(tmesh.device_grid(_cpus(8), (8,)), ("seq",))
    ta, tla, tlb = torch.from_numpy(a), torch.from_numpy(la), torch.from_numpy(lb)
    stripes = shard_b_for_wavefront(torch.from_numpy(b), mesh)
    assert [s.shape for s in stripes] == [(B, S // 8, d)] * 8
    got = dtw_wavefront_sharded(ta, stripes, tla, tlb, mesh, band=band, block=8)
    one = dtw_long_batch(ta, torch.from_numpy(b), tla, tlb, band=band, block=8)
    assert torch.equal(got, one)
    jm = JMesh(np.asarray(jax.devices()[:8]), ("seq",))
    want = j_wavefront(jnp.asarray(a), j_shard_b(jnp.asarray(b), jm), jnp.asarray(la),
                       jnp.asarray(lb), jm, band=band, block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,block,n,match", [(60, 8, 4, "not a multiple of block"),
                                             (64, 8, 3, "not divisible by 3 devices")])
def test_wavefront_refuses_a_bad_grid(S, block, n, match):
    x = torch.zeros((1, S, 2))
    n_len = torch.full((1,), S, dtype=torch.int32)
    mesh = tmesh.Mesh(tmesh.device_grid(_cpus(n), (n,)), ("seq",))
    with pytest.raises(ValueError, match=match):
        dtw_wavefront_sharded(x, [x] * n, n_len, n_len, mesh, block=block)


@pytest.mark.parametrize("cuts", [(5,), (1, 2, 9), (14,)])
def test_k8_twin_stepped_by_diagonals(cuts):
    # K8's plain twin advanced in ranges of block diagonals: bit for bit
    # the stripe in one call (15 diagonals at nB = 8).
    rng = np.random.default_rng(10)
    a, b = (torch.from_numpy(rng.normal(0, 1, (3, 64, 5)).astype(np.float32)) for _ in "ab")
    la = torch.tensor([64, 40, 57], dtype=torch.int32)
    lb = torch.tensor([50, 64, 33], dtype=torch.int32)
    kw = dict(block=8, J0=0, nJ=8, band=6)
    whole = LongStripe(a, b, la, lb, **kw)
    whole.advance(0, whole.n_diag)
    stepped = LongStripe(a, b, la, lb, **kw)
    for k0, k1 in zip((0, *cuts), (*cuts, stepped.n_diag)):
        stepped.advance(k0, k1)
    assert torch.equal(stepped.out, whole.out) and torch.equal(stepped.V, whole.V)
    assert torch.equal(whole.out, dtw_long_batch(a, b, la, lb, block=8, band=6))


@pytest.mark.parametrize("metric,matmul_dtype", [("euclidean", None), ("cosine", None),
                                                 ("sqeuclidean", "bfloat16")])
def test_k8_twin_split_stripes_match_one_call(metric, matmul_dtype):
    # Two stripes of 4 block columns, the second holding only its own frames
    # of b and the first's right columns as its halo, give dtw_long_batch's
    # distances bit for bit, under the bf16 Gram costs too.
    rng = np.random.default_rng(11)
    a, b = (torch.from_numpy(rng.normal(0, 1, (3, 64, 5)).astype(np.float32)) for _ in "ab")
    la = torch.tensor([64, 40, 57], dtype=torch.int32)
    lb = torch.tensor([50, 64, 33], dtype=torch.int32)
    kw = dict(block=8, nJ=4, metric=metric, matmul_dtype=matmul_dtype)
    out = torch.full((3,), float("inf"))
    left = LongStripe(a, b, la, lb, J0=0, out=out, **kw)
    left.advance(0, left.n_diag)
    right = LongStripe(a, b[:, 32:].contiguous(), la, lb, J0=4, b_off=32,
                       halo=left.V.contiguous(), out=out, **kw)
    right.advance(0, right.n_diag)
    want = dtw_long_batch(a, b, la, lb, block=8, metric=metric, matmul_dtype=matmul_dtype)
    assert torch.equal(out, want)


# ---- discover() ------------------------------------------------------------

def test_discover_data_axis_one_is_the_one_device_run(tmp_path):
    # parallel.data_axis=1 trims the list to one device: the run is the
    # one-device run, bit for bit, AE and all.
    from audio_pattern_discovery_tpu_torch.pipeline import discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    make_corpus(str(tmp_path / "wav"), n_clips=6, n_motifs=2, seed=3)
    cfg = PipelineConfig()
    cfg.parallel.data_axis = 1
    one = discover(tmp_path / "wav", cfg, device="cpu")
    got = discover(tmp_path / "wav", cfg, device=_cpus(4))
    np.testing.assert_array_equal(got.distance_matrix, one.distance_matrix)
    assert got.ae_losses == one.ae_losses


def test_discover_on_a_2x2_mesh(tmp_path):
    from audio_pattern_discovery_tpu_torch.pipeline import discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

    make_corpus(str(tmp_path / "wav"), n_clips=12, n_motifs=3, seed=7)
    cfg = PipelineConfig()
    cfg.parallel.model_axis = 2
    one = discover(tmp_path / "wav", cfg, device="cpu")
    got = discover(tmp_path / "wav", cfg, device=_cpus(4))
    assert got.config.parallel.model_axis == 2 and cfg.autoencoder.enabled
    np.testing.assert_array_equal(got.labels, one.labels)
    np.testing.assert_allclose(got.distance_matrix, one.distance_matrix, rtol=0, atol=AE_D_ATOL)

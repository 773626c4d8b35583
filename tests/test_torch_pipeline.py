"""The port's whole slice on the CPU: discover() and the CLI against the
committed goldens and the JAX pipeline, the AE's checkpoint resume and
two-phase training pool, import hygiene, and the configurations and flags
that raised NotImplementedError until they were ported.

Golden tolerances are those of tests/test_pipeline_e2e.py (D at rtol 1e-4 /
atol 1e-5, cluster partition exact), except for the AE goldens' D: see
test_discover_default_config_matches_ae_golden."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from audio_pattern_discovery_tpu_torch.cli import main as cli_main
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.pipeline import discover
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden" / "GOLDEN_cpu_seed7_mfcc_pca.npz"


def _golden_config(cls=PipelineConfig):
    cfg = cls()
    cfg.dtw.band = 16
    cfg.spectrogram.feature = "mfcc"
    cfg.spectrogram.n_mels = 48
    cfg.spectrogram.n_mfcc = 16
    cfg.autoencoder.method = "pca"
    cfg.autoencoder.latent_dim = 8
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    return cfg


def _partition(labels):
    groups = {}
    for i, lab in enumerate(labels):
        groups.setdefault(int(lab), []).append(i)
    return sorted(tuple(g) for g in groups.values())


@pytest.fixture(scope="module")
def seed7(tmp_path_factory):
    d = tmp_path_factory.mktemp("seed7") / "corpus"
    make_corpus(d, n_clips=12, n_motifs=3, seed=7)
    return d


@pytest.mark.parametrize("resident", [True, False])
def test_discover_matches_committed_golden(seed7, resident):
    # resident=False: the spectrogram corpus assembles on the host (the
    # path for corpora above spectrogram.max_resident_bytes).
    cfg = _golden_config()
    if not resident:
        cfg.spectrogram.max_resident_bytes = 0
    res = discover(seed7, cfg, device="cpu")
    ref = np.load(GOLDEN)
    assert res.distance_matrix.shape == ref["D"].shape
    np.testing.assert_allclose(res.distance_matrix, ref["D"], rtol=1e-4, atol=1e-5)
    assert _partition(res.labels) == _partition(ref["labels"])
    # The scaler and the covariance were fitted from the resident tensor.
    assert res.counters.counts["embedding_fit_device"] == 1
    # CPU tensors never reach the CUDA kernel.
    assert res.counters.counts["dtw_kernel_launches"] == 0


def test_discover_matches_jax_pipeline_stagewise(seed7):
    # Same corpus through both packages: segment table, features and
    # alignment paths agree, not only D and the labels.
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover

    cfg = _golden_config()
    cfg.dtw.max_seq_len = 64
    jcfg = _golden_config(JCfg)
    jcfg.dtw.max_seq_len = 64
    got = discover(seed7, cfg, device="cpu")
    want = jdiscover(seed7, jcfg)
    assert [tuple(vars(s).values()) for s in got.segments] == [
        tuple(vars(s).values()) for s in want.segments
    ]
    np.testing.assert_array_equal(got.seg_lengths, want.seg_lengths)
    for k, n in enumerate(got.seg_lengths):
        np.testing.assert_allclose(got.seg_features[k, :n], want.seg_features[k, :n],
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix,
                               rtol=1e-4, atol=1e-5)
    assert _partition(got.labels) == _partition(want.labels)
    assert [(c.exemplar, c.members) for c in got.clusters] == [
        (c.exemplar, c.members) for c in want.clusters
    ]
    for c_t, c_j in zip(got.clusters, want.clusters):
        assert c_t.alignments == c_j.alignments


def test_cli_writes_artifacts(seed7, tmp_path, capsys):
    out = tmp_path / "out"
    rc = cli_main([str(seed7), "-o", str(out), "--device", "cpu", "-s", "dtw.band=16",
                   "-s", "autoencoder.method=pca", "-s", "autoencoder.latent_dim=8",
                   "-s", "output.write_images=false"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    manifest = json.loads((out / "clusters.json").read_text())
    assert manifest["n_clusters"] == summary["n_clusters"] >= 1
    D = np.load(out / "distance_matrix.npy")
    assert D.shape == (summary["n_segments"],) * 2
    assert (out / "state.json").exists() and (out / "index.html").exists()
    snippets = list((out / "snippets").glob("*.wav"))
    assert len(snippets) == sum(len(c["members"]) for c in manifest["clusters"])
    for cl in manifest["clusters"]:
        for path in cl["alignments"].values():
            assert path[0] == [0, 0]
            for (i0, j0), (i1, j1) in zip(path, path[1:]):
                assert (i1 - i0, j1 - j0) in {(1, 0), (0, 1), (1, 1)}


def test_state_fingerprint_equals_jax(seed7, tmp_path):
    # state.json is interchangeable between the packages.
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.pipeline import _feature_fingerprint as jfp

    from audio_pattern_discovery_tpu_torch.pipeline import _feature_fingerprint

    assert _feature_fingerprint(_golden_config()) == jfp(_golden_config(JCfg))


def test_dump_config_matches_reference(capsys):
    assert cli_main(["--dump-config", "-s", "dtw.band=16"]) == 0
    got = json.loads(capsys.readouterr().out)
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg

    assert got == json.loads(json.dumps(JCfg().override({"dtw.band": 16}).to_dict()))


def test_port_never_imports_jax(tmp_path):
    script = f"""
import sys
from audio_pattern_discovery_tpu_torch.synthetic import make_corpus
from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.pipeline import discover
import audio_pattern_discovery_tpu_torch.cli, audio_pattern_discovery_tpu_torch.ops.dtw_cuda
import audio_pattern_discovery_tpu_torch.ops.dtw_long
make_corpus({str(tmp_path / 'c')!r}, n_clips=4, n_motifs=2, clip_seconds=1.5, seed=3)
cfg = PipelineConfig().override({{"dtw.band": 8, "autoencoder.method": "pca",
                                  "autoencoder.latent_dim": 4, "dtw.max_seq_len": 48}})
r = discover({str(tmp_path / 'c')!r}, cfg, device="cpu")
assert r.distance_matrix.shape[0] >= 2
# The trained AE (the default embedder), its checkpoint written and restored.
cfg = PipelineConfig().override({{"dtw.band": 8, "autoencoder.epochs": 2,
                                  "autoencoder.hidden_dims": [16], "autoencoder.latent_dim": 4,
                                  "autoencoder.checkpoint": True, "dtw.max_seq_len": 48,
                                  "output.write_images": False}})
for n in range(2):
    r = discover({str(tmp_path / 'c')!r}, cfg, out_dir={str(tmp_path / 'out')!r}, device="cpu")
    assert bool(r.ae_losses) == (n == 0) and r.distance_matrix.shape[0] >= 2
# Index reuse: an update and a query of that index, and the worker's module.
from audio_pattern_discovery_tpu_torch.query import query_corpus
import audio_pattern_discovery_tpu_torch.serve
up = discover({str(tmp_path / 'c')!r}, cfg, out_dir={str(tmp_path / 'up')!r},
              update_from={str(tmp_path / 'out')!r}, device="cpu")
assert (up.distance_matrix == r.distance_matrix).all()
rep = query_corpus({str(tmp_path / 'out')!r}, [{str(tmp_path / 'c' / 'clip_0000.wav')!r}], cfg,
                   top_k=2, device="cpu")
assert rep["queries"]
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not any(m.startswith("audio_pattern_discovery_tpu.") or m == "audio_pattern_discovery_tpu"
               for m in sys.modules)
print("OK")
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize(
    "overrides,alignments_dtype",
    [
        ({"dtw.band": None, "dtw.max_seq_len": 8192}, None),
        ({"dtw.dtype": "bfloat16"}, "float32 only"),
    ],
)
def test_unported_configs_raise(seed7, overrides, alignments_dtype):
    # Two configurations that raised until they were ported.  Unbanded DTW
    # at max_seq_len 8192 runs per pair (no tiled route past 4096 frames)
    # and gives the tiled route's D on the same segments (max_seq_len only
    # pads them).  dtw.dtype=bfloat16 runs per pair with the bf16 Gram (diag
    # band 16: the plain dtw_batch), its D that of dtw_batch's bf16 recipe
    # on the run's features, while the alignments stay "float32 only", as
    # the reference's: the fp32 run's paths on the same clusters.
    cfg = PipelineConfig().override({"dtw.band": 16, "autoencoder.method": "pca", **overrides})
    got = discover(seed7, cfg, device="cpu")
    assert got.counters.counts["dtw_tile_programs"] == 0      # the per-pair route
    if alignments_dtype is not None:
        from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch
        from audio_pattern_discovery_tpu_torch.pipeline import _cluster_alignments

        n, f = got.seg_lengths, torch.from_numpy(got.seg_features)
        ii, jj = np.triu_indices(len(n), 1)
        want = dtw_batch(f[ii], f[jj], torch.from_numpy(n[ii]), torch.from_numpy(n[jj]),
                         band=16, band_mode="diag", normalize="path_len",
                         matmul_dtype="bfloat16").numpy()
        np.testing.assert_allclose(got.distance_matrix[ii, jj], want, rtol=1e-5, atol=1e-6)
        f32 = PipelineConfig().override({"dtw.band": 16, "autoencoder.method": "pca"})
        for c in (c for c in got.clusters if len(c.members) > 1):
            assert c.alignments == _cluster_alignments(
                c.exemplar, [m for m in c.members if m != c.exemplar], got.seg_features,
                got.seg_lengths, f32, "cpu")
        return
    cfg.dtw.max_seq_len = 256
    want = discover(seed7, cfg, device="cpu")
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix, rtol=1e-5, atol=1e-6)
    assert _partition(got.labels) == _partition(want.labels)


def test_update_query_serve_and_long_alignments_raise(seed7, tmp_path, capsys):
    # --update, --query and --serve run in the port; without a prior index
    # the first two raise as the reference does, and --serve refuses a
    # corpus argument.
    cfg = _golden_config()
    with pytest.raises(FileNotFoundError, match="state.json"):
        discover(seed7, cfg, update_from=tmp_path, device="cpu")
    with pytest.raises(FileNotFoundError, match="state.json"):
        cli_main([str(seed7), "-o", str(tmp_path), "--device", "cpu", "--update",
                  "-s", "dtw.band=16", "-s", "autoencoder.method=pca"])
    with pytest.raises(FileNotFoundError, match="state.json"):
        cli_main(["--query", "x.wav", "-o", str(tmp_path), "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli_main([str(seed7), "--serve", str(tmp_path / "sock"), "--device", "cpu"])
    assert "--serve runs a resident worker" in capsys.readouterr().err
    # Alignments of 512 frames or more no longer raise: they run through
    # the checkpointed backtrace and give the one-shot paths.
    from audio_pattern_discovery_tpu_torch.ops.backtrace import paths_from_dirs
    from audio_pattern_discovery_tpu_torch.ops.backtrace_ckpt import dtw_paths_checkpointed
    from audio_pattern_discovery_tpu_torch.ops.dtw import dtw_batch_with_dirs
    from audio_pattern_discovery_tpu_torch.pipeline import _cluster_alignments

    rng = np.random.default_rng(8)
    lens = np.array([600, 590, 580], np.int32)
    feats = rng.normal(0, 1, (3, 600, 2)).astype(np.float32)
    for k in range(3):
        feats[k, lens[k]:] = 0.0
    before = dtw_paths_checkpointed.calls
    got = _cluster_alignments(0, [1, 2], feats, lens, cfg, "cpu")
    assert dtw_paths_checkpointed.calls == before + 1
    _, dirs = dtw_batch_with_dirs(
        torch.from_numpy(feats[[0, 0]]), torch.from_numpy(feats[[1, 2]]),
        torch.from_numpy(lens[[0, 0]]), torch.from_numpy(lens[[1, 2]]), band=16,
        band_mode=cfg.dtw.band_mode,
    )
    want = paths_from_dirs(dirs.numpy(), lens[[0, 0]], lens[[1, 2]])
    assert [got[1], got[2]] == want


@pytest.mark.parametrize("flags,title", [
    (["--doctor"], "Runtime extras"),
    (["--trace", "trace_dir"], "Runtime extras"),
])
def test_reference_only_flags_raise_naming_their_item(seed7, tmp_path, capsys, flags, title):
    # The reference's flags, which raised naming their ROADMAP.md item until
    # it was ported: each runs as the reference's does, and ROADMAP.md
    # records the item among the ported modules.
    roadmap = (REPO / "ROADMAP.md").read_text().replace("`", "")
    assert f"Ported: {title}" in roadmap
    if flags[0] == "--trace":
        flags = [str(seed7), "-o", str(tmp_path / "out"), "--device", "cpu",
                 "--trace", str(tmp_path / flags[1]), "-s", "dtw.band=16",
                 "-s", "autoencoder.method=pca", "-s", "output.write_images=false"]
    assert cli_main(flags) == 0
    out = json.loads(capsys.readouterr().out)
    if flags[0] == "--doctor":
        assert {"versions", "host", "native_lib", "compile_cache", "env", "first_use_s",
                "first_use_counts", "device"} == set(out)
    else:
        assert out["n_clusters"] >= 1
        assert len(list((tmp_path / "trace_dir").glob("*.pt.trace.json"))) == 1


@pytest.mark.parametrize("entry", ["discover", "cli", "all_pairs_distances",
                                   "all_pairs_distances_tiled", "all_pairs_distances_per_pair",
                                   "fit_pca", "spectrogram_corpus"])
def test_no_card_raises_unless_cpu_is_asked_for(seed7, tmp_path, monkeypatch, entry):
    # The entry points default to the card; without one they raise and name
    # the explicit CPU choice instead of carrying on on the CPU.
    from audio_pattern_discovery_tpu_torch.config import DTWConfig, SpectrogramConfig
    from audio_pattern_discovery_tpu_torch.models.pca import fit_pca
    from audio_pattern_discovery_tpu_torch.ops.spectrogram import spectrogram_corpus
    from audio_pattern_discovery_tpu_torch.parallel import pair_scheduler as tps

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    feats, lens = np.zeros((3, 8, 2), np.float32), np.array([8, 7, 6], np.int32)
    cfg = DTWConfig(band=2, band_mode="diag")
    frames = np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32)
    clips = [np.ones(2048, np.float32)]
    calls = {
        "fit_pca": lambda **kw: fit_pca(frames, 2, **kw),
        "spectrogram_corpus":
            lambda **kw: spectrogram_corpus(clips, SpectrogramConfig(), **kw),
        "discover": lambda **kw: discover(seed7, _golden_config(), **kw),
        "cli": lambda **kw: cli_main([str(seed7), "-o", str(tmp_path / "out"),
                                      *(["--device", kw["device"]] if kw else [])]),
        "all_pairs_distances": lambda **kw: tps.all_pairs_distances(feats, lens, cfg, **kw),
        "all_pairs_distances_tiled":
            lambda **kw: tps.all_pairs_distances_tiled(feats, lens, cfg, **kw),
        "all_pairs_distances_per_pair":
            lambda **kw: tps.all_pairs_distances_per_pair(feats, lens, cfg, **kw),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()
    if entry != "cli":
        with pytest.raises(RuntimeError, match="no CUDA card"):
            calls[entry](device="cuda")
    if entry.startswith("all_pairs"):
        assert calls[entry](device="cpu").shape == (3, 3)
    elif entry == "fit_pca":
        assert calls[entry](device="cpu").components.shape == (3, 2)
    elif entry == "spectrogram_corpus":
        assert calls[entry](device="cpu")[0].shape[0] == 1


def test_discover_unbanded_matches_jax_pipeline(seed7):
    # The default DTW (dtw.band=None) through K2's route on the CPU against
    # the JAX package's discover() with the same config, in this process.
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover

    cfg, jcfg = _golden_config(), _golden_config(JCfg)
    cfg.dtw.band = jcfg.dtw.band = None
    got = discover(seed7, cfg, device="cpu")
    want = jdiscover(seed7, jcfg)
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix,
                               rtol=1e-4, atol=1e-5)
    assert _partition(got.labels) == _partition(want.labels)
    assert got.counters.counts["dtw_kernel_launches"] == 0
    for c_t, c_j in zip(got.clusters, want.clusters):
        assert c_t.alignments == c_j.alignments


@pytest.mark.parametrize("case", ["unbanded discover", "widen discover", "all_pairs"])
def test_jobs_past_4096_frames_run(seed7, case):
    # The three long jobs that raised, citing "ops/dtw_long.py", until the
    # blocked wavefront was ported: each now runs on the per-pair route.
    from audio_pattern_discovery_tpu_torch.config import DTWConfig
    from audio_pattern_discovery_tpu_torch.parallel.pair_scheduler import all_pairs_distances

    if case == "all_pairs":
        # One pair of 4200 and 4100 frames: a K8 bucket (blocks of 256).
        stats = {}
        D = all_pairs_distances(np.zeros((2, 4200, 2), np.float32), [4200, 4100],
                                DTWConfig(band=None), device="cpu", stats=stats)
        assert stats["route"] == "per_pair" and stats["blocks"] == 1
        np.testing.assert_array_equal(D, 0.0)
        return
    mode = {"dtw.band": None} if case.startswith("unbanded") else {"dtw.band_mode": "widen"}
    res = discover(seed7, PipelineConfig().override(
        {"dtw.band": 16, "autoencoder.method": "pca", "dtw.max_seq_len": 5000, **mode}),
        device="cpu")
    assert np.isfinite(res.distance_matrix).all() and len(res.clusters) >= 1
    assert res.counters.counts["dtw_tile_programs"] == 0


def test_discover_past_4096_matches_jax_pipeline(seed7):
    # dtw.max_seq_len past 4096, unbanded, PCA: the port's per-pair route
    # against the JAX package's discover() with the same config, as
    # test_discover_unbanded_matches_jax_pipeline does at 256.
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover

    cfg, jcfg = _golden_config(), _golden_config(JCfg)
    cfg.dtw.band = jcfg.dtw.band = None
    cfg.dtw.max_seq_len = jcfg.dtw.max_seq_len = 5000
    got = discover(seed7, cfg, device="cpu")
    want = jdiscover(seed7, jcfg)
    assert got.seg_features.shape[1] == 5000
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix,
                               rtol=1e-4, atol=1e-5)
    assert _partition(got.labels) == _partition(want.labels)
    assert got.counters.counts["dtw_tile_programs"] == 0


def test_not_implemented_messages_cite_roadmap_titles(seed7, tmp_path, capsys):
    # The three calls that raised NotImplementedError, naming their
    # ROADMAP.md items, until those were ported now run; no source file of
    # the port raises it any more, and ROADMAP.md lists no raise left.
    base = {"dtw.band": 16, "autoencoder.method": "pca"}
    res = discover(seed7, PipelineConfig().override({**base, "dtw.dtype": "bfloat16"}),
                   device="cpu")
    assert np.isfinite(res.distance_matrix).all() and len(res.clusters) >= 1
    assert cli_main(["--doctor"]) == 0
    assert cli_main([str(seed7), "-o", str(tmp_path / "out"), "--device", "cpu", "--trace",
                     str(tmp_path / "trace_dir"), "-s", "dtw.band=16",
                     "-s", "autoencoder.method=pca", "-s", "output.write_images=false"]) == 0
    capsys.readouterr()
    assert list((tmp_path / "trace_dir").glob("*.json"))
    pkg = REPO / "audio_pattern_discovery_tpu_torch"
    raising = [str(p) for p in pkg.rglob("*.py") if "NotImplementedError" in p.read_text()]
    assert raising == []
    roadmap = (REPO / "ROADMAP.md").read_text().replace("`", "")
    assert not re.findall(r'ROADMAP\.md Queue \d: "([^"]+)"', roadmap)


@pytest.fixture(scope="module")
def lenvar(tmp_path_factory):
    d = tmp_path_factory.mktemp("lenvar") / "corpus"
    make_corpus(d, n_clips=10, n_motifs=3, motif_seconds=(0.15, 0.6), seed=11)
    return d


def _widen_config(cls=PipelineConfig):
    cfg = cls()
    cfg.dtw.band = 16
    cfg.dtw.band_mode = "widen"
    cfg.autoencoder.method = "pca"
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    return cfg


def test_discover_widen_matches_jax_pipeline(lenvar):
    # The widen band mode through the port's K4 route (its twin on the CPU)
    # against the JAX package's discover() with the same config, on the
    # length-varied corpus whose pairs tell widen from diag.
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover

    got = discover(lenvar, _widen_config(), device="cpu")
    want = jdiscover(lenvar, _widen_config(JCfg))
    lens = got.seg_lengths
    assert int(lens.max()) >= 2 * int(lens.min())
    np.testing.assert_allclose(got.distance_matrix, want.distance_matrix, rtol=1e-4, atol=1e-5)
    assert _partition(got.labels) == _partition(want.labels)
    assert [(c.exemplar, c.members) for c in got.clusters] == [
        (c.exemplar, c.members) for c in want.clusters
    ]
    for c_t, c_j in zip(got.clusters, want.clusters):
        assert c_t.alignments == c_j.alignments
    assert got.counters.counts["dtw_kernel_launches"] == 0
    # What changed: widen and diag distances differ on this corpus.
    diag_cfg = _widen_config()
    diag_cfg.dtw.band_mode = "diag"
    diag = discover(lenvar, diag_cfg, device="cpu")
    assert np.abs(diag.distance_matrix - got.distance_matrix).max() > 1e-3


def test_cli_runs_widen(lenvar, tmp_path, capsys):
    out = tmp_path / "out"
    rc = cli_main([str(lenvar), "-o", str(out), "--device", "cpu", "-s", "dtw.band=16",
                   "-s", "dtw.band_mode=widen",
                   "-s", "autoencoder.method=pca", "-s", "output.write_images=false"])
    assert rc == 0
    summary = json.loads(capsys.readouterr().out)
    assert summary["counts"]["launches.dtw_tile_lane_pairs"] == 0
    state = json.loads((out / "state.json").read_text())
    assert state["band_mode"] == "widen"
    D = np.load(out / "distance_matrix.npy")
    ref = discover(lenvar, _widen_config(), device="cpu")
    np.testing.assert_allclose(D, ref.distance_matrix, rtol=1e-6, atol=1e-7)


# ---- the trained AE, the default embedder

def _carry_jax_init(monkeypatch, dim: int = 513) -> None:
    """The port's AE init replaced by the JAX package's initial parameters
    for the default config: ``init_state(cfg, dim, split(PRNGKey(seed))[1])``,
    as the reference's ``train_autoencoder`` draws them."""
    import jax

    from audio_pattern_discovery_tpu.config import AutoencoderConfig as JAECfg
    from audio_pattern_discovery_tpu.models.autoencoder import init_state as jinit

    from audio_pattern_discovery_tpu_torch.models import autoencoder as tae

    _, init_rng = jax.random.split(jax.random.PRNGKey(JAECfg().seed))
    _, state, _ = jinit(JAECfg(), dim, init_rng)
    carried = tae.params_from_flax(jax.device_get(state.params))
    real = tae.init_state
    monkeypatch.setattr(
        tae, "init_state",
        lambda cfg, d, device="cuda", params=None:
            real(cfg, d, device=device, params=carried if params is None else params))


def _default_config(cls=PipelineConfig):
    cfg = cls()
    cfg.dtw.band = 16
    cfg.output.write_snippets = False
    cfg.output.write_images = False
    cfg.output.write_html_report = False
    return cfg


def _purity(segments, labels, truth, cfg) -> float:
    """tests/test_pipeline_e2e.py's planted-truth purity over a labelling:
    each segment takes the motif whose occurrence it overlaps most; purity
    is the share of members that agree with their cluster's majority, over
    clusters of at least cluster.min_cluster_size."""
    hop, win = cfg.spectrogram.hop_length, cfg.spectrogram.win_length

    def motif_of(seg):
        s0, s1 = seg.start_frame * hop, (seg.end_frame - 1) * hop + win
        best, best_ov = None, 0
        for occ in truth:
            ov = min(s1, occ.start + occ.length) - max(s0, occ.start)
            if occ.clip == seg.clip and ov > best_ov:
                best, best_ov = occ.motif, ov
        return best

    agree = total = 0
    for lab in np.unique(labels):
        members = np.flatnonzero(labels == lab)
        if len(members) < cfg.cluster.min_cluster_size:
            continue
        motifs = [m for m in (motif_of(segments[i]) for i in members) if m is not None]
        if motifs:
            majority = max(set(motifs), key=motifs.count)
            agree += sum(m == majority for m in motifs)
            total += len(motifs)
    return agree / max(total, 1)


@pytest.mark.parametrize("corpus,golden,d_atol", [
    ("seed7", "GOLDEN_cpu_seed7.npz", 0.3),
    ("lenvar", "GOLDEN_cpu_lenvar_seed11.npz", 0.15),
])
def test_discover_default_config_matches_ae_golden(request, monkeypatch, corpus, golden,
                                                   d_atol):
    # The default config (the trained AE, 513 -> 256 -> 64 -> 16) with band
    # 16, from the JAX package's initial parameters.  Partition exact.  D:
    # the goldens were recorded on the suite's 8 virtual devices, whose
    # gradient reduction order the AE's 20 epochs amplify (Adam turns a few
    # ulps of a near-zero gradient into an update of up to lr): the JAX
    # package itself on 1 device misses GOLDEN_cpu_seed7.npz by 0.079 in D,
    # and the port by 0.097 (seed 7) and 0.045 (lenvar), as
    # tests/torch_ae_drift.py measures.  So D is held to ~3x those maxima
    # (well under 10x), not to rtol 1e-4.
    _carry_jax_init(monkeypatch)
    res = discover(request.getfixturevalue(corpus), _default_config(), device="cpu")
    ref = np.load(REPO / "tests" / "golden" / golden)
    assert res.distance_matrix.shape == ref["D"].shape
    np.testing.assert_allclose(res.distance_matrix, ref["D"], rtol=0, atol=d_atol)
    assert _partition(res.labels) == _partition(ref["labels"])
    assert len(res.ae_losses) == 20 and res.ae_losses[-1] < res.ae_losses[0]
    assert res.counters.counts["launches.dtw_tile_lane_diag_pairs"] == 0


def test_own_init_purity_matches_jax(tmp_path):
    # The port's own init (not JAX's bits) on the seed-7 corpus and AE config
    # of tests/test_pipeline_e2e.py::test_discovery_recovers_planted_motifs:
    # planted-truth purity no lower than the JAX package's run in this
    # process.  (At the default config on the 12-clip seed-7 corpus the AE
    # takes only 40 steps and purity rests on the init's luck: over
    # autoencoder.seed 0-5 the JAX package reaches 1.0 at seed 0 and 0.79
    # at the others, the port's own init 1.0 at seed 3 and 0.79 at the
    # others, tests/torch_ae_drift.py; the AE golden test carries JAX's
    # seed-0 init.)
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover

    corpus = tmp_path / "corpus"
    truth = make_corpus(corpus, n_clips=10, n_motifs=3, occurrences_per_clip=2,
                        clip_seconds=2.0, sample_rate=16_000, seed=7)
    jcfg = JCfg().override({
        "spectrogram.sample_rate": 16_000, "spectrogram.win_length": 256,
        "spectrogram.hop_length": 128, "spectrogram.max_bins": 64,
        "segmentation.threshold_db": -25.0, "segmentation.min_len_frames": 6,
        "segmentation.merge_gap_frames": 3, "autoencoder.epochs": 8,
        "autoencoder.hidden_dims": [64], "autoencoder.latent_dim": 8, "dtw.max_seq_len": 64,
        "dtw.pair_batch": 128, "cluster.linkage": "average", "output.write_snippets": False,
        "output.write_images": False, "output.write_html_report": False})
    want = jdiscover(corpus, jcfg)
    got = discover(corpus, PipelineConfig.from_dict(jcfg.to_dict()), device="cpu")
    assert [tuple(vars(s).values()) for s in got.segments] == [
        tuple(vars(s).values()) for s in want.segments]
    assert _purity(got.segments, got.labels, truth, jcfg) >= _purity(
        want.segments, want.labels, truth, jcfg) >= 0.9


def _small_ae_config(**overrides):
    # tests/test_checkpoint.py's resume config.
    cfg = PipelineConfig()
    cfg.spectrogram.sample_rate = 16_000
    cfg.spectrogram.win_length = 256
    cfg.spectrogram.hop_length = 128
    cfg.spectrogram.max_bins = 32
    cfg.segmentation.threshold_db = -25.0
    cfg.segmentation.min_len_frames = 6
    cfg.autoencoder.epochs = 2
    cfg.autoencoder.hidden_dims = (16,)
    cfg.autoencoder.latent_dim = 4
    cfg.autoencoder.checkpoint = True
    cfg.dtw.max_seq_len = 64
    cfg.dtw.pair_batch = 64
    cfg.output.write_images = False
    return cfg.override(overrides)


@pytest.mark.parametrize("method,state_file", [("ae", "ae_state.npz"),
                                               ("pca", "pca_state.npz")])
def test_pipeline_resume_skips_training(tmp_path, monkeypatch, method, state_file):
    # Mirrors tests/test_checkpoint.py::test_pipeline_resume_skips_training;
    # the second run must not fit anything.
    from audio_pattern_discovery_tpu_torch import pipeline as tpipe

    corpus, out = tmp_path / "corpus", tmp_path / "out"
    make_corpus(corpus, n_clips=6, n_motifs=2, clip_seconds=1.5, seed=3)
    cfg = _small_ae_config(**{"autoencoder.method": method})
    r1 = discover(corpus, cfg, out_dir=out, device="cpu")
    assert (out / cfg.autoencoder.checkpoint_dir / state_file).is_file()
    assert bool(r1.ae_losses) == (method == "ae")

    def refuse(*a, **k):
        raise AssertionError("a restored run fitted its embedder again")

    monkeypatch.setattr(tpipe, "train_autoencoder", refuse)
    monkeypatch.setattr(tpipe, "fit_pca", refuse)
    r2 = discover(corpus, cfg, out_dir=out, device="cpu")
    assert not r2.ae_losses
    if method == "pca":
        assert r1.counters.counts["embedding_fit_device"] == 1
        assert r2.counters.counts["embedding_fit_device"] == 0
    np.testing.assert_array_equal(r1.labels, r2.labels)
    np.testing.assert_array_equal(r1.distance_matrix, r2.distance_matrix)
    np.testing.assert_array_equal(r1.seg_features, r2.seg_features)


def test_overlap_training_pool_is_the_prefix_derivation(tmp_path, monkeypatch):
    # overlap_clip_fraction=0.5: the AE trains on the first ceil(0.5 n)
    # clips' segment frames, standardized by a scaler fitted on them: the
    # reference's rule, its pool and scaler bitwise equal to the port's own
    # derivation over that prefix.  The segment table is the single-phase
    # run's.
    import math

    from audio_pattern_discovery_tpu_torch import pipeline as tpipe
    from audio_pattern_discovery_tpu_torch.io.corpus import StreamingCorpus
    from audio_pattern_discovery_tpu_torch.models.autoencoder import FeatureScaler
    from audio_pattern_discovery_tpu_torch.utils.logging import StageCounters, get_logger

    corpus, out = tmp_path / "corpus", tmp_path / "out"
    truth = make_corpus(corpus, n_clips=10, n_motifs=3, occurrences_per_clip=2,
                        clip_seconds=2.0, sample_rate=16_000, seed=7)
    cfg = _small_ae_config(**{"autoencoder.overlap_clip_fraction": 0.5,
                              "autoencoder.epochs": 8, "autoencoder.hidden_dims": [64],
                              "autoencoder.latent_dim": 8, "spectrogram.max_bins": 64,
                              "segmentation.merge_gap_frames": 3,
                              "cluster.linkage": "average", "dtw.pair_batch": 128})
    pools = []
    real = tpipe.train_autoencoder

    def record(frames, ae_cfg, **kw):
        pools.append(np.array(frames))
        return real(frames, ae_cfg, **kw)

    monkeypatch.setattr(tpipe, "train_autoencoder", record)
    res = discover(corpus, cfg, out_dir=out, device="cpu")
    single = discover(corpus, cfg.override({"autoencoder.overlap_clip_fraction": 0.0,
                                            "autoencoder.checkpoint": False}), device="cpu")
    assert len(pools) == 2      # the overlap run's, then the single-phase run's

    stream = StreamingCorpus(corpus)
    m = math.ceil(0.5 * len(stream))
    _, _, segs1, sf1, _, sl1 = tpipe._prepare_corpus(
        cfg, stream.view(0, m), StageCounters(), get_logger(), torch.device("cpu"))
    flat1 = tpipe._flat_frames(sf1, sl1, len(segs1))
    scaler1 = FeatureScaler.fit(flat1)
    np.testing.assert_array_equal(pools[0], scaler1.transform(flat1).astype(np.float32))
    with np.load(out / cfg.autoencoder.checkpoint_dir / "ae_state.npz") as z:
        np.testing.assert_array_equal(z["scaler_mean"], scaler1.mean)
        np.testing.assert_array_equal(z["scaler_std"], scaler1.std)
    assert len(pools[0]) < len(pools[1])
    assert [tuple(vars(s).values()) for s in res.segments] == [
        tuple(vars(s).values()) for s in single.segments]
    assert len(res.ae_losses) == 8 and all(np.isfinite(res.ae_losses))
    assert _purity(res.segments, res.labels, truth, cfg) >= 0.9


@pytest.mark.parametrize("ctx", [0, 2])
def test_device_pool_is_the_host_pool_bitwise(seed7, ctx):
    # The PCA fit's rows, gathered on the device from the resident segment
    # tensor (context slices stacked there), are the host pool's: the same
    # frames in the same order (_flat_frames; flat_context for ctx > 0).
    from audio_pattern_discovery_tpu_torch import pipeline as tpipe
    from audio_pattern_discovery_tpu_torch.io.corpus import StreamingCorpus
    from audio_pattern_discovery_tpu_torch.ops.context import stack_context_device
    from audio_pattern_discovery_tpu_torch.utils.logging import StageCounters, get_logger

    _, _, segs, seg_frames, seg_dev, lens = tpipe._prepare_corpus(
        _golden_config(), StreamingCorpus(seed7), StageCounters(), get_logger(),
        torch.device("cpu"))
    assert lens.min() < seg_frames.shape[1]          # padded rows to leave out
    want = tpipe._flat_frames(seg_frames, lens, len(segs), ctx)
    got = tpipe._flat_frames_device(stack_context_device(seg_dev, lens, ctx), lens)
    assert got.shape == want.shape == (lens.sum(), (2 * ctx + 1) * seg_frames.shape[2])
    np.testing.assert_array_equal(got.numpy(), want)


def test_cli_default_config(seed7, tmp_path, capsys):
    # No -s at all: the trained AE and the unbanded default DTW (K2's route;
    # its twin on the CPU).
    out = tmp_path / "out"
    assert cli_main([str(seed7), "-o", str(out), "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out)
    manifest = json.loads((out / "clusters.json").read_text())
    assert manifest["n_clusters"] == summary["n_clusters"] >= 1
    assert len(manifest["ae_losses"]) == 20
    assert {"autoencoder_train", "autoencoder_encode", "dtw"} <= set(summary["timings_s"])
    assert summary["counts"]["feature_dim"] == 16
    assert summary["counts"]["launches.dtw_tile_pairs"] == 0

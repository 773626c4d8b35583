"""What the AE golden tolerances of tests/test_torch_pipeline.py rest on,
measured on the CPU (a script beside the tests, not collected by pytest):

1. the JAX package's own ``discover()`` at the default config with band 16
   on the seed-7 corpus, on ``--devices`` virtual CPU devices, against
   ``GOLDEN_cpu_seed7.npz`` (recorded on 8): the largest |D - D_golden|;
2. the port's ``discover()`` from JAX's initial AE parameters against both
   AE goldens;
3. planted-truth purity at that config for ``autoencoder.seed`` 0-5: the
   JAX package's runs and the port's runs from its own init.

    python tests/torch_ae_drift.py --devices 1
    python tests/torch_ae_drift.py --devices 8
"""

import argparse
import logging
import os
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=1, help="virtual CPU devices for JAX")
    args = parser.parse_args()
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={args.devices}"
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))

    import jax
    import numpy as np
    import torch

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    logging.getLogger("apd").setLevel(logging.ERROR)

    from audio_pattern_discovery_tpu.config import AutoencoderConfig as JAECfg
    from audio_pattern_discovery_tpu.config import PipelineConfig as JCfg
    from audio_pattern_discovery_tpu.models.autoencoder import init_state as jinit
    from audio_pattern_discovery_tpu.pipeline import discover as jdiscover
    from audio_pattern_discovery_tpu_torch.config import PipelineConfig
    from audio_pattern_discovery_tpu_torch.models import autoencoder as tae
    from audio_pattern_discovery_tpu_torch.pipeline import discover
    from audio_pattern_discovery_tpu_torch.synthetic import make_corpus
    from test_torch_pipeline import _default_config, _partition, _purity

    golden = REPO / "tests" / "golden"
    with tempfile.TemporaryDirectory() as tmp:
        seed7, lenvar = Path(tmp) / "seed7", Path(tmp) / "lenvar"
        truth = make_corpus(seed7, n_clips=12, n_motifs=3, seed=7)
        make_corpus(lenvar, n_clips=10, n_motifs=3, motif_seconds=(0.15, 0.6), seed=11)
        ref = np.load(golden / "GOLDEN_cpu_seed7.npz")
        got = jdiscover(seed7, _default_config(JCfg))
        print(f"JAX on {len(jax.devices())} device(s) vs GOLDEN_cpu_seed7.npz: max |dD| "
              f"{np.abs(got.distance_matrix - ref['D']).max():.4g}, partition equal "
              f"{_partition(got.labels) == _partition(ref['labels'])}")

        _, init_rng = jax.random.split(jax.random.PRNGKey(JAECfg().seed))
        carried = tae.params_from_flax(jax.device_get(jinit(JAECfg(), 513, init_rng)[1].params))
        real = tae.init_state
        tae.init_state = lambda cfg, d, device="cuda", params=None: real(
            cfg, d, device=device, params=carried if params is None else params)
        for corpus, name in ((seed7, "GOLDEN_cpu_seed7.npz"),
                             (lenvar, "GOLDEN_cpu_lenvar_seed11.npz")):
            ref = np.load(golden / name)
            res = discover(corpus, _default_config(), device="cpu")
            print(f"port from JAX's init vs {name}: max |dD| "
                  f"{np.abs(res.distance_matrix - ref['D']).max():.4g}, partition equal "
                  f"{_partition(res.labels) == _partition(ref['labels'])}")
        tae.init_state = real

        for seed in range(6):
            jcfg, cfg = _default_config(JCfg), _default_config(PipelineConfig)
            jcfg.autoencoder.seed = cfg.autoencoder.seed = seed
            jres, res = jdiscover(seed7, jcfg), discover(seed7, cfg, device="cpu")
            print(f"autoencoder.seed {seed}: purity JAX {_purity(jres.segments, jres.labels, truth, jcfg):.3f} "
                  f"({len(jres.clusters)} clusters), port's own init "
                  f"{_purity(res.segments, res.labels, truth, cfg):.3f} ({len(res.clusters)} clusters)")


if __name__ == "__main__":
    main()

"""Command line: ``python -m audio_pattern_discovery_tpu_torch <wav-dir>``.

Port of ``audio_pattern_discovery_tpu/cli.py``, trimmed to discovery: the
same ``-c`` config file, ``-s section.key=value`` overrides and
``--dump-config``.  ``--update``, ``--query``, ``--top-k``, ``--serve``,
``--doctor`` and ``--trace`` are accepted so that a command line written
for the reference fails loudly here: they raise ``NotImplementedError``
naming their ROADMAP.md items.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.utils.logging import get_logger


def _parse_override(kv: str):
    key, _, raw = kv.partition("=")
    if not _:
        raise argparse.ArgumentTypeError(f"override must be key=value, got {kv!r}")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return key, value


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="audio_pattern_discovery_tpu_torch",
        description="Discovery of recurring audio patterns on a CUDA card "
        "(PyTorch port): directory of WAVs in, pattern clusters + DTW "
        "alignments out.",
    )
    p.add_argument(
        "wav_dir", type=Path, nargs="?", help="directory of input WAV files"
    )
    p.add_argument("-o", "--out-dir", type=Path, default=Path("apd_out"))
    p.add_argument("-c", "--config", type=Path, help="JSON config file")
    p.add_argument(
        "-s",
        "--set",
        dest="overrides",
        action="append",
        default=[],
        type=_parse_override,
        metavar="KEY=VALUE",
        help="dotted config override, e.g. -s dtw.band=32 -s cluster.n_clusters=5",
    )
    p.add_argument("--update", action="store_true", help="not ported yet")
    p.add_argument("--query", action="append", default=[], type=Path,
                   metavar="WAV", help="not ported yet")
    p.add_argument("--top-k", type=int, default=None, help="not ported yet (goes with --query)")
    p.add_argument("--serve", type=Path, metavar="SOCKET", help="not ported yet")
    p.add_argument("--doctor", action="store_true", help="not ported yet")
    p.add_argument("--trace", type=Path, metavar="DIR", help="not ported yet")
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the pipeline runs (default: the card; cpu runs the kernels' plain twins)",
    )
    p.add_argument("--dump-config", action="store_true", help="print config and exit")
    p.add_argument("--json-logs", action="store_true")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    cfg = PipelineConfig.from_json(args.config) if args.config else PipelineConfig()
    if args.overrides:
        cfg = cfg.override(dict(args.overrides))
    if args.dump_config:
        print(json.dumps(cfg.to_dict(), indent=2))
        return 0
    if args.serve or args.query or args.top_k is not None:
        raise NotImplementedError(
            "--serve, --query and --top-k are not ported to audio_pattern_discovery_tpu_torch "
            'yet (ROADMAP.md Queue 1: "query.py, --update, --query, block persistence"; '
            'ROADMAP.md Queue 1: "Runtime extras")'
        )
    if args.doctor or args.trace:
        raise NotImplementedError(
            "--doctor and --trace are not ported to audio_pattern_discovery_tpu_torch yet "
            '(ROADMAP.md Queue 1: "Runtime extras")'
        )
    if args.wav_dir is None:
        build_parser().error("wav_dir is required (unless --dump-config)")
    try:
        cfg.validate()
    except ValueError as e:
        build_parser().error(str(e))
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    result = discover(
        args.wav_dir, cfg, out_dir=args.out_dir,
        logger=get_logger(json_lines=args.json_logs),
        update_from=args.out_dir if args.update else None,
        device=args.device,
    )
    print(
        json.dumps(
            {
                "out_dir": str(args.out_dir),
                "n_clips": len(result.clips),
                "n_segments": len(result.segments),
                "n_clusters": len(result.clusters),
                "timings_s": result.counters.timings_s,
                "counts": result.counters.counts,
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

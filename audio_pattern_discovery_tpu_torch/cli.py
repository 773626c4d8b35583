"""Command line: ``python -m audio_pattern_discovery_tpu_torch <wav-dir>``.

Port of ``audio_pattern_discovery_tpu/cli.py``: the same ``-c`` config
file, ``-s section.key=value`` overrides, ``--dump-config``, ``--update``
(grow the index in ``--out-dir``), ``--query`` with ``--top-k`` (rank the
indexed segments against new WAVs), ``--serve`` (a resident worker on a
Unix socket), ``--doctor`` (the environment report of ``utils/doctor.py``)
and ``--trace DIR`` (a ``torch.profiler`` trace of a discovery or update
run), with the reference's conflict checks; ``--device`` picks the cards
(the default: every visible card, the reference's mesh over them) or the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.utils.logging import FIRST_USE, get_logger


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
    p.add_argument(
        "--update",
        action="store_true",
        help="incremental update: reuse the distance matrix in --out-dir "
        "from a prior run over the same directory; only DTW pairs touching "
        "newly added WAVs are computed (the embedding model is frozen from "
        "the prior run)",
    )
    p.add_argument(
        "--query",
        action="append",
        default=[],
        type=Path,
        metavar="WAV",
        help="query-by-example instead of discovery: rank the corpus "
        "segments indexed in --out-dir (a prior run) by DTW distance to "
        "each segment of this WAV and print JSON matches with their "
        "clusters; repeatable",
    )
    p.add_argument(
        "--top-k", type=int, default=10,
        help="matches per query segment for --query (default 10)",
    )
    p.add_argument(
        "--serve",
        type=Path,
        metavar="SOCKET",
        help="run as a resident worker serving discover/update/query "
        "requests over this Unix socket (newline-delimited JSON; see "
        "serve.py) on --device; pays the process's start-up once instead "
        "of per invocation.  -c/-s set the server's default config; "
        "requests may override per call",
    )
    p.add_argument(
        "--doctor",
        action="store_true",
        help="print environment diagnostics (versions, native lib, kernel build, the card's "
        "launch round trip, memory bandwidth and upload rate) and exit",
    )
    p.add_argument(
        "--trace",
        type=Path,
        metavar="DIR",
        help="write a torch.profiler trace (Chrome-trace JSON) of the discovery or update run "
        "to DIR",
    )
    p.add_argument(
        "--device",
        choices=("cuda", "cpu"),
        default="cuda",
        help="where the pipeline runs (default: every visible card, as the mesh of "
        "parallel.data_axis x parallel.model_axis; cpu runs the kernels' plain twins)",
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
    if args.doctor:
        from audio_pattern_discovery_tpu_torch.utils.doctor import run_doctor

        print(json.dumps(run_doctor(), indent=2))
        return 0
    log = get_logger(json_lines=args.json_logs)
    if args.serve:
        if args.wav_dir is not None or args.update or args.query:
            build_parser().error(
                "--serve runs a resident worker; send discover/update/query "
                "as requests on the socket instead of CLI arguments"
            )
        try:
            cfg.validate()
        except ValueError as e:
            build_parser().error(str(e))
        from audio_pattern_discovery_tpu_torch.serve import serve

        served = serve(args.serve, cfg, logger=log, device=args.device)
        print(json.dumps({"served": served}))
        return 0
    if args.query:
        if args.update or args.wav_dir is not None:
            # Dropping either would run against a stale index or ignore an
            # intended discovery: the user picks one action.
            build_parser().error(
                "--query cannot be combined with wav_dir or --update; "
                "run the update first, then query the refreshed index"
            )
        try:
            cfg.validate()
        except ValueError as e:
            build_parser().error(str(e))
        from audio_pattern_discovery_tpu_torch.query import query_corpus

        report = query_corpus(args.out_dir, args.query, cfg, top_k=args.top_k, logger=log,
                              device=args.device)
        print(json.dumps(report, indent=2))
        return 0
    if args.wav_dir is None:
        build_parser().error("wav_dir is required (unless --dump-config)")
    try:
        cfg.validate()
    except ValueError as e:
        build_parser().error(str(e))
    from audio_pattern_discovery_tpu_torch.pipeline import discover

    trace = contextlib.nullcontext()
    if args.trace:
        from audio_pattern_discovery_tpu_torch.utils.profiling import trace_to

        trace = trace_to(args.trace)
    with trace:
        result = discover(
            args.wav_dir, cfg, out_dir=args.out_dir, logger=log,
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
                "first_use_s": FIRST_USE.timings_s,
                "first_use_counts": FIRST_USE.counts,
            },
            indent=2,
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

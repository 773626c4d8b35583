"""Warm-process serving: a long-lived worker that holds one device and
serves discovery / update / query requests over a Unix-domain socket.

Port of ``audio_pattern_discovery_tpu/serve.py``.  A fresh process on the
card pays fixed costs before any work: importing torch and creating the
CUDA context, loading the nvcc-built kernel libraries (built once into
``audio_pattern_discovery_tpu_torch/build/`` and loaded per process), and
torch.optim's first use, which imports ``torch._dynamo`` (seconds on the
card's host).  The serve loop pays them once per process lifetime, so a
warm query costs its compute.

Protocol — newline-delimited JSON, one request per connection:

    client connects -> sends one JSON object + "\\n" -> reads one JSON
    line back -> connection closes.

Requests (all fields beyond "cmd" optional unless noted):

    {"cmd": "ping"}
    {"cmd": "doctor", "probe_device": false}
    {"cmd": "discover", "wav_dir": ..., "out_dir": ...,
     "config": {...full config dict...}, "overrides": {"dtw.band": 32},
     "update": true}
    {"cmd": "query", "out_dir": ..., "wavs": [...], "top_k": 10,
     "config": {...}, "overrides": {...}}
    {"cmd": "shutdown"}

Responses: {"ok": true, "result": ...} or {"ok": false, "error": "...",
"traceback": "..."}.  ``doctor`` answers ``utils/doctor.run_doctor``'s
report (the device probes only with ``"probe_device": true``).  Requests
are served strictly one at a time on
the device the server was started with, so two device jobs never run
together.  A request that fails with a Python exception leaves the worker
serving; a CUDA error that poisons the context (an illegal address) cannot
be recovered in-process, and every later request reports it.
"""

from __future__ import annotations

import json
import os
import socket
import traceback
from pathlib import Path
from typing import Any

import torch

from audio_pattern_discovery_tpu_torch.config import PipelineConfig
from audio_pattern_discovery_tpu_torch.utils.device import resolve_device
from audio_pattern_discovery_tpu_torch.utils.logging import get_logger

# Generous per-line cap: a query report over a huge index is megabytes,
# not gigabytes; anything larger indicates a protocol error, and an
# unbounded readline would let a bad client exhaust host memory.
_MAX_LINE_BYTES = 256 << 20


def _request_config(req: dict, default: PipelineConfig) -> PipelineConfig:
    """The effective config of one request: its "config" (a full to_dict()
    tree) replaces the server default, then its "overrides" (dotted keys)
    apply on top."""
    cfg = PipelineConfig.from_dict(req["config"]) if req.get("config") else default
    if req.get("overrides"):
        cfg = cfg.override(dict(req["overrides"]))
    return cfg.validate()


def _handle(req: dict, default_cfg: PipelineConfig, log, device: torch.device) -> Any:
    cmd = req.get("cmd")
    if cmd == "ping":
        return {"pong": True, "pid": os.getpid(), "device": str(device)}
    if cmd == "doctor":
        from audio_pattern_discovery_tpu_torch.utils.doctor import run_doctor

        return run_doctor(probe_device=bool(req.get("probe_device", False)))
    if cmd == "discover":
        from audio_pattern_discovery_tpu_torch.pipeline import discover

        if "wav_dir" not in req:
            raise ValueError("discover: 'wav_dir' is required")
        out_dir = Path(req.get("out_dir", "apd_out"))
        cfg = _request_config(req, default_cfg)
        result = discover(
            Path(req["wav_dir"]),
            cfg,
            out_dir=out_dir,
            logger=log,
            update_from=out_dir if req.get("update") else None,
            device=device,
        )
        return {
            "out_dir": str(out_dir),
            "n_clips": len(result.clips),
            "n_segments": len(result.segments),
            "n_clusters": len(result.clusters),
            "timings_s": result.counters.timings_s,
            "counts": result.counters.counts,
        }
    if cmd == "query":
        from audio_pattern_discovery_tpu_torch.query import query_corpus

        if "out_dir" not in req or not req.get("wavs"):
            raise ValueError("query: 'out_dir' and non-empty 'wavs' required")
        cfg = _request_config(req, default_cfg)
        return query_corpus(
            Path(req["out_dir"]),
            [Path(w) for w in req["wavs"]],
            cfg,
            top_k=int(req.get("top_k", 10)),
            logger=log,
            device=device,
        )
    raise ValueError(f"unknown cmd {cmd!r}")


def serve(
    socket_path: str | Path,
    config: PipelineConfig | None = None,
    logger=None,
    max_requests: int | None = None,
    device: torch.device | str = "cuda",
) -> int:
    """Run the serve loop on ``device`` (the card unless the caller asks for
    the CPU) until a shutdown request (or max_requests).

    Returns the number of requests served.  The socket file is created
    fresh (a stale leftover from a dead server is replaced, a live server
    is refused) and removed on exit."""
    socket_path = Path(socket_path)
    default_cfg = (config or PipelineConfig()).validate()
    device = resolve_device(device)
    log = logger or get_logger()
    if socket_path.exists():
        # Replace only a dead server's leftover: if something answers on
        # the socket, a second worker here would race it for the device.
        probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            probe.settimeout(1.0)
            probe.connect(str(socket_path))
        except OSError:
            socket_path.unlink()
        else:
            raise RuntimeError(f"{socket_path}: a live server is already answering")
        finally:
            probe.close()
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    served = 0
    try:
        srv.bind(str(socket_path))
        srv.listen(1)
        log.info("serving on %s (pid %d, device %s)", socket_path, os.getpid(), device)
        while True:
            conn, _ = srv.accept()
            try:
                with conn.makefile("rwb") as f:
                    line = f.readline(_MAX_LINE_BYTES)
                    if not line.strip():
                        continue
                    try:
                        req = json.loads(line)
                        if not isinstance(req, dict):
                            raise ValueError("request must be a JSON object")
                        if req.get("cmd") == "shutdown":
                            f.write(b'{"ok": true, "result": "bye"}\n')
                            f.flush()
                            served += 1
                            return served
                        resp = {"ok": True, "result": _handle(req, default_cfg, log, device)}
                    except Exception as exc:  # noqa: BLE001 — a bad request must not
                        # take down the warm worker, whose value is surviving to the
                        # next request.
                        log.warning("request failed: %s", exc)
                        resp = {
                            "ok": False,
                            "error": f"{type(exc).__name__}: {exc}",
                            "traceback": traceback.format_exc(),
                        }
                    f.write(json.dumps(resp).encode() + b"\n")
                    f.flush()
                    served += 1
            finally:
                conn.close()
            if max_requests is not None and served >= max_requests:
                return served
    finally:
        srv.close()
        try:
            socket_path.unlink()
        except OSError:
            pass


def request(socket_path: str | Path, req: dict, timeout: float | None = None) -> dict:
    """Send one request to a running server and return the response
    envelope ({"ok": ..., ...}).  Raises OSError if the server is
    unreachable; protocol and handler failures come back as ok=False."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        c.settimeout(timeout)
        c.connect(str(Path(socket_path)))
        with c.makefile("rwb") as f:
            f.write(json.dumps(req).encode() + b"\n")
            f.flush()
            line = f.readline(_MAX_LINE_BYTES)
        if not line:
            raise OSError("server closed the connection without a response")
        return json.loads(line)
    finally:
        c.close()

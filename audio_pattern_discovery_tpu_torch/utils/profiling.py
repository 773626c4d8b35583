"""Tracing and profiling hooks over ``torch.profiler``.

Port of ``audio_pattern_discovery_tpu/utils/profiling.py``.  A trace
records the host's operators and, when a CUDA card is in use, the card's
kernels and copies; it is written as a Chrome-trace JSON file
(``<host>_<pid>.<ms>.pt.trace.json``), which Perfetto and
``chrome://tracing`` open.

Usage:
    with trace_to("/tmp/apd_trace"):           # whole-region trace
        D = all_pairs_distances(...)

    with annotate("dtw_block"):                # named span inside a trace
        ...

    prof = Profiler("/tmp/apd_trace"); prof.start(); ...; prof.stop()
"""

from __future__ import annotations

from contextlib import contextmanager
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity


def _profile(log_dir: str) -> torch.profiler.profile:
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )


@contextmanager
def trace_to(log_dir: str | Path):
    """Capture a trace of the enclosed region into ``log_dir`` (a JSON file
    written when the region ends)."""
    log_dir = str(log_dir)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with _profile(log_dir):
        yield log_dir


def annotate(name: str):
    """Named span that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


class Profiler:
    """Start/stop profiler for a region that spans multiple functions."""

    def __init__(self, log_dir: str | Path):
        self.log_dir = str(log_dir)
        self._prof: torch.profiler.profile | None = None

    def start(self) -> None:
        Path(self.log_dir).mkdir(parents=True, exist_ok=True)
        self._prof = _profile(self.log_dir)
        self._prof.start()

    def stop(self) -> None:
        if self._prof is not None:
            self._prof.stop()
            self._prof = None

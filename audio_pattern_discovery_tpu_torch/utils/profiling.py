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

``annotate`` opens a range only while a profiler records on the calling
thread; otherwise it returns a null context, so the program's stage timers
(``utils/logging.StageCounters.time_stage``) cost nothing more untraced.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity


@contextmanager
def trace_to(log_dir: str | Path):
    """Capture a trace of the enclosed region into ``log_dir`` (a JSON file
    written when the region ends)."""
    log_dir = str(log_dir)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    ):
        yield log_dir


def profiling() -> bool:
    """Whether a ``torch.profiler`` session records on this thread."""
    return torch.autograd._profiler_enabled()


def annotate(name: str):
    """Named range on the trace timeline, on the profiler's clock beside the
    kernels; a null context when no profiler records (``profiling``)."""
    return torch.profiler.record_function(name) if profiling() else nullcontext()


"""Structured logging + per-stage counters (SURVEY.md SS6.5).

The reference logs via stdout prints; the rebuild emits JSON-lines records
with per-stage counters (clips, frames, segments, pairs/sec, cluster count)
suitable for machine scraping and the bench harness.

Port of ``audio_pattern_discovery_tpu/utils/logging.py``.  Beyond the
reference, a stage timer also opens a range ``apd.<key>`` on the timeline
of an active ``torch.profiler`` (``utils/profiling.annotate``), and
``FIRST_USE`` is the process's record of one-time costs: kernel builds and
loads, the native library, the optimizer's first construction.

Keys are dotted by nesting: ``a.b`` is timed inside ``a``, so a stage's
self time is its seconds less its children's.  Children that run side by
side (``kernel_build.<name>``, one compiler each) each stay within their
parent, but their sum may exceed it.  One child runs before its parent:
on the two-phase path ``autoencoder_train.steps_enqueued`` is timed on a
worker thread beside the spectrograms, and ``autoencoder_train`` then
times only the drain.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import Any

from audio_pattern_discovery_tpu_torch.utils.profiling import annotate


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "apd", None)
        if extra:
            payload.update(extra)
        return json.dumps(payload)


def get_logger(name: str = "apd", json_lines: bool = False) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        logger.addHandler(logging.StreamHandler(sys.stderr))
        logger.setLevel(logging.INFO)
        logger.propagate = False
    # (Re)apply the requested format: the first caller must not permanently
    # fix the formatter for later callers asking for the other style.
    formatter = (
        _JsonFormatter()
        if json_lines
        else logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
    )
    for handler in logger.handlers:
        handler.setFormatter(formatter)
    return logger


def log_event(logger: logging.Logger, msg: str, **fields: Any) -> None:
    logger.info(msg, extra={"apd": fields})


@dataclass
class StageCounters:
    """Pipeline-wide counters, reported in the final manifest."""

    counts: dict[str, float] = field(default_factory=dict)
    timings_s: dict[str, float] = field(default_factory=dict)

    def add(self, key: str, value: float = 1.0) -> None:
        self.counts[key] = self.counts.get(key, 0.0) + value

    @contextmanager
    def time_stage(self, key: str):
        """Add the enclosed region's host seconds to ``timings_s[key]``; while
        a profiler records, also a range ``apd.<key>`` around it."""
        t0 = time.perf_counter()
        try:
            with annotate(f"apd.{key}"):
                yield
        finally:
            self.timings_s[key] = self.timings_s.get(key, 0.0) + (time.perf_counter() - t0)

    def first_use(self, key: str):
        """``time_stage(key)`` the first time ``key`` is entered; a null
        context once it has seconds."""
        return nullcontext() if key in self.timings_s else self.time_stage(key)

    def to_dict(self) -> dict[str, Any]:
        return {"counts": dict(self.counts), "timings_s": dict(self.timings_s)}


# The process's one-time costs: ``kernel_build`` (with ``kernel_build.<name>``
# and the count ``kernel_builds``) and ``kernel_load`` (with
# ``kernel_load.<name>``) in ``ops/_build.py``, ``native_load`` (with
# ``native_load.build``) in ``native.py``, ``optimizer_first_use`` in
# ``models/autoencoder.py``.  The CLI's summary and the doctor's report print
# it as ``first_use_s`` and ``first_use_counts``.
FIRST_USE = StageCounters()

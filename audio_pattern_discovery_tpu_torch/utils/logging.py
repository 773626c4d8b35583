"""Structured logging + per-stage counters (SURVEY.md SS6.5).

The reference logs via stdout prints; the rebuild emits JSON-lines records
with per-stage counters (clips, frames, segments, pairs/sec, cluster count)
suitable for machine scraping and the bench harness.

Copy of ``audio_pattern_discovery_tpu/utils/logging.py``; only the import paths differ.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from dataclasses import dataclass, field
from typing import Any


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

    def time_stage(self, key: str):
        counters = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                counters.timings_s[key] = counters.timings_s.get(key, 0.0) + (
                    time.perf_counter() - self.t0
                )
                return False

        return _Ctx()

    def to_dict(self) -> dict[str, Any]:
        return {"counts": dict(self.counts), "timings_s": dict(self.timings_s)}

"""The traced part of a run: torch.profiler around whole jobs, reduced to
device busy time, kernel time by name and the longest idle gaps.

The profiler records CPU and CUDA activity.  Its Chrome trace is written to
the run's scratch directory, read back and deleted.  Device operations are
the events of categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``, each
on the card its ``args["device"]`` names; the traced window is the span of
the harness's ``bench.job`` ranges.  An idle
gap is named by what the host was doing in it: the function of the program
that a sampler of every thread's Python stack (``HostSampler``) found most
often in the gap, else the innermost torch operation around it.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import Counter
from pathlib import Path

PROGRAM = "audio_pattern_discovery_tpu_torch"
# Frames that only wait for other threads.
_WAITS = ("threading.py", "queue.py", "concurrent/futures", "selectors.py", "socket.py")


class HostSampler:
    """Samples, every ``period`` seconds, each thread's innermost frame in
    the program (``module/file.py:function``), with ``time.perf_counter``."""

    def __init__(self, period: float = 0.002):
        self.period, self.samples = period, []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bench-host-sampler", daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.period):
            t = time.perf_counter()
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                label = None
                f = frame
                while f is not None:
                    name = f.f_code.co_filename
                    if any(w in name for w in _WAITS):
                        label = None
                        break
                    if PROGRAM in name:
                        label = f"{name.split(PROGRAM + '/')[-1]}:{f.f_code.co_name}"
                        break
                    f = f.f_back
                if label:
                    self.samples.append((t, label))

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(10)
        return False


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
JOB_RANGE = "bench.job"


def union_s(intervals: list[tuple[float, float]]) -> float:
    """Seconds covered by (start_us, end_us) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e6


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The (start_us, end_us) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def card_of(event: dict) -> int:
    """The card a device operation ran on, by the profiler's device index."""
    return int(event.get("args", {}).get("device", 0))


def reduce_trace(path: Path, samples=(), first_job_t0: float = 0.0, top: int = 10,
                 cards=(0,)) -> dict:
    """{"window_s", "busy_s", "busy_s_by_device", "kernel_s", "device_ops":
    [[name, s]], "device_ops_by_device": [[[name, s]], ...], "idle_gaps":
    [[what, s]]} of a Chrome trace, over the span of its job ranges.
    ``busy_s`` is the mean over ``cards`` (device indices) of each card's
    own busy seconds (``busy_s_by_device``, in the order of ``cards``);
    ``device_ops`` sums each operation's seconds over every card,
    ``device_ops_by_device`` lists each card's ``top`` longest; the idle gaps
    are those of every card's operations together.  ``samples`` from a
    ``HostSampler``, whose clock the first job's start ``first_job_t0``
    (perf_counter seconds) ties to the trace's."""
    events = json.loads(Path(path).read_text()).get("traceEvents", [])
    jobs = [(e["ts"], e["ts"] + e["dur"]) for e in events if e.get("ph") == "X"
            and e.get("name") == JOB_RANGE and e.get("cat") != "gpu_user_annotation"]
    if not jobs:
        raise RuntimeError("the trace holds no job range")
    lo, hi = min(s for s, _ in jobs), max(e for _, e in jobs)
    # With one card every device operation is its own, whatever index the
    # profiler gives it.
    dev = [(e["name"], max(e["ts"], lo), min(e["ts"] + e["dur"], hi), e["cat"],
            card_of(e) if len(cards) > 1 else cards[0])
           for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    busy = [(s, e) for _, s, e, _, _ in dev]
    busy_by = [union_s([(s, e) for _, s, e, _, c in dev if c == card]) for card in cards]
    host = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("cpu_op", "user_annotation",
                                                               "cuda_runtime", "cuda_driver")
                   and e.get("name") != JOB_RANGE and e["ts"] < hi and e["ts"] + e["dur"] > lo),
                  key=lambda t: t[0])
    idle = sorted(gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:top]
    first_ts = min(s for s, _ in jobs)
    at = [((t - first_job_t0) * 1e6 + first_ts, label) for t, label in samples]
    labelled = []
    for s, e in idle:
        seen = Counter(label for t, label in at if s <= t <= e)
        if seen:
            what = f"host: {seen.most_common(1)[0][0]}"
        else:
            mid = 0.5 * (s + e)
            # The innermost host range that covers the middle of the gap.
            inner = [h for h in host if h[0] <= mid <= h[1]]
            what = f"host: {min(inner, key=lambda h: h[1] - h[0])[2]}" if inner else "host"
        labelled.append([what, (e - s) / 1e6])
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(busy_by) / len(busy_by),
        "busy_s_by_device": busy_by,
        "kernel_s": sum((e - s) for _, s, e, cat, _ in dev if cat == "kernel") / 1e6,
        "device_ops": top_ops(dev, top),
        "device_ops_by_device": [top_ops([o for o in dev if o[4] == card], top)
                                 for card in cards],
        "idle_gaps": labelled,
    }


def top_ops(dev: list, top: int) -> list:
    """[[name, seconds]] of the ``top`` operations of ``dev`` that took the
    most time, each name's intervals summed."""
    by_name: dict[str, float] = {}
    for name, s, e, *_ in dev:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
    return sorted(([n, t] for n, t in by_name.items()), key=lambda x: -x[1])[:top]


def idle_pct(run):
    """The share of the traced window in which no operation ran on a card
    (the union of the profiler's kernel, copy and set intervals on it), in
    %, the mean over the cell's cards; None without a trace."""
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])

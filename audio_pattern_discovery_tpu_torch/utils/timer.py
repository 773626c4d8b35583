"""Synchronized device timing.

Port of ``audio_pattern_discovery_tpu/utils/timer.py``.  CUDA launches are
asynchronous: PyTorch returns before the card finishes, so a host clock read
without a barrier measures the enqueue, not the work.  The honest barrier on
the card is ``torch.cuda.synchronize()`` on the outputs' device; CPU tensors
are computed when the call returns.  ``materialize``, ``DeviceTimer`` and
``time_fn`` time host walls that end in that barrier.  ``cuda_ms`` times
the device alone: CUDA events between calls queued behind a device sleep.
"""

from __future__ import annotations

import time

import torch


def _tensors(tree):
    """The tensors of a nested structure of lists, tuples and dicts."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def materialize(tree) -> None:
    """Wait until every tensor of a nested structure is computed:
    ``torch.cuda.synchronize()`` on each CUDA device among them."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class DeviceTimer:
    """Usage:
        with DeviceTimer() as t:
            out = fn(x)
            t.block_on(out)
        elapsed = t.elapsed_s
    """

    def __enter__(self) -> "DeviceTimer":
        self._outputs = []
        self.t0 = time.perf_counter()
        return self

    def block_on(self, *outputs) -> None:
        self._outputs.extend(outputs)

    def __exit__(self, *exc) -> bool:
        materialize(self._outputs)
        self.elapsed_s = time.perf_counter() - self.t0
        return False


def time_fn(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall-seconds per call of ``fn(*args)`` after ``warmup`` calls,
    including the synchronization of its outputs."""
    for _ in range(warmup):
        materialize(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        materialize(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def cuda_ms(fn, reps: int, warm: bool = True, per_call: list | None = None) -> float:
    """Mean device ms of ``reps`` calls of fn on the current CUDA device
    (after a warm call unless ``warm`` is false), from CUDA events between
    the calls.  The device first sleeps (~50 ms) while the host queues the
    calls, so no call waits on the host's work for the next one: the time is
    the device's even where that work outlasts the kernel.  ``per_call``
    receives each call's ms."""
    if warm:
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize()
    times = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    if per_call is not None:
        per_call.extend(times)
    return sum(times) / reps

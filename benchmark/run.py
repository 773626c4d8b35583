"""The benchmark of ``audio_pattern_discovery_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One process runs one cell of ``BENCHMARK.json``.  It finds everything by
name: the cell's file ``benchmark/workloads/<cell>.json`` (its configuration,
traffic driver, parameters and limits), the configuration's file
``benchmark/configs/<config>.json``, the driver ``benchmark/traffic/<driver>.py``
and a reader ``benchmark/metrics/<metric>.py`` for each metric.  It makes the
inputs from the seed, warms up (set-up, ``setup_s``), then runs whole jobs or
requests back to back for ``--seconds``.  With ``--trace 0`` it reports the
cell's end-to-end metrics; with ``--trace 1`` it runs the jobs that start in
the window, up to the cell's ``trace_jobs``, under torch.profiler and
reports the per-layer metrics, the device's busy seconds and a breakdown.
Then it frees the program's state and holds what the last job of the window
produced against the plain reference under ``benchmark/reference/``: each
number beside its limit on standard error's last lines and under the result's
last key, ``checks``.  The result is standard output's last line.

A cell of ``chips`` cards runs on cards 0 .. chips-1 (``Ctx.devices``); the
result line's ``device.count`` is the number of them that the window's jobs
allocated on.  Exits 2 without a result where torch sees fewer cards than
the cell asks for, and 3 where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that no process of the benchmark may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "audio_pattern_discovery_tpu")


@dataclass
class Ctx:
    """What a traffic driver is given: the cell's and configuration's files
    as parsed, the seed, the cell's devices (``devices``, the first of them
    ``device``) and a scratch directory under TMPDIR."""

    name: str
    cell: dict
    config: dict
    seed: int
    devices: list
    tmp: Path
    log: logging.Logger

    @property
    def device(self):
        return self.devices[0]

    @property
    def program_device(self):
        """What the program is handed: the device list in a cell of more
        than one chip, else the one device."""
        return self.devices if len(self.devices) > 1 else self.device


@dataclass
class Run:
    """What a metric reader is given."""

    ctx: Ctx
    setup_s: float
    window_s: float = 0.0
    jobs: list = field(default_factory=list)   # {"t0", "t1", "work", "stats"} per job
    trace: dict | None = None


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path):
    """A driver or reader by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"bench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _merged(base: dict, over: dict | None) -> dict:
    """``base`` with the keys of ``over`` replaced (dicts merged one level)."""
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = {**out[k], **v} if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def cell_devices(devices, chips: int) -> list:
    """The cell's ``chips`` devices: a list as given; for one device, cards
    0 .. chips-1 where it is a card, else that device ``chips`` times (a
    device list may repeat one device)."""
    if isinstance(devices, (list, tuple)):
        return list(devices)
    if devices is not None and getattr(devices, "type", devices) == "cuda":
        import torch

        return [torch.device("cuda", i) for i in range(chips)]
    return [devices] * chips


def card_indices(devices: list) -> list[int]:
    """The distinct CUDA cards among ``devices``, by index, in order."""
    cards = [d for d in dict.fromkeys(devices) if getattr(d, "type", None) == "cuda"]
    return [d.index or 0 for d in cards]


def allocations(cards: list[int]) -> list[int]:
    """Each card's count of allocations so far (the caching allocator's
    ``allocation.all.allocated``)."""
    import torch

    return [int(torch.cuda.memory_stats(i).get("allocation.all.allocated", 0)) for i in cards]


def cards_used(before: list[int], after: list[int]) -> int:
    """The cards whose allocation count grew between two readings."""
    return sum(a > b for b, a in zip(before, after))


def make_ctx(name: str, seed: int, devices, tmp: Path, overrides: dict | None = None) -> Ctx:
    """The context of cell ``name`` on ``devices`` (a list, or one device:
    see ``cell_devices``); ``overrides`` ({"cell": ..., "config": ...})
    shrink a cell for the CPU tests."""
    overrides = overrides or {}
    cell = _merged(load_json(HERE / "workloads" / f"{name}.json"), overrides.get("cell"))
    config = _merged(load_json(HERE / "configs" / f"{cell['config']}.json"),
                     overrides.get("config"))
    log = logging.getLogger("apd.bench")
    log.setLevel(logging.WARNING)
    if not log.handlers:
        log.addHandler(logging.StreamHandler(sys.stderr))
    log.propagate = False
    return Ctx(name, cell, config, int(seed), cell_devices(devices, int(cell["chips"])), tmp, log)


def run_window(driver, state, seconds: float, trace_jobs: int, tmp: Path, sync,
               cards: list[int] = (0,)) -> tuple:
    """Whole jobs back to back from the window's start; those that end within
    ``seconds`` count.  With ``trace_jobs`` > 0 the jobs that start in the
    window, up to that many, run under torch.profiler, and the trace is
    reduced over ``cards`` (device indices).  Returns (window_s,
    jobs, the reduced trace or None, the last counted job's output,
    attempted, failed)."""
    import torch

    from benchmark.trace import HostSampler, reduce_trace

    jobs, out, failed, trace = [], None, 0, None
    prof = sampler = None
    if trace_jobs:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        sampler = HostSampler().__enter__()
    t_start = time.perf_counter()
    deadline = t_start + seconds
    while True:
        t0 = time.perf_counter()
        if t0 >= deadline or (trace_jobs and len(jobs) >= trace_jobs):
            break
        try:
            with torch.profiler.record_function("bench.job"):
                rec, result = driver.run_job(state)
                sync()
        except Exception:  # noqa: BLE001 — a failed job is counted and reported
            import traceback

            traceback.print_exc()
            failed += 1
            break
        t1 = time.perf_counter()
        if t1 > deadline and not trace_jobs:
            break
        rec.update(t0=t0, t1=t1)
        jobs.append(rec)
        out = result
    window_s = (jobs[-1]["t1"] - t_start) if jobs else 0.0
    if prof is not None:
        sampler.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        path = tmp / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        if jobs:
            trace = reduce_trace(path, sampler.samples, jobs[0]["t0"], cards=cards)
        path.unlink()
    return window_s, jobs, trace, out, len(jobs) + failed, failed


def machine_lines(device) -> list[str]:
    """The card's name and power limit and the port's doctor probes
    (``hbm_gbps``, ``dispatch_floor_ms``), as descriptors of the machine
    (not metrics)."""
    if getattr(device, "type", "cpu") != "cuda":
        return []
    from audio_pattern_discovery_tpu_torch.utils.doctor import run_doctor

    probes = run_doctor(probe_device=True)["device"]
    return [f"card: {probes.get('name_power_limit')}",
            f"doctor: hbm_gbps {probes.get('hbm_gbps')} dispatch_floor_ms "
            f"{probes.get('dispatch_floor_ms')}"]


def metric_names(bench: dict, name: str, trace: bool) -> list[dict]:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind] if name in m.get("workloads", [name])]


def run_cell(name: str, seed: int, seconds: float, trace: bool, devices,
             overrides: dict | None = None, bench: dict | None = None) -> tuple[dict, list]:
    """One run of cell ``name`` on ``devices`` (a list, or one device: see
    ``cell_devices``): (result line, checks)."""
    import torch

    bench = bench or load_json(ROOT / "BENCHMARK.json")
    tmp = Path(tempfile.mkdtemp(prefix="apd_bench_", dir=os.environ.get("TMPDIR")))
    try:
        ctx = make_ctx(name, seed, devices, tmp, overrides)
        driver = load_module(HERE / "traffic" / f"{ctx.cell['driver']}.py")
        cards = card_indices(ctx.devices)

        def sync():
            for i in cards:
                torch.cuda.synchronize(i)

        state = driver.setup(ctx)
        sync()
        setup_s = time.perf_counter() - T_START
        before = allocations(cards)
        window_s, jobs, tr, out, attempted, failed = run_window(
            driver, state, seconds, int(ctx.cell["trace_jobs"]) if trace else 0, tmp, sync,
            cards or [0])
        used = cards_used(before, allocations(cards)) if cards else 1
        peaks = [int(torch.cuda.max_memory_allocated(i)) for i in cards]
        run = Run(ctx, setup_s, window_s, jobs, tr)
        metrics = {}
        for m in metric_names(bench, name, trace):
            value = load_module(HERE / "metrics" / f"{m['name']}.py").read(run) if jobs else None
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        driver.release(state)
        del state
        checks = driver.check(ctx, out) if out is not None else []
        for line in machine_lines(ctx.device):
            print(line, file=sys.stderr)
        if cards and used < len(cards):
            print(f"the window's jobs used {used} of the cell's {len(cards)} cards",
                  file=sys.stderr)
        print(f"jobs {len(jobs)} attempted {attempted} failed {failed} window_s {window_s} "
              f"setup_s {setup_s}", file=sys.stderr)
        print(f"job seconds: {[j['t1'] - j['t0'] for j in jobs]}", file=sys.stderr)
        for key in ("timings_s", "counts"):
            names = {k for j in jobs for k in j.get("stats", {}).get(key, {})}
            mean = {k: sum(j["stats"][key].get(k, 0.0) for j in jobs) / len(jobs)
                    for k in sorted(names)}
            if mean:
                print(f"{key} a job: {json.dumps(mean)}", file=sys.stderr)
        correct = bool(checks) and failed == 0 and all(c[1] <= c[2] for c in checks)
        dev_info = {"platform": "gpu" if cards else "cpu",
                    "kind": torch.cuda.get_device_name(cards[0]) if cards else "cpu",
                    "count": used, "memory_peak_bytes": max(peaks, default=0),
                    "memory_peak_bytes_by_device": peaks}
        result = {"correct": correct, "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev_info}
        if tr is not None:
            dev_info["busy_s"] = tr["busy_s"]
            dev_info["window_s"] = tr["window_s"]
            dev_info["busy_s_by_device"] = tr["busy_s_by_device"]
            dev_info["device_ops_by_device"] = tr["device_ops_by_device"]
            result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
        result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
        return result, checks
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # Build and kernel caches at fixed paths inside the checkout; the port
    # builds its kernels into its own build/ directory.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / ".bench_cache" / sub)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"the cell needs {cell['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), bench=bench)
    bad = forbidden_loaded()
    if bad:
        print(f"loaded in this process: {', '.join(bad)} (the benchmark runs without JAX)",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for n, v, lim in checks:
        print(f"check {n} = {v!r} (limit {lim!r}): {'ok' if v <= lim else 'FAIL'}",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Environment diagnostics: ``python -m audio_pattern_discovery_tpu_torch --doctor``.

Port of ``audio_pattern_discovery_tpu/utils/doctor.py``.  When a run is
slow, the first question is whether the machine or the code changed; the
doctor reads the quantities the port's performance depends on in one
command: the versions, the host, the native library, the kernel build
(``ops/_build.py``'s nvcc and the libraries it built) and, on the card, its
properties and three probes: a launch's round trip, the device memory's
copy bandwidth and the host-to-device upload rate.

Every probe is individually guarded: a missing card, compiler or native
library degrades that one entry to an "error" string, never the whole
report.  Without a card the device entry is that error: no probe falls back
to the CPU.
"""

from __future__ import annotations

import os
import subprocess
import time


def _guard(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - diagnostics must never crash
        return {"error": f"{type(e).__name__}: {e}"}


def _versions() -> dict:
    import numpy
    import torch

    import audio_pattern_discovery_tpu_torch as apd

    return {
        "audio_pattern_discovery_tpu_torch": apd.__version__,
        "torch": torch.__version__,
        "torch_cuda": torch.version.cuda,
        "numpy": numpy.__version__,
    }


def _host() -> dict:
    info: dict = {"cpus": os.cpu_count()}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    info["mem_total_gb"] = round(int(line.split()[1]) / 1024**2, 1)
                    break
    except OSError:
        pass
    return info


def _native() -> dict:
    from audio_pattern_discovery_tpu_torch import native

    return {"available": native.available(), "native_openmp": native.openmp}


def _nvcc() -> dict:
    from audio_pattern_discovery_tpu_torch.ops import _build

    path = _build._nvcc()
    proc = subprocess.run([path, "--version"], capture_output=True, text=True, timeout=60)
    return {"path": path, "version": proc.stdout.strip().splitlines()[-1]}


def _compile_cache() -> dict:
    """The kernel build: nvcc, the build directory's entries and bytes, and
    each ``csrc/*.cu`` library's state (``_build.library_state``)."""
    from audio_pattern_discovery_tpu_torch.ops import _build

    out: dict = {"dir": str(_build.BUILD_DIR), "nvcc": _guard(_nvcc)}
    files = [p for p in _build.BUILD_DIR.iterdir() if p.is_file()] \
        if _build.BUILD_DIR.is_dir() else []
    out["entries"] = len(files)
    out["bytes"] = sum(p.stat().st_size for p in files)
    out["libraries"] = {src.stem: _build.library_state(src.stem)
                        for src in sorted(_build.CSRC_DIR.glob("*.cu"))}
    return out


def _power_limit() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi exited {proc.returncode}: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def _device_probes(hbm_mb: int) -> dict:
    """The card's properties and three probes, on CUDA device 0.

    dispatch_floor_ms: a trivial launch and a synchronize, the least of 5:
    the round trip every launch that the host waits on pays.
    hbm_gbps: a device-to-device copy of ``hbm_mb`` MB (read plus write
    counted), timed with ``utils/timer.cuda_ms``: the device memory's
    streaming rate, against which the memory-bound kernels are sized.
    upload_mb_s: 8 MB of pageable host memory copied to the card, the best
    of 4 copies: the rate that bounds uploading a fresh corpus."""
    import numpy as np
    import torch

    from audio_pattern_discovery_tpu_torch.utils.timer import cuda_ms

    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA card")
    dev = torch.device("cuda", 0)
    out: dict = {}
    t0 = time.perf_counter()
    tiny = torch.zeros((), device=dev)
    torch.cuda.synchronize(dev)
    out["handshake_s"] = round(time.perf_counter() - t0, 3)
    props = torch.cuda.get_device_properties(dev)
    out["platform"] = "gpu"
    out["n_devices"] = torch.cuda.device_count()
    out["device_kind"] = torch.cuda.get_device_name(dev)
    out["name_power_limit"] = _guard(_power_limit)
    out["capability"] = f"{props.major}.{props.minor}"
    out["sm_count"] = props.multi_processor_count
    out["memory_gb"] = round(props.total_memory / 1024**3, 1)

    reps = []
    for _ in range(6):
        t0 = time.perf_counter()
        tiny.add_(1.0)
        torch.cuda.synchronize(dev)
        reps.append(time.perf_counter() - t0)
    out["dispatch_floor_ms"] = round(min(reps[1:]) * 1e3, 4)

    n = hbm_mb * 1024 * 1024 // 4
    x = torch.ones(n, device=dev)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        ms = cuda_ms(lambda: y.copy_(x), 5)
    out["hbm_gbps"] = round(2 * n * 4 / (ms / 1e3) / 1e9, 2)
    out["hbm_probe_mb"] = hbm_mb
    del x, y

    up = torch.from_numpy(np.ones(2 * 1024 * 1024, np.float32))
    best = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        up.to(dev)
        torch.cuda.synchronize(dev)
        best = min(best, time.perf_counter() - t0)
    out["upload_mb_s"] = round(up.numel() * 4 / 2**20 / best, 2)
    return out


def run_doctor(probe_device: bool = True, hbm_mb: int = 64) -> dict:
    """Collect the full diagnostic report as a JSON-serializable dict."""
    report = {
        "versions": _guard(_versions),
        "host": _guard(_host),
        "native_lib": _guard(_native),
        "compile_cache": _guard(_compile_cache),
        "env": {
            k: os.environ[k]
            for k in ("CUDA_HOME", "CUDA_VISIBLE_DEVICES", "APD_NO_NATIVE_SCATTER")
            if k in os.environ
        },
    }
    if probe_device:
        report["device"] = _guard(lambda: _device_probes(hbm_mb))
    return report

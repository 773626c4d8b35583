"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point; it is compiled with
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` (beside this package,
listed in ``.gitignore``) and loaded with ctypes.  A library is rebuilt when
its source, or any header ``csrc/*.cuh``, is newer than the built file.  Nothing here runs at import time:
the CPU-only test host has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds, ptxas report) of the build this process ran, if any;
# builds started together each report the seconds from their common start
# until their compiler was collected.
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels are built from source at first use"
    )


def library_state(name: str) -> str:
    """``lib<name>.so`` against ``csrc/<name>.cu``: "absent", "stale" (older
    than its source or a header, so the next load rebuilds it) or
    "current"."""
    so = BUILD_DIR / f"lib{name}.so"
    if not so.exists():
        return "absent"
    headers = max((h.stat().st_mtime for h in CSRC_DIR.glob("*.cuh")), default=0.0)
    newest = max((CSRC_DIR / f"{name}.cu").stat().st_mtime, headers)
    return "stale" if so.stat().st_mtime < newest else "current"


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if stale."""
    return load_all([name])[name]


def load_all(names: list[str]) -> dict[str, ctypes.CDLL]:
    """Load several libraries, running one ``nvcc`` per stale source, all
    started together."""
    with _lock:
        stale = []
        for name in names:
            src, so = CSRC_DIR / f"{name}.cu", BUILD_DIR / f"lib{name}.so"
            if name not in _libs and library_state(name) != "current":
                stale.append((name, src, so))
        if stale:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            t0 = time.perf_counter()
            procs = []
            for name, src, so in stale:
                tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
                procs.append((name, src, so, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            failed = []
            for name, src, so, tmp, proc in procs:
                _, err = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"nvcc failed building {src.name} (exit "
                                  f"{proc.returncode}):\n{err[-4000:]}")
                    continue
                os.replace(tmp, so)
                build_info[name] = (time.perf_counter() - t0, err.strip())
            if failed:
                raise RuntimeError("\n".join(failed))
        for name in names:
            if name not in _libs:
                _libs[name] = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
        return {name: _libs[name] for name in names}

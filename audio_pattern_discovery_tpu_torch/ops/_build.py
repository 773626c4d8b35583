"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` exposes a plain C entry point; it is compiled with
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` (beside this package,
listed in ``.gitignore``) and loaded with ctypes.  A library is rebuilt when
its source is newer than the built file.  Nothing here runs at import time:
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
# name -> (seconds, ptxas report) of the build this process ran, if any.
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


def load(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built from ``csrc/<name>.cu`` if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        so = BUILD_DIR / f"lib{name}.so"
        if not so.exists() or so.stat().st_mtime < src.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src.name} (exit {proc.returncode}):\n"
                    f"{proc.stderr[-4000:]}"
                )
            os.replace(tmp, so)
            build_info[name] = (time.perf_counter() - t0, proc.stderr.strip())
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib

"""ctypes bindings for the native C++ library (SURVEY.md SS3 row 11).

Builds ``native/apd_native.cc`` (the reference's source, shared and never
edited) into this package's own ``build/libapd_native.so`` at first use and
loads it.  The build tries ``-fopenmp`` first and, where that fails (a
compiler without libgomp), builds again without it: the source guards every
OpenMP use with ``#ifdef _OPENMP``, so that library is the same code,
single-threaded.  ``openmp`` records which library was loaded, and
``utils/logging.FIRST_USE`` the seconds (``native_load``, with
``native_load.build`` when it built).  No ``-march=native``, so a library
built on one host runs on another.  Every binding has a pure-Python fallback
elsewhere in the package, so the framework still runs without a compiler.

The bindings are a copy of ``audio_pattern_discovery_tpu/native.py``
without its block scatter: the port assembles D on the device
(``ops/dtw_scatter.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

from audio_pattern_discovery_tpu_torch.utils.logging import FIRST_USE

_SRC = Path(__file__).resolve().parent.parent / "native" / "apd_native.cc"
LIB_PATH = Path(__file__).resolve().parent / "build" / "libapd_native.so"
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
_lib: ctypes.CDLL | None = None
_load_failed = False
# True / False: the loaded library was / was not built with OpenMP; None:
# no library is loaded.
openmp: bool | None = None


def build_library(out: Path, *, use_openmp: bool = True) -> bool:
    """Compile the library to ``out`` (with ``-fopenmp`` or without); True
    on success.  The compiler writes a per-process temporary file that is
    renamed into place, so concurrent builders never see a partial file."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_CXXFLAGS, *(["-fopenmp"] if use_openmp else []), "-o", str(tmp), str(_SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, out)
    return True


def links_openmp(so: Path) -> bool:
    """Whether a built library depends on libgomp (its dynamic section names
    the OpenMP runtime only when it was linked with -fopenmp)."""
    return b"libgomp" in so.read_bytes()


def get_lib() -> ctypes.CDLL | None:
    """The loaded library (built into ``LIB_PATH`` if missing or older than
    its source), or None if no compiler can build it."""
    global _lib, _load_failed, openmp
    if _lib is not None or _load_failed:
        return _lib

    def load() -> ctypes.CDLL | None:
        try:
            return bind(ctypes.CDLL(str(LIB_PATH)))
        except OSError:
            return None

    with FIRST_USE.time_stage("native_load"):
        fresh = LIB_PATH.exists() and LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime
        lib = load() if fresh else None
        # A library that is missing, stale or does not load here (built on
        # another host) is built again.
        if lib is None:
            with FIRST_USE.time_stage("native_load.build"):
                built = build_library(LIB_PATH) or build_library(LIB_PATH, use_openmp=False)
            lib = load() if built else None
    if lib is None:
        _load_failed = True
        return None
    _lib = lib
    openmp = links_openmp(LIB_PATH)
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a loaded library."""
    lib.apd_dtw_batch.restype = None
    lib.apd_dtw_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.apd_nn_chain.restype = ctypes.c_int
    lib.apd_nn_chain.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.apd_read_wav_pcm16.restype = ctypes.c_int64
    lib.apd_read_wav_pcm16.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.apd_wav_info_batch.restype = ctypes.c_int
    lib.apd_wav_info_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    lib.apd_wav_load_batch.restype = ctypes.c_int
    lib.apd_wav_load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int,
    ]
    return lib


def available() -> bool:
    return get_lib() is not None


_METRICS = {"euclidean": 0, "sqeuclidean": 1, "cosine": 2}
_LINKAGES = {"single": 0, "complete": 1, "average": 2, "weighted": 3}


def dtw_batch_cpu(
    a: np.ndarray,            # [B, S, d] f32 padded
    b: np.ndarray,
    len_a: np.ndarray,
    len_b: np.ndarray,
    *,
    metric: str = "euclidean",
    band: int | None = None,
    auto_widen: bool = True,
    normalize: str = "none",
    n_threads: int = 0,       # 0 = all cores, 1 = single-core baseline
    band_mode: str = "widen",
) -> np.ndarray:
    """Native CPU batched DTW — the Rust-reference-equivalent baseline."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    la = np.ascontiguousarray(len_a, dtype=np.int32)
    lb = np.ascontiguousarray(len_b, dtype=np.int32)
    B, S, d = a.shape
    if b.shape != a.shape:
        raise ValueError(f"b shape {b.shape} != a shape {a.shape}")
    if la.shape != (B,) or lb.shape != (B,):
        raise ValueError("length vectors must be [B]")
    if (la > S).any() or (lb > S).any() or (la < 0).any() or (lb < 0).any():
        raise ValueError("lengths must be within [0, S]")
    out = np.empty(B, dtype=np.float32)
    lib.apd_dtw_batch(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        la.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        B,
        S,
        d,
        -1 if band is None else int(band),
        _METRICS[metric],
        int(auto_widen),
        1 if normalize == "path_len" else 0,
        n_threads,
        1 if band_mode == "diag" else 0,
    )
    return out


def nn_chain_cpp(dist: np.ndarray, method: str = "average") -> np.ndarray:
    """Raw merge rows (pre-sort/relabel) from the C++ NN-chain."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    D = np.ascontiguousarray(dist, dtype=np.float64)
    K = D.shape[0]
    Z = np.zeros((max(K - 1, 0), 4), dtype=np.float64)
    if K >= 2:
        rc = lib.apd_nn_chain(
            D.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            K,
            _LINKAGES[method],
            Z.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        if rc != 0:
            raise RuntimeError(f"apd_nn_chain failed: {rc}")
    return Z


def read_wav_pcm16(path: str | Path) -> tuple[np.ndarray, int] | None:
    """Native PCM16 WAV demux; None if unsupported format (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.frombuffer(Path(path).read_bytes(), dtype=np.uint8)
    rate = ctypes.c_int32(0)
    n = lib.apd_read_wav_pcm16(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(raw),
        None,
        ctypes.byref(rate),
    )
    if n < 0:
        return None
    out = np.empty(int(n), dtype=np.float32)
    lib.apd_read_wav_pcm16(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(rate),
    )
    return out, int(rate.value)


def load_wavs_batch(
    paths: list[str | Path],
    n_threads: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray] | None:
    """Parallel bulk WAV ingest (the native data loader, SS3 rows 1 & 11).

    Header-probes every file in parallel to size the padded batch, then
    reads + decodes all files with an OpenMP thread pool directly into the
    padded [B, max_len] float32 array the spectrogram op consumes.

    Returns (padded [B, N], lengths [B], rates [B]) or None if the library
    is unavailable or any file is not plain PCM16 (caller falls back to the
    Python reader, which handles 8/24/32-bit and float formats).
    """
    lib = get_lib()
    if lib is None or not paths:
        return None
    c_paths = (ctypes.c_char_p * len(paths))(
        *[str(p).encode() for p in paths]
    )
    n_samples = np.empty(len(paths), dtype=np.int64)
    rates = np.empty(len(paths), dtype=np.int32)
    rc = lib.apd_wav_info_batch(
        c_paths,
        len(paths),
        n_samples.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if rc != 0:
        return None
    # Streaming WAVs declare placeholder data sizes (0xFFFFFFFF); clamp each
    # count by what the file can physically hold (2 bytes/sample lower
    # bound) so one bogus header cannot size a multi-GB padded batch.
    sizes = np.array([Path(p).stat().st_size for p in paths], np.int64)
    n_samples = np.minimum(n_samples, np.maximum(sizes - 44, 0) // 2)
    stride = int(n_samples.max())
    # The batch pads every clip to the longest one; a very ragged corpus
    # (hours-long recording + many short clips) would allocate mostly
    # padding.  Bail to the per-file Python path when padding dominates or
    # the allocation is large.
    padded_bytes = 4 * len(paths) * stride
    real_bytes = 4 * int(n_samples.sum())
    if stride > 2**31 - 1 or (
        padded_bytes > 1 << 30 and padded_bytes > 4 * real_bytes
    ):
        return None
    if stride <= 0:
        return None
    out = np.zeros((len(paths), stride), dtype=np.float32)
    lengths = np.empty(len(paths), dtype=np.int32)
    rc = lib.apd_wav_load_batch(
        c_paths,
        len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        stride,
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_threads,
    )
    if rc != 0:
        return None
    return out, lengths, rates

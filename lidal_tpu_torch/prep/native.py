"""ctypes bindings for the native C++ prep components (port of
``lidal_tpu/prep/native.py``).

* :func:`vccs_cluster` — VCCS supervoxel clustering (replaces the reference's
  PCL binary, ``pcl_related/supervoxel_clustering.cpp``; no PCD round trip —
  arrays in, labels out).
* :func:`balanced_kmeans_native` — capacity-constrained k-means (the
  ``k_means_constrained`` replacement).

The sources are the repository's ``csrc/vccs.cpp`` and
``csrc/balanced_kmeans.cpp``.  The port neither loads the committed
``csrc/liblidal_native.so`` (``-march=native`` code of whichever host built
it) nor runs ``make -C csrc`` (which writes into that tree): at first use
:func:`load` compiles both sources with ``g++`` and the flags of
``csrc/Makefile`` into ``lidal_tpu_torch/_build/liblidal_native-<hash>.so``.
The hash covers the sources, the flags and what ``-march=native`` means on
this host, so a changed source, flag or CPU gets a new library.  A failed
build or load raises with the compiler's output; nothing falls back.  Nothing
is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
SOURCES = ("vccs.cpp", "balanced_kmeans.cpp")
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared")  # csrc/Makefile

_LIBS: dict = {}  # library path -> loaded library
_LOCK = threading.Lock()
# library path -> (seconds spent building, or 0.0 when it was already built; the compiler's output)
BUILD_LOG: dict = {}


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native prep library is built from csrc/*.cpp with g++")
    return found


@functools.lru_cache(maxsize=None)
def _native_target() -> str:
    """The options ``-march=native`` expands to on this host (g++'s cc1 line)."""
    proc = subprocess.run([_gxx(), "-march=native", "-E", "-v", "-x", "c++", os.devnull],
                          capture_output=True, text=True)
    return "\n".join(ln for ln in proc.stderr.splitlines() if "cc1" in ln and "-march" in ln)


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(CXXFLAGS).encode())
    h.update(_native_target().encode())
    return BUILD_DIR / f"liblidal_native-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_gxx(), *CXXFLAGS, "-o", str(tmp), *(str(CSRC / s) for s in SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the native prep library:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial library
    BUILD_LOG[so] = (time.perf_counter() - t0, proc.stderr)


def load() -> ctypes.CDLL:
    """The loaded native library, built first if needed."""
    with _LOCK:
        so = library_path()
        lib = _LIBS.get(so)
        if lib is not None:
            return lib
        if so.exists():
            BUILD_LOG.setdefault(so, (0.0, ""))
        else:
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.vccs_cluster.restype = ctypes.c_int
        lib.vccs_cluster.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_uint),
        ]
        lib.balanced_kmeans.restype = ctypes.c_int
        lib.balanced_kmeans.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_ulonglong,
            ctypes.POINTER(ctypes.c_int),
        ]
        _LIBS[so] = lib
        return lib


# Reference parameter defaults: pcl_related/supervoxel_clustering.cpp:44-66.
def vccs_cluster(
    xyz: np.ndarray,
    voxel_res: float = 0.5,
    seed_res: float = 10.0,
    color_w: float = 0.1,
    spatial_w: float = 0.4,
    normal_w: float = 1.0,
    iterations: int = 3,
) -> np.ndarray:
    """Per-point supervoxel labels (1-based; 0 = unassigned)."""
    lib = load()
    pts = np.ascontiguousarray(xyz, np.float32)
    n = len(pts)
    out = np.zeros(n, np.uint32)
    k = lib.vccs_cluster(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n),
        ctypes.c_float(voxel_res), ctypes.c_float(seed_res),
        ctypes.c_float(color_w), ctypes.c_float(spatial_w),
        ctypes.c_float(normal_w), ctypes.c_int(iterations),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
    )
    if k < 0:
        raise RuntimeError("vccs_cluster failed")
    return out.astype(np.int64)


def balanced_kmeans_native(
    xyz: np.ndarray,
    n_clusters: int = 20,
    size_tol: float = 0.05,
    lloyd_iters: int = 1,
    seed: int = 0,
) -> np.ndarray:
    """Capacity-constrained k-means labels [n] int32."""
    lib = load()
    pts = np.ascontiguousarray(xyz, np.float32)
    n = len(pts)
    out = np.zeros(n, np.int32)
    k = lib.balanced_kmeans(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_longlong(n), ctypes.c_int(n_clusters),
        ctypes.c_float(size_tol), ctypes.c_int(lloyd_iters),
        ctypes.c_ulonglong(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    if k < 0:
        raise RuntimeError("balanced_kmeans failed")
    return out

"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), named
after a hash of its source, the shared headers ``csrc/*.cuh`` and the flags
under ``lidal_tpu_torch/_build/``.  A changed source or header gets a new hash
and is rebuilt; an unchanged one is loaded from the existing library.  Every
exported C function returns ``cudaGetLastError()`` after its launch, and the
Python wrappers raise when that is not 0.

Nothing here runs at import: :func:`load` is called by the kernel wrappers the
first time a CUDA tensor reaches them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # per-kernel registers / shared memory / spills, kept in BUILD_LOG
)

_LIBS: dict = {}
_FUNCTIONS: dict = {}  # (library, symbol) -> ctypes function with its argument types set
_BUILD_LOCKS: dict = {}  # name -> lock: one build per library, whichever thread asks first
_BUILD_LOCKS_GUARD = threading.Lock()
# name -> (seconds spent building, or 0.0 when the library was already built;
#          the compiler's resource report, kept beside the library)
BUILD_LOG: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built from source with the CUDA toolkit")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCKS_GUARD:
        lock = _BUILD_LOCKS.setdefault(name, threading.Lock())
    with lock:
        return _LIBS.get(name) or _build_and_load(name)


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of ``csrc/<name>.cu`` (built first if needed),
    taking ``argtypes`` and returning an int, set up once and then reused."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


def load_all(names) -> None:
    """Build (one ``nvcc`` each, all started together) and load several libraries."""
    threads = [threading.Thread(target=load, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for n in names:
        load(n)  # raises here what a thread's build raised


def _build_and_load(name: str) -> ctypes.CDLL:
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    seconds, report = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True,
            text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stdout}\n{proc.stderr}")
        report = proc.stderr
        so.with_suffix(".ptxas.txt").write_text(report)
        os.replace(tmp, so)  # atomic: a concurrent loader never sees a partial library
    elif so.with_suffix(".ptxas.txt").exists():
        report = so.with_suffix(".ptxas.txt").read_text()
    lib = ctypes.CDLL(str(so))
    _LIBS[name] = lib
    BUILD_LOG[name] = (seconds, report)
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")

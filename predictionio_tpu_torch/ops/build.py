"""Build and load the port's hand-written CUDA kernels.

Every ``ops/csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, loaded with ``ctypes``.
Nothing includes PyTorch's headers, so a build takes seconds.  Libraries
land in ``ops/_build/`` (ignored by git), keyed by a hash of the source's
content, at first use: a checkout builds what it runs.  ``build_all``
starts one ``nvcc`` per source, all at once.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC_DIR = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: argtypes of each library's entry point: every pointer and the stream are
#: c_void_p (an int argtype would cut a 64-bit pointer to 32 bits)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # u, v, mask, mask_is_f32, mask_ld, bias, has_bias, out, B, I, K, route, stream
    "masked_score": ("pio_masked_score",
                     [_P, _P, _P, _I, _L, _P, _I, _P, _I, _I, _I, _P, _P]),
    # counts, ld, row_marg, col_marg, n_total, threshold, out, R, C, stream
    "llr_masked": ("pio_llr_masked", [_P, _L, _P, _P, _F, _F, _P, _I, _I, _P]),
    # scores, ld, R, W, b, id_offset, carry_s, carry_i, out_s, out_i, stream
    "tile_topk": ("pio_tile_topk", [_P, _L, _I, _I, _I, _I, _P, _P, _P, _P, _P]),
    # m, ld, out, R, C, accumulate, stream
    "row_count": ("pio_row_count", [_P, _L, _P, _I, _I, _I, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: ptxas report (registers, shared memory, spills) of each build this process ran
build_logs: Dict[str, str] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from source at first use")


def source(name: str) -> Path:
    return CSRC_DIR / f"{name}.cu"


def artifact(name: str) -> Path:
    key = hashlib.sha256(source(name).read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start the build of ``name`` unless its artifact exists."""
    so = artifact(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    return subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen, timeout: float) -> None:
    so = artifact(name)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    log, _ = proc.communicate(timeout=timeout)
    build_logs[name] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source(name)}:\n{log}")
    # rename into place: a concurrent build never loads a half-written file
    tmp.replace(so)


def build_all(names: Optional[List[str]] = None, timeout: float = 600) -> float:
    """Build every kernel (default: all of ``SIGNATURES``) with one ``nvcc``
    each, started together; returns the wall seconds taken.  Processes that
    find a library missing build under one file lock (the ranks of a
    multi-process train): the first builds, the others wait and find it
    built."""
    t0 = time.perf_counter()
    names = names or list(SIGNATURES)
    with _lock:
        if all(artifact(n).exists() for n in names):
            return time.perf_counter() - t0
        BUILD_DIR.mkdir(exist_ok=True)
        with open(BUILD_DIR / ".build.lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            procs = {n: _start(n) for n in names}
            try:
                for n, p in procs.items():
                    if p is not None:
                        _finish(n, p, timeout)
            finally:   # a failed or timed-out build leaves no nvcc running
                for p in procs.values():
                    if p is not None and p.poll() is None:
                        p.kill()
                        p.wait()
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all([name])
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(artifact(name)))
            fn_name, argtypes = SIGNATURES[name]
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[name] = lib
    return lib

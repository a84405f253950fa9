"""Build the port's native host code at first use: the event-log scanner
(``scanner.py``) and the scan core's header parse (``core.py``).

Counterpart of ``predictionio_tpu/native/build.py``.  ``<stem>-<key>.so``
lands in ``native/_build/`` (ignored by git), keyed by a SHA-256 of the
C++ source's content, so an edited source never loads a stale library.
Each build writes a temporary name of its own process and renames it into
place with ``os.replace``: two processes building at once both load a
whole library (a shared temporary name lets one rename the other's file
while it is still being written).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

log = logging.getLogger("pio.native")

BUILD_DIR = Path(__file__).parent / "_build"

_CXX_CANDIDATES = ("g++", "c++", "clang++")
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def compiler() -> Optional[str]:
    """The first C++ compiler on PATH, or None (no toolchain)."""
    for cxx in _CXX_CANDIDATES:
        if shutil.which(cxx):
            return cxx
    return None


def source_key(src: Path) -> str:
    """Content hash of ``src``, the build-cache key (its first 16 hex
    characters)."""
    return hashlib.sha256(src.read_bytes()).hexdigest()[:16]


def artifact_path(src: Path, stem: str) -> Path:
    key = source_key(src)
    return BUILD_DIR / f"{stem}-{key}.so"


def build(src: Path, stem: str, timeout: int = 300) -> Path:
    """Compile ``src`` into its content-keyed library unless it exists;
    raises when there is no compiler or the build fails."""
    so = artifact_path(src, stem)
    if so.exists():
        return so
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler on PATH")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=timeout)
        os.replace(tmp, so)
    finally:
        tmp.unlink(missing_ok=True)
    return so


def load(src: Path, stem: str) -> Optional[ctypes.CDLL]:
    """Build if needed and load; None when there is no compiler or the
    build or the load fails (the caller then takes its Python path)."""
    try:
        return ctypes.CDLL(str(build(src, stem)))
    except Exception as e:
        log.warning("native %s unavailable (%s); using the Python path", stem, e)
        return None

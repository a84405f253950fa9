"""The JAX package's native libraries, built once under a file lock, and
a JAX loader that lost the build's race probed again.

The JAX build (``predictionio_tpu/native/build.py``) compiles into one
temporary file a library that every process shares, so two processes that
build it at once can lose the race: the loser's scanner marks itself failed
for the life of the process (``scanner._load_failed``).  In an xdist worker
that loses it, every JAX training read falls back to ``find``, which sorts
by event time, while the port's native read and the JAX fold keep the log
order: the dictionaries then differ in order and the indicator tables come
out permuted (``test_torch_cco_scale``'s JAX-written-store case and two
cases of ``test_streaming_follow``).

The JAX test modules that build at import (``test_native_cores``,
``test_native_scanner``) are collected before any port test module, so
every worker races there first.  When this module is imported (every
worker collects every test file before it runs one) it builds both JAX
libraries with the JAX package's own ``build.build`` under an ``flock``
(a library a lost race left missing is built once), waits until each
library in place loads (a losing build may still be writing into it), and
then a JAX loader that recorded a failure is probed again
(``scanner._load_failed`` cleared, ``core.reset_for_tests``), as
``tests/test_torch_native.py``'s fixture does for its own tests.  The
port's build is untouched (it renames a temporary file of its own process).
"""

import ctypes
import fcntl
import subprocess
import time
import warnings

from predictionio_tpu.native import build as _jax_build
from predictionio_tpu.native import core as _jax_core
from predictionio_tpu.native import scanner as _jax_scanner

# a racing build that lost still writes into the library's inode for a
# few seconds after the winner's rename: wait this long for it to load
_SETTLE_S = 120.0


def _settled(src, stem):
    """Build ``stem`` if it is missing, then wait until the library in
    place loads; one that never does is removed and built again."""
    so = _jax_build.build(src, stem)
    deadline = time.monotonic() + _SETTLE_S
    while True:
        try:
            ctypes.CDLL(str(so))
            return so
        except OSError:
            if time.monotonic() > deadline:
                so.unlink(missing_ok=True)
                return _jax_build.build(src, stem)
            time.sleep(0.25)


def prebuild_jax_native() -> bool:
    """Build ``libeventscan`` and ``libdataplane`` of the JAX package into
    its ``native/_build`` under the lock, wait until each loads, then let a
    loader that failed during a lost race load them; False without a C++
    compiler (the JAX package then reads in Python)."""
    if _jax_build.compiler() is None:
        return False
    _jax_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_jax_build.BUILD_DIR / "prebuild.lock", "a") as lockf:
        fcntl.flock(lockf.fileno(), fcntl.LOCK_EX)
        _settled(_jax_scanner._SRC, "libeventscan")
        _settled(_jax_core._SRC, _jax_core._STEM)
    if _jax_scanner._load_failed:
        _jax_scanner._load_failed = False
    if _jax_core._lib_tried and _jax_core._lib is None:
        _jax_core.reset_for_tests()
    return True


try:
    prebuild_jax_native()
except (OSError, RuntimeError, subprocess.SubprocessError) as e:
    # collection goes on: the JAX package builds (or reads in Python) at
    # first use, as it would without this module
    warnings.warn(f"prebuilding the JAX native libraries failed: {e!r}")

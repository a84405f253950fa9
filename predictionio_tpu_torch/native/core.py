"""``PIO_NATIVE`` and the ctypes bindings of the scan core's header parse.

Counterpart of ``predictionio_tpu/native/core.py``, its scan core's
columnar header parse only (``data_plane.cpp``): ``read_batch`` of a
PIOCOL01 snapshot hands the JSON header to C, which returns the column
specs, the dictionaries as undecoded UTF-8 blobs and the span of ``meta``;
the GIL is released for the call.  The knob keeps the JAX package's
meaning, re-read on every call:

- ``PIO_NATIVE=auto`` (default): the native parse where the library builds
  and loads, else the Python parse (``json.loads``), silently;
- ``PIO_NATIVE=on``: the same, and a library that never loaded is counted
  as a ``no_build`` fallback, once per core;
- ``PIO_NATIVE=off``: the Python parse, always (the parity oracle).

The library builds with the host's C++ compiler at first use
(``native/build.py``, into ``native/_build/``); with no compiler
``scan_enabled()`` is False and the Python parse answers.  The JAX
package's metrics registry is not ported yet (ROADMAP.md, queue A,
'Event-loop server and micro-batcher'), so the counts are module-level:
``calls`` (operations a native core served, by core), ``fallbacks`` (by
reason: ``no_build``, ``error``, ``unsupported``) and ``active``.  Its
dictionary-union handles (``BatchMerger``), serve core and HTTP core are
not here.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from predictionio_tpu_torch.native import build as _build

_SRC = Path(__file__).parent / "data_plane.cpp"
_STEM = "libdataplane"
_ABI_VERSION = 1

#: logical operations served by a native core, by core
calls: Dict[str, int] = {"scan": 0}
#: operations the Python path answered instead, by reason
fallbacks: Dict[str, int] = {"no_build": 0, "error": 0, "unsupported": 0}
#: True while the native library is loaded and enabled (None: not asked yet)
active: Optional[bool] = None

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_no_build_counted: set = set()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
#: (name, argtypes, restype) of every entry point used here
_SIGNATURES = [
    ("dp_abi_version", [], _I64),
    ("dp_col_parse", [ctypes.c_char_p, _I64], _P),
    ("dp_col_free", [_P], None),
    ("dp_col_rows", [_P], _I64),
    ("dp_col_spec", [_P, _INT, _P], _INT),
    ("dp_col_dict_n", [_P, _INT], _I64),
    ("dp_col_dict_bytes", [_P, _INT], _I64),
    ("dp_col_dict_copy", [_P, _INT, _P, _P], None),
    ("dp_col_nprops", [_P], _I64),
    ("dp_col_prop_key_bytes", [_P, _I64], _I64),
    ("dp_col_prop_key_copy", [_P, _I64, _P], None),
    ("dp_col_prop_spec", [_P, _I64, _INT, _P], _INT),
    ("dp_col_prop_dict_n", [_P, _I64], _I64),
    ("dp_col_prop_dict_bytes", [_P, _I64], _I64),
    ("dp_col_prop_dict_copy", [_P, _I64, _P, _P], None),
    ("dp_col_meta_span", [_P, _P], None),
]


def mode() -> str:
    """The knob: "auto" | "on" | "off" (re-read on every call)."""
    v = os.environ.get("PIO_NATIVE", "auto").strip().lower()
    if v in ("off", "0", "false", "no"):
        return "off"
    if v in ("on", "1", "true", "yes"):
        return "on"
    return "auto"


def _bind(lib: ctypes.CDLL) -> None:
    for name, argtypes, restype in _SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None without a
    compiler or when the build, the load or the ABI check fails."""
    global _lib, _lib_tried
    if not _lib_tried:
        with _lock:
            if not _lib_tried:
                loaded = _build.load(_SRC, _STEM)
                if loaded is not None:
                    try:
                        _bind(loaded)
                        if loaded.dp_abi_version() != _ABI_VERSION:
                            loaded = None
                    except Exception:
                        loaded = None
                _lib = loaded
                _lib_tried = True
    return _lib


def reset_for_tests() -> None:
    """Forget the loaded library, so a test can simulate a host without a
    compiler (``build.load`` patched to None) or force a rebuild."""
    global _lib, _lib_tried, active
    with _lock:
        _lib = None
        _lib_tried = False
        active = None
        _no_build_counted.clear()


def _enabled(core: str) -> bool:
    global active
    if mode() == "off":
        active = False
        return False
    ok = lib() is not None
    if not ok and core not in _no_build_counted:
        # wanted (auto or on) but never loaded: one mark a core a process
        _no_build_counted.add(core)
        fallbacks["no_build"] += 1
    active = ok
    return ok


def scan_enabled() -> bool:
    return _enabled("scan")


def note_call(core: str) -> None:
    calls[core] = calls.get(core, 0) + 1


def note_fallback(reason: str) -> None:
    fallbacks[reason] = fallbacks.get(reason, 0) + 1


def _ptr(arr: np.ndarray):
    return _P(arr.ctypes.data)


class ColumnarHeader:
    """A PIOCOL01 JSON header parsed in C.  ``parse`` returns None when
    the parser declines the header (an unknown layout, or corrupt); the
    caller then reads it with ``json.loads``, which reads it or raises."""

    __slots__ = ("_h", "_lib")

    def __init__(self, handle, lib_):
        self._h = handle
        self._lib = lib_

    @classmethod
    def parse(cls, header_bytes: bytes) -> Optional["ColumnarHeader"]:
        L = lib()
        if L is None:
            return None
        h = L.dp_col_parse(header_bytes, len(header_bytes))
        return cls(h, L) if h else None

    def __del__(self):
        try:
            if self._h:
                self._lib.dp_col_free(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def rows(self) -> int:
        return int(self._lib.dp_col_rows(self._h))

    def spec(self, which: int) -> Optional[Tuple[int, int]]:
        """(n, off) of fixed column 0..5, the ids blob 6, the ids offsets 7."""
        out = np.empty(2, np.int64)
        if self._lib.dp_col_spec(self._h, which, _ptr(out)) != 0:
            return None
        return int(out[0]), int(out[1])

    def _blob(self, n: int, nb: int, copy) -> Tuple[bytes, np.ndarray]:
        blob = ctypes.create_string_buffer(nb if nb else 1)
        offs = np.empty(n + 1, np.int64)
        copy(blob, _ptr(offs))
        return blob.raw[:nb], offs

    def dict_blob(self, which: int) -> Tuple[bytes, np.ndarray]:
        """Dictionary 0 event, 1 entity type, 2 entity, 3 target."""
        L, h = self._lib, self._h
        return self._blob(int(L.dp_col_dict_n(h, which)), int(L.dp_col_dict_bytes(h, which)),
                          lambda b, o: L.dp_col_dict_copy(h, which, b, o))

    @property
    def nprops(self) -> int:
        return int(self._lib.dp_col_nprops(self._h))

    def prop_key(self, i: int) -> str:
        nb = int(self._lib.dp_col_prop_key_bytes(self._h, i))
        buf = ctypes.create_string_buffer(nb if nb else 1)
        self._lib.dp_col_prop_key_copy(self._h, i, buf)
        return buf.raw[:nb].decode("utf-8", "surrogatepass")

    def prop_spec(self, i: int, which: int) -> Optional[Tuple[int, int]]:
        """(n, off): 0 rows, 1 kind, 2 num, 3 str_offs, 4 codes."""
        out = np.empty(2, np.int64)
        if self._lib.dp_col_prop_spec(self._h, i, which, _ptr(out)) != 0:
            return None
        return int(out[0]), int(out[1])

    def prop_dict_blob(self, i: int) -> Tuple[bytes, np.ndarray]:
        L, h = self._lib, self._h
        return self._blob(int(L.dp_col_prop_dict_n(h, i)), int(L.dp_col_prop_dict_bytes(h, i)),
                          lambda b, o: L.dp_col_prop_dict_copy(h, i, b, o))

    def meta_span(self) -> Optional[Tuple[int, int]]:
        """(offset, length) of the raw ``meta`` value in the header bytes."""
        out = np.empty(2, np.int64)
        self._lib.dp_col_meta_span(self._h, _ptr(out))
        if out[0] < 0:
            return None
        return int(out[0]), int(out[1])

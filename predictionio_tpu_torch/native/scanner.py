"""ctypes bindings of the native event-log scanner.

Counterpart of ``predictionio_tpu/native/scanner.py``: ``scan_segments``
parses JSON-lines segments into one ``EventBatch`` with its property
columns, one thread per segment, and ``layout_chunks`` groups CCO
training's (user, item) pairs into user blocks in one O(n) counting pass,
both from ``eventlog_scanner.cpp`` built at first use (``native/build.py``).
Without a C++ compiler ``native_available()`` is False: ``PEventStore``
reads the rows in Python and ``ops.cco.block_interactions`` lays the
blocks out with numpy, as the JAX package does.

``scans_served`` counts the batches ``scan_segments`` returned in this
process (the JAX package's ``pio_native_calls_total{core="scan"}``).
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

from predictionio_tpu_torch.native import build as _native_build

log = logging.getLogger("pio.native")

_SRC = Path(__file__).parent / "eventlog_scanner.cpp"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
scans_served = 0

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
#: (name, argtypes, restype) of every entry point used here
_SIGNATURES = [
    ("scan_new", [], _P),
    ("scan_add_file", [_P, ctypes.c_char_p], None),
    ("scan_run", [_P, ctypes.c_int], _I64),
    ("scan_error", [_P], ctypes.c_char_p),
    ("scan_free", [_P], None),
    ("scan_col_event", [_P], ctypes.POINTER(ctypes.c_int32)),
    ("scan_col_entity_type", [_P], ctypes.POINTER(ctypes.c_int32)),
    ("scan_col_entity", [_P], ctypes.POINTER(ctypes.c_int32)),
    ("scan_col_target", [_P], ctypes.POINTER(ctypes.c_int32)),
    ("scan_col_time", [_P], ctypes.POINTER(ctypes.c_int64)),
    ("scan_col_rating", [_P], ctypes.POINTER(ctypes.c_float)),
    ("scan_dict_size", [_P, ctypes.c_int], _I64),
    ("scan_dict_export", [_P, ctypes.c_int], _I64),
    ("scan_dict_blob", [_P], ctypes.POINTER(ctypes.c_char)),
    ("scan_dict_offsets", [_P], ctypes.POINTER(ctypes.c_int64)),
    ("scan_prop_count", [_P], _I64),
    ("scan_prop_key", [_P, ctypes.c_int], ctypes.POINTER(ctypes.c_char)),
    ("scan_prop_key_len", [_P, ctypes.c_int], _I64),
    ("scan_prop_rows", [_P, ctypes.c_int], ctypes.POINTER(ctypes.c_int64)),
    ("scan_prop_kind", [_P, ctypes.c_int], ctypes.POINTER(ctypes.c_int8)),
    ("scan_prop_num", [_P, ctypes.c_int], ctypes.POINTER(ctypes.c_double)),
    ("scan_prop_stroffs", [_P, ctypes.c_int], ctypes.POINTER(ctypes.c_int64)),
    ("scan_prop_codes", [_P, ctypes.c_int], ctypes.POINTER(ctypes.c_int32)),
    ("scan_prop_len", [_P, ctypes.c_int], _I64),
    ("scan_prop_codes_len", [_P, ctypes.c_int], _I64),
    ("scan_prop_dict_size", [_P, ctypes.c_int], _I64),
    ("scan_prop_dict_export", [_P, ctypes.c_int], _I64),
    ("layout_width", [_P, _I64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32], _I64),
    ("layout_fill", [_P, _P, _I64, ctypes.c_int32, ctypes.c_int32, _I64, _P, _P, _P],
     ctypes.c_int32),
]


def _build_and_load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        lib = _native_build.load(_SRC, "libeventscan")   # None: no compiler, or it failed
        if lib is None:
            log.warning("native scanner unavailable; using the Python path")
            _load_failed = True
            return None
        for name, argtypes, restype in _SIGNATURES:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = lib
        return _lib


def native_available() -> bool:
    return _build_and_load() is not None


def _decode(b: bytes) -> str:
    # surrogatepass: JSON may carry lone surrogates (Python's own json
    # writes them); anything else malformed decodes with replacement
    try:
        return b.decode("utf-8", "surrogatepass")
    except UnicodeDecodeError:
        return b.decode("utf-8", "replace")


def _strings(lib, handle, n: int, blob_len: int) -> List[str]:
    """The ``n`` strings of the dictionary the last ``*_export`` call laid
    out in the scanner's blob."""
    if n <= 0 or blob_len < 0:
        return []
    offsets = np.ctypeslib.as_array(lib.scan_dict_offsets(handle), shape=(n + 1,)).copy()
    blob = ctypes.string_at(lib.scan_dict_blob(handle), blob_len)
    return [_decode(blob[offsets[i]:offsets[i + 1]]) for i in range(n)]


def scan_segments(paths: Sequence[os.PathLike], n_threads: int = 0):
    """Parse JSON-lines event segments into one ``EventBatch`` with
    ``prop_columns``, rows in segment order, then line order."""
    global scans_served
    from predictionio_tpu_torch.store.columnar import EventBatch, IdDict, PropColumn

    lib = _build_and_load()
    if lib is None:
        raise RuntimeError("native scanner unavailable")
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 4, 16)
    handle = lib.scan_new()
    try:
        for p in paths:
            lib.scan_add_file(handle, str(p).encode())
        rows = lib.scan_run(handle, n_threads)
        if rows < 0:
            raise RuntimeError(lib.scan_error(handle).decode())

        def arr(ptr, n, dtype):
            if n == 0:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).astype(dtype, copy=True)

        def dictionary(which):
            n = lib.scan_dict_size(handle, which)
            return IdDict.from_state(_strings(lib, handle, n, lib.scan_dict_export(handle, which)))

        props = {}
        for k in range(lib.scan_prop_count(handle)):
            key = ctypes.string_at(lib.scan_prop_key(handle, k), lib.scan_prop_key_len(handle, k))
            n = lib.scan_prop_len(handle, k)
            nd = lib.scan_prop_dict_size(handle, k)
            strings = _strings(lib, handle, nd, lib.scan_prop_dict_export(handle, k))
            props[_decode(key)] = PropColumn(
                rows=arr(lib.scan_prop_rows(handle, k), n, np.int64),
                kind=arr(lib.scan_prop_kind(handle, k), n, np.int8),
                num=arr(lib.scan_prop_num(handle, k), n, np.float64),
                str_offs=(arr(lib.scan_prop_stroffs(handle, k), n + 1, np.int64)
                          if n else np.zeros(1, np.int64)),
                codes=arr(lib.scan_prop_codes(handle, k),
                          lib.scan_prop_codes_len(handle, k), np.int32),
                dict=IdDict.from_state(strings),
            )
        batch = EventBatch(
            event_codes=arr(lib.scan_col_event(handle), rows, np.int32),
            entity_type_codes=arr(lib.scan_col_entity_type(handle), rows, np.int32),
            entity_ids=arr(lib.scan_col_entity(handle), rows, np.int32),
            target_ids=arr(lib.scan_col_target(handle), rows, np.int32),
            times_us=arr(lib.scan_col_time(handle), rows, np.int64),
            ratings=arr(lib.scan_col_rating(handle), rows, np.float32),
            event_dict=dictionary(0),
            entity_type_dict=dictionary(1),
            entity_dict=dictionary(2),
            target_dict=dictionary(3),
            prop_columns=props,
        )
    finally:
        lib.scan_free(handle)
    scans_served += 1
    return batch


def layout_chunks(user, item, chunk: int, n_chunks: int, pad_multiple: int = 8):
    """Chunk-grouped COO layout through the native O(n) counting pass:
    (lu [n_chunks, width], it [n_chunks, width], cnt [n_chunks]), int32, a
    chunk's pairs in input order, zeros past its count.  None only when the
    native library is unavailable (the caller lays out with numpy); a
    length mismatch or a user id outside [0, chunk * n_chunks) raises."""
    lib = _build_and_load()
    if lib is None:
        return None
    user = np.ascontiguousarray(user, np.int32)
    item = np.ascontiguousarray(item, np.int32)
    if len(user) != len(item):
        raise ValueError(f"user/item length mismatch: {len(user)} vs {len(item)}")
    n = len(user)
    width = lib.layout_width(user.ctypes.data, n, chunk, n_chunks, pad_multiple)
    if width < 0:
        raise ValueError(f"user ids outside [0, {chunk * n_chunks}) in layout_chunks")
    lu = np.zeros((n_chunks, int(width)), np.int32)
    it = np.zeros((n_chunks, int(width)), np.int32)
    cnt = np.zeros(n_chunks, np.int32)
    rc = lib.layout_fill(user.ctypes.data, item.ctypes.data, n, chunk, n_chunks, width,
                         lu.ctypes.data, it.ctypes.data, cnt.ctypes.data)
    if rc != 0:
        raise ValueError(f"native layout_fill failed (rc={rc})")
    return lu, it, cnt

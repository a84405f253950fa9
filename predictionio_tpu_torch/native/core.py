"""``PIO_NATIVE`` and the ctypes bindings of the scan core's header parse,
the serve core and the HTTP core.

Counterpart of ``predictionio_tpu/native/core.py``, three of its cores
(``data_plane.cpp``): ``read_batch`` of a PIOCOL01 snapshot hands the JSON
header to C, which returns the column specs, the dictionaries as
undecoded UTF-8 blobs and the span of ``meta``; the UR's host serve tail
gathers posting lists, takes their unique union, accumulates scores and
takes top-ks in C (``csr_gather``, ``unique_i32``, ``score_accum``,
``topk_f32``; each bit for bit its numpy oracle); the event-loop front
end (``api/http_util.py``) parses request heads and assembles large
responses in C; ``store/columnar.BatchMerger`` unions the dictionaries of a
k-way merge (``DictHandle``) and gathers the re-coded columns
(``take_i32``) in C.  The GIL is released for every call.  The knob keeps the
JAX package's meaning, re-read on every call:

- ``PIO_NATIVE=auto`` (default): the native parse where the library builds
  and loads, else the Python parse (``json.loads``), silently;
- ``PIO_NATIVE=on``: the same, and a library that never loaded is counted
  as a ``no_build`` fallback, once per core;
- ``PIO_NATIVE=off``: the Python parse, always (the parity oracle).

The library builds with the host's C++ compiler at first use
(``native/build.py``, into ``native/_build/``); with no compiler
``scan_enabled()``/``serve_enabled()``/``http_enabled()`` are False and
the Python paths answer.  Metrics, the JAX package's families:
``pio_native_calls_total{core}`` (operations a native core served),
``pio_native_fallback_total{reason}`` (``no_build``, ``error``,
``unsupported``) and ``pio_native_active``; ``calls`` and ``fallbacks``
read them as dicts, and ``active`` is the last answer of the gate.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from predictionio_tpu_torch.native import build as _build
from predictionio_tpu_torch.obs import metrics as obs_metrics

_SRC = Path(__file__).parent / "data_plane.cpp"
_STEM = "libdataplane"
_ABI_VERSION = 4

_M_ACTIVE = obs_metrics.get_registry().gauge(
    "pio_native_active",
    "1 while the native data-plane cores are loaded and engaged")
_M_CALLS = obs_metrics.get_registry().counter(
    "pio_native_calls_total",
    "Logical operations served by a native core, by core (scan/serve/http)")
_M_FALLBACK = obs_metrics.get_registry().counter(
    "pio_native_fallback_total",
    "Data-plane operations answered by the Python oracle instead of a "
    "native core, by reason (no_build/error/unsupported)")

#: logical operations served by a native core, by core (registry view)
calls = obs_metrics.SeriesView(
    {c: (_M_CALLS, {"core": c}) for c in ("scan", "serve", "http")})
#: operations the Python path answered instead, by reason (registry view)
fallbacks = obs_metrics.SeriesView(
    {r: (_M_FALLBACK, {"reason": r}) for r in ("no_build", "error", "unsupported")})
#: True while the native library is loaded and enabled (None: not asked yet)
active: Optional[bool] = None

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_no_build_counted: set = set()

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_F32 = ctypes.c_float
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
    ("dp_dict_new", [], _P),
    ("dp_dict_free", [_P], None),
    ("dp_dict_len", [_P], _I64),
    ("dp_dict_union", [_P, ctypes.c_char_p, _P, _I64, _P], _I64),
    ("dp_dict_export", [_P, _I64], _I64),
    ("dp_dict_export_blob", [_P], _P),
    ("dp_dict_export_offs", [_P], _P),
    ("dp_take_i32", [_P, _I64, _P, _I64, _P, _INT], _INT),
    ("dp_csr_gather_size", [_P, _I64, _P, _I64], _I64),
    ("dp_csr_gather", [_P, _I64, _P, _I64, _P, _P, _P, _P], _I64),
    ("dp_unique_i32", [_P, _I64, _P], _I64),
    ("dp_score_accum", [_P, _I64, _P, _I64, _P, _F32, _P, _P, _INT], None),
    ("dp_topk_f32", [_P, _I64, _I64, _P, _P], None),
    ("dp_http_parse", [ctypes.c_char_p, _I64, _I64, _P, _P], _INT),
    ("dp_http_assemble", [ctypes.c_char_p, _I64, ctypes.c_char_p, _I64,
                          ctypes.c_char_p, _I64, ctypes.c_char_p, _I64, _P, _I64], _I64),
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
        if active is not False:
            _M_ACTIVE.set(0.0)
        active = False
        return False
    ok = lib() is not None
    if not ok and core not in _no_build_counted:
        # wanted (auto or on) but never loaded: one mark a core a process
        _no_build_counted.add(core)
        _M_FALLBACK.inc(reason="no_build")
    if active is not ok:
        _M_ACTIVE.set(1.0 if ok else 0.0)
    active = ok
    return ok


def scan_enabled() -> bool:
    return _enabled("scan")


def serve_enabled() -> bool:
    return _enabled("serve")


def http_enabled() -> bool:
    return _enabled("http")


def note_call(core: str) -> None:
    _M_CALLS.inc(core=core)


def note_fallback(reason: str) -> None:
    _M_FALLBACK.inc(reason=reason)


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


class DictHandle:
    """A native string dictionary of ``BatchMerger``'s k-way merge: codes
    in first-appearance order across its unions, the order of the Python
    path.  Raises RuntimeError where the library did not load."""

    __slots__ = ("_h", "_lib")

    def __init__(self):
        L = lib()
        if L is None:
            raise RuntimeError("native library unavailable")
        self._lib = L
        self._h = L.dp_dict_new()

    def __del__(self):
        try:
            if self._h:
                self._lib.dp_dict_free(self._h)
                self._h = None
        except Exception:
            pass

    def __len__(self) -> int:
        return int(self._lib.dp_dict_len(self._h))

    def union(self, blob: bytes, offs: np.ndarray) -> Tuple[np.ndarray, int]:
        """Union the ``len(offs) - 1`` strings of ``blob``: (their int32
        codes, how many were new)."""
        n = len(offs) - 1
        offs = np.ascontiguousarray(offs, np.int64)
        if n < 0 or (n and (offs[0] < 0 or offs[-1] > len(blob))):
            raise ValueError("offsets outside the blob")
        out = np.empty(n, np.int32)
        nnew = self._lib.dp_dict_union(self._h, blob, _ptr(offs), n, _ptr(out))
        return out, int(nnew)

    def export(self, start: int) -> Tuple[bytes, np.ndarray]:
        """Strings [start, len) as (UTF-8 blob, int64 offsets)."""
        nb = int(self._lib.dp_dict_export(self._h, start))
        if nb < 0:
            raise ValueError("bad export range")
        n = len(self) - start
        blob = ctypes.string_at(self._lib.dp_dict_export_blob(self._h), nb)
        offs = np.ctypeslib.as_array(
            ctypes.cast(self._lib.dp_dict_export_offs(self._h), ctypes.POINTER(_I64)),
            shape=(n + 1,)).copy()
        return blob, offs


def take_i32(cmap: np.ndarray, codes: np.ndarray, out: np.ndarray, sentinel: bool) -> bool:
    """``out[i] = cmap[codes[i]]`` in C; with ``sentinel`` a code -1 gives
    -1 (the merged ``target_ids``).  False at an out-of-range code, or an
    ``out`` that is not a writable contiguous int32 array of ``codes``'
    length: the caller runs the numpy oracle, which raises its IndexError."""
    L = lib()
    if (out.dtype != np.int32 or not out.flags.c_contiguous or not out.flags.writeable
            or len(out) != len(codes)):
        return False
    cmap = np.ascontiguousarray(cmap, np.int32)
    codes = np.ascontiguousarray(codes, np.int32)
    rc = L.dp_take_i32(_ptr(cmap), len(cmap), _ptr(codes), len(codes),
                       _ptr(out), 1 if sentinel else 0)
    return rc == 0


# ---------------------------------------------------------------------------
# serve core wrappers
# ---------------------------------------------------------------------------


def csr_gather(indptr: np.ndarray, ids: np.ndarray, rows: np.ndarray,
               w: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Native twin of ``models.common.gather_csr_rows`` for the serve
    tail's (int32 rows[, float32 weights]) columns: the same element
    order, the GIL dropped for both passes."""
    L = lib()
    indptr = np.ascontiguousarray(indptr, np.int64)
    ids = np.ascontiguousarray(ids, np.int64)
    rows = np.ascontiguousarray(rows, np.int32)
    n_rows = len(indptr) - 1
    total = int(L.dp_csr_gather_size(_ptr(indptr), n_rows, _ptr(ids), len(ids)))
    o0 = np.empty(total, np.int32)
    o1 = None
    w_ptr = o1_ptr = None
    if w is not None:
        w = np.ascontiguousarray(w, np.float32)
        o1 = np.empty(total, np.float32)
        w_ptr, o1_ptr = _ptr(w), _ptr(o1)
    if total:
        L.dp_csr_gather(_ptr(indptr), n_rows, _ptr(ids), len(ids),
                        _ptr(rows), w_ptr, _ptr(o0), o1_ptr)
    return o0, o1


def unique_i32(values: np.ndarray) -> np.ndarray:
    """Ascending unique int32 (``np.unique``'s set), GIL dropped."""
    L = lib()
    values = np.ascontiguousarray(values, np.int32)
    out = np.empty(len(values), np.int32)
    n = int(L.dp_unique_i32(_ptr(values), len(values), _ptr(out)))
    return out[:n].copy()


def score_accum(cand: np.ndarray, rows: np.ndarray, w: Optional[np.ndarray],
                weight: float, scratch: np.ndarray, out: np.ndarray,
                first: bool) -> None:
    """One event type's score accumulation over the compacted candidate
    space, into ``out`` (float32, len(cand)): bit for bit searchsorted +
    float64 bincount + float32 cast + float32 weight multiply + float32
    total add (see data_plane.cpp).  ``cand`` is ascending int32 and
    ``scratch`` a float64 workspace of len(cand)."""
    L = lib()
    cand = np.ascontiguousarray(cand, np.int32)
    rows = np.ascontiguousarray(rows, np.int32)
    w_ptr = None
    if w is not None:
        w = np.ascontiguousarray(w, np.float32)
        w_ptr = _ptr(w)
    L.dp_score_accum(_ptr(cand), len(cand), _ptr(rows), len(rows), w_ptr,
                     _F32(weight), _ptr(scratch), _ptr(out), 1 if first else 0)


def topk_f32(s: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """``host_topk_desc`` of a contiguous float32 vector (the same
    composite key, the same total order), GIL dropped."""
    L = lib()
    k = min(int(k), len(s))
    vals = np.empty(k, np.float32)
    idx = np.empty(k, np.int32)
    if k:
        L.dp_topk_f32(_ptr(s), len(s), k, _ptr(vals), _ptr(idx))
    return vals, idx


# ---------------------------------------------------------------------------
# http core wrappers
# ---------------------------------------------------------------------------

_HTTP_MAX_HEADERS = 100


def http_parse_head(head: bytes) -> Tuple[int, np.ndarray, np.ndarray]:
    """Parse one request head (bytes before the CRLFCRLF) natively.

    → (rc, out int64[9], spans int32[4 per header]); rc numbers the
    oracle's refusals in its exact first-error-wins order (see
    data_plane.cpp); rc 0 is a parsed request."""
    L = lib()
    out = np.empty(9, np.int64)
    # worst case one header per 3 bytes ("a:\r\n" is 4); +2 slots for the
    # request line edge and the trailing-empty-line edge
    max_spans = (len(head) // 3 + 2) * 4
    spans = np.empty(max(max_spans, 8), np.int32)
    rc = L.dp_http_parse(head, len(head), _HTTP_MAX_HEADERS,
                         _ptr(out), _ptr(spans))
    return int(rc), out, spans


def http_assemble(prefix: bytes, request_id: Optional[bytes], tail: bytes,
                  body: bytes) -> Optional[bytearray]:
    """Native response assembly: prefix + optional X-Request-ID line +
    Content-Length line + tail + body, one pre-sized buffer, GIL
    dropped.  Value-equal to the oracle's ``bytes`` join (a bytearray
    compares and sends identically)."""
    L = lib()
    rid = request_id or b""
    cap = len(prefix) + len(rid) + len(tail) + len(body) + 64
    buf = bytearray(cap)
    cbuf = (ctypes.c_char * cap).from_buffer(buf)
    n = L.dp_http_assemble(prefix, len(prefix), rid, len(rid),
                           tail, len(tail), body, len(body),
                           ctypes.addressof(cbuf), cap)
    del cbuf
    if n < 0:
        return None
    del buf[n:]
    return buf

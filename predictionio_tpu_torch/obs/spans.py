"""Structured span collection: train/eval journals and the building
block the request flight recorder (``obs.tracing``) shares (counterpart
of ``predictionio_tpu/obs/spans.py``; either package reads the other's
journals).

``utils.tracing.timed`` logged wall-clock spans and accumulated them in a
dict; :class:`SpanCollector` extends that into structured records with
parent/child links.  Two consumers build on it:

- :class:`SpanJournal` — one JSONL file per workflow run (train or
  eval), written next to the engine instances so ``pio dashboard`` can
  render the breakdown of every completed run;
- ``obs.tracing.Trace`` — the per-HTTP-request live trace of the flight
  recorder.

Parent/child structure comes from a per-thread stack: a span opened
while another is active on the same thread becomes its child.  The
ACTIVE journal travels via a contextvar, so any ``timed()`` call inside
``engine.train`` — engine code never imports this module — lands in the
run's journal automatically.

Journal location (:func:`spans_dir`): ``PIO_SPANS_DIR`` if set, else
``<storage localfs/sharedfs METADATA path>/spans/`` (next to the engine
instances), else ``~/.cache/predictionio_tpu/spans``.  File name is the
engine/evaluation instance id: ``<instance_id>.jsonl``.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional

_CURRENT: contextvars.ContextVar[Optional["SpanJournal"]] = (
    contextvars.ContextVar("pio_span_journal", default=None))


def current_journal() -> Optional["SpanJournal"]:
    return _CURRENT.get()


class SpanCollector:
    """Accumulates spans with parent/child links (per-thread stacks).

    Span record shape (shared by journals, traces, and the dashboard
    renderers): ``{id, parent, name, start, duration_s, end, attrs?,
    error?}`` — ``start``/``end`` are wall-clock epoch seconds,
    ``duration_s`` is measured on the monotonic clock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: List[dict] = []
        self._next_id = 1
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[dict]:
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
        stack = self._stack()
        parent = stack[-1] if stack else None
        rec = {"id": span_id, "parent": parent, "name": name,
               "start": time.time()}
        if attrs:
            rec["attrs"] = {k: v for k, v in attrs.items()}
        stack.append(span_id)
        t0 = time.perf_counter()
        try:
            yield rec
        except BaseException:
            rec["error"] = True
            raise
        finally:
            rec["duration_s"] = time.perf_counter() - t0
            rec["end"] = rec["start"] + rec["duration_s"]
            stack.pop()
            with self._lock:
                self._spans.append(rec)
            if parent is None:
                self._on_root_complete()

    def add_span(self, name: str, start: float, duration_s: float,
                 parent: Optional[int] = None,
                 attrs: Optional[dict] = None) -> dict:
        """Record an already-measured span (e.g. serve-tail stage laps
        reconstructed from accumulated wall times) without paying a
        contextmanager per stage on the hot path."""
        with self._lock:
            span_id = self._next_id
            self._next_id += 1
            rec = {"id": span_id, "parent": parent, "name": name,
                   "start": start, "duration_s": duration_s,
                   "end": start + duration_s}
            if attrs:
                rec["attrs"] = dict(attrs)
            self._spans.append(rec)
        return rec

    def spans(self) -> List[dict]:
        with self._lock:
            return sorted(self._spans, key=lambda s: s["id"])

    def _on_root_complete(self) -> None:
        """Hook: a top-level span just finished (journals flush here)."""


class SpanJournal(SpanCollector):
    """Collects spans for one run and persists them as JSONL
    incrementally: every completed ROOT span flushes the buffered
    records, so a crashed train/eval run keeps every phase that finished
    before the crash instead of losing the whole journal (the old
    write-once-at-close behavior)."""

    def __init__(self, path):
        super().__init__()
        self.path = Path(path)
        self._file = None
        self._flushed = 0   # count of spans already appended to the file

    def _on_root_complete(self) -> None:
        try:
            self.flush()
        except OSError:
            import logging

            logging.getLogger("pio.trace").exception(
                "span journal flush failed: %s", self.path)

    def flush(self) -> None:
        """Append every not-yet-persisted completed span to the file and
        flush to the OS, so a SIGKILLed process loses at most the spans
        still open (never a completed root and its children)."""
        with self._lock:
            pending = sorted(self._spans[self._flushed:],
                             key=lambda s: s["id"])
            self._flushed = len(self._spans)
            if not pending:
                return
            if self._file is None:
                self.path.parent.mkdir(parents=True, exist_ok=True)
                # "w": a journal owns its path for exactly one run; any
                # stale file from a recycled instance id must not prepend
                # a previous run's spans
                self._file = open(self.path, "w")
            for rec in pending:
                self._file.write(json.dumps(rec, sort_keys=True) + "\n")
            self._file.flush()

    def write(self) -> None:
        """Final drain + close (kept under its historical name: callers
        treat it as 'persist everything now')."""
        self.flush()
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None
            elif not self._spans:
                # a run that recorded nothing still leaves an empty
                # journal, preserving the old write()'s contract that the
                # file exists after a completed run
                self.path.parent.mkdir(parents=True, exist_ok=True)
                self.path.touch()

    @contextlib.contextmanager
    def activate(self) -> Iterator["SpanJournal"]:
        """Make this the process-current journal (timed() feeds it) for
        the duration; the journal is fully persisted on exit, success or
        not (and incrementally while running)."""
        token = _CURRENT.set(self)
        try:
            yield self
        finally:
            _CURRENT.reset(token)
            try:
                self.write()
            except OSError:
                import logging

                logging.getLogger("pio.trace").exception(
                    "span journal write failed: %s", self.path)


def read_journal(path) -> List[dict]:
    """Load a journal; missing file → [].  A torn final line (crash
    mid-append) is skipped, matching the incremental-append format."""
    p = Path(path)
    if not p.exists():
        return []
    out = []
    for line in p.read_text().splitlines():
        line = line.strip()
        if line:
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    return out


def spans_dir(storage=None) -> Path:
    """Where this deployment's span journals live (see module docstring
    for the precedence)."""
    env = os.environ.get("PIO_SPANS_DIR")
    if env:
        return Path(env)
    if storage is not None:
        try:
            src = storage.config.sources[storage.config.repositories["METADATA"]]
            if src.get("type") in ("localfs", "sharedfs") and src.get("path"):
                return Path(src["path"]) / "spans"
        except (KeyError, AttributeError):
            pass
    return Path.home() / ".cache" / "predictionio_tpu" / "spans"


def journal_path(storage, instance_id: str) -> Path:
    safe = "".join(c for c in instance_id if c.isalnum() or c in "_-")
    return spans_dir(storage) / f"{safe}.jsonl"

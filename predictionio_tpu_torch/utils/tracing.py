"""Tracing and profiling helpers (counterpart of
``predictionio_tpu/utils/tracing.py``).

``named_scope`` is a ``torch.profiler.record_function`` range (it shows
up in profiler timelines as the JAX scope shows up in xprof);
``profile_to`` records a ``torch.profiler`` trace of CPU activity and, when
CUDA is available, of the card's kernels, and writes it into a directory
as a Chrome trace; ``timed`` is a wall-clock span that feeds the workflow
logs and, when a span journal is active (``obs.spans``: ``pio train`` and
``pio eval`` activate one a run), lands in the journal as a structured
span with parent/child links, else in the live request trace.  Unlike the
JAX package's, ``timed`` also opens a ``record_function`` range of the
same name, so a ``torch.profiler`` trace shows the block, and keeps the
last spans the process closed (``recent_spans``).

One clock: the profiler's events carry Unix-epoch nanoseconds
(``start_ns``), as a journal span's ``start`` carries ``time.time()``
seconds and ``recent_spans`` ``time.time_ns()``, so the records of one
span agree on when it ran, and a span names what the host was doing in
an idle gap of the device's timeline.

The spans read the host clock.  A CUDA launch returns before its work
ends, so a ``timed`` block around a launch without a readback measures
the launch; the device's time lands in whichever block synchronises.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import time
from typing import Deque, Iterator, List, Optional, Tuple

log = logging.getLogger("pio.trace")

#: the spans ``timed`` closed last in this process, oldest first:
#: (start ns, end ns, name), start on the Unix-epoch clock
_RECENT: Deque[Tuple[int, int, str]] = collections.deque(maxlen=4096)


def recent_spans() -> List[Tuple[int, int, str]]:
    """The last spans ``timed`` closed in this process, oldest first, as
    (start ns, end ns, name) on the Unix-epoch clock of a profiler trace:
    a reader picks a traced window's spans by their times."""
    return list(_RECENT)


@contextlib.contextmanager
def named_scope(name: str) -> Iterator[None]:
    """A profiler-visible range (``torch.profiler.record_function``)."""
    import torch

    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def profile_to(log_dir: str, host_tracer_level: int = 2) -> Iterator[None]:
    """Record a ``torch.profiler`` trace of the block and write it into
    ``log_dir`` as ``trace-<pid>-<ns>.json`` (a Chrome trace, viewable in
    Perfetto or ``chrome://tracing``).

    CPU activity is always recorded, the card's when CUDA is available.
    ``host_tracer_level`` keeps the JAX signature: 0 records the card only
    (CPU activity too when there is no card), 1 and 2 record operators,
    3 adds their shapes and call stacks."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = []
    if host_tracer_level > 0 or not torch.cuda.is_available():
        activities.append(ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    verbose = host_tracer_level >= 3
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=verbose,
                 with_stack=verbose) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    path = os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profile written to %s", path)


@contextlib.contextmanager
def timed(name: str, sink: Optional[dict] = None) -> Iterator[None]:
    """Wall-clock span logged at INFO; optionally recorded into sink.

    ``sink[name]`` accumulates seconds across calls and
    ``sink[name + ".count"]`` the number of calls, so a sink consumer can
    tell one 10 s span from a thousand 10 ms ones.  When a span journal
    is active (obs.spans: train/eval runs), the block is also recorded
    there as a structured span (with parent/child nesting); otherwise,
    when a request trace is live (obs.tracing flight recorder), it lands
    in that trace's waterfall instead.  The block is a ``record_function``
    range of the same name too, and lands in ``recent_spans``.  Used as a
    decorator, it spans each call."""
    from torch.profiler import record_function

    from predictionio_tpu_torch.obs import spans as _spans
    from predictionio_tpu_torch.obs import tracing as _tracing

    sink_obj = _spans.current_journal() or _tracing.current_trace()
    ctx = sink_obj.span(name) if sink_obj is not None else contextlib.nullcontext()
    start_ns = time.time_ns()
    t0 = time.perf_counter_ns()
    try:
        with ctx, record_function(name):
            yield
    finally:
        dt_ns = time.perf_counter_ns() - t0
        _RECENT.append((start_ns, start_ns + dt_ns, name))
        dt = dt_ns / 1e9
        log.info("%s took %.3fs", name, dt)
        if sink is not None:
            sink[name] = sink.get(name, 0.0) + dt
            count_key = name + ".count"
            sink[count_key] = sink.get(count_key, 0) + 1

"""The device extents of the program's ``cco.dense`` ranges in a traced
window, for the dense route's readers.

The program opens one ``cco.dense`` span a dense run of an event type
(``ops/cco.py:_DenseRunner.dispatch``: the type's staging, chunk loop,
marginals, K2 and K3).  Its launches return before the card is done, so a
range's device extent runs from the first device activity it launched to
the end of the last, its K3 (``tile_topk_kernel``), which ends every dense
run.  On the card's one stream activities run in launch order, so a range's
first activity is the first that starts at or after the range's host start
and after the previous range's K3, and its end is the first K3 from there.
Spans are the program's record (``spans.window_spans``), on the clock of the
trace.  Where the card is idle when a range opens (a train's first), the
host's clock and the trace's device times may disagree by a few
milliseconds, and the range's first activities may then fall outside it; the
profiler's own device-side copies of the ranges, which the trace leaves
out, agreed with these extents to the nanosecond in three traced runs of
``ur_train.catalog8k`` on an NVIDIA H100, and in a fourth differed by
0.15-4.64 ms at 8 of its 9 trains' first starts and nowhere else.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from pio_bench import spans as spans_mod

DENSE_SPAN = "cco.dense"
#: the trace's class of the kernel that ends every dense run
END_CLASS = "k3"


def extents(trace, spans: Optional[Sequence[spans_mod.Span]] = None,
            ) -> List[Tuple[int, int]]:
    """(start ns, end ns) on the device of each ``cco.dense`` range in the
    window, in order; a range whose K3 the window lacks ends the list."""
    starts = sorted(s for s, _, n in spans_mod.window_spans(trace, spans)
                    if n == DENSE_SPAN)
    ops = trace.ops
    out: List[Tuple[int, int]] = []
    i = 0
    for s in starts:
        while i < len(ops) and ops[i].start_ns < s:
            i += 1
        j = i
        while j < len(ops) and ops[j].cls != END_CLASS:
            j += 1
        if j == len(ops):
            break
        out.append((ops[i].start_ns, ops[j].end_ns))
        i = j + 1
    return out


def window_extents(ctx) -> Optional[List[Tuple[int, int]]]:
    """The extents of a run's traced window when it holds one range for
    every event type of every train, else None."""
    if ctx.trace is None or ctx.steps == 0:
        return None
    got = extents(ctx.trace)
    if not got or len(got) != ctx.steps * len(ctx.cfg["event_types"]):
        return None
    return got


def busy_ns(trace, within: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds of device activity (the union of every kernel, copy and
    set) inside the intervals ``within``."""
    return sum(max(0, min(e, f) - max(s, r))
               for s, e, _ in trace.busy_intervals() for r, f in within)

"""Reduction of a ``torch.profiler`` trace of the measured window.

The harness marks the window and each step with ``record_function``
(``pio_bench.window``, ``pio_bench.step``).  From the profiler's events this
module keeps every device activity (kernels, copies, sets) inside the
window, names the CPU operator that launched it, and classes it:

- ``count_product``: launched by ``aten::_int_mm`` (the int8 count product
  of ``ops/cco.py:_count_product``), with the operator's input shapes;
- ``k2``, ``k3``: the kernels ``llr_masked_kernel`` (``ops/csrc/llr_masked.cu``)
  and ``tile_topk_kernel`` (``ops/csrc/tile_topk.cu``), by name;
- ``other``: everything else on the device.

Busy time is the union of the activities' intervals, so overlapping
activities count once.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, List, Optional, Tuple

WINDOW_MARK = "pio_bench.window"
STEP_MARK = "pio_bench.step"
COUNT_PRODUCT_OP = "aten::_int_mm"
KERNEL_CLASSES = (("k2", "llr_masked_kernel"), ("k3", "tile_topk_kernel"))
NAME_CHARS = 120


@dataclasses.dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    op: str = ""                              # the launching CPU operator
    shapes: Optional[List[List[int]]] = None  # its input shapes
    launch: int = 0                           # its correlation id
    cls: str = "other"


@dataclasses.dataclass
class Trace:
    window_ns: Tuple[int, int]
    ops: List[DeviceOp]                       # sorted by start
    host_ops: List[Tuple[int, int, str]]      # the window's thread, sorted by start

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def busy_intervals(self) -> List[Tuple[int, int, str]]:
        """Merged intervals of device activity, each with the name of the
        activity that opened it."""
        merged: List[List] = []
        for o in self.ops:
            if merged and o.start_ns <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], o.end_ns)
            else:
                merged.append([o.start_ns, o.end_ns, o.name])
        return [tuple(m) for m in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e, _ in self.busy_intervals()) / 1e9

    def class_s(self, cls: str) -> float:
        return sum(o.end_ns - o.start_ns for o in self.ops if o.cls == cls) / 1e9

    def count_product_launches(self) -> List[Tuple[Optional[List[List[int]]], float]]:
        """(input shapes, device seconds of every kernel it launched) of
        each count-product operator call."""
        calls: Dict[int, List] = {}
        for o in self.ops:
            if o.cls == "count_product":
                calls.setdefault(o.launch, [o.shapes, 0])[1] += o.end_ns - o.start_ns
        return [(shapes, ns / 1e9) for shapes, ns in calls.values()]

    def idle_gaps(self) -> List[Tuple[int, int, str]]:
        """The window's idle gaps, each labelled by what the host was doing:
        the innermost CPU operator running at its middle, else untraced host
        work (Python, NumPy) before the device activity that ended it."""
        busy = self.busy_intervals()
        edges = [(self.window_ns[0], None)] + [(x, n) for s, e, n in busy
                                               for x in (s, e)] + [(self.window_ns[1], None)]
        gaps = []
        for (gs, _), (ge, after) in zip(edges[0::2], edges[1::2]):
            if ge > gs:
                gaps.append((gs, ge, after))
        starts = [h[0] for h in self.host_ops]
        out = []
        stack: List[Tuple[int, int, str]] = []
        i = 0
        for gs, ge, after in sorted(gaps, key=lambda g: (g[0] + g[1]) // 2):
            mid = (gs + ge) // 2
            j = bisect.bisect_right(starts, mid)
            while i < j:
                h = self.host_ops[i]
                while stack and stack[-1][1] <= h[0]:
                    stack.pop()
                stack.append(h)
                i += 1
            while stack and stack[-1][1] <= mid:
                stack.pop()
            if stack:
                label = "host " + stack[-1][2]
            else:
                label = "untraced host work before " + (after or "the window's end")
            out.append((gs, ge, label[:NAME_CHARS]))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, by name, and the
        idle gaps summed by label, longest first."""
        by_name: Dict[str, float] = collections.Counter()
        for o in self.ops:
            by_name[o.name[:NAME_CHARS]] += (o.end_ns - o.start_ns) / 1e9
        gaps: Dict[str, float] = collections.Counter()
        for gs, ge, label in self.idle_gaps():
            gaps[label] += (ge - gs) / 1e9
        return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(top)]}


def classify(name: str, op: str) -> str:
    if op == COUNT_PRODUCT_OP:
        return "count_product"
    for cls, kernel in KERNEL_CLASSES:
        if kernel in name:
            return cls
    return "other"


def _annotation(e) -> bool:
    """Whether a kineto event is a ``record_function`` mark or its copy on
    the device's timeline (``is_user_annotation``, where the profiler has
    it; the harness's own marks by name in any case)."""
    flag = getattr(e, "is_user_annotation", None)
    return e.name().startswith("pio_bench.") or bool(flag and flag())


def from_events(events) -> Trace:
    """The window's trace from the profiler's kineto events (a stopped
    session's ``prof.profiler.kineto_results.events()``): the window's
    mark; CPU operators by correlation id (named ``namespace::op``, which
    leaves out the CUDA runtime's calls and the profiler's own events);
    and the device's kernels, copies and sets, each tied to its operator
    by the id it was launched under.  Marks are not work: their copies on
    the device's timeline are left out."""
    from torch.autograd import DeviceType

    window = thread = None
    cpu_ops: Dict[int, Tuple[str, List[List[int]]]] = {}
    host: List[Tuple[int, int, str, int]] = []
    device = []
    for e in events:
        name, on_cpu = e.name(), e.device_type() == DeviceType.CPU
        if on_cpu and name == WINDOW_MARK:
            window, thread = (e.start_ns(), e.end_ns()), e.start_thread_id()
        elif _annotation(e):
            continue
        elif on_cpu and "::" in name:
            cpu_ops[e.correlation_id()] = (name, e.shapes())
            host.append((e.start_ns(), e.end_ns(), name, e.start_thread_id()))
        elif e.device_type() == DeviceType.CUDA:
            device.append(e)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_MARK!r} mark")
    ops = []
    for e in device:
        s, t = e.start_ns(), e.end_ns()
        if t <= window[0] or s >= window[1]:
            continue
        op, shapes = cpu_ops.get(e.linked_correlation_id(), ("", None))
        ops.append(DeviceOp(e.name(), max(s, window[0]), min(t, window[1]), op, shapes,
                            e.linked_correlation_id(), classify(e.name(), op)))
    ops.sort(key=lambda o: o.start_ns)
    host_ops = sorted((s, t, n) for s, t, n, th in host
                      if th == thread and t > window[0] and s < window[1])
    return Trace(window, ops, host_ops)

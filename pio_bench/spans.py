"""The program's own spans in a traced run, and the idle gaps they name.

The program's ``timed`` blocks (``predictionio_tpu_torch/utils/tracing.py``)
keep each span they close as (start ns, end ns, name) on the Unix-epoch
clock that the profiler's events carry (``recent_spans``), and open a
``record_function`` range of the same name.  The readers of
``ur_engine_host_ms`` and ``cco_prep_host_ms`` take the spans inside the
traced window from the first; a program that keeps none gives them nothing
to read.  ``label_gaps`` names the window's idle gaps: the innermost host
operator at a gap's middle, as ``trace.py`` does, else the innermost span
there, else untraced host work.

    python3 pio_bench/spans.py --workload <name> --seed <n> --seconds <s>

makes one traced run of a cell on the card and prints as its last line a
JSON object: the run's per-layer metrics; the idle gaps summed by label;
each span's calls and seconds a train, from the program's record and from
the profiler's ranges; the steps' seconds; and the profiler's copies of
the ranges on the device's timeline, which ``trace.py`` leaves out of the
device's work by their annotation flag (``unflagged`` counts those it would
not).
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

ROOT = Path(__file__).resolve().parents[1]
#: the name prefixes of the program's spans in a UR/CCO train
PREFIXES = ("ur.", "cco.")

Span = Tuple[int, int, str]


def recorded() -> List[Span]:
    """The spans the program kept, or [] from a program that keeps none."""
    from predictionio_tpu_torch.utils import tracing

    recent = getattr(tracing, "recent_spans", None)
    return recent() if recent is not None else []


def window_spans(trace, spans: Optional[Sequence[Span]] = None) -> List[Span]:
    """The spans (the program's record by default) that overlap the
    trace's window, clipped to it."""
    w0, w1 = trace.window_ns
    spans = recorded() if spans is None else spans
    return [(max(s, w0), min(e, w1), n) for s, e, n in spans if e > w0 and s < w1]


def _union(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered_ns(spans: Sequence[Span], names: Iterable[str]) -> int:
    """Nanoseconds the union of the named spans covers."""
    names = set(names)
    return sum(e - s for s, e in _union((s, e) for s, e, n in spans if n in names))


def self_ns(spans: Sequence[Span], outer: str, inner: str) -> int:
    """Nanoseconds inside ``outer`` spans that no ``inner`` span covers."""
    outs = _union((s, e) for s, e, n in spans if n == outer)
    ins = _union((s, e) for s, e, n in spans if n == inner)
    both = sum(max(0, min(e, f) - max(s, r)) for s, e in outs for r, f in ins)
    return sum(e - s for s, e in outs) - both


def innermost(spans: Sequence[Span], t: int) -> Optional[str]:
    """The name of the innermost span open at ``t``: the last opened of
    those that hold it."""
    holding = [(s, -e, n) for s, e, n in spans if s <= t < e]
    return max(holding)[2] if holding else None


def label_gaps(trace, spans: Sequence[Span]) -> List[Span]:
    """``trace.idle_gaps()``, each gap no host operator explains named by
    the innermost span at its middle where one is open there."""
    out = []
    for gs, ge, label in trace.idle_gaps():
        name = None
        if label.startswith("untraced host work"):
            name = innermost(spans, (gs + ge) // 2)
        out.append((gs, ge, f"span {name}" if name else label))
    return out


def ranges(events, window_ns: Tuple[int, int]) -> List[Span]:
    """The program's ranges in the profiler's events: its named
    annotations on the host's timeline, inside the window."""
    from torch.autograd import DeviceType

    return sorted((e.start_ns(), e.end_ns(), e.name()) for e in events
                  if e.device_type() == DeviceType.CPU and e.name().startswith(PREFIXES)
                  and e.end_ns() > window_ns[0] and e.start_ns() < window_ns[1])


def per_train(spans: Sequence[Span], steps: int) -> Dict[str, List[float]]:
    """Each span's [calls, seconds covered] a train."""
    calls = collections.Counter(n for _, _, n in spans)
    return {n: [c / steps, covered_ns(spans, [n]) / 1e9 / steps]
            for n, c in sorted(calls.items())}


def traced_run(root: Path, workload: str, seed: int, seconds: float,
               device: str = "cuda") -> Dict:
    """One traced run of a cell through the harness, the profiler's events
    kept: what the module's docstring says ``main`` prints."""
    from torch.autograd import DeviceType

    from pio_bench import harness, trace

    kept = []
    reduce = trace.from_events

    def keep(events):
        events = list(events)
        kept.append((events, reduce(events)))
        return kept[-1][1]

    trace.from_events = keep
    try:
        result, _ = harness.run(root, workload, seed, seconds, True, device=device)
    finally:
        trace.from_events = reduce
    events, tr = kept[-1]
    steps = result["attempted"]
    mine = window_spans(tr)
    theirs = ranges(events, tr.window_ns)
    step_s = [(e.end_ns() - e.start_ns()) / 1e9 for e in events
              if e.device_type() == DeviceType.CPU and e.name() == trace.STEP_MARK]
    gaps: Dict[str, float] = collections.Counter()
    for gs, ge, label in label_gaps(tr, mine):
        gaps[label] += (ge - gs) / 1e9
    kind = collections.Counter()
    for label, s in gaps.items():
        kind[label.split(" ")[0]] += s
    copies = [e for e in events if e.device_type() == DeviceType.CUDA
              and e.name().startswith(PREFIXES)]
    flag = [getattr(e, "is_user_annotation", lambda: False)() for e in copies]
    return {
        "workload": workload, "seed": seed, "correct": result["correct"], "steps": steps,
        "metrics": {k: v["value"] for k, v in result["metrics"].items()},
        "device": result["device"], "power_limit_w": result["power_limit_w"],
        "step_s": step_s, "mean_step_s": statistics.fmean(step_s) if step_s else None,
        "idle_s": tr.window_s - tr.busy_s,
        "idle_by_kind_s": dict(kind),
        "idle_gaps": [[k, v] for k, v in gaps.most_common(15)],
        "spans_per_train": per_train(mine, steps) if steps else {},
        "ranges_per_train": per_train(theirs, steps) if steps else {},
        "device_copies": {"n": len(copies), "unflagged": flag.count(False),
                          "counted_as_work": sum(o.name.startswith(PREFIXES)
                                                 for o in tr.ops)},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("pio_bench.spans: needs a CUDA card", file=sys.stderr)
        return 2
    out = traced_run(ROOT, args.workload, args.seed, args.seconds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    # the checkout's root heads the import path, and the kernel caches sit
    # where a run puts them (``run.py``'s set-up, run on import)
    sys.path[0] = str(ROOT)
    from pio_bench import run  # noqa: F401

    sys.exit(main())

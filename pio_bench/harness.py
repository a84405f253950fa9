"""One run of one cell: set-up, the measured window, the check, the line.

``run`` finds everything by name from ``BENCHMARK.json`` under ``root``:
the cell, its configuration file, ``traffic/<traffic>.json`` (which names
the entry), ``entries/<entry>.py``, ``limits/<workload>.json`` and, for each
metric the cell reports, ``metrics/<metric>.py``.

An entry module defines ``prepare(cfg, traffic, inputs, device)``, which
sets the program up from the generated events and returns the step the
window repeats.  It may define ``reference(cfg, traffic, inputs, seed)``,
the plain reference's answers (default: ``check.Reference``), and
``compare(reference, output)``, the numbers of one step's output
(default: ``check.compare``).  A metric module defines ``read(ctx)``,
which returns a number, or None when the run holds nothing for it to read.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from pio_bench import check, gen
from pio_bench import trace as trace_mod

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "predictionio_tpu")


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module from a file whose name may hold dots."""
    spec = importlib.util.spec_from_file_location(
        "pio_bench_file_" + path.stem.replace(".", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    entry, limits and the metrics it reports."""

    def __init__(self, root: Path, workload: str):
        self.root = Path(root)
        self.bench = self.root / "pio_bench"
        self.spec = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.cfg = load_json(self.root / configs[self.cell["config"]]["file"])
        self.traffic = load_json(self.bench / "traffic" / f"{self.cell['traffic']}.json")
        self.entry = load_module(self.bench / "entries" / f"{self.traffic['entry']}.py")
        self.reference = getattr(self.entry, "reference", check.Reference)
        self.compare = getattr(self.entry, "compare", check.compare)
        self.limits = load_json(self.bench / "limits" / f"{workload}.json")

    def metrics(self, traced: bool) -> List[Dict]:
        """The metrics this cell reports: end to end untraced, per layer
        traced; a metric with ``workloads`` in those cells only, a
        per-layer one without it wherever its end-to-end metric is."""
        name = self.cell["name"]
        e2e = [m for m in self.spec["end_to_end"]
               if name in m.get("workloads", [name])]
        if not traced:
            return e2e
        have = {m["name"] for m in e2e}
        return [m for m in self.spec["per_layer"]
                if (name in m["workloads"] if "workloads" in m else m["moves"] in have)]

    def read(self, metric: Dict, ctx) -> Optional[float]:
        value = load_module(self.bench / "metrics" / f"{metric['name']}.py").read(ctx)
        return None if value is None else float(value)


def power_limit_w() -> Optional[float]:
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def forbidden_modules() -> List[str]:
    """Forbidden top-level names among the loaded modules, whole names
    compared (``predictionio_tpu_torch`` is not ``predictionio_tpu``)."""
    loaded = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN_MODULES))


def finite(x: float) -> float:
    """A number JSON can hold: non-finite readings print as 1e308."""
    return x if math.isfinite(x) else 1e308


def run(root: Path, workload: str, seed: int, seconds: float, traced: bool,
        device: str = "cuda", t0: Optional[float] = None,
        ) -> Tuple[Dict, List[str]]:
    """(the result object, the check's lines) of one run."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(root, workload)
    cfg, traffic = cell.cfg, cell.traffic
    watts = power_limit_w() if device == "cuda" else None

    inputs = gen.make_events(cfg, traffic, seed)
    step = cell.entry.prepare(cfg, traffic, inputs, device)
    step()                                   # the warm-up step: builds, loads, warms
    _sync(device)
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    outputs, step_s = [], []
    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        prof = profile(activities=acts, record_shapes=True)
        prof.start()
    with torch.profiler.record_function(trace_mod.WINDOW_MARK):
        w0 = now = time.perf_counter()
        while now - w0 < seconds:
            with torch.profiler.record_function(trace_mod.STEP_MARK):
                outputs.append(step())
                _sync(device)
            step_s.append(time.perf_counter() - now)
            now += step_s[-1]
        window_s = now - w0
    tr = None
    if prof is not None:
        prof.stop()
        tr = trace_mod.from_events(prof.profiler.kineto_results.events())
        del prof
    window_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # the program's state goes before the reference runs
    del step
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    c0 = time.perf_counter()
    ref = cell.reference(cfg, traffic, inputs, seed)
    per_step = [cell.compare(ref, out) for out in outputs]
    del outputs
    check_s = time.perf_counter() - c0
    failed = sum(not check.judge(nums, cell.limits) for nums in per_step)
    nums = check.worst(per_step)
    correct = failed == 0 and check.judge(nums, cell.limits)

    ctx = types.SimpleNamespace(
        cfg=cfg, traffic=traffic, cell=cell.cell, setup_s=setup_s, window_s=window_s,
        steps=len(per_step), peak_bytes=window_peak, trace=tr)
    metrics = {}
    for m in cell.metrics(traced):
        value = cell.read(m, ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": int(cell.cell["chips"]),
           "memory_peak_bytes": int(max(setup_peak, window_peak))}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": len(per_step), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = tr.breakdown()
    result["power_limit_w"] = watts
    checks = {k: {"value": finite(float(nums.get(k, math.inf))),
                  "limit": float(lim["limit"])} for k, lim in cell.limits.items()}
    result["checks"] = checks
    lines = [f"pio_bench: {workload} seed {seed}: set-up {setup_s:.3f} s, window "
             f"{window_s:.3f} s of {len(per_step)} steps (each {min(step_s):.3f}-"
             f"{max(step_s):.3f} s), check {check_s:.3f} s, power limit {watts} W"]
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines

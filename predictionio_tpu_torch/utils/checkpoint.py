"""Mid-training checkpoint/resume.

Counterpart of ``predictionio_tpu/utils/checkpoint.py``, with the same
on-disk layout, so either package resumes the other's snapshot of the same
run (``ops.als.als_fingerprint`` gives both the same run key).  The
reference has no mid-training checkpointing (Spark task retry restarts the
whole job); here periodic factor snapshots plus the retry loop of
``workflow.core_workflow.run_train`` resume a failed train from its newest
snapshot.

Storage is an atomic ``.npz`` a step: training state is a flat dict of
host arrays plus JSON-able scalars.  Layout::

    <dir>/step_<n>.npz
    <dir>/MANIFEST.json     {"steps": [...]}
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, List, Optional, Tuple

import numpy as np


class CheckpointStore:
    """Step-indexed pytree snapshots under one directory (one training run).

    Values must be a flat dict of numpy arrays plus JSON-able scalars —
    the shape every algorithm's training state reduces to here.
    """

    def __init__(self, directory: str | os.PathLike, keep: int = 2):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- manifest ----------------------------------------------------------

    def _manifest_path(self) -> Path:
        return self.dir / "MANIFEST.json"

    def steps(self) -> List[int]:
        p = self._manifest_path()
        if not p.exists():
            return []
        return sorted(json.loads(p.read_text()).get("steps", []))

    def _write_manifest(self, steps: List[int]) -> None:
        tmp = self._manifest_path().with_suffix(f".tmp{os.getpid()}")
        tmp.write_text(json.dumps({"steps": sorted(steps)}))
        tmp.replace(self._manifest_path())

    # -- save / restore ----------------------------------------------------

    def save(self, step: int, state: dict) -> None:
        """Snapshot ``state`` (dict of arrays + scalars) as ``step``."""
        arrays = {}
        scalars = {}
        for k, v in state.items():
            if isinstance(v, (int, float, str, bool)) or v is None:
                scalars[k] = v
            else:
                arrays[k] = np.asarray(v)
        path = self.dir / f"step_{step}.npz"
        tmp = path.with_suffix(f".tmp{os.getpid()}.npz")
        with open(tmp, "wb") as f:
            np.savez(f, __scalars__=json.dumps(scalars), **arrays)
        tmp.replace(path)
        steps = [s for s in self.steps() if s != step] + [step]
        # prune oldest beyond keep
        for old in sorted(steps)[:-self.keep] if self.keep > 0 else []:
            self._delete(old)
            steps.remove(old)
        self._write_manifest(steps)

    def restore(self, step: int) -> dict:
        path = self.dir / f"step_{step}.npz"
        with np.load(path, allow_pickle=False) as z:
            state = {k: z[k] for k in z.files if k != "__scalars__"}
            state.update(json.loads(str(z["__scalars__"])))
        return state

    def latest(self) -> Optional[Tuple[int, dict]]:
        # Walk newest→oldest, skipping manifest entries whose step file is
        # gone (a concurrent run's prune/clear can race the manifest):
        # resume falls back to an older snapshot or a fresh run, never crashes.
        for step in reversed(self.steps()):
            try:
                return step, self.restore(step)
            except FileNotFoundError:
                continue
        return None

    def _delete(self, step: int) -> None:
        p = self.dir / f"step_{step}.npz"
        if p.exists():
            p.unlink()

    def clear(self, remove_dir: bool = False) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        if not remove_dir:
            self.dir.mkdir(parents=True, exist_ok=True)


def prune_stale_runs(base_dir: str | os.PathLike, ttl_seconds: Optional[float] = None) -> int:
    """Remove per-run checkpoint subdirectories untouched for ``ttl_seconds``
    (default PIO_CHECKPOINT_TTL_SECONDS, else 7 days).

    Run-keyed dirs (checkpoints keyed by data+hyperparam fingerprint) are only
    reused by a resume of the *same* run; a crashed run whose data changes
    before the retry would otherwise leak its snapshots forever.  Returns the
    number of directories removed.
    """
    if ttl_seconds is None:
        ttl_seconds = float(os.environ.get("PIO_CHECKPOINT_TTL_SECONDS", 7 * 86400))
    base = Path(base_dir)
    if not base.exists():
        return 0
    import time

    now = time.time()
    removed = 0
    for d in base.iterdir():
        if not d.is_dir():
            continue
        try:
            newest = max(
                (f.stat().st_mtime for f in d.iterdir()), default=d.stat().st_mtime
            )
        except OSError:
            continue
        if now - newest > ttl_seconds:
            shutil.rmtree(d, ignore_errors=True)
            removed += 1
    return removed


# ---------------------------------------------------------------------------
# fault injection (a test and operations tool; the reference has none)
# ---------------------------------------------------------------------------


class InjectedFault(RuntimeError):
    pass


# hit counters keyed by the exact PIO_FAULT_INJECT config string, so a new
# config (different site OR different :n) always starts counting from zero
_fault_hits: dict = {}


def maybe_inject(site: str) -> None:
    """Raise InjectedFault once if PIO_FAULT_INJECT names this site.

    Format: ``PIO_FAULT_INJECT=site[:n]`` — fail the n-th hit (default 1st)
    of ``site``, then disarm.  Lets tests and operators rehearse the
    retry/resume path deterministically.
    """
    conf = os.environ.get("PIO_FAULT_INJECT", "")
    if not conf:
        return
    name, _, nth = conf.partition(":")
    if name != site:
        return
    count = _fault_hits.get(conf, 0) + 1
    _fault_hits[conf] = count
    if count >= (int(nth) if nth else 1):
        os.environ.pop("PIO_FAULT_INJECT", None)
        _fault_hits.pop(conf, None)
        raise InjectedFault(f"injected fault at {site!r} (hit {count})")

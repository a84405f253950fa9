"""Running the port's operator drills (``predictionio_tpu_torch/tools``) as
their users do, and loading the JAX package's ``scripts/`` drills they are
held to, for the ``tests/test_torch_drill_*.py`` files."""

import ast
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
#: each drill run's own limit
TIMEOUT_S = 300


def jax_drill(name):
    """``scripts/<name>.py`` loaded as a module (the JAX package's drill), for
    the drills whose import only puts the checkout on ``sys.path``."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_JAX_VALUE = """
import importlib.util, json, sys
sys.path.insert(0, {tests!r})
from _torch_drill_cases import event_rows
sys.argv = ["drill"] + {argv!r}
spec = importlib.util.spec_from_file_location("drill", {path!r})
drill = importlib.util.module_from_spec(spec)
spec.loader.exec_module(drill)
print(json.dumps({expr}, sort_keys=True))
"""


def jax_value(name, expr, argv=()):
    """``expr`` over ``scripts/<name>.py`` loaded as ``drill`` with
    ``argv``, evaluated in a fresh interpreter (the drills set environment
    variables and read ``sys.argv`` as they are imported), as JSON;
    ``event_rows`` is in scope."""
    code = _JAX_VALUE.format(argv=list(argv), expr=expr, tests=str(REPO / "tests"),
                             path=str(REPO / "scripts" / f"{name}.py"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=TIMEOUT_S, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def jax_literal(name, target):
    """The literal assigned to ``target`` in ``scripts/<name>.py`` (at any
    depth), read from its source."""
    tree = ast.parse((REPO / "scripts" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign)
                and [t.id for t in node.targets if isinstance(t, ast.Name)] == [target]):
            return ast.literal_eval(node.value)
    raise KeyError(f"scripts/{name}.py assigns no {target}")


def event_rows(events):
    """Events as the JSON lines of their fields (no ids, no times)."""
    return [json.dumps({"event": e.event, "entityType": e.entity_type,
                        "entityId": e.entity_id,
                        "targetEntityType": e.target_entity_type,
                        "targetEntityId": e.target_entity_id,
                        "properties": dict(e.properties)}, sort_keys=True)
            for e in events]


def run_drill(name, *args, timeout=TIMEOUT_S):
    """``python -m predictionio_tpu_torch.tools.<name> *args`` from the
    checkout's root: the finished process."""
    return subprocess.run(
        [sys.executable, "-m", f"predictionio_tpu_torch.tools.{name}", *args],
        capture_output=True, text=True, timeout=timeout, cwd=REPO)


def assert_passes_on_cpu(name, *args):
    """The drill on ``--device cpu`` exits 0 with its ``ok:`` verdict last
    and, before it, this process's launch counts (none on the CPU)."""
    r = run_drill(name, "--device", "cpu", *args)
    assert r.returncode == 0, r.stdout + r.stderr
    lines = r.stdout.strip().splitlines()
    assert lines[-1].startswith("ok: "), r.stdout
    assert lines[-2].startswith("launches: "), r.stdout
    counts = json.loads(lines[-2][len("launches: "):])
    assert counts == {"device": "cpu", "masked_score": 0, "llr_masked": 0,
                      "tile_topk": 0}
    assert "FAIL" not in r.stderr, r.stderr
    return r


def assert_cuda_refused(name, *args):
    """Without a card, the default ``--device cuda`` exits non-zero before
    any phase, naming the device; it never goes on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: there is no refusal to see")
    r = run_drill(name, *args, timeout=120)
    assert r.returncode == 2, r.stdout + r.stderr
    assert r.stderr.strip().splitlines()[-1].startswith(
        "FAIL device 'cuda' requested but CUDA is not available"), r.stderr
    assert "ok:" not in r.stdout and "launches:" not in r.stdout, r.stdout

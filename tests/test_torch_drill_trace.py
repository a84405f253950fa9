"""The port's ``tools/check_trace_roundtrip.py`` against the JAX package's
``scripts/check_trace_roundtrip.py``: the round trip passes on the CPU,
its engine variant, query and stages are the JAX drill's, a run whose
exemplar never comes fails on that check alone, and without a card the
default device is refused."""

import ast
import os
import subprocess
import sys

from predictionio_tpu_torch.tools import check_trace_roundtrip as port_drill

from _torch_drill_cases import (REPO, TIMEOUT_S, assert_cuda_refused,
                                assert_passes_on_cpu, jax_literal)

NAME = "check_trace_roundtrip"


def _jax_query():
    """The JAX drill's query body, built inline in its ``main``."""
    tree = ast.parse((REPO / "scripts" / f"{NAME}.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return ast.literal_eval(node.args[0])
    raise KeyError("no query body")


def test_port_drill_passes_on_cpu():
    assert_passes_on_cpu(NAME)


def test_fixture_is_the_jax_drills():
    """The variant, query and stages, read from the JAX drill's source (its
    import sets the trace thresholds in the environment); the commerce
    fixture both share is held in tests/test_torch_drill_serve_parity.py."""
    variant = jax_literal(NAME, "variant")
    port_variant = dict(port_drill.VARIANT)
    assert port_variant.pop("engineFactory") == variant.pop("engineFactory").replace(
        "predictionio_tpu.", "predictionio_tpu_torch.", 1)
    assert port_variant == variant
    assert port_drill.QUERY == _jax_query()
    assert port_drill.STAGES == jax_literal(NAME, "STAGES")
    src = (REPO / "scripts" / f"{NAME}.py").read_text()
    assert 'RID = f"trace-rt-{os.getpid()}"' in src
    assert port_drill.RID == f"trace-rt-{os.getpid()}"


def test_fails_when_no_exemplar_ever_comes():
    """The latency histogram keeps no exemplar: after the deadline the
    drill exits 1 on that check, every other check passing."""
    script = (
        "import sys\n"
        "from predictionio_tpu_torch.obs import metrics\n"
        "observe = metrics.Histogram.observe\n"
        "def no_exemplar(self, value, exemplar=None, **labels):\n"
        "    observe(self, value, **labels)\n"
        "metrics.Histogram.observe = no_exemplar\n"
        "from predictionio_tpu_torch.tools import check_trace_roundtrip as drill\n"
        "drill.EXEMPLAR_WAIT_S = 0.5\n"
        "sys.exit(drill.main(['--device', 'cpu']))\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    fails = [ln for ln in r.stderr.splitlines() if ln.startswith("FAIL ")]
    assert fails == ["FAIL no trace-id exemplar on the request-latency histogram"], r.stderr
    assert "ok:" not in r.stdout


def test_cuda_without_a_card_is_refused():
    assert_cuda_refused(NAME)

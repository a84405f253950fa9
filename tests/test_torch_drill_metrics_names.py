"""The port's ``tools/check_metrics_names.py`` against the JAX package's
``scripts/check_metrics_names.py``.

The port's lint passes over the port's registry, span names and the
docs' metric catalog; it fails on a metric that dodges the registry's
name check.  Its contract names equal the JAX lint's, and the port
registers every metric the JAX package registers, with the same kind and
buckets, plus the port's one own counter.  The help strings that the
port words differently are pinned in ``HELP_DIFFERS``.
"""

import json
import os
import subprocess
import sys

from predictionio_tpu_torch.tools import check_metrics_names as port_lint

from _torch_drill_cases import REPO, TIMEOUT_S, jax_drill


#: the port's own counter: serial re-runs of a micro-batch that failed
PORT_ONLY = {"pio_serve_batch_serial_reruns_total"}

#: the metrics whose help text the port words more briefly, or words for
#: the port's own labels (the device-tail caches, the serve stages' cache
#: lap, the mask cache's swap outcomes)
HELP_DIFFERS = {
    "pio_model_plane_blob_count",
    "pio_model_plane_bytes",
    "pio_model_plane_chain_len",
    "pio_model_plane_gc_total",
    "pio_model_plane_generation",
    "pio_model_plane_map_seconds",
    "pio_model_plane_publish_bytes_total",
    "pio_plane_repl_bytes_total",
    "pio_plane_repl_lag_generations",
    "pio_plane_repl_resyncs_total",
    "pio_plane_repl_subscribers",
    "pio_ur_host_inverted_bytes",
    "pio_ur_rule_mask_cache_total",
    "pio_ur_serve_cache_total",
    "pio_ur_serve_candidate_frac",
    "pio_ur_serve_stage_duration_seconds",
}


JAX_LINT = jax_drill("check_metrics_names")

_DUMP = """
import importlib, json, sys
sys.path.insert(0, {repo!r})
{load}
for mod in lint.INSTRUMENTED_MODULES:
    importlib.import_module(mod)
from {pkg}.obs.metrics import get_registry
print(json.dumps({{m.name: [m.kind, m.help, list(getattr(m, "buckets", ()))]
                  for m in get_registry().metrics()}}))
"""


def _registry(pkg):
    """{name: [kind, help, buckets]} of ``pkg``'s registry once the lint's
    instrumented modules are imported, read in a fresh interpreter."""
    if pkg == "predictionio_tpu":
        load = ("import importlib.util\n"
                "spec = importlib.util.spec_from_file_location('l', "
                f"{str(REPO / 'scripts' / 'check_metrics_names.py')!r})\n"
                "lint = importlib.util.module_from_spec(spec)\n"
                "spec.loader.exec_module(lint)")
    else:
        load = "from predictionio_tpu_torch.tools import check_metrics_names as lint"
    r = subprocess.run(
        [sys.executable, "-c", _DUMP.format(repo=str(REPO), load=load, pkg=pkg)],
        capture_output=True, text=True, timeout=TIMEOUT_S,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_port_lint_passes():
    r = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.check_metrics_names"],
        capture_output=True, text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("ok: ") and "FAIL" not in r.stderr


def test_lint_fails_on_a_metric_that_dodges_the_registry():
    """A counter put into the registry past its name check: the lint names
    it and exits 1."""
    script = (
        "import sys\n"
        "from predictionio_tpu_torch.tools import check_metrics_names as lint\n"
        "from predictionio_tpu_torch.obs.metrics import Counter, get_registry\n"
        "reg = get_registry()\n"
        "reg._metrics['Bad-Name'] = Counter(reg, 'Bad-Name', 'dodges the check')\n"
        "sys.exit(lint.main([]))\n")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, timeout=TIMEOUT_S, cwd=REPO)
    assert r.returncode == 1, r.stdout + r.stderr
    fails = [ln for ln in r.stderr.splitlines() if ln.startswith("FAIL ")]
    assert fails == ["FAIL Bad-Name: name violates ^pio_[a-z0-9_]+$"], r.stderr
    assert "ok:" not in r.stdout


def test_contract_names_equal_the_jax_lint():
    assert port_lint.REQUIRED_METRICS == JAX_LINT.REQUIRED_METRICS
    assert port_lint.SPAN_CALL_NAMES == JAX_LINT.SPAN_CALL_NAMES
    assert port_lint.STAGE_CALL_NAMES == JAX_LINT.STAGE_CALL_NAMES
    assert port_lint._EXEMPT_KWARGS == JAX_LINT._EXEMPT_KWARGS
    assert port_lint.INSTRUMENTED_MODULES == [
        m.replace("predictionio_tpu.", "predictionio_tpu_torch.", 1)
        for m in JAX_LINT.INSTRUMENTED_MODULES]


def test_registry_matches_the_jax_registry():
    """Names, kinds and buckets equal, plus the port's own counter; the
    help strings equal but for ``HELP_DIFFERS``."""
    jax_reg = _registry("predictionio_tpu")
    port_reg = _registry("predictionio_tpu_torch")
    assert set(port_reg) == set(jax_reg) | PORT_ONLY
    assert not PORT_ONLY & set(jax_reg)
    for name, (kind, _help, buckets) in jax_reg.items():
        assert (port_reg[name][0], port_reg[name][2]) == (kind, buckets), name
    differs = {n for n in jax_reg if port_reg[n][1] != jax_reg[n][1]}
    assert differs == HELP_DIFFERS
    assert JAX_LINT.REQUIRED_METRICS <= set(port_reg)
    assert all(port_reg[n][1].strip() for n in port_reg)

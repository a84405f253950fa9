#!/usr/bin/env python
"""Lint the metric-name AND trace-span-name contracts.

Imports every module that declares instruments (they register at import
time) and verifies each registered metric:

- name matches ``pio_[a-z0-9_]+`` (the registry enforces this at
  registration too — the lint catches a registry regression and any
  metric that dodges the registry);
- carries a non-empty help string;
- histograms have strictly increasing bucket boundaries.

Then statically scans the package source (AST, not regex — multiline
calls and nesting are handled) for flight-recorder/journal span calls —
``.span("name", attr=...)``, ``trace_span("name", ...)``,
``timed("name")``, ``add_span("name", ...)`` — and lints every literal
span name and attr keyword against ``obs.tracing.SPAN_NAME_PATTERN``
(lowercase snake with optional dots: the pio_-style contract minus the
prefix), so waterfall rows and span-based dashboards stay greppable and
stable.

Run standalone (``python -m predictionio_tpu_torch.tools.check_metrics_names``,
or the file's path) or via the tier-1 suite
(tests/test_torch_drill_metrics_names.py wraps it), exit 0 = clean.  The
port's copy of ``scripts/check_metrics_names.py``: the same checks,
messages and exit code over the port's registry and source.  It does no
device work, so it takes no ``--device``.
"""

from __future__ import annotations

import ast
import importlib
import os
import re
import sys

# runnable from any cwd without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# every module that declares instruments at import time; a new
# instrumented module must be added here (the test fails otherwise only
# if its names are bad AND it happens to be imported transitively)
INSTRUMENTED_MODULES = [
    "predictionio_tpu_torch.obs.metrics",
    "predictionio_tpu_torch.obs.tracing",
    "predictionio_tpu_torch.api.http_util",
    "predictionio_tpu_torch.api.event_server",
    "predictionio_tpu_torch.api.dashboard",
    "predictionio_tpu_torch.storage.localfs",
    "predictionio_tpu_torch.storage.sharded",
    "predictionio_tpu_torch.storage.snapshot",
    "predictionio_tpu_torch.workflow.core_workflow",
    "predictionio_tpu_torch.workflow.create_server",
    "predictionio_tpu_torch.models.universal_recommender.engine",
    "predictionio_tpu_torch.streaming.follow",
    "predictionio_tpu_torch.streaming.fold",
    "predictionio_tpu_torch.streaming.plane",
    "predictionio_tpu_torch.streaming.replicate",
    "predictionio_tpu_torch.serve.response_cache",
    "predictionio_tpu_torch.serve.history_cache",
    "predictionio_tpu_torch.native.core",
    "predictionio_tpu_torch.obs.lineage",
    "predictionio_tpu_torch.obs.tsdb",
    "predictionio_tpu_torch.obs.slo",
    "predictionio_tpu_torch.obs.cluster",
]


# contract names external dashboards/alerts key on: the HTTP middleware
# family must survive any front-end rewrite (the event-loop migration is
# exactly the kind of change that could silently drop one)
REQUIRED_METRICS = frozenset({
    "pio_http_requests_total",
    "pio_http_request_duration_seconds",
    "pio_http_requests_in_flight",
    "pio_http_connections",
    "pio_serve_batch_size",
    "pio_events_ingested_total",
    # candidate-pruned serving contract: dashboards key on the
    # pruned/fallback outcome mix and the candidate-fraction histogram
    "pio_ur_serve_candidate_total",
    "pio_ur_serve_candidate_frac",
    "pio_ur_host_inverted_bytes",
    # streaming-freshness contract: the follow-trainer's fold
    # outcomes/lag and the hot-swap generation counter every serving
    # cache invalidates on
    "pio_follow_folds_total",
    "pio_follow_fold_duration_seconds",
    "pio_follow_lag_events",
    "pio_follow_last_publish_timestamp_seconds",
    "pio_model_generation",
    # sparse fold state: capacity alerting keys on the resident
    # state footprint and the sparse|dense|retrain mode flag
    "pio_follow_state_bytes",
    "pio_follow_state_mode",
    # fold-tick phases + pruned re-LLR: the freshness sweep's
    # per-phase columns and the roundtrip's pruning/incremental-emit
    # engagement assertions key on these
    "pio_follow_fold_phase_duration_seconds",
    "pio_follow_rellr_rows_total",
    "pio_follow_emit_total",
    # sharded/replicated store contract: the failover drill and
    # replica-lag alerting key on these
    "pio_store_shard_events_total",
    "pio_store_replica_lag_events",
    "pio_store_promotions_total",
    # parallel cross-shard scan pipeline: the bench's recovery
    # guard and the freshness roundtrip's parallel-path assertion key on
    # the worker gauge; per-shard durations feed the straggler view
    "pio_store_scan_shard_duration_seconds",
    "pio_store_scan_workers",
    "pio_store_scan_merged_events_per_sec",
    # shared-memory model plane: the bench's memory guard and
    # the group-convergence probes key on the per-worker generation/rss
    # gauges; GC visibility on the counter
    "pio_model_plane_generation",
    "pio_model_plane_bytes",
    "pio_model_plane_map_seconds",
    "pio_model_plane_gc_total",
    "pio_process_rss_bytes",
    # delta arenas: the bench's write-amplification guard and
    # publish-side observability key on the per-path byte counter; the
    # blob-store/chain gauges feed disk-sizing and restart-cost views
    "pio_model_plane_publish_bytes_total",
    "pio_model_plane_blob_count",
    "pio_model_plane_chain_len",
    # provenance-invalidated response cache: hit-rate dashboards
    # key on the outcome counter; the zero-staleness alert keys on the
    # audit-mismatch counter staying 0
    "pio_serve_cache_total",
    "pio_serve_cache_invalidations_total",
    "pio_serve_cache_entries",
    "pio_serve_cache_audit_mismatch_total",
    # generation lineage + local TSDB + SLO engine: the
    # roundtrip check keys on the record counter; dashboards and
    # /healthz key on the burn gauges; sibling-eviction visibility on
    # the stale counter
    "pio_lineage_records_total",
    "pio_obs_stale_siblings_total",
    "pio_slo_burn_rate",
    # native data-plane cores + history cache: the fallback
    # runbook keys on the reason counter, capacity/rollout dashboards on
    # the active gauge and per-core call counter; history-cache hit-rate
    # and staleness views on the outcome counter and entries gauge
    "pio_native_active",
    "pio_native_calls_total",
    "pio_native_fallback_total",
    "pio_history_cache_total",
    "pio_history_cache_entries",
    # multi-node plane replication: fleet-health alerting keys
    # on the per-subscriber lag and session gauges; network sizing on
    # the dir/kind byte counter; resync visibility on the reason counter
    "pio_plane_repl_bytes_total",
    "pio_plane_repl_lag_generations",
    "pio_plane_repl_subscribers",
    "pio_plane_repl_resyncs_total",
    # cluster observability fabric: fleet dashboards key on the
    # federated liveness gauges; the cluster SLOs read the propagation
    # histogram (stitched lineage truth) and the divergence gauges
    "pio_cluster_nodes",
    "pio_cluster_node_up",
    "pio_cluster_scrapes_total",
    "pio_cluster_propagation_seconds",
    "pio_cluster_qps_divergence",
    "pio_cluster_p95_divergence",
})

SPAN_CALL_NAMES = frozenset({"span", "trace_span", "timed", "add_span"})
# lineage stage calls name their stage in args[1] (args[0] is the
# lineage id); their attr kwargs follow the same naming contract
STAGE_CALL_NAMES = frozenset({"stage"})
# control kwargs, not attr names
_EXEMPT_KWARGS = ("parent", "attrs", "start", "duration_s", "flush",
                  "node")
# span attrs assigned post-hoc (rec["attrs"] = {...}) use literal dict
# keys; f-string keys (dynamic stage suffixes) are checked on their
# literal prefix parts only
_ATTRS_SUBSCRIPT = "attrs"


def lint_span_names(pkg_root: str) -> list:
    """Every literal span name and attr key in ``pkg_root`` must match
    SPAN_NAME_PATTERN."""
    from predictionio_tpu_torch.obs.tracing import SPAN_NAME_PATTERN

    name_re = re.compile(SPAN_NAME_PATTERN)
    problems = []

    def check(value: str, where: str) -> None:
        if not name_re.match(value):
            problems.append(
                f"{where}: span/attr name {value!r} violates "
                f"{SPAN_NAME_PATTERN}")

    for dirpath, _dirs, files in os.walk(pkg_root):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                try:
                    tree = ast.parse(f.read(), filename=path)
                except SyntaxError as e:
                    problems.append(f"{path}: unparseable: {e}")
                    continue
            rel = os.path.relpath(path, os.path.dirname(pkg_root))
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fname = (node.func.attr if isinstance(node.func, ast.Attribute)
                         else node.func.id if isinstance(node.func, ast.Name)
                         else None)
                if fname in SPAN_CALL_NAMES:
                    name_idx = 0
                elif fname in STAGE_CALL_NAMES:
                    name_idx = 1
                else:
                    continue
                where = f"{rel}:{node.lineno}"
                if (len(node.args) > name_idx
                        and isinstance(node.args[name_idx], ast.Constant)
                        and isinstance(node.args[name_idx].value, str)):
                    check(node.args[name_idx].value, where)
                for kw in node.keywords:
                    if kw.arg and kw.arg not in _EXEMPT_KWARGS:
                        check(kw.arg, where)
    return problems


def lint_docs_catalog(repo_root: str, registered: set) -> list:
    """Cross-check the docs metric-catalog table against the code:
    every REQUIRED metric must appear in the table, and every pio_ name
    the table documents must be registered or at least declared in the
    package source (some gauges register lazily on first publish)."""
    path = os.path.join(repo_root, "docs", "operations.md")
    if not os.path.exists(path):
        return [f"{path}: missing (the metric catalog lives there)"]
    name_re = re.compile(r"pio_[a-z0-9_]+")
    docs_names = set()
    with open(path) as f:
        for line in f:
            if line.startswith("| `pio_"):
                docs_names.update(name_re.findall(line))
    declared = set(registered)
    pkg_root = os.path.join(repo_root, "predictionio_tpu_torch")
    for dirpath, _dirs, files in os.walk(pkg_root):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(dirpath, fn)) as f:
                    declared.update(name_re.findall(f.read()))
    problems = []
    for miss in sorted(REQUIRED_METRICS - docs_names):
        problems.append(
            f"docs/operations.md: required metric {miss} missing from "
            "the metric-catalog table")
    for ghost in sorted(docs_names - declared):
        problems.append(
            f"docs/operations.md: catalog documents {ghost} but no such "
            "metric exists in the package")
    return problems


def main(argv=None) -> int:
    import argparse

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    for mod in INSTRUMENTED_MODULES:
        importlib.import_module(mod)
    from predictionio_tpu_torch.obs.metrics import NAME_RE, Histogram, get_registry

    problems = []
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    problems += lint_span_names(pkg_root)
    metrics = get_registry().metrics()
    for m in metrics:
        if not NAME_RE.match(m.name):
            problems.append(f"{m.name}: name violates {NAME_RE.pattern}")
        if not m.help or not m.help.strip():
            problems.append(f"{m.name}: missing help string")
        if isinstance(m, Histogram):
            if list(m.buckets) != sorted(set(m.buckets)):
                problems.append(f"{m.name}: buckets not strictly increasing")
    if not metrics:
        problems.append("no metrics registered — imports broken?")
    names = {m.name for m in metrics}
    for req in sorted(REQUIRED_METRICS - names):
        problems.append(
            f"required metric {req} not registered (middleware contract "
            "broken by a front-end change?)")
    problems += lint_docs_catalog(os.path.dirname(pkg_root), names)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print(f"ok: {len(metrics)} metrics + span-name scan, "
              "names and help strings clean")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())

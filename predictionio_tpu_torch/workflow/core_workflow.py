"""Training and evaluation orchestration.

Counterpart of ``predictionio_tpu/workflow/core_workflow.py`` (reference:
core/.../workflow/CoreWorkflow.scala): ``run_train`` records an
EngineInstance (INIT → TRAINING → COMPLETED, or FAILED with the exception
re-raised), runs ``Engine.train`` on the named device and persists the
models, counting the events it staged by source (snapshot, tail, delta:
``pio_train_staged_events_total``, through ``_staging_delta``, which the
follow-trainer's retrain tick reads too); ``load_latest_models`` is the
deploy-time lookup; ``run_eval`` runs an Evaluation on the named device
and records an EvaluationInstance (EVALRUNNING → EVALCOMPLETED with the
results as text, JSON and HTML, or EVALFAILED) and counts
``pio_eval_runs_total`` by final status.  Each run writes a span journal
next to its instance (``obs/spans.py``; ``pio dashboard`` renders it): a
train's ``train`` root holds ``engine_train`` (with its attempt),
``staging_summary`` (the staged counts as attributes) and
``save_models``, an eval's is ``eval``.  ``pio_train_runs_total`` and
``pio_train_duration_seconds`` count and time the trains.  The spans read
the host clock: on the card a train's last readback closes
``engine_train``.
"""

from __future__ import annotations

import datetime as _dt
import json
import logging
import os
import traceback
from typing import Optional

from predictionio_tpu_torch.controller.engine import (
    Engine,
    EngineParams,
    serialize_engine_params,
)
from predictionio_tpu_torch.controller.evaluation import Evaluation, MetricEvaluatorResult
from predictionio_tpu_torch.core.base import doer_name
from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.obs import spans as _spans
from predictionio_tpu_torch.obs.metrics import get_registry
from predictionio_tpu_torch.storage.base import EngineInstance, EvaluationInstance
from predictionio_tpu_torch.storage.locator import Storage, get_storage
from predictionio_tpu_torch.workflow import persistence

log = logging.getLogger("pio.workflow")

_REG = get_registry()
_M_TRAINS = _REG.counter(
    "pio_train_runs_total", "Training runs by final status")
_M_TRAIN_S = _REG.histogram(
    "pio_train_duration_seconds", "Wall-clock duration of training runs")
_M_EVALS = _REG.counter(
    "pio_eval_runs_total", "Evaluation runs by final status")
_M_TRAIN_STAGED = _REG.counter(
    "pio_train_staged_events_total",
    "Events staged during training runs, by source: snapshot = mmap'd "
    "columns, tail = JSONL past snapshot coverage, delta = JSONL past a "
    "retained batch's watermark (delta-aware retrain)")


def _staging_delta(before):
    """Per-source staged-event counts accrued since ``before`` (a
    ``store.event_store.staging_counts`` reading)."""
    from predictionio_tpu_torch.store.event_store import staging_counts

    after = staging_counts()
    return {mode: after[mode] - before.get(mode, 0) for mode in after}


def count_staged(staged) -> None:
    """Add one run's ``_staging_delta`` to pio_train_staged_events_total."""
    for mode, v in staged.items():
        if v:
            _M_TRAIN_STAGED.inc(v, mode=mode)


def _now() -> _dt.datetime:
    return _dt.datetime.now(_dt.timezone.utc)


def run_train(
    engine: Engine,
    engine_params: EngineParams,
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    engine_factory: str = "",
    storage: Optional[Storage] = None,
    retries: Optional[int] = None,
    device="cuda",
) -> EngineInstance:
    """Train on ``device`` and persist: returns the COMPLETED
    EngineInstance (or raises, leaving a FAILED instance recorded).  Raises
    before recording anything when CUDA is asked for and absent.

    ``retries`` (default: PIO_TRAIN_RETRIES env, 0) re-runs Engine.train
    after a failure — the elastic-recovery analogue of Spark task retry in
    the reference.
    """
    device = resolve_device(device)
    storage = storage or get_storage()
    if retries is None:
        retries = int(os.environ.get("PIO_TRAIN_RETRIES", "0"))
    params_json = serialize_engine_params(engine_params)
    instance = EngineInstance(
        id="",
        status="INIT",
        start_time=_now(),
        end_time=None,
        engine_id=engine_id,
        engine_version=engine_version,
        engine_variant=engine_variant,
        engine_factory=engine_factory or engine_id,
        data_source_params=params_json["data_source_params"],
        preparator_params=params_json["preparator_params"],
        algorithms_params=params_json["algorithms_params"],
        serving_params=params_json["serving_params"],
    )
    instance_id = storage.engine_instances.insert(instance)
    instance.status = "TRAINING"
    storage.engine_instances.update(instance)
    attempt = 0
    # span journal persisted next to the engine instance: every timed()
    # inside engine.train nests under this run's root span, and
    # `pio dashboard` renders the breakdown per completed train
    journal = _spans.SpanJournal(_spans.journal_path(storage, instance_id))
    t_run = _dt.datetime.now(_dt.timezone.utc).timestamp()
    with journal.activate():
        with journal.span("train", engine_id=engine_id, instance_id=instance_id):
            while True:
                try:
                    log.info("training engine %s (instance %s, attempt %d)",
                             engine_id, instance_id, attempt + 1)
                    from predictionio_tpu_torch.store.event_store import staging_counts

                    stage_before = staging_counts()
                    with journal.span("engine_train", attempt=attempt + 1):
                        models = engine.train(engine_params, device=device)
                    # how many events this run staged from where (snapshot
                    # columns, the parsed tail, or a delta past a retained
                    # batch): a span attribute a run and a cross-run
                    # counter; all zero when the engine read through a
                    # non-snapshot path
                    staged = _staging_delta(stage_before)
                    with journal.span("staging_summary", **{
                            f"staged_{k}": int(v) for k, v in staged.items()}):
                        pass
                    count_staged(staged)
                    log.info("training staged %s", staged)
                    with journal.span("save_models"):
                        persistence.save_models(storage, instance_id, models)
                    instance.status = "COMPLETED"
                    instance.end_time = _now()
                    storage.engine_instances.update(instance)
                    log.info("training done: instance %s COMPLETED", instance_id)
                    _M_TRAINS.inc(1, status="COMPLETED")
                    _M_TRAIN_S.observe(
                        _dt.datetime.now(_dt.timezone.utc).timestamp() - t_run)
                    return instance
                except Exception:
                    attempt += 1
                    if attempt <= retries:
                        log.warning(
                            "training attempt %d failed, retrying (%d left):\n%s",
                            attempt, retries - attempt + 1, traceback.format_exc())
                        continue
                    instance.status = "FAILED"
                    instance.end_time = _now()
                    storage.engine_instances.update(instance)
                    log.error("training FAILED: %s", traceback.format_exc())
                    _M_TRAINS.inc(1, status="FAILED")
                    raise


def load_latest_models(
    engine_id: str,
    engine_version: str = "1",
    engine_variant: str = "default",
    storage: Optional[Storage] = None,
    device="cuda",
) -> tuple:
    """(instance, models) for the latest COMPLETED engine instance, the
    models serving on ``device`` — the deploy-time lookup (reference:
    CreateServer resolving EngineInstance)."""
    storage = storage or get_storage()
    instance = storage.engine_instances.get_latest_completed(
        engine_id, engine_version, engine_variant
    )
    if instance is None:
        raise LookupError(
            f"no COMPLETED engine instance for {engine_id} v{engine_version} ({engine_variant}); "
            "run `pio train` first"
        )
    models = persistence.load_models(storage, instance.id, device)
    return instance, models


def _eval_results_html(result: MetricEvaluatorResult) -> str:
    """Candidate table for the dashboard (reference: EvaluationInstances'
    evaluatorResultsHTML rendered by the dashboard module)."""
    import html as _html

    rows = "".join(
        "<tr{hl}><td>{i}</td><td>{score:.6f}</td><td>{others}</td>"
        "<td><pre>{params}</pre></td></tr>".format(
            hl=' style="background:#e8f4e8"' if i == result.best_index else "",
            i=i + 1,
            score=score,
            others=_html.escape(", ".join(f"{o:.4f}" for o in others)),
            params=_html.escape(json.dumps(ep.to_json(), indent=1)[:2000]),
        )
        for i, (ep, score, others) in enumerate(result.engine_params_scores)
    )
    return (
        f"<h3>{_html.escape(result.metric_header)}</h3>"
        f"<table><tr><th>#</th><th>{_html.escape(result.metric_header)}</th>"
        f"<th>{_html.escape(', '.join(result.other_metric_headers))}</th>"
        f"<th>engine params</th></tr>{rows}</table>"
    )


def run_eval(
    evaluation: Evaluation,
    evaluation_class: str = "",
    storage: Optional[Storage] = None,
    device="cuda",
    eval_runner=None,
) -> MetricEvaluatorResult:
    """Run an Evaluation with its candidates' models on ``device``, record
    the EvaluationInstance, return the result.  ``eval_runner`` (e.g.
    ``FastEvalEngine(engine, device).eval``) replaces ``Engine.eval``.
    Raises before recording anything when CUDA is asked for and absent."""
    device = resolve_device(device)
    storage = storage or get_storage()
    instance = EvaluationInstance(
        id="",
        status="EVALRUNNING",
        start_time=_now(),
        end_time=None,
        evaluation_class=evaluation_class or doer_name(evaluation),
    )
    instance_id = storage.evaluation_instances.insert(instance)
    journal = _spans.SpanJournal(_spans.journal_path(storage, instance_id))
    try:
        log.info("evaluating %s (instance %s)", instance.evaluation_class, instance_id)
        with journal.activate(), journal.span(
                "eval", instance_id=instance_id,
                evaluation_class=instance.evaluation_class):
            result = evaluation.run(eval_runner=eval_runner, device=device)
        instance.status = "EVALCOMPLETED"
        instance.end_time = _now()
        instance.evaluator_results = (
            f"{result.metric_header}: best={result.best_score:.6f} "
            f"(candidate {result.best_index + 1}/{len(result.engine_params_scores)})"
        )
        instance.evaluator_results_json = json.dumps(result.to_json())
        instance.evaluator_results_html = _eval_results_html(result)
        storage.evaluation_instances.update(instance)
        # counted only after the instance is durably COMPLETED: one run
        # never counts under both statuses
        _M_EVALS.inc(1, status="EVALCOMPLETED")
        return result
    except Exception:
        _M_EVALS.inc(1, status="EVALFAILED")
        instance.status = "EVALFAILED"
        instance.end_time = _now()
        storage.evaluation_instances.update(instance)
        log.error("evaluation FAILED: %s", traceback.format_exc())
        raise

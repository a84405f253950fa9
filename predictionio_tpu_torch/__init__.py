"""PyTorch/CUDA port of ``predictionio_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference the port is
held against.  Module paths mirror ``predictionio_tpu`` so each counterpart
is easy to find.  This package imports ``torch`` and numpy only: never
``jax`` and nothing of ``predictionio_tpu``.

Ported so far (ROADMAP.md, queue A): the ``recommendation`` (ALS)
template, trained on the card (``ops/als.py``: explicit and implicit ALS,
checkpoint/resume in ``utils/checkpoint.py``) and every query scored by a
hand-written CUDA kernel (``ops/csrc/masked_score.cu``); the
``ecommerce`` template (implicit ALS, category and list rules, live
constraints); the Universal Recommender's CCO training
through the LLR and tile top-k kernels (``ops/csrc/llr_masked.cu``,
``ops/csrc/tile_topk.cu``), checkpointed per event type, and its serving
with business rules through the device or the host scorer and tail
(candidate pruning, the native serve core) behind the response, rule-mask
and history caches (``serve/``); the event
model, the memory and localfs storage backends with the native segment
scanner (``native/eventlog_scanner.cpp``), the columnar snapshots and the
staged retrain cache (``storage/snapshot.py``, their header parse in
``native/data_plane.cpp``), ``PEventStore``, the model store, the train →
deploy workflow (``workflow/core_workflow.py``,
``workflow/create_server.py``) and the ``pio`` console
(``python -m predictionio_tpu_torch.cli.main``); the event server, the
event-loop HTTP front end with prefork workers, the query server's
micro-batcher, hot reload and feedback (``api/``), and the metrics
registry behind ``/metrics`` (``obs/``); ``pio eval`` and the evaluation
workflow (``controller/evaluation.py``, ``workflow/fast_eval.py``), the
product-ranking, complementary-purchase (basket rules through the tile
top-k kernel), classification, lead-scoring and text templates
(``ops/logreg.py``, ``ops/naive_bayes.py``, ``ops/text.py``), the ``e2``
helpers and ``pio template``.
"""

__version__ = "0.1.0"

from predictionio_tpu_torch.controller import (  # noqa: E402,F401
    Algorithm,
    AverageMetric,
    AverageServing,
    DataSource,
    EmptyParams,
    Engine,
    EngineFactory,
    EngineParams,
    Evaluation,
    FirstServing,
    IdentityPreparator,
    Metric,
    MetricEvaluator,
    OptionAverageMetric,
    Params,
    PersistentModel,
    Preparator,
    Serving,
    SumMetric,
)

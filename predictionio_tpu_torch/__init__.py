"""PyTorch/CUDA port of ``predictionio_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference the port is
held against.  Module paths mirror ``predictionio_tpu`` so each counterpart
is easy to find.  This package imports ``torch`` and numpy only: never
``jax`` and nothing of ``predictionio_tpu``.

The port covers the whole JAX package: every module of
``predictionio_tpu`` has its counterpart here, with the same public names,
parameters and ``PIO_*`` variables, but for the reasoned differences that
``tests/test_torch_parity_audit.py`` lists and checks.  The three Pallas
kernels run as hand-written CUDA kernels for ``sm_90a``
(``ops/csrc/masked_score.cu``, ``ops/csrc/llr_masked.cu``,
``ops/csrc/tile_topk.cu``, bound in ``ops/hopper_kernels.py``); the rest is
PyTorch and numpy, with the native host code in ``native/``.  The console
is ``python -m predictionio_tpu_torch.cli.main``, and the repo's evaluation
examples ship as ``predictionio_tpu_torch.examples`` for ``pio eval``.
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

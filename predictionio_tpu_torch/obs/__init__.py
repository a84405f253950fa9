"""Observability of the port (counterpart of ``predictionio_tpu/obs``):
the metrics registry (``obs/metrics.py``) and its exposition
(``obs/exposition.py``: Prometheus text at ``GET /metrics``, the
reference-parity ``GET /stats.json`` windows), the train and eval span
journals (``obs/spans.py``), the request flight recorder
(``obs/tracing.py``), generation lineage (``obs/lineage.py``), the
metrics history ring (``obs/tsdb.py``), the SLO engine behind
``/healthz`` (``obs/slo.py``) and the cluster federation
(``obs/cluster.py``).  Their files, documents and metric families are the
JAX package's.  Standard library only.
"""

from predictionio_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    set_enabled,
)

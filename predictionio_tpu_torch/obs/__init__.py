"""Observability of the port: the metrics registry (``obs/metrics.py``)
and its exposition (``obs/exposition.py``: Prometheus text at
``GET /metrics``, the reference-parity ``GET /stats.json`` windows).

Counterpart of ``predictionio_tpu/obs``'s registry and exposition; the
span journals, the flight recorder, lineage, SLOs, the time-series ring
and the cluster federation wait for ROADMAP.md, queue A, 'Observability
and the rest of the front end'.  Standard library only.
"""

from predictionio_tpu_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    get_registry,
    set_enabled,
)

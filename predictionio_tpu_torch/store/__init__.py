"""The columnar event store (counterpart of ``predictionio_tpu/store``)."""

from predictionio_tpu_torch.store.columnar import EventBatch, IdDict  # noqa: F401
from predictionio_tpu_torch.store.event_store import LEventStore, PEventStore  # noqa: F401

"""The event model (counterpart of ``predictionio_tpu/events``)."""

from predictionio_tpu_torch.events.event import (  # noqa: F401
    DataMap,
    Event,
    PropertyMap,
    aggregate_properties,
    SET_EVENT,
    UNSET_EVENT,
    DELETE_EVENT,
)

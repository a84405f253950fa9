"""The event model (counterpart of ``predictionio_tpu/events``)."""

"""Core base types (counterpart of ``predictionio_tpu/core``)."""

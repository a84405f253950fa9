"""Serving workflow of the port (counterpart of ``predictionio_tpu/workflow``)."""

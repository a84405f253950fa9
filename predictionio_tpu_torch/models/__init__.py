"""Engine templates of the port (counterpart of ``predictionio_tpu/models``)."""

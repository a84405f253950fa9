"""Framework utilities (counterpart of ``predictionio_tpu/utils``)."""

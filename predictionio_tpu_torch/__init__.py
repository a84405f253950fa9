"""PyTorch/CUDA port of ``predictionio_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference the port is
held against.  Module paths mirror ``predictionio_tpu`` so each counterpart
is easy to find.  This package imports ``torch`` and numpy only: never
``jax`` and nothing of ``predictionio_tpu``.

Ported so far: serving of the ``recommendation`` (ALS) template — the
library predictor and a ``POST /queries.json`` server — with every query
scored by a hand-written CUDA kernel (``ops/csrc/masked_score.cu``).
"""

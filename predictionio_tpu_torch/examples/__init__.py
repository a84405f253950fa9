"""The evaluation examples of the repo's ``examples/`` on the port.

Each ``<template>/evaluation.py`` is ``examples/<template>/evaluation.py``
with every ``from predictionio_tpu.`` import on the port's module path, and
nothing else changed: the same classes, parameters, app names and grids.
``pio eval`` names them by package path from any working directory::

    pio eval predictionio_tpu_torch.examples.recommendation.evaluation.RecommendationEvaluation
    pio eval predictionio_tpu_torch.examples.universal_recommender.evaluation.UREvaluation \\
             predictionio_tpu_torch.examples.universal_recommender.evaluation.MinLlrGrid

They run on the card unless ``PIO_TORCH_DEVICE=cpu`` asks for the CPU.
"""

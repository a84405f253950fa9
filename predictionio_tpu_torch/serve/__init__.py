"""Serving-side subsystems above one engine's predict math (counterpart of
``predictionio_tpu/serve``).

``response_cache`` — the provenance-invalidated top-k response cache:
whole answers memoized and re-armed on each installed model generation.
``history_cache`` — the per-process user-history read cache, invalidated
through the storage append-listener bus.
"""

"""Streaming freshness: the incremental CCO fold and the follow-trainer.

Counterpart of ``predictionio_tpu/streaming``: ``URFoldState`` (the
additive fold of a Universal Recommender's counts, ``fold.py``),
``FollowTrainer`` (tail → fold → hot-swap, ``follow.py``) and
``FoldUnsupported``.  The model plane and its replication
(``plane.py``, ``replicate.py``) wait for ROADMAP.md, queue A,
'Streaming'.
"""

from predictionio_tpu_torch.streaming.fold import FoldUnsupported, URFoldState
from predictionio_tpu_torch.streaming.follow import FollowTrainer

__all__ = ["FoldUnsupported", "FollowTrainer", "URFoldState"]

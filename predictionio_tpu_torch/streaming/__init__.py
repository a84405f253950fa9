"""Streaming freshness: the incremental CCO fold and the follow-trainer.

Counterpart of ``predictionio_tpu/streaming``: ``URFoldState`` (the
additive fold of a Universal Recommender's counts, ``fold.py``),
``FollowTrainer`` (tail → fold → hot-swap, ``follow.py``) and
``FoldUnsupported``; the model plane (``plane.py``: ``ModelPlane``, the
delta arenas, ``PlaneWatcher``) and its replication over TCP
(``replicate.py``: ``PlaneReplicator``, ``PlaneSubscriber``).  The
follower runs on every event backend with the delta-tail protocol: memory,
localfs, sharedfs and the sharded store (``storage/sharded.py``, whose
watermarks are shard-namespaced); on sql it retrains every tick.
"""

from predictionio_tpu_torch.streaming.fold import FoldUnsupported, URFoldState
from predictionio_tpu_torch.streaming.follow import FollowTrainer
from predictionio_tpu_torch.streaming.plane import ModelPlane, PlaneUnsupported, PlaneWatcher

__all__ = ["FoldUnsupported", "FollowTrainer", "ModelPlane", "PlaneUnsupported",
           "PlaneWatcher", "URFoldState"]

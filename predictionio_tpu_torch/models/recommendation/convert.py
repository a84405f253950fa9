"""Carry a JAX-trained ALS model across to the port.

``als_model_from_state`` takes the state dict of the JAX package's
``ALSModel`` (``model.__getstate__()``: numpy factor matrices ``X``/``Y``,
the ``users``/``items`` id lists and the ``seen`` CSR arrays) and returns
the port's model on the named device.  It reads plain data only: a pickled
JAX model blob names its class by the JAX package's module path and cannot
be unpickled here.  Reading the JAX model store comes with the storage
slice.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from predictionio_tpu_torch.models.recommendation.engine import ALSModel
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict


def als_model_from_state(state: Dict, device="cuda") -> ALSModel:
    """The port's ``ALSModel`` for a JAX ``ALSModel.__getstate__()`` dict,
    serving on ``device`` (raises when CUDA is asked for and absent)."""
    return ALSModel(
        np.asarray(state["X"], np.float32),
        np.asarray(state["Y"], np.float32),
        IdDict.from_state(state["users"]),
        IdDict.from_state(state["items"]),
        CSRLookup.from_state(state["seen"]),
        device=device,
    )

"""Carry a JAX-trained similar-product model across to the port.

``sp_model_from_state`` takes the state dict of the JAX package's
``SPModel`` (``model.__getstate__()``: the kind, the item id list, the
per-item categories, and numpy item factors or indicator ids and LLR
weights) and returns the port's model on the named device.  It reads plain
data only; a JAX-pickled blob loads through the model store
(``workflow.persistence``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from predictionio_tpu_torch.models.similar_product.engine import SPModel
from predictionio_tpu_torch.store.columnar import IdDict


def sp_model_from_state(state: Dict, device="cuda") -> SPModel:
    """The port's ``SPModel`` for a JAX ``SPModel.__getstate__()`` dict,
    serving on ``device`` (raises when CUDA is asked for and absent)."""
    def arr(x, dtype):
        return None if x is None else np.asarray(x, dtype)

    return SPModel(
        state["kind"], IdDict.from_state(state["items"]), dict(state["cats"]),
        item_factors=arr(state["factors"], np.float32),
        indicator_idx=arr(state["idx"], np.int32),
        indicator_llr=arr(state["llr"], np.float32),
        device=device)

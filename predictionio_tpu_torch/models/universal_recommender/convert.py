"""Carry Universal Recommender models and training data across to the port.

``ur_model_from_state`` takes the state dict of the JAX package's
``URModel`` (``model.__getstate__()``: numpy indicator tables, popularity,
the id lists and the seen-item CSR arrays) and returns the port's model on
the named device.  ``ur_training_data_from_arrays`` builds the port's
``URTrainingData`` from the arrays of the JAX ``URTrainingData`` and its
``IdDict.to_state()`` lists, so both packages train in one id space.  Both
read plain data only: a pickled JAX object names the JAX package's classes
and cannot be unpickled here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from predictionio_tpu_torch.models.universal_recommender.engine import (
    URModel,
    URTrainingData,
)
from predictionio_tpu_torch.store.columnar import CSRLookup, IdDict


def ur_model_from_state(state: Dict, device="cuda") -> URModel:
    """The port's ``URModel`` for a JAX ``URModel.__getstate__()`` dict,
    serving on ``device`` (raises when CUDA is asked for and absent)."""
    return URModel(
        primary_event=state["primary_event"],
        item_dict=IdDict.from_state(state["items"]),
        user_dict=IdDict.from_state(state["users"]),
        indicator_idx={k: np.asarray(v, np.int32)
                       for k, v in state["indicator_idx"].items()},
        indicator_llr={k: np.asarray(v, np.float32)
                       for k, v in state["indicator_llr"].items()},
        event_item_dicts={k: IdDict.from_state(v)
                          for k, v in state["event_items"].items()},
        popularity=np.asarray(state["popularity"]),
        item_properties=dict(state["item_properties"]),
        user_seen=CSRLookup.from_state(state["user_seen"]),
        user_seen_by_event={k: CSRLookup.from_state(v) for k, v in
                            state.get("user_seen_by_event", {}).items()},
        device=device,
    )


def ur_training_data_from_arrays(
    event_names: Sequence[str],
    users: Sequence[str],
    interactions: Mapping[str, Tuple[Any, Any, Sequence[str], Any]],
    item_properties: Optional[Dict[str, Dict[str, Any]]] = None,
) -> URTrainingData:
    """``URTrainingData`` from ``users`` (the user ``IdDict``'s strings)
    and, per event type, ``(user_idx, item_idx, items, times)``: int ids,
    the type's item strings and epoch seconds per event."""
    return URTrainingData(
        event_names=list(event_names),
        user_dict=IdDict.from_state(users),
        interactions={
            name: (np.asarray(u, np.int32), np.asarray(i, np.int32),
                   IdDict.from_state(items), np.asarray(t, np.float64))
            for name, (u, i, items, t) in interactions.items()},
        item_properties=dict(item_properties or {}),
    )

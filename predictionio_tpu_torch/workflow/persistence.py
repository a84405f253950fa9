"""Model persistence (reference: core/.../workflow model save path +
data/.../storage/Models.scala and PersistentModel support).

Counterpart of ``predictionio_tpu/workflow/persistence.py``, with the same
blob format: a pickled list of ``(kind, module, qualname, bytes)`` entries
in the Models store keyed by engine-instance id; a ``PersistentModel``
controls its own bytes (the default pickles the model, whose state is the
JAX package's state dict).

A blob written by the JAX package names its classes by their JAX module
paths (``predictionio_tpu.models....URModel``), in the entry and in the
model's own pickle.  ``loads`` maps each ``predictionio_tpu.<path>`` to
``predictionio_tpu_torch.<path>`` for the classes the port has, and raises
naming any other; it never imports the JAX package (nor JAX) to resolve a
name.  Unpickle only blobs that this system wrote: unpickling can run code.
"""

from __future__ import annotations

import importlib
import io
import pickle
from typing import Any, List

from predictionio_tpu_torch.controller.dase import PersistentModel
from predictionio_tpu_torch.storage.locator import Storage

_JAX_PACKAGE = "predictionio_tpu"
_PORT_PACKAGE = "predictionio_tpu_torch"


def port_class(module: str, qualname: str) -> type:
    """The port's class for a pickled (module, qualname), with the JAX
    package's module paths mapped onto the port's.  Raises
    ``pickle.UnpicklingError`` naming the class when the port has no
    counterpart, and for any JAX module."""
    name = f"{module}.{qualname}"
    if module == _JAX_PACKAGE or module.startswith(_JAX_PACKAGE + "."):
        module = _PORT_PACKAGE + module[len(_JAX_PACKAGE):]
    elif module.split(".")[0] in ("jax", "jaxlib"):
        raise pickle.UnpicklingError(
            f"model blob holds {name}, a JAX object the port cannot load")
    try:
        obj = importlib.import_module(module)
        for part in qualname.split("."):
            obj = getattr(obj, part)
    except (ImportError, AttributeError) as e:
        raise pickle.UnpicklingError(
            f"model blob holds {name}, which the port has no counterpart "
            f"of ({module}.{qualname} not found)") from e
    return obj


def _names_jax(module: str) -> bool:
    return module.split(".")[0] in (_JAX_PACKAGE, "jax", "jaxlib")


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if _names_jax(module):
            return port_class(module, name)
        return super().find_class(module, name)


def loads(blob: bytes) -> Any:
    """``pickle.loads`` with the JAX package's class paths mapped onto the
    port's (see ``port_class``)."""
    return _PortUnpickler(io.BytesIO(blob)).load()


def serialize_models(models: List[Any]) -> bytes:
    payload = []
    for m in models:
        if isinstance(m, PersistentModel):
            payload.append(("persistent", type(m).__module__, type(m).__qualname__, m.save()))
        else:
            payload.append(("pickle", None, None, pickle.dumps(m)))
    buf = io.BytesIO()
    pickle.dump(payload, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return buf.getvalue()


def deserialize_models(blob: bytes, device="cuda") -> List[Any]:
    """The models of a blob, each serving on ``device`` (raises when CUDA
    is asked for and absent)."""
    models = []
    for kind, mod, qual, data in loads(blob):
        model = port_class(mod, qual).load(data) if kind == "persistent" else loads(data)
        to_device = getattr(model, "to_device", None)
        if to_device is not None:
            to_device(device)
        models.append(model)
    return models


def save_models(storage: Storage, instance_id: str, models: List[Any]) -> None:
    storage.models.insert(instance_id, serialize_models(models))


def load_models(storage: Storage, instance_id: str, device="cuda") -> List[Any]:
    blob = storage.models.get(instance_id)
    if blob is None:
        raise KeyError(f"no models stored for engine instance {instance_id!r}")
    return deserialize_models(blob, device)

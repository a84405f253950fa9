"""engine.json → engine glue (reference: core/.../workflow/CreateWorkflow.scala
+ WorkflowUtils engine-variant parsing).

Counterpart of the part of ``predictionio_tpu/workflow/create_workflow.py``
that deploy needs: resolve the engine factory named in engine.json (a
template shortname or a dotted path, the JAX package's paths mapped onto
the port's), load the variant, bind its params blocks to typed
EngineParams, and pick the engine id.  The ``pio train``/``build``/``eval``
entry points wait for the CLI (ROADMAP.md, queue A, 'Storage and event
store: localfs').
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type

from predictionio_tpu_torch.controller.engine import Engine, EngineFactory, EngineParams
from predictionio_tpu_torch.models import ENGINE_FACTORIES, NOT_PORTED

_JAX_PACKAGE = "predictionio_tpu"
_PORT_PACKAGE = "predictionio_tpu_torch"
ROADMAP_TEMPLATES = "ROADMAP.md, queue A, 'Remaining templates'"


def resolve_engine_factory(name: str) -> Type[EngineFactory]:
    """The port's EngineFactory class for a template shortname or a dotted
    path; a path into the JAX package names the port's class on the same
    module path."""
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"engineFactory {name!r}: the port does not have this template "
            f"yet ({ROADMAP_TEMPLATES})")
    dotted = ENGINE_FACTORIES.get(name, name)
    if dotted == _JAX_PACKAGE or dotted.startswith(_JAX_PACKAGE + "."):
        dotted = _PORT_PACKAGE + dotted[len(_JAX_PACKAGE):]
    module_name, _, cls_name = dotted.rpartition(".")
    if not module_name:
        raise ValueError(
            f"engineFactory {name!r} is not a dotted path or known template "
            f"({sorted(ENGINE_FACTORIES)})"
        )
    try:
        module = importlib.import_module(module_name)
    except ModuleNotFoundError as e:
        if module_name.startswith(_PORT_PACKAGE + ".models."):
            raise NotImplementedError(
                f"engineFactory {name!r}: the port has no {module_name} yet "
                f"({ROADMAP_TEMPLATES})") from e
        raise
    factory = getattr(module, cls_name)
    if not (isinstance(factory, type) and issubclass(factory, EngineFactory)):
        raise TypeError(f"{dotted} is not an EngineFactory subclass")
    return factory


def load_engine_variant(engine_json: str, variant_id: str = "default") -> Dict[str, Any]:
    """Load engine.json; supports both a single variant document and the
    reference's ``engineFactory`` + per-variant files."""
    path = Path(engine_json)
    if not path.exists():
        raise FileNotFoundError(f"engine variant file {engine_json!r} not found")
    doc = json.loads(path.read_text())
    if "engineFactory" not in doc:
        raise ValueError(f"{engine_json}: missing required key 'engineFactory'")
    # engine.json lives next to user code; make its directory importable the
    # way the reference adds the engine assembly jar to the classpath, so
    # engineFactory can name a module local to the engine directory.
    parent = str(path.resolve().parent)
    if parent not in sys.path:
        sys.path.insert(0, parent)
    return doc


def engine_from_variant(
    variant: Dict[str, Any]
) -> Tuple[Type[EngineFactory], Engine, EngineParams]:
    factory = resolve_engine_factory(variant["engineFactory"])
    engine = factory.apply()
    engine_params = engine.engine_params_from_variant(variant)
    return factory, engine, engine_params


def resolve_engine_id(
    cli_engine_id: Optional[str], variant: Dict[str, Any], factory: Type[EngineFactory]
) -> str:
    """Single precedence rule for the engine id, shared by build/train/deploy:
    explicit --engine-id > engine.json "id" > factory class name."""
    return cli_engine_id or variant.get("id") or factory.engine_id()

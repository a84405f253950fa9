"""engine.json → engine glue (reference: core/.../workflow/CreateWorkflow.scala
+ WorkflowUtils engine-variant parsing).

Counterpart of ``predictionio_tpu/workflow/create_workflow.py``: resolve
the engine factory named in engine.json (a template shortname or a dotted
path, the JAX package's paths mapped onto the port's), load the variant,
bind its params blocks to typed EngineParams, pick the engine id, and the
``pio train`` and ``pio build`` entry points.  ``pio eval`` waits for the
evaluation workflow (ROADMAP.md, queue A, 'Remaining templates') and
``pio train --follow`` for ROADMAP.md, queue A, 'Streaming'.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np

from predictionio_tpu_torch.controller.engine import Engine, EngineFactory, EngineParams
from predictionio_tpu_torch.models import ENGINE_FACTORIES, NOT_PORTED

log = logging.getLogger("pio.workflow")

_JAX_PACKAGE = "predictionio_tpu"
_PORT_PACKAGE = "predictionio_tpu_torch"
ROADMAP_TEMPLATES = "ROADMAP.md, queue A, 'Remaining templates'"
ROADMAP_STREAMING = "ROADMAP.md, queue A, 'Streaming'"


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


def resolve_variant_path(args) -> str:
    """The engine.json of a workflow command: the ``--engine-json`` path if
    it exists, else the file ``pio build`` registered for (--engine-id,
    --engine-version) (reference: RunWorkflow resolving the engine through
    its EngineManifest)."""
    if Path(args.engine_json).exists():
        return args.engine_json
    if args.engine_id:
        from predictionio_tpu_torch.storage import get_storage

        manifest = get_storage().engine_manifests.get(args.engine_id, args.engine_version)
        if manifest and manifest.files and Path(manifest.files[0]).exists():
            log.info("resolved engine %s via manifest: %s", args.engine_id, manifest.files[0])
            return manifest.files[0]
    return args.engine_json  # load_engine_variant raises FileNotFoundError


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


def _describe(obj) -> str:
    """One-line summary of a training-data object (the output of
    ``--stop-after-read``/``--stop-after-prepare``)."""
    bits = [type(obj).__name__]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if isinstance(v, np.ndarray):
                bits.append(f"{f.name}[{v.shape} {v.dtype}]")
            elif isinstance(v, dict):
                bits.append(f"{f.name}{{{len(v)}}}")
            elif hasattr(v, "__len__"):
                bits.append(f"{f.name}({len(v)})")
    elif hasattr(obj, "__len__"):
        bits.append(f"len={len(obj)}")
    return " ".join(bits)


def run_train_from_args(args) -> int:
    """``pio train`` (reference: Console.train → RunWorkflow →
    CreateWorkflow.main), on ``args.device`` (the CLI's
    ``PIO_TORCH_DEVICE``, default ``cuda``)."""
    from predictionio_tpu_torch.workflow import core_workflow

    try:
        if args.follow:
            raise NotImplementedError(
                f"pio train --follow is not ported yet ({ROADMAP_STREAMING})")
        variant = load_engine_variant(resolve_variant_path(args), args.variant)
        factory, engine, engine_params = engine_from_variant(variant)
        engine_id = resolve_engine_id(args.engine_id, variant, factory)
        if args.stop_after_read or args.stop_after_prepare:
            # reference WorkflowParams stopAfterRead/stopAfterPrepare: check
            # the data pipeline without training or persisting
            data_source, preparator, _algos, _serving = engine.make_components(engine_params)
            td = data_source.read_training()
            print(f"read_training -> {_describe(td)}")
            if args.stop_after_prepare:
                print(f"prepare -> {_describe(preparator.prepare(td))}")
            print("Stopped before training (debug flag).")
            return 0
        instance = core_workflow.run_train(
            engine,
            engine_params,
            engine_id=engine_id,
            engine_version=args.engine_version,
            engine_variant=args.variant,
            engine_factory=variant["engineFactory"],
            device=args.device,
        )
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Training completed. Engine instance id: {instance.id}")
    return 0


def run_build_from_args(args) -> int:
    """``pio build`` (reference: Console.build → sbt assembly +
    RegisterEngine).  There is no jar to compile: the build checks the
    engine variant end to end (factory import, engine construction, params
    binding) and registers its manifest, so train and deploy can resolve
    the engine by (id, version)."""
    from predictionio_tpu_torch.storage import EngineManifest, get_storage

    try:
        variant = load_engine_variant(args.engine_json, args.variant)
        factory, engine, engine_params = engine_from_variant(variant)
        engine_id = resolve_engine_id(args.engine_id, variant, factory)
        get_storage().engine_manifests.insert(EngineManifest(
            id=engine_id,
            version=args.engine_version,
            name=variant.get("id", engine_id),
            description=variant.get("description", ""),
            files=[str(Path(args.engine_json).resolve())],
            engine_factory=variant["engineFactory"],
        ))
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    n_algos = len(engine_params.algorithm_params_list)
    print(f"Build successful. Registered engine {engine_id} {args.engine_version} "
          f"(factory {variant['engineFactory']}, {n_algos} algorithm(s)).")
    return 0

"""engine.json → engine glue (reference: core/.../workflow/CreateWorkflow.scala
+ WorkflowUtils engine-variant parsing).

Counterpart of ``predictionio_tpu/workflow/create_workflow.py``: resolve
the engine factory named in engine.json (a template shortname or a dotted
path, the JAX package's paths mapped onto the port's), load the variant,
bind its params blocks to typed EngineParams, pick the engine id, and the
``pio train`` (with ``--follow``, the resident follow-trainer of
``streaming/follow.py``), ``pio build`` and ``pio eval`` entry points.
"""

from __future__ import annotations

import ast
import dataclasses
import importlib
import importlib.util
import json
import logging
import sys
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Type

import numpy as np

from predictionio_tpu_torch.controller.engine import Engine, EngineFactory, EngineParams
from predictionio_tpu_torch.models import ENGINE_FACTORIES

log = logging.getLogger("pio.workflow")

_JAX_PACKAGE = "predictionio_tpu"
_PORT_PACKAGE = "predictionio_tpu_torch"


def resolve_engine_factory(name: str) -> Type[EngineFactory]:
    """The port's EngineFactory class for a template shortname or a dotted
    path; a path into the JAX package names the port's class on the same
    module path."""
    dotted = ENGINE_FACTORIES.get(name, name)
    if dotted == _JAX_PACKAGE or dotted.startswith(_JAX_PACKAGE + "."):
        dotted = _PORT_PACKAGE + dotted[len(_JAX_PACKAGE):]
    module_name, _, cls_name = dotted.rpartition(".")
    if not module_name:
        raise ValueError(
            f"engineFactory {name!r} is not a dotted path or known template "
            f"({sorted(ENGINE_FACTORIES)})"
        )
    module = importlib.import_module(module_name)
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
    from predictionio_tpu_torch.parallel.distributed import init_distributed
    from predictionio_tpu_torch.workflow import core_workflow

    try:
        # a no-op for one process; with PIO_COORDINATOR_ADDRESS et al. this
        # joins the process group before any mesh is built.  Every process
        # trains and persists its model, as in the JAX package.
        init_distributed(device=args.device)
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
        if args.follow:
            return _run_follow(args, variant, engine, engine_params, engine_id)
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


def _run_follow(args, variant, engine, engine_params, engine_id: str) -> int:
    """``pio train --follow``: the resident follow-trainer on
    ``args.device``.  It bootstraps (or resumes from its persisted
    watermark or checkpoint), then tails the event store and publishes a
    COMPLETED engine instance for every folded generation; deployments
    with ``--auto-reload`` pick each one up.  Runs until SIGINT."""
    from predictionio_tpu_torch.streaming.follow import FollowTrainer

    trainer = FollowTrainer(
        engine, engine_params, engine_id=engine_id,
        engine_version=args.engine_version, engine_variant=args.variant,
        engine_factory=variant["engineFactory"],
        interval=getattr(args, "follow_interval", 0.0) or None,
        persist=True, device=args.device)
    print(f"Follow-trainer for {engine_id} resident (mode={trainer.mode}, "
          f"interval={trainer.interval:g}s, device={trainer.device}); Ctrl-C stops.",
          flush=True)
    try:
        trainer.run_forever()
    except KeyboardInterrupt:
        pass
    finally:
        trainer.stop()
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


def _imports_jax_package(module_name: str) -> bool:
    """Whether ``module_name`` is, or its source imports, the JAX package
    (``predictionio_tpu``): read from the source without importing it."""
    if module_name == _JAX_PACKAGE or module_name.startswith(_JAX_PACKAGE + "."):
        return True
    spec = importlib.util.find_spec(module_name)
    if spec is None or not spec.origin or not spec.origin.endswith(".py"):
        return False
    tree = ast.parse(Path(spec.origin).read_text(), filename=spec.origin)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        if any(n == _JAX_PACKAGE or n.startswith(_JAX_PACKAGE + ".") for n in names):
            return True
    return False


def _load_dotted(path: str, what: str):
    """The attribute a dotted path names.  A module that imports the JAX
    package is refused before it is imported: the port never loads it (an
    evaluation written against the JAX package needs the port's imports)."""
    module_name, _, attr = path.rpartition(".")
    if not module_name:
        raise ValueError(f"{what} {path!r} must be a dotted path")
    if _imports_jax_package(module_name):
        raise ImportError(
            f"{what} {path!r}: module {module_name!r} imports the JAX package "
            f"({_JAX_PACKAGE}); the port does not load it — import the same "
            f"names from {_PORT_PACKAGE} instead")
    return getattr(importlib.import_module(module_name), attr)


def run_eval_from_args(args) -> int:
    """``pio eval <Evaluation> [<EngineParamsGenerator>]`` (reference:
    Console.eval → EvaluationWorkflow), on ``args.device``: the evaluation
    class is a dotted path to an Evaluation subclass or instance, the
    optional generator a dotted path to an EngineParamsGenerator that
    supplies the candidate grid."""
    from predictionio_tpu_torch.controller.evaluation import (
        EngineParamsGenerator,
        Evaluation,
    )
    from predictionio_tpu_torch.workflow import core_workflow

    try:
        # like engine.json's directory for train: the working directory's
        # modules are importable by dotted path
        if "" not in sys.path and str(Path.cwd()) not in sys.path:
            sys.path.insert(0, str(Path.cwd()))
        obj = _load_dotted(args.evaluation_class, "evaluation class")
        evaluation = obj() if isinstance(obj, type) else obj
        if not isinstance(evaluation, Evaluation):
            raise TypeError(f"{args.evaluation_class} is not an Evaluation")
        gen_path = getattr(args, "params_generator", None)
        if gen_path:
            gobj = _load_dotted(gen_path, "engine params generator")
            gen = gobj() if isinstance(gobj, type) else gobj
            if not isinstance(gen, EngineParamsGenerator):
                raise TypeError(f"{gen_path} is not an EngineParamsGenerator")
            evaluation.engine_params_list = list(gen.engine_params_list)
        result = core_workflow.run_eval(evaluation, evaluation_class=args.evaluation_class,
                                        device=args.device)
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"Evaluation completed: {result.metric_header} best={result.best_score:.6f}")
    # the per-candidate table with the side metrics (the reference's
    # MetricEvaluator prints the whole candidate/metric matrix)
    headers = [result.metric_header] + list(result.other_metric_headers)
    for i, (_ep, score, others) in enumerate(result.engine_params_scores):
        marker = "*" if i == result.best_index else " "
        cells = "  ".join(f"{h}={v:.6f}" for h, v in zip(headers, [score] + list(others)))
        print(f"  {marker} candidate {i}: {cells}")
    print("Best engine params:")
    print(json.dumps(result.best_engine_params.to_json(), indent=2))
    return 0

"""The port's public API against the JAX package's, module by module.

One case for every module ``pkgutil.walk_packages`` finds in
``predictionio_tpu`` (and the package itself), none written by hand: the
port's module at the same path imports, every public name of the JAX
module is an attribute of it, and every function, constructor (a
dataclass's fields in order) and public method that both have takes the JAX
parameters in the JAX order (the port's ``device`` aside; parameters of the
port's own may follow them).  ``ops.pallas_kernels`` maps onto
``ops.hopper_kernels``, which must hold the four kernel entry points.  One
more case holds the ``PIO_*`` environment variables the JAX code names
(string constants, not comments or docstrings) to the port's code.

"Public" leaves out names that start with ``_``, submodules, and callables
(functions, classes, typing constructs) whose ``__module__`` lies outside
the JAX package: what a module imports from ``typing``, numpy, ``jax``,
``dataclasses`` and the like.  A module's data (constants, its logger) is
public.  The differences the port keeps on purpose are ``DELIBERATE`` and
``DELIBERATE_ENV``, each with its reason; an entry fails its case once the
JAX module no longer has the name or the port has it, so neither table can
go stale.
"""

import ast
import importlib
import inspect
import pkgutil
import re
import types
from pathlib import Path

import pytest

import _torch_native_prebuild  # noqa: F401  (the JAX native libraries, built once)
import predictionio_tpu

REPO = Path(__file__).resolve().parents[1]
JAX, PORT = "predictionio_tpu", "predictionio_tpu_torch"


def _raise(name):
    raise ImportError(f"pkgutil.walk_packages could not import {name}")


JAX_MODULES = [JAX] + sorted(
    m.name for m in pkgutil.walk_packages(predictionio_tpu.__path__, JAX + ".",
                                          onerror=_raise))

#: JAX modules whose counterpart sits at another path, with the names the
#: counterpart must hold: the Pallas kernels are the port's hand-written
#: Hopper kernels (``ops/csrc/*.cu``) behind their wrappers
MAPPED = {
    "predictionio_tpu.ops.pallas_kernels": (
        "predictionio_tpu_torch.ops.hopper_kernels",
        ("masked_score_matmul", "recommend_batch_fused", "llr_masked_scores",
         "tile_topk_desc")),
}

#: JAX names the port lacks on purpose, by module, each with its reason
#: (ROADMAP.md, the deliberate differences)
DELIBERATE = {
    "predictionio_tpu.utils": {
        "apply_platform_override": "configures JAX's platform; the port's device is "
                                   "PIO_TORCH_DEVICE",
    },
    "predictionio_tpu.utils.config": {
        "apply_platform_override": "configures JAX's platform; the port's device is "
                                   "PIO_TORCH_DEVICE",
        "enable_compilation_cache": "configures XLA's compilation cache; the port "
                                    "compiles no XLA program",
    },
    "predictionio_tpu.ops.cco": {
        "topk_impl": "picks JAX's top-k implementation; K3 (tile_topk.cu) is the "
                     "port's one top-k",
    },
    "predictionio_tpu.ops.topk": {
        "NEG_INF": "the padding score of JAX's pure-JAX top-k tournament, which K3 "
                   "replaces",
        "bitonic_topk": "JAX's pure-JAX top-k tournament; K3 (tile_topk.cu) "
                        "replaces it",
        "sort_topb_desc": "JAX's pure-JAX sorted top-b; K3 (tile_topk.cu) replaces it",
    },
}

#: PIO_* variables only the JAX package reads, each with its reason: each
#: picks a JAX implementation or configures XLA; the port has one path
DELIBERATE_ENV = {
    "PIO_PALLAS": "turns JAX's Pallas kernels on or off; the port always launches "
                  "its CUDA kernels on the card",
    "PIO_CCO_TOPK": "picks JAX's CCO top-k (lax.top_k or the tournament); the port "
                    "has K3 alone",
    "PIO_CCO_MM_DTYPE": "picks the dtype of JAX's CCO count matmul; the port's "
                        "counts are exact in one dtype",
    "PIO_JAX_CACHE": "the directory of XLA's compilation cache",
    "PIO_JAX_CACHE_MIN_S": "the least compile time XLA's cache keeps",
    "PIO_JAX_PLATFORM": "picks JAX's platform (apply_platform_override); the port's "
                        "device is PIO_TORCH_DEVICE",
}


def _public(mod):
    """``{name: value}`` of the public names of ``mod``."""
    out = {}
    for name, value in vars(mod).items():
        if name.startswith("_") or isinstance(value, types.ModuleType):
            continue
        if callable(value):
            owner = getattr(value, "__module__", None)
            if owner is not None and owner != JAX and not owner.startswith(JAX + "."):
                continue
        out[name] = value
    return out


def _params(fn):
    """Parameter names of ``fn`` without the port's ``device``."""
    return [p for p in inspect.signature(fn).parameters if p != "device"]


def _has_signature(cls):
    """False for a class whose constructor is a builtin's (an exception,
    a ``dict`` subclass without ``__init__``): nothing to compare."""
    try:
        inspect.signature(cls)
    except (TypeError, ValueError):
        return False
    return True


def _signature_pairs(name, a, b, module):
    """(label, JAX callable, port callable) for ``name`` itself when it is
    a function (``jax.jit``'s wrappers too), and for the constructor and
    every public method of a class ``module`` defines."""
    if inspect.isclass(a):
        if a.__module__ != module:
            return []
        ctor = [(f"{name}()", a, b)] if _has_signature(a) else []
        return ctor + [(f"{name}.{m}", getattr(a, m), getattr(b, m, None))
                       for m, v in vars(a).items()
                       if not m.startswith("_") and not isinstance(v, type)
                       and callable(getattr(a, m))]
    return [(name, a, b)] if callable(a) else []


def _port_name(jax_name):
    return PORT + jax_name[len(JAX):]


def test_every_jax_module_is_walked():
    """The walk finds every ``.py`` of the JAX package (a package that
    failed to import would hide its modules)."""
    files = {p.relative_to(REPO).with_suffix("").as_posix().replace("/", ".")
             for p in (REPO / JAX).rglob("*.py")}
    files = {f[:-len(".__init__")] if f.endswith(".__init__") else f for f in files}
    assert set(JAX_MODULES) == files


@pytest.mark.parametrize("jax_name", JAX_MODULES)
def test_port_module_has_the_jax_names(jax_name):
    """The port's module at the same path has every public name of the JAX
    module, and each function, constructor and public method both have
    takes the JAX parameters in the JAX order (the port's own, such as
    ``device``, may follow them), but for the ``DELIBERATE`` differences
    (which must still be differences)."""
    jax_mod = importlib.import_module(jax_name)
    if jax_name in MAPPED:
        port_name, entry_points = MAPPED[jax_name]
        port_mod = importlib.import_module(port_name)
        missing = [n for n in entry_points if not callable(getattr(port_mod, n, None))]
        assert not missing, f"{port_name} lacks {missing}"
        return
    port_mod = importlib.import_module(_port_name(jax_name))
    want = _public(jax_mod)
    deliberate = DELIBERATE.get(jax_name, {})
    stale = sorted(n for n in deliberate if n not in want or hasattr(port_mod, n))
    assert not stale, f"DELIBERATE entries of {jax_name} no longer differ: {stale}"
    missing = sorted(n for n in want if n not in deliberate and not hasattr(port_mod, n))
    assert not missing, f"{_port_name(jax_name)} lacks {missing}"
    wrong = []
    for name in sorted(set(want) - set(deliberate)):
        for label, fa, fb in _signature_pairs(name, want[name], getattr(port_mod, name),
                                              jax_name):
            if fb is None:
                wrong.append(f"{label}: missing")
            elif _params(fb)[:len(_params(fa))] != _params(fa):
                wrong.append(f"{label}: {_params(fb)} does not start with JAX's "
                             f"{_params(fa)}")
    assert not wrong, f"{_port_name(jax_name)}: {wrong}"


_ENV = re.compile(r"PIO_[A-Z0-9_]+")


def _docstrings(tree):
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


def _env_names(package):
    """The ``PIO_*`` names ``package``'s code reads or sets: string
    constants that are exactly such a name (the argument of
    ``os.environ.get``, of a helper, a prefix in an f-string), never a
    comment, a docstring or a message that mentions one."""
    names = set()
    for path in (REPO / package).rglob("*.py"):
        tree = ast.parse(path.read_text())
        docs = _docstrings(tree)
        names |= {node.value for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and isinstance(node.value, str)
                  and id(node) not in docs and _ENV.fullmatch(node.value)}
    return names


def test_port_reads_the_jax_environment_variables():
    """Every ``PIO_*`` name the JAX package's code reads is one the port's
    code reads, but for ``DELIBERATE_ENV`` (whose entries must still be
    JAX's alone)."""
    jax_env, port_env = _env_names(JAX), _env_names(PORT)
    stale = sorted(n for n in DELIBERATE_ENV if n not in jax_env or n in port_env)
    assert not stale, f"DELIBERATE_ENV entries no longer differ: {stale}"
    assert sorted(jax_env - port_env - set(DELIBERATE_ENV)) == []


@pytest.mark.parametrize("table", ["DELIBERATE", "DELIBERATE_ENV"])
def test_every_deliberate_difference_has_a_reason(table):
    rows = (DELIBERATE_ENV.items() if table == "DELIBERATE_ENV" else
            [(n, r) for names in DELIBERATE.values() for n, r in names.items()])
    assert [n for n, reason in rows if not reason.strip() or "\n" in reason] == []
    if table == "DELIBERATE":
        assert set(DELIBERATE) <= set(JAX_MODULES)

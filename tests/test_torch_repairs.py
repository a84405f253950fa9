"""Faults of the port against the JAX package, each held by a parity test
that failed before its repair:

- ``pio deploy --engine-instance-id`` was refused (the JAX parser takes the
  option and reads it nowhere): every option of every subcommand of the JAX
  ``pio`` that the port has is accepted by the port's parser;
- the public DASE names were missing (``IdentityPreparator``,
  ``AverageServing``, the P/L aliases, ``Doer.with_params``,
  ``BaseEvaluator``, ``BaseEngine.eval``, the exports of ``core``): the
  public names of ``predictionio_tpu{,.controller,.core}`` equal the port's,
  and a toy engine built on those names answers as the JAX one does;
- localfs ``find_batches`` without a snapshot read in time order (through
  ``find``), not in log order: ``FSEvents.scan`` streams the log, skipping
  lines by their event-name needles, and takes the channel positionally;
- an xdist worker that lost the JAX package's native build race kept its
  JAX scanner failed, which turns the JAX training reads to time order for
  the worker's life: the tests build both JAX libraries under a lock at
  collection and probe a failed JAX loader again.
"""

import subprocess
import sys
import types
from dataclasses import dataclass
from pathlib import Path

import pytest

from _torch_event_cases import (
    assert_same_batch,
    fill_jax,
    port_localfs_storage,
    seeded_corpus,
)

REPO = Path(__file__).resolve().parents[1]


# -- pio deploy --engine-instance-id ---------------------------------------------------


def _subparsers(parser):
    import argparse

    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return action.choices
    return {}


def _options(parser):
    return {s for a in parser._actions for s in a.option_strings}


def test_deploy_accepts_engine_instance_id_as_jax():
    """The option parses in both packages to the same value, which neither
    reads."""
    from predictionio_tpu.cli.main import build_parser as jax_parser
    from predictionio_tpu_torch.cli.main import build_parser

    argv = ["deploy", "--engine-instance-id", "abc123", "--port", "8123"]
    got, want = build_parser().parse_args(argv), jax_parser().parse_args(argv)
    assert got.engine_instance_id == want.engine_instance_id == "abc123"
    assert got.port == want.port == 8123


def test_every_jax_option_of_a_ported_subcommand_parses():
    """An argparse walk of both ``pio`` parsers: each JAX subcommand that the
    port has takes every option the JAX one takes."""
    from predictionio_tpu.cli.main import build_parser as jax_parser
    from predictionio_tpu_torch.cli.main import NOT_PORTED, build_parser

    mine, theirs = _subparsers(build_parser()), _subparsers(jax_parser())
    missing = {}
    for name, sp in theirs.items():
        if name in NOT_PORTED:
            continue
        assert name in mine, name
        lost = _options(sp) - _options(mine[name])
        if lost:
            missing[name] = sorted(lost)
    assert missing == {}


# -- the public DASE names ---------------------------------------------------------------


def _public(mod):
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}


@pytest.mark.parametrize("name", ["", ".controller", ".core"])
def test_public_names_equal_the_jax_package(name):
    import importlib

    jax_mod = importlib.import_module("predictionio_tpu" + name)
    port_mod = importlib.import_module("predictionio_tpu_torch" + name)
    assert _public(port_mod) == _public(jax_mod)


def test_dase_aliases_and_core_bases_as_jax():
    from predictionio_tpu.controller import dase as jax_dase
    from predictionio_tpu.core import base as jax_base
    from predictionio_tpu_torch.controller import dase
    from predictionio_tpu_torch.core import base

    for alias in ("PDataSource", "LDataSource", "PPreparator", "LPreparator", "PAlgorithm",
                  "LAlgorithm", "P2LAlgorithm", "LServing"):
        target = getattr(jax_dase, alias).__name__
        assert getattr(dase, alias) is getattr(dase, target), alias
    assert base.A.__name__ == jax_base.A.__name__ == "A"
    assert [p.__name__ for p in base.BaseDataSource.__parameters__] == [
        p.__name__ for p in jax_base.BaseDataSource.__parameters__]
    assert base.BaseEvaluator.__abstractmethods__ == jax_base.BaseEvaluator.__abstractmethods__
    assert base.BaseEngine.__abstractmethods__ == jax_base.BaseEngine.__abstractmethods__


def _toy(pkg):
    """A toy engine on ``IdentityPreparator`` and ``AverageServing``, written
    once against either package's names."""
    import importlib

    c = importlib.import_module(pkg + ".controller")

    @dataclass
    class ScaleParams(c.Params):
        factor: float = 1.0

    class Source(c.PDataSource):
        def read_training(self):
            return [1.0, 2.0, 4.0, 9.0]

    class Mean(c.P2LAlgorithm):
        params_class = ScaleParams

        def train(self, data):
            return sum(data) / len(data) * self.params.factor

        def predict(self, model, query):
            return model * query

    class Last(c.LAlgorithm):
        def train(self, data):
            return data[-1]

        def predict(self, model, query):
            return model + query

    engine = c.Engine(Source, c.IdentityPreparator, {"mean": Mean, "last": Last},
                      c.AverageServing)
    ep = c.EngineParams(algorithm_params_list=[
        ("mean", Mean.with_params({"factor": 3.0}).params), ("last", c.EmptyParams()),
        ("mean", ScaleParams(factor=0.5))])
    return engine, ep


def test_toy_engine_on_identity_preparator_and_average_serving_answers_as_jax():
    j_engine, j_ep = _toy("predictionio_tpu")
    p_engine, p_ep = _toy("predictionio_tpu_torch")
    j_models = j_engine.train(j_ep)
    p_models = p_engine.train(p_ep, device="cpu")
    assert p_models == j_models == [12.0, 9.0, 2.0]
    j_pred, p_pred = j_engine.predictor(j_ep, j_models), p_engine.predictor(p_ep, p_models)
    for q in (0.0, 1.0, -2.5, 10.0):
        assert p_pred(q) == j_pred(q)


# -- localfs scan: log order, needles, the positional channel ---------------------------


@pytest.fixture()
def probe_store(fs_storage, tmp_path):
    """The re-anchor's probe: ``seeded_corpus(3)`` written by the JAX package
    into its localfs store, no snapshot; the port's storage on the same
    directory."""
    app_id = fill_jax(fs_storage, "probe", seeded_corpus(3))
    root = fs_storage.config.sources[fs_storage.config.repositories["EVENTDATA"]]["path"]
    return fs_storage, port_localfs_storage(root), app_id


@pytest.mark.parametrize("names", [None, ["purchase", "view"], ["$set"], []])
def test_find_batches_without_a_snapshot_reads_in_log_order(probe_store, names):
    jax_store, port_store, app_id = probe_store
    kw = {} if names is None else {"event_names": names}
    want = list(jax_store.p_events.find_batches(app_id, **kw))
    got = list(port_store.p_events.find_batches(app_id, **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_batch(g, w)


@pytest.mark.parametrize("kw", [{}, {"event_names": ["view"]},
                                {"entity_type": "item", "event_names": ["$set", "$unset"]},
                                {"target_entity_type": "item", "start_time": "2026-05-28"}])
def test_scan_streams_the_log_as_jax(probe_store, kw):
    from predictionio_tpu_torch.events.event import parse_time

    jax_store, port_store, app_id = probe_store
    pkw = dict(kw)
    if "start_time" in kw:
        pkw["start_time"] = kw["start_time"] = parse_time(kw["start_time"] + "T00:00:00Z")
    got = [(e.event_id, e.event) for e in port_store.l_events.scan(app_id, None, **pkw)]
    want = [(e.event_id, e.event) for e in jax_store.l_events.scan(app_id, None, **kw)]
    assert got == want and got


def test_event_needles_as_jax():
    from predictionio_tpu.storage.localfs import FSEvents as JaxFSEvents
    from predictionio_tpu_torch.storage.localfs import FSEvents

    for names in (None, [], ["view"], ["$set", 'q"uote', "ü"]):
        assert FSEvents._event_needles(names) == JaxFSEvents._event_needles(names)


# -- the JAX native libraries, built once ----------------------------------------------


_RACE = r"""
import sys, time
from pathlib import Path
sys.path.insert(0, sys.argv[3])
import predictionio_tpu.native.build as b
b.BUILD_DIR = Path(sys.argv[1])
from predictionio_tpu.native import core, scanner
while time.time() < float(sys.argv[2]):
    time.sleep(0.005)
# the JAX test modules' own probes at collection, unlocked: these race
first = (scanner.native_available(), core.lib() is not None)
import _torch_native_prebuild   # builds under the lock, probes a lost race again
assert scanner.native_available(), "the JAX scanner did not load"
assert core.lib() is not None, "the JAX data plane did not load"
print("loaded", first)
"""


def test_jax_native_prebuild_survives_racing_workers(tmp_path):
    """Six processes probe the JAX libraries at the same instant in one
    empty build directory, unlocked, as xdist workers collecting the JAX
    native tests do (some may lose that race), and then import the
    prebuild: every one ends with both JAX libraries loaded."""
    import shutil
    import time

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler")
    start = time.time() + 3.0
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, str(tmp_path / "b"), str(start),
                               str(REPO / "tests")], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip().splitlines()[-1].startswith("loaded")
    built = sorted(p.name for p in (tmp_path / "b").glob("*.so"))
    assert [n.split("-")[0] for n in built] == ["libdataplane", "libeventscan"], built

"""The port's generation lineage (``obs/lineage.py`` and its hooks in the
follow-trainer, the query server's install and first answer, the model
plane and replication) against the JAX package's (the parity target is
the JAX suite's tests/test_lineage.py and tests/test_cluster_obs.py's
stitching cases).

- A ``FollowTrainer`` of each package, hosted by its ``QueryServerState``
  over the same seeded appends, leaves records with equal stage sequences
  (in ``STAGE_ORDER``), generations and outcomes.
- ``merge_records`` and ``apply_cluster_outcome`` give equal output on the
  same fragments, supersession and orphans included.
- ``render_lineage_text`` and ``render_lineage_cluster_text`` are
  byte-equal.
- A plane publisher of one package and a replication subscriber of the
  other stitch one record: the subscriber's ``repl.*`` stages reach the
  publisher's record under its lineage id, in its node's lane.
- The recorders of the two packages persist into one directory and each
  merges the other's files.
"""

import copy
import time

import numpy as np
import pytest

from predictionio_tpu.controller.engine import EngineParams as JaxEngineParams
from predictionio_tpu.events.event import Event as JaxEvent
from predictionio_tpu.models.universal_recommender import (
    UniversalRecommenderEngine as JaxUREngine,
)
from predictionio_tpu.models.universal_recommender.engine import URAlgorithmParams as JaxAP
from predictionio_tpu.models.universal_recommender.engine import URDataSourceParams as JaxDSP
from predictionio_tpu.obs import lineage as jax_lineage
from predictionio_tpu.storage import App as JaxApp
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu.streaming.follow import FollowTrainer as JaxFollowTrainer
from predictionio_tpu.streaming.plane import ModelPlane as JaxPlane
from predictionio_tpu.streaming.replicate import PlaneReplicator as JaxReplicator
from predictionio_tpu.streaming.replicate import PlaneSubscriber as JaxSubscriber
from predictionio_tpu.workflow import core_workflow as jax_workflow
from predictionio_tpu.workflow.create_server import QueryServerState as JaxState
from predictionio_tpu_torch.events.event import Event as PortEvent
from predictionio_tpu_torch.models.universal_recommender import URQuery as PortQuery
from predictionio_tpu_torch.obs import lineage as port_lineage
from predictionio_tpu_torch.storage import App as PortApp
from predictionio_tpu_torch.storage import set_storage as port_set_storage
from predictionio_tpu_torch.streaming.follow import FollowTrainer as PortFollowTrainer
from predictionio_tpu_torch.streaming.plane import ModelPlane as PortPlane
from predictionio_tpu_torch.streaming.replicate import PlaneReplicator as PortReplicator
from predictionio_tpu_torch.streaming.replicate import PlaneSubscriber as PortSubscriber
from predictionio_tpu_torch.workflow import core_workflow as port_workflow
from predictionio_tpu_torch.workflow.create_server import QueryServerState as PortState

from _torch_obs_cases import lineages, localfs_pair, mask, poll  # noqa: F401  (fixture)
from _torch_serve_cases import make_models
from _torch_stream_cases import ur_params as port_ur_params

APP = "lnapp"


def _frag(lid, start, stages, outcome=None, origin=None, generation=None):
    doc = {"lid": lid, "start": start, "stages": stages}
    if outcome:
        doc["outcome"] = outcome
    if origin:
        doc["origin"] = origin
    if generation is not None:
        doc["generation"] = generation
    return doc


def _stage(name, start, worker="w", node=None, duration_s=0.01, **extra):
    s = {"stage": name, "start": start, "duration_s": duration_s, "worker": worker, **extra}
    if node:
        s["node"] = node
    return s


def _node_lane(start, node):
    return [_stage("repl.recv", start, node, node), _stage("repl.verify", start + 0.05, node, node),
            _stage("repl.land", start + 0.1, node, node), _stage("install", start + 0.2, node, node),
            _stage("first_serve", start + 0.3, node, node)]


def _origin(lid, start=100.0):
    return _frag(lid, start, [_stage("append_observed", start, "pub"),
                              _stage("publish", start + 0.5, "pub"),
                              _stage("install", start + 0.6, "pub-w"),
                              _stage("first_serve", start + 0.7, "pub-w")],
                 outcome="published", generation=7)


#: fragment lists of the JAX suite's merge and stitching cases
MERGE_CASES = {
    "complete": [_frag("ln-a", 100.0, [_stage("append_observed", 100.0, "pub"),
                                       _stage("publish", 100.5, "pub")],
                       outcome="published", origin="pub", generation=7),
                 _frag("ln-a", 100.0, [_stage("install", 101.0, "w1"),
                                       _stage("cache_invalidation", 101.0, "w1",
                                              parent="install", outcome="full_flush"),
                                       _stage("first_serve", 101.2, "w1")])],
    "published": [_frag("ln-b", 50.0, [_stage("publish", 50.4, "pub")], outcome="published")],
    "superseded": [_frag("ln-dead", 10.0, [_stage("append_observed", 10.0, "pub")]),
                   _frag("ln-live", 20.0, [_stage("publish", 20.3, "pub")],
                         outcome="published")],
    "newest_open": [_frag("ln-old", 10.0, [_stage("publish", 10.1, "pub")],
                          outcome="published"),
                    _frag("ln-new", 30.0, [_stage("append_observed", 30.0, "pub")])],
    "dedupe": [_frag("ln-c", 5.0, [_stage("publish", 5.0, "pub")], outcome="published"),
               _frag("ln-c", 5.0, [_stage("publish", 5.0, "pub")])],
    "orphan_lane": [_frag("ln-o", 40.0, _node_lane(41.0, "node-a"))],
    "two_nodes": [_origin("ln-x"), _frag("ln-x", 100.0, _node_lane(101.0, "node-a")),
                  _frag("ln-x", 100.0, _node_lane(102.0, "node-b"))],
    "lagging": [_origin("ln-y"), _frag("ln-y", 100.0, _node_lane(101.0, "node-a")),
                _frag("ln-y", 100.0, _node_lane(102.0, "node-b")[:3])],
}

#: (expected nodes, live nodes) of the stitching cases
CLUSTER_VIEWS = [([], None), (["node-a"], None), (["node-a", "node-b"], ["node-a", "node-b"]),
                 (["node-a", "node-b"], []), (["node-a", "node-c"], ["node-a"])]


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_records_equal_the_jax_merge(case):
    frags = MERGE_CASES[case]
    want = jax_lineage.merge_records(copy.deepcopy(frags))
    assert port_lineage.merge_records(copy.deepcopy(frags)) == want


@pytest.mark.parametrize("view", range(len(CLUSTER_VIEWS)))
@pytest.mark.parametrize("case", ["two_nodes", "lagging", "orphan_lane", "complete"])
def test_cluster_outcome_and_renderers_equal_the_jax_package(case, view):
    expected, live = CLUSTER_VIEWS[view]
    for doc in jax_lineage.merge_records(copy.deepcopy(MERGE_CASES[case])):
        want = jax_lineage.apply_cluster_outcome(copy.deepcopy(doc), expected, live)
        got = port_lineage.apply_cluster_outcome(copy.deepcopy(doc), expected, live)
        assert got == want
        for width in (44, 20):
            assert (port_lineage.render_lineage_text(got, width=width)
                    == jax_lineage.render_lineage_text(want, width=width))
            assert (port_lineage.render_lineage_cluster_text(got, width=width)
                    == jax_lineage.render_lineage_cluster_text(want, width=width))


def test_stage_order_and_cluster_node_as_jax(monkeypatch):
    assert port_lineage.STAGE_ORDER == jax_lineage.STAGE_ORDER
    monkeypatch.setenv("PIO_CLUSTER_NODE", "node-q")
    assert port_lineage.cluster_node() == jax_lineage.cluster_node() == "node-q"
    monkeypatch.delenv("PIO_CLUSTER_NODE")
    assert port_lineage.cluster_node() == jax_lineage.cluster_node()


def test_recorders_of_both_packages_merge_one_directory(tmp_path):
    """A JAX publisher's record and a port worker's install/first-serve
    stages in one lineage directory: either side's merged view is the
    whole, complete record."""
    pub = jax_lineage.LineageRecorder(directory=tmp_path, tag="pub-1", enabled=True)
    worker = port_lineage.LineageRecorder(directory=tmp_path, tag="w1-1", enabled=True)
    lid = pub.new_id()
    t0 = time.time()
    pub.begin(lid, start=t0)
    pub.stage(lid, "append_observed", start=t0, duration_s=0.01)
    pub.stage(lid, "publish", start=t0 + 0.1, duration_s=0.02)
    pub.note_generation(lid, 3)
    pub.close(lid, outcome="published")
    worker.stage(lid, "install", start=t0 + 0.3, duration_s=0.01, flush=True)
    worker.stage(lid, "first_serve", start=t0 + 0.4, duration_s=0.005, flush=True)
    assert worker.get(lid) == pub.get(lid)
    doc = worker.get(lid)
    assert doc["outcome"] == "complete" and doc["generation"] == 3
    assert set(doc["workers"]) == {"pub-1", "w1-1"}
    assert worker.get_generation(3)["lid"] == lid
    assert worker.index()["records"] == pub.index()["records"]


# -- the follow-trainer's records -----------------------------------------------------------


def _appends(seed, n_users=10, n_items=7, base_u=0):
    rng = np.random.default_rng(seed)
    out = []
    for u in range(base_u, base_u + n_users):
        for it in range(n_items):
            if rng.random() < 0.45:
                out.append(("purchase", f"u{u}", f"i{it}"))
            if rng.random() < 0.6:
                out.append(("view", f"u{u}", f"i{it}"))
    return out


def _events(cls, rows):
    return [cls(event=e, entity_type="user", entity_id=u, target_entity_type="item",
                target_entity_id=i) for e, u, i in rows]


ROUNDS = [_appends(2, 3, 7, base_u=20), [("purchase", "u1", "i9"), ("purchase", "u2", "i9")],
          _appends(3, 2, 9, base_u=30)]


def _jax_pair(store):
    engine = JaxUREngine.apply()
    ep = JaxEngineParams(
        data_source_params=JaxDSP(app_name=APP, event_names=["purchase", "view"]),
        algorithm_params_list=[("ur", JaxAP(app_name=APP, mesh_dp=1,
                                            max_correlators_per_item=6))])
    jax_workflow.run_train(engine, ep, engine_id="ln-eng", storage=store)
    state = JaxState(engine, ep, JaxUREngine.query_class, "ln-eng", "1", "default",
                     storage=store)
    follower = state.follower = JaxFollowTrainer(
        engine, ep, "ln-eng", storage=store, interval=3600,
        on_publish=state.swap_models, persist=False)
    return state, follower


def _port_pair(store):
    engine, _, ep = port_ur_params(APP, max_correlators_per_item=6)
    port_workflow.run_train(engine, ep, engine_id="ln-eng", storage=store, device="cpu")
    state = PortState(engine, ep, PortQuery, "ln-eng", "1", "default", storage=store,
                      device="cpu")
    follower = state.follower = PortFollowTrainer(
        engine, ep, "ln-eng", storage=store, interval=3600,
        on_publish=state.swap_models, persist=False, device="cpu")
    return state, follower


def _records_shape(recorder):
    out = []
    for rec in sorted(recorder.merged(), key=lambda r: r["start"]):
        names = [s["stage"] for s in rec["stages"]]
        out.append({"stages": names, "generation": rec.get("generation"),
                    "outcome": rec["outcome"],
                    "attrs": [mask({k: v for k, v in s.items()
                                    if k not in ("stage", "worker", "node")})
                              for s in rec["stages"]]})
    return out


def test_follow_trainer_records_equal_the_jax_package(tmp_path, lineages, monkeypatch):
    for k in ("PIO_HISTORY_CACHE", "PIO_SERVE_CACHE", "PIO_NATIVE"):
        monkeypatch.setenv(k, "off")
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "host")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "host")
    monkeypatch.delenv("PIO_CLUSTER_NODE", raising=False)
    jstore, pstore = localfs_pair(tmp_path)
    seed = _appends(1)
    jid = jstore.apps.insert(JaxApp(0, APP))
    pid = pstore.apps.insert(PortApp(0, APP))
    jstore.l_events.insert_batch(_events(JaxEvent, seed), jid)
    pstore.l_events.insert_batch(_events(PortEvent, seed), pid)
    jax_set_storage(jstore)
    port_set_storage(pstore)
    followers = []
    try:
        jstate, jfollow = _jax_pair(jstore)
        pstate, pfollow = _port_pair(pstore)
        followers += [jfollow, pfollow]
        assert jfollow.bootstrap() and pfollow.bootstrap()
        for rows in ROUNDS:
            jstore.l_events.insert_batch(_events(JaxEvent, rows), jid)
            pstore.l_events.insert_batch(_events(PortEvent, rows), pid)
            assert jfollow.tick() == pfollow.tick() == "fold"
            jstate.predict({"user": "u1", "num": 3})
            pstate.predict({"user": "u1", "num": 3})
        want = _records_shape(lineages["jax"])
        got = _records_shape(lineages["port"])
        assert got == want and len(got) == len(ROUNDS)
        order = port_lineage.STAGE_ORDER
        for rec in got:
            assert rec["outcome"] == "complete"
            ranks = [order.index(n) for n in rec["stages"]]
            assert ranks == sorted(ranks), rec["stages"]
            assert {"append_observed", "fold.apply", "fold.rellr", "publish",
                    "install", "cache_invalidation", "first_serve"} <= set(rec["stages"])
        assert [r["generation"] for r in got] == [pstate.generation - 2 + i
                                                  for i in range(len(ROUNDS))]
    finally:
        for f in followers:
            f.stop(timeout=2.0)
        jax_set_storage(None)
        port_set_storage(None)


# -- replication between the packages --------------------------------------------------------


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_mixed_publisher_and_subscriber_stitch_one_record(tmp_path, lineages, direction):
    jax_model, port_model = make_models(n_items=90, k=5, seed=4)
    if direction == "jax_to_port":
        pub_lin, pub_mod = lineages["jax"], jax_lineage
        plane = JaxPlane(str(tmp_path / "pub"))
        model, repl_cls, sub_cls = jax_model, JaxReplicator, PortSubscriber
    else:
        pub_lin, pub_mod = lineages["port"], port_lineage
        plane = PortPlane(str(tmp_path / "pub"), device="cpu")
        model, repl_cls, sub_cls = port_model, PortReplicator, JaxSubscriber
    lid = pub_lin.new_id()
    pub_lin.begin(lid)
    pub_lin.stage(lid, "append_observed", duration_s=0.001, events=3)
    gen = plane.publish([model], {"mode": "fold", "lineageId": lid})
    pub_lin.stage(lid, "publish", duration_s=0.001, mode="fold")
    pub_lin.close(lid, outcome="published")
    repl = repl_cls(plane, bind="127.0.0.1:0")
    repl.start()
    pub_mod.set_cluster_provider(repl.cluster_view)
    sub = sub_cls(str(tmp_path / "sub"), f"127.0.0.1:{repl.port}", node="node-a")
    try:
        sub.start()
        assert sub.wait_generation(gen, 20.0)

        def stitched():
            doc = pub_mod.annotate_cluster(pub_lin.get(lid))
            lane = [s["stage"] for s in doc["stages"] if s.get("node") == "node-a"]
            return doc if {"repl.recv", "repl.verify", "repl.land"} <= set(lane) else None
        doc = poll(stitched, timeout=10.0)
        assert doc["generation"] == gen
        assert [s["stage"] for s in doc["stages"] if s["stage"] == "plane.write"]
        assert doc["cluster"]["expected"] == ["node-a"]
        assert doc["cluster"]["nodes"]["node-a"]["status"] == "open"
        assert repl.peers()["node-a"]["connected"] is True
        assert repl.cluster_view() == {"expected": ["node-a"], "live": ["node-a"]}
        plan = [s for s in doc["stages"] if s["stage"] == "repl.plan"]
        assert plan and plan[0]["attrs"]["peer"] == "node-a"
        assert plan[0]["attrs"]["resync"] == "cold"
    finally:
        sub.stop()
        repl.stop()

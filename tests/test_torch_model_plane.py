"""The port's model plane (``streaming/plane.py``) and its container
(``store/columnar.write_arrays``/``read_arrays``), against the JAX package.

Exactness, bit for bit throughout: the container is byte-identical to the
JAX writer's for the same arrays, each package reads the other's file as
read-only views and both refuse a torn one; a JAX publisher's keyframe and
fold deltas compose in the port into the JAX model's arrays and
dictionaries, and a port publisher's compose in the JAX package into the
port's; the port's own delta generations (on an incremental reader and a
cold joiner) equal the full-arena oracle (``PIO_MODEL_PLANE_DELTA=off``).
Parity: the port's fold and the JAX fold on the same log, each through its
own plane, agree within 1e-4 (ids equal up to ties; ROADMAP §A.12's bar).
The rest mirrors tests/test_model_plane.py: dictionary carry and
extension, torn files quarantined while the old generation serves, GC
chain refcounting, keyframe interval and restart replay, the watcher's
inotify wake and stat-poll fallback, two query servers converging on one
plane, the embedded follower publishing through it, and a prefork group
with one publisher process.  Every wait is bounded.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from predictionio_tpu.store import columnar as jax_columnar
from predictionio_tpu.streaming import plane as jax_plane
from predictionio_tpu_torch.models.universal_recommender.convert import ur_model_from_state
from predictionio_tpu_torch.store import columnar
from predictionio_tpu_torch.streaming import plane
from predictionio_tpu_torch.streaming.plane import ModelPlane, PlaneWatcher

from _torch_event_cases import jax_events, port_localfs_storage, seeded_corpus
from _torch_plane_cases import (  # noqa: F401  (fixtures)
    CPU,
    assert_models_identical,
    buy,
    canon,
    corpus,
    freshness_delta,
    host_serving,
    plane_dir,
    port_fold_delta,
    port_fold_state,
    port_mem,
    read_only_views,
    seed_app,
    ur,
)
from test_model_plane import _fold_delta as jax_fold_delta
from test_model_plane import _fold_state as jax_fold_state
from test_model_plane import _wait_group
from test_torch_streaming_fold import _assert_tables_match, _full_llr, _jax_params

REPO = Path(__file__).resolve().parent.parent
RTOL = ATOL = 1e-4


# -- the PIOARR01 container ----------------------------------------------------------

def _arrays(case):
    rng = np.random.default_rng(case)
    if case == 0:
        return {"a": rng.random((7, 5)).astype(np.float32),
                "b": rng.integers(-9, 9, 13).astype(np.int64),
                "c": np.frombuffer("héllo wörld".encode(), np.uint8)}, {"k": [1, "x"]}
    if case == 1:
        return {"empty": np.zeros(0, np.int32), "scalar": np.float64(3.5),
                "strided": rng.integers(0, 99, (6, 8)).astype(np.int32)[:, ::3],
                "bool": rng.random(65) < 0.5}, None
    return {f"k{j}": rng.standard_normal(int(n)).astype(dt)
            for j, (n, dt) in enumerate(zip(rng.integers(1, 300, 6),
                                            [np.float32, np.float64, np.int32, np.int16,
                                             np.uint8, np.float32]))}, {"generation": 4}


@pytest.mark.parametrize("case", [0, 1, 2])
def test_write_arrays_byte_identical_and_cross_read(tmp_path, case):
    """The same arrays give the same file from both writers; each package
    reads the other's file as read-only mapped views, equal to the source."""
    arrays, meta = _arrays(case)
    port_path, jax_path = tmp_path / "port.arr", tmp_path / "jax.arr"
    columnar.write_arrays(port_path, arrays, meta)
    jax_columnar.write_arrays(jax_path, arrays, meta)
    assert port_path.read_bytes() == jax_path.read_bytes()
    for reader, path in ((columnar.read_arrays, jax_path),
                         (jax_columnar.read_arrays, port_path)):
        got, got_meta = reader(path, mmap=True)
        assert got_meta == (meta or {})
        assert list(got) == list(arrays)
        for name, want in arrays.items():
            want = np.ascontiguousarray(want)
            assert got[name].dtype == want.dtype and np.array_equal(got[name], want), name
            assert not got[name].flags.writeable
        copies, _ = reader(path, mmap=False)
        assert all(a.flags.writeable for a in copies.values())


@pytest.mark.parametrize("cut", ["empty", "magic", "header", "blob"])
def test_read_arrays_refuses_a_torn_file_in_both(tmp_path, cut):
    arrays, meta = _arrays(0)
    good = tmp_path / "good.arr"
    columnar.write_arrays(good, arrays, meta)
    raw = good.read_bytes()
    hlen = int.from_bytes(raw[8:16], "little")
    keep = {"empty": 0, "magic": 12, "header": 16 + hlen // 2, "blob": len(raw) - 3}[cut]
    torn = tmp_path / "torn.arr"
    torn.write_bytes(raw[:keep])
    for reader in (columnar.read_arrays, jax_columnar.read_arrays):
        with pytest.raises(ValueError):
            reader(torn)


# -- the port's plane on its own -----------------------------------------------------

def test_plane_roundtrip_bit_exact_and_readonly(port_mem, host_serving, plane_dir):
    """A mapped generation equals the published model array for array,
    answers every query identically, carries the derived serving state
    built, and refuses writes into the shared views."""
    seed_app(port_mem)
    engine, ep, algo = ur()
    model = engine.train(ep, device=CPU)[0]
    pub = ModelPlane(plane_dir, device=CPU)
    assert pub.publish([model], {"mode": "test"}) == 1
    sub = ModelPlane(plane_dir, device=CPU)
    mapped, info = sub.load(sub.current())
    assert info["planeGeneration"] == 1 and mapped.__dict__["_plane_generation"] == 1
    assert_models_identical(mapped, model)
    for q in corpus():
        assert canon(algo.predict(mapped, q)) == canon(algo.predict(model, q))
    for arr in read_only_views(mapped):
        assert not arr.flags.writeable
        with pytest.raises(ValueError):
            arr[..., 0] = 1


def test_device_staging_never_aliases_a_mapped_view(port_mem, plane_dir, monkeypatch):
    """The device halves stage the composed tables by copy: no tensor
    shares memory with the read-only mapping (no non-writable warning),
    and the answers equal the private model's."""
    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "device")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "device")
    seed_app(port_mem)
    engine, ep, algo = ur()
    model = engine.train(ep, device=CPU)[0]
    pub = ModelPlane(plane_dir, device=CPU)
    pub.publish([model])
    mapped, _ = pub.load(pub.current())
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        mapped.warm()
        staged = mapped.device_indicators()
    for name, (idx, _valid, llr) in staged.items():
        for view in (mapped.indicator_idx[name], mapped.indicator_llr[name]):
            lo = view.__array_interface__["data"][0]
            for t in (idx, llr):
                assert not (lo <= t.data_ptr() < lo + view.nbytes)
        valid = np.asarray(mapped.indicator_idx[name]) >= 0
        assert torch.equal(llr[torch.as_tensor(valid)],
                           torch.tensor(np.asarray(mapped.indicator_llr[name])[valid]))
    for q in corpus():
        assert canon(algo.predict(mapped, q)) == canon(algo.predict(model, q))


def test_plane_dict_carry_and_extension(port_mem, host_serving, plane_dir):
    """Unchanged dictionaries carry by object across mapped generations; an
    end-grown item dictionary extends the reader's previous one."""
    from predictionio_tpu_torch.store.columnar import IdDict

    seed_app(port_mem)
    engine, ep, _ = ur()
    model = engine.train(ep, device=CPU)[0]
    pub, sub = ModelPlane(plane_dir, device=CPU), ModelPlane(plane_dir, device=CPU)
    pub.publish([model])
    m1, _ = sub.load(sub.current())
    rebuilt0 = sub.dicts_rebuilt
    pub.publish([model])
    m2, _ = sub.load(sub.current())
    assert m2.item_dict is m1.item_dict and m2.user_dict is m1.user_dict
    assert sub.dicts_rebuilt == rebuilt0
    grown = model.item_dict.clone()
    grown.add("brand-new-item")
    model.item_dict = grown
    model.event_item_dicts = {"purchase": grown}
    k = model.indicator_idx["purchase"].shape[1]
    model.indicator_idx = {"purchase": np.vstack([model.indicator_idx["purchase"],
                                                  -np.ones((1, k), np.int32)])}
    model.indicator_llr = {"purchase": np.vstack([model.indicator_llr["purchase"],
                                                  np.zeros((1, k), np.float32)])}
    model.popularity = np.concatenate([np.asarray(model.popularity, np.float32), [0.0]])
    for attr in ("_host_inv", "_host_pop_order", "_host_pop", "_pop_norm"):
        model.__dict__.pop(attr, None)
    pub.publish([model])
    ext0 = sub.dicts_extended
    m3, _ = sub.load(sub.current())
    assert sub.dicts_extended == ext0 + 1
    assert m3.item_dict.strings() == grown.strings() and isinstance(m3.item_dict, IdDict)


def test_torn_arena_quarantined_old_generation_serves(port_mem, host_serving, plane_dir):
    """A tmp file of a killed publisher is invisible; a torn arena the
    manifest names is quarantined and the old generation keeps serving,
    until the next good publish supersedes it."""
    seed_app(port_mem)
    engine, ep, algo = ur()
    model = engine.train(ep, device=CPU)[0]
    pub = ModelPlane(plane_dir, device=CPU)
    pub.publish([model])
    sub = ModelPlane(plane_dir, device=CPU)
    installed = []
    watcher = PlaneWatcher(sub, lambda models, info: (installed.append(models[0]), True)[1],
                           poll_s=0.05)
    assert watcher.check_now() and watcher.generation == 1
    (Path(plane_dir) / ".gen-0000000002.arena.tmp-999").write_bytes(b"PIOARR01garbage")
    assert not watcher.check_now()
    (Path(plane_dir) / "gen-0000000002.arena").write_bytes(b"PIOARR01" + b"\x00" * 8)
    pub._write_manifest({**pub.current(), "generation": 2, "file": "gen-0000000002.arena"})
    assert not watcher.check_now()
    assert watcher.generation == 1
    assert (Path(plane_dir) / "gen-0000000002.arena.quarantine").exists()
    q = corpus()[0]
    assert canon(algo.predict(installed[-1], q)) == canon(algo.predict(model, q))
    assert pub.publish([model]) == 3
    assert watcher.check_now() and watcher.generation == 3


def test_gc_keeps_window_and_never_breaks_a_mapped_arena(port_mem, host_serving, plane_dir,
                                                         monkeypatch):
    """With full arenas GC keeps PIO_MODEL_PLANE_KEEP generations (counted
    in pio_model_plane_gc_total); a model mapping an unlinked arena keeps
    answering identically."""
    monkeypatch.setenv("PIO_MODEL_PLANE_KEEP", "2")
    monkeypatch.setenv("PIO_MODEL_PLANE_DELTA", "off")
    seed_app(port_mem)
    engine, ep, algo = ur()
    model = engine.train(ep, device=CPU)[0]
    pub, sub = ModelPlane(plane_dir, device=CPU), ModelPlane(plane_dir, device=CPU)
    pub.publish([model])
    mapped, _ = sub.load(sub.current())
    ref = [canon(algo.predict(mapped, q)) for q in corpus()]
    gc0 = plane._M_GC.value()
    for _ in range(4):
        pub.publish([model])
    assert sorted(p.name for p in Path(plane_dir).glob("gen-*.arena")) == [
        "gen-0000000004.arena", "gen-0000000005.arena"]
    assert plane._M_GC.value() > gc0
    assert [canon(algo.predict(mapped, q)) for q in corpus()] == ref


# -- delta arenas ----------------------------------------------------------------------

def test_delta_composed_bit_exact_vs_full_arena_oracle(plane_dir, tmp_path, monkeypatch):
    """Freshness-shaped port folds published as deltas compose, on an
    incremental reader and on a cold mid-chain joiner, into models
    bit-identical to the full-arena oracle's; each delta writes <= 10% of
    the keyframe's bytes and a duplicate-only fold <= 5%."""
    n_items = 2000
    state = port_fold_state(n_items=n_items, k=8)
    pub, worker = ModelPlane(plane_dir, device=CPU), ModelPlane(plane_dir, device=CPU)
    oracle_pub = ModelPlane(str(tmp_path / "oracle"), device=CPU)
    oracle_sub = ModelPlane(str(tmp_path / "oracle"), device=CPU)

    def oracle_load(model):
        monkeypatch.setenv("PIO_MODEL_PLANE_DELTA", "off")
        try:
            oracle_pub.publish([model])
            return oracle_sub.load(oracle_sub.current())[0]
        finally:
            monkeypatch.delenv("PIO_MODEL_PLANE_DELTA")

    m0 = state.model
    m0.ensure_host_serving_state()
    pub.publish([m0], {"mode": "fold"})
    full_bytes = pub.last_publish_stats["written"]
    assert_models_identical(worker.load(worker.current())[0], oracle_load(m0))
    cold = None
    for r in range(3):
        m = port_fold_delta(state, freshness_delta(r, n_items))
        pub.publish([m], {"mode": "fold"})
        st = pub.last_publish_stats
        assert os.path.exists(os.path.join(plane_dir, f"gen-{r + 2:010d}.delta"))
        assert st["written"] <= 0.10 * full_bytes, st
        wa, info = worker.load(worker.current())
        assert info["planeGeneration"] == r + 2
        ref = oracle_load(m)
        assert_models_identical(wa, ref)
        assert_models_identical(wa, m)
        if r == 1:
            cold = ModelPlane(plane_dir, device=CPU)
        if cold is not None:
            assert_models_identical(cold.load(cold.current())[0], ref)
        for arr in (wa.indicator_llr["buy"], wa.popularity, wa.__dict__["_host_inv"]["buy"][2]):
            assert not arr.flags.writeable

    def written():
        return (plane._M_PUB_BYTES.value(path="full") or 0) + (
            plane._M_PUB_BYTES.value(path="delta") or 0)

    before = written()
    m = port_fold_delta(state, [buy("u0", "i0", "buy")])
    pub.publish([m], {"mode": "fold"})
    assert pub.last_publish_stats["written"] <= 0.05 * full_bytes
    assert written() - before <= 0.05 * full_bytes
    assert_models_identical(worker.load(worker.current())[0], oracle_load(m))


def test_publisher_sigkill_mid_blob_and_mid_manifest(plane_dir):
    """A killed publisher's partial tmp files are invisible; a torn delta
    the manifest names is quarantined while the old generation serves, and
    a restarted publisher heals with a keyframe."""
    n_items = 600
    state = port_fold_state(n_items=n_items)
    pub = ModelPlane(plane_dir, device=CPU)
    m0 = state.model
    m0.ensure_host_serving_state()
    pub.publish([m0], {"mode": "fold"})
    pub.publish([port_fold_delta(state, freshness_delta(0, n_items))], {"mode": "fold"})
    sub = ModelPlane(plane_dir, device=CPU)
    installed = []
    watcher = PlaneWatcher(sub, lambda models, info: (installed.append(models[0]), True)[1],
                           poll_s=0.05)
    assert watcher.check_now() and watcher.generation == 2
    (Path(plane_dir) / ".gen-0000000003.delta.tmp-999").write_bytes(b"PIOARR01" + b"\0" * 4)
    (Path(plane_dir) / "CURRENT.json.tmp-999").write_bytes(b'{"gen')
    assert not watcher.check_now() and watcher.generation == 2
    m2 = port_fold_delta(state, freshness_delta(1, n_items))
    pub.publish([m2], {"mode": "fold"})
    torn = Path(plane_dir) / "gen-0000000003.delta"
    good = torn.read_bytes()
    torn.write_bytes(good[:len(good) // 2])
    assert not watcher.check_now() and watcher.generation == 2
    assert (Path(plane_dir) / "gen-0000000003.delta.quarantine").exists()
    pub2 = ModelPlane(plane_dir, device=CPU)
    assert pub2.publish([m2], {"mode": "fold"}) == 4
    assert (Path(plane_dir) / "gen-0000000004.arena").exists()
    assert watcher.check_now() and watcher.generation == 4
    assert_models_identical(installed[-1], m2)


def test_torn_mid_chain_file_quarantines_the_failing_file(plane_dir):
    """A cold reader of a chain whose middle file is torn quarantines that
    file, not the newest; the live publisher then writes a keyframe."""
    n_items = 600
    state = port_fold_state(n_items=n_items)
    pub = ModelPlane(plane_dir, device=CPU)
    m = state.model
    m.ensure_host_serving_state()
    pub.publish([m], {"mode": "fold"})
    for r in range(2):
        pub.publish([port_fold_delta(state, freshness_delta(r, n_items))], {"mode": "fold"})
    mid = Path(plane_dir) / "gen-0000000002.delta"
    mid.write_bytes(mid.read_bytes()[:64])
    watcher = PlaneWatcher(ModelPlane(plane_dir, device=CPU), lambda models, info: True,
                           poll_s=0.05)
    assert not watcher.check_now()
    assert (Path(plane_dir) / "gen-0000000002.delta.quarantine").exists()
    assert not (Path(plane_dir) / "gen-0000000003.delta.quarantine").exists()
    m2 = port_fold_delta(state, freshness_delta(2, n_items))
    assert pub.publish([m2], {"mode": "fold"}) == 4
    assert (Path(plane_dir) / "gen-0000000004.arena").exists()
    assert watcher.check_now() and watcher.generation == 4


def test_keyframe_interval_and_restart_replay(plane_dir, monkeypatch):
    """PIO_MODEL_PLANE_FULL_EVERY puts a keyframe every N generations; a
    fresh reader at the tip needs only the newest keyframe and its deltas."""
    monkeypatch.setenv("PIO_MODEL_PLANE_FULL_EVERY", "3")
    monkeypatch.setenv("PIO_MODEL_PLANE_KEEP", "10")
    n_items = 600
    state = port_fold_state(n_items=n_items)
    pub = ModelPlane(plane_dir, device=CPU)
    m = state.model
    m.ensure_host_serving_state()
    pub.publish([m], {"mode": "fold"})
    for r in range(5):
        m = port_fold_delta(state, freshness_delta(r, n_items))
        pub.publish([m], {"mode": "fold"})
    names = {p.name for p in Path(plane_dir).glob("gen-*")}
    assert {"gen-0000000001.arena", "gen-0000000004.arena", "gen-0000000005.delta",
            "gen-0000000006.delta"} <= names
    for p in Path(plane_dir).glob("gen-000000000[123].*"):
        p.unlink()
    fresh = ModelPlane(plane_dir, device=CPU)
    mapped, info = fresh.load(fresh.current())
    assert info["planeGeneration"] == 6
    assert_models_identical(mapped, m)


def test_gc_refcount_keeps_chain_incl_quarantine_heal(plane_dir, monkeypatch):
    """GC keeps every file a kept generation composes from (the keyframe
    past the KEEP count); after a quarantine and its healing keyframe the
    superseded files, the quarantined one too, are reclaimed."""
    monkeypatch.setenv("PIO_MODEL_PLANE_KEEP", "2")
    monkeypatch.setenv("PIO_MODEL_PLANE_FULL_EVERY", "100")
    n_items = 600
    state = port_fold_state(n_items=n_items)
    pub = ModelPlane(plane_dir, device=CPU)
    m = state.model
    m.ensure_host_serving_state()
    pub.publish([m], {"mode": "fold"})
    for r in range(4):
        m = port_fold_delta(state, freshness_delta(r, n_items))
        pub.publish([m], {"mode": "fold"})
    assert {p.name for p in Path(plane_dir).glob("gen-*")} == {
        "gen-0000000001.arena", "gen-0000000002.delta", "gen-0000000003.delta",
        "gen-0000000004.delta", "gen-0000000005.delta"}
    fresh = ModelPlane(plane_dir, device=CPU)
    assert_models_identical(fresh.load(fresh.current())[0], m)
    q = Path(plane_dir) / "gen-0000000003.delta"
    q.replace(str(q) + ".quarantine")
    m = port_fold_delta(state, freshness_delta(4, n_items))
    pub.publish([m], {"mode": "fold"})
    assert (Path(plane_dir) / "gen-0000000006.arena").exists()
    gc0 = plane._M_GC.value()
    for r in range(5, 7):
        m = port_fold_delta(state, freshness_delta(r, n_items))
        gen = pub.publish([m], {"mode": "fold"})
    assert gen == 8
    assert {p.name for p in Path(plane_dir).glob("gen-*")} == {
        "gen-0000000006.arena", "gen-0000000007.delta", "gen-0000000008.delta"}
    assert plane._M_GC.value() > gc0
    fresh2 = ModelPlane(plane_dir, device=CPU)
    assert_models_identical(fresh2.load(fresh2.current())[0], m)


# -- across the packages ---------------------------------------------------------------

def test_jax_publisher_composes_in_the_port(plane_dir, port_mem, host_serving):
    """A JAX plane's keyframe and fold deltas compose in the port, every
    generation bit-equal to the JAX fold's model; the composed model
    answers as the same JAX model carried across by ``ur_model_from_state``."""
    from predictionio_tpu.events.event import Event as JaxEvent
    from predictionio_tpu_torch.models.universal_recommender import URQuery
    from predictionio_tpu_torch.storage import App

    port_mem.apps.insert(App(0, "delta"))   # the history read of a user query
    n_items = 600
    state = jax_fold_state(n_items=n_items)
    pub = jax_plane.ModelPlane(plane_dir)
    reader = ModelPlane(plane_dir, device=CPU)
    cold = None
    m = state.model
    m.ensure_host_serving_state()
    pub.publish([m], {"mode": "fold"})
    for r in range(4):
        got, info = reader.load(reader.current())
        assert info["planeGeneration"] == r + 1
        assert_models_identical(got, m)
        if cold is not None:
            assert_models_identical(cold.load(cold.current())[0], m)
        m = jax_fold_delta(state, freshness_delta(r, n_items, JaxEvent))
        pub.publish([m], {"mode": "fold"})
        assert pub.current()["kind"] == "delta"
        cold = cold or ModelPlane(plane_dir, device=CPU)
    got, _ = reader.load(reader.current())
    assert_models_identical(got, m)
    carried = ur_model_from_state(m.__getstate__(), device=CPU)
    algo = ur("delta")[2]
    bodies = [{"item": f"i{j}", "num": 6} for j in (0, 97, 194, 500)] + [
        {"item": "fresh_item_3", "num": 6}, {"user": "nobody", "num": 5}]
    for body in bodies:
        q = URQuery.from_json(body)
        assert canon(algo.predict(got, q)) == canon(algo.predict(carried, q)), body


def test_port_publisher_composes_in_jax(plane_dir):
    """The reverse: the port's CPU fold published through the port's plane
    composes in the JAX package bit-equal to the port's model, keyframe
    and deltas, on an incremental and a cold JAX reader."""
    n_items = 600
    state = port_fold_state(n_items=n_items)
    pub = ModelPlane(plane_dir, device=CPU)
    reader = jax_plane.ModelPlane(plane_dir)
    m = state.model
    m.ensure_host_serving_state()
    pub.publish([m], {"mode": "fold"})
    for r in range(4):
        assert_models_identical(reader.load(reader.current())[0], m)
        m = port_fold_delta(state, freshness_delta(r, n_items))
        pub.publish([m], {"mode": "fold"})
        assert pub.current()["kind"] == "delta"
    assert_models_identical(reader.load(reader.current())[0], m)
    cold = jax_plane.ModelPlane(plane_dir)
    assert_models_identical(cold.load(cold.current())[0], m)


def test_port_fold_matches_jax_fold_through_the_planes(fs_storage, tmp_path, monkeypatch):
    """The JAX package writes the log; each package folds its own tail and
    publishes through its own plane; the composed generations agree: item
    spaces equal, ids equal up to ties, scores within 1e-4."""
    from predictionio_tpu.models.universal_recommender import engine as jax_ur
    from predictionio_tpu.storage import App as JaxApp
    from predictionio_tpu.streaming import fold as jax_fold
    from predictionio_tpu_torch.storage import set_storage
    from predictionio_tpu_torch.streaming import fold

    from _torch_stream_cases import tail, ur_params

    port_fs = port_localfs_storage(tmp_path / "store")
    set_storage(port_fs)
    try:
        jax_app = fs_storage.apps.insert(JaxApp(0, "parity"))
        _, ap, ep = ur_params("parity")
        jds = jax_ur.URDataSourceParams(app_name="parity", event_names=["purchase", "view"])
        specs = seeded_corpus(43, n_users=30, n_items=24, n_inter=500)
        fs_storage.l_events.insert_batch(jax_events(specs), jax_app)
        pt = tail(port_fs, jax_app, {}, None, None)
        jt = fs_storage.l_events.scan_tail_from(jax_app, None, {}, base=None, heads=None)
        port_state = fold.URFoldState.bootstrap(ap, ep.data_source_params, pt["batch"],
                                                device=CPU)
        jax_state = jax_fold.URFoldState.bootstrap(_jax_params(ap), jds, jt["batch"])
        port_pub = ModelPlane(str(tmp_path / "port-plane"), device=CPU)
        jax_pub = jax_plane.ModelPlane(str(tmp_path / "jax-plane"))
        port_reader = ModelPlane(str(tmp_path / "port-plane"), device=CPU)
        jax_reader = jax_plane.ModelPlane(str(tmp_path / "jax-plane"))
        deltas = [seeded_corpus(44, n_users=40, n_items=30, n_inter=60), specs[:40]]
        for k, d in enumerate([[]] + deltas):
            if d:
                evs = jax_events(d)
                for j, e in enumerate(evs):
                    e.event_id = f"pd{k}-{j}"
                fs_storage.l_events.insert_batch(evs, jax_app)
                pt = tail(port_fs, jax_app, pt["watermark"], port_state.batch, pt["heads"])
                jt = fs_storage.l_events.scan_tail_from(jax_app, None, jt["watermark"],
                                                        base=jax_state.batch,
                                                        heads=jt["heads"])
                port_state.fold(pt["batch"])
                jax_state.fold(jt["batch"])
            port_pub.publish([port_state.model], {"mode": "fold"})
            jax_pub.publish([jax_state.model], {"mode": "fold"})
            pm = port_reader.load(port_reader.current())[0]
            jm = jax_reader.load(jax_reader.current())[0]
            assert pm.item_dict.strings() == jm.item_dict.strings(), k
            for name in pm.indicator_idx:
                assert pm.event_item_dicts[name].strings() == jm.event_item_dicts[name].strings()
                _assert_tables_match(pm.indicator_idx[name], pm.indicator_llr[name],
                                     np.asarray(jm.indicator_idx[name]),
                                     np.asarray(jm.indicator_llr[name]),
                                     _full_llr(port_state, name))
            np.testing.assert_allclose(pm.popularity, jm.popularity, rtol=RTOL, atol=ATOL)
            assert dict(pm.item_properties) == dict(jm.item_properties)
            assert port_pub.current()["kind"] == jax_pub.current()["kind"], k
    finally:
        set_storage(None)


# -- the watcher and the query server ----------------------------------------------------

def test_watcher_inotify_wake_beats_the_poll_period(port_mem, host_serving, plane_dir):
    """With a 30 s poll period a publish still installs within seconds: the
    inotify wake on the manifest rename drives the swap."""
    os.makedirs(plane_dir, exist_ok=True)
    plane._DirNotify(plane_dir).close()   # raises where inotify is missing
    seed_app(port_mem)
    engine, ep, _ = ur()
    model = engine.train(ep, device=CPU)[0]
    pub, sub = ModelPlane(plane_dir, device=CPU), ModelPlane(plane_dir, device=CPU)
    installed = []
    watcher = PlaneWatcher(sub, lambda models, info: (
        installed.append(info["planeGeneration"]), True)[1], poll_s=30.0)
    watcher.start()
    try:
        time.sleep(0.3)
        t0 = time.time()
        pub.publish([model])
        deadline = time.time() + 5
        while time.time() < deadline and not installed:
            time.sleep(0.02)
        assert installed == [1] and time.time() - t0 < 5.0
    finally:
        watcher.stop()


def test_watcher_stat_poll_fallback_converges(port_mem, host_serving, plane_dir, monkeypatch):
    monkeypatch.setenv("PIO_MODEL_PLANE_NOTIFY", "off")
    seed_app(port_mem)
    engine, ep, _ = ur()
    model = engine.train(ep, device=CPU)[0]
    pub, sub = ModelPlane(plane_dir, device=CPU), ModelPlane(plane_dir, device=CPU)
    installed = []
    watcher = PlaneWatcher(sub, lambda models, info: (
        installed.append(info["planeGeneration"]), True)[1], poll_s=0.05)
    watcher.start()
    try:
        pub.publish([model])
        deadline = time.time() + 5
        while time.time() < deadline and not installed:
            time.sleep(0.02)
        assert installed == [1] and watcher._notify is None
    finally:
        watcher.stop()


def _state(store, engine, ep, plane_dir):
    from predictionio_tpu_torch.models.universal_recommender import URQuery
    from predictionio_tpu_torch.workflow.create_server import QueryServerState

    return QueryServerState(engine, ep, URQuery, "mp-engine", "1", "default", storage=store,
                            device=CPU, plane_dir=plane_dir)


def _wait(cond, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not cond():
        time.sleep(0.02)
    return cond()


def test_watcher_converges_two_states_and_single_reload(port_mem, host_serving, plane_dir):
    """Two query servers on one plane: the initial publish converges both,
    one plane_reload on either converges both, and both answer alike."""
    from predictionio_tpu_torch.workflow import core_workflow

    seed_app(port_mem)
    engine, ep, _ = ur()
    core_workflow.run_train(engine, ep, engine_id="mp-engine", storage=port_mem, device=CPU)
    a = _state(port_mem, engine, ep, plane_dir)
    b = _state(port_mem, engine, ep, plane_dir)
    try:
        a.plane_publish_initial()
        assert _wait(lambda: a.plane_generation >= 1 and b.plane_generation >= 1)
        assert a.plane_generation == b.plane_generation == 1
        body = {"user": "u2", "num": 5}
        assert a.predict(body).to_json() == b.predict(body).to_json()
        gen, iid = b.plane_reload()
        assert gen == 2 and iid and b.plane_generation == 2
        assert _wait(lambda: a.plane_generation >= 2)
        assert a.predict(body).to_json() == b.predict(body).to_json()
        assert a.info()["planeGeneration"] == 2
        fr = b.freshness()
        assert fr["planeGeneration"] == 2 and fr["planePublish"]["file"] > 0
    finally:
        a.stop_auto_reload()
        b.stop_auto_reload()


def test_embedded_follower_publishes_through_plane(port_mem, host_serving, plane_dir):
    """The embedded follower publishes each fold into the plane; a sibling
    state converges; after the drain both answer as a fresh train."""
    from predictionio_tpu_torch.streaming.follow import FollowTrainer
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache

    app_id = seed_app(port_mem)
    engine, ep, algo = ur()
    core_workflow.run_train(engine, ep, engine_id="mp-engine", storage=port_mem, device=CPU)
    a = _state(port_mem, engine, ep, plane_dir)
    b = _state(port_mem, engine, ep, plane_dir)
    follower = None
    try:
        a.plane_publish_initial()
        follower = a.follower = FollowTrainer(engine, ep, "mp-engine", storage=port_mem,
                                              interval=0.05, on_publish=a.plane_publish,
                                              persist=False, device=CPU)
        follower.start()
        assert _wait(lambda: b.plane_generation >= 1 and follower.generation >= 1
                     and follower.last_outcome == "idle", 20)
        gref = b.plane_generation
        port_mem.l_events.insert_batch([buy("newbie", f"i{j}") for j in (0, 1, 2)], app_id)
        assert _wait(lambda: a.plane_generation > gref
                     and b.plane_generation == a.plane_generation
                     and follower.last_outcome == "idle", 20)
        invalidate_staging_cache()
        ref = engine.train(ep, device=CPU)[0]
        from predictionio_tpu_torch.models.universal_recommender import URQuery

        bodies = [{"user": "u2", "num": 5}, {"user": "newbie", "num": 5},
                  {"user": "u3", "num": 5,
                   "fields": [{"name": "category", "values": ["c1"], "bias": -1}]}]
        for st in (a, b):
            for body in bodies:
                want = algo.predict(ref, URQuery.from_json(body)).to_json()
                assert st.predict(body).to_json() == want, body
    finally:
        if follower is not None:
            follower.stop()
        a.stop_auto_reload()
        b.stop_auto_reload()


def test_prefork_plane_one_fold_one_reload(tmp_path):
    """``pio deploy --workers 2 --follow`` on the CPU: the workers converge
    on plane generations, one publisher process folds a delta once for the
    group (its fold counter in the merged /metrics), and one /reload
    converges every worker."""
    import re

    from predictionio_tpu_torch.storage import set_storage
    from predictionio_tpu_torch.workflow import core_workflow

    store_path = tmp_path / "store"
    storage = port_localfs_storage(store_path)
    set_storage(storage)
    try:
        app_id = seed_app(storage, app_name="mpe2e")
        engine, ep, _ = ur(app_name="mpe2e")
        variant = {"id": "mpe2e-engine", "engineFactory": "universal_recommender",
                   "datasource": {"params": {"appName": "mpe2e", "eventNames": ["purchase"]}},
                   "algorithms": [{"name": "ur", "params": {
                       "appName": "mpe2e", "eventNames": [], "maxCorrelatorsPerItem": 5}}]}
        ur_json = tmp_path / "engine.json"
        ur_json.write_text(json.dumps(variant))
        core_workflow.run_train(engine, ep, engine_id="mpe2e-engine", storage=storage,
                                device=CPU)
    finally:
        set_storage(None)
    env = {**os.environ, "PYTHONPATH": str(REPO), "PIO_TORCH_DEVICE": "cpu",
           "PIO_STORAGE_SOURCES_FS_TYPE": "localfs",
           "PIO_STORAGE_SOURCES_FS_PATH": str(store_path),
           **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "FS"
              for r in ("METADATA", "EVENTDATA", "MODELDATA")},
           "PIO_METRICS_FLUSH_S": "0.25", "PIO_MODEL_PLANE_POLL_S": "0.1"}
    env.pop("PIO_MODEL_PLANE_DIR", None)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
         "--engine-json", str(ur_json), "--ip", "127.0.0.1", "--port", str(port),
         "--workers", "2", "--follow", "0.3"], env=env, cwd=str(tmp_path))
    base = f"http://127.0.0.1:{port}"
    try:
        # generation 1: the parent's seed publish; 2: the publisher's bootstrap
        _wait_group(base, 2, 2, 120, proc)
        with urllib.request.urlopen(base + "/reload", timeout=30) as r:
            rel = json.loads(r.read())
        assert rel["reloaded"] is True and rel["generation"] >= 2
        _wait_group(base, 2, rel["generation"], 30, proc)
        port_localfs_storage(store_path).l_events.insert_batch(
            [buy("newbie", f"i{j}") for j in (0, 1, 2)], app_id)
        _wait_group(base, 2, rel["generation"] + 1, 60, proc)
        deadline = time.time() + 15
        folds, text = 0.0, ""
        while time.time() < deadline and folds < 1.0:
            with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
                text = r.read().decode()
            folds = sum(float(m.group(1)) for m in re.finditer(
                r'pio_follow_folds_total\{outcome="fold"\} ([0-9.e+]+)', text))
            if folds < 1.0:
                time.sleep(0.3)
        assert folds == 1.0, f"expected exactly one fold, saw {folds}"
        gens = dict(re.findall(r'pio_model_plane_generation\{worker="([^"]+)"\} ([0-9.e+]+)',
                               text))
        assert len(gens) == 3, gens    # two workers and the publisher
        req = urllib.request.Request(base + "/queries.json",
                                     json.dumps({"user": "newbie", "num": 5}).encode(),
                                     {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=10) as r:
            assert json.loads(r.read())["itemScores"]
    finally:
        for _ in range(16):
            try:
                with urllib.request.urlopen(base + "/stop", timeout=5) as r:
                    r.read()
                time.sleep(0.3)
            except Exception:
                break
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)

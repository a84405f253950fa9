"""The port over two ranks: two OS processes join one ``torch.distributed``
process group on the CPU (gloo) from the PIO_* variables, as JAX's
tests/test_distributed.py runs two processes.

One pair of workers (tests/_torch_dist_worker.py) runs every case once,
each with its own timeout and reaped in ``finally``; the tests below read
what each rank wrote:

- ``PEventStore.batch(local_shard=True)`` on a sharedfs store: the shards
  are disjoint, non-empty and union to the log (JAX :158);
- CCO over the mesh, the dense runner and the chunked strategy (several
  tiles, user blocks padded to the mesh; its counts two a word and one a
  word): tables bit-equal to the port's one-rank train, ids equal to a JAX
  mesh train's up to ties, scores within 1e-4, one all-reduce an event
  type (dense) or a tile (chunked);
- ALS at dp 2 and 4 over the two ranks (and dp 2 checkpointed): bit-equal
  to the port's one-rank train on the same layout from the same initial
  factors, and within JAX's own bar (rtol/atol 2e-3, JAX :373-374) of a
  JAX mesh train;
- logistic regression over the mesh: W and b equal in both ranks, within
  1e-4 of a JAX mesh train and of the port's one rank;
- ``process_local_rows`` on the two-rank mesh;
- ``pio train`` of a small UR with PIO_NUM_PROCESSES=2: each rank stores a
  model, each equal to a one-process ``pio train``'s.

And a coordinator that never answers makes ``init_distributed`` raise
within its timeout, in both roles.
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from predictionio_tpu.ops import als as jax_als
from predictionio_tpu.ops import cco as jax_cco
from predictionio_tpu.ops import logreg as jax_lr
from predictionio_tpu_torch.ops import als as port_als
from predictionio_tpu_torch.ops import logreg as port_lr

from _torch_cco_cases import assert_indicators_match, corpus, exact_llr, port_result

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_dist_worker.py"
WORKER_TIMEOUT_S = 120
APP, ENGINE_ID = "distapp", "disttest"

import _torch_dist_worker as worker  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(cmds, envs, timeout=WORKER_TIMEOUT_S):
    """Start the workers and ALWAYS reap them: a rank blocked in a
    collective must not outlive the test.  Output goes to files, so no
    rank blocks on a full pipe while the other waits for it."""
    import tempfile

    with tempfile.TemporaryDirectory() as logs:
        procs = []
        for k, (c, e) in enumerate(zip(cmds, envs)):
            with open(f"{logs}/{k}.out", "w") as out, open(f"{logs}/{k}.err", "w") as err:
                procs.append(subprocess.Popen(c, env=e, stdout=out, stderr=err))
        outs = []
        try:
            deadline = time.monotonic() + timeout
            for k, p in enumerate(procs):
                p.wait(timeout=max(deadline - time.monotonic(), 1))
                outs.append((p.returncode, *(open(f"{logs}/{k}.{ext}").read()
                                             for ext in ("out", "err"))))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return outs


def _store_env(store: Path) -> dict:
    env = {"PIO_STORAGE_SOURCES_S_TYPE": "sharedfs", "PIO_STORAGE_SOURCES_S_PATH": str(store)}
    for r in ("METADATA", "EVENTDATA", "MODELDATA"):
        env[f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE"] = "S"
    return env


def _storage(store: Path):
    from predictionio_tpu_torch.storage import Storage, StorageConfig

    return Storage(StorageConfig(sources={"S": {"type": "sharedfs", "path": str(store)}},
                                 repositories={r: "S" for r in
                                               ("METADATA", "EVENTDATA", "MODELDATA")}))


def _fill_store(store: Path, monkeypatch) -> int:
    """A small UR app in several segments: buy and view events, a $set
    category on every item; every event at its own time."""
    import predictionio_tpu_torch.storage.localfs as lfs
    from predictionio_tpu_torch.events.event import Event
    from predictionio_tpu_torch.storage import App

    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 4096)
    storage = _storage(store)
    app_id = storage.apps.insert(App(0, APP))
    rng = np.random.default_rng(3)
    t0, events = 1.7e9, []
    for k in range(360):
        name = "buy" if k % 3 == 0 else "view"
        u, i = int(rng.integers(0, 60)), int(rng.integers(0, 25))
        events.append(Event(name, "user", f"u{u}", "item", f"i{i}", event_time=t0 + k,
                            creation_time=t0 + k))
    events += [Event("$set", "item", f"i{j}", properties={"category": f"c{j % 4}"},
                     event_time=t0 + 1000 + j, creation_time=t0 + 1000 + j)
               for j in range(25)]
    for s in range(0, len(events), 40):
        storage.l_events.insert_batch(events[s:s + 40], app_id)
    return len(events)


def _variant(engine_id=ENGINE_ID) -> dict:
    return {"id": engine_id, "engineFactory": "universal_recommender",
            "datasource": {"params": {"appName": APP, "eventNames": ["buy", "view"]}},
            "algorithms": [{"name": "ur", "params": {
                "appName": APP, "maxCorrelatorsPerItem": 5, "itemTile": 8,
                "userBlock": 16}}]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, with the run's paths."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    store = tmp / "store"
    mp = pytest.MonkeyPatch()
    try:
        n_events = _fill_store(store, mp)
    finally:
        mp.undo()
    (tmp / "engine.json").write_text(json.dumps(_variant()))
    u, i, r = worker.als_corpus()
    inits = {}
    for dp in (2, 4):
        jd = jax_als.prepare_als_data(u, i, r, worker.ALS["n_users"], worker.ALS["n_items"], dp)
        x0, y0 = jax_als._als_init(jd, 6, 7)
        inits[str(dp)] = str(tmp / f"init{dp}.npz")
        np.savez(inits[str(dp)], x0=np.asarray(x0), y0=np.asarray(y0))
    spec = tmp / "spec.json"
    spec.write_text(json.dumps({"app": APP, "engine_json": str(tmp / "engine.json"),
                                "als_init": inits, "checkpoint_dir": str(tmp / "ckpt")}))
    base = {"PYTHONPATH": str(REPO), "PATH": os.environ.get("PATH", ""),
            "HOME": str(tmp), "TMPDIR": str(tmp), "PIO_TORCH_DEVICE": "cpu",
            "PIO_NUM_PROCESSES": "2", "PIO_DIST_TIMEOUT_S": "60",
            "OMP_NUM_THREADS": "2", **_store_env(store)}
    for attempt in range(2):   # once more if another test took the port
        base["PIO_COORDINATOR_ADDRESS"] = f"127.0.0.1:{_free_port()}"
        outs = _run_workers(
            [[sys.executable, str(WORKER), str(tmp / f"rank{k}.npz"), str(spec)]
             for k in range(2)],
            [dict(base, PIO_PROCESS_ID=str(k)) for k in range(2)])
        if not any("EADDRINUSE" in err or "address already in use" in err.lower()
                   for _, _, err in outs):
            break
    for k, (rc, out, err) in enumerate(outs):
        assert rc == 0 and "WORKER OK" in out, f"rank {k}: rc {rc}\n{out[-2000:]}\n{err[-4000:]}"
    got = [dict(np.load(tmp / f"rank{k}.npz")) for k in range(2)]
    return {"ranks": got, "store": store, "n_events": n_events}


def _jax_mesh(dp):
    return Mesh(np.array(jax.devices()[:dp]).reshape(-1, 1), ("dp", "mp"))


def test_ranks_join_one_gloo_group(ranks):
    """Both ranks in one gloo group, a dp = 2 mesh, no JAX module loaded."""
    for k, got in enumerate(ranks["ranks"]):
        assert (int(got["rank"]), int(got["world"]), int(got["dp"])) == (k, 2, 2)
        assert str(got["backend"]) == "gloo"
        assert not bool(got["jax_loaded"])


def test_local_shards_are_disjoint_and_union_to_the_log(ranks):
    from predictionio_tpu_torch.store.event_store import PEventStore

    shards = [got["shard_times"] for got in ranks["ranks"]]
    assert all(len(s) > 0 for s in shards)
    union = np.concatenate(shards)
    assert len(np.unique(union)) == len(union) == ranks["n_events"]
    full = PEventStore.batch(APP, storage=_storage(ranks["store"]))
    np.testing.assert_array_equal(np.sort(union), np.sort(np.asarray(full.times_us)))


@pytest.mark.parametrize("strategy", ["dense", "chunked", "chunked_wide"])
def test_cco_over_two_ranks(ranks, strategy, monkeypatch):
    """``chunked_wide`` sends the counts one a word, as past 2**15 users:
    twice the bytes of ``chunked``'s two a word, the same tables."""
    c = corpus("resident")
    one_rank = port_result("resident", "dense")
    monkeypatch.setenv("PIO_CCO_DENSE", "1" if strategy == "dense" else "0")
    monkeypatch.setenv("PIO_CCO_SPARSE", "0")
    want = jax_cco.cco_train_indicators(
        c["pu"], c["pi"], [("buy", c["pu"], c["pi"], c["n_ip"]),
                           ("view", c["vu"], c["vi"], c["n_it"])],
        c["n_users"], c["n_ip"], top_k=5, exclude_self_for="buy", item_tile=8,
        user_block=16, mesh=_jax_mesh(2))
    tiles = -(-c["n_ip"] // 8) + -(-c["n_it"] // 8)
    for got in ranks["ranks"]:
        if strategy == "chunked_wide":
            assert int(got["cco_chunked_wide_bytes"]) > 1.9 * int(got["cco_chunked_bytes"])
        assert int(got[f"cco_{strategy}_all_reduce"]) == (2 if strategy == "dense" else tiles)
        for name in ("buy", "view"):
            s, i = got[f"cco_{strategy}_{name}_s"], got[f"cco_{strategy}_{name}_i"]
            np.testing.assert_array_equal(s.view(np.int32), one_rank[name][0].view(np.int32))
            np.testing.assert_array_equal(i, one_rank[name][1])
            assert_indicators_match((s, i), want[name], exact_llr(c, name))


@pytest.mark.parametrize("case,dp,implicit", [("dp2", 2, False), ("dp4", 4, True),
                                              ("dp2_ckpt", 2, False)])
def test_als_over_two_ranks(ranks, case, dp, implicit, monkeypatch):
    u, i, r = worker.als_corpus()
    n_u, n_i = worker.ALS["n_users"], worker.ALS["n_items"]
    jd = jax_als.prepare_als_data(u, i, r, n_u, n_i, dp)
    x0, y0 = jax_als._als_init(jd, 6, 7)
    jx, jy = jax_als.als_train(jd, k=6, reg=0.1, iterations=2, mesh=_jax_mesh(dp),
                               implicit=implicit, alpha=2.0)
    monkeypatch.setattr(port_als, "_als_init", lambda data, k, seed: (
        torch.as_tensor(np.array(x0)), torch.as_tensor(np.array(y0))))
    ox, oy = port_als.als_train(port_als.prepare_als_data(u, i, r, n_u, n_i, dp), k=6,
                                reg=0.1, iterations=2, implicit=implicit, alpha=2.0,
                                device="cpu")
    sweeps = 2
    for got in ranks["ranks"]:
        X, Y = got[f"als_{case}_X"], got[f"als_{case}_Y"]
        np.testing.assert_array_equal(X, ox)
        np.testing.assert_array_equal(Y, oy)
        np.testing.assert_allclose(X, np.asarray(jx), rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(Y, np.asarray(jy), rtol=2e-3, atol=2e-3)
        # two gathers a sweep, then X and Y for the result (and the snapshots)
        gathers = 2 * sweeps + 2 + (2 * sweeps if case.endswith("ckpt") else 0)
        assert int(got[f"als_{case}_all_gather"]) == gathers


@pytest.mark.parametrize("opt", ["lbfgs", "adam"])
def test_logreg_over_two_ranks(ranks, opt):
    x, y = worker.logreg_corpus()
    jw, jb = jax_lr.logreg_train(x, y, 3, l2=1e-3, iterations=20, optimizer=opt,
                                 mesh=_jax_mesh(2))
    ow, ob = port_lr.logreg_train(x, y, 3, l2=1e-3, iterations=20, optimizer=opt,
                                  device="cpu")
    r0, r1 = ranks["ranks"]
    np.testing.assert_array_equal(r0[f"logreg_{opt}_w"], r1[f"logreg_{opt}_w"])
    np.testing.assert_array_equal(r0[f"logreg_{opt}_b"], r1[f"logreg_{opt}_b"])
    for want_w, want_b in ((np.asarray(jw), np.asarray(jb)), (ow, ob)):
        np.testing.assert_allclose(r0[f"logreg_{opt}_w"], want_w, rtol=0, atol=1e-4)
        np.testing.assert_allclose(r0[f"logreg_{opt}_b"], want_b, rtol=0, atol=1e-4)


def test_process_local_rows_on_two_ranks(ranks):
    assert [tuple(got["local_rows"]) for got in ranks["ranks"]] == [(0, 400), (400, 800)]


def test_pio_train_over_two_ranks_equals_one_process(ranks):
    """Each rank stores its model (the JAX package's run_train has no rank
    test); each equals a one-process train of the same store."""
    from predictionio_tpu_torch.workflow.core_workflow import run_train
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant
    from predictionio_tpu_torch.workflow.persistence import load_models

    storage = _storage(ranks["store"])
    for got in ranks["ranks"]:
        assert int(got["pio_train_rc"]) == 0
        assert int(got["pio_train_all_reduce"]) == 2      # dense: one an event type
    from predictionio_tpu_torch.storage import set_storage

    _, engine, ep = engine_from_variant(_variant(ENGINE_ID + "-one"))
    set_storage(storage)   # the data source reads the process default, as pio train's
    try:
        one = run_train(engine, ep, ENGINE_ID + "-one", storage=storage, device="cpu")
    finally:
        set_storage(None)
    (want,) = load_models(storage, one.id, device="cpu")
    stored = [inst for inst in storage.engine_instances.get_all()
              if inst.engine_id == ENGINE_ID]
    assert len(stored) == 2 and all(inst.status == "COMPLETED" for inst in stored)
    for inst in stored:
        (model,) = load_models(storage, inst.id, device="cpu")
        assert model.item_dict.strings() == want.item_dict.strings()
        assert sorted(model.indicator_idx) == sorted(want.indicator_idx) == ["buy", "view"]
        for name in want.indicator_idx:
            np.testing.assert_array_equal(model.indicator_idx[name], want.indicator_idx[name])
            np.testing.assert_array_equal(model.indicator_llr[name], want.indicator_llr[name])


def test_a_coordinator_that_never_answers_raises_within_the_timeout(tmp_path):
    """Rank 1 of 2 dialling a port nobody listens on, and rank 0 of 2 whose
    peer never comes: both raise within their 2 s timeout (plus start-up)."""
    code = ("from predictionio_tpu_torch.parallel.distributed import init_distributed\n"
            "init_distributed(device='cpu')\n")
    port = _free_port()
    base = {"PYTHONPATH": str(REPO), "PATH": os.environ.get("PATH", ""),
            "HOME": str(tmp_path), "PIO_NUM_PROCESSES": "2", "PIO_DIST_TIMEOUT_S": "2"}
    t0 = time.monotonic()
    outs = _run_workers(
        [[sys.executable, "-c", code]] * 2,
        [dict(base, PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{port}", PIO_PROCESS_ID="0"),
         dict(base, PIO_COORDINATOR_ADDRESS=f"127.0.0.1:{_free_port()}",
              PIO_PROCESS_ID="1")], timeout=60)
    assert time.monotonic() - t0 < 45
    for rc, _, err in outs:
        assert rc != 0 and "timed out" in err.lower(), err[-2000:]

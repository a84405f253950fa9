"""The port's plane replication (``streaming/replicate.py``, PRP1 over
loopback TCP), against itself and the JAX package.

Exactness, bit for bit: a JAX ``PlaneReplicator`` feeds a port
``PlaneSubscriber`` and a port replicator a JAX subscriber, and the landed
files are byte-identical to the publisher's; every subscriber's composed
generation answers as the publisher's model.  The rest mirrors
tests/test_plane_replication.py: a cold subscriber's keyframe catch-up,
live publishes streaming incrementally, a torn transfer quarantined and
re-requested, a killed subscriber resuming from its last flipped
generation, a subscriber past the publisher's GC re-syncing from a
keyframe, the split-brain refusals, the header-only chain walk; then the
CLI: ``pio plane-subscribe``, ``pio deploy --plane-publish`` feeding a
subscriber, and ``deploy --plane-publish`` feeding ``pio deploy
--plane-from``.  Every socket and wait has a timeout.
"""

import json
import os
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import pytest

from predictionio_tpu.streaming import plane as jax_plane
from predictionio_tpu.streaming import replicate as jax_replicate
from predictionio_tpu_torch.streaming import replicate
from predictionio_tpu_torch.streaming.plane import REPLICA_KEY, ModelPlane, _PlaneCorrupt
from predictionio_tpu_torch.streaming.replicate import PlaneReplicator, PlaneSubscriber

from _torch_event_cases import port_localfs_storage
from _torch_plane_cases import (  # noqa: F401  (fixtures)
    CPU,
    assert_models_identical,
    buy,
    canon,
    corpus,
    freshness_delta,
    host_serving,
    port_fold_delta,
    port_fold_state,
    port_mem,
    seed_app,
    ur,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture()
def fast_repl(monkeypatch):
    monkeypatch.setenv("PIO_MODEL_PLANE_POLL_S", "0.05")
    monkeypatch.setenv("PIO_PLANE_REPL_PING_S", "0.3")
    monkeypatch.setenv("PIO_PLANE_REPL_BACKOFF_S", "0.1")
    monkeypatch.setenv("PIO_PLANE_REPL_TIMEOUT_S", "10")


def _publisher(tmp_path, store, n_gens=1):
    """A trained port model published ``n_gens`` times into a fresh plane."""
    seed_app(store)
    engine, ep, algo = ur()
    model = engine.train(ep, device=CPU)[0]
    pub = ModelPlane(str(tmp_path / "pub-plane"), device=CPU)
    for _ in range(n_gens):
        pub.publish([model], {"mode": "test"})
    return pub, model, algo


def _start_pair(pub, sub_dir, node="t-sub"):
    repl = PlaneReplicator(pub, bind="127.0.0.1:0")
    repl.start()
    sub = PlaneSubscriber(str(sub_dir), f"127.0.0.1:{repl.port}", node=node)
    sub.start()
    return repl, sub


def _assert_parity(sub_dir, model, algo):
    reader = ModelPlane(str(sub_dir), device=CPU)
    mapped, _ = reader.load(reader.current())
    assert_models_identical(mapped, model)
    for q in corpus():
        assert canon(algo.predict(mapped, q)) == canon(algo.predict(model, q))


def _same_files(pub_dir, sub_dir):
    """Every generation file the subscriber holds is the publisher's, byte
    for byte."""
    landed = sorted(p.name for p in Path(sub_dir).glob("gen-*")
                    if not p.name.endswith(".quarantine"))
    assert landed
    for name in landed:
        src = Path(pub_dir) / name
        if src.exists():
            assert (Path(sub_dir) / name).read_bytes() == src.read_bytes(), name
    return landed


def test_cold_subscriber_keyframe_catchup_bit_exact(port_mem, host_serving, fast_repl,
                                                    tmp_path):
    pub, model, algo = _publisher(tmp_path, port_mem, n_gens=4)
    repl, sub = _start_pair(pub, tmp_path / "sub-plane")
    try:
        assert sub.wait_generation(4, timeout=20)
        _assert_parity(tmp_path / "sub-plane", model, algo)
        _same_files(pub.dir, tmp_path / "sub-plane")
        cur = ModelPlane(str(tmp_path / "sub-plane")).current()
        assert cur[REPLICA_KEY] == sub.source
        st = sub.status()
        assert st["role"] == "subscriber" and st["lagGenerations"] == 0
        deadline = time.time() + 10
        while time.time() < deadline:
            pst = repl.status()
            if pst["subscribers"] and pst["subscribers"][0]["ackedGeneration"] == 4:
                break
            time.sleep(0.05)
        assert pst["role"] == "publisher" and pst["subscribers"][0]["lagGenerations"] == 0
    finally:
        sub.stop()
        repl.stop()


def test_live_publishes_stream_to_subscriber(port_mem, host_serving, fast_repl, tmp_path):
    """Generations published while a subscriber is connected arrive as
    deltas, with no re-sync."""
    pub, model, algo = _publisher(tmp_path, port_mem, n_gens=1)
    repl, sub = _start_pair(pub, tmp_path / "sub-plane")
    resync = replicate._M_RESYNC
    try:
        assert sub.wait_generation(1, timeout=20)
        lag0, torn0 = resync.value(reason="lag"), resync.value(reason="torn")
        out0 = replicate._M_RBYTES.value(dir="out", kind="delta")
        in0 = replicate._M_RBYTES.value(dir="in", kind="delta")
        for _ in range(3):
            pub.publish([model], {"mode": "test"})
        assert sub.wait_generation(4, timeout=20)
        _assert_parity(tmp_path / "sub-plane", model, algo)
        assert resync.value(reason="lag") == lag0 and resync.value(reason="torn") == torn0
        sent = replicate._M_RBYTES.value(dir="out", kind="delta") - out0
        assert sent > 0 and replicate._M_RBYTES.value(dir="in", kind="delta") - in0 == sent
    finally:
        sub.stop()
        repl.stop()


def test_torn_transfer_quarantines_and_rerequests(port_mem, host_serving, fast_repl,
                                                  tmp_path, monkeypatch):
    """One file frame with a wrong sha256: the subscriber quarantines it,
    never flips over it, re-requests the chain and converges."""
    pub, model, algo = _publisher(tmp_path, port_mem, n_gens=2)
    real_send = replicate._send_frame
    tears = {"left": 1}

    def flaky_send(sock, header, payload_len=0):
        if header.get("type") == "file" and tears["left"]:
            tears["left"] -= 1
            header = dict(header, sha256="0" * 64)
        real_send(sock, header, payload_len)

    monkeypatch.setattr(replicate, "_send_frame", flaky_send)
    repl, sub = _start_pair(pub, tmp_path / "sub-plane")
    try:
        assert sub.wait_generation(2, timeout=30)
        assert tears["left"] == 0 and sub.resyncs >= 1
        assert list(Path(tmp_path / "sub-plane").glob("*.quarantine"))
        _assert_parity(tmp_path / "sub-plane", model, algo)
    finally:
        sub.stop()
        repl.stop()


def test_killed_subscriber_resumes_from_last_acked_generation(port_mem, host_serving,
                                                              fast_repl, tmp_path):
    """A stopped subscriber reconnects with its last flipped generation and
    receives only the missing ones: no cold or lag re-sync."""
    pub, model, algo = _publisher(tmp_path, port_mem, n_gens=2)
    repl, sub = _start_pair(pub, tmp_path / "sub-plane")
    resync = replicate._M_RESYNC
    sub2 = None
    try:
        assert sub.wait_generation(2, timeout=20)
        sub.stop()
        for _ in range(2):
            pub.publish([model], {"mode": "test"})
        cold0, lag0 = resync.value(reason="cold"), resync.value(reason="lag")
        sub2 = PlaneSubscriber(str(tmp_path / "sub-plane"), f"127.0.0.1:{repl.port}",
                               node="t-sub-2")
        sub2.start()
        assert sub2.generation == 2
        assert sub2.wait_generation(4, timeout=20)
        assert resync.value(reason="cold") == cold0 and resync.value(reason="lag") == lag0
        _assert_parity(tmp_path / "sub-plane", model, algo)
    finally:
        if sub2 is not None:
            sub2.stop()
        sub.stop()
        repl.stop()


def test_lagged_past_gc_resyncs_from_keyframe(port_mem, host_serving, fast_repl, tmp_path,
                                              monkeypatch):
    monkeypatch.setenv("PIO_MODEL_PLANE_KEEP", "2")
    monkeypatch.setenv("PIO_MODEL_PLANE_FULL_EVERY", "2")
    pub, model, algo = _publisher(tmp_path, port_mem, n_gens=2)
    repl, sub = _start_pair(pub, tmp_path / "sub-plane")
    resync = replicate._M_RESYNC
    sub2 = None
    try:
        assert sub.wait_generation(2, timeout=20)
        sub.stop()
        lag0 = resync.value(reason="lag")
        for _ in range(6):
            pub.publish([model], {"mode": "test"})
        sub2 = PlaneSubscriber(str(tmp_path / "sub-plane"), f"127.0.0.1:{repl.port}",
                               node="t-sub-2")
        sub2.start()
        assert sub2.wait_generation(8, timeout=20)
        assert resync.value(reason="lag") > lag0
        _assert_parity(tmp_path / "sub-plane", model, algo)
    finally:
        if sub2 is not None:
            sub2.stop()
        sub.stop()
        repl.stop()


def test_subscriber_refuses_locally_published_dir(port_mem, host_serving, tmp_path):
    pub, _model, _algo = _publisher(tmp_path, port_mem, n_gens=1)
    with pytest.raises(RuntimeError, match="locally-published"):
        PlaneSubscriber(str(pub.dir), "127.0.0.1:1").start()


def test_local_publisher_forces_keyframes_on_replica_dir(port_mem, host_serving, tmp_path):
    pub, model, _algo = _publisher(tmp_path, port_mem, n_gens=2)
    cur = pub.current()
    assert cur["kind"] == "delta"
    pub._write_manifest({**cur, REPLICA_KEY: "other-node:9999"})
    pub.publish([model], {"mode": "test"})
    assert pub.current()["kind"] == "full"


def test_chain_files_walks_prev_links(port_mem, host_serving, tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_MODEL_PLANE_KEEP", "10")
    pub, _model, _algo = _publisher(tmp_path, port_mem, n_gens=3)
    cur = pub.current()
    chain = pub.chain_files(cur["file"])
    assert chain[0].endswith(".arena") and chain[-1] == cur["file"] and chain == sorted(chain)
    os.unlink(os.path.join(pub.dir, chain[0]))
    with pytest.raises(_PlaneCorrupt):
        pub.chain_files(cur["file"])


# -- across the packages ---------------------------------------------------------------

@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_replication_across_packages_lands_identical_files(fast_repl, tmp_path, direction):
    """A JAX replicator feeds a port subscriber, and a port replicator a JAX
    subscriber: a cold catch-up and live fold deltas land byte-identical to
    the publisher's files, and the subscriber's plane composes (in the
    other package) into the publisher's model bit for bit."""
    from predictionio_tpu.events.event import Event as JaxEvent

    from test_model_plane import _fold_delta as jax_fold_delta
    from test_model_plane import _fold_state as jax_fold_state

    n_items = 600
    pub_dir, sub_dir = tmp_path / "pub", tmp_path / "sub"
    if direction == "jax-to-port":
        state = jax_fold_state(n_items=n_items)
        pub = jax_plane.ModelPlane(str(pub_dir))
        repl = jax_replicate.PlaneReplicator(pub, bind="127.0.0.1:0")

        def fold(r):
            return jax_fold_delta(state, freshness_delta(r, n_items, JaxEvent))

        def subscriber(port):
            return PlaneSubscriber(str(sub_dir), f"127.0.0.1:{port}", node="port-sub")

        reader = ModelPlane(str(sub_dir), device=CPU)
    else:
        state = port_fold_state(n_items=n_items)
        pub = ModelPlane(str(pub_dir), device=CPU)
        repl = PlaneReplicator(pub, bind="127.0.0.1:0")

        def fold(r):
            return port_fold_delta(state, freshness_delta(r, n_items))

        def subscriber(port):
            return jax_replicate.PlaneSubscriber(str(sub_dir), f"127.0.0.1:{port}",
                                                 node="jax-sub")

        reader = jax_plane.ModelPlane(str(sub_dir))
    m = state.model
    m.ensure_host_serving_state()
    pub.publish([m], {"mode": "fold"})
    m = fold(0)
    pub.publish([m], {"mode": "fold"})
    repl.start()
    sub = subscriber(repl.port)
    sub.start()
    try:
        assert sub.wait_generation(2, timeout=30)   # cold: keyframe + delta
        assert_models_identical(reader.load(reader.current())[0], m)
        for r in range(1, 3):
            m = fold(r)
            pub.publish([m], {"mode": "fold"})
            assert sub.wait_generation(r + 2, timeout=30)
            assert_models_identical(reader.load(reader.current())[0], m)
        landed = _same_files(pub_dir, sub_dir)
        assert any(n.endswith(".delta") for n in landed)
        cur = json.loads((sub_dir / "CURRENT.json").read_text())
        assert cur["generation"] == 4 and cur[REPLICA_KEY] == sub.source
    finally:
        sub.stop()
        repl.stop()


# -- the CLI ---------------------------------------------------------------------------

def _cli_env(**extra):
    env = {**os.environ, "PYTHONPATH": str(REPO), "PIO_TORCH_DEVICE": "cpu",
           "PIO_MODEL_PLANE_POLL_S": "0.05", "PIO_PLANE_REPL_PING_S": "0.3",
           "PIO_PLANE_REPL_BACKOFF_S": "0.1", **extra}
    env.pop("PIO_MODEL_PLANE_DIR", None)
    return env


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(2)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)


def test_pio_plane_subscribe_mirrors_and_refuses_a_foreign_dir(port_mem, host_serving,
                                                               fast_repl, tmp_path):
    """``pio plane-subscribe`` lands every generation of a port publisher
    (files byte-identical, SIGINT exits 0) and exits 1 on a directory a
    local publisher owns."""
    pub, model, algo = _publisher(tmp_path, port_mem, n_gens=2)
    repl = PlaneReplicator(pub, bind="127.0.0.1:0")
    repl.start()
    sub_dir = tmp_path / "cli-sub"
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "plane-subscribe",
         "--from", f"127.0.0.1:{repl.port}", "--plane-dir", str(sub_dir), "--node", "cli"],
        env=_cli_env(), cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and proc.poll() is None:
            cur = ModelPlane(str(sub_dir)).current()
            if cur is not None and cur["generation"] == 2:
                break
            time.sleep(0.05)
        pub.publish([model], {"mode": "test"})
        while time.time() < deadline and proc.poll() is None:
            cur = ModelPlane(str(sub_dir)).current()
            if cur is not None and cur["generation"] == 3:
                break
            time.sleep(0.05)
        assert cur is not None and cur["generation"] == 3, proc.poll()
        _same_files(pub.dir, sub_dir)
        _assert_parity(sub_dir, model, algo)
    finally:
        _stop(proc)
        repl.stop()
    out = proc.stdout.read()
    assert proc.returncode == 0 and "mirroring" in out, out
    refused = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "plane-subscribe",
         "--from", "127.0.0.1:1", "--plane-dir", str(pub.dir)],
        env=_cli_env(), cwd=str(tmp_path), capture_output=True, text=True, timeout=60)
    assert refused.returncode == 1 and "locally-published" in refused.stderr


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _post_raw(url, body, timeout=10):
    req = urllib.request.Request(url, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_deploy_plane_publish_feeds_a_plane_from_subprocess(tmp_path, monkeypatch):
    """``deploy(follow=, plane_publish=)`` in this process and ``pio deploy
    --plane-from`` as a subprocess on the CPU, each with its own plane
    directory: an appended delta folds on the publisher, both converge on
    its plane generation, and both answer byte-equal."""
    from predictionio_tpu_torch.storage import set_storage
    from predictionio_tpu_torch.workflow import core_workflow
    from predictionio_tpu_torch.workflow.create_server import deploy

    store_path = tmp_path / "store"
    storage = port_localfs_storage(store_path)
    set_storage(storage)
    server = proc = None
    try:
        app_id = seed_app(storage, app_name="repl")
        engine, ep, _ = ur(app_name="repl")
        variant = {"id": "repl-engine", "engineFactory": "universal_recommender",
                   "datasource": {"params": {"appName": "repl", "eventNames": ["purchase"]}},
                   "algorithms": [{"name": "ur", "params": {"appName": "repl",
                                                            "maxCorrelatorsPerItem": 5}}]}
        ur_json = tmp_path / "engine.json"
        ur_json.write_text(json.dumps(variant))
        core_workflow.run_train(engine, ep, engine_id="repl-engine", storage=storage,
                                device=CPU)
        monkeypatch.setenv("PIO_MODEL_PLANE_DIR", str(tmp_path / "pub-plane"))
        monkeypatch.setenv("PIO_MODEL_PLANE_POLL_S", "0.05")
        monkeypatch.setenv("PIO_PLANE_REPL_PING_S", "0.3")
        server = deploy(str(ur_json), host="127.0.0.1", port=0, storage=storage,
                        device=CPU, follow=0.2, plane_publish="127.0.0.1:0")
        state = server.pio_state
        assert state.plane is not None and state.replication is not None
        pub_url = f"http://127.0.0.1:{server.server_address[1]}"
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            sub_port = s.getsockname()[1]
        env = _cli_env(PIO_MODEL_PLANE_DIR=str(tmp_path / "sub-plane"),
                       PIO_STORAGE_SOURCES_FS_TYPE="localfs",
                       PIO_STORAGE_SOURCES_FS_PATH=str(store_path),
                       **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "FS"
                          for r in ("METADATA", "EVENTDATA", "MODELDATA")})
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
             "--engine-json", str(ur_json), "--ip", "127.0.0.1", "--port", str(sub_port),
             "--plane-from", f"127.0.0.1:{state.replication.port}"],
            env=env, cwd=str(tmp_path))
        sub_url = f"http://127.0.0.1:{sub_port}"

        def converged(min_gen):
            deadline = time.time() + 60
            while time.time() < deadline:
                assert proc.poll() is None, f"the subscriber exited {proc.returncode}"
                try:
                    sg = _get(sub_url + "/")["planeGeneration"] or 0
                except OSError:
                    sg = 0
                pg = state.plane_generation
                if pg >= min_gen and sg == pg and state.follower.last_outcome == "idle":
                    return pg
                time.sleep(0.05)
            raise AssertionError(f"no convergence on generation >= {min_gen}")

        g0 = converged(1)
        storage.l_events.insert_batch([buy("newbie", f"i{j}") for j in (0, 1, 2)], app_id)
        g1 = converged(g0 + 1)
        fr = _get(sub_url + "/stats.json")["freshness"]
        assert fr["replication"]["role"] == "subscriber" and fr["planeGeneration"] == g1
        assert _get(pub_url + "/stats.json")["freshness"]["replication"]["role"] == "publisher"
        for body in ({"user": "newbie", "num": 5}, {"user": "u2", "num": 5},
                     {"item": "i1", "num": 4}, {"user": "nobody", "num": 3}):
            assert _post_raw(sub_url + "/queries.json", body) == _post_raw(
                pub_url + "/queries.json", body), body
    finally:
        if proc is not None:
            _stop(proc)
        if server is not None:
            server.shutdown()
            server.server_close()
        set_storage(None)


def test_pio_deploy_plane_publish_serves_a_subscriber(tmp_path, monkeypatch):
    """``pio deploy --follow --plane-publish HOST:PORT`` as a subprocess on
    the CPU: a ``PlaneSubscriber`` here lands its generations, and the
    composed newest one answers as the publisher does over HTTP after an
    appended delta folds."""
    from predictionio_tpu_torch.models.universal_recommender import URQuery
    from predictionio_tpu_torch.storage import set_storage
    from predictionio_tpu_torch.workflow import core_workflow

    monkeypatch.setenv("PIO_UR_SERVE_SCORER", "host")
    monkeypatch.setenv("PIO_UR_SERVE_TAIL", "host")
    monkeypatch.setenv("PIO_PLANE_REPL_BACKOFF_S", "0.1")
    store_path = tmp_path / "store"
    storage = port_localfs_storage(store_path)
    set_storage(storage)
    proc = sub = None
    try:
        app_id = seed_app(storage, app_name="clipub")
        engine, ep, algo = ur(app_name="clipub")
        variant = {"id": "clipub-engine", "engineFactory": "universal_recommender",
                   "datasource": {"params": {"appName": "clipub",
                                             "eventNames": ["purchase"]}},
                   "algorithms": [{"name": "ur", "params": {"appName": "clipub",
                                                            "maxCorrelatorsPerItem": 5}}]}
        ur_json = tmp_path / "engine.json"
        ur_json.write_text(json.dumps(variant))
        core_workflow.run_train(engine, ep, engine_id="clipub-engine", storage=storage,
                                device=CPU)
        ports = []
        for _ in range(2):
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                ports.append(s.getsockname()[1])
        http_port, repl_port = ports
        env = _cli_env(PIO_MODEL_PLANE_DIR=str(tmp_path / "pub-plane"),
                       PIO_UR_SERVE_SCORER="host", PIO_UR_SERVE_TAIL="host",
                       PIO_STORAGE_SOURCES_FS_TYPE="localfs",
                       PIO_STORAGE_SOURCES_FS_PATH=str(store_path),
                       **{f"PIO_STORAGE_REPOSITORIES_{r}_SOURCE": "FS"
                          for r in ("METADATA", "EVENTDATA", "MODELDATA")})
        proc = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
             "--engine-json", str(ur_json), "--ip", "127.0.0.1", "--port", str(http_port),
             "--follow", "0.2", "--plane-publish", f"127.0.0.1:{repl_port}"],
            env=env, cwd=str(tmp_path))
        base = f"http://127.0.0.1:{http_port}"
        sub = PlaneSubscriber(str(tmp_path / "sub-plane"), f"127.0.0.1:{repl_port}",
                              node="t-cli")
        sub.start()

        def published():
            try:
                fr = _get(base + "/")["freshness"]
            except OSError:
                return 0
            return fr["planeGeneration"] if fr["follower"]["lastOutcome"] == "idle" else 0

        deadline = time.time() + 90
        while time.time() < deadline and published() < 2:
            assert proc.poll() is None, f"pio deploy exited {proc.returncode}"
            time.sleep(0.1)
        g0 = published()
        assert g0 >= 2                       # the seed and the follower's bootstrap
        storage.l_events.insert_batch([buy("newbie", f"i{j}") for j in (0, 1, 2)], app_id)
        while time.time() < deadline and published() <= g0:
            time.sleep(0.1)
        g1 = published()
        assert g1 > g0 and sub.wait_generation(g1, timeout=30)
        reader = ModelPlane(str(tmp_path / "sub-plane"), device=CPU)
        model, info = reader.load(reader.current())
        assert info["planeGeneration"] == g1 and "newbie" in model.user_dict
        for body in ({"user": "newbie", "num": 5}, {"user": "u2", "num": 5},
                     {"item": "i1", "num": 4}):
            want = json.dumps(algo.predict(model, URQuery.from_json(body)).to_json(),
                              separators=(",", ":"))
            assert json.loads(_post_raw(base + "/queries.json", body)) == json.loads(want)
    finally:
        if sub is not None:
            sub.stop()
        if proc is not None:
            _stop(proc)
        set_storage(None)

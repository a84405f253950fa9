"""The port's ``pio`` console against the JAX package's.

The whole loop runs in subprocesses on the CPU (``PIO_TORCH_DEVICE=cpu``)
over one localfs store: ``app new`` → ``import`` of a JSON-lines corpus of a
few hundred events (interactions and ``$set`` item properties) →
``snapshot`` (and ``snapshot --status``) → ``build`` → ``train``, which
reads the snapshot → ``deploy`` → ``POST /queries.json`` → ``undeploy`` →
``export``.  The served answers equal, under the UR bar of
``_torch_ur_cases.assert_same_answer`` (scores within rtol 1e-5), the JAX
package's UR trained on the same events; the import writes the segment
bytes the JAX ``pio import`` writes; the export equals the JAX ``pio
export`` of the same store byte for byte; the JAX ``pio snapshot
--status`` reads the port-built snapshot and prints what the port's does,
and the port's reads a JAX-built one.  Every subcommand the port does not
have yet exits non-zero naming its ROADMAP item.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from predictionio_tpu.cli import main as jax_cli
from predictionio_tpu.storage import set_storage as jax_set_storage
from predictionio_tpu.storage.locator import Storage as JaxStorage
from predictionio_tpu.storage.locator import StorageConfig as JaxStorageConfig
from predictionio_tpu.workflow import core_workflow as jax_workflow
from predictionio_tpu.workflow.create_workflow import engine_from_variant as jax_variant
from predictionio_tpu_torch.cli import main as cli
from predictionio_tpu_torch.storage import Storage, StorageConfig, set_storage

from _torch_event_cases import ecommerce_corpus, port_events, rating_corpus, rule_corpus
from _torch_ur_cases import assert_same_answer

REPO = Path(__file__).resolve().parents[1]
APP = "cliapp"
VARIANT = {
    "id": "cli-ur", "engineFactory": "universal_recommender",
    "datasource": {"params": {"appName": APP, "eventNames": ["purchase", "view"]}},
    "algorithms": [{"name": "ur", "params": {
        "appName": APP, "maxCorrelatorsPerItem": 8, "expireDateName": "expireDate"}}],
}
STAMPS = [("b2", {"expireDate": "2026-07-29T00:00:00"}),
          ("e1", {"expireDate": "2027-01-01T00:00:00", "tags": ["new", "sale"]})]
QUERIES = [{"user": "u20", "num": 6}, {"user": "u2", "num": 4},
           {"user": "u20", "num": 8, "currentDate": "2026-07-29T00:00:00"},
           {"user": "u2", "num": 4, "fields": [
               {"name": "category", "values": ["books"], "bias": -1}]},
           {"user": "u7", "num": 5, "fields": [
               {"name": "tags", "values": ["sale"], "bias": 2.0}]},
           {"item": "e1", "num": 3}, {"itemSet": ["b1", "e3"], "num": 4},
           {"user": "u3", "num": 4, "blacklistItems": ["e0", "e1"]},
           {"user": "stranger", "num": 5}]


def _env(root: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("PIO_")}
    return {**env, "PIO_FS_BASEDIR": str(root / "store"), "PIO_TORCH_DEVICE": "cpu",
            "HOME": str(root), "PYTHONPATH": str(REPO)}


def _pio(root: Path, *argv, check=True) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.main", *argv],
                         cwd=root, env=_env(root), capture_output=True, text=True,
                         timeout=300)
    if check:
        assert out.returncode == 0, (argv, out.stdout, out.stderr)
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def _jax_args(argv):
    return jax_cli.build_parser().parse_args(argv)


def _served(root: Path, bodies, env=None) -> dict:
    """``pio deploy`` in a subprocess: its ``GET /`` info, its answers to
    ``bodies``, then ``pio undeploy`` (twice: the second finds nothing) and
    the deploy's exit code and output."""
    out = {}
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy",
         "--ip", "127.0.0.1", "--port", str(port)],
        cwd=root, env=env or _env(root), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        base = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline, "pio deploy did not answer"
            try:
                with urllib.request.urlopen(base + "/", timeout=5) as resp:
                    out["info"] = json.loads(resp.read())
                break
            except (urllib.error.URLError, ConnectionError):
                time.sleep(0.2)
        out["answers"] = [_post(base + "/queries.json", q) for q in bodies]
        out["undeploy"] = _pio(root, "undeploy", "--port", str(port))
        out["deploy_rc"] = proc.wait(timeout=60)
        out["deploy_out"] = proc.stdout.read()
        out["undeploy_again"] = _pio(root, "undeploy", "--port", str(port), check=False)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return out


@pytest.fixture(scope="module")
def loop(tmp_path_factory):
    """The port's CLI loop, run once: what it printed and served."""
    root = tmp_path_factory.mktemp("cli")
    corpus = root / "events.jsonl"
    corpus.write_text("".join(json.dumps(e.to_json()) + "\n"
                              for e in port_events(rule_corpus(STAMPS))))
    (root / "engine.json").write_text(json.dumps(VARIANT))
    out = {"root": root, "corpus": corpus}
    out["new"] = _pio(root, "app", "new", APP).stdout
    out["import"] = _pio(root, "import", "--app-name", APP, "--input", str(corpus)).stdout
    out["snapshot"] = _pio(root, "snapshot", APP).stdout
    out["status"] = _pio(root, "snapshot", APP, "--status").stdout
    out["build"] = _pio(root, "build").stdout
    out["train"] = _pio(root, "train").stdout
    out["show"] = _pio(root, "app", "show", APP).stdout
    shutil.copytree(root / "store", root / "store-at-train")
    out.update(_served(root, QUERIES))
    out["export"] = _pio(root, "export", "--app-name", APP, "--output",
                         str(root / "export.jsonl")).stdout
    return out


@pytest.fixture(scope="module")
def jax_answers(loop):
    """The JAX package's UR trained from a copy of the same store (its own
    engine instance), answering QUERIES."""
    root = loop["root"]
    store = JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(root / "store-at-train")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    with pytest.MonkeyPatch.context() as mp:
        for k in ("PIO_HISTORY_CACHE", "PIO_SERVE_CACHE"):
            mp.setenv(k, "off")
        mp.setenv("PIO_SPANS_DIR", str(root / "spans"))
        jax_set_storage(store)
        try:
            factory, engine, ep = jax_variant(VARIANT)
            jax_workflow.run_train(engine, ep, engine_id="cli-ur-jax", storage=store)
            _, models = jax_workflow.load_latest_models("cli-ur-jax", storage=store)
            predict = engine.predictor(ep, models)
            return [predict(factory.query_class.from_json(q)).to_json() for q in QUERIES]
        finally:
            jax_set_storage(None)


def test_app_new_import_build_train(loop):
    assert f"Created app '{APP}' with id 1." in loop["new"]
    n = len(rule_corpus(STAMPS))
    assert loop["import"].strip() == f"Imported {n} events to app 1."
    assert "Registered engine cli-ur 1" in loop["build"]
    assert loop["train"].startswith("Training completed. Engine instance id: ")
    assert "access key: " in loop["show"]


def test_snapshot_before_train_and_the_jax_status_of_it(loop, capsys):
    n = len(rule_corpus(STAMPS))
    assert loop["snapshot"].startswith(f"Built snapshot for app '{APP}': {n} events from 1 "
                                       "segment(s) in ")
    lines = loop["status"].splitlines()
    assert lines[0] == f"Snapshot status for app '{APP}':"
    assert lines[2:] == [f"  events: {n} in snapshot, 0 in JSONL tail (0 bytes)",
                         "  coverage: 1.0000 over 1 segment(s)"]
    assert "writer local)" in lines[1]
    jax_set_storage(JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(loop["root"] / "store-at-train")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")})))
    try:
        capsys.readouterr()
        assert jax_cli._cmd_snapshot(_jax_args(["snapshot", APP, "--status"])) == 0
    finally:
        jax_set_storage(None)
    assert capsys.readouterr().out == loop["status"]


def test_deploy_serves_on_the_asked_device_and_undeploy_ends_it(loop):
    assert loop["info"]["devices"] == ["cpu"]
    assert loop["info"]["algorithms"] == ["ur"]
    assert loop["deploy_rc"] == 0, loop["deploy_out"]
    assert "deployed at http://127.0.0.1:" in loop["deploy_out"]
    assert loop["undeploy"].stdout.startswith("Undeployed 127.0.0.1:")
    assert loop["undeploy_again"].returncode == 1
    assert "No deployment reachable" in loop["undeploy_again"].stdout


def test_undeploy_probes_again_when_the_closing_listener_resets_it(monkeypatch, capsys):
    """A probe connect that the closing listener resets (ECONNRESET) is
    not a verdict: undeploy probes again, sees the port refuse, exits 0."""
    from types import SimpleNamespace

    from predictionio_tpu_torch.workflow.create_server import deploy_models

    class Engine:
        def serving_bundle(self, engine_params, models):
            return (lambda query: {"itemScores": []}), None

    server = deploy_models(Engine(), SimpleNamespace(algorithm_params_list=[]), [])
    port = server.server_address[1]
    real, calls = socket.create_connection, []

    def reset_once(address, *a, **kw):
        # the first connect is the /stop request's, the second the first probe's
        calls.append(address)
        if len(calls) == 2:
            raise ConnectionResetError(104, "Connection reset by peer")
        return real(address, *a, **kw)

    monkeypatch.setattr(cli.socket, "create_connection", reset_once)
    try:
        assert cli.main(["undeploy", "--port", str(port), "--timeout", "10"]) == 0
    finally:
        server.shutdown()
        server.server_close()
    assert len(calls) >= 3 and set(calls) == {("127.0.0.1", port)}
    assert capsys.readouterr().out == f"Undeployed 127.0.0.1:{port}.\n"


@pytest.mark.parametrize("k", range(len(QUERIES)))
def test_served_answers_equal_the_jax_ur(loop, jax_answers, k):
    got, want = loop["answers"][k], jax_answers[k]
    assert_same_answer(got, want)
    if QUERIES[k].get("user") != "stranger":
        assert got["itemScores"], QUERIES[k]


def test_import_writes_the_jax_import_bytes(loop, tmp_path):
    store = JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(tmp_path / "jax")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    jax_set_storage(store)
    try:
        assert jax_cli._cmd_app(_jax_args(["app", "new", APP])) == 0
        assert jax_cli._cmd_import(_jax_args(
            ["import", "--app-name", APP, "--input", str(loop["corpus"])])) == 0
    finally:
        jax_set_storage(None)
    rel = Path("events/app_1/_default")
    port = sorted((loop["root"] / "store-at-train" / rel).glob("seg-*.jsonl"))
    jax = sorted((tmp_path / "jax" / rel).glob("seg-*.jsonl"))
    assert [p.name for p in port] == [p.name for p in jax] and port
    assert [p.read_bytes() for p in port] == [p.read_bytes() for p in jax]


def test_export_equals_the_jax_export(loop, tmp_path):
    root = loop["root"]
    jax_set_storage(JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(root / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")})))
    try:
        assert jax_cli._cmd_export(_jax_args(
            ["export", "--app-name", APP, "--output", str(tmp_path / "jax.jsonl")])) == 0
    finally:
        jax_set_storage(None)
    n = len(rule_corpus(STAMPS))
    assert loop["export"].strip() == f"Exported {n} events from app 1 to {root / 'export.jsonl'}."
    assert (root / "export.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


TEMPLATES = {
    "recommendation": (rating_corpus, {
        "id": "cli-reco", "engineFactory": "recommendation",
        "datasource": {"params": {"appName": "clireco"}},
        "algorithms": [{"name": "als", "params": {
            "rank": 6, "numIterations": 6, "lambda": 0.05, "checkpointEvery": 2}}]},
        [{"user": "u0", "num": 5}, {"user": "u1", "num": 5, "unseenOnly": True},
         {"user": "u2", "num": 3, "blackList": ["i0", "i2"]}, {"user": "ghost"}]),
    "ecommerce": (ecommerce_corpus, {
        "id": "cli-ecomm", "engineFactory": "ecommerce",
        "datasource": {"params": {"appName": "cliecomm"}},
        "algorithms": [{"name": "ecomm", "params": {
            "appName": "cliecomm", "rank": 8, "numIterations": 10, "alpha": 2.0,
            "unseenOnly": True}}]},
        [{"user": "u0", "num": 4}, {"user": "u1", "num": 4, "categories": ["alpha"]},
         {"user": "u2", "num": 6, "blackList": ["a0"]}, {"user": "nobody", "num": 3}]),
}


@pytest.fixture(scope="module", params=sorted(TEMPLATES))
def template_loop(request, tmp_path_factory):
    """``pio app new`` → ``import`` → ``train`` → ``deploy`` of one ALS
    template in subprocesses on the CPU.  The recommendation train
    checkpoints every 2 sweeps under ``PIO_CHECKPOINT_DIR`` with a fault
    injected after its second chunk and ``PIO_TRAIN_RETRIES=1``; then the
    port's own predictor, loading the trained model in this process,
    answers the same queries."""
    name = request.param
    corpus, variant, bodies = TEMPLATES[name]
    app = variant["datasource"]["params"]["appName"]
    root = tmp_path_factory.mktemp(name)
    (root / "events.jsonl").write_text("".join(
        json.dumps(e.to_json()) + "\n" for e in port_events(corpus())))
    (root / "engine.json").write_text(json.dumps(variant))
    env = {**_env(root), "PIO_CHECKPOINT_DIR": str(root / "ck"),
           "PIO_TRAIN_RETRIES": "1", "PIO_FAULT_INJECT": "als.sweep:2"}
    _pio(root, "app", "new", app)
    _pio(root, "import", "--app-name", app, "--input", str(root / "events.jsonl"))
    train = subprocess.run([sys.executable, "-m", "predictionio_tpu_torch.cli.main", "train"],
                           cwd=root, env=env, capture_output=True, text=True, timeout=300)
    out = {"name": name, "root": root, "bodies": bodies, "train": train}
    out.update(_served(root, bodies))
    store = Storage(StorageConfig(
        sources={"S": {"type": "localfs", "path": str(root / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    set_storage(store)
    try:
        from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
        from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

        factory, engine, ep = engine_from_variant(variant)
        _, models = load_latest_models(variant["id"], storage=store, device="cpu")
        predict = engine.predictor(ep, models)
        out["in_process"] = [predict(factory.query_class.from_json(b)).to_json()
                             for b in bodies]
    finally:
        set_storage(None)
    return out


def test_pio_train_and_deploy_serve_the_template(template_loop):
    t = template_loop
    assert t["train"].returncode == 0, t["train"].stderr
    assert t["train"].stdout.startswith("Training completed. Engine instance id: ")
    if t["name"] == "recommendation":   # the retry resumed, then cleared its snapshots
        assert "injected fault at 'als.sweep'" in t["train"].stderr
        assert list((t["root"] / "ck" / "als").iterdir()) == []
    assert t["info"]["devices"] == ["cpu"]
    assert t["deploy_rc"] == 0, t["deploy_out"]
    assert t["answers"] == t["in_process"]
    first = [s["item"] for s in t["answers"][0]["itemScores"]]
    if t["name"] == "recommendation":
        assert first and all(int(i[1:]) % 2 == 0 for i in first), first
        assert t["answers"][-1] == {"itemScores": []}
    else:   # unseenOnly: none of u0's own items, live from the store
        seen = {s[4] for s in ecommerce_corpus() if s[2] == "u0"}
        assert first and not seen & set(first), first
        assert all(s["item"].startswith("a") for s in t["answers"][1]["itemScores"])
        assert t["answers"][-1]["itemScores"]     # the popularity tier


@pytest.fixture()
def port_store(tmp_path):
    store = Storage(StorageConfig(
        sources={"S": {"type": "localfs", "path": str(tmp_path / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    set_storage(store)
    yield store
    set_storage(None)


@pytest.mark.parametrize("argv", sorted([name] for name in cli.NOT_PORTED))
def test_unported_subcommands_exit_naming_their_item(argv, capsys):
    assert cli.main(argv + ["x", "--y"]) == 1
    item = cli.ROADMAP[cli.NOT_PORTED[argv[0]]]
    assert item in capsys.readouterr().err


@pytest.mark.parametrize("argv, item", [
    (["deploy", "--follow", "2", "--workers", "2"], "--workers requires the CPU"),
    (["deploy", "--plane-publish", "9000", "--plane-from", "h:9000"], "relaying"),
    (["deploy", "--plane-from", "h:9000", "--follow", "2"], "drop --follow"),
    (["deploy", "--follow", "2", "--plane-publish", "9000", "--workers", "2"],
     "--workers requires the CPU"),
])
def test_unported_options_exit_naming_their_item(port_store, tmp_path, monkeypatch, capsys,
                                                 argv, item):
    """Since the model plane is ported every deploy option is; the
    combinations deploy cannot honour exit 1 naming why: a subscriber that
    also folds or publishes, prefork workers on the card (the CLI's
    default device)."""
    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    assert cli.main(argv) == 1
    assert item in capsys.readouterr().err


def test_cuda_without_a_card_fails_and_cpu_trains(port_store, tmp_path, monkeypatch, capsys):
    """PIO_TORCH_DEVICE is the CLI's device; ``cuda`` (the default) without
    a card fails the train, nothing falls back."""
    import torch

    (tmp_path / "engine.json").write_text(json.dumps(VARIANT))
    (tmp_path / "events.jsonl").write_text("".join(
        json.dumps(e.to_json()) + "\n" for e in port_events(rule_corpus(STAMPS))))
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["app", "new", APP]) == 0
    assert cli.main(["import", "--app-name", APP, "--input", "events.jsonl"]) == 0
    monkeypatch.delenv("PIO_TORCH_DEVICE", raising=False)
    assert cli.main(["train"]) == 1
    assert "CUDA is not available" in capsys.readouterr().err
    assert port_store.engine_instances.get_all() == []
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    assert cli.main(["train", "--stop-after-prepare"]) == 0
    assert "read_training -> URTrainingData" in capsys.readouterr().out
    assert cli.main(["train"]) == 0
    assert [i.status for i in port_store.engine_instances.get_all()] == ["COMPLETED"]


def test_snapshot_of_a_jax_built_store_and_its_tail(port_store, tmp_path, capsys):
    """The JAX ``pio snapshot`` builds; the port's ``--status`` reports it
    and the tail the port imports after it, as the JAX one does; errors
    exit 1."""
    events = port_events(rule_corpus(STAMPS))
    (tmp_path / "a.jsonl").write_text("".join(json.dumps(e.to_json()) + "\n"
                                              for e in events[:40]))
    (tmp_path / "b.jsonl").write_text("".join(json.dumps(e.to_json()) + "\n"
                                              for e in events[40:]))
    assert cli.main(["app", "new", APP]) == 0
    assert cli.main(["snapshot", APP, "--status"]) == 0
    assert capsys.readouterr().out.endswith(f"No snapshot for app '{APP}'.\n")
    assert cli.main(["import", "--app-name", APP, "--input", str(tmp_path / "a.jsonl")]) == 0
    jax_set_storage(JaxStorage(JaxStorageConfig(
        sources={"S": {"type": "localfs", "path": str(tmp_path / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")})))
    try:
        assert jax_cli._cmd_snapshot(_jax_args(["snapshot", APP])) == 0
        assert cli.main(["import", "--app-name", APP, "--input", str(tmp_path / "b.jsonl")]) == 0
        capsys.readouterr()
        assert jax_cli._cmd_snapshot(_jax_args(["snapshot", APP, "--status"])) == 0
        want = capsys.readouterr().out
    finally:
        jax_set_storage(None)
    assert cli.main(["snapshot", APP, "--status"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert f"  events: 40 in snapshot, {len(events) - 40} in JSONL tail" in got
    assert cli.main(["snapshot", "nope"]) == 1
    assert cli.main(["snapshot", APP, "--channel", "nope"]) == 1
    assert "does not exist" in capsys.readouterr().err
    assert cli.main(["snapshot", APP]) == 0
    assert cli.main(["snapshot", APP, "--status"]) == 0
    assert f"  events: {len(events)} in snapshot, 0 in JSONL tail" in capsys.readouterr().out


def test_app_and_key_management(port_store, capsys):
    assert cli.main(["app", "new", "a", "--description", "d"]) == 0
    assert cli.main(["app", "new", "a"]) == 1
    assert cli.main(["channel", "new", "a", "ch"]) == 0
    assert cli.main(["accesskey", "new", "a", "buy"]) == 0
    key = capsys.readouterr().out.split("Created access key: ")[1].split()[0]
    assert port_store.access_keys.get(key).events == ["buy"]
    assert cli.main(["accesskey", "list", "a"]) == 0
    assert key in capsys.readouterr().out
    assert cli.main(["accesskey", "delete", "--", key]) == 0   # a key may start with "-"
    assert cli.main(["app", "list"]) == 0 and "  1  a  d" in capsys.readouterr().out
    assert cli.main(["app", "data-delete", "a"]) == 0
    assert cli.main(["channel", "delete", "a", "ch"]) == 0
    assert cli.main(["app", "delete", "a"]) == 0
    assert port_store.apps.get_all() == [] and port_store.access_keys.get_by_app_id(1) == []
    assert cli.main(["app", "show", "a"]) == 1
    assert cli.main(["version"]) == 0 and cli.main(["status"]) == 0
    assert "type=localfs" in capsys.readouterr().out


def test_train_resolves_the_engine_through_its_manifest(port_store, tmp_path, monkeypatch,
                                                        capsys):
    """``pio build`` registers engine.json; a train from another directory
    finds it by --engine-id (reference: the EngineManifest lookup)."""
    eng = tmp_path / "eng"
    eng.mkdir()
    (eng / "engine.json").write_text(json.dumps(VARIANT))
    monkeypatch.chdir(eng)
    assert cli.main(["build"]) == 0
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PIO_TORCH_DEVICE", "cpu")
    assert cli.main(["train", "--engine-id", "cli-ur", "--stop-after-read"]) == 1
    assert f"app {APP!r} does not exist" in capsys.readouterr().err
    assert cli.main(["train", "--engine-id", "nope", "--stop-after-read"]) == 1
    assert "engine.json" in capsys.readouterr().err


def _wait_json(url, timeout=120):
    deadline = time.monotonic() + timeout
    while True:
        try:
            with urllib.request.urlopen(url, timeout=5) as resp:
                return json.loads(resp.read())
        except (urllib.error.URLError, ConnectionError):
            assert time.monotonic() < deadline, f"{url} did not answer"
            time.sleep(0.2)


def test_eventserver_ingest_train_and_auto_reloading_deploy(tmp_path):
    """``pio eventserver --workers 2`` takes the ratings over HTTP with an
    access key (per-writer segments), ``pio train`` trains from them,
    ``pio deploy --auto-reload --feedback`` serves; new events and a second
    ``pio train`` reach the running server without a restart, each answer
    is then the new model's, the fed-back predictions are in the store,
    and ``pio undeploy`` stops both servers (exit 0)."""
    corpus, variant, bodies = TEMPLATES["recommendation"]
    variant = {**variant, "algorithms": [{"name": "als", "params": {
        "rank": 6, "numIterations": 6, "lambda": 0.05}}]}
    app = variant["datasource"]["params"]["appName"]
    (tmp_path / "engine.json").write_text(json.dumps(variant))
    key = re.search(r"Access key: (\S+)", _pio(tmp_path, "app", "new", app).stdout).group(1)
    es_port, q_port = _free_port(), _free_port()
    es = subprocess.Popen([sys.executable, "-m", "predictionio_tpu_torch.cli.main",
                           "eventserver", "--ip", "127.0.0.1", "--port", str(es_port),
                           "--workers", "2"], cwd=tmp_path, env=_env(tmp_path))
    deploy = None
    try:
        es_base = f"http://127.0.0.1:{es_port}"
        _wait_json(es_base + "/")
        wire = [e.to_json() for e in port_events(corpus())]
        for k in range(0, len(wire), 50):
            res = _post(f"{es_base}/batch/events.json?accessKey={key}", wire[k:k + 50])
            assert {r["status"] for r in res} == {201}
        chan = tmp_path / "store" / "events" / "app_1" / "_default"
        assert all(p.name.startswith("seg-w") for p in chan.glob("seg-*.jsonl"))
        _pio(tmp_path, "train")
        deploy = subprocess.Popen(
            [sys.executable, "-m", "predictionio_tpu_torch.cli.main", "deploy", "--ip",
             "127.0.0.1", "--port", str(q_port), "--auto-reload", "0.2", "--feedback"],
            cwd=tmp_path, env=_env(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        base = f"http://127.0.0.1:{q_port}"
        first = _wait_json(base + "/")["engineInstanceId"]
        before = [_post(base + "/queries.json", q) for q in bodies]
        flipped = [{**e, "properties": {"rating": 6.0 - e["properties"]["rating"]},
                    "eventTime": e["eventTime"].replace("2026", "2027")} for e in wire]
        for k in range(0, len(flipped), 50):
            _post(f"{es_base}/batch/events.json?accessKey={key}", flipped[k:k + 50])
        _pio(tmp_path, "train")
        deadline = time.monotonic() + 60
        while _wait_json(base + "/")["engineInstanceId"] == first:
            assert time.monotonic() < deadline, "the new instance was never installed"
            time.sleep(0.1)
        after = [_post(base + "/queries.json", q) for q in bodies]
        assert after != before
        assert _pio(tmp_path, "undeploy", "--port", str(q_port)).returncode == 0
        assert deploy.wait(timeout=60) == 0
        assert _pio(tmp_path, "undeploy", "--port", str(es_port)).returncode == 0
        assert es.wait(timeout=60) == 0
    finally:
        for p in (es, deploy):
            if p is not None and p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    store = Storage(StorageConfig(
        sources={"S": {"type": "localfs", "path": str(tmp_path / "store")}},
        repositories={r: "S" for r in ("METADATA", "EVENTDATA", "MODELDATA")}))
    predicts = list(store.l_events.find(1, event_names=["predict"]))
    assert len(predicts) == 2 * len(bodies)
    served = sorted(json.dumps(e.properties["prediction"], sort_keys=True) for e in predicts)
    assert served == sorted(json.dumps(a, sort_keys=True) for a in before + after)
    # the second model is the one a fresh load answers with
    set_storage(store)
    try:
        from predictionio_tpu_torch.workflow.core_workflow import load_latest_models
        from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

        factory, engine, ep = engine_from_variant(variant)
        _, models = load_latest_models(variant["id"], storage=store, device="cpu")
        predict = engine.predictor(ep, models)
        assert after == [predict(factory.query_class.from_json(b)).to_json() for b in bodies]
    finally:
        set_storage(None)

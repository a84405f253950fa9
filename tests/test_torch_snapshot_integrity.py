"""The port's ``tools/check_snapshot_integrity.py`` against the JAX
package's ``scripts/check_snapshot_integrity.py``.

Both scripts check the same stores: localfs and a 2-shard, 2-replica
sharded store with its merged manifest, each written by either package,
each clean, with a manifest watermark one event off, and with a covered
segment gone.  They must give the same exit codes and print the same
lines.
"""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import pytest

import predictionio_tpu.storage.localfs as jax_localfs
import predictionio_tpu.storage.sharded as jax_sharded
import predictionio_tpu_torch.storage.localfs as port_localfs
import predictionio_tpu_torch.storage.sharded as port_sharded
from predictionio_tpu_torch.tools import check_snapshot_integrity as port_check

REPO = Path(__file__).resolve().parents[1]


def _jax_check():
    spec = importlib.util.spec_from_file_location(
        "_jax_check_snapshot_integrity", REPO / "scripts" / "check_snapshot_integrity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CHECK = _jax_check()

STORES = {
    "jax-localfs": (jax_localfs, lambda root: jax_localfs.FSEvents(root)),
    "port-localfs": (port_localfs, lambda root: port_localfs.FSEvents(root)),
    "jax-sharded": (jax_localfs,
                    lambda root: jax_sharded.ShardedEvents(root, shards=2, replicas=2)),
    "port-sharded": (port_localfs,
                     lambda root: port_sharded.ShardedEvents(root, shards=2, replicas=2)),
}


def _events(n):
    out = []
    for k in range(n):
        ev = {"event": "buy" if k % 3 else "view", "entityType": "user",
              "entityId": f"u{k % 11}", "targetEntityType": "item",
              "targetEntityId": f"i{k % 7}", "eventId": f"ev-{k:04d}",
              "eventTime": f"2026-01-01T00:{k // 60:02d}:{k % 60:02d}.000Z"}
        if k % 9 == 8:
            ev = {"event": "$set", "entityType": "item", "entityId": f"i{k % 7}",
                  "properties": {"color": "red"}, "eventId": f"ev-{k:04d}",
                  "eventTime": ev["eventTime"]}
        out.append(ev)
    return out


def _write_store(kind, root, monkeypatch):
    """120 events in small segments, one tombstone, then the snapshot."""
    lfs, make = STORES[kind]
    monkeypatch.setattr(lfs, "SEGMENT_MAX_BYTES", 3000)
    ev = make(root)
    try:
        ev.insert_json_batch(_events(120), 1)
        ev.delete("ev-0005", 1)
        ev.build_snapshot(1)
        return ev._chan_dir(1, None)
    finally:
        if hasattr(ev, "close"):
            ev.close()


def _corrupt(chan: Path, root: Path, how: str) -> None:
    manifest = chan / "snapshot" / "manifest.json"
    m = json.loads(manifest.read_text())
    if how == "watermark":
        m["events"] += 1
        manifest.write_text(json.dumps(m))
    elif how == "segment":
        key = sorted(m["covered"])[0]
        shard, sep, name = key.partition("|")
        if sep:   # a merged manifest: the segment is gone from every node of its shard
            segs = list(root.glob(f"shard_{int(shard):02d}/*/events/app_1/_default/{name}"))
        else:
            segs = [chan / key]
        assert segs
        for seg in segs:
            seg.unlink()


def _run(check, root, capsys):
    rc = check.main([str(root)])
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("how", ["clean", "watermark", "segment"])
@pytest.mark.parametrize("kind", sorted(STORES))
def test_port_script_reports_as_the_jax_script(kind, how, tmp_path, monkeypatch, capsys):
    root = tmp_path / "store"
    chan = _write_store(kind, root, monkeypatch)
    _corrupt(chan, root, how)
    want = _run(JAX_CHECK, root, capsys)
    got = _run(port_check, root, capsys)
    assert got == want
    assert want[0] == (0 if how == "clean" else 1), want
    if how == "clean":
        assert "snapshot(s) match" in want[1]
    else:
        assert ("watermark" if how == "watermark" else "missing") in want[2]


def test_port_script_runs_alone_without_jax(tmp_path, monkeypatch):
    """``python -m`` on a port-written store, in a fresh interpreter that
    never imports JAX; a usage error exits 2 as the JAX script's does."""
    root = tmp_path / "store"
    _write_store("port-localfs", root, monkeypatch)
    code = ("import runpy, sys\n"
            "sys.argv = ['check_snapshot_integrity', sys.argv[1]]\n"
            "try:\n"
            "    runpy.run_module('predictionio_tpu_torch.tools.check_snapshot_integrity',"
            " run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not any(m == 'jax' or m.startswith(('jax.', 'predictionio_tpu.'))"
            " for m in sys.modules), 'imported JAX'\n"
            "    raise\n")
    r = subprocess.run([sys.executable, "-c", code, str(root)], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ok: 1 snapshot(s)" in r.stdout
    assert port_check.main([]) == JAX_CHECK.main([]) == 2

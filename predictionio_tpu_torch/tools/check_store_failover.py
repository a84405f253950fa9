#!/usr/bin/env python
"""Fault-injection drill for the sharded, replicated event store.

Proves the failover contract end to end on a real store (shards=2,
replicas=2, PIO_FSYNC=always):

1. **Kill a primary mid-group-commit**: a real OS-process writer ingests
   through the semi-sync replication barrier, printing every ACKED event
   id; it is SIGKILLed mid-stream, then every shard's primary node
   directory is yanked away.  A fresh store instance must promote each
   replica and serve every acked event exactly once — zero acked-event
   loss, zero duplicates, with the un-acked tail either absent or present
   at most once (at-least-once is the ingest contract).
2. **Torn replica tail**: garbage is appended past a replica segment's
   acknowledged offset and an acknowledged suffix is torn off another;
   the follower must heal both (truncate / re-copy) and ingest must keep
   acking — replica bytes end up byte-identical to the primary.
3. **Partition mid-scan**: a shard's primary directory is renamed away
   while a fan-out scan is mid-flight; the scan must promote, resume on
   the replica, and still return every surviving event exactly once.
4. **Re-sync drains**: after all of the above, ``topology_status`` (the
   /stats.json ``storeTopology`` document) must show every shard's
   ``replicaLagEvents`` at 0 — the ``pio_store_replica_lag_events``
   gauge's source of truth.

Exit 0 = every phase clean; 1 = any failure (printed).  Run standalone
(``python -m predictionio_tpu_torch.tools.check_store_failover``, or the
file's path) or via the tier-1 suite (tests/test_torch_drill_store_failover.py
wraps it).  The port's copy of ``scripts/check_store_failover.py``: the same
phases, messages and exit codes on the port's sharded store.  It does no
device work, so it takes no ``--device``.
"""

from __future__ import annotations

import os
import shutil
import signal
import subprocess
import sys
import tempfile
import textwrap
import time
from pathlib import Path

# runnable from any cwd without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from predictionio_tpu_torch.tools._drill import REPO_ROOT  # noqa: E402

SHARDS = 2
APP_ID = 1


def writer_script(root: str, tag: str, n: int, shards: int = SHARDS,
                  app_id: int = APP_ID) -> str:
    """A real OS-process writer into the replicated store: each event id
    (``<tag>-<k>``) is printed only AFTER the insert returned — i.e.
    after the semi-sync replication barrier acknowledged it on both
    nodes.  The port's writer, in a child that imports the port from the
    checkout (the drill runs it with ``PYTHONPATH`` at the checkout's
    root)."""
    return textwrap.dedent(f"""
        import os
        os.environ["PIO_FSYNC"] = "always"
        os.environ["PIO_WRITER_TAG"] = {tag!r}
        from predictionio_tpu_torch.storage import localfs
        localfs.SEGMENT_MAX_BYTES = 4096   # constant rotation
        from predictionio_tpu_torch.storage.sharded import ShardedEvents
        ev = ShardedEvents({root!r}, shards={shards}, replicas=2)
        for k in range({n}):
            r = ev.insert_json_batch(
                [{{"event": "buy", "entityType": "user",
                   "entityId": "u%d" % k,
                   "eventId": "{tag}-%d" % k}}], {app_id})
            assert r[0]["status"] == 201, r
            print("{tag}-%d" % k, flush=True)
        print("DONE", flush=True)
    """)


def phase_kill_primary(root: str, problems: list) -> set:
    """SIGKILL a writer mid-commit, yank every primary node dir, verify
    promotion preserves exactly the acked set."""
    from predictionio_tpu_torch.storage.sharded import ShardedEvents

    path = os.environ.get("PYTHONPATH")
    p = subprocess.Popen(
        [sys.executable, "-c", writer_script(root, "wK", 100_000)],
        stdout=subprocess.PIPE, text=True,
        env={**os.environ,
             "PYTHONPATH": REPO_ROOT + (os.pathsep + path if path else "")})
    acked = []
    for line in p.stdout:
        acked.append(line.strip())
        if len(acked) >= 80:
            break
    os.kill(p.pid, signal.SIGKILL)
    p.wait(timeout=30)
    # yank the primary node of every shard (the "node died" injection)
    for k in range(SHARDS):
        pdir = Path(root) / f"shard_{k:02d}" / "a"
        if pdir.exists():
            shutil.move(str(pdir), str(pdir) + ".lost")
    ev = ShardedEvents(root, shards=SHARDS, replicas=2)
    got = [e.event_id for e in ev.scan(APP_ID)]
    missing = set(acked) - set(got)
    if missing:
        problems.append(
            f"kill-primary: {len(missing)} acked events lost after "
            f"promotion (e.g. {sorted(missing)[:3]})")
    dups = {i for i in got if got.count(i) > 1} if len(got) != len(
        set(got)) else set()
    if dups:
        problems.append(f"kill-primary: duplicated events {sorted(dups)[:3]}")
    topo = ev.topology_status()
    promoted = [s for s in topo["perShard"] if s["epoch"] >= 1
                and s["primary"] == "b"]
    if len(promoted) != SHARDS:
        problems.append(f"kill-primary: expected {SHARDS} promoted shards, "
                        f"topology={topo}")
    # ingestion continues through the promotion: new events ack again
    # (the follower re-creates + re-syncs the yanked node)
    res = ev.insert_json_batch(
        [{"event": "buy", "entityType": "user", "entityId": f"p{k}",
          "eventId": f"post-{k}"} for k in range(40)], APP_ID)
    bad = [r for r in res if r.get("status") != 201]
    if bad:
        problems.append(f"kill-primary: post-promotion ingest NACKed: {bad[:2]}")
    got2 = {e.event_id for e in ev.scan(APP_ID)}
    if not {f"post-{k}" for k in range(40)} <= got2:
        problems.append("kill-primary: post-promotion events not readable")
    ev.close()
    if not problems:
        print(f"ok: kill-primary — {len(acked)} acked events survived "
              f"promotion exactly once, ingest continued")
    return set(acked) | {f"post-{k}" for k in range(40)}


def phase_torn_replica(root: str, acked_ids: set, problems: list) -> set:
    """Tear replica tails both ways; the follower heals and ingest keeps
    acking; replica ends byte-identical to primary."""
    from predictionio_tpu_torch.storage.sharded import ShardedEvents

    ev = ShardedEvents(root, shards=SHARDS, replicas=2)
    before = len(problems)
    # current primaries are node b (promoted in phase 1); replicas are a
    topo = ev.topology_status()
    segs = []
    for s in topo["perShard"]:
        k = s["shard"]
        rep = "a" if s["primary"] == "b" else "b"
        rdir = Path(root) / f"shard_{k:02d}" / rep
        segs.extend(sorted(rdir.glob("events/app_*/*/seg-*.jsonl")))
    if len(segs) < 2:
        problems.append(f"torn-replica: expected ≥2 replica segments, "
                        f"found {len(segs)}")
        ev.close()
        return acked_ids
    # injection 1: garbage appended past the acked offset (torn copy)
    with open(segs[0], "ab") as f:
        f.write(b'{"eventId": "torn-garbage", "event": "bu')
    # injection 2: tear an acked suffix off (replica lost durable bytes)
    sz = segs[1].stat().st_size
    with open(segs[1], "rb+") as f:
        f.truncate(max(0, sz - 17))
    res = ev.insert_json_batch(
        [{"event": "buy", "entityType": "user", "entityId": f"t{k}",
          "eventId": f"torn-{k}"} for k in range(30)], APP_ID)
    if any(r.get("status") != 201 for r in res):
        problems.append("torn-replica: ingest NACKed while healing")
    deadline = time.time() + 10
    while time.time() < deadline:
        if all(s["replicaLagEvents"] == 0
               for s in ev.topology_status()["perShard"]):
            break
        time.sleep(0.05)
    # replica must be byte-identical to the primary's complete lines
    for s in ev.topology_status()["perShard"]:
        k = s["shard"]
        pri, rep = s["primary"], ("a" if s["primary"] == "b" else "b")
        proot = Path(root) / f"shard_{k:02d}" / pri
        rroot = Path(root) / f"shard_{k:02d}" / rep
        for seg in sorted(proot.glob("events/app_*/*/seg-*.jsonl")):
            rel = seg.relative_to(proot)
            want = seg.read_bytes()
            got = (rroot / rel).read_bytes() if (rroot / rel).exists() else b""
            if got != want:
                problems.append(
                    f"torn-replica: {rel} diverges "
                    f"(replica {len(got)}B vs primary {len(want)}B)")
    got = [e.event_id for e in ev.scan(APP_ID)]
    if "torn-garbage" in got:
        problems.append("torn-replica: injected garbage line surfaced")
    missing = (acked_ids | {f"torn-{k}" for k in range(30)}) - set(got)
    if missing:
        problems.append(f"torn-replica: events lost: {sorted(missing)[:3]}")
    ev.close()
    if len(problems) == before:
        print("ok: torn-replica — both tears healed, replica byte-identical, "
              "ingest kept acking")
    return acked_ids | {f"torn-{k}" for k in range(30)}


def phase_partition_mid_scan(root: str, acked_ids: set,
                             problems: list) -> None:
    """Rename a shard's primary away while a fan-out scan is mid-flight:
    the scan promotes and still yields every surviving event once."""
    from predictionio_tpu_torch.storage.sharded import ShardedEvents

    ev = ShardedEvents(root, shards=SHARDS, replicas=2)
    before = len(problems)
    topo = ev.topology_status()
    victim = topo["perShard"][0]
    vdir = Path(root) / "shard_00" / victim["primary"]
    seen = []
    it = ev.scan(APP_ID)
    for _ in range(5):          # partially consume, then partition
        seen.append(next(it).event_id)
    shutil.move(str(vdir), str(vdir) + ".partitioned")
    try:
        seen.extend(e.event_id for e in it)
    except OSError as e:
        problems.append(f"partition-mid-scan: scan died instead of "
                        f"failing over: {e}")
    if len(seen) != len(set(seen)):
        problems.append("partition-mid-scan: duplicates after mid-scan "
                        "failover")
    missing = acked_ids - set(seen)
    if missing:
        problems.append(
            f"partition-mid-scan: {len(missing)} acked events missing "
            f"(e.g. {sorted(missing)[:3]})")
    new_topo = ev.topology_status()
    if new_topo["perShard"][0]["epoch"] <= victim["epoch"]:
        problems.append("partition-mid-scan: shard 0 never promoted")
    # re-sync after the partition drains to 0 on every shard
    deadline = time.time() + 10
    while time.time() < deadline:
        if all(s["replicaLagEvents"] == 0
               for s in ev.topology_status()["perShard"]):
            break
        time.sleep(0.05)
    lags = {s["shard"]: s["replicaLagEvents"]
            for s in ev.topology_status()["perShard"]}
    if any(lags.values()):
        problems.append(f"partition-mid-scan: replica lag never drained "
                        f"to 0: {lags}")
    from predictionio_tpu_torch.storage.sharded import _M_REPL_LAG

    for k in range(SHARDS):
        if _M_REPL_LAG.value(shard=str(k)) != 0:
            problems.append(
                f"pio_store_replica_lag_events{{shard={k}}} != 0 after drain")
    ev.close()
    if len(problems) == before:
        print("ok: partition-mid-scan — scan failed over, exactly-once "
              "preserved, lag drained to 0")


def main(argv=None) -> int:
    import argparse

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    # env mutations live HERE, not at module level: the tests import
    # writer_script without inheriting PIO_FSYNC=always
    os.environ["PIO_FSYNC"] = "always"
    problems: list = []
    tmp = tempfile.mkdtemp(prefix="pio-failover-")
    try:
        acked = phase_kill_primary(tmp, problems)
        acked = phase_torn_replica(tmp, acked, problems)
        phase_partition_mid_scan(tmp, acked, problems)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print("ok: store failover drill clean — zero acked-event loss, "
              "zero duplicates, promotion + re-sync verified")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main())

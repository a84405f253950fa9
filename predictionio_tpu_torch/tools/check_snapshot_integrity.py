#!/usr/bin/env python
"""Verify columnar event-store snapshots against their JSONL ground truth.

For every ``snapshot/manifest.json`` under a localfs/sharedfs store root
(``<root>/events/app_*/<channel>/snapshot/``):

- re-parse each covered byte range of each covered segment, drop the
  tombstone ids the manifest says were applied, and diff the resulting
  event COUNT against both the manifest's event-count watermark and the
  snapshot file's row count;
- diff the re-derived eventId SET against the snapshot's id column;
- row-verify a sample prefix: event verb, entityType, entityId, target
  and timestamp columns must decode back to exactly what the JSONL says.

Exit 0 = every snapshot matches; 1 = any diff (printed).  Run standalone
(``python -m predictionio_tpu_torch.tools.check_snapshot_integrity
<store_root>...``, or the file's path) or via the tier-1 suite
(tests/test_torch_snapshot_integrity.py).  The port's copy of
``scripts/check_snapshot_integrity.py``: the same checks, messages and exit
codes, read through the port's columnar reader.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

# runnable from any cwd without an installed package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SAMPLE_ROWS = 500


def _parse_covered(seg: Path, end: int, applied: set, truth: list) -> None:
    with open(seg, "rb") as f:
        data = f.read(end)
    for line in data.split(b"\n"):
        if not line.strip():
            continue
        ev = json.loads(line)
        if ev.get("eventId") in applied:
            continue
        truth.append(ev)


def _shard_primary(shard_dir: Path) -> str:
    try:
        topo = json.loads((shard_dir / "topology.json").read_text())
        return topo.get("primary", "a")
    except (OSError, json.JSONDecodeError):
        return "a"


def check_channel(d: Path, store_root: Path = None) -> list:
    """Problems for one channel dir with a snapshot (empty = clean).

    A MERGED cross-shard manifest (the sharded store's root-level
    snapshot; covered keys are ``"<shard>|<segment>"``) re-derives its
    ground truth from every shard's primary node in shard order — the
    merged file's row-order contract — and needs ``store_root`` to
    resolve the shard directories."""
    from predictionio_tpu_torch.store.columnar import read_batch
    from predictionio_tpu_torch.storage.snapshot import load_manifest

    problems = []
    m = load_manifest(d)
    if m is None:
        return [f"{d}: unreadable/invalid manifest"]
    try:
        batch, ids, _meta = read_batch(d / "snapshot" / m["snapshot"])
    except (OSError, ValueError) as e:
        return [f"{d}: snapshot unreadable: {e}"]
    if ids is None:
        return [f"{d}: snapshot has no id column"]
    applied = set(m.get("tombstones_applied", ()))
    truth = []   # wire dicts in builder order (sorted covered segments)
    if m.get("merged"):
        if store_root is None:
            return [f"{d}: merged manifest outside a sharded store root"]
        per_shard: dict = {}
        for key, end in m["covered"].items():
            k, sep, name = key.partition("|")
            if not sep or not k.isdigit():
                problems.append(f"{d}: malformed merged covered key {key!r}")
                continue
            per_shard.setdefault(int(k), {})[name] = end
        for k in sorted(per_shard):
            sd = store_root / f"shard_{k:02d}"
            chan = (sd / _shard_primary(sd) / "events"
                    / d.parent.name / d.name)
            for name in sorted(per_shard[k]):
                seg = chan / name
                if not seg.exists():
                    problems.append(
                        f"{d}: covered segment {k}|{name} missing "
                        "(stale manifest — snapshot would be bypassed)")
                    continue
                _parse_covered(seg, per_shard[k][name], applied, truth)
    else:
        for name in sorted(m["covered"]):
            seg = d / name
            if not seg.exists():
                problems.append(f"{d}: covered segment {name} missing "
                                "(stale manifest — snapshot would be "
                                "bypassed)")
                continue
            _parse_covered(seg, m["covered"][name], applied, truth)
    if len(truth) != m.get("events"):
        problems.append(
            f"{d}: JSONL recount {len(truth)} != manifest watermark "
            f"{m.get('events')}")
    if len(batch) != len(truth):
        problems.append(
            f"{d}: snapshot rows {len(batch)} != JSONL recount {len(truth)}")
    id_truth = {e.get("eventId") for e in truth}
    id_snap = set(ids.tolist())
    if id_truth != id_snap:
        missing = list(id_truth - id_snap)[:3]
        extra = list(id_snap - id_truth)[:3]
        problems.append(
            f"{d}: eventId set diff (missing {missing}, extra {extra})")
    from predictionio_tpu_torch.events.event import parse_time

    # merged manifests verify sample rows by id alignment (multi-writer
    # segment-name interleaving can make the cross-shard parse order
    # differ from the build-time order without being wrong); per-shard
    # manifests keep the strict prefix-order check
    row_of = None
    if m.get("merged"):
        row_of = {eid: j for j, eid in enumerate(ids.tolist())}
    for j, ev in enumerate(truth[:SAMPLE_ROWS]):
        if row_of is not None:
            j = row_of.get(ev.get("eventId"), -1)
            if j < 0:
                continue      # already reported by the id-set diff
        if j >= len(batch):
            break
        got = (
            batch.event_dict.str(int(batch.event_codes[j])),
            batch.entity_type_dict.str(int(batch.entity_type_codes[j])),
            batch.entity_dict.str(int(batch.entity_ids[j])),
            (batch.target_dict.str(int(batch.target_ids[j]))
             if batch.target_ids[j] >= 0 else None),
            int(batch.times_us[j]),
        )
        want = (
            ev["event"], ev["entityType"], str(ev["entityId"]),
            (str(ev["targetEntityId"])
             if ev.get("targetEntityId") is not None else None),
            int(parse_time(ev["eventTime"]).timestamp() * 1e6),
        )
        if got != want:
            problems.append(f"{d}: row {j} mismatch: {got} != {want}")
            break
    return problems


def _channel_ids(chan: Path) -> set:
    """Live eventIds in a channel dir: complete lines of every segment,
    minus the unioned tombstones (torn tails skipped, like the scans)."""
    dead = set()
    for t in chan.glob("tombstones*.txt"):
        dead.update(t.read_text().split())
    ids = set()
    for seg in sorted(chan.glob("seg-*.jsonl")):
        data = seg.read_bytes()
        lines = data.split(b"\n")
        if lines and not data.endswith(b"\n"):
            lines = lines[:-1]          # torn tail: never acknowledged
        for line in lines:
            if not line.strip():
                continue
            try:
                eid = json.loads(line).get("eventId")
            except json.JSONDecodeError:
                continue
            if eid and eid not in dead:
                ids.add(eid)
    return ids


def check_sharded_root(root: Path) -> list:
    """Sharded-store invariants: every shard's PRIMARY node is a normal
    localfs tree (its snapshots are verified by check_channel like any
    other), and the merged cross-shard eventId sets per (app, channel)
    must be pairwise DISJOINT — an id in two shards means routing broke
    or a failover duplicated data."""
    problems = []
    shards = sorted(p for p in root.glob("shard_*") if p.is_dir())
    per_chan: dict = {}           # (app/chan relpath) -> {shard: ids}
    for sd in shards:
        try:
            topo = json.loads((sd / "topology.json").read_text())
            primary = topo.get("primary", "a")
        except (OSError, json.JSONDecodeError):
            primary = "a"
        evroot = sd / primary / "events"
        if not evroot.exists():
            continue
        for chan in sorted(evroot.glob("app_*/*")):
            if not chan.is_dir():
                continue
            key = f"{chan.parent.name}/{chan.name}"
            per_chan.setdefault(key, {})[sd.name] = _channel_ids(chan)
    for key, by_shard in sorted(per_chan.items()):
        owner: dict = {}
        for shard_name, ids in sorted(by_shard.items()):
            for eid in ids:
                if eid in owner:
                    problems.append(
                        f"{root}: {key}: eventId {eid!r} present in BOTH "
                        f"{owner[eid]} and {shard_name} (cross-shard "
                        "duplicate)")
                    break               # one example per shard pair
                owner[eid] = shard_name
    return problems


def main(argv) -> int:
    if not argv:
        print("usage: check_snapshot_integrity.py <store_root>...",
              file=sys.stderr)
        return 2
    problems = []
    checked = 0
    for root in argv:
        events = Path(root) / "events"
        for manifest in sorted(events.glob("app_*/*/snapshot/manifest.json")):
            checked += 1
            problems.extend(check_channel(manifest.parent.parent,
                                          store_root=Path(root)))
        # sharded layout: per-shard per-node manifests + the cross-shard
        # merged eventId disjointness sweep
        for manifest in sorted(Path(root).glob(
                "shard_*/*/events/app_*/*/snapshot/manifest.json")):
            checked += 1
            problems.extend(check_channel(manifest.parent.parent))
        if any(Path(root).glob("shard_*")):
            problems.extend(check_sharded_root(Path(root)))
    for p in problems:
        print(f"FAIL {p}", file=sys.stderr)
    if not problems:
        print(f"ok: {checked} snapshot(s) match their JSONL ground truth")
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

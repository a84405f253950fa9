#!/usr/bin/env python3
"""Where the PyTorch/H100 port's time goes: ALS serving, K1 and the store.

    python3 profile_torch.py [--queries N] [--only als|k1|store] [--ab-parent DIR]

ALS serving.  Builds the model ``chip_smoke.py`` serves (5,000 users x
100,000 items x rank 32, random factors from a seed) on the CUDA card and
measures, after a warm-up:

1. library predict latency (``Engine.predictor``, no HTTP) and batch
   predict latency at the serving micro-batch (64 queries), host clock;
2. the per-query stages one at a time, each ended by a synchronize:
   exclusion mask on the device, the masked-score kernel, the
   ``lax.top_k``-ordered top-k, the device→host copy, host result assembly;
3. a ``torch.profiler`` window over ``--queries`` predicts: the device's
   busy share of the wall time and kernel time by kernel name.

K1 alone (``--only k1``, the quick loop for work on the masked-score
kernel; not part of the default run):

4. build K1 only and hold it against its plain version at every
   ``chip_smoke.K1_CASES`` shape (packed and row-strided masks);
5. time it with ``chip_smoke.time_masked_score`` at ``chip_smoke.K1_TIMED``
   and at B = 8 and 16 (either side of the streaming / tiled cut), an empty
   kernel through the same ``time_cold``, and the 5 interleaved B = 1
   rounds against ``addmm`` + ``masked_fill_`` (``chip_smoke.retime_k1``).

The localfs store path alone (``--only store``, the quick loop for work on
the event store; not part of the default run), at the deployed width (1.2M
interactions + 100k ``$set`` item events, ``chip_smoke.py`` phase 11b's
data) in a temporary directory:

6. the JSON-lines write, ``pio import`` (events/s), the native scan of the
   segments (3 runs, its read rate, and the C++ parse and merge alone),
   ``fold_properties`` of the item ``$set`` events, and ``read_training``
   (scan, fold and translation);
7. the columnar snapshot of the same store: its build (``pio snapshot``'s
   work), ``read_batch`` of the snapshot file with the native header parse
   and with the Python one (``PIO_NATIVE=on|off``, 3 runs each; the read
   alone, and with the dictionaries decoded and every column paged in),
   ``scan_tail`` of a ``chip_smoke.SNAP_TAIL`` tail imported after the
   build, the lookup of ``chip_smoke.SNAP_DELETES`` tombstoned ids in the
   snapshot's id column (an ``index_of`` an id, as the JAX package's
   ``drop_tombstoned`` does, against ``rows_of``'s one pass), the ``$set``
   fold of the snapshot's batch, ``read_training`` served by the snapshot
   and its tail, and ``delete``'s liveness check for three view events
   (the first, the middle and the last one of the log): the byte search
   of the segments (``FSEvents._is_live``) against the full parse of the
   log that the JAX package's ``delete`` runs.

With ``--ab-parent DIR`` (DIR a checkout of another commit, e.g. ``git
archive`` of the parent unpacked into ``_archive/``), fresh processes of
DIR and of this checkout, in the order DIR, this, this, DIR, each run the
same work on one host: with ``--only store``, ``read_training`` of step
6's store through the native scan, 3 reads each; with ``--only als``,
the ALS batch run the serving micro-batcher makes (``batch_predictor``
on step 1's model, 100,000 items) at micro-batches of 4 and 64 queries,
host clock, p50 of ``--queries`` queries' batches.

Needs a CUDA card; imports neither JAX nor the JAX package.  Prints one
JSON object as its last line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _ms(samples):
    samples = sorted(samples)
    return {"p50": statistics.median(samples),
            "p99": samples[min(len(samples) - 1, int(len(samples) * 0.99))],
            "n": len(samples)}


def _device_kernels(prof, per: int):
    """Device time by kernel name from a profiler window, per ``per``
    queries, and the window's device busy µs."""
    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us_per": dev_us / per, "calls": ev.count}
    busy_us = sum(k["us_per"] for k in kernels.values()) * per
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1]["us_per"])[:12])
    for name, k in top.items():
        print(f"  {k['us_per']:11.2f} us  {k['calls']:6d} calls  {name[:90]}")
    return top, busy_us


def profile_k1(chip_smoke, smi: str) -> dict:
    """Steps 4-5: K1 built, checked and timed, nothing else."""
    from predictionio_tpu_torch.device import resolve_device
    from predictionio_tpu_torch.ops import build
    from predictionio_tpu_torch.ops import hopper_kernels as hk

    dev = resolve_device("cuda")
    build_s = build.build_all(["masked_score"])
    print(f"  build_s={build_s:.3f}")
    for line in build.build_logs.get("masked_score", "").splitlines():
        if "entry function" in line or "Used" in line or "spill" in line:
            print(f"  {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    worst = chip_smoke.compare_kernel(hk, dev, gen)
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)   # > 50 MB L2
    clock = chip_smoke.SMClock()
    empty_ms = chip_smoke.time_empty(flush, clock)
    rows = [chip_smoke.time_masked_score(hk, dev, gen, b, k, chip_smoke.N_ITEMS, flush,
                                         clock, strided)
            for b, k, strided in chip_smoke.K1_TIMED + [(8, 32, True), (16, 32, True)]]
    rounds = chip_smoke.retime_k1(hk, dev, gen, flush, clock)
    print(f"  empty kernel (torch.cuda._sleep(0)) through time_cold: {empty_ms:.4f} ms | {smi}")
    for r in rows:
        print(chip_smoke.k1_text(r, smi))
    for line in chip_smoke.k1_rounds_text(rounds, smi):
        print(line)
    return {"max_abs_err": worst, "empty_kernel_ms": empty_ms, "rows": rows,
            "rounds": rounds, "build_s": build_s}


def profile_store(chip_smoke, smi: str, ab_parent: Optional[Path] = None) -> dict:
    """Step 6: import, native scan and $set fold at the deployed width."""
    import os
    import shutil
    import tempfile

    from predictionio_tpu_torch.models import universal_recommender as ur
    from predictionio_tpu_torch.native import scanner
    from predictionio_tpu_torch.storage import get_storage, set_storage
    from predictionio_tpu_torch.store.columnar import fold_properties
    from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant

    n_items = chip_smoke.DEPLOYED_UR[1]
    arrays = chip_smoke.deployed_arrays()
    props = chip_smoke.item_properties(chip_smoke.item_columns(n_items))
    if not scanner.native_available():   # built here, outside the timings
        raise RuntimeError("the native event-log scanner did not build")
    workdir = Path(tempfile.mkdtemp(prefix="profile-store-"))
    try:
        os.environ.update(chip_smoke.localfs_env(workdir / "store"))
        set_storage(None)
        t = {}
        t0 = time.perf_counter()
        chip_smoke.write_jsonl(workdir / "events.jsonl", arrays, props)
        t["jsonl_write_s"] = time.perf_counter() - t0
        chip_smoke.pio("app", "new", "smoke")
        t0 = time.perf_counter()
        chip_smoke.pio("import", "--app-name", "smoke", "--input", str(workdir / "events.jsonl"))
        t["import_s"] = time.perf_counter() - t0
        store = get_storage()
        paths = store.l_events.segment_paths(store.apps.get_by_name("smoke").id)
        seg_bytes = sum(p.stat().st_size for p in paths)
        n_events = sum(len(a) for a in arrays[::2]) + n_items
        scans, parses = [], []
        lib = scanner._build_and_load()
        for _ in range(3):
            t0 = time.perf_counter()
            batch = scanner.scan_segments(paths)
            scans.append(time.perf_counter() - t0)
            # the C++ parse and merge alone (scan_segments without the
            # copies out and the dictionaries' decode)
            handle = lib.scan_new()
            for p in paths:
                lib.scan_add_file(handle, str(p).encode())
            t0 = time.perf_counter()
            lib.scan_run(handle, min(os.cpu_count() or 4, 16))
            parses.append(time.perf_counter() - t0)
            lib.scan_free(handle)
        t0 = time.perf_counter()
        folded = fold_properties(batch, "item")
        t["fold_s"] = time.perf_counter() - t0
        _, _, ep = engine_from_variant(chip_smoke.engine_variant(False))
        t0 = time.perf_counter()
        ur.URDataSource(ep.data_source_params).read_training()
        t["read_training_s"] = time.perf_counter() - t0
        if ab_parent is not None:
            t["read_training_ab"] = read_training_ab(chip_smoke, ab_parent, workdir / "store")
        t["snapshot"] = profile_snapshot(chip_smoke, store, ep, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
        set_storage(None)
    t.update(scan_s=scans, scan_run_s=parses, events=n_events, segments=len(paths), segment_bytes=seg_bytes,
             import_events_per_s=n_events / t["import_s"],
             scan_gb_per_s=seg_bytes / min(scans) / 1e9, folded_items=len(folded))
    print(f"  store: {n_events} events, JSONL write {t['jsonl_write_s']:.3f} s, pio import "
          f"{t['import_s']:.3f} s ({t['import_events_per_s']:.0f} events/s) into "
          f"{len(paths)} segments of {seg_bytes} bytes; native scan "
          f"{', '.join(f'{x:.3f}' for x in scans)} s ({t['scan_gb_per_s']:.3f} GB/s at the "
          f"best; the C++ parse and merge alone {', '.join(f'{x:.3f}' for x in parses)} s), "
          f"$set fold {t['fold_s']:.3f} s ({len(folded)} items), read_training "
          f"{t['read_training_s']:.3f} s (host work; {os.cpu_count()} CPUs) | {smi}")
    return t


# one process's native-scan reads: argv = engine variant (JSON), reads
AB_READ = r"""
import json, sys, time
from predictionio_tpu_torch.native import scanner
from predictionio_tpu_torch.workflow.create_workflow import engine_from_variant
assert scanner.native_available(), "the native scanner did not build"
_, engine, ep = engine_from_variant(json.loads(sys.argv[1]))
out = []
for _ in range(int(sys.argv[2])):
    n = scanner.scans_served
    t0 = time.perf_counter()
    td = engine.make_components(ep)[0].read_training()
    out.append(time.perf_counter() - t0)
    assert scanner.scans_served == n + 1, "read_training made no native scan"
    del td
print(json.dumps(out))
"""


AB_BATCH = r"""
import json, sys, time
import numpy as np
import chip_smoke
from predictionio_tpu_torch.controller import EngineParams
from predictionio_tpu_torch.models import recommendation as reco
rng = np.random.default_rng(chip_smoke.SEED)
model = reco.als_model_from_state(chip_smoke.make_state(rng), device="cuda")
ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams())])
predict_batch = reco.RecommendationEngine.apply().batch_predictor(ep, [model])
qs = [reco.RecoQuery.from_json(b) for b in chip_smoke.queries(rng, int(sys.argv[1]))]
out = {}
for size in (4, 64):
    predict_batch(qs[:size])
    ms = []
    for s in range(0, len(qs) - size + 1, size):
        t0 = time.perf_counter()
        predict_batch(qs[s:s + size])
        ms.append((time.perf_counter() - t0) * 1e3)
    out[size] = sorted(ms)[len(ms) // 2]
print(json.dumps(out))
"""


def als_batch_ab(parent: Path, n_queries: int, smi: str) -> dict:
    """The ALS batch run of the serving micro-batcher (``batch_predictor``
    on step 1's model) at 4 and 64 queries a batch, p50 ms on the host
    clock, by ``parent``'s package and by this checkout's, each in fresh
    processes, in the order parent, this, this, parent."""
    import os

    here = Path(__file__).resolve().parent
    out = {"parent": [], "change": []}
    for who, root in (("parent", parent), ("change", here), ("change", here),
                      ("parent", parent)):
        r = subprocess.run([sys.executable, "-c", AB_BATCH, str(n_queries)], cwd=root,
                           env={**os.environ, "PYTHONPATH": str(root)},
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{who} batch run failed: {r.stderr[-2000:]}")
        out[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
    for who in ("parent", "change"):
        print(f"  ALS batch run p50, {who}: " + " | ".join(
            ", ".join(f"{b} queries {ms:.3f} ms" for b, ms in run.items())
            for run in out[who]) + f" | {smi}")
    return out


def read_training_ab(chip_smoke, parent: Path, store_root: Path, reads: int = 3) -> dict:
    """``read_training`` through the native scan of step 6's store (no
    snapshot yet) by ``parent``'s package and by this checkout's, each in
    fresh processes, in the order parent, this, this, parent."""
    import os

    here = Path(__file__).resolve().parent
    env = {**os.environ, **chip_smoke.localfs_env(store_root)}
    variant = json.dumps(chip_smoke.engine_variant(False))
    out = {"parent": [], "change": []}
    for who, root in (("parent", parent), ("change", here), ("change", here),
                      ("parent", parent)):
        r = subprocess.run([sys.executable, "-c", AB_READ, variant, str(reads)],
                           cwd=root, env={**env, "PYTHONPATH": str(root)},
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{who} read failed: {r.stderr[-2000:]}")
        out[who].append(json.loads(r.stdout.strip().splitlines()[-1]))
    fmt = lambda runs: " | ".join(", ".join(f"{x:.3f}" for x in xs) for xs in runs)  # noqa: E731
    print(f"  read_training through the native scan, fresh processes in the order parent, "
          f"change, change, parent: parent {fmt(out['parent'])} s; change "
          f"{fmt(out['change'])} s")
    return out


def delete_liveness(store, app_id, ids, n_items, n_p, n_v) -> dict:
    """``delete``'s check that an id is live, for the first, the middle
    and the last view event of the log: the byte search against the full
    parse (the JAX package's ``delete``: every line parsed up to the id)."""
    fs = store.l_events
    out = {}
    for name, row in (("first", n_items + n_p), ("middle", n_items + n_p + n_v // 2),
                      ("last", n_items + n_p + n_v - 1)):
        eid = bytes(ids.blob[ids.offs[row]:ids.offs[row + 1]]).decode()
        t0 = time.perf_counter()
        live = fs._is_live(eid, app_id, None)
        search = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = any(e.event_id == eid for e in fs._iter_raw(app_id, None))
        full = time.perf_counter() - t0
        if not (live and parsed):
            raise RuntimeError(f"event {eid} (row {row}) not found live")
        out[name] = {"row": row, "byte_search_s": search, "full_parse_s": full}
    return out


def profile_snapshot(chip_smoke, store, ep, workdir) -> dict:
    """Step 7: the snapshot's build, its read with either header parse,
    the tail scan, the $set fold and read_training from it."""
    import os

    from predictionio_tpu_torch.models import universal_recommender as ur
    from predictionio_tpu_torch.native import core as ncore
    from predictionio_tpu_torch.storage import snapshot as snap
    from predictionio_tpu_torch.store.columnar import fold_properties, read_batch
    from predictionio_tpu_torch.store.event_store import invalidate_staging_cache

    if ncore.lib() is None:   # built here, outside the timings
        raise RuntimeError("the native scan core did not build")
    app_id = store.apps.get_by_name("smoke").id
    chan = store.l_events._chan_dir(app_id, None)
    t = {}
    t0 = time.perf_counter()
    stats = store.l_events.build_snapshot(app_id)
    t["build_s"] = time.perf_counter() - t0
    path = chan / snap.SNAP_DIR / stats["snapshot"]
    t["bytes"] = path.stat().st_size

    def touch(batch):
        # decode every dictionary and page every column in
        total = sum(int(getattr(batch, c).sum()) for c in ("entity_ids", "target_ids", "times_us"))
        for d in (batch.event_dict, batch.entity_type_dict, batch.entity_dict, batch.target_dict):
            d.strings()
        for col in (batch.prop_columns or {}).values():
            col.dict.strings()
            total += int(col.rows.sum()) + int(col.codes.sum())
        return total

    for native in ("on", "off"):
        os.environ["PIO_NATIVE"] = native
        alone, touched = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            batch, ids, _meta = read_batch(path)
            alone.append(time.perf_counter() - t0)
            touch(batch)
            touched.append(time.perf_counter() - t0)
        t[f"read_batch_native_{native}_s"] = alone
        t[f"read_batch_native_{native}_touched_s"] = touched
    os.environ.pop("PIO_NATIVE")
    m = snap.load_manifest(chan)
    n_tail = sum(chip_smoke.SNAP_TAIL)
    rng = np.random.default_rng(chip_smoke.SEED + 7)
    n_users, n_items = chip_smoke.DEPLOYED_UR[:2]
    tail = [(name, rng.integers(0, n_users, n).astype(np.int32),
             (rng.zipf(1.3, n) % n_items).astype(np.int32),
             chip_smoke.T0 + 2e6 + np.arange(n, dtype=np.float64))
            for name, n in zip(("purchase", "view"), chip_smoke.SNAP_TAIL)]
    with open(workdir / "tail.jsonl", "w") as f:
        chip_smoke.write_interactions(f, tail)
    chip_smoke.pio("import", "--app-name", "smoke", "--input", str(workdir / "tail.jsonl"))
    tails = []
    for _ in range(3):
        base, _ids, _meta = read_batch(path)
        t0 = time.perf_counter()
        res = snap.scan_tail(chan, m["covered"], set(), base=base, heads=m["heads"])
        tails.append(time.perf_counter() - t0)
        if res["events"] != n_tail:
            raise RuntimeError(f"scan_tail read {res['events']} events, not {n_tail}")
    t["scan_tail_s"] = tails
    _batch, ids, _meta = read_batch(path)
    picks = rng.choice(np.arange(len(ids) // 2, len(ids)), chip_smoke.SNAP_DELETES, replace=False)
    dead = {bytes(ids.blob[ids.offs[r]:ids.offs[r + 1]]).decode() for r in picks.tolist()}
    ids.tolist()   # the blob paged in before either lookup
    t0 = time.perf_counter()
    by_index_of = sorted(ids.index_of(e) for e in dead)
    t["tombstone_index_of_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_rows_of = sorted(ids.rows_of(dead))
    t["tombstone_rows_of_s"] = time.perf_counter() - t0
    if by_index_of != by_rows_of or by_rows_of != sorted(picks.tolist()):
        raise RuntimeError("rows_of and index_of disagree")
    n_p, n_v = chip_smoke.DEPLOYED_UR[2:4]
    t["delete_liveness"] = delete_liveness(store, app_id, ids, n_items, n_p, n_v)
    res = store.l_events.snapshot_scan(app_id)
    t0 = time.perf_counter()
    folded = fold_properties(res["batch"], "item")
    t["fold_s"] = time.perf_counter() - t0
    invalidate_staging_cache()
    t0 = time.perf_counter()
    ur.URDataSource(ep.data_source_params).read_training()
    t["read_training_s"] = time.perf_counter() - t0
    invalidate_staging_cache()
    t.update(events=stats["events"], tail_events=n_tail, folded_items=len(folded))
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)  # noqa: E731
    print(f"  snapshot: build {t['build_s']:.3f} s ({stats['events']} events, {t['bytes']} "
          f"bytes); read_batch with the native header parse {fmt(t['read_batch_native_on_s'])} "
          f"s (decoded and paged in {fmt(t['read_batch_native_on_touched_s'])}), with the "
          f"Python one {fmt(t['read_batch_native_off_s'])} s (decoded and paged in "
          f"{fmt(t['read_batch_native_off_touched_s'])}); scan_tail of {n_tail} events "
          f"{fmt(tails)} s; {len(dead)} tombstoned ids found by index_of "
          f"{t['tombstone_index_of_s']:.3f} s, by rows_of {t['tombstone_rows_of_s']:.3f} s; "
          f"$set fold {t['fold_s']:.3f} s; read_training from the snapshot "
          f"and its tail {t['read_training_s']:.3f} s (host work; {os.cpu_count()} CPUs)")
    print("  delete's liveness check, byte search against the full parse: " + "; ".join(
        f"{k} view event (row {v['row']}) {v['byte_search_s']:.4f} s against "
        f"{v['full_parse_s']:.3f} s" for k, v in t["delete_liveness"].items()))
    return t


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=200)
    ap.add_argument("--only", choices=("als", "k1", "store"), default=None)
    ap.add_argument("--ab-parent", type=Path, default=None,
                    help="with --only store or --only als: a checkout of another "
                         "commit whose native-scan read_training (store) or ALS "
                         "batch run (als) runs beside this one's")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import chip_smoke
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    out = {"card": smi}
    if args.only in (None, "als"):
        out["als_serving"] = profile_als_serving(chip_smoke, args.queries)
    if args.only == "als" and args.ab_parent is not None:
        out["als_batch_ab"] = als_batch_ab(args.ab_parent, args.queries, smi)
    if args.only == "k1":
        out["k1"] = profile_k1(chip_smoke, smi)
    if args.only == "store":
        out["store"] = profile_store(chip_smoke, smi, args.ab_parent)
    print(json.dumps(out))
    return 0


def profile_als_serving(chip_smoke, n_queries: int) -> dict:
    """Steps 1-3: ALS serving latency, per-query stages, profiler window."""
    from predictionio_tpu_torch.controller import EngineParams
    from predictionio_tpu_torch.models import recommendation as reco
    from predictionio_tpu_torch.ops import als as als_ops
    from predictionio_tpu_torch.ops.hopper_kernels import masked_score_matmul
    from predictionio_tpu_torch.ops.topk import topk_desc

    rng = np.random.default_rng(chip_smoke.SEED)
    model = reco.als_model_from_state(chip_smoke.make_state(rng), device="cuda")
    engine = reco.RecommendationEngine.apply()
    ep = EngineParams(algorithm_params_list=[("als", reco.ALSAlgorithmParams())])
    predict = engine.predictor(ep, [model])
    predict_batch = engine.batch_predictor(ep, [model])
    qs = [reco.RecoQuery.from_json(b) for b in chip_smoke.queries(rng, n_queries)]
    t0 = time.perf_counter()
    predict(qs[0])
    first_ms = (time.perf_counter() - t0) * 1e3
    for q in qs[:20]:
        predict(q)
    predict_batch(qs[:64])

    # 1. end-to-end library latency
    lat = []
    for q in qs:
        t0 = time.perf_counter()
        predict(q)
        lat.append((time.perf_counter() - t0) * 1e3)
    batch = []
    for s in range(0, len(qs) - 63, 64):
        t0 = time.perf_counter()
        predict_batch(qs[s:s + 64])
        batch.append((time.perf_counter() - t0) * 1e3)

    # 2. stages of one query, each ended by a synchronize
    algo = reco.ALSAlgorithm()
    stages = {k: [] for k in ("mask", "kernel", "topk", "readback", "assemble")}
    for q in qs:
        uid = model.user_dict.id(q.user)
        k = algo._k_bucket(min(q.num, len(model.item_factors)), len(model.item_factors))
        excl = als_ops.pad_ids(algo._exclusions(model, q, uid))
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        mask = als_ops.exclusion_mask(excl[None], len(model.item_factors), model.device)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        scores = masked_score_matmul(model.user_factors_device()[uid][None],
                                     model.item_factors_device(), mask)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        stacked = als_ops._stack_topk(*topk_desc(scores, k))
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        out = stacked.cpu().numpy()
        t.append(time.perf_counter())
        [(model.item_dict.str(int(i)), float(s)) for s, i in zip(out[0, 0], out[0, 1])]
        t.append(time.perf_counter())
        for name, a, b in zip(stages, t, t[1:]):
            stages[name].append((b - a) * 1e3)

    # 3. profiler window: device busy share and kernel time by name
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for q in qs:
            predict(q)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    top, busy_us = _device_kernels(prof, len(qs))
    return {"first_query_ms": first_ms,
            "predict_ms": _ms(lat), "batch64_ms": _ms(batch),
            "stages_ms": {k: _ms(v) for k, v in stages.items()},
            "profiler": {"queries": len(qs), "wall_ms": wall_us / 1e3,
                         "device_busy_ms": busy_us / 1e3,
                         "device_busy_share": busy_us / wall_us if wall_us else None,
                         "kernels_us_per_query": top}}


if __name__ == "__main__":
    sys.exit(main())

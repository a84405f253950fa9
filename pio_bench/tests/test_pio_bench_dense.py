"""The dense route's cell ``ur_train.catalog8k``: its configuration, the
dense work counted from its shapes (``dense_counts.py``), the device
extents of the program's ``cco.dense`` ranges (``dense_ranges.py``) and the
three readers of them, on a trace made by hand, and a small copy of the
cell run through the harness on the CPU."""

import json
import shutil
import types
from pathlib import Path

import pytest

from conftest import make_root
from pio_bench import counts, dense_counts, dense_ranges, harness, trace
from predictionio_tpu_torch.ops import cco
from predictionio_tpu_torch.utils import tracing
from test_pio_bench_trace import MS, read

ROOT = Path(__file__).resolve().parents[2]
CELL = "ur_train.catalog8k"
READERS = ("cco_dense_roofline_pct", "cco_dense_idle_pct", "ur_outside_dense_ms")


def config(name="ur_catalog8k"):
    return json.loads((ROOT / f"pio_bench/configs/{name}.json").read_text())


def test_the_configuration_keeps_the_log_s_users_and_behaviours():
    cfg = config()
    src = cfg["source_stats"]
    assert cfg["reduced"] == ["items"] and cfg["items"] == 8192 < src["items"]
    assert cfg["users"] == src["users"] == 987_994
    assert [(t["name"], t["source_event"]) for t in cfg["event_types"]] == [
        ("purchase", "buy"), ("view", "pv"), ("cart", "cart"), ("fav", "fav")]
    for et in cfg["event_types"]:
        assert et["events"] == src["events"][et["source_event"]] and et["zipf_s"] == 0.871
    assert counts.events_per_train(cfg) == sum(src["events"].values()) == 100_150_807
    assert cfg["strategy"] == "auto" and set(cfg["assumed"]) >= {"users", "event_types",
                                                                  "items"}


# (users, items, users a chunk, U_pad, chunk passes a train of two types)
CHUNKS = [
    # (200 + 256) * 2 bytes a user: one chunk, 700 users rounded up to 256s
    (700, 200, 768, 768, 2),
    # (8,192 + 8,192) * 2: 32,768 users a chunk at most, so 4 chunks of
    # 25,000 rounded up to 25,088
    (100_000, 8192, 25_088, 100_352, 8),
    # the cell's: 31 chunks of 31,871 rounded up to 32,000
    (987_994, 8192, 32_000, 992_000, 62),
]


@pytest.mark.parametrize("users,items,chunk,u_pad,passes", CHUNKS)
def test_the_chunk_rule_by_hand(users, items, chunk, u_pad, passes):
    cfg = {"users": users, "items": items,
           "event_types": [{"name": "p", "events": 1}, {"name": "v", "events": 1}]}
    assert dense_counts.chunk_users(cfg) == chunk
    assert dense_counts.padded_users(cfg) == u_pad
    assert u_pad // chunk * len(cfg["event_types"]) == passes


def test_the_counts_of_a_small_shape_by_hand():
    cfg = {"users": 700, "items": 200,
           "event_types": [{"name": "p", "events": 1}, {"name": "v", "events": 1}]}
    # the primary against itself at its own width; the other type at 256
    assert dense_counts.type_shapes(cfg) == [("p", 200, 200, True), ("v", 200, 256, False)]
    assert dense_counts.ops_per_type(cfg) == [2 * 768 * 200 * 200, 2 * 768 * 200 * 256]
    assert dense_counts.bytes_per_type(cfg) == [768 * 200 + 4 * 200 * 200,
                                                768 * (200 + 256) + 4 * 200 * 256]
    # the bytes bound both types at this width: under 200 operations a
    # byte, where the card's peaks balance at 591
    want = sum(max(o / 1979e12, b / 3.35e12) for o, b in
               zip(dense_counts.ops_per_type(cfg), dense_counts.bytes_per_type(cfg)))
    assert dense_counts.bound_s_per_train(cfg) == pytest.approx(want)
    assert want == pytest.approx((768 * 200 + 4 * 200 * 200) / 3.35e12
                                 + (768 * 456 + 4 * 200 * 256) / 3.35e12)


def test_the_cell_s_dense_work_by_hand():
    cfg = config()
    ops = 2 * 992_000 * 8192 * 8192
    assert dense_counts.ops_per_type(cfg) == [ops] * 4
    assert dense_counts.bytes_per_type(cfg) == [992_000 * 8192 + 4 * 8192**2] + \
        [992_000 * 16_384 + 4 * 8192**2] * 3
    # 31 chunks of 32,000 users a type: the program's dense_chunks a train
    assert dense_counts.padded_users(cfg) // dense_counts.chunk_users(cfg) * 4 == 124
    # the operations bound every type: 4 x 67.3 ms at the int8 peak
    assert dense_counts.bound_s_per_train(cfg) == pytest.approx(4 * ops / 1979e12)


def op(name, start, end, cls="other"):
    return trace.DeviceOp(name, start * MS, end * MS, cls=cls)


#: two trains of two types, 100 ms: the primary's staging before the first
#: range; range 2's launches queued behind range 1's K3 and idle for 2 ms
#: inside; between ranges 3 and 4 the card idle for 3 ms; readbacks after
OPS = [
    op("stage", 1, 3), op("product", 5, 15), op("topk", 15, 20, "k3"),
    op("Memcpy HtoD", 21, 22), op("product", 24, 30), op("topk", 30, 32, "k3"),
    op("Memcpy DtoH", 33, 35),
    op("product", 52, 60), op("topk", 60, 62, "k3"),
    op("product", 65, 70), op("topk", 70, 75, "k3"), op("Memcpy DtoH", 80, 85),
]
#: the program's spans: a warm-up range before the window, four in it
KEPT = [
    (-10 * MS, -5 * MS, "cco.dense"), (0, 40 * MS, "ur.train"),
    (4 * MS, 6 * MS, "cco.dense"), (7 * MS, 9 * MS, "cco.dense"),
    (33 * MS, 36 * MS, "cco.finalize"),
    (45 * MS, 95 * MS, "ur.train"), (50 * MS, 51 * MS, "cco.dense"),
    (52 * MS, 53 * MS, "cco.dense"), (80 * MS, 86 * MS, "cco.finalize"),
]
CFG = {"users": 700, "items": 200, "top_k": 8,
       "event_types": [{"name": "p", "events": 10}, {"name": "v", "events": 20}]}


def ctx_with(monkeypatch, kept, steps=2, ops=OPS):
    monkeypatch.setattr(tracing, "recent_spans", lambda: list(kept))
    tr = trace.Trace((0, 100 * MS), list(ops), [])
    return types.SimpleNamespace(cfg=CFG, trace=tr, steps=steps, window_s=0.1)


def test_the_ranges_device_extents(monkeypatch):
    ctx = ctx_with(monkeypatch, KEPT)
    assert dense_ranges.extents(ctx.trace) == [
        (5 * MS, 20 * MS), (21 * MS, 32 * MS), (52 * MS, 62 * MS), (65 * MS, 75 * MS)]
    # the staging's 2 ms, then 3 of range 2's and 1 of the readback's
    assert dense_ranges.busy_ns(ctx.trace, [(0, 4 * MS), (29 * MS, 34 * MS)]) == 6 * MS


def test_the_readers_on_the_trace(monkeypatch):
    ctx = ctx_with(monkeypatch, KEPT)
    spent = (15 + 11 + 10 + 10) / 1e3
    assert read("cco_dense_roofline_pct", ctx) == pytest.approx(
        100 * 2 * dense_counts.bound_s_per_train(CFG) / spent)
    # 2 of the ranges' 46 ms idle: the gap at [22, 24] ms inside range 2
    assert read("cco_dense_idle_pct", ctx) == pytest.approx(100 * 2 / 46)
    # (100 - 46) ms outside the ranges over two trains
    assert read("ur_outside_dense_ms", ctx) == pytest.approx(27.0)


def test_the_readers_find_nothing_without_the_ranges(monkeypatch):
    no_trace = types.SimpleNamespace(cfg=CFG, trace=None, steps=2, window_s=0.1)
    without = [s for s in KEPT if s[2] != "cco.dense"]
    for name in READERS:
        assert read(name, no_trace) is None
        # a program with no cco.dense span, as the parent of the span had
        assert read(name, ctx_with(monkeypatch, without)) is None
        # only the warm-up's range, before the window
        assert read(name, ctx_with(monkeypatch, KEPT[:2])) is None
        # a range for every type of three trains is not in the window
        assert read(name, ctx_with(monkeypatch, KEPT, steps=3)) is None
        # the window ends before the last range's K3
        assert read(name, ctx_with(monkeypatch, KEPT, ops=OPS[:-2])) is None
    monkeypatch.delattr(tracing, "recent_spans")
    tr = trace.Trace((0, 100 * MS), list(OPS), [])
    for name in READERS:
        assert read(name, types.SimpleNamespace(cfg=CFG, trace=tr, steps=2,
                                                window_s=0.1)) is None


def test_the_cell_loads_with_its_three_metrics_of_each_kind():
    cell = harness.Cell(ROOT, CELL)
    assert cell.cfg["name"] == "ur_catalog8k" and cell.traffic["entry"] == "ur_train"
    assert cell.cell["chips"] == 1
    assert [m["name"] for m in cell.metrics(False)] == [
        "train_events_per_s", "train_peak_gib", "setup_s"]
    assert [m["name"] for m in cell.metrics(True)] == list(READERS)
    assert set(cell.limits) == {"score_err", "rank_gap", "entries_mismatch",
                                "popularity_err", "seen_mismatch"}
    for name in ("entries_mismatch", "popularity_err", "seen_mismatch"):
        assert cell.limits[name]["limit"] == 0
    for other in ("ur_train.catalog100k", "cco_scale.catalog131k"):
        assert not set(READERS) & {m["name"] for m in harness.Cell(ROOT, other).metrics(True)}


def test_a_small_copy_of_the_cell_trains_on_the_dense_route_on_the_cpu(tmp_path, monkeypatch):
    """The cell's four types at a small size through the harness, on the
    CPU with the host sparse runner off, as the card chooses: correct, and
    every train of the window and the warm-up takes the dense route."""
    root = make_root(tmp_path)
    cfg = config()
    cfg.update(name="small_ur8k", users=900, items=300)
    for et in cfg["event_types"]:
        et["events"] = round(et["events"] * 900 / 987_994) + 200
    (root / "pio_bench/configs/small_ur8k.json").write_text(json.dumps(cfg))
    shutil.copy(root / f"pio_bench/limits/{CELL}.json",
                root / "pio_bench/limits/small.ur8k.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "small_ur8k", "source": "tests",
                            "file": "pio_bench/configs/small_ur8k.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "small.ur8k", "config": "small_ur8k",
                              "traffic": "ur_train", "chips": 1, "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    monkeypatch.delenv("PIO_CCO_DENSE", raising=False)
    cco.reset_strategy_counts()
    result, _ = harness.run(root, "small.ur8k", 2**31 + 11, 0.3, False, device="cpu")
    assert result["correct"] is True and result["attempted"] >= 1
    trains = result["attempted"] + 1
    assert cco.strategy_by_type == {"dense": 4 * trains, "resident": 0, "chunked": 0,
                                    "sparse": 0}
    assert cco.dense_chunks == 4 * trains
    assert set(result["checks"]) == {"score_err", "rank_gap", "entries_mismatch",
                                     "popularity_err", "seen_mismatch"}

"""The program's spans in a traced run (``spans.py``) and the two readers
of them, on the hand-made trace of ``test_pio_bench_trace.py`` with the
program's ranges added, and through the harness on the CPU."""

import types
from pathlib import Path

import pytest

from pio_bench import spans, trace
from predictionio_tpu_torch.utils import tracing
from test_pio_bench_trace import MS, Ev, events, read

ROOT = Path(__file__).resolve().parents[2]
READERS = ("device_idle_pct.train", "cco_other_device_ms", "train_mfu_pct",
           "count_product_roofline_pct", "k2_roofline_pct", "k3_roofline_pct")
CFG = {"users": 20, "items": 100, "top_k": 10, "event_types": [{"name": "a", "events": 50}]}


def with_ranges():
    """``events()`` plus the program's ranges on the host's timeline and
    their copies on the device's: ``cco.stage`` holds the middle of the
    window's first gap, which no operator explains."""
    return events() + [
        Ev("ur.train", 0, 100 * MS, annotation=True),
        Ev("cco.train", 1 * MS, 99 * MS, annotation=True),
        Ev("cco.stage", 2 * MS, 9 * MS, annotation=True),
        Ev("cco.stage", 3 * MS, 8 * MS, cuda=True, annotation=True),
        Ev("ur.train", 10 * MS, 70 * MS, cuda=True, annotation=True),
    ]


def test_ranges_name_a_gap_and_leave_the_device_work_as_it_was():
    plain, tr = trace.from_events(events()), trace.from_events(with_ranges())
    assert [(o.name, o.start_ns, o.end_ns, o.cls) for o in tr.ops] == \
        [(o.name, o.start_ns, o.end_ns, o.cls) for o in plain.ops]
    assert tr.busy_s == plain.busy_s and tr.idle_gaps() == plain.idle_gaps()
    got = spans.ranges(with_ranges(), tr.window_ns)
    assert got == [(0, 100 * MS, "ur.train"), (1 * MS, 99 * MS, "cco.train"),
                   (2 * MS, 9 * MS, "cco.stage")]
    labels = {label: (ge - gs) / 1e9 for gs, ge, label in spans.label_gaps(tr, got)}
    assert labels == {"span cco.stage": pytest.approx(0.010),
                      "host aten::copy_": pytest.approx(0.010),
                      "host aten::nonzero": pytest.approx(0.030)}
    assert spans.label_gaps(tr, []) == tr.idle_gaps()


@pytest.mark.parametrize("name", READERS)
def test_existing_readers_read_the_same_with_the_ranges(name):
    def value(evs):
        ctx = types.SimpleNamespace(cfg=CFG, trace=trace.from_events(evs), steps=2,
                                    window_s=0.1)
        return read(name, ctx)

    assert value(with_ranges()) == value(events())


#: two trains' spans as the program keeps them, and one from the warm-up
#: before the window
KEPT = [
    (-50 * MS, -1 * MS, "ur.train"),
    (5 * MS, 7 * MS, "cco.check_ids"), (6 * MS, 10 * MS, "cco.stage"),
    (10 * MS, 28 * MS, "cco.tiles"), (5 * MS, 30 * MS, "cco.train"), (0, 40 * MS, "ur.train"),
    (50 * MS, 53 * MS, "cco.flatten"), (53 * MS, 58 * MS, "cco.stage"),
    (50 * MS, 80 * MS, "cco.train"), (45 * MS, 95 * MS, "ur.train"),
]


def ctx_with(monkeypatch, kept, steps=2):
    monkeypatch.setattr(tracing, "recent_spans", lambda: list(kept))
    return types.SimpleNamespace(cfg=CFG, trace=trace.from_events(events()), steps=steps,
                                 window_s=0.1)


def test_the_new_readers_read_the_window_s_spans(monkeypatch):
    ctx = ctx_with(monkeypatch, KEPT)
    # (40 - 25) + (50 - 30) ms outside the driver, over two trains
    assert read("ur_engine_host_ms", ctx) == pytest.approx(17.5)
    # [5, 10] and [50, 58] ms: the overlapping check and staging once
    assert read("cco_prep_host_ms", ctx) == pytest.approx(6.5)


def test_the_new_readers_find_nothing_without_spans(monkeypatch):
    for name in ("ur_engine_host_ms", "cco_prep_host_ms"):
        assert read(name, types.SimpleNamespace(cfg={}, trace=None, steps=1,
                                                window_s=1.0)) is None
        assert read(name, ctx_with(monkeypatch, [])) is None
        assert read(name, ctx_with(monkeypatch, KEPT[:1])) is None
    # a program without the record: its parent's
    monkeypatch.delattr(tracing, "recent_spans")
    ctx = types.SimpleNamespace(cfg=CFG, trace=trace.from_events(events()), steps=2,
                                window_s=0.1)
    assert spans.recorded() == []
    assert read("ur_engine_host_ms", ctx) is None and read("cco_prep_host_ms", ctx) is None


@pytest.mark.parametrize("workload,span", [("small.ur", "ur.train"),
                                           ("small.cco", "cco.train")])
def test_a_traced_run_on_the_cpu_reads_the_spans(small_root, workload, span):
    out = spans.traced_run(small_root, workload, 2**31 + 7, 0.3, device="cpu")
    assert out["correct"] is True and out["steps"] >= 1
    m = out["metrics"]
    assert m["cco_prep_host_ms"] > 0
    assert ("ur_engine_host_ms" in m) == (workload == "small.ur")
    mine, theirs = out["spans_per_train"], out["ranges_per_train"]
    assert mine[span][0] == theirs[span][0] == 1
    assert {k: v[0] for k, v in mine.items()} == {k: v[0] for k, v in theirs.items()}
    assert out["device_copies"] == {"n": 0, "unflagged": 0, "counted_as_work": 0}
    assert len(out["step_s"]) == out["steps"]
    # the train's span covers its step but for the harness's own work
    assert mine[span][1] <= out["mean_step_s"] * 1.001

"""The operation and byte counts of the cells' shapes, and the window's
arithmetic, against numbers worked out by hand."""

import json
import time
import types
from pathlib import Path

import pytest

from pio_bench import counts, harness

ROOT = Path(__file__).resolve().parents[2]


def config(name):
    return json.loads((ROOT / f"pio_bench/configs/{name}.json").read_text())


# (config, events a train, dense int8 operations a train, K2 bytes, K3 bytes)
SHAPES = [
    # 2 types x 2 * 100,000 * 100,000 * 100,000; K2 8 bytes a cell + marginals;
    # K3 4 bytes a cell + 50 x 8 bytes a row
    ("ur_catalog100k", 204_034 + 9_080_649, 2 * 2 * 100_000 * 100_000 * 100_000,
     2 * (8 * 10**10 + 4 * 200_000), 2 * (4 * 10**10 + 100_000 * 400)),
    ("cco_catalog131k", 18_161_297, 2 * 200_000 * 131_072**2,
     8 * 131_072**2 + 4 * 2 * 131_072, 4 * 131_072**2 + 131_072 * 400),
]


@pytest.mark.parametrize("name,events,ops,k2,k3", SHAPES)
def test_counts_of_each_shape(name, events, ops, k2, k3):
    cfg = config(name)
    assert counts.events_per_train(cfg) == events
    assert counts.dense_ops_per_train(cfg) == ops
    assert counts.k2_bytes_per_train(cfg) == k2
    assert counts.k3_bytes_per_train(cfg) == k3


def test_the_deployed_width_at_peak():
    # 4.0e15 operations a train: 2.021 s at 1,979 TOP/s
    s = counts.dense_ops_per_train(config("ur_catalog100k")) / counts.INT8_PEAK_OPS
    assert s == pytest.approx(2.02122, rel=1e-4)


def test_count_product_bound():
    # a resident tile: [100,000 x 20,096] x [20,096 x 4,096] is bound by
    # its operations: 1.6464e13 / 1.979e15 s
    assert counts.count_product_bound_s(100_000, 20_096, 4_096) == pytest.approx(
        2 * 100_000 * 20_096 * 4_096 / 1979e12)
    # a thin product is bound by its bytes: 1 + 1 + 4 bytes a cell of 1e8
    assert counts.count_product_bound_s(10_000, 1, 10_000) == pytest.approx(
        (10_000 + 10_000 + 4e8) / 3.35e12)


def test_rate_is_every_event_over_all_the_window():
    read = harness.load_module(ROOT / "pio_bench/metrics/train_events_per_s.py").read
    cfg = {"event_types": [{"events": 600}, {"events": 400}]}
    ctx = types.SimpleNamespace(cfg=cfg, steps=3, window_s=2.5)
    assert read(ctx) == 1_200.0
    assert read(types.SimpleNamespace(cfg=cfg, steps=0, window_s=1.0)) is None


def test_window_runs_whole_steps_until_the_seconds_pass(small_root, monkeypatch):
    """The window runs whole steps until its seconds have passed and
    closes at the end of the last; the rate counts every step's events
    over the whole window."""
    ends = []
    real_cell = harness.Cell

    def cell_with_slow_steps(root, workload):
        c = real_cell(root, workload)
        prepare = c.entry.prepare

        def slow_prepare(*args):
            step = prepare(*args)

            def slow():
                out = step()
                time.sleep(0.05)
                ends.append(time.perf_counter())
                return out
            return slow

        c.entry.prepare = slow_prepare
        return c

    monkeypatch.setattr(harness, "Cell", cell_with_slow_steps)
    seen = {}
    real_read = real_cell.read

    def spy(self, metric, ctx):
        seen["ctx"] = ctx
        return real_read(self, metric, ctx)

    monkeypatch.setattr(real_cell, "read", spy)
    result, _ = harness.run(small_root, "small.ur", 7, 0.3, False, device="cpu")
    ctx = seen["ctx"]
    window = ends[1:]                    # ends[0] is the warm-up step's
    start = window[-1] - ctx.window_s
    assert result["attempted"] == ctx.steps == len(window) >= 2
    assert all(e - start < 0.3 for e in window[:-1])
    assert window[-1] - start >= 0.3
    rate = result["metrics"]["train_events_per_s"]["value"]
    assert rate == pytest.approx(len(window) * 9_000 / ctx.window_s)

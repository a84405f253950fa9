"""The trace's reduction and the per-layer readers, on a trace made by hand
in the shape of the profiler's kineto events."""

import types
from pathlib import Path

import pytest
from torch.autograd import DeviceType

from pio_bench import counts, harness, trace

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000


class Ev:
    def __init__(self, name, start, end, cuda=False, corr=0, linked=0, shapes=(),
                 thread=1, annotation=False):
        self._v = (name, start, end, cuda, corr, linked, list(shapes), thread, annotation)

    def name(self): return self._v[0]
    def start_ns(self): return self._v[1]
    def end_ns(self): return self._v[2]
    def device_type(self): return DeviceType.CUDA if self._v[3] else DeviceType.CPU
    def correlation_id(self): return self._v[4]
    def linked_correlation_id(self): return self._v[5]
    def shapes(self): return self._v[6]
    def start_thread_id(self): return self._v[7]
    def is_user_annotation(self): return self._v[8]


def events():
    """A 100 ms window: a count product of two kernels (one overlapping K2),
    K2, K3, a copy, a step mark and its copy on the device, a profiler event
    that shares the product's correlation id, and work outside the window."""
    return [
        Ev("pio_bench.window", 0, 100 * MS, annotation=True),
        Ev("pio_bench.step", 0, 100 * MS, annotation=True),
        Ev("pio_bench.step", 5 * MS, 95 * MS, cuda=True, annotation=True),
        Ev("aten::_int_mm", 1 * MS, 2 * MS, corr=10, shapes=[[100, 20], [20, 40]]),
        Ev("Buffer Flush", 1 * MS, 1 * MS, corr=10),
        Ev("cudaLaunchKernel", 1 * MS, 2 * MS, corr=99, linked=10),
        Ev("aten::copy_", 60 * MS, 70 * MS, corr=11),
        Ev("aten::nonzero", 75 * MS, 90 * MS, corr=12),
        Ev("gemm_s8_part1", 10 * MS, 30 * MS, cuda=True, linked=10),
        Ev("gemm_s8_part2", 30 * MS, 40 * MS, cuda=True, linked=10),
        Ev("(anonymous namespace)::llr_masked_kernel(int const*)", 35 * MS, 50 * MS,
           cuda=True),
        Ev("void (anonymous namespace)::tile_topk_kernel<2>(float const*)", 50 * MS,
           55 * MS, cuda=True),
        Ev("Memcpy HtoD (Pageable -> Device)", 65 * MS, 70 * MS, cuda=True, linked=11),
        Ev("late_kernel", 150 * MS, 160 * MS, cuda=True),
    ]


def test_reduction_of_a_trace():
    tr = trace.from_events(events())
    assert tr.window_s == pytest.approx(0.1)
    assert [o.cls for o in tr.ops] == ["count_product", "count_product", "k2", "k3", "other"]
    # busy: [10, 55] and [65, 70] ms, the overlap of the product and K2 once
    assert tr.busy_s == pytest.approx(0.050)
    assert tr.class_s("count_product") == pytest.approx(0.030)
    assert tr.class_s("k2") == pytest.approx(0.015)
    assert tr.count_product_launches() == [([[100, 20], [20, 40]], pytest.approx(0.030))]
    gaps = {label: (ge - gs) / 1e9 for gs, ge, label in tr.idle_gaps()}
    assert gaps == {
        "untraced host work before gemm_s8_part1": pytest.approx(0.010),
        "host aten::copy_": pytest.approx(0.010),
        "host aten::nonzero": pytest.approx(0.030),
    }
    b = tr.breakdown()
    assert b["device_ops"][0] == ["gemm_s8_part1", pytest.approx(0.020)]
    assert b["idle_gaps"][0] == ["host aten::nonzero", pytest.approx(0.030)]


def read(name, ctx):
    return harness.load_module(ROOT / f"pio_bench/metrics/{name}.py").read(ctx)


def test_per_layer_readers_on_the_trace():
    tr = trace.from_events(events())
    cfg = {"users": 20, "items": 100, "top_k": 10,
           "event_types": [{"name": "a", "events": 50}]}
    ctx = types.SimpleNamespace(cfg=cfg, trace=tr, steps=2, window_s=0.1)
    assert read("device_idle_pct.train", ctx) == pytest.approx(50.0)
    assert read("cco_other_device_ms", ctx) == pytest.approx(2.5)
    ops = 2 * 2 * 20 * 100 * 100
    assert read("train_mfu_pct", ctx) == pytest.approx(100 * ops / (0.1 * 1979e12))
    bound = counts.count_product_bound_s(100, 20, 40)
    # the call's 2*100*20*40 operations are fewer than the two trains'
    # dense 2*2*20*100*100, so its bound is not scaled down
    assert read("count_product_roofline_pct", ctx) == pytest.approx(100 * bound / 0.030)
    k2 = 2 * counts.k2_bytes_per_train(cfg) / 3.35e12
    assert read("k2_roofline_pct", ctx) == pytest.approx(100 * k2 / 0.015)
    k3 = 2 * counts.k3_bytes_per_train(cfg) / 3.35e12
    assert read("k3_roofline_pct", ctx) == pytest.approx(100 * k3 / 0.005)


def test_readers_find_nothing_without_a_trace():
    ctx = types.SimpleNamespace(cfg={}, trace=None, steps=1, window_s=1.0)
    for name in ("device_idle_pct.train", "cco_other_device_ms", "train_mfu_pct",
                 "count_product_roofline_pct", "k2_roofline_pct", "k3_roofline_pct"):
        assert read(name, ctx) is None

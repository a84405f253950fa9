"""The small cells through the whole harness on the card: set-up, window,
trace, readers and check.  Skips without a card (decided in the fixture).

    python -m pytest pio_bench/tests -m cuda
"""

import pytest

from pio_bench import harness

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("workload", ["small.ur", "small.cco"])
def test_small_cells_on_the_card(small_root, card, workload):
    plain, _ = harness.run(small_root, workload, 3, 0.5, False, device=card)
    assert plain["correct"] is True, plain["checks"]
    assert {"train_events_per_s", "train_peak_gib", "setup_s"} <= set(plain["metrics"])
    traced, _ = harness.run(small_root, workload, 4, 0.5, True, device=card)
    assert traced["correct"] is True, traced["checks"]
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    assert {"train_mfu_pct", "count_product_roofline_pct", "k2_roofline_pct",
            "k3_roofline_pct", "cco_other_device_ms", "device_idle_pct.train"} <= set(m)
    for name in ("train_mfu_pct", "count_product_roofline_pct", "k2_roofline_pct",
                 "k3_roofline_pct"):
        assert 0 < m[name] <= 105, (name, m[name])
    assert len(traced["breakdown"]["device_ops"]) <= 10

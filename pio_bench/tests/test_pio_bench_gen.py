"""The event generator's popularity law, and each configuration's event
counts against the published statistics of its source."""

import json
from pathlib import Path

import numpy as np
import pytest

from pio_bench import gen

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = sorted(p.stem for p in (ROOT / "pio_bench/configs").glob("*.json"))


def small(items=40, events=400_000, s=0.871):
    cfg = {"users": 1000, "items": items,
           "event_types": [{"name": "a", "events": events, "zipf_s": s},
                           {"name": "b", "events": events // 4, "zipf_s": s}]}
    return cfg, {"batch": 150_000}


def test_items_follow_the_rank_law_truncated_to_the_catalog():
    cfg, traffic = small()
    ev = gen.make_events(cfg, traffic, 2**40 + 7)["a"]
    assert ev.user.min() >= 0 and ev.user.max() < cfg["users"]
    assert ev.item.min() >= 0 and ev.item.max() < cfg["items"]
    catalog = gen.rng(2**40 + 7, gen.CATALOG_STREAM).permutation(cfg["items"])
    freq = np.bincount(ev.item, minlength=cfg["items"])[catalog] / len(ev.item)
    ranks = np.arange(1, cfg["items"] + 1, dtype=np.float64)
    want = ranks ** -0.871 / (ranks ** -0.871).sum()
    # 400,000 draws: the least share (0.85%) is ~3,400 draws, 1.7% its sd
    np.testing.assert_allclose(freq, want, rtol=0.06)


def test_event_types_share_the_catalogs_popular_items():
    cfg, traffic = small()
    ev = gen.make_events(cfg, traffic, -3)
    tops = {int(np.bincount(ev[n].item, minlength=cfg["items"]).argmax()) for n in "ab"}
    assert tops == {int(gen.rng(-3, gen.CATALOG_STREAM).permutation(cfg["items"])[0])}


def test_the_same_seed_gives_the_same_arrays():
    cfg, traffic = small(events=10_000)
    one, two = (gen.make_events(cfg, dict(traffic, time_span_s=60), 2**33) for _ in range(2))
    for n in one:
        for field in ("user", "item", "time"):
            assert np.array_equal(getattr(one[n], field), getattr(two[n], field))


@pytest.mark.parametrize("name", CONFIGS)
def test_event_counts_are_the_sources_per_user_rates(name):
    cfg = json.loads((ROOT / f"pio_bench/configs/{name}.json").read_text())
    src = cfg["source_stats"]
    assert set(cfg["reduced"]) == {"users", "items", "event_types"}
    assert cfg["users"] < src["users"] and cfg["items"] < src["items"]
    for et in cfg["event_types"]:
        per_user = src["events"][et["source_event"]] / src["users"]
        assert et["events"] == round(cfg["users"] * per_user)
    assert sum(src["events"].values()) == 100_150_807

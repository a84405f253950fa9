"""Fixtures of the benchmark's tests: a checkout-like root that holds a copy
of the benchmark with small cells added, for runs on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: small cells, one a traffic mix: (workload, config, traffic, limits copied from)
SMALL = {
    "small.ur": ("small_ur", "ur_train", "ur_train.catalog100k"),
    "small.cco": ("small_cco", "cco_scale", "cco_scale.catalog131k"),
}


def small_configs():
    ur = json.loads((ROOT / "pio_bench/configs/ur_catalog100k.json").read_text())
    ur.update(name="small_ur", users=300, items=500, item_tile=128, top_k=10,
              event_types=[{"name": "purchase", "events": 3000, "zipf_s": 0.871},
                           {"name": "view", "events": 6000, "zipf_s": 0.871}])
    cco = json.loads((ROOT / "pio_bench/configs/cco_catalog131k.json").read_text())
    cco.update(name="small_cco", users=400, items=700, item_tile=128, user_block=64,
               top_k=10, event_types=[{"name": "interaction", "events": 20000,
                                       "zipf_s": 0.871}])
    return {"small_ur": ur, "small_cco": cco}


def make_root(dest: Path) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``pio_bench/`` as the repo
    has them, plus the small cells with their configs and limits."""
    shutil.copytree(ROOT / "pio_bench", dest / "pio_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for name, cfg in small_configs().items():
        (dest / f"pio_bench/configs/{name}.json").write_text(json.dumps(cfg))
        spec["configs"].append({"name": name, "source": "a small copy for tests",
                                "file": f"pio_bench/configs/{name}.json",
                                "reduced": [], "why": "tests"})
    for workload, (config, traffic, limits) in SMALL.items():
        spec["workloads"].append({"name": workload, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "tests"})
        shutil.copy(dest / f"pio_bench/limits/{limits}.json",
                    dest / f"pio_bench/limits/{workload}.json")
    for m in spec["per_layer"]:
        m["workloads"] += list(SMALL)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture()
def small_root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture()
def card():
    """The CUDA card, or a skip: decided here, when a test runs."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"

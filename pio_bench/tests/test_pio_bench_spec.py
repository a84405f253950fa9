"""BENCHMARK.json against the contract, and the harness finding every piece
by name, including pieces a later change adds as new files alone."""

import json
import re
from pathlib import Path

import pytest

from pio_bench import harness

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["pio_bench"]
    assert SPEC["command"][1] == "pio_bench/run.py"
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (ROOT / c["file"]).is_file()
        assert c["file"].startswith("pio_bench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    assert len({(w["config"], w["traffic"]) for w in SPEC["workloads"]}) == len(CELLS)
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("workload", CELLS)
def test_harness_finds_each_piece_by_name(workload):
    cell = harness.Cell(ROOT, workload)
    assert cell.cfg["name"] == cell.cell["config"]
    assert callable(cell.entry.prepare)
    assert callable(cell.reference) and callable(cell.compare)
    assert {"score_err", "rank_gap", "entries_mismatch"} <= set(cell.limits)
    for traced in (False, True):
        metrics = cell.metrics(traced)
        assert metrics
        for m in metrics:
            path = ROOT / "pio_bench/metrics" / f"{m['name']}.py"
            assert callable(harness.load_module(path).read)
    assert "setup_s" in {m["name"] for m in cell.metrics(False)}


def test_every_metric_file_is_named_in_the_spec():
    files = {p.stem for p in (ROOT / "pio_bench/metrics").glob("*.py")}
    assert files == {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}


def test_a_new_cell_config_traffic_and_metric_are_files_alone(small_root):
    """A later change adds a configuration, a traffic mix, a metric and a
    cell as new files and entries; the harness runs it unedited."""
    root = small_root
    b = root / "pio_bench"
    cfg = json.loads((b / "configs/small_ur.json").read_text())
    cfg.update(name="throwaway_ur", users=200, items=300)
    (b / "configs/throwaway_ur.json").write_text(json.dumps(cfg))
    traffic = json.loads((b / "traffic/ur_train.json").read_text())
    traffic["check"].update(rows=16, any_rows=8)
    (b / "traffic/throwaway_mix.json").write_text(json.dumps(traffic))
    (b / "metrics/throwaway_steps.py").write_text("def read(ctx):\n    return ctx.steps\n")
    (b / "limits/throwaway.cell.json").write_text(
        (b / "limits/ur_train.catalog100k.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway_ur", "source": "tests",
                            "file": "pio_bench/configs/throwaway_ur.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": "throwaway.cell", "config": "throwaway_ur",
                              "traffic": "throwaway_mix", "chips": 1, "why": "tests"})
    spec["end_to_end"].append({"name": "throwaway_steps", "unit": "steps",
                               "better": "higher", "bound": 0.05, "source": "host_clock",
                               "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    result, lines = harness.run(root, "throwaway.cell", 5, 0.2, False, device="cpu")
    assert result["correct"] is True
    assert result["metrics"]["throwaway_steps"]["value"] == result["attempted"] >= 1
    assert set(result["metrics"]) == {"train_events_per_s", "setup_s", "throwaway_steps"}
    assert list(result)[-1] == "checks" and len(lines) == len(result["checks"]) + 1

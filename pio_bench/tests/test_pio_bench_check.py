"""The comparison that decides ``correct``: sound runs pass, and a run
with the timed path broken underneath, or the reference in bfloat16 in the
program's place (the control), fails.

The runs skip the harness's look for a card and drive the rest of a run on
the CPU, on the small cells.  The faults are planted in the program's
resident tile loop (``PIO_CCO_SPARSE=off``, ``PIO_CCO_DENSE=off``), the
strategy ``ur_train.catalog100k`` and ``cco_scale.catalog131k`` take on
the card.  No cell spans chips, so there is no exchange between chips to
leave out.
"""

import numpy as np
import pytest
import torch

from pio_bench import check, gen, harness

WORKLOADS = ["small.ur", "small.cco"]


@pytest.fixture()
def tiled(monkeypatch):
    monkeypatch.setenv("PIO_CCO_SPARSE", "off")
    monkeypatch.setenv("PIO_CCO_DENSE", "off")


def run(root, workload, seed=20261018):
    result, lines = harness.run(root, workload, seed, 0.05, False, device="cpu")
    return result


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("path", ["auto", "tiled"])
def test_sound_runs_are_correct(small_root, monkeypatch, workload, path):
    if path == "tiled":
        monkeypatch.setenv("PIO_CCO_SPARSE", "off")
        monkeypatch.setenv("PIO_CCO_DENSE", "off")
    result = run(small_root, workload, seed=2**31 + 17)
    assert result["correct"] is True and result["failed"] == 0, result["checks"]
    assert result["attempted"] >= 1


def heaviest_item(root, workload, seed):
    cell = harness.Cell(root, workload)
    first = cell.cfg["event_types"][0]["name"]
    ev = gen.make_events(cell.cfg, cell.traffic, seed)[first]
    held = np.zeros(int(cell.cfg["items"]), np.int64)
    np.add.at(held, np.unique(ev.user.astype(np.int64) * cell.cfg["items"] + ev.item)
              % cell.cfg["items"], 1)
    return int(np.argmax(held))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_step_that_returns_its_state_unchanged_fails(small_root, monkeypatch, tiled,
                                                       workload):
    from predictionio_tpu_torch.ops import cco

    real = cco.tile_topk_desc

    def carry_unchanged(scores, b, id_offset=0, carry=None):
        return carry if carry is not None else real(scores, b, id_offset)

    monkeypatch.setattr(cco, "tile_topk_desc", carry_unchanged)
    result = run(small_root, workload)
    assert result["correct"] is False
    assert result["checks"]["entries_mismatch"]["value"] > 0


@pytest.mark.parametrize("workload", WORKLOADS)
def test_half_of_the_events_left_out_fails(small_root, monkeypatch, tiled, workload):
    from predictionio_tpu_torch.ops import cco

    real = cco._densify

    def half(items, users, n_rows, n_cols):
        n = len(items) // 2
        return real(items[:n], users[:n], n_rows, n_cols)

    monkeypatch.setattr(cco, "_densify", half)
    result = run(small_root, workload)
    assert result["correct"] is False
    assert result["failed"] == result["attempted"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_an_answer_altered_where_it_is_produced_fails(small_root, monkeypatch, tiled,
                                                      workload):
    from predictionio_tpu_torch.ops import cco

    seed = 20261018
    row = heaviest_item(small_root, workload, seed)
    real = cco._finalize_topk

    def altered(best_scores, best_idx, n_items_t, top_k=None):
        scores, idx = real(best_scores, best_idx, n_items_t, top_k)
        idx = idx.copy()
        idx[row, 0] = (idx[row, 0] + 1) % n_items_t
        return scores, idx

    monkeypatch.setattr(cco, "_finalize_topk", altered)
    result = run(small_root, workload, seed)
    assert result["correct"] is False


@pytest.mark.parametrize("workload", WORKLOADS)
def test_the_control_in_bfloat16_fails_a_limit(small_root, workload):
    """The reference computed in bfloat16 (the next precision below the
    configuration's float32 scores), put in the program's place on the
    sampled rows, reads over the cell's limits."""
    cell = harness.Cell(small_root, workload)
    seed = 7
    events = gen.make_events(cell.cfg, cell.traffic, seed)
    ref = check.Reference(cell.cfg, cell.traffic, events, seed)
    ctl = check.Reference(cell.cfg, cell.traffic, events, seed, dtype=torch.bfloat16)
    worst = {}
    for name, rows in ctl.indicators.items():
        nums = check.compare_rows(ref.indicators[name],
                                  ((r, rr.top_ids, rr.top_scores) for r, rr in rows.items()))
        worst = check.worst([worst, nums]) if worst else nums
    assert not check.judge({**worst, "popularity_err": 0, "seen_mismatch": 0},
                           cell.limits)
    assert max(worst["score_err"] / cell.limits["score_err"]["limit"],
               worst["rank_gap"] / cell.limits["rank_gap"]["limit"]) > 3

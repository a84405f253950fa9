"""The control of a cell's check: the reference in a lower precision put in
the program's place, at the cell's own size.

    python3 pio_bench/control.py --workload <name> --seeds <n> [<n> ...] [--dtype bfloat16]

For each seed it draws the cell's events, counts the sampled rows exactly
once, scores them in float64 (the reference) and in ``--dtype`` (the
control: bfloat16, the next precision below the configuration's float32
scores), ranks both, and prints one JSON line of the numbers the check
compares (``score_err``, ``rank_gap``, ``entries_mismatch``) with the
control's answers held against the reference's; then a last line with the
least of each over the seeds, the upper reading a limit is set under.  It
runs on the host alone and imports nothing of the program.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def readings(cell, seed: int, dtype) -> dict:
    from pio_bench import check, gen, reference

    cfg, chk = cell.cfg, cell.traffic["check"]
    users, items, k = int(cfg["users"]), int(cfg["items"]), int(cfg["top_k"])
    threshold = float(cfg.get("min_llr", 0.0))
    events = gen.make_events(cfg, cell.traffic, seed)
    names = [t["name"] for t in cfg["event_types"]]
    pairs = {n: reference.Pairs(events[n].user, events[n].item, users, items) for n in names}
    p = pairs[names[0]]
    rows = reference.sample_rows(p, gen.rng(seed, 1000), int(chk["heavy_rows"]),
                                 int(chk["rows"]), int(chk["any_rows"]))
    worst = {}
    for n in names:
        counts = reference.count_rows(p, pairs[n], rows)
        args = (p, pairs[n], rows, users, k, threshold, n == names[0])
        ref = reference.indicator_rows(*args, counts=counts)
        ctl = reference.indicator_rows(*args, dtype=dtype, counts=counts)
        nums = check.compare_rows(ref, ((r, c.top_ids, c.top_scores) for r, c in ctl.items()))
        worst = check.worst([worst, nums]) if worst else nums
    return worst


def main(argv=None) -> int:
    import torch

    from pio_bench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float16", "float32"))
    args = ap.parse_args(argv)
    cell = harness.Cell(ROOT, args.workload)
    least = {}
    for seed in args.seeds:
        t = time.perf_counter()
        nums = readings(cell, seed, getattr(torch, args.dtype))
        print(json.dumps({"workload": args.workload, "seed": seed, "dtype": args.dtype,
                          **nums, "seconds": time.perf_counter() - t}), flush=True)
        least = {k: min(least.get(k, v), v) for k, v in nums.items()}
    print(json.dumps({"workload": args.workload, "dtype": args.dtype, "least": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

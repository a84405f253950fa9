"""Run one cell of the benchmark and print its result as the last line.

    python3 pio_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The run makes its events from the seed, sets
up and warms the program, runs whole steps back to back for ``--seconds``,
checks what the window's steps returned against the plain reference, and
prints the check's numbers beside their limits as the last lines of
standard error and, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, the card's ``power_limit_w``, and last
``checks``.  It exits non-zero, printing no result, when the card is
missing or the cell asks for more cards than there are, when the run
fails, and when a module of JAX or of the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this directory, heads the import path: the
# harness's modules are ``pio_bench.*`` and shadow no top-level name
sys.path[0] = str(ROOT)
# every kernel cache sits at a fixed path inside the checkout
CACHE = ROOT / ".pio_bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from pio_bench import harness

    chips = int(harness.Cell(ROOT, args.workload).cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"pio_bench: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        result, lines = harness.run(ROOT, args.workload, args.seed, args.seconds,
                                    bool(args.trace), device="cuda", t0=T0)
    except Exception:
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"pio_bench: the run loaded forbidden modules: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

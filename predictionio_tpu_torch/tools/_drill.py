"""What the port's operator drills share: the ``--device`` flag, the device
check that refuses to go on without the card asked for, the line of kernel
launch counts each drill prints before its verdict, and the ``pio`` command
line and environment of the drills' child processes."""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import TYPE_CHECKING, Optional, Sequence, Tuple

if TYPE_CHECKING:
    import torch

#: the root of the checkout: a child process imports the port from here
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: ``python -m`` of the port's console, as a drill starts its ``pio`` children
PIO = [sys.executable, "-m", "predictionio_tpu_torch.cli.main"]


def parse_args(argv: Optional[Sequence[str]], description: str,
               parser: Optional[argparse.ArgumentParser] = None
               ) -> Tuple[argparse.Namespace, "torch.device"]:
    """Parse ``--device {cuda,cpu}`` (default ``cuda``) beside a drill's own
    flags, and resolve the device: without the card asked for, print one
    ``FAIL`` line naming it and exit 2 before any phase runs."""
    from predictionio_tpu_torch.device import resolve_device

    parser = parser or argparse.ArgumentParser(description=description)
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the drill trains and serves (default: cuda)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"FAIL {e}", file=sys.stderr)
        raise SystemExit(2)
    return args, device


def child_env(device, extra: Optional[dict] = None) -> dict:
    """The environment of a ``pio`` child: this process's, the port importable
    from the checkout and ``PIO_TORCH_DEVICE`` set to the drill's device."""
    path = os.environ.get("PYTHONPATH")
    env = {**os.environ,
           "PYTHONPATH": REPO_ROOT + (os.pathsep + path if path else ""),
           "PIO_TORCH_DEVICE": str(device)}
    env.update(extra or {})
    return env


def launch_counts() -> dict:
    """This process's launches of K1, K2 and K3 (the wrappers' counters)."""
    from predictionio_tpu_torch.ops import hopper_kernels as hk

    return {"masked_score": hk.masked_score_matmul.launches,
            "llr_masked": hk.llr_masked_scores.launches,
            "tile_topk": hk.tile_topk_desc.launches}


def print_launches(device) -> None:
    """One line before the verdict: ``launches: {...}`` (JSON), this
    process's K1, K2 and K3 counts on ``device``."""
    print(f"launches: {json.dumps({'device': str(device), **launch_counts()})}",
          flush=True)

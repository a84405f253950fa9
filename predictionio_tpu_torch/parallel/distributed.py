"""The multi-process runtime over ``torch.distributed``.

Counterpart of ``predictionio_tpu/parallel/distributed.py``.  Every process
runs the same program; ``init_distributed`` joins them into one process
group from the pio-env.sh variables (``PIO_COORDINATOR_ADDRESS``,
``PIO_NUM_PROCESSES``, ``PIO_PROCESS_ID``).  One process (a rank) drives one
device, where a JAX process drives every local device: a mesh's ``dp`` is
the number of ranks.

The backend is chosen from the topology before the group is made:

- ``nccl`` when the device is CUDA and every rank on this host has a card of
  its own (rank → ``cuda:<local rank>``; ``LOCAL_RANK`` and
  ``LOCAL_WORLD_SIZE`` name the host's share where ranks span hosts, else
  every rank is local);
- ``gloo`` on the CPU, and where ranks share a card (NCCL refuses two ranks
  on one GPU).  Gloo runs both collectives on CUDA tensors itself (through
  host memory), so the helpers stage nothing.

The JAX package's TPU-pod autodetection has no counterpart: several
processes without a coordinator raise.  A failed init or collective
raises; every init and collective has a timeout (``PIO_DIST_TIMEOUT_S``,
default 600 s).

The module adds the two collectives the ops need, ``all_reduce_sum`` and
``all_gather_rows``.  Each counts its calls, bytes and seconds in
``COLLECTIVES`` (a process-wide record, read by ``chip_smoke.py``, not a
metric).
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, TypeVar

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger("pio.distributed")

T = TypeVar("T")

DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class DistributedConfig:
    """Multi-process topology, from env (conf/pio-env.sh convention)."""

    coordinator_address: Optional[str]  # host:port of process 0
    num_processes: int
    process_id: int

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        return cls(
            coordinator_address=os.environ.get("PIO_COORDINATOR_ADDRESS") or None,
            num_processes=int(os.environ.get("PIO_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("PIO_PROCESS_ID", "0")),
        )

    @property
    def is_multi_process(self) -> bool:
        return self.num_processes > 1 or self.coordinator_address is not None


#: the device ``init_distributed`` gave this process's rank (the process
#: group itself is torch.distributed's process-wide default group)
_rank_device: Optional[torch.device] = None


def choose_backend(device: torch.device, config: DistributedConfig) -> Tuple[str, torch.device]:
    """(backend, this rank's device) from the topology: NCCL when every rank
    on this host has a CUDA card of its own, else gloo (see the module's
    docstring)."""
    if device.type != "cuda":
        return "gloo", torch.device("cpu")
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("a CUDA rank was asked for but no card is visible")
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", config.num_processes))
    local_rank = int(os.environ.get("LOCAL_RANK", config.process_id))
    if n_cards >= local_world:
        return "nccl", torch.device("cuda", local_rank)
    return "gloo", torch.device("cuda", local_rank % n_cards)


def init_distributed(config: Optional[DistributedConfig] = None,
                     device=None) -> DistributedConfig:
    """Idempotently join the multi-process runtime.

    Single-process configs are a no-op, so every entry point (CLI train,
    servers, tests) can call this unconditionally.  ``device`` is the kind
    of device the rank drives (default ``"cuda"``, the port's default); on
    CUDA the rank's card becomes the current device.
    """
    global _rank_device
    config = config or DistributedConfig.from_env()
    if dist.is_initialized() or not config.is_multi_process:
        return config
    if config.coordinator_address is None:
        raise ValueError(
            f"PIO_NUM_PROCESSES={config.num_processes} needs PIO_COORDINATOR_ADDRESS "
            "(host:port of process 0): the port has no TPU-pod autodetection")
    if not 0 <= config.process_id < config.num_processes:
        raise ValueError(f"PIO_PROCESS_ID {config.process_id} out of range for "
                         f"{config.num_processes} processes")
    from predictionio_tpu_torch.device import resolve_device

    backend, dev = choose_backend(resolve_device(device), config)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info("joining %d processes at %s as rank %d: backend %s on %s",
             config.num_processes, config.coordinator_address, config.process_id,
             backend, dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{config.coordinator_address}",
        rank=config.process_id, world_size=config.num_processes,
        timeout=datetime.timedelta(
            seconds=float(os.environ.get("PIO_DIST_TIMEOUT_S", DEFAULT_TIMEOUT_S))))
    _rank_device = dev
    log.info("distributed runtime up: process %d/%d, backend %s",
             config.process_id, config.num_processes, backend)
    return config


def backend() -> Optional[str]:
    """The process group's backend (None without one)."""
    return dist.get_backend() if dist.is_initialized() else None


def local_device() -> Optional[torch.device]:
    """The device ``init_distributed`` gave this rank (None without one)."""
    return _rank_device if dist.is_initialized() else None


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def shard_segments(segments: Sequence[T],
                   n_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> List[T]:
    """This process's share of the event-log segments, strided round-robin.

    Segments are immutable once rotated (storage/localfs.py), so a static
    assignment is safe; striding (rather than contiguous blocks) balances
    load when segment sizes trend over time.
    """
    n = n_processes if n_processes is not None else process_count()
    i = process_id if process_id is not None else process_index()
    if not 0 <= i < n:
        raise ValueError(f"process_id {i} out of range for {n} processes")
    return list(segments[i::n])


def process_local_rows(n_rows: int, mesh) -> Tuple[int, int]:
    """[start, stop) of the dp-sharded global row space owned by this
    process — what host-side staging must load.  Rows must divide evenly
    over dp (use mesh.pad_rows_for_mesh first)."""
    dp = mesh.shape["dp"]
    if n_rows % dp != 0:
        raise ValueError(f"{n_rows} rows do not divide over dp={dp}")
    rows_per_shard = n_rows // dp
    me = process_index()
    dp_positions = sorted({int(pos[0]) for pos, rank in np.ndenumerate(mesh.devices)
                           if rank == me})
    if not dp_positions:
        return (0, 0)
    if dp_positions != list(range(dp_positions[0], dp_positions[-1] + 1)):
        raise ValueError(
            f"this process's dp positions {dp_positions} are not contiguous; "
            "build the mesh with ranks laid out contiguously along dp")
    return (dp_positions[0] * rows_per_shard, (dp_positions[-1] + 1) * rows_per_shard)


# -- the collectives the ops run -------------------------------------------------


@dataclasses.dataclass
class CollectiveCount:
    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


#: calls, bytes (this rank's input) and wall seconds of each collective
COLLECTIVES: Dict[str, CollectiveCount] = {
    "all_reduce": CollectiveCount(), "all_gather": CollectiveCount()}


def reset_collective_counts() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = CollectiveCount()


def collective_counts() -> Dict[str, Dict[str, float]]:
    return {k: dataclasses.asdict(v) for k, v in COLLECTIVES.items()}


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _count(name: str, t: torch.Tensor, t0: float) -> None:
    _sync(t)
    c = COLLECTIVES[name]
    c.calls += 1
    c.bytes += t.numel() * t.element_size()
    c.seconds += time.perf_counter() - t0


def all_reduce_sum(t: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """Sum ``t`` in place over the ranks along ``axis`` of ``mesh``; a no-op
    where the rank has nobody to exchange with (no process group)."""
    group = mesh.group(axis)
    if group is None:
        return t
    _sync(t)
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    _count("all_reduce", t, t0)
    return t


def all_gather_rows(t: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """The row blocks of every rank along ``axis``, concatenated in mesh
    order: [n * rows, ...] on ``t``'s device (gloo gathers CUDA tensors
    itself, as NCCL does)."""
    group = mesh.group(axis)
    if group is None:
        return t
    t = t.contiguous()
    _sync(t)
    t0 = time.perf_counter()
    ranks = dist.get_process_group_ranks(group)
    out = torch.empty((len(ranks) * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    line = _line(mesh, axis)
    if line != ranks:   # the group's order is the ranks'; the mesh's may differ
        by_rank = dict(zip(ranks, out.split(t.shape[0])))
        out = torch.cat([by_rank[r] for r in line])
    _count("all_gather", t, t0)
    return out


def _line(mesh, axis: str) -> List[int]:
    """The ranks along ``axis`` through this rank, in mesh order."""
    ax = mesh.axis_names.index(axis)
    index = list(mesh.coords())
    index[ax] = slice(None)
    return [int(r) for r in mesh.devices[tuple(index)]]

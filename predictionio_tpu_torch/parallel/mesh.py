"""The mesh of ranks.

Counterpart of ``predictionio_tpu/parallel/mesh.py``.  A JAX mesh is an
array of devices that one program spans; here one OS process (a rank of
the ``torch.distributed`` process group) drives one device, so a mesh is an
array of ranks.  Axis convention, as in the JAX package:

- ``dp`` — data parallelism (events, users, examples);
- ``mp`` — model parallelism (the item or feature dimension).

``Mesh.shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
does, so call sites read ``mesh.shape["dp"]``.  ``Mesh.group(axis)`` is the
process group of the ranks that differ only along ``axis`` (the whole world
when the mesh is the world and the other axis is 1): the group the ops'
collectives along that axis run in.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from predictionio_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape; resolved against available devices."""

    dp: int = -1  # -1 = fill with remaining devices
    mp: int = 1

    def resolve(self, n_devices: int) -> Tuple[int, int]:
        mp = self.mp if self.mp > 0 else 1
        if n_devices % mp != 0:
            raise ValueError(f"mp={mp} does not divide device count {n_devices}")
        dp = self.dp if self.dp > 0 else n_devices // mp
        if dp * mp != n_devices:
            raise ValueError(f"mesh {dp}x{mp} != {n_devices} devices")
        return dp, mp


class Mesh:
    """A ``(dp, mp)`` array of ranks, this rank's device, and the process
    group of each axis (``None`` where the axis needs no collective)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...],
                 device=None, groups: Optional[Dict[str, object]] = None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        self.device = device
        self._groups = dict(groups or {})

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def coords(self) -> Tuple[int, ...]:
        """This rank's position in the mesh."""
        from predictionio_tpu_torch.parallel.distributed import process_index

        at = np.argwhere(self.devices == process_index())
        if len(at) == 0:
            raise ValueError(f"rank {process_index()} is not in the mesh "
                             f"{self.devices.tolist()}")
        return tuple(int(c) for c in at[0])

    def position(self, axis: str) -> int:
        """This rank's index along ``axis``."""
        return self.coords()[self.axis_names.index(axis)]

    def group(self, axis: str = "dp"):
        """The process group of the ranks that share this rank's position on
        every other axis (``torch.distributed``'s default group when that is
        the whole world); ``None`` without a process group, or when this
        rank is alone along ``axis``."""
        return self._groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.devices.tolist()})"


def _axis_groups(arr: np.ndarray, axis_names: Tuple[str, ...]) -> Dict[str, object]:
    """Each axis's group for this rank.  ``new_group`` is collective: every
    rank of the world creates every group, in the same order."""
    if not dist.is_initialized():
        return {}
    world = dist.get_world_size()
    me = dist.get_rank()
    groups: Dict[str, object] = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(arr, ax, -1).reshape(-1, arr.shape[ax])
        for line in lines:
            ranks = sorted(int(r) for r in line)
            if len(ranks) == world:
                group = dist.group.WORLD
            elif len(ranks) == 1:
                group = None    # nothing to exchange along this axis
            else:
                group = dist.new_group(ranks=ranks)
            if me in ranks:
                groups[name] = group
    return groups


def create_mesh(
    spec: Optional[MeshSpec] = None,
    devices: Optional[Sequence[int]] = None,
    axis_names: Tuple[str, str] = ("dp", "mp"),
) -> Mesh:
    """Build a 2-D mesh over the given ranks (default: every rank of the
    process group, or this process alone when there is none), ``dp`` the
    outer axis.  Raises ``MeshSpec.resolve``'s ``ValueError`` when the spec
    does not fill the ranks."""
    from predictionio_tpu_torch.parallel.distributed import local_device, process_count

    ranks = list(devices) if devices is not None else list(range(process_count()))
    dp, mp = (spec or MeshSpec()).resolve(len(ranks))
    arr = np.asarray(ranks, dtype=np.int64).reshape(dp, mp)
    return Mesh(arr, axis_names, device=local_device(), groups=_axis_groups(arr, axis_names))


def default_mesh() -> Mesh:
    """Process-wide default mesh: all ranks on a (dp, mp=1) mesh, with the
    shape overridable via PIO_MESH (e.g. 'dp=4,mp=2')."""
    conf = os.environ.get("PIO_MESH", "")
    spec = MeshSpec()
    if conf:
        kv = dict(part.split("=") for part in conf.split(",") if "=" in part)
        spec = MeshSpec(dp=int(kv.get("dp", -1)), mp=int(kv.get("mp", 1)))
    return create_mesh(spec)


def host_staging_iterator(
    arrays: Iterable[np.ndarray],
    mesh: Mesh,
    axis: str = "dp",
    device=None,
) -> Iterator[torch.Tensor]:
    """Double-buffered host→device staging of row-sharded batches: this
    rank's rows of each batch are copied from pinned host memory with
    ``non_blocking`` on a side stream while the previous batch is yielded,
    so the copy overlaps the consumer's work.  A yielded tensor is ready on
    the current stream."""
    from predictionio_tpu_torch.parallel.sharding import local_rows, shard_rows

    dev = resolve_device(device if device is not None else mesh.device)
    side = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def stage(arr):
        arr = np.asarray(arr)
        lo, hi = local_rows(arr.shape[0], shard_rows(mesh, axis, arr.ndim))
        host = torch.as_tensor(np.ascontiguousarray(arr[lo:hi]))
        if side is None:
            return host.to(dev), None
        host = host.pin_memory()
        with torch.cuda.stream(side):
            out = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, (done, host)   # the pinned source lives until the copy ends

    def ready(staged):
        out, pending = staged
        if pending is not None:
            current = torch.cuda.current_stream(dev)
            current.wait_event(pending[0])
            out.record_stream(current)
        return out

    pending = None
    for arr in arrays:
        staged = stage(arr)
        if pending is not None:
            yield ready(pending)
        pending = staged
    if pending is not None:
        yield ready(pending)


def pad_rows_for_mesh(n_rows: int, mesh: Mesh, axis: str = "dp", multiple: int = 8) -> int:
    """Rows padded so each shard is a multiple of ``multiple``."""
    shards = mesh.shape[axis]
    per = math.ceil(n_rows / shards)
    per = ((per + multiple - 1) // multiple) * multiple
    return per * shards


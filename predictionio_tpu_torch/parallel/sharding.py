"""Sharding helpers shared by the ops and the templates.

Counterpart of ``predictionio_tpu/parallel/sharding.py``.  A sharding is a
small frozen descriptor: the mesh and one entry a dimension, the mesh axis
that dimension is split over (``None``: whole in every rank).  Every rank
holds the full host array, as in the JAX package (the sharedfs event log is
reachable from every host, so each re-derives the same layout); staging
copies this rank's contiguous rows of it to the rank's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The mesh and, for each leading dimension, the mesh axis it is split
    over (``None`` or absent: not split)."""

    mesh: object
    spec: Tuple[Optional[str], ...] = ()

    @property
    def row_axis(self) -> Optional[str]:
        return self.spec[0] if self.spec else None


def named_sharding(mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, tuple(spec))


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, ())


def shard_rows(mesh, axis: str = "dp", ndim: int = 2) -> NamedSharding:
    """Rows over ``axis``, everything else replicated."""
    return NamedSharding(mesh, (axis, *([None] * (ndim - 1))))


def pad_to_multiple(
    arr: np.ndarray, multiple: int, axis: int = 0, fill: Union[int, float] = 0
) -> np.ndarray:
    """Pad ``axis`` up to a multiple (pad rows are masked out downstream)."""
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, constant_values=fill)


def local_rows(n_rows: int, sharding: NamedSharding) -> Tuple[int, int]:
    """[start, stop) of the rows this rank holds under ``sharding``."""
    axis = sharding.row_axis
    if axis is None:
        return 0, n_rows
    n = sharding.mesh.shape[axis]
    if n_rows % n:
        raise ValueError(f"{n_rows} rows do not divide over {axis}={n}")
    per = n_rows // n
    me = sharding.mesh.position(axis)
    return me * per, (me + 1) * per


def stage_global(arr: np.ndarray, sharding: NamedSharding, device=None) -> torch.Tensor:
    """This rank's contiguous rows of the full host array ``arr`` under
    ``sharding``, as a tensor on ``device`` (default: the mesh's device)."""
    dev = resolve_device(device if device is not None else sharding.mesh.device)
    lo, hi = local_rows(arr.shape[0], sharding)
    return torch.as_tensor(np.ascontiguousarray(arr[lo:hi])).to(dev)


def device_put_sharded_rows(arr: np.ndarray, mesh, axis: str = "dp",
                            device=None) -> torch.Tensor:
    """Pad rows to the ``axis`` extent and stage this rank's rows."""
    arr = pad_to_multiple(np.asarray(arr), mesh.shape[axis], axis=0)
    return stage_global(arr, shard_rows(mesh, axis, arr.ndim), device)

"""The work of the CCO dense route in one train, from the configuration's
shapes alone, so that it reads the same work whatever computes it.

The dense route (``predictionio_tpu_torch/ops/cco.py:_DenseRunner``, on the
chunk rule of the JAX package's ``_dense_chunk_users``) splits the users
into equal chunks, as few as fit 1 GiB of densified primary and event type
at 2 bytes a cell, each a multiple of 256 users.  For each event type t
against the primary p it adds the count product of every chunk's 0/1
matrices, the primary's [I_p × chunk] and t's [it_pad × chunk], into one
int32 count matrix [I_p, it_pad]; the primary's self-indicator takes the
primary's chunk as both operands.  it_pad is I_t rounded up to 128 (the
primary's own width for the self-indicator); U_pad, the users rounded up to
whole chunks.

A type's least time is the larger of its operations, 2·U_pad·I_p·it_pad,
at the int8 peak and of its bytes at HBM's rate: every densified chunk read
once (U_pad·(I_p + it_pad) bytes, U_pad·I_p for the self-indicator) and the
count matrix written once (4·I_p·it_pad).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

from pio_bench import counts

#: the dense chunk's budget, densified primary and event type together, at
#: the JAX package's 2 bytes a cell
CHUNK_BYTES = 1 << 30
BYTES_PER_CELL = 2
#: a chunk's users and a padded item width are multiples of these
CHUNK_ROUND = 256
ITEM_ROUND = 128


def padded_items(n_items: int) -> int:
    return max(math.ceil(n_items / ITEM_ROUND) * ITEM_ROUND, ITEM_ROUND)


def type_shapes(cfg: Dict) -> List[Tuple[str, int, int, bool]]:
    """(event type, I_p, it_pad, self-indicator) of every type a train
    computes, the first the primary against itself; every type indexes the
    configuration's one catalog."""
    items = int(cfg["items"])
    return [(t["name"], items, items if k == 0 else padded_items(items), k == 0)
            for k, t in enumerate(cfg["event_types"])]


def chunk_users(cfg: Dict) -> int:
    """The users of one dense chunk."""
    shapes = type_shapes(cfg)
    i_p = shapes[0][1]
    per_user = (i_p + max(i_p, *(it for _, _, it, _ in shapes))) * BYTES_PER_CELL
    max_chunk = max(CHUNK_BYTES // per_user, CHUNK_ROUND)
    users = int(cfg["users"])
    n_chunks = max(math.ceil(users / max_chunk), 1)
    return max(math.ceil(users / n_chunks / CHUNK_ROUND) * CHUNK_ROUND, CHUNK_ROUND)


def padded_users(cfg: Dict) -> int:
    """U_pad: the users rounded up to whole chunks."""
    chunk = chunk_users(cfg)
    return math.ceil(max(int(cfg["users"]), 1) / chunk) * chunk


def ops_per_type(cfg: Dict) -> List[float]:
    u_pad = padded_users(cfg)
    return [2.0 * u_pad * i_p * it for _, i_p, it, _ in type_shapes(cfg)]


def bytes_per_type(cfg: Dict) -> List[float]:
    u_pad = padded_users(cfg)
    return [float(u_pad * (i_p + (0 if self_pair else it)) + 4 * i_p * it)
            for _, i_p, it, self_pair in type_shapes(cfg)]


def bound_s_per_train(cfg: Dict) -> float:
    """The dense route's least seconds a train: over the types, the larger
    of the operations at the int8 peak and of the bytes at HBM's rate."""
    return sum(max(ops / counts.INT8_PEAK_OPS, b / counts.HBM_BYTES_S)
               for ops, b in zip(ops_per_type(cfg), bytes_per_type(cfg)))

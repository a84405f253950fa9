"""Alternating least squares: training on one device, and serving.

Counterpart of ``predictionio_tpu/ops/als.py``.

Training (JAX :40-412).  ``prepare_als_data`` builds the JAX package's dual
layout array for array (events grouped by user shard and by item shard,
padded to a multiple of 8), so fingerprints, checkpoints and the tests
compare like with like.  Each half-step solves, for every row on one side,
the normal equations (YᵀCY + λ·n_e·I) x = YᵀCp with the other side fixed
(``_half_step`` explicit, ``_half_step_implicit`` with the YᵀY Gram term).
The JAX package builds them as [E, K, K] outer products segment-summed by
row; here that tensor never exists.  The host sorts each side's events by
owner row once a train (``HalfStepPlan``: CSR order) and groups the rows
into buckets by degree rounded up to a power of two.  A bucket is solved
in chunks of rows whose gathered factors and systems fit ``SCRATCH_BYTES``:
gather [R, D, K], one batched product each for A [R, K, K] and b [R, K],
``torch.linalg.cholesky_ex`` (no host sync, no raise, as
``jax.scipy.linalg.cho_factor``) and ``torch.cholesky_solve``, then the
rows are written back.  A row with more events than one chunk holds is
summed over slices of its events, in order.  Every sum has a fixed order
(batched products, one write a row, no atomics), so two trains from one
seed on one card give the same bits.  TF32 stays off
(``device.resolve_device``): the Gram and the solves need f32.

Factors start from an explicit ``torch.Generator`` on the CPU (JAX draws
from ``PRNGKey(seed)``, which torch cannot reproduce), so the CPU and the
card start from the same factors.  A device mesh (``mesh``, or data laid
out for dp > 1) is not ported: it raises naming ROADMAP.md's item.

Serving (JAX :414-686).  Every route without business rules scores
through the fused masked-score kernel
(``ops.hopper_kernels.masked_score_matmul``); the e-commerce rule routes
(``recommend_scores_rules`` and its batch, JAX :471-624) score with one
``torch.matmul`` outside any kernel, as the JAX package leaves them to XLA.
All rank in ``lax.top_k``'s order (``ops.topk.topk_desc``) and return one
stacked [2, k] tensor a query.  Item factors stay resident on the device;
a query sends its user row (or vector) and small padded id lists.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.ops.cco import ROADMAP_MESH
from predictionio_tpu_torch.ops.hopper_kernels import (
    masked_score_matmul,
    recommend_batch_fused,
)
from predictionio_tpu_torch.ops.topk import topk_desc

#: bound on one chunk's device scratch in a half-step: the gathered
#: factors, the weighted copy, the systems and their factors
SCRATCH_BYTES = 256 * 2**20


# -- training: the host-prepared layout (JAX :40-115) --------------------------


@dataclasses.dataclass
class ALSData:
    """Host-prepared dual-layout interaction data for a mesh of size dp.

    Layout invariant: global entity ``e`` maps to (shard ``e % dp``, local row
    ``e // dp``); factor blocks are stored as [dp * rows, K] arrays whose
    flat index is ``shard * rows + local_row``.
    """

    dp: int
    n_users: int
    n_items: int
    user_rows: int   # padded users per shard
    item_rows: int   # padded items per shard
    # by-user layout: [dp, E_u]
    u_user_local: np.ndarray   # local user row on the owning shard
    u_item_flat: np.ndarray    # flat index into item factor blocks
    u_rating: np.ndarray
    u_mask: np.ndarray         # f32 validity mask
    # by-item layout: [dp, E_i]
    i_item_local: np.ndarray
    i_user_flat: np.ndarray
    i_rating: np.ndarray
    i_mask: np.ndarray


def _group_by_shard(
    owner: np.ndarray, other_flat: np.ndarray, rating: np.ndarray, dp: int, pad_multiple: int = 8
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Bucket events by ``owner % dp``; pad buckets to a common length."""
    shard = owner % dp
    order = np.argsort(shard, kind="stable")
    owner_s, other_s, rating_s, shard_s = owner[order], other_flat[order], rating[order], shard[order]
    counts = np.bincount(shard_s, minlength=dp)
    width = max(int(counts.max()) if len(owner) else 1, 1)
    width = ((width + pad_multiple - 1) // pad_multiple) * pad_multiple
    local = np.zeros((dp, width), np.int32)
    other = np.zeros((dp, width), np.int32)
    rat = np.zeros((dp, width), np.float32)
    mask = np.zeros((dp, width), np.float32)
    start = 0
    for s in range(dp):
        c = int(counts[s])
        sl = slice(start, start + c)
        local[s, :c] = owner_s[sl] // dp
        other[s, :c] = other_s[sl]
        rat[s, :c] = rating_s[sl]
        mask[s, :c] = 1.0
        start += c
    return local, other, rat, mask


def prepare_als_data(
    user_idx: np.ndarray,
    item_idx: np.ndarray,
    rating: np.ndarray,
    n_users: int,
    n_items: int,
    dp: int,
) -> ALSData:
    user_idx = np.asarray(user_idx, np.int32)
    item_idx = np.asarray(item_idx, np.int32)
    rating = np.asarray(rating, np.float32)
    user_rows = max(math.ceil(n_users / dp), 1)
    item_rows = max(math.ceil(n_items / dp), 1)
    # flat index of the OTHER side's factor row: shard * rows + local_row
    item_flat = (item_idx % dp) * item_rows + item_idx // dp
    user_flat = (user_idx % dp) * user_rows + user_idx // dp
    uu, ui, ur, um = _group_by_shard(user_idx, item_flat, rating, dp)
    ii, iu, ir, im = _group_by_shard(item_idx, user_flat, rating, dp)
    return ALSData(
        dp=dp, n_users=n_users, n_items=n_items,
        user_rows=user_rows, item_rows=item_rows,
        u_user_local=uu, u_item_flat=ui, u_rating=ur, u_mask=um,
        i_item_local=ii, i_user_flat=iu, i_rating=ir, i_mask=im,
    )


# -- training: the half-step (JAX :118-170) --------------------------------------


@dataclasses.dataclass
class _Bucket:
    """Rows of one side whose events fit width D: ``other``, ``rating`` and
    ``mask`` are [R, D] (padding: index 0, rating 0, mask 0)."""

    rows: torch.Tensor      # [R] int64 row to solve
    other: torch.Tensor     # [R, D] int64 gather index into the other side
    rating: torch.Tensor    # [R, D] f32
    mask: torch.Tensor      # [R, D] f32, 1 on an event
    n_e: torch.Tensor       # [R] f32 events a row


@dataclasses.dataclass
class HalfStepPlan:
    """One side's events in CSR order by owner row, bucketed by degree
    (a power of two a bucket; a row above ``d_cap`` events is a bucket of
    its own at its exact width, summed over slices of ``d_cap``).  Rows
    without events are in no bucket: their solution is 0, as JAX's."""

    rows: int
    scratch_bytes: int
    d_cap: int
    buckets: List[_Bucket]


def _d_cap(k: int, scratch_bytes: int) -> int:
    """Events of one row summed in one slice: the largest power of two
    whose gathered [D, K] factors and weighted copy fit half the scratch."""
    return 1 << max(0, (scratch_bytes // (16 * (k + 1))).bit_length() - 1)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def half_step_plan(local_idx, other_flat, rating, mask, rows: int, k: int,
                   device, scratch_bytes: int = SCRATCH_BYTES) -> HalfStepPlan:
    """Build one side's ``HalfStepPlan`` on the host from its padded event
    arrays (a shard's row of ``ALSData``) and stage it on ``device``."""
    local_idx, other_flat = _host(local_idx), _host(other_flat)
    rating, mask = _host(rating), _host(mask)
    keep = mask > 0
    local = local_idx[keep].astype(np.int64)
    order = np.argsort(local, kind="stable")
    local = local[order]
    other = other_flat[keep].astype(np.int64)[order]
    rat = rating[keep].astype(np.float32)[order]
    deg = np.bincount(local, minlength=rows)
    start = np.concatenate([[0], np.cumsum(deg)[:-1]])
    d_cap = _d_cap(k, scratch_bytes)
    owned = np.flatnonzero(deg)
    width = np.left_shift(1, np.ceil(np.log2(deg[owned])).astype(np.int64))
    groups = []
    for d in np.unique(width):
        sel = owned[width == d]
        if d <= d_cap:
            groups.append((sel, int(d)))
        else:   # one bucket a row, at its exact width
            groups.extend((sel[j:j + 1], int(deg[sel[j]])) for j in range(len(sel)))

    def dev(a):
        return torch.as_tensor(a).to(device)

    buckets = []
    for sel, d in groups:
        col = np.arange(d)
        valid = col[None, :] < deg[sel][:, None]
        pos = np.where(valid, start[sel][:, None] + col[None, :], 0)
        buckets.append(_Bucket(
            rows=dev(sel.astype(np.int64)),
            other=dev(np.where(valid, other[pos], 0)),
            rating=dev(np.where(valid, rat[pos], 0).astype(np.float32)),
            mask=dev(valid.astype(np.float32)),
            n_e=dev(deg[sel].astype(np.float32))))
    return HalfStepPlan(rows=rows, scratch_bytes=scratch_bytes, d_cap=d_cap,
                        buckets=buckets)


def _mark(mark: Optional[Callable[[str], None]], stage: str) -> None:
    if mark is not None:
        mark(stage)


def solve_half(plan: HalfStepPlan, other_full: torch.Tensor, reg: float,
               gram: Optional[torch.Tensor] = None, alpha: float = 1.0,
               mark: Optional[Callable[[str], None]] = None) -> torch.Tensor:
    """Solve one side's rows against ``other_full`` [N, K]: explicit
    (``gram`` None) or implicit (``gram`` = other_fullᵀ other_full, and
    confidence c = 1 + ``alpha``·r).  Returns [plan.rows, K] f32.

    ``mark(stage)`` is called as each chunk enters "build" (gather and the
    normal equations), "cholesky" and "solve", and with "end" at the end:
    a caller can time the stages with CUDA events."""
    k = other_full.shape[1]
    dev = other_full.device
    out = torch.zeros((plan.rows, k), dtype=torch.float32, device=dev)
    for bk in plan.buckets:
        n_rows, d = bk.other.shape
        dc = min(d, plan.d_cap)
        # a chunk's rows hold: the gathered factors and their weighted copy
        # [Dc, K] each, A, its Cholesky factor and the solver's copies
        # [K, K] (four in all), b and x [K]
        per_row = 4 * (2 * dc * (k + 1) + 4 * k * k + 2 * k)
        step = max(1, plan.scratch_bytes // per_row)
        for r0 in range(0, n_rows, step):
            rs = slice(r0, r0 + step)
            _mark(mark, "build")
            a = b = None
            for c0 in range(0, d, dc):   # one slice unless a row is wider
                cs = slice(c0, c0 + dc)
                y = other_full[bk.other[rs, cs]]               # [R, Dc, K]
                m, r = bk.mask[rs, cs], bk.rating[rs, cs]
                if gram is None:
                    wa, wb = m, r * m                           # Σ y yᵀ, Σ r y
                else:
                    wa = alpha * r * m                          # Σ (c−1) y yᵀ
                    wb = (1.0 + wa) * m                         # Σ c p y
                pa = torch.bmm((y * wa[..., None]).transpose(1, 2), y)
                pb = torch.bmm(wb[:, None, :], y)[:, 0]
                del y
                if a is None:
                    a, b = pa, pb
                else:   # a row wider than a slice: its slices in order
                    a.add_(pa)
                    b.add_(pb)
            if gram is not None:
                a.add_(gram)
            # λ·n_e ridge (MLlib's ALS-WR weighting) + ε guard, as JAX :135
            # (there the λ·I product adds 0 off the diagonal)
            lam = reg * torch.clamp(bk.n_e[rs], min=1.0) + 1e-6
            a.diagonal(dim1=-2, dim2=-1).add_(lam[:, None])
            _mark(mark, "cholesky")
            chol, _info = torch.linalg.cholesky_ex(a)
            del a
            _mark(mark, "solve")
            out[bk.rows[rs]] = torch.cholesky_solve(b[..., None], chol)[..., 0]
    _mark(mark, "end")
    return out


def _half_step(
    other_full: torch.Tensor,   # [dp*other_rows, K] the opposite factors
    local_idx, other_flat, rating, mask,   # [E] one shard's events
    rows: int,
    reg: float,
    scratch_bytes: int = SCRATCH_BYTES,
) -> torch.Tensor:
    """Solve per-row normal equations (YᵀY + λ n_e I) x = Yᵀr on one shard
    (JAX ``_half_step``); the plan is built from the event arrays."""
    plan = half_step_plan(local_idx, other_flat, rating, mask, rows,
                          other_full.shape[1], other_full.device, scratch_bytes)
    return solve_half(plan, other_full, reg)


def _half_step_implicit(
    other_full: torch.Tensor,   # [dp*other_rows, K]
    gram: torch.Tensor,         # [K, K] = other_fullᵀ other_full
    local_idx, other_flat, rating, mask,   # [E]
    rows: int,
    reg: float,
    alpha: float,
    scratch_bytes: int = SCRATCH_BYTES,
) -> torch.Tensor:
    """Implicit-feedback half-step (Hu/Koren/Volinsky; JAX
    ``_half_step_implicit``): (YᵀY + Yᵀ(C−I)Y + λ·n_e·I) x = Yᵀ C p."""
    plan = half_step_plan(local_idx, other_flat, rating, mask, rows,
                          other_full.shape[1], other_full.device, scratch_bytes)
    return solve_half(plan, other_full, reg, gram, float(alpha))


# -- training: the sweeps (JAX :173-412) -------------------------------------------


def _check_single(data: ALSData, mesh) -> None:
    if mesh is not None or data.dp != 1:
        raise NotImplementedError(
            f"ALS over a device mesh (dp={data.dp}) is not ported yet ({ROADMAP_MESH})")


def als_train(
    data: ALSData,
    k: int,
    reg: float,
    iterations: int,
    mesh=None,
    seed: int = 7,
    checkpoint=None,
    checkpoint_every: int = 0,
    implicit: bool = False,
    alpha: float = 1.0,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run ALS sweeps on ``device`` (default ``cuda``); returns (X
    [n_users, K], Y [n_items, K]) on the host.

    ``implicit=True`` switches to implicit-feedback ALS (the MLlib
    ``ALS.trainImplicit`` of the reference e-commerce template): ratings
    become confidences c = 1 + ``alpha``·r over binary preferences, and
    each half-step adds the dense YᵀY Gram term.

    ``checkpoint`` (a ``utils.checkpoint.CheckpointStore``) +
    ``checkpoint_every`` snapshot the factor blocks every N sweeps and
    resume from the newest snapshot of the same run (``als_fingerprint``).
    """
    _check_single(data, mesh)
    dev = resolve_device(device)
    if checkpoint is not None and checkpoint_every > 0:
        return _als_train_checkpointed(
            data, k, reg, iterations, mesh, seed, checkpoint, checkpoint_every,
            implicit=implicit, alpha=alpha, device=dev)
    x0, y0 = _als_init(data, k, seed)
    x, y = _als_sweeps(data, x0.to(dev), y0.to(dev), iterations, reg, mesh,
                       implicit=implicit, alpha=alpha)
    return _als_deinterleave(data, x, y, k)


def _als_init(data: ALSData, k: int, seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x0, y0) [dp, rows, K] f32 on the CPU: y0 ~ N(0, 0.1²) from a CPU
    ``torch.Generator(seed)``, x0 zero."""
    gen = torch.Generator().manual_seed(int(seed))
    y0 = torch.randn((data.dp, data.item_rows, k), generator=gen,
                     dtype=torch.float32) * 0.1
    # zero the padding rows (shard s, local r holds item r*dp + s): the
    # implicit Gram must not see init noise there, and they then stay 0
    item_id = (torch.arange(data.item_rows)[None, :] * data.dp
               + torch.arange(data.dp)[:, None])
    y0 = y0 * (item_id < data.n_items)[..., None]
    x0 = torch.zeros((data.dp, data.user_rows, k), dtype=torch.float32)
    return x0, y0


def _als_device_args(data: ALSData, k: int, device) -> Tuple[HalfStepPlan, HalfStepPlan]:
    """Both sides' plans on ``device``: one host->device upload a train."""
    _check_single(data, None)
    return (
        half_step_plan(data.u_user_local[0], data.u_item_flat[0], data.u_rating[0],
                       data.u_mask[0], data.user_rows, k, device),
        half_step_plan(data.i_item_local[0], data.i_user_flat[0], data.i_rating[0],
                       data.i_mask[0], data.item_rows, k, device),
    )


def _als_sweeps(data: ALSData, x0: torch.Tensor, y0: torch.Tensor, n_sweeps: int,
                reg: float, mesh=None, args=None, implicit: bool = False,
                alpha: float = 1.0, mark: Optional[Callable[[str], None]] = None):
    """``n_sweeps`` sweeps from (x0, y0) [dp, rows, K] on their device,
    user side then item side; returns (x, y) there."""
    _check_single(data, mesh)
    dp, _, k = y0.shape
    if args is None:
        args = _als_device_args(data, k, y0.device)
    user_plan, item_plan = args
    x, y = x0, y0
    for _ in range(int(n_sweeps)):
        y_full = y.reshape(dp * data.item_rows, k)
        gram = y_full.T @ y_full if implicit else None
        x = solve_half(user_plan, y_full, reg, gram, alpha, mark=mark).reshape(
            dp, data.user_rows, k)
        x_full = x.reshape(dp * data.user_rows, k)
        gram = x_full.T @ x_full if implicit else None
        y = solve_half(item_plan, x_full, reg, gram, alpha, mark=mark).reshape(
            dp, data.item_rows, k)
    return x, y


def _als_deinterleave(data: ALSData, x, y, k: int) -> Tuple[np.ndarray, np.ndarray]:
    # [dp, rows, K] back to global [n, K]: global e = shard + dp*row
    x = _host(x).transpose(1, 0, 2).reshape(-1, k)[: data.n_users]
    y = _host(y).transpose(1, 0, 2).reshape(-1, k)[: data.n_items]
    return np.ascontiguousarray(x), np.ascontiguousarray(y)


def als_fingerprint(data: ALSData, k: int, reg: float, seed: int,
                    implicit: bool = False, alpha: float = 1.0) -> str:
    """Identifies a training run well enough to reject foreign snapshots:
    hyperparams + data layout + a cheap content signature (the JAX
    package's string, so either package resumes the other's snapshot)."""
    n_events = int(data.u_mask.sum())
    sig = int(np.int64(data.u_rating.sum() * 1000)) if n_events else 0
    mode = f"-imp{alpha}" if implicit else ""
    return (
        f"k{k}-dp{data.dp}-u{data.n_users}x{data.user_rows}"
        f"-i{data.n_items}x{data.item_rows}-e{n_events}-r{reg}-s{seed}-h{sig}{mode}"
    )


def _als_train_checkpointed(
    data: ALSData, k: int, reg: float, iterations: int, mesh,
    seed: int, checkpoint, checkpoint_every: int,
    implicit: bool = False, alpha: float = 1.0, device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Chunked sweeps with snapshot/resume (see als_train's docstring)."""
    from predictionio_tpu_torch.utils.checkpoint import maybe_inject

    dev = resolve_device(device)
    fingerprint = als_fingerprint(data, k, reg, seed, implicit, alpha)
    done = 0
    x = y = None
    latest = checkpoint.latest()
    if latest is not None:
        step, state = latest
        # resume ONLY a snapshot of this exact run with sweeps still to do;
        # anything else is stale: start fresh
        if state.get("fingerprint") == fingerprint and step < iterations:
            done = step
            x = torch.as_tensor(np.asarray(state["x"], np.float32))
            y = torch.as_tensor(np.asarray(state["y"], np.float32))
    if x is None:
        x, y = _als_init(data, k, seed)
    x, y = x.to(dev), y.to(dev)
    args = _als_device_args(data, k, dev)   # one upload for all chunks
    while done < iterations:
        n = min(checkpoint_every, iterations - done)
        x, y = _als_sweeps(data, x, y, n, reg, mesh, args=args,
                           implicit=implicit, alpha=alpha)
        done += n
        maybe_inject("als.sweep")  # rehearse a mid-training failure
        checkpoint.save(done, {
            "x": _host(x), "y": _host(y), "fingerprint": fingerprint,
        })
    return _als_deinterleave(data, x, y, k)


# -- serving (JAX :414-686) -----------------------------------------------------


def check_f32_id_range(n_items: int) -> None:
    """The stacked-readback serving paths pack item indices as f32, which
    is exact only below 2**24: violating catalogs fail loudly instead of
    silently serving corrupted item ids."""
    if n_items >= 1 << 24:
        raise ValueError(
            f"catalog of {n_items} items exceeds the 2**24 exact-int range "
            "of the f32-packed top-k serving path; shard the catalog across "
            "devices or split the app")


def _stack_topk(scores: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Pack (scores, idx) as one [..., 2, k] f32 tensor so serving does ONE
    device→host copy per query (item ids are exact in f32 below 2**24,
    see check_f32_id_range)."""
    return torch.stack([scores, idx.to(torch.float32)], dim=-2)


def bucket_width(n: int, min_width: int = 16) -> int:
    """Smallest power-of-two ≥ n (and ≥ min_width) — the one shape-bucketing
    rule for serving: distinct exclusion lengths, batch sizes and top-k
    values collapse to a handful of shapes."""
    return max(min_width, 1 << max(0, (int(n) - 1).bit_length()))


def pad_ids(ids, min_width: int = 16) -> np.ndarray:
    """Pad an id list to a bucketed width with -1 (see bucket_width)."""
    n = len(ids)
    out = np.full(bucket_width(n, min_width), -1, np.int32)
    if n:
        out[:n] = np.asarray(ids, np.int32)
    return out


def exclusion_mask(excl_idx, n_items: int, device: torch.device) -> torch.Tensor:
    """[B, W] -1-padded item ids → [B, n_items] uint8 mask (1 = excluded),
    built on ``device``: only the id list crosses to it.

    Padding (and any id outside the catalog, which JAX's scatter drops) is
    sent to a sink column past the last item and sliced off, so item 0 is
    excluded only when it is listed.  The result is a row-strided view,
    which the kernel takes as it is."""
    ids = torch.as_tensor(excl_idx).to(device=device, dtype=torch.int64)
    ids = torch.where((ids >= 0) & (ids < n_items), ids, n_items)
    mask = torch.zeros((ids.shape[0], n_items + 1), dtype=torch.uint8,
                       device=device)
    mask.scatter_(1, ids, 1)
    return mask[:, :n_items]


def recommend_scores(
    user_vec: torch.Tensor,       # [K]
    item_factors: torch.Tensor,   # [n_items, K]
    seen_mask: torch.Tensor,      # [n_items] >0 where already interacted
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-K item scores for one user; seen items pushed to -inf."""
    scores = masked_score_matmul(user_vec[None], item_factors, seen_mask[None])
    s, i = topk_desc(scores, top_k)
    return s[0], i[0]


def recommend_batch_excl(
    user_vecs: torch.Tensor,      # [B, K]
    item_factors: torch.Tensor,   # [n_items, K] — device-resident
    excl_idx,                     # [B, W] per-row exclusions, -1 padding
    top_k: int,
) -> torch.Tensor:                # [B, 2, top_k]: scores row, item-id row
    """Top-K per row with an exclusion LIST instead of a dense mask."""
    n_items = item_factors.shape[0]
    check_f32_id_range(n_items)
    mask = exclusion_mask(excl_idx, n_items, item_factors.device)
    return _stack_topk(*recommend_batch_fused(
        user_vecs, item_factors, mask, top_k))


def recommend_scores_excl(
    user_vec: torch.Tensor,       # [K]
    item_factors: torch.Tensor,   # [n_items, K] — device-resident
    excl_idx,                     # [W] item ids to exclude, -1 padding
    top_k: int,
) -> torch.Tensor:                # [2, top_k]: scores row, item-id row
    """Single-query ``recommend_batch_excl``."""
    return recommend_batch_excl(user_vec[None], item_factors,
                                torch.as_tensor(excl_idx)[None], top_k)[0]


def recommend_batch(
    user_vecs: torch.Tensor,      # [B, K]
    item_factors: torch.Tensor,   # [n_items, K]
    seen_mask: torch.Tensor,      # [B, n_items]
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched top-K scoring through the fused kernel."""
    return recommend_batch_fused(user_vecs, item_factors, seen_mask, top_k)


def pad_id_rows(rows, min_width: int = 16) -> np.ndarray:
    """-1-padded [B, W] id matrix with W pow2-bucketed (the 2-D sibling of
    pad_ids) — the shared scaffold for every serve_batch_predict."""
    w = bucket_width(max((len(r) for r in rows), default=1), min_width)
    out = np.full((len(rows), w), -1, np.int32)
    for r, ids in enumerate(rows):
        out[r, : len(ids)] = ids
    return out


def _id_rows(ids, device) -> torch.Tensor:
    return torch.as_tensor(ids).to(device=device, dtype=torch.int64)


def _rules_topk_batch(scores: torch.Tensor, cat_masks: torch.Tensor, cat_ids,
                      white_idx, excl_idx, top_k: int) -> torch.Tensor:
    """Per-row category / whitelist allow-masks and exclusion lists over
    [B, n_items] scores, then the stacked [B, 2, top_k] result.  An all -1
    ``cat_ids`` or ``white_idx`` row means "no constraint of that kind";
    an id outside the catalog is ignored, as JAX's scatter drops it."""
    b, n_items = scores.shape
    check_f32_id_range(n_items)
    dev = scores.device
    cat_ids = _id_rows(cat_ids, dev)                      # [B, Wc]
    cat_valid = cat_ids >= 0
    sel = cat_masks[cat_ids.clamp(min=0)] & cat_valid[:, :, None]   # [B, Wc, I]
    allow_cat = torch.where(cat_valid.any(dim=1, keepdim=True), sel.any(dim=1),
                            torch.ones((), dtype=torch.bool, device=dev))
    white_idx = _id_rows(white_idx, dev)                  # [B, Ww]
    white_valid = white_idx >= 0
    white_mask = exclusion_mask(white_idx, n_items, dev).bool()
    allow_white = torch.where(white_valid.any(dim=1, keepdim=True), white_mask,
                              torch.ones((), dtype=torch.bool, device=dev))
    scores = scores.masked_fill(~(allow_cat & allow_white), float("-inf"))
    scores = scores.masked_fill(exclusion_mask(excl_idx, n_items, dev).bool(),
                                float("-inf"))
    return _stack_topk(*topk_desc(scores, top_k))


def _rules_topk(scores, cat_masks, cat_ids, white_idx, excl_idx, top_k: int):
    """Single-row ``_rules_topk_batch``: [n_items] scores → [2, top_k]."""
    return _rules_topk_batch(scores[None], cat_masks, torch.as_tensor(cat_ids)[None],
                             torch.as_tensor(white_idx)[None],
                             torch.as_tensor(excl_idx)[None], top_k)[0]


def recommend_scores_rules(
    user_vec: torch.Tensor,       # [K]
    item_factors: torch.Tensor,   # [n_items, K] — device-resident
    cat_masks: torch.Tensor,      # [C, n_items] bool — device-resident
    cat_ids,                      # [Wc] category ids to OR, -1 padding
    white_idx,                    # [Ww] whitelist item ids, -1 padding
    excl_idx,                     # [We] excluded item ids, -1 padding
    top_k: int,
) -> torch.Tensor:                # [2, top_k]: scores row, item-id row
    """Top-K with e-commerce business rules, device-final: a query ships
    three small padded id lists, and only the top-K crosses back."""
    return _rules_topk(item_factors @ user_vec, cat_masks, cat_ids, white_idx,
                       excl_idx, top_k)


def scores_rules_topk(scores: torch.Tensor, cat_masks: torch.Tensor, cat_ids,
                      white_idx, excl_idx, top_k: int) -> torch.Tensor:
    """Business-rule mask + top-k over an already-computed [n_items] score
    vector — recommend_scores_rules without the factor product."""
    return _rules_topk(scores, cat_masks, cat_ids, white_idx, excl_idx, top_k)


def recommend_batch_rules(
    user_vecs: torch.Tensor,      # [B, K]
    item_factors: torch.Tensor,   # [n_items, K] — device-resident
    cat_masks: torch.Tensor,      # [C, n_items] bool — device-resident
    cat_ids,                      # [B, Wc] -1-padded
    white_idx,                    # [B, Ww] -1-padded
    excl_idx,                     # [B, We] -1-padded
    top_k: int,
) -> torch.Tensor:                # [B, 2, top_k]
    """Batched recommend_scores_rules: B queries' rules + top-ks, one
    readback."""
    return _rules_topk_batch(user_vecs @ item_factors.T, cat_masks, cat_ids,
                             white_idx, excl_idx, top_k)


def scores_rules_topk_batch(scores: torch.Tensor, cat_masks: torch.Tensor, cat_ids,
                            white_idx, excl_idx, top_k: int) -> torch.Tensor:
    """Batched scores_rules_topk over [B, n_items] scores."""
    return _rules_topk_batch(scores, cat_masks, cat_ids, white_idx, excl_idx, top_k)


def indicator_scatter_scores(idx: torch.Tensor, llr: torch.Tensor, q_ids) -> torch.Tensor:
    """score[j] = Σ_{q ∈ query items} Σ_k 1[idx[q,k] = j] · llr[q,k] over an
    [n_items, C] indicator table (-1 = padding) and -1-padded query ids: a
    gather of the query rows and one scatter-add, on the table's device
    (``predictionio_tpu/ops/als.py:indicator_scatter_scores``).  Padding
    lands in a sink entry past the last item.  On the card the float
    scatter-add sums in no fixed order (within f32 rounding of the CPU's)."""
    return indicator_scatter_scores_batch(idx, llr, torch.as_tensor(q_ids)[None])[0]


def indicator_scatter_scores_batch(idx: torch.Tensor, llr: torch.Tensor,
                                   q_ids) -> torch.Tensor:
    """Batched ``indicator_scatter_scores``: [B, Wq] query rows → [B, n_items]
    scores in one gather and one scatter-add (all-(-1) rows score 0)."""
    n = idx.shape[0]
    q = torch.as_tensor(q_ids).to(device=idx.device, dtype=torch.int64)
    b = q.shape[0]
    qv = q >= 0
    safe = torch.where(qv, q, 0)
    rows = idx[safe].to(torch.int64)                      # [B, Wq, C]
    vals = llr[safe] * qv[:, :, None]
    valid = rows >= 0
    base = (torch.arange(b, device=idx.device, dtype=torch.int64) * (n + 1))[:, None, None]
    out = torch.zeros(b * (n + 1), dtype=torch.float32, device=idx.device)
    out.index_add_(0, (base + torch.where(valid, rows, n)).reshape(-1),
                   torch.where(valid, vals, 0.0).reshape(-1))
    return out.view(b, n + 1)[:, :n]

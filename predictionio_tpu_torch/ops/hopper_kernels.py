"""Hand-written Hopper kernels for the serving and training hot paths,
with their plain PyTorch versions.

Counterpart of ``predictionio_tpu/ops/pallas_kernels.py``:

- ``masked_score_matmul`` (K1) — the ``/queries.json`` hot path of ALS
  serving: ``scores = U @ Vᵀ + bias; scores[mask > 0] = -inf`` in one pass
  (``ops/csrc/masked_score.cu``, replacing the Pallas ``_score_kernel``),
  so the [B, I] score matrix is written to device memory once.
- ``llr_masked_scores`` (K2) — the LLR pass of CCO training: Dunning G²
  of every cell's 2×2 table, -inf where the count is 0 or G² misses the
  threshold (``ops/csrc/llr_masked.cu``, replacing ``_llr_kernel``).  It
  reads the count product's int32 output directly.
- ``tile_topk_desc`` (K3) — the exact top-b of every row of a score tile,
  in ``lax.top_k``'s total order (``ops/csrc/tile_topk.cu``, replacing
  ``_topk_sort_kernel``): the row top-k of the dense CCO strategy and, with
  the running carry merged in the same launch, the per-tile top-k and carry
  merge of the tiled one.
- ``row_counts`` — the CCO marginals: each row's sum of an item-major int8
  matrix into int32, in one pass over its bytes (``ops/csrc/row_count.cu``).
  It replaces no Pallas kernel (the reference's marginals are an XLA sum):
  ``torch.sum(dtype=torch.int32)`` casts its whole input to int32 first.

A wrapper launches its kernel for CUDA tensors and runs the plain version
only for tensors on the CPU (the CPU tests).  It checks device, dtype,
shape and layout and raises on anything else; nothing falls back.  Each
wrapper counts its launches in a plain integer attribute (``.launches``),
so a run can show that its path went through the kernel; K1 also counts
them by the route the kernel reports it took
(``masked_score_matmul.launches_by_route``: ``streaming`` for B <= 8,
``tiled`` above).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import build
from predictionio_tpu_torch.ops.topk import tile_topk_desc_plain, topk_desc

_MASK_DTYPES = (torch.bool, torch.uint8, torch.float32)
# K1's grid is one resident wave whatever the shape (a grid-stride loop over
# 32-item groups, or over units of 32 or 64 rows x 128 items), so its only
# limits are the C ABI's int B, I and K: row, item and k indices stay below
# 2**31 after rounding B, I and K up to a unit (64 rows, 128 items, 32 k)
_MAX_ROWS = 2**31 - 64
_MAX_ITEMS = 2**31 - 128
# the query server's handler pool launches from several threads at once
_count_lock = threading.Lock()
# the route codes pio_masked_score writes back (kRouteStream, kRouteTiled)
_K1_ROUTES = ("streaming", "tiled")


def _check_masked_score_args(u, v, mask, bias) -> None:
    if not (u.dim() == 2 and v.dim() == 2 and mask.dim() == 2):
        raise ValueError("masked_score_matmul: u [B, K], v [I, K], mask [B, I] "
                         f"expected, got {tuple(u.shape)}, {tuple(v.shape)}, "
                         f"{tuple(mask.shape)}")
    b, k = u.shape
    n = v.shape[0]
    if v.shape[1] != k or tuple(mask.shape) != (b, n):
        raise ValueError(f"masked_score_matmul: shapes u {tuple(u.shape)}, "
                         f"v {tuple(v.shape)}, mask {tuple(mask.shape)} disagree")
    if u.dtype != torch.float32 or v.dtype != torch.float32:
        raise TypeError("masked_score_matmul: u and v must be float32")
    if mask.dtype not in _MASK_DTYPES:
        raise TypeError(f"masked_score_matmul: mask dtype {mask.dtype} is not "
                        "bool, uint8 or float32")
    tensors = [u, v, mask]
    if bias is not None:
        if bias.dtype != torch.float32 or tuple(bias.shape) != (n,):
            raise ValueError(f"masked_score_matmul: bias must be float32 [{n}]")
        tensors.append(bias)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("masked_score_matmul: tensors on different devices: "
                         f"{sorted({str(t.device) for t in tensors})}")
    if u.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked_score_matmul: unsupported device {u.device}")
    if not (u.is_contiguous() and v.is_contiguous()
            and (bias is None or bias.is_contiguous())):
        raise ValueError("masked_score_matmul: u, v and bias must be contiguous")
    # the mask may be a row-strided view (its rows need not be packed)
    if n > 1 and mask.stride(1) != 1 or b > 1 and mask.stride(0) < n:
        raise ValueError("masked_score_matmul: mask rows must be contiguous")
    if b > _MAX_ROWS or n > _MAX_ITEMS or k > _MAX_ROWS:
        raise ValueError(f"masked_score_matmul: B={b}, I={n}, K={k} exceed the "
                         f"kernel's limits ({_MAX_ROWS}, {_MAX_ITEMS}, {_MAX_ROWS})")


def masked_score_matmul_plain(
    u: torch.Tensor,                      # [B, K] f32
    v: torch.Tensor,                      # [I, K] f32
    mask: torch.Tensor,                   # [B, I] bool/uint8/f32, >0 = excluded
    bias: Optional[torch.Tensor] = None,  # [I] f32 additive per-item boost
) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel: ``u @ vᵀ + bias``, then
    ``-inf`` where ``mask > 0`` (the JAX kernel's ``seen > 0``)."""
    s = u @ v.T
    if bias is not None:
        s = s + bias
    return s.masked_fill(mask > 0, float("-inf"))


def masked_score_matmul(
    u: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fused ``scores = u @ vᵀ + bias; scores[mask > 0] = -inf`` → [B, I] f32.

    CUDA tensors launch ``ops/csrc/masked_score.cu`` on the current stream
    (no synchronisation): its streaming pass over V for B <= 8, its
    pipelined tile above.  The mask may be a row-strided view of any stride
    >= I and any alignment.  CPU tensors take ``masked_score_matmul_plain``.
    """
    _check_masked_score_args(u, v, mask, bias)
    if u.device.type == "cpu":
        return masked_score_matmul_plain(u, v, mask, bias)
    b, k = u.shape
    n = v.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=u.device)
    if b == 0 or n == 0:
        return out
    fn = build.load("masked_score").pio_masked_score
    route = ctypes.c_int(-1)
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 int(mask.dtype == torch.float32), mask.stride(0) if b > 1 else n,
                 bias.data_ptr() if bias is not None else None,
                 int(bias is not None), out.data_ptr(), b, n, k,
                 ctypes.addressof(route),
                 torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_score kernel launch failed: CUDA error {err}")
    with _count_lock:
        masked_score_matmul.launches += 1
        masked_score_matmul.launches_by_route[_K1_ROUTES[route.value]] += 1
    return out


masked_score_matmul.launches = 0
masked_score_matmul.launches_by_route = {"streaming": 0, "tiled": 0}


def reset_k1_counts() -> None:
    """Set K1's launch counts, the total and each route's, to 0."""
    with _count_lock:
        masked_score_matmul.launches = 0
        masked_score_matmul.launches_by_route.update(streaming=0, tiled=0)


def recommend_batch_fused(
    u: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,
    top_k: int,
    bias: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused-kernel scoring + ``lax.top_k``-ordered top-k: ([B, k] scores,
    [B, k] int64 item ids)."""
    return topk_desc(masked_score_matmul(u, v, mask, bias), top_k)


# -- K2: fused LLR scoring + masking -------------------------------------------

_MAX_LLR_COLS = 2**31 - 2 * 4096   # int column indices, one 4,096-column step spare


def _check_llr_args(counts, row, col) -> None:
    if not (counts.dim() == 2 and row.dim() == 1 and col.dim() == 1):
        raise ValueError("llr_masked_scores: counts [R, C], row [R], col [C] "
                         f"expected, got {tuple(counts.shape)}, "
                         f"{tuple(row.shape)}, {tuple(col.shape)}")
    r, c = counts.shape
    if row.shape[0] != r or col.shape[0] != c:
        raise ValueError(f"llr_masked_scores: shapes counts {tuple(counts.shape)}, "
                         f"row {tuple(row.shape)}, col {tuple(col.shape)} disagree")
    for name, t in (("counts", counts), ("row", row), ("col", col)):
        if t.dtype != torch.int32:
            raise TypeError(f"llr_masked_scores: int32 {name} expected, got {t.dtype}")
    if len({t.device for t in (counts, row, col)}) != 1:
        raise ValueError("llr_masked_scores: tensors on different devices")
    if counts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"llr_masked_scores: unsupported device {counts.device}")
    # the counts may be a row-strided view (a slice of a padded product)
    if c > 1 and counts.stride(1) != 1 or r > 1 and counts.stride(0) < c:
        raise ValueError("llr_masked_scores: counts rows must be contiguous")
    if c > _MAX_LLR_COLS:
        raise ValueError(f"llr_masked_scores: C={c} exceeds {_MAX_LLR_COLS}")


def llr_masked_scores_plain(
    counts: torch.Tensor,      # [R, C] int32 cooccurrence counts
    row: torch.Tensor,         # [R] int32 users per primary item
    col: torch.Tensor,         # [C] int32 users per other item
    n_total: float,
    threshold: float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of K2 (``_llr_mask_scores(..., pallas="off")``
    of the JAX package): G² in f32, -inf where the count is 0 or G² <
    ``threshold``."""
    from predictionio_tpu_torch.ops.cco import llr_masked_cells

    return llr_masked_cells(counts.to(torch.float32), row.to(torch.float32)[:, None],
                            col.to(torch.float32)[None, :], n_total, threshold)


def llr_masked_scores(
    counts: torch.Tensor,
    row: torch.Tensor,
    col: torch.Tensor,
    n_total: float,
    threshold: float = 0.0,
) -> torch.Tensor:
    """Fused G² scores with zero-count and threshold masking → [R, C] f32.

    CUDA tensors launch ``ops/csrc/llr_masked.cu`` on the current stream
    (no synchronisation); CPU tensors take ``llr_masked_scores_plain``."""
    _check_llr_args(counts, row, col)
    if counts.device.type == "cpu":
        return llr_masked_scores_plain(counts, row, col, n_total, threshold)
    r, c = counts.shape
    out = torch.empty((r, c), dtype=torch.float32, device=counts.device)
    if r == 0 or c == 0:
        return out
    # the marginals are tiny: one f32 copy each (exact below 2**24)
    row_f = row.to(torch.float32).contiguous()
    col_f = col.to(torch.float32).contiguous()
    fn = build.load("llr_masked").pio_llr_masked
    with torch.cuda.device(counts.device):
        err = fn(counts.data_ptr(), counts.stride(0) if r > 1 else c, row_f.data_ptr(),
                 col_f.data_ptr(), float(n_total), float(threshold),
                 out.data_ptr(), r, c,
                 torch.cuda.current_stream(counts.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"llr_masked kernel launch failed: CUDA error {err}")
    with _count_lock:
        llr_masked_scores.launches += 1
    return out


llr_masked_scores.launches = 0


# -- K3: exact per-row top-b ----------------------------------------------------

_MAX_TOPK_B = 1024


def _check_topk_args(scores, b: int, id_offset: int, carry=None) -> None:
    if scores.dim() != 2:
        raise ValueError(f"tile_topk_desc: scores [R, W] expected, got "
                         f"{tuple(scores.shape)}")
    if scores.dtype != torch.float32:
        raise TypeError(f"tile_topk_desc: float32 scores expected, got {scores.dtype}")
    if scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tile_topk_desc: unsupported device {scores.device}")
    r, w = scores.shape
    if not (1 <= b <= _MAX_TOPK_B and b & (b - 1) == 0):
        raise ValueError(f"tile_topk_desc: b={b} must be a power of two in "
                         f"[1, {_MAX_TOPK_B}] (see ops.topk.block_width)")
    if w < 1:
        raise ValueError("tile_topk_desc: rows must have at least one column")
    if not (0 <= id_offset and id_offset + max(w, b) < 2**31):
        raise ValueError(f"tile_topk_desc: id_offset={id_offset} out of range")
    if w > 1 and scores.stride(1) != 1 or r > 1 and scores.stride(0) < w:
        raise ValueError("tile_topk_desc: score rows must be contiguous")
    if carry is not None:
        cs, ci = carry
        if tuple(cs.shape) != (r, b) or tuple(ci.shape) != (r, b):
            raise ValueError(f"tile_topk_desc: carry must be two [{r}, {b}] tensors, "
                             f"got {tuple(cs.shape)}, {tuple(ci.shape)}")
        if cs.dtype != torch.float32 or ci.dtype != torch.int32:
            raise TypeError("tile_topk_desc: carry must be (float32, int32)")
        if cs.device != scores.device or ci.device != scores.device:
            raise ValueError("tile_topk_desc: carry and scores on different devices")
        if not (cs.is_contiguous() and ci.is_contiguous()):
            raise ValueError("tile_topk_desc: carry must be contiguous")


def tile_topk_desc(
    scores: torch.Tensor, b: int, id_offset: int = 0,
    carry: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``b`` of every row of f32 ``scores`` [R, W], in
    (score desc, column asc) order: (values [R, b] f32, int32 column ids +
    ``id_offset`` [R, b]).  A row narrower than ``b`` is padded with -inf.

    With ``carry=(carry_s, carry_i)`` ([R, b] f32 and int32) the result is,
    bit for bit, ``merge_desc(carry_s, carry_i, *tile_topk_desc(scores, b,
    id_offset))``: the carry merge of the tiled CCO loop, fused into the
    same launch.

    CUDA tensors launch ``ops/csrc/tile_topk.cu`` on the current stream
    (no synchronisation); CPU tensors take ``ops.topk.tile_topk_desc_plain``."""
    _check_topk_args(scores, b, id_offset, carry)
    if scores.device.type == "cpu":
        return tile_topk_desc_plain(scores, b, id_offset, carry)
    r, w = scores.shape
    out_s = torch.empty((r, b), dtype=torch.float32, device=scores.device)
    out_i = torch.empty((r, b), dtype=torch.int32, device=scores.device)
    if r == 0:
        return out_s, out_i
    fn = build.load("tile_topk").pio_tile_topk
    with torch.cuda.device(scores.device):
        err = fn(scores.data_ptr(), scores.stride(0) if r > 1 else w, r, w, b,
                 id_offset, carry[0].data_ptr() if carry is not None else None,
                 carry[1].data_ptr() if carry is not None else None,
                 out_s.data_ptr(), out_i.data_ptr(),
                 torch.cuda.current_stream(scores.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tile_topk kernel launch failed: CUDA error {err}")
    with _count_lock:
        tile_topk_desc.launches += 1
    return out_s, out_i


tile_topk_desc.launches = 0


# -- the CCO marginals: row counts of an int8 matrix ---------------------------

#: rows a block of the plain version's sum: ``sum(dtype=int32)`` first casts
#: its whole input to int32, 4x its int8 bytes
_PLAIN_ROWS = 4096


def _check_row_count_args(m, out, accumulate: bool) -> None:
    if m.dim() != 2:
        raise ValueError(f"row_counts: m [R, C] expected, got {tuple(m.shape)}")
    if m.dtype != torch.int8:
        raise TypeError(f"row_counts: int8 m expected, got {m.dtype}")
    if m.device.type not in ("cpu", "cuda"):
        raise ValueError(f"row_counts: unsupported device {m.device}")
    r, c = m.shape
    # m may be a row-strided view (a slice of a wider or padded matrix); an
    # empty m reads nothing, whatever its strides
    if m.numel() and (c > 1 and m.stride(1) != 1 or r > 1 and m.stride(0) < c):
        raise ValueError("row_counts: m's rows must be contiguous")
    if r >= 2**31 or c >= 2**31:
        raise ValueError(f"row_counts: R={r}, C={c} exceed the kernel's int indices")
    if out is None:
        if accumulate:
            raise ValueError("row_counts: accumulate needs an out to add into")
        return
    if out.dtype != torch.int32 or tuple(out.shape) != (r,) or not out.is_contiguous():
        raise ValueError(f"row_counts: out must be a contiguous int32 [{r}], got "
                         f"{out.dtype} {tuple(out.shape)}")
    if out.device != m.device:
        raise ValueError("row_counts: m and out on different devices")


def row_counts_plain(m: torch.Tensor, out: Optional[torch.Tensor] = None,
                     accumulate: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the row-count kernel: ``torch.sum(m, 1,
    dtype=torch.int32)`` in blocks of ``_PLAIN_ROWS`` rows, written into
    ``out`` (a new tensor by default) or, with ``accumulate``, added to it."""
    if out is None:
        out = torch.empty(m.shape[0], dtype=torch.int32, device=m.device)
    for s in range(0, m.shape[0], _PLAIN_ROWS):
        block, dst = m[s:s + _PLAIN_ROWS], out[s:s + _PLAIN_ROWS]
        if accumulate:
            dst += torch.sum(block, 1, dtype=torch.int32)
        else:
            torch.sum(block, 1, dtype=torch.int32, out=dst)
    return out


def row_counts(m: torch.Tensor, out: Optional[torch.Tensor] = None,
               accumulate: bool = False) -> torch.Tensor:
    """Each row's sum of int8 ``m`` [R, C] → int32 [R]: written into ``out``
    (a new tensor by default) or, with ``accumulate``, added to it.  For the
    CCO's 0/1 matrices, the distinct users of each item.

    CUDA tensors launch ``ops/csrc/row_count.cu`` on the current stream (no
    synchronisation); ``m`` may be a row-strided view at any alignment.  CPU
    tensors take ``row_counts_plain``."""
    _check_row_count_args(m, out, accumulate)
    if m.device.type == "cpu":
        return row_counts_plain(m, out, accumulate)
    r, c = m.shape
    if out is None:
        out = torch.empty(r, dtype=torch.int32, device=m.device)
    if r == 0:
        return out
    fn = build.load("row_count").pio_row_count
    with torch.cuda.device(m.device):
        err = fn(m.data_ptr(), m.stride(0) if r > 1 else c, out.data_ptr(), r, c,
                 int(accumulate), torch.cuda.current_stream(m.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_count kernel launch failed: CUDA error {err}")
    with _count_lock:
        row_counts.launches += 1
    return out


row_counts.launches = 0

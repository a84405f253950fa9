"""Hand-written Hopper kernels for the serving hot path, with their plain
PyTorch versions.

Counterpart of ``predictionio_tpu/ops/pallas_kernels.py``:

- ``masked_score_matmul`` — the ``/queries.json`` hot path of ALS
  serving: ``scores = U @ Vᵀ + bias; scores[mask > 0] = -inf`` in one pass
  (``ops/csrc/masked_score.cu``, replacing the Pallas ``_score_kernel``),
  so the [B, I] score matrix is written to device memory once.

A wrapper launches its kernel for CUDA tensors and runs the plain version
only for tensors on the CPU (the CPU tests).  It checks device, dtype,
shape and layout and raises on anything else; nothing falls back.  Each
wrapper counts its launches in a plain integer attribute (``.launches``),
so a run can show that its path went through the kernel.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from predictionio_tpu_torch.ops import build
from predictionio_tpu_torch.ops.topk import topk_desc

_MASK_DTYPES = (torch.bool, torch.uint8, torch.float32)
# grid.y limit (65535) x rows per block (64)
_MAX_ROWS = 65535 * 64
# the threaded query server launches from several threads at once
_count_lock = threading.Lock()


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
    if b > _MAX_ROWS:
        raise ValueError(f"masked_score_matmul: B={b} exceeds {_MAX_ROWS}")


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
    (no synchronisation); CPU tensors take ``masked_score_matmul_plain``.
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
    with torch.cuda.device(u.device):
        err = fn(u.data_ptr(), v.data_ptr(), mask.data_ptr(),
                 int(mask.dtype == torch.float32), mask.stride(0) if b > 1 else n,
                 bias.data_ptr() if bias is not None else None,
                 int(bias is not None), out.data_ptr(), b, n, k,
                 torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_score kernel launch failed: CUDA error {err}")
    with _count_lock:
        masked_score_matmul.launches += 1
    return out


masked_score_matmul.launches = 0


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

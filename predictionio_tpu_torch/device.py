"""Where the port's tensors live.

The device is chosen once, where a model is built, and everything
downstream follows the tensors' device.  The default is the GPU: a caller
who wants the CPU says so with ``device="cpu"``.  There is no switch that
swaps a kernel for its plain version on a GPU.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The ``torch.device`` for ``device`` (default ``"cuda"``).

    Raises ``RuntimeError`` when a CUDA device is asked for and none is
    present: the port never continues on the CPU unless told to.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available; "
                "pass device='cpu' to run on the CPU")
        # f32 products stay f32 (the JAX reference's precision): TF32
        # keeps ~3 decimal digits and would break the 1e-5 parity bar
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev

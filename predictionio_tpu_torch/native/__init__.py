from predictionio_tpu_torch.native.scanner import (  # noqa: F401
    layout_chunks,
    native_available,
    scan_segments,
)

from predictionio_tpu_torch.native.scanner import (  # noqa: F401
    native_available,
    scan_segments,
)

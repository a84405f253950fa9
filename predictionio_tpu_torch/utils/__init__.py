"""Framework utilities (counterpart of ``predictionio_tpu/utils``; the JAX
package's ``apply_platform_override`` configures JAX and has no
counterpart, see ``utils/config.py``)."""

from predictionio_tpu_torch.utils.config import load_pio_env  # noqa: F401
from predictionio_tpu_torch.utils.tracing import named_scope, profile_to, timed  # noqa: F401
from predictionio_tpu_torch.utils.checkpoint import (  # noqa: F401
    CheckpointStore,
    InjectedFault,
    maybe_inject,
)

"""Serving workflow of the port (counterpart of ``predictionio_tpu/workflow``)."""

from predictionio_tpu_torch.workflow.core_workflow import (  # noqa: F401
    run_eval,
    run_train,
)
from predictionio_tpu_torch.workflow.create_workflow import (  # noqa: F401
    load_engine_variant,
    resolve_engine_factory,
)

from predictionio_tpu_torch.models.lead_scoring.engine import (  # noqa: F401
    LeadScoringEngine,
    LSQuery,
)

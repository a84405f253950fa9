"""Data parallelism over ``torch.distributed`` ranks (counterpart of
``predictionio_tpu/parallel``)."""

from predictionio_tpu_torch.parallel.distributed import (  # noqa: F401
    DistributedConfig,
    init_distributed,
    process_local_rows,
    shard_segments,
)
from predictionio_tpu_torch.parallel.mesh import (  # noqa: F401
    MeshSpec,
    create_mesh,
    default_mesh,
    host_staging_iterator,
)
from predictionio_tpu_torch.parallel.sharding import (  # noqa: F401
    named_sharding,
    pad_to_multiple,
    replicated,
    shard_rows,
)

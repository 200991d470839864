"""Data parallelism over torch.distributed (the JAX package's
``parallel/``)."""

from vag_nmt_tpu_torch.parallel.sharding import (  # noqa: F401
    Mesh,
    backend_for,
    host_shard,
    init_distributed,
    make_mesh,
)

"""The data mesh, the ``(pop, data)`` mesh and process-group formation
(counterpart of ``warehouse_tpu/parallel``)."""

from .distributed import maybe_initialize_distributed
from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    POP_AXIS,
    data_sharding,
    make_mesh,
    make_pop_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "POP_AXIS",
    "make_mesh",
    "make_pop_mesh",
    "data_sharding",
    "replicated",
    "shard_batch",
    "maybe_initialize_distributed",
]

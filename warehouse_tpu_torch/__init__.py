"""warehouse_tpu_torch — the warehouse engine ported to PyTorch and CUDA.

A second package beside the JAX reference ``warehouse_tpu``: the same
batched multi-agent env (docs/SEMANTICS.md), bit-exact against the JAX
engine, with the TPU's Pallas kernels rewritten as CUDA kernels for
Hopper (``kernels/``). It imports ``torch`` and never ``jax``; the shape
spec is shared: ``warehouse_tpu.config`` is pure Python.
"""

from warehouse_tpu.config import (EnvConfig, TrainConfig, large_config,
                                  medium_config, shelves_config,
                                  small_config)

__all__ = ["EnvConfig", "TrainConfig", "small_config", "medium_config",
           "large_config", "shelves_config"]

"""warehouse_tpu_torch — the warehouse engine ported to PyTorch and CUDA.

A second package beside the JAX reference ``warehouse_tpu``: the same
batched multi-agent env (docs/SEMANTICS.md), bit-exact against the JAX
engine, with the TPU's Pallas kernels rewritten as CUDA kernels for
Hopper (``kernels/``). It imports ``torch`` and never ``jax``, and nothing
of the JAX package: ``config.py`` is its own copy of the shape spec. Its
entry points run on the card unless the caller passes ``device="cpu"``
(``device.py``).
"""

from .config import (EnvConfig, TrainConfig, large_config, medium_config,
                     shelves_config, small_config)
from .device import default_device, resolve_device

__all__ = ["default_device", "resolve_device", "EnvConfig", "TrainConfig",
           "small_config", "medium_config", "large_config", "shelves_config"]

"""Uniform random policy (counterpart of warehouse_tpu/baselines/random.py)."""

from __future__ import annotations

import torch

from ..config import EnvConfig

from .. import rng as _rng


def random_actions(cfg: EnvConfig, key: torch.Tensor,
                   batch_shape: tuple = ()) -> torch.Tensor:
    """int32[*batch_shape, A], the same draws as ``jax.random.randint``."""
    return _rng.randint(key, (*batch_shape, cfg.num_agents), 0,
                        cfg.num_actions)

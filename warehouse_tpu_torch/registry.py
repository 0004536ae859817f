"""Named env registry (counterpart of ``warehouse_tpu/registry.py``):
string ids -> configured env constructors, the ``tune.register_env``
capability, with the JAX package's names and presets on the port's own
``config.py``."""

from __future__ import annotations

from typing import Callable

from .config import (EnvConfig, large_config, medium_config, shelves_config,
                     small_config)

_REGISTRY: dict[str, Callable[..., EnvConfig]] = {
    "warehouse-small": small_config,
    "warehouse-medium": medium_config,
    "warehouse-large": large_config,
    "warehouse-shelves": shelves_config,
}


def register(name: str, cfg_factory: Callable[..., EnvConfig]) -> None:
    if name in _REGISTRY:
        raise ValueError(f"{name!r} already registered")
    _REGISTRY[name] = cfg_factory


def registered() -> list[str]:
    return sorted(_REGISTRY)


def make_config(name: str, **overrides) -> EnvConfig:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown env {name!r}; registered: {registered()}"
        )
    return _REGISTRY[name](**overrides)


def make_env(name: str, backend: str = "torch", device=None, **overrides):
    """Dict-API env by name (RLlib-style construction), on the card unless
    ``device="cpu"``."""
    from .env.wrapper import WarehouseMultiAgentEnv

    return WarehouseMultiAgentEnv(make_config(name, **overrides),
                                  backend=backend, device=device)


def make_parallel_env(name: str, backend: str = "torch", device=None,
                      **overrides):
    """PettingZoo ParallelEnv by name, on the card unless
    ``device="cpu"``."""
    from .env.pettingzoo_adapter import WarehouseParallelEnv

    return WarehouseParallelEnv(make_config(name, **overrides),
                                backend=backend, device=device)

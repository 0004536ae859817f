"""Pluggable draw sources for the NumPy oracle (docs/SEMANTICS.md §9).

Two implementations of the same interface (counterpart of
``warehouse_tpu/oracle/draws.py``):

- ``TorchDrawSource`` — replays the engine's exact threefry stream through
  the port's :mod:`warehouse_tpu_torch.rng` (``reset_draws`` /
  ``step_draws`` on a batch of one key, on the CPU). Used where the oracle
  is held bit for bit against the port's engine and env kernels.
- ``NumpyDrawSource`` — a plain ``np.random.Generator`` stream with the
  same *sequence shape*, for standalone CPU use.
"""

from __future__ import annotations

from typing import NamedTuple, Protocol

import numpy as np
import torch

from ..config import EnvConfig


class ResetDrawsNp(NamedTuple):
    agent_cells: np.ndarray  # int [A], distinct row-major cell ids
    req_pick: np.ndarray     # int [init_requests]
    req_drop: np.ndarray     # int [init_requests]


class StepDrawsNp(NamedTuple):
    spawn_u: float
    spawn_pick: int
    spawn_drop: int


class DrawSource(Protocol):
    def reset(self, cfg: EnvConfig) -> ResetDrawsNp: ...
    def step(self, cfg: EnvConfig) -> StepDrawsNp: ...
    def reset_from_step(self, cfg: EnvConfig) -> ResetDrawsNp:
        """Draws for an auto-reset triggered by the most recent step."""
        ...


class TorchDrawSource:
    """Mirrors the engine's key threading exactly (docs/SEMANTICS.md §9).
    ``seed_or_key``: an int seed (``rng.prng_key``) or the threefry key
    words ``[2]`` (a tensor, array or pair of ints)."""

    def __init__(self, seed_or_key) -> None:
        from .. import rng as _rng

        if isinstance(seed_or_key, int):
            key = _rng.prng_key(seed_or_key)
        else:
            key = torch.as_tensor(seed_or_key, dtype=torch.int64)
        self._key = key.detach().to("cpu", torch.int64).reshape(1, 2)
        self._pending_reset_key = None

    def reset(self, cfg: EnvConfig) -> ResetDrawsNp:
        return self._reset_with(self._key, cfg)

    def _reset_with(self, key, cfg: EnvConfig) -> ResetDrawsNp:
        from .. import rng as _rng

        d = _rng.reset_draws(key, cfg)
        self._key = d.carry_key
        return ResetDrawsNp(
            d.agent_cells[0].numpy().astype(np.int64),
            d.req_pick[0].numpy().astype(np.int64),
            d.req_drop[0].numpy().astype(np.int64),
        )

    def step(self, cfg: EnvConfig) -> StepDrawsNp:
        from .. import rng as _rng

        d = _rng.step_draws(self._key, cfg)
        self._key = d.next_key
        self._pending_reset_key = d.reset_key
        return StepDrawsNp(
            float(d.spawn_u[0]), int(d.spawn_pick[0]), int(d.spawn_drop[0])
        )

    def reset_from_step(self, cfg: EnvConfig) -> ResetDrawsNp:
        assert self._pending_reset_key is not None, "no step taken yet"
        return self._reset_with(self._pending_reset_key, cfg)

    @property
    def key(self) -> torch.Tensor:
        """The key words ``[2]`` the next draw consumes (the engine's
        ``state.key``)."""
        return self._key[0].clone()


class NumpyDrawSource:
    """Same draw sequence shape from ``np.random.Generator``."""

    def __init__(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    def reset(self, cfg: EnvConfig) -> ResetDrawsNp:
        free = np.array(cfg.free_cells)
        cells = free[self._rng.permutation(cfg.num_free)[: cfg.num_agents]]
        pick = free[self._rng.integers(0, cfg.num_free,
                                       size=cfg.init_requests)]
        drop = free[self._rng.integers(0, cfg.num_free,
                                       size=cfg.init_requests)]
        return ResetDrawsNp(cells, pick, drop)

    def step(self, cfg: EnvConfig) -> StepDrawsNp:
        free = cfg.free_cells
        u = float(self._rng.random())
        pick = free[int(self._rng.integers(0, cfg.num_free))]
        drop = free[int(self._rng.integers(0, cfg.num_free))]
        return StepDrawsNp(u, pick, drop)

    def reset_from_step(self, cfg: EnvConfig) -> ResetDrawsNp:
        return self.reset(cfg)

"""Batched env API (counterpart of ``warehouse_tpu/env/batch.py``).

The engine is batched already, so ``reset_batch``/``step_batch`` are the
engine functions; this module adds the two auto-reset schedules the
rollouts use. Both consume ``StepDraws.reset_key`` of the truncating
tick, so either is draw-for-draw identical to the per-env reset of
``engine.step`` with ``auto_reset=True``.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig

from .. import rng as _rng
from ..utils.profiling import annotate
from . import engine
from .state import EnvState, TimeStep


def reset_batch(cfg: EnvConfig, keys: torch.Tensor):
    """Reset a batch of envs from keys ``[B, 2]``: ``(state, obs)``."""
    return engine.reset(cfg, keys)


def step_batch(cfg: EnvConfig, state: EnvState, actions: torch.Tensor):
    """Step a batch: actions int32[B, A] -> ``(state, TimeStep)``."""
    return engine.step(cfg, state, actions)


def observe_batch(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """Observations of a batched state, float32[B, A, obs_dim]."""
    return engine.observe_state(cfg, state)


def reset_truncated_batch(cfg: EnvConfig, state: EnvState,
                          reset_keys: torch.Tensor):
    """Boundary auto-reset after a chunked rollout.

    Where ``state.t >= max_steps``, the env is replaced by
    ``reset(reset_keys[b])``; ``reset_keys`` are the reset keys of the
    truncating tick (``ppo_rollout``'s ``reset_key_last``). Returns
    ``(state, obs, truncated)`` with the post-reset obs where reset.
    """
    dev = state.t.device
    with annotate("boundary_reset", dev):
        done = state.t >= cfg.max_steps
        obs = observe_batch(cfg, state)
        with annotate("boundary_reset_host_read", dev):
            reset = bool(done.any())
        if reset:
            reset_state, reset_obs = engine.reset(cfg, reset_keys)
            state = reset_state.where(done, state)
            obs = torch.where(done[:, None, None], reset_obs, obs)
    return state, obs, done


def step_autoreset_batch(cfg: EnvConfig, state: EnvState,
                         actions: torch.Tensor,
                         draws: _rng.StepDraws | None = None
                         ) -> tuple[EnvState, TimeStep]:
    """``step_batch`` with ``auto_reset=True``, the reset run only on ticks
    where some env truncates (bit-exact twin of the per-env reset).
    ``draws``: the tick's ``StepDraws`` of ``state.key``, made here when
    not given."""
    return step_autoreset_batch_any(cfg, state, actions, draws)[:2]


def step_autoreset_batch_any(cfg: EnvConfig, state: EnvState,
                             actions: torch.Tensor,
                             draws: _rng.StepDraws | None = None
                             ) -> tuple[EnvState, TimeStep, bool]:
    """``step_autoreset_batch`` and whether some env reset on the tick:
    the one host read of ``truncated.any()`` that decides the reset."""
    cfg_step = cfg.replace(auto_reset=False)
    if draws is None:
        draws = _rng.step_draws(state.key, cfg_step)
    new, ts = engine.step(cfg_step, state, actions, draws)
    done = ts.truncated
    with annotate("tick_host_read", state.t.device):
        reset = bool(done.any())
    if reset:
        reset_state, reset_obs = engine.reset(cfg_step, draws.reset_key)
        new = reset_state.where(done, new)
        ts = ts.replace(obs=torch.where(done[:, None, None], reset_obs,
                                        ts.obs))
    return new, ts, reset

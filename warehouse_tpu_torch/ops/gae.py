"""Generalized Advantage Estimation (counterpart of ``warehouse_tpu/ops/gae.py``).

A reverse loop over T in plain torch ops: the JAX package computes it
outside any Pallas kernel, and it is T small elementwise steps.
"""

from __future__ import annotations

import torch


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float, lam: float,
        bootstrap_values: torch.Tensor | None = None):
    """Returns ``(advantages [T, ...], targets [T, ...])``.

    ``dones[t]`` marks that the transition at t ended an episode. Without
    ``bootstrap_values`` the bootstrap across a boundary is masked
    (truncation treated as termination); with it, a boundary delta uses
    ``bootstrap_values[t]``, V of the true pre-reset successor. The
    λ-trace is cut at the boundary either way. Same op order as the JAX
    scan body.
    """
    not_done = 1.0 - dones.to(torch.float32)
    if bootstrap_values is None:
        bootstrap_values = torch.zeros_like(values)
    next_adv = torch.zeros_like(last_value)
    next_value = last_value
    advs = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        nd = not_done[t]
        nv = nd * next_value + (1.0 - nd) * bootstrap_values[t]
        delta = rewards[t] + gamma * nv - values[t]
        next_adv = delta + gamma * lam * nd * next_adv
        next_value = values[t]
        advs[t] = next_adv
    advs = torch.stack(advs)
    return advs, advs + values

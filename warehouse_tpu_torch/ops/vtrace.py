"""V-trace (counterpart of ``warehouse_tpu/ops/vtrace.py``).

The off-policy return and advantage estimator of IMPALA (Espeholt et al.
2018) as a reverse loop over T in plain torch ops, in the JAX function's
op order. Inputs are time-major ``[T, ...]``; ``dones[t]`` marks that the
transition at t ended an episode, so every bootstrap across it is cut, as
in ``ops/gae.py``.
"""

from __future__ import annotations

import torch


def vtrace(behavior_log_prob: torch.Tensor, target_log_prob: torch.Tensor,
           rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
           last_value: torch.Tensor, gamma: float, rho_clip: float = 1.0,
           c_clip: float = 1.0,
           bootstrap_values: torch.Tensor | None = None):
    """``(vs, pg_advantages)``, both ``float32[T, ...]`` and detached.

    ``vs_t = V(s_t) + sum_{k>=t} gamma^(k-t) (prod_{i<k} c_i) delta_k`` with
    ``delta_k = rho_k (r_k + gamma V(s_{k+1}) - V(s_k))``, ``rho_k =
    min(rho_clip, pi/mu)``, ``c_k = min(c_clip, pi/mu)``; ``pg_t = rho_t
    (r_t + gamma vs_{t+1} - V(s_t))``. ``bootstrap_values`` (V of the
    true successor) replaces 0 as the next value at a boundary.
    """
    behavior_log_prob, target_log_prob, rewards, values, last_value = (
        x.detach() for x in (behavior_log_prob, target_log_prob, rewards,
                             values, last_value))
    not_done = 1.0 - dones.to(torch.float32)
    if bootstrap_values is None:
        bootstrap_values = torch.zeros_like(values)
    bootstrap_values = bootstrap_values.detach()
    rho = torch.exp(target_log_prob - behavior_log_prob)
    clipped_rho = torch.clamp(rho, max=rho_clip)
    cs = torch.clamp(rho, max=c_clip)

    values_next = torch.cat([values[1:], last_value[None]])
    values_next = (not_done * values_next
                   + (1.0 - not_done) * bootstrap_values)
    deltas = clipped_rho * (rewards + gamma * values_next - values)

    acc = torch.zeros_like(last_value)
    vs_minus_v = [None] * values.shape[0]
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + gamma * not_done[t] * cs[t] * acc
        vs_minus_v[t] = acc
    vs = values + torch.stack(vs_minus_v)

    vs_next = torch.cat([vs[1:], last_value[None]])
    vs_next = not_done * vs_next + (1.0 - not_done) * bootstrap_values
    pg_advantages = clipped_rho * (rewards + gamma * vs_next - values)
    return vs, pg_advantages

"""Debug mode and state validation (counterpart of
``warehouse_tpu/utils/debug.py``).

``check_state_invariants`` checks the docs/SEMANTICS.md §2 invariants of a
batched state, one verdict per env; ``enable_debug_mode`` turns on
autograd's anomaly detection (NaN trapping in the backward passes).
``assert_replicated_in_sync`` and ``visualize_sharding`` come with the
multi-device port (ROADMAP M-8).
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from ..env.state import EMPTY, IN_TRANSIT, EnvState


def enable_debug_mode() -> None:
    """Anomaly detection in autograd: a backward pass that makes a NaN
    raises, naming the forward operation."""
    torch.autograd.set_detect_anomaly(True)


def check_state_invariants(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """bool[B]: True for each env whose state keeps every §2 invariant
    (the JAX function's seven, on a batch): agents on the grid, no two on
    one cell, an agent's request names it back (an agent without one
    carries nothing), carrying iff its request is in transit, a request's
    agent names it back, an empty slot has no agent, a slot in transit
    has one."""
    A, R = cfg.num_agents, cfg.queue_capacity
    pos = state.agent_pos
    dev = pos.device
    pos_ok = ((pos >= 0).all(-1).all(-1)
              & (pos[..., 0] < cfg.height).all(-1)
              & (pos[..., 1] < cfg.width).all(-1))
    cells = pos[..., 0] * cfg.width + pos[..., 1]
    distinct = ((cells[:, :, None] != cells[:, None, :])
                | torch.eye(A, dtype=torch.bool, device=dev))
    no_overlap = distinct.all(-1).all(-1)

    has = state.agent_req >= 0
    safe = state.agent_req.clamp(0, R - 1).long()
    agents = torch.arange(A, dtype=state.req_agent.dtype, device=dev)
    pair_ok = torch.where(has, torch.gather(state.req_agent, 1, safe)
                          == agents, ~state.carrying).all(-1)
    carry_ok = torch.where(
        has, state.carrying == (torch.gather(state.req_status, 1, safe)
                                == IN_TRANSIT),
        ~state.carrying).all(-1)

    r_has = state.req_agent >= 0
    r_safe = state.req_agent.clamp(0, A - 1).long()
    slots = torch.arange(R, dtype=state.agent_req.dtype, device=dev)
    rpair_ok = torch.where(r_has, torch.gather(state.agent_req, 1, r_safe)
                           == slots, True).all(-1)
    empty_ok = torch.where(state.req_status == EMPTY, ~r_has, True).all(-1)
    transit_ok = torch.where(state.req_status == IN_TRANSIT, r_has,
                             True).all(-1)
    return (pos_ok & no_overlap & pair_ok & carry_ok & rpair_ok & empty_ok
            & transit_ok)

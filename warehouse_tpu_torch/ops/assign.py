"""Request-to-agent assignment (docs/SEMANTICS.md §7) on batched tensors.

Counterpart of ``warehouse_tpu/ops/assign.py``: agents take the nearest
available PENDING request in index order, so agent i's take is visible to
agent i+1. Ties at equal distance go to the lowest slot, written out as
a min over slot ids (``torch.argmin`` does not promise the first index
on CUDA).
"""

from __future__ import annotations

import torch

from ..config import EnvConfig

PENDING = 1
BIG = 1 << 30


def assign_requests(cfg: EnvConfig, agent_pos, agent_req, req_pickup,
                    req_status, req_agent):
    """Sticky nearest-pending assignment: ``(agent_req, req_agent)``."""
    R = cfg.queue_capacity
    dist = (agent_pos[:, :, None, :] - req_pickup[:, None, :, :]).abs().sum(-1)
    slots = torch.arange(R, dtype=torch.int32, device=agent_pos.device)
    agent_req = agent_req.clone()
    for i in range(cfg.num_agents):
        avail = (req_status == PENDING) & (req_agent < 0)
        d = torch.where(avail, dist[:, i], BIG)
        best = d.min(-1, keepdim=True).values
        r = torch.where(d == best, slots, BIG).min(-1).values
        take = (agent_req[:, i] < 0) & avail.any(-1)
        agent_req[:, i] = torch.where(take, r, agent_req[:, i])
        req_agent = torch.where(take[:, None] & (slots == r[:, None]),
                                i, req_agent)
    return agent_req, req_agent

"""Batched greedy nearest-request policy (docs/SEMANTICS.md §12).

Counterpart of ``warehouse_tpu/baselines/greedy.py`` ``greedy_actions``.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig

from ..env.state import EnvState
from ..ops.obs import targets

STAY, UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3, 4


def greedy_actions(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """int32[B, A]: close the row gap first, then the column gap."""
    has, tgt = targets(cfg, state.agent_pos, state.agent_req, state.carrying,
                       state.req_pickup, state.req_drop)
    d = tgt - state.agent_pos
    vert = torch.where(d[..., 0] < 0, UP, DOWN)
    horiz = torch.where(d[..., 1] < 0, LEFT, RIGHT)
    act = torch.where(d[..., 0] != 0, vert,
                      torch.where(d[..., 1] != 0, horiz, STAY))
    return torch.where(has, act, STAY).to(torch.int32)

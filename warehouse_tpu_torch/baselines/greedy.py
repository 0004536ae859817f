"""Batched greedy nearest-request policies (docs/SEMANTICS.md §12, §12a).

Counterpart of ``warehouse_tpu/baselines/greedy.py``: ``greedy_actions``
closes the row gap then the column gap and ignores walls;
``greedy_bfs_actions`` steps to the neighbour nearest its target by the
BFS table of ``ops/pathing.py``.
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


def target_cells(cfg: EnvConfig, state: EnvState):
    """``(target_cell int32[B, A], has_task bool[B, A])``: each agent's
    navigation target, the assigned pickup cell or the drop cell once
    carrying; cell 0 without a task, as the JAX function's one-hot read
    gives it."""
    has, tgt = targets(cfg, state.agent_pos, state.agent_req, state.carrying,
                       state.req_pickup, state.req_drop)
    cell = tgt[..., 0] * cfg.width + tgt[..., 1]
    return torch.where(has, cell, 0).to(torch.int32), has


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The index of the minimum along ``dim``, the lowest on a tie, written
    out: ``torch.argmin`` does not promise the first on every device."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    is_min = x == x.amin(dim=dim, keepdim=True)
    return torch.where(is_min, idx, n).amin(dim=dim)


def greedy_bfs_actions(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """int32[B, A]: the obstacle-aware greedy (docs/SEMANTICS.md §12a). Of
    the five candidates in §3 action order (stay, up, down, left, right)
    the one whose cell is nearest the target by BFS distance, the lowest
    index on a tie; a candidate off the grid counts ``2 * UNREACHABLE``, a
    wall cell ``UNREACHABLE`` (its table entry); ``STAY`` without a task."""
    from ..ops.pathing import UNREACHABLE, device_table, dist_rows

    H, W = cfg.height, cfg.width
    dev = state.agent_pos.device
    target_cell, has = target_cells(cfg, state)
    rows = dist_rows(cfg, device_table(cfg, dev), target_cell)  # [B, A, C]
    deltas = torch.tensor([(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)],
                          dtype=torch.int32, device=dev)
    prop = state.agent_pos[..., None, :] + deltas               # [B, A, 5, 2]
    r, c = prop[..., 0], prop[..., 1]
    in_grid = (r >= 0) & (r < H) & (c >= 0) & (c < W)
    prop_cell = r.clamp(0, H - 1) * W + c.clamp(0, W - 1)       # [B, A, 5]
    cand = torch.gather(rows, -1, prop_cell.long())
    cand = torch.where(in_grid, cand, 2.0 * float(UNREACHABLE))
    act = first_argmin(cand, -1).to(torch.int32)
    return torch.where(has, act, STAY)

"""Movement and collision resolution (docs/SEMANTICS.md §4.1), batched.

Counterpart of ``warehouse_tpu/ops/move.py``: rules 1-3 as [B, A, A]
boolean matrices, rule 4 as a fixed point unrolled A times (each pass
only ever reverts moves, so A passes suffice).
"""

from __future__ import annotations

import torch

from ..config import EnvConfig

# STAY, UP, DOWN, LEFT, RIGHT (docs/SEMANTICS.md §3).
ACTION_DELTAS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))


def _deltas(device) -> torch.Tensor:
    return torch.tensor(ACTION_DELTAS, dtype=torch.int32, device=device)


def _blocked(cfg: EnvConfig, prop: torch.Tensor) -> torch.Tensor:
    """Off-grid or wall target cells (rule 1, static part)."""
    out = ((prop[..., 0] < 0) | (prop[..., 0] >= cfg.height)
           | (prop[..., 1] < 0) | (prop[..., 1] >= cfg.width))
    if cfg.walls:
        cell = prop[..., 0] * cfg.width + prop[..., 1]
        walls = torch.tensor(cfg.walls, dtype=torch.int32, device=prop.device)
        out = out | (cell[..., None] == walls).any(-1)
    return out


def resolve_moves(cfg: EnvConfig, pos: torch.Tensor, actions: torch.Tensor):
    """Resolve simultaneous moves.

    Args:
      pos: int32[B, A, 2] current cells.
      actions: int32[B, A] in [0, 5).

    Returns:
      (new_pos int32[B, A, 2], collided bool[B, A]) — ``collided[b, i]``
      iff agent i proposed a move (action != STAY) that was reverted.
    """
    A = cfg.num_agents
    proposed = actions != 0
    prop = pos + _deltas(pos.device)[actions.long()]
    moving = proposed & ~_blocked(cfg, prop)

    def settle():
        return torch.where(moving[..., None], prop, pos)

    prop = settle()
    eye = torch.eye(A, dtype=torch.bool, device=pos.device)
    lower = torch.tril(torch.ones(A, A, dtype=torch.bool, device=pos.device),
                       diagonal=-1)                     # [i, j]: j < i

    # Rule 2: same target — lowest agent index wins.
    tgt = prop[..., 0] * cfg.width + prop[..., 1]
    both = moving[:, :, None] & moving[:, None, :]
    same = (tgt[:, :, None] == tgt[:, None, :]) & both
    moving = moving & ~(same & lower).any(-1)
    prop = settle()

    # Rule 3: swaps — both revert.
    both = moving[:, :, None] & moving[:, None, :]
    i_to_j = (prop[:, :, None, :] == pos[:, None, :, :]).all(-1)
    swap = (i_to_j & i_to_j.transpose(1, 2) & both & ~eye).any(-1)
    moving = moving & ~swap
    prop = settle()

    # Rule 4: a move into a cell held by a non-mover reverts; A passes.
    for _ in range(A):
        hits = (prop[:, :, None, :] == prop[:, None, :, :]).all(-1)
        blocked = (hits & ~moving[:, None, :] & ~eye).any(-1)
        moving = moving & ~blocked
        prop = settle()

    return prop, proposed & ~moving


def valid_action_mask(cfg: EnvConfig, pos: torch.Tensor) -> torch.Tensor:
    """bool[..., A, 5]: the move stays on the grid and off the walls."""
    prop = pos[..., None, :] + _deltas(pos.device)
    return ~_blocked(cfg, prop)

"""All-pairs BFS shortest-path distances over the static layout.

Counterpart of ``warehouse_tpu/ops/pathing.py``. The wall layout is part
of the frozen ``EnvConfig``, so the all-pairs table is computed once per
config on the host in NumPy (``distance_table``) and kept on each device
that reads it (``device_table``). Path planning is then a table read. The
JAX functions read the table by one-hot products in float32; every such
sum selects exactly one element, so the index reads here give the same
bits.

Used by the obstacle-aware greedy baseline
(``baselines.greedy.greedy_bfs_actions``) and by the potential-based
reward shaping of the acting kernels (``kernels/act.py``; Ng et al. 1999:
``r + gamma * phi(s') - phi(s)`` with ``phi = -BFS distance to the
agent's target``). With no walls the table is the Manhattan distance.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import EnvConfig
from ..env.state import EnvState

# Unreachable / wall sentinel: finite, so integer arithmetic cannot
# overflow, and far larger than any real grid distance.
UNREACHABLE = np.int32(1 << 14)


@functools.lru_cache(maxsize=None)
def distance_table(cfg: EnvConfig) -> np.ndarray:
    """int32[C, C] BFS distances between all cell pairs; row-major ids.

    ``table[a, b]`` is the length of the shortest 4-neighbour path from
    cell ``a`` to cell ``b`` through non-wall cells, or ``UNREACHABLE`` if
    either endpoint is a wall or no path exists. Symmetric.
    """
    H, W, C = cfg.height, cfg.width, cfg.num_cells
    wall = np.zeros(C, dtype=bool)
    wall[list(cfg.walls)] = True

    table = np.full((C, C), UNREACHABLE, dtype=np.int32)
    for src in range(C):
        if wall[src]:
            continue
        dist = np.full(C, UNREACHABLE, dtype=np.int32)
        dist[src] = 0
        frontier = [src]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for c in frontier:
                r, col = divmod(c, W)
                for nc in (
                    c - W if r > 0 else -1,
                    c + W if r < H - 1 else -1,
                    c - 1 if col > 0 else -1,
                    c + 1 if col < W - 1 else -1,
                ):
                    if nc >= 0 and not wall[nc] and dist[nc] == UNREACHABLE:
                        dist[nc] = d
                        nxt.append(nc)
            frontier = nxt
        table[src] = dist
    return table


@functools.lru_cache(maxsize=None)
def _device_table(cfg: EnvConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(distance_table(cfg)).to(device)


def device_table(cfg: EnvConfig, device) -> torch.Tensor:
    """``distance_table(cfg)`` as an int32 ``[C, C]`` tensor on ``device``,
    cached per (config, device)."""
    return _device_table(cfg, torch.device(device))


def dist_rows(cfg: EnvConfig, table: torch.Tensor,
              target_cell: torch.Tensor) -> torch.Tensor:
    """float32[..., C]: the BFS distance from every cell to each target,
    ``rows[..., c] = table[c, target_cell[...]]``."""
    return table.t()[target_cell.long()].to(torch.float32)


def dist_to_targets(cfg: EnvConfig, table: torch.Tensor, cell: torch.Tensor,
                    target_cell: torch.Tensor) -> torch.Tensor:
    """float32[...]: ``table[cell, target_cell]`` elementwise."""
    return table[cell.long(), target_cell.long()].to(torch.float32)


def potential(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """float32[B, A] shaping potential ``phi(s) = -BFS_dist(pos, target)``,
    0 if the agent has no task or its target is unreachable."""
    from ..baselines.greedy import target_cells

    table = device_table(cfg, state.agent_pos.device)
    target_cell, has = target_cells(cfg, state)
    pos_cell = state.agent_pos[..., 0] * cfg.width + state.agent_pos[..., 1]
    d = dist_to_targets(cfg, table, pos_cell, target_cell)
    ok = has & (d < float(UNREACHABLE))
    return torch.where(ok, -d, 0.0).to(torch.float32)

"""NumPy greedy nearest-request baseline solver (docs/SEMANTICS.md §12).

The port's copy of ``warehouse_tpu/oracle/greedy.py``. The batched twin is
``warehouse_tpu_torch/baselines/greedy.py`` (and K1's in-kernel greedy
step) and must match this bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from ..config import EnvConfig
from .env import OracleState

STAY, UP, DOWN, LEFT, RIGHT = 0, 1, 2, 3, 4


def greedy_actions(cfg: EnvConfig, s: OracleState) -> np.ndarray:
    """Per-agent greedy action from privileged state."""
    A = cfg.num_agents
    actions = np.zeros(A, dtype=np.int64)
    for i in range(A):
        r = s.agent_req[i]
        if r < 0:
            actions[i] = STAY
            continue
        target = s.req_drop[r] if s.carrying[i] else s.req_pickup[r]
        drow = int(target[0] - s.agent_pos[i][0])
        dcol = int(target[1] - s.agent_pos[i][1])
        if drow != 0:
            actions[i] = UP if drow < 0 else DOWN
        elif dcol != 0:
            actions[i] = LEFT if dcol < 0 else RIGHT
        else:
            actions[i] = STAY
    return actions


_DELTAS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))  # §3 action order


def greedy_bfs_actions(cfg: EnvConfig, s: OracleState) -> np.ndarray:
    """Obstacle-aware greedy via the BFS table (docs/SEMANTICS.md §12a)."""
    from ..ops.pathing import UNREACHABLE, distance_table

    table = distance_table(cfg)
    A = cfg.num_agents
    actions = np.zeros(A, dtype=np.int64)
    for i in range(A):
        r = s.agent_req[i]
        if r < 0:
            actions[i] = STAY
            continue
        target = s.req_drop[r] if s.carrying[i] else s.req_pickup[r]
        tcell = int(target[0]) * cfg.width + int(target[1])
        best_a, best_d = STAY, None
        for a, (dr, dc) in enumerate(_DELTAS):
            pr = int(s.agent_pos[i][0]) + dr
            pc = int(s.agent_pos[i][1]) + dc
            if not (0 <= pr < cfg.height and 0 <= pc < cfg.width):
                d = 2 * int(UNREACHABLE)
            else:
                d = int(table[pr * cfg.width + pc, tcell])
            if best_d is None or d < best_d:
                best_a, best_d = a, d
        actions[i] = best_a
    return actions

"""NumPy oracle environment — readable, step-for-step (docs/SEMANTICS.md).

This is the executable form of the spec: simple Python loops, one function
per sub-step, in the exact sub-step order of SEMANTICS.md §4 (the port's
copy of ``warehouse_tpu/oracle/env.py``). The port's engine
(``warehouse_tpu_torch/env/engine.py``) and its env kernels must match it
bit-for-bit when fed the same draws (``tests/test_torch_oracle.py``;
``chip_smoke.py`` holds K1 against it on the card).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..config import EnvConfig
from .draws import DrawSource, StepDrawsNp

EMPTY, PENDING, IN_TRANSIT = 0, 1, 2

# Action deltas, docs/SEMANTICS.md §3: STAY, UP, DOWN, LEFT, RIGHT.
ACTION_DELTAS = np.array(
    [[0, 0], [-1, 0], [1, 0], [0, -1], [0, 1]], dtype=np.int64
)


@dataclasses.dataclass
class OracleState:
    agent_pos: np.ndarray   # int [A, 2]
    agent_req: np.ndarray   # int [A], -1 = none
    carrying: np.ndarray    # bool [A]
    req_pickup: np.ndarray  # int [R, 2]
    req_drop: np.ndarray    # int [R, 2]
    req_status: np.ndarray  # int [R]
    req_agent: np.ndarray   # int [R], -1 = none
    t: int

    def copy(self) -> "OracleState":
        return OracleState(
            self.agent_pos.copy(), self.agent_req.copy(),
            self.carrying.copy(), self.req_pickup.copy(),
            self.req_drop.copy(), self.req_status.copy(),
            self.req_agent.copy(), self.t,
        )


def cell_to_rc(cell: int, width: int) -> tuple[int, int]:
    return int(cell) // width, int(cell) % width


class OracleEnv:
    """Single-instance warehouse env over a pluggable draw source."""

    def __init__(self, cfg: EnvConfig, draws: DrawSource) -> None:
        self.cfg = cfg
        self.draws = draws
        self.state: OracleState | None = None

    # ------------------------------------------------------------- reset
    def reset(self) -> np.ndarray:
        cfg = self.cfg
        d = self.draws.reset(cfg)
        return self._apply_reset(d)

    def _apply_reset(self, d) -> np.ndarray:
        cfg = self.cfg
        A, R = cfg.num_agents, cfg.queue_capacity
        agent_pos = np.zeros((A, 2), dtype=np.int64)
        for i in range(A):
            agent_pos[i] = cell_to_rc(d.agent_cells[i], cfg.width)
        req_pickup = np.zeros((R, 2), dtype=np.int64)
        req_drop = np.zeros((R, 2), dtype=np.int64)
        req_status = np.zeros(R, dtype=np.int64)
        req_agent = np.full(R, -1, dtype=np.int64)
        for s in range(cfg.init_requests):
            req_pickup[s] = cell_to_rc(d.req_pick[s], cfg.width)
            req_drop[s] = cell_to_rc(d.req_drop[s], cfg.width)
            req_status[s] = PENDING
        self.state = OracleState(
            agent_pos=agent_pos,
            agent_req=np.full(A, -1, dtype=np.int64),
            carrying=np.zeros(A, dtype=bool),
            req_pickup=req_pickup,
            req_drop=req_drop,
            req_status=req_status,
            req_agent=req_agent,
            t=0,
        )
        return self._observe()

    # -------------------------------------------------------------- step
    def step(self, actions: np.ndarray):
        cfg = self.cfg
        s = self.state
        assert s is not None, "call reset() first"
        actions = np.asarray(actions, dtype=np.int64)
        assert actions.shape == (cfg.num_agents,)

        collided = self._move(s, actions)            # §4.1
        picked = self._pickup(s)                     # §5
        delivered = self._deliver(s)                 # §5
        self._spawn(s, self.draws.step(cfg))         # §6
        self._assign(s)                              # §7
        # §8 — float32 arithmetic throughout, matching the engine exactly
        # (float64-then-cast could differ by 1 ulp).
        rewards = (
            np.float32(cfg.step_penalty)
            + np.float32(cfg.pickup_reward) * picked.astype(np.float32)
            + np.float32(cfg.delivery_reward) * delivered.astype(np.float32)
            + np.float32(cfg.collision_penalty) * collided.astype(np.float32)
        ).astype(np.float32)
        s.t += 1
        truncated = s.t >= cfg.max_steps
        obs = self._observe()                        # §10
        info = {"picked": picked, "delivered": delivered,
                "collided": collided}
        if cfg.auto_reset and truncated:
            obs = self._apply_reset(self.draws.reset_from_step(cfg))
        return obs, rewards, False, truncated, info

    # ------------------------------------------------- §4.1 move/collide
    def _move(self, s: OracleState, actions: np.ndarray) -> np.ndarray:
        cfg = self.cfg
        A = cfg.num_agents
        pos = s.agent_pos
        prop = pos + ACTION_DELTAS[actions]
        moving = actions != 0
        collided = np.zeros(A, dtype=bool)

        # Rule 1: bounds + static walls (§1a).
        wall_set = set(cfg.walls)
        for i in range(A):
            r, c = prop[i]
            blocked = not (0 <= r < cfg.height and 0 <= c < cfg.width)
            if not blocked and wall_set:
                blocked = int(r) * cfg.width + int(c) in wall_set
            if moving[i] and blocked:
                prop[i] = pos[i]
                moving[i] = False
                collided[i] = True

        # Rule 2: same-target — lowest index wins.
        for i in range(A):
            if not moving[i]:
                continue
            for j in range(i):
                if moving[j] and (prop[j] == prop[i]).all():
                    prop[i] = pos[i]
                    moving[i] = False
                    collided[i] = True
                    break

        # Rule 3: swaps — both revert.
        swap = np.zeros(A, dtype=bool)
        for i in range(A):
            for j in range(i + 1, A):
                if (moving[i] and moving[j]
                        and (prop[i] == pos[j]).all()
                        and (prop[j] == pos[i]).all()):
                    swap[i] = swap[j] = True
        for i in range(A):
            if swap[i]:
                prop[i] = pos[i]
                moving[i] = False
                collided[i] = True

        # Rule 4: blocked-cell fixed point (≤ A iterations).
        for _ in range(A):
            changed = False
            for i in range(A):
                if not moving[i]:
                    continue
                for j in range(A):
                    if j != i and not moving[j] and (prop[i] == prop[j]).all():
                        # prop[j] == pos[j] for non-moving j.
                        prop[i] = pos[i]
                        moving[i] = False
                        collided[i] = True
                        changed = True
                        break
            if not changed:
                break

        s.agent_pos = prop
        return collided

    # --------------------------------------------------------- §5 pickup
    def _pickup(self, s: OracleState) -> np.ndarray:
        A = self.cfg.num_agents
        picked = np.zeros(A, dtype=bool)
        for i in range(A):
            r = s.agent_req[i]
            if (r >= 0 and not s.carrying[i]
                    and s.req_status[r] == PENDING
                    and (s.agent_pos[i] == s.req_pickup[r]).all()):
                s.carrying[i] = True
                s.req_status[r] = IN_TRANSIT
                picked[i] = True
        return picked

    # -------------------------------------------------------- §5 deliver
    def _deliver(self, s: OracleState) -> np.ndarray:
        A = self.cfg.num_agents
        delivered = np.zeros(A, dtype=bool)
        for i in range(A):
            r = s.agent_req[i]
            if (r >= 0 and s.carrying[i]
                    and (s.agent_pos[i] == s.req_drop[r]).all()):
                s.req_status[r] = EMPTY
                s.req_agent[r] = -1
                s.req_pickup[r] = 0
                s.req_drop[r] = 0
                s.agent_req[i] = -1
                s.carrying[i] = False
                delivered[i] = True
        return delivered

    # ---------------------------------------------------------- §6 spawn
    def _spawn(self, s: OracleState, d: StepDrawsNp) -> None:
        cfg = self.cfg
        if d.spawn_u >= cfg.spawn_prob:
            return
        empty = np.nonzero(s.req_status == EMPTY)[0]
        if empty.size == 0:
            return
        slot = int(empty[0])  # lowest-index empty slot
        s.req_pickup[slot] = cell_to_rc(d.spawn_pick, cfg.width)
        s.req_drop[slot] = cell_to_rc(d.spawn_drop, cfg.width)
        s.req_status[slot] = PENDING
        s.req_agent[slot] = -1

    # --------------------------------------------------------- §7 assign
    def _assign(self, s: OracleState) -> None:
        cfg = self.cfg
        for i in range(cfg.num_agents):
            if s.agent_req[i] >= 0:
                continue
            best_r, best_d = -1, None
            for r in range(cfg.queue_capacity):
                if s.req_status[r] != PENDING or s.req_agent[r] >= 0:
                    continue
                dist = int(np.abs(s.agent_pos[i] - s.req_pickup[r]).sum())
                if best_d is None or dist < best_d:  # ties: lowest r wins
                    best_r, best_d = r, dist
            if best_r >= 0:
                s.agent_req[i] = best_r
                s.req_agent[best_r] = i

    # ----------------------------------------------------------- §10 obs
    def _target(self, s: OracleState, i: int):
        """(has_task, target_cell) — pickup if not carrying, else drop."""
        r = s.agent_req[i]
        if r < 0:
            return False, s.agent_pos[i]
        return True, (s.req_drop[r] if s.carrying[i] else s.req_pickup[r])

    def _observe(self) -> np.ndarray:
        cfg = self.cfg
        s = self.state
        if cfg.global_obs:
            return self._observe_global(s)
        A, k = cfg.num_agents, cfg.obs_radius
        S = cfg.window_size
        out = np.zeros((A, cfg.obs_dim), dtype=np.float32)
        for i in range(A):
            win = np.zeros((S, S, 4), dtype=np.float32)
            pr, pc = s.agent_pos[i]
            has_task, tgt = self._target(s, i)
            for wr in range(S):
                for wc in range(S):
                    gr, gc = pr + wr - k, pc + wc - k
                    if not (0 <= gr < cfg.height and 0 <= gc < cfg.width):
                        continue
                    if int(gr) * cfg.width + int(gc) in set(cfg.walls):
                        # wall: visible entities can't be here; ch3 stays 0
                        continue
                    win[wr, wc, 3] = 1.0
                    for j in range(A):
                        if s.agent_pos[j][0] == gr and s.agent_pos[j][1] == gc:
                            win[wr, wc, 0] = 1.0
                    for r in range(cfg.queue_capacity):
                        if (s.req_status[r] == PENDING
                                and s.req_pickup[r][0] == gr
                                and s.req_pickup[r][1] == gc):
                            win[wr, wc, 1] = 1.0
                    if has_task and tgt[0] == gr and tgt[1] == gc:
                        win[wr, wc, 2] = 1.0
            feats = self._features(s, i)
            out[i] = np.concatenate([win.ravel(), feats])
        return out

    def _observe_global(self, s: OracleState) -> np.ndarray:
        cfg = self.cfg
        A = cfg.num_agents
        out = np.zeros((A, cfg.obs_dim), dtype=np.float32)
        pending = np.zeros((cfg.height, cfg.width), dtype=np.float32)
        for r in range(cfg.queue_capacity):
            if s.req_status[r] == PENDING:
                pending[tuple(s.req_pickup[r])] = 1.0
        free = np.ones((cfg.height, cfg.width), dtype=np.float32)
        for w in cfg.walls:
            free[cell_to_rc(w, cfg.width)] = 0.0
        for i in range(A):
            g = np.zeros((cfg.height, cfg.width, 5), dtype=np.float32)
            g[tuple(s.agent_pos[i]) + (0,)] = 1.0
            for j in range(A):
                if j != i:
                    g[tuple(s.agent_pos[j]) + (1,)] = 1.0
            g[:, :, 2] = pending
            has_task, tgt = self._target(s, i)
            if has_task:
                g[tuple(tgt) + (3,)] = 1.0
            g[:, :, 4] = free  # traversability (§1a): 0 on wall cells
            out[i] = np.concatenate([g.ravel(), self._features(s, i)])
        return out

    def _features(self, s: OracleState, i: int) -> np.ndarray:
        cfg = self.cfg
        has_task, tgt = self._target(s, i)
        delta = (tgt - s.agent_pos[i]) if has_task else np.zeros(2, np.int64)
        # Explicit float32 reciprocal MULTIPLY (not division): under jit
        # XLA strength-reduces x/const to x*(1/const), which rounds
        # differently from true division for some values (1 ulp at W=6,
        # found by hypothesis) — docs/SEMANTICS.md §10 pins the multiply.
        inv_h = np.float32(1.0) / np.float32(cfg.height)
        inv_w = np.float32(1.0) / np.float32(cfg.width)
        num = np.array(
            [
                s.agent_pos[i][0], s.agent_pos[i][1],
                int(s.carrying[i]), int(has_task),
                delta[0], delta[1],
            ],
            dtype=np.float32,
        )
        scale = np.array([inv_h, inv_w, 1.0, 1.0, inv_h, inv_w], np.float32)
        return num * scale

"""The warehouse engine: batched ``reset``/``step`` (docs/SEMANTICS.md).

Counterpart of ``warehouse_tpu/env/engine.py``, batched natively over a
leading env axis. ``tick`` is the draw-free core of a step: the
sub-steps in spec order given the spawn draws, so the plain twins of the
rollout kernels can feed it precomputed draw streams exactly as the
kernels consume them.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig

from .. import rng as _rng
from ..ops.assign import assign_requests
from ..ops.move import resolve_moves
from ..ops.obs import observe
from .state import EMPTY, IN_TRANSIT, PENDING, EnvState, TimeStep


def cell_to_rc(cell: torch.Tensor, width: int) -> torch.Tensor:
    return torch.stack([cell // width, cell % width], dim=-1).to(torch.int32)


def observe_state(cfg: EnvConfig, s: EnvState) -> torch.Tensor:
    return observe(cfg, s.agent_pos, s.agent_req, s.carrying, s.req_pickup,
                   s.req_drop, s.req_status)


def reset(cfg: EnvConfig, keys: torch.Tensor) -> tuple[EnvState, torch.Tensor]:
    """Fresh episodes for keys ``[B, 2]``: ``(state, obs)`` (§9)."""
    A, R, k = cfg.num_agents, cfg.queue_capacity, cfg.init_requests
    B, dev = keys.shape[0], keys.device
    d = _rng.reset_draws(keys, cfg)
    i32 = torch.int32
    req_pickup = torch.zeros(B, R, 2, dtype=i32, device=dev)
    req_drop = torch.zeros(B, R, 2, dtype=i32, device=dev)
    req_status = torch.zeros(B, R, dtype=i32, device=dev)
    req_pickup[:, :k] = cell_to_rc(d.req_pick, cfg.width)
    req_drop[:, :k] = cell_to_rc(d.req_drop, cfg.width)
    req_status[:, :k] = PENDING
    state = EnvState(
        agent_pos=cell_to_rc(d.agent_cells, cfg.width),
        agent_req=torch.full((B, A), -1, dtype=i32, device=dev),
        carrying=torch.zeros(B, A, dtype=torch.bool, device=dev),
        req_pickup=req_pickup,
        req_drop=req_drop,
        req_status=req_status,
        req_agent=torch.full((B, R), -1, dtype=i32, device=dev),
        t=torch.zeros(B, dtype=i32, device=dev),
        key=d.carry_key,
    )
    return state, observe_state(cfg, state)


def rewards(cfg: EnvConfig, picked, delivered, collided) -> torch.Tensor:
    """Per-agent float32 rewards (§8), summed in the spec's order."""
    f = torch.float32
    return (((cfg.step_penalty + cfg.pickup_reward * picked.to(f))
             + cfg.delivery_reward * delivered.to(f))
            + cfg.collision_penalty * collided.to(f))


def tick(cfg: EnvConfig, state: EnvState, actions: torch.Tensor,
         spawn_u: torch.Tensor, spawn_pick: torch.Tensor,
         spawn_drop: torch.Tensor):
    """Movement -> pickup -> delivery -> spawn -> assignment (§4-§7).

    Returns ``(state, picked, delivered, collided)``; the state's ``t``
    and ``key`` are left as they were.
    """
    R = cfg.queue_capacity
    actions = actions.to(torch.int32)
    agent_pos, collided = resolve_moves(cfg, state.agent_pos, actions)

    # 2. Pickup (§5): only the assigned agent picks up.
    has_req = state.agent_req >= 0
    idx = state.agent_req.clamp(0, R - 1).long()
    idx2 = idx[..., None].expand(*idx.shape, 2)
    my_pickup = torch.gather(state.req_pickup, 1, idx2)
    my_drop = torch.gather(state.req_drop, 1, idx2)
    my_status = torch.gather(state.req_status, 1, idx)
    picked = (has_req & ~state.carrying & (my_status == PENDING)
              & (agent_pos == my_pickup).all(-1))
    carrying = state.carrying | picked
    slots = torch.arange(R, device=idx.device)
    oh = (idx[..., None] == slots) & has_req[..., None]        # [B, A, R]
    req_status = torch.where((oh & picked[..., None]).any(1), IN_TRANSIT,
                             state.req_status)

    # 3. Delivery (§5), after pickup: pickup == drop completes this tick.
    delivered = has_req & carrying & (agent_pos == my_drop).all(-1)
    slot_del = (oh & delivered[..., None]).any(1)                # [B, R]
    req_status = torch.where(slot_del, EMPTY, req_status)
    req_agent = torch.where(slot_del, -1, state.req_agent)
    req_pickup = torch.where(slot_del[..., None], 0, state.req_pickup)
    req_drop = torch.where(slot_del[..., None], 0, state.req_drop)
    agent_req = torch.where(delivered, -1, state.agent_req)
    carrying = carrying & ~delivered

    # 4. Spawn (§6): the lowest EMPTY slot; draws are consumed regardless.
    is_empty = req_status == EMPTY
    first = torch.where(is_empty, slots, R).min(-1).values       # [B]
    w = (slots == first[:, None]) & (spawn_u < cfg.spawn_prob)[:, None]
    req_pickup = torch.where(w[..., None],
                             cell_to_rc(spawn_pick, cfg.width)[:, None],
                             req_pickup)
    req_drop = torch.where(w[..., None],
                           cell_to_rc(spawn_drop, cfg.width)[:, None],
                           req_drop)
    req_status = torch.where(w, PENDING, req_status)
    req_agent = torch.where(w, -1, req_agent)

    # 5. Assignment (§7).
    agent_req, req_agent = assign_requests(cfg, agent_pos, agent_req,
                                           req_pickup, req_status, req_agent)
    new = state.replace(
        agent_pos=agent_pos, agent_req=agent_req, carrying=carrying,
        req_pickup=req_pickup, req_drop=req_drop, req_status=req_status,
        req_agent=req_agent)
    return new, picked, delivered, collided


def step(cfg: EnvConfig, state: EnvState, actions: torch.Tensor,
         draws: _rng.StepDraws | None = None) -> tuple[EnvState, TimeStep]:
    """One tick for every env, sub-steps in the order of §4, with the
    per-env auto-reset of §4.9 when ``cfg.auto_reset``. ``draws``: the
    tick's ``StepDraws`` of ``state.key``, made here when not given."""
    if draws is None:
        draws = _rng.step_draws(state.key, cfg)
    new, picked, delivered, collided = tick(
        cfg, state, actions, draws.spawn_u, draws.spawn_pick,
        draws.spawn_drop)
    t = state.t + 1
    truncated = t >= cfg.max_steps
    new = new.replace(t=t, key=draws.next_key)
    obs = observe_state(cfg, new)
    final_obs = obs
    if cfg.auto_reset and bool(truncated.any()):
        reset_state, reset_obs = reset(cfg, draws.reset_key)
        new = reset_state.where(truncated, new)
        obs = torch.where(truncated[:, None, None], reset_obs, obs)
    ts = TimeStep(
        obs=obs, final_obs=final_obs,
        reward=rewards(cfg, picked, delivered, collided),
        terminated=torch.zeros_like(truncated), truncated=truncated,
        picked=picked, delivered=delivered, collided=collided)
    return new, ts

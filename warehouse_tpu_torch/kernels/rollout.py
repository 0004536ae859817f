"""K1: the greedy-baseline rollout kernel and its plain twin.

Counterpart of ``warehouse_tpu/pallas/rollout.py`` ``greedy_rollout_pallas``.
``greedy_rollout`` runs T greedy ticks for a batch of envs and returns
``(EnvState, delivered int32[B], reward_sum float32[B])``; the trajectory
equals a loop of ``greedy_actions`` + ``engine.step``. The spawn draws
come precomputed from ``rng.batched_step_draws``, as the JAX wrapper
computes them. On a CUDA tensor the CUDA kernel (``csrc/rollout.cu``)
runs; on a CPU tensor the plain twin does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EnvConfig

from .. import rng as _rng
from ..baselines.greedy import greedy_actions
from ..env import engine
from ..env.state import EnvState
from . import build

# (num_agents, queue_capacity) the CUDA kernels are instantiated for: the
# four presets of config.py.
KERNEL_SHAPES = ((2, 4), (4, 8), (6, 12), (8, 16))
STATE_INT_FIELDS = ("agent_pos", "agent_req", "carrying", "req_pickup",
                    "req_drop", "req_status", "req_agent")


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python scalar constant."""
    return float(np.float32(x))


def check_kernel_shape(cfg: EnvConfig) -> None:
    shape = (cfg.num_agents, cfg.queue_capacity)
    if shape not in KERNEL_SHAPES:
        raise ValueError(
            f"the CUDA env kernels are built for (num_agents, "
            f"queue_capacity) in {KERNEL_SHAPES}, got {shape}")


def check_multiple_of_4(kernel: str, widths: dict) -> None:
    """Raise ``ValueError`` naming ``kernel`` and the first of ``widths``
    (name -> width) that is not a multiple of 4: the CUDA kernels lay such
    widths out in float4 lanes and refuse the others on the card (ROADMAP
    T-6), which the JAX package trains."""
    for name, w in widths.items():
        if w % 4:
            raise ValueError(
                f"{kernel} takes {name} widths that are multiples of 4 on "
                f"the card, got {name} {w} (ROADMAP T-6)")


def wall_mask(cfg: EnvConfig, device) -> torch.Tensor:
    """uint8[H * W], 1 on wall cells: the kernels' layout input."""
    m = torch.zeros(cfg.num_cells, dtype=torch.uint8)
    if cfg.walls:
        m[list(cfg.walls)] = 1
    return m.to(device)


def kernel_state(state: EnvState) -> list[torch.Tensor]:
    """The int fields as contiguous int32 tensors, in the C argument order."""
    return [getattr(state, f).to(torch.int32).contiguous()
            for f in STATE_INT_FIELDS]


def state_from_kernel(outs, t, key) -> EnvState:
    fields = dict(zip(STATE_INT_FIELDS, outs))
    fields["carrying"] = fields["carrying"].bool()
    return EnvState(**fields, t=t, key=key)


def reward_sum_step(cfg: EnvConfig, n_pick, n_del, n_col) -> torch.Tensor:
    """One tick's summed team reward in the order of rollout.py:488-493."""
    return (((f32(cfg.step_penalty * cfg.num_agents)
              + cfg.pickup_reward * n_pick)
             + cfg.delivery_reward * n_del)
            + cfg.collision_penalty * n_col)


def greedy_steps_reference(cfg: EnvConfig, state: EnvState, u, pick, drop):
    """Plain PyTorch twin of the kernel: T = ``u.shape[0]`` ticks of
    ``greedy_actions`` + ``engine.tick`` on the given draws."""
    B = state.agent_pos.shape[0]
    dev = state.agent_pos.device
    deliv = torch.zeros(B, dtype=torch.int32, device=dev)
    rew = torch.zeros(B, dtype=torch.float32, device=dev)
    for t in range(u.shape[0]):
        act = greedy_actions(cfg, state)
        state, picked, delivered, collided = engine.tick(
            cfg, state, act, u[t], pick[t], drop[t])
        f = torch.float32
        deliv = deliv + delivered.sum(-1, dtype=torch.int32)
        rew = rew + reward_sum_step(cfg, picked.sum(-1).to(f),
                                    delivered.sum(-1).to(f),
                                    collided.sum(-1).to(f))
    return state, deliv, rew


def greedy_steps(cfg: EnvConfig, state: EnvState, u, pick, drop):
    """T greedy ticks on precomputed draws: the CUDA kernel for CUDA
    tensors, the plain twin for CPU tensors. Returns ``(state, delivered,
    reward_sum)``; ``t`` and ``key`` are left as they were."""
    dev = state.agent_pos.device
    if dev.type == "cpu":
        return greedy_steps_reference(cfg, state, u, pick, drop)
    if dev.type != "cuda":
        raise ValueError(f"greedy_steps: unsupported device {dev}")
    check_kernel_shape(cfg)
    B, T = state.agent_pos.shape[0], u.shape[0]
    ins = kernel_state(state)
    draws = [u.to(torch.float32).contiguous(),
             pick.to(torch.int32).contiguous(),
             drop.to(torch.int32).contiguous()]
    for x in draws:
        if x.shape != (T, B) or x.device != dev:
            raise ValueError(f"draws must be [T, B] = {(T, B)} on {dev}")
    outs = [torch.empty_like(x) for x in ins]
    deliv = torch.empty(B, dtype=torch.int32, device=dev)
    rew = torch.empty(B, dtype=torch.float32, device=dev)
    walls = wall_mask(cfg, dev)
    lib = build.library()
    err = lib.wh_greedy_rollout(
        cfg.num_agents, cfg.queue_capacity, B, T, cfg.height, cfg.width,
        f32(cfg.spawn_prob), f32(cfg.step_penalty * cfg.num_agents),
        f32(cfg.pickup_reward), f32(cfg.delivery_reward),
        f32(cfg.collision_penalty), walls.data_ptr(),
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in draws),
        *(x.data_ptr() for x in outs), deliv.data_ptr(), rew.data_ptr(),
        build.stream_handle(dev))
    build.check(err, "greedy_rollout kernel launch")
    greedy_steps.launches += 1
    return state_from_kernel(outs, state.t, state.key), deliv, rew


greedy_steps.launches = 0


def _rollout(steps, cfg: EnvConfig, state: EnvState, T: int):
    if cfg.auto_reset:
        raise ValueError("greedy_rollout does not support auto_reset")
    final_keys, u, pick, drop, _ = _rng.batched_step_draws(state.key, cfg, T)
    new, deliv, rew = steps(cfg, state, u, pick, drop)
    return new.replace(t=state.t + T, key=final_keys), deliv, rew


def greedy_rollout(cfg: EnvConfig, state: EnvState, T: int):
    """T greedy steps for a batched state: ``(EnvState, delivered int32[B],
    reward_sum float32[B])``, through the kernel on a CUDA state."""
    return _rollout(greedy_steps, cfg, state, T)


def greedy_rollout_reference(cfg: EnvConfig, state: EnvState, T: int):
    """The plain PyTorch twin of ``greedy_rollout`` on any device."""
    return _rollout(greedy_steps_reference, cfg, state, T)

"""K1: the greedy-baseline rollout kernel and its plain twin.

Counterpart of ``warehouse_tpu/pallas/rollout.py`` ``greedy_rollout_pallas``
with the draw stream it makes before its kernel. ``greedy_rollout`` runs T
greedy ticks for a batch of envs and returns ``(EnvState, delivered
int32[B], reward_sum float32[B])``; the trajectory equals a loop of
``greedy_actions`` + ``engine.step``. On a CUDA state one launch of
``csrc/rollout.cu`` makes each env's draws in registers from its key chain
(``csrc/threefry.cuh``) and runs its ticks: no draw is made on the host;
the instance is the pair's (``build.env_library``: the library's for a
preset, any other pair's own library built at its first use). On a CPU
state the plain twin runs: ``rng.batched_step_draws`` then
``greedy_steps_reference``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import EnvConfig

from .. import rng as _rng
from ..baselines.greedy import greedy_actions
from ..env import engine
from ..env.state import EnvState
from . import build

STATE_INT_FIELDS = ("agent_pos", "agent_req", "carrying", "req_pickup",
                    "req_drop", "req_status", "req_agent")


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a Python scalar constant."""
    return float(np.float32(x))


@functools.lru_cache(maxsize=None)
def _map_tables(cfg: EnvConfig, device: torch.device):
    mask = torch.zeros(cfg.num_cells, dtype=torch.uint8)
    if cfg.walls:
        mask[list(cfg.walls)] = 1
    return mask.to(device), _rng.free_cells(cfg, device)


def map_tables(cfg: EnvConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(walls uint8[H * W], 1 on wall cells; free int32[num_free], the
    free cells' row-major ids)``: the kernels' layout inputs, made once per
    (config, device)."""
    return _map_tables(cfg, torch.device(device))


def wall_mask(cfg: EnvConfig, device) -> torch.Tensor:
    """uint8[H * W], 1 on wall cells: the kernels' layout input."""
    return map_tables(cfg, device)[0]


def span_mod(span: int) -> tuple[int, int, int, int]:
    """``(magic, sh1, sh2, mult)`` of threefry.cuh's ``SpanMod`` for
    ``randint(key, (), 0, span)``: Granlund and Montgomery's constants for
    an exact ``x mod span`` of any uint32 ``x`` by one multiply-high (``l =
    ceil(log2 span)``, ``magic = floor(2^32 (2^l - span) / span) + 1``,
    ``sh1 = min(l, 1)``, ``sh2 = max(l - 1, 0)``), and ``rng.randint``'s
    multiplier ``(2^16 mod span)^2 mod span``. Host integers: the kernel
    takes them as arguments."""
    if not 1 <= span < 2 ** 32:
        raise ValueError(f"span must be in [1, 2^32), got {span}")
    lg = (span - 1).bit_length()
    magic = (2 ** 32 * (2 ** lg - span)) // span + 1
    mult = ((2 ** 16 % span) ** 2 & _rng.M32) % span
    return magic, min(lg, 1), max(lg - 1, 0), mult


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


def _check_rollout(cfg: EnvConfig, state: EnvState) -> torch.device:
    if cfg.auto_reset:
        raise ValueError("greedy_rollout does not support auto_reset")
    dev = state.agent_pos.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"greedy_rollout: unsupported device {dev}")
    return dev


def _span_args(cfg: EnvConfig) -> tuple:
    return (cfg.num_free, *span_mod(cfg.num_free))


def greedy_rollout(cfg: EnvConfig, state: EnvState, T: int):
    """T greedy steps for a batched state: ``(EnvState, delivered int32[B],
    reward_sum float32[B])``. On a CUDA state, one launch of the kernel,
    which makes the draws too; on a CPU state, ``greedy_rollout_reference``."""
    dev = _check_rollout(cfg, state)
    if dev.type == "cpu":
        return greedy_rollout_reference(cfg, state, T)
    lib = build.env_library(cfg.num_agents, cfg.queue_capacity)
    out = greedy_rollout_launch(lib, cfg, state, T)
    greedy_rollout.launches += 1
    return out


def greedy_rollout_launch(lib, cfg: EnvConfig, state: EnvState, T: int):
    """One launch of ``lib``'s ``wh_greedy_rollout`` (the K1 of
    ``build.env_library`` for the pair, or another build of
    ``csrc/rollout.cu``) on a CUDA state; what ``greedy_rollout``
    returns."""
    dev = state.agent_pos.device
    B = state.agent_pos.shape[0]
    ins = kernel_state(state)
    key = state.key.to(torch.int64).contiguous()
    t = state.t.to(torch.int32).contiguous()
    outs = [torch.empty_like(x) for x in ins]
    o_key, o_t = torch.empty_like(key), torch.empty_like(t)
    deliv = torch.empty(B, dtype=torch.int32, device=dev)
    rew = torch.empty(B, dtype=torch.float32, device=dev)
    walls, free = map_tables(cfg, dev)
    err = lib.wh_greedy_rollout(
        cfg.num_agents, cfg.queue_capacity, B, T, cfg.height, cfg.width,
        *_span_args(cfg), f32(cfg.spawn_prob),
        f32(cfg.step_penalty * cfg.num_agents), f32(cfg.pickup_reward),
        f32(cfg.delivery_reward), f32(cfg.collision_penalty),
        walls.data_ptr(), free.data_ptr(), key.data_ptr(), t.data_ptr(),
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in outs),
        o_key.data_ptr(), o_t.data_ptr(), deliv.data_ptr(), rew.data_ptr(),
        build.stream_handle(dev))
    build.check(err, f"greedy_rollout kernel launch at (num_agents, "
                     f"queue_capacity) = ({cfg.num_agents}, "
                     f"{cfg.queue_capacity}) (the map's free-cell "
                     f"table and walls, {4 * free.numel() + walls.numel()} "
                     f"bytes, are staged in shared memory)", lib)
    return state_from_kernel(outs, o_t, o_key), deliv, rew


greedy_rollout.launches = 0


def greedy_rollout_reference(cfg: EnvConfig, state: EnvState, T: int):
    """The plain PyTorch twin of ``greedy_rollout`` on any device: the
    batched draw stream, then T ticks of ``greedy_steps_reference``."""
    _check_rollout(cfg, state)
    final_keys, u, pick, drop, _ = _rng.batched_step_draws(state.key, cfg, T)
    new, deliv, rew = greedy_steps_reference(cfg, state, u, pick, drop)
    return new.replace(t=state.t + T, key=final_keys), deliv, rew


def spawn_draws_check(cfg: EnvConfig, keys: torch.Tensor, T: int):
    """``(final_keys, u float32[T, B], pick int32[T, B], drop int32[T,
    B])``: T chained ``threefry.cuh`` ``spawn_draws`` per key of ``keys``
    (int64 ``[B, 2]`` on the card), made by one launch of the header alone.
    The checks hold it against ``rng.batched_step_draws``; no path runs it.
    Its plain version is ``rng.spawn_draws`` chained T times."""
    if keys.device.type != "cuda":
        raise ValueError("spawn_draws_check launches the draw kernel: it "
                         f"takes CUDA keys, got {keys.device}")
    B, dev = keys.shape[0], keys.device
    key = keys.to(torch.int64).contiguous()
    o_key = torch.empty_like(key)
    u = torch.empty(T, B, dtype=torch.float32, device=dev)
    pick = torch.empty(T, B, dtype=torch.int32, device=dev)
    drop = torch.empty_like(pick)
    free = map_tables(cfg, dev)[1]
    err = build.library().wh_spawn_draws(
        B, T, *_span_args(cfg), free.data_ptr(), key.data_ptr(),
        u.data_ptr(), pick.data_ptr(), drop.data_ptr(), o_key.data_ptr(),
        build.stream_handle(dev))
    build.check(err, "spawn_draws kernel launch")
    return o_key, u, pick, drop

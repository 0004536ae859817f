"""K2: the PPO acting-phase kernel (MLP policy) and its plain twin.

Counterpart of ``warehouse_tpu/pallas/act.py`` ``ppo_rollout_pallas``,
MLP arm. ``ppo_rollout`` runs T acting steps — observe, MLP forward,
gumbel-argmax sample, env tick — and returns ``(EnvState, ActRollout,
reset_key_last, next_key)`` like the JAX wrapper: ``reset_key_last`` is
the reset key of the chunk's last tick, which the caller hands to
``env.batch.reset_truncated_batch`` for the episode-boundary reset. The
env draws come from ``rng.batched_step_draws`` and the gumbel noise from
``rng.batched_gumbel_stream(key, T, (5, B*A))``, the streams the JAX
wrapper feeds its kernel. On a CUDA tensor the CUDA kernel
(``csrc/act.cu``) runs; on a CPU tensor the plain twin does.

With ``mask_actions`` the logits of moves off the grid or into a wall
(``ops.move.valid_action_mask`` of the pre-tick positions) are floored to
-1e9 before the sample and the log-softmax (``pallas/act.py:415-428``),
and the mask is returned in ``ActRollout.mask``. Reward shaping, global
observations inside the kernel, policy groups and the CNN torso are not
ported yet; ``ppo_rollout`` raises ``NotImplementedError`` for them. The
recurrent policies act through ``kernels.act_rnn.ppo_rnn_rollout``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EnvConfig

from .. import rng as _rng
from ..env import engine
from ..env.state import EnvState
from ..models.policy import ActorCriticMLP
from ..ops.move import valid_action_mask
from ..ops.obs import inv_side
from ..ops.ppo_update import NEG_INF, sample_action_with_gumbel
from . import build
from .rollout import (check_kernel_shape, f32, kernel_state,
                      state_from_kernel, wall_mask)


class ActRollout(NamedTuple):
    """T-step trajectory, env-major like the JAX path."""
    obs: torch.Tensor         # float32[T, B, A, obs_dim]
    action: torch.Tensor      # int32[T, B, A]
    log_prob: torch.Tensor    # float32[T, B, A]
    value: torch.Tensor       # float32[T, B, A]
    reward: torch.Tensor      # float32[T, B, A]
    delivered: torch.Tensor   # int32[T, B] per-env delivery counts
    truncated: torch.Tensor   # bool[T, B]
    mask: torch.Tensor        # bool[T, B, A, 5] valid moves (all True
    #                           without masking)
    raw_reward: torch.Tensor  # float32[T, B, A], == reward (no shaping)


def act_steps_reference(cfg: EnvConfig, model: ActorCriticMLP,
                        state: EnvState, u, pick, drop, g, logits=None,
                        mask=None):
    """Plain PyTorch twin of the kernel: T = ``u.shape[0]`` steps of
    observe -> MLP -> sample -> ``engine.tick`` on the given draws and
    gumbel noise ``g [T, 5, B*A]``. Returns ``(state, obs, action,
    log_prob, value, reward, delivered)``, each stacked over T. A
    ``logits [T, B, A, 5]`` tensor, if given, receives the MLP's logits; a
    bool ``mask [T, B, A, 5]``, if given, turns action masking on and
    receives the valid-action mask."""
    outs = []
    with torch.no_grad():
        for t in range(u.shape[0]):
            obs = engine.observe_state(cfg, state)
            lg, value = model(obs)
            if logits is not None:
                logits[t] = lg
            if mask is not None:
                mask[t] = valid_action_mask(cfg, state.agent_pos)
                lg = torch.where(mask[t], lg, NEG_INF)
            action, lp = sample_action_with_gumbel(lg, g[t])
            state, picked, delivered, collided = engine.tick(
                cfg, state, action, u[t], pick[t], drop[t])
            reward = engine.rewards(cfg, picked, delivered, collided)
            outs.append((obs, action, lp, value, reward,
                         delivered.sum(-1, dtype=torch.int32)))
    return (state, *(torch.stack(x) for x in zip(*outs)))


def packed_weights(model: ActorCriticMLP, device) -> tuple[torch.Tensor,
                                                          list[int]]:
    """The kernel's weight layout: per hidden layer ``W [in, out]`` then
    ``b [out]``, then the fused head ``W [H, 6]`` (5 logits + value) and
    ``b [6]``, flat float32. Returns ``(weights, dims)`` with ``dims`` =
    input width then the hidden widths."""
    parts, dims = [], [model.hidden[0].in_features if model.hidden
                       else model.logits.in_features]
    for layer in model.hidden:
        parts += [layer.weight.t(), layer.bias]
        dims.append(layer.out_features)
    parts += [torch.cat([model.logits.weight, model.value.weight]).t(),
              torch.cat([model.logits.bias, model.value.bias])]
    flat = torch.cat([p.detach().to(torch.float32).reshape(-1)
                      for p in parts])
    return flat.to(device).contiguous(), dims


def act_steps(cfg: EnvConfig, model: ActorCriticMLP, state: EnvState, u,
              pick, drop, g, logits=None, mask=None):
    """T acting steps on precomputed draws and gumbel noise: the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors. Same
    arguments and returns as ``act_steps_reference``."""
    dev = state.agent_pos.device
    if dev.type == "cpu":
        return act_steps_reference(cfg, model, state, u, pick, drop, g,
                                   logits, mask)
    if dev.type != "cuda":
        raise ValueError(f"act_steps: unsupported device {dev}")
    check_kernel_shape(cfg)
    A, D = cfg.num_agents, cfg.obs_dim
    B, T = state.agent_pos.shape[0], u.shape[0]
    weights, dims = packed_weights(model, dev)
    if dims[0] != D or model.logits.out_features != cfg.num_actions:
        raise ValueError(f"model widths {dims} do not fit obs_dim {D}")
    lib = build.library()
    smem = lib.wh_act_smem_bytes(A, cfg.queue_capacity, D, len(dims) - 1,
                                 build.int_array(dims), weights.numel())
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"act kernel needs {smem} bytes of shared memory per block for "
            f"layer widths {dims}; the card allows {limit}")
    ins = kernel_state(state)
    draws = [u.to(torch.float32).contiguous(),
             pick.to(torch.int32).contiguous(),
             drop.to(torch.int32).contiguous(),
             g.to(torch.float32).contiguous()]
    if any(x.shape != (T, B) for x in draws[:3]) or g.shape != (T, 5, B * A):
        raise ValueError("draws must be [T, B] and gumbel [T, 5, B*A]")
    for name, out, dtype in (("logits", logits, torch.float32),
                             ("mask", mask, torch.bool)):
        if out is not None and (
                out.shape != (T, B, A, 5) or out.dtype != dtype
                or out.device != dev or not out.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} "
                             f"[T, B, A, 5] tensor on {dev}")
    outs = [torch.empty_like(x) for x in ins]
    obs = torch.empty(T, B, A, D, dtype=torch.float32, device=dev)
    action = torch.empty(T, B, A, dtype=torch.int32, device=dev)
    log_prob, value, reward = (torch.empty(T, B, A, device=dev)
                               for _ in range(3))
    delivered = torch.empty(T, B, dtype=torch.int32, device=dev)
    walls = wall_mask(cfg, dev)
    err = lib.wh_act_rollout(
        A, cfg.queue_capacity, B, T, cfg.height, cfg.width,
        f32(cfg.spawn_prob), cfg.window_size, cfg.obs_radius, D,
        inv_side(cfg.height), inv_side(cfg.width), f32(cfg.step_penalty),
        f32(cfg.pickup_reward), f32(cfg.delivery_reward),
        f32(cfg.collision_penalty), len(dims) - 1, build.int_array(dims),
        walls.data_ptr(), weights.data_ptr(), weights.numel(),
        *(x.data_ptr() for x in ins), *(x.data_ptr() for x in draws),
        *(x.data_ptr() for x in outs), obs.data_ptr(), action.data_ptr(),
        log_prob.data_ptr(), value.data_ptr(), reward.data_ptr(),
        delivered.data_ptr(),
        None if logits is None else logits.data_ptr(),
        None if mask is None else mask.data_ptr(),
        build.stream_handle(dev))
    build.check(err, "ppo_rollout kernel launch")
    act_steps.launches += 1
    new = state_from_kernel(outs, state.t, state.key)
    return new, obs, action, log_prob, value, reward, delivered


act_steps.launches = 0


def _check_options(cfg, shaping_coef, policy_groups, arch):
    if cfg.auto_reset:
        raise ValueError("ppo_rollout: auto_reset is handled by the caller")
    if arch in ("gru", "lstm"):
        raise ValueError(f"ppo_rollout: arch={arch!r} acts through "
                         "kernels.act_rnn.ppo_rnn_rollout")
    for name, unsupported in (("shaping_coef", shaping_coef > 0.0),
                              ("global_obs", cfg.global_obs),
                              ("policy_groups", policy_groups is not None),
                              (f"arch={arch!r}", arch != "mlp")):
        if unsupported:
            raise NotImplementedError(
                f"ppo_rollout: {name} is not ported yet")


def chunk_rollout(run_steps, cfg: EnvConfig, state: EnvState, T: int,
                  key: torch.Tensor, mask_actions: bool):
    """The wrapper shared by the acting kernels: draws the chunk's env
    stream and gumbel noise, calls ``run_steps(u, pick, drop, g, mask)``
    -> ``(state, obs, action, log_prob, value, reward, delivered, *rest)``
    and returns ``(EnvState, ActRollout, reset_key_last, next_key,
    *rest)`` with the step counter, the env keys and the truncation flags
    filled in."""
    B, A = state.agent_pos.shape[:2]
    dev = state.agent_pos.device
    final_keys, u, pick, drop, reset_keys = _rng.batched_step_draws(
        state.key, cfg, T)
    next_key, g = _rng.batched_gumbel_stream(key, T, (5, B * A))
    mask = torch.ones(T, B, A, 5, dtype=torch.bool, device=dev)
    new, obs, action, lp, value, reward, delivered, *rest = run_steps(
        u, pick, drop, g, mask if mask_actions else None)
    steps_ahead = (state.t[None, :] + 1
                   + torch.arange(T, dtype=state.t.dtype,
                                  device=state.t.device)[:, None])
    roll = ActRollout(
        obs=obs, action=action, log_prob=lp, value=value, reward=reward,
        delivered=delivered, truncated=steps_ahead >= cfg.max_steps,
        mask=mask, raw_reward=reward)
    new = new.replace(t=state.t + T, key=final_keys)
    return (new, roll, reset_keys[-1], next_key, *rest)


def _rollout(steps, cfg: EnvConfig, model: ActorCriticMLP, state: EnvState,
             T: int, key: torch.Tensor, mask_actions: bool = False,
             shaping_coef: float = 0.0, policy_groups=None,
             arch: str = "mlp"):
    _check_options(cfg, shaping_coef, policy_groups, arch)
    return chunk_rollout(
        lambda u, pick, drop, g, mask: steps(cfg, model, state, u, pick,
                                             drop, g, mask=mask),
        cfg, state, T, key, mask_actions)


def ppo_rollout(cfg: EnvConfig, model: ActorCriticMLP, state: EnvState,
                T: int, key: torch.Tensor, **options):
    """T acting steps of the MLP policy, through the kernel on a CUDA
    state: ``(EnvState, ActRollout, reset_key_last, next_key)``.
    ``options`` (``mask_actions``, ``shaping_coef``, ``policy_groups``,
    ``arch``) take the JAX wrapper's names; ``mask_actions`` is ported,
    the others only at their defaults."""
    return _rollout(act_steps, cfg, model, state, T, key, **options)


def ppo_rollout_reference(cfg: EnvConfig, model: ActorCriticMLP,
                          state: EnvState, T: int, key: torch.Tensor,
                          **options):
    """The plain PyTorch twin of ``ppo_rollout`` on any device."""
    return _rollout(act_steps_reference, cfg, model, state, T, key,
                    **options)

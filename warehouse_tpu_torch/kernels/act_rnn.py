"""K7: the acting-phase kernel of the recurrent (GRU / LSTM) policy and its
plain twin.

Counterpart of ``warehouse_tpu/pallas/act.py`` ``ppo_rnn_rollout_pallas``
(:747). ``ppo_rnn_rollout`` runs T acting steps — observe, encoder, cell,
heads, gumbel-argmax sample, env tick — with the recurrent carry threaded
over the steps, and returns ``(EnvState, ActRollout, reset_key_last,
next_key, new_carry)`` like the JAX wrapper. ``new_carry`` is NOT reset at
episode boundaries: the caller zeroes it where the chunk truncated (the
trainer only lets an episode end on a chunk's last step). The env draws
and the gumbel noise are K2's streams (``rng.batched_step_draws``,
``rng.batched_gumbel_stream(key, T, (5, B*A))``). On a CUDA tensor the
CUDA kernel (``csrc/act_rnn.cu``) runs; on a CPU tensor the plain twin
does.

The carry is ``h float32[B, A, H]`` for the GRU, the tuple ``(c, h)`` of two
such tensors for the LSTM. ``mask_actions`` works as in K2; like the JAX
function, it has no reward shaping and raises on global observations
(``NotImplementedError``: the trainer's option, ROADMAP M-4b).

``pack_rnn`` / ``unpack_rnn`` lay a recurrent policy's params dict out as
the flat vector the recurrent kernels read (``csrc/rnn_cell.cuh``): the
encoder layers, the stacked input-side gate kernels (and GRU biases), the
stacked recurrent gate kernels and their biases, the fused head.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from ..env import engine
from ..env.state import EnvState
from ..models.policy import (ActorCriticRNN, apply_rnn, cell_type_of,
                             num_encoder)
from ..ops.move import valid_action_mask
from ..ops.obs import inv_side
from ..ops.ppo_update import NEG_INF, sample_action_with_gumbel
from . import build
from .act import chunk_rollout
from .rollout import (check_kernel_shape, check_multiple_of_4, f32,
                      kernel_state, state_from_kernel, wall_mask)

GATE_ORDER = {"gru": ("r", "z", "n"), "lstm": ("i", "f", "g", "o")}


def rnn_layout(params) -> list[list[str]]:
    """The packed vector as a list of segments, each a list of params keys
    whose tensors are concatenated along dim 0 (so a segment is one matrix
    ``[out, in]`` or one bias vector)."""
    cell = cell_type_of(params)
    gates = GATE_ORDER[cell]
    segs = []
    for i in range(num_encoder(params)):
        segs += [[f"encoder.{i}.weight"], [f"encoder.{i}.bias"]]
    segs.append([f"cell.i{g}.weight" for g in gates])
    if cell == "gru":
        segs.append([f"cell.i{g}.bias" for g in gates])
    segs.append([f"cell.h{g}.weight" for g in gates])
    segs.append(["cell.hn.bias"] if cell == "gru"
                else [f"cell.h{g}.bias" for g in gates])
    segs += [["logits.weight", "value.weight"], ["logits.bias", "value.bias"]]
    return segs


def pack_rnn(tree) -> torch.Tensor:
    """A recurrent params-shaped dict as the kernels' flat float32 vector."""
    return torch.cat([tree[k].detach().reshape(-1)
                      for seg in rnn_layout(tree) for k in seg]
                     ).to(torch.float32).contiguous()


def unpack_rnn(flat: torch.Tensor, like) -> dict:
    """Inverse of ``pack_rnn``: views of ``flat`` with ``like``'s keys and
    shapes."""
    out, off = {}, 0
    for seg in rnn_layout(like):
        for k in seg:
            n = like[k].numel()
            out[k] = flat[off:off + n].view(like[k].shape)
            off += n
    return {k: out[k] for k in like}


def rnn_dims(params, D: int) -> tuple[list[int], int, bool]:
    """``(dims, H, lstm)``: the obs width then the encoder widths, the
    cell's hidden width and its type, with every shape checked."""
    cell = cell_type_of(params)
    dims = [D] + [params[f"encoder.{i}.weight"].shape[0]
                  for i in range(num_encoder(params))]
    H = params["cell.hn.weight" if cell == "gru"
               else "cell.ho.weight"].shape[0]
    for i, (fan_in, fan_out) in enumerate(zip(dims, dims[1:])):
        if params[f"encoder.{i}.weight"].shape != (fan_out, fan_in):
            raise ValueError(f"encoder.{i}: shape does not fit widths {dims}")
    for g in GATE_ORDER[cell]:
        if (params[f"cell.i{g}.weight"].shape != (H, dims[-1])
                or params[f"cell.h{g}.weight"].shape != (H, H)):
            raise ValueError(f"cell gate {g}: shape does not fit widths "
                             f"{dims[-1]} -> {H}")
    if params["logits.weight"].shape != (5, H) or (
            params["value.weight"].shape != (1, H)):
        raise ValueError("the recurrent kernels take a 5-action head and a "
                         "value head on the cell's output")
    return dims, H, cell == "lstm"


def rnn_kernel_dims(kernel: str, params, D: int):
    """``rnn_dims`` for the recurrent CUDA kernel ``kernel`` (K7, or K8 /
    K9): raises ``ValueError`` naming the kernel and the width where a
    hidden or encoder width is not a multiple of 4 (ROADMAP T-6)."""
    dims, H, lstm = rnn_dims(params, D)
    check_multiple_of_4(kernel, {"hidden": H, **{
        f"encoder {i}": d for i, d in enumerate(dims[1:])}})
    return dims, H, lstm


def check_act_rnn_fits(cfg: EnvConfig, params, dev):
    """K7's ``(dims, H, lstm)`` for ``params`` on ``cfg``; raises
    ``ValueError`` for an (agents, queue) shape, a width (before any
    library call) or a shared-memory need the kernel does not take."""
    check_kernel_shape(cfg)
    dims, H, lstm = rnn_kernel_dims("K7", params, cfg.obs_dim)
    smem = build.library().wh_act_rnn_smem_bytes(
        cfg.num_agents, cfg.queue_capacity, len(dims) - 1,
        build.int_array(dims), H, int(lstm))
    limit = build.smem_limit(dev, smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"recurrent act kernel needs {smem} bytes of shared memory per "
            f"block for widths {dims}, {H}; the card allows {limit}")
    return dims, H, lstm


def split_carry(carry, lstm: bool):
    """``(h, c)`` float32 contiguous tensors of a carry (``c`` None for the
    GRU)."""
    if lstm:
        c, h = carry
        return (h.to(torch.float32).contiguous(),
                c.to(torch.float32).contiguous())
    return carry.to(torch.float32).contiguous(), None


def act_rnn_steps_reference(cfg: EnvConfig, params: dict, state: EnvState,
                            carry, u, pick, drop, g, logits=None, mask=None):
    """Plain PyTorch twin of the kernel: T = ``u.shape[0]`` steps of
    observe -> ``apply_rnn`` -> sample -> ``engine.tick`` on the given
    draws and gumbel noise ``g [T, 5, B*A]``. Returns ``(state, carry, obs,
    action, log_prob, value, reward, delivered)``, the last six stacked
    over T. ``logits`` / ``mask`` ``[T, B, A, 5]``, if given, receive the
    raw logits / turn masking on and receive the valid-action mask."""
    outs = []
    with torch.no_grad():
        for t in range(u.shape[0]):
            obs = engine.observe_state(cfg, state)
            lg, value, carry = apply_rnn(params, obs, carry)
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
    return (state, carry, *(torch.stack(x) for x in zip(*outs)))


def act_rnn_steps(cfg: EnvConfig, params: dict, state: EnvState, carry, u,
                  pick, drop, g, logits=None, mask=None):
    """T recurrent acting steps on precomputed draws and gumbel noise: the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors. Same
    arguments and returns as ``act_rnn_steps_reference``."""
    dev = state.agent_pos.device
    if dev.type == "cpu":
        return act_rnn_steps_reference(cfg, params, state, carry, u, pick,
                                       drop, g, logits, mask)
    if dev.type != "cuda":
        raise ValueError(f"act_rnn_steps: unsupported device {dev}")
    A, D = cfg.num_agents, cfg.obs_dim
    B, T = state.agent_pos.shape[0], u.shape[0]
    dims, H, lstm = check_act_rnn_fits(cfg, params, dev)
    dims_arr = build.int_array(dims)
    lib = build.library()
    weights = pack_rnn(params).to(dev)
    if weights.numel() != lib.wh_rnn_param_floats(len(dims) - 1, dims_arr, H,
                                                  int(lstm)):
        raise ValueError("packed params do not fit the kernel's layout")
    weights_t = torch.empty_like(weights)
    h0, c0 = split_carry(carry, lstm)
    if any(x is not None and (x.shape != (B, A, H) or x.device != dev)
           for x in (h0, c0)):
        raise ValueError(f"carry must be [B, A, H] = {(B, A, H)} on {dev}")
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
    h_out = torch.empty_like(h0)
    c_out = torch.empty_like(c0) if lstm else None
    obs = torch.empty(T, B, A, D, dtype=torch.float32, device=dev)
    action = torch.empty(T, B, A, dtype=torch.int32, device=dev)
    log_prob, value, reward = (torch.empty(T, B, A, device=dev)
                               for _ in range(3))
    delivered = torch.empty(T, B, dtype=torch.int32, device=dev)
    walls = wall_mask(cfg, dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = lib.wh_act_rnn_rollout(
        A, cfg.queue_capacity, B, T, cfg.height, cfg.width,
        f32(cfg.spawn_prob), cfg.window_size, cfg.obs_radius, D,
        inv_side(cfg.height), inv_side(cfg.width), f32(cfg.step_penalty),
        f32(cfg.pickup_reward), f32(cfg.delivery_reward),
        f32(cfg.collision_penalty), len(dims) - 1, dims_arr, H, int(lstm),
        walls.data_ptr(), weights.data_ptr(), weights_t.data_ptr(),
        *(x.data_ptr() for x in ins), h0.data_ptr(), ptr(c0),
        *(x.data_ptr() for x in draws), *(x.data_ptr() for x in outs),
        h_out.data_ptr(), ptr(c_out), obs.data_ptr(), action.data_ptr(),
        log_prob.data_ptr(), value.data_ptr(), reward.data_ptr(),
        delivered.data_ptr(), ptr(logits), ptr(mask),
        build.stream_handle(dev))
    build.check(err, "ppo_rnn_rollout kernel launch")
    act_rnn_steps.launches += 1
    new = state_from_kernel(outs, state.t, state.key)
    new_carry = (c_out, h_out) if lstm else h_out
    return new, new_carry, obs, action, log_prob, value, reward, delivered


act_rnn_steps.launches = 0


def _params_of(model_or_params) -> dict:
    if isinstance(model_or_params, ActorCriticRNN):
        return dict(model_or_params.named_parameters())
    return model_or_params


def _rollout(steps, cfg: EnvConfig, params, state: EnvState, carry, T: int,
             key: torch.Tensor, mask_actions: bool = False):
    if cfg.auto_reset:
        raise ValueError("ppo_rnn_rollout: auto_reset is handled by the "
                         "caller")
    if cfg.global_obs:  # the TPU kernel has none: the trainer's option
        raise NotImplementedError(
            "ppo_rnn_rollout: global_obs is not ported yet (ROADMAP M-4b)")
    params = _params_of(params)

    def run_steps(u, pick, drop, g, mask, shaping):
        new, new_carry, *outs = steps(cfg, params, state, carry, u, pick,
                                      drop, g, mask=mask)
        return (new, *outs, new_carry)

    return chunk_rollout(run_steps, cfg, state, T, key, mask_actions)


def ppo_rnn_rollout(cfg: EnvConfig, params, state: EnvState, carry, T: int,
                    key: torch.Tensor, **options):
    """T acting steps of the recurrent policy (an ``ActorCriticRNN`` or its
    params dict), through the kernel on a CUDA state: ``(EnvState,
    ActRollout, reset_key_last, next_key, new_carry)``. ``options``:
    ``mask_actions``."""
    return _rollout(act_rnn_steps, cfg, params, state, carry, T, key,
                    **options)


def ppo_rnn_rollout_reference(cfg: EnvConfig, params, state: EnvState, carry,
                              T: int, key: torch.Tensor, **options):
    """The plain PyTorch twin of ``ppo_rnn_rollout`` on any device."""
    return _rollout(act_rnn_steps_reference, cfg, params, state, carry, T,
                    key, **options)

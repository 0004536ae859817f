"""K2 and K10: the PPO acting-phase kernels (MLP and CNN policy) and
their plain twin.

Counterpart of ``warehouse_tpu/pallas/act.py`` ``ppo_rollout_pallas``,
its MLP arm (K2) and its CNN arm (K10, ``arch="cnn"``). ``ppo_rollout``
runs T acting steps — observe, policy forward, gumbel-argmax sample, env
tick — and returns ``(EnvState, ActRollout, reset_key_last, next_key)``
like the JAX wrapper: ``reset_key_last`` is the reset key of the chunk's
last tick, which the caller hands to
``env.batch.reset_truncated_batch`` for the episode-boundary reset. The
env draws come from ``rng.batched_step_draws`` and the gumbel noise from
``rng.batched_gumbel_stream(key, T, (5, B*A))``, the streams the JAX
wrapper feeds its kernel. On a CUDA tensor the CUDA kernel runs
(``csrc/act.cu`` for the MLP, ``csrc/act_cnn.cu`` for the CNN); on a CPU
tensor the plain twin does, which calls the model and so serves both.

With ``mask_actions`` the logits of moves off the grid or into a wall
(``ops.move.valid_action_mask`` of the pre-tick positions) are floored to
-1e9 before the sample and the log-softmax (``pallas/act.py:415-428``),
and the mask is returned in ``ActRollout.mask``.

With ``shaping_coef > 0`` the kernels add the potential-based shaping
term (``pallas/act.py`` ``_phi_row`` :266-296, ``_act_kernel`` :356-363,
:457-468): per agent and step ``phi = -(BFS distance from its cell to its
target's cell)`` read from the ``[C, C]`` table of ``ops/pathing.py`` (0
without a task or when unreachable), before the tick and after it on the
pre-reset state, and ``reward = rew + coef * (gamma * phi_post * (1 -
done_t) - phi_pre)`` in exactly that float32 operation order, with
``done_t`` the chunk's truncation flags. The unshaped reward is returned
in ``ActRollout.raw_reward``.

With ``cfg.global_obs`` the kernels build the global view themselves
(``pallas/act.py`` ``_obs_rows_global`` :193-242): the whole ``H x W`` grid
with 5 channels per cell (self, other agents, pending pickups, own target,
traversable), then the 6 self features, ``D = 5 H W + 6``; the CNN's grid
becomes the whole map. ``check_act_fits`` raises for a shape the kernels
do not take.

With ``policy_groups`` (a tuple of one group id per agent) the model is a
``MultiPolicyActorCritic`` of MLPs or of CNNs and each agent's rows run
through its group's weights only (``pallas/act.py:1062-1076``, the
trace-time selection of ``_act_kernel`` :325, :336-338, :409): the kernels
pack the groups' weights one after another in group order and order each
step's rows group by group (``act_cnn_rows``), so that every tile of
their stage kernels is one group's. The attention torso raises
``NotImplementedError``, as the TPU kernel has no attention arm: the
trainers act with it through their per-step phase
(``train.ppo.step_rollout``). The recurrent policies act through
``kernels.act_rnn.ppo_rnn_rollout``.

``pack_cnn`` / ``unpack_cnn`` give the CNN kernels' flat parameter vector
(K10-K12; the layout of ``csrc/cnn_net.cuh``): each conv kernel as ``[9
OC, IC]`` (row ``k OC + oc``, the packed layout of
``pallas/sgd_cnn.py`` ``flat_cnn_tensors``), its bias, the trunk ``[H,
in]`` and bias, the head as the 6 x H stack of the logits and value rows
and its 6 biases.

K10 runs each step as three stage kernels over all of the step's ``N = B
A`` rows (``csrc/act_cnn.cu``): ``conv`` (both convolutions: the trunk's
input rows ``a1``), ``trunk`` (the trunk and the fused head: 5 logits and
the value a row) and ``env`` (mask, sample, tick, rewards, the next
observation). ``ACT_CNN_STAGES`` names them, ``act_conv_plain``,
``act_trunk_plain`` and ``act_env_plain`` are their plain versions,
``act_cnn_steps_staged`` composes the three into
``act_steps_reference``'s contract, and ``act_cnn_stage`` runs one stage's
kernel on given rows (its plain version on a CPU tensor), for the stages'
checks on the card.

K2 runs each step as stage kernels over the step's rows in the same
order (``csrc/act.cu``): ``hidden`` (a tanh layer, once per hidden layer
but the last), ``head`` (the last hidden layer and the fused head) and
``env`` (K10's env kernel, then a kernel of its own for the next
observation rows, which it also writes in row order for the first
layer). ``ACT_MLP_STAGES`` names them,
``act_hidden_plain`` and ``act_head_plain`` are the first two's plain
versions, ``act_mlp_steps_staged`` composes the stages and
``act_mlp_stage`` runs one stage's kernel (its plain version on a CPU
tensor).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import EnvConfig

from .. import rng as _rng
from ..env import engine
from ..env.state import EnvState
from ..models.policy import (ActorCriticCNN, ActorCriticMLP,
                             MultiPolicyActorCritic, apply, cnn_dims,
                             num_conv)
from ..ops.move import valid_action_mask
from ..ops.obs import inv_side
from ..ops.pathing import device_table, potential
from ..ops.ppo_update import NEG_INF, sample_action_with_gumbel
from ..utils.profiling import annotate
from . import build
from .rollout import f32, kernel_state, state_from_kernel, wall_mask


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
    raw_reward: torch.Tensor  # float32[T, B, A] before shaping (the same
    #                           tensor as ``reward`` without shaping)


class Shaping(NamedTuple):
    """The potential-shaping option of one chunk."""
    coef: float               # shaping coefficient, > 0
    gamma: float              # discount of the next state's potential
    done: torch.Tensor        # float32[T, B], 1.0 where the step truncates
    raw_reward: torch.Tensor  # float32[T, B, A]: receives the unshaped reward


def act_steps_reference(cfg: EnvConfig, model, state: EnvState, u, pick,
                        drop, g, logits=None, mask=None, shaping=None,
                        groups=None):
    """Plain PyTorch twin of both kernels: T = ``u.shape[0]`` steps of
    observe -> model (MLP or CNN) -> sample -> ``engine.tick`` on the
    given draws and gumbel noise ``g [T, 5, B*A]``. Returns ``(state, obs,
    action, log_prob, value, reward, delivered)``, each stacked over T. A
    ``logits [T, B, A, 5]`` tensor, if given, receives the model's
    logits; a bool ``mask [T, B, A, 5]``, if given, turns action masking
    on and receives the valid-action mask; a ``Shaping``, if given, turns
    the potential shaping on: ``reward`` is then the shaped reward and
    ``shaping.raw_reward`` receives the unshaped one. The shaping term is
    three rounded float32 operations in the JAX kernel's order, then one
    product and one sum. With ``groups`` (one group id per agent) the
    model is a ``MultiPolicyActorCritic`` and agent a takes group
    ``groups[a]``'s outputs. The model runs in float32 whatever its
    compute dtype, as the kernels do (a bf16 model's acting is float32 in
    the JAX package's acting kernels too)."""
    outs = []
    params = dict(model.named_parameters())
    gids = None if groups is None else torch.tensor(groups)
    with torch.no_grad():
        for t in range(u.shape[0]):
            obs = engine.observe_state(cfg, state)
            lg, value = apply(params, obs, gids)
            if logits is not None:
                logits[t] = lg
            out = env_step_plain(cfg, state, lg, u[t], pick[t], drop[t], g[t],
                                 mask is not None, _step_shaping(shaping, t))
            _keep_step(out, t, mask, shaping)
            state = out["state"]
            outs.append((obs, out["action"], out["log_prob"], value,
                         out["reward"], out["delivered"]))
    return (state, *(torch.stack(x) for x in zip(*outs)))


def env_step_plain(cfg: EnvConfig, state: EnvState, logits, u, pick, drop,
                   g, mask_on: bool = False, shaping=None) -> dict:
    """One plain env step on the policy's ``logits [B, A, 5]``: with
    ``mask_on`` the invalid moves' logits floored to -1e9; the
    gumbel-argmax sample on ``g [5, B A]`` and its log-softmax; the tick
    on the draws ``u``, ``pick``, ``drop`` ``[B]``; the rewards (with
    ``shaping``, a ``(coef, gamma, done [B])``, the shaped ones: three
    rounded float32 operations in the JAX kernel's order, then one product
    and one sum). Returns ``state``, ``action``, ``log_prob``, ``reward``,
    ``raw_reward`` (the unshaped), ``delivered`` (per env) and ``mask``
    (None without ``mask_on``) by name."""
    mask = valid_action_mask(cfg, state.agent_pos) if mask_on else None
    if mask_on:
        logits = torch.where(mask, logits, NEG_INF)
    action, lp = sample_action_with_gumbel(logits, g)
    if shaping is not None:
        phi_pre = potential(cfg, state)
    new, picked, delivered, collided = engine.tick(cfg, state, action, u,
                                                   pick, drop)
    raw = reward = engine.rewards(cfg, picked, delivered, collided)
    if shaping is not None:
        coef, gamma, done = shaping
        term = f32(gamma) * potential(cfg, new)
        term = term * (1.0 - done)[:, None]
        term = term - phi_pre
        reward = reward + f32(coef) * term
    return {"state": new, "action": action, "log_prob": lp,
            "reward": reward, "raw_reward": raw,
            "delivered": delivered.sum(-1, dtype=torch.int32), "mask": mask}


def _step_shaping(shaping, t: int):
    """Step t's ``(coef, gamma, done)`` of a chunk's ``Shaping`` (or
    None)."""
    return None if shaping is None else (shaping.coef, shaping.gamma,
                                         shaping.done[t])


def _keep_step(out: dict, t: int, mask, shaping) -> None:
    """Writes step t's mask and unshaped reward into the chunk's buffers,
    where the caller gave them."""
    if mask is not None:
        mask[t] = out["mask"]
    if shaping is not None:
        shaping.raw_reward[t] = out["raw_reward"]


def packed_weights(model, device) -> tuple[torch.Tensor, list[int]]:
    """The kernel's weight layout: per hidden layer ``W [in, out]`` then
    ``b [out]``, then the fused head ``W [H, 6]`` (5 logits + value) and
    ``b [6]``, flat float32; for a ``MultiPolicyActorCritic`` each group's
    in group order (``pallas/sgd.py`` ``_flat_tensors``' order), every
    group of the same widths. Returns ``(weights, dims)`` with ``dims`` =
    input width then the hidden widths."""
    if isinstance(model, MultiPolicyActorCritic):
        packed = [packed_weights(sub, device) for sub in model.policies]
        if any(d != packed[0][1] for _, d in packed):
            raise ValueError(f"the policy groups' layer widths differ: "
                             f"{[d for _, d in packed]}")
        return torch.cat([w for w, _ in packed]), packed[0][1]
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


def is_cnn_model(model) -> bool:
    """Whether ``model`` is an ``ActorCriticCNN`` or a
    ``MultiPolicyActorCritic`` of them."""
    if isinstance(model, MultiPolicyActorCritic):
        model = model.policies[0]
    return isinstance(model, ActorCriticCNN)


def act_steps(cfg: EnvConfig, model, state: EnvState, u, pick, drop, g,
              logits=None, mask=None, shaping=None, groups=None):
    """T acting steps on precomputed draws and gumbel noise: the CUDA
    kernel for CUDA tensors (K2 for an MLP or, with ``groups``, a
    ``MultiPolicyActorCritic`` of MLPs; K10 through ``act_cnn_steps`` for
    a CNN or one of CNNs), the plain twin for CPU tensors. Same arguments
    and returns as ``act_steps_reference``."""
    dev = state.agent_pos.device
    if dev.type == "cpu":
        return act_steps_reference(cfg, model, state, u, pick, drop, g,
                                   logits, mask, shaping, groups)
    if dev.type != "cuda":
        raise ValueError(f"act_steps: unsupported device {dev}")
    if is_cnn_model(model):
        return act_cnn_steps(cfg, model, state, u, pick, drop, g, logits,
                             mask, shaping, groups)
    run = ActMlpLaunch(cfg, model, state, u, pick, drop, g, logits, mask,
                       shaping, groups)
    hidden, head, env, prep = run.launch(None)
    act_steps.launches += 1
    act_steps.shaped_launches += shaping is not None
    act_steps.global_launches += cfg.global_obs
    act_steps.group_launches += groups is not None
    act_steps.hidden_launches += hidden
    act_steps.head_launches += head
    act_steps.env_launches += env
    act_steps.stage_launches += hidden + head + env + prep
    return run.io.results(state)


act_steps.launches = 0
act_steps.shaped_launches = 0  # the launches that had the shaping option on
act_steps.global_launches = 0  # those that built the global view
act_steps.group_launches = 0   # those that routed rows by policy group
# The stage kernels those launches ran, as the C entry point counts them
# where it launches them: a hidden stage per hidden layer but the last, the
# head stage and the env stage (the tick, then the next observation rows
# but on the last step) a step, the prep (with a hidden layer) and the
# first observation's pair.
act_steps.stage_launches = 0
act_steps.hidden_launches = 0  # of them, the hidden stages' kernels
act_steps.head_launches = 0    # the head stages'
act_steps.env_launches = 0     # the env stages' (tick and observation)


def _group_args(cfg: EnvConfig, groups):
    """``(K, the agent -> group map as a C int array or None)`` of the
    kernel's group option: ``(1, None)`` without groups."""
    if groups is None:
        return 1, None
    if len(groups) != cfg.num_agents:
        raise ValueError("policy_groups must have one entry per agent")
    most = max_groups(cfg)
    if min(groups) < 0 or max(groups) >= most:
        raise ValueError(f"policy_groups must be group ids in [0, "
                         f"{most}), got {tuple(groups)}")
    return max(groups) + 1, build.int_array([int(x) for x in groups])


def group_models(model, groups=None) -> list:
    """The sub-models of ``model`` in group order (``[model]`` without
    groups); ``ValueError`` unless the model is a ``MultiPolicyActorCritic``
    of one policy per group exactly when ``groups`` is given."""
    multi = isinstance(model, MultiPolicyActorCritic)
    if multi != (groups is not None) or (
            multi and len(model.policies) != max(groups) + 1):
        raise ValueError(
            f"a {type(model).__name__} does not fit policy_groups={groups}")
    return list(model.policies) if multi else [model]


def max_groups(cfg: EnvConfig) -> int:
    """Policy groups the acting kernels take at ``cfg``'s agents: 8, or
    one per agent where there are more (``act_stages.cuh`` ``ACT_MAXK``)."""
    return max(8, cfg.num_agents)


def _mlp_fits(cfg: EnvConfig, model, dev, groups=None):
    """K2's ``(weights, dims)`` for ``model`` (an MLP, or with ``groups`` a
    ``MultiPolicyActorCritic`` of MLPs) on ``cfg``, ``dims`` the input
    width then the hidden widths; raises ``ValueError`` naming what K2
    does not take: the (agents, queue) shape, widths that do not fit the
    observation or the 5 actions, or a group map that does not fit the
    model. Any width and any number of hidden layers."""
    build.check_pair(cfg.num_agents, cfg.queue_capacity)
    subs = group_models(model, groups)
    if not all(isinstance(m, ActorCriticMLP) for m in subs):
        raise ValueError("the act kernel takes MLP policies")
    weights, dims = packed_weights(model, dev)
    if dims[0] != cfg.obs_dim or (
            subs[0].logits.out_features != cfg.num_actions):
        raise ValueError(f"model widths {dims} do not fit obs_dim "
                         f"{cfg.obs_dim} and {cfg.num_actions} actions")
    _group_args(cfg, groups)
    return weights, dims


def check_cnn_widths(cfg: EnvConfig, model, groups=None):
    """K10's ``(S, C0, C1, C2, H)`` for ``model`` (a CNN or, with
    ``groups``, a ``MultiPolicyActorCritic`` of CNNs) on ``cfg``; raises
    ``ValueError`` for an (agents, queue) pair no env stage can be built
    for (``build.check_pair``) or a grid that is not the env's, before any
    library call. Any trunk width."""
    build.check_pair(cfg.num_agents, cfg.queue_capacity)
    subs = group_models(model, groups)
    nets = {cnn_kernel_dims(dict(m.named_parameters()), cfg.obs_dim)
            for m in subs}
    if len(nets) != 1:
        raise ValueError(f"the policy groups' CNN widths differ: {nets}")
    net = nets.pop()
    side = cfg.height if cfg.global_obs else cfg.window_size
    if net[0] != side or net[1] != cfg.num_obs_channels:
        raise ValueError(
            f"the model's {net[0]}x{net[0]} grid of {net[1]} channels is not "
            f"the env's {side}x{side} observation grid of "
            f"{cfg.num_obs_channels}")
    return net


def _cnn_fits(cfg: EnvConfig, model, dev, groups=None):
    """K10's ``(S, C0, C1, C2, H)`` for ``model`` on ``cfg``
    (``check_cnn_widths``); raises ``ValueError`` for a shape the kernel
    cannot take, its shared memory too."""
    net = check_cnn_widths(cfg, model, groups)
    k, gmap = _cnn_group_args(cfg, groups)
    A, R = cfg.num_agents, cfg.queue_capacity
    smem = build.env_library(A, R).wh_act_cnn_smem_bytes(A, R, *net, k, gmap)
    limit = build.smem_limit(dev, smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"CNN act kernel needs {smem} bytes of shared memory per block "
            f"for (S, channels, hidden) = {net} with {cfg.num_agents} agents "
            f"and policy_groups={groups} (a conv tile of 16 samples beside "
            f"the conv kernels, as the CNN learner's); the card allows "
            f"{limit}")
    return net


def _cnn_group_args(cfg: EnvConfig, groups):
    """``(K, the agent -> group map)`` of K10's group option: ``(0,
    None)`` without groups."""
    if groups is None:
        return 0, None
    return _group_args(cfg, groups)


def check_act_fits(cfg: EnvConfig, model, dev, groups=None) -> None:
    """Raise ``ValueError`` unless the acting kernel (K2 for an MLP, K10
    for a CNN or, with ``groups``, a ``MultiPolicyActorCritic`` of either)
    takes ``cfg`` and ``model`` on the CUDA device ``dev``: the env's
    (agents, queue) shape, the model's widths and the shared memory they
    need. A trainer calls it when it is built."""
    if is_cnn_model(model):
        _cnn_fits(cfg, model, dev, groups)
    else:
        _mlp_fits(cfg, model, dev, groups)


class _KernelIO:
    """The tensors the acting kernels K2 and K10 share, checked: the env
    state in the kernels' layout, the draws, and the outputs allocated."""

    def __init__(self, cfg, state, u, pick, drop, g, logits, mask,
                 shaping=None):
        dev = state.agent_pos.device
        A, D = cfg.num_agents, cfg.obs_dim
        B, T = state.agent_pos.shape[0], u.shape[0]
        self.B, self.T = B, T
        self.ins = kernel_state(state)
        self.draws = [u.to(torch.float32).contiguous(),
                      pick.to(torch.int32).contiguous(),
                      drop.to(torch.int32).contiguous(),
                      g.to(torch.float32).contiguous()]
        if (any(x.shape != (T, B) for x in self.draws[:3])
                or g.shape != (T, 5, B * A)):
            raise ValueError("draws must be [T, B] and gumbel [T, 5, B*A]")
        for name, out, dtype in (("logits", logits, torch.float32),
                                 ("mask", mask, torch.bool)):
            if out is not None and (
                    out.shape != (T, B, A, 5) or out.dtype != dtype
                    or out.device != dev or not out.is_contiguous()):
                raise ValueError(f"{name} must be a contiguous {dtype} "
                                 f"[T, B, A, 5] tensor on {dev}")
        self.logits, self.mask = logits, mask
        # The shaping option: the int32 BFS table and the chunk's flags.
        self.shaping, self.table = shaping, None
        if shaping is not None:
            for name, x, shape in (("done", shaping.done, (T, B)),
                                   ("raw_reward", shaping.raw_reward,
                                    (T, B, A))):
                if (x.shape != shape or x.dtype != torch.float32
                        or x.device != dev or not x.is_contiguous()):
                    raise ValueError(f"shaping.{name} must be a contiguous "
                                     f"float32 {list(shape)} tensor on {dev}")
            self.table = device_table(cfg, dev)
        self.outs = [torch.empty_like(x) for x in self.ins]
        self.obs = torch.empty(T, B, A, D, dtype=torch.float32, device=dev)
        self.action = torch.empty(T, B, A, dtype=torch.int32, device=dev)
        self.log_prob, self.value, self.reward = (
            torch.empty(T, B, A, device=dev) for _ in range(3))
        self.delivered = torch.empty(T, B, dtype=torch.int32, device=dev)
        self.walls = wall_mask(cfg, dev)

    def env_args(self, cfg) -> tuple:
        """The leading scalar arguments of both C entry points; the
        grid's side is the ego window's or, with global observations, the
        (square, for the CNN) map's."""
        side = cfg.height if cfg.global_obs else cfg.window_size
        return (cfg.num_agents, cfg.queue_capacity, self.B, self.T,
                cfg.height, cfg.width, f32(cfg.spawn_prob), side,
                cfg.obs_radius, cfg.obs_dim, int(cfg.global_obs),
                inv_side(cfg.height), inv_side(cfg.width),
                f32(cfg.step_penalty),
                f32(cfg.pickup_reward), f32(cfg.delivery_reward),
                f32(cfg.collision_penalty))

    def tensor_ptrs(self) -> list:
        """State in, draws, state out, trajectory out, logits and mask,
        then the shaping option (null pointers and zeros when off)."""
        sh = self.shaping
        return [*(x.data_ptr() for x in self.ins),
                *(x.data_ptr() for x in self.draws),
                *(x.data_ptr() for x in self.outs), self.obs.data_ptr(),
                self.action.data_ptr(), self.log_prob.data_ptr(),
                self.value.data_ptr(), self.reward.data_ptr(),
                self.delivered.data_ptr(),
                None if self.logits is None else self.logits.data_ptr(),
                None if self.mask is None else self.mask.data_ptr(),
                None if sh is None else self.table.data_ptr(),
                None if sh is None else sh.done.data_ptr(),
                None if sh is None else sh.raw_reward.data_ptr(),
                0.0 if sh is None else f32(sh.coef),
                0.0 if sh is None else f32(sh.gamma)]

    def results(self, state):
        new = state_from_kernel(self.outs, state.t, state.key)
        return (new, self.obs, self.action, self.log_prob, self.value,
                self.reward, self.delivered)


class ActMlpLaunch:
    """One K2 call on the card: the checked inputs and outputs
    (``_KernelIO``), the packed weights and the workspace (the layers'
    padded kernels, the observation rows ``xs`` in row order, the hidden
    rows, ``head [N, 8]``, the env states), and its C arguments."""

    def __init__(self, cfg, model, state, u, pick, drop, g, logits=None,
                 mask=None, shaping=None, groups=None):
        dev = state.agent_pos.device
        self.weights, self.dims = _mlp_fits(cfg, model, dev, groups)
        self.lib = build.env_library(cfg.num_agents, cfg.queue_capacity)
        dims = build.int_array(self.dims)
        k, gmap = _group_args(cfg, groups)
        if self.weights.numel() != k * self.lib.wh_act_weight_floats(
                len(self.dims) - 1, dims):
            raise ValueError("packed weights do not fit the kernel's layout")
        self.io = _KernelIO(cfg, state, u, pick, drop, g, logits, mask,
                            shaping)
        self.shape = (cfg.num_agents, cfg.queue_capacity, self.io.B,
                      len(self.dims) - 1, dims, k)
        self.work = torch.empty(
            self.lib.wh_act_workspace_floats(*self.shape),
            dtype=torch.float32, device=dev)
        self.args = [*self.io.env_args(cfg), len(self.dims) - 1, dims,
                     self.io.walls.data_ptr(), self.weights.data_ptr(), k,
                     gmap, self.work.data_ptr(), *self.io.tensor_ptrs()]
        self.stream = build.stream_handle(dev)

    def rows(self, layer: int) -> dict:
        """The workspace's step rows, as views: ``x``, layer ``layer``'s
        input rows (the observation rows ``xs`` for layer 0), and ``y``,
        its output rows where a hidden stage writes them (None for the
        last layer, which the head stage runs), each padded with zeros to
        its width rounded up to 32; ``head [N, 8]``."""
        out = (build.L * 5)()
        build.check(self.lib.wh_act_layout(*self.shape, out),
                    "wh_act_layout", self.lib)
        n = self.io.B * self.shape[0]

        def view(off, width):
            ld = -(-width // 32) * 32
            return self.work[off:off + n * ld].view(n, ld)

        x = (view(out[0], self.dims[0]) if layer <= 0 else
             view(out[1 + (layer - 1) % 2], self.dims[layer]))
        y = (view(out[1 + layer % 2], self.dims[layer + 1])
             if 0 <= layer < len(self.dims) - 2 else None)
        return {"x": x, "y": y,
                "head": self.work[out[3]:out[3] + n * 8].view(n, 8)}

    def fill(self, stage: str, inputs: dict, layer: int):
        """Writes a stage's input rows (``act_mlp_stage``'s names,
        unpadded) where its kernel reads them, padding with zeros; returns
        the env stage's buffer for the next observation rows (else
        None)."""
        key = "head" if stage == "env" else "x"
        dst = self.rows(layer)[key]
        dst.zero_()
        dst[:, :inputs[key].shape[1]] = inputs[key]
        return torch.empty_like(self.io.obs[0]) if stage == "env" else None

    def outputs(self, stage: str, state, obs_next, layer: int) -> dict:
        """A stage's outputs after its launch, as ``act_mlp_stage`` names
        them."""
        if stage == "hidden":
            return {"h": self.rows(layer)["y"][
                :, :self.dims[layer + 1]].clone()}
        if stage == "head":
            return {"head": self.rows(layer)["head"][:, :6].clone()}
        return env_stage_outputs(self.io, state, obs_next)

    def launch(self, stage, obs_next=None, layer: int = 0):
        """The whole chunk (``stage`` None), or one of ``ACT_MLP_STAGES``
        of its step 0 on the rows the workspace holds (``hidden``: layer
        ``layer``); the env stage writes the next observation rows into
        ``obs_next``. The chunk returns the kernels it launched, as the C
        entry point counted them: the hidden stages', the head stages', the
        env stages', the prep's."""
        if stage is None:
            launched = (build.L * 4)()
            err = self.lib.wh_act_rollout(*self.args, launched, self.stream)
            build.check(err, "ppo_rollout kernel launch", self.lib)
            return list(launched)
        err = self.lib.wh_act_stage(
            ACT_MLP_STAGES.index(stage), layer, *self.args,
            None if obs_next is None else obs_next.data_ptr(), self.stream)
        build.check(err, f"K2 stage {stage} launch", self.lib)


def env_stage_outputs(io: _KernelIO, state, obs_next) -> dict:
    """The env stage's outputs of step 0 after its launch (K2's and
    K10's), by ``act_env_plain``'s names."""
    new, _, action, lp, value, reward, delivered = io.results(state)
    sh, mask = io.shaping, io.mask
    return {"state": new, "action": action[0], "log_prob": lp[0],
            "value": value[0], "reward": reward[0],
            "raw_reward": reward[0] if sh is None else sh.raw_reward[0],
            "delivered": delivered[0], "logits": io.logits[0],
            "mask": None if mask is None else mask[0], "obs": obs_next}


# ---- K10: the CNN arm -------------------------------------------------------

def cnn_layout(params) -> list[str]:
    """The keys of a CNN params dict in the packed vector's order."""
    keys = [f"conv.{i}.{x}" for i in range(num_conv(params))
            for x in ("weight", "bias")]
    return keys + ["trunk.weight", "trunk.bias", "logits.weight",
                   "value.weight", "logits.bias", "value.bias"]


def pack_cnn(tree) -> torch.Tensor:
    """A CNN params-shaped dict as the kernels' flat float32 vector; a
    conv kernel ``[OC, IC, 3, 3]`` goes in as ``[3, 3, OC, IC]``."""
    parts = [tree[k].detach().permute(2, 3, 0, 1) if tree[k].dim() == 4
             else tree[k].detach() for k in cnn_layout(tree)]
    return torch.cat([x.reshape(-1) for x in parts]
                     ).to(torch.float32).contiguous()


def unpack_cnn(flat: torch.Tensor, like) -> dict:
    """Inverse of ``pack_cnn``: tensors with ``like``'s keys and shapes
    (views of ``flat``, but for the conv kernels, which are relaid)."""
    out, off = {}, 0
    for k in cnn_layout(like):
        n, shape = like[k].numel(), like[k].shape
        seg = flat[off:off + n]
        if len(shape) == 4:
            oc, ic = shape[:2]
            out[k] = seg.view(3, 3, oc, ic).permute(2, 3, 0, 1).contiguous()
        else:
            out[k] = seg.view(shape)
        off += n
    return {k: out[k] for k in like}


def cnn_kernel_dims(params, D: int) -> tuple[int, int, int, int, int]:
    """``(S, C0, C1, C2, H)`` of a CNN params dict for the kernels, which
    take two convs on the observation's grid and a 5-action head."""
    S, chans, H = cnn_dims(params)
    if len(chans) != 3 or D != S * S * chans[0] + 6:
        raise ValueError(f"the CNN kernels take two convs on a {D}-wide "
                         f"observation, got channels {chans} on a {S}x{S} "
                         "grid")
    if params["logits.weight"].shape != (5, H) or (
            params["value.weight"].shape != (1, H)):
        raise ValueError("the CNN kernels take a 5-action head and a value "
                         "head on the trunk's output")
    return (S, *chans, H)


def act_cnn_steps(cfg: EnvConfig, model, state: EnvState, u, pick, drop, g,
                  logits=None, mask=None, shaping=None, groups=None):
    """T acting steps of the CNN policy (with ``groups``, a
    ``MultiPolicyActorCritic`` of CNNs) on precomputed draws and gumbel
    noise: the CUDA kernels (K10: three stage kernels a step) for CUDA
    tensors, the plain twin for CPU tensors. Same arguments and returns as
    ``act_steps_reference``."""
    dev = state.agent_pos.device
    if dev.type == "cpu":
        return act_steps_reference(cfg, model, state, u, pick, drop, g,
                                   logits, mask, shaping, groups)
    if dev.type != "cuda":
        raise ValueError(f"act_cnn_steps: unsupported device {dev}")
    run = ActCnnLaunch(cfg, model, state, u, pick, drop, g, logits, mask,
                       shaping, groups)
    run.launch(None)
    act_cnn_steps.launches += 1
    act_cnn_steps.shaped_launches += shaping is not None
    act_cnn_steps.global_launches += cfg.global_obs
    act_cnn_steps.group_launches += groups is not None
    act_cnn_steps.stage_launches += 3 * u.shape[0] + 2
    return run.io.results(state)


act_cnn_steps.launches = 0
act_cnn_steps.shaped_launches = 0
act_cnn_steps.global_launches = 0
act_cnn_steps.group_launches = 0  # those that routed rows by policy group
# The stage kernels those launches ran: 3 a step (conv, trunk, env), the
# trunk's prep and the first observation.
act_cnn_steps.stage_launches = 0


class ActCnnLaunch:
    """One K10 call on the card: the checked inputs and outputs
    (``_KernelIO``), the packed weights and the workspace (the trunk's
    padded kernels, the rows ``a1 [N, KT]`` and ``head [N, 8]``, the env
    states), and its C arguments."""

    def __init__(self, cfg, model, state, u, pick, drop, g, logits=None,
                 mask=None, shaping=None, groups=None):
        dev = state.agent_pos.device
        self.net = _cnn_fits(cfg, model, dev, groups)
        subs = group_models(model, groups)
        self.lib = build.env_library(cfg.num_agents, cfg.queue_capacity)
        self.weights = torch.cat([pack_cnn(dict(m.named_parameters()))
                                  for m in subs]).to(dev)
        if self.weights.numel() != len(subs) * self.lib.wh_cnn_param_floats(
                *self.net):
            raise ValueError("packed params do not fit the kernel's layout")
        self.io = _KernelIO(cfg, state, u, pick, drop, g, logits, mask,
                            shaping)
        self.k, self.gmap = _cnn_group_args(cfg, groups)
        self.shape = (cfg.num_agents, cfg.queue_capacity, self.io.B,
                      *self.net, self.k)
        self.work = torch.empty(
            self.lib.wh_act_cnn_workspace_floats(*self.shape),
            dtype=torch.float32, device=dev)
        self.args = [*self.io.env_args(cfg), *self.net[1:], self.k,
                     self.gmap, self.io.walls.data_ptr(),
                     self.weights.data_ptr(), self.work.data_ptr(),
                     *self.io.tensor_ptrs()]
        self.stream = build.stream_handle(dev)

    def rows(self) -> dict:
        """The workspace's step rows, as views: ``a1 [N, KT]`` (the
        trunk's input padded with zeros to KT) and ``head [N, 8]``."""
        out = (build.L * 6)()
        build.check(self.lib.wh_act_cnn_layout(*self.shape, out),
                    "wh_act_cnn_layout", self.lib)
        n, kt = self.io.B * self.shape[0], out[4]
        return {"a1": self.work[out[1]:out[1] + n * kt].view(n, kt),
                "head": self.work[out[2]:out[2] + n * 8].view(n, 8)}

    def fill(self, stage: str, inputs: dict):
        """Writes a stage's input rows (``act_cnn_stage``'s names,
        unpadded) where its kernel reads them, padding with zeros; returns
        the env stage's buffer for the next observation rows (else None)."""
        if stage == "conv":
            self.io.obs[0].copy_(inputs["obs"])
            return None
        views = self.rows()
        key = "a1" if stage == "trunk" else "head"
        views[key].zero_()
        views[key][:, :inputs[key].shape[1]] = inputs[key]
        return torch.empty_like(self.io.obs[0]) if stage == "env" else None

    def outputs(self, stage: str, state, obs_next) -> dict:
        """A stage's outputs after its launch, as ``act_cnn_stage`` names
        them."""
        if stage != "env":
            S, _, _, C2, _ = self.net
            views = self.rows()
            return ({"a1": views["a1"][:, :S * S * C2 + 6].clone()}
                    if stage == "conv" else
                    {"head": views["head"][:, :6].clone()})
        return env_stage_outputs(self.io, state, obs_next)

    def launch(self, stage, obs_next=None) -> None:
        """The whole chunk (``stage`` None), or one of ``ACT_CNN_STAGES``
        of its step 0 on the rows the workspace and ``io.obs[0]`` hold; the
        env stage writes the next observation rows into ``obs_next``."""
        if stage is None:
            err = self.lib.wh_act_cnn_rollout(*self.args, self.stream)
            build.check(err, "ppo_rollout (cnn) kernel launch", self.lib)
            return
        err = self.lib.wh_act_cnn_stage(
            ACT_CNN_STAGES.index(stage), *self.args,
            None if obs_next is None else obs_next.data_ptr(), self.stream)
        build.check(err, f"K10 stage {stage} launch", self.lib)


# ---- K10's stages, plain ----------------------------------------------------

ACT_CNN_STAGES = ("conv", "trunk", "env")


def act_cnn_rows(cfg: EnvConfig, B: int, groups=None) -> torch.Tensor:
    """The stages' row order: row q's ``b A + a``. Group 0's (env, agent)
    pairs env by env, each env's in agent order, then group 1's, and so
    on; without groups ``b A + a`` itself."""
    A = cfg.num_agents
    gids = (0,) * A if groups is None else tuple(groups)
    envs = torch.arange(B)[:, None] * A
    return torch.cat([(envs + torch.tensor(
        [a for a in range(A) if gids[a] == k])[None, :]).reshape(-1)
        for k in range(max(gids) + 1)])


def act_cnn_row_groups(cfg: EnvConfig, order, groups=None) -> torch.Tensor:
    """Each row's group, for rows in ``order`` (``act_cnn_rows``)."""
    gids = torch.tensor((0,) * cfg.num_agents if groups is None else groups)
    return gids[order % cfg.num_agents]


def cnn_group_params(model, groups=None) -> list:
    """The params dict of each group's CNN, in group order (``[model]``'s
    without groups)."""
    return [dict(m.named_parameters()) for m in group_models(model, groups)]


def act_conv_plain(params: list, rows, row_group):
    """Stage ``conv``: the trunk's input rows ``a1 [N, S² C2 + 6]`` of the
    observation rows ``rows [N, D]``, each row through its group's
    convolutions (``params``: one CNN params dict a group; ``row_group
    [N]``); relu after each conv, the self features after the channel-last
    grid."""
    # The CNN learner's conv-forward stage computes the same rows.
    from .sgd_cnn import conv_forward_plain

    S, (_, _, C2), _ = cnn_dims(params[0])
    out = rows.new_empty(rows.shape[0], S * S * C2 + 6)
    for k, p in enumerate(params):
        sel = row_group.to(rows.device) == k
        out[sel] = conv_forward_plain(p, rows[sel])[1]
    return out


def act_trunk_plain(params: list, a1, row_group):
    """Stage ``trunk``: ``head [N, 6]``, the 5 logits and the value of
    ``tanh(a1 Wt^T + bt)``, each row through its group's trunk and head."""
    out = a1.new_empty(a1.shape[0], 6)
    for k, p in enumerate(params):
        sel = row_group.to(a1.device) == k
        h = torch.tanh(a1[sel] @ p["trunk.weight"].T + p["trunk.bias"])
        wh = torch.cat([p["logits.weight"], p["value.weight"]])
        out[sel] = h @ wh.T + torch.cat([p["logits.bias"], p["value.bias"]])
    return out


def act_env_plain(cfg: EnvConfig, state: EnvState, head, order, u, pick,
                  drop, g, mask_on: bool = False, shaping=None) -> dict:
    """Stage ``env`` of one step: the head rows ``head [N, 6]`` (in
    ``order``) as each (env, agent)'s logits and value, then
    ``env_step_plain`` on them (``mask_on``, ``shaping`` as there) and
    the next observation rows. Returns ``env_step_plain``'s outputs and
    ``value``, ``logits`` (before the mask) and ``obs`` by name."""
    B, A = state.agent_pos.shape[:2]
    by_pair = head.new_empty(B * A, 6)
    by_pair[order.to(head.device)] = head
    by_pair = by_pair.view(B, A, 6)
    logits, value = by_pair[..., :5], by_pair[..., 5]
    out = env_step_plain(cfg, state, logits, u, pick, drop, g, mask_on,
                         shaping)
    return {**out, "value": value, "logits": logits,
            "obs": engine.observe_state(cfg, out["state"])}


def act_cnn_steps_staged(cfg: EnvConfig, model, state: EnvState, u, pick,
                         drop, g, logits=None, mask=None, shaping=None,
                         groups=None):
    """The three plain stages composed, step by step, on the rows in the
    kernels' order: ``act_steps_reference``'s arguments and returns."""
    params = cnn_group_params(model, groups)
    B = state.agent_pos.shape[0]
    order = act_cnn_rows(cfg, B, groups)
    row_group = act_cnn_row_groups(cfg, order, groups)
    obs, outs = engine.observe_state(cfg, state), []
    with torch.no_grad():
        for t in range(u.shape[0]):
            rows = obs.reshape(B * cfg.num_agents, -1)[order.to(obs.device)]
            head = act_trunk_plain(params,
                                   act_conv_plain(params, rows, row_group),
                                   row_group)
            out = act_env_plain(cfg, state, head, order, u[t], pick[t],
                                drop[t], g[t], mask is not None,
                                _step_shaping(shaping, t))
            if logits is not None:
                logits[t] = out["logits"]
            _keep_step(out, t, mask, shaping)
            outs.append((obs, out["action"], out["log_prob"], out["value"],
                         out["reward"], out["delivered"]))
            state, obs = out["state"], out["obs"]
    return (state, *(torch.stack(x) for x in zip(*outs)))


def act_cnn_stage(stage: str, cfg: EnvConfig, model, state: EnvState,
                  inputs: dict, u, pick, drop, g, mask_on: bool = False,
                  shaping=None, groups=None) -> dict:
    """One of ``ACT_CNN_STAGES`` of one step, on the rows ``inputs`` (in
    ``act_cnn_rows``' order): ``conv`` takes ``obs [B, A, D]`` and gives
    ``a1``; ``trunk`` takes ``a1`` and gives ``head [N, 6]``; ``env``
    takes ``head`` and the step's state and draws (``u``, ``pick``,
    ``drop`` ``[1, B]``, ``g [1, 5, B A]``; ``shaping`` a ``Shaping`` of
    one step) and gives ``act_env_plain``'s outputs. The stage's kernel on
    CUDA tensors, its plain version on CPU ones; ``launches`` counts the
    kernel launches."""
    if stage not in ACT_CNN_STAGES:
        raise ValueError(f"stage must be one of {ACT_CNN_STAGES}, "
                         f"got {stage!r}")
    dev = state.agent_pos.device
    B, A = state.agent_pos.shape[:2]
    if dev.type == "cpu":
        params = cnn_group_params(model, groups)
        order = act_cnn_rows(cfg, B, groups)
        row_group = act_cnn_row_groups(cfg, order, groups)
        with torch.no_grad():
            if stage == "conv":
                rows = inputs["obs"].reshape(B * A, -1)[order]
                return {"a1": act_conv_plain(params, rows, row_group)}
            if stage == "trunk":
                return {"head": act_trunk_plain(params, inputs["a1"],
                                                row_group)}
            return act_env_plain(cfg, state, inputs["head"], order, u[0],
                                 pick[0], drop[0], g[0], mask_on,
                                 _step_shaping(shaping, 0))
    logits = torch.empty(1, B, A, 5, device=dev)
    mask = (torch.empty(1, B, A, 5, dtype=torch.bool, device=dev)
            if mask_on else None)
    run = ActCnnLaunch(cfg, model, state, u, pick, drop, g, logits, mask,
                       shaping, groups)
    obs_next = run.fill(stage, inputs)
    run.launch(stage, obs_next)
    act_cnn_stage.launches += 1
    return run.outputs(stage, state, obs_next)


act_cnn_stage.launches = 0


# ---- K2's stages, plain -----------------------------------------------------

ACT_MLP_STAGES = ("hidden", "head", "env")


def act_hidden_plain(models: list, layer: int, x, row_group):
    """Stage ``hidden``: ``tanh(x W^T + b)`` of hidden layer ``layer`` on
    the rows ``x [N, in]`` (``models``: one MLP a group; ``row_group
    [N]``), each row through its group's layer."""
    out = x.new_empty(x.shape[0], models[0].hidden[layer].out_features)
    for k, m in enumerate(models):
        sel = row_group.to(x.device) == k
        lin = m.hidden[layer]
        out[sel] = torch.tanh(x[sel] @ lin.weight.T + lin.bias)
    return out


def act_head_plain(models: list, x, row_group):
    """Stage ``head``: ``head [N, 6]``, the 5 logits and the value, of the
    last hidden layer's input rows ``x`` (the observation rows without
    hidden layers), each row through its group's last layer and head."""
    out = x.new_empty(x.shape[0], 6)
    for k, m in enumerate(models):
        sel = row_group.to(x.device) == k
        h = x[sel]
        if len(m.hidden):
            h = torch.tanh(h @ m.hidden[-1].weight.T + m.hidden[-1].bias)
        wh = torch.cat([m.logits.weight, m.value.weight])
        out[sel] = h @ wh.T + torch.cat([m.logits.bias, m.value.bias])
    return out


def act_mlp_steps_staged(cfg: EnvConfig, model, state: EnvState, u, pick,
                         drop, g, logits=None, mask=None, shaping=None,
                         groups=None):
    """K2's plain stages composed, step by step, on the rows in the
    kernels' order: ``act_steps_reference``'s arguments and returns."""
    models = group_models(model, groups)
    B = state.agent_pos.shape[0]
    order = act_cnn_rows(cfg, B, groups)
    row_group = act_cnn_row_groups(cfg, order, groups)
    obs, outs = engine.observe_state(cfg, state), []
    with torch.no_grad():
        for t in range(u.shape[0]):
            x = obs.reshape(B * cfg.num_agents, -1)[order.to(obs.device)]
            for layer in range(len(models[0].hidden) - 1):
                x = act_hidden_plain(models, layer, x, row_group)
            out = act_env_plain(cfg, state,
                                act_head_plain(models, x, row_group), order,
                                u[t], pick[t], drop[t], g[t],
                                mask is not None, _step_shaping(shaping, t))
            if logits is not None:
                logits[t] = out["logits"]
            _keep_step(out, t, mask, shaping)
            outs.append((obs, out["action"], out["log_prob"], out["value"],
                         out["reward"], out["delivered"]))
            state, obs = out["state"], out["obs"]
    return (state, *(torch.stack(x) for x in zip(*outs)))


def act_mlp_stage(stage: str, cfg: EnvConfig, model, state: EnvState,
                  inputs: dict, u, pick, drop, g, mask_on: bool = False,
                  shaping=None, groups=None, layer: int = 0) -> dict:
    """One of ``ACT_MLP_STAGES`` of one step, on rows in ``act_cnn_rows``'
    order: ``hidden`` takes hidden layer ``layer``'s input rows ``x``
    (the observation rows for layer 0) and gives its output ``h``; ``head``
    takes the last hidden layer's input rows ``x`` and gives ``head [N,
    6]``; ``env`` takes ``head`` and the step's state and draws (``u``,
    ``pick``, ``drop`` ``[1, B]``, ``g [1, 5, B A]``; ``shaping`` a
    ``Shaping`` of one step) and gives ``act_env_plain``'s outputs. The
    stage's kernel on CUDA tensors, its plain version on CPU ones;
    ``launches`` counts the kernel launches."""
    if stage not in ACT_MLP_STAGES:
        raise ValueError(f"stage must be one of {ACT_MLP_STAGES}, "
                         f"got {stage!r}")
    dev = state.agent_pos.device
    B, A = state.agent_pos.shape[:2]
    models = group_models(model, groups)
    L = len(models[0].hidden)
    if stage == "hidden" and not 0 <= layer < L - 1:
        raise ValueError(f"the hidden stage runs layers 0 to {L - 2} of "
                         f"{L} (the head stage the last), got {layer}")
    if dev.type == "cpu":
        order = act_cnn_rows(cfg, B, groups)
        row_group = act_cnn_row_groups(cfg, order, groups)
        with torch.no_grad():
            if stage == "hidden":
                return {"h": act_hidden_plain(models, layer, inputs["x"],
                                              row_group)}
            if stage == "head":
                return {"head": act_head_plain(models, inputs["x"],
                                               row_group)}
            return act_env_plain(cfg, state, inputs["head"], order, u[0],
                                 pick[0], drop[0], g[0], mask_on,
                                 _step_shaping(shaping, 0))
    logits = torch.empty(1, B, A, 5, device=dev)
    mask = (torch.empty(1, B, A, 5, dtype=torch.bool, device=dev)
            if mask_on else None)
    run = ActMlpLaunch(cfg, model, state, u, pick, drop, g, logits, mask,
                       shaping, groups)
    layer = layer if stage == "hidden" else L - 1
    obs_next = run.fill(stage, inputs, layer)
    run.launch(stage, obs_next, layer)
    act_mlp_stage.launches += 1
    return run.outputs(stage, state, obs_next, layer)


act_mlp_stage.launches = 0


def _check_options(cfg, model, policy_groups, arch):
    if cfg.auto_reset:
        raise ValueError("ppo_rollout: auto_reset is handled by the caller")
    if arch in ("gru", "lstm"):
        raise ValueError(f"ppo_rollout: arch={arch!r} acts through "
                         "kernels.act_rnn.ppo_rnn_rollout")
    if arch not in ("mlp", "cnn"):
        raise NotImplementedError(
            f"ppo_rollout: arch={arch!r}: the acting kernels implement the "
            "MLP and the CNN, as the TPU kernel does; the trainers act with "
            "other policies through their per-step phase")
    multi = isinstance(model, MultiPolicyActorCritic)
    if multi != (policy_groups is not None):
        raise ValueError(f"ppo_rollout: a {type(model).__name__} does not "
                         f"fit policy_groups={policy_groups}")
    if multi:
        if len(policy_groups) != cfg.num_agents or (
                len(model.policies) != max(policy_groups) + 1):
            raise ValueError(f"ppo_rollout: policy_groups={policy_groups} "
                             f"does not fit {cfg.num_agents} agents and "
                             f"{len(model.policies)} policies")
        model = model.policies[0]
    if isinstance(model, ActorCriticCNN) != (arch == "cnn"):
        raise ValueError(f"ppo_rollout: arch={arch!r} does not fit a "
                         f"{type(model).__name__}")


def chunk_rollout(run_steps, cfg: EnvConfig, state: EnvState, T: int,
                  key: torch.Tensor, mask_actions: bool,
                  shaping_coef: float = 0.0, gamma: float = 0.99):
    """The wrapper shared by the acting kernels: draws the chunk's env
    stream and gumbel noise, calls ``run_steps(u, pick, drop, g, mask,
    shaping)`` -> ``(state, obs, action, log_prob, value, reward,
    delivered, *rest)`` and returns ``(EnvState, ActRollout,
    reset_key_last, next_key, *rest)`` with the step counter, the env keys
    and the truncation flags filled in. ``shaping`` is a ``Shaping`` when
    ``shaping_coef > 0`` (its flags computed for every step of the chunk,
    not only the last), else None."""
    B, A = state.agent_pos.shape[:2]
    dev = state.agent_pos.device
    with annotate("draws", dev):
        final_keys, u, pick, drop, reset_keys = _rng.batched_step_draws(
            state.key, cfg, T)
        next_key, g = _rng.batched_gumbel_stream(key, T, (5, B * A))
    mask = torch.ones(T, B, A, 5, dtype=torch.bool, device=dev)
    steps_ahead = (state.t[None, :] + 1
                   + torch.arange(T, dtype=state.t.dtype,
                                  device=state.t.device)[:, None])
    truncated = steps_ahead >= cfg.max_steps
    shaping = None
    if shaping_coef > 0.0:
        shaping = Shaping(shaping_coef, gamma, truncated.to(torch.float32),
                          torch.empty(T, B, A, dtype=torch.float32,
                                      device=dev))
    with annotate("act_kernel", dev):
        new, obs, action, lp, value, reward, delivered, *rest = run_steps(
            u, pick, drop, g, mask if mask_actions else None, shaping)
    roll = ActRollout(
        obs=obs, action=action, log_prob=lp, value=value, reward=reward,
        delivered=delivered, truncated=truncated, mask=mask,
        raw_reward=reward if shaping is None else shaping.raw_reward)
    new = new.replace(t=state.t + T, key=final_keys)
    return (new, roll, reset_keys[-1], next_key, *rest)


def _rollout(steps, cfg: EnvConfig, model, state: EnvState,
             T: int, key: torch.Tensor, mask_actions: bool = False,
             shaping_coef: float = 0.0, gamma: float = 0.99,
             policy_groups=None, arch: str = "mlp"):
    _check_options(cfg, model, policy_groups, arch)
    groups = None if policy_groups is None else tuple(
        int(x) for x in policy_groups)
    return chunk_rollout(
        lambda u, pick, drop, g, mask, shaping: steps(
            cfg, model, state, u, pick, drop, g, mask=mask, shaping=shaping,
            groups=groups),
        cfg, state, T, key, mask_actions, shaping_coef, gamma)


def ppo_rollout(cfg: EnvConfig, model, state: EnvState, T: int,
                key: torch.Tensor, **options):
    """T acting steps of the MLP policy or, with ``arch="cnn"``, of the
    CNN policy, through its kernel on a CUDA state: ``(EnvState,
    ActRollout, reset_key_last, next_key)``. ``options``
    (``mask_actions``, ``shaping_coef``, ``gamma``, ``policy_groups``,
    ``arch``) take the JAX wrapper's names; ``mask_actions``,
    ``shaping_coef`` with its ``gamma``, ``arch`` "mlp" / "cnn" and
    ``policy_groups`` (the model a ``MultiPolicyActorCritic``) are ported.
    ``cfg.global_obs`` picks the global view."""
    return _rollout(act_steps, cfg, model, state, T, key, **options)


def ppo_rollout_reference(cfg: EnvConfig, model, state: EnvState, T: int,
                          key: torch.Tensor, **options):
    """The plain PyTorch twin of ``ppo_rollout`` on any device."""
    return _rollout(act_steps_reference, cfg, model, state, T, key,
                    **options)

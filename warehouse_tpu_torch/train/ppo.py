"""The PPO actor-learner (counterpart of ``warehouse_tpu/train/ppo.py``).

One update, draw for draw as the JAX trainer with, per phase, its kernel
(``rollout_backend="pallas"``) or its XLA route:

1. with ``minibatch_mode="env"`` and ``epoch_shuffle="once"``, permute the
   env axis of the state and its observations with
   ``permutation(fold_in(key, 0x5EED), B)`` ("shuffle the envs, not the
   data": minibatches are then contiguous env ranges, :370-386); with any
   other cadence the state is not permuted;
2. act T steps: through ``kernels.ppo_rollout`` (K2; K10 with
   ``arch="cnn"``), which with ``shaping_coef > 0`` adds the potential
   shaping to the reward it returns, then the boundary reset
   ``reset_truncated_batch`` (:399-410), and with ``bootstrap_truncated``
   V of the pre-reset states (:412-422); or, where no acting kernel takes
   the configuration (``rollout_problems``), through ``step_rollout``, the
   per-step phase of the JAX XLA scan (:431-476): the model at its own
   dtype, the mask, the sample, the potential before and after the tick,
   ``step_autoreset_batch`` (the reset inside the chunk), the bootstrap
   from ``final_obs`` on every step;
3. GAE from ``last_value``;
4. the SGD phase: where a learner kernel takes the configuration,
   advantages normalized per env minibatch and ``kernels.ppo_sgd_phase``
   (K3) or, for the CNN, ``kernels.ppo_cnn_sgd_phase`` (K11), with the
   per-step lr and bias-correction rows (:678-686); else the plain learner
   phase of the JAX XLA route (``_learn`` :481-602): autograd through
   ``models.policy.apply`` at the model's precision (the flax-bf16 forward
   at bfloat16), ``ops.ppo_update``'s scaffold and ``optim.py``;
5. the scaffold's key splits (``partition_keys``: one for "once", one per
   epoch for "each"), the metrics and the adaptive KL coefficient
   (:713-746).

Each phase's route follows from the configuration alone, as the JAX
trainer's ``_rollout_problems`` / ``_grad_problems`` (:162-303) decide
between its kernel and XLA, never from a failed build or launch:
``PPOTrainer.backends`` is ``{"rollout": "cuda" | "plain" | "step",
"grad": "cuda" | "plain"}`` (``make_backends``), the counterpart of JAX
``PPOTrainer.backends`` (:825). Acting is per step (``"step"``, on every
device) for the attention torso, ``max_steps % unroll_length != 0`` (an
episode may end inside a chunk) and the CNN on a global grid wider than
9x9 (the 11x11 shelves map, whose conv tiles K10 / K11 cannot hold, as
the JAX VMEM gates route it to XLA). The learner is plain where the JAX
trainer resolves it to XLA: the attention torso, that CNN, the CNN with
``policy_groups`` (its fused learner is single-policy, :243-247),
``minibatch_mode="flat"`` or ``epoch_shuffle="each"``
(``--rllib-cadence``), ``micro_batches > 1`` (the mean of the
micro-gradients, one optimizer step, advantages normalized per minibatch,
:564-587) and ``flat_optimizer`` (``optax.flatten``: clip and Adam over
one vector). On a CUDA device the kernels run and a build or launch
failure raises; on the CPU the kernels' phases run their plain twins.
``PPOTrainer.plain_step`` is the same update with the acting kernel's
twin and, where the learner is a kernel, its twin.

Ported besides: the MLP, CNN and attention policies, one shared policy or
``policy_groups`` (:94-113: K independent policies, a
``MultiPolicyActorCritic``, each agent acting and learning through its
group's; K2 / K10 and K3/K4 route each row by its agent's group, the
bootstrap and last values take each agent's group's), ``model_dtype``
float32 or bfloat16 (the JAX trainer's, :91-110: the model is built at
that compute dtype, so the bootstrap, the last values and the per-step
phase take the flax-bf16 forward; the learner kernels K3/K4 and K11/K12
take ``matmul_dtype="bfloat16"``; acting in K2/K10 stays float32), entropy
anneal, adaptive KL, truncation bootstrap, lr anneal, action masking (the
invalid moves floored, the loss re-applies the mask), potential shaping
(GAE reads the shaped reward, the ``reward_per_step`` metric the raw
one), global observations (the acting kernels build the global view, the
learners read the wider observation). The kernels take any model width
and any number of hidden layers; on the card ``make_train`` raises
``ValueError`` for what they cannot hold (the shared memory a width needs,
and ROADMAP T-7: more than 128 agents, a grouped learner over more than 16
agents), whichever route, before any launch; an env's (agents, queue) pair
outside the presets builds its env kernels at first use
(``kernels.build``). The
TPU block knobs (``pallas_block``, ``pallas_interpret``,
``sgd_block_envs``, ``sgd_rows_per_block``) have no counterpart and are
ignored; ``rollout_backend``/``grad_backend="xla"`` raises.

With ``mesh`` (a ``parallel.mesh.DataMesh``: one rank per card, the JAX
trainer's ``shard_map`` over the ``data`` axis, :748-786) each rank owns
``num_envs / world`` envs and steps them as above; ``init_global(key)``
makes this rank's part of ``init(key)`` (its envs' resets from
``fold_in(ekey, i)`` for its global indices ``i``, the shard key
``fold_in(skey, rank)``, the params and moments alike on every rank), and
``shard_runner_state`` cuts a whole state down to it. The learner averages
each minibatch's gradient and loss terms over the ranks before the step:
where a learner kernel takes the configuration, the meshed route (JAX
:694-708) — per step K4's gradient (K12's for the CNN) on this rank's
minibatch, one ``all_reduce`` of the gradient and its loss sums, then the
clip + Adam kernel (their twins and ``optim.py`` on the CPU); else the plain
phase with the average where the JAX scaffold ``pmean``s. The KL mean, the
reward and the deliveries are averaged too before the metrics (:713-726).
A world of 1 takes the meshed route all the same, as JAX's 1-device mesh
does.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..config import EnvConfig, TrainConfig
from ..device import resolve_device

from .. import rng
from ..env import engine
from ..env.batch import (observe_batch, reset_truncated_batch,
                         step_autoreset_batch_any)
from ..env.state import STATE_FIELDS, EnvState
from ..kernels.act import (ActRollout, check_act_fits, check_cnn_widths,
                           ppo_rollout, ppo_rollout_reference)
from ..kernels.rollout import f32
from ..kernels.sgd import (check_group_map, check_learner_fits,
                           normalize_adv_env_minibatch,
                           ppo_sgd_phase, ppo_sgd_phase_reference)
from ..kernels.sgd_cnn import (check_cnn_learner_fits, ppo_cnn_sgd_phase,
                               ppo_cnn_sgd_phase_reference)
from ..kernels.sgd_rnn import zero_where
from ..models.policy import (FEED_FORWARD, apply, make_model,
                             make_multi_policy_model, model_precision,
                             params_from_flax)
from ..ops.gae import gae
from ..ops.move import valid_action_mask
from ..ops.pathing import potential
from ..ops.ppo_update import (NEG_INF, adaptive_kl_coeff, entropy_coef_at,
                              env_major_minibatches, flat_minibatches,
                              minibatch_epochs, partition_keys, ppo_losses,
                              sample_action_with_gumbel)
from ..optim import AdamState, ClipAdam, make_optimizer, opt_state_from_optax
from ..parallel.mesh import DATA_AXIS, gather_batch, shard_batch
from ..utils.profiling import annotate

PERM_SALT = 0x5EED  # fold_in salt of the env-state permutation key
CNN_KERNEL_GRID = 9  # the largest global grid side K10 / K11 hold
# The route of each phase, in ``backends``: the kernel on the card, its
# plain twin on the CPU, or (acting only) the per-step phase on any device.
KERNEL, PLAIN, STEP = "cuda", "plain", "step"


class RunnerState(NamedTuple):
    params: dict             # the model's state_dict-keyed tensors
    opt_state: AdamState
    env_state: EnvState      # [B] envs (a rank's: its B / world)
    obs: torch.Tensor        # float32[B, A, obs_dim]
    key: torch.Tensor        # int64[2] threefry key words ([world, 2]: whole)
    update_idx: torch.Tensor  # int32[]
    kl_coeff: torch.Tensor   # float32[] adaptive KL penalty


class Transition(NamedTuple):
    obs: torch.Tensor         # float32[T, B, A, obs_dim]
    action: torch.Tensor      # int32[T, B, A]
    log_prob: torch.Tensor
    value: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor        # bool[T, B, A]
    mask: torch.Tensor        # bool[T, B, A, 5] (all True: no masking)
    boot_value: torch.Tensor  # V(pre-reset successor) (0 if off)


class PPOTrainer(NamedTuple):
    init: Callable        # key int64[2] -> RunnerState
    train_step: Callable  # (rs, mark=None) -> (rs, metrics)
    train_many: Callable  # (rs, n) -> (rs, metrics stacked [n])
    plain_step: Callable  # train_step through the plain twins
    model: torch.nn.Module  # holds the params the act phase reads
    optimizer: ClipAdam
    env_cfg: EnvConfig
    tcfg: TrainConfig
    device: torch.device
    policy_groups: tuple | None = None  # agent -> policy group, or None
    backends: dict | None = None  # {"rollout", "grad"}: make_backends'
    mesh: Any = None  # the DataMesh, or None on one device
    init_global: Callable | None = None  # key -> this rank's RunnerState
    shard_runner_state: Callable | None = None  # whole state -> this rank's


def check_backend_names(tcfg: TrainConfig) -> None:
    """Refuse ``rollout_backend`` / ``grad_backend="xla"``: the port
    picks each phase's route from the configuration and the device."""
    for name in ("rollout_backend", "grad_backend"):
        if getattr(tcfg, name) == "xla":
            raise ValueError(f"{name}='xla': the port has no backend switch;"
                             " each phase runs its kernel where one takes the"
                             " configuration (CUDA), else plain PyTorch")


def make_backends(device, rollout_problems: list,
                  grad_problems: list) -> dict:
    """The trainers' ``backends``, each phase's route. Acting: ``"step"``,
    the per-step phase (``step_rollout``) on any device, where
    ``rollout_problems`` names an option or shape the acting kernel does
    not take (the JAX trainer's XLA scan); else the acting kernel on a
    CUDA device (``"cuda"``), its plain twin on the CPU (``"plain"``). The
    learner: its kernel on a CUDA device unless ``grad_problems`` names
    something, else ``"plain"``."""
    cuda = device.type == "cuda"
    return {"rollout": (STEP if rollout_problems
                        else KERNEL if cuda else PLAIN),
            "grad": KERNEL if cuda and not grad_problems else PLAIN}


def global_cnn_too_wide(env_cfg: EnvConfig, arch: str) -> bool:
    """The CNN on a global grid wider than ``CNN_KERNEL_GRID`` (the 11x11
    shelves map): K10's and K11's conv tiles do not fit a block beside the
    conv kernels there, and the JAX trainer's VMEM gates send both phases
    to XLA (``train/ppo.py:191-219``, :239-268)."""
    return (arch == "cnn" and env_cfg.global_obs
            and env_cfg.height > CNN_KERNEL_GRID)


def rollout_problems(env_cfg: EnvConfig, tcfg: TrainConfig,
                     arch: str) -> list:
    """What the PPO acting kernels (K2, K10) do not take (the JAX
    trainer's ``_rollout_problems``, :162-227, less the TPU's VMEM
    estimates, the only place policy groups enter it, and block lanes):
    where this is not empty the acting phase is the per-step one."""
    problems = []
    if arch not in ("mlp", "cnn"):
        problems.append(f"arch={arch!r} (the acting kernels implement "
                        "MLP/CNN)")
    if global_cnn_too_wide(env_cfg, arch):
        problems.append(f"arch='cnn' with global_obs on a {env_cfg.height}x"
                        f"{env_cfg.width} map (the CNN kernels hold grids up "
                        f"to {CNN_KERNEL_GRID}x{CNN_KERNEL_GRID})")
    if env_cfg.max_steps % tcfg.unroll_length:
        problems.append("max_steps % unroll_length != 0")
    return problems


def grad_problems(env_cfg: EnvConfig, tcfg: TrainConfig, arch: str,
                  policy_groups) -> list:
    """The options of ``tcfg`` and the shape of ``env_cfg`` that no PPO
    learner kernel computes (the JAX trainer's ``_grad_problems``,
    :239-288): where this is not empty the SGD phase is plain."""
    problems = []
    if arch not in ("mlp", "cnn"):
        problems.append(f"arch={arch!r} (the learner kernels implement "
                        "MLP/CNN)")
    if global_cnn_too_wide(env_cfg, arch):
        problems.append(f"arch='cnn' with global_obs on a {env_cfg.height}x"
                        f"{env_cfg.width} map")
    if arch == "cnn" and policy_groups is not None:
        problems.append("policy_groups with arch='cnn' (the CNN learner "
                        "kernel is single-policy)")
    if tcfg.minibatch_mode != "env" or tcfg.epoch_shuffle != "once":
        problems.append("epoch_shuffle != 'once' or minibatch_mode != 'env'")
    if tcfg.micro_batches != 1:
        problems.append("micro_batches != 1")
    if tcfg.flat_optimizer:
        problems.append("flat_optimizer")
    return problems


def local_envs(tcfg: TrainConfig, mesh) -> int:
    """The envs each rank steps: ``num_envs`` over the mesh's data axis
    (all of them without a mesh), as the JAX trainers' ``b_local``."""
    n_shards = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if tcfg.num_envs % n_shards:
        raise ValueError(f"num_envs={tcfg.num_envs} not divisible by "
                         f"{n_shards} shards")
    return tcfg.num_envs // n_shards


def _check_config(env_cfg: EnvConfig, tcfg: TrainConfig, arch, mesh) -> None:
    if arch in ("gru", "lstm"):
        raise ValueError(f"arch={arch!r}: the recurrent policies train "
                         "through train.ppo_rnn.make_train_rnn")
    if arch not in FEED_FORWARD:
        raise ValueError(f"unknown arch {arch!r}")
    check_backend_names(tcfg)
    b = local_envs(tcfg, mesh)
    batch = tcfg.unroll_length * b * env_cfg.num_agents
    if batch % tcfg.num_minibatches:
        raise ValueError("T*B_local*A must divide into num_minibatches")
    if tcfg.minibatch_mode == "env" and b % tcfg.num_minibatches:
        raise ValueError(f"B_local={b} not divisible by "
                         f"num_minibatches={tcfg.num_minibatches}")
    mb_samples = batch // tcfg.num_minibatches
    if mb_samples % tcfg.micro_batches:
        raise ValueError(f"micro_batches={tcfg.micro_batches} must divide "
                         f"the minibatch sample count {mb_samples}")


def _tensor(x, device=None) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if a.dtype.name == "bfloat16":  # a bf16 carry: the same bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def runner_state_from_jax(rs_np, device=None) -> RunnerState:
    """A JAX ``RunnerState`` of the single-device trainer, its leaves as
    numpy, as the port's: params through ``params_from_flax``, the
    optimizer through ``opt_state_from_optax`` (a flattened one too),
    uint32 keys as int64 (the shard key ``[1, 2]`` as ``[2]``; a meshed
    state's ``[world, 2]`` kept)."""
    params = {k: v.to(device)
              for k, v in params_from_flax(rs_np.params).items()}
    env = EnvState(**{f: _tensor(getattr(rs_np.env_state, f), device)
                      for f in STATE_FIELDS})
    return RunnerState(
        params=params,
        opt_state=opt_state_from_optax(rs_np.opt_state, device,
                                       params_like=rs_np.params),
        env_state=env,
        obs=_tensor(rs_np.obs, device),
        key=shard_keys(_tensor(rs_np.key, device)),
        update_idx=_tensor(rs_np.update_idx, device).to(torch.int32),
        kl_coeff=_tensor(rs_np.kl_coeff, device).to(torch.float32))


def shard_keys(key: torch.Tensor) -> torch.Tensor:
    """A JAX state's shard keys ``[n, 2]``: ``[2]`` for one shard."""
    return key.reshape(2) if key.numel() == 2 else key


# The runner states' fields cut over the data axis (the JAX trainers'
# ``P(DATA_AXIS)`` specs); ``key`` is one row per rank.
SHARDED = ("env_state", "obs", "carry")


def shard_runner_state(rs, mesh):
    """A whole runner state (PPO, recurrent or IMPALA) cut to this rank's
    part: its rows of the env batch, the observations and the carry, and
    its shard key; ``rs`` itself without a mesh (JAX ``shard_runner_state``,
    :788-807)."""
    if mesh is None:
        return rs
    cut = {f: shard_batch(mesh, getattr(rs, f)) for f in SHARDED
           if f in rs._fields}
    return rs._replace(key=rs.key.reshape(-1, 2)[mesh.rank], **cut)


def unshard_runner_state(rs, mesh):
    """The inverse of ``shard_runner_state``: every rank's part joined in
    rank order, the keys ``[world, 2]`` (a collective: every rank calls
    it). For a checkpoint of a meshed run."""
    if mesh is None:
        return rs
    whole = {f: gather_batch(mesh, getattr(rs, f)) for f in SHARDED
             if f in rs._fields}
    return rs._replace(key=gather_batch(mesh, rs.key[None]), **whole)


def build_model(cfg: EnvConfig, tcfg: TrainConfig, arch: str, device,
                policy_groups=None, generator=None) -> torch.nn.Module:
    """The policy of ``arch`` at ``tcfg``'s widths and compute dtype or,
    with ``policy_groups``, the ``MultiPolicyActorCritic`` of one per
    group."""
    if policy_groups is None:
        return make_model(cfg, arch, tcfg.hidden_dim, tcfg.num_layers,
                          generator, device, tcfg.model_dtype)
    return make_multi_policy_model(cfg, policy_groups, arch, tcfg.hidden_dim,
                                   tcfg.num_layers, generator, device,
                                   tcfg.model_dtype)


def init_parts(cfg: EnvConfig, tcfg: TrainConfig, arch: str, device,
               key: torch.Tensor, policy_groups=None, envs=None, shard=0):
    """The start of a run from ``key``, as the JAX trainers' ``init``:
    ``split(key, 3)``; the params from a ``torch.Generator`` seeded by the
    first key (flax's bits are not reproduced; with ``policy_groups`` the
    groups' sub-models in group order); env b reset from ``fold_in(ekey,
    b)`` for b in ``envs`` (a ``range``, all ``num_envs`` by default); the
    shard key ``fold_in(skey, shard)`` (``shard`` an int, or a tensor of
    them for one key each). Returns ``(params, env_state, obs, key)``."""
    pkey, ekey, skey = rng.split(key.to(device), 3)
    seed = int(pkey[0]) << 32 | int(pkey[1])
    init_model = build_model(cfg, tcfg, arch, device, policy_groups,
                             torch.Generator().manual_seed(seed))
    params = {k: v.detach().clone()
              for k, v in init_model.state_dict().items()}
    envs = range(tcfg.num_envs) if envs is None else envs
    env_state, obs = engine.reset(
        cfg, rng.fold_in(ekey, torch.arange(envs.start, envs.stop,
                                            device=device)))
    return params, env_state, obs, rng.fold_in(skey, shard)


def init_range(tcfg: TrainConfig, mesh, whole: bool):
    """``init_parts``' ``(envs, shard)``: the whole run's (every env; the
    keys of all ``world`` shards with a mesh, one key without), or, with
    ``whole`` False, this rank's (its envs and its shard key)."""
    if mesh is None:
        return None, 0
    if whole:
        return None, torch.arange(mesh.world)
    rows = mesh.rows(tcfg.num_envs)
    return range(rows.start, rows.stop), mesh.rank


def run_many(train_step: Callable, rs, n: int):
    """n updates of ``train_step``; metrics stacked ``[n]``."""
    rows: list[dict[str, Any]] = []
    for _ in range(n):
        rs, m = train_step(rs)
        rows.append(m)
    return rs, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def update_metrics(tcfg: TrainConfig, losses, kl_coeff, roll, mesh=None):
    """The metrics of one PPO update and the adapted KL coefficient, from
    the SGD phase's ``losses`` and the chunk's rollout
    (``warehouse_tpu/train/ppo.py:713-746``); with ``mesh`` the KL mean, the
    reward and the deliveries averaged over its ranks (one
    ``all_reduce``) before the KL coefficient adapts."""
    T, B = roll.delivered.shape
    mean_kl = losses[4].mean()
    reward = roll.raw_reward.mean(dim=(1, 2)).mean()
    deliveries = roll.delivered.sum(dtype=torch.float32) / (T * B)
    if mesh is not None:
        mean_kl, reward, deliveries = mesh.mean([mean_kl, reward,
                                                 deliveries])
    kl_coeff = adaptive_kl_coeff(tcfg, kl_coeff, mean_kl)
    return {
        "loss": losses[0].mean(),
        "pg_loss": losses[1].mean(),
        "v_loss": losses[2].mean(),
        "entropy": losses[3].mean(),
        "kl": mean_kl,
        "kl_coeff": kl_coeff,
        "reward_per_step": reward,
        "deliveries_per_env_step": deliveries,
    }, kl_coeff


def step_rollout(cfg: EnvConfig, tcfg: TrainConfig, policy: Callable,
                 state: EnvState, obs: torch.Tensor, T: int,
                 key: torch.Tensor, carry=None):
    """The per-step acting phase of the JAX trainers' XLA route
    (``train/ppo.py:431-476``, ``train/impala.py:279-312``,
    ``train/ppo_rnn.py:288-332``), step for step: ``key, akey =
    split(key)``; ``policy(obs, carry) -> (logits, value, new_carry)``;
    with ``mask_actions`` the invalid moves' logits floored to -1e9;
    ``sample_action(akey, logits)`` (the gumbel noise of the chunk's
    ``akey`` chain and the env's draws made in bulk beforehand, as the
    acting kernels' wrappers make them: the same values); with
    ``shaping_coef > 0`` the potential before and after the tick;
    ``step_autoreset_batch`` (the in-step reset: an episode may end on any
    step); ``done`` the
    truncation flags over the agents; the shaped reward ``r + c (γ φ'
    (1 - done) - φ)`` (in the acting kernels' float32 order); with
    ``bootstrap_truncated`` V of ``ts.final_obs`` (with the pre-reset
    carry); the carry zeroed where ``done``. ``obs`` are ``state``'s
    observations. Returns ``(state, roll, last_obs, key, boot, carry)``:
    ``roll`` an ``ActRollout`` (``raw_reward`` the unshaped reward), ``boot
    [T, B, A]`` (zeros without the bootstrap), ``carry`` None for a
    feed-forward ``policy``. Each tick reads ``truncated.any()`` on the
    host once: the in-step reset's read, which also decides whether the
    draws are remade."""
    shaping = tcfg.shaping_coef > 0.0
    B, A = state.agent_pos.shape[:2]
    dev = state.agent_pos.device
    # The chunk's draws in bulk, the values of the per-step splits: the
    # gumbel noise of ``split(key)``'s chain, and the env draws of each
    # env's key chain, made anew from the state's keys after a tick where
    # some env reset (its key then starts a new chain).
    with annotate("draws", dev):
        key, gumbel = rng.batched_gumbel_stream(key, T, (5, B * A))
        draws, first = rng.chained_step_draws(state.key, cfg, T), 0
    steps = []
    with torch.no_grad():
        for t in range(T):
            with annotate("policy", dev):
                logits, value, new_carry = policy(obs, carry)
                if tcfg.mask_actions:
                    mask = valid_action_mask(cfg, state.agent_pos)
                    logits = torch.where(mask, logits, NEG_INF)
                else:
                    mask = torch.ones(logits.shape, dtype=torch.bool,
                                      device=logits.device)
                action, log_prob = sample_action_with_gumbel(logits,
                                                             gumbel[t])
            with annotate("tick", dev):
                if shaping:
                    phi = potential(cfg, state)
                state, ts, reset = step_autoreset_batch_any(
                    cfg, state, action,
                    rng.StepDraws(*(x[t - first] for x in draws)))
                done = ts.truncated[:, None].expand_as(ts.reward)
                reward = ts.reward
                if shaping:
                    term = f32(tcfg.gamma) * potential(cfg, state)
                    term = term * (1.0 - done.to(torch.float32))
                    term = term - phi
                    reward = reward + f32(tcfg.shaping_coef) * term
            if t + 1 < T and reset:
                with annotate("draws", dev):
                    draws, first = rng.chained_step_draws(
                        state.key, cfg, T - t - 1), t + 1
            if tcfg.bootstrap_truncated:
                with annotate("bootstrap", dev):
                    boot = policy(ts.final_obs, new_carry)[1]
            else:
                boot = torch.zeros_like(value)
            steps.append((obs, action, log_prob, value, reward,
                          ts.delivered.sum(-1, dtype=torch.int32),
                          ts.truncated, mask, ts.reward, boot))
            carry = (None if new_carry is None
                     else zero_where(done, new_carry))
            obs = ts.obs
    (obs_t, action, log_prob, value, reward, delivered, truncated, mask,
     raw, boot) = (torch.stack(x) for x in zip(*steps))
    roll = ActRollout(obs=obs_t, action=action, log_prob=log_prob,
                      value=value, reward=reward, delivered=delivered,
                      truncated=truncated, mask=mask, raw_reward=raw)
    return state, roll, obs, key, boot, carry


def ppo_plain_phase(tcfg: TrainConfig, optimizer: ClipAdam, params,
                    opt_state, key, traj, adv, targets, ent_coef, kl_coeff,
                    state_shuffled: bool, policy_groups=None,
                    precision: str = "float32", mesh=None):
    """The PPO SGD phase of the JAX XLA route (``train/ppo.py:481-602``)
    in plain PyTorch, on any device: the minibatches of ``minibatch_mode``
    (env-major env ranges, permuted per partition unless the state was
    shuffled before acting, or flat samples), a partition per update or per
    epoch (``epoch_shuffle``), ``micro_batches`` micro-gradients averaged
    before each step (advantages then normalized per minibatch, else in the
    loss), ``optimizer``'s step (flat or not), autograd through
    ``models.policy.apply`` at ``precision``, with ``mesh`` each step's
    gradient and losses averaged over its ranks. ``adv`` are GAE's raw
    advantages. Returns ``(params, opt_state, key, losses)``, ``key`` after
    the scaffold's splits."""
    T, B, A = traj.action.shape
    M, E, k = tcfg.num_minibatches, tcfg.ppo_epochs, tcfg.micro_batches
    fields = [traj.obs, traj.action, traj.log_prob, traj.value, adv, targets,
              traj.mask]
    if policy_groups is not None:  # each sample's group travels with it
        fields.append(torch.tensor(policy_groups, device=adv.device)
                      .expand(T, B, A))
    if tcfg.minibatch_mode == "env":
        batch = [x.movedim(1, 0).reshape(B, T * A, *x.shape[3:])
                 for x in fields]

        def make(pkey):
            return env_major_minibatches(None if state_shuffled else pkey,
                                         batch, M)
    else:
        batch = [x.reshape(T * B * A, *x.shape[3:]) for x in fields]

        def make(pkey):
            return flat_minibatches(pkey, batch, M)

    def partition(pkey):
        mbs = make(pkey)
        if k == 1:
            return mbs
        # Micro-gradients average to the minibatch's only with advantages
        # normalized over the whole minibatch first.
        return [(*mb[:4], (mb[4] - mb[4].mean())
                 / (mb[4].std(correction=0) + 1e-8), *mb[5:]) for mb in mbs]

    def loss_fn(p, mb):
        obs, action, old_lp, old_v, a, tgt, mask, *gids = mb
        logits, value = apply(p, obs, gids[0] if gids else None,
                              precision=precision)
        if tcfg.mask_actions:
            logits = torch.where(mask, logits, NEG_INF)
        return ppo_losses(logits, value, action, old_lp, old_v, a, tgt,
                          clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                          ent_coef=ent_coef, kl_coeff=kl_coeff,
                          normalize_adv=k == 1)

    each = tcfg.epoch_shuffle == "each"
    key, pkeys = partition_keys(key, E, each)
    minibatches = ((lambda e: partition(pkeys[e])) if each
                   else partition(pkeys[0]))
    rows = optimizer.step_rows(opt_state.count, E * M, adv.device)
    params, opt_state, losses = minibatch_epochs(
        params, opt_state, loss_fn=loss_fn, minibatches=minibatches,
        num_epochs=E, update_fn=optimizer.update_fn(rows, opt_state.count),
        micro_batches=k, mesh=mesh)
    return params, opt_state, key, losses


def check_kernel_fits(cfg: EnvConfig, model, device, arch: str,
                      policy_groups, act_kernel: bool,
                      grad_kernel: bool) -> None:
    """On the card, refuse by name what the kernels of an MLP or CNN
    policy cannot hold, whichever route a phase takes: more agents than an
    env stage takes (``build.check_pair``, T-7), so that no such shape runs
    plain unseen; then what each phase's kernel, where it runs, cannot hold
    (K10's and the learners' shared memory, K3 / K4's group map; K2 has no
    such limit). Any width and depth passes the shape checks. A CNN acting
    per step has its pair and grid checked alone. The attention torso has
    no kernel: nothing to refuse."""
    if arch == "cnn" and not act_kernel:
        check_cnn_widths(cfg, model, policy_groups)
    elif arch in ("mlp", "cnn"):
        check_act_fits(cfg, model, device, policy_groups)
    if grad_kernel:
        (check_cnn_learner_fits if arch == "cnn" else check_learner_fits)(
            model.state_dict(), cfg.obs_dim, device)
        if arch == "mlp":
            check_group_map(policy_groups)


def make_train(env_cfg: EnvConfig, tcfg: TrainConfig, arch: str = "mlp",
               device=None, mesh=None,
               policy_groups: tuple | None = None) -> PPOTrainer:
    """Build the trainer for ``tcfg`` on ``device``: the card by default,
    the CPU (plain twins) with ``device="cpu"``. ``policy_groups``: a tuple
    of one group id ``0..K-1`` per agent, K independent feed-forward
    policies. ``mesh``: a ``parallel.mesh.DataMesh``; ``num_envs`` is then
    the whole batch over its ranks."""
    _check_config(env_cfg, tcfg, arch, mesh)
    device = resolve_device(device)
    cfg = env_cfg.replace(auto_reset=False)
    B, T, M = local_envs(tcfg, mesh), tcfg.unroll_length, tcfg.num_minibatches
    n_steps = tcfg.ppo_epochs * M
    optimizer = make_optimizer(tcfg)
    if policy_groups is not None:
        policy_groups = tuple(int(g) for g in policy_groups)
    model = build_model(cfg, tcfg, arch, device, policy_groups)
    # Each phase's route, from the configuration alone (JAX's "auto").
    act_problems = rollout_problems(cfg, tcfg, arch)
    problems = grad_problems(cfg, tcfg, arch, policy_groups)
    grad_kernel = not problems
    backends = make_backends(device, act_problems, problems)
    stepwise = backends["rollout"] == STEP
    state_shuffle = (tcfg.minibatch_mode == "env"
                     and tcfg.epoch_shuffle == "once")
    if device.type == "cuda":
        check_kernel_fits(cfg, model, device, arch, policy_groups,
                          not stepwise, grad_kernel)
    sgd_fn, sgd_reference = (
        (ppo_cnn_sgd_phase, ppo_cnn_sgd_phase_reference) if arch == "cnn"
        else (ppo_sgd_phase, ppo_sgd_phase_reference))
    # Each sample's group by its agent (broadcast over [..., B, A]).
    gids = None if policy_groups is None else torch.tensor(policy_groups,
                                                           device=device)
    sgd_kw = {"matmul_dtype": tcfg.model_dtype, "mesh": mesh}
    if policy_groups is not None:
        sgd_kw["policy_groups"] = policy_groups
    # The bootstrap and last values' forward, and the per-step phase's:
    # the model's.
    precision = model_precision(tcfg.model_dtype)

    def init(key: torch.Tensor, whole: bool = True) -> RunnerState:
        params, env_state, obs, key = init_parts(
            cfg, tcfg, arch, device, key, policy_groups,
            *init_range(tcfg, mesh, whole))
        return RunnerState(
            params=params, opt_state=optimizer.init(params),
            env_state=env_state, obs=obs, key=key,
            update_idx=torch.zeros((), dtype=torch.int32, device=device),
            kl_coeff=torch.tensor(tcfg.kl_coeff, dtype=torch.float32,
                                  device=device))

    def chunk_acting(rollout_fn):
        """T steps through ``rollout_fn`` (the acting kernel or its twin),
        the boundary reset, the bootstrap on the chunk's last step."""
        def act(params, env_in, obs_in, key):
            with annotate("load_state_dict", device):
                model.load_state_dict(params)
            new_env, roll, reset_key, key = rollout_fn(
                cfg, model, env_in, T, key, mask_actions=tcfg.mask_actions,
                shaping_coef=tcfg.shaping_coef, gamma=tcfg.gamma, arch=arch,
                policy_groups=policy_groups)
            env_state, last_obs, _ = reset_truncated_batch(cfg, new_env,
                                                           reset_key)
            boot = torch.zeros_like(roll.value)
            if tcfg.bootstrap_truncated:
                # done is only ever set on the chunk's last step.
                with annotate("bootstrap", device):
                    boot[-1] = apply(params, observe_batch(cfg, new_env),
                                     gids, precision=precision)[1]
            return env_state, roll, last_obs, key, boot
        return act

    def step_acting(params, env_in, obs_in, key):
        """The per-step phase (``backends["rollout"] == "step"``)."""
        def policy(obs, carry):
            return (*apply(params, obs, gids, precision=precision), None)
        return step_rollout(cfg, tcfg, policy, env_in, obs_in, T, key)[:5]

    def step(rs: RunnerState, act_fn, sgd_fn, mark=None):
        mark = mark or (lambda name: None)
        key = rs.key
        env_in, obs_in = rs.env_state, rs.obs
        if state_shuffle:
            with annotate("permutation", device):
                perm = rng.permutation(rng.fold_in(key, PERM_SALT), B)
                env_in = EnvState(**{f: getattr(rs.env_state, f)[perm]
                                     for f in STATE_FIELDS})
                # The chunk rollout (kernel or twin) observes the state
                # itself.
                obs_in = rs.obs[perm] if stepwise else None
        env_state, roll, last_obs, key, boot = act_fn(rs.params, env_in,
                                                      obs_in, key)
        traj = Transition(roll.obs, roll.action, roll.log_prob, roll.value,
                          roll.reward,
                          roll.truncated[:, :, None].expand_as(roll.reward),
                          roll.mask, boot)
        mark("acting")

        with annotate("last_value", device):
            _, last_value = apply(rs.params, last_obs, gids,
                                  precision=precision)
        with annotate("gae", device):
            adv, targets = gae(traj.reward, traj.value, traj.done,
                               last_value, tcfg.gamma, tcfg.gae_lambda,
                               boot if tcfg.bootstrap_truncated else None)
            ent_coef = entropy_coef_at(tcfg, rs.update_idx)
            if sgd_fn is not None:
                adv_n = normalize_adv_env_minibatch(adv, M)
                rows = optimizer.step_rows(rs.opt_state.count, n_steps,
                                           device)
        mark("gae")
        with annotate("learner", device):
            if sgd_fn is None:  # the plain learner phase (M-4)
                params, opt_state, key, losses = ppo_plain_phase(
                    tcfg, optimizer, rs.params, rs.opt_state, key, traj, adv,
                    targets, ent_coef, rs.kl_coeff, state_shuffle,
                    policy_groups, precision, mesh)
            else:
                params, opt_state, losses = sgd_fn(
                    rs.params, rs.opt_state, traj, adv_n, targets, *rows,
                    ent_coef, rs.kl_coeff, num_epochs=tcfg.ppo_epochs,
                    num_minibatches=M, clip_eps=tcfg.clip_eps,
                    value_coef=tcfg.value_coef,
                    max_grad_norm=tcfg.max_grad_norm,
                    mask_actions=tcfg.mask_actions, **sgd_kw)
                # The key split the JAX scaffold spends on its partition.
                key, _ = partition_keys(key, tcfg.ppo_epochs, False)
        mark("sgd")

        with annotate("metrics", device):
            metrics, kl_coeff = update_metrics(tcfg, losses, rs.kl_coeff,
                                               roll, mesh)
        new = RunnerState(params=params, opt_state=opt_state,
                          env_state=env_state, obs=last_obs, key=key,
                          update_idx=rs.update_idx + 1, kl_coeff=kl_coeff)
        return new, metrics

    def train_step(rs: RunnerState, mark=None):
        """One update through each phase's route of ``backends`` (plain
        twins on the CPU). ``mark(name)``, if given, is called after the
        acting, GAE and SGD phases (for timing)."""
        return step(rs, step_acting if stepwise else chunk_acting(ppo_rollout),
                    sgd_fn if grad_kernel else None, mark)

    def plain_step(rs: RunnerState, mark=None):
        """The same update through the plain PyTorch twins."""
        return step(rs, step_acting if stepwise
                    else chunk_acting(ppo_rollout_reference),
                    sgd_reference if grad_kernel else None, mark)

    def train_many(rs: RunnerState, n: int):
        """n updates; metrics stacked ``[n]``."""
        return run_many(train_step, rs, n)

    return PPOTrainer(init=init, train_step=train_step,
                      train_many=train_many, plain_step=plain_step,
                      model=model, optimizer=optimizer, env_cfg=cfg,
                      tcfg=tcfg, device=device, policy_groups=policy_groups,
                      backends=backends, mesh=mesh,
                      init_global=lambda key: init(key, whole=mesh is None),
                      shard_runner_state=lambda rs: shard_runner_state(
                          rs, mesh))

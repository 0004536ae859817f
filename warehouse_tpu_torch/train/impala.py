"""The IMPALA (V-trace) actor-learner (counterpart of
``warehouse_tpu/train/impala.py``).

One update, draw for draw as the JAX trainer with, per phase, its kernel
(acting ``rollout_backend="pallas"``, :250-273) or its XLA route (acting
:274-312, learning :310-424):

1. act T steps from ``rs.key``, with no env permutation (IMPALA's
   minibatches are fixed env slices): through ``kernels.ppo_rollout``
   (K2), then the boundary reset ``reset_truncated_batch`` and, with
   ``bootstrap_truncated``, V of the pre-reset states (:256-272); or,
   where K2 does not take the configuration (``rollout_problems_impala``:
   an arch but the MLP, ``model_dtype="bfloat16"``, ``global_obs``,
   ``max_steps % unroll_length != 0``), through the per-step phase
   ``train.ppo.step_rollout`` (the JAX XLA scan, the model at its own
   dtype, no shaping);
2. the learner phase: ``impala_passes x num_minibatches`` steps of the
   V-trace loss, clip and RMSProp or Adam, with the per-step lr rows
   (:490-516), through ``kernels.impala_sgd_phase`` (K5) where the kernel
   takes the configuration (the MLP in float32; an episode may end inside
   the chunk); else (``micro_batches > 1``, env-axis micro-batches, exact
   for V-trace, :374-390; ``flat_optimizer``, ROADMAP M-4; the CNN, the
   attention torso, bfloat16) through the plain phase,
   ``impala_sgd_phase_reference`` with those options and the model at its
   precision;
3. the metrics of ``_metrics_tail`` (:429-454). The key the acting phase
   returns is the next update's; there is no trailing split.

``ImpalaTrainer.backends`` names each phase's route as the PPO trainer's
does (``train.ppo.make_backends``). Routes follow from the configuration
alone. On a CUDA device the kernels run and a build or launch failure
raises, and a cap that stays (the shared memory a width needs, T-7) is
refused by name whatever the route; on the CPU the kernels' phases are
plain. ``ImpalaTrainer.plain_step`` is the same update through
the plain twins on any device.

Ported: the MLP, CNN and attention policies (one shared policy), float32
or bfloat16, RMSProp or Adam (``impala_rmsprop``), lr anneal, passes,
truncation bootstrap, action masking, global observations, any
``unroll_length``, ``micro_batches``, ``flat_optimizer``; ``shaping_coef``
is accepted and has no effect, as in the JAX trainer, which never reads
it. The TPU block knobs have no counterpart and are ignored;
``rollout_backend``/``grad_backend="xla"`` raises.

With ``mesh`` (a ``parallel.mesh.DataMesh``) each rank owns ``num_envs /
world`` envs, as ``train.ppo.make_train`` shards them (``init_global``,
``shard_runner_state``); where the learner kernel takes the configuration,
each step is K6's gradient on this rank's minibatch, one ``all_reduce`` of
the gradient and its loss sums, then the clip + RMSProp or Adam kernel
(JAX's meshed route, :518-527); else the plain phase averages where the
JAX XLA learner ``pmean``s (:408-411). The reward and the deliveries are
averaged before the metrics (:435-437).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from ..config import EnvConfig, TrainConfig
from ..device import resolve_device

from ..env.batch import observe_batch, reset_truncated_batch
from ..env.state import STATE_FIELDS, EnvState
from ..kernels.act import ppo_rollout, ppo_rollout_reference
from ..kernels.vtrace_sgd import (check_impala_fits, impala_sgd_phase,
                                  impala_sgd_phase_reference)
from ..models.policy import (FEED_FORWARD, apply, make_model, model_precision,
                             params_from_flax)
from ..optim import (AdamState, ClipAdam, ClipRMSProp, RMSState,
                     make_impala_optimizer, opt_state_from_optax)
from ..utils.profiling import annotate
from .ppo import (STEP, _tensor, check_backend_names, check_kernel_fits,
                  init_parts, init_range, local_envs, make_backends,
                  run_many, shard_keys, shard_runner_state, step_rollout)


class ImpalaRunnerState(NamedTuple):
    params: dict               # the model's state_dict-keyed tensors
    opt_state: RMSState | AdamState
    env_state: EnvState        # [B] envs (a rank's: its B / world)
    obs: torch.Tensor          # float32[B, A, obs_dim]
    key: torch.Tensor          # int64[2] key words ([world, 2]: whole)
    update_idx: torch.Tensor   # int32[]


class ImpalaTransition(NamedTuple):
    obs: torch.Tensor                # float32[T, B, A, obs_dim]
    action: torch.Tensor             # int32[T, B, A]
    behavior_log_prob: torch.Tensor  # float32[T, B, A]
    reward: torch.Tensor
    done: torch.Tensor               # bool[T, B, A]
    mask: torch.Tensor               # bool[T, B, A, 5] (all True: off)
    boot_value: torch.Tensor         # V(pre-reset successor) (0 if off)


class ImpalaTrainer(NamedTuple):
    init: Callable        # key int64[2] -> ImpalaRunnerState
    train_step: Callable  # (rs, mark=None) -> (rs, metrics)
    train_many: Callable  # (rs, n) -> (rs, metrics stacked [n])
    plain_step: Callable  # train_step through the plain twins
    model: torch.nn.Module  # holds the params the act phase reads
    optimizer: ClipRMSProp | ClipAdam
    env_cfg: EnvConfig
    tcfg: TrainConfig
    device: torch.device
    backends: dict | None = None  # {"rollout", "grad"}: make_backends'
    mesh: Any = None  # the DataMesh, or None on one device
    init_global: Callable | None = None  # key -> this rank's state
    shard_runner_state: Callable | None = None  # whole state -> this rank's


def rollout_problems_impala(env_cfg: EnvConfig, tcfg: TrainConfig,
                            arch: str) -> list:
    """What the acting kernel K2 does not take for IMPALA (the JAX
    trainer's ``_rollout_problems``, :110-126, less the TPU's block
    lanes): where this is not empty the acting phase is the per-step
    one."""
    problems = []
    if arch != "mlp":
        problems.append(f"arch={arch!r} (the IMPALA acting route implements "
                        "MLP)")
    if tcfg.model_dtype != "float32":
        problems.append("model_dtype")
    if env_cfg.global_obs:
        problems.append("global_obs")
    if env_cfg.max_steps % tcfg.unroll_length:
        problems.append("max_steps % unroll_length != 0")
    return problems


def grad_problems_impala(tcfg: TrainConfig, arch: str) -> list:
    """The options that the IMPALA learner kernel does not compute (the
    JAX trainer's ``_grad_problems``, :128-153, less ``bootstrap_truncated``,
    which the port's kernel takes)."""
    problems = []
    if arch != "mlp":
        problems.append(f"arch={arch!r} (the learner kernel implements MLP)")
    if tcfg.model_dtype != "float32":
        problems.append("model_dtype")
    if tcfg.micro_batches != 1:
        problems.append("micro_batches != 1")
    if tcfg.flat_optimizer:
        problems.append("flat_optimizer")
    return problems


def _check_config(env_cfg: EnvConfig, tcfg: TrainConfig, arch, mesh) -> None:
    if arch not in FEED_FORWARD:
        raise ValueError(f"IMPALA with arch={arch!r}: it takes the "
                         f"feed-forward policies {FEED_FORWARD}")
    check_backend_names(tcfg)
    b = local_envs(tcfg, mesh)
    if b % tcfg.num_minibatches:
        raise ValueError(f"B_local={b} must divide into "
                         f"num_minibatches={tcfg.num_minibatches} (IMPALA "
                         "minibatches split the env axis, keeping T intact)")
    mb_envs = b // tcfg.num_minibatches
    if mb_envs % tcfg.micro_batches:
        raise ValueError(f"micro_batches={tcfg.micro_batches} must divide "
                         f"the per-minibatch env count {mb_envs}")


def impala_runner_state_from_jax(rs_np, tcfg: TrainConfig,
                                 device=None) -> ImpalaRunnerState:
    """A JAX ``ImpalaRunnerState`` of the single-device trainer, its leaves
    as numpy, as the port's: params through ``params_from_flax``, the
    optimizer through ``opt_state_from_optax`` (a constant-lr RMSProp
    keeps no count; it takes ``update_idx`` x steps per update, as the
    JAX fused path does), uint32 keys as int64."""
    update_idx = int(rs_np.update_idx)
    steps = tcfg.impala_passes * tcfg.num_minibatches
    params = {k: v.to(device)
              for k, v in params_from_flax(rs_np.params).items()}
    env = EnvState(**{f: _tensor(getattr(rs_np.env_state, f), device)
                      for f in STATE_FIELDS})
    return ImpalaRunnerState(
        params=params,
        opt_state=opt_state_from_optax(rs_np.opt_state, device,
                                       default_count=update_idx * steps,
                                       params_like=rs_np.params),
        env_state=env, obs=_tensor(rs_np.obs, device),
        key=shard_keys(_tensor(rs_np.key, device)),
        update_idx=_tensor(rs_np.update_idx, device).to(torch.int32))


def make_train_impala(env_cfg: EnvConfig, tcfg: TrainConfig,
                      arch: str = "mlp", device=None,
                      mesh=None) -> ImpalaTrainer:
    """Build the IMPALA trainer for ``tcfg`` on ``device``: the card by
    default, the CPU (plain twins) with ``device="cpu"``; ``mesh`` as
    ``train.ppo.make_train`` takes it."""
    _check_config(env_cfg, tcfg, arch, mesh)
    device = resolve_device(device)
    cfg = env_cfg.replace(auto_reset=False)
    B, T, M = local_envs(tcfg, mesh), tcfg.unroll_length, tcfg.num_minibatches
    n_steps = tcfg.impala_passes * M
    optimizer = make_impala_optimizer(tcfg)
    model = make_model(cfg, arch, tcfg.hidden_dim, tcfg.num_layers,
                       device=device, dtype=tcfg.model_dtype)
    problems = grad_problems_impala(tcfg, arch)
    grad_kernel = not problems
    backends = make_backends(device, rollout_problems_impala(cfg, tcfg, arch),
                             problems)
    stepwise = backends["rollout"] == STEP
    precision = model_precision(tcfg.model_dtype)
    if device.type == "cuda":  # refuse by name what no kernel route holds
        check_kernel_fits(cfg, model, device, arch, None, not stepwise,
                          False)
        if grad_kernel:
            check_impala_fits(model.state_dict(), cfg.obs_dim, device)

    def plain_phase(params, opt_state, traj, last_obs, rows, *args, **kw):
        """The plain learner phase (M-4, and the models and dtypes no
        kernel takes): micro-batches, the flat optimizer, the model's
        precision."""
        return impala_sgd_phase_reference(
            params, opt_state, traj, last_obs, rows, *args,
            micro_batches=tcfg.micro_batches,
            update_fn=optimizer.update_fn(rows, opt_state.count),
            precision=precision, **kw)

    def init(key: torch.Tensor, whole: bool = True) -> ImpalaRunnerState:
        params, env_state, obs, key = init_parts(
            cfg, tcfg, arch, device, key, None,
            *init_range(tcfg, mesh, whole))
        return ImpalaRunnerState(
            params=params, opt_state=optimizer.init(params),
            env_state=env_state, obs=obs, key=key,
            update_idx=torch.zeros((), dtype=torch.int32, device=device))

    def chunk_acting(rollout_fn):
        """T steps of K2 (or its twin) from ``rs.key``, the boundary reset,
        the bootstrap on the chunk's last step."""
        def act(rs):
            with annotate("load_state_dict", device):
                model.load_state_dict(rs.params)
            new_env, roll, reset_key, key = rollout_fn(
                cfg, model, rs.env_state, T, rs.key,
                mask_actions=tcfg.mask_actions)
            env_state, last_obs, _ = reset_truncated_batch(cfg, new_env,
                                                           reset_key)
            boot = torch.zeros_like(roll.reward)
            if tcfg.bootstrap_truncated:
                # done is only ever set on the chunk's last step.
                with annotate("bootstrap", device):
                    boot[-1] = apply(rs.params,
                                     observe_batch(cfg, new_env))[1]
            return env_state, roll, last_obs, key, boot
        return act

    def step_acting(rs):
        """The per-step phase (``backends["rollout"] == "step"``), with no
        env permutation and no shaping (the JAX trainer reads neither)."""
        def policy(obs, carry):
            return (*apply(rs.params, obs, precision=precision), None)
        return step_rollout(cfg, tcfg.replace(shaping_coef=0.0), policy,
                            rs.env_state, rs.obs, T, rs.key)[:5]

    def step(rs: ImpalaRunnerState, act_fn, learn_fn, mark=None):
        mark = mark or (lambda name: None)
        env_state, roll, last_obs, key, boot = act_fn(rs)
        traj = ImpalaTransition(
            roll.obs, roll.action, roll.log_prob, roll.reward,
            roll.truncated[:, :, None].expand_as(roll.reward), roll.mask,
            boot)
        mark("acting")

        with annotate("learner", device):
            rows = optimizer.step_rows(rs.opt_state.count, n_steps, device)
            params, opt_state, losses = learn_fn(
                rs.params, rs.opt_state, traj, last_obs, rows,
                tcfg.entropy_coef, num_passes=tcfg.impala_passes,
                num_minibatches=M, max_grad_norm=tcfg.max_grad_norm,
                gamma=tcfg.gamma, rho_clip=tcfg.rho_clip, c_clip=tcfg.c_clip,
                value_coef=tcfg.value_coef, mask_actions=tcfg.mask_actions,
                bootstrap_truncated=tcfg.bootstrap_truncated, mesh=mesh)
        mark("learner")

        with annotate("metrics", device):
            reward = roll.raw_reward.mean(dim=(1, 2)).mean()
            deliveries = roll.delivered.sum(dtype=torch.float32) / (T * B)
            if mesh is not None:
                reward, deliveries = mesh.mean([reward, deliveries])
            metrics = {
                "loss": losses[0].mean(),
                "pg_loss": losses[1].mean(),
                "v_loss": losses[2].mean(),
                "entropy": losses[3].mean(),
                "reward_per_step": reward,
                "deliveries_per_env_step": deliveries,
            }
        new = ImpalaRunnerState(params=params, opt_state=opt_state,
                                env_state=env_state, obs=last_obs, key=key,
                                update_idx=rs.update_idx + 1)
        return new, metrics

    def train_step(rs: ImpalaRunnerState, mark=None):
        """One update through each phase's route of ``backends`` (plain
        twins on the CPU). ``mark(name)``, if given, is called after the
        acting and learner phases (for timing)."""
        return step(rs, step_acting if stepwise else chunk_acting(ppo_rollout),
                    impala_sgd_phase if grad_kernel else plain_phase, mark)

    def plain_step(rs: ImpalaRunnerState, mark=None):
        """The same update through the plain PyTorch twins."""
        return step(rs, step_acting if stepwise
                    else chunk_acting(ppo_rollout_reference),
                    impala_sgd_phase_reference if grad_kernel
                    else plain_phase, mark)

    def train_many(rs: ImpalaRunnerState, n: int):
        """n updates; metrics stacked ``[n]``."""
        return run_many(train_step, rs, n)

    return ImpalaTrainer(init=init, train_step=train_step,
                         train_many=train_many, plain_step=plain_step,
                         model=model, optimizer=optimizer, env_cfg=cfg,
                         tcfg=tcfg, device=device, backends=backends,
                         mesh=mesh,
                         init_global=lambda key: init(key, whole=mesh is None),
                         shard_runner_state=lambda rs: shard_runner_state(
                             rs, mesh))

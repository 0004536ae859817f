"""The recurrent (GRU / LSTM) PPO actor-learner (counterpart of
``warehouse_tpu/train/ppo_rnn.py``).

One update, draw for draw as the JAX trainer with, per phase, its kernel
(acting ``rollout_backend="pallas"``, :242-286; learning :337-362) or its
XLA route (acting :288-332; learning :364-440):

1. with ``epoch_shuffle="once"``, permute the env axis of the state, its
   observations AND the carry with ``permutation(fold_in(key, 0x5EED),
   B)`` (:248-254); the (permuted) carry ``h0`` is what the rollout and
   the replay both start from;
2. act T steps: through ``kernels.ppo_rnn_rollout`` (K7), then the
   boundary reset of the env (``reset_truncated_batch``) and of the carry,
   zeroed where the chunk truncated (:270-275); or, where K7 does not take
   the configuration (``rollout_problems_rnn``: ``global_obs``,
   ``shaping_coef``, ``bootstrap_truncated``, ``max_steps %
   unroll_length != 0``), through the per-step phase
   ``train.ppo.step_rollout`` (the JAX XLA scan): the model at its own
   dtype on the runner state's carry, the potential shaping, the in-step
   reset, V of ``final_obs`` with the pre-reset carry, the carry zeroed
   where ``done``;
3. the last value from ``(last_obs, last_h)``, GAE (with the bootstrap
   values where ``bootstrap_truncated``);
4. the sequence-replay SGD phase: where the learner kernel takes the
   configuration, advantages normalized per env minibatch and
   ``kernels.ppo_rnn_sgd_phase`` (K8) from ``h0``, with the per-step lr
   and bias-correction rows; else (``epoch_shuffle="each"``,
   ``flat_optimizer``, and an episode that can end inside a chunk, which
   K8's replay has no carry reset for) the plain phase of the JAX XLA
   route: env-axis sequence minibatches, permuted per epoch with "each",
   replayed from their slice of ``h0`` through ``models.policy.apply_rnn``
   at the model's precision with the carry zeroed after each ``done``,
   advantages normalized in the loss, ``optim.py``'s step (flat or not);
5. the scaffold's key splits, the metrics and the adaptive KL coefficient
   (:441-470).

``PPORNNTrainer.backends`` names each phase's route as the PPO trainer's
does (``train.ppo.make_backends``: ``"step"`` for the per-step acting).
Routes follow from the configuration alone. On a CUDA device the kernels
run and a build or launch failure raises, and K8's shared memory or more
agents than an env stage takes (T-7) is refused by name whatever the
route (any hidden and encoder width and depth passes); on the CPU the
kernels' phases are plain. ``plain_step`` is the
same update through the plain twins on any device.

Ported: one shared policy, ``epoch_shuffle`` "once" and "each",
``flat_optimizer``, entropy anneal, adaptive KL, lr anneal, action
masking, global observations, potential shaping, the truncation
bootstrap, any ``unroll_length``, ``model_dtype`` float32 or bfloat16;
``micro_batches`` is accepted and has no effect, as in the JAX trainer,
which never reads it. With bfloat16 (:66-70, :106-110, :271-274,
:504-508) the model is built at that compute dtype and the runner state's
carry is bf16: K7's carry is rounded back to bf16 after the boundary reset
of every chunk, K7 and the learner kernels read it cast up to float32,
the per-step phase and the last value (and the plain phase's replay) run
the flax-bf16 forward on it, and the learner kernels K8/K9 take
``matmul_dtype="bfloat16"``; acting in K7 stays float32.

With ``mesh`` (a ``parallel.mesh.DataMesh``) each rank owns ``num_envs /
world`` envs and their carry, as ``train.ppo.make_train`` shards them
(``init_global``, ``shard_runner_state``; JAX :563-608); where the learner
kernel takes the configuration, each step is K9's gradient on this rank's
minibatch, one ``all_reduce`` of the gradient and its loss sums, then the
clip + Adam kernel (JAX's meshed route, :543-552); else the plain replay
phase averages where the JAX scaffold ``pmean``s (:433). The KL mean, the
reward and the deliveries are averaged before the metrics (:444-454).
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import rng
from ..config import EnvConfig, TrainConfig
from ..device import resolve_device
from ..env.batch import reset_truncated_batch
from ..env.state import STATE_FIELDS, EnvState
from ..kernels.act_rnn import (check_act_rnn_fits, ppo_rnn_rollout,
                               ppo_rnn_rollout_reference)
from ..kernels.sgd import normalize_adv_env_minibatch
from ..kernels.sgd_rnn import (check_rnn_learner_fits, ppo_rnn_sgd_phase,
                               ppo_rnn_sgd_phase_reference, replay_loss_fn,
                               zero_where)
from ..models.policy import (apply_rnn, initial_carry, make_model,
                             model_precision, params_from_flax, torch_dtype)
from ..ops.gae import gae
from ..ops.ppo_update import entropy_coef_at, minibatch_epochs, partition_keys
from ..optim import AdamState, ClipAdam, make_optimizer, opt_state_from_optax
from .ppo import (PERM_SALT, STEP, Transition, _tensor, check_backend_names,
                  init_parts, init_range, local_envs, make_backends, run_many,
                  shard_keys, shard_runner_state, step_rollout,
                  update_metrics)


class RunnerStateRNN(NamedTuple):
    params: dict             # ActorCriticRNN.state_dict-keyed tensors
    opt_state: AdamState
    env_state: EnvState      # [B] envs (a rank's: its B / world)
    obs: torch.Tensor        # float32[B, A, obs_dim]
    carry: Any               # [B, A, H] at the model's dtype, or (c, h)
    key: torch.Tensor        # int64[2] threefry key words ([world, 2]: whole)
    update_idx: torch.Tensor  # int32[]
    kl_coeff: torch.Tensor   # float32[] adaptive KL penalty


class PPORNNTrainer(NamedTuple):
    init: Callable        # key int64[2] -> RunnerStateRNN
    train_step: Callable  # (rs, mark=None) -> (rs, metrics)
    train_many: Callable  # (rs, n) -> (rs, metrics stacked [n])
    plain_step: Callable  # train_step through the plain twins
    model: torch.nn.Module  # an ActorCriticRNN of the run's widths
    optimizer: ClipAdam
    env_cfg: EnvConfig
    tcfg: TrainConfig
    arch: str
    device: torch.device
    backends: dict | None = None  # {"rollout", "grad"}: make_backends'
    mesh: Any = None  # the DataMesh, or None on one device
    init_global: Callable | None = None  # key -> this rank's RunnerStateRNN
    shard_runner_state: Callable | None = None  # whole state -> this rank's


def rollout_problems_rnn(env_cfg: EnvConfig, tcfg: TrainConfig) -> list:
    """What the recurrent acting kernel K7 does not take (the JAX
    trainer's ``_rollout_problems``, :101-125, less the TPU's block
    lanes): where this is not empty the acting phase is the per-step
    one."""
    problems = []
    if env_cfg.global_obs:
        problems.append("global_obs")
    if tcfg.shaping_coef != 0.0:
        problems.append("shaping_coef")
    if tcfg.bootstrap_truncated:
        problems.append("bootstrap_truncated")
    if env_cfg.max_steps % tcfg.unroll_length:
        problems.append("max_steps % unroll_length != 0")
    return problems


def grad_problems_rnn(env_cfg: EnvConfig, tcfg: TrainConfig) -> list:
    """The options that the recurrent learner kernel does not compute (the
    JAX trainer's ``_grad_problems``, :127-150): K8 replays a chunk with no
    carry reset inside it, so an episode that ends before the chunk's last
    step sends the learner to the plain replay, which resets it."""
    problems = []
    if tcfg.epoch_shuffle != "once":
        problems.append("epoch_shuffle != 'once'")
    if tcfg.flat_optimizer:
        problems.append("flat_optimizer")
    if env_cfg.max_steps % tcfg.unroll_length:
        problems.append("max_steps % unroll_length != 0")
    return problems


def _check_config(env_cfg: EnvConfig, tcfg: TrainConfig, arch, mesh) -> None:
    if arch not in ("gru", "lstm"):
        raise ValueError(f"make_train_rnn: arch={arch!r}; the recurrent "
                         "trainer takes 'gru' or 'lstm'")
    check_backend_names(tcfg)
    b = local_envs(tcfg, mesh)
    if b % tcfg.num_minibatches:
        raise ValueError(
            f"recurrent PPO minibatches slice the env axis: B_local={b} "
            f"must divide into {tcfg.num_minibatches} minibatches")


def _carry_map(fn, carry):
    return tuple(fn(x) for x in carry) if isinstance(carry, tuple) else fn(
        carry)


def runner_state_rnn_from_jax(rs_np, device=None) -> RunnerStateRNN:
    """A JAX ``RunnerStateRNN`` of the single-device trainer, its leaves as
    numpy, as the port's: params through ``params_from_flax``, the
    optimizer through ``opt_state_from_optax``, the carry leaf for leaf
    (the LSTM's ``(c, h)`` tuple kept), uint32 keys as int64 (the shard key
    ``[1, 2]`` as ``[2]``, a meshed state's ``[world, 2]`` kept), on
    ``device`` (like ``runner_state_from_jax``,
    where the numpy leaves are when ``None``)."""
    params = {k: v.to(device)
              for k, v in params_from_flax(rs_np.params).items()}
    env = EnvState(**{f: _tensor(getattr(rs_np.env_state, f), device)
                      for f in STATE_FIELDS})
    carry = rs_np.carry
    carry = (tuple(_tensor(x, device) for x in carry)
             if isinstance(carry, (tuple, list)) else _tensor(carry, device))
    return RunnerStateRNN(
        params=params,
        opt_state=opt_state_from_optax(rs_np.opt_state, device,
                                       params_like=rs_np.params),
        env_state=env,
        obs=_tensor(rs_np.obs, device),
        carry=carry,
        key=shard_keys(_tensor(rs_np.key, device)),
        update_idx=_tensor(rs_np.update_idx, device).to(torch.int32),
        kl_coeff=_tensor(rs_np.kl_coeff, device).to(torch.float32))


def rnn_plain_phase(tcfg: TrainConfig, optimizer: ClipAdam, params,
                    opt_state, key, traj, adv, targets, h0, ent_coef,
                    kl_coeff, state_shuffled: bool, precision: str,
                    mesh=None):
    """The recurrent SGD phase of the JAX XLA route
    (``train/ppo_rnn.py:364-440``) in plain PyTorch: minibatches of B/M
    envs' whole sequences with their slice of the rollout-start carry
    ``h0``, contiguous when the state was shuffled before acting, else
    permuted by ``permutation(pkey, B)`` per partition (one partition per
    update or per epoch, ``epoch_shuffle``); the T-step replay through
    ``apply_rnn`` at ``precision``, the carry zeroed after each step where
    ``traj.done`` (an episode that ended inside the chunk), the PPO loss
    with advantages normalized over the minibatch, ``optimizer``'s step
    (with ``mesh``, after the gradient and losses are averaged over its
    ranks). ``adv`` are GAE's raw advantages. Returns ``(params, opt_state,
    key, losses)``."""
    B, M, E = traj.obs.shape[1], tcfg.num_minibatches, tcfg.ppo_epochs
    w = B // M
    fields = (traj.obs, traj.action, traj.log_prob, traj.value, adv,
              targets, traj.mask, traj.done)

    def partition(pkey):
        perm = None if state_shuffled else rng.permutation(pkey, B)
        out = []
        for m in range(M):
            idx = (slice(m * w, (m + 1) * w) if perm is None
                   else perm[m * w:(m + 1) * w])
            out.append((tuple(x[:, idx] for x in fields),
                        _carry_map(lambda x: x[idx], h0)))
        return out

    each = tcfg.epoch_shuffle == "each"
    key, pkeys = partition_keys(key, E, each)
    rows = optimizer.step_rows(opt_state.count, E * M, adv.device)
    params, opt_state, losses = minibatch_epochs(
        params, opt_state,
        loss_fn=replay_loss_fn(tcfg.clip_eps, tcfg.value_coef, ent_coef,
                               kl_coeff, tcfg.mask_actions, precision,
                               normalize_adv=True),
        minibatches=((lambda e: partition(pkeys[e])) if each
                     else partition(pkeys[0])),
        num_epochs=E, update_fn=optimizer.update_fn(rows, opt_state.count),
        mesh=mesh)
    return params, opt_state, key, losses


def make_train_rnn(env_cfg: EnvConfig, tcfg: TrainConfig, arch: str = "gru",
                   device=None, mesh=None) -> PPORNNTrainer:
    """Build the recurrent trainer for ``tcfg`` on ``device``: the card by
    default, the CPU (plain twins) with ``device="cpu"``; ``mesh`` as
    ``train.ppo.make_train`` takes it."""
    _check_config(env_cfg, tcfg, arch, mesh)
    device = resolve_device(device)
    cfg = env_cfg.replace(auto_reset=False)
    B, T, M = local_envs(tcfg, mesh), tcfg.unroll_length, tcfg.num_minibatches
    A, H = cfg.num_agents, tcfg.hidden_dim
    n_steps = tcfg.ppo_epochs * M
    optimizer = make_optimizer(tcfg)
    dtype = tcfg.model_dtype
    model = make_model(cfg, arch, tcfg.hidden_dim, tcfg.num_layers,
                       device=device, dtype=dtype)
    problems = grad_problems_rnn(cfg, tcfg)
    grad_kernel = not problems
    backends = make_backends(device, rollout_problems_rnn(cfg, tcfg),
                             problems)
    stepwise = backends["rollout"] == STEP
    state_shuffle = tcfg.epoch_shuffle == "once"
    precision = model_precision(dtype)
    if device.type == "cuda":  # the kernels' (agents, queue) shapes, widths
        check_act_rnn_fits(cfg, model.state_dict())
        if grad_kernel:
            check_rnn_learner_fits(model.state_dict(), cfg.obs_dim, device)

    def init(key: torch.Tensor, whole: bool = True) -> RunnerStateRNN:
        params, env_state, obs, key = init_parts(
            cfg, tcfg, arch, device, key, None,
            *init_range(tcfg, mesh, whole))
        return RunnerStateRNN(
            params=params, opt_state=optimizer.init(params),
            env_state=env_state, obs=obs,
            carry=initial_carry(arch, (obs.shape[0], A), H, device, dtype),
            key=key,
            update_idx=torch.zeros((), dtype=torch.int32, device=device),
            kl_coeff=torch.tensor(tcfg.kl_coeff, dtype=torch.float32,
                                  device=device))

    def chunk_acting(rollout_fn):
        """T steps of K7 (or its twin) from the carry cast to float32, the
        boundary reset of the env and of the carry (zeroed where the chunk
        truncated, back in the runner state's dtype)."""
        def act(params, env_in, obs_in, h0, key):
            new_env, roll, reset_key, key, new_carry = rollout_fn(
                cfg, params, env_in, _carry_map(lambda x: x.float(), h0), T,
                key, mask_actions=tcfg.mask_actions)
            env_state, last_obs, done_b = reset_truncated_batch(
                cfg, new_env, reset_key)
            last_h = _carry_map(lambda x: x.to(torch_dtype(dtype)),
                                zero_where(done_b[:, None], new_carry))
            return (env_state, roll, last_obs, key,
                    torch.zeros_like(roll.value), last_h)
        return act

    def step_acting(params, env_in, obs_in, h0, key):
        """The per-step phase (``backends["rollout"] == "step"``): the
        model at its own dtype, the carry in the runner state's."""
        def policy(obs, carry):
            return apply_rnn(params, obs, carry, precision=precision)
        return step_rollout(cfg, tcfg, policy, env_in, obs_in, T, key, h0)

    def step(rs: RunnerStateRNN, act_fn, sgd_fn, mark=None):
        mark = mark or (lambda name: None)
        key = rs.key
        env_in, obs_in, h0 = rs.env_state, rs.obs, rs.carry
        if state_shuffle:
            perm = rng.permutation(rng.fold_in(key, PERM_SALT), B)
            env_in = EnvState(**{f: getattr(rs.env_state, f)[perm]
                                 for f in STATE_FIELDS})
            # The chunk rollout (kernel or twin) observes the state itself.
            obs_in = rs.obs[perm] if stepwise else None
            h0 = _carry_map(lambda x: x[perm], rs.carry)
        env_state, roll, last_obs, key, boot, last_h = act_fn(
            rs.params, env_in, obs_in, h0, key)
        traj = Transition(roll.obs, roll.action, roll.log_prob, roll.value,
                          roll.reward,
                          roll.truncated[:, :, None].expand_as(roll.reward),
                          roll.mask, boot)
        mark("acting")

        with torch.no_grad():
            _, last_value, _ = apply_rnn(rs.params, last_obs, last_h,
                                         precision=precision)
        adv, targets = gae(traj.reward, traj.value, traj.done, last_value,
                           tcfg.gamma, tcfg.gae_lambda,
                           boot if tcfg.bootstrap_truncated else None)
        ent_coef = entropy_coef_at(tcfg, rs.update_idx)
        if sgd_fn is None:  # the plain learner phase
            mark("gae")
            params, opt_state, key, losses = rnn_plain_phase(
                tcfg, optimizer, rs.params, rs.opt_state, key, traj, adv,
                targets, h0, ent_coef, rs.kl_coeff, state_shuffle, precision,
                mesh)
        else:
            adv_n = normalize_adv_env_minibatch(adv, M)
            rows = optimizer.step_rows(rs.opt_state.count, n_steps, device)
            mark("gae")
            # K8 and its twin read the carry in float32 (a bf16 one cast up).
            params, opt_state, losses = sgd_fn(
                rs.params, rs.opt_state, traj, adv_n, targets,
                _carry_map(lambda x: x.float(), h0), *rows,
                ent_coef, rs.kl_coeff, num_epochs=tcfg.ppo_epochs,
                num_minibatches=M, clip_eps=tcfg.clip_eps,
                value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
                mask_actions=tcfg.mask_actions, matmul_dtype=dtype, mesh=mesh)
            # The key split the JAX scaffold spends on its partition.
            key, _ = partition_keys(key, tcfg.ppo_epochs, False)
        mark("sgd")

        metrics, kl_coeff = update_metrics(tcfg, losses, rs.kl_coeff, roll,
                                           mesh)
        new = RunnerStateRNN(params=params, opt_state=opt_state,
                             env_state=env_state, obs=last_obs, carry=last_h,
                             key=key, update_idx=rs.update_idx + 1,
                             kl_coeff=kl_coeff)
        return new, metrics

    def train_step(rs: RunnerStateRNN, mark=None):
        """One update through each phase's route of ``backends`` (plain
        twins on the CPU). ``mark(name)``, if given, is called after the
        acting, GAE and SGD phases (for timing)."""
        return step(rs, step_acting if stepwise
                    else chunk_acting(ppo_rnn_rollout),
                    ppo_rnn_sgd_phase if grad_kernel else None, mark)

    def plain_step(rs: RunnerStateRNN, mark=None):
        """The same update through the plain PyTorch twins."""
        return step(rs, step_acting if stepwise
                    else chunk_acting(ppo_rnn_rollout_reference),
                    ppo_rnn_sgd_phase_reference if grad_kernel else None,
                    mark)

    def train_many(rs: RunnerStateRNN, n: int):
        """n updates; metrics stacked ``[n]``."""
        return run_many(train_step, rs, n)

    return PPORNNTrainer(init=init, train_step=train_step,
                         train_many=train_many, plain_step=plain_step,
                         model=model, optimizer=optimizer, env_cfg=cfg,
                         tcfg=tcfg, arch=arch, device=device,
                         backends=backends, mesh=mesh,
                         init_global=lambda key: init(key, whole=mesh is None),
                         shard_runner_state=lambda rs: shard_runner_state(
                             rs, mesh))

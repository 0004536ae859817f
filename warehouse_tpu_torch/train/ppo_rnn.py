"""The recurrent (GRU / LSTM) PPO actor-learner on one device (counterpart
of ``warehouse_tpu/train/ppo_rnn.py``, single-device fused path).

One update, draw for draw as the JAX trainer's fused path
(``rollout_backend``/``grad_backend="pallas"``, :242-286, :337-362):

1. permute the env axis of the state AND of the carry with
   ``permutation(fold_in(key, 0x5EED), B)`` (:248-254); the permuted carry
   ``h0`` is what the rollout and the replay both start from;
2. act T steps through ``kernels.ppo_rnn_rollout`` (K7), then the boundary
   reset of the env (``reset_truncated_batch``) and of the carry, zeroed
   where the chunk truncated (:270-275);
3. the last value from ``(last_obs, last_h)``, GAE, advantages normalized
   per env minibatch;
4. the sequence-replay SGD phase through ``kernels.ppo_rnn_sgd_phase``
   (K8) from ``h0``, with the per-step lr and bias-correction rows;
5. the mirrored ``key, _ = split(key)`` (:359), the metrics and the
   adaptive KL coefficient (:441-470).

The replay has no carry reset inside a chunk, so an episode may only end
on a chunk's last step: ``max_steps % unroll_length != 0`` is a
``ValueError`` (:117, :138). On a CUDA device the kernels run and a build
or launch failure raises; on the CPU their plain twins run.
``plain_step`` is the same update through the plain twins on any device.

The envelope of the JAX kernels path is the port's only path. Ported:
one shared policy, ``epoch_shuffle="once"``, entropy anneal, adaptive KL,
lr anneal, action masking, ``model_dtype`` float32 or bfloat16. With
bfloat16 (:66-70, :106-110, :271-274, :504-508) the model is built at that
compute dtype and the runner state's carry is bf16: the rollout's carry is
rounded back to bf16 after the boundary reset of every chunk, K7 and the
learner read it cast up to float32, the last value is the flax-bf16
forward from it, and the learner kernels K8/K9 take
``matmul_dtype="bfloat16"``; acting in K7 stays float32.
``NotImplementedError``, naming the ROADMAP id: ``global_obs``,
``shaping_coef``, ``bootstrap_truncated``, ``epoch_shuffle="each"``,
``flat_optimizer``, ``micro_batches > 1``, a mesh.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from .. import rng
from ..config import EnvConfig, TrainConfig
from ..device import resolve_device
from ..env.batch import reset_truncated_batch
from ..env.state import STATE_FIELDS, EnvState
from ..kernels.act_rnn import ppo_rnn_rollout, ppo_rnn_rollout_reference
from ..kernels.rollout import check_kernel_shape
from ..kernels.sgd import normalize_adv_env_minibatch
from ..kernels.sgd_rnn import ppo_rnn_sgd_phase, ppo_rnn_sgd_phase_reference
from ..models.policy import (apply_rnn, initial_carry, make_model,
                             model_precision, params_from_flax, torch_dtype)
from ..ops.gae import gae
from ..ops.ppo_update import entropy_coef_at
from ..optim import AdamState, ClipAdam, make_optimizer, opt_state_from_optax
from .ppo import (PERM_SALT, Transition, _not_ported, _tensor, init_parts,
                  run_many, update_metrics)


class RunnerStateRNN(NamedTuple):
    params: dict             # ActorCriticRNN.state_dict-keyed tensors
    opt_state: AdamState
    env_state: EnvState      # [B] envs
    obs: torch.Tensor        # float32[B, A, obs_dim]
    carry: Any               # [B, A, H] at the model's dtype, or (c, h)
    key: torch.Tensor        # int64[2] threefry key words
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


def _check_config(env_cfg: EnvConfig, tcfg: TrainConfig, arch, mesh) -> None:
    if arch not in ("gru", "lstm"):
        raise ValueError(f"make_train_rnn: arch={arch!r}; the recurrent "
                         "trainer takes 'gru' or 'lstm'")
    for what, off, item in (
            ("a mesh", mesh is None, "M-8"),
            ("shaping_coef > 0", tcfg.shaping_coef == 0.0, "M-4"),
            ("global_obs", not env_cfg.global_obs, "M-4"),
            ("bootstrap_truncated", not tcfg.bootstrap_truncated, "M-4"),
            ("epoch_shuffle='each'", tcfg.epoch_shuffle == "once", "M-4"),
            ("micro_batches > 1", tcfg.micro_batches == 1, "M-4"),
            ("flat_optimizer", not tcfg.flat_optimizer, "M-4")):
        if not off:
            _not_ported(f"recurrent PPO with {what}", item)
    for name in ("rollout_backend", "grad_backend"):
        if getattr(tcfg, name) == "xla":
            raise ValueError(f"{name}='xla': the port has no backend switch;"
                             " the device picks kernel (CUDA) or plain twin"
                             " (CPU)")
    if tcfg.num_envs % tcfg.num_minibatches:
        raise ValueError(
            "recurrent PPO minibatches slice the env axis: num_envs="
            f"{tcfg.num_envs} must divide into {tcfg.num_minibatches} "
            "minibatches")
    if env_cfg.max_steps % tcfg.unroll_length:
        raise ValueError(
            "max_steps % unroll_length != 0: the sequence replay has no "
            "carry reset inside a chunk, so an episode may only end on a "
            "chunk's last step")


def _carry_map(fn, carry):
    return tuple(fn(x) for x in carry) if isinstance(carry, tuple) else fn(
        carry)


def runner_state_rnn_from_jax(rs_np, device=None) -> RunnerStateRNN:
    """A JAX ``RunnerStateRNN`` of the single-device trainer, its leaves as
    numpy, as the port's: params through ``params_from_flax``, the
    optimizer through ``opt_state_from_optax``, the carry leaf for leaf
    (the LSTM's ``(c, h)`` tuple kept), uint32 keys as int64 (the shard key
    ``[1, 2]`` as ``[2]``), on ``device`` (like ``runner_state_from_jax``,
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
        opt_state=opt_state_from_optax(rs_np.opt_state, device),
        env_state=env,
        obs=_tensor(rs_np.obs, device),
        carry=carry,
        key=_tensor(rs_np.key, device).reshape(2),
        update_idx=_tensor(rs_np.update_idx, device).to(torch.int32),
        kl_coeff=_tensor(rs_np.kl_coeff, device).to(torch.float32))


def make_train_rnn(env_cfg: EnvConfig, tcfg: TrainConfig, arch: str = "gru",
                   device=None, mesh=None) -> PPORNNTrainer:
    """Build the recurrent trainer for ``tcfg`` on ``device``: the card by
    default, the CPU (plain twins) with ``device="cpu"``."""
    _check_config(env_cfg, tcfg, arch, mesh)
    device = resolve_device(device)
    cfg = env_cfg.replace(auto_reset=False)
    B, T, M = tcfg.num_envs, tcfg.unroll_length, tcfg.num_minibatches
    A, H = cfg.num_agents, tcfg.hidden_dim
    n_steps = tcfg.ppo_epochs * M
    optimizer = make_optimizer(tcfg)
    dtype = tcfg.model_dtype
    model = make_model(cfg, arch, tcfg.hidden_dim, tcfg.num_layers,
                       device=device, dtype=dtype)
    if device.type == "cuda":  # the env kernels' (agents, queue) shapes
        check_kernel_shape(cfg)

    def init(key: torch.Tensor) -> RunnerStateRNN:
        params, env_state, obs, key = init_parts(cfg, tcfg, arch, device, key)
        return RunnerStateRNN(
            params=params, opt_state=optimizer.init(params),
            env_state=env_state, obs=obs,
            carry=initial_carry(arch, (B, A), H, device, dtype), key=key,
            update_idx=torch.zeros((), dtype=torch.int32, device=device),
            kl_coeff=torch.tensor(tcfg.kl_coeff, dtype=torch.float32,
                                  device=device))

    def step(rs: RunnerStateRNN, act_fn, sgd_fn, mark=None):
        mark = mark or (lambda name: None)
        key = rs.key
        perm = rng.permutation(rng.fold_in(key, PERM_SALT), B)
        env_in = EnvState(**{f: getattr(rs.env_state, f)[perm]
                             for f in STATE_FIELDS})
        h0 = _carry_map(lambda x: x[perm], rs.carry)
        # K7 and the learner read the carry in float32 (a bf16 one cast up).
        h0_f32 = _carry_map(lambda x: x.float(), h0)
        new_env, roll, reset_key, key, new_carry = act_fn(
            cfg, rs.params, env_in, h0_f32, T, key,
            mask_actions=tcfg.mask_actions)
        env_state, last_obs, done_b = reset_truncated_batch(cfg, new_env,
                                                            reset_key)
        # The carry restarts with the episode, and goes back to the runner
        # state's dtype (rounded to bf16 at bfloat16).
        last_h = _carry_map(
            lambda x: torch.where(done_b[:, None, None],
                                  torch.zeros((), dtype=x.dtype,
                                              device=x.device), x).to(
                                      torch_dtype(dtype)),
            new_carry)
        traj = Transition(roll.obs, roll.action, roll.log_prob, roll.value,
                          roll.reward,
                          roll.truncated[:, :, None].expand_as(roll.reward),
                          roll.mask, torch.zeros_like(roll.value))
        mark("acting")

        with torch.no_grad():
            _, last_value, _ = apply_rnn(rs.params, last_obs, last_h,
                                         precision=model_precision(dtype))
        adv, targets = gae(traj.reward, traj.value, traj.done, last_value,
                           tcfg.gamma, tcfg.gae_lambda, None)
        adv_n = normalize_adv_env_minibatch(adv, M)
        ent_coef = entropy_coef_at(tcfg, rs.update_idx)
        rows = optimizer.step_rows(rs.opt_state.count, n_steps, device)
        mark("gae")

        params, opt_state, losses = sgd_fn(
            rs.params, rs.opt_state, traj, adv_n, targets, h0_f32, *rows,
            ent_coef, rs.kl_coeff, num_epochs=tcfg.ppo_epochs,
            num_minibatches=M, clip_eps=tcfg.clip_eps,
            value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
            mask_actions=tcfg.mask_actions, matmul_dtype=dtype)
        mark("sgd")

        # The key split the JAX XLA scaffold spends on its partition.
        key = rng.split(key, 2)[0]
        metrics, kl_coeff = update_metrics(tcfg, losses, rs.kl_coeff, roll)
        new = RunnerStateRNN(params=params, opt_state=opt_state,
                             env_state=env_state, obs=last_obs, carry=last_h,
                             key=key, update_idx=rs.update_idx + 1,
                             kl_coeff=kl_coeff)
        return new, metrics

    def train_step(rs: RunnerStateRNN, mark=None):
        """One update through the kernels (plain twins on the CPU).
        ``mark(name)``, if given, is called after the acting, GAE and SGD
        phases (for timing)."""
        return step(rs, ppo_rnn_rollout, ppo_rnn_sgd_phase, mark)

    def plain_step(rs: RunnerStateRNN, mark=None):
        """The same update through the plain PyTorch twins."""
        return step(rs, ppo_rnn_rollout_reference,
                    ppo_rnn_sgd_phase_reference, mark)

    def train_many(rs: RunnerStateRNN, n: int):
        """n updates; metrics stacked ``[n]``."""
        return run_many(train_step, rs, n)

    return PPORNNTrainer(init=init, train_step=train_step,
                         train_many=train_many, plain_step=plain_step,
                         model=model, optimizer=optimizer, env_cfg=cfg,
                         tcfg=tcfg, arch=arch, device=device)

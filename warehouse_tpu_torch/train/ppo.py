"""The PPO actor-learner on one device (counterpart of
``warehouse_tpu/train/ppo.py``, single-device fused path).

One update, draw for draw as the JAX trainer's fused path
(``rollout_backend``/``grad_backend="pallas"``):

1. permute the env axis of the state with ``permutation(fold_in(key,
   0x5EED), B)`` ("shuffle the envs, not the data": minibatches are then
   contiguous env ranges, :383-386);
2. act T steps through ``kernels.ppo_rollout`` (K2; K10 with
   ``arch="cnn"``), which with ``shaping_coef > 0`` adds the potential
   shaping to the reward it returns, then the boundary reset
   ``reset_truncated_batch`` (:399-410), and with ``bootstrap_truncated``
   V of the pre-reset states (:412-422);
3. GAE from ``last_value``, advantages normalized per env minibatch;
4. the SGD phase through ``kernels.ppo_sgd_phase`` (K3) or, for the CNN,
   ``kernels.ppo_cnn_sgd_phase`` (K11), with the per-step lr and
   bias-correction rows (:678-686);
5. the mirrored ``key, _ = split(key)`` (:503), the metrics and the
   adaptive KL coefficient (:713-746).

On a CUDA device the kernels run and a build or launch failure raises;
on the CPU their plain twins run. ``PPOTrainer.plain_step`` is the same
update through the plain twins on any device, for measurement and tests.

Ported: the MLP and the CNN policy (``arch="cnn"``; its
``policy_groups`` gate raises ``ValueError`` as the JAX trainer's fused
learner does, :244-247, ROADMAP T-3b), one shared policy or, for the MLP,
``policy_groups`` (:94-113: K independent policies, a
``MultiPolicyActorCritic``, each agent acting and learning through its
group's; K2 and K3/K4 route each row by its agent's group, the bootstrap
and last values take each agent's group's), ``model_dtype`` float32 or
bfloat16 (the JAX trainer's, :91-110: the model is built at that compute
dtype, so the bootstrap and last values take the flax-bf16 forward; the
learner kernels K3/K4 and K11/K12 take ``matmul_dtype="bfloat16"``; acting
in K2/K10 stays float32), ``minibatch_mode=
"env"`` with ``epoch_shuffle="once"``, one gradient per minibatch,
entropy anneal, adaptive KL, truncation bootstrap, lr anneal, action
masking (K2 floors invalid moves, the loss re-applies the mask),
potential shaping (GAE reads the shaped reward, the ``reward_per_step``
metric the raw one), global observations (the acting kernels build the
global view, the learners read the wider observation; on the card
``make_train`` raises ``ValueError`` for an env shape or model widths the
kernels cannot hold, before any launch). The TPU
block knobs (``pallas_block``, ``pallas_interpret``, ``sgd_block_envs``,
``sgd_rows_per_block``) have no counterpart and are ignored; the device
picks kernel or twin, so ``rollout_backend``/``grad_backend="xla"``
raises. Everything else raises ``NotImplementedError`` naming its
ROADMAP id.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..config import EnvConfig, TrainConfig
from ..device import resolve_device

from .. import rng
from ..env import engine
from ..env.batch import observe_batch, reset_truncated_batch
from ..env.state import STATE_FIELDS, EnvState
from ..kernels.act import check_act_fits, ppo_rollout, ppo_rollout_reference
from ..kernels.sgd import (check_learner_fits, normalize_adv_env_minibatch,
                           ppo_sgd_phase, ppo_sgd_phase_reference)
from ..kernels.sgd_cnn import (check_cnn_learner_fits, ppo_cnn_sgd_phase,
                               ppo_cnn_sgd_phase_reference)
from ..models.policy import (apply, make_model, make_multi_policy_model,
                             model_precision, params_from_flax)
from ..ops.gae import gae
from ..ops.ppo_update import adaptive_kl_coeff, entropy_coef_at
from ..optim import AdamState, ClipAdam, make_optimizer, opt_state_from_optax

PERM_SALT = 0x5EED  # fold_in salt of the env-state permutation key


class RunnerState(NamedTuple):
    params: dict             # the model's state_dict-keyed tensors
    opt_state: AdamState
    env_state: EnvState      # [B] envs
    obs: torch.Tensor        # float32[B, A, obs_dim]
    key: torch.Tensor        # int64[2] threefry key words
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _check_config(env_cfg: EnvConfig, tcfg: TrainConfig, arch, mesh,
                  policy_groups) -> None:
    if arch in ("gru", "lstm"):
        raise ValueError(f"arch={arch!r}: the recurrent policies train "
                         "through train.ppo_rnn.make_train_rnn")
    if arch not in ("mlp", "cnn"):
        _not_ported(f"arch={arch!r}", "M-7")
    if arch == "cnn" and policy_groups is not None:
        raise ValueError("policy_groups with arch='cnn': the CNN learner is "
                         "single-policy (ROADMAP T-3b)")
    for what, off, item in (
            ("a mesh", mesh is None, "M-8"),
            ("minibatch_mode='flat'", tcfg.minibatch_mode == "env", "M-4"),
            ("epoch_shuffle='each'", tcfg.epoch_shuffle == "once", "M-4"),
            ("micro_batches > 1", tcfg.micro_batches == 1, "M-4"),
            ("flat_optimizer", not tcfg.flat_optimizer, "M-4")):
        if not off:
            _not_ported(what, item)
    for name in ("rollout_backend", "grad_backend"):
        if getattr(tcfg, name) == "xla":
            raise ValueError(f"{name}='xla': the port has no backend switch;"
                             " the device picks kernel (CUDA) or plain twin"
                             " (CPU)")
    if tcfg.num_envs % tcfg.num_minibatches:
        raise ValueError(f"num_envs={tcfg.num_envs} not divisible by "
                         f"num_minibatches={tcfg.num_minibatches}")
    if env_cfg.max_steps % tcfg.unroll_length:
        raise ValueError("max_steps % unroll_length != 0: the boundary "
                         "reset runs after the chunk")


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
    optimizer through ``opt_state_from_optax``, uint32 keys as int64 (the
    shard key ``[1, 2]`` as ``[2]``)."""
    params = {k: v.to(device)
              for k, v in params_from_flax(rs_np.params).items()}
    env = EnvState(**{f: _tensor(getattr(rs_np.env_state, f), device)
                      for f in STATE_FIELDS})
    return RunnerState(
        params=params,
        opt_state=opt_state_from_optax(rs_np.opt_state, device),
        env_state=env,
        obs=_tensor(rs_np.obs, device),
        key=_tensor(rs_np.key, device).reshape(2),
        update_idx=_tensor(rs_np.update_idx, device).to(torch.int32),
        kl_coeff=_tensor(rs_np.kl_coeff, device).to(torch.float32))


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
               key: torch.Tensor, policy_groups=None):
    """The start of a run from ``key``, as the JAX trainers' ``init``:
    ``split(key, 3)``; the params from a ``torch.Generator`` seeded by the
    first key (flax's bits are not reproduced; with ``policy_groups`` the
    groups' sub-models in group order); env b reset from ``fold_in(ekey,
    b)``; the shard key ``fold_in(skey, 0)``. Returns ``(params,
    env_state, obs, key)``."""
    pkey, ekey, skey = rng.split(key.to(device), 3)
    seed = int(pkey[0]) << 32 | int(pkey[1])
    init_model = build_model(cfg, tcfg, arch, device, policy_groups,
                             torch.Generator().manual_seed(seed))
    params = {k: v.detach().clone()
              for k, v in init_model.state_dict().items()}
    env_state, obs = engine.reset(
        cfg, rng.fold_in(ekey, torch.arange(tcfg.num_envs, device=device)))
    return params, env_state, obs, rng.fold_in(skey, 0)


def run_many(train_step: Callable, rs, n: int):
    """n updates of ``train_step``; metrics stacked ``[n]``."""
    rows: list[dict[str, Any]] = []
    for _ in range(n):
        rs, m = train_step(rs)
        rows.append(m)
    return rs, {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def update_metrics(tcfg: TrainConfig, losses, kl_coeff, roll):
    """The metrics of one PPO update and the adapted KL coefficient, from
    the SGD phase's ``losses`` and the chunk's rollout
    (``warehouse_tpu/train/ppo.py:713-746``)."""
    T, B = roll.delivered.shape
    mean_kl = losses[4].mean()
    kl_coeff = adaptive_kl_coeff(tcfg, kl_coeff, mean_kl)
    return {
        "loss": losses[0].mean(),
        "pg_loss": losses[1].mean(),
        "v_loss": losses[2].mean(),
        "entropy": losses[3].mean(),
        "kl": mean_kl,
        "kl_coeff": kl_coeff,
        "reward_per_step": roll.raw_reward.mean(dim=(1, 2)).mean(),
        "deliveries_per_env_step":
            roll.delivered.sum(dtype=torch.float32) / (T * B),
    }, kl_coeff


def make_train(env_cfg: EnvConfig, tcfg: TrainConfig, arch: str = "mlp",
               device=None, mesh=None,
               policy_groups: tuple | None = None) -> PPOTrainer:
    """Build the trainer for ``tcfg`` on ``device``: the card by default,
    the CPU (plain twins) with ``device="cpu"``. ``policy_groups``: a tuple
    of one group id ``0..K-1`` per agent, K independent MLP policies."""
    _check_config(env_cfg, tcfg, arch, mesh, policy_groups)
    device = resolve_device(device)
    cfg = env_cfg.replace(auto_reset=False)
    B, T, M = tcfg.num_envs, tcfg.unroll_length, tcfg.num_minibatches
    n_steps = tcfg.ppo_epochs * M
    optimizer = make_optimizer(tcfg)
    if policy_groups is not None:
        policy_groups = tuple(int(g) for g in policy_groups)
    model = build_model(cfg, tcfg, arch, device, policy_groups)
    if device.type == "cuda":  # refuse by name what no kernel route holds
        check_act_fits(cfg, model, device, policy_groups)
        (check_cnn_learner_fits if arch == "cnn" else check_learner_fits)(
            model.state_dict(), cfg.obs_dim, device)
    sgd_fn, sgd_reference = (
        (ppo_cnn_sgd_phase, ppo_cnn_sgd_phase_reference) if arch == "cnn"
        else (ppo_sgd_phase, ppo_sgd_phase_reference))
    # Each sample's group by its agent (broadcast over [..., B, A]).
    gids = None if policy_groups is None else torch.tensor(policy_groups,
                                                           device=device)
    sgd_kw = {"matmul_dtype": tcfg.model_dtype}
    if policy_groups is not None:
        sgd_kw["policy_groups"] = policy_groups
    # The bootstrap and last values' forward: the model's.
    precision = model_precision(tcfg.model_dtype)

    def init(key: torch.Tensor) -> RunnerState:
        params, env_state, obs, key = init_parts(cfg, tcfg, arch, device, key,
                                                 policy_groups)
        return RunnerState(
            params=params, opt_state=optimizer.init(params),
            env_state=env_state, obs=obs, key=key,
            update_idx=torch.zeros((), dtype=torch.int32, device=device),
            kl_coeff=torch.tensor(tcfg.kl_coeff, dtype=torch.float32,
                                  device=device))

    def step(rs: RunnerState, act_fn, sgd_fn, mark=None):
        mark = mark or (lambda name: None)
        key = rs.key
        perm = rng.permutation(rng.fold_in(key, PERM_SALT), B)
        env_in = EnvState(**{f: getattr(rs.env_state, f)[perm]
                             for f in STATE_FIELDS})
        model.load_state_dict(rs.params)
        new_env, roll, reset_key, key = act_fn(
            cfg, model, env_in, T, key, mask_actions=tcfg.mask_actions,
            shaping_coef=tcfg.shaping_coef, gamma=tcfg.gamma, arch=arch,
            policy_groups=policy_groups)
        env_state, last_obs, _ = reset_truncated_batch(cfg, new_env,
                                                       reset_key)
        boot = torch.zeros_like(roll.value)
        if tcfg.bootstrap_truncated:
            # done is only ever set on the chunk's last step.
            boot[-1] = apply(rs.params, observe_batch(cfg, new_env), gids,
                             precision=precision)[1]
        traj = Transition(roll.obs, roll.action, roll.log_prob, roll.value,
                          roll.reward,
                          roll.truncated[:, :, None].expand_as(roll.reward),
                          roll.mask, boot)
        mark("acting")

        _, last_value = apply(rs.params, last_obs, gids, precision=precision)
        adv, targets = gae(traj.reward, traj.value, traj.done, last_value,
                           tcfg.gamma, tcfg.gae_lambda,
                           boot if tcfg.bootstrap_truncated else None)
        adv_n = normalize_adv_env_minibatch(adv, M)
        ent_coef = entropy_coef_at(tcfg, rs.update_idx)
        rows = optimizer.step_rows(rs.opt_state.count, n_steps, device)
        mark("gae")

        params, opt_state, losses = sgd_fn(
            rs.params, rs.opt_state, traj, adv_n, targets, *rows, ent_coef,
            rs.kl_coeff, num_epochs=tcfg.ppo_epochs, num_minibatches=M,
            clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
            max_grad_norm=tcfg.max_grad_norm,
            mask_actions=tcfg.mask_actions, **sgd_kw)
        mark("sgd")

        # The key split the JAX XLA scaffold spends on its partition.
        key = rng.split(key, 2)[0]
        metrics, kl_coeff = update_metrics(tcfg, losses, rs.kl_coeff, roll)
        new = RunnerState(params=params, opt_state=opt_state,
                          env_state=env_state, obs=last_obs, key=key,
                          update_idx=rs.update_idx + 1, kl_coeff=kl_coeff)
        return new, metrics

    def train_step(rs: RunnerState, mark=None):
        """One update through the kernels (plain twins on the CPU).
        ``mark(name)``, if given, is called after the acting, GAE and
        SGD phases (for timing)."""
        return step(rs, ppo_rollout, sgd_fn, mark)

    def plain_step(rs: RunnerState, mark=None):
        """The same update through the plain PyTorch twins."""
        return step(rs, ppo_rollout_reference, sgd_reference, mark)

    def train_many(rs: RunnerState, n: int):
        """n updates; metrics stacked ``[n]``."""
        return run_many(train_step, rs, n)

    return PPOTrainer(init=init, train_step=train_step,
                      train_many=train_many, plain_step=plain_step,
                      model=model, optimizer=optimizer, env_cfg=cfg,
                      tcfg=tcfg, device=device, policy_groups=policy_groups)

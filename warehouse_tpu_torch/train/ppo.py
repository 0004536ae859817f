"""The PPO actor-learner on one device (counterpart of
``warehouse_tpu/train/ppo.py``, single-device path).

One update, draw for draw as the JAX trainer with its acting kernel
(``rollout_backend="pallas"``) and, per phase, its learner kernel or its
XLA learner:

1. with ``minibatch_mode="env"`` and ``epoch_shuffle="once"``, permute the
   env axis of the state with ``permutation(fold_in(key, 0x5EED), B)``
   ("shuffle the envs, not the data": minibatches are then contiguous env
   ranges, :370-386); with any other cadence the state is not permuted;
2. act T steps through ``kernels.ppo_rollout`` (K2; K10 with
   ``arch="cnn"``), which with ``shaping_coef > 0`` adds the potential
   shaping to the reward it returns, then the boundary reset
   ``reset_truncated_batch`` (:399-410), and with ``bootstrap_truncated``
   V of the pre-reset states (:412-422);
3. GAE from ``last_value``;
4. the SGD phase: where a learner kernel takes the configuration,
   advantages normalized per env minibatch and ``kernels.ppo_sgd_phase``
   (K3) or, for the CNN, ``kernels.ppo_cnn_sgd_phase`` (K11), with the
   per-step lr and bias-correction rows (:678-686); else the plain learner
   phase of the JAX XLA route (``_learn`` :481-602, ROADMAP M-4): autograd
   through ``models.policy.apply`` at the model's precision (the flax-bf16
   forward at bfloat16), ``ops.ppo_update``'s scaffold and ``optim.py``;
5. the scaffold's key splits (``partition_keys``: one for "once", one per
   epoch for "each"), the metrics and the adaptive KL coefficient
   (:713-746).

Each phase's route follows from the configuration alone, as the JAX
trainer's ``_rollout_problems`` / ``_grad_problems`` (:162-303) decide
between its kernel and XLA: ``PPOTrainer.backends`` is ``{"rollout":
"cuda" | "plain", "grad": "cuda" | "plain"}``, the counterpart of JAX
``PPOTrainer.backends`` (:825). The learner is plain where the JAX trainer
resolves it to XLA: the CNN with ``policy_groups`` (its fused learner is
single-policy, :243-247), ``minibatch_mode="flat"`` or
``epoch_shuffle="each"`` (``--rllib-cadence``), ``micro_batches > 1``
(the mean of the micro-gradients, one optimizer step, advantages
normalized per minibatch, :564-587) and ``flat_optimizer``
(``optax.flatten``: clip and Adam over one vector). On a CUDA device the
kernels run and a build or launch failure raises; no failure picks a
route. On the CPU both phases are plain (the kernels' twins or the plain
learner). ``PPOTrainer.plain_step`` is the same update with the acting
kernel's twin and, where the learner is a kernel, its twin.

Ported besides: the MLP and the CNN policy, one shared policy or
``policy_groups`` (:94-113: K independent policies, a
``MultiPolicyActorCritic``, each agent acting and learning through its
group's; K2 / K10 and K3/K4 route each row by its agent's group, the
bootstrap and last values take each agent's group's), ``model_dtype``
float32 or bfloat16 (the JAX trainer's, :91-110: the model is built at
that compute dtype, so the bootstrap and last values take the flax-bf16
forward; the learner kernels K3/K4 and K11/K12 take
``matmul_dtype="bfloat16"``; acting in K2/K10 stays float32), entropy
anneal, adaptive KL, truncation bootstrap, lr anneal, action masking (K2
floors invalid moves, the loss re-applies the mask), potential shaping
(GAE reads the shaped reward, the ``reward_per_step`` metric the raw
one), global observations (the acting kernels build the global view, the
learners read the wider observation; on the card ``make_train`` raises
``ValueError`` for an env shape or model widths the kernels cannot hold,
before any launch). The TPU block knobs (``pallas_block``,
``pallas_interpret``, ``sgd_block_envs``, ``sgd_rows_per_block``) have no
counterpart and are ignored; ``rollout_backend``/``grad_backend="xla"``
raises. Everything else raises ``NotImplementedError`` naming its ROADMAP
id.
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
from ..ops.ppo_update import (NEG_INF, adaptive_kl_coeff, entropy_coef_at,
                              env_major_minibatches, flat_minibatches,
                              minibatch_epochs, partition_keys, ppo_losses)
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
    backends: dict | None = None  # {"rollout", "grad"}: "cuda" or "plain"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def check_backend_names(tcfg: TrainConfig) -> None:
    """Refuse ``rollout_backend`` / ``grad_backend="xla"``: the port
    picks each phase's route from the configuration and the device."""
    for name in ("rollout_backend", "grad_backend"):
        if getattr(tcfg, name) == "xla":
            raise ValueError(f"{name}='xla': the port has no backend switch;"
                             " each phase runs its kernel where one takes the"
                             " configuration (CUDA), else plain PyTorch")


def make_backends(device, problems: list) -> dict:
    """The trainers' ``backends``: on a CUDA device the acting kernel,
    and the learner kernel unless ``problems`` names an option it does not
    take; on the CPU both phases plain."""
    cuda = device.type == "cuda"
    return {"rollout": "cuda" if cuda else "plain",
            "grad": "cuda" if cuda and not problems else "plain"}


def grad_problems(tcfg: TrainConfig, arch: str, policy_groups) -> list:
    """The options of ``tcfg`` that no PPO learner kernel computes (the
    JAX trainer's ``_grad_problems``, :239-288): where this is not empty
    the SGD phase is plain."""
    problems = []
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


def _check_config(env_cfg: EnvConfig, tcfg: TrainConfig, arch, mesh) -> None:
    if arch in ("gru", "lstm"):
        raise ValueError(f"arch={arch!r}: the recurrent policies train "
                         "through train.ppo_rnn.make_train_rnn")
    if arch not in ("mlp", "cnn"):
        _not_ported(f"arch={arch!r}", "M-7")
    if mesh is not None:
        _not_ported("a mesh", "M-8")
    check_backend_names(tcfg)
    batch = tcfg.unroll_length * tcfg.num_envs * env_cfg.num_agents
    if batch % tcfg.num_minibatches:
        raise ValueError("T*B*A must divide into num_minibatches")
    if tcfg.minibatch_mode == "env" and (
            tcfg.num_envs % tcfg.num_minibatches):
        raise ValueError(f"num_envs={tcfg.num_envs} not divisible by "
                         f"num_minibatches={tcfg.num_minibatches}")
    mb_samples = batch // tcfg.num_minibatches
    if mb_samples % tcfg.micro_batches:
        raise ValueError(f"micro_batches={tcfg.micro_batches} must divide "
                         f"the minibatch sample count {mb_samples}")
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
    optimizer through ``opt_state_from_optax`` (a flattened one too),
    uint32 keys as int64 (the shard key ``[1, 2]`` as ``[2]``)."""
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


def ppo_plain_phase(tcfg: TrainConfig, optimizer: ClipAdam, params,
                    opt_state, key, traj, adv, targets, ent_coef, kl_coeff,
                    state_shuffled: bool, policy_groups=None,
                    precision: str = "float32"):
    """The PPO SGD phase of the JAX XLA route (``train/ppo.py:481-602``)
    in plain PyTorch, on any device: the minibatches of ``minibatch_mode``
    (env-major env ranges, permuted per partition unless the state was
    shuffled before acting, or flat samples), a partition per update or per
    epoch (``epoch_shuffle``), ``micro_batches`` micro-gradients averaged
    before each step (advantages then normalized per minibatch, else in the
    loss), ``optimizer``'s step (flat or not), autograd through
    ``models.policy.apply`` at ``precision``. ``adv`` are GAE's raw
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
        micro_batches=k)
    return params, opt_state, key, losses


def make_train(env_cfg: EnvConfig, tcfg: TrainConfig, arch: str = "mlp",
               device=None, mesh=None,
               policy_groups: tuple | None = None) -> PPOTrainer:
    """Build the trainer for ``tcfg`` on ``device``: the card by default,
    the CPU (plain twins) with ``device="cpu"``. ``policy_groups``: a tuple
    of one group id ``0..K-1`` per agent, K independent MLP or CNN
    policies."""
    _check_config(env_cfg, tcfg, arch, mesh)
    device = resolve_device(device)
    cfg = env_cfg.replace(auto_reset=False)
    B, T, M = tcfg.num_envs, tcfg.unroll_length, tcfg.num_minibatches
    n_steps = tcfg.ppo_epochs * M
    optimizer = make_optimizer(tcfg)
    if policy_groups is not None:
        policy_groups = tuple(int(g) for g in policy_groups)
    model = build_model(cfg, tcfg, arch, device, policy_groups)
    # The learner kernels take the default cadence only; the state shuffle
    # before acting is that cadence's minibatching.
    problems = grad_problems(tcfg, arch, policy_groups)
    grad_kernel = not problems
    backends = make_backends(device, problems)
    state_shuffle = (tcfg.minibatch_mode == "env"
                     and tcfg.epoch_shuffle == "once")
    if device.type == "cuda":  # refuse by name what no kernel route holds
        check_act_fits(cfg, model, device, policy_groups)
        if grad_kernel:
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
        env_in = rs.env_state
        if state_shuffle:
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
        ent_coef = entropy_coef_at(tcfg, rs.update_idx)
        if sgd_fn is None:  # the plain learner phase (M-4)
            mark("gae")
            params, opt_state, key, losses = ppo_plain_phase(
                tcfg, optimizer, rs.params, rs.opt_state, key, traj, adv,
                targets, ent_coef, rs.kl_coeff, state_shuffle,
                policy_groups, precision)
        else:
            adv_n = normalize_adv_env_minibatch(adv, M)
            rows = optimizer.step_rows(rs.opt_state.count, n_steps, device)
            mark("gae")
            params, opt_state, losses = sgd_fn(
                rs.params, rs.opt_state, traj, adv_n, targets, *rows,
                ent_coef, rs.kl_coeff, num_epochs=tcfg.ppo_epochs,
                num_minibatches=M, clip_eps=tcfg.clip_eps,
                value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
                mask_actions=tcfg.mask_actions, **sgd_kw)
            # The key split the JAX scaffold spends on its partition.
            key, _ = partition_keys(key, tcfg.ppo_epochs, False)
        mark("sgd")

        metrics, kl_coeff = update_metrics(tcfg, losses, rs.kl_coeff, roll)
        new = RunnerState(params=params, opt_state=opt_state,
                          env_state=env_state, obs=last_obs, key=key,
                          update_idx=rs.update_idx + 1, kl_coeff=kl_coeff)
        return new, metrics

    def train_step(rs: RunnerState, mark=None):
        """One update through each phase's route of ``backends`` (plain
        twins on the CPU). ``mark(name)``, if given, is called after the
        acting, GAE and SGD phases (for timing)."""
        return step(rs, ppo_rollout, sgd_fn if grad_kernel else None, mark)

    def plain_step(rs: RunnerState, mark=None):
        """The same update through the plain PyTorch twins."""
        return step(rs, ppo_rollout_reference,
                    sgd_reference if grad_kernel else None, mark)

    def train_many(rs: RunnerState, n: int):
        """n updates; metrics stacked ``[n]``."""
        return run_many(train_step, rs, n)

    return PPOTrainer(init=init, train_step=train_step,
                      train_many=train_many, plain_step=plain_step,
                      model=model, optimizer=optimizer, env_cfg=cfg,
                      tcfg=tcfg, device=device, policy_groups=policy_groups,
                      backends=backends)

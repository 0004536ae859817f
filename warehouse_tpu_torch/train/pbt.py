"""Population Based Training (counterpart of ``warehouse_tpu/train/pbt.py``):
Ray Tune's PBT scheduler.

The JAX PBT trains its population as a vmap axis in one program; the
port trains the members one after another, each a ``MemberState``, and
keeps the rest: the learning rate and the entropy coefficient are runtime
values of each member (no rebuild when explore changes them); exploit
copies a member's whole training state from a sampled top-quantile
member; explore multiplies by 1.2, divides by 1.2 or resamples with
probability ``resample_prob``, on the JAX module's
``np.random.Generator(seed)`` in its order of draws.

A member's update is the JAX ``_update_one`` step for step: the per-step
acting phase (``train.ppo.step_rollout``: ``step_autoreset_batch`` each
tick, the mask, the shaping, the bootstrap from ``final_obs``), GAE, and
``train.ppo.ppo_plain_phase`` on flat minibatches of all ``T*B*A`` samples
(a partition per update, or per epoch with ``epoch_shuffle="each"``), with
the member's entropy and KL coefficients, and clip + Adam at the member's
learning rate with no schedule (optax ``inject_hyperparams``), flat with
``flat_optimizer``. The
JAX PBT reaches no Pallas kernel, so both phases are plain PyTorch on the
card (``backends`` ``{"rollout": "step", "grad": "plain"}``, in every row).

With a ``(pop, data)`` mesh (``parallel.mesh.make_pop_mesh``; JAX
``train/pbt.py:268-329``) slice ``s`` holds members ``[s P / pop, (s + 1)
P / pop)`` (member ``p`` from ``fold_in(key, p)`` all the same), each
member's envs sharded over the slice's data ranks: env ``i`` reset from
``fold_in(ekey, i)`` for the rank's global env indices, the rank's shard
key ``fold_in(skey, d)``, flat minibatches of its ``T * b_local * A``
samples permuted by that key, each step's gradient and loss averaged over
the slice's data group (``minibatch_epochs(mesh=)``), the deliveries (over
``T * b_local``) and the reward averaged over it too (:246-257).
``train_chunk``'s metrics and ``get_lr`` are gathered over the slices to
``[P, ...]`` on every rank, ``with_hp`` takes the whole population's;
every rank runs the same generator, so the exploit's sources and the
explored hyperparameters agree everywhere; a member replaced by one on
another slice receives its whole state bit for bit, rank ``(s, d)`` to
rank ``(s', d)`` (``PopMesh.copy_tree``: point to point, one buffer for
each replaced member and data index; JAX's gather along the population
axis, ``run_pbt`` :419-421). The mesh's rank 0 alone writes the JSONL.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import EnvConfig, TrainConfig
from ..device import resolve_device

from .. import rng
from ..env.state import STATE_FIELDS, EnvState
from ..models.policy import apply, params_from_flax
from ..ops.gae import gae
from ..ops.ppo_update import adaptive_kl_coeff
from ..optim import AdamState, ClipAdam, opt_state_from_optax
from ..parallel.mesh import DATA_AXIS, POP_AXIS
from .ppo import (PLAIN, STEP, Transition, _tensor, init_parts,
                  ppo_plain_phase, step_rollout)
from .sweep import sample_spec

BACKENDS = {"rollout": STEP, "grad": PLAIN}


@dataclasses.dataclass
class MemberState:
    """One population member's training state."""
    params: dict               # the model's state_dict-keyed tensors
    opt_state: AdamState
    env_state: EnvState        # [B] envs
    obs: torch.Tensor          # float32[B, A, obs_dim]
    key: torch.Tensor          # int64[2] threefry key words
    learning_rate: torch.Tensor  # float32[], runtime-mutable (explore)
    entropy_coef: torch.Tensor   # float32[], runtime-mutable (explore)
    kl_coeff: torch.Tensor       # float32[], adaptive KL penalty state


class PBTResult(NamedTuple):
    rows: list
    best: dict
    member: list            # the final population, a MemberState each


_MUTABLE = ("learning_rate", "entropy_coef")


def _sample_hp(space: Any, rng_np: np.random.Generator) -> float:
    return float(sample_spec(space, rng_np))


def _clone(x):
    """A copy of a member's tree whose tensors share no storage."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _clone(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def member_range(P: int, mesh) -> range:
    """The members this rank holds: all ``P`` without a mesh, else its
    slice's ``P / pop``; ``ValueError`` (JAX's) where ``pop`` does not
    divide ``P``."""
    if mesh is None:
        return range(P)
    pop = mesh.shape[POP_AXIS]
    if P % pop:
        raise ValueError(f"population {P} not divisible by {pop} pop shards")
    per = P // pop
    return range(mesh.slice * per, (mesh.slice + 1) * per)


def population_values(members: list, name: str, mesh=None) -> np.ndarray:
    """Every member's float ``name`` (a hyperparameter), ``[P]`` in member
    order: this rank's members', gathered over the mesh's slices."""
    local = torch.tensor([float(getattr(m, name)) for m in members],
                         dtype=torch.float64)
    if mesh is not None:
        local = torch.cat(mesh.gather_slices(local))
    return local.numpy()


def make_pbt_trainer(env_cfg: EnvConfig, tcfg: TrainConfig,
                     arch: str = "mlp", mesh=None, device=None):
    """Build ``(init_members, train_chunk, get_lr, with_hp)`` with runtime
    lr / entropy_coef, on the card unless ``device="cpu"``.

    ``init_members(key, lrs, ents) -> [MemberState]`` (member p from
    ``fold_in(key, p)``); ``train_chunk(members, n) -> (members,
    metrics)``: n updates of every member in turn, ``metrics`` a dict of
    tensors ``[P, n]``.

    ``mesh``: a ``parallel.mesh.PopMesh`` (``make_pop_mesh``): the members
    sharded over its ``pop`` slices (this rank's members are its slice's),
    each member's env batch over the slice's data ranks (``num_envs``
    divisible by them).
    """
    device = resolve_device(device)
    env_cfg = env_cfg.replace(auto_reset=True)
    # The JAX PBT builds its model at float32, whatever model_dtype says.
    tcfg = tcfg.replace(model_dtype="float32")
    n_data = 1 if mesh is None else mesh.shape[DATA_AXIS]
    if tcfg.num_envs % n_data:
        raise ValueError(f"num_envs={tcfg.num_envs} not divisible by "
                         f"{n_data} data shards")
    # The slice's data group averages each step's gradient and the metrics.
    data = None if mesh is None else mesh.data
    T, B, A = tcfg.unroll_length, tcfg.num_envs // n_data, env_cfg.num_agents
    if T * B * A % tcfg.num_minibatches:
        raise ValueError("T*B_local*A must divide into num_minibatches")
    # JAX's PBT learns on flat minibatches of whole gradients.
    learner_tcfg = tcfg.replace(minibatch_mode="flat", micro_batches=1)

    def optimizer(member: MemberState) -> ClipAdam:
        # The member's runtime learning rate, constant over its steps.
        lr = member.learning_rate
        return ClipAdam(lambda count: lr.expand(count.shape),
                        tcfg.max_grad_norm, tcfg.flat_optimizer)

    # This rank's envs of each member (by global index) and its shard key.
    envs, shard = (None, 0) if mesh is None else (
        range(data.rank * B, (data.rank + 1) * B), data.rank)

    def init_one(key: torch.Tensor, lr: float, ent: float) -> MemberState:
        params, env_state, obs, skey = init_parts(
            env_cfg, tcfg, arch, device, key, envs=envs, shard=shard)
        opt = ClipAdam(lr, tcfg.max_grad_norm, tcfg.flat_optimizer)
        return MemberState(params, opt.init(params), env_state, obs, skey,
                           _f32(lr, device), _f32(ent, device),
                           _f32(tcfg.kl_coeff, device))

    def init_members(key: torch.Tensor, lrs, ents) -> list[MemberState]:
        key = key.to(device)
        return [init_one(rng.fold_in(key, p), lrs[p], ents[p])
                for p in member_range(len(lrs), mesh)]

    def update_one(member: MemberState):
        params = member.params

        def policy(obs, carry):
            return (*apply(params, obs), None)

        env_state, roll, last_obs, key, boot, _ = step_rollout(
            env_cfg, tcfg, policy, member.env_state, member.obs, T,
            member.key)
        done = roll.truncated[:, :, None].expand_as(roll.reward)
        with torch.no_grad():
            last_value = apply(params, last_obs)[1]
        advantages, targets = gae(
            roll.reward, roll.value, done, last_value, tcfg.gamma,
            tcfg.gae_lambda, boot if tcfg.bootstrap_truncated else None)
        traj = Transition(obs=roll.obs, action=roll.action,
                          log_prob=roll.log_prob, value=roll.value,
                          reward=roll.reward, done=done, mask=roll.mask,
                          boot_value=boot)
        params, opt_state, key, losses = ppo_plain_phase(
            learner_tcfg, optimizer(member), params, member.opt_state, key,
            traj, advantages, targets, member.entropy_coef, member.kl_coeff,
            False, mesh=data)
        mean_kl = losses[4].mean()
        kl_coeff = adaptive_kl_coeff(tcfg, member.kl_coeff, mean_kl)
        deliveries = roll.delivered.sum(dtype=torch.float32) / (T * B)
        reward = roll.raw_reward.mean(dim=(1, 2)).mean()
        if data is not None:
            deliveries, reward = data.mean([deliveries, reward])
        metrics = {
            "loss": losses[0].mean(),
            "entropy": losses[3].mean(),
            "kl": mean_kl,
            "deliveries_per_env_step": deliveries,
            "reward_per_step": reward,
        }
        return dataclasses.replace(
            member, params=params, opt_state=opt_state, env_state=env_state,
            obs=last_obs, key=key, kl_coeff=kl_coeff), metrics

    def train_chunk(members: list[MemberState], n: int):
        out, rows = [], []
        for member in members:
            steps = []
            for _ in range(n):
                member, m = update_one(member)
                steps.append(m)
            out.append(member)
            rows.append({k: torch.stack([s[k] for s in steps])
                         for k in steps[0]})
        metrics = {k: torch.stack([r[k] for r in rows]) for k in rows[0]}
        if mesh is not None:  # [P, n]: every slice's members, in order
            metrics = {k: torch.cat(mesh.gather_slices(v))
                       for k, v in metrics.items()}
        return out, metrics

    def get_lr(members: list[MemberState]) -> np.ndarray:
        return population_values(members, "learning_rate", mesh)

    def with_hp(members: list[MemberState], lrs, ents) -> list[MemberState]:
        """The whole population's ``lrs`` and ``ents`` ``[P]`` set on this
        rank's members."""
        mine = member_range(len(lrs), mesh)
        return [dataclasses.replace(m, learning_rate=_f32(lrs[p], device),
                                    entropy_coef=_f32(ents[p], device))
                for m, p in zip(members, mine)]

    return init_members, train_chunk, get_lr, with_hp


def exploit(members: list, src: np.ndarray, mesh=None) -> list:
    """Member ``i`` replaced by a copy of member ``src[i]``'s whole state,
    for every ``i`` (``[P]``, the same on every rank). With ``mesh`` the
    rank's members are its slice's: a source on the same slice is cloned
    in place, one on another slice arrives from the rank of that slice at
    this rank's data index (``PopMesh.copy_tree``), the copies made in
    member order on every rank."""
    if mesh is None:
        return [_clone(members[int(s)]) for s in src]
    mine = member_range(len(src), mesh)
    per = len(mine)
    out = list(members)
    for i, s in enumerate(int(s) for s in src):
        here, there = i // per, s // per
        if here == there:
            if i in mine:
                out[i - mine.start] = _clone(members[s - mine.start])
            continue
        tree = (members[s - mine.start] if there == mesh.slice
                else members[i - mine.start] if here == mesh.slice else None)
        got = mesh.copy_tree(tree, there, here)
        if i in mine:
            out[i - mine.start] = got
    return out


def exploit_explore(members: list, scores: np.ndarray, lrs: np.ndarray,
                    ents: np.ndarray, hyper_space: dict, rng_np, quantile,
                    resample_prob: float, sign: float, mesh=None):
    """Tune's default PBT rule, as the JAX loop applies it: the bottom
    ``quantile`` of members (by ``sign * scores``) each copy the whole
    state of a member drawn from the top quantile (``exploit``, over
    ``mesh`` where the members are sharded), then each mutable
    hyperparameter in ``hyper_space`` is resampled with probability
    ``resample_prob`` or multiplied by 1.2 or 1/1.2. Returns ``(members,
    src, bottom, new_lrs, new_ents)``: member i's state is now member
    ``src[i]``'s; the caller sets the new hyperparameters."""
    P = len(scores)
    ranked = np.argsort(sign * scores)[::-1]         # best first
    n_q = max(1, int(np.ceil(P * quantile)))
    top, bottom = ranked[:n_q], ranked[P - n_q:]
    src = np.arange(P)
    src[bottom] = rng_np.choice(top, size=len(bottom))
    members = exploit(members, src, mesh)
    new_lrs, new_ents = lrs[src].copy(), ents[src].copy()
    for i in bottom:
        for name, arr in (("learning_rate", new_lrs),
                          ("entropy_coef", new_ents)):
            if name not in hyper_space:
                continue
            if rng_np.random() < resample_prob:
                arr[i] = _sample_hp(hyper_space[name], rng_np)
            else:
                arr[i] *= 1.2 if rng_np.random() < 0.5 else 1 / 1.2
    return members, src, bottom, new_lrs, new_ents


def run_pbt(
    env_cfg: EnvConfig,
    base_tcfg: TrainConfig,
    hyper_space: dict[str, Any],
    population_size: int = 8,
    perturb_interval: int = 10,
    num_intervals: int = 5,
    quantile: float = 0.25,
    resample_prob: float = 0.25,
    arch: str = "mlp",
    select_metric: str = "deliveries_per_env_step",
    mode: str = "max",
    seed: int = 0,
    out_path: str | None = None,
    mesh=None,
    device=None,
) -> PBTResult:
    """Run PBT; returns (rows, best, final population).

    ``hyper_space`` maps a subset of {"learning_rate", "entropy_coef"}
    to a sample spec (list = choice, {"uniform"|"loguniform": [lo,hi]}).
    Score per interval = mean of ``select_metric`` over the interval's
    updates. Runs on the card unless ``device="cpu"``. ``mesh``: a
    ``(pop, data)`` mesh (``make_pbt_trainer``); the final population is
    then this rank's members.
    """
    for k in hyper_space:
        if k not in _MUTABLE:
            raise ValueError(
                f"PBT mutates {_MUTABLE}; got {k!r} (fixed fields are "
                "build-time settings: sweep them with train/sweep.py)")
    if mode not in ("max", "min"):
        raise ValueError("mode must be 'max' or 'min'")
    sign = 1.0 if mode == "max" else -1.0
    rng_np = np.random.default_rng(seed)
    P = population_size

    lrs = np.array([
        _sample_hp(hyper_space["learning_rate"], rng_np)
        if "learning_rate" in hyper_space else base_tcfg.learning_rate
        for _ in range(P)])
    ents = np.array([
        _sample_hp(hyper_space["entropy_coef"], rng_np)
        if "entropy_coef" in hyper_space else base_tcfg.entropy_coef
        for _ in range(P)])

    tcfg = base_tcfg.replace(anneal_lr=False)
    device = resolve_device(device)
    init_members, train_chunk, get_lr, with_hp = make_pbt_trainer(
        env_cfg, tcfg, arch=arch, mesh=mesh, device=device)
    member = init_members(rng.prng_key(seed, device), lrs, ents)

    rows: list[dict[str, Any]] = []
    scores = np.zeros(P)
    for interval in range(num_intervals):
        member, metrics = train_chunk(member, perturb_interval)
        curve = metrics[select_metric].detach().cpu().numpy()  # [P, n]
        scores = curve.mean(axis=1)
        lrs = get_lr(member)
        ents = population_values(member, "entropy_coef", mesh)
        for p in range(P):
            rows.append({
                "member": p, "interval": interval,
                "updates_so_far": (interval + 1) * perturb_interval,
                "score": float(scores[p]),
                "learning_rate": float(lrs[p]),
                "entropy_coef": float(ents[p]),
                "backends": BACKENDS,
            })
        if interval == num_intervals - 1:
            break
        member, _, _, new_lrs, new_ents = exploit_explore(
            member, scores, lrs, ents, hyper_space, rng_np, quantile,
            resample_prob, sign, mesh=mesh)
        member = with_hp(member, new_lrs, new_ents)

    best_i = int(np.argmax(sign * scores))
    best = {
        "summary": True, "scheduler": "pbt", "select_metric": select_metric,
        "mode": mode, "population_size": P,
        "perturb_interval": perturb_interval,
        "num_intervals": num_intervals,
        "best_member": best_i, "best_score": float(scores[best_i]),
        "best_hyperparams": {"learning_rate": float(get_lr(member)[best_i]),
                             "entropy_coef": float(population_values(
                                 member, "entropy_coef", mesh)[best_i])},
        "backends": BACKENDS,
    }
    rows.append(best)
    if out_path and (mesh is None or mesh.rank == 0):
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return PBTResult(rows, best, member)


def members_from_jax(member_np, device=None) -> list[MemberState]:
    """A JAX population (``MemberState`` of leading axis [P], its leaves as
    numpy, one data shard) as the port's members: params through
    ``params_from_flax``, the ``inject_hyperparams`` optimizer state
    through ``opt_state_from_optax`` and its ``learning_rate``, uint32 keys
    as int64."""
    device = resolve_device(device)
    P = np.asarray(member_np.entropy_coef).shape[0]

    def leaf(tree, p):
        if dataclasses.is_dataclass(tree):
            return dataclasses.replace(tree, **{
                f.name: leaf(getattr(tree, f.name), p)
                for f in dataclasses.fields(tree)})
        if isinstance(tree, dict):
            return {k: leaf(v, p) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(leaf(v, p) for v in tree))
        if isinstance(tree, (tuple, list)):
            return type(tree)(leaf(v, p) for v in tree)
        return np.asarray(tree)[p]

    out = []
    for p in range(P):
        m = leaf(member_np, p)
        params = {k: v.to(device)
                  for k, v in params_from_flax(m.params).items()}
        opt_state = opt_state_from_optax(m.opt_state, device,
                                         params_like=m.params)
        lr = m.opt_state[1].hyperparams["learning_rate"]
        env = EnvState(**{f: _tensor(getattr(m.env_state, f), device)
                          for f in STATE_FIELDS})
        out.append(MemberState(
            params=params, opt_state=opt_state, env_state=env,
            obs=_tensor(m.obs, device), key=_tensor(m.key, device).reshape(2),
            learning_rate=_f32(lr, device),
            entropy_coef=_f32(m.entropy_coef, device),
            kl_coeff=_f32(m.kl_coeff, device)))
    return out

"""The trainers' optimizers, written out as optax computes them.

Counterparts of the chains at ``warehouse_tpu/train/ppo.py:323-335`` and
``warehouse_tpu/train/impala.py:192-221``:
``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, ADAM_B1,
ADAM_B2, ADAM_EPS))`` and IMPALA's default ``optax.chain(
clip_by_global_norm(max_grad_norm), rmsprop(lr, decay=0.99, eps=0.1))``,
with ``lr`` a ``linear_schedule`` over the run's optimizer steps or a
constant. Each formula is optax's, in its op order:

- clip: ``where(norm < max, g, (g / norm) * max)``, no epsilon (torch's
  ``clip_grad_norm_`` adds 1e-6 and scales by a clamped ratio instead);
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g² + b2 nu``, then
  ``update = -lr * (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps)``
  with ``k`` the incremented count and ``lr`` the schedule at the count
  before it; eps outside the sqrt (``torch.optim.Adam`` rounds the bias
  corrections differently);
- RMSProp (``scale_by_rms``): ``nu = (1-decay) g² + decay nu``, then
  ``update = -lr * (rsqrt(nu + eps) * g)``: eps inside the sqrt, no bias
  correction, no momentum (``torch.optim.RMSprop`` adds eps outside).

Params, moments and grads are dicts of tensors keyed like the model's
``state_dict``. ``step_rows`` gives each step's learning rate (and Adam's
bias corrections); ``clip_adam_step``/``clip_rms_step`` apply one step
with them, and the learner kernels (``kernels/sgd.py``,
``kernels/vtrace_sgd.py``) the same step on the card.

``flat=True`` is ``optax.flatten`` of the chain (the trainers'
``flat_optimizer``): the moments are one vector of every parameter, under
the key ``FLAT``, the params in key order, and the global norm is one sum
over it. ``update_fn`` gives the per-step function the plain learner
phases take, flat or not; no learner kernel takes a flat state.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, NamedTuple

import numpy as np
import torch

from .config import ADAM_B1, ADAM_B2, ADAM_EPS

from .models.policy import params_from_flax

Params = dict[str, torch.Tensor]

RMS_DECAY = 0.99  # IMPALA's rmsprop(decay=0.99, eps=0.1), impala.py:216
RMS_EPS = 0.1
FLAT = "flat"  # the one key of a flat optimizer's moments


class AdamState(NamedTuple):
    count: int   # optimizer steps taken (optax's Adam and schedule counts)
    mu: Params
    nu: Params


class RMSState(NamedTuple):
    count: int   # optimizer steps taken (the lr schedule's count)
    nu: Params


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable:
    """``optax.linear_schedule``: count (int tensor) -> float32 value."""
    def schedule(count: torch.Tensor) -> torch.Tensor:
        if transition_steps <= 0:
            return torch.full(count.shape, init_value, dtype=torch.float32,
                              device=count.device)
        c = count.clamp(0, transition_steps).to(torch.float32)
        frac = 1 - c / float(transition_steps)
        return (init_value - end_value) * frac + end_value
    return schedule


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in tree.values()))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    norm = global_norm(grads)
    trigger = norm < max_norm
    return {k: torch.where(trigger, g, (g / norm) * max_norm)
            for k, g in grads.items()}


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}


def clip_adam_step(grads: Params, state: AdamState, lr, bc1, bc2,
                   max_grad_norm: float):
    """One clip + Adam step given this step's learning rate and bias
    corrections (``ClipAdam.step_rows``): ``(updates, new_state)``; add
    the updates with ``apply_updates``."""
    grads = clip_by_global_norm(grads, max_grad_norm)
    mu = {k: (1 - ADAM_B1) * g + ADAM_B1 * state.mu[k]
          for k, g in grads.items()}
    nu = {k: (1 - ADAM_B2) * (g * g) + ADAM_B2 * state.nu[k]
          for k, g in grads.items()}
    updates = {k: -lr * ((mu[k] / bc1) / (torch.sqrt(nu[k] / bc2)
                                          + ADAM_EPS))
               for k in grads}
    return updates, AdamState(state.count + 1, mu, nu)


def clip_rms_step(grads: Params, state: RMSState, lr, max_grad_norm: float,
                  decay: float = RMS_DECAY, eps: float = RMS_EPS):
    """One clip + RMSProp step given this step's learning rate
    (``ClipRMSProp.step_rows``): ``(updates, new_state)``."""
    grads = clip_by_global_norm(grads, max_grad_norm)
    nu = {k: (1 - decay) * (g * g) + decay * state.nu[k]
          for k, g in grads.items()}
    updates = {k: -lr * (torch.rsqrt(nu[k] + eps) * g)
               for k, g in grads.items()}
    return updates, RMSState(state.count + 1, nu)


def flatten(tree: Params) -> Params:
    """``{FLAT: every leaf of tree raveled and joined in key order}``."""
    return {FLAT: torch.cat([tree[k].reshape(-1) for k in sorted(tree)])}


def unflatten(flat: torch.Tensor, like: Params) -> Params:
    """Inverse of ``flatten``: views of ``flat`` with ``like``'s keys and
    shapes."""
    out, off = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[off:off + n].view(like[k].shape)
        off += n
    return {k: out[k] for k in like}


def _flat_step(step: Callable) -> Callable:
    """``optax.flatten``: ``step`` on the flattened grads, its updates
    back in the grads' keys and shapes."""
    def fn(grads: Params, state):
        updates, state = step(flatten(grads), state)
        return unflatten(updates[FLAT], grads), state
    return fn


def adam_update_fn(rows, count0: int, max_grad_norm: float) -> Callable:
    """``(grads, state) -> (updates, state)``: one clip + Adam step with
    the rows ``(lr, bc1, bc2)`` (``ClipAdam.step_rows(count0, n)``) of step
    ``state.count - count0``."""
    def step(grads, state):
        s = state.count - count0
        return clip_adam_step(grads, state, rows[0][s], rows[1][s],
                              rows[2][s], max_grad_norm)
    return step


def rms_update_fn(rows, count0: int, max_grad_norm: float) -> Callable:
    """``(grads, state) -> (updates, state)``: one clip + RMSProp step
    with the lr row (``ClipRMSProp.step_rows(count0, n)``) of step
    ``state.count - count0``."""
    def step(grads, state):
        return clip_rms_step(grads, state, rows[0][state.count - count0],
                             max_grad_norm)
    return step


def _lr_row(learning_rate, count: torch.Tensor) -> torch.Tensor:
    if callable(learning_rate):
        return learning_rate(count)
    return torch.full(count.shape, learning_rate, dtype=torch.float32,
                      device=count.device)


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(clip_by_global_norm, adam)``: its state and the
    per-step scalars that ``clip_adam_step`` and the learner kernels
    take."""
    learning_rate: float | Callable
    max_grad_norm: float
    flat: bool = False

    def init(self, params: Params) -> AdamState:
        if self.flat:
            params = flatten(params)
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def update_fn(self, rows, count0: int) -> Callable:
        """``adam_update_fn``, over the flat vector with ``flat``."""
        step = adam_update_fn(rows, count0, self.max_grad_norm)
        return _flat_step(step) if self.flat else step

    def step_rows(self, count0: int, n: int, device=None):
        """``(lr, 1 - b1^k, 1 - b2^k)`` float32 ``[n]`` for the n steps
        from count ``count0``: the schedule at each pre-increment count,
        the bias corrections at the incremented one (``ppo.py:678-686``)."""
        count = count0 + torch.arange(n, device=device)
        k = (count + 1).to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=device)
        return (_lr_row(self.learning_rate, count),
                1 - (one * ADAM_B1) ** k, 1 - (one * ADAM_B2) ** k)


@dataclasses.dataclass(frozen=True)
class ClipRMSProp:
    """``optax.chain(clip_by_global_norm, rmsprop(lr, decay, eps))``: its
    state and the per-step learning rates that ``clip_rms_step`` and the
    IMPALA learner kernel take."""
    learning_rate: float | Callable
    max_grad_norm: float
    flat: bool = False

    def init(self, params: Params) -> RMSState:
        if self.flat:
            params = flatten(params)
        return RMSState(0, {k: torch.zeros_like(p) for k, p in params.items()})

    def update_fn(self, rows, count0: int) -> Callable:
        """``rms_update_fn``, over the flat vector with ``flat``."""
        step = rms_update_fn(rows, count0, self.max_grad_norm)
        return _flat_step(step) if self.flat else step

    def step_rows(self, count0: int, n: int, device=None):
        """``(lr,)``: float32 ``[n]``, the schedule at each pre-increment
        count from ``count0`` (``impala.py:499-506``)."""
        return (_lr_row(self.learning_rate,
                        count0 + torch.arange(n, device=device)),)


def _learning_rate(tcfg, steps_per_update: int):
    if tcfg.anneal_lr:
        return linear_schedule(tcfg.learning_rate, 0.0,
                               tcfg.num_updates * steps_per_update)
    return tcfg.learning_rate


def make_optimizer(tcfg) -> ClipAdam:
    """The PPO trainer's optimizer for a ``TrainConfig``
    (``ppo.py:323-335``), flat with ``flat_optimizer``."""
    return ClipAdam(_learning_rate(
        tcfg, tcfg.ppo_epochs * tcfg.num_minibatches), tcfg.max_grad_norm,
        tcfg.flat_optimizer)


def make_impala_optimizer(tcfg) -> ClipRMSProp | ClipAdam:
    """The IMPALA trainer's optimizer (``impala.py:192-221``): RMSProp, or
    Adam with ``impala_rmsprop=False``; lr annealed over ``num_updates *
    impala_passes * num_minibatches`` steps; flat with ``flat_optimizer``.
    RMSProp logs the JAX trainer's build-time warning."""
    lr = _learning_rate(tcfg, tcfg.impala_passes * tcfg.num_minibatches)
    if not tcfg.impala_rmsprop:
        return ClipAdam(lr, tcfg.max_grad_norm, tcfg.flat_optimizer)
    logging.getLogger("warehouse_tpu_torch").warning(
        "IMPALA is using its canonical RMSProp (eps=0.1): measured flat at "
        "few-hundred-update horizons on this env "
        "(runs/r4_curves/config4_impala_fused.jsonl) — pass --impala-adam / "
        "impala_rmsprop=False unless you are running the paper's "
        "long-horizon budget")
    return ClipRMSProp(lr, tcfg.max_grad_norm, tcfg.flat_optimizer)


def _unravel_flax(vec: np.ndarray, like) -> dict:
    """``jax.flatten_util.ravel_pytree``'s vector back in the nested dict
    ``like``'s structure: its leaves in jax's order, dict keys sorted."""
    off = 0

    def walk(node):
        nonlocal off
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        shape = np.shape(node)
        n = int(np.prod(shape))
        off += n
        return vec[off - n:off].reshape(shape)

    out = walk(like)
    if off != vec.size:
        raise ValueError(f"a flat optimizer state of {vec.size} floats does "
                         f"not fit params of {off}")
    return out


def opt_state_from_optax(opt_state_np, device=None,
                         default_count: int = 0,
                         params_like=None) -> AdamState | RMSState:
    """A JAX ``optax.chain(clip_by_global_norm, adam(...) | rmsprop(...))``
    state, its leaves as numpy, as an ``AdamState`` or ``RMSState``: the
    count from the ``ScaleByAdamState`` or the lr schedule's state
    (checked against each other where both exist; ``default_count`` for a
    constant-lr RMSProp, which keeps none; an ``inject_hyperparams`` state's
    count is checked too, its hyperparameters left to the caller), the
    moments through
    ``params_from_flax``. A state of ``optax.flatten`` of the chain holds
    each moment as one vector in the flax params' leaf order: it takes the
    flax params ``params_like`` (numpy leaves) for that order and becomes a
    flat state (``FLAT``) in the port's order."""
    adam, rms, counts = [], [], []

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None and {"count", "mu", "nu"} <= set(fields):
            adam.append(node)
        elif fields == ("nu",):
            rms.append(node)
        elif fields == ("count",):
            counts.append(int(np.asarray(node.count)))
        elif fields is not None and {"count", "hyperparams",
                                     "inner_state"} <= set(fields):
            # optax.inject_hyperparams (PBT's runtime learning rate): its
            # count beside the inner Adam's.
            counts.append(int(np.asarray(node.count)))
            walk(node.inner_state)
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(opt_state_np)
    if len(adam) + len(rms) != 1:
        raise ValueError(f"expected one Adam or RMSProp state, found "
                         f"{len(adam)} and {len(rms)}: the port carries "
                         "clip_by_global_norm + adam or rmsprop only")
    if adam:
        count = int(np.asarray(adam[0].count))
    else:
        count = counts[0] if counts else default_count
    if any(c != count for c in counts):
        raise ValueError(f"schedule counts {counts} differ from the "
                         f"optimizer count {count}")

    def moments(tree):
        if isinstance(tree, dict):
            return {k: v.to(device) for k, v in params_from_flax(tree).items()}
        if params_like is None:
            raise ValueError("a flat optimizer state needs the params it "
                             "flattened (params_like)")
        tree = _unravel_flax(np.asarray(tree), params_like)
        return {k: v.to(device)
                for k, v in flatten(params_from_flax(tree)).items()}

    if rms:
        return RMSState(count, moments(rms[0].nu))
    return AdamState(count, moments(adam[0].mu), moments(adam[0].nu))

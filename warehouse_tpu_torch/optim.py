"""The PPO trainer's optimizer, written out as optax computes it.

Counterpart of the chain at ``warehouse_tpu/train/ppo.py:323-335``:
``optax.chain(clip_by_global_norm(max_grad_norm), adam(lr, ADAM_B1,
ADAM_B2, ADAM_EPS))`` with ``lr`` a ``linear_schedule`` over
``num_updates * ppo_epochs * num_minibatches`` steps or a constant. Each
formula is optax's, in its op order:

- clip: ``where(norm < max, g, (g / norm) * max)``, no epsilon (torch's
  ``clip_grad_norm_`` adds 1e-6 and scales by a clamped ratio instead);
- Adam: ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g² + b2 nu``, then
  ``update = -lr * (mu / (1 - b1^k)) / (sqrt(nu / (1 - b2^k)) + eps)``
  with ``k`` the incremented count and ``lr`` the schedule at the count
  before it; eps outside the sqrt (``torch.optim.Adam`` rounds the bias
  corrections differently).

Params, moments and grads are dicts of tensors keyed like the model's
``state_dict``. ``ClipAdam.step_rows`` gives each step's learning rate
and bias corrections; ``clip_adam_step`` applies one step with them, and
the SGD-phase kernel (``kernels/sgd.py``) the same step on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch

from warehouse_tpu.config import ADAM_B1, ADAM_B2, ADAM_EPS

from .models.policy import params_from_flax

Params = dict[str, torch.Tensor]


class AdamState(NamedTuple):
    count: int   # optimizer steps taken (optax's Adam and schedule counts)
    mu: Params
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


@dataclasses.dataclass(frozen=True)
class ClipAdam:
    """``optax.chain(clip_by_global_norm, adam)``: its state and the
    per-step scalars that ``clip_adam_step`` and the SGD kernel take."""
    learning_rate: float | Callable
    max_grad_norm: float

    def init(self, params: Params) -> AdamState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def step_rows(self, count0: int, n: int, device=None):
        """``(lr, 1 - b1^k, 1 - b2^k)`` float32 ``[n]`` for the n steps
        from count ``count0``: the schedule at each pre-increment count,
        the bias corrections at the incremented one (``ppo.py:678-686``)."""
        count = count0 + torch.arange(n, device=device)
        if callable(self.learning_rate):
            lr = self.learning_rate(count)
        else:
            lr = torch.full((n,), self.learning_rate, dtype=torch.float32,
                            device=device)
        k = (count + 1).to(torch.float32)
        one = torch.ones((), dtype=torch.float32, device=device)
        return lr, 1 - (one * ADAM_B1) ** k, 1 - (one * ADAM_B2) ** k


def make_optimizer(tcfg) -> ClipAdam:
    """The trainer's optimizer for a ``TrainConfig`` (``ppo.py:323-335``)."""
    if tcfg.anneal_lr:
        total = tcfg.num_updates * tcfg.ppo_epochs * tcfg.num_minibatches
        lr = linear_schedule(tcfg.learning_rate, 0.0, total)
    else:
        lr = tcfg.learning_rate
    return ClipAdam(lr, tcfg.max_grad_norm)


def opt_state_from_optax(opt_state_np, device=None) -> AdamState:
    """A JAX ``optax.chain(clip_by_global_norm, adam(...))`` state, its
    leaves as numpy, as an ``AdamState``: the count from the
    ``ScaleByAdamState`` (checked against the schedule's count where there
    is one), ``mu``/``nu`` through ``params_from_flax``."""
    adam, counts = [], []

    def walk(node):
        fields = getattr(node, "_fields", None)
        if fields is not None and {"count", "mu", "nu"} <= set(fields):
            adam.append(node)
        elif fields == ("count",):
            counts.append(int(np.asarray(node.count)))
        elif isinstance(node, tuple):
            for child in node:
                walk(child)

    walk(opt_state_np)
    if len(adam) != 1:
        raise ValueError(f"expected one Adam state, found {len(adam)}: the "
                         "port carries clip_by_global_norm + adam only")
    count = int(np.asarray(adam[0].count))
    if any(c != count for c in counts):
        raise ValueError(f"schedule counts {counts} differ from the Adam "
                         f"count {count}")

    def moments(tree):
        return {k: v.to(device) for k, v in params_from_flax(tree).items()}

    return AdamState(count, moments(adam[0].mu), moments(adam[0].nu))

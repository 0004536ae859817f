"""PPO update machinery (counterpart of ``warehouse_tpu/ops/ppo_update.py``).

The sampler of the acting phase, the clipped-surrogate loss, the entropy
and KL schedules, and the epoch/minibatch scaffold of the SGD phase: the
plain twin of the learner kernels (``kernels/sgd.py``) and, with a
per-epoch partition (``epoch_shuffle="each"``) or micro-batches, the plain
learner phase that runs where no kernel takes the options (ROADMAP M-4).
``partition_keys`` ports the scaffold's key splits and
``flat_minibatches`` / ``env_major_minibatches`` its two layouts.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from .. import rng as _rng
from ..optim import apply_updates

NEG_INF = -1e9  # logits floor for masked (invalid) actions


def first_argmax(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Index of the first maximum along ``dim`` (the ``jnp.argmax`` tie
    rule, written out: ``torch.argmax`` does not promise it on CUDA)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    idx = torch.arange(n, device=x.device).reshape(
        (n,) + (1,) * (x.dim() - dim - 1))
    best = x.amax(dim, keepdim=True)
    return torch.where(x == best, idx, n).amin(dim)


def sample_action_with_gumbel(logits: torch.Tensor, g: torch.Tensor):
    """Categorical sample and its log-prob from logits ``[..., n_act]`` and
    gumbel noise ``g [n_act, N]`` laid out on the transpose, as the JAX
    sampler draws it. Returns ``(action int32[...], log_prob f32[...])``."""
    n_act = logits.shape[-1]
    lt = logits.reshape(-1, n_act).T                     # [n_act, N]
    action = first_argmax(lt + g, 0)
    logp = torch.log_softmax(lt, dim=0)
    lp = torch.gather(logp, 0, action[None])[0]
    shape = logits.shape[:-1]
    return action.to(torch.int32).reshape(shape), lp.reshape(shape)


def sample_action(key: torch.Tensor, logits: torch.Tensor):
    """``sample_action(key, logits)`` of the JAX package: gumbel drawn on
    the ``[n_act, N]`` transpose, so it is the stream the act kernel
    consumes."""
    n_act = logits.shape[-1]
    g = _rng.gumbel(key, (n_act, logits.numel() // n_act))
    return sample_action_with_gumbel(logits, g)


def action_log_prob_entropy(logits: torch.Tensor, action: torch.Tensor):
    """``(log π(a|s)`` with the action's shape, mean entropy) from logits
    ``[..., n_act]``."""
    logp = torch.log_softmax(logits, dim=-1)
    lp = torch.gather(logp, -1, action.long()[..., None])[..., 0]
    entropy = -(torch.exp(logp) * logp).sum(-1).mean()
    return lp, entropy


def ppo_losses(logits, value, action, old_log_prob, old_value, advantages,
               targets, *, clip_eps: float, value_coef: float, ent_coef,
               kl_coeff, normalize_adv: bool = True):
    """Clipped-surrogate PPO loss with the clipped value loss, the entropy
    bonus and the RLlib-style KL penalty; ``logits`` are post-mask.

    Returns ``(total, (pg_loss, v_loss, entropy, kl))``. With
    ``normalize_adv`` the advantages are normalized over the given batch
    (population std, as ``jnp.std``); without, they arrive normalized.
    ``torch.minimum``/``maximum`` split the gradient of a tie 0.5/0.5 and
    ``clamp`` passes it at the bounds, as ``jax.grad`` does.
    """
    lp, entropy = action_log_prob_entropy(logits, action)
    ratio = torch.exp(lp - old_log_prob)
    if normalize_adv:
        adv_n = (advantages - advantages.mean()) / (
            advantages.std(correction=0) + 1e-8)
    else:
        adv_n = advantages
    pg1 = ratio * adv_n
    pg2 = torch.clamp(ratio, 1 - clip_eps, 1 + clip_eps) * adv_n
    pg_loss = -torch.minimum(pg1, pg2).mean()
    v_clip = old_value + torch.clamp(value - old_value, -clip_eps, clip_eps)
    v_loss = 0.5 * torch.maximum((value - targets) ** 2,
                                 (v_clip - targets) ** 2).mean()
    kl = (old_log_prob - lp).mean()
    total = pg_loss + value_coef * v_loss - ent_coef * entropy + kl_coeff * kl
    return total, (pg_loss, v_loss, entropy, kl)


def entropy_coef_at(tcfg, update_idx: torch.Tensor) -> torch.Tensor:
    """Linear entropy-coefficient anneal (``entropy_coef_final`` < 0:
    constant)."""
    if tcfg.entropy_coef_final >= 0.0:
        frac = update_idx.to(torch.float32) / max(tcfg.num_updates, 1)
        return tcfg.entropy_coef + frac * (tcfg.entropy_coef_final
                                           - tcfg.entropy_coef)
    return torch.tensor(tcfg.entropy_coef, dtype=torch.float32,
                        device=update_idx.device)


def adaptive_kl_coeff(tcfg, kl_coeff: torch.Tensor,
                      mean_kl: torch.Tensor) -> torch.Tensor:
    """RLlib's adaptive KL rule: x1.5 above 2x target, x0.5 below 0.5x;
    the identity when the penalty is off."""
    if tcfg.kl_coeff > 0.0 and tcfg.adaptive_kl:
        return torch.where(
            mean_kl > 2.0 * tcfg.kl_target, kl_coeff * 1.5,
            torch.where(mean_kl < 0.5 * tcfg.kl_target, kl_coeff * 0.5,
                        kl_coeff))
    return kl_coeff


def partition_keys(key: torch.Tensor, num_epochs: int,
                   reshuffle_each_epoch: bool):
    """The key splits of the JAX scaffold (``ops/ppo_update.py:199-216``):
    ``key, pkey = split(key)`` once for ``epoch_shuffle="once"``, once per
    epoch for ``"each"``. Returns ``(key, [pkey, ...])``."""
    pkeys = []
    for _ in range(num_epochs if reshuffle_each_epoch else 1):
        key, pkey = _rng.split(key, 2)
        pkeys.append(pkey)
    return key, pkeys


def flat_minibatches(key: torch.Tensor, batch: Sequence, num_minibatches: int):
    """``flat_minibatches`` of the JAX package: the ``[N, ...]`` fields of
    ``batch`` shuffled by ``permutation(key, N)`` and cut into
    ``num_minibatches`` equal minibatches (tuples)."""
    n = batch[0].shape[0]
    perm = _rng.permutation(key, n)
    w = n // num_minibatches
    return [tuple(x[perm[m * w:(m + 1) * w]] for x in batch)
            for m in range(num_minibatches)]


def env_major_minibatches(key, batch: Sequence, num_minibatches: int):
    """The env-mode layout of the JAX XLA learner (``train/ppo.py:527-552``):
    fields ``[B, T*A, ...]`` (env-major), the env axis shuffled by
    ``permutation(key, B)`` (``key`` None: contiguous env ranges, the
    state-shuffled cadence), each minibatch ``B/M`` envs flattened to
    ``[B/M * T*A, ...]``."""
    B = batch[0].shape[0]
    w = B // num_minibatches
    perm = None if key is None else _rng.permutation(key, B)
    out = []
    for m in range(num_minibatches):
        idx = slice(m * w, (m + 1) * w) if perm is None else perm[
            m * w:(m + 1) * w]
        out.append(tuple(x[idx].reshape(-1, *x.shape[2:]) for x in batch))
    return out


def split_leading(mb: Sequence, k: int) -> list:
    """A minibatch of ``[n, ...]`` fields as ``k`` micro-batches of
    ``n/k`` consecutive samples (the JAX scaffold's micro reshape)."""
    return [tuple(x.reshape(k, x.shape[0] // k, *x.shape[1:])[j] for x in mb)
            for j in range(k)]


def _value_and_grad(loss_fn: Callable, params, mb):
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, aux = loss_fn(leaves, mb)
    grads = dict(zip(leaves, torch.autograd.grad(total,
                                                 list(leaves.values()))))
    return [total.detach(), *(a.detach() for a in aux)], grads


def minibatch_epochs(params, opt_state, *, loss_fn: Callable,
                     minibatches: Sequence | Callable, num_epochs: int,
                     update_fn: Callable, micro_batches: int = 1,
                     split_micro: Callable = split_leading, mesh=None):
    """The PPO epoch/minibatch SGD loop.

    ``loss_fn(params, minibatch) -> (total, aux)``; ``update_fn(grads,
    opt_state) -> (updates, opt_state)`` (``optim.ClipAdam.update_fn``).
    ``minibatches`` is one partition that every epoch visits in order, or
    a function ``epoch -> partition`` (the per-epoch reshuffle); one
    optimizer step per minibatch. With ``micro_batches = k > 1`` a
    minibatch's gradient is the mean of its k micro-batches' gradients
    (``split_micro(mb, k)``), summed in order and divided by k, and its
    losses the means of theirs (``ops/ppo_update.py:220-240``). Returns
    ``(params, opt_state, losses)``, ``losses`` the tuple ``(total,
    *aux)`` of ``[num_epochs, M]`` tensors. IMPALA's passes over its fixed
    env minibatches run through it too. The JAX scaffold's key splits are
    the caller's (``partition_keys``). With ``mesh`` (a
    ``parallel.mesh.DataMesh``) each step's gradient and loss row are
    averaged over its ranks before the step, where the JAX scaffold
    ``pmean``s them over ``pmean_axis`` (:241-244).
    """
    rows = []
    for epoch in range(num_epochs):
        part = minibatches(epoch) if callable(minibatches) else minibatches
        for mb in part:
            if micro_batches == 1:
                row, grads = _value_and_grad(loss_fn, params, mb)
            else:
                micro = [_value_and_grad(loss_fn, params, mi)
                         for mi in split_micro(mb, micro_batches)]
                grads = micro[0][1]
                for _, g in micro[1:]:
                    grads = {k: v + g[k] for k, v in grads.items()}
                grads = {k: v / micro_batches for k, v in grads.items()}
                row = [torch.stack(col).mean()
                       for col in zip(*(r for r, _ in micro))]
            if mesh is not None:
                grads, row = mesh.mean_grads(grads, row)
            with torch.no_grad():
                updates, opt_state = update_fn(grads, opt_state)
                params = apply_updates(params, updates)
            rows.append(row)
    losses = tuple(torch.stack([r[i] for r in rows]).reshape(num_epochs, -1)
                   for i in range(len(rows[0])))
    return params, opt_state, losses

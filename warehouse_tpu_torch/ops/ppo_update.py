"""PPO acting-side ops (counterpart of ``warehouse_tpu/ops/ppo_update.py``).

Only ``sample_action`` is ported so far; the loss and the epoch scan come
with the PPO trainer.
"""

from __future__ import annotations

import torch

from .. import rng as _rng


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

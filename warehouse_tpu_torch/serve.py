"""Policy serving (counterpart of ``warehouse_tpu/serve.py`` ``Policy``).

``compute_actions`` maps observations ``[B, A, obs_dim]`` to int32
actions ``[B, A]`` through the MLP, the CNN or the recurrent (GRU / LSTM)
policy:
argmax by default, or a categorical sample (``explore=True``) on the same
key chain as the JAX ``Policy``. A recurrent policy threads its carry:
``initial_state`` (alias ``get_initial_state``) gives the zero carry and
``compute_actions(obs, carry)`` returns ``(actions, new_carry)``. The
policy runs on its model's device. Loading from a checkpoint waits for
the checkpoint port.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import EnvConfig

from . import rng as _rng
from .models.policy import ActorCriticCNN, ActorCriticMLP, ActorCriticRNN
from .ops.move import valid_action_mask
from .ops.ppo_update import first_argmax

NEG_INF = -1e9  # logits floor for masked actions


class Policy:
    """A policy ready for inference on its model's device."""

    def __init__(self, env_cfg: EnvConfig,
                 model: ActorCriticMLP | ActorCriticCNN | ActorCriticRNN,
                 arch: str | None = None, mask_actions: bool = False,
                 policy_groups: tuple | None = None):
        recurrent = isinstance(model, ActorCriticRNN)
        own = (model.cell_type if recurrent
               else "cnn" if isinstance(model, ActorCriticCNN) else "mlp")
        arch = arch or own
        if arch not in ("mlp", "cnn", "gru", "lstm") or (
                policy_groups is not None):
            raise NotImplementedError(
                "only a shared MLP, CNN, GRU or LSTM policy is ported for "
                "serving")
        if arch != own:
            raise ValueError(f"arch={arch!r} does not fit the model")
        self.env_cfg = env_cfg
        self.model = model
        self.arch = arch
        self.recurrent = recurrent
        self.mask_actions = mask_actions
        self.device = next(model.parameters()).device
        self._key = _rng.prng_key(0, self.device)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, step: int | None = None):
        raise NotImplementedError("checkpoints are not ported yet")

    def initial_state(self, batch_size: int = 1):
        """The zero carry of a recurrent policy for ``batch_size`` envs
        (``[B, A, H]``, the LSTM's ``(c, h)``); None for the MLP and the
        CNN."""
        if not self.recurrent:
            return None
        return self.model.initial_carry((batch_size,
                                         self.env_cfg.num_agents))

    get_initial_state = initial_state

    def compute_actions(self, obs, state=None, explore: bool = False,
                        seed: int | None = None, agent_pos=None):
        """obs float32[B, A, obs_dim] (or [A, obs_dim]) -> (int32[B, A]
        actions, next carry); the carry is None for the MLP and the CNN,
        and a recurrent policy starts from ``initial_state`` when given
        none."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        if obs.dim() == 2:
            pos = None if agent_pos is None else (
                torch.as_tensor(agent_pos)[None])
            acts, carry = self.compute_actions(obs[None], state, explore,
                                               seed, pos)
            return acts[0], carry
        if seed is not None:
            self._key = _rng.prng_key(seed, self.device)
        k = _rng.split(self._key, 2)
        self._key, key = k[0], k[1]
        if self.recurrent and state is None:
            state = self.initial_state(obs.shape[0])
        with torch.no_grad():
            if self.recurrent:
                logits, _, state = self.model(obs, state)
            else:
                logits, _ = self.model(obs)
        if self.mask_actions and agent_pos is not None:
            pos = torch.as_tensor(agent_pos, dtype=torch.int32,
                                  device=self.device)
            logits = torch.where(valid_action_mask(self.env_cfg, pos),
                                 logits, NEG_INF)
        if explore:  # jax.random.categorical: argmax(logits + gumbel)
            logits = logits + _rng.gumbel(key, tuple(logits.shape))
        return first_argmax(logits, -1).to(torch.int32), state

    def compute_single_action(self, obs, state=None, explore: bool = False,
                              seed: int | None = None, agent_pos=None):
        """One env's obs [A, obs_dim] -> int actions [A] (+ carry)."""
        actions, carry = self.compute_actions(obs, state, explore, seed,
                                              agent_pos)
        return np.asarray(actions.cpu()), carry

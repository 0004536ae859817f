"""Policy serving (counterpart of ``warehouse_tpu/serve.py``):
self-describing checkpoints and the inference API.

The train CLI drops a ``policy_meta.json`` next to the checkpoint files
(``write_policy_meta``), so ``Policy.from_checkpoint(dir)`` rebuilds the
env config and the model without any flag given again.

``compute_actions`` maps observations ``[B, A, obs_dim]`` to int32
actions ``[B, A]`` through the MLP, the CNN, the attention torso or the
recurrent (GRU / LSTM) policy:
argmax by default, or a categorical sample (``explore=True``) on the same
key chain as the JAX ``Policy``. A recurrent policy threads its carry:
``initial_state`` (alias ``get_initial_state``) gives the zero carry and
``compute_actions(obs, carry)`` returns ``(actions, new_carry)``;
``compute_actions_dict`` serves the dict-API wrapper
(``env/wrapper.py``), one agent's action per key. With
``policy_groups`` the model is a ``MultiPolicyActorCritic`` of
feed-forward policies and agent a acts through group ``policy_groups[a]``'s. The
policy runs on its model's device and at its compute dtype: a checkpoint of
a ``--model-dtype bfloat16`` run serves the bf16 model, whose recurrent
carry is bf16.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .config import EnvConfig, TrainConfig

from . import rng as _rng
from .models.policy import (FEED_FORWARD, ActorCriticAttn, ActorCriticCNN,
                            ActorCriticMLP, ActorCriticRNN,
                            MultiPolicyActorCritic)
from .ops.move import valid_action_mask
from .ops.ppo_update import first_argmax

NEG_INF = -1e9  # logits floor for masked actions
META_NAME = "policy_meta.json"


def write_policy_meta(checkpoint_dir: str, env_cfg: EnvConfig,
                      tcfg: TrainConfig, arch: str = "mlp",
                      policy_groups: tuple | None = None) -> str:
    """Write the serving metadata the train CLI knows at save time, with
    the JAX package's keys; returns the file's path."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    meta = {
        "env_config": json.loads(env_cfg.to_json()),
        "arch": arch,
        "hidden_dim": tcfg.hidden_dim,
        "num_layers": tcfg.num_layers,
        "model_dtype": tcfg.model_dtype,
        "mask_actions": tcfg.mask_actions,
        "policy_groups": (
            list(policy_groups) if policy_groups is not None else None),
    }
    path = os.path.join(checkpoint_dir, META_NAME)
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    return path


class Policy:
    """A policy ready for inference on its model's device."""

    def __init__(self, env_cfg: EnvConfig,
                 model: ActorCriticMLP | ActorCriticCNN | ActorCriticAttn
                 | ActorCriticRNN | MultiPolicyActorCritic,
                 arch: str | None = None, mask_actions: bool = False,
                 policy_groups: tuple | None = None):
        multi = isinstance(model, MultiPolicyActorCritic)
        if multi != (policy_groups is not None) or multi and (
                len(policy_groups) != env_cfg.num_agents
                or sorted(set(policy_groups)) != list(
                    range(len(model.policies)))):
            raise ValueError(
                f"a {type(model).__name__} does not fit policy_groups="
                f"{policy_groups} on {env_cfg.num_agents} agents")
        sub = model.policies[0] if multi else model
        recurrent = isinstance(sub, ActorCriticRNN)
        own = (sub.cell_type if recurrent
               else "cnn" if isinstance(sub, ActorCriticCNN)
               else "attn" if isinstance(sub, ActorCriticAttn) else "mlp")
        arch = arch or own
        if arch not in (*FEED_FORWARD, "gru", "lstm") or (
                multi and arch not in FEED_FORWARD):
            raise ValueError(
                f"arch={arch!r}: serving takes an MLP, CNN, attention, GRU "
                "or LSTM policy, or policy groups of feed-forward ones")
        if arch != own or multi and any(
                type(m) is not type(sub) for m in model.policies):
            raise ValueError(f"arch={arch!r} does not fit the model")
        self.env_cfg = env_cfg
        self.model = model
        self.arch = arch
        self.recurrent = recurrent
        self.mask_actions = mask_actions
        self.policy_groups = (None if policy_groups is None
                              else tuple(int(g) for g in policy_groups))
        self.device = next(model.parameters()).device
        self._key = _rng.prng_key(0, self.device)

    @classmethod
    def from_checkpoint(cls, checkpoint_dir: str, step: int | None = None,
                        device=None) -> "Policy":
        """Rebuild the model and load the params of ``step`` (the latest
        without it) from a self-describing checkpoint directory, on the
        card unless ``device="cpu"``."""
        from .device import resolve_device
        from .models import make_model, make_multi_policy_model
        from .train.checkpoint import restore_params

        device = resolve_device(device)
        meta_path = os.path.join(checkpoint_dir, META_NAME)
        if not os.path.exists(meta_path):
            raise FileNotFoundError(
                f"{meta_path} not found: the checkpoint has no serving "
                "metadata; rebuild the model and use Policy(...)")
        with open(meta_path) as f:
            meta = json.load(f)
        env_cfg = EnvConfig.from_dict(meta["env_config"])
        groups = meta.get("policy_groups")
        # A bf16 run's meta builds the bf16 model (JAX serve.py:144-147).
        widths = dict(arch=meta["arch"], hidden_dim=meta["hidden_dim"],
                      num_layers=meta["num_layers"], device=device,
                      dtype=meta.get("model_dtype", "float32"))
        if groups is not None:
            groups = tuple(int(g) for g in groups)
            model = make_multi_policy_model(env_cfg, groups, **widths)
        else:
            model = make_model(env_cfg, **widths)
        model.load_state_dict(restore_params(checkpoint_dir, step,
                                             device=device))
        return cls(env_cfg, model, arch=meta["arch"],
                   mask_actions=meta.get("mask_actions", False),
                   policy_groups=groups)

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
        actions, next carry); the carry is None for the feed-forward policies,
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
            elif self.policy_groups is not None:
                logits, _ = self.model(obs, torch.tensor(self.policy_groups))
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

    def compute_actions_dict(self, env, obs_dict: dict, state=None,
                             explore: bool = False, seed: int | None = None):
        """Dict-API serving against a ``WarehouseMultiAgentEnv``:
        ``{agent_i: obs}`` -> ``({agent_i: int action}, next carry)``. A
        mask-trained policy reads the agents' positions from the wrapper's
        state, so its invalid moves are masked."""
        A = self.env_cfg.num_agents
        obs = np.stack([np.asarray(obs_dict[f"agent_{i}"], np.float32)
                        for i in range(A)])
        agent_pos = env.agent_pos() if self.mask_actions else None
        actions, carry = self.compute_single_action(obs, state, explore,
                                                    seed, agent_pos)
        return {f"agent_{i}": int(actions[i]) for i in range(A)}, carry

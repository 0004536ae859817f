"""RLlib/gymnasium-style multi-agent dict API (counterpart of
``warehouse_tpu/env/wrapper.py``, docs/SEMANTICS.md §11).

Dict-in/dict-out ``reset``/``step`` keyed by ``"agent_i"`` strings with
``"__all__"`` in terminated/truncated, over the port's batched engine at
B = 1 on the card (or the CPU with ``device="cpu"``), or with
``backend="oracle"`` over the NumPy oracle (``warehouse_tpu_torch.oracle``,
on the host, its draws from ``TorchDrawSource``). ``reset(seed=s)`` starts
from ``rng.prng_key(s)``, the JAX wrapper's ``PRNGKey(s)``, so the
wrappers and both backends give the same episode bit for bit. gymnasium
is imported only by the spaces.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from ..config import EnvConfig
from ..device import resolve_device

from .. import rng as _rng
from . import engine
from .render import render_ascii
from .state import STATE_FIELDS


class WarehouseMultiAgentEnv:
    """Dict-API adapter. ``backend``: "torch" (the port's engine at B = 1
    on ``device``: the card unless ``device="cpu"``) or "oracle" (the NumPy
    oracle, which steps on the host whatever ``device``; its draws come
    from the port's ``rng`` there)."""

    metadata = {"render_modes": ["ansi", "rgb_array"]}

    def __init__(self, cfg: EnvConfig | None = None, backend: str = "torch",
                 seed: int = 0, device=None) -> None:
        self.cfg = cfg or EnvConfig()
        if backend not in ("torch", "oracle"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = resolve_device(device)
        self._seed = seed
        self._state = None
        self.possible_agents = [
            f"agent_{i}" for i in range(self.cfg.num_agents)
        ]
        self.agents = list(self.possible_agents)

    # ------------------------------------------------------------ spaces
    # lru_cache: consumers (pettingzoo API test) require the SAME space
    # object per agent across calls.
    @functools.lru_cache(maxsize=None)
    def observation_space(self, agent: str):
        import gymnasium as gym

        return gym.spaces.Box(-np.inf, np.inf, (self.cfg.obs_dim,),
                              np.float32)

    @functools.lru_cache(maxsize=None)
    def action_space(self, agent: str):
        import gymnasium as gym

        return gym.spaces.Discrete(self.cfg.num_actions)

    # --------------------------------------------------------------- api
    def reset(self, seed: int | None = None, options: Any = None):
        """A fresh episode from ``PRNGKey(seed)`` (the last seed without
        one). ``options={"key": k}`` starts from the threefry key words
        ``k`` (``[2]``, e.g. a ``rng.fold_in`` of one) instead."""
        if seed is not None:
            self._seed = seed
        key = (options or {}).get("key")
        if key is None:
            key = _rng.prng_key(self._seed, self.device)
        key = torch.as_tensor(key, dtype=torch.int64, device=self.device)
        if self.backend == "oracle":
            from ..oracle import OracleEnv, TorchDrawSource

            self._env = OracleEnv(self.cfg, TorchDrawSource(key))
            obs = self._env.reset()
        else:
            self._state, obs = engine.reset(self.cfg, key.reshape(1, 2))
            obs = obs[0].cpu().numpy()
        self.agents = list(self.possible_agents)
        return (self._obs_dict(obs),
                {a: {} for a in self.possible_agents})

    def step(self, action_dict: dict[str, int]):
        actions = np.zeros(self.cfg.num_agents, dtype=np.int32)
        for i, a in enumerate(self.possible_agents):
            act = int(action_dict.get(a, 0))
            if not 0 <= act < self.cfg.num_actions:
                raise ValueError(
                    f"invalid action {act} for {a}; expected 0..4"
                )
            actions[i] = act
        if self.backend == "oracle":
            obs, rew, term, trunc, info = self._env.step(actions)
        else:
            self._state, ts = engine.step(
                self.cfg, self._state,
                torch.from_numpy(actions).to(self.device)[None])
            obs = ts.obs[0].cpu().numpy()
            rew = ts.reward[0].cpu().numpy()
            term, trunc = bool(ts.terminated[0]), bool(ts.truncated[0])
            info = {
                "picked": ts.picked[0].cpu().numpy(),
                "delivered": ts.delivered[0].cpu().numpy(),
                "collided": ts.collided[0].cpu().numpy(),
            }
        obs_d = self._obs_dict(obs)
        rew_d = {a: float(rew[i]) for i, a in enumerate(self.possible_agents)}
        term_d = {a: bool(term) for a in self.possible_agents}
        term_d["__all__"] = bool(term)
        trunc_d = {a: bool(trunc) for a in self.possible_agents}
        trunc_d["__all__"] = bool(trunc)
        info_d = {
            a: {k: bool(v[i]) for k, v in info.items()}
            for i, a in enumerate(self.possible_agents)
        }
        if trunc:
            self.agents = []
        return obs_d, rew_d, term_d, trunc_d, info_d

    def render(self, mode: str = "ansi"):
        """mode "ansi" → str; "rgb_array" → uint8[H·px, W·px, 3]."""
        state = self.numpy_state()
        if mode == "rgb_array":
            from .render import render_rgb

            return render_rgb(self.cfg, state)
        return render_ascii(self.cfg, state)

    # ----------------------------------------------------------- helpers
    @property
    def state(self):
        """The engine's state, a batch of one env (``EnvState`` fields
        ``[1, ...]`` on the wrapper's device); the oracle's ``OracleState``
        with the "oracle" backend, as the JAX wrapper gives it."""
        return self._env.state if self.backend == "oracle" else self._state

    def agent_pos(self):
        """The agents' cells ``[A, 2]`` (a tensor on the wrapper's device,
        or the oracle's array)."""
        return self.state.agent_pos if self.backend == "oracle" else (
            self._state.agent_pos[0])

    def numpy_state(self) -> SimpleNamespace:
        """The one env's state fields as NumPy arrays (no env axis); the
        oracle's key is its draw source's."""
        if self.backend == "oracle":
            st = self._env.state
            fields = {f: np.asarray(getattr(st, f)) for f in STATE_FIELDS
                      if f != "key"}
            fields["key"] = self._env.draws.key.numpy()
            return SimpleNamespace(**fields)
        return SimpleNamespace(**{f: getattr(self._state, f)[0].cpu().numpy()
                                  for f in STATE_FIELDS})

    def _obs_dict(self, obs: np.ndarray) -> dict[str, np.ndarray]:
        return {
            a: np.asarray(obs[i], dtype=np.float32)
            for i, a in enumerate(self.possible_agents)
        }

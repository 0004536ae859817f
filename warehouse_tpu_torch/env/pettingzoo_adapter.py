"""PettingZoo ParallelEnv adapter (counterpart of
``warehouse_tpu/env/pettingzoo_adapter.py``): a thin shim over
``WarehouseMultiAgentEnv``. pettingzoo is optional: without it the class
derives from ``object``.
"""

from __future__ import annotations

from typing import Any

from ..config import EnvConfig
from .wrapper import WarehouseMultiAgentEnv

try:
    from pettingzoo import ParallelEnv as _ParallelEnv
except Exception:  # pragma: no cover - pettingzoo optional
    _ParallelEnv = object


class WarehouseParallelEnv(_ParallelEnv):
    """PettingZoo ParallelEnv over the port's engine (on the card unless
    ``device="cpu"``)."""

    metadata = {"render_modes": ["ansi"], "name": "warehouse_tpu_torch_v0"}

    def __init__(self, cfg: EnvConfig | None = None, backend: str = "torch",
                 device=None) -> None:
        self._env = WarehouseMultiAgentEnv(cfg, backend=backend,
                                           device=device)
        self.possible_agents = list(self._env.possible_agents)
        self.agents = list(self.possible_agents)

    def observation_space(self, agent: str):
        return self._env.observation_space(agent)

    def action_space(self, agent: str):
        return self._env.action_space(agent)

    def reset(self, seed: int | None = None, options: Any = None):
        obs, info = self._env.reset(seed=seed, options=options)
        self.agents = list(self.possible_agents)
        return obs, info

    def step(self, actions: dict[str, int]):
        obs, rew, term, trunc, info = self._env.step(actions)
        # PettingZoo has no "__all__" key — per-agent dicts only.
        term = {a: term[a] for a in self.possible_agents}
        trunc = {a: trunc[a] for a in self.possible_agents}
        if all(term.values()) or all(trunc.values()):
            self.agents = []
        return obs, rew, term, trunc, info

    def render(self):
        return self._env.render()

    def close(self) -> None:
        pass

    @property
    def num_agents(self) -> int:
        return len(self.agents)

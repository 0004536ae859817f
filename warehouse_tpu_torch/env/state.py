"""EnvState / TimeStep as dataclasses of batched tensors (SEMANTICS §2).

Every field carries a leading env axis ``B``; the JAX package's per-env
pytrees are the same fields without it. Integers are int32, flags bool;
PRNG keys are int64 ``[B, 2]`` holding uint32 words (see ``rng.py``).
"""

from __future__ import annotations

import dataclasses

import torch

EMPTY, PENDING, IN_TRANSIT = 0, 1, 2

STATE_FIELDS = ("agent_pos", "agent_req", "carrying", "req_pickup",
                "req_drop", "req_status", "req_agent", "t", "key")


@dataclasses.dataclass
class EnvState:
    agent_pos: torch.Tensor   # int32[B, A, 2]
    agent_req: torch.Tensor   # int32[B, A]; -1 = unassigned
    carrying: torch.Tensor    # bool[B, A]
    req_pickup: torch.Tensor  # int32[B, R, 2]
    req_drop: torch.Tensor    # int32[B, R, 2]
    req_status: torch.Tensor  # int32[B, R]; EMPTY/PENDING/IN_TRANSIT
    req_agent: torch.Tensor   # int32[B, R]; -1 = unassigned
    t: torch.Tensor           # int32[B]
    key: torch.Tensor         # int64[B, 2] threefry key words

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)

    def where(self, mask: torch.Tensor, other: "EnvState") -> "EnvState":
        """Per env: this state where ``mask[b]``, else ``other``'s."""
        def pick(a, b):
            m = mask.reshape(mask.shape + (1,) * (a.dim() - 1))
            return torch.where(m, a, b)
        return EnvState(**{f: pick(getattr(self, f), getattr(other, f))
                           for f in STATE_FIELDS})


@dataclasses.dataclass
class TimeStep:
    obs: torch.Tensor         # float32[B, A, obs_dim] (post-auto-reset)
    final_obs: torch.Tensor   # float32[B, A, obs_dim] pre-auto-reset obs
    reward: torch.Tensor      # float32[B, A]
    terminated: torch.Tensor  # bool[B] (always False, SEMANTICS §4.7)
    truncated: torch.Tensor   # bool[B]
    picked: torch.Tensor      # bool[B, A]
    delivered: torch.Tensor   # bool[B, A]
    collided: torch.Tensor    # bool[B, A]

    def replace(self, **kw) -> "TimeStep":
        return dataclasses.replace(self, **kw)

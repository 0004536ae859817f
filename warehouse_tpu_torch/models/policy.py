"""Actor-critic MLP policy (counterpart of ``warehouse_tpu/models/policy.py``).

Only the feed-forward MLP arm is ported: a shared-parameter per-agent
actor-critic applied to ``[..., obs_dim]`` observations. Initialisation
follows the flax model — orthogonal kernels with gain √2 on the hidden
layers, 0.01 on the logits head and 1.0 on the value head, zero biases —
drawn from an explicit ``torch.Generator`` (the numbers differ from
flax's; ``params_from_flax`` carries a flax model's weights over).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from warehouse_tpu.config import EnvConfig


class ActorCriticMLP(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int,
                 hidden_dims: Sequence[int] = (128, 128),
                 generator: torch.Generator | None = None):
        super().__init__()
        dims = (obs_dim, *hidden_dims)
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.logits = nn.Linear(dims[-1], num_actions)
        self.value = nn.Linear(dims[-1], 1)
        gains = [math.sqrt(2.0)] * len(self.hidden) + [0.01, 1.0]
        with torch.no_grad():
            for layer, gain in zip(self.layers(), gains):
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                layer.bias.zero_()

    def layers(self) -> list[nn.Linear]:
        """Hidden layers, then the logits head, then the value head."""
        return [*self.hidden, self.logits, self.value]

    def forward(self, obs: torch.Tensor):
        """obs float32[..., obs_dim] -> (logits [..., 5], value [...])."""
        return apply(dict(self.named_parameters()), obs)


def num_hidden(params: dict) -> int:
    return sum(1 for k in params if k.endswith(".weight")) - 2


def apply(params: dict, obs: torch.Tensor):
    """The MLP on a params dict keyed like ``ActorCriticMLP.state_dict``
    (the functional form the trainer and the SGD twins use)."""
    x = obs
    for i in range(num_hidden(params)):
        x = torch.tanh(F.linear(x, params[f"hidden.{i}.weight"],
                                params[f"hidden.{i}.bias"]))
    value = F.linear(x, params["value.weight"], params["value.bias"])
    return (F.linear(x, params["logits.weight"], params["logits.bias"]),
            value.squeeze(-1))


def make_model(cfg: EnvConfig, arch: str = "mlp", hidden_dim: int = 128,
               num_layers: int = 2, generator: torch.Generator | None = None,
               device=None) -> ActorCriticMLP:
    if arch != "mlp":
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet; only 'mlp' is")
    model = ActorCriticMLP(cfg.obs_dim, cfg.num_actions,
                           (hidden_dim,) * num_layers, generator)
    return model.to(device)


def params_from_flax(params_np) -> dict:
    """A flax ``ActorCriticMLP``'s params (nested dict of numpy arrays,
    with or without the top ``"params"`` level) as this module's
    ``state_dict``. ``Dense_i`` are taken in index order — hidden layers,
    logits head, value head — and each kernel ``[in, out]`` becomes a
    ``Linear.weight [out, in]``. Every shape is checked."""
    dense = params_np.get("params", params_np)
    names = sorted(dense, key=lambda s: int(s.split("_")[1]))
    if len(names) < 3 or any(not n.startswith("Dense_") for n in names):
        raise ValueError(f"not an MLP actor-critic: layers {names}")
    keys = [f"hidden.{i}" for i in range(len(names) - 2)] + ["logits",
                                                             "value"]
    out, fan_in = {}, None
    for key, name in zip(keys, names):
        kernel = np.asarray(dense[name]["kernel"], np.float32)
        bias = np.asarray(dense[name]["bias"], np.float32)
        if kernel.ndim != 2 or bias.shape != (kernel.shape[1],):
            raise ValueError(f"{name}: kernel {kernel.shape}, bias "
                             f"{bias.shape}")
        if key == "value" and kernel.shape[1] != 1:
            raise ValueError(f"{name}: value head has {kernel.shape[1]} "
                             "outputs, expected 1")
        if fan_in is not None and kernel.shape[0] != fan_in:
            raise ValueError(f"{name}: input width {kernel.shape[0]}, "
                             f"expected {fan_in}")
        if key != "logits":
            fan_in = kernel.shape[1]
        out[f"{key}.weight"] = torch.from_numpy(kernel.T.copy())
        out[f"{key}.bias"] = torch.from_numpy(bias.copy())
    return out

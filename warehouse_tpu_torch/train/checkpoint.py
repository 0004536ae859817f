"""Checkpoint and resume (counterpart of
``warehouse_tpu/train/checkpoint.py``, on ``torch.save`` instead of orbax).

A checkpoint is the whole runner state of a trainer (params, optimizer
moments and count, env state with its keys, observations, key, update
index, KL coefficient, and the recurrent carry where there is one) under
``<directory>/step_%08d``. It is stored as plain containers (dicts and
lists of tensors and numbers), so a file loads with
``torch.load(weights_only=True)`` and needs none of the port's classes;
``restore`` pours it back into the structure of a target state. A file is
written under a temporary name and renamed when complete, so only names
that match ``step_(\\d+)`` exactly are finished checkpoints. Tensors load
onto the device asked for, whichever device wrote them; a restored run
continues bit for bit. Trees written by the JAX package (orbax) are not
read: ``runner_state_from_jax`` carries a JAX state over.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any

import torch

from ..device import resolve_device


def _plain(tree: Any) -> Any:
    """``tree`` with its named tuples and dataclasses as dicts, its tuples
    as lists, and its tensors detached on the CPU."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if hasattr(tree, "_fields"):
        return {f: _plain(getattr(tree, f)) for f in tree._fields}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_plain(v) for v in tree]
    return tree


def _pour(plain: Any, target: Any, where: str) -> Any:
    """``plain`` in the structure of ``target``: every tensor on its
    target leaf's device, shape and dtype checked."""
    if isinstance(target, torch.Tensor):
        if (not isinstance(plain, torch.Tensor) or plain.shape != target.shape
                or plain.dtype != target.dtype):
            raise ValueError(f"checkpoint leaf {where} does not fit the "
                             f"target's {tuple(target.shape)} {target.dtype}")
        return plain.to(target.device)
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        names = [f.name for f in dataclasses.fields(target)]
    elif hasattr(target, "_fields"):
        names = list(target._fields)
    elif isinstance(target, dict):
        names = None
    elif isinstance(target, (tuple, list)):
        if not isinstance(plain, list) or len(plain) != len(target):
            raise ValueError(f"checkpoint node {where} does not fit the "
                             "target's sequence")
        return type(target)(_pour(p, t, f"{where}[{i}]")
                            for i, (p, t) in enumerate(zip(plain, target)))
    else:
        return type(target)(plain)  # a number: the optimizer's count
    keys = list(target) if names is None else names
    if not isinstance(plain, dict) or set(plain) != set(keys):
        raise ValueError(f"checkpoint node {where} has other fields than "
                         f"the target's {keys}")
    if names is None:
        return {k: _pour(plain[k], target[k], f"{where}.{k}") for k in keys}
    return type(target)(**{k: _pour(plain[k], getattr(target, k),
                                    f"{where}.{k}") for k in keys})


def _path(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f"step_{step:08d}"))


def save(directory: str, step: int, tree: Any) -> str:
    """Save ``tree`` under ``directory/step_{step:08d}``; returns the path.
    The file appears under that name only once it is complete."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_plain(tree), tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    """The largest step with a finished checkpoint, or None. A crash in
    the middle of a save leaves a ``step_*.tmp`` file, which does not
    count."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", name))]
    return max(steps) if steps else None


def _load(directory: str, step: int, device) -> Any:
    return torch.load(_path(directory, step), map_location=device,
                      weights_only=True)


def restore(directory: str, step: int, target: Any) -> Any:
    """The checkpoint of ``step`` in the structure of ``target`` (a runner
    state of the same trainer), each tensor on its target leaf's device."""
    return _pour(_load(directory, step, "cpu"), target, "state")


def restore_latest(directory: str, target: Any) -> tuple[int, Any] | None:
    step = latest_step(directory)
    if step is None:
        return None
    return step, restore(directory, step, target)


def restore_params(directory: str, step: int | None = None,
                   device=None) -> dict:
    """Only the ``params`` dict of a training checkpoint (the latest
    without ``step``), on ``device``: the card by default, the CPU with
    ``device="cpu"``, whichever wrote the file. No model object is needed:
    serving and evaluation load params knowing only the directory."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    return _load(directory, step, device)["params"]

"""Canonical random-draw streams (docs/SEMANTICS.md §9) in PyTorch.

A bit-exact port of the threefry2x32 key operations and samplers that
``warehouse_tpu/rng.py`` calls through ``jax.random``, with
``jax_threefry_partitionable=True`` (the layout jax 0.9 uses):

- ``split(key, n)[i]`` and ``fold_in(key, i)`` are both
  ``threefry2x32(key, (0, i))``;
- ``random_bits(key, shape)`` hashes the flat 64-bit element index
  ``(hi, lo)`` and xors the two output words;
- ``uniform`` fills the mantissa of a float in ``[1, 2)`` and subtracts 1;
- ``randint`` takes two bit draws and folds them with the span/multiplier
  rule of ``jax.random.randint``;
- ``permutation`` is jax's sort-key shuffle: ``ceil(3 ln n / ln(2^32-1))``
  rounds of a stable sort on fresh 32-bit keys.

Keys are int64 tensors ``[..., 2]`` holding uint32 values: torch has no
uint32 shifts on the CPU, so every word is kept in int64 and masked with
``0xFFFFFFFF``. All functions are batched over the leading axes of the
key tensor (no vmap) and run on the key's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .config import EnvConfig

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY_F32 = float(np.finfo(np.float32).tiny)


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``, 32-bit: ``[0, seed mod 2^32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 hash (20 rounds) on broadcastable int64 words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _hash(key: torch.Tensor, hi, lo):
    return threefry2x32(key[..., 0], key[..., 1], hi, lo)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``; ``data`` is an int or a tensor broadcastable
    against ``key[..., 0]``."""
    lo = torch.as_tensor(data, dtype=torch.int64, device=key.device) & M32
    b0, b1 = _hash(key, torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: keys ``[..., 2]`` -> ``[..., num, 2]``."""
    idx = torch.arange(num, dtype=torch.int64, device=key.device)
    b0, b1 = _hash(key[..., None, :], torch.zeros_like(idx), idx)
    return torch.stack(torch.broadcast_tensors(b0, b1), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple = ()) -> torch.Tensor:
    """32 random bits per element of ``shape`` per key: ``[..., *shape]``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    k = key.reshape(*key.shape[:-1], *([1] * len(shape)), 2)
    hi = (idx >> 32).reshape(shape)
    lo = (idx & M32).reshape(shape)
    b0, b1 = _hash(k, hi, lo)
    return b0 ^ b1


def uniform(key: torch.Tensor, shape: tuple = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32 (bit-exact)."""
    bits = random_bits(key, shape)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    return torch.maximum(lo, floats * (hi - lo) + lo)


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` into int32 (bit-exact): two 32-bit draws
    folded modulo the span with the ``2^32 mod span`` multiplier."""
    k = split(key, 2)
    higher = random_bits(k[..., 0, :], shape)
    lower = random_bits(k[..., 1, :], shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & M32) % span  # uint32 product wraps
    off = (((higher % span) * mult) & M32) + (lower % span)
    off = (off & M32) % span
    return (minval + off).to(torch.int32)


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: ``[..., n]`` int64 indices."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    x = x.expand(*key.shape[:-1], n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(M32)))
    for _ in range(rounds):
        k = split(key, 2)
        key, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def gumbel(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32: ``-log(-log(u))``.
    The uniform draw is bit-exact; ``log`` may differ from XLA's by an ulp."""
    u = uniform(key, shape, minval=_TINY_F32, maxval=1.0)
    return -torch.log(-torch.log(u))


# ---- the environment's draw streams (warehouse_tpu/rng.py) ---------------

class ResetDraws(NamedTuple):
    carry_key: torch.Tensor    # int64[B, 2] becomes state.key
    agent_cells: torch.Tensor  # int32[B, A] row-major cell ids, distinct
    req_pick: torch.Tensor     # int32[B, init_requests]
    req_drop: torch.Tensor     # int32[B, init_requests]


class StepDraws(NamedTuple):
    next_key: torch.Tensor     # int64[B, 2] becomes state.key
    reset_key: torch.Tensor    # int64[B, 2] used iff the tick auto-resets
    spawn_u: torch.Tensor      # float32[B] in [0, 1)
    spawn_pick: torch.Tensor   # int32[B] cell id
    spawn_drop: torch.Tensor   # int32[B] cell id


def free_cells(cfg: EnvConfig, device=None) -> torch.Tensor:
    """Row-major ids of the cells that are not walls (§1a), int32."""
    return torch.tensor(cfg.free_cells, dtype=torch.int32, device=device)


def reset_draws(keys: torch.Tensor, cfg: EnvConfig) -> ResetDraws:
    """Draws for ``reset`` of a batch of keys ``[B, 2]`` (§9)."""
    free = free_cells(cfg, keys.device)
    k = split(keys, 3)
    carry_key, pos_key, req_key = k[:, 0], k[:, 1], k[:, 2]
    perm = permutation(pos_key, cfg.num_free)
    agent_cells = free[perm[:, :cfg.num_agents]]
    n = cfg.init_requests
    slots = torch.arange(n, dtype=torch.int64, device=keys.device)
    rk = req_key[:, None, :]
    pick = randint(fold_in(rk, 2 * slots), (), 0, cfg.num_free)
    drop = randint(fold_in(rk, 2 * slots + 1), (), 0, cfg.num_free)
    return ResetDraws(carry_key, agent_cells, free[pick.long()],
                      free[drop.long()])


def _spawn_cells(sk: torch.Tensor, cfg: EnvConfig):
    free = free_cells(cfg, sk.device)
    u = uniform(fold_in(sk, 0))
    pick = free[randint(fold_in(sk, 1), (), 0, cfg.num_free).long()]
    drop = free[randint(fold_in(sk, 2), (), 0, cfg.num_free).long()]
    return u, pick, drop


def step_draws(keys: torch.Tensor, cfg: EnvConfig) -> StepDraws:
    """Draws for one ``step`` tick of a batch of keys ``[B, 2]`` (§9)."""
    k = split(keys, 3)
    u, pick, drop = _spawn_cells(k[:, 1], cfg)
    return StepDraws(k[:, 0], k[:, 2], u, pick, drop)


def spawn_draws(keys: torch.Tensor, cfg: EnvConfig):
    """One tick's draws for a batch of keys ``[B, 2]`` in the order that
    ``kernels/csrc/threefry.cuh`` ``spawn_draws`` makes them: ``(next_key,
    u, pick, drop)``, ``step_draws`` without its reset key. The spawn key
    is ``fold_in(key, 1)`` (``split(key, 3)[1]``), then its uniform and two
    randints, then the next key ``fold_in(key, 0)``."""
    sk = fold_in(keys, 1)
    u, pick, drop = _spawn_cells(sk, cfg)
    return fold_in(keys, 0), u, pick, drop


def chained_step_draws(keys: torch.Tensor, cfg: EnvConfig,
                       T: int) -> StepDraws:
    """T chained ``step_draws`` from keys ``[B, 2]``, each field stacked
    ``[T, B, ...]``: the same values, with only the key chain sequential
    (the spawn draws of all T ticks made at once)."""
    nks, sks, rks = [], [], []
    for _ in range(T):
        trip = split(keys, 3)
        keys = trip[:, 0]
        nks.append(keys)
        sks.append(trip[:, 1])
        rks.append(trip[:, 2])
    u, pick, drop = _spawn_cells(torch.stack(sks), cfg)
    return StepDraws(torch.stack(nks), torch.stack(rks), u, pick, drop)


def batched_step_draws(keys: torch.Tensor, cfg: EnvConfig, T: int):
    """T steps of per-env draws: ``(final_keys, u float32[T, B],
    pick int32[T, B], drop int32[T, B], reset_keys int64[T, B, 2])``,
    ``chained_step_draws``' values."""
    d = chained_step_draws(keys, cfg, T)
    return d.next_key[-1], d.spawn_u, d.spawn_pick, d.spawn_drop, d.reset_key


def batched_gumbel_stream(key: torch.Tensor, T: int, shape: tuple):
    """``(next_key, g float32[T, *shape])`` — the chain
    ``key, ak = split(key); gumbel(ak, shape)`` for T steps."""
    aks = []
    for _ in range(T):
        k = split(key, 2)
        key = k[0]
        aks.append(k[1])
    return key, gumbel(torch.stack(aks), shape)

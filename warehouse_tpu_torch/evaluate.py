"""Evaluation CLI: ``python -m warehouse_tpu_torch.evaluate``.

Counterpart of ``warehouse_tpu/evaluate.py`` for the greedy and random
baselines: B envs run one full episode each (auto-reset off) and the same
metrics dict is reported. Evaluating a checkpoint waits for the
checkpoint port.
"""

from __future__ import annotations

import argparse

import torch

from . import rng as _rng
from .configs_cli import (add_device_args, add_env_args, device_from_args,
                          env_config_from_args)
from .device import resolve_device
from .env import engine


def evaluate_policy(cfg, policy_fn, num_episodes: int, seed: int = 0,
                    device=None) -> dict:
    """``policy_fn(state, obs, key) -> int32[B, A]``; returns the metrics.

    Env b resets from ``fold_in(PRNGKey(seed), b)`` and the policy keys
    split off ``PRNGKey(seed + 1)`` once per step, as in the JAX package.
    Runs on the card unless ``device="cpu"``.
    """
    device = resolve_device(device)
    cfg = cfg.replace(auto_reset=False)
    B = num_episodes
    base = _rng.prng_key(seed, device)
    keys = _rng.fold_in(base, torch.arange(B, device=base.device))
    state, obs = engine.reset(cfg, keys)
    key = _rng.prng_key(seed + 1, device)
    ret = torch.zeros(B, cfg.num_agents, dtype=torch.float32,
                      device=base.device)
    deliv = torch.zeros(B, cfg.num_agents, dtype=torch.int64,
                        device=base.device)
    with torch.no_grad():
        for _ in range(cfg.max_steps):
            k = _rng.split(key, 2)
            key, ak = k[0], k[1]
            state, ts = engine.step(cfg, state, policy_fn(state, obs, ak))
            obs = ts.obs
            ret = ret + ts.reward
            deliv = deliv + ts.delivered
    ep_return = ret.cpu().numpy()
    ep_deliv = deliv.cpu().numpy()
    return {
        "episodes": B,
        "mean_agent_return": float(ep_return.mean()),
        "mean_episode_return": float(ep_return.sum(-1).mean()),
        "mean_deliveries_per_episode": float(ep_deliv.sum(-1).mean()),
        "std_episode_return": float(ep_return.sum(-1).std()),
    }


def policy_fn_for(name: str, cfg):
    if name == "greedy":
        from .baselines.greedy import greedy_actions

        return lambda state, obs, key: greedy_actions(cfg, state)
    if name == "random":
        from .baselines.random import random_actions

        return lambda state, obs, key: random_actions(
            cfg, key, (obs.shape[0],))
    raise NotImplementedError(f"policy {name!r} is not ported yet")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu_torch.evaluate")
    add_env_args(p)
    add_device_args(p)
    p.add_argument("--policy", choices=["greedy", "random"],
                   default="greedy")
    p.add_argument("--episodes", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    cfg = env_config_from_args(args)
    metrics = evaluate_policy(cfg, policy_fn_for(args.policy, cfg),
                              args.episodes, args.seed,
                              device_from_args(args))
    for k, v in metrics.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

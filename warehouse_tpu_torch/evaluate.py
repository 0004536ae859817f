"""Evaluation CLI: ``python -m warehouse_tpu_torch.evaluate``.

Counterpart of ``warehouse_tpu/evaluate.py``: B envs run one full episode
each (auto-reset off) under the greedy baseline, the obstacle-aware
``greedy_bfs`` baseline, a random policy or a trained checkpoint, and the
same metrics dict is reported. The CLI's greedy baseline runs as one
launch of the greedy rollout kernel K1 (``evaluate_greedy``, which the
kernel's wrapper runs plain on the CPU), at any (agents, queue) pair.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from . import rng as _rng
from .configs_cli import (add_device_args, add_env_args, device_from_args,
                          env_config_from_args)
from .device import resolve_device
from .env import engine


def evaluate_policy(cfg, policy_fn, num_episodes: int, seed: int = 0,
                    init_carry=None, device=None) -> dict:
    """``policy_fn(state, obs, key) -> int32[B, A]``; returns the metrics.

    Env b resets from ``fold_in(PRNGKey(seed), b)`` and the policy keys
    split off ``PRNGKey(seed + 1)`` once per step, as in the JAX package.
    A recurrent policy passes ``init_carry(B) -> carry`` and a
    ``policy_fn(state, obs, key, carry) -> (actions, carry)``; the carry
    is threaded through the episode. Runs on the card unless
    ``device="cpu"``.
    """
    device = resolve_device(device)
    cfg = cfg.replace(auto_reset=False)
    B = num_episodes
    base = _rng.prng_key(seed, device)
    keys = _rng.fold_in(base, torch.arange(B, device=base.device))
    state, obs = engine.reset(cfg, keys)
    key = _rng.prng_key(seed + 1, device)
    carry = init_carry(B) if init_carry is not None else None
    ret = torch.zeros(B, cfg.num_agents, dtype=torch.float32,
                      device=base.device)
    deliv = torch.zeros(B, cfg.num_agents, dtype=torch.int64,
                        device=base.device)
    with torch.no_grad():
        for _ in range(cfg.max_steps):
            k = _rng.split(key, 2)
            key, ak = k[0], k[1]
            if init_carry is not None:
                actions, carry = policy_fn(state, obs, ak, carry)
            else:
                actions = policy_fn(state, obs, ak)
            state, ts = engine.step(cfg, state, actions)
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


def evaluate_greedy(cfg, num_episodes: int, seed: int = 0,
                    device=None) -> dict:
    """``evaluate_policy``'s metrics for the greedy baseline from the same
    resets, the whole episode as one ``kernels.rollout.greedy_rollout``
    (K1 on the card, its plain twin on the CPU). Deliveries are equal to
    ``evaluate_policy``'s; K1 sums each env's team reward step by step, so
    the returns are its sums (``mean_agent_return`` the episode's over the
    agents), within float32 rounding of the per-agent sums."""
    from .kernels.rollout import greedy_rollout

    device = resolve_device(device)
    cfg = cfg.replace(auto_reset=False)
    base = _rng.prng_key(seed, device)
    keys = _rng.fold_in(base, torch.arange(num_episodes, device=device))
    state, _ = engine.reset(cfg, keys)
    _, deliv, ret = greedy_rollout(cfg, state, cfg.max_steps)
    ep_return = ret.cpu().numpy()
    return {
        "episodes": num_episodes,
        "mean_agent_return": float(ep_return.mean() / cfg.num_agents),
        "mean_episode_return": float(ep_return.mean()),
        "mean_deliveries_per_episode": float(deliv.cpu().numpy().mean()),
        "std_episode_return": float(ep_return.std()),
    }


def policy_fn_for(name: str, cfg):
    """The ``policy_fn`` of a baseline: "greedy", "greedy_bfs", "random"."""
    if name in ("greedy", "greedy_bfs"):
        from .baselines.greedy import greedy_actions, greedy_bfs_actions

        fn = greedy_bfs_actions if name == "greedy_bfs" else greedy_actions
        return lambda state, obs, key: fn(cfg, state)
    if name == "random":
        from .baselines.random import random_actions

        return lambda state, obs, key: random_actions(
            cfg, key, (obs.shape[0],))
    raise ValueError(f"policy {name!r} is not a baseline")


def params_policy_fn(cfg, params: dict, arch: str, mask_actions: bool = False,
                     sample: bool = False, dtype="float32"):
    """``(policy_fn, init_carry)`` for ``evaluate_policy`` from a params
    dict of the MLP, CNN, attention, GRU or LSTM policy at compute
    ``dtype``: the
    argmax action (first on a tie) or, with ``sample``, a categorical
    sample; with ``mask_actions`` the logits of moves off the grid or into
    a wall are floored to -1e9 first. ``init_carry`` is None for the
    feed-forward policies."""
    from .models.policy import (apply, apply_rnn, initial_carry,
                                model_precision)
    from .ops.move import valid_action_mask
    from .ops.ppo_update import NEG_INF, first_argmax, sample_action

    precision = model_precision(dtype)

    def pick(state, logits, key):
        if mask_actions:
            logits = torch.where(valid_action_mask(cfg, state.agent_pos),
                                 logits, NEG_INF)
        if sample:
            return sample_action(key, logits)[0].to(torch.int32)
        return first_argmax(logits, -1).to(torch.int32)

    if arch in ("gru", "lstm"):
        hidden = params["logits.weight"].shape[1]
        device = params["logits.weight"].device

        def policy_fn(state, obs, key, carry):
            logits, _, carry = apply_rnn(params, obs, carry,
                                         precision=precision)
            return pick(state, logits, key), carry

        def init_carry(B):
            return initial_carry(arch, (B, cfg.num_agents), hidden, device,
                                 dtype)

        return policy_fn, init_carry

    def policy_fn(state, obs, key):
        return pick(state, apply(params, obs, precision=precision)[0], key)

    return policy_fn, None


def _read_meta(checkpoint_dir: str) -> dict:
    """The directory's ``policy_meta.json``, or ``{}`` without one."""
    from .serve import META_NAME

    meta_path = os.path.join(checkpoint_dir, META_NAME)
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def _meta_view(meta: dict):
    """Whether the meta's env had global observations; None if unsaid."""
    view = meta.get("env_config", {}).get("global_obs")
    return None if view is None else bool(view)


def checkpoint_env_config(cfg, checkpoint_dir: str):
    """``cfg`` with the observation view (``global_obs``) of the env the
    checkpoint under ``checkpoint_dir`` was trained on, from its
    ``policy_meta.json``: the view decides the model's input width, so it
    belongs to the policy like the mask does."""
    view = _meta_view(_read_meta(checkpoint_dir))
    if view is None or view == cfg.global_obs:
        return cfg
    return cfg.replace(global_obs=view)


def checkpoint_policy_fn(cfg, checkpoint_dir: str, arch=None, hidden_dim=None,
                         mask_actions: bool = False, sample: bool = False,
                         device=None):
    """``(policy_fn, init_carry, mask_actions)`` from the latest checkpoint
    under ``checkpoint_dir``. ``arch``, ``hidden_dim`` and the mask default
    to the directory's ``policy_meta.json`` (then "mlp", 128, off): a
    mask-trained checkpoint turns the mask on, since evaluating it
    unmasked scores near zero. The checkpoint's params must fit the model
    those settings build; a ``cfg`` whose observation view is not the
    meta's raises ``ValueError`` (``checkpoint_env_config`` gives the
    fitting one). The policy runs in float32 whatever the meta's
    ``model_dtype``, as the JAX package's evaluate builds it."""
    from .models import make_model
    from .train.checkpoint import restore_params

    device = resolve_device(device)
    meta = _read_meta(checkpoint_dir)
    view = _meta_view(meta)
    if view is not None and view != cfg.global_obs:
        raise ValueError(
            f"the checkpoint under {checkpoint_dir} was trained "
            f"{'with' if view else 'without'} --global-obs (its "
            f"policy_meta.json), the env has global_obs={cfg.global_obs}")
    if meta.get("policy_groups") is not None:
        raise ValueError(
            f"the checkpoint under {checkpoint_dir} holds policy_groups="
            f"{meta['policy_groups']} (its policy_meta.json): evaluate takes "
            "a shared policy, as the JAX package's does; serve it with "
            "serve.Policy.from_checkpoint")
    arch = arch or meta.get("arch", "mlp")
    hidden_dim = hidden_dim or meta.get("hidden_dim", 128)
    mask_actions = bool(mask_actions or meta.get("mask_actions"))
    try:
        params = restore_params(checkpoint_dir, device=device)
    except FileNotFoundError as e:
        raise SystemExit(str(e)) from e
    model = make_model(cfg, arch=arch, hidden_dim=hidden_dim,
                       num_layers=meta.get("num_layers", 2), device=device)
    model.load_state_dict(params)  # raises where the settings do not fit
    fn, init_carry = params_policy_fn(cfg, params, arch, mask_actions, sample)
    return fn, init_carry, mask_actions


def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu_torch.evaluate")
    add_env_args(p)
    add_device_args(p)
    p.add_argument("--policy",
                   choices=["greedy", "greedy_bfs", "random", "checkpoint"],
                   default="greedy")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--arch", choices=["mlp", "cnn", "attn", "gru", "lstm"],
                   default=None,
                   help="default: the checkpoint's policy_meta.json "
                        "(falls back to mlp)")
    p.add_argument("--hidden-dim", type=int, default=None)
    p.add_argument("--episodes", type=int, default=256)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sample", action="store_true",
                   help="sample checkpoint-policy actions from the "
                        "categorical instead of argmax")
    p.add_argument("--mask-actions", action="store_true",
                   help="mask wall/out-of-grid moves at the logits (on by "
                        "itself when the checkpoint's meta says it was "
                        "trained with --mask-actions)")
    args = p.parse_args(argv)
    cfg = env_config_from_args(args)
    device = device_from_args(args)
    init_carry = None
    if args.policy == "checkpoint":
        # The observation view is the checkpoint's, whatever the flag says.
        flag = cfg.global_obs
        cfg = checkpoint_env_config(cfg, args.checkpoint_dir)
        if cfg.global_obs != flag:
            print(f"global_obs={cfg.global_obs}: the checkpoint's "
                  "policy_meta.json")
        policy_fn, init_carry, _ = checkpoint_policy_fn(
            cfg, args.checkpoint_dir, args.arch, args.hidden_dim,
            args.mask_actions, args.sample, device)
    elif args.policy != "greedy":
        policy_fn = policy_fn_for(args.policy, cfg)
    if args.policy == "greedy":
        metrics = evaluate_greedy(cfg, args.episodes, args.seed, device)
    else:
        metrics = evaluate_policy(cfg, policy_fn, args.episodes, args.seed,
                                  init_carry=init_carry, device=device)
    for k, v in metrics.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()

"""Demo CLI: ``python -m warehouse_tpu_torch.demo`` (counterpart of
``warehouse_tpu/demo.py``).

Rolls one episode through the dict-API wrapper under the greedy baseline,
the obstacle-aware ``greedy_bfs``, a random policy or a trained checkpoint,
and prints per-step ASCII renders (``--render``), an animated GIF
(``--gif``, needs PIL) and the episode summary. The flags are the JAX
demo's, with ``--backend torch`` and ``--device`` / ``--cpu``: the episode
runs on the card unless the CPU is asked for.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .configs_cli import (add_device_args, add_env_args, device_from_args,
                          env_config_from_args)


def _legacy_checkpoint_fn(cfg, args, device):
    """Argmax over the model that ``--arch`` / ``--hidden-dim`` build from
    the latest checkpoint's params, for a directory without
    ``policy_meta.json`` (no masking, no carry)."""
    from .models import make_model
    from .ops.ppo_update import first_argmax
    from .train.checkpoint import restore_params

    model = make_model(cfg, arch=args.arch, hidden_dim=args.hidden_dim,
                       device=device)
    model.load_state_dict(restore_params(args.checkpoint_dir, device=device))

    def act(obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            logits, _ = model(torch.from_numpy(obs).to(device)[None])
        return first_argmax(logits[0], -1).cpu().numpy()

    return act


def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu_torch.demo")
    add_env_args(p)
    add_device_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--steps", type=int, default=None,
                   help="default: env max_steps")
    p.add_argument("--policy",
                   choices=["greedy", "greedy_bfs", "random", "checkpoint"],
                   default="greedy")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--arch", choices=["mlp", "cnn", "attn"], default="mlp")
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--render", action="store_true")
    p.add_argument("--gif", default=None, metavar="PATH",
                   help="write the episode as an animated GIF "
                        "(rgb_array rendering)")
    p.add_argument("--backend", choices=["torch", "oracle"], default="torch",
                   help="oracle: the NumPy oracle (it steps on the host), "
                        "the same episode as torch's")
    args = p.parse_args(argv)

    cfg = env_config_from_args(args)
    oracle = args.backend == "oracle"
    device = device_from_args(args)
    steps = args.steps or cfg.max_steps

    from .env.wrapper import WarehouseMultiAgentEnv

    env = WarehouseMultiAgentEnv(cfg, backend=args.backend, device=device)
    obs, _ = env.reset(seed=args.seed)
    rng = np.random.default_rng(args.seed)

    ckpt_apply = None
    ckpt_policy = None
    ckpt_carry = None
    if args.policy == "checkpoint":
        # The self-describing serving path first: policy_meta.json rebuilds
        # the arch, the mask and the groups, and Policy threads the carry.
        from .serve import Policy

        try:
            ckpt_policy = Policy.from_checkpoint(args.checkpoint_dir,
                                                 device=device)
            ckpt_carry = ckpt_policy.initial_state(1)
        except FileNotFoundError:
            ckpt_apply = _legacy_checkpoint_fn(cfg, args, device)

    returns = {a: 0.0 for a in env.possible_agents}
    deliveries = 0
    frames = []
    if args.render:
        print(env.render())
    if args.gif:
        frames.append(env.render(mode="rgb_array"))
    for t in range(steps):
        if args.policy in ("greedy", "greedy_bfs"):
            if oracle:
                from .oracle import greedy_actions, greedy_bfs_actions
            else:
                from .baselines.greedy import (greedy_actions,
                                               greedy_bfs_actions)

            fn = (greedy_bfs_actions if args.policy == "greedy_bfs"
                  else greedy_actions)
            acts = fn(cfg, env.state)
            acts = np.asarray(acts) if oracle else acts[0].cpu().numpy()
            action_dict = {
                a: int(acts[i]) for i, a in enumerate(env.possible_agents)
            }
        elif args.policy == "checkpoint":
            if ckpt_policy is not None:
                action_dict, ckpt_carry = ckpt_policy.compute_actions_dict(
                    env, obs, state=ckpt_carry
                )
            else:
                acts = ckpt_apply(np.stack([obs[a]
                                            for a in env.possible_agents]))
                action_dict = {
                    a: int(acts[i])
                    for i, a in enumerate(env.possible_agents)
                }
        else:
            action_dict = {
                a: int(rng.integers(0, cfg.num_actions))
                for a in env.possible_agents
            }
        obs, rew, term, trunc, info = env.step(action_dict)
        deliveries += sum(info[a]["delivered"] for a in env.possible_agents)
        for a in env.possible_agents:
            returns[a] += rew[a]
        if args.render:
            print(env.render())
        if args.gif:
            frames.append(env.render(mode="rgb_array"))
        if trunc["__all__"] or term["__all__"]:
            break
    if args.gif:
        from .env.render import save_gif

        save_gif(frames, args.gif)
        print(f"gif written: {args.gif} ({len(frames)} frames)")
    print(f"episode finished after {t + 1} steps")
    print(f"deliveries: {deliveries}")
    for a, r in returns.items():
        print(f"  {a}: return {r:.3f}")
    print(f"mean return: {np.mean(list(returns.values())):.3f}")


if __name__ == "__main__":
    main()

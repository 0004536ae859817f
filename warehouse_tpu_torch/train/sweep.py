"""Hyperparameter sweeps (counterpart of ``warehouse_tpu/train/sweep.py``):
Ray Tune's grid and random search and its ASHA scheduler.

The JAX sweep trains a point's seeds as a vmap axis in one program; the
port trains them one after another on the single-device trainer, each
through its own routes (``make_train``'s ``backends``: the acting kernel
K2 and the learner kernel K3 at config 4 on the card), and stacks their
metrics ``[num_seeds, num_updates]``. Seed s starts from
``fold_in(PRNGKey(tcfg.seed), s)``, as in the JAX sweep. The JSONL rows
(one per trial and seed, or per trial and rung, then a summary), the
selection by ``select_metric`` over the last ``last_k`` updates and
``mode``, random search and ASHA's rungs and promotions are the JAX
module's; each row also records the trial's ``backends``.

With a ``seed_mesh`` (``parallel.mesh.make_pop_mesh``: the JAX sweep's
seed axis sharded over ``pop``, with no collective) slice ``s`` of ``pop``
trains seeds ``[s S / pop, (s + 1) S / pop)`` in turn, each from the same
key and through the same routes as without the mesh; the data ranks of a
slice are replicas, as JAX's ``P(POP_AXIS)`` sharding makes them. The
metrics are gathered over the slices in seed order, so every rank holds
the same ``[num_seeds, n]`` arrays (and ASHA's promotions agree
everywhere); the mesh's rank 0 alone writes the JSONL.
"""

from __future__ import annotations

import argparse
import itertools
import json
from typing import Any, Sequence

import numpy as np
import torch

from ..config import EnvConfig, TrainConfig
from ..device import resolve_device

from .. import rng
from ..parallel.mesh import POP_AXIS
from .ppo import make_train


def seed_range(num_seeds: int, seed_mesh) -> range:
    """The seeds this rank trains: all of them without a mesh, else its
    slice's ``num_seeds / pop``; ``ValueError`` (JAX's) where ``pop`` does
    not divide ``num_seeds``."""
    if seed_mesh is None:
        return range(num_seeds)
    pop = seed_mesh.shape[POP_AXIS]
    if num_seeds % pop:
        raise ValueError(f"num_seeds={num_seeds} not divisible by {pop} pop "
                         "shards")
    per = num_seeds // pop
    return range(seed_mesh.slice * per, (seed_mesh.slice + 1) * per)


def _grid_points(grid: dict[str, Sequence[Any]]) -> list[dict[str, Any]]:
    """Cartesian product of the grid, key-sorted for determinism."""
    keys = sorted(grid)
    return [dict(zip(keys, vals))
            for vals in itertools.product(*(grid[k] for k in keys))]


def sample_spec(spec: Any, rng_np: np.random.Generator) -> Any:
    """One draw from a search spec: a list (uniform choice) or a dict with
    one of {"uniform": [lo, hi]}, {"loguniform": [lo, hi]},
    {"randint": [lo, hi]}. The draws are the JAX module's, in its order."""
    if isinstance(spec, (list, tuple)):
        return spec[int(rng_np.integers(len(spec)))]
    if isinstance(spec, dict) and "uniform" in spec:
        lo, hi = spec["uniform"]
        return float(rng_np.uniform(lo, hi))
    if isinstance(spec, dict) and "loguniform" in spec:
        lo, hi = spec["loguniform"]
        return float(np.exp(rng_np.uniform(np.log(lo), np.log(hi))))
    if isinstance(spec, dict) and "randint" in spec:
        lo, hi = spec["randint"]
        return int(rng_np.integers(lo, hi))
    raise ValueError(f"bad search spec: {spec!r}")


def _random_points(space: dict[str, Any], num_samples: int,
                   seed: int) -> list[dict[str, Any]]:
    """Random search (`tune.uniform`/`loguniform`/`choice` analogue): each
    field drawn by ``sample_spec``. Draw order is key-sorted →
    deterministic for a given seed.
    """
    rng_np = np.random.default_rng(seed)
    points = []
    for _ in range(num_samples):
        points.append({k: sample_spec(space[k], rng_np)
                       for k in sorted(space)})
    return points


def _points(grid, search: str, num_samples: int, search_seed: int):
    if search == "grid":
        return _grid_points(grid)
    if search == "random":
        return _random_points(grid, num_samples, search_seed)
    raise ValueError("search must be 'grid' or 'random'")


def seed_keys(tcfg: TrainConfig, num_seeds: int, device) -> list:
    """Seed s's key ``fold_in(PRNGKey(tcfg.seed), s)``, for s < num_seeds."""
    base = rng.prng_key(tcfg.seed, device)
    return [rng.fold_in(base, s) for s in range(num_seeds)]


def init_seeds(trainer, tcfg: TrainConfig, num_seeds: int,
               seeds=None) -> list:
    """Each seed's runner state from its ``seed_keys`` key, for the seeds
    ``seeds`` (all of them by default)."""
    keys = seed_keys(tcfg, num_seeds, trainer.device)
    return [trainer.init(keys[s])
            for s in (range(num_seeds) if seeds is None else seeds)]


def _stack(per_seed: list[dict]) -> dict[str, np.ndarray]:
    """Each metric of every seed as ``[num_seeds, n]`` NumPy arrays."""
    return {k: np.stack([m[k].detach().cpu().numpy() for m in per_seed])
            for k in per_seed[0]}


def _train_seeds(trainer, states: list, n: int):
    """n updates of each seed's state in turn: ``(states, metrics)``."""
    out, metrics = [], []
    for rs in states:
        rs, m = trainer.train_many(rs, n)
        out.append(rs)
        metrics.append(m)
    return out, _stack(metrics)


def _gather_seeds(metrics: dict, seed_mesh) -> dict:
    """This slice's seeds' metrics joined with the other slices', in seed
    order (a collective over the mesh); ``metrics`` without a mesh."""
    if seed_mesh is None:
        return metrics
    return {k: np.concatenate([
        x.numpy() for x in seed_mesh.gather_slices(torch.from_numpy(v))])
        for k, v in metrics.items()}


def _trial(env_cfg, tcfg, num_seeds, arch, device, seed_mesh=None):
    trainer = make_train(env_cfg, tcfg, arch=arch, device=device)
    seeds = seed_range(num_seeds, seed_mesh)
    states, metrics = _train_seeds(
        trainer, init_seeds(trainer, tcfg, num_seeds, seeds),
        tcfg.num_updates)
    return trainer, states, _gather_seeds(metrics, seed_mesh)


def run_trial(env_cfg: EnvConfig, tcfg: TrainConfig, num_seeds: int,
              arch: str = "mlp", seed_mesh=None, device=None):
    """Train ``num_seeds`` seeds of one config, one after another on the
    card unless ``device="cpu"``: ``(states, metrics)``, the runner state
    of each seed and a dict of arrays ``[num_seeds, num_updates]``. With
    ``seed_mesh`` this rank trains its slice's seeds alone: ``states`` holds
    theirs and None for the others', ``metrics`` every seed's."""
    seeds = seed_range(num_seeds, seed_mesh)
    _, states, metrics = _trial(env_cfg, tcfg, num_seeds, arch,
                                resolve_device(device), seed_mesh)
    out = [None] * num_seeds
    out[seeds.start:seeds.stop] = states
    return out, metrics


def _write(rows: list, out_path: str | None, seed_mesh=None) -> None:
    """The rows as JSONL, by the mesh's rank 0 alone."""
    if seed_mesh is not None and seed_mesh.rank != 0:
        return
    if out_path:
        with open(out_path, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


def run_sweep(
    env_cfg: EnvConfig,
    base_tcfg: TrainConfig,
    grid: dict[str, Sequence[Any]],
    num_seeds: int = 1,
    arch: str = "mlp",
    select_metric: str = "deliveries_per_env_step",
    last_k: int = 10,
    out_path: str | None = None,
    mode: str = "max",
    search: str = "grid",
    num_samples: int = 8,
    search_seed: int = 0,
    seed_mesh=None,
    device=None,
):
    """Hyperparameter sweep. `search="grid"` takes the cartesian product
    of `grid`'s value lists; `search="random"` draws `num_samples`
    points from `grid` treated as a distribution spec (`_random_points`).
    Returns (rows, best) where `rows` is the JSONL payload (one dict per
    (trial, seed) + summary) and `best` is the winning trial summary.
    Runs on the card unless ``device="cpu"``."""
    if mode not in ("max", "min"):
        raise ValueError("mode must be 'max' or 'min'")
    seed_range(num_seeds, seed_mesh)
    device = resolve_device(device)
    points = _points(grid, search, num_samples, search_seed)
    if not points:
        raise ValueError("empty grid")
    rows: list[dict[str, Any]] = []
    trial_scores: list[float] = []
    backends = []
    for i, point in enumerate(points):
        tcfg = base_tcfg.replace(**point)
        trainer, _, metrics = _trial(env_cfg, tcfg, num_seeds, arch, device,
                                     seed_mesh)
        backends.append(trainer.backends)
        curve = metrics[select_metric]                 # [S, n]
        k = min(last_k, curve.shape[1])
        per_seed = curve[:, -k:].mean(axis=1)          # [S]
        for s in range(num_seeds):
            rows.append({
                "trial": i,
                "overrides": point,
                "seed": s,
                "score": float(per_seed[s]),
                "final": {m: float(v[s, -1]) for m, v in metrics.items()},
                "backends": trainer.backends,
            })
        trial_scores.append(float(per_seed.mean()))
    sign = 1.0 if mode == "max" else -1.0
    best_i = int(np.argmax([sign * s for s in trial_scores]))
    seed_scores = [r["score"] for r in rows if r["trial"] == best_i]
    best = {
        "summary": True,
        "select_metric": select_metric,
        "mode": mode,
        "num_trials": len(points),
        "num_seeds": num_seeds,
        "best_trial": best_i,
        "best_overrides": points[best_i],
        "best_score_mean": trial_scores[best_i],
        "best_score_std": float(np.std(seed_scores)),
        "all_scores": trial_scores,
        "backends": backends[best_i],
    }
    rows.append(best)
    _write(rows, out_path, seed_mesh)
    return rows, best


def run_asha(
    env_cfg: EnvConfig,
    base_tcfg: TrainConfig,
    grid: dict[str, Sequence[Any]],
    rung_updates: Sequence[int] = (10, 20, 40),
    eta: int = 2,
    num_seeds: int = 1,
    arch: str = "mlp",
    select_metric: str = "deliveries_per_env_step",
    last_k: int = 5,
    out_path: str | None = None,
    mode: str = "max",
    search: str = "grid",
    num_samples: int = 8,
    search_seed: int = 0,
    seed_mesh=None,
    device=None,
):
    """Successive-halving scheduler (Ray Tune ASHA/HyperBand parity).

    All trials train `rung_updates[0]` updates, then only the top
    `1/eta` fraction (by `select_metric`, seed-averaged over the last
    `last_k` updates of the rung) continue into the next rung, and so
    on. Each trial's trainer and runner states persist across rungs, so
    promotion is a plain continuation (no checkpoint round-trip); the
    learning-rate schedule spans all the rungs. Returns (rows, best); rows
    include one record per (trial, rung) with the rung score and survival
    flag. Runs on the card unless ``device="cpu"``.
    """
    if mode not in ("max", "min"):
        raise ValueError("mode must be 'max' or 'min'")
    seeds = seed_range(num_seeds, seed_mesh)
    device = resolve_device(device)
    points = _points(grid, search, num_samples, search_seed)
    if not points:
        raise ValueError("empty search space")
    sign = 1.0 if mode == "max" else -1.0

    trials = []
    for point in points:
        overrides = {**point, "num_updates": int(sum(rung_updates))}
        tcfg = base_tcfg.replace(**overrides)
        trainer = make_train(env_cfg, tcfg, arch=arch, device=device)
        trials.append({"trainer": trainer, "point": point,
                       "rs": init_seeds(trainer, tcfg, num_seeds, seeds)})

    rows: list[dict[str, Any]] = []
    alive = list(range(len(trials)))
    scores: dict[int, float] = {}
    for rung, n in enumerate(rung_updates):
        for i in alive:
            t = trials[i]
            t["rs"], metrics = _train_seeds(t["trainer"], t["rs"], n)
            curve = _gather_seeds(metrics, seed_mesh)[select_metric]  # [S, n]
            k = min(last_k, curve.shape[1])
            scores[i] = float(curve[:, -k:].mean(axis=1).mean())
        ranked = sorted(alive, key=lambda i: sign * scores[i], reverse=True)
        keep = max(1, len(alive) // eta) if rung < len(rung_updates) - 1 \
            else len(alive)
        survivors = set(ranked[:keep])
        for i in alive:
            rows.append({
                "trial": i, "rung": rung, "overrides": trials[i]["point"],
                "updates_so_far": int(sum(rung_updates[:rung + 1])),
                "score": scores[i], "promoted": i in survivors,
                "backends": trials[i]["trainer"].backends,
            })
        alive = [i for i in ranked if i in survivors]
    best_i = alive[0]
    best = {
        "summary": True, "scheduler": "asha", "select_metric": select_metric,
        "mode": mode, "eta": eta, "rung_updates": list(rung_updates),
        "num_trials": len(points), "num_seeds": num_seeds,
        "best_trial": best_i, "best_overrides": points[best_i],
        "best_score": scores[best_i],
        "backends": trials[best_i]["trainer"].backends,
    }
    rows.append(best)
    _write(rows, out_path, seed_mesh)
    return rows, best


def main(argv: Sequence[str] | None = None) -> None:
    from ..configs_cli import (add_device_args, add_env_args,
                               device_from_args, env_config_from_args)

    p = argparse.ArgumentParser(
        prog="python -m warehouse_tpu_torch.train.sweep",
        description="Grid / random hyperparameter sweep, seeds in turn",
    )
    add_env_args(p)
    add_device_args(p)
    p.add_argument("--grid", required=True,
                   help='JSON, e.g. \'{"learning_rate": [3e-4, 1e-3]}\'')
    p.add_argument("--seeds", type=int, default=2)
    p.add_argument("--updates", type=int, default=50)
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--unroll", type=int, default=16)
    p.add_argument("--arch", default="mlp",
                   choices=["mlp", "cnn", "attn"])
    p.add_argument("--select", default="deliveries_per_env_step")
    p.add_argument("--mode", default="max", choices=["max", "min"])
    p.add_argument("--search", default="grid", choices=["grid", "random"])
    p.add_argument("--samples", type=int, default=8,
                   help="trial count for --search random")
    p.add_argument("--search-seed", type=int, default=0)
    p.add_argument("--scheduler", default="fifo", choices=["fifo", "asha"],
                   help="asha = successive halving: trials share "
                        "--updates across --rungs, bottom 1-1/eta "
                        "dropped at each rung")
    p.add_argument("--rungs", default="10,20,40",
                   help="comma-separated updates per ASHA rung")
    p.add_argument("--eta", type=int, default=2)
    p.add_argument("--last-k", type=int, default=10)
    p.add_argument("--out", default="sweep.jsonl")
    args = p.parse_args(argv)
    device = device_from_args(args)

    grid = json.loads(args.grid)
    env_cfg = env_config_from_args(args)
    tcfg = TrainConfig(num_envs=args.num_envs, unroll_length=args.unroll,
                       num_updates=args.updates)
    common = dict(
        num_seeds=args.seeds, arch=args.arch, select_metric=args.select,
        last_k=args.last_k, out_path=args.out, mode=args.mode,
        search=args.search, num_samples=args.samples,
        search_seed=args.search_seed, device=device,
    )
    try:
        if args.scheduler == "asha":
            rungs = tuple(int(x) for x in args.rungs.split(","))
            rows, best = run_asha(env_cfg, tcfg, grid, rung_updates=rungs,
                                  eta=args.eta, **common)
        else:
            rows, best = run_sweep(env_cfg, tcfg, grid, **common)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from e
    print(json.dumps(best, indent=2))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``warehouse_tpu_torch/kernels/csrc/`` and

1. ``k1_check``: holds the greedy-rollout kernel (K1) against its plain
   PyTorch twin, bit for bit, on the medium and shelves configs
   (B = 4096, T = 128), then at B = 131072 on one draw stream, and times
   both there;
2. ``k2_check``: holds the act-phase kernel (K2) against the plain engine
   replaying its actions (obs, rewards, deliveries, final state bit-equal)
   and against the plain MLP (logits, values, log-probs within 1e-4), at
   B = 4096, T = 16, hidden 128 x 2, and times it beside its twin;
3. ``k1_episodes`` (main path): 8 greedy episodes through
   ``greedy_rollout`` (draw stream + K1) at B = 131072, T = max_steps =
   128, each from a batched reset, with env-steps/s beside one episode of
   the plain path;
4. ``slice`` (main path): one episode of the acting phase at BASELINE
   config 4 — 8 chunks of K2 with the boundary reset after each — timed
   against the plain path, then ``serve.Policy.compute_actions``.

Each phase prints one JSON line; any failure ends the run with a
non-zero exit. The kernels' launch counts are zeroed just before the main
path and read just after it. The last lines are the kernels' JSON line,
the card's name and power limit from ``nvidia-smi``, and the device line.
There is no CPU path: without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from warehouse_tpu_torch import medium_config, rng, shelves_config
from warehouse_tpu_torch.env.batch import (reset_batch,
                                           reset_truncated_batch,
                                           step_batch)
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import act, build, rollout
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.ops.ppo_update import first_argmax
from warehouse_tpu_torch.serve import Policy

SEED = 0
TOL = 1e-4  # MLP outputs: f32 sums in another order, tanh/exp/log ulps
CHECK_B = 4096      # envs in the kernel-vs-twin checks
EPISODE_B = 131072  # envs per greedy episode (bench.py:70)
EPISODES = 8        # greedy episodes timed (bench.py:93)
SLICE_B, SLICE_T = 4096, 16  # BASELINE config 4: num_envs, unroll_length
HIDDEN = (128, 2)   # BASELINE config 4: hidden_dim, num_layers


def nvidia_smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    out = res.stdout.strip()
    return out.splitlines()[0] if out else (
        f"nvidia-smi failed: {res.stderr.strip()}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """CUDA-event timer over a region of device work, in milliseconds."""

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.end.synchronize()
        self.ms = self.start.elapsed_time(self.end)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def timed(fn, n):
    """Median milliseconds of n runs of ``fn``."""
    times = []
    for _ in range(n):
        with Timer() as tm:
            fn()
        times.append(tm.ms)
    return median(times)


def state_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in STATE_FIELDS)


def bits_equal(x, y) -> bool:
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def max_abs_diff(a, b) -> float:
    return max(float((getattr(a, f).double() - getattr(b, f).double())
                     .abs().max()) for f in STATE_FIELDS)


def reset_envs(cfg, B, seed, dev):
    """Env b resets from fold_in(PRNGKey(seed), b), as bench.py does."""
    keys = rng.fold_in(rng.prng_key(seed, dev), torch.arange(B, device=dev))
    return reset_batch(cfg, keys)


def k1_check(dev):
    """K1 bit-equal to its twin on medium and shelves at B = 4096, then at
    the main path's B = 131072 on one draw stream, both timed there."""
    B = CHECK_B
    for name, cfg in (("medium", medium_config()),
                      ("shelves", shelves_config())):
        T = cfg.max_steps
        state, _ = reset_envs(cfg, B, SEED, dev)
        ks, kd, kr = rollout.greedy_rollout(cfg, state, T)
        ps, pd, pr = rollout.greedy_rollout_reference(cfg, state, T)
        torch.cuda.synchronize()
        require(state_equal(ks, ps), f"K1 {name}: state differs from twin")
        require(torch.equal(kd, pd), f"K1 {name}: deliveries differ")
        require(bits_equal(kr, pr), f"K1 {name}: reward sums differ")
        emit({"phase": "k1_check", "config": name, "B": B, "T": T,
              "bit_equal": True, "deliveries": int(kd.sum())})

    cfg = medium_config()
    B, T = EPISODE_B, cfg.max_steps
    state, _ = reset_envs(cfg, B, SEED, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, T)
    ks, kd, kr = rollout.greedy_steps(cfg, state, u, pick, drop)
    ps, pd, pr = rollout.greedy_steps_reference(cfg, state, u, pick, drop)
    err = max(max_abs_diff(ks, ps), float((kd - pd).abs().max()),
              float((kr - pr).abs().max()))
    require(err == 0.0 and bits_equal(kr, pr),
            f"K1 at B={B}: kernel differs from twin")
    k_ms = timed(lambda: rollout.greedy_steps(cfg, state, u, pick, drop), 5)
    p_ms = timed(lambda: rollout.greedy_steps_reference(cfg, state, u, pick,
                                                        drop), 3)
    emit({"phase": "k1_check", "config": "medium", "B": B, "T": T,
          "bit_equal": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "kernel_env_steps_per_s": B * T / (k_ms / 1e3),
          "plain_env_steps_per_s": B * T / (p_ms / 1e3)})
    return err, k_ms, p_ms


def k2_check(dev, cfg, model):
    B, T, A = CHECK_B, SLICE_T, cfg.num_agents
    state, obs0 = reset_envs(cfg, B, SEED + 1, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, T)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), T,
                                     (5, B * A))
    logits_k = torch.empty(T, B, A, 5, device=dev)
    ks, obs, action, lp, value, reward, delivered = act.act_steps(
        cfg, model, state, u, pick, drop, g, logits=logits_k)
    torch.cuda.synchronize()

    # Dynamics: the plain engine replays the kernel's actions.
    s = state
    require(bits_equal(obs[0], obs0), "K2: first obs differs")
    for t in range(T):
        s, ts = step_batch(cfg, s, action[t])
        require(bits_equal(ts.reward, reward[t]), f"K2: reward t={t}")
        require(torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                            delivered[t]), f"K2: deliveries t={t}")
        if t + 1 < T:
            require(bits_equal(ts.obs, obs[t + 1]), f"K2: obs t={t + 1}")
    require(state_equal(s.replace(t=state.t, key=state.key), ks),
            "K2: final state differs")

    # Policy head: the plain MLP on the kernel's observations.
    with torch.no_grad():
        logits, val = model(obs)
    lp_plain = torch.log_softmax(logits, -1).gather(
        -1, action.long()[..., None])[..., 0]
    err = {"logits": float((logits - logits_k).abs().max()),
           "value": float((val - value).abs().max()),
           "log_prob": float((lp_plain - lp).abs().max())}
    z = logits.reshape(T, B * A, 5).transpose(1, 2) + g       # [T, 5, N]
    top2 = z.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]).reshape(T, B, A) > TOL
    agree = bool(((first_argmax(z, 1).reshape(T, B, A) == action)
                  | ~clear).all())
    require(max(err.values()) <= TOL, f"K2: MLP outputs off by {err}")
    require(agree, "K2: actions differ where the top-two gap is clear")

    # The kernel alone and its twin on the same inputs, main-path shapes.
    k_ms = timed(lambda: act.act_steps(cfg, model, state, u, pick, drop, g),
                 5)
    p_ms = timed(lambda: act.act_steps_reference(cfg, model, state, u, pick,
                                                 drop, g), 3)
    emit({"phase": "k2_check", "B": B, "T": T, "max_abs_err": err,
          "tol": TOL, "actions_agree_where_gap_gt_tol": agree,
          "clear_share": float(clear.float().mean()),
          "kernel_ms": k_ms, "plain_ms": p_ms})
    return max(err.values()), k_ms, p_ms


def k1_episodes(dev):
    """Greedy episodes through ``greedy_rollout`` (draw stream + K1), each
    from a batched reset; the first episode also through the plain path."""
    cfg = medium_config()
    B, T = EPISODE_B, cfg.max_steps
    episode_ms, total_d = [], 0
    for i in range(EPISODES):
        state, _ = reset_envs(cfg, B, 100 + i, dev)
        torch.cuda.synchronize()
        with Timer() as tm:
            final, deliv, rew = rollout.greedy_rollout(cfg, state, T)
        episode_ms.append(tm.ms)
        total_d += int(deliv.sum())
        require(bool((final.t == T).all() and torch.isfinite(rew).all()),
                "K1 episode: bad final step count or reward")
        if i == 0:
            with Timer() as tp:
                plain = rollout.greedy_rollout_reference(cfg, state, T)
            plain_ms = tp.ms
            require(state_equal(final, plain[0])
                    and torch.equal(deliv, plain[1]),
                    "K1 episode differs from the plain path")
    require(total_d > 0, "K1 episodes delivered nothing")
    ms = median(episode_ms)
    emit({"phase": "k1_episodes", "B": B, "T": T, "episodes": EPISODES,
          "episode_ms_median": ms, "episode_ms": episode_ms,
          "plain_episode_ms": plain_ms,
          "env_steps_per_s": B * T / (ms / 1e3),
          "plain_env_steps_per_s": B * T / (plain_ms / 1e3),
          "deliveries_per_env_step": total_d / (EPISODES * B * T)})


def run_slice(dev, cfg, model, rollout_fn):
    """One episode of config-4 acting: 8 chunks + the boundary reset."""
    state, _ = reset_envs(cfg, SLICE_B, SEED + 3, dev)
    key = rng.prng_key(SEED + 4, dev)
    torch.cuda.synchronize()
    deliv, chunk_ms = 0, []
    with Timer() as total:
        for _ in range(cfg.max_steps // SLICE_T):
            with Timer() as tc:
                new, roll, reset_key, key = rollout_fn(cfg, model, state,
                                                       SLICE_T, key)
            chunk_ms.append(tc.ms)
            state, obs, _ = reset_truncated_batch(cfg, new, reset_key)
            deliv += int(roll.delivered.sum())
    require(bool((state.t == 0).all()), "slice: envs were not reset")
    require(bool(torch.isfinite(roll.value).all()
                 and torch.isfinite(roll.log_prob).all()),
            "slice: non-finite policy outputs")
    return total.ms, chunk_ms, deliv, obs


def slice_phase(dev, cfg, model):
    B, steps = SLICE_B, SLICE_B * cfg.max_steps
    k_ms, k_chunks, k_del, obs = run_slice(dev, cfg, model, act.ppo_rollout)
    p_ms, p_chunks, p_del, _ = run_slice(dev, cfg, model,
                                         act.ppo_rollout_reference)
    require(k_del > 0, "slice delivered nothing")

    # Serving on the post-episode observations.
    acts, _ = Policy(cfg, model).compute_actions(obs)
    with torch.no_grad():
        logits, _ = model(obs)
    require(acts.shape == (B, cfg.num_agents) and acts.dtype == torch.int32,
            "serve: bad action shape")
    require(torch.equal(acts, first_argmax(logits, -1).to(torch.int32)),
            "serve: actions differ from the argmax of the plain logits")
    emit({"phase": "slice", "B": B, "T": SLICE_T,
          "chunks": cfg.max_steps // SLICE_T,
          "kernel_ms": k_ms, "plain_ms": p_ms,
          "kernel_chunk_ms": k_chunks, "plain_chunk_ms": p_chunks,
          "kernel_env_steps_per_s": steps / (k_ms / 1e3),
          "plain_env_steps_per_s": steps / (p_ms / 1e3),
          "kernel_deliveries_per_env_step": k_del / steps,
          "plain_deliveries_per_env_step": p_del / steps,
          "serve_batch": [B, cfg.num_agents, cfg.obs_dim]})


def main() -> int:
    print(nvidia_smi(), flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    t0 = time.perf_counter()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    print(build.build_log(), file=sys.stderr)

    k1_err, k1_ms, k1_plain_ms = k1_check(dev)
    cfg = medium_config()
    model = make_model(cfg, hidden_dim=HIDDEN[0], num_layers=HIDDEN[1],
                       generator=torch.Generator().manual_seed(SEED),
                       device=dev)
    k2_err, k2_ms, k2_plain_ms = k2_check(dev, cfg, model)

    # ---- the main path: counts from here on only ----------------------
    rollout.greedy_steps.launches = 0
    act.act_steps.launches = 0
    k1_episodes(dev)
    slice_phase(dev, cfg, model)
    launches = {"greedy_rollout": rollout.greedy_steps.launches,
                "ppo_rollout": act.act_steps.launches}
    require(all(n > 0 for n in launches.values()),
            f"a kernel of the main path never launched: {launches}")

    csrc = "warehouse_tpu_torch/kernels/csrc/"
    emit({"kernels": [
        {"name": "greedy_rollout", "route": "cuda",
         "source": csrc + "rollout.cu",
         "replaces": "warehouse_tpu/pallas/rollout.py:516",
         "launches": launches["greedy_rollout"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "ppo_rollout", "route": "cuda", "source": csrc + "act.cu",
         "replaces": "warehouse_tpu/pallas/act.py:1028",
         "launches": launches["ppo_rollout"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

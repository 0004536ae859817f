#!/usr/bin/env python3
"""Time one of the PyTorch/CUDA port's kernels from several source trees in
turns on one GPU, with its device time split by kernel, and hash the
outputs of the kernels the trees should share bit for bit: a chunk of the
feed-forward acting kernels K2 (the MLP policy) or K10 (the CNN policy),
a chunk of the recurrent acting kernel K7, the IMPALA learner K5 with K6
inside it, or a greedy episode of K1.

    python tools/torch_ab.py [--kernel k1|k2|k5|k7|k10] PARENT_TREE . . PARENT_TREE

Each tree argument is a directory that holds ``chip_smoke.py`` and
``warehouse_tpu_torch/``; each runs in a process of its own (the trees'
packages share a name), which builds that tree's kernels and then, with
that tree's ``chip_smoke`` helpers (seeded models, resets and draw
streams):

- runs one chunk of T = 16 steps of each of K2's and K10's seven
  instances and hashes its outputs; for the selected kernel (``--kernel``,
  K10 by default) it also times each instance (the median of 5 chunks by
  CUDA events after one of warm-up, the wrapper inside) and splits one
  chunk's device time by kernel name with ``torch.profiler``
  (milliseconds and launches per chunk). K2's instances: BASELINE config
  4 (B = 4096, 106 -> 128 -> 128 -> 6), the same with the groups ``(0, 1,
  0, 1)`` and at hidden 256, the shelves recipe (6 agents, masked and
  shaped from a mid-episode state, B = 4096), the shelves groups recipe
  ``(0, 0, 0, 1, 1, 1)`` and the shelves global recipe (D = 611), both
  masked, shaped, B = 2048, and medium's global view (D = 411, B = 4096).
  K10's: the 9x9 global view (S = 9, D = 411, hidden 128), the same with
  the groups ``(0, 1, 0, 1)``, config 4 (the 5x5 window), config 4 with
  one policy per agent ``(0, 1, 2, 3)``, the shelves recipe, the shelves
  groups recipe (B = 2048) and the 8-agent preset with one policy per
  agent (masked, shaped, B = 4096);
- hashes the outputs of the other kernels: one K1 greedy episode (B =
  4096), one K3 phase (float32 and bf16, K4 inside it), one K5 phase
  (Adam), one K6 gradient, one K7 chunk (the GRU), one K8 phase (the GRU,
  float32, K9 inside it, on a trajectory from K7's plain twin) and one K11
  phase (float32 and bf16, K12 inside it), all at config 4; and the env
  kernels at each of the four presets (small, medium, large, shelves: the
  instances of the library): one K1 greedy episode and one chunk each of
  K2, K10 and K7 (the GRU, from a random carry) at B = 1024
  (``preset_*``); and, at config 4, the widths and depths the kernels
  took once any ran (``t6_*``): K2 at 5 hidden layers, K3 (float32 and
  bf16) and K5 (Adam, K6 inside them) at 5 hidden layers, one K6 gradient
  there, K7 (the GRU) at hidden 50 and at 4 encoder layers, K8 (float32
  and bf16; the GRU, K9 inside it) at hidden 50 and K8 at 4 encoder
  layers, K10 and K11 (float32 and bf16) at trunk width 50; and the
  meshed learners at world 1 (``t6_mesh1_*``: an NCCL group of the child
  alone, each step's gradient averaged over it before the clip step), one
  phase each of K3, K11, K8 (the GRU), K5 (Adam and RMSProp) at config 4,
  K3 at 5 hidden layers and K8 at hidden 50. A tree whose
  kernels or helpers do not take one records it as ``"refused: <the
  exception's type>"``;
- with ``--kernel k7``, times and hashes one K7 chunk (T = 16, B = 4096,
  106 -> 128, cell 128, from a reset and a random carry) for the GRU and
  the LSTM at config 4 and for the GRU on shelves with action masking
  (the median of 5 by CUDA events after one run of warm-up, the wrapper
  inside, and one chunk's device time split by kernel);
- with ``--kernel k1``, times and hashes one greedy episode through
  ``kernels.rollout.greedy_rollout`` (T = 128 from a batched reset, the
  draws and the kernel: whatever the tree's wrapper runs) at B = 131072
  on medium and at B = 4096 on shelves (the median of 5 by CUDA events
  after one run that is hashed, the wrapper inside, and one episode's
  device time split by kernel);
- with ``--kernel k5``, times and hashes one phase of K5 (one pass of M =
  4 minibatches, Adam and RMSProp; K6's gradient kernels inside it) and
  one K6 gradient (minibatch 1), each on ``chip_smoke.impala_inputs``'
  trajectory at config 4 and at hidden 256 (the median of 5 by CUDA
  events after one run of warm-up, the wrapper inside, and one run's
  device time split by kernel with ``torch.profiler``).

Each process prints one line ``{"tree": ..., "kernel": "k1" | "k2" | "k5" |
"k7" | "k10",
"times": {instance: {"ms": ..., "split": {kernel: [ms, launches]}}},
"sha256": {kernel_instance: hex}}``; equal hashes are the same bits. This
script prints the card's name and power limit first. Comparing two trees
is only sound inside one run on one card (turns: A, B, B, A).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = """
import hashlib, json, os, sys, tempfile, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from warehouse_tpu_torch.parallel.distributed import process_group
from torch.profiler import ProfilerActivity, profile
from warehouse_tpu_torch import (large_config, medium_config,
                                 shelves_config, small_config)
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.optim import make_impala_optimizer
from warehouse_tpu_torch.kernels import (act_rnn, build, rollout, sgd,
                                         sgd_cnn, sgd_rnn, vtrace_sgd)
dev = torch.device("cuda", 0)
build.library()
cfg = medium_config()
shelves = shelves_config()
large = large_config()
medium_g = cfg.replace(global_obs=True)


def leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in leaves(v)]
    return []


def sha(*trees):
    h = hashlib.sha256()
    for x in leaves(trees):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def split_of(run):
    # A kernel's name up to its argument list: the template arguments tell
    # the instances apart (rows_gemm_kernel<false, 0> and <false, 2>).
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    out = {{}}
    for e in prof.key_averages():
        ms = getattr(e, "device_time_total", 0.0) / 1e3
        if ms > 0 and e.device_type.name != "CPU":
            key = e.key.replace("(anonymous namespace)::", "")[:70]
            got = out.setdefault(key, [0.0, 0])
            got[0] += ms
            got[1] += e.count
    return out


def chunk_sha(out):
    return sha([getattr(out[0], f) for f in cs.STATE_FIELDS] + list(out[1:]))


def chunk_inputs(model, c, B, groups, shaped):
    # chip_smoke.k2_check's inputs: a reset (with shaping, then one chunk
    # to a mid-episode state), the chunk's draws and gumbel noise.
    state, _ = cs.reset_envs(c, B, cs.SEED + 1, dev)
    if shaped:
        state, _ = cs.shaped_start(c, model, state, False, dev, groups)
    T, A = cs.SLICE_T, c.num_agents
    _, u, pick, drop, _ = cs.rng.batched_step_draws(state.key, c, T)
    _, g = cs.rng.batched_gumbel_stream(cs.rng.prng_key(cs.SEED + 2, dev), T,
                                        (5, B * A))
    kw = {{}} if groups is None else {{"groups": groups}}
    if shaped:
        done = ((state.t[None] + 1 + torch.arange(T, device=dev)[:, None])
                >= c.max_steps).to(torch.float32)
        kw["mask"] = torch.empty(T, B, A, 5, dtype=torch.bool, device=dev)
        kw["shaping"] = cs.act.Shaping(*cs.SHAPING, done,
                                       torch.empty(T, B, A, device=dev))
    return (c, model, state, u, pick, drop, g), kw


def k2_model(c, hidden, groups):
    if groups is not None:
        return cs.groups_model(c, groups, dev)
    return make_model(c, hidden_dim=hidden, num_layers=cs.HIDDEN[1],
                      generator=torch.Generator().manual_seed(cs.SEED),
                      device=dev)


def k10_model(c, hidden, groups):
    return (cs.cnn_model(c, dev) if groups is None
            else cs.cnn_groups_model(c, groups, dev))


shelves_g = shelves.replace(global_obs=True)
H = cs.HIDDEN[0]
CASES = {{  # kernel: (wrapper, model, {{instance: (config, B, groups,
    #                                       masked and shaped, hidden)}})
    "k2": (cs.act.act_steps, k2_model, {{
        "config4": (cfg, cs.CHECK_B, None, False, H),
        "config4_groups": (cfg, cs.CHECK_B, cs.CONFIG4_GROUPS, False, H),
        "config4_hidden256": (cfg, cs.CHECK_B, None, False, 256),
        "shelves": (shelves, cs.CHECK_B, None, True, H),
        "shelves_groups": (shelves, cs.GROUPS_B, cs.GROUPS, True, H),
        "shelves_global": (shelves_g, cs.GLOBAL_B, None, True, H),
        "medium_global": (medium_g, cs.CHECK_B, None, False, H)}}),
    "k10": (cs.act.act_cnn_steps, k10_model, {{
        "global": (medium_g, cs.CHECK_B, None, False, H),
        "global_groups": (medium_g, cs.CHECK_B, cs.CONFIG4_GROUPS, False, H),
        "config4": (cfg, cs.CHECK_B, None, False, H),
        "config4_per_agent": (cfg, cs.CHECK_B, cs.PER_AGENT, False, H),
        "shelves": (shelves, cs.CHECK_B, None, True, H),
        "shelves_groups": (shelves, cs.GROUPS_B, cs.GROUPS, True, H),
        "large_per_agent": (large, cs.CHECK_B,
                            tuple(range(large.num_agents)), True, H)}})}}
times, out = {{}}, {{}}
for kernel, (steps, model_of, cases) in CASES.items():
    for name, (c, B, groups, shaped, hidden) in cases.items():
        args, kw = chunk_inputs(model_of(c, hidden, groups), c, B, groups,
                                shaped)
        run = lambda: steps(*args, **kw)
        res = run()
        out[kernel + "_" + name] = chunk_sha(res) if not shaped else sha(
            [getattr(res[0], f) for f in cs.STATE_FIELDS] + list(res[1:])
            + [kw["mask"], kw["shaping"].raw_reward])
        if kernel == {kernel!r}:
            times[name] = {{"ms": cs.timed(run, 5), "split": split_of(run)}}
        del args, kw, res


def phase_args(tcfg, tr, rs, traj, adv_n, targets, ent, *lead):
    E, M = tcfg.ppo_epochs, tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, E * M, dev)
    args = (rs.params, rs.opt_state, traj, adv_n, targets, *lead, *rows, ent,
            rs.kl_coeff)
    kw = dict(num_epochs=E, num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
              mask_actions=tcfg.mask_actions)
    return args, kw


# K3: one config-4 phase, float32 and bf16.
args, kw = phase_args(*cs.sgd_inputs(dev, cfg))
for dtype in ("float32", "bfloat16"):
    out["k3_" + dtype] = sha(sgd.ppo_sgd_phase(
        *args, **dict(kw, matmul_dtype=dtype)))
del args, kw

# K5 (Adam, 1 pass) and K6 on one config-4 IMPALA trajectory.
tcfg, params, traj, last_obs, vkw = cs.impala_inputs(dev, cfg)
M = tcfg.num_minibatches
tc = tcfg.replace(impala_rmsprop=False, impala_passes=1)
optimizer = make_impala_optimizer(tc)
opt = optimizer.init(params)
rows = optimizer.step_rows(opt.count, M, dev)
out["k5_adam"] = sha(vtrace_sgd.impala_sgd_phase(
    params, opt, traj, last_obs, rows, tc.entropy_coef, num_passes=1,
    num_minibatches=M, max_grad_norm=tc.max_grad_norm, **vkw))
out["k6"] = sha(vtrace_sgd.impala_minibatch_grads(
    params, traj, last_obs, 1, tcfg.entropy_coef, num_minibatches=M, **vkw))
del params, traj, last_obs
if {kernel!r} == "k5":
    # K5 (1 pass of Adam, of RMSProp) and one K6 gradient at config 4 and
    # at hidden 256, each timed after one run of warm-up.
    for hname, hidden in (("config4", cs.HIDDEN[0]), ("hidden256", 256)):
        tcfg, params, traj, last_obs, vkw = cs.impala_inputs(dev, cfg, hidden)
        M = tcfg.num_minibatches
        runs = {{}}
        for oname, rms in (("adam", False), ("rmsprop", True)):
            tc = tcfg.replace(impala_rmsprop=rms, impala_passes=1)
            optimizer = make_impala_optimizer(tc)
            opt = optimizer.init(params)
            rows = optimizer.step_rows(opt.count, M, dev)
            runs[oname] = (lambda tc=tc, opt=opt, rows=rows:
                           vtrace_sgd.impala_sgd_phase(
                               params, opt, traj, last_obs, rows,
                               tc.entropy_coef, num_passes=1,
                               num_minibatches=M,
                               max_grad_norm=tc.max_grad_norm, **vkw))
        runs["k6"] = lambda: vtrace_sgd.impala_minibatch_grads(
            params, traj, last_obs, 1, tcfg.entropy_coef, num_minibatches=M,
            **vkw)
        for rname, run in runs.items():
            out[f"k5_{{hname}}_{{rname}}"] = sha(run())
            times[f"{{hname}}_{{rname}}"] = {{"ms": cs.timed(run, 5),
                                            "split": split_of(run)}}
        del params, traj, last_obs, runs

# K8: one GRU phase, float32, on a trajectory from K7's plain twin, so
# that its inputs do not follow K7's bits.
k7_rollout = cs.act_rnn.ppo_rnn_rollout
cs.act_rnn.ppo_rnn_rollout = cs.act_rnn.ppo_rnn_rollout_reference
try:
    tcfg, tr, rs, traj, adv_n, targets, h0, ent = cs.rnn_inputs(dev, cfg,
                                                                "gru")
finally:
    cs.act_rnn.ppo_rnn_rollout = k7_rollout
args, kw = phase_args(tcfg, tr, rs, traj, adv_n, targets, ent, h0)
kw.update(mask_actions=False, matmul_dtype="float32")
out["k8_float32"] = sha(sgd_rnn.ppo_rnn_sgd_phase(*args, **kw))
del args, kw, traj, adv_n, targets, h0, tr, rs

# K11: one phase, float32 and bf16.
args, kw = phase_args(*cs.sgd_inputs(dev, cfg, "cnn", cs.CNN_SCHEDULE))
out["k11_float32"] = sha(sgd_cnn.ppo_cnn_sgd_phase(*args, **kw))
out["k11_bfloat16"] = sha(sgd_cnn.ppo_cnn_sgd_phase(
    *args, **dict(kw, matmul_dtype="bfloat16")))
del args, kw


def t6(name, fn):
    try:
        out["t6_" + name] = fn()
    except Exception as e:  # a tree that does not take the shape
        out["t6_" + name] = "refused: " + type(e).__name__


def t6_rnn(shape, dtype, arch="gru", mesh=None):
    k7_rollout = cs.act_rnn.ppo_rnn_rollout
    cs.act_rnn.ppo_rnn_rollout = cs.act_rnn.ppo_rnn_rollout_reference
    try:
        tcfg, tr, rs, traj, adv_n, targets, h0, ent = cs.rnn_inputs(
            dev, cfg, arch, dtype == "bfloat16", shape=shape)
    finally:
        cs.act_rnn.ppo_rnn_rollout = k7_rollout
    args, kw = phase_args(tcfg, tr, rs, traj, adv_n, targets, ent, h0)
    kw.update(mask_actions=False, matmul_dtype=dtype)
    if mesh is not None:
        kw["mesh"] = mesh
    return sha(sgd_rnn.ppo_rnn_sgd_phase(*args, **kw))


def t6_k7(shape):
    model = make_model(cfg, "gru", *shape,
                       torch.Generator().manual_seed(cs.SEED), dev)
    params = {{k: v.detach() for k, v in model.state_dict().items()}}
    state, u, pick, drop, g = draws(cfg, cs.CHECK_B)
    carry = (0.5 * torch.randn(cs.CHECK_B, cfg.num_agents, shape[0],
                               generator=torch.Generator().manual_seed(
                                   cs.SEED + 9))).to(dev)
    return chunk_sha(act_rnn.act_rnn_steps(cfg, params, state, carry, u,
                                           pick, drop, g))


def t6_chunk(arch, shape):
    model = make_model(cfg, arch, *shape,
                       torch.Generator().manual_seed(cs.SEED), dev)
    steps = cs.act.act_cnn_steps if arch == "cnn" else cs.act.act_steps
    args, kw = chunk_inputs(model, cfg, cs.CHECK_B, None, False)
    return chunk_sha(steps(*args, **kw))


def t6_impala(layers, mesh=None, rms=False):
    tcfg, params, traj, last_obs, vkw = cs.impala_inputs(dev, cfg,
                                                         layers=layers)
    M = tcfg.num_minibatches
    tc = tcfg.replace(impala_rmsprop=rms, impala_passes=1)
    optimizer = make_impala_optimizer(tc)
    opt = optimizer.init(params)
    rows = optimizer.step_rows(opt.count, M, dev)
    return (sha(vtrace_sgd.impala_sgd_phase(
        params, opt, traj, last_obs, rows, tc.entropy_coef, num_passes=1,
        num_minibatches=M, max_grad_norm=tc.max_grad_norm, mesh=mesh,
        **vkw)),
        sha(vtrace_sgd.impala_minibatch_grads(
            params, traj, last_obs, 1, tcfg.entropy_coef, num_minibatches=M,
            **vkw)))


def t6_phase(arch, shape, dtype, mesh=None):
    sched = cs.CNN_SCHEDULE if arch == "cnn" else cs.TRAIN_SCHEDULE
    tcfg = cs.TrainConfig(num_updates=sched, hidden_dim=shape[0],
                          num_layers=shape[1])
    args, kw = phase_args(*cs.sgd_inputs(dev, cfg, arch, sched, tcfg))
    if mesh is not None:
        kw["mesh"] = mesh
    phase = sgd_cnn.ppo_cnn_sgd_phase if arch == "cnn" else sgd.ppo_sgd_phase
    return sha(phase(*args, **dict(kw, matmul_dtype=dtype)))


def draws(c, B):
    state, _ = cs.reset_envs(c, B, cs.SEED + 1, dev)
    _, u, pick, drop, _ = cs.rng.batched_step_draws(state.key, c, cs.SLICE_T)
    _, g = cs.rng.batched_gumbel_stream(cs.rng.prng_key(cs.SEED + 2, dev),
                                        cs.SLICE_T, (5, B * c.num_agents))
    return state, u, pick, drop, g


# T-6's instances (5 hidden layers; num_layers 5: 4 encoder layers).
H50, DEEP = (50, cs.HIDDEN[1]), (cs.HIDDEN[0], 5)
t6("k2_deep5", lambda: t6_chunk("mlp", DEEP))
for dtype in ("float32", "bfloat16"):
    t6("k3_deep5_" + dtype, lambda: t6_phase("mlp", DEEP, dtype))
    t6("k11_h50_" + dtype, lambda: t6_phase("cnn", H50, dtype))
    t6("k8_h50_" + dtype, lambda: t6_rnn(H50, dtype))
t6("k5_k6_deep5", lambda: t6_impala(5))
t6("k7_h50", lambda: t6_k7(H50))
t6("k7_enc4", lambda: t6_k7(DEEP))
t6("k8_enc4_float32", lambda: t6_rnn(DEEP, "float32"))
t6("k10_h50", lambda: t6_chunk("cnn", H50))

# The meshed learners at world 1 (an NCCL group of this process alone on a
# file store): each step's gradient averaged over the one rank before the
# clip step, at the shapes of mesh_world1_train (K3, K11, K8 GRU, K5 Adam;
# K5 RMSProp too) and of T-6's meshed paths (K3 at 5 layers, K8 GRU at
# hidden 50).
with tempfile.TemporaryDirectory() as tmp, process_group(
        os.path.join(tmp, "store"), backend="nccl") as mesh1:
    t6("mesh1_k3", lambda: t6_phase("mlp", cs.HIDDEN, "float32", mesh1))
    t6("mesh1_k11", lambda: t6_phase("cnn", cs.HIDDEN, "float32", mesh1))
    t6("mesh1_k8", lambda: t6_rnn(cs.HIDDEN, "float32", mesh=mesh1))
    t6("mesh1_k5_adam", lambda: t6_impala(cs.HIDDEN[1], mesh1))
    t6("mesh1_k5_rmsprop", lambda: t6_impala(cs.HIDDEN[1], mesh1, True))
    t6("mesh1_k3_deep5", lambda: t6_phase("mlp", DEEP, "float32", mesh1))
    t6("mesh1_k8_h50", lambda: t6_rnn(H50, "float32", mesh=mesh1))

model = make_model(cfg, "gru", cs.HIDDEN[0], cs.HIDDEN[1],
                   torch.Generator().manual_seed(cs.SEED), dev)
params = {{k: v.detach() for k, v in model.state_dict().items()}}
state, u, pick, drop, g = draws(cfg, cs.CHECK_B)
carry = (0.5 * torch.randn(cs.CHECK_B, cfg.num_agents, cs.HIDDEN[0],
                           generator=torch.Generator().manual_seed(
                               cs.SEED + 9))).to(dev)
out["k7"] = chunk_sha(act_rnn.act_rnn_steps(cfg, params, state, carry, u,
                                            pick, drop, g))
if {kernel!r} == "k7":
    # K7 chunks: the GRU and the LSTM at config 4, the masked GRU on
    # shelves, each from a reset and a random carry.
    for name, (c, arch, masked) in (("gru", (cfg, "gru", False)),
                                    ("lstm", (cfg, "lstm", False)),
                                    ("shelves_gru_masked",
                                     (shelves, "gru", True))):
        model = make_model(c, arch, cs.HIDDEN[0], cs.HIDDEN[1],
                           torch.Generator().manual_seed(cs.SEED), dev)
        params = {{k: v.detach() for k, v in model.state_dict().items()}}
        state, u, pick, drop, g = draws(c, cs.CHECK_B)
        gen = torch.Generator().manual_seed(cs.SEED + 9)
        carry = tuple((0.5 * torch.randn(cs.CHECK_B, c.num_agents,
                                         cs.HIDDEN[0], generator=gen)).to(dev)
                      for _ in range(2 if arch == "lstm" else 1))
        carry = carry if arch == "lstm" else carry[0]
        mask = (torch.empty(cs.SLICE_T, cs.CHECK_B, c.num_agents, 5,
                            dtype=torch.bool, device=dev) if masked else None)
        run = (lambda c=c, params=params, state=state, carry=carry, u=u,
               pick=pick, drop=drop, g=g, mask=mask: act_rnn.act_rnn_steps(
                   c, params, state, carry, u, pick, drop, g, mask=mask))
        res = run()
        out["k7_" + name] = sha([getattr(res[0], f) for f in cs.STATE_FIELDS]
                                + list(res[1:]) + [mask])
        times[name] = {{"ms": cs.timed(run, 5), "split": split_of(run)}}
        del res, run
# K1: one greedy episode of 4096 config-4 envs.
state, _ = cs.reset_envs(cfg, cs.CHECK_B, cs.SEED, dev)
out["k1"] = chunk_sha(rollout.greedy_rollout(cfg, state, cfg.max_steps))
if {kernel!r} == "k1":
    # Greedy episodes: B = 131072 on medium (the main path's), B = 4096 on
    # shelves.
    for name, c, B in (("medium", cfg, cs.EPISODE_B),
                       ("shelves", shelves, cs.CHECK_B)):
        state, _ = cs.reset_envs(c, B, cs.SEED, dev)
        run = lambda c=c, state=state: rollout.greedy_rollout(c, state,
                                                              c.max_steps)
        out["k1_" + name] = chunk_sha(run())
        times[name] = {{"ms": cs.timed(run, 5), "split": split_of(run)}}
        del state, run
# K1, K2, K10 and K7 (GRU) at each of the four presets, the instances the
# library holds: one greedy episode and one chunk each at B = 1024.
for pname, c in (("small", small_config()), ("medium", cfg),
                 ("large", large), ("shelves", shelves)):
    state, _ = cs.reset_envs(c, 1024, cs.SEED, dev)
    out["preset_k1_" + pname] = chunk_sha(rollout.greedy_rollout(
        c, state, c.max_steps))
    state, u, pick, drop, g = draws(c, 1024)
    for kname, arch, steps in (("k2", "mlp", cs.act.act_steps),
                               ("k10", "cnn", cs.act.act_cnn_steps)):
        model = make_model(c, arch, cs.HIDDEN[0], cs.HIDDEN[1],
                           torch.Generator().manual_seed(cs.SEED), dev)
        out[f"preset_{{kname}}_{{pname}}"] = chunk_sha(steps(
            c, model, state, u, pick, drop, g))
    model = make_model(c, "gru", cs.HIDDEN[0], cs.HIDDEN[1],
                       torch.Generator().manual_seed(cs.SEED), dev)
    params = {{k: v.detach() for k, v in model.state_dict().items()}}
    carry = (0.5 * torch.randn(1024, c.num_agents, cs.HIDDEN[0],
                               generator=torch.Generator().manual_seed(
                                   cs.SEED + 9))).to(dev)
    out["preset_k7_" + pname] = chunk_sha(act_rnn.act_rnn_steps(
        c, params, state, carry, u, pick, drop, g))
print(json.dumps({{"tree": {tree!r}, "kernel": {kernel!r}, "times": times,
                  "sha256": out}}))
"""


def main(argv) -> int:
    kernel = "k10"
    if argv[:1] == ["--kernel"] and len(argv) > 1:
        kernel, argv = argv[1], argv[2:]
    if not argv or kernel not in ("k1", "k2", "k5", "k7", "k10"):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    rc = 0
    for tree in argv:
        tree = os.path.abspath(tree)
        res = subprocess.run(
            [sys.executable, "-c", CHILD.format(tree=tree, kernel=kernel)],
            cwd=tree, capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(json.dumps({"tree": tree, "rc": res.returncode,
                              "stderr": res.stderr[-2000:]}), flush=True)
            rc = res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

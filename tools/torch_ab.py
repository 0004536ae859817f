#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's recurrent SGD phase (K8) from several
source trees in turns on one GPU, with its device time split by kernel,
and hash the outputs of the kernels the trees should share bit for bit.

    python tools/torch_ab.py PARENT_TREE . . PARENT_TREE

Each argument is a directory that holds ``chip_smoke.py`` and
``warehouse_tpu_torch/``; each runs in a process of its own (the trees'
packages share a name), which builds that tree's kernels and then, on
trajectories made by that tree's ``chip_smoke`` (BASELINE config 4:
medium, B = 4096, T = 16, 4 agents, 4 epochs x 4 minibatches of 4096
sequences of 16 steps, hidden 128):

- times K8 (``ppo_rnn_sgd_phase``, the median of 5 phases by CUDA events)
  for the GRU and the LSTM, each in float32 and with
  ``matmul_dtype="bfloat16"`` (from ``chip_smoke.rnn_inputs``: a K7 chunk
  and a random carry, of bf16 values for bf16), and splits one phase's
  device time by kernel name with ``torch.profiler`` (milliseconds and
  launches per phase);
- hashes the outputs (params, Adam moments, losses) of one K3 phase (the
  MLP learner) and of one K11 phase (the CNN learner, float32 and bf16),
  and of one K10 chunk, ungrouped and with the groups ``(0, 1, 0, 1)``,
  and one K7 chunk (the GRU, float32), all at config 4.

Each process prints one line ``{"tree": ..., "k8": {case: {"ms": ...,
"split": {kernel: [ms, launches]}}}, "k3_sha256": ..., "k11_sha256": ...,
"k11_bf16_sha256": ..., "k10_sha256": ..., "k10_groups_sha256": ...,
"k7_sha256": ...}``; equal hashes are the same bits. This script prints
the card's name and power limit first. Comparing two trees is only sound
inside one run on one card (turns: A, B, B, A).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = """
import hashlib, json, sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from torch.profiler import ProfilerActivity, profile
from warehouse_tpu_torch import medium_config
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.kernels import act_rnn, build, sgd, sgd_cnn, sgd_rnn
dev = torch.device("cuda", 0)
build.library()
cfg = medium_config()


def sha(*trees):
    h = hashlib.sha256()
    for t in trees:
        xs = [t[k] for k in sorted(t)] if isinstance(t, dict) else t
        for x in xs:
            h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def phase_args(tcfg, tr, rs, traj, adv_n, targets, ent, *lead):
    E, M = tcfg.ppo_epochs, tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, E * M, dev)
    args = (rs.params, rs.opt_state, traj, adv_n, targets, *lead, *rows, ent,
            rs.kl_coeff)
    kw = dict(num_epochs=E, num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
              mask_actions=tcfg.mask_actions)
    return args, kw


def phase_sha(fn, args, kw):
    p, o, l = fn(*args, **kw)
    return sha(p, o.mu, o.nu, l)


k8 = {{}}
for arch in ("gru", "lstm"):
    for dtype in ("float32", "bfloat16"):
        bf16 = dtype == "bfloat16"
        tcfg, tr, rs, traj, adv_n, targets, h0, ent = cs.rnn_inputs(
            dev, cfg, arch, bf16)
        args, kw = phase_args(tcfg, tr, rs, traj, adv_n, targets, ent, h0)
        kw.update(mask_actions=False, matmul_dtype=dtype)
        run = lambda: sgd_rnn.ppo_rnn_sgd_phase(*args, **kw)
        run()
        ms = cs.timed(run, 5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        split = {{e.key[:70]: [getattr(e, "device_time_total", 0.0) / 1e3,
                              e.count]
                 for e in prof.key_averages()
                 if getattr(e, "device_time_total", 0.0) > 0
                 and e.device_type.name != "CPU"}}
        k8[arch + "_" + dtype] = {{"ms": ms, "split": split}}
        del args, kw, traj, adv_n, targets, h0, tr, rs
k3 = phase_sha(sgd.ppo_sgd_phase, *phase_args(*cs.sgd_inputs(dev, cfg)))
args, kw = phase_args(*cs.sgd_inputs(dev, cfg, "cnn", cs.CNN_SCHEDULE))
k11 = phase_sha(sgd_cnn.ppo_cnn_sgd_phase, args, kw)
k11_bf16 = phase_sha(sgd_cnn.ppo_cnn_sgd_phase, args,
                     dict(kw, matmul_dtype="bfloat16"))


def digest(c, model, B, **kw):
    state, _ = cs.reset_envs(c, B, cs.SEED + 1, dev)
    _, u, pick, drop, _ = cs.rng.batched_step_draws(state.key, c, cs.SLICE_T)
    _, g = cs.rng.batched_gumbel_stream(cs.rng.prng_key(cs.SEED + 2, dev),
                                        cs.SLICE_T, (5, B * c.num_agents))
    out = cs.act.act_cnn_steps(c, model, state, u, pick, drop, g, **kw)
    return sha([getattr(out[0], f) for f in cs.STATE_FIELDS] + list(out[1:]))


def k7_digest(c, B):
    model = make_model(c, "gru", cs.HIDDEN[0], cs.HIDDEN[1],
                       torch.Generator().manual_seed(cs.SEED), dev)
    params = {{k: v.detach() for k, v in model.state_dict().items()}}
    state, _ = cs.reset_envs(c, B, cs.SEED + 1, dev)
    gen = torch.Generator().manual_seed(cs.SEED + 9)
    carry = (0.5 * torch.randn(B, c.num_agents, cs.HIDDEN[0],
                               generator=gen)).to(dev)
    _, u, pick, drop, _ = cs.rng.batched_step_draws(state.key, c, cs.SLICE_T)
    _, g = cs.rng.batched_gumbel_stream(cs.rng.prng_key(cs.SEED + 2, dev),
                                        cs.SLICE_T, (5, B * c.num_agents))
    out = act_rnn.act_rnn_steps(c, params, state, carry, u, pick, drop, g)
    return sha([getattr(out[0], f) for f in cs.STATE_FIELDS] + list(out[1:]))


print(json.dumps({{"tree": {tree!r}, "k8": k8, "k3_sha256": k3,
                  "k11_sha256": k11, "k11_bf16_sha256": k11_bf16,
                  "k10_sha256": digest(cfg, cs.cnn_model(cfg, dev),
                                       cs.CHECK_B),
                  "k10_groups_sha256": digest(
                      cfg, cs.cnn_groups_model(cfg, cs.CONFIG4_GROUPS, dev),
                      cs.CHECK_B, groups=cs.CONFIG4_GROUPS),
                  "k7_sha256": k7_digest(cfg, cs.CHECK_B)}}))
"""


def main(trees) -> int:
    if not trees:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    rc = 0
    for tree in trees:
        tree = os.path.abspath(tree)
        res = subprocess.run([sys.executable, "-c", CHILD.format(tree=tree)],
                             cwd=tree, capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(json.dumps({"tree": tree, "rc": res.returncode,
                              "stderr": res.stderr[-2000:]}), flush=True)
            rc = res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

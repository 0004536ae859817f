#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's acting kernels (K2, K10 without and with
policy groups), SGD-phase kernel (K3) and the grouped CNN's plain learner
from several source trees in turns, on one GPU.

    python tools/torch_ab.py PARENT_TREE . . PARENT_TREE

Each argument is a directory that holds ``chip_smoke.py`` and
``warehouse_tpu_torch/``; each runs in a process of its own (the trees'
packages share a name), which builds that tree's kernels, times the plain
learner phase of the grouped-CNN shelves recipe (``--arch cnn
--policy-groups 0,0,0,1,1,1``, 2048 envs; the median of updates 2-4 by
CUDA events) under torch's default flags, then calls its
``chip_smoke.k2_check`` and ``k3_check`` at BASELINE config 4 (medium, B =
4096, T = 16, hidden 128 x 2), ``k2_check`` on K2's wide route (the
shelves recipe with global observations: D = 611, B = 2048, masked and
shaped), and ``k2_check`` of the CNN acting kernel (K10) at config 4 and
masked on shelves, and with policy groups at config 4 ``(0, 1, 0, 1)`` and
on the shelves recipe (masked, shaped, B = 2048): the checks against the
plain twins, then the kernels' median times by CUDA events. Each process
prints the checks' JSON lines, then one line ``{"tree": ..., "k2_ms": ...,
"k3_ms": ..., "k2_wide_ms": ..., "k10_ms": ..., "k10_shelves_ms": ...,
"k10_groups_ms": ..., "k10_groups_shelves_ms": ..., "plain_learner_ms":
..., "k10_sha256": ..., "k10_groups_sha256": ...}``, the hashes those of
one K10 chunk's outputs at config 4 and of one grouped chunk at each of the
two group maps (equal hashes: the same bits); this script prints the
card's name and power limit first. Comparing two trees is only sound
inside one run on one card (turns: A, B, B, A).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = """
import hashlib, json, statistics, sys, torch
sys.path.insert(0, {tree!r})
import chip_smoke as cs
from warehouse_tpu_torch import medium_config, shelves_config
from warehouse_tpu_torch.kernels import build
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.train import make_train
dev = torch.device("cuda", 0)
build.library()
shelves = shelves_config()
tr = make_train(shelves, cs.groups_tcfg(), arch="cnn", device=dev,
                policy_groups=cs.GROUPS)
rs, sgd = tr.init(cs.rng.prng_key(0, dev)), []
for _ in range(4):
    marks = cs.Marks()
    rs, _ = tr.train_step(rs, mark=marks)
    sgd.append(marks.split()["sgd"])
# The kernels' twins below compare with TF32 convolutions off.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cfg = medium_config()
model = make_model(cfg, hidden_dim=cs.HIDDEN[0], num_layers=cs.HIDDEN[1],
                   generator=torch.Generator().manual_seed(cs.SEED),
                   device=dev)
k2 = cs.k2_check(dev, "medium", cfg, model)
k3 = cs.k3_check(dev, cfg)
wide_cfg = shelves_config(global_obs=True)
wide_model = make_model(wide_cfg, hidden_dim=cs.HIDDEN[0],
                        num_layers=cs.HIDDEN[1],
                        generator=torch.Generator().manual_seed(cs.SEED),
                        device=dev)
k2w = cs.k2_check(dev, "shelves_global", wide_cfg, wide_model, True,
                  shaped=True, B=2048, phase="global_check", wide=True)
cnn = cs.cnn_model(cfg, dev)
k10 = cs.k2_check(dev, "medium", cfg, cnn)
k10s = cs.k2_check(dev, "shelves", shelves, cs.cnn_model(shelves, dev),
                   mask_actions=True)
m4 = cs.cnn_groups_model(cfg, cs.CONFIG4_GROUPS, dev)
m6 = cs.cnn_groups_model(shelves, cs.GROUPS, dev)
k10g = cs.k2_check(dev, "medium_cnn_groups", cfg, m4,
                   phase="k10_groups_check", groups=cs.CONFIG4_GROUPS)
k10gs = cs.k2_check(dev, "shelves_cnn_groups", shelves, m6, True,
                    shaped=True, B=cs.GROUPS_B, phase="k10_groups_check",
                    groups=cs.GROUPS)


def digest(c, model, B, **kw):
    state, _ = cs.reset_envs(c, B, cs.SEED + 1, dev)
    _, u, pick, drop, _ = cs.rng.batched_step_draws(state.key, c, cs.SLICE_T)
    _, g = cs.rng.batched_gumbel_stream(cs.rng.prng_key(cs.SEED + 2, dev),
                                        cs.SLICE_T, (5, B * c.num_agents))
    out = cs.act.act_cnn_steps(c, model, state, u, pick, drop, g, **kw)
    h = hashlib.sha256()
    for x in [getattr(out[0], f) for f in cs.STATE_FIELDS] + list(out[1:]):
        h.update(x.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


mask = torch.empty(cs.SLICE_T, cs.GROUPS_B, 6, 5, dtype=torch.bool,
                   device=dev)
print(json.dumps({{"tree": {tree!r}, "k2_ms": k2[1], "k3_ms": k3[1],
                  "k2_wide_ms": k2w[1], "k10_ms": k10[1],
                  "k10_shelves_ms": k10s[1], "k10_groups_ms": k10g[1],
                  "k10_groups_shelves_ms": k10gs[1],
                  "plain_learner_ms": statistics.median(sgd[1:]),
                  "k10_sha256": digest(cfg, cnn, cs.CHECK_B),
                  "k10_groups_sha256": [
                      digest(cfg, m4, cs.CHECK_B, groups=cs.CONFIG4_GROUPS),
                      digest(shelves, m6, cs.GROUPS_B, groups=cs.GROUPS,
                             mask=mask)]}}))
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

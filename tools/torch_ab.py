#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's acting kernels (K2, K10) and SGD-phase
kernel (K3) without policy groups from several source trees in turns, on
one GPU.

    python tools/torch_ab.py PARENT_TREE . . PARENT_TREE

Each argument is a directory that holds ``chip_smoke.py`` and
``warehouse_tpu_torch/``; each runs in a process of its own (the trees'
packages share a name), which builds that tree's kernels and calls its
``chip_smoke.k2_check`` and ``k3_check`` at BASELINE config 4 (medium, B =
4096, T = 16, hidden 128 x 2), then ``k2_check`` on K2's wide route (the
shelves recipe with global observations: D = 611, B = 2048, masked and
shaped), and ``k2_check`` of the CNN acting kernel (K10) at config 4 and
masked on shelves: the checks against the plain twins, then the kernels'
median times by CUDA events. Each process prints the checks' JSON lines,
then one line ``{"tree": ..., "k2_ms": ..., "k3_ms": ..., "k2_wide_ms":
..., "k10_ms": ..., "k10_shelves_ms": ..., "k10_sha256": ...}``, the last
the hash of one config-4 K10 chunk's outputs (equal hashes: the same bits);
this script prints the card's name and power limit first. Comparing two
trees is only sound inside one run on one card (turns: A, B, B, A).
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
from warehouse_tpu_torch import medium_config, shelves_config
from warehouse_tpu_torch.kernels import build
from warehouse_tpu_torch.models import make_model
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
build.library()
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
shelves = shelves_config()
k10s = cs.k2_check(dev, "shelves", shelves, cs.cnn_model(shelves, dev),
                   mask_actions=True)
state, _ = cs.reset_envs(cfg, cs.CHECK_B, cs.SEED + 1, dev)
_, u, pick, drop, _ = cs.rng.batched_step_draws(state.key, cfg, cs.SLICE_T)
_, g = cs.rng.batched_gumbel_stream(cs.rng.prng_key(cs.SEED + 2, dev),
                                    cs.SLICE_T, (5, cs.CHECK_B * 4))
out = cs.act.act_cnn_steps(cfg, cnn, state, u, pick, drop, g)
digest = hashlib.sha256()
for x in [getattr(out[0], f) for f in cs.STATE_FIELDS] + list(out[1:]):
    digest.update(x.contiguous().cpu().numpy().tobytes())
print(json.dumps({{"tree": {tree!r}, "k2_ms": k2[1], "k3_ms": k3[1],
                  "k2_wide_ms": k2w[1], "k10_ms": k10[1],
                  "k10_shelves_ms": k10s[1],
                  "k10_sha256": digest.hexdigest()}}))
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

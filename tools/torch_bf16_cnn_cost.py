#!/usr/bin/env python3
"""Where the CNN learner's bf16 route costs time, and whether
chip_smoke.py's bf16 bounds catch a kernel that leaves one stage's
rounding out, on one GPU.

    python3 tools/torch_bf16_cnn_cost.py [--out DIR]

Times the CNN SGD phase (K11, ``ppo_cnn_sgd_phase``: 4 epochs x 4
minibatches) at config 4's shapes (medium: the 5x5 window, 4 channels,
convs 16 and 32, trunk 128; T = 16, B = 4096, 4 agents) with
``matmul_dtype="float32"`` and ``"bfloat16"``, and with ``"bfloat16"`` on
copies of ``warehouse_tpu_torch/`` in which one stage's products round
nothing: in ``csrc/sgd_cnn.cu`` (``VARIANTS``) its ``mma_k16<BF>`` runs
the float32 route (FFMA on unrounded operands) inside the bf16
instance, or a rounding on the
CUDA cores (the obs staging, the head, the trunk's delta, the head's
weight gradient) takes ``rbf<false>``. The copies compute wrong numbers on
purpose. Each copy is held to its bf16 twin by chip_smoke.py's
``k4_check`` and ``k3_check`` (K12 and K11 on a config-4 trajectory, with
``bf16=True``): a copy that passes them is a rounding the bounds cannot
see. The unedited tree must pass.

The copies go under DIR (a temporary directory by default) and are built
in parallel, one process each; they are then timed one at a time, each in
a process of its own (the copies' packages share a name), on the same
synthetic inputs (seeded). One JSON line per variant, ``{"variant": ...,
"matmul_dtype": ..., "ms": median of 5}``, then the checks' JSON lines
and one ``{"variant": ..., "check": ..., "caught": ...}`` per check, after
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "warehouse_tpu_torch/kernels/csrc/sgd_cnn.cu"
# variant: (text of csrc/sgd_cnn.cu, its replacement, occurrences)
VARIANTS = {
    "obs_staging": ("rbf<BF>(bt.obs[", "rbf<false>(bt.obs[", 2),
    "conv1_forward": ("mma_k16<BF>(acc, la, ColLoader<A1S>",
                      "mma_k16<false>(acc, la, ColLoader<A1S>", 1),
    "trunk_products": ("mma_k16<BF>(acc, RowLoader<LD>",
                       "mma_k16<false>(acc, RowLoader<LD>", 1),
    "head": ("rbf<BF>(hb[n * HS + k]), rbf<BF>(__ldg(Wh + o * H + k))",
             "rbf<false>(hb[n * HS + k]), rbf<false>(__ldg(Wh + o * H + k))",
             1),
    "trunk_delta": ("rbf<BF>(outs[n * OST + o]), rbf<BF>(__ldg(Wh + o * H + j"
                    ")", "rbf<false>(outs[n * OST + o]), rbf<false>(__ldg(Wh +"
                    " o * H + j)", 1),
    "conv0_delta": ("mma_k16<BF>(accd[i]", "mma_k16<false>(accd[i]", 1),
    "conv1_wgrad": ("mma_k16<BF>(acc1,", "mma_k16<false>(acc1,", 1),
    "conv0_wgrad": ("mma_k16<BF>(acc0,", "mma_k16<false>(acc0,", 1),
    "trunk_wgrad": ("mma_k16<BF>(acc, KRowLoader", "mma_k16<false>(acc, "
                    "KRowLoader", 1),
    "head_wgrad": ("rbf<BF>(p.sc.h[q * H + j])", "rbf<false>(p.sc.h[q * H + j])",
                   1),
}

BUILD = """
import sys
sys.path.insert(0, {tree!r})
from warehouse_tpu_torch.kernels import build
build.library()
"""

TIME = """
import json, sys, torch
sys.path.insert(0, {tree!r})
from warehouse_tpu_torch import TrainConfig, medium_config
from warehouse_tpu_torch.kernels.sgd import normalize_adv_env_minibatch
from warehouse_tpu_torch.kernels.sgd_cnn import ppo_cnn_sgd_phase
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.optim import AdamState, make_optimizer
from warehouse_tpu_torch.train.ppo import Transition

dev = torch.device("cuda", 0)
cfg = medium_config()
T, B, A, D, E, M = 16, 4096, cfg.num_agents, cfg.obs_dim, 4, 4
g = torch.Generator().manual_seed(0)
obs = (torch.rand(T, B, A, D, generator=g) < 0.3).float()
obs[..., -6:] = torch.rand(T, B, A, 6, generator=g)
action = torch.randint(0, 5, (T, B, A), generator=g, dtype=torch.int32)
traj = Transition(
    obs=obs, action=action,
    log_prob=-1.6 + 0.1 * torch.randn(T, B, A, generator=g),
    value=torch.randn(T, B, A, generator=g), reward=torch.zeros(T, B, A),
    done=torch.zeros(T, B, A, dtype=bool),
    mask=torch.ones(T, B, A, 5, dtype=bool), boot_value=torch.zeros(T, B, A))
traj = Transition(*(x.to(dev) for x in traj))
adv_n = normalize_adv_env_minibatch(
    torch.randn(T, B, A, generator=g), M).to(dev)
targets = torch.randn(T, B, A, generator=g).to(dev)
model = make_model(cfg, "cnn", 128, generator=g, device=dev)
params = {{k: v.detach() for k, v in model.state_dict().items()}}
opt = AdamState(0, {{k: torch.zeros_like(v) for k, v in params.items()}},
                {{k: torch.zeros_like(v) for k, v in params.items()}})
rows = make_optimizer(TrainConfig(num_updates=300)).step_rows(0, E * M, dev)


def run():
    ppo_cnn_sgd_phase(params, opt, traj, adv_n, targets, *rows, 0.01, 0.0,
                      num_epochs=E, num_minibatches=M, clip_eps=0.2,
                      value_coef=0.5, max_grad_norm=0.5, mask_actions=False,
                      matmul_dtype={dtype!r})


run()
times = []
for _ in range(5):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
print(json.dumps({{"variant": {variant!r}, "matmul_dtype": {dtype!r},
                  "ms": sorted(times)[2], "ms_all": times}}), flush=True)
if {check!r}:
    sys.path.insert(1, {root!r})  # chip_smoke.py; the package stays the copy's
    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fn in (cs.k4_check, cs.k3_check):
        try:
            fn(dev, cfg, cnn=True, bf16=True)
            caught = False
        except AssertionError as e:
            caught = str(e)[:300]
        print(json.dumps({{"variant": {variant!r}, "check": fn.__name__,
                          "caught": caught}}), flush=True)
        if caught and {variant!r} == "none":
            sys.exit(1)  # the unedited kernel must pass
"""


def make_variant(out: Path, name: str) -> Path:
    """A copy of the package with one edit of csrc/sgd_cnn.cu."""
    old, new, count = VARIANTS[name]
    tree = out / name
    shutil.copytree(ROOT / "warehouse_tpu_torch", tree / "warehouse_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = tree / SRC
    text = src.read_text()
    if text.count(old) != count:
        raise SystemExit(f"{name}: {old!r} occurs {text.count(old)} times in "
                         f"{SRC}, not {count}: the source moved")
    src.write_text(text.replace(old, new))
    return tree


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="where the variant copies go")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    out = Path(args.out or tempfile.mkdtemp(prefix="bf16_cnn_cost_"))
    out.mkdir(parents=True, exist_ok=True)
    trees = {"none": ROOT, **{n: make_variant(out, n) for n in VARIANTS}}
    builds = {n: subprocess.Popen([sys.executable, "-c",
                                   BUILD.format(tree=str(t))])
              for n, t in trees.items()}
    failed = [n for n, p in builds.items() if p.wait() != 0]
    if failed:
        print(f"build failed: {failed}", file=sys.stderr)
        return 1
    runs = [("none", "float32", False), ("none", "bfloat16", True),
            *((n, "bfloat16", True) for n in VARIANTS),
            ("none", "bfloat16", False)]
    for name, dtype, check in runs:
        res = subprocess.run([sys.executable, "-c", TIME.format(
            tree=str(trees[name]), variant=name, dtype=dtype, check=check,
            root=str(ROOT))])
        if res.returncode != 0:
            return res.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())

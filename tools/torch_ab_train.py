#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's config-4 trainers from several source trees
in turns on one GPU: PPO (``chip_smoke.py``'s ``train`` path, an 80-update
schedule) and IMPALA with Adam (its ``impala_train`` path, a 300-update
schedule), both through their kernels (K2 acting, K3 or K5 learning).

    python tools/torch_ab_train.py [--updates N] PARENT . . PARENT ...

Each tree argument is a directory that holds ``warehouse_tpu_torch/``;
each runs in a process of its own (the trees' packages share a name),
which builds that tree's kernels, then for each trainer runs two updates
of warm-up from ``PRNGKey(0)`` and N more (10 by default), each split by
CUDA events at the trainer's ``mark`` calls (acting, GAE, the learner)
and the rest as ``glue``, hashes the final params and env state (equal
hashes: the trees computed the same bits), and counts what one more
update asks of the host under ``torch.profiler``: the ``aten::`` operator
calls and the CUDA kernel launches (``cudaLaunchKernel`` and
``cuLaunchKernel`` calls). Each process prints one line ``{"tree": ...,
"paths": {path: {"backends": ..., "update_ms": [...], "acting_ms": [...],
"split_ms_median": {...}, "env_steps_per_sec": ..., "sha256": hex,
"host_calls": {"aten_ops": n, "launches": n}}}}``; the last line pools
each tree's turns: ``{"summary": {tree: {path: {"update_ms": [median,
min, max], "acting_ms": [...]}}}}``.
The card's name and power limit are printed first. Comparing two trees is
only sound inside one run on one card, in turns (A, B, B, A, ...).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

CHILD = """
import hashlib, json, sys, time, torch
from torch.profiler import ProfilerActivity, profile
sys.path.insert(0, {tree!r})
from warehouse_tpu_torch import TrainConfig, medium_config, rng
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import build
from warehouse_tpu_torch.train import make_train, make_train_impala
dev = torch.device("cuda", 0)
build.library()
cfg = medium_config()
N, WARM = {updates}, 2


class Marks:
    def __init__(self):
        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def split(self):
        self("glue")
        self.events[-1][1].synchronize()
        out = {{name: a.elapsed_time(b) for (_, a), (name, b)
               in zip(self.events, self.events[1:])}}
        out["total"] = sum(out.values())
        return out


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2] if len(xs) % 2 else 0.5 * (
        xs[len(xs) // 2 - 1] + xs[len(xs) // 2])


def sha(rs):
    h = hashlib.sha256()
    for k in sorted(rs.params):
        h.update(rs.params[k].contiguous().cpu().numpy().tobytes())
    for f in STATE_FIELDS:
        h.update(getattr(rs.env_state, f).contiguous().cpu().numpy()
                 .tobytes())
    return h.hexdigest()


def host_calls(tr, rs):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step(rs)
        torch.cuda.synchronize()
    aten = launches = 0
    for e in prof.key_averages():
        if e.device_type.name != "CPU":
            continue
        if e.key.startswith("aten::"):
            aten += e.count
        elif e.key in ("cudaLaunchKernel", "cuLaunchKernel"):
            launches += e.count
    return {{"aten_ops": aten, "launches": launches}}


paths = {{
    "train": make_train(cfg, TrainConfig(num_updates=80), device=dev),
    "impala_train": make_train_impala(
        cfg, TrainConfig(num_updates=300, impala_rmsprop=False), device=dev),
}}
out = {{}}
for name, tr in paths.items():
    rs = tr.init(rng.prng_key(0, dev))
    for _ in range(WARM):
        rs, _ = tr.train_step(rs)
    torch.cuda.synchronize()
    splits, t0 = [], time.perf_counter()
    for _ in range(N):
        marks = Marks()
        rs, _ = tr.train_step(rs, mark=marks)
        splits.append(marks.split())
    wall = time.perf_counter() - t0
    B, T = tr.tcfg.num_envs, tr.tcfg.unroll_length
    out[name] = {{
        "backends": tr.backends,
        "update_ms": [s["total"] for s in splits],
        "acting_ms": [s["acting"] for s in splits],
        "split_ms_median": {{k: median([s[k] for s in splits])
                            for k in splits[0]}},
        "env_steps_per_sec": B * T * N / wall, "sha256": sha(rs),
        "host_calls": host_calls(tr, rs)}}
print(json.dumps({{"tree": {tree!r}, "paths": out}}))
"""


def pooled(xs):
    xs = sorted(xs)
    return [xs[len(xs) // 2], xs[0], xs[-1]]


def main(argv) -> int:
    updates = 10
    if argv[:1] == ["--updates"] and len(argv) > 1:
        updates, argv = int(argv[1]), argv[2:]
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    rc, summary = 0, {}
    for tree in argv:
        tree = os.path.abspath(tree)
        res = subprocess.run(
            [sys.executable, "-c", CHILD.format(tree=tree, updates=updates)],
            cwd=tree, capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(json.dumps({"tree": tree, "rc": res.returncode,
                              "stderr": res.stderr[-2000:]}), flush=True)
            rc = res.returncode
            continue
        line = json.loads(res.stdout.strip().splitlines()[-1])
        for path, got in line["paths"].items():
            acc = summary.setdefault(tree, {}).setdefault(
                path, {"update_ms": [], "acting_ms": []})
            acc["update_ms"] += got["update_ms"]
            acc["acting_ms"] += got["acting_ms"]
    print(json.dumps({"summary": {
        tree: {path: {k: pooled(v) for k, v in got.items()}
               for path, got in paths.items()}
        for tree, paths in summary.items()}}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

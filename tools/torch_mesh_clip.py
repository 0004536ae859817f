#!/usr/bin/env python3
"""The data mesh's clip by the averaged gradient (ROADMAP F-10) on one GPU,
for the port's package in each of several source trees.

    python3 tools/torch_mesh_clip.py [TREE ...]        (default: .)

Each TREE is a directory that holds ``warehouse_tpu_torch/`` (this
repository, or a parent commit unpacked with ``git archive``). For each, a
process of its own builds that tree's kernels and spawns two ranks on the
one card, a gloo group (NCCL refuses two ranks on one device), each with
``RANK_ENVS`` envs of config 4 (medium, MLP 128 x 2) and ``max_grad_norm``
``CLIP_NORM``, at which every step clips. On each rank and for each of
PPO (K4's gradient, K3's clip + Adam), the GRU (K9, K8), the CNN (K12,
K11) and IMPALA with Adam and with RMSProp (K6, K5): one meshed update
through the kernels from ``init_global(PRNGKey(0))``, its params and
optimizer state checked bit-identical on the two ranks
(``assert_replicated_in_sync``), and held against the plain twins'
world-2 update from the same state (``plain_step``, which clips by the
norm of the gradient averaged over the ranks, as JAX ``pmean``s before
optax's clip) at the learners' bound on params (rtol 1e-5, atol 1e-6,
chip_smoke.py's ``SGD_TOL`` / ``CNN_TOL`` / ``VT_TOL``). Each step's
gradient norm on each rank before the all-reduce and after it is
recorded. A tree whose learners clip by a rank's own norm fails both
checks. Each tree prints one JSON line: ``{"tree", "ok", "paths": [{"path",
"in_sync", "twin_params_tol_ratio", "own_norms", "avg_norms", ...}]}``;
this script prints the card's name and power limit first.

chip_smoke.py's ``mesh_clip_ranks`` phase runs ``clip_ranks`` on this
tree's package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

CLIP_NORM = 1e-3   # far below every config-4 step's gradient norm
RANK_ENVS = 1024   # envs of each of the two ranks
PARAM_TOL = (1e-5, 1e-6)  # the learners' twin bound on params
TIMEOUT_S = 300    # a rank's wait for the other before it raises
PATHS = ("ppo", "gru", "cnn", "impala_adam", "impala_rmsprop")


class NormMesh:
    """A ``DataMesh`` whose ``mean_`` (the meshed learner's one all-reduce
    a step, of the gradient and its 4 loss sums) records the gradient's
    norm before and after the average; everything else is the mesh's."""

    def __init__(self, mesh):
        self._mesh = mesh
        self.norms = []

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def mean_(self, x):
        own = torch.linalg.vector_norm(x[:-4])
        self._mesh.mean_(x)
        self.norms.append((own, torch.linalg.vector_norm(x[:-4])))
        return x


def trainer(name: str, envs: int, dev, mesh):
    """The config-4 trainer of path ``name`` at ``envs`` envs in all."""
    from warehouse_tpu_torch import TrainConfig, medium_config
    from warehouse_tpu_torch.train import (make_train, make_train_impala,
                                           make_train_rnn)

    kw = dict(num_envs=envs, max_grad_norm=CLIP_NORM)
    if name == "ppo":
        return make_train(medium_config(), TrainConfig(num_updates=80, **kw),
                          device=dev, mesh=mesh)
    if name in ("gru", "cnn"):
        make = make_train_rnn if name == "gru" else make_train
        return make(medium_config(), TrainConfig(num_updates=300, **kw),
                    arch=name, device=dev, mesh=mesh)
    return make_train_impala(
        medium_config(), TrainConfig(num_updates=300, impala_rmsprop=(
            name == "impala_rmsprop"), **kw), device=dev, mesh=mesh)


def tol_ratio(a: dict, b: dict) -> float:
    """max |a - b| / (atol + rtol |b|) over the params: at most 1 within
    ``PARAM_TOL``."""
    rtol, atol = PARAM_TOL
    return max(float(((a[k].double() - b[k].double()).abs()
                      / (atol + rtol * b[k].double().abs())).max())
               for k in b)


def clip_rank(rank: int, world: int, store: str, out: str, envs: int,
              counts=None) -> None:
    """One rank: each path's meshed update, its checks and norms, into
    ``out`` (with ``counts()``, the launch counts, where given)."""
    from warehouse_tpu_torch import rng
    from warehouse_tpu_torch.parallel.distributed import process_group
    from warehouse_tpu_torch.utils import assert_replicated_in_sync

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    rows = []
    with process_group(store, backend="gloo", rank=rank, world=world,
                       timeout_s=TIMEOUT_S, local_rank=0) as mesh:
        for name in PATHS:
            nmesh = NormMesh(mesh)
            tr = trainer(name, world * envs, dev, nmesh)
            rs = tr.init_global(rng.prng_key(0, dev))
            nxt, m = tr.train_step(rs)
            try:
                assert_replicated_in_sync((nxt.params, nxt.opt_state), mesh)
                in_sync = True
            except AssertionError:
                in_sync = False
            twin, _ = tr.plain_step(rs)
            rows.append({
                "path": name, "backends": tr.backends,
                "steps": len(nmesh.norms), "in_sync": in_sync,
                "twin_params_tol_ratio": tol_ratio(nxt.params, twin.params),
                "finite": all(bool(torch.isfinite(v).all())
                              for v in m.values()),
                "own_norms": [float(a) for a, _ in nmesh.norms],
                "avg_norms": [float(b) for _, b in nmesh.norms]})
    torch.save({"rank": rank, "rows": rows,
                **(counts() if counts else {})}, out)


def clip_rank_entry(rank, world, store, outs, envs, counts):
    clip_rank(rank, world, store, outs[rank], envs, counts)


def clip_ranks(world: int = 2, envs: int = RANK_ENVS, counts=None):
    """``world`` spawned ``clip_rank`` processes on the one card: their
    results (rank order) and the wall seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            clip_rank_entry, args=(world, os.path.join(tmp, "store"), outs,
                                   envs, counts),
            nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > 2 * TIMEOUT_S:
                    raise TimeoutError("the clip ranks did not finish")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        wall = time.perf_counter() - t0
        return [torch.load(o, weights_only=False) for o in outs], wall


def verdict(res: list) -> dict:
    """Each path's checks over the ranks: every step clipped (its averaged
    norm above ``CLIP_NORM``), the averaged norms equal on the ranks and
    the ranks' own norms apart from them, the ranks in sync, each rank's
    update within ``PARAM_TOL`` of the twins', both phases through the
    kernels. ``ok`` where all hold."""
    paths = []
    for rows in zip(*(r["rows"] for r in res)):
        avg = rows[0]["avg_norms"]
        paths.append({
            "path": rows[0]["path"], "steps": rows[0]["steps"],
            "backends": rows[0]["backends"],
            "clipped": all(a > CLIP_NORM for a in avg),
            "avg_equal": all(r["avg_norms"] == avg for r in rows),
            "own_apart": all(any(o != a for o, a in zip(r["own_norms"], avg))
                             for r in rows),
            "in_sync": all(r["in_sync"] for r in rows),
            "finite": all(r["finite"] for r in rows),
            "twin_params_tol_ratio": [r["twin_params_tol_ratio"]
                                      for r in rows],
            "avg_norms": avg,
            "own_norms": [r["own_norms"] for r in rows]})
    for p in paths:
        p["ok"] = (p["backends"] == {"rollout": "cuda", "grad": "cuda"}
                   and p["steps"] > 0 and p["clipped"] and p["avg_equal"]
                   and p["own_apart"] and p["in_sync"] and p["finite"]
                   and max(p["twin_params_tol_ratio"]) <= 1.0)
    return {"ok": all(p["ok"] for p in paths), "paths": paths}


CHILD = """
import json, sys
sys.path.insert(0, {tree!r})
sys.path.insert(1, {tools!r})
import torch_mesh_clip as clip
from warehouse_tpu_torch.kernels import build
build.library()
res, wall = clip.clip_ranks()
print(json.dumps({{"tree": {tree!r}, "wall_s": wall, **clip.verdict(res)}}))
"""


def main(argv) -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    tools = os.path.dirname(os.path.abspath(__file__))
    rc = 0
    for tree in argv or ["."]:
        tree = os.path.abspath(tree)
        res = subprocess.run(
            [sys.executable, "-c", CHILD.format(tree=tree, tools=tools)],
            cwd=tree, capture_output=True, text=True)
        print(res.stdout, end="", flush=True)
        if res.returncode:
            print(json.dumps({"tree": tree, "rc": res.returncode,
                              "stderr": res.stderr[-2000:]}), flush=True)
            rc = res.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

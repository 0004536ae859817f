"""Two gloo ranks of the port's meshed trainers against the JAX trainers on
a 2-device mesh (the conftest's fake CPU devices).

The ranks are spawned processes that run ``_rank_worker``, a function of
this file, which imports nothing of JAX at its top: a rank imports the port
alone. The test process runs the JAX references (PPO with the MLP, with
the default cadence and with ``epoch_shuffle="each"``, IMPALA with Adam;
8 envs, 4 a shard, T = 4, hidden 16, 1 epoch or pass x 2
minibatches; the XLA routes, whose meshed learner ``pmean``s the gradient
where the Pallas one does, and which compile faster on a CPU than the
kernels in interpret mode, which ``tests/test_torch_mesh.py`` runs) while
the ranks run the same 2 updates from the same start (each rank's shard of
the JAX state, carried across) through the port's meshed route on the
kernels' twins (K2, K4 and K6's; with "each", the plain learner phase;
"ppo_clip" at ``max_grad_norm=1e-3``, where every step clips: the twin
the card's meshed clip is held against clips by the norm of the gradient
averaged over the ranks, as JAX's ``pmean`` before optax's clip; each
step's averaged norm is recorded beside the rank's own),
checking after every update that
their params and optimizer state are bit-identical
(``assert_replicated_in_sync``), and that a perturbed leaf on one rank is
caught on both; and that the whole state a checkpoint gathers, cut
again, is each rank's. Held here: the two ranks' params bit-identical; each
rank's env state and key bit-equal to its JAX shard; metrics and params at
the bounds of ``tests/test_torch_train.py`` (2e-4 + 1e-3 relative; rtol
2e-4, atol 5e-5).
"""

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

from warehouse_tpu_torch.config import TrainConfig, small_config
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.optim import global_norm
from warehouse_tpu_torch.parallel import distributed
from warehouse_tpu_torch.parallel.mesh import DataMesh
from warehouse_tpu_torch.train import make_train, make_train_impala
from warehouse_tpu_torch.train.ppo import unshard_runner_state
from warehouse_tpu_torch.utils import assert_replicated_in_sync

WORLD = 2
MAX_STEPS = 8
TCFG = dict(num_envs=8, unroll_length=4, num_updates=2, num_minibatches=2,
            ppo_epochs=1, impala_passes=1, hidden_dim=16)
# PPO through K4's twin; with a partition an epoch, through the plain phase
# (its scaffold averages where JAX's ``pmean``s); IMPALA through K6's twin.
CLIP = 1e-3  # max_grad_norm of "ppo_clip": far below every step's norm
JOBS = {"ppo": dict(TCFG), "ppo_each": dict(TCFG, epoch_shuffle="each"),
        "impala": dict(TCFG, impala_rmsprop=False),
        "ppo_clip": dict(TCFG, max_grad_norm=CLIP)}
JAX_ROUTE = dict(rollout_backend="xla", grad_backend="xla")
UPDATES = 2
DEADLINE_S = 120  # the ranks' whole run, rendezvous included


NORMS = []  # a rank's (own, averaged) gradient norm of each meshed step


@dataclasses.dataclass(frozen=True)
class NormMesh(DataMesh):
    """A ``DataMesh`` that records each step's gradient norm before and
    after its average over the ranks (``NORMS``)."""

    def mean_grads(self, grads: dict, row: list):
        out = super().mean_grads(grads, row)
        NORMS.append((float(global_norm(grads)), float(global_norm(out[0]))))
        return out


def _rank_worker(rank: int, tmp: str, jobs: dict) -> None:
    """One rank: each job's 2 meshed updates from its shard of the JAX
    start, the sync check after each; then a perturbed leaf."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    cfg = small_config(max_steps=MAX_STEPS)
    with distributed.process_group(tmp / "store", rank=rank, world=WORLD,
                                   timeout_s=DEADLINE_S) as mesh:
        out = {}
        for name, kw in jobs.items():
            rs = torch.load(tmp / f"{name}{rank}.pt", weights_only=False)
            make = make_train_impala if name == "impala" else make_train
            tr = make(cfg, TrainConfig(**kw), device="cpu",
                      mesh=NormMesh(**vars(mesh)) if name == "ppo_clip"
                      else mesh)
            metrics = []
            for _ in range(UPDATES):
                rs, m = tr.train_step(rs)
                assert_replicated_in_sync((rs.params, rs.opt_state), mesh)
                metrics.append({k: float(v) for k, v in m.items()})
            # A checkpoint's whole state, cut again, is this rank's.
            again = tr.shard_runner_state(unshard_runner_state(rs, mesh))
            assert all(torch.equal(getattr(again.env_state, f),
                                   getattr(rs.env_state, f))
                       for f in STATE_FIELDS)
            assert torch.equal(again.obs, rs.obs)
            assert torch.equal(again.key, rs.key)
            out[name] = (rs, metrics)
        out["norms"] = NORMS
        bad = dict(rs.params)
        if rank == 1:
            k = next(iter(bad))
            bad[k] = bad[k].clone()
            bad[k].view(-1)[0] += 1.0
        try:
            assert_replicated_in_sync(bad, mesh)
            out["caught"] = ""
        except AssertionError as e:
            out["caught"] = str(e)
    torch.save(out, tmp / f"out{rank}.pt")


def _jax_shard(rs_np, rank: int):
    """Shard ``rank`` of a JAX meshed runner state (numpy leaves)."""
    import jax

    def rows(x):
        b = x.shape[0] // WORLD
        return x[rank * b:(rank + 1) * b]

    return rs_np.replace(env_state=jax.tree.map(rows, rs_np.env_state),
                         obs=rows(rs_np.obs),
                         key=rs_np.key[rank:rank + 1])


def test_two_gloo_ranks_match_jax_two_device_mesh(tmp_path):
    import jax

    from warehouse_tpu.config import TrainConfig as JTrainConfig
    from warehouse_tpu.config import small_config as j_small_config
    from warehouse_tpu.parallel.mesh import make_mesh
    from warehouse_tpu.train.impala import make_train_impala as j_impala
    from warehouse_tpu.train.ppo import make_train as j_ppo
    from warehouse_tpu_torch.train import (impala_runner_state_from_jax,
                                           runner_state_from_jax)

    from test_torch_rng import assert_bits
    from test_torch_train import assert_params

    jmesh = make_mesh(jax.devices()[:WORLD])
    cfg = j_small_config(max_steps=MAX_STEPS)
    jtrainers, jstates = {}, {}
    for name, kw in JOBS.items():
        tcfg = JTrainConfig(**kw, **JAX_ROUTE)
        jtr = (j_impala if name == "impala" else j_ppo)(cfg, tcfg,
                                                        mesh=jmesh)
        jrs = jtr.init_global(jax.random.PRNGKey(0))
        rs_np = jax.tree.map(np.asarray, jrs)
        for r in range(WORLD):
            shard = _jax_shard(rs_np, r)
            torch.save(impala_runner_state_from_jax(shard, tcfg)
                       if name == "impala" else runner_state_from_jax(shard),
                       tmp_path / f"{name}{r}.pt")
        jtrainers[name], jstates[name] = jtr, jrs

    ctx = mp.start_processes(_rank_worker, args=(str(tmp_path), JOBS),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        # The JAX references run while the ranks do.
        jmetrics = {}
        for name, jtr in jtrainers.items():
            jrs, rows = jstates[name], []
            for _ in range(UPDATES):
                jrs, jm = jtr.train_step(jrs)
                rows.append({k: float(v) for k, v in jm.items()})
            jstates[name], jmetrics[name] = jax.tree.map(np.asarray, jrs), rows
        deadline = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()

    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(WORLD)]
    for out in outs:
        assert "replicated leaf diverged across shards" in out["caught"]
    # Every "ppo_clip" step clipped by the averaged gradient's norm, which
    # is the same on both ranks and not either rank's own.
    steps = UPDATES * TCFG["ppo_epochs"] * TCFG["num_minibatches"]
    assert all(len(out["norms"]) == steps for out in outs)
    for (own0, avg0), (own1, avg1) in zip(*(out["norms"] for out in outs)):
        assert avg0 == avg1 > CLIP and own0 != own1
        assert avg0 != own0 and avg0 != own1
    for name in JOBS:
        (rs0, _), (rs1, _) = outs[0][name], outs[1][name]
        assert all(torch.equal(rs0.params[k], rs1.params[k])
                   for k in rs0.params), name
        jrs = jstates[name]
        for r, out in enumerate(outs):
            rs, metrics = out[name]
            shard = _jax_shard(jrs, r)
            for f in STATE_FIELDS:
                assert_bits(getattr(shard.env_state, f),
                            getattr(rs.env_state, f), f"{name} rank {r} {f}")
            assert_bits(shard.key.reshape(2), rs.key, f"{name} rank {r} key")
            assert_bits(shard.obs, rs.obs, f"{name} rank {r} obs")
            for u, (m, jm) in enumerate(zip(metrics, jmetrics[name])):
                assert m.keys() == jm.keys()
                for k in jm:
                    assert abs(m[k] - jm[k]) < 2e-4 + 1e-3 * abs(jm[k]), (
                        name, r, u, k, m[k], jm[k])
            assert_params(rs.params, jrs.params, 2e-4, 5e-5, f"{name} {r}")
            assert int(rs.update_idx) == UPDATES

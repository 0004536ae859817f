"""The port's ``(pop, data)`` mesh (``parallel.mesh.make_pop_mesh``, ROADMAP
M-8b) on the CPU: its layout against JAX ``make_pop_mesh``'s reshape, and
two spawned gloo ranks running the sweep's ``seed_mesh`` and PBT's mesh
against the unmeshed port and the JAX package on a 2-device mesh (the
conftest's fake CPU devices).

The ranks run ``_rank_worker``, a function of this file that imports
nothing of JAX at its top: a rank imports the port alone, with one
intra-op thread. The test process runs the references while the ranks run
(the small config, 8 envs, T = 4, hidden 16):

- ``run_trial`` with 4 seeds and ``run_asha`` with 4 seeds over 2 learning
  rates on a pop = 2 mesh, each slice training its 2 seeds: metrics, rows
  and promotions bit-equal to the port's unmeshed sweep, the JSONL from
  rank 0 alone; the metrics against JAX ``run_trial(seed_mesh=
  make_pop_mesh(2, devices[:2]))`` at ``tests/test_sweep.py``'s bounds
  (rtol 1e-5, atol 1e-6). Both sides start each seed from the JAX
  vmapped init's state (the port's params are not flax's bits).
- ``run_pbt`` at (pop 2, data 1), population 4: rows bit-equal to the
  unmeshed port's, and an exploit whose every source lies on the other
  slice: each rank's members bit-equal to the unmeshed copies.
- PBT at (pop 1, data 2) from JAX ``make_pbt_trainer(mesh=make_pop_mesh(
  1, devices[:2]))``'s init, each rank its data shard: ``train_chunk`` of
  2 updates, an exploit, 2 more; each member's params and Adam state in
  sync on the slice's data ranks after each chunk
  (``assert_replicated_in_sync`` on the ``PopMesh``), env shards and keys
  bit-equal to JAX's, metrics and params against JAX's at
  ``tests/test_pbt.py``'s bounds (loss rtol 1e-5, atol 1e-6; params rtol
  1e-6, atol 1e-6).

The four-rank (pop 2, data 2) case runs on the card (``chip_smoke.py``
``pop_pbt_ranks``).
"""

import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from warehouse_tpu_torch import TrainConfig, small_config
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.parallel import distributed
from warehouse_tpu_torch.parallel import mesh as pmesh
from warehouse_tpu_torch.train import pbt, sweep
from warehouse_tpu_torch.utils import assert_replicated_in_sync

WORLD = 2
DEADLINE_S = 150  # the ranks' whole run, rendezvous included
MAX_STEPS = 8
SEEDS = 4
SWEEP = dict(num_envs=8, unroll_length=4, num_updates=2, num_minibatches=2,
             ppo_epochs=1, hidden_dim=16, num_layers=1)
GRID = {"learning_rate": [3e-4, 1e-3]}
RUNGS = (1, 1)
PBT = dict(num_envs=8, unroll_length=4, num_minibatches=2, ppo_epochs=2,
           hidden_dim=16, anneal_lr=False)
SPACE = {"learning_rate": {"loguniform": [1e-4, 1e-2]},
         "entropy_coef": {"uniform": [0.005, 0.02]}}
PBT_RUN = dict(population_size=4, perturb_interval=2, num_intervals=2,
               seed=3)
CROSS_SRC = np.array([2, 3, 0, 1])  # every source on the other slice
LRS, ENTS = np.array([3e-4, 1e-3, 3e-3, 1e-4]), np.full(4, 0.01)
EXPLOIT_SRC = np.array([0, 0, 3, 2])


@pytest.mark.parametrize("world,pop", [(1, 1), (2, 1), (2, 2), (4, 2),
                                       (6, 3), (8, 2), (8, 4), (8, 8),
                                       (6, 4), (8, 3)])
def test_pop_layout_matches_jax_reshape(world, pop):
    """Rank r of the port's mesh is device r of the JAX mesh's ``(pop,
    data)`` array; both refuse a world ``pop`` does not divide."""
    import jax

    from warehouse_tpu.parallel.mesh import make_pop_mesh

    if world % pop:
        with pytest.raises(ValueError, match=f"not divisible by pop={pop}"):
            make_pop_mesh(pop, jax.devices()[:world])
        with pytest.raises(ValueError, match=f"not divisible by pop={pop}"):
            pmesh.pop_layout(world, pop)
        return
    jm = make_pop_mesh(pop, jax.devices()[:world])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert jm.axis_names == (pmesh.POP_AXIS, pmesh.DATA_AXIS)
    np.testing.assert_array_equal(np.array(pmesh.pop_layout(world, pop)),
                                  ids)


def _bits(tree) -> list:
    """Every tensor leaf of ``tree`` as its bytes."""
    leaves = []
    pmesh._tree_map(lambda x: leaves.append(
        x.contiguous().reshape(-1).view(torch.uint8)) or x, tree)
    return leaves


def _patch_seed_inits(states: list) -> None:
    """Seed s starts from ``states[s]`` whatever the trainer: the JAX
    vmapped init's state carried across."""
    def init_seeds(trainer, tcfg, num_seeds, seeds=None):
        return [states[s] for s in (range(num_seeds) if seeds is None
                                    else seeds)]
    sweep.init_seeds = init_seeds


def _rank_worker(rank: int, tmp: str) -> None:
    """One rank: the sweep and PBT at pop = 2, then PBT at data = 2."""
    torch.set_num_threads(1)
    tmp = Path(tmp)
    cfg = small_config(max_steps=MAX_STEPS)
    out = {}
    with distributed.process_group(tmp / "store", rank=rank, world=WORLD,
                                   timeout_s=DEADLINE_S):
        pop2 = pmesh.make_pop_mesh(2)
        _patch_seed_inits(torch.load(tmp / "seeds.pt", weights_only=False))
        states, out["trial"] = sweep.run_trial(
            cfg, TrainConfig(**SWEEP), SEEDS, seed_mesh=pop2, device="cpu")
        out["trial_mine"] = [s is not None for s in states]
        out["asha"], _ = sweep.run_asha(
            cfg, TrainConfig(**SWEEP), GRID, rung_updates=RUNGS,
            num_seeds=SEEDS, seed_mesh=pop2, device="cpu",
            out_path=str(tmp / f"asha{rank}.jsonl"))

        res = pbt.run_pbt(cfg, TrainConfig(**PBT), SPACE, mesh=pop2,
                          device="cpu", **PBT_RUN)
        out["pbt_rows"] = res.rows
        out["pbt_crossed"] = pbt.exploit(res.member, CROSS_SRC, pop2)

        data2 = pmesh.make_pop_mesh(1)
        init, chunk, get_lr, _ = pbt.make_pbt_trainer(
            cfg, TrainConfig(**PBT), mesh=data2, device="cpu")
        members = torch.load(tmp / f"members{rank}.pt", weights_only=False)
        steps = []
        for n in range(2):
            members, metrics = chunk(members, 2)
            for m in members:
                assert_replicated_in_sync((m.params, m.opt_state), data2)
            steps.append((members, metrics))
            if n == 0:
                members = pbt.exploit(members, EXPLOIT_SRC, data2)
        out["data2"] = steps
        out["data2_lr"] = get_lr(members)
    torch.save(out, tmp / f"out{rank}.pt")


def _jax_members(jm_np, rank: int):
    """Data shard ``rank`` of a JAX population on a (1, 2) mesh (numpy
    leaves), as the port's members."""
    import jax

    b = PBT["num_envs"] // WORLD

    def rows(x):
        return x[:, rank * b:(rank + 1) * b]

    shard = jm_np.replace(env_state=jax.tree.map(rows, jm_np.env_state),
                          obs=rows(jm_np.obs),
                          key=jm_np.key[:, rank:rank + 1])
    return pbt.members_from_jax(shard, "cpu")


def test_two_gloo_ranks_pop_mesh(tmp_path):
    import jax

    from warehouse_tpu.config import TrainConfig as JTrainConfig
    from warehouse_tpu.config import small_config as j_small
    from warehouse_tpu.parallel.mesh import make_pop_mesh
    from warehouse_tpu.train import pbt as jpbt
    from warehouse_tpu.train import sweep as jsweep
    from warehouse_tpu.train.ppo import make_train as j_make_train
    from warehouse_tpu_torch.models import params_from_flax
    from warehouse_tpu_torch.optim import opt_state_from_optax
    from warehouse_tpu_torch.train import runner_state_from_jax

    from test_torch_m4 import assert_tree
    from test_torch_rng import assert_bits

    jcfg = j_small(max_steps=MAX_STEPS)
    jtcfg = jsweep._pin_auto_backends(JTrainConfig(**SWEEP))
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(0), s))(
        np.arange(SEEDS))
    jrs = jax.tree.map(np.asarray,
                       jax.vmap(j_make_train(jcfg, jtcfg).init)(keys))
    seeds = [runner_state_from_jax(jax.tree.map(lambda x: x[s], jrs))
             for s in range(SEEDS)]
    torch.save(seeds, tmp_path / "seeds.pt")
    jmesh = make_pop_mesh(1, jax.devices()[:WORLD])
    ji, jchunk, _, _ = jpbt.make_pbt_trainer(jcfg, JTrainConfig(**PBT),
                                             mesh=jmesh)
    jm = ji(jax.random.PRNGKey(2), LRS, ENTS)
    jm_np = jax.tree.map(np.asarray, jm)
    for r in range(WORLD):
        torch.save(_jax_members(jm_np, r), tmp_path / f"members{r}.pt")

    ctx = mp.start_processes(_rank_worker, args=(str(tmp_path),),
                             nprocs=WORLD, join=False, start_method="spawn")
    init_seeds, threads = sweep.init_seeds, torch.get_num_threads()
    # The unmeshed references at the ranks' one intra-op thread: torch's
    # CPU reductions split by threads.
    torch.set_num_threads(1)
    try:
        # The references run while the ranks do.
        _, jtrial = jsweep.run_trial(jcfg, JTrainConfig(**SWEEP), SEEDS,
                                     seed_mesh=make_pop_mesh(
                                         2, jax.devices()[:WORLD]))
        jsteps = []
        for n in range(2):
            jm, jmet = jchunk(jm, 2)
            jsteps.append((jax.tree.map(np.asarray, jm),
                           {k: np.asarray(v) for k, v in jmet.items()}))
            if n == 0:
                jm = jax.tree.map(lambda x: x[EXPLOIT_SRC], jm)
        cfg = small_config(max_steps=MAX_STEPS)
        _patch_seed_inits(seeds)
        _, trial = sweep.run_trial(cfg, TrainConfig(**SWEEP), SEEDS,
                                   device="cpu")
        asha, _ = sweep.run_asha(cfg, TrainConfig(**SWEEP), GRID,
                                 rung_updates=RUNGS, num_seeds=SEEDS,
                                 device="cpu")
        res = pbt.run_pbt(cfg, TrainConfig(**PBT), SPACE, device="cpu",
                          **PBT_RUN)
        crossed = pbt.exploit(res.member, CROSS_SRC)
        deadline = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        sweep.init_seeds = init_seeds
        torch.set_num_threads(threads)
        for p in ctx.processes:
            if p.is_alive():
                p.kill()

    outs = [torch.load(tmp_path / f"out{r}.pt", weights_only=False)
            for r in range(WORLD)]
    assert (tmp_path / "asha0.jsonl").exists()
    assert not (tmp_path / "asha1.jsonl").exists()
    for r, out in enumerate(outs):
        # The sweep: each slice its seeds, every rank every seed's metrics.
        assert out["trial_mine"] == [s // 2 == r for s in range(SEEDS)]
        for k in trial:
            assert np.array_equal(out["trial"][k], trial[k]), (r, k)
            np.testing.assert_allclose(out["trial"][k], jtrial[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        assert out["asha"] == asha, r
        # PBT at pop 2: the unmeshed run's rows; the cross-slice exploit.
        assert out["pbt_rows"] == res.rows, r
        for got, want in zip(out["pbt_crossed"], crossed[2 * r:2 * r + 2]):
            assert all(torch.equal(a, b)
                       for a, b in zip(_bits(got), _bits(want))), r
        # PBT at data 2 against JAX, chunk by chunk.
        for (members, metrics), (jn, jmet) in zip(out["data2"], jsteps):
            np.testing.assert_allclose(metrics["loss"].numpy(), jmet["loss"],
                                       rtol=1e-5, atol=1e-6)
            for k in jmet:
                assert metrics[k].shape == (4, 2), k
            want = _jax_members(jn, r)
            for p, (m, w) in enumerate(zip(members, want)):
                for f in STATE_FIELDS:
                    assert_bits(getattr(w.env_state, f).numpy(),
                                getattr(m.env_state, f), f"{p} {f}")
                assert_bits(w.obs.numpy(), m.obs, f"member {p} obs")
                assert_bits(w.key.numpy(), m.key, f"member {p} key")
                one = jax.tree.map(lambda x: x[p], jn)
                assert_tree(m.params, params_from_flax(one.params), 1e-6,
                            1e-6, f"member {p} params")
                opt = opt_state_from_optax(one.opt_state,
                                           params_like=one.params)
                assert int(m.opt_state.count) == int(opt.count)
        np.testing.assert_array_equal(out["data2_lr"].astype(np.float32),
                                      LRS[EXPLOIT_SRC].astype(np.float32))

"""The port's sweeps (``warehouse_tpu_torch.train.sweep``, ROADMAP M-9) on
the CPU, against the JAX package's: the grid and random points; the JSONL
rows, summary, best point and ASHA's promotions with both modules'
trainers replaced by one fake that returns the same metric arrays from
each seed's key; each seed's env state and keys after init bit-equal to
replica s of the JAX vmapped init; a seed's metrics equal to a standalone
run's from the same key; a ``seed_mesh``'s slice and its refusal of a
seed count its ``pop`` does not divide; the CLI.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.config import TrainConfig as JTrainConfig
from warehouse_tpu.config import small_config as j_small
from warehouse_tpu.train import sweep as jsweep
from warehouse_tpu_torch import TrainConfig, rng, small_config
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.parallel import mesh as pmesh
from warehouse_tpu_torch.train import make_train
from warehouse_tpu_torch.train import sweep

from test_torch_rng import assert_bits

GRID = {"learning_rate": [3e-4, 1e-3, 3e-3], "entropy_coef": [0.01, 0.02]}
SPACE = {"learning_rate": {"loguniform": [1e-4, 1e-2]},
         "entropy_coef": {"uniform": [0.0, 0.05]},
         "num_minibatches": [2, 4], "ppo_epochs": {"randint": [1, 5]}}


def tiny(cls=TrainConfig, **kw):
    base = dict(num_envs=8, unroll_length=4, num_updates=3,
                num_minibatches=2, ppo_epochs=1, hidden_dim=16,
                num_layers=1)
    return cls(**{**base, **kw})


def test_grid_points_match_jax():
    assert sweep._grid_points(GRID) == jsweep._grid_points(GRID)
    assert len(sweep._grid_points(GRID)) == 6


@pytest.mark.parametrize("seed", [0, 7])
def test_random_points_match_jax(seed):
    assert (sweep._random_points(SPACE, 5, seed)
            == jsweep._random_points(SPACE, 5, seed))
    with pytest.raises(ValueError, match="bad search spec"):
        sweep._random_points({"x": {"normal": [0, 1]}}, 1, 0)


# Each point's share of a fake metric: a few bits, so that float32 holds
# every value exactly on both sides.
LR_BITS = {3e-4: 0.5, 1e-3: 0.25, 3e-3: 0.0}
ENT_BITS = {0.01: 0.0625, 0.02: -0.375}


def fake_value(lr, ent, k, u):
    """One metric value from the trial's point, the seed's key word ``k``
    and the update ``u``; the seeds and points rank differently over
    updates."""
    return ((k % 5) * 3 + (u % 4)) * 0.125 + LR_BITS[lr] + ENT_BITS[ent]


def jax_fake(env_cfg, tcfg, arch="mlp", **kw):
    """A JAX trainer the sweep can vmap and jit: state (key word, updates
    so far)."""
    class Trainer:
        @staticmethod
        def init(key):
            return jnp.stack([key[1] % 5, jnp.uint32(0)]).astype(jnp.float32)

        @staticmethod
        def train_many(rs, n):
            u = rs[1] + jnp.arange(n, dtype=jnp.float32)
            v = ((rs[0] * 3 + u % 4) * 0.125 + LR_BITS[tcfg.learning_rate]
                 + ENT_BITS[tcfg.entropy_coef])
            return rs.at[1].add(n), {"deliveries_per_env_step": v,
                                     "loss": -2.0 * v}
    return Trainer


def port_fake(env_cfg, tcfg, arch="mlp", device=None, **kw):
    class Trainer:
        backends = {"rollout": "plain", "grad": "plain"}

        def __init__(self):
            self.device = torch.device("cpu")

        @staticmethod
        def init(key):
            return torch.tensor([int(key[1]) % 5, 0], dtype=torch.float32)

        @staticmethod
        def train_many(rs, n):
            v = torch.tensor([fake_value(tcfg.learning_rate,
                                         tcfg.entropy_coef, int(rs[0]),
                                         int(rs[1]) + u) for u in range(n)],
                             dtype=torch.float32)
            return rs + torch.tensor([0.0, n]), {
                "deliveries_per_env_step": v, "loss": -2.0 * v}
    return Trainer()


def strip(rows):
    return [{k: v for k, v in r.items() if k != "backends"} for r in rows]


@pytest.fixture
def fakes(monkeypatch):
    monkeypatch.setattr(jsweep, "make_train", jax_fake)
    monkeypatch.setattr(sweep, "make_train", port_fake)


@pytest.mark.parametrize("search,mode", [("grid", "max"), ("random", "min")])
def test_sweep_rows_match_jax(fakes, tmp_path, search, mode):
    space = GRID if search == "grid" else {
        "learning_rate": [3e-4, 1e-3, 3e-3], "entropy_coef": [0.01, 0.02]}
    kw = dict(num_seeds=3, last_k=2, mode=mode, search=search, num_samples=4,
              search_seed=3)
    jrows, jbest = jsweep.run_sweep(
        j_small(max_steps=8), tiny(JTrainConfig), space,
        out_path=str(tmp_path / "j.jsonl"), **kw)
    rows, best = sweep.run_sweep(small_config(max_steps=8), tiny(), space,
                                 out_path=str(tmp_path / "p.jsonl"),
                                 device="cpu", **kw)
    assert strip(rows) == jrows and strip([best]) == [jbest]
    assert all(r["backends"] == {"rollout": "plain", "grad": "plain"}
               for r in rows)
    lines = [json.loads(x) for x in
             (tmp_path / "p.jsonl").read_text().splitlines()]
    jlines = [json.loads(x) for x in
              (tmp_path / "j.jsonl").read_text().splitlines()]
    assert strip(lines) == jlines
    assert len(lines) == 1 + 3 * (6 if search == "grid" else 4)


def test_asha_rungs_and_promotions_match_jax(fakes, tmp_path):
    kw = dict(rung_updates=(2, 1, 3), eta=2, num_seeds=2, last_k=2)
    jrows, jbest = jsweep.run_asha(j_small(max_steps=8), tiny(JTrainConfig),
                                   GRID, **kw)
    rows, best = sweep.run_asha(small_config(max_steps=8), tiny(), GRID,
                                device="cpu", out_path=str(tmp_path / "a"),
                                **kw)
    assert strip(rows) == jrows and strip([best]) == [jbest]
    promoted = [r["trial"] for r in rows if r.get("promoted")]
    assert len({r["trial"] for r in rows if "rung" in r}) == 6
    assert len(promoted) == 3 + 1 + 1


def test_seed_init_matches_jax_vmapped_init():
    """Seed s's runner state after init: env state, observations and key
    bit-equal to replica s of the JAX sweep's ``vmap(trainer.init)``."""
    from warehouse_tpu.train.ppo import make_train as j_make_train

    tcfg = tiny(seed=5)
    jtr = j_make_train(j_small(max_steps=8),
                       jsweep._pin_auto_backends(tiny(JTrainConfig, seed=5)))
    keys = jax.vmap(lambda s: jax.random.fold_in(jax.random.PRNGKey(5), s))(
        np.arange(3))
    jrs = jax.vmap(jtr.init)(keys)
    tr = make_train(small_config(max_steps=8), tcfg, device="cpu")
    for s, rs in enumerate(sweep.init_seeds(tr, tcfg, 3)):
        for f in STATE_FIELDS:
            assert_bits(np.asarray(getattr(jrs.env_state, f))[s],
                        getattr(rs.env_state, f), f"seed {s} {f}")
        assert_bits(np.asarray(jrs.obs)[s], rs.obs, f"seed {s} obs")
        assert_bits(np.asarray(jrs.key)[s].reshape(2), rs.key, f"seed {s}")


def test_run_trial_seed_equals_a_standalone_run():
    """Each seed of ``run_trial`` is the run a standalone ``make_train``
    makes from ``fold_in(PRNGKey(seed), s)``, bit for bit."""
    cfg, tcfg = small_config(max_steps=8), tiny(num_updates=2)
    states, metrics = sweep.run_trial(cfg, tcfg, 2, device="cpu")
    assert metrics["loss"].shape == (2, 2)
    tr = make_train(cfg, tcfg, device="cpu")
    rs, m = tr.train_many(tr.init(rng.fold_in(rng.prng_key(0), 1)), 2)
    for k in m:
        assert np.array_equal(metrics[k][1], m[k].numpy()), k
    for k in rs.params:
        assert torch.equal(states[1].params[k], rs.params[k]), k


def test_seed_mesh_is_refused_by_name():
    """A ``seed_mesh`` whose ``pop`` does not divide ``num_seeds`` is
    refused with JAX's ``ValueError``, before any trainer is built; the
    seeds a slice trains (``tests/test_torch_pop_mesh.py`` runs the meshed
    sweep)."""
    cpu = torch.device("cpu")
    pop3 = pmesh.PopMesh(whole=pmesh.DataMesh(None, 4, 6, cpu),
                         data=pmesh.DataMesh(None, 0, 2, cpu), pop=3,
                         ranks=tuple(range(6)))
    assert pop3.shape == {"pop": 3, "data": 2} and pop3.slice == 2
    assert sweep.seed_range(6, pop3) == range(4, 6)
    assert sweep.seed_range(5, None) == range(5)
    with pytest.raises(ValueError, match="num_seeds=2 not divisible by 3 "
                                         "pop shards"):
        sweep.run_trial(small_config(), tiny(), 2, seed_mesh=pop3,
                        device="cpu")
    with pytest.raises(ValueError, match="num_seeds=4 not divisible by 3"):
        sweep.run_asha(small_config(), tiny(), GRID, num_seeds=4,
                       seed_mesh=pop3, device="cpu")
    with pytest.raises(ValueError, match="num_seeds=1 not divisible by 3"):
        sweep.run_sweep(small_config(), tiny(), GRID, num_seeds=1,
                        seed_mesh=pop3, device="cpu")


@pytest.mark.parametrize("scheduler", ["fifo", "asha"])
def test_cli_runs(tmp_path, capsys, scheduler):
    out = tmp_path / "sweep.jsonl"
    sweep.main(["--env", "small", "--env-config", '{"max_steps": 8}', "--cpu",
                "--grid", '{"learning_rate": [3e-4, 1e-3]}', "--seeds", "1",
                "--updates", "1", "--num-envs", "8", "--unroll", "4",
                "--scheduler", scheduler, "--rungs", "1,1", "--out",
                str(out)])
    best = json.loads(capsys.readouterr().out)
    rows = [json.loads(x) for x in out.read_text().splitlines()]
    assert rows[-1] == best and best["best_trial"] in (0, 1)
    assert all(r["backends"] == {"rollout": "plain", "grad": "plain"}
               for r in rows)

"""The port's PBT (``warehouse_tpu_torch.train.pbt``, ROADMAP M-9) on the
CPU, against the JAX package's: a JAX population carried across
(``members_from_jax``) gives, after one ``train_chunk`` of 2 updates, env
states, observations and keys bit-equal, and metrics, params and Adam's
moments within the bounds of ``tests/test_torch_step_acting.py`` (Adam's
second moment within those of the float32 trainer tests); exploit
and explore pick the same members and the same new hyperparameters as JAX
from the same scores and seed (both modules' trainers replaced by one
fake); the end-to-end run and the refusals (a mesh's axes that do not
divide the envs or the population).
"""

import dataclasses
import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.config import EnvConfig as JEnvConfig
from warehouse_tpu.config import TrainConfig as JTrainConfig
from warehouse_tpu.config import small_config as j_small
from warehouse_tpu.train import pbt as jpbt
from warehouse_tpu_torch import EnvConfig, TrainConfig, small_config
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.optim import opt_state_from_optax
from warehouse_tpu_torch.parallel import mesh as pmesh
from warehouse_tpu_torch.train import pbt

from test_torch_m4 import assert_tree
from test_torch_rng import assert_bits

WALLED = dict(height=5, width=5, num_agents=2, queue_capacity=4,
              init_requests=2, spawn_prob=0.5, walls=(10, 11, 13, 14),
              max_steps=6)
CASES = {
    # name: (env, TrainConfig change): max_steps 6 at T = 4 ends every
    # episode inside the second chunk (the in-step reset).
    "knobs_walled": (WALLED, dict(mask_actions=True, shaping_coef=0.1,
                                  kl_coeff=0.2, bootstrap_truncated=True)),
    "flat_each": (dict(max_steps=6), dict(flat_optimizer=True,
                                          epoch_shuffle="each")),
}
BASE = dict(num_envs=8, unroll_length=4, num_minibatches=2, ppo_epochs=2,
            hidden_dim=16, anneal_lr=False)


@pytest.mark.parametrize("case", sorted(CASES))
def test_member_update_matches_jax(case):
    env, change = CASES[case]
    jcfg = (JEnvConfig(**env) if "walls" in env else j_small(**env))
    cfg = EnvConfig(**env) if "walls" in env else small_config(**env)
    ji, jchunk, jget_lr, _ = jpbt.make_pbt_trainer(
        jcfg, JTrainConfig(**BASE, **change))
    _, chunk, get_lr, _ = pbt.make_pbt_trainer(
        cfg, TrainConfig(**BASE, **change), device="cpu")
    jm = ji(jax.random.PRNGKey(2), np.array([3e-4, 2e-3]),
            np.array([0.01, 0.03]))
    members = pbt.members_from_jax(jax.tree.map(np.asarray, jm), "cpu")
    np.testing.assert_array_equal(get_lr(members).astype(np.float32),
                                  jget_lr(jm))
    jm, jmetrics = jchunk(jm, 2)
    members, metrics = chunk(members, 2)
    jn = jax.tree.map(np.asarray, jm)
    assert metrics.keys() == jmetrics.keys()
    for k in jmetrics:
        want = np.asarray(jmetrics[k])
        got = metrics[k].numpy()
        assert got.shape == want.shape == (2, 2)
        assert (np.abs(got - want) < 2e-4 + 1e-3 * np.abs(want)).all(), k
    for p, m in enumerate(members):
        for f in STATE_FIELDS:
            assert_bits(getattr(jn.env_state, f)[p], getattr(m.env_state, f),
                        f"member {p} {f}")
        assert_bits(jn.obs[p], m.obs, f"member {p} obs")
        assert_bits(jn.key[p].reshape(2), m.key, f"member {p} key")
        one = jax.tree.map(lambda x: x[p], jn)
        assert_tree(m.params, params_from_flax(one.params), 2e-4, 5e-5,
                    "params")
        want = opt_state_from_optax(one.opt_state, params_like=one.params)
        assert m.opt_state.count == want.count == 2 * 2 * 2
        assert_tree(m.opt_state.mu, want.mu, 2e-4, 5e-6, "mu")
        assert_tree(m.opt_state.nu, want.nu, 2e-4, 5e-9, "nu")
        assert float(m.kl_coeff) == pytest.approx(float(one.kl_coeff))


def test_opt_state_from_optax_checks_the_injected_count():
    """The ``inject_hyperparams`` state's own count is held against the
    inner Adam's."""
    ji, _, _, _ = jpbt.make_pbt_trainer(j_small(max_steps=8),
                                        JTrainConfig(**BASE))
    one = jax.tree.map(lambda x: np.asarray(x)[0],
                       ji(jax.random.PRNGKey(0), np.array([1e-3]),
                          np.array([0.01])))
    clip, inj = one.opt_state
    assert opt_state_from_optax(one.opt_state).count == 0
    with pytest.raises(ValueError, match="differ"):
        opt_state_from_optax((clip, inj._replace(count=np.int32(3))))


@dataclasses.dataclass
class FakeMember:
    learning_rate: torch.Tensor
    entropy_coef: torch.Tensor
    lineage: torch.Tensor   # which member's state this one carries


def fake_score(lineage, lr, ent, interval):
    """A member's metric from its lineage (which the exploit copies), its
    hyperparameters and the interval: different picks give other rows."""
    return ((lineage * 7 + interval * 3) % 11) * 0.25 + np.log(lr) * 0.5 \
        - ent * 4.0


class JaxFakeMember(NamedTuple):
    learning_rate: jax.Array
    entropy_coef: jax.Array
    lineage: jax.Array
    interval: jax.Array


def jax_fake(env_cfg, tcfg, arch="mlp", mesh=None):
    def init_members(key, lrs, ents):
        return JaxFakeMember(jnp.asarray(lrs, jnp.float32),
                             jnp.asarray(ents, jnp.float32),
                             jnp.arange(len(lrs)),
                             jnp.zeros(len(lrs), jnp.int32))

    def train_chunk(m, n):
        score = np.array([fake_score(int(l), float(lr), float(e), int(i))
                          for lr, e, l, i in zip(*m)], np.float32)
        return m._replace(interval=m.interval + 1), {
            "deliveries_per_env_step": jnp.repeat(jnp.asarray(score)[:, None],
                                                  n, axis=1)}

    def get_lr(m):
        return np.asarray(m.learning_rate)

    def with_hp(m, lrs, ents):
        return m._replace(learning_rate=jnp.asarray(lrs, jnp.float32),
                          entropy_coef=jnp.asarray(ents, jnp.float32))

    return init_members, train_chunk, get_lr, with_hp


def port_fake(env_cfg, tcfg, arch="mlp", mesh=None, device=None):
    interval = {"n": 0}

    def init_members(key, lrs, ents):
        return [FakeMember(torch.tensor(lr, dtype=torch.float32),
                           torch.tensor(e, dtype=torch.float32),
                           torch.tensor(p)) for p, (lr, e) in
                enumerate(zip(lrs, ents))]

    def train_chunk(members, n):
        score = torch.tensor([fake_score(int(m.lineage),
                                         float(m.learning_rate),
                                         float(m.entropy_coef),
                                         interval["n"]) for m in members],
                             dtype=torch.float32)
        interval["n"] += 1
        return members, {"deliveries_per_env_step":
                         score[:, None].repeat(1, n)}

    def get_lr(members):
        return np.array([float(m.learning_rate) for m in members])

    def with_hp(members, lrs, ents):
        return [dataclasses.replace(
            m, learning_rate=torch.tensor(lr, dtype=torch.float32),
            entropy_coef=torch.tensor(e, dtype=torch.float32))
            for m, lr, e in zip(members, lrs, ents)]

    return init_members, train_chunk, get_lr, with_hp


@pytest.mark.parametrize("space", [
    {"learning_rate": {"loguniform": [1e-4, 1e-2]},
     "entropy_coef": [0.005, 0.01, 0.02]},
    {"learning_rate": [1e-4, 3e-4, 1e-3]}])
def test_exploit_explore_matches_jax(monkeypatch, tmp_path, space):
    monkeypatch.setattr(jpbt, "make_pbt_trainer", jax_fake)
    monkeypatch.setattr(pbt, "make_pbt_trainer", port_fake)
    kw = dict(population_size=8, perturb_interval=2, num_intervals=4,
              quantile=0.25, resample_prob=0.5, seed=3)
    jres = jpbt.run_pbt(j_small(), JTrainConfig(**BASE), space, **kw)
    res = pbt.run_pbt(small_config(), TrainConfig(**BASE), space,
                      device="cpu", out_path=str(tmp_path / "pbt.jsonl"),
                      **kw)
    rows = [{k: v for k, v in r.items() if k != "backends"}
            for r in res.rows]
    assert len(rows) == 8 * 4 + 1
    for r, jr in zip(rows, jres.rows):
        assert r.keys() == jr.keys()
        for k in r:
            if isinstance(r[k], float):
                assert r[k] == pytest.approx(jr[k], rel=1e-6), (r, k)
            elif k != "best_hyperparams":
                assert r[k] == jr[k], (r, k)
    # The lineage the exploit copied, member by member.
    assert [int(m.lineage) for m in res.member] == [
        int(x) for x in jres.member.lineage]
    assert len({int(m.lineage) for m in res.member}) < 8
    lines = (tmp_path / "pbt.jsonl").read_text().splitlines()
    assert json.loads(lines[-1])["backends"] == pbt.BACKENDS


def test_run_pbt_end_to_end(tmp_path):
    res = pbt.run_pbt(
        small_config(max_steps=8), TrainConfig(**BASE),
        {"learning_rate": {"loguniform": [1e-4, 1e-2]},
         "entropy_coef": {"uniform": [0.005, 0.02]}},
        population_size=2, perturb_interval=1, num_intervals=2,
        quantile=0.5, device="cpu", out_path=str(tmp_path / "pbt.jsonl"))
    rows = [r for r in res.rows if "member" in r]
    assert len(rows) == 4 and all(np.isfinite(r["score"]) for r in rows)
    assert res.best["best_member"] in (0, 1)
    assert all(r["backends"] == {"rollout": "step", "grad": "plain"}
               for r in res.rows)
    for m in res.member:
        assert int(m.opt_state.count) == 2 * 2 * 2


def test_refusals():
    """A ``(pop, data)`` mesh whose data axis does not divide the envs, or
    whose pop axis does not divide the population, is refused with JAX's
    ``ValueError`` (``tests/test_torch_pop_mesh.py`` runs the meshed PBT);
    a fixed field in the hyperparameter space too."""
    cpu = torch.device("cpu")

    def pop_mesh(pop, data):
        return pmesh.PopMesh(whole=pmesh.DataMesh(None, 0, pop * data, cpu),
                             data=pmesh.DataMesh(None, 0, data, cpu),
                             pop=pop, ranks=tuple(range(pop * data)))

    with pytest.raises(ValueError, match="num_envs=8 not divisible by 3 "
                                         "data shards"):
        pbt.make_pbt_trainer(small_config(), TrainConfig(**BASE),
                             mesh=pop_mesh(1, 3), device="cpu")
    init, _, _, _ = pbt.make_pbt_trainer(
        small_config(), TrainConfig(**BASE), mesh=pop_mesh(2, 2),
        device="cpu")
    with pytest.raises(ValueError, match="population 3 not divisible by 2 "
                                         "pop shards"):
        init(torch.tensor([0, 1]), np.full(3, 1e-3), np.full(3, 0.01))
    assert pbt.member_range(6, pop_mesh(3, 1)) == range(0, 2)
    with pytest.raises(ValueError, match="PBT mutates"):
        pbt.run_pbt(small_config(), TrainConfig(**BASE),
                    {"num_envs": [8]}, device="cpu")

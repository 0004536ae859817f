"""The port's BFS pathing, ``greedy_bfs`` baseline and its evaluation
(``warehouse_tpu_torch/ops/pathing.py``, ``baselines/greedy.py``,
``evaluate.py``) against the JAX package on the CPU.

The JAX functions read the distance table by one-hot products in float32;
each sum selects one element, so the port's index reads are held bit-equal,
on states taken along an episode (random and greedy_bfs actions, numpy
seeded) that the port's engine steps and the JAX functions read as numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import warehouse_tpu as wj
import warehouse_tpu_torch as wt
from warehouse_tpu.baselines import greedy as jgreedy
from warehouse_tpu.env.state import EnvState as JEnvState
from warehouse_tpu.evaluate import evaluate_policy as j_evaluate
from warehouse_tpu.ops import pathing as jpathing
from warehouse_tpu_torch.baselines.greedy import (first_argmin,
                                                  greedy_actions,
                                                  greedy_bfs_actions,
                                                  target_cells)
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.evaluate import (evaluate_policy, main as eval_main,
                                          policy_fn_for)
from warehouse_tpu_torch.ops import pathing

from test_torch_env import env_keys
from test_torch_rng import assert_bits

B = 16
# 5x5 with a wall bar through the middle row and a gap at cell 12; 4x3 with
# a wall column that seals the right column off (an unreachable pocket).
LAYOUTS = {
    "small": dict(preset="small_config"),
    "medium": dict(preset="medium_config"),
    "shelves": dict(preset="shelves_config"),
    "walled": dict(height=5, width=5, num_agents=2, queue_capacity=4,
                   init_requests=2, spawn_prob=0.5, walls=(10, 11, 13, 14)),
    "sealed": dict(height=4, width=3, num_agents=1, queue_capacity=2,
                   init_requests=1, spawn_prob=0.5, walls=(1, 4, 7, 10)),
}


def configs(name, **kw):
    """(JAX config, port config) of a layout."""
    spec = dict(LAYOUTS[name], **kw)
    preset = spec.pop("preset", None)
    if preset:
        return getattr(wj, preset)(**spec), getattr(wt, preset)(**spec)
    return wj.EnvConfig(**spec), wt.EnvConfig(**spec)


def to_jax_state(state) -> JEnvState:
    fields = {f: jnp.asarray(getattr(state, f).numpy()) for f in STATE_FIELDS}
    fields["key"] = fields["key"].astype(jnp.uint32)
    return JEnvState(**fields)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_distance_table_equals_jax(name):
    jcfg, cfg = configs(name)
    table = pathing.distance_table(cfg)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, jpathing.distance_table(jcfg))
    assert int(pathing.UNREACHABLE) == int(jpathing.UNREACHABLE)
    dev = pathing.device_table(cfg, "cpu")
    assert dev.dtype == torch.int32 and dev.is_contiguous()
    assert pathing.device_table(cfg, torch.device("cpu")) is dev  # cached
    np.testing.assert_array_equal(dev.numpy(), table)
    if name == "sealed":
        assert table[0, 2] == pathing.UNREACHABLE and table[0, 9] == 3


@pytest.mark.parametrize("name", ["medium", "shelves", "walled", "sealed"])
def test_potential_and_targets_bit_equal(name):
    """``target_cells``, ``dist_rows``, ``dist_to_targets`` and
    ``potential`` on 12 states along an episode of random actions."""
    jcfg, cfg = configs(name, max_steps=12)
    _, keys = env_keys(4, n=B)
    state, _ = batch.reset_batch(cfg, keys)
    table = pathing.device_table(cfg, "cpu")
    jtable = jpathing.distance_table(jcfg)
    j_targets = jax.jit(jax.vmap(lambda s: jgreedy.target_cells(jcfg, s)))
    j_phi = jax.jit(jax.vmap(lambda s: jpathing.potential(jcfg, s)))
    j_rows = jax.jit(jax.vmap(
        lambda t: jpathing.dist_rows(jcfg, jtable, t, xp=jnp)))
    j_dist = jax.jit(jax.vmap(
        lambda c, t: jpathing.dist_to_targets(jcfg, jtable, c, t, xp=jnp)))
    rs = np.random.default_rng(0)
    seen_unreachable = seen_task = False
    for t in range(12):
        js = to_jax_state(state)
        cell, has = target_cells(cfg, state)
        j_cell, j_has = j_targets(js)
        assert cell.dtype == torch.int32 and has.dtype == torch.bool
        assert_bits(j_cell, cell, f"target cell t={t}")
        assert_bits(j_has, has, f"has t={t}")
        pos = state.agent_pos[..., 0] * cfg.width + state.agent_pos[..., 1]
        d = pathing.dist_to_targets(cfg, table, pos, cell)
        assert_bits(j_dist(jnp.asarray(pos.numpy()), j_cell), d, f"dist {t}")
        assert_bits(j_rows(j_cell), pathing.dist_rows(cfg, table, cell),
                    f"rows t={t}")
        phi = pathing.potential(cfg, state)
        assert phi.dtype == torch.float32
        assert_bits(j_phi(js), phi, f"potential t={t}")  # -0.0 included
        seen_unreachable |= bool((has & (d >= float(pathing.UNREACHABLE)))
                                 .any())
        seen_task |= bool((phi < 0).any())
        actions = torch.from_numpy(rs.integers(
            0, 5, size=(B, cfg.num_agents)).astype(np.int32))
        state, _ = batch.step_batch(cfg, state, actions)
    assert seen_task
    assert seen_unreachable == (name == "sealed")


@pytest.mark.parametrize("name", ["shelves", "walled", "sealed"])
def test_greedy_bfs_actions_bit_equal_over_an_episode(name):
    jcfg, cfg = configs(name, max_steps=64)
    _, keys = env_keys(3, n=B)
    state, _ = batch.reset_batch(cfg, keys)
    j_bfs = jax.jit(jax.vmap(lambda s: jgreedy.greedy_bfs_actions(jcfg, s)))
    delivered = 0
    for t in range(64):
        actions = greedy_bfs_actions(cfg, state)
        assert actions.dtype == torch.int32
        assert_bits(j_bfs(to_jax_state(state)), actions, f"t={t}")
        state, ts = batch.step_batch(cfg, state, actions)
        delivered += int(ts.delivered.sum())
    assert delivered > 0 or name == "sealed"


def test_greedy_bfs_equals_greedy_on_an_open_floor():
    """docs/SEMANTICS.md §12a: without walls the two baselines agree step
    by step, so their deliveries are equal."""
    _, cfg = configs("medium", max_steps=64)
    _, keys = env_keys(7, n=B)
    state, _ = batch.reset_batch(cfg, keys)
    delivered = 0
    for t in range(64):
        plain = greedy_actions(cfg, state)
        assert torch.equal(plain, greedy_bfs_actions(cfg, state)), t
        state, ts = batch.step_batch(cfg, state, plain)
        delivered += int(ts.delivered.sum())
    assert delivered > 0


def test_first_argmin_takes_the_lowest_index_on_a_tie():
    x = torch.tensor([[3.0, 1.0, 1.0, 2.0], [0.0, 0.0, 0.0, 0.0],
                      [5.0, 4.0, 3.0, 3.0]])
    assert first_argmin(x, -1).tolist() == [1, 0, 2]
    assert first_argmin(x.t(), 0).tolist() == [1, 0, 2]
    g = torch.Generator().manual_seed(0)
    y = torch.randint(0, 3, (64, 5), generator=g).float()
    assert torch.equal(first_argmin(y, -1),
                       torch.from_numpy(np.argmin(y.numpy(), -1)))


@pytest.mark.parametrize("name, policy", [("walled", "greedy_bfs"),
                                          ("shelves", "greedy_bfs"),
                                          ("shelves", "greedy")])
def test_evaluate_policy_greedy_bfs_matches_jax(name, policy):
    """Deliveries exactly; returns within 1e-6 relative (the episode sums
    run in another order than XLA's reduce)."""
    jcfg, cfg = configs(name, max_steps=32)
    fn = (jgreedy.greedy_bfs_actions if policy == "greedy_bfs"
          else jgreedy.greedy_actions)
    want = j_evaluate(jcfg, lambda state, obs, key: jax.vmap(
        lambda s: fn(jcfg, s))(state), 24, seed=5)
    got = evaluate_policy(cfg, policy_fn_for(policy, cfg), 24, seed=5,
                          device="cpu")
    assert got.keys() == want.keys()
    assert (got["mean_deliveries_per_episode"]
            == want["mean_deliveries_per_episode"])
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def test_evaluate_cli_greedy_bfs_beats_greedy_on_shelves(capsys):
    """``python -m warehouse_tpu_torch.evaluate --env shelves --policy
    greedy_bfs`` on the CPU, beside plain greedy (16 episodes)."""
    deliveries = {}
    for policy in ("greedy", "greedy_bfs"):
        eval_main(["--cpu", "--env", "shelves", "--policy", policy,
                   "--episodes", "16"])
        out = dict(line.split(": ") for line in
                   capsys.readouterr().out.strip().splitlines())
        deliveries[policy] = float(out["mean_deliveries_per_episode"])
    assert deliveries["greedy_bfs"] > 2 * deliveries["greedy"] > 0


def test_policy_fn_for_refuses_an_unknown_name():
    with pytest.raises(ValueError, match="not a baseline"):
        policy_fn_for("checkpoint", wt.small_config())

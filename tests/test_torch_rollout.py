"""K1, the greedy rollout (warehouse_tpu_torch/kernels/rollout.py), on the CPU.

On CPU tensors ``greedy_rollout`` runs its plain twin; it is held against
``greedy_rollout_pallas`` in interpret mode and against a scan of the JAX
``engine.step`` with the greedy policy. States and delivery counts are
bit-equal. The reward sum follows the unfused order of rollout.py:488-493
exactly; XLA on the CPU contracts that multiply-add chain into FMAs, so
the interpret-mode sums may differ by an ulp per step.
The CUDA kernel itself is checked on the card by test_torch_kernels_gpu.py
and chip_smoke.py.
"""

import jax
import numpy as np
import pytest
import torch

from warehouse_tpu.baselines.greedy import greedy_actions as j_greedy
from warehouse_tpu.config import EnvConfig, medium_config, shelves_config
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.pallas.rollout import greedy_rollout_pallas
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.kernels import build
from warehouse_tpu_torch.kernels.rollout import (f32, greedy_rollout,
                                                 greedy_rollout_reference)

from test_torch_env import assert_state, env_keys
from test_torch_rng import assert_bits

B, T = 32, 8


def engine_scan(cfg, js):
    """Per-step team events of the JAX engine under the greedy policy."""
    events = []
    for _ in range(T):
        a = jax.vmap(lambda s: j_greedy(cfg, s))(js)
        js, ts = jbatch.step_batch(cfg, js, a)
        events.append([np.asarray(x).sum(-1) for x in
                       (ts.picked, ts.delivered, ts.collided)])
    return js, np.array(events)                      # [T, 3, B]


def spec_reward_sum(cfg, events):
    """rollout.py:488-493 in float32, one rounding per operation."""
    f = np.float32
    rew = np.zeros(events.shape[-1], f)
    for n_pick, n_del, n_col in events.astype(f):
        s = f(f(cfg.step_penalty * cfg.num_agents)
              + f(f(cfg.pickup_reward) * n_pick))
        s = f(s + f(f(cfg.delivery_reward) * n_del))
        s = f(s + f(f(cfg.collision_penalty) * n_col))
        rew = f(rew + s)
    return rew


CONFIGS = {
    "medium": medium_config(max_steps=10**9),
    "shelves": shelves_config(max_steps=10**9),
    "high_contention": EnvConfig(height=4, width=4, num_agents=4,
                                 queue_capacity=4, init_requests=4,
                                 spawn_prob=0.9, max_steps=10**9),
}


def rollouts(name):
    cfg = CONFIGS[name]
    jk, tk = env_keys(0)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    return cfg, js, greedy_rollout(cfg, ts, T)


# Interpret mode traces the unrolled kernel, and the walls multiply its
# size, so the Pallas comparison runs on the open layouts.
@pytest.mark.parametrize("name", ["medium", "high_contention"])
def test_greedy_rollout_matches_pallas(name):
    cfg, js, (new, deliv, rew) = rollouts(name)
    p_state, p_deliv, p_rew = greedy_rollout_pallas(cfg, js, T, B, True)
    assert_state(p_state, new, "vs pallas")
    assert_bits(p_deliv, deliv, "delivered vs pallas")
    ulp = np.spacing(np.abs(np.asarray(p_rew)).max() + 1)
    np.testing.assert_allclose(rew.numpy(), np.asarray(p_rew), rtol=0,
                               atol=T * ulp)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_greedy_rollout_matches_engine_scan(name):
    cfg, js, (new, deliv, rew) = rollouts(name)
    e_state, events = engine_scan(cfg, js)
    assert_state(e_state, new, "vs engine scan")
    np.testing.assert_array_equal(events[:, 1].sum(0), deliv.numpy())
    assert_bits(spec_reward_sum(cfg, events), rew, "reward sum")
    assert int(deliv.sum()) > 0


def test_twin_is_the_cpu_path():
    cfg = medium_config()
    _, tk = env_keys(1)
    ts, _ = batch.reset_batch(cfg, tk)
    a = greedy_rollout(cfg, ts, 4)
    b = greedy_rollout_reference(cfg, ts, 4)
    assert_state(a[0], b[0])
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_rejects_auto_reset():
    cfg = medium_config(auto_reset=True)
    _, tk = env_keys(0, n=2)
    ts, _ = batch.reset_batch(cfg, tk)
    with pytest.raises(ValueError, match="auto_reset"):
        greedy_rollout(cfg, ts, 4)


def test_kernel_shapes_are_the_presets():
    """The library holds the presets' env instances; any other pair is
    named for its own library by the sources' hash and the pair."""
    import warehouse_tpu_torch.config as pcfg

    presets = {(c.num_agents, c.queue_capacity) for c in (
        pcfg.small_config(), pcfg.medium_config(), pcfg.large_config(),
        pcfg.shelves_config())}
    assert set(build.PRESET_SHAPES) == presets
    stem = build.pair_stem(4, 5)
    assert stem.startswith("env-a4-q5-") and stem == build.pair_stem(4, 5)
    assert len({stem, build.pair_stem(5, 4), build.pair_stem(4, 6)}) == 3
    assert build.pair_defines(4, 5) == ("WH_PAIR_A=4", "WH_PAIR_R=5")
    assert f32(0.1) == float(np.float32(0.1))


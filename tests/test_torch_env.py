"""The port's batched engine (warehouse_tpu_torch.env) vs warehouse_tpu.env.

Same keys and actions (numpy, seeded) through both; every EnvState and
TimeStep field must be bit-equal, step after step, over 2 x max_steps
steps so every episode truncates (and auto-resets) twice. Random actions
make collisions; every third step the greedy baseline drives instead and
its actions are held against the JAX greedy policy too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.baselines.greedy import greedy_actions as j_greedy
from warehouse_tpu.config import (large_config, medium_config,
                                  shelves_config, small_config)
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.ops.move import valid_action_mask as j_valid
from warehouse_tpu_torch.baselines.greedy import greedy_actions
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.ops.move import valid_action_mask

from test_torch_rng import assert_bits, to_torch

TS_FIELDS = ("obs", "final_obs", "reward", "terminated", "truncated",
             "picked", "delivered", "collided")
B = 32
CONFIGS = {
    "small": small_config(max_steps=6),
    "medium": medium_config(max_steps=6),
    "large": large_config(max_steps=6),
    "shelves": shelves_config(max_steps=6),
    "medium_global_obs": medium_config(max_steps=6, global_obs=True),
}


def env_keys(seed, n=B):
    k = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(seed), i))(
        jnp.arange(n))
    return k, to_torch(k)


DTYPES = dict.fromkeys(STATE_FIELDS, torch.int32) | {
    "carrying": torch.bool, "key": torch.int64}


def assert_state(js, ts, what=""):
    for f in STATE_FIELDS:
        assert getattr(ts, f).dtype == DTYPES[f], (what, f)
        assert_bits(getattr(js, f), getattr(ts, f), f"{what} {f}")


def assert_timestep(jts, tts, what=""):
    for f in TS_FIELDS:
        assert_bits(getattr(jts, f), getattr(tts, f), f"{what} {f}")


j_greedy_batch = jax.jit(jax.vmap(j_greedy, in_axes=(None, 0)),
                         static_argnums=0)


def drive(cfg, js, ts, steps, j_step, t_step, seed=0):
    """Step both engines; greedy every third step, random otherwise."""
    rng = np.random.default_rng(seed)
    for t in range(steps):
        if t % 3 == 2:
            a = np.array(j_greedy_batch(cfg, js))
            assert_bits(a, greedy_actions(cfg, ts), f"greedy t={t}")
        else:
            a = rng.integers(0, 5, (B, cfg.num_agents)).astype(np.int32)
        js, jts = j_step(cfg, js, jnp.asarray(a))
        ts, tts = t_step(cfg, ts, torch.from_numpy(a))
        assert_state(js, ts, f"t={t}")
        assert_timestep(jts, tts, f"t={t}")
    return js, ts


@pytest.mark.parametrize("auto_reset", [False, True])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reset_and_step_bit_exact(name, auto_reset):
    cfg = CONFIGS[name].replace(auto_reset=auto_reset)
    jk, tk = env_keys(3)
    js, jobs = jbatch.reset_batch(cfg, jk)
    ts, tobs = batch.reset_batch(cfg, tk)
    assert_state(js, ts, "reset")
    assert_bits(jobs, tobs, "reset obs")
    drive(cfg, js, ts, 2 * cfg.max_steps, jbatch.step_batch,
          batch.step_batch)


@pytest.mark.parametrize("name", ["medium", "shelves"])
def test_step_autoreset_batch(name):
    cfg = CONFIGS[name].replace(auto_reset=True)
    jk, tk = env_keys(5)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    drive(cfg, js, ts, 2 * cfg.max_steps, jbatch.step_autoreset_batch,
          batch.step_autoreset_batch, seed=1)


def test_reset_truncated_batch():
    """Half the envs at the episode end, half mid-episode."""
    cfg = CONFIGS["medium"]
    jk, tk = env_keys(9)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    js, ts = drive(cfg, js, ts, cfg.max_steps, jbatch.step_batch,
                   batch.step_batch, seed=2)
    t = np.where(np.arange(B) % 2 == 0, cfg.max_steps, 2).astype(np.int32)
    js = js.replace(t=jnp.asarray(t))
    ts = ts.replace(t=torch.from_numpy(t))
    rk_j, rk_t = env_keys(11)
    j_out = jbatch.reset_truncated_batch(cfg, js, rk_j)
    t_out = batch.reset_truncated_batch(cfg, ts, rk_t)
    assert_state(j_out[0], t_out[0], "reset")
    assert_bits(j_out[1], t_out[1], "obs")
    assert_bits(j_out[2], t_out[2], "done")


def test_observe_batch_and_valid_action_mask():
    cfg = CONFIGS["shelves"]
    jk, tk = env_keys(13)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    assert_bits(jbatch.observe_batch(cfg, js), batch.observe_batch(cfg, ts))
    assert_bits(jax.vmap(lambda p: j_valid(cfg, p))(js.agent_pos),
                valid_action_mask(cfg, ts.agent_pos))

"""The slice as a whole: MLP, chunked acting with the boundary reset,
serving and evaluation, each held against the JAX package; and the port
imports without jax.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.config import medium_config, small_config
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.evaluate import evaluate_policy as j_evaluate
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.pallas.act import ppo_rollout_pallas
from warehouse_tpu.serve import Policy as JPolicy
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.evaluate import evaluate_policy, policy_fn_for
from warehouse_tpu_torch.kernels.act import ppo_rollout
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.serve import Policy

from test_torch_env import assert_state, env_keys
from test_torch_rng import assert_bits

HIDDEN = 32


def flax_and_port(cfg, seed=0, hidden=HIDDEN):
    jm = j_make_model(cfg, hidden_dim=hidden)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.obs_dim)))
    m = make_model(cfg, hidden_dim=hidden, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, m


def test_mlp_forward_matches_flax():
    cfg = medium_config()
    jm, params, m = flax_and_port(cfg)
    obs = np.random.default_rng(0).random((64, cfg.num_agents, cfg.obs_dim),
                                          np.float32)
    j_logits, j_value = jm.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        logits, value = m(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value),
                               rtol=0, atol=1e-5)


def test_init_is_orthogonal_and_seeded():
    cfg = medium_config()
    a = make_model(cfg, hidden_dim=HIDDEN,
                   generator=torch.Generator().manual_seed(1), device="cpu")
    b = make_model(cfg, hidden_dim=HIDDEN,
                   generator=torch.Generator().manual_seed(1), device="cpu")
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
    for layer, gain in zip(a.layers(), [2 ** 0.5] * 2 + [0.01, 1.0]):
        w = layer.weight.detach().double()
        rows = min(w.shape)
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        torch.testing.assert_close(gram, gain ** 2 * torch.eye(
            rows, dtype=torch.float64), rtol=0, atol=1e-5)
        assert not layer.bias.any()


def test_chunked_acting_with_boundary_reset():
    """Two episodes of two chunks each, the reset between chunks, against
    the JAX fused-kernel path of train/ppo.py (interpret mode)."""
    T = 4
    cfg = small_config(max_steps=2 * T)
    jm, params, m = flax_and_port(cfg)
    jk, tk = env_keys(21, n=32)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    j_key, t_key = jax.random.PRNGKey(5), rng.prng_key(5)
    for chunk in range(4):
        j_new, j_roll, j_rk, j_key = ppo_rollout_pallas(
            cfg, params, js, T, j_key, block=32, interpret=True)
        js, j_obs, j_done = jbatch.reset_truncated_batch(cfg, j_new, j_rk)
        t_new, roll, t_rk, t_key = ppo_rollout(cfg, m, ts, T, t_key)
        ts, t_obs, t_done = batch.reset_truncated_batch(cfg, t_new, t_rk)
        for f in ("obs", "action", "reward", "delivered", "truncated"):
            assert_bits(getattr(j_roll, f), getattr(roll, f),
                        f"chunk {chunk} {f}")
        assert_state(js, ts, f"chunk {chunk}")
        assert_bits(j_obs, t_obs, f"chunk {chunk} obs")
        assert bool(t_done.all()) == (chunk % 2 == 1)
    assert_bits(j_key, t_key, "key")


def test_serve_compute_actions_matches_jax():
    cfg = medium_config()
    jm, params, m = flax_and_port(cfg, seed=3)
    obs = np.random.default_rng(1).random((16, cfg.num_agents, cfg.obs_dim),
                                          np.float32)
    j_acts, _ = JPolicy(cfg, jm, params).compute_actions(obs)
    pol = Policy(cfg, m)
    acts, carry = pol.compute_actions(obs)
    assert carry is None and acts.dtype == torch.int32
    assert_bits(j_acts, acts, "argmax actions")
    single, _ = pol.compute_single_action(obs[0])
    np.testing.assert_array_equal(single, acts[0].numpy())
    s1, _ = pol.compute_actions(obs, explore=True, seed=7)
    s2, _ = pol.compute_actions(obs, explore=True, seed=7)
    assert torch.equal(s1, s2)
    with pytest.raises(FileNotFoundError, match="policy_meta.json"):
        Policy.from_checkpoint("no_such_checkpoints", device="cpu")


@pytest.mark.parametrize("policy", ["greedy", "random"])
def test_evaluate_policy_matches_jax(policy):
    cfg = small_config(max_steps=16)
    if policy == "greedy":
        from warehouse_tpu.baselines.greedy import greedy_actions

        def j_fn(state, obs, key):
            return jax.vmap(lambda s: greedy_actions(cfg, s))(state)
    else:
        from warehouse_tpu.baselines.random import random_actions

        def j_fn(state, obs, key):
            return random_actions(cfg, key, (obs.shape[0],)).astype("int32")
    want = j_evaluate(cfg, j_fn, 24, seed=3)
    got = evaluate_policy(cfg, policy_fn_for(policy, cfg), 24, seed=3,
                          device="cpu")
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


def test_port_imports_without_jax():
    """Every module of the port (the package walked, not listed by hand;
    the utilities, the dict API, the sweeps, the mesh and the oracle
    named too),
    chip_smoke.py, the card-only test file and the file whose function the
    spawned mesh ranks run import with nothing of jax and nothing of the
    JAX package ``warehouse_tpu`` in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import warehouse_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    if not m.name.endswith('.__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "import warehouse_tpu_torch.train.__main__\n"
        "new = ('utils.profiling', 'utils.debug', 'env.wrapper',\n"
        "       'env.render', 'env.pettingzoo_adapter', 'registry',\n"
        "       'demo', 'train.sweep', 'train.pbt', 'parallel.mesh',\n"
        "       'parallel.distributed', 'oracle', 'oracle.draws',\n"
        "       'oracle.env', 'oracle.greedy')\n"
        "assert all('warehouse_tpu_torch.' + m in sys.modules\n"
        "           for m in new)\n"
        "import chip_smoke\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_kernels_gpu\n"
        "import test_torch_mesh_ranks\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',\n"
        "                              'orbax', 'warehouse_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('warehouse_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 46


def test_import_check_sees_the_jax_package():
    """The check above is not blind: the same scan after importing the JAX
    package's config finds it."""
    code = ("import sys, warehouse_tpu.config\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('warehouse_tpu',)]\n"
            "assert bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr

"""Policy groups with the CNN policy (``--arch cnn --policy-groups``), on
the CPU.

On CPU tensors K10's wrapper runs its plain twin; the JAX package runs its
Pallas act kernel in interpret mode (``ppo_rollout_pallas(arch="cnn",
policy_groups=...)``) and, for the trainer, its fused acting with the XLA
learner, the route it takes because its fused CNN learner is
single-policy. The same inputs, made from seeds with numpy or carried over
from the JAX side, go through both, at small sizes (hidden 16, T = 4):

- ``params_from_flax`` of a flax ``MultiPolicyActorCritic`` tree of CNNs
  at 4 agents ``(0, 1, 0, 1)``: logits and values within 1e-6 of flax's;
- K10's twin with groups against the Pallas kernel: obs, actions on the
  JAX gumbel stream, deliveries, mask and final state bit-equal, rewards
  bit-equal (the shaped reward within 1e-6: XLA:CPU contracts its sums),
  values and log-probs within 1e-5; plain on the small layout ``(1, 0)``,
  masked and shaped mid-episode on a 3-agent walled shelves layout ``(0,
  1, 0)`` (the 6-agent preset takes minutes to compile in interpret mode),
  one policy per agent there ``(0, 1, 2)`` and on the 4-agent map ``(0, 1,
  2, 3)``, and two groups ``(0, 1, 0, 1)`` on the 9x9 global view;
- ``make_train(arch="cnn", policy_groups=...)`` against the JAX trainer
  with ``rollout_backend="pallas"`` (interpret mode) and
  ``grad_backend="xla"`` for 3 updates across an episode boundary, with
  ``(0, 1)`` on the small layout and one policy per agent on the 4-agent
  map: env
  state, obs and keys bit-equal after every update, metrics within 2e-4 +
  1e-3 relative, params and Adam moments at ``tests/test_torch_train.py``'s
  bounds; ``backends`` plain on the CPU;
- the CLI: ``--arch cnn --policy-groups 0,1`` trains, its meta line names
  the backends and ``Policy.from_checkpoint`` serves the checkpoint.

The CUDA kernel's group route is held against this twin on the card by
``test_torch_kernels_gpu.py`` and ``chip_smoke.py`` (``k10_groups_check``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import (TrainConfig, medium_config, shelves_config,
                                  small_config)
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_multi_policy_model as j_multi
from warehouse_tpu.pallas.act import ppo_rollout_pallas
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels.act import Shaping, act_steps, ppo_rollout
from warehouse_tpu_torch.models import (ActorCriticCNN,
                                        make_multi_policy_model,
                                        params_from_flax)
from warehouse_tpu_torch.models.policy import apply
from warehouse_tpu_torch.ops.ppo_update import first_argmax
from warehouse_tpu_torch.serve import Policy
from warehouse_tpu_torch.train import make_train, runner_state_from_jax
from warehouse_tpu_torch.train.__main__ import main as train_main

from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch

T, HIDDEN, B = 4, 16, 16
COEF, GAMMA = 0.02, 0.99
WALLED3 = shelves_config(max_steps=2 * T, num_agents=3, queue_capacity=6,
                         init_requests=3)


def tree_np(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def j_params(cfg, groups, seed):
    jm = j_multi(cfg, groups, arch="cnn", hidden_dim=HIDDEN)
    return jm, jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.obs_dim)),
                       jnp.zeros(1, jnp.int32))


def port_model(cfg, groups, params):
    m = make_multi_policy_model(cfg, groups, "cnn", hidden_dim=HIDDEN,
                                device="cpu")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in tree_np(params).items()})
    return m


def test_params_from_flax_cnn_groups():
    cfg = medium_config()
    groups = (0, 1, 0, 1)
    jm, params = j_params(cfg, groups, seed=2)
    m = port_model(cfg, groups, params)
    assert all(isinstance(p, ActorCriticCNN) for p in m.policies)
    assert {k.split(".")[1] for k in m.state_dict()} == {"0", "1"}
    obs = np.random.default_rng(3).normal(
        size=(8, cfg.num_agents, cfg.obs_dim)).astype(np.float32)
    gids = np.broadcast_to(np.asarray(groups, np.int32), obs.shape[:2])
    j_logits, j_value = jm.apply(params, jnp.asarray(obs), jnp.asarray(gids))
    with torch.no_grad():
        logits, value = m(torch.from_numpy(obs), torch.tensor(groups))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=0,
                               atol=1e-6)


# ---- (K10) the acting twin against the Pallas kernel's groups ---------------

ACT_CASES = {  # name: (config, groups, masked and shaped, start step)
    "small_10": (small_config(max_steps=T), (1, 0), False, 0),
    "walled3_masked_shaped": (WALLED3, (0, 1, 0), True, T),
    # One policy per agent, and two groups on the 9x9 global view: the maps
    # that need the kernel's one-group-at-a-time passes on the card.
    "walled3_per_agent_masked_shaped": (WALLED3, (0, 1, 2), True, T),
    "medium_per_agent": (medium_config(max_steps=T), (0, 1, 2, 3), False, 0),
    "medium_global_0101": (medium_config(max_steps=T, global_obs=True),
                           (0, 1, 0, 1), False, 0),
}


@pytest.fixture(scope="module", params=sorted(ACT_CASES))
def act_setup(request):
    cfg, groups, on, t0 = ACT_CASES[request.param]
    _, params = j_params(cfg, groups, seed=1)
    jk, tk = env_keys(4, n=B)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    js = js.replace(t=js.t + t0)
    ts = ts.replace(t=ts.t + t0)
    out = ppo_rollout_pallas(cfg, params, js, T, jax.random.PRNGKey(9),
                             block=B, interpret=True, mask_actions=on,
                             shaping_coef=COEF if on else 0.0, gamma=GAMMA,
                             policy_groups=groups, arch="cnn")
    return cfg, groups, on, port_model(cfg, groups, params), ts, out


def test_grouped_cnn_twin_matches_pallas_kernel(act_setup):
    cfg, groups, on, m, ts, (j_new, j_roll, _, _) = act_setup
    A = cfg.num_agents
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T, (5, B * A))
    mask = shaping = None
    if on:
        mask = torch.zeros(T, B, A, 5, dtype=torch.bool)
        done = to_torch(j_roll.truncated).to(torch.float32)
        assert bool(done[-1].all())  # the chunk ends the episode
        shaping = Shaping(COEF, GAMMA, done, torch.zeros(T, B, A))
    new, obs, action, lp, value, reward, delivered = act_steps(
        cfg, m, ts, u, pick, drop, to_torch(g), mask=mask, shaping=shaping,
        groups=groups)
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.delivered, delivered, "delivered")
    if on:
        assert_bits(j_roll.mask, mask, "mask")
        assert_bits(j_roll.raw_reward, shaping.raw_reward, "raw reward")
        np.testing.assert_allclose(reward.numpy(), np.asarray(j_roll.reward),
                                   rtol=0, atol=1e-6)
    else:
        assert_bits(j_roll.reward, reward, "reward")
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-5)
    # The wrapper with the JAX wrapper's names; each agent's group's
    # values, which differ from group 0's on the other groups' agents.
    _, roll, _, _ = ppo_rollout(cfg, m, ts, T, rng.prng_key(9),
                                mask_actions=on, policy_groups=groups,
                                shaping_coef=COEF if on else 0.0,
                                gamma=GAMMA, arch="cnn")
    assert_bits(j_roll.truncated, roll.truncated, "truncated")
    with torch.no_grad():
        one = m.policies[0](roll.obs)[1]
    g0 = torch.tensor(groups) == 0
    assert torch.allclose(one[..., g0], roll.value[..., g0], atol=1e-5)
    assert not torch.allclose(one[..., ~g0], roll.value[..., ~g0], atol=1e-5)


# ---- the trainer against the JAX trainer ------------------------------------

TCFG = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   kl_coeff=0.1, entropy_coef_final=0.001, mask_actions=True)


@pytest.mark.parametrize("cfg,groups", [
    (small_config(max_steps=8), (0, 1)),
    (medium_config(max_steps=8), (0, 1, 2, 3))], ids=["small_10",
                                                      "medium_per_agent"])
def test_grouped_cnn_train_steps_match_jax_trainer(cfg, groups):
    """3 masked updates from a carried-over state; the episode ends with
    update 2 (max_steps 8, T = 4). The JAX trainer acts through its Pallas
    kernel with groups (interpret mode) and learns on XLA. Two groups on
    the small layout, and one policy per agent on the 4-agent map."""
    jtr = j_make_train(cfg, TCFG.replace(
        rollout_backend="pallas", pallas_interpret=True, pallas_block=16,
        grad_backend="xla"), arch="cnn", policy_groups=groups)
    tr = make_train(cfg, TCFG, arch="cnn", policy_groups=groups,
                    device="cpu")
    assert tr.backends == {"rollout": "plain", "grad": "plain"}
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    assert rs.params.keys() == tr.model.state_dict().keys()
    for u in range(3):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert_bits(jrs.obs, rs.obs, f"update {u} obs")
        assert bool((rs.env_state.t == 0).all()) == (u == 1)
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    for k, v in tree_np(jrs.params).items():
        np.testing.assert_allclose(rs.params[k].numpy(), v, rtol=2e-4,
                                   atol=5e-5, err_msg=k)
    _, mu, _ = find_adam_state(jrs.opt_state)
    for k, v in tree_np(mu).items():
        np.testing.assert_allclose(rs.opt_state.mu[k].numpy(), v, rtol=2e-4,
                                   atol=5e-6, err_msg=f"mu {k}")


def test_cli_cnn_groups_checkpoint_serves(tmp_path):
    """``--arch cnn --policy-groups 0,1`` trains 2 updates on the CPU; the
    meta line names the backends; ``Policy.from_checkpoint`` acts as the
    trained params do."""
    ckpt = tmp_path / "ckpt"
    path = tmp_path / "m.jsonl"
    train_main(["--cpu", "--arch", "cnn", "--env", "small", "--env-config",
                '{"max_steps": 8}', "--num-envs", "16", "--unroll-length",
                "4", "--num-updates", "2", "--num-minibatches", "2",
                "--ppo-epochs", "1", "--hidden-dim", "16", "--policy-groups",
                "0,1", "--log-every", "1", "--checkpoint-every", "2",
                "--checkpoint-dir", str(ckpt), "--metrics-path", str(path)])
    meta = json.loads(path.read_text().splitlines()[0])
    assert meta["backends"] == {"rollout": "plain", "grad": "plain"}
    policy = Policy.from_checkpoint(str(ckpt), device="cpu")
    assert policy.policy_groups == (0, 1) and policy.arch == "cnn"
    params = dict(policy.model.state_dict())
    assert "policies.1.conv.0.weight" in params
    _, obs = batch.reset_batch(policy.env_cfg, env_keys(7, n=4)[1])
    acts, _ = policy.compute_actions(obs)
    logits, _ = apply(params, obs, torch.tensor((0, 1)))
    assert torch.equal(acts, first_argmax(logits, -1).to(torch.int32))

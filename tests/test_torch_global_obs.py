"""Global observations in the port (``EnvConfig.global_obs``), on the CPU.

On CPU tensors the port's wrappers run their plain twins; the JAX package
runs its Pallas kernels in interpret mode or, for the trainer, its XLA
route. The same inputs, made from seeds with numpy or carried over from the
JAX side, go through both:

- the acting twin against ``ppo_rollout_pallas(interpret=True)`` with the
  in-kernel global view on a walled 3-agent shelves layout (interpret mode
  on the full 6-agent preset takes minutes to compile): obs, actions on the
  JAX gumbel stream, mask, raw reward and final state bit-equal; the shaped
  reward within 4 ulp (XLA:CPU contracts the shaping's sums, as
  ``test_torch_act.py`` notes); values 1e-5, log-probs 1e-4;
- the learner twins at the medium preset's global width D = 411 against
  ``ppo_sgd_phase_pallas`` / ``ppo_minibatch_grads_pallas`` in interpret
  mode at hidden 16, with ``tests/test_grad_kernel.py``'s tolerances;
- ``make_train`` with ``global_obs`` for the MLP and the CNN against the
  JAX trainer's XLA route for 3 updates from a carried-over state: env
  state and keys bit-equal, metrics within 2e-4 + 1e-3 relative, params
  rtol 2e-4 / atol 5e-5 (``test_torch_train.py``'s bounds);
- ``params_from_flax`` for the global CNN on the 9 x 9 map (a ``[3, 3, 5,
  16]`` flax kernel, a trunk over the channel-last flatten of 9 x 9 x 32):
  logits and value within 1e-5 of flax on one numpy batch;
- a global-obs checkpoint written by the train CLI: ``Policy.
  from_checkpoint`` rebuilds the env with its global view and returns the
  trained policy's actions, and ``evaluate --policy checkpoint`` runs on it.

The CUDA kernels' global view is held on the card by
``test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import (TrainConfig, medium_config, shelves_config,
                                  small_config)
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.models.policy import ActorCriticMLP as JMLP
from warehouse_tpu.pallas.act import _pad8, ppo_rollout_pallas
from warehouse_tpu.pallas.sgd import (FIELD_ROWS, find_adam_state,
                                      ppo_minibatch_grads_pallas,
                                      ppo_sgd_phase_pallas)
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.config import shelves_config as t_shelves_config
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.evaluate import checkpoint_policy_fn
from warehouse_tpu_torch.evaluate import main as evaluate_main
from warehouse_tpu_torch.kernels import sgd
from warehouse_tpu_torch.kernels.act import (Shaping, act_steps, ppo_rollout)
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.models.policy import apply
from warehouse_tpu_torch.ops.ppo_update import first_argmax
from warehouse_tpu_torch.optim import (ClipAdam, linear_schedule,
                                       opt_state_from_optax)
from warehouse_tpu_torch.serve import Policy
from warehouse_tpu_torch.train import (Transition, make_train,
                                       runner_state_from_jax)
from warehouse_tpu_torch.train.__main__ import main as train_main

from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch, ulps

B, T, HIDDEN = 16, 4, 32
COEF, GAMMA = 0.02, 0.99
WALLED = shelves_config(max_steps=T, global_obs=True, num_agents=3,
                        queue_capacity=6, init_requests=3)


def tree_np(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


# ---- (a) the acting twin against the Pallas kernel's global view ---------------

@pytest.fixture(scope="module")
def act_setup():
    """``ppo_rollout_pallas`` with the global view, masked and shaped, in
    interpret mode, and the port's model and start state."""
    jm = j_make_model(WALLED, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, WALLED.obs_dim)))
    m = make_model(WALLED, hidden_dim=HIDDEN, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    jk, tk = env_keys(3, n=B)
    js, jobs = jbatch.reset_batch(WALLED, jk)
    ts, tobs = batch.reset_batch(WALLED, tk)
    out = ppo_rollout_pallas(WALLED, params, js, T, jax.random.PRNGKey(9),
                             block=B, interpret=True, mask_actions=True,
                             shaping_coef=COEF, gamma=GAMMA)
    return m, ts, jobs, tobs, out


def test_global_obs_twin_matches_pallas_kernel(act_setup):
    m, ts, jobs, tobs, (j_new, j_roll, _, _) = act_setup
    A, D = WALLED.num_agents, WALLED.obs_dim
    assert D == 5 * 121 + 6 and m.hidden[0].in_features == D
    assert_bits(jobs, tobs, "reset obs")
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, WALLED, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T, (5, B * A))
    mask = torch.zeros(T, B, A, 5, dtype=torch.bool)
    done = to_torch(j_roll.truncated).to(torch.float32)
    shaping = Shaping(COEF, GAMMA, done, torch.zeros(T, B, A))
    new, obs, action, lp, value, reward, delivered = act_steps(
        WALLED, m, ts, u, pick, drop, to_torch(g), mask=mask,
        shaping=shaping)
    assert obs.shape == (T, B, A, D)
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.mask, mask, "mask")
    assert_bits(j_roll.delivered, delivered, "delivered")
    assert_bits(j_roll.raw_reward, shaping.raw_reward, "raw reward")
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    assert int(ulps(j_roll.reward, reward.numpy()).max()) <= 4
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-4)
    # Channel 4 is the layout: the racks' cells read 0, everywhere.
    grid = obs[..., :-6].reshape(T, B, A, 121, 5)
    walls = torch.zeros(121, dtype=torch.bool)
    walls[list(WALLED.walls)] = True
    assert torch.equal(grid[..., 4] == 0, walls.expand(T, B, A, 121))
    # Channel 0 marks the agent itself, channel 1 never its own cell.
    assert bool((grid[..., 0].sum(-1) == 1).all())
    assert not bool((grid[..., 0] * grid[..., 1]).any())


def test_global_obs_wrapper_keys_and_truncation(act_setup):
    """``ppo_rollout`` on a global-obs config: the wrapper's keys and flags
    are the JAX wrapper's, the first obs is the engine's global view."""
    m, ts, _, tobs, (j_new, j_roll, j_rk, j_nk) = act_setup
    new, roll, rk, nk = ppo_rollout(WALLED, m, ts, T, rng.prng_key(9),
                                    mask_actions=True, shaping_coef=COEF,
                                    gamma=GAMMA)
    assert_bits(j_rk, rk, "reset_key_last")
    assert_bits(j_nk, nk, "next key")
    assert_bits(j_new.key, new.key, "key")
    assert_bits(j_roll.truncated, roll.truncated, "truncated")
    assert torch.equal(roll.obs[0], tobs)


# ---- (d) the learner twins at D = 411 against the Pallas kernels ---------------

SA, SD, SH, SB, SE, SM = 4, 411, 16, 8, 2, 2
CLIP, VCOEF, MAXNORM, ENT, KL = 0.2, 0.5, 0.5, 0.01, 0.05


def sgd_setup(seed):
    """A numpy trajectory at the medium preset's global width (A = 4, D =
    411), a flax MLP 411 -> 16 -> 16 and its optax state; masks on."""
    r = np.random.default_rng(seed)
    shape = (T, SB, SA)
    obs = r.normal(size=(*shape, SD)).astype(np.float32)
    action = r.integers(0, 5, size=shape).astype(np.int32)
    old_lp = (-1.6 + 0.1 * r.normal(size=shape)).astype(np.float32)
    old_v, adv, tgt = (r.normal(size=shape).astype(np.float32)
                       for _ in range(3))
    mask = r.random(size=(*shape, 5)) > 0.3
    mask[..., 0] = True
    np.put_along_axis(mask, action[..., None], True, -1)
    g = adv.reshape(T, SM, SB // SM, SA)
    adv_n = ((g - g.mean(axis=(0, 2, 3), keepdims=True))
             / (g.std(axis=(0, 2, 3), keepdims=True) + 1e-8)).reshape(shape)
    model = JMLP(num_actions=5, hidden_dims=(SH, SH))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, SD)))
    sched = optax.linear_schedule(3e-4, 0.0, 100)
    tx = optax.chain(optax.clip_by_global_norm(MAXNORM),
                     optax.adam(sched, eps=1e-5))
    return params, sched, tx.init(params), (obs, action, old_lp, old_v,
                                            adv_n.astype(np.float32), tgt,
                                            mask)


def pallas_inputs(data):
    """The TPU kernels' packed layout (``tests/test_grad_kernel.py``
    ``_kernel_inputs``): obs ``[T A Dp, B]``, the field rows ``[T A 16,
    B]``."""
    obs, action, old_lp, old_v, adv_n, tgt, mask = map(jnp.asarray, data)
    dp = _pad8(SD)
    obs_bm = jnp.pad(obs.transpose(0, 2, 3, 1),
                     ((0, 0), (0, 0), (0, dp - SD), (0, 0))
                     ).reshape(T * SA * dp, SB)

    def row(x):
        return x.transpose(0, 2, 1).reshape(T * SA, SB)

    rows = [row(action.astype(jnp.float32)), row(old_lp), row(old_v),
            row(adv_n), row(tgt)]
    rows += [row(mask[..., r].astype(jnp.float32)) for r in range(5)]
    rows += [jnp.zeros((T * SA, SB), jnp.float32)] * (FIELD_ROWS - len(rows))
    return obs_bm, jnp.stack(rows, axis=1).reshape(T * SA * FIELD_ROWS, SB)


def port_inputs(params, data):
    obs, action, old_lp, old_v, adv_n, tgt, mask = map(torch.from_numpy,
                                                       data)
    zeros = torch.zeros_like(old_v)
    traj = Transition(obs, action, old_lp, old_v, zeros, zeros.bool(), mask,
                      zeros)
    return ({k: torch.from_numpy(v) for k, v in tree_np(params).items()},
            traj, adv_n, tgt)


def assert_tree(port, jax_tree, rtol, atol, what):
    want = tree_np(jax_tree)
    assert port.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def test_sgd_phase_twin_at_global_width_matches_pallas():
    params, sched, opt_state, data = sgd_setup(0)
    n_steps = SE * SM
    steps = jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_p, opt_p, l_p = ppo_sgd_phase_pallas(
        params, opt_state, *pallas_inputs(data),
        jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
        1.0 - 0.999 ** cnt, ENT, KL, num_epochs=SE, num_minibatches=SM,
        clip_eps=CLIP, value_coef=VCOEF, max_grad_norm=MAXNORM,
        mask_actions=True, obs_dim=SD, block_envs=SB // SM, rows_per_block=4,
        interpret=True)
    p0, traj, adv_n, tgt = port_inputs(params, data)
    assert p0["hidden.0.weight"].shape == (SH, SD)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    rows = ClipAdam(linear_schedule(3e-4, 0.0, 100), MAXNORM).step_rows(
        opt0.count, n_steps)
    p_t, opt_t, l_t = sgd.ppo_sgd_phase(
        p0, opt0, traj, adv_n, tgt, *rows, ENT, KL, num_epochs=SE,
        num_minibatches=SM, clip_eps=CLIP, value_coef=VCOEF,
        max_grad_norm=MAXNORM, mask_actions=True)
    for a, b in zip(l_t, l_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    assert_tree(p_t, p_p, 1e-5, 1e-6, "params")
    count, mu, nu = find_adam_state(opt_p)
    assert int(count) == opt_t.count == n_steps
    assert_tree(opt_t.mu, mu, 1e-5, 1e-7, "mu")
    assert_tree(opt_t.nu, nu, 1e-5, 1e-10, "nu")


@pytest.mark.parametrize("mb", range(SM))
def test_minibatch_grads_twin_at_global_width_matches_pallas(mb):
    params, _, _, data = sgd_setup(3)
    obs_bm, fields = pallas_inputs(data)
    (l_r, aux_r), g_r = ppo_minibatch_grads_pallas(
        params, obs_bm, fields, mb, ENT, KL, num_minibatches=SM,
        clip_eps=CLIP, value_coef=VCOEF, mask_actions=True, obs_dim=SD,
        block_envs=SB // SM, interpret=True)
    p0, traj, adv_n, tgt = port_inputs(params, data)
    (l_t, aux_t), g_t = sgd.ppo_minibatch_grads(
        p0, traj, adv_n, tgt, mb, ENT, KL, num_minibatches=SM,
        clip_eps=CLIP, value_coef=VCOEF, mask_actions=True)
    for a, b in zip((l_t, *aux_t), (l_r, *aux_r)):
        assert abs(float(a) - float(b)) < 1e-6
    assert_tree(g_t, g_r, 1e-4, 1e-7, f"grads mb={mb}")


# ---- (b) the trainer with global observations against the JAX trainer ----------

TCFG = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   mask_actions=True, shaping_coef=0.02,
                   entropy_coef_final=0.001)


@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_global_obs_train_steps_match_jax_trainer(arch):
    """3 updates across an episode boundary, masked and shaped, on the
    small preset with the global view (D = 131; the CNN's grid is the 5 x 5
    map with 5 channels)."""
    cfg = small_config(max_steps=8, global_obs=True)
    jtr = j_make_train(cfg, TCFG.replace(rollout_backend="xla",
                                         grad_backend="xla"), arch=arch)
    tr = make_train(cfg, TCFG, arch=arch, device="cpu")
    assert tr.env_cfg.obs_dim == 131
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    if arch == "cnn":
        assert rs.params["conv.0.weight"].shape == (16, 5, 3, 3)
    else:
        assert rs.params["hidden.0.weight"].shape == (16, 131)
    for u in range(3):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert_bits(jrs.obs, rs.obs, f"update {u} obs")
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    want = tree_np(jrs.params)
    for k, v in want.items():
        np.testing.assert_allclose(rs.params[k].numpy(), v, rtol=2e-4,
                                   atol=5e-5, err_msg=k)


# ---- (c) params_from_flax for the global CNN at S = 9 --------------------------

def test_params_from_flax_global_cnn_on_the_9x9_map():
    cfg = medium_config(global_obs=True)
    jm = j_make_model(cfg, arch="cnn", hidden_dim=32)
    params = jm.init(jax.random.PRNGKey(2), jnp.zeros((1, cfg.obs_dim)))
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    assert sd["conv.0.weight"].shape == (16, 5, 3, 3)
    assert sd["trunk.weight"].shape == (32, 81 * 32 + 6)
    m = make_model(cfg, "cnn", hidden_dim=32, device="cpu")
    m.load_state_dict(sd)
    # Observations of the engine (the grid's 0 / 1 planes) plus noise, so
    # that every trunk column carries weight in the comparison.
    r = np.random.default_rng(5)
    ts, tobs = batch.reset_batch(cfg, env_keys(4, n=8)[1])
    obs = tobs.numpy() + 0.1 * r.normal(size=tobs.shape).astype(np.float32)
    j_logits, j_value = jm.apply(params, jnp.asarray(obs))
    with torch.no_grad():
        logits, value = m(torch.from_numpy(obs))
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_value), rtol=0,
                               atol=1e-5)


# ---- (e) a global-obs checkpoint round-trips ------------------------------------

def test_global_obs_checkpoint_serves_and_evaluates(tmp_path, capsys):
    """The train CLI with ``--global-obs`` writes a checkpoint and its meta
    file; ``Policy.from_checkpoint`` rebuilds the env with the global view
    and acts as the trained params do; ``evaluate --policy checkpoint
    --global-obs`` runs on the directory, and without the flag too: the
    view comes from the meta file; ``checkpoint_policy_fn`` on an env of the
    other view refuses by the flag's name."""
    ckpt = tmp_path / "ckpt"
    train_main(["--cpu", "--env", "shelves", "--global-obs",
                "--mask-actions", "--shaping-coef", "0.02", "--env-config",
                '{"max_steps": 8}', "--num-envs", "8", "--unroll-length",
                "4", "--num-updates", "2", "--num-minibatches", "2",
                "--ppo-epochs", "1", "--hidden-dim", "16",
                "--checkpoint-every", "2", "--checkpoint-dir", str(ckpt),
                "--metrics-path", str(tmp_path / "m.jsonl")])
    meta = json.loads((ckpt / "policy_meta.json").read_text())
    assert meta["env_config"]["global_obs"] is True
    policy = Policy.from_checkpoint(str(ckpt), device="cpu")
    assert policy.env_cfg.global_obs and policy.env_cfg.obs_dim == 611
    assert policy.mask_actions
    params = {k: v for k, v in policy.model.state_dict().items()}
    assert params["hidden.0.weight"].shape == (16, 611)
    _, obs = batch.reset_batch(policy.env_cfg, env_keys(7, n=4)[1])
    acts, _ = policy.compute_actions(obs)
    assert torch.equal(acts, first_argmax(apply(params, obs)[0], -1)
                       .to(torch.int32))
    evaluate_main(["--cpu", "--env", "shelves", "--global-obs",
                   "--env-config", '{"max_steps": 8}', "--policy",
                   "checkpoint", "--checkpoint-dir", str(ckpt), "--episodes",
                   "4"])
    assert "mean_deliveries_per_episode" in capsys.readouterr().out
    evaluate_main(["--cpu", "--env", "shelves", "--env-config",
                   '{"max_steps": 8}', "--policy", "checkpoint",
                   "--checkpoint-dir", str(ckpt), "--episodes", "4"])
    out = capsys.readouterr().out
    assert "global_obs=True" in out and "mean_deliveries_per_episode" in out
    with pytest.raises(ValueError, match="--global-obs"):
        checkpoint_policy_fn(t_shelves_config(max_steps=8), str(ckpt),
                             device="cpu")

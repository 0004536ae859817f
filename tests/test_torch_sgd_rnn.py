"""K8/K9's plain twins and the recurrent PPO trainer against the JAX
package, on the CPU.

The twins (autograd through a Python loop over T of ``apply_rnn`` from the
rollout-start carry, ``ppo_losses``, ``optim.py``) are held against
``ppo_rnn_minibatch_grads_pallas`` and ``ppo_rnn_sgd_phase_pallas`` in
interpret mode on the JAX suite's own inputs (``tests/
test_sgd_rnn_kernel.py`` ``_setup``) at its own tolerances: f32 sums in
another order on both sides. The trainer case carries a JAX
``RunnerStateRNN`` into the port and runs 3 updates on both with
``max_steps = 32`` and T = 16, so the second update ends an episode: the
env AND the carry are reset inside the compared window. Bit-equal env
states, keys and deliveries after every update show that no sampled
action flipped; metrics, params and moments are held to the bounds
``tests/test_torch_train.py`` uses for PPO. Every call to the port passes
``device="cpu"``.
"""

import json

import jax
import numpy as np
import pytest
import torch

import test_sgd_rnn_kernel as jt
from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.pallas.sgd_rnn import (ppo_rnn_minibatch_grads_pallas,
                                          ppo_rnn_sgd_phase_pallas)
from warehouse_tpu.train.ppo_rnn import make_train_rnn as j_make_train_rnn
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.parallel.distributed import process_group
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels.sgd_rnn import (
    ppo_rnn_minibatch_grads, ppo_rnn_minibatch_grads_reference,
    ppo_rnn_sgd_phase, ppo_rnn_sgd_phase_reference)
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.optim import opt_state_from_optax
from warehouse_tpu_torch.train import (Transition, make_train_rnn,
                                       runner_state_rnn_from_jax)
from warehouse_tpu_torch.train.__main__ import main as cli_main
from warehouse_tpu_torch.train.ppo_rnn import rollout_problems_rnn

from test_torch_rng import assert_bits, to_torch

CASES = [("gru", True, 1), ("gru", False, 2), ("lstm", False, 1),
         ("lstm", True, 2), ("gru", False, 1), ("gru", False, 4)]
KW = dict(num_minibatches=jt.M, clip_eps=jt.CLIP, value_coef=jt.VCOEF)


def port_inputs(params, opt_state, data, h0):
    """The JAX suite's inputs as the port's: params dict, Adam state,
    trajectory, normalized advantages, targets, carry."""
    obs, action, old_lp, old_v, adv_n, tgt, mask, done = (
        to_torch(x) for x in data)
    traj = Transition(obs, action, old_lp, old_v, torch.zeros_like(old_v),
                      done, mask, torch.zeros_like(old_v))
    carry = (tuple(to_torch(x) for x in h0) if isinstance(h0, tuple)
             else to_torch(h0))
    return (params_from_flax(jax.tree.map(np.asarray, params)),
            opt_state_from_optax(jax.tree.map(np.asarray, opt_state)),
            traj, adv_n, tgt, carry)


def assert_tree(port, jax_tree, rtol, atol, what):
    want = params_from_flax(jax.tree.map(np.asarray, jax_tree))
    assert port.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("cell,mask_on,n_enc", CASES)
def test_rnn_minibatch_grads_twin_matches_pallas(cell, mask_on, n_enc):
    """K9's twin vs the TPU kernel in interpret mode, every minibatch:
    losses within 1e-6, grads rtol 1e-4 / atol 1e-6
    (tests/test_sgd_rnn_kernel.py:237-244)."""
    (_, params, _, _, opt_state, data, h0) = jt._setup(mask_on, n_enc,
                                                       seed=3, cell=cell)
    obs_bm, fields, h0_rows = jt._kernel_inputs(data, h0)
    p, _, traj, adv_n, tgt, carry = port_inputs(params, opt_state, data, h0)
    for mb in range(jt.M):
        (l_k, aux_k), g_k = ppo_rnn_minibatch_grads_pallas(
            params, obs_bm, fields, h0_rows, mb, jt.ENT, jt.KL,
            unroll_length=jt.T, num_agents=jt.A, mask_actions=mask_on,
            obs_dim=jt.D, block_envs=8, interpret=True, **KW)
        (l_t, aux_t), g_t = ppo_rnn_minibatch_grads(
            p, traj, adv_n, tgt, carry, mb, jt.ENT, jt.KL,
            mask_actions=mask_on, **KW)
        assert abs(float(l_t) - float(l_k)) < 1e-6
        for a, b in zip(aux_t, aux_k):
            assert abs(float(a) - float(b)) < 1e-6
        assert_tree(g_t, g_k, 1e-4, 1e-6, f"grads mb={mb}")
    # On CPU tensors the wrapper is its twin.
    (l_r, _), g_r = ppo_rnn_minibatch_grads_reference(
        p, traj, adv_n, tgt, carry, jt.M - 1, jt.ENT, jt.KL,
        mask_actions=mask_on, **KW)
    assert float(l_r) == float(l_t)
    assert all(torch.equal(g_r[k], g_t[k]) for k in g_t)


@pytest.mark.parametrize("cell,mask_on,n_enc", CASES)
def test_rnn_sgd_phase_twin_matches_pallas(cell, mask_on, n_enc):
    """K8's twin vs the TPU kernel in interpret mode over E x M = 4 steps,
    at the tolerances of tests/test_sgd_rnn_kernel.py:195-207."""
    (_, params, _, sched, opt_state, data, h0) = jt._setup(mask_on, n_enc,
                                                           cell=cell)
    obs_bm, fields, h0_rows = jt._kernel_inputs(data, h0)
    n_steps = jt.E * jt.M
    count0, _, _ = find_adam_state(opt_state)
    steps = count0 + jax.numpy.arange(n_steps)
    lr_row = jax.vmap(sched)(steps).astype(jax.numpy.float32)
    cnt = (steps + 1).astype(jax.numpy.float32)
    rows = (lr_row, 1.0 - 0.9 ** cnt, 1.0 - 0.999 ** cnt)
    p_k, opt_k, losses_k = ppo_rnn_sgd_phase_pallas(
        params, opt_state, obs_bm, fields, h0_rows, *rows, jt.ENT, jt.KL,
        num_epochs=jt.E, unroll_length=jt.T, num_agents=jt.A,
        max_grad_norm=jt.MAXNORM, mask_actions=mask_on, obs_dim=jt.D,
        block_envs=8, interpret=True, **KW)

    p, opt, traj, adv_n, tgt, carry = port_inputs(params, opt_state, data, h0)
    args = (p, opt, traj, adv_n, tgt, carry, *(to_torch(r) for r in rows),
            jt.ENT, jt.KL)
    kw = dict(num_epochs=jt.E, max_grad_norm=jt.MAXNORM,
              mask_actions=mask_on, **KW)
    p_t, opt_t, losses_t = ppo_rnn_sgd_phase(*args, **kw)
    for a, b in zip(losses_t, losses_k):
        assert a.shape == (jt.E, jt.M)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    assert_tree(p_t, p_k, 1e-5, 1e-6, "params")
    count_k, mu_k, nu_k = find_adam_state(opt_k)
    assert opt_t.count == int(count_k) == n_steps
    assert_tree(opt_t.mu, mu_k, 1e-5, 1e-7, "mu")
    assert_tree(opt_t.nu, nu_k, 1e-5, 1e-10, "nu")
    p_r, _, losses_r = ppo_rnn_sgd_phase_reference(*args, **kw)
    assert all(torch.equal(p_r[k], p_t[k]) for k in p_t)
    assert all(torch.equal(a, b) for a, b in zip(losses_r, losses_t))


# ---- the trainer -----------------------------------------------------------------

CFG = small_config(max_steps=32)
BASE = TrainConfig(num_envs=8, unroll_length=16, num_updates=4, ppo_epochs=2,
                   num_minibatches=2, hidden_dim=16, kl_coeff=0.1,
                   entropy_coef_final=0.001)
FUSED = dict(rollout_backend="pallas", grad_backend="pallas",
             pallas_interpret=True, pallas_block=8, sgd_rnn_block_envs=4)


def leaves(carry):
    return carry if isinstance(carry, tuple) else (carry,)


@pytest.mark.parametrize("arch,masked", [("gru", False), ("lstm", False),
                                         ("gru", True)])
def test_rnn_train_steps_match_jax_trainer(arch, masked):
    tcfg = BASE.replace(mask_actions=masked)
    jtr = j_make_train_rnn(CFG, tcfg.replace(**FUSED), arch=arch)
    tr = make_train_rnn(CFG, tcfg, arch=arch, device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(1))
    rs = runner_state_rnn_from_jax(jax.tree.map(np.asarray, jrs))
    assert rs.key.shape == (2,) and rs.opt_state.count == 0
    assert len(leaves(rs.carry)) == (2 if arch == "lstm" else 1)
    reset_seen = False
    for u in range(3):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert_bits(jrs.obs, rs.obs, f"update {u} obs")
        for a, b in zip(leaves(rs.carry), leaves(jrs.carry)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5, err_msg=f"update {u} carry")
        # Episodes end with update 2 (32 steps): env and carry restart.
        zeroed = all(not bool(x.any()) for x in leaves(rs.carry))
        assert zeroed == (u == 1) == bool((rs.env_state.t == 0).all())
        reset_seen |= zeroed
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
        assert float(m["deliveries_per_env_step"]) == float(
            jm["deliveries_per_env_step"])
    assert reset_seen
    assert int(rs.update_idx) == int(jrs.update_idx) == 3
    assert rs.opt_state.count == 3 * BASE.ppo_epochs * BASE.num_minibatches
    assert_tree(rs.params, jrs.params, 2e-4, 5e-5, "params")
    _, mu, nu = find_adam_state(jrs.opt_state)
    assert_tree(rs.opt_state.mu, mu, 2e-4, 5e-6, "mu")
    assert_tree(rs.opt_state.nu, nu, 2e-4, 5e-9, "nu")


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_rnn_init_matches_jax_init(arch):
    """Env resets, the shard key and the zero carry as the JAX trainer's;
    the params come from a torch.Generator (not flax's bits)."""
    jrs = j_make_train_rnn(CFG, BASE, arch=arch).init(jax.random.PRNGKey(3))
    tr = make_train_rnn(CFG, BASE, arch=arch, device="cpu")
    rs = tr.init(rng.prng_key(3))
    for f in STATE_FIELDS:
        assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f), f)
    assert_bits(jrs.obs, rs.obs, "obs")
    assert torch.equal(rs.key, to_torch(jrs.key).reshape(2))
    for a, b in zip(leaves(rs.carry), leaves(jrs.carry)):
        assert_bits(b, a, "carry")
    assert rs.params.keys() == tr.model.state_dict().keys()
    again = tr.init(rng.prng_key(3))
    assert all(torch.equal(rs.params[k], again.params[k]) for k in rs.params)


def test_rnn_train_many_runs_and_plain_step_is_the_cpu_path():
    tr = make_train_rnn(CFG, BASE, arch="gru", device="cpu")
    rs0 = tr.init(rng.prng_key(1))
    rs, ms = tr.train_many(rs0, 2)
    assert int(rs.update_idx) == 2
    assert all(v.shape == (2,) and bool(torch.isfinite(v).all())
               for v in ms.values())
    assert any(not torch.equal(rs.params[k], rs0.params[k])
               for k in rs.params)
    a, ma = tr.train_step(rs0)
    b, mb = tr.plain_step(rs0)
    assert torch.equal(a.env_state.agent_pos, b.env_state.agent_pos)
    assert torch.equal(a.carry, b.carry)
    assert float(ma["loss"]) == float(mb["loss"])


# Each case keeps the id it had while it was refused: shaping, global
# observations, the truncation bootstrap and an unroll length that does not
# divide max_steps are built now, acting per step; a mesh (a world-1 gloo
# group) takes the meshed route.
@pytest.mark.parametrize("change, error", [
    pytest.param(dict(mesh=True), None, id="change0-NotImplementedError"),
    pytest.param(dict(shaping_coef=0.1), None,
                 id="change1-NotImplementedError"),
    pytest.param(dict(global_obs=True), None,
                 id="change2-NotImplementedError"),
    pytest.param(dict(bootstrap_truncated=True), None,
                 id="change3-NotImplementedError"),
    (dict(epoch_shuffle="each"), None),  # ported: the learner runs plain
    (dict(flat_optimizer=True), None),  # ported: the learner runs plain
    (dict(micro_batches=2), None),  # accepted and ignored, as in JAX
    (dict(model_dtype="bfloat16"), None),  # ported: the trainer is built
    (dict(rollout_backend="xla"), ValueError),
    (dict(grad_backend="xla"), ValueError),
    (dict(num_envs=9), ValueError),
    pytest.param(dict(unroll_length=12), None,   # 32 % 12 != 0
                 id="change11-ValueError"),
    (dict(arch="mlp"), ValueError),
])
def test_rnn_gates_raise(change, error, tmp_path):
    change = dict(change)
    kw = {k: change.pop(k) for k in ("arch", "mesh") if k in change}
    cfg = CFG.replace(global_obs=change.pop("global_obs", False))
    if kw.pop("mesh", False):
        # A world-1 data mesh: the meshed route runs (K9's gradient
        # averaged over one rank, then the step).
        with process_group(tmp_path / "store") as mesh:
            tr = make_train_rnn(cfg, BASE.replace(**change), device="cpu",
                                mesh=mesh, **kw)
            assert tr.mesh is mesh
            assert tr.backends == {"rollout": "plain", "grad": "plain"}
            rs, m = tr.train_step(tr.init_global(rng.prng_key(0)))
            assert int(rs.update_idx) == 1 and all(
                bool(torch.isfinite(v)) for v in m.values())
        return
    if error is None:
        tcfg = BASE.replace(**change)
        tr = make_train_rnn(cfg, tcfg, device="cpu", **kw)
        want = (torch.bfloat16 if change.get("model_dtype") == "bfloat16"
                else torch.float32)
        rs = tr.init(rng.prng_key(0))
        assert rs.carry.dtype == want
        if rollout_problems_rnn(cfg, tcfg):
            # Acting per step; one update runs.
            assert tr.backends == {"rollout": "step", "grad": "plain"}
            rs, m = tr.train_step(rs)
            assert int(rs.update_idx) == 1 and all(
                bool(torch.isfinite(v)) for v in m.values())
            return
        assert tr.backends == {"rollout": "plain", "grad": "plain"}
        return
    with pytest.raises(error) as e:
        make_train_rnn(cfg, BASE.replace(**change), device="cpu", **kw)
    if error is NotImplementedError:
        assert "ROADMAP" in str(e.value)


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_rnn_cli_runs_two_updates(arch, tmp_path):
    path = tmp_path / "metrics.jsonl"
    cli_main(["--arch", arch, "--env", "small", "--env-config",
              '{"max_steps": 8}', "--num-envs", "8", "--unroll-length", "4",
              "--num-updates", "2", "--num-minibatches", "2", "--ppo-epochs",
              "2", "--hidden-dim", "16", "--log-every", "1", "--eval-every",
              "2", "--eval-episodes", "4", "--cpu", "--metrics-path",
              str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["meta"] and recs[0]["arch"] == arch
    assert recs[0]["device"] == "cpu" and recs[0]["kernels"] is False
    steps = [r for r in recs[1:] if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert any("eval_mean_episode_return" in r for r in recs)


def test_rnn_cli_refuses_impala_with_a_recurrent_policy(tmp_path):
    with pytest.raises(SystemExit) as e:
        cli_main(["--algo", "impala", "--arch", "gru", "--cpu",
                  "--metrics-path", str(tmp_path / "m.jsonl")])
    assert e.value.code not in (0, None)

"""The kernels' twins at the widths and depths that the JAX package's
Pallas kernels compute and the port's CUDA kernels took last (ROADMAP
T-6), against the JAX package on the CPU.

A hidden width of 50 (no multiple of 4) for the recurrent kernels K7-K9
(cell and encoder) and the CNN kernels K10-K12 (trunk); 5 hidden layers
for the MLP kernels K2-K6; 4 encoder layers (``num_layers=5``) for K7-K9.
Each twin is held against the Pallas kernel in interpret mode on the JAX
suite's own inputs (its ``_setup`` at these widths), at the tolerances of
the port's test file that runs the same kernel at its preset widths
(``test_torch_sgd.py``, ``test_torch_sgd_rnn.py``, ``test_torch_impala.py``,
``test_torch_cnn.py``, ``test_torch_act.py``, ``test_torch_rnn.py``,
``test_torch_bf16.py``); the plain stage twins, which ``chip_smoke.py``
holds the CUDA stages against, are held against their composed twins; one
update of each trainer at these shapes against the JAX trainer's from the
same state; and the weights carried across (``params_from_flax``,
``opt_state_from_optax``). Inputs are made with numpy from a seed. Every
call to the port passes CPU tensors (its plain twins).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_grad_kernel as tg
import test_impala_kernel as ti
import test_sgd_cnn_kernel as tc
import test_sgd_rnn_kernel as jt
from warehouse_tpu import rng as jrng
from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.models.policy import ActorCriticMLP
from warehouse_tpu.pallas.act import ppo_rnn_rollout_pallas, ppo_rollout_pallas
from warehouse_tpu.pallas.sgd import (find_adam_state,
                                      ppo_minibatch_grads_pallas,
                                      ppo_sgd_phase_pallas)
from warehouse_tpu.pallas.sgd_cnn import (ppo_cnn_minibatch_grads_pallas,
                                          ppo_cnn_sgd_phase_pallas)
from warehouse_tpu.pallas.sgd_rnn import (ppo_rnn_minibatch_grads_pallas,
                                          ppo_rnn_sgd_phase_pallas)
from warehouse_tpu.pallas.vtrace_sgd import (find_rms_state,
                                             impala_minibatch_grads_pallas,
                                             impala_sgd_phase_pallas)
from warehouse_tpu.train.impala import make_train_impala as j_make_impala
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu.train.ppo_rnn import make_train_rnn as j_make_train_rnn
import warehouse_tpu_torch as wt
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import (act, act_rnn, sgd, sgd_cnn, sgd_rnn,
                                         vtrace_sgd)
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.optim import (ClipAdam, linear_schedule,
                                       opt_state_from_optax)
from warehouse_tpu_torch.train import (impala_runner_state_from_jax,
                                       make_train, make_train_impala,
                                       make_train_rnn, runner_state_from_jax,
                                       runner_state_rnn_from_jax)

import test_torch_act_cnn_stages as tacs
import test_torch_act_mlp_stages as tams
import test_torch_act_rnn_stages as tars
import test_torch_cnn_stages as tcs
import test_torch_rnn_stages as trs
import test_torch_sgd_stages as tss
import test_torch_vtrace_stages as tvs
from test_torch_env import env_keys
from test_torch_impala import LOSS_KW
from test_torch_impala import port_inputs as impala_port_inputs
from test_torch_rng import assert_bits, to_torch
from test_torch_sgd import port_inputs as mlp_port_inputs
from test_torch_sgd_rnn import port_inputs as rnn_port_inputs

W50 = 50     # a hidden width no multiple of 4
DEEP = 5     # hidden layers of the MLP; the recurrent num_layers (4 encoder
#              layers, make_model's max(num_layers - 1, 1))


def tree_np(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def assert_tree(port: dict, jax_tree, rtol, atol, what=""):
    want = tree_np(jax_tree)
    assert port.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


def deep_mlp(num_actions, hidden_dims):
    """The JAX suites' ``ActorCriticMLP`` at DEEP hidden layers of their
    width."""
    return ActorCriticMLP(num_actions=num_actions,
                          hidden_dims=(hidden_dims[0],) * DEEP)


def adam_rows(sched, opt_state, n_steps):
    count0, _, _ = find_adam_state(opt_state)
    steps = count0 + jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    return (jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
            1.0 - 0.999 ** cnt)


# ---- K8 / K9 at hidden 50, float32 and bf16 ----------------------------------

# The LSTM's bf16 products at hidden 50 are held in norm, ||twin - Pallas||
# <= rel ||Pallas|| + atol sqrt(n), as chip_smoke.py and
# test_torch_kernels_gpu.py hold bf16 kernels: a float32 value one ulp off
# between two implementations can round to the neighbouring bf16 operand.
# Read by tools/torch_bf16_lstm_witness.py on this file's inputs (seeds
# 0-5, minibatches of 64 samples): the twin's gradient lies up to 3.2 x
# 2e-4 from the Pallas kernel's in relative norm; on seed 3's minibatch 0
# (1.7 x 2e-4) the Pallas kernel agrees with the bf16 twin summing in
# float64 (0.0013 x 2e-4), on seed 5's (3.2 x 2e-4) the float32-summing
# twin does (0.0005 x 2e-4): neither side is the odd one. Moving the params
# by one float32 ulp moves the twin's own gradient by 0.004 to 8.1 x 2e-4
# (12 moves on each seed and minibatch). So a minibatch's gradient is held
# at test_torch_kernels_gpu.py's GRAD_REL for small minibatches (2e-3), the
# phase's params, moments and losses at chip_smoke.py's BF16_PHASE_REL
# with the float32 tolerances' atol (the twin at most 0.26 of it), and the
# float32 twin lies beyond both.
LSTM_BF16_GRAD_REL, LSTM_BF16_PHASE_REL = 2e-3, 3e-3
PHASE_ATOL = dict(params=1e-6, mu=1e-7, nu=1e-10)


def norm_ratio(port: dict, jax_tree, rel, atol=0.0) -> float:
    """The largest ||port - jax|| / (rel ||jax|| + atol sqrt(n)) over the
    tensors of a tree."""
    want = tree_np(jax_tree)
    return max(float(np.linalg.norm(port[k].double().numpy() - want[k])
                     / (rel * np.linalg.norm(want[k].astype(np.float64))
                        + atol * want[k].size ** 0.5)) for k in want)


@pytest.mark.parametrize("cell,dtype", [("lstm", "float32"),
                                        ("gru", "bfloat16"),
                                        ("lstm", "bfloat16")])
def test_rnn_learner_twins_match_pallas_at_width_50(cell, dtype,
                                                    monkeypatch):
    """K9's twin on every minibatch and K8's over E x M steps against the
    TPU kernels in interpret mode at hidden (and encoder) width 50: float32
    at the bounds of test_torch_sgd_rnn.py, the GRU's bf16 products at
    those of test_torch_bf16.py, the LSTM's in norm (above). (4 encoder
    layers: test_torch_sgd_rnn.py's cases.)"""
    monkeypatch.setattr(jt, "H", W50)
    (_, params, _, sched, opt_state, data, h0) = jt._setup(True, 1, seed=3,
                                                           cell=cell)
    obs_bm, fields, h0_rows = jt._kernel_inputs(data, h0)
    p, opt, traj, adv_n, tgt, carry = rnn_port_inputs(params, opt_state,
                                                      data, h0)
    assert p["cell.hn.weight" if cell == "gru" else "cell.ho.weight"].shape \
        == (W50, W50)
    kw = dict(num_minibatches=jt.M, clip_eps=jt.CLIP, value_coef=jt.VCOEF,
              mask_actions=True)
    bf16 = dtype == "bfloat16"
    in_norm = bf16 and cell == "lstm"
    # test_torch_bf16.py's bounds for bf16 products (PHASE_TOL: an operand
    # one float32 ulp off rounds to the neighbouring bf16 value), else
    # test_torch_sgd_rnn.py's.
    g_tol = (1e-4, 1e-7) if bf16 else (1e-4, 1e-6)
    tol = (dict(params=(1e-5, 5e-6), mu=(1e-5, 1e-6), nu=(1e-5, 1e-9))
           if bf16 else dict(params=(1e-5, 1e-6), mu=(1e-5, 1e-7),
                             nu=(1e-5, 1e-10)))
    for mb in range(jt.M):
        (l_k, aux_k), g_k = ppo_rnn_minibatch_grads_pallas(
            params, obs_bm, fields, h0_rows, mb, jt.ENT, jt.KL,
            unroll_length=jt.T, num_agents=jt.A, obs_dim=jt.D, block_envs=8,
            interpret=True, matmul_dtype=dtype, **kw)
        (l_t, aux_t), g_t = sgd_rnn.ppo_rnn_minibatch_grads(
            p, traj, adv_n, tgt, carry, mb, jt.ENT, jt.KL, matmul_dtype=dtype,
            **kw)
        for a, b in zip((l_t, *aux_t), (l_k, *aux_k)):
            assert abs(float(a) - float(b)) < 1e-6
        if not in_norm:
            assert_tree(g_t, g_k, *g_tol, f"grads mb={mb}")
            continue
        assert norm_ratio(g_t, g_k, LSTM_BF16_GRAD_REL) <= 1.0, mb
        (_, _), g_f = sgd_rnn.ppo_rnn_minibatch_grads(
            p, traj, adv_n, tgt, carry, mb, jt.ENT, jt.KL, **kw)
        assert norm_ratio(g_f, g_k, LSTM_BF16_GRAD_REL) > 1.0, mb
    rows = adam_rows(sched, opt_state, jt.E * jt.M)
    p_k, opt_k, losses_k = ppo_rnn_sgd_phase_pallas(
        params, opt_state, obs_bm, fields, h0_rows, *rows, jt.ENT, jt.KL,
        num_epochs=jt.E, unroll_length=jt.T, num_agents=jt.A,
        max_grad_norm=jt.MAXNORM, obs_dim=jt.D, block_envs=8,
        interpret=True, matmul_dtype=dtype, **kw)

    def port_phase(**dt):
        return sgd_rnn.ppo_rnn_sgd_phase(
            p, opt, traj, adv_n, tgt, carry, *(to_torch(r) for r in rows),
            jt.ENT, jt.KL, num_epochs=jt.E, max_grad_norm=jt.MAXNORM,
            **dt, **kw)
    p_t, opt_t, losses_t = port_phase(matmul_dtype=dtype)
    _, mu_k, nu_k = find_adam_state(opt_k)
    if not in_norm:
        for a, b in zip(losses_t, losses_k):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=2e-6)
        assert_tree(p_t, p_k, *tol["params"], "params")
        assert_tree(opt_t.mu, mu_k, *tol["mu"], "mu")
        assert_tree(opt_t.nu, nu_k, *tol["nu"], "nu")
        return

    def phase_ratios(pp, oo, ll):
        lt = torch.stack(tuple(ll)).double().numpy()
        lk = np.stack([np.asarray(x, np.float64) for x in losses_k])
        return [norm_ratio(t, k, LSTM_BF16_PHASE_REL, PHASE_ATOL[q])
                for q, t, k in (("params", pp, p_k), ("mu", oo.mu, mu_k),
                                ("nu", oo.nu, nu_k))] + [
            float(np.linalg.norm(lt - lk) / (LSTM_BF16_PHASE_REL
                                             * np.linalg.norm(lk)
                                             + 2e-6 * lk.size ** 0.5))]
    assert max(phase_ratios(p_t, opt_t, losses_t)) <= 1.0
    assert max(phase_ratios(*port_phase())) > 1.0


# ---- K7 at hidden 50 and at 4 encoder layers -------------------------------

ACT_B, ACT_T = 32, 4
ACT_CFG = small_config(max_steps=ACT_T)


@pytest.mark.parametrize("arch,num_layers", [("gru", 2), ("lstm", DEEP)],
                         ids=["gru-h50", "lstm-h50-enc4"])
def test_rnn_act_twin_matches_pallas(arch, num_layers):
    """K7's twin against ``ppo_rnn_rollout_pallas`` in interpret mode with
    the same gumbel stream: obs, actions, rewards and the env state
    bit-equal, values, log-probs and the carry within 1e-5
    (test_torch_rnn.py). Hidden and encoder width 50; the LSTM with 4
    encoder layers."""
    hidden = W50
    jm = j_make_model(ACT_CFG, arch=arch, hidden_dim=hidden,
                      num_layers=num_layers)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, ACT_CFG.obs_dim)),
                     jm.initial_carry((1,)))
    m = make_model(ACT_CFG, arch, hidden, num_layers, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    jk, tk = env_keys(0, n=ACT_B)
    js, _ = jbatch.reset_batch(ACT_CFG, jk)
    ts, _ = batch.reset_batch(ACT_CFG, tk)
    A = ACT_CFG.num_agents
    r = np.random.default_rng(3)
    leaves = [0.5 * r.standard_normal((ACT_B, A, hidden)).astype(np.float32)
              for _ in range(2 if arch == "lstm" else 1)]
    jc = tuple(jnp.asarray(x) for x in leaves)
    tcar = tuple(torch.from_numpy(x.copy()) for x in leaves)
    jc, tcar = (jc, tcar) if arch == "lstm" else (jc[0], tcar[0])
    j_new, j_roll, _, _, j_carry = ppo_rnn_rollout_pallas(
        ACT_CFG, params, js, jc, ACT_T, jax.random.PRNGKey(7), ACT_B, True,
        False, arch)
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, ACT_CFG, ACT_T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), ACT_T,
                                      (5, ACT_B * A))
    new, carry, obs, action, lp, value, reward, delivered = \
        act_rnn.act_rnn_steps(ACT_CFG, dict(m.named_parameters()), ts, tcar,
                              u, pick, drop, to_torch(g))
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    pairs = [(value, j_roll.value), (lp, j_roll.log_prob)] + list(zip(
        carry if arch == "lstm" else (carry,),
        j_carry if arch == "lstm" else (j_carry,)))
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


# ---- K2 at 5 hidden layers, K10 at trunk width 50 ---------------------------

@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_act_twin_matches_pallas(arch):
    """K2's twin at 5 hidden layers and K10's at trunk width 50 against
    ``ppo_rollout_pallas`` in interpret mode with the same gumbel stream:
    obs, actions, rewards and the env state bit-equal, values within 1e-5
    and log-probs within 1e-4 (K2, test_torch_act.py) or 1e-5 (K10,
    test_torch_cnn.py)."""
    hidden, layers = (32, DEEP) if arch == "mlp" else (W50, 2)
    jm = j_make_model(ACT_CFG, arch=arch, hidden_dim=hidden,
                      num_layers=layers)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, ACT_CFG.obs_dim)))
    m = make_model(ACT_CFG, arch, hidden, layers, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    jk, tk = env_keys(3, n=ACT_B)
    js, _ = jbatch.reset_batch(ACT_CFG, jk)
    ts, _ = batch.reset_batch(ACT_CFG, tk)
    j_new, j_roll, _, _ = ppo_rollout_pallas(
        ACT_CFG, params, js, ACT_T, jax.random.PRNGKey(7), block=ACT_B,
        interpret=True, arch=arch)
    A = ACT_CFG.num_agents
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, ACT_CFG, ACT_T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), ACT_T,
                                      (5, ACT_B * A))
    steps = act.act_cnn_steps if arch == "cnn" else act.act_steps
    new, obs, action, lp, value, reward, delivered = steps(
        ACT_CFG, m, ts, u, pick, drop, to_torch(g))
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-4 if arch == "mlp" else 1e-5)


# ---- K11 / K12 at trunk width 50 --------------------------------------------

def test_cnn_learner_twins_match_pallas_at_width_50(monkeypatch):
    """K12's twin on the first minibatch and K11's over E x M steps
    against the TPU kernels in interpret mode at trunk width 50, at the
    bounds of test_torch_cnn.py."""
    monkeypatch.setattr(tc, "H", W50)
    tcfg = tc.TCFG.replace(hidden_dim=W50)
    _, params, _, sched, opt_state, data = tc._setup(True, seed=3)
    obs_bm, fields = tc._kernel_inputs(data)
    p0, traj, adv_n, tgt = mlp_port_inputs(params, None, data)
    assert p0["trunk.weight"].shape[0] == W50
    kw = dict(num_minibatches=tc.M, clip_eps=tc.CLIP, value_coef=tc.VCOEF,
              mask_actions=True)
    for mb in range(1):
        (l_k, aux_k), g_k = ppo_cnn_minibatch_grads_pallas(
            params, obs_bm, fields, mb, tc.ENT, tc.KL, env_cfg=tc.CFG,
            tcfg=tcfg, obs_dim=tc.D, block_envs=8, interpret=True, **kw)
        (l_t, aux_t), g_t = sgd_cnn.ppo_cnn_minibatch_grads(
            p0, traj, adv_n, tgt, mb, tc.ENT, tc.KL, **kw)
        for a, b in zip((l_t, *aux_t), (l_k, *aux_k)):
            assert abs(float(a) - float(b)) < 1e-6
        assert_tree(g_t, g_k, 1e-4, 1e-6, f"grads mb={mb}")
    rows = adam_rows(sched, opt_state, tc.E * tc.M)
    p_k, opt_k, l_k = ppo_cnn_sgd_phase_pallas(
        params, opt_state, obs_bm, fields, *rows, tc.ENT, tc.KL,
        env_cfg=tc.CFG, tcfg=tcfg, num_epochs=tc.E,
        max_grad_norm=tc.MAXNORM, obs_dim=tc.D, block_envs=8,
        interpret=True, **kw)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    p_t, opt_t, l_t = sgd_cnn.ppo_cnn_sgd_phase(
        p0, opt0, traj, adv_n, tgt, *(to_torch(r) for r in rows), tc.ENT,
        tc.KL, num_epochs=tc.E, max_grad_norm=tc.MAXNORM, **kw)
    for a, b in zip(l_t, l_k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    assert_tree(p_t, p_k, 1e-5, 1e-6, "params")
    _, mu_k, nu_k = find_adam_state(opt_k)
    assert_tree(opt_t.mu, mu_k, 1e-5, 1e-7, "mu")
    assert_tree(opt_t.nu, nu_k, 1e-5, 1e-10, "nu")


# ---- K3 / K4 and K5 / K6 at 5 hidden layers ----------------------------------

def test_mlp_learner_twins_match_pallas_at_5_layers(monkeypatch):
    """K4's twin on every minibatch and K3's over E x M steps against the
    TPU kernels in interpret mode at 5 hidden layers, at the bounds of
    test_torch_sgd.py."""
    monkeypatch.setattr(tg, "ActorCriticMLP", deep_mlp)
    _, params, _, sched, opt_state, data = tg._setup(True, seed=3)
    obs_bm, fields = tg._kernel_inputs(data)
    p0, traj, adv_n, tgt = mlp_port_inputs(params, None, data)
    assert sum(k.endswith(".weight") and k.startswith("hidden")
               for k in p0) == DEEP
    kw = dict(num_minibatches=tg.M, clip_eps=tg.CLIP, value_coef=tg.VCOEF,
              mask_actions=True)
    for mb in range(tg.M):
        (l_k, aux_k), g_k = ppo_minibatch_grads_pallas(
            params, obs_bm, fields, mb, tg.ENT, tg.KL, obs_dim=tg.D,
            block_envs=8, interpret=True, **kw)
        (l_t, aux_t), g_t = sgd.ppo_minibatch_grads(
            p0, traj, adv_n, tgt, mb, tg.ENT, tg.KL, **kw)
        for a, b in zip((l_t, *aux_t), (l_k, *aux_k)):
            assert abs(float(a) - float(b)) < 1e-6
        assert_tree(g_t, g_k, 1e-4, 1e-7, f"grads mb={mb}")
    n_steps = tg.E * tg.M
    rows = adam_rows(sched, opt_state, n_steps)
    p_k, opt_k, l_k = ppo_sgd_phase_pallas(
        params, opt_state, obs_bm, fields, *rows, tg.ENT, tg.KL,
        num_epochs=tg.E, max_grad_norm=tg.MAXNORM, obs_dim=tg.D,
        block_envs=8, rows_per_block=4, interpret=True, **kw)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    p_t, opt_t, l_t = sgd.ppo_sgd_phase(
        p0, opt0, traj, adv_n, tgt, *(to_torch(r) for r in rows), tg.ENT,
        tg.KL, num_epochs=tg.E, max_grad_norm=tg.MAXNORM, **kw)
    for a, b in zip(l_t, l_k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    assert_tree(p_t, p_k, 1e-5, 1e-6, "params")
    _, mu_k, nu_k = find_adam_state(opt_k)
    assert_tree(opt_t.mu, mu_k, 1e-5, 1e-7, "mu")
    assert_tree(opt_t.nu, nu_k, 1e-5, 1e-10, "nu")


@pytest.mark.parametrize("use_rms", [True, False], ids=["rmsprop", "adam"])
def test_impala_learner_twins_match_pallas_at_5_layers(use_rms, monkeypatch):
    """K6's twin on every minibatch and K5's over its passes x M steps
    (RMSProp and Adam) against the TPU kernels in interpret mode at 5
    hidden layers, at the bounds of test_torch_impala.py."""
    monkeypatch.setattr(ti, "ActorCriticMLP", deep_mlp)
    (_, params, _, sched, opt_state, data, last_obs) = ti._setup(
        True, use_rms, seed=3)
    obs_bm, fields, lrows = ti._kernel_inputs(data, last_obs)
    p0, traj, lobs = impala_port_inputs(params, data, last_obs)
    kw = dict(mask_actions=True, **LOSS_KW)
    if use_rms:
        for m in range(ti.M):
            (l_k, aux_k), g_k = impala_minibatch_grads_pallas(
                params, obs_bm, fields, lrows, m, ti.ENT,
                num_minibatches=ti.M, unroll_length=ti.T, num_agents=ti.A,
                obs_dim=ti.D, block_envs=8, interpret=True, **kw)
            (l_t, aux_t), g_t = vtrace_sgd.impala_minibatch_grads(
                p0, traj, lobs, m, ti.ENT, num_minibatches=ti.M,
                bootstrap_truncated=False, **kw)
            for a, b in zip((l_t, *aux_t), (l_k, *aux_k)):
                assert abs(float(a) - float(b)) < 1e-6
            assert_tree(g_t, g_k, 1e-4, 1e-6, f"grads mb={m}")
    n_steps = ti.PASSES * ti.M
    steps = jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_k, opt_k, l_k = impala_sgd_phase_pallas(
        params, opt_state, obs_bm, fields, lrows,
        jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
        1.0 - 0.999 ** cnt, ti.ENT, num_passes=ti.PASSES,
        num_minibatches=ti.M, unroll_length=ti.T, num_agents=ti.A,
        max_grad_norm=ti.MAXNORM, obs_dim=ti.D, use_rms=use_rms,
        block_envs=8, eps=0.1 if use_rms else 1e-5, interpret=True, **kw)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    optimizer = (wt.optim.ClipRMSProp if use_rms else ClipAdam)(
        linear_schedule(3e-4, 0.0, 100), ti.MAXNORM)
    rows = optimizer.step_rows(opt0.count, n_steps)
    p_t, opt_t, l_t = vtrace_sgd.impala_sgd_phase(
        p0, opt0, traj, lobs, rows, ti.ENT, num_passes=ti.PASSES,
        num_minibatches=ti.M, max_grad_norm=ti.MAXNORM,
        bootstrap_truncated=False, **kw)
    for a, b in zip(l_t, l_k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    assert_tree(p_t, p_k, 1e-5, 1e-6, "params")
    nu = (find_rms_state(opt_k) if use_rms else find_adam_state(opt_k)[2])
    assert_tree(opt_t.nu, nu, 1e-5, 1e-10, "nu")


# ---- the plain stage twins at these shapes ----------------------------------

def stage_twins(family, monkeypatch):
    """One stage family's plain stages composed against its plain twin, at
    a width of 50 or 5 hidden layers (4 encoder layers), with the checks
    and bounds of the stage family's own test file."""
    if family == "mlp_stage":  # K4's four stages: 5 layers, then width 50
        for n_hidden, H in ((DEEP, 12), (2, W50)):
            params, traj, adv_n, tgt, M = tss.setup(n_hidden, H=H)
            for mb in range(M):
                got, want = tss.staged_and_twin(params, traj, adv_n, tgt, mb,
                                                M, matmul_dtype="float32")
                tss.assert_losses(got[0], want[0])
                tss.assert_grads(got[1], want[1], False, f"mb={mb}")
    elif family == "vtrace_stage":  # K6's five: 5 layers, masked, bootstrap
        params, traj, last_obs = tvs.setup(DEEP, seed=5)
        for mb in range(2):
            got, want = tvs.staged_and_twin(params, traj, last_obs, mb, 2,
                                            mask_actions=True,
                                            bootstrap_truncated=True)
            tvs.assert_losses(got[0], want[0])
            tvs.assert_grads(got[1], want[1], f"mb={mb}")
    elif family == "rnn_stage":  # K9's six: hidden 50, 4 encoder layers
        for cell, n_enc, dtype in (("gru", DEEP - 1, "float32"),
                                   ("lstm", 1, "bfloat16")):
            params, traj, adv_n, tgt, carry, M = trs.setup(cell, n_enc, H=W50)
            kw = dict(num_minibatches=M, matmul_dtype=dtype, **trs.HYPER)
            got = sgd_rnn.rnn_minibatch_grads_staged(
                params, traj, adv_n, tgt, carry, 1, trs.ENT, trs.KL, **kw)
            want = sgd_rnn.ppo_rnn_minibatch_grads_reference(
                params, traj, adv_n, tgt, carry, 1, trs.ENT, trs.KL, **kw)
            trs.assert_losses(got[0], want[0])
            trs.assert_grads(got[1], want[1], dtype == "bfloat16", cell)
    elif family == "cnn_stage":  # K12's five: trunk 50
        monkeypatch.setattr(tcs, "H", W50)
        for dtype in tcs.DTYPES:
            tcs.test_staged_grads_match_twin("S5", dtype)
    elif family == "act_mlp_stage":  # K2's: 5 hidden layers
        name = "small_5_layers"
        monkeypatch.setitem(tams.CASES, name, (
            small_config(max_steps=tams.T), None, 16, DEEP, False, 0, 16))
        tams.test_staged_chunk_matches_twin(name)
    elif family == "act_rnn_stage":  # K7's: hidden 50, 4 encoder layers
        name = "gru_small_h50_enc4"
        monkeypatch.setitem(tars.CASES, name, (
            small_config(max_steps=tars.T), "gru", W50, DEEP, False, 16))
        tars.test_staged_chunk_matches_twin(name)
        tars.test_plain_stages_match_twin_step(name)
    else:  # act_cnn_stage, K10's: trunk 50
        monkeypatch.setattr(tacs, "HIDDEN", W50)
        tacs.test_staged_chunk_matches_twin("small")


@pytest.mark.parametrize("family", [
    "mlp_stage", "vtrace_stage", "rnn_stage", "cnn_stage", "act_mlp_stage",
    "act_rnn_stage", "act_cnn_stage"])
def test_plain_stages_match_composed_twin(family, monkeypatch):
    """The plain stages that ``chip_smoke.py`` holds the CUDA stages
    against, at width 50 and at 5 layers, equal to their composed twin."""
    stage_twins(family, monkeypatch)


# ---- one update of each trainer against the JAX trainer ---------------------

TR_CFG = small_config(max_steps=8)
TR_BASE = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                      num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                      kl_coeff=0.1)


def port_tcfg(tcfg):
    return wt.TrainConfig(**{f: getattr(tcfg, f) for f in (
        "num_envs", "unroll_length", "num_updates", "num_minibatches",
        "ppo_epochs", "hidden_dim", "num_layers", "kl_coeff",
        "impala_rmsprop")})


@pytest.mark.parametrize("algo,arch,change", [
    ("ppo", "mlp", dict(num_layers=DEEP)),
    ("impala", "mlp", dict(num_layers=DEEP, impala_rmsprop=False)),
    ("ppo", "cnn", dict(hidden_dim=W50)),
    ("ppo_rnn", "gru", dict(hidden_dim=W50)),
    ("ppo_rnn", "gru", dict(num_layers=DEEP))],
    ids=["ppo-5-layers", "impala-5-layers", "cnn-h50", "gru-h50",
         "gru-5-layers"])
def test_one_update_matches_jax_trainer(algo, arch, change):
    """One update of the port's trainer (its plain twins on the CPU) from
    the JAX trainer's initial state against the JAX trainer's (its XLA
    route on the CPU): env state, key and obs bit-equal, metrics within
    2e-4 + 1e-3 relative, params within rtol 2e-4 / atol 5e-5 (the bounds
    of test_torch_train.py)."""
    tcfg = TR_BASE.replace(**change)
    if algo == "impala":
        jtr = j_make_impala(TR_CFG, tcfg)
        tr = make_train_impala(wt.small_config(max_steps=8), port_tcfg(tcfg),
                               device="cpu")
        to_port = lambda x: impala_runner_state_from_jax(x, port_tcfg(tcfg))
    elif algo == "ppo_rnn":
        jtr = j_make_train_rnn(TR_CFG, tcfg, arch=arch)
        tr = make_train_rnn(wt.small_config(max_steps=8), port_tcfg(tcfg),
                            arch=arch, device="cpu")
        to_port = runner_state_rnn_from_jax
    else:
        jtr = j_make_train(TR_CFG, tcfg, arch=arch)
        tr = make_train(wt.small_config(max_steps=8), port_tcfg(tcfg),
                        arch=arch, device="cpu")
        to_port = runner_state_from_jax
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = to_port(jax.tree.map(np.asarray, jrs))
    assert rs.params.keys() == tr.model.state_dict().keys()
    jrs, jm = jtr.train_step(jrs)
    rs, m = tr.train_step(rs)
    for f in STATE_FIELDS:
        assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f), f)
    assert_bits(np.asarray(jrs.key).reshape(2), rs.key, "key")
    assert_bits(jrs.obs, rs.obs, "obs")
    assert m.keys() == jm.keys()
    for k in jm:
        a, b = float(m[k]), float(jm[k])
        assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (k, a, b)
    assert_tree(rs.params, jrs.params, 2e-4, 5e-5, "params")


# ---- the weights carried across -------------------------------------------

@pytest.mark.parametrize("arch,hidden,layers", [
    ("mlp", 16, DEEP), ("gru", W50, 2), ("lstm", 16, DEEP), ("cnn", W50, 2)])
def test_params_and_adam_state_carry_across(arch, hidden, layers):
    """A flax model's params at width 50 or 5 layers into the port
    (``params_from_flax``) load into the port's model of those widths and
    give flax's outputs within 1e-5; an optax Adam state after one step
    (``opt_state_from_optax``) gives its moments leaf for leaf."""
    import optax

    jm = j_make_model(TR_CFG, arch=arch, hidden_dim=hidden, num_layers=layers)
    obs = jnp.asarray(np.random.default_rng(0).normal(
        size=(6, TR_CFG.obs_dim)).astype(np.float32))
    rnn = arch in ("gru", "lstm")
    init = (jm.initial_carry((6,)),) if rnn else ()
    params = jm.init(jax.random.PRNGKey(2), obs, *init)
    m = make_model(wt.small_config(max_steps=8), arch, hidden, layers,
                   device="cpu")
    port = params_from_flax(jax.tree.map(np.asarray, params))
    m.load_state_dict(port)
    out_j = jm.apply(params, obs, *init)
    with torch.no_grad():
        out_t = (m(to_torch(obs), m.initial_carry((6,))) if rnn
                 else m(to_torch(obs)))
    for a, b in zip(jax.tree.leaves(out_j), [
            x for y in out_t for x in (y if isinstance(y, tuple) else (y,))]):
        np.testing.assert_allclose(b.numpy().reshape(np.shape(a)),
                                   np.asarray(a), rtol=0, atol=1e-5)
    tx = optax.adam(1e-3)
    opt = tx.init(params)
    _, opt = tx.update(jax.tree.map(jnp.ones_like, params), opt, params)
    got = opt_state_from_optax(jax.tree.map(np.asarray, opt))
    assert got.count == 1
    for port_tree, jax_tree in ((got.mu, opt[0].mu), (got.nu, opt[0].nu)):
        assert port_tree.keys() == port.keys()
        assert_tree(port_tree, jax_tree, 0, 0, "moment")

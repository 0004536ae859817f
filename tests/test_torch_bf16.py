"""``--model-dtype bfloat16`` in the port against the JAX package, on the
CPU: the two bfloat16s of ``models/policy.py`` and what uses them.

- The bf16-operand products (``Bf16Linear``, ``Bf16Conv``) against
  ``jax.grad`` of the same products written in JAX: operands rounded to
  bf16 (straight through), float32 sums, the cotangent rounded before the
  backward products. Autograd through plain casts rounds each gradient
  after its product instead, and differs.
- The learner twins with ``matmul_dtype="bfloat16"`` (K3/K4 with and
  without groups, K8/K9 for the GRU and the LSTM, K11/K12) against the
  Pallas kernels with ``matmul_dtype="bfloat16", interpret=True`` on the
  JAX suite's inputs, at the f32 suite's tolerances: both sides multiply
  the same rounded operands exactly and differ in the order of their
  float32 sums. The f32 twin on the same inputs lies outside them.
- The flax-bf16 forward (``precision="flax_bf16"``) against the flax models
  built with ``dtype=bfloat16``: at most ``FLAX_SHARE`` of the outputs
  differ, by at most ``FLAX_ULPS`` bf16 ulps (measured: 3 of 20480 MLP
  logits and 5 of 10240 CNN logits by 1-2 ulps, all values and every
  GRU / LSTM output and carry equal).
- The bf16 trainers (MLP, GRU, CNN) against the JAX trainer on its fused
  route in interpret mode for 3 updates across an episode boundary;
  serving, ``--resume`` and the CLI at bf16; IMPALA's refusal.

Every call to the port passes ``device="cpu"``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.nn import functional as F

import test_grad_kernel as mg
import test_sgd_cnn_kernel as cg
import test_sgd_rnn_kernel as rg
import test_torch_groups as tg
import test_torch_sgd_rnn as tsr
from warehouse_tpu.config import TrainConfig as JTrainConfig
from warehouse_tpu.config import small_config as j_small_config
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.pallas.sgd import (find_adam_state,
                                      ppo_minibatch_grads_pallas,
                                      ppo_sgd_phase_pallas)
from warehouse_tpu.pallas.sgd_cnn import (ppo_cnn_minibatch_grads_pallas,
                                          ppo_cnn_sgd_phase_pallas)
from warehouse_tpu.pallas.sgd_rnn import (ppo_rnn_minibatch_grads_pallas,
                                          ppo_rnn_sgd_phase_pallas)
from warehouse_tpu.serve import Policy as JPolicy
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu.train.ppo_rnn import make_train_rnn as j_make_train_rnn
import warehouse_tpu_torch as wt
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import sgd, sgd_cnn, sgd_rnn
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.models.policy import (Bf16Conv, Bf16Linear, apply,
                                               apply_rnn)
from warehouse_tpu_torch.optim import (ClipAdam, linear_schedule,
                                       opt_state_from_optax)
from warehouse_tpu_torch.serve import Policy, write_policy_meta
from warehouse_tpu_torch.train import (checkpoint, make_train,
                                       make_train_impala, make_train_rnn,
                                       runner_state_from_jax,
                                       runner_state_rnn_from_jax)
from warehouse_tpu_torch.train.__main__ import main as cli_main

from test_torch_checkpoint import assert_same_state
from test_torch_rng import assert_bits, to_torch
from test_torch_sgd import port_inputs, tree_np

BF = dict(matmul_dtype="bfloat16")


def r16(x):
    return x.astype(jnp.bfloat16).astype(jnp.float32)


# ---- (1a) the bf16-operand products --------------------------------------------

@jax.custom_vjp
def round_cotangent(y):
    return y


round_cotangent.defvjp(lambda y: (y, None),
                       lambda _, g: (r16(g),))


def st_round(x):
    """``x`` rounded to bf16 in the forward, the identity in the
    backward: the kernels' operand rounding, differentiable."""
    return x + jax.lax.stop_gradient(r16(x) - x)


def j_linear(x, w):
    return round_cotangent(jnp.dot(st_round(x), st_round(w).T,
                                   precision=jax.lax.Precision.HIGHEST))


def j_conv(x, w):
    return round_cotangent(jax.lax.conv_general_dilated(
        st_round(x), st_round(w), (1, 1), "SAME",
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        precision=jax.lax.Precision.HIGHEST))


@pytest.mark.parametrize("op", ["linear", "conv"])
def test_bf16_product_grads_match_jax_grad(op):
    """``Bf16Linear`` / ``Bf16Conv``: the forward and both gradients
    within rtol 1e-5 / atol 1e-6 of ``jax.grad`` of the same product (f32
    sums in another order); autograd through ``.bfloat16().float()`` casts
    lies outside that bound."""
    gen = np.random.default_rng(0)
    if op == "linear":
        x, w = gen.normal(size=(64, 48)), gen.normal(size=(40, 48))
        fn, j_fn, plain = Bf16Linear.apply, j_linear, F.linear
    else:
        x, w = gen.normal(size=(8, 5, 7, 7)), gen.normal(size=(16, 5, 3, 3))
        fn, j_fn = Bf16Conv.apply, j_conv

        def plain(a, b):
            return F.conv2d(a, b, padding=1)
    x, w = x.astype(np.float32), w.astype(np.float32)
    g = gen.normal(size=np.asarray(j_fn(x, w)).shape).astype(np.float32)

    y_j, vjp = jax.vjp(j_fn, jnp.asarray(x), jnp.asarray(w))
    want = (y_j, *vjp(jnp.asarray(g)))
    xt, wt_ = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    y = fn(xt, wt_)
    got = (y, *torch.autograd.grad(y, (xt, wt_), torch.from_numpy(g)))
    for a, b, what in zip(got, want, ("y", "dx", "dw")):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6, err_msg=what)
    xc, wc = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    yc = plain(xc.bfloat16().float(), wc.bfloat16().float())
    casts = torch.autograd.grad(yc, (xc, wc), torch.from_numpy(g))
    np.testing.assert_array_equal(yc.detach().numpy(), y.detach().numpy())
    for a, b in zip(casts, want[1:]):
        assert not np.allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                               atol=1e-6)


# ---- (1b) the flax-bf16 forward ---------------------------------------------

FLAX_SHARE, FLAX_ULPS = 1e-3, 2


def bf16_ulps(a, b) -> np.ndarray:
    """|a - b| in bf16 ulps of two arrays of bf16 values."""
    def bits(x):
        return torch.from_numpy(np.array(x, np.float32)).bfloat16().view(
            torch.int16).int()
    return (bits(a) - bits(b)).abs().numpy()


def assert_flax_close(got, want, what):
    u = bf16_ulps(got, want)
    assert (u > 0).mean() <= FLAX_SHARE and u.max() <= FLAX_ULPS, (
        what, int((u > 0).sum()), int(u.max()))


@pytest.mark.parametrize("arch", ["mlp", "cnn", "gru", "lstm"])
def test_bf16_forward_matches_flax(arch):
    """``apply*(precision="flax_bf16")`` against the flax model built with
    ``dtype=bfloat16`` on the same params, 2048 rows; logits and values
    float32 of bf16 values, the recurrent carry out bf16."""
    cfg = j_small_config()
    gen = np.random.default_rng(1)
    N = 2048
    if arch == "cnn":
        obs = (gen.random((N, cfg.obs_dim)) < 0.3).astype(np.float32)
        obs[:, -6:] = gen.random((N, 6))
    else:
        obs = gen.normal(size=(N, cfg.obs_dim)).astype(np.float32)
    jm = j_make_model(cfg, arch, hidden_dim=64, dtype=jnp.bfloat16)
    recurrent = arch in ("gru", "lstm")
    if recurrent:
        c = [jnp.asarray(0.5 * gen.normal(size=(N, 64)), jnp.bfloat16)
             for _ in range(2 if arch == "lstm" else 1)]
        carry_j = tuple(c) if arch == "lstm" else c[0]
        params = jm.init(jax.random.PRNGKey(2), obs[:1],
                         jm.initial_carry((1,)))
        lj, vj, nj = jm.apply(params, obs, carry_j)
        carry = tuple(to_torch(x.astype(jnp.float32)).bfloat16() for x in c)
        p = params_from_flax(jax.tree.map(np.asarray, params))
        lt, vt, nt = apply_rnn(p, torch.from_numpy(obs),
                               carry if arch == "lstm" else carry[0],
                               precision="flax_bf16")
        nj = nj if arch == "lstm" else (nj,)
        nt = nt if arch == "lstm" else (nt,)
        for a, b in zip(nt, nj):
            assert a.dtype == torch.bfloat16 and b.dtype == jnp.bfloat16
            assert_flax_close(a.float().numpy(), b.astype(jnp.float32),
                              "carry")
    else:
        params = jm.init(jax.random.PRNGKey(2), obs[:1])
        lj, vj = jm.apply(params, obs)
        p = params_from_flax(jax.tree.map(np.asarray, params))
        lt, vt = apply(p, torch.from_numpy(obs), precision="flax_bf16")
    assert lt.dtype == vt.dtype == torch.float32
    assert_flax_close(lt.numpy(), lj, "logits")
    assert_flax_close(vt.numpy(), vj, "value")
    # The float32 forward is not the bf16 one.
    lf = (apply_rnn(p, torch.from_numpy(obs), tuple(x.float() for x in carry)
                    if arch == "lstm" else carry[0].float())[0]
          if recurrent else apply(p, torch.from_numpy(obs))[0])
    assert (bf16_ulps(lf.numpy(), lj) > 0).mean() > FLAX_SHARE


# ---- (2) the learner twins against the Pallas kernels -------------------------

def mlp_case(seed, groups=None):
    """(pallas kwargs, port args) on test_grad_kernel's inputs, or
    test_torch_groups' with ``groups``."""
    if groups is None:
        _, params, _, sched, opt_state, data = mg._setup(True, seed=seed)
        obs_bm, fields = mg._kernel_inputs(data)
        p0, traj, adv_n, tgt = port_inputs(params, opt_state, data)
        pk = dict(obs_dim=mg.D, block_envs=8)
        return (params, opt_state, sched, (obs_bm, fields), pk,
                (p0, traj, adv_n, tgt), {})
    _, params, sched, opt_state, data = tg.sgd_setup(groups, seed)
    p0, traj, adv_n, tgt = tg.port_inputs(params, data)
    pk = dict(obs_dim=tg.SD, block_envs=tg.SB // tg.SM,
              rows_per_block=len(groups), policy_groups=groups)
    return (params, opt_state, sched, tg.pallas_inputs(data), pk,
            (p0, traj, adv_n, tgt), dict(policy_groups=groups))


def cnn_case(seed):
    _, params, _, sched, opt_state, data = cg._setup(True, seed=seed)
    p0, traj, adv_n, tgt = port_inputs(params, opt_state, data)
    pk = dict(obs_dim=cg.D, block_envs=8, env_cfg=cg.CFG, tcfg=cg.TCFG)
    return (params, opt_state, sched, cg._kernel_inputs(data), pk,
            (p0, traj, adv_n, tgt), {})


def rnn_case(seed, cell):
    _, params, _, sched, opt_state, data, h0 = rg._setup(True, 1, seed=seed,
                                                         cell=cell)
    obs_bm, fields, h0_rows = rg._kernel_inputs(data, h0)
    p, _, traj, adv_n, tgt, carry = tsr.port_inputs(params, opt_state, data,
                                                    h0)
    pk = dict(obs_dim=rg.D, block_envs=8, unroll_length=rg.T,
              num_agents=rg.A)
    return (params, opt_state, sched, (obs_bm, fields, h0_rows), pk,
            (p, traj, adv_n, tgt, carry), {})


LEARNERS = {  # case: (setup, pallas grads, pallas phase, port module names)
    "mlp": (lambda s: mlp_case(s), ppo_minibatch_grads_pallas,
            ppo_sgd_phase_pallas, sgd.ppo_minibatch_grads,
            sgd.ppo_sgd_phase),
    "mlp_groups": (lambda s: mlp_case(s, (0, 1, 0, 1)),
                   ppo_minibatch_grads_pallas, ppo_sgd_phase_pallas,
                   sgd.ppo_minibatch_grads, sgd.ppo_sgd_phase),
    "gru": (lambda s: rnn_case(s, "gru"), ppo_rnn_minibatch_grads_pallas,
            ppo_rnn_sgd_phase_pallas, sgd_rnn.ppo_rnn_minibatch_grads,
            sgd_rnn.ppo_rnn_sgd_phase),
    "lstm": (lambda s: rnn_case(s, "lstm"), ppo_rnn_minibatch_grads_pallas,
             ppo_rnn_sgd_phase_pallas, sgd_rnn.ppo_rnn_minibatch_grads,
             sgd_rnn.ppo_rnn_sgd_phase),
    "cnn": (lambda s: cnn_case(s), ppo_cnn_minibatch_grads_pallas,
            ppo_cnn_sgd_phase_pallas, sgd_cnn.ppo_cnn_minibatch_grads,
            sgd_cnn.ppo_cnn_sgd_phase),
}
E, M = 2, 2  # every JAX setup's epochs and minibatches
HYPER = dict(num_minibatches=M, clip_eps=0.2, value_coef=0.5)
ENT, KL, MAXNORM = 0.01, 0.05, 0.5


def tree_err(port: dict, jax_tree, rtol, atol) -> float:
    """The largest |port - jax| / (atol + rtol |jax|) over the tree."""
    want = tree_np(jax_tree)
    assert port.keys() == want.keys()
    return max(float(np.max(np.abs(port[k].numpy() - want[k])
                            / (atol + rtol * np.abs(want[k]))))
               for k in want)


@pytest.mark.parametrize("case", sorted(LEARNERS))
def test_bf16_minibatch_grads_twin_matches_pallas(case):
    """K4 / K9 / K12's bf16 twin against the Pallas kernel with
    ``matmul_dtype="bfloat16"`` in interpret mode, every minibatch: losses
    within 1e-6, grads rtol 1e-4 / atol 1e-7 (the f32 suites' bounds);
    the f32 twin's grads lie outside."""
    setup, pallas, _, port, _ = LEARNERS[case]
    params, _, _, k_in, pk, p_in, gkw = setup(3)
    for mb in range(M):
        (l_k, aux_k), g_k = pallas(params, *k_in, mb, ENT, KL, **HYPER,
                                   mask_actions=True, interpret=True, **pk,
                                   **BF)
        (l_t, aux_t), g_t = port(*p_in, mb, ENT, KL, **HYPER,
                                 mask_actions=True, **gkw, **BF)
        for a, b in zip((l_t, *aux_t), (l_k, *aux_k)):
            assert abs(float(a) - float(b)) < 1e-6
        assert tree_err(g_t, g_k, 1e-4, 1e-7) <= 1.0, f"grads mb={mb}"
    (_, _), g_f = port(*p_in, M - 1, ENT, KL, **HYPER, mask_actions=True,
                       **gkw)
    assert tree_err(g_f, g_k, 1e-4, 1e-7) > 1.0


# (rtol, atol) of the phase: five to ten times the f32 suites' atol. In 4
# Adam steps an activation that is one float32 ulp off the interpret-mode
# value (tanhf, expf) can round to the neighbouring bf16 operand: measured
# on the CNN, params 1.6e-6 and mu 3.4e-7 off; on the others at most 2.7e-7
# and 5.8e-8. The f32 twin's mu lies 20 to 600 times beyond this bound.
PHASE_TOL = dict(params=(1e-5, 5e-6), mu=(1e-5, 1e-6), nu=(1e-5, 1e-9))


@pytest.mark.parametrize("case", sorted(LEARNERS))
def test_bf16_sgd_phase_twin_matches_pallas(case):
    """K3 / K8 / K11's bf16 twin against the Pallas phase kernel with
    ``matmul_dtype="bfloat16"`` in interpret mode over E x M = 4 steps:
    losses rtol 1e-5 / atol 2e-6 (the f32 suites' bound), params, mu and
    nu at ``PHASE_TOL``; the f32 twin's mu lies outside."""
    setup, _, pallas, _, port = LEARNERS[case]
    params, opt_state, sched, k_in, pk, p_in, gkw = setup(0)
    n_steps = E * M
    count0, _, _ = find_adam_state(opt_state)
    steps = count0 + jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_k, opt_k, l_k = pallas(
        params, opt_state, *k_in, jax.vmap(sched)(steps).astype(jnp.float32),
        1.0 - 0.9 ** cnt, 1.0 - 0.999 ** cnt, ENT, KL, num_epochs=E,
        max_grad_norm=MAXNORM, mask_actions=True, interpret=True, **HYPER,
        **pk, **BF)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    rows = ClipAdam(linear_schedule(3e-4, 0.0, 100), MAXNORM).step_rows(
        opt0.count, n_steps)
    lead, tail = p_in[:4], p_in[4:]  # the recurrent twins take h0 last
    kw = dict(num_epochs=E, max_grad_norm=MAXNORM, mask_actions=True,
              **HYPER, **gkw)
    p_t, opt_t, l_t = port(lead[0], opt0, *lead[1:], *tail, *rows, ENT, KL,
                           **kw, **BF)
    for a, b in zip(l_t, l_k):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    _, mu_k, nu_k = find_adam_state(opt_k)
    assert opt_t.count == n_steps
    assert tree_err(p_t, p_k, *PHASE_TOL["params"]) <= 1.0, "params"
    assert tree_err(opt_t.mu, mu_k, *PHASE_TOL["mu"]) <= 1.0, "mu"
    assert tree_err(opt_t.nu, nu_k, *PHASE_TOL["nu"]) <= 1.0, "nu"
    _, opt_f, _ = port(lead[0], opt0, *lead[1:], *tail, *rows, ENT, KL, **kw)
    assert tree_err(opt_f.mu, mu_k, *PHASE_TOL["mu"]) > 1.0


def test_bad_matmul_dtype_raises():
    params, _, _, _, _, p_in, _ = mlp_case(0)
    with pytest.raises(ValueError, match="matmul_dtype"):
        sgd.ppo_minibatch_grads(*p_in, 0, ENT, KL, **HYPER,
                                mask_actions=True, matmul_dtype="float16")


# ---- (5) the trainers against the JAX trainer ----------------------------------

J_CFG = j_small_config(max_steps=8)
J_BASE = JTrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                      num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                      mask_actions=True, kl_coeff=0.1,
                      entropy_coef_final=0.001, model_dtype="bfloat16")
PORT_FIELDS = ("num_envs", "unroll_length", "num_updates", "num_minibatches",
               "ppo_epochs", "hidden_dim", "mask_actions", "kl_coeff",
               "entropy_coef_final", "model_dtype")
TRAINERS = {  # arch: (env max_steps, unroll, JAX fused route)
    "mlp": (8, 4, dict(pallas_block=16)),
    "cnn": (8, 4, dict(pallas_block=16)),
    "gru": (32, 16, dict(pallas_block=8, sgd_rnn_block_envs=4)),
}


def leaves_of(carry):
    return carry if isinstance(carry, tuple) else (carry,)


@pytest.mark.parametrize("arch", sorted(TRAINERS))
def test_bf16_train_steps_match_jax_trainer(arch):
    """3 updates from one carried-over state at ``model_dtype="bfloat16"``:
    the JAX trainer on its fused route in interpret mode (the acting
    kernel in float32, the learner kernel on bf16 operands, the flax-bf16
    model's last values) against the port on the CPU. The episode ends
    inside the window (after update 2). Env state, keys and obs bit-equal,
    so no action flipped; the GRU's carry bf16 and equal; metrics within
    2e-4 + 1e-3 relative; params rtol 2e-4 / atol 5e-5, mu rtol 2e-4 /
    atol 5e-6, nu rtol 2e-4 / atol 5e-9 (the f32 trainer tests'
    bounds)."""
    max_steps, T, route = TRAINERS[arch]
    tcfg = J_BASE.replace(unroll_length=T)
    jcfg = J_CFG.replace(max_steps=max_steps)
    fused = tcfg.replace(rollout_backend="pallas", grad_backend="pallas",
                         pallas_interpret=True, **route)
    ptcfg = wt.TrainConfig(**{f: getattr(tcfg, f) for f in PORT_FIELDS})
    pcfg = wt.small_config(max_steps=max_steps)
    recurrent = arch == "gru"
    if recurrent:
        jtr = j_make_train_rnn(jcfg, fused.replace(num_envs=8), arch=arch)
        tr = make_train_rnn(pcfg, ptcfg.replace(num_envs=8), arch=arch,
                            device="cpu")
        jrs = jtr.init(jax.random.PRNGKey(1))
        rs = runner_state_rnn_from_jax(jax.tree.map(np.asarray, jrs))
        assert rs.carry.dtype == torch.bfloat16
    else:
        jtr = j_make_train(jcfg, fused, arch=arch)
        tr = make_train(pcfg, ptcfg, arch=arch, device="cpu")
        jrs = jtr.init(jax.random.PRNGKey(0))
        rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    assert tr.model.dtype == torch.bfloat16
    for u in range(3):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert_bits(jrs.obs, rs.obs, f"update {u} obs")
        ended = (u + 1) * T % max_steps == 0  # update 2 ends the episode
        assert bool((rs.env_state.t == 0).all()) == ended
        if recurrent:
            assert (not rs.carry.any()) == ended
            assert rs.carry.dtype == torch.bfloat16
            assert jrs.carry.dtype == jnp.bfloat16
            np.testing.assert_array_equal(
                rs.carry.float().numpy(),
                np.asarray(jrs.carry.astype(jnp.float32)),
                err_msg=f"update {u} carry")
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    assert tree_err(rs.params, jrs.params, 2e-4, 5e-5) <= 1.0, "params"
    _, mu, nu = find_adam_state(jrs.opt_state)
    assert tree_err(rs.opt_state.mu, mu, 2e-4, 5e-6) <= 1.0, "mu"
    assert tree_err(rs.opt_state.nu, nu, 2e-4, 5e-9) <= 1.0, "nu"


# ---- serving, resume, the CLI --------------------------------------------------

@pytest.mark.parametrize("arch", ["mlp", "gru"])
def test_bf16_policy_from_checkpoint_matches_jax_policy(arch, tmp_path):
    """A bf16 run's checkpoint: ``Policy.from_checkpoint`` builds the bf16
    model (a recurrent one threads a bf16 carry) and acts as the JAX
    ``serve.Policy`` of the flax-bf16 model on the same params, argmax
    actions bit-equal over 4 steps."""
    cfg = j_small_config()
    jm = j_make_model(cfg, arch, hidden_dim=16, dtype=jnp.bfloat16)
    gen = np.random.default_rng(6)
    obs = gen.normal(size=(4, 32, cfg.num_agents, cfg.obs_dim)).astype(
        np.float32)
    args = (obs[0, :1, 0], jm.initial_carry((1,))) if arch == "gru" else (
        obs[0, :1, 0],)
    params = jm.init(jax.random.PRNGKey(7), *args)
    tcfg = wt.TrainConfig(hidden_dim=16, model_dtype="bfloat16")
    d = str(tmp_path)
    write_policy_meta(d, wt.small_config(), tcfg, arch=arch)
    checkpoint.save(d, 1, {"params": params_from_flax(
        jax.tree.map(np.asarray, params))})
    got = Policy.from_checkpoint(d, device="cpu")
    assert got.model.dtype == torch.bfloat16
    want = JPolicy(cfg, jm, params, arch=arch)
    s_got = s_want = None
    for t in range(4):
        a, s_got = got.compute_actions(obs[t], s_got)
        b, s_want = want.compute_actions(obs[t], s_want)
        assert_bits(b, a, f"step {t} actions")
        if arch == "gru":
            assert s_got.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                s_got.float().numpy(), np.asarray(s_want.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ["mlp", "gru"])
def test_bf16_resume_is_bit_exact(arch, tmp_path):
    """Saved at update 2 and restored into a fresh state, a bf16 run goes
    on to update 4 bit-equal to the uninterrupted run; the GRU's carry
    stays bf16 through the file."""
    cfg = wt.small_config(max_steps=8)
    tcfg = wt.TrainConfig(num_envs=16, unroll_length=4, num_updates=4,
                          num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                          model_dtype="bfloat16")

    def build():
        if arch == "gru":
            return make_train_rnn(cfg, tcfg.replace(num_envs=8), arch=arch,
                                  device="cpu")
        return make_train(cfg, tcfg, device="cpu")

    tr = build()
    rs, _ = tr.train_many(tr.init(rng.prng_key(0)), 2)
    checkpoint.save(str(tmp_path), 2, rs)
    full, _ = tr.train_many(rs, 2)
    step, restored = checkpoint.restore_latest(
        str(tmp_path), build().init(rng.prng_key(9)))
    assert step == 2
    assert_same_state(restored, rs)
    if arch == "gru":
        assert restored.carry.dtype == torch.bfloat16
    resumed, _ = build().train_many(restored, 2)
    assert_same_state(resumed, full)


@pytest.mark.parametrize("arch", ["mlp", "gru", "cnn"])
def test_bf16_cli_runs_two_updates(arch, tmp_path):
    """``--model-dtype bfloat16`` trains 2 updates on the CPU, writes the
    dtype into ``policy_meta.json``, and its checkpoint serves the bf16
    model."""
    path = tmp_path / "metrics.jsonl"
    ckpt = tmp_path / "ckpt"
    cli_main(["--arch", arch, "--env", "small", "--env-config",
              '{"max_steps": 8}', "--num-envs", "8", "--unroll-length", "4",
              "--num-updates", "2", "--num-minibatches", "2", "--ppo-epochs",
              "2", "--hidden-dim", "16", "--log-every", "1", "--model-dtype",
              "bfloat16", "--checkpoint-every", "2", "--checkpoint-dir",
              str(ckpt), "--cpu", "--metrics-path", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    steps = [r for r in recs[1:] if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in steps)
    meta = json.loads((ckpt / "policy_meta.json").read_text())
    assert meta["model_dtype"] == "bfloat16" and meta["arch"] == arch
    pol = Policy.from_checkpoint(str(ckpt), device="cpu")
    assert pol.model.dtype == torch.bfloat16
    obs = np.zeros((3, 2, wt.small_config().obs_dim), np.float32)
    acts, state = pol.compute_actions(obs)
    assert acts.shape == (3, 2)
    assert (state is not None and state.dtype == torch.bfloat16) == (
        arch == "gru")


def test_bf16_impala_is_refused_by_name():
    """Refused until the per-step acting phase: the bf16 IMPALA trainer
    now builds the bf16 model, acts per step and learns plain, as the JAX
    trainer sends both phases to XLA (held against it in
    ``tests/test_torch_step_acting.py``); the route is named."""
    tcfg = wt.TrainConfig(num_envs=16, unroll_length=4, hidden_dim=16,
                          model_dtype="bfloat16")
    tr = make_train_impala(wt.small_config(), tcfg, device="cpu")
    assert tr.model.dtype == torch.bfloat16
    assert tr.backends == {"rollout": "step", "grad": "plain"}

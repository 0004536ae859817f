"""Policy groups in the port (``policy_groups``), on the CPU.

On CPU tensors the port's wrappers run their plain twins; the JAX package
runs its Pallas kernels in interpret mode or, for the trainer, its XLA
route. The same inputs, made from seeds with numpy or carried over from the
JAX side, go through both, at small sizes (2 agents with the groups ``(0,
1)`` and ``(1, 0)``, 4 agents with ``(0, 1, 0, 1)``, hidden 16, T = 4):

- the multi-policy model: the JAX package's two ``ValueError``s, and
  ``params_from_flax`` of a flax ``MultiPolicyActorCritic`` tree (MLP and
  CNN sub-models, and a one-group map): logits and values within 1e-6 of
  flax's;
- the acting twin against ``ppo_rollout_pallas(interpret=True,
  policy_groups=...)``: obs, actions on the JAX gumbel stream, rewards,
  mask and final state bit-equal (the shaped reward within 1e-6: XLA:CPU
  contracts its sums), values and log-probs within 1e-5; plain, masked and
  shaped mid-episode, global view and masked;
- the learner twins against ``ppo_sgd_phase_pallas`` /
  ``ppo_minibatch_grads_pallas`` in interpret mode with ``policy_groups``,
  and the gradient against ``jax.grad`` of the multi-policy loss, with
  ``tests/test_torch_sgd.py``'s tolerances;
- ``make_train(policy_groups=(0, 1))`` against the JAX trainer's XLA route
  for 3 updates from a carried-over state (``runner_state_from_jax``: the
  ``policies_g`` params and their Adam moments): env state and keys
  bit-equal, metrics within 2e-4 + 1e-3 relative, every group's params and
  moments at ``tests/test_torch_train.py``'s bounds;
- serving: ``Policy`` with groups against the JAX ``serve.Policy`` on the
  same params, and the train CLI's ``--policy-groups`` checkpoint through
  ``Policy.from_checkpoint``.

The CUDA kernels' group routing is held on the card by
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
from warehouse_tpu.config import (TrainConfig, medium_config, small_config)
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_multi_policy_model as j_multi
from warehouse_tpu.ops.ppo_update import ppo_losses as j_losses
from warehouse_tpu.pallas.act import _pad8, ppo_rollout_pallas
from warehouse_tpu.pallas.sgd import (FIELD_ROWS, find_adam_state,
                                      ppo_minibatch_grads_pallas,
                                      ppo_sgd_phase_pallas)
from warehouse_tpu.serve import Policy as JPolicy
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.evaluate import checkpoint_policy_fn
from warehouse_tpu_torch.kernels import sgd
from warehouse_tpu_torch.kernels.act import Shaping, act_steps, ppo_rollout
from warehouse_tpu_torch.models import (MultiPolicyActorCritic,
                                        make_multi_policy_model,
                                        params_from_flax)
from warehouse_tpu_torch.models.policy import apply
from warehouse_tpu_torch.ops.ppo_update import NEG_INF, first_argmax
from warehouse_tpu_torch.optim import (ClipAdam, linear_schedule,
                                       opt_state_from_optax)
from warehouse_tpu_torch.serve import Policy
from warehouse_tpu_torch.train import (Transition, make_train,
                                       runner_state_from_jax)
from warehouse_tpu_torch.train.__main__ import main as train_main

from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch

T, HIDDEN = 4, 16
COEF, GAMMA = 0.02, 0.99


def tree_np(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def j_params(cfg, groups, arch="mlp", seed=0):
    jm = j_multi(cfg, groups, arch=arch, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.obs_dim)),
                     jnp.zeros(1, jnp.int32))
    return jm, params


def port_model(cfg, groups, params, arch="mlp"):
    m = make_multi_policy_model(cfg, groups, arch, hidden_dim=HIDDEN,
                                device="cpu")
    m.load_state_dict({k: torch.from_numpy(v)
                       for k, v in tree_np(params).items()})
    return m


# ---- the model and its weights ---------------------------------------------

@pytest.mark.parametrize("groups, match", [((0,), "one entry per agent"),
                                           ((0, 2), "no gaps")])
def test_multi_policy_validation(groups, match):
    """The JAX package's two ``ValueError``s (``tests/test_ppo.py::
    test_multi_policy_validation``), from the model and from the
    trainer."""
    cfg = small_config()
    with pytest.raises(ValueError, match=match):
        make_multi_policy_model(cfg, groups, device="cpu")
    with pytest.raises(ValueError, match=match):
        make_train(cfg, TrainConfig(num_envs=8, unroll_length=4,
                                    num_minibatches=2, hidden_dim=16),
                   policy_groups=groups, device="cpu")


@pytest.mark.parametrize("name, groups, arch", [
    ("small", (0, 1), "mlp"), ("small", (1, 0), "mlp"),
    ("small", (0, 0), "mlp"), ("medium", (0, 1, 0, 1), "mlp"),
    ("small", (0, 1), "cnn")])
def test_params_from_flax_multi_policy(name, groups, arch):
    """A flax ``MultiPolicyActorCritic`` tree carried over: the port's
    forward equals ``model.apply(params, obs, gids)`` within 1e-6, through
    the module and through ``apply``."""
    cfg = {"small": small_config(), "medium": medium_config()}[name]
    jm, params = j_params(cfg, groups, arch, seed=2)
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    K = max(groups) + 1
    assert {k.split(".")[1] for k in sd} == {str(g) for g in range(K)}
    m = port_model(cfg, groups, params, arch)
    assert isinstance(m, MultiPolicyActorCritic) and len(m.policies) == K
    obs = np.random.default_rng(3).normal(
        size=(8, cfg.num_agents, cfg.obs_dim)).astype(np.float32)
    gids = np.broadcast_to(np.asarray(groups, np.int32), obs.shape[:2])
    j_logits, j_value = jm.apply(params, jnp.asarray(obs), jnp.asarray(gids))
    with torch.no_grad():
        logits, value = m(torch.from_numpy(obs), torch.tensor(groups))
        a_logits, a_value = apply(dict(m.named_parameters()),
                                  torch.from_numpy(obs), torch.tensor(groups))
    for got in ((logits, value), (a_logits, a_value)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(j_logits),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(j_value),
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="policy_groups"):
        apply(sd, torch.from_numpy(obs))


# ---- (K2) the acting twin against the Pallas kernel's groups ---------------

B = 16
ACT_CASES = {  # name: (config, groups, masked, shaped, start step)
    "small_01": (small_config(max_steps=T), (0, 1), False, False, 0),
    "small_10_masked_shaped": (small_config(max_steps=2 * T), (1, 0), True,
                               True, T),
    "global_masked": (small_config(max_steps=T, global_obs=True), (0, 1),
                      True, False, 0),
}


@pytest.fixture(scope="module", params=sorted(ACT_CASES))
def act_setup(request):
    cfg, groups, masked, shaped, t0 = ACT_CASES[request.param]
    _, params = j_params(cfg, groups, seed=1)
    jk, tk = env_keys(4, n=B)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    js = js.replace(t=js.t + t0)
    ts = ts.replace(t=ts.t + t0)
    out = ppo_rollout_pallas(cfg, params, js, T, jax.random.PRNGKey(9),
                             block=B, interpret=True, mask_actions=masked,
                             shaping_coef=COEF if shaped else 0.0,
                             gamma=GAMMA, policy_groups=groups)
    return (cfg, groups, masked, shaped, port_model(cfg, groups, params), ts,
            out)


def test_grouped_twin_matches_pallas_kernel(act_setup):
    cfg, groups, masked, shaped, m, ts, (j_new, j_roll, _, _) = act_setup
    A = cfg.num_agents
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T, (5, B * A))
    mask = torch.zeros(T, B, A, 5, dtype=torch.bool) if masked else None
    shaping = None
    if shaped:
        done = to_torch(j_roll.truncated).to(torch.float32)
        shaping = Shaping(COEF, GAMMA, done, torch.zeros(T, B, A))
    new, obs, action, lp, value, reward, delivered = act_steps(
        cfg, m, ts, u, pick, drop, to_torch(g), mask=mask, shaping=shaping,
        groups=groups)
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.delivered, delivered, "delivered")
    if masked:
        assert_bits(j_roll.mask, mask, "mask")
    if shaped:  # XLA:CPU contracts the shaping's sums (test_torch_act.py)
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
    # The wrapper: the JAX wrapper's keys; the groups really differ.
    _, roll, rk, nk = ppo_rollout(cfg, m, ts, T, rng.prng_key(9),
                                  mask_actions=masked, policy_groups=groups,
                                  shaping_coef=COEF if shaped else 0.0,
                                  gamma=GAMMA)
    assert_bits(j_roll.truncated, roll.truncated, "truncated")
    with torch.no_grad():
        one = m.policies[0](roll.obs)[1]
    assert not torch.equal(one, roll.value)


def test_groups_gates():
    """A multi-policy model needs its groups and the groups their model;
    a multi-policy model of CNNs acts with ``arch="cnn"`` only (its twin
    against the Pallas kernel: test_torch_cnn_groups.py)."""
    cfg = small_config(max_steps=T)
    _, params = j_params(cfg, (0, 1))
    m = port_model(cfg, (0, 1), params)
    ts, _ = batch.reset_batch(cfg, env_keys(5, n=4)[1])
    with pytest.raises(ValueError, match="policy_groups"):
        ppo_rollout(cfg, m, ts, T, rng.prng_key(0))
    with pytest.raises(ValueError, match="policy_groups"):
        ppo_rollout(cfg, m, ts, T, rng.prng_key(0), policy_groups=(0, 0))
    cnn = make_multi_policy_model(cfg, (0, 1), "cnn", hidden_dim=HIDDEN,
                                  device="cpu")
    _, roll, _, _ = ppo_rollout(cfg, cnn, ts, T, rng.prng_key(0),
                                policy_groups=(0, 1), arch="cnn")
    assert roll.value.shape == (T, 4, cfg.num_agents)
    with pytest.raises(ValueError, match="arch"):
        ppo_rollout(cfg, cnn, ts, T, rng.prng_key(0), policy_groups=(0, 1))


# ---- (K3 / K4) the learner twins against the Pallas kernels' groups ---------

SB, SE, SM, SD = 16, 2, 2, 26
CLIP, VCOEF, MAXNORM, ENT, KL = 0.2, 0.5, 0.5, 0.01, 0.05
SGD_CASES = {"a2_01": (0, 1), "a2_10": (1, 0), "a4_0101": (0, 1, 0, 1)}
# (the phase's cases; each gradient case holds the second minibatch)
PHASE_CASES = ("a2_01", "a4_0101")


def sgd_setup(groups, seed):
    """A numpy trajectory ``[T, SB, A]`` at D = 26, a flax multi-policy
    MLP 26 -> 16 -> 16 per group and its optax state; masks on."""
    A = len(groups)
    r = np.random.default_rng(seed)
    shape = (T, SB, A)
    obs = r.normal(size=(*shape, SD)).astype(np.float32)
    action = r.integers(0, 5, size=shape).astype(np.int32)
    old_lp = (-1.6 + 0.1 * r.normal(size=shape)).astype(np.float32)
    old_v, adv, tgt = (r.normal(size=shape).astype(np.float32)
                       for _ in range(3))
    mask = r.random(size=(*shape, 5)) > 0.3
    mask[..., 0] = True
    np.put_along_axis(mask, action[..., None], True, -1)
    g = adv.reshape(T, SM, SB // SM, A)
    adv_n = ((g - g.mean(axis=(0, 2, 3), keepdims=True))
             / (g.std(axis=(0, 2, 3), keepdims=True) + 1e-8)).reshape(shape)
    cfg = small_config().replace(num_agents=A)
    jm = j_multi(cfg, groups, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, SD)),
                     jnp.zeros(1, jnp.int32))
    sched = optax.linear_schedule(3e-4, 0.0, 100)
    tx = optax.chain(optax.clip_by_global_norm(MAXNORM),
                     optax.adam(sched, eps=1e-5))
    return jm, params, sched, tx.init(params), (
        obs, action, old_lp, old_v, adv_n.astype(np.float32), tgt, mask)


def pallas_inputs(data):
    """The TPU kernels' packed layout: obs ``[T A Dp, B]``, the field rows
    ``[T A 16, B]`` (``tests/test_grad_kernel.py`` ``_kernel_inputs``)."""
    obs, action, old_lp, old_v, adv_n, tgt, mask = map(jnp.asarray, data)
    A, dp = obs.shape[2], _pad8(SD)
    obs_bm = jnp.pad(obs.transpose(0, 2, 3, 1),
                     ((0, 0), (0, 0), (0, dp - SD), (0, 0))
                     ).reshape(T * A * dp, SB)

    def row(x):
        return x.transpose(0, 2, 1).reshape(T * A, SB)

    rows = [row(action.astype(jnp.float32)), row(old_lp), row(old_v),
            row(adv_n), row(tgt)]
    rows += [row(mask[..., r].astype(jnp.float32)) for r in range(5)]
    rows += [jnp.zeros((T * A, SB), jnp.float32)] * (FIELD_ROWS - len(rows))
    return obs_bm, jnp.stack(rows, axis=1).reshape(T * A * FIELD_ROWS, SB)


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


@pytest.mark.parametrize("case", PHASE_CASES)
def test_grouped_sgd_phase_twin_matches_pallas(case):
    groups = SGD_CASES[case]
    _, params, sched, opt_state, data = sgd_setup(groups, 0)
    n_steps = SE * SM
    steps = jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_p, opt_p, l_p = ppo_sgd_phase_pallas(
        params, opt_state, *pallas_inputs(data),
        jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
        1.0 - 0.999 ** cnt, ENT, KL, num_epochs=SE, num_minibatches=SM,
        clip_eps=CLIP, value_coef=VCOEF, max_grad_norm=MAXNORM,
        mask_actions=True, obs_dim=SD, block_envs=SB // SM,
        rows_per_block=len(groups), policy_groups=groups, interpret=True)
    p0, traj, adv_n, tgt = port_inputs(params, data)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    assert opt0.mu.keys() == p0.keys()
    rows = ClipAdam(linear_schedule(3e-4, 0.0, 100), MAXNORM).step_rows(
        opt0.count, n_steps)
    p_t, opt_t, l_t = sgd.ppo_sgd_phase(
        p0, opt0, traj, adv_n, tgt, *rows, ENT, KL, num_epochs=SE,
        num_minibatches=SM, clip_eps=CLIP, value_coef=VCOEF,
        max_grad_norm=MAXNORM, mask_actions=True, policy_groups=groups)
    for a, b in zip(l_t, l_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-6)
    assert_tree(p_t, p_p, 1e-5, 1e-6, "params")
    count, mu, nu = find_adam_state(opt_p)
    assert int(count) == opt_t.count == n_steps
    assert_tree(opt_t.mu, mu, 1e-5, 1e-7, "mu")
    assert_tree(opt_t.nu, nu, 1e-5, 1e-10, "nu")
    # Each group trained on its own agents' samples only.
    k0 = "policies.0.hidden.0.weight"
    if len(set(groups)) > 1:
        assert not torch.equal(p_t[k0] - p0[k0], p_t[k0.replace(
            "s.0.", "s.1.")] - p0[k0.replace("s.0.", "s.1.")])


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_grouped_minibatch_grads_twin_matches_pallas_and_jax_grad(case):
    groups = SGD_CASES[case]
    jm, params, _, _, data = sgd_setup(groups, 3)
    obs_bm, fields = pallas_inputs(data)
    p0, traj, adv_n, tgt = port_inputs(params, data)
    w = SB // SM
    gids = jnp.broadcast_to(jnp.asarray(groups, jnp.int32), (T, w,
                                                             len(groups)))

    def loss_fn(p, mb):
        o, a, olp, ov, ad, tg, mk = mb
        logits, value = jm.apply(p, o, gids)
        logits = jnp.where(mk, logits, NEG_INF)
        return j_losses(logits, value, a, olp, ov, ad, tg, clip_eps=CLIP,
                        value_coef=VCOEF, ent_coef=ENT, kl_coeff=KL,
                        normalize_adv=False)

    for mb in (SM - 1,):
        ref_mb = tuple(jnp.asarray(x[:, mb * w:(mb + 1) * w]) for x in data)
        jax_grad = jax.value_and_grad(loss_fn, has_aux=True)(params, ref_mb)
        pallas = ppo_minibatch_grads_pallas(
            params, obs_bm, fields, mb, ENT, KL, num_minibatches=SM,
            clip_eps=CLIP, value_coef=VCOEF, mask_actions=True, obs_dim=SD,
            block_envs=w, rows_per_block=len(groups), policy_groups=groups,
            interpret=True)
        (l_t, aux_t), g_t = sgd.ppo_minibatch_grads(
            p0, traj, adv_n, tgt, mb, ENT, KL, num_minibatches=SM,
            clip_eps=CLIP, value_coef=VCOEF, mask_actions=True,
            policy_groups=groups)
        for (l_r, aux_r), g_r in (jax_grad, pallas):
            for a, b in zip((l_t, *aux_t), (l_r, *aux_r)):
                assert abs(float(a) - float(b)) < 1e-6
            assert_tree(g_t, g_r, 1e-4, 1e-7, f"grads mb={mb}")


def test_pack_layout_is_group_order():
    """The kernels' flat vector: group 0's packed params, then group 1's,
    each in the single-policy layout."""
    cfg = small_config()
    m = make_multi_policy_model(cfg, (0, 1), hidden_dim=8, device="cpu",
                                generator=torch.Generator().manual_seed(0))
    params = dict(m.state_dict())
    flat = sgd.pack(params)
    subs = [sgd.pack(dict(p.state_dict())) for p in m.policies]
    assert torch.equal(flat, torch.cat(subs))
    back = sgd.unpack(flat, params)
    assert list(back) == list(params)
    assert all(torch.equal(back[k], params[k]) for k in params)


# ---- the trainer against the JAX trainer ------------------------------------

TCFG = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   kl_coeff=0.1, entropy_coef_final=0.001, mask_actions=True)


def assert_params(port, jax_params, rtol, atol, what):
    for k, v in tree_np(jax_params).items():
        np.testing.assert_allclose(port[k].numpy(), v, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


def test_grouped_train_steps_match_jax_trainer():
    """3 updates, masked, from a carried-over multi-policy state; the JAX
    trainer on its XLA route (rollout and SGD)."""
    cfg = small_config(max_steps=8)
    groups = (0, 1)
    jtr = j_make_train(cfg, TCFG.replace(rollout_backend="xla",
                                         grad_backend="xla"),
                       policy_groups=groups)
    tr = make_train(cfg, TCFG, policy_groups=groups, device="cpu")
    assert tr.policy_groups == groups
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
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    assert_params(rs.params, jrs.params, 2e-4, 5e-5, "params")
    _, mu, _ = find_adam_state(jrs.opt_state)
    assert_params(rs.opt_state.mu, mu, 2e-4, 5e-6, "mu")
    k0 = "policies.0.hidden.0.weight"
    assert not torch.equal(rs.params[k0], rs.params[k0.replace("s.0.",
                                                               "s.1.")])
    # The init draws each group's sub-model from the generator in turn.
    again = tr.init(rng.prng_key(3))
    assert not torch.equal(again.params[k0],
                           again.params[k0.replace("s.0.", "s.1.")])


# ---- serving and the CLI -----------------------------------------------------

@pytest.mark.parametrize("arch", ["mlp", "cnn"])
def test_grouped_policy_matches_jax_policy(arch):
    """``Policy(policy_groups=)`` of MLP or CNN sub-models against the JAX
    ``serve.Policy`` on the same params: the argmax actions bit-equal."""
    cfg = small_config()
    groups = (1, 0)
    jm, params = j_params(cfg, groups, arch, seed=4)
    m = port_model(cfg, groups, params, arch)
    obs = np.random.default_rng(5).normal(
        size=(16, cfg.num_agents, cfg.obs_dim)).astype(np.float32)
    want, _ = JPolicy(cfg, jm, params, arch=arch,
                      policy_groups=groups).compute_actions(obs)
    got, _ = Policy(cfg, m, policy_groups=groups).compute_actions(obs)
    assert_bits(want, got, "actions")
    with pytest.raises(ValueError, match="policy_groups"):
        Policy(cfg, m)
    with pytest.raises(ValueError, match="policy_groups"):
        Policy(cfg, m, policy_groups=(0, 1, 2))


def test_cli_policy_groups_checkpoint_serves(tmp_path):
    """``--policy-groups 0,1`` trains 2 updates on the CPU, writes the
    groups into ``policy_meta.json``; ``Policy.from_checkpoint`` acts as
    the trained params do; ``evaluate``'s checkpoint policy refuses the
    groups by name."""
    ckpt = tmp_path / "ckpt"
    train_main(["--cpu", "--env", "small", "--env-config",
                '{"max_steps": 8}', "--num-envs", "16", "--unroll-length",
                "4", "--num-updates", "2", "--num-minibatches", "2",
                "--ppo-epochs", "1", "--hidden-dim", "16", "--policy-groups",
                "0,1", "--log-every", "1", "--checkpoint-every", "2",
                "--checkpoint-dir", str(ckpt), "--metrics-path",
                str(tmp_path / "m.jsonl")])
    meta = json.loads((ckpt / "policy_meta.json").read_text())
    assert meta["policy_groups"] == [0, 1]
    policy = Policy.from_checkpoint(str(ckpt), device="cpu")
    assert policy.policy_groups == (0, 1)
    params = dict(policy.model.state_dict())
    assert "policies.1.hidden.0.weight" in params
    _, obs = batch.reset_batch(policy.env_cfg, env_keys(7, n=4)[1])
    acts, _ = policy.compute_actions(obs)
    logits, _ = apply(params, obs, torch.tensor((0, 1)))
    assert torch.equal(acts, first_argmax(logits, -1).to(torch.int32))
    with pytest.raises(ValueError, match="policy_groups"):
        checkpoint_policy_fn(policy.env_cfg, str(ckpt), device="cpu")

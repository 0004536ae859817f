"""The CNN-torso PPO path of the port (``arch="cnn"``) against the JAX
package, on the CPU.

Inputs come from numpy seeds and go through the JAX function and its
counterpart: the flax ``ActorCriticCNN`` against the port's through
``params_from_flax``; ``ppo_rollout_pallas(arch="cnn")`` in interpret mode
against the acting twin; ``ppo_cnn_minibatch_grads_pallas`` /
``ppo_cnn_sgd_phase_pallas`` in interpret mode (and ``jax.grad`` / optax
through flax's true convolutions) against the learner twins, on
``tests/test_sgd_cnn_kernel.py``'s inputs and at its tolerances; the JAX
trainer against the port's for 3 updates from one ``RunnerState``. On CPU
tensors the port's wrappers run their plain twins; the CUDA kernels
(K10-K12) are held against the same twins on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import (TrainConfig, medium_config, shelves_config,
                                  small_config)
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.ops.ppo_update import minibatch_epochs as j_epochs
from warehouse_tpu.pallas.act import ppo_rollout_pallas
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.pallas.sgd_cnn import (flat_cnn_tensors,
                                          ppo_cnn_minibatch_grads_pallas,
                                          ppo_cnn_sgd_phase_pallas)
from warehouse_tpu.train.ppo import make_train as j_make_train
import warehouse_tpu_torch as wt
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.evaluate import evaluate_policy
from warehouse_tpu_torch.kernels import act, sgd_cnn
from warehouse_tpu_torch.models import (ActorCriticCNN, make_model,
                                        params_from_flax)
from warehouse_tpu_torch.models.policy import apply, cnn_dims
from warehouse_tpu_torch.ops.ppo_update import first_argmax
from warehouse_tpu_torch.optim import (ClipAdam, linear_schedule,
                                       opt_state_from_optax)
from warehouse_tpu_torch.serve import Policy
from warehouse_tpu_torch.train import make_train, runner_state_from_jax
from warehouse_tpu_torch.train.__main__ import main as cli_main

from test_sgd_cnn_kernel import (CFG as J_CFG, CLIP, ENT, KL, MAXNORM, TCFG,
                                 VCOEF, D, E, H, M, _envmajor_minibatches,
                                 _kernel_inputs, _loss_fn_for, _setup)
from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch, ulps
from test_torch_sgd import assert_tree, port_inputs, tree_np


def flax_cnn(cfg, hidden, seed=0):
    model = j_make_model(cfg, arch="cnn", hidden_dim=hidden)
    params = model.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, cfg.obs_dim), jnp.float32))
    return model, params


def port_cnn(cfg, hidden, params) -> ActorCriticCNN:
    m = make_model(cfg, "cnn", hidden_dim=hidden, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return m


# ---- the model ----------------------------------------------------------------

MODEL_CONFIGS = {
    "small": (small_config(), wt.small_config()),
    "medium": (medium_config(), wt.medium_config()),
    "global": (small_config(global_obs=True), wt.small_config(global_obs=True)),
}


@pytest.mark.parametrize("name", sorted(MODEL_CONFIGS))
def test_model_matches_flax(name):
    """Logits and values within 1e-5 of flax's on seeded observations: a
    flatten in NCHW order, or a conv kernel carried over untransposed,
    passes every shape check and fails here."""
    jcfg, cfg = MODEL_CONFIGS[name]
    jm, params = flax_cnn(jcfg, 32)
    m = port_cnn(cfg, 32, params)
    obs = np.random.default_rng(0).normal(
        size=(3, 5, jcfg.obs_dim)).astype(np.float32)
    jl, jv = jm.apply(params, obs)
    with torch.no_grad():
        logits, value = m(torch.from_numpy(obs))
    assert logits.shape == (3, 5, 5) and value.shape == (3, 5)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(value.numpy(), np.asarray(jv), rtol=0,
                               atol=1e-5)
    S, chans, hidden = cnn_dims(dict(m.state_dict()))
    side = jcfg.height if jcfg.global_obs else jcfg.window_size
    assert (S, chans, hidden) == (side, (jcfg.num_obs_channels, 16, 32), 32)


def test_make_model_cnn_gates():
    """The square-grid error of the JAX ``make_model`` for global obs;
    ``num_layers`` ignored; the attention torso, once refused here, is
    built at half the hidden width (``tests/test_torch_attn.py`` holds it
    against flax)."""
    with pytest.raises(ValueError, match="square"):
        make_model(wt.small_config(global_obs=True, height=6, width=8),
                   "cnn", device="cpu")
    a = make_model(wt.small_config(), "cnn", 16, num_layers=1, device="cpu")
    b = make_model(wt.small_config(), "cnn", 16, num_layers=3, device="cpu")
    assert a.state_dict().keys() == b.state_dict().keys()
    attn = make_model(wt.small_config(), "attn", 16, device="cpu")
    assert type(attn).__name__ == "ActorCriticAttn"
    assert attn.pos_embed.shape == (25, 8)


def test_params_from_flax_cnn_shapes_and_errors():
    _, params = flax_cnn(J_CFG, H)
    p = jax.tree.map(np.asarray, params)
    sd = params_from_flax(p)
    assert sd["conv.0.weight"].shape == (16, 4, 3, 3)
    assert sd["conv.1.weight"].shape == (32, 16, 3, 3)
    assert sd["trunk.weight"].shape == (H, 25 * 32 + 6)
    assert sd["logits.weight"].shape == (5, H)
    assert sd["value.weight"].shape == (1, H)
    # Conv_i [3, 3, IC, OC] -> [OC, IC, 3, 3], element for element.
    k = p["params"]["Conv_1"]["kernel"]
    assert float(sd["conv.1.weight"][7, 3, 2, 0]) == float(k[2, 0, 3, 7])

    def broken(path, value):
        bad = jax.tree.map(lambda x: x, p)
        node = bad["params"]
        for key in path[:-1]:
            node = node[key]
        node[path[-1]] = value
        return bad

    for path, value, match in (
            (("Conv_1", "kernel"), np.zeros((3, 3, 8, 32), np.float32),
             "Conv_1"),
            (("Conv_0", "kernel"), np.zeros((5, 5, 4, 16), np.float32),
             "Conv_0"),
            (("Conv_0", "bias"), np.zeros(3, np.float32), "Conv_0"),
            (("Dense_0", "kernel"), np.zeros((805, H), np.float32),
             "square grid"),
            (("Dense_1", "kernel"), np.zeros((H + 1, 5), np.float32),
             "input width"),
            (("Dense_2", "kernel"), np.zeros((H, 2), np.float32),
             "Dense_2")):
        with pytest.raises(ValueError, match=match):
            params_from_flax(broken(path, value))
    extra = jax.tree.map(lambda x: x, p)
    extra["params"]["Dense_3"] = extra["params"]["Dense_2"]
    with pytest.raises(ValueError, match="not a CNN"):
        params_from_flax(extra)
    with pytest.raises(ValueError):  # neither MLP, recurrent nor CNN
        params_from_flax({"params": {"Embed_0": {"embedding": np.zeros(3)}}})


def test_cnn_init_statistics():
    """flax's distributions, not its bits: convs and trunk lecun-normal
    (variance 1 / fan_in, truncated at two standard deviations), zero
    biases, orthogonal heads of gain 0.01 and 1.0."""
    m = make_model(wt.medium_config(), "cnn", 128,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    sd = m.state_dict()
    for key, tol in (("conv.0.weight", 0.15), ("conv.1.weight", 0.05),
                     ("trunk.weight", 0.02)):
        w = sd[key]
        fan_in = w[0].numel()
        assert float(w.var()) * fan_in == pytest.approx(1.0, abs=tol), key
        # truncated at 2 sigma of the untruncated normal
        assert float(w.abs().max()) <= 2.0 / 0.87962566 / math.sqrt(fan_in)
        assert abs(float(w.mean())) < 3.0 / math.sqrt(fan_in * w.numel())
    assert all(float(v.abs().max()) == 0.0 for k, v in sd.items()
               if k.endswith(".bias"))
    for key, gain in (("logits.weight", 0.01), ("value.weight", 1.0)):
        w = sd[key]
        torch.testing.assert_close(w @ w.t(), gain ** 2 * torch.eye(len(w)),
                                   rtol=1e-4, atol=1e-8)
    again = make_model(wt.medium_config(), "cnn", 128,
                       generator=torch.Generator().manual_seed(0),
                       device="cpu").state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


# ---- acting: the twin against the Pallas kernel's CNN arm -----------------------

ACT_B, ACT_T, ACT_H = 32, 4, 32
ACT_CONFIGS = {
    False: (small_config(max_steps=ACT_T), wt.small_config(max_steps=ACT_T)),
    # A walled layout (interpret-mode Pallas on the 6-agent preset takes
    # minutes to compile on the CPU).
    True: (shelves_config(max_steps=ACT_T, num_agents=3, queue_capacity=6,
                          init_requests=3),
           wt.shelves_config(max_steps=ACT_T, num_agents=3, queue_capacity=6,
                             init_requests=3)),
}


@pytest.fixture(scope="module", params=[False, True],
                ids=["unmasked", "masked"])
def act_setup(request):
    mask_on = request.param
    jcfg, cfg = ACT_CONFIGS[mask_on]
    _, params = flax_cnn(jcfg, ACT_H, seed=1)
    m = port_cnn(cfg, ACT_H, params)
    jk, tk = env_keys(3, n=ACT_B)
    js, _ = jbatch.reset_batch(jcfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    out = ppo_rollout_pallas(jcfg, params, js, ACT_T, jax.random.PRNGKey(7),
                             block=ACT_B, interpret=True,
                             mask_actions=mask_on, arch="cnn")
    return mask_on, jcfg, cfg, m, ts, out


def test_act_twin_with_jax_gumbel_bit_exact(act_setup):
    """Env state, obs, rewards, deliveries (and the mask) bit-equal,
    actions equal, log-probs and values within 1e-5."""
    mask_on, jcfg, cfg, m, ts, (j_new, j_roll, _, _) = act_setup
    A = cfg.num_agents
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, ACT_T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), ACT_T,
                                      (5, ACT_B * A))
    mask = (torch.zeros(ACT_T, ACT_B, A, 5, dtype=torch.bool) if mask_on
            else None)
    act.act_cnn_steps.launches = 0
    new, obs, action, lp, value, reward, delivered = act.act_cnn_steps(
        cfg, m, ts, u, pick, drop, to_torch(g), mask=mask)
    assert act.act_cnn_steps.launches == 0  # the twin ran on the CPU
    if mask_on:
        assert_bits(j_roll.mask, mask, "mask")
        assert not bool(mask.all())
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-5)


def test_act_wrapper_keys_and_reference(act_setup):
    """``ppo_rollout(arch="cnn")``: the wrapper's keys, step counter and
    truncation flags are the JAX wrapper's bit for bit; on the CPU it is
    its own reference; the arch has to fit the model."""
    mask_on, jcfg, cfg, m, ts, (j_new, j_roll, j_rk, j_nk) = act_setup
    kw = dict(mask_actions=mask_on, arch="cnn")
    new, roll, rk, nk = act.ppo_rollout(cfg, m, ts, ACT_T, rng.prng_key(7),
                                        **kw)
    assert_bits(j_rk, rk, "reset_key_last")
    assert_bits(j_nk, nk, "next key")
    assert_bits(j_new.t, new.t, "t")
    assert_bits(j_new.key, new.key, "key")
    assert_bits(j_roll.truncated, roll.truncated, "truncated")
    assert_bits(j_roll.mask, roll.mask, "mask")
    ref = act.ppo_rollout_reference(cfg, m, ts, ACT_T, rng.prng_key(7), **kw)
    for x, y in zip(roll, ref[1]):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="does not fit"):
        act.ppo_rollout(cfg, m, ts, ACT_T, rng.prng_key(7))
    mlp = make_model(cfg, hidden_dim=ACT_H, device="cpu")
    with pytest.raises(ValueError, match="does not fit"):
        act.ppo_rollout(cfg, mlp, ts, ACT_T, rng.prng_key(7), arch="cnn")
    # Groups take a MultiPolicyActorCritic (test_torch_cnn_groups.py).
    with pytest.raises(ValueError, match="policy_groups"):
        act.ppo_rollout(cfg, m, ts, ACT_T, rng.prng_key(7), arch="cnn",
                        policy_groups=(0,) * cfg.num_agents)


# ---- the learner twins against the Pallas kernels --------------------------------

@pytest.mark.parametrize("t0", [0, ACT_T], ids=["truncating", "mid_episode"])
def test_shaped_act_twin_with_jax_gumbel(t0):
    """The CNN arm with ``mask_actions`` and ``shaping_coef=0.02`` on the
    walled layout, a chunk that ends with the episode and one in its
    middle: env state, obs, actions, mask, deliveries and the raw reward
    bit-equal to the Pallas kernel in interpret mode; the shaped reward
    bit-equal to the twin's formula on the raw reward and potentials, and
    within 4 ulp of the kernel (XLA:CPU contracts the shaping into FMAs;
    ``tests/test_torch_act.py`` measured at most 3)."""
    from warehouse_tpu_torch.ops.pathing import potential

    coef, gamma = 0.02, 0.99
    jcfg, cfg = (c.replace(max_steps=ACT_T + t0) for c in ACT_CONFIGS[True])
    A = cfg.num_agents
    _, params = flax_cnn(jcfg, ACT_H, seed=1)
    m = port_cnn(cfg, ACT_H, params)
    jk, tk = env_keys(8, n=ACT_B)
    js, _ = jbatch.reset_batch(jcfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    js, ts = js.replace(t=js.t + t0), ts.replace(t=ts.t + t0)
    j_new, j_roll, _, _ = ppo_rollout_pallas(
        jcfg, params, js, ACT_T, jax.random.PRNGKey(7), block=ACT_B,
        interpret=True, mask_actions=True, shaping_coef=coef, gamma=gamma,
        arch="cnn")
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, ACT_T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), ACT_T,
                                      (5, ACT_B * A))
    mask = torch.zeros(ACT_T, ACT_B, A, 5, dtype=torch.bool)
    done = to_torch(j_roll.truncated).to(torch.float32)
    assert bool(done[-1].all()) and not bool(done[:-1].any())
    shaping = act.Shaping(coef, gamma, done,
                          torch.zeros(ACT_T, ACT_B, A))
    new, obs, action, lp, value, reward, delivered = act.act_cnn_steps(
        cfg, m, ts, u, pick, drop, to_torch(g), mask=mask, shaping=shaping)
    for name, want, got in (("obs", j_roll.obs, obs),
                            ("action", j_roll.action, action),
                            ("mask", j_roll.mask, mask),
                            ("delivered", j_roll.delivered, delivered),
                            ("raw reward", j_roll.raw_reward,
                             shaping.raw_reward)):
        assert_bits(want, got, name)
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    s, f32 = ts, np.float32
    for t in range(ACT_T):
        phi_pre = potential(cfg, s).numpy()
        s, _ = batch.step_batch(cfg, s, action[t])
        term = f32(gamma) * potential(cfg, s).numpy()
        term = term * (f32(1.0) - done[t].numpy())[:, None] - phi_pre
        want = shaping.raw_reward[t].numpy() + f32(coef) * term
        np.testing.assert_array_equal(want.view(np.int32),
                                      reward[t].numpy().view(np.int32))
    assert int(ulps(j_roll.reward, reward.numpy()).max()) <= 4
    # The wrapper: the same chunk from its own draws, twin == CPU path.
    a = act.ppo_rollout(cfg, m, ts, ACT_T, rng.prng_key(7), arch="cnn",
                        mask_actions=True, shaping_coef=coef, gamma=gamma)[1]
    assert_bits(j_roll.truncated, a.truncated, "truncated")
    assert not torch.equal(a.reward, a.raw_reward)
    plain = act.ppo_rollout(cfg, m, ts, ACT_T, rng.prng_key(7), arch="cnn",
                            mask_actions=True)[1]
    assert plain.raw_reward is plain.reward
    assert torch.equal(a.raw_reward, plain.reward)


def cnn_port_inputs(params, opt_state, data):
    p0, traj, adv_n, tgt = port_inputs(params, opt_state, data)
    return p0, opt_state_from_optax(jax.tree.map(np.asarray, opt_state)), \
        traj, adv_n, tgt


@pytest.mark.parametrize("mask_on", [False, True])
def test_cnn_minibatch_grads_twin_matches_pallas_and_jax_grad(mask_on):
    model, params, _tx, _sched, opt_state, data = _setup(mask_on, seed=3)
    mbs = _envmajor_minibatches(data)
    loss_fn = _loss_fn_for(model, mask_on)
    obs_bm, fields = _kernel_inputs(data)
    p0, _, traj, adv_n, tgt = cnn_port_inputs(params, opt_state, data)
    sgd_cnn.ppo_cnn_minibatch_grads.launches = 0
    for mb in range(M):
        ref_mb = jax.tree.map(lambda x: x[mb], mbs)
        jax_grad = jax.value_and_grad(loss_fn, has_aux=True)(params, ref_mb)
        pallas = ppo_cnn_minibatch_grads_pallas(
            params, obs_bm, fields, mb, ENT, KL, env_cfg=J_CFG, tcfg=TCFG,
            num_minibatches=M, clip_eps=CLIP, value_coef=VCOEF,
            mask_actions=mask_on, obs_dim=D, block_envs=8, interpret=True)
        (l_t, aux_t), g_t = sgd_cnn.ppo_cnn_minibatch_grads(
            p0, traj, adv_n, tgt, mb, ENT, KL, num_minibatches=M,
            clip_eps=CLIP, value_coef=VCOEF, mask_actions=mask_on)
        for (l_r, aux_r), g_r in (jax_grad, pallas):
            for a, b in zip((l_t, *aux_t), (l_r, *aux_r)):
                assert abs(float(a) - float(b)) < 1e-6
            assert_tree(g_t, g_r, 1e-4, 1e-6, f"grads mb={mb}")
    assert sgd_cnn.ppo_cnn_minibatch_grads.launches == 0  # the CPU's twin


@pytest.mark.parametrize("mask_on", [False, True])
def test_cnn_sgd_phase_twin_matches_pallas_and_xla(mask_on):
    model, params, tx, sched, opt_state, data = _setup(mask_on)
    n_steps = E * M
    p_x, opt_x, _, l_x = j_epochs(
        params, opt_state, jax.random.PRNGKey(2),
        loss_fn=_loss_fn_for(model, mask_on),
        make_minibatches=lambda _k: _envmajor_minibatches(data),
        num_epochs=E, tx=tx, reshuffle_each_epoch=False)
    steps = jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_p, opt_p, l_p = ppo_cnn_sgd_phase_pallas(
        params, opt_state, *_kernel_inputs(data),
        jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
        1.0 - 0.999 ** cnt, ENT, KL, env_cfg=J_CFG, tcfg=TCFG, num_epochs=E,
        num_minibatches=M, clip_eps=CLIP, value_coef=VCOEF,
        max_grad_norm=MAXNORM, mask_actions=mask_on, obs_dim=D, block_envs=8,
        rows_per_block=4, interpret=True)

    p0, opt0, traj, adv_n, tgt = cnn_port_inputs(params, opt_state, data)
    rows = ClipAdam(linear_schedule(3e-4, 0.0, 100), MAXNORM).step_rows(
        opt0.count, n_steps)
    sgd_cnn.ppo_cnn_sgd_phase.launches = 0
    p_t, opt_t, l_t = sgd_cnn.ppo_cnn_sgd_phase(
        p0, opt0, traj, adv_n, tgt, *rows, ENT, KL, num_epochs=E,
        num_minibatches=M, clip_eps=CLIP, value_coef=VCOEF,
        max_grad_norm=MAXNORM, mask_actions=mask_on)
    assert sgd_cnn.ppo_cnn_sgd_phase.launches == 0  # the twin ran on the CPU
    assert opt_t.count == n_steps
    for p_ref, opt_ref, l_ref in ((p_x, opt_x, l_x), (p_p, opt_p, l_p)):
        for a, b in zip(l_t, l_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=2e-6)
        assert_tree(p_t, p_ref, 1e-5, 1e-6, "params")
        count, mu, nu = find_adam_state(opt_ref)
        assert int(count) == n_steps
        assert_tree(opt_t.mu, mu, 1e-5, 1e-7, "mu")
        assert_tree(opt_t.nu, nu, 1e-5, 1e-10, "nu")


def test_cnn_learner_takes_only_cnn_params():
    mlp = dict(make_model(wt.small_config(), hidden_dim=H,
                          device="cpu").state_dict())
    _, params, _, _, opt_state, data = _setup(False)
    _, _, traj, adv_n, tgt = cnn_port_inputs(params, opt_state, data)
    with pytest.raises(ValueError, match="ActorCriticCNN"):
        sgd_cnn.ppo_cnn_minibatch_grads(
            mlp, traj, adv_n, tgt, 0, ENT, KL, num_minibatches=M,
            clip_eps=CLIP, value_coef=VCOEF, mask_actions=False)


def test_pack_cnn_is_a_bijection_and_matches_flat_cnn_tensors():
    """``pack_cnn``: every parameter once, ``unpack_cnn`` its inverse, and
    its conv segments the ``[9 OC, IC]`` relayout of
    ``pallas/sgd_cnn.py`` ``flat_cnn_tensors`` (whose head is padded to 8
    rows, which the port's is not)."""
    _, params = flax_cnn(J_CFG, H, seed=2)
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    flat = act.pack_cnn(sd)
    assert flat.numel() == sum(v.numel() for v in sd.values())
    back = act.unpack_cnn(flat, sd)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    # A permutation: distinct values land in distinct slots.
    marks = act.unpack_cnn(torch.arange(flat.numel(), dtype=torch.float32),
                           sd)
    seen = torch.cat([v.reshape(-1) for v in marks.values()])
    assert torch.equal(seen.sort().values,
                       torch.arange(flat.numel(), dtype=torch.float32))
    wc0, bc0, wc1, bc1, wt_, bt, wh, bh = (
        np.asarray(x) for x in flat_cnn_tensors(params))
    want = np.concatenate([wc0.ravel(), bc0.ravel(), wc1.ravel(),
                           bc1.ravel(), wt_.ravel(), bt.ravel(),
                           wh[:6].ravel(), bh[:6].ravel()])
    np.testing.assert_array_equal(flat.numpy(), want)
    assert act.cnn_kernel_dims(sd, D) == (5, 4, 16, 32, H)
    with pytest.raises(ValueError, match="two convs"):
        act.cnn_kernel_dims(sd, D + 1)


# ---- the trainer ---------------------------------------------------------------

TRAIN_CFG = small_config(max_steps=8)
TRAIN_BASE = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                         num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                         mask_actions=True, kl_coeff=0.1)


def test_cnn_train_steps_match_jax_trainer():
    """3 updates from one ``RunnerState``: the JAX trainer on its fused
    CNN acting and learner kernels (interpret mode; the configuration of
    its own ``test_trainer_grad_backend_equivalence_cnn_sgd``) against the
    port on the CPU. Env state bit-equal, so no action flipped; metrics
    within 2e-4 + 1e-3 relative; params rtol 2e-4 / atol 5e-5."""
    jtr = j_make_train(TRAIN_CFG, TRAIN_BASE.replace(
        rollout_backend="pallas", grad_backend="pallas", pallas_block=16,
        pallas_interpret=True), arch="cnn")
    tr = make_train(wt.small_config(max_steps=8),
                    wt.TrainConfig(**{f: getattr(TRAIN_BASE, f) for f in (
                        "num_envs", "unroll_length", "num_updates",
                        "num_minibatches", "ppo_epochs", "hidden_dim",
                        "mask_actions", "kl_coeff")}),
                    arch="cnn", device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    assert rs.params.keys() == tr.model.state_dict().keys()
    assert rs.opt_state.count == 0 and rs.opt_state.mu.keys() == rs.params.keys()
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
    assert int(rs.update_idx) == 3
    assert rs.opt_state.count == 3 * 2 * 2
    want = tree_np(jrs.params)
    for k, v in want.items():
        np.testing.assert_allclose(rs.params[k].numpy(), v, rtol=2e-4,
                                   atol=5e-5, err_msg=k)
    _, mu, _ = find_adam_state(jrs.opt_state)
    assert_tree(rs.opt_state.mu, mu, 2e-4, 5e-6, "mu")


def test_shaped_cnn_train_steps_match_jax_trainer():
    """``mask_actions=True, shaping_coef=0.02`` on a walled layout with
    ``max_steps = 2 * unroll_length``, so the 3 updates cross an episode
    boundary: the JAX trainer on its XLA route (which shapes on the
    auto-reset state and cuts the next potential by ``1 - done``) against
    the port's CNN trainer on the CPU (which shapes on the pre-reset state
    inside the acting twin). Env state and keys bit-equal, metrics and
    params at the tolerances of the test above."""
    walls = dict(height=5, width=5, num_agents=2, queue_capacity=4,
                 init_requests=2, spawn_prob=0.5, walls=(10, 11, 13, 14),
                 max_steps=8)
    fields = dict(num_envs=16, unroll_length=4, num_updates=3,
                  num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                  mask_actions=True, kl_coeff=0.1, shaping_coef=0.02)
    from warehouse_tpu.config import EnvConfig as JEnvConfig

    jtr = j_make_train(JEnvConfig(**walls), TrainConfig(
        **fields, rollout_backend="xla", grad_backend="xla"), arch="cnn")
    tr = make_train(wt.EnvConfig(**walls), wt.TrainConfig(**fields),
                    arch="cnn", device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    for u in range(3):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    assert int(rs.env_state.t[0]) == 4  # 12 steps: one boundary crossed
    want = tree_np(jrs.params)
    for k, v in want.items():
        np.testing.assert_allclose(rs.params[k].numpy(), v, rtol=2e-4,
                                   atol=5e-5, err_msg=k)


def test_cnn_trainer_gates_and_plain_step():
    cfg = wt.small_config(max_steps=8)
    tcfg = wt.TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                          num_minibatches=2, ppo_epochs=2, hidden_dim=16)
    # Policy groups are ported (test_torch_cnn_groups.py): K10 acts, the
    # learner is plain, as the JAX trainer's fused CNN learner refuses them.
    grouped = make_train(cfg, tcfg, arch="cnn", policy_groups=(0, 1),
                         device="cpu")
    assert all(isinstance(m, ActorCriticCNN) for m in grouped.model.policies)
    assert grouped.backends == {"rollout": "plain", "grad": "plain"}
    # global_obs is ported: the CNN's grid becomes the whole 5 x 5 map with
    # 5 channels (held against the JAX trainer in test_torch_global_obs.py).
    wide = make_train(cfg.replace(global_obs=True), tcfg, arch="cnn",
                      device="cpu")
    assert wide.model.state_dict()["conv.0.weight"].shape == (16, 5, 3, 3)
    with pytest.raises(ValueError, match="square grid"):
        make_train(cfg.replace(global_obs=True, width=6), tcfg, arch="cnn",
                   device="cpu")
    tr = make_train(cfg, tcfg, arch="cnn", device="cpu")
    assert isinstance(tr.model, ActorCriticCNN)
    rs0 = tr.init(rng.prng_key(1))
    assert rs0.params.keys() == tr.model.state_dict().keys()
    rs, ms = tr.train_many(rs0, 2)
    assert int(rs.update_idx) == 2
    assert all(v.shape == (2,) and bool(torch.isfinite(v).all())
               for v in ms.values())
    assert any(not torch.equal(rs.params[k], rs0.params[k])
               for k in rs.params)
    a, ma = tr.train_step(rs0)
    b, mb = tr.plain_step(rs0)
    assert torch.equal(a.env_state.agent_pos, b.env_state.agent_pos)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)


# ---- entry points --------------------------------------------------------------

def test_cli_trains_cnn_on_the_cpu(tmp_path):
    path = tmp_path / "metrics.jsonl"
    cli_main(["--arch", "cnn", "--cpu", "--env", "small", "--env-config",
              '{"max_steps": 8}', "--num-envs", "16", "--unroll-length", "4",
              "--num-updates", "2", "--num-minibatches", "2", "--ppo-epochs",
              "2", "--hidden-dim", "16", "--log-every", "1", "--eval-every",
              "2", "--eval-episodes", "4", "--metrics-path", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["meta"] and recs[0]["arch"] == "cnn"
    assert recs[0]["device"] == "cpu" and recs[0]["kernels"] is False
    steps = [r for r in recs[1:] if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(math.isfinite(r["loss"]) and r["env_steps_per_sec"] > 0
               for r in steps)
    assert any("eval_mean_episode_return" in r for r in recs)


@pytest.mark.parametrize("flags", [["--algo", "impala", "--arch", "cnn"],
                                   ["--arch", "cnn", "--policy-groups",
                                    "0,1", "--eval-every", "1"]])
def test_cli_cnn_exits_on_unported_combinations(flags, tmp_path):
    """``--arch cnn --policy-groups`` with ``--eval-every`` still exits (the
    evaluation takes a shared policy); ``--algo impala --arch cnn``, once
    refused here, runs an update: both phases plain, acting per step, as
    the JAX trainer sends both to XLA."""
    path = tmp_path / "m.jsonl"
    if "impala" in flags:
        cli_main(["--num-envs", "16", "--cpu", "--env", "small",
                  "--unroll-length", "4", "--num-updates", "1",
                  "--num-minibatches", "2", "--hidden-dim", "16",
                  "--metrics-path", str(path), *flags])
        meta = json.loads(path.read_text().splitlines()[0])
        assert meta["arch"] == "cnn" and meta["backends"] == {
            "rollout": "step", "grad": "plain"}
        return
    with pytest.raises(SystemExit) as e:
        cli_main(["--num-envs", "16", "--cpu", "--metrics-path", str(path),
                  *flags])
    assert e.value.code not in (0, None)


def test_serve_and_evaluate_take_a_cnn_model():
    cfg = wt.small_config()
    m = make_model(cfg, "cnn", 16, generator=torch.Generator().manual_seed(3),
                   device="cpu")
    policy = Policy(cfg, m)
    assert policy.arch == "cnn" and policy.initial_state(4) is None
    obs = torch.from_numpy(np.random.default_rng(1).normal(
        size=(6, cfg.num_agents, cfg.obs_dim)).astype(np.float32))
    acts, carry = policy.compute_actions(obs)
    with torch.no_grad():
        logits, _ = m(obs)
    assert carry is None and acts.dtype == torch.int32
    assert torch.equal(acts, first_argmax(logits, -1).to(torch.int32))
    one = policy.compute_single_action(obs[0])[0]
    assert one.shape == (cfg.num_agents,)
    sampled, _ = policy.compute_actions(obs, explore=True, seed=5)
    again, _ = policy.compute_actions(obs, explore=True, seed=5)
    assert torch.equal(sampled, again)
    with pytest.raises(ValueError, match="does not fit"):
        Policy(cfg, m, arch="mlp")
    with pytest.raises(ValueError, match="policy_groups"):
        Policy(cfg, m, policy_groups=(0, 1))  # one CNN, not a group's

    params = dict(m.state_dict())
    ev = evaluate_policy(
        cfg, lambda state, obs, key: first_argmax(
            apply(params, obs)[0], -1).to(torch.int32), 4, seed=2,
        device="cpu")
    assert ev["episodes"] == 4
    assert all(math.isfinite(v) for v in ev.values())

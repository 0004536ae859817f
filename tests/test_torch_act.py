"""K2, the act phase (warehouse_tpu_torch/kernels/act.py), on the CPU.

The flax model's weights go to the torch model through
``params_from_flax``; ``ppo_rollout_pallas`` runs in interpret mode. On
CPU tensors the port runs its plain twin. With the JAX gumbel stream fed
in, obs, actions, rewards, deliveries and the final state are
bit-equal, values within 1e-5 and log-probs within 1e-4 (f32 sums in
another order, and torch's exp/log/tanh against XLA's). The wrapper's
own keys are bit-exact. With ``shaping_coef`` the shaped reward is
bit-equal to the formula's float32 operation order evaluated in numpy and
to the Pallas kernel in interpret mode, the raw reward rides beside it.
The CUDA kernel is checked on the card by test_torch_kernels_gpu.py and
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import (medium_config, shelves_config,
                                  small_config)
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.pallas.act import ppo_rollout_pallas
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels.act import (Shaping, act_steps,
                                             ppo_rollout,
                                             ppo_rollout_reference)
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.ops.move import valid_action_mask
from warehouse_tpu_torch.ops.pathing import potential

from test_torch_env import assert_state, env_keys
from test_torch_rng import assert_bits, to_torch, ulps

B, T, HIDDEN = 64, 4, 32
CFG = small_config(max_steps=T)  # the chunk ends with the episode


def port_model(params):
    m = make_model(CFG, hidden_dim=HIDDEN, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return m


@pytest.fixture(scope="module")
def setup():
    jm = j_make_model(CFG, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, CFG.obs_dim)))
    jk, tk = env_keys(0, n=B)
    js, jobs = jbatch.reset_batch(CFG, jk)
    ts, tobs = batch.reset_batch(CFG, tk)
    out = ppo_rollout_pallas(CFG, params, js, T, jax.random.PRNGKey(7),
                             block=B, interpret=True)
    return jm, params, port_model(params), js, ts, out


def test_with_jax_gumbel_bit_exact(setup):
    jm, params, m, js, ts, (j_new, j_roll, _, _) = setup
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, CFG, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), T,
                                      (5, B * CFG.num_agents))
    new, obs, action, lp, value, reward, delivered = act_steps(
        CFG, m, ts, u, pick, drop, to_torch(g))
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-4)


def test_wrapper_outputs_and_keys(setup):
    jm, params, m, js, ts, (j_new, j_roll, j_rk, j_nk) = setup
    new, roll, rk, nk = ppo_rollout(CFG, m, ts, T, rng.prng_key(7))
    assert_bits(j_rk, rk, "reset_key_last")
    assert_bits(j_nk, nk, "next key")
    assert_bits(j_new.t, new.t, "t")
    assert_bits(j_new.key, new.key, "key")
    for f in ("truncated", "mask"):
        assert_bits(getattr(j_roll, f), getattr(roll, f), f)
    assert torch.equal(roll.raw_reward, roll.reward)
    # Own gumbel stream: the sampled action is JAX's wherever the top-two
    # gap of logits + gumbel is wider than the gumbel's tolerance.
    logits, _ = jm.apply(params, j_roll.obs)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), T,
                                      (5, B * CFG.num_agents))
    z = np.asarray(logits).reshape(T, -1, 5) + np.asarray(g).transpose(0, 2, 1)
    top2 = np.sort(z, -1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0] > 1e-4).reshape(T, B, -1)
    same = np.asarray(j_roll.action) == roll.action.numpy()
    assert (same | ~clear).all()


def test_twin_is_the_cpu_path(setup):
    _, _, m, _, ts, _ = setup
    a = ppo_rollout(CFG, m, ts, T, rng.prng_key(3))
    b = ppo_rollout_reference(CFG, m, ts, T, rng.prng_key(3))
    assert_state(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def test_boundary_reset_matches_autoreset_path(setup):
    """reset_truncated_batch on the rollout's output == stepping the last
    tick with step_autoreset_batch, and == the JAX boundary reset."""
    _, _, m, js, ts, (j_new, _, j_rk, _) = setup
    new, roll, rk, _ = ppo_rollout(CFG, m, ts, T, rng.prng_key(7))
    reset_state, reset_obs, done = batch.reset_truncated_batch(CFG, new, rk)
    assert bool(done.all())

    s = ts
    for t in range(T - 1):
        s, _ = batch.step_batch(CFG, s, roll.action[t])
    s2, tstep = batch.step_autoreset_batch(CFG, s, roll.action[T - 1])
    for f in STATE_FIELDS:
        assert torch.equal(getattr(s2, f), getattr(reset_state, f)), f
    assert torch.equal(tstep.obs, reset_obs)

    j_state, j_obs, _ = jbatch.reset_truncated_batch(CFG, j_new, j_rk)
    assert_state(j_state, reset_state, "vs JAX")
    assert_bits(j_obs, reset_obs, "obs vs JAX")


@pytest.mark.parametrize("option", [
    {"policy_groups": (0, 1), "arch": "attn"}, {"arch": "attn"}])
def test_unsupported_options_raise(setup, option):
    """Policy groups are ported for the MLP (test_torch_groups.py) and the
    CNN (test_torch_cnn_groups.py); the attention torso raises, with groups
    or without."""
    _, _, m, _, ts, _ = setup
    with pytest.raises(NotImplementedError):
        ppo_rollout(CFG, m, ts, T, rng.prng_key(0), **option)


def test_global_obs_and_auto_reset_raise(setup):
    """``global_obs`` is ported (held against the Pallas kernel's global
    view in test_torch_global_obs.py): the rollout returns the engine's
    global observations; a model of the ego width does not fit them;
    ``auto_reset`` still raises."""
    _, _, m, _, ts, _ = setup
    cfg = CFG.replace(global_obs=True)
    wide = make_model(cfg, hidden_dim=HIDDEN, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    _, roll, _, _ = ppo_rollout(cfg, wide, ts, T, rng.prng_key(0))
    assert roll.obs.shape[-1] == cfg.obs_dim == 5 * 25 + 6
    assert torch.equal(roll.obs[0], batch.observe_batch(cfg, ts))
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        ppo_rollout(cfg, m, ts, T, rng.prng_key(0))
    with pytest.raises(ValueError, match="auto_reset"):
        ppo_rollout(CFG.replace(auto_reset=True), m, ts, T, rng.prng_key(0))


def test_params_from_flax_checks_shapes(setup):
    _, params, _, _, _, _ = setup
    p = jax.tree.map(np.asarray, params)
    sd = params_from_flax(p)
    assert sd["hidden.0.weight"].shape == (HIDDEN, CFG.obs_dim)
    assert sd["value.weight"].shape == (1, HIDDEN)
    bad = jax.tree.map(lambda x: x, p)
    bad["params"]["Dense_1"]["kernel"] = np.zeros((HIDDEN + 1, HIDDEN),
                                                  np.float32)
    with pytest.raises(ValueError, match="input width"):
        params_from_flax(bad)
    bad = jax.tree.map(lambda x: x, p)
    bad["params"]["Dense_3"]["bias"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="Dense_3"):
        params_from_flax(bad)



# ---- the action-masking option ---------------------------------------------

WALLED = shelves_config(max_steps=T, num_agents=3, queue_capacity=6,
                        init_requests=3)


@pytest.fixture(scope="module")
def masked_setup():
    """A walled layout, masking on, through ``ppo_rollout_pallas``."""
    jm = j_make_model(WALLED, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, WALLED.obs_dim)))
    m = make_model(WALLED, hidden_dim=HIDDEN, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    jk, tk = env_keys(2, n=B)
    js, _ = jbatch.reset_batch(WALLED, jk)
    ts, _ = batch.reset_batch(WALLED, tk)
    out = ppo_rollout_pallas(WALLED, params, js, T, jax.random.PRNGKey(9),
                             block=B, interpret=True, mask_actions=True)
    return m, ts, out


def test_masked_twin_with_jax_gumbel_bit_exact(masked_setup):
    """The twin with masking against the Pallas kernel's mask option
    (``pallas/act.py:415-428``): obs, actions, rewards, deliveries, final
    state and mask bit-equal; values and log-probs as above."""
    m, ts, (j_new, j_roll, _, _) = masked_setup
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, WALLED, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T,
                                      (5, B * WALLED.num_agents))
    mask = torch.zeros(T, B, WALLED.num_agents, 5, dtype=torch.bool)
    new, obs, action, lp, value, reward, delivered = act_steps(
        WALLED, m, ts, u, pick, drop, to_torch(g), mask=mask)
    assert_bits(j_roll.mask, mask, "mask")
    assert not bool(mask.all())  # the walls and edges masked some moves
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-4)


def test_masked_wrapper_samples_only_valid_moves(masked_setup):
    """``ppo_rollout(mask_actions=True)``: the mask is valid_action_mask
    of the pre-tick positions, no sampled action is masked, and the
    log-probs are the masked log-softmax's (finite)."""
    m, ts, (_, j_roll, _, _) = masked_setup
    new, roll, _, _ = ppo_rollout(WALLED, m, ts, T, rng.prng_key(9),
                                  mask_actions=True)
    assert_bits(j_roll.mask, roll.mask, "mask")
    s = ts
    for t in range(T):
        assert torch.equal(roll.mask[t], valid_action_mask(WALLED,
                                                           s.agent_pos))
        assert bool(roll.mask[t].gather(
            -1, roll.action[t].long()[..., None]).all())
        s, _ = batch.step_batch(WALLED, s, roll.action[t])
    assert bool(torch.isfinite(roll.log_prob).all())
    plain = ppo_rollout(WALLED, m, ts, T, rng.prng_key(9))[1]
    assert bool(plain.mask.all())


# ---- the potential-shaping option -------------------------------------------

COEF, GAMMA = 0.02, 0.99
SB = 32
# Interpret mode runs the Pallas kernel through XLA:CPU, which contracts the
# shaping's products and sums into FMAs: 12-20% of the shaped rewards are off
# the unfused spec order, by at most 3 ulp on medium and 2 on the walled
# layout (the sum cancels, so half an ulp of a product is ulps of the
# result). The port keeps the spec order, as it does for the greedy reward
# sum.
SHAPED_ULP = 4
# (config, the step counter the chunk starts from): a chunk that ends with
# the episode on the walled layout, one in the middle of an episode, and
# the open medium floor (the table is the Manhattan distance there).
SHAPED_CASES = {
    "walled_truncating": (WALLED, 0),
    "walled_mid_episode": (WALLED.replace(max_steps=3 * T), T),
    "medium_truncating": (medium_config(max_steps=2 * T), T),
}


def shaped_spec(cfg, ts, roll_action, raw, done):
    """The shaped reward in the formula's order, each operation rounded to
    float32 by numpy: the plain engine replays the actions and
    ``ops.pathing.potential`` reads each state."""
    f = np.float32
    s, out = ts, []
    for t in range(roll_action.shape[0]):
        phi_pre = potential(cfg, s).numpy()
        s, _ = batch.step_batch(cfg, s, roll_action[t])
        term = f(GAMMA) * potential(cfg, s).numpy()
        term = term * (f(1.0) - done[t].numpy().astype(f))[:, None]
        term = term - phi_pre
        out.append(raw[t].numpy() + f(COEF) * term)
    return np.stack(out)


@pytest.fixture(scope="module", params=sorted(SHAPED_CASES))
def shaped_setup(request):
    """``ppo_rollout_pallas(mask_actions=True, shaping_coef=0.02)`` in
    interpret mode and the port's wrapper on the same start state."""
    cfg, t0 = SHAPED_CASES[request.param]
    jm = j_make_model(cfg, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, cfg.obs_dim)))
    m = make_model(cfg, hidden_dim=HIDDEN, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    jk, tk = env_keys(5, n=SB)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    js = js.replace(t=js.t + t0)
    ts = ts.replace(t=ts.t + t0)
    out = ppo_rollout_pallas(cfg, params, js, T, jax.random.PRNGKey(9),
                             block=SB, interpret=True, mask_actions=True,
                             shaping_coef=COEF, gamma=GAMMA)
    return request.param, cfg, m, ts, out


def test_shaped_twin_with_jax_gumbel(shaped_setup):
    """The shaped twin on the JAX gumbel stream: dynamics, obs, actions,
    mask and raw reward bit-equal to the Pallas kernel; the shaped reward
    bit-equal to the numpy float32 spec order and within ``SHAPED_ULP`` of
    the kernel in interpret mode."""
    name, cfg, m, ts, (j_new, j_roll, _, _) = shaped_setup
    A = cfg.num_agents
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T, (5, SB * A))
    mask = torch.zeros(T, SB, A, 5, dtype=torch.bool)
    done = to_torch(j_roll.truncated).to(torch.float32)
    shaping = Shaping(COEF, GAMMA, done, torch.zeros(T, SB, A))
    new, obs, action, lp, value, reward, delivered = act_steps(
        cfg, m, ts, u, pick, drop, to_torch(g), mask=mask, shaping=shaping)
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.mask, mask, "mask")
    assert_bits(j_roll.delivered, delivered, "delivered")
    assert_bits(j_roll.raw_reward, shaping.raw_reward, "raw reward")
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    spec = shaped_spec(cfg, ts, action, shaping.raw_reward, done)
    np.testing.assert_array_equal(spec.view(np.int32),
                                  reward.numpy().view(np.int32))
    off = ulps(j_roll.reward, reward.numpy())
    assert int(off.max()) <= SHAPED_ULP, int(off.max())
    assert not torch.equal(reward, shaping.raw_reward)
    assert bool(done[-1].all()) == name.endswith("truncating")
    assert not bool(done[:-1].any())


def test_shaped_wrapper_returns_shaped_and_raw_reward(shaped_setup):
    """``ppo_rollout(shaping_coef=, gamma=)``: the truncation flags it
    computes are the JAX wrapper's, the raw reward is the unshaped
    rollout's reward on the same key, and without the option ``raw_reward``
    is ``reward`` itself."""
    _, cfg, m, ts, (_, j_roll, _, _) = shaped_setup
    _, roll, _, _ = ppo_rollout(cfg, m, ts, T, rng.prng_key(9),
                                mask_actions=True, shaping_coef=COEF,
                                gamma=GAMMA)
    assert_bits(j_roll.truncated, roll.truncated, "truncated")
    plain = ppo_rollout(cfg, m, ts, T, rng.prng_key(9), mask_actions=True)[1]
    assert plain.raw_reward is plain.reward
    assert torch.equal(roll.action, plain.action)
    assert torch.equal(roll.raw_reward, plain.reward)
    done = roll.truncated.to(torch.float32)
    spec = shaped_spec(cfg, ts, roll.action, roll.raw_reward, done)
    np.testing.assert_array_equal(spec.view(np.int32),
                                  roll.reward.numpy().view(np.int32))
    ref = ppo_rollout_reference(cfg, m, ts, T, rng.prng_key(9),
                                mask_actions=True, shaping_coef=COEF,
                                gamma=GAMMA)[1]
    assert torch.equal(ref.reward, roll.reward)
    assert torch.equal(ref.raw_reward, roll.raw_reward)


def test_shaping_cuts_the_next_potential_at_a_truncation():
    """At a truncating step the ``gamma * phi_post`` term is cut: the
    shaped reward there is ``raw + coef * (-phi_pre)``; the zero it is cut
    to may be negative (``-0.0``), and leaves no trace in the sum."""
    cfg = WALLED
    m = make_model(cfg, hidden_dim=HIDDEN, device="cpu",
                   generator=torch.Generator().manual_seed(2))
    _, tk = env_keys(6, n=SB)
    ts, _ = batch.reset_batch(cfg, tk)
    _, roll, _, _ = ppo_rollout(cfg, m, ts, T, rng.prng_key(4),
                                shaping_coef=COEF, gamma=GAMMA)
    assert bool(roll.truncated[-1].all())
    s = ts
    for t in range(T - 1):
        s, _ = batch.step_batch(cfg, s, roll.action[t])
    phi_pre = potential(cfg, s)
    want = roll.raw_reward[-1] + np.float32(COEF) * (0.0 - phi_pre)
    assert torch.equal(roll.reward[-1], want)
    assert bool((phi_pre < 0).any())

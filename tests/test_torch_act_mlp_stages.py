"""K2's plain stages (``kernels/act.py``: ``hidden``, ``head``, ``env``)
against the plain twin and the JAX package, on the CPU; and the width
refusals of the CUDA kernels (K7-K12), which name their cause.

K2 runs each acting step as stage kernels over all of the step's ``B A``
rows, group by group (``act_cnn_rows``): a tanh layer a launch for every
hidden layer but the last, then the last layer with the fused head, then
the env stage that K10 shares. Their plain versions, composed step by step
(``act_mlp_steps_staged``), must give the twin's chunk
(``act_steps_reference``) and the Pallas kernel's
(``ppo_rollout_pallas(interpret=True)``). The weights are drawn with numpy
in the flax trees' shapes and go to both sides; the twin comparisons take
numpy gumbel noise, the Pallas ones JAX's gumbel stream. Cases: the ego
window at 0, 1, 2 and 3 hidden layers (narrow widths), the small global
view (D = 131), the groups ``(0, 1, 0, 1)``, masked and shaped
mid-episode on a 3-agent walled layout with a chunk that ends the
episode, and a ragged B of 13; then ``act_mlp_stage`` on the CPU (each
stage its plain version, the launch count unmoved) and an unknown stage
refused. The stage kernels are held against these plain stages on the
card by ``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``
(``act_mlp_stage_check``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import rng as jrng
from warehouse_tpu.config import medium_config, shelves_config, small_config
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.models import make_multi_policy_model as j_multi
from warehouse_tpu.pallas.act import ppo_rollout_pallas
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import (act, act_rnn, build, sgd, sgd_cnn,
                                         sgd_rnn, vtrace_sgd)
from warehouse_tpu_torch.models import (make_model, make_multi_policy_model,
                                        params_from_flax)

from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch

T = 4
COEF, GAMMA = 0.02, 0.99
WALLED3 = shelves_config(max_steps=2 * T, num_agents=3, queue_capacity=6,
                         init_requests=3)
# name: (config, groups, hidden, layers, masked and shaped, start step, B)
CASES = {
    "small_0_layers": (small_config(max_steps=T), None, 16, 0, False, 0, 16),
    "small_1_layer": (small_config(max_steps=T), None, 16, 1, False, 0, 16),
    "small_2_layers": (small_config(max_steps=T), None, 16, 2, False, 0, 16),
    "small_3_layers": (small_config(max_steps=T), None, 12, 3, False, 0, 16),
    "small_global": (small_config(max_steps=T, global_obs=True), None, 16, 2,
                     False, 0, 16),
    "medium_0101": (medium_config(max_steps=T), (0, 1, 0, 1), 16, 2, False,
                    0, 16),
    "walled3_masked_shaped": (WALLED3, None, 16, 2, True, T, 16),
    "medium_ragged": (medium_config(max_steps=T), None, 20, 2, False, 0, 13),
}


def numpy_weights(cfg, groups, hidden, layers, seed):
    """The flax tree of an MLP (with ``groups``, of a multi-policy MLP) at
    ``hidden`` x ``layers``, its leaves drawn with numpy (kernels at flax's
    lecun-normal scale, biases at 0.1), and the port's model holding the
    same weights."""
    kw = dict(hidden_dim=hidden, num_layers=layers)
    if groups is None:
        tree = j_make_model(cfg, **kw).init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, cfg.obs_dim)))
        m = make_model(cfg, device="cpu", **kw)
    else:
        tree = j_multi(cfg, groups, **kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim)),
            jnp.zeros(1, jnp.int32))
        m = make_multi_policy_model(cfg, groups, device="cpu", **kw)
    draw = np.random.default_rng(seed)

    def leaf(x):  # lecun-normal kernels (flax's default scale), biases 0.1
        fan_in = x.shape[0] if x.ndim > 1 else 100
        return (draw.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    tree = jax.tree.map(leaf, tree)
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, tree)))
    return tree, m


def start(cfg, B, t0, seed):
    jk, tk = env_keys(seed, n=B)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    return js.replace(t=js.t + t0), ts.replace(t=ts.t + t0)


def options(cfg, B, on, ts):
    """The mask and shaping buffers of one chunk (None when off)."""
    if not on:
        return None, None
    A = cfg.num_agents
    steps = ts.t[None, :] + 1 + torch.arange(T)[:, None]
    done = (steps >= cfg.max_steps).to(torch.float32)
    return (torch.zeros(T, B, A, 5, dtype=torch.bool),
            act.Shaping(COEF, GAMMA, done, torch.zeros(T, B, A)))


def run(fn, cfg, m, ts, g, groups, on):
    B = ts.agent_pos.shape[0]
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    mask, shaping = options(cfg, B, on, ts)
    logits = torch.zeros(T, B, cfg.num_agents, 5)
    out = fn(cfg, m, ts, u, pick, drop, g, logits=logits, mask=mask,
             shaping=shaping, groups=groups)
    return out, logits, mask, shaping


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_chunk_matches_twin(name):
    """The composed plain stages against the twin on the same draws and
    numpy gumbel noise: state, obs, actions, rewards (shaped and raw),
    deliveries and the mask bit-equal; logits, values and log-probs within
    1e-6 (each row's products taken on its group's rows alone)."""
    cfg, groups, hidden, layers, on, t0, B = CASES[name]
    _, m = numpy_weights(cfg, groups, hidden, layers, seed=3)
    _, ts = start(cfg, B, t0, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).gumbel(
        size=(T, 5, B * cfg.num_agents)).astype(np.float32))
    (s1, *o1), l1, m1, sh1 = run(act.act_mlp_steps_staged, cfg, m, ts, g,
                                 groups, on)
    (s2, *o2), l2, m2, sh2 = run(act.act_steps_reference, cfg, m, ts, g,
                                 groups, on)
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    for k, i in (("obs", 0), ("action", 1), ("reward", 4),
                 ("delivered", 5)):
        assert_bits(o2[i].numpy(), o1[i], k)
    for k, a, b in (("log_prob", o1[2], o2[2]), ("value", o1[3], o2[3]),
                    ("logits", l1, l2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    if on:
        assert torch.equal(m1, m2) and not bool(m1.all())
        assert_bits(sh2.raw_reward.numpy(), sh1.raw_reward, "raw reward")
        assert not torch.equal(o1[4], sh1.raw_reward)
    assert int(o1[5].sum()) >= 0 and bool(torch.isfinite(o1[3]).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_chunk_matches_pallas_kernel(name):
    """The composed plain stages against ``ppo_rollout_pallas`` in
    interpret mode on JAX's gumbel stream: obs, actions, deliveries, mask,
    raw reward and final state bit-equal, the reward bit-equal (the shaped
    one within 1e-6: XLA:CPU contracts its sums), values within 1e-5 and
    log-probs within 1e-4 (``tests/test_torch_act.py``'s bounds)."""
    cfg, groups, hidden, layers, on, t0, B = CASES[name]
    tree, m = numpy_weights(cfg, groups, hidden, layers, seed=6)
    js, ts = start(cfg, B, t0, seed=7)
    j_new, j_roll, _, _ = ppo_rollout_pallas(
        cfg, tree, js, T, jax.random.PRNGKey(9), block=B, interpret=True,
        mask_actions=on, shaping_coef=COEF if on else 0.0, gamma=GAMMA,
        policy_groups=groups)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T,
                                      (5, B * cfg.num_agents))
    (new, obs, action, lp, value, reward, delivered), _, mask, shaping = run(
        act.act_mlp_steps_staged, cfg, m, ts, to_torch(g), groups, on)
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
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    np.testing.assert_allclose(value.numpy(), np.asarray(j_roll.value),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(j_roll.log_prob),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", ["small_3_layers", "medium_0101",
                                  "walled3_masked_shaped", "small_0_layers"])
def test_act_mlp_stage_on_cpu(name):
    """``act_mlp_stage`` on CPU tensors runs each plain stage and launches
    nothing: the hidden stages then ``head`` give the model's logits and
    values on the step's observations (rows in ``act_cnn_rows``' order),
    ``env`` gives the twin's first step; an unknown stage and a hidden
    stage past the last but one layer are refused."""
    cfg, groups, hidden, layers, on, t0, B = CASES[name]
    _, m = numpy_weights(cfg, groups, hidden, layers, seed=8)
    _, ts = start(cfg, B, t0, seed=9)
    A = cfg.num_agents
    obs = batch.observe_batch(cfg, ts)
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, 1)
    g = torch.from_numpy(np.random.default_rng(10).gumbel(
        size=(1, 5, B * A)).astype(np.float32))
    mask, shaping = options(cfg, B, on, ts)
    if on:
        mask, shaping = mask[:1], act.Shaping(
            COEF, GAMMA, shaping.done[:1], torch.zeros(1, B, A))
    before = act.act_mlp_stage.launches
    kw = dict(mask_on=on, shaping=shaping, groups=groups)
    order = act.act_cnn_rows(cfg, B, groups)
    x = obs.reshape(B * A, -1)[order]
    for layer in range(layers - 1):
        x = act.act_mlp_stage("hidden", cfg, m, ts, {"x": x}, u, pick, drop,
                              g, layer=layer, **kw)["h"]
        assert x.shape == (B * A, hidden)
    head = act.act_mlp_stage("head", cfg, m, ts, {"x": x}, u, pick, drop, g,
                             **kw)["head"]
    with torch.no_grad():
        lg, v = (m(obs) if groups is None else m(obs, torch.tensor(groups)))
    want = torch.cat([lg, v[..., None]], -1).reshape(B * A, 6)[order]
    np.testing.assert_allclose(head.numpy(), want.numpy(), rtol=0, atol=1e-6)
    out = act.act_mlp_stage("env", cfg, m, ts, {"head": head}, u, pick, drop,
                            g, **kw)
    ref = act.act_steps_reference(cfg, m, ts, u, pick, drop, g, mask=mask,
                                  shaping=shaping, groups=groups)
    for f in STATE_FIELDS[:-2]:
        assert torch.equal(getattr(out["state"], f), getattr(ref[0], f)), f
    assert torch.equal(out["action"], ref[2][0])
    assert_bits(ref[5][0].numpy(), out["reward"], "reward")
    assert torch.equal(out["delivered"], ref[6][0])
    assert torch.equal(out["obs"], batch.observe_batch(cfg, out["state"]))
    if on:
        assert torch.equal(out["mask"], mask[0])
        assert_bits(shaping.raw_reward[0].numpy(), out["raw_reward"], "raw")
    assert act.act_mlp_stage.launches == before
    with pytest.raises(ValueError, match="stage must be one of"):
        act.act_mlp_stage("conv", cfg, m, ts, {"x": x}, u, pick, drop, g)
    with pytest.raises(ValueError, match="the hidden stage runs layers"):
        act.act_mlp_stage("hidden", cfg, m, ts, {"x": x}, u, pick, drop, g,
                          layer=max(layers - 1, 0), **kw)


# ---- the widths and depths the kernels take ------------------------------

@pytest.fixture
def no_library(monkeypatch):
    """The checks below must pass every shape check before any call into
    the CUDA library (a check that needs the library then reaches it)."""
    def refuse():
        raise AssertionError("the check called the CUDA library")

    monkeypatch.setattr(build, "library", refuse)


REACHES_LIBRARY = "the check called the CUDA library"


def test_k2_refuses_more_than_four_hidden_layers(no_library):
    """K2 takes any number of hidden layers and any width: 5 and 8 layers
    and 50-wide layers pass its check; a group map that does not fit the
    model stays refused.
    (The name is that of the refusal this test held before the kernels
    took these shapes, kept so that the test's record runs on.)"""
    cfg = small_config()
    for layers in (5, 8):
        act.check_act_fits(cfg, make_model(cfg, hidden_dim=8,
                                           num_layers=layers, device="cpu"),
                           "cpu")
    act.check_act_fits(cfg, make_model(cfg, hidden_dim=50, device="cpu"),
                       "cpu")
    with pytest.raises(ValueError, match="one entry per agent"):
        act.check_act_fits(cfg, make_multi_policy_model(
            cfg, (0, 1), hidden_dim=8, device="cpu"), "cpu", (0, 1, 0))


def gru_params(cfg, hidden, num_layers=2):
    m = make_model(cfg, "gru", hidden_dim=hidden, num_layers=num_layers,
                   device="cpu")
    return {k: v.detach() for k, v in m.state_dict().items()}


def cnn_params(cfg, hidden):
    m = make_model(cfg, "cnn", hidden_dim=hidden, device="cpu")
    return {k: v.detach() for k, v in m.state_dict().items()}


def test_k10_refuses_width_50_by_name(no_library):
    """K10 takes a trunk 50 wide: its shape checks pass and the check goes
    on to ask the library for the stage's shared memory.
    (The name is that of the refusal this test held before the kernels
    took these shapes, kept so that the test's record runs on.)"""
    cfg = medium_config()
    with pytest.raises(AssertionError, match=REACHES_LIBRARY):
        act.check_act_fits(cfg, make_model(cfg, "cnn", hidden_dim=50,
                                           device="cpu"), "cpu")


def test_k7_refuses_width_50_by_name(no_library):
    """K7 takes hidden and encoder widths of 50 and 4 encoder layers
    (num_layers 5): the check passes without the library.
    (The name is that of the refusal this test held before the kernels
    took these shapes, kept so that the test's record runs on.)"""
    cfg = medium_config()
    assert act_rnn.check_act_rnn_fits(cfg, gru_params(cfg, 50))[1] == 50
    dims, H, _ = act_rnn.check_act_rnn_fits(cfg, gru_params(cfg, 12, 5))
    assert dims == [cfg.obs_dim, 12, 12, 12, 12] and H == 12


def test_k8_k9_refuse_width_50_by_name(no_library):
    """K8 / K9 take a hidden width of 50 and 4 encoder layers: the shape
    checks pass and the check goes on to ask the library for the stages'
    shared memory.
    (The name is that of the refusal this test held before the kernels
    took these shapes, kept so that the test's record runs on.)"""
    cfg = medium_config()
    for params in (gru_params(cfg, 50), gru_params(cfg, 12, 5)):
        with pytest.raises(AssertionError, match=REACHES_LIBRARY):
            sgd_rnn.check_rnn_learner_fits(params, cfg.obs_dim, "cpu")


def test_k11_k12_refuse_width_50_by_name(no_library):
    """K11 / K12 take a trunk 50 wide: the shape checks pass and the check
    goes on to ask the library for the stages' shared memory.
    (The name is that of the refusal this test held before the kernels
    took these shapes, kept so that the test's record runs on.)"""
    cfg = medium_config()
    with pytest.raises(AssertionError, match=REACHES_LIBRARY):
        sgd_cnn.check_cnn_learner_fits(cnn_params(cfg, 50), cfg.obs_dim,
                                       "cpu")


def test_k3_to_k6_refuse_no_hidden_layer_by_name(no_library):
    """K3-K6 take any number of hidden layers from 1; without one the JAX
    kernel raises, and these checks refuse by name before any library
    call. 5 layers pass the shape checks and reach the library."""
    cfg = small_config()
    flat = {k: v.detach() for k, v in make_model(
        cfg, hidden_dim=8, num_layers=0, device="cpu").state_dict().items()}
    deep = {k: v.detach() for k, v in make_model(
        cfg, hidden_dim=8, num_layers=5, device="cpu").state_dict().items()}
    for check in (sgd.check_learner_fits, vtrace_sgd.check_impala_fits):
        with pytest.raises(ValueError, match="at least 1 hidden layer"):
            check(flat, cfg.obs_dim, "cpu")
        with pytest.raises(AssertionError, match=REACHES_LIBRARY):
            check(deep, cfg.obs_dim, "cpu")

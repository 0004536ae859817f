"""K10's three plain stages (``kernels/act.py``: ``conv``, ``trunk``,
``env``) against the plain twin and the JAX package, on the CPU.

K10 runs each acting step as three stage kernels over all of the step's
``B A`` rows, group by group (``act_cnn_rows``). Their plain versions,
composed step by step (``act_cnn_steps_staged``), must give the twin's
chunk (``act_steps_reference``) and the Pallas kernel's
(``ppo_rollout_pallas(arch="cnn", interpret=True)``). The weights are
drawn with numpy in the flax trees' shapes and go to both sides; the
twin comparisons take numpy gumbel noise, the Pallas ones JAX's gumbel
stream (as ``tests/test_torch_cnn.py`` does). Cases: the 5x5 window, the
global view (5 channels), the groups ``(0, 1, 0, 1)`` on the 9x9 global
view, one policy per agent, masked and shaped mid-episode on a 3-agent
walled layout with a chunk that ends the episode, and a ragged B of 13;
then ``act_cnn_stage`` on the CPU (each stage its plain version, the
launch count unmoved) and an unknown stage refused. The stage kernels are
held against these plain stages on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``
(``act_cnn_stage_check``).
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
from warehouse_tpu_torch.kernels import act
from warehouse_tpu_torch.models import (make_model, make_multi_policy_model,
                                        params_from_flax)

from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch

T, HIDDEN = 4, 16
COEF, GAMMA = 0.02, 0.99
WALLED3 = shelves_config(max_steps=2 * T, num_agents=3, queue_capacity=6,
                         init_requests=3)
# name: (config, groups, masked and shaped, start step, B)
CASES = {
    "small": (small_config(max_steps=T), None, False, 0, 16),
    "small_global_masked_shaped": (small_config(max_steps=T, global_obs=True),
                                   None, True, 0, 16),
    "medium_global_0101": (medium_config(max_steps=T, global_obs=True),
                           (0, 1, 0, 1), False, 0, 16),
    "medium_per_agent_ragged": (medium_config(max_steps=T), (0, 1, 2, 3),
                                False, 0, 13),
    "walled3_0101_masked_shaped": (WALLED3, (0, 1, 0), True, T, 16),
    "walled3_masked_shaped_ragged": (WALLED3, None, True, T, 13),
}


def numpy_weights(cfg, groups, seed):
    """The flax tree of a CNN (with ``groups``, of a multi-policy CNN) at
    HIDDEN, its leaves drawn with numpy (kernels at flax's lecun-normal
    scale, biases at 0.1), and the port's model holding the same
    weights."""
    if groups is None:
        tree = j_make_model(cfg, arch="cnn", hidden_dim=HIDDEN).init(
            jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim)))
        m = make_model(cfg, "cnn", hidden_dim=HIDDEN, device="cpu")
    else:
        tree = j_multi(cfg, groups, arch="cnn", hidden_dim=HIDDEN).init(
            jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim)),
            jnp.zeros(1, jnp.int32))
        m = make_multi_policy_model(cfg, groups, "cnn", hidden_dim=HIDDEN,
                                    device="cpu")
    draw = np.random.default_rng(seed)

    def leaf(x):  # lecun-normal kernels (flax's default scale), biases 0.1
        fan_in = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 100
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
    1e-5 (the trunk's product in another form)."""
    cfg, groups, on, t0, B = CASES[name]
    _, m = numpy_weights(cfg, groups, seed=3)
    _, ts = start(cfg, B, t0, seed=4)
    g = torch.from_numpy(np.random.default_rng(5).gumbel(
        size=(T, 5, B * cfg.num_agents)).astype(np.float32))
    (s1, *o1), l1, m1, sh1 = run(act.act_cnn_steps_staged, cfg, m, ts, g,
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
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    if on:
        assert torch.equal(m1, m2) and not bool(m1.all())
        assert_bits(sh2.raw_reward.numpy(), sh1.raw_reward, "raw reward")
        assert not torch.equal(o1[4], sh1.raw_reward)
    assert int(o1[5].sum()) >= 0 and bool(torch.isfinite(o1[3]).all())


PALLAS_CASES = ("small", "small_global_masked_shaped", "medium_global_0101",
                "walled3_0101_masked_shaped")


@pytest.mark.parametrize("name", PALLAS_CASES)
def test_staged_chunk_matches_pallas_kernel(name):
    """The composed plain stages against ``ppo_rollout_pallas(arch="cnn")``
    in interpret mode on JAX's gumbel stream: obs, actions, deliveries,
    mask, raw reward and final state bit-equal, the reward bit-equal (the
    shaped one within 1e-6: XLA:CPU contracts its sums), values and
    log-probs within 1e-5."""
    cfg, groups, on, t0, B = CASES[name]
    tree, m = numpy_weights(cfg, groups, seed=6)
    js, ts = start(cfg, B, t0, seed=7)
    j_new, j_roll, _, _ = ppo_rollout_pallas(
        cfg, tree, js, T, jax.random.PRNGKey(9), block=B, interpret=True,
        mask_actions=on, shaping_coef=COEF if on else 0.0, gamma=GAMMA,
        policy_groups=groups, arch="cnn")
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(9), T,
                                      (5, B * cfg.num_agents))
    (new, obs, action, lp, value, reward, delivered), _, mask, shaping = run(
        act.act_cnn_steps_staged, cfg, m, ts, to_torch(g), groups, on)
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
                               rtol=0, atol=1e-5)


def test_rows_are_group_major():
    """Row q's (env, agent): group 0's pairs env by env, then group 1's;
    without groups env-major."""
    cfg = medium_config()
    assert act.act_cnn_rows(cfg, 2, (0, 1, 0, 1)).tolist() == [
        0, 2, 4, 6, 1, 3, 5, 7]
    assert act.act_cnn_rows(cfg, 3, (1, 0, 0, 1)).tolist() == [
        1, 2, 5, 6, 9, 10, 0, 3, 4, 7, 8, 11]
    assert torch.equal(act.act_cnn_rows(cfg, 3), torch.arange(12))


@pytest.mark.parametrize("name", ["medium_global_0101",
                                  "walled3_masked_shaped_ragged"])
def test_act_cnn_stage_on_cpu(name):
    """``act_cnn_stage`` on CPU tensors runs each plain stage and launches
    nothing: ``conv`` then ``trunk`` give the model's logits and values on
    the step's observations (rows in ``act_cnn_rows``' order), ``env``
    gives the twin's first step; an unknown stage is refused."""
    cfg, groups, on, t0, B = CASES[name]
    _, m = numpy_weights(cfg, groups, seed=8)
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
    before = act.act_cnn_stage.launches
    kw = dict(mask_on=on, shaping=shaping, groups=groups)
    a1 = act.act_cnn_stage("conv", cfg, m, ts, {"obs": obs}, u, pick, drop,
                           g, **kw)["a1"]
    head = act.act_cnn_stage("trunk", cfg, m, ts, {"a1": a1}, u, pick, drop,
                             g, **kw)["head"]
    order = act.act_cnn_rows(cfg, B, groups)
    with torch.no_grad():
        lg, v = (m(obs) if groups is None else m(obs, torch.tensor(groups)))
    want = torch.cat([lg, v[..., None]], -1).reshape(B * A, 6)[order]
    np.testing.assert_allclose(head.numpy(), want.numpy(), rtol=0, atol=1e-5)
    out = act.act_cnn_stage("env", cfg, m, ts, {"head": head}, u, pick, drop,
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
    assert act.act_cnn_stage.launches == before
    with pytest.raises(ValueError, match="stage must be one of"):
        act.act_cnn_stage("conv_fwd", cfg, m, ts, {"obs": obs}, u, pick,
                          drop, g)

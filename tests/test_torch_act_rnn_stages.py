"""K7's plain stages (``kernels/act_rnn.py``: ``encoder``, ``cell``,
``head``, ``env``) against the plain twin and the JAX package, on the CPU.

K7 runs each acting step as stage kernels over all of the step's ``B A``
rows (row ``b A + a``): a tanh layer a launch per encoder layer, the cell
as one product over ``[e | h]`` on the kernel's interleaved gate columns
(``cell_columns`` / ``cell_weights``) with the gates after it, the head on
the new ``h``, then K2's env stage. Their plain versions, composed step by
step (``act_rnn_steps_staged``), must give the twin's chunk
(``act_rnn_steps_reference``) and the Pallas kernel's
(``ppo_rnn_rollout_pallas(interpret=True)``); each plain stage must give
the twin's step. The weights are drawn with numpy in the flax trees'
shapes and go to both sides, the carry too; the twin comparisons take
numpy gumbel noise, the Pallas ones JAX's gumbel stream. Cases: GRU and
LSTM, 1 and 2 encoder layers, hidden 12 to 20 (one cell tile of 32 units,
most of it padding), masked on a 3-agent walled layout, a ragged B of 13.
The stage kernels are held against these plain stages on the card by
``tests/test_torch_kernels_gpu.py`` and ``chip_smoke.py``
(``act_rnn_stage_check``).
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
from warehouse_tpu.pallas.act import ppo_rnn_rollout_pallas
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import act_rnn
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.models.policy import apply_rnn

from test_torch_env import env_keys
from test_torch_rng import assert_bits, to_torch

T = 4
WALLED3 = shelves_config(max_steps=T, num_agents=3, queue_capacity=6,
                         init_requests=3)
# name: (config, cell, hidden, num_layers, masked, B)
CASES = {
    "gru_small": (small_config(max_steps=T), "gru", 16, 2, False, 16),
    "lstm_small_2_encoders": (small_config(max_steps=T), "lstm", 12, 3,
                              False, 16),
    "gru_walled3_masked": (WALLED3, "gru", 16, 2, True, 16),
    "lstm_walled3_masked": (WALLED3, "lstm", 16, 2, True, 16),
    "gru_medium_ragged": (medium_config(max_steps=T), "gru", 20, 2, False,
                          13),
}


def numpy_weights(cfg, arch, hidden, layers, seed):
    """The flax tree of the recurrent policy, its leaves drawn with numpy
    (kernels at flax's lecun-normal scale, biases at 0.1), and the port's
    params dict holding the same weights."""
    jm = j_make_model(cfg, arch=arch, hidden_dim=hidden, num_layers=layers)
    tree = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim)),
                   jm.initial_carry((1,)))
    draw = np.random.default_rng(seed)

    def leaf(x):
        fan_in = x.shape[0] if x.ndim > 1 else 100
        return (draw.standard_normal(x.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    tree = jax.tree.map(leaf, tree)
    m = make_model(cfg, arch, hidden, layers, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, tree)))
    return tree, {k: v.detach() for k, v in m.state_dict().items()}


def numpy_carry(arch, B, A, hidden, seed):
    """A seeded numpy carry as (jax, torch): h, or the LSTM's (c, h)."""
    r = np.random.default_rng(seed)
    leaves = [0.5 * r.standard_normal((B, A, hidden)).astype(np.float32)
              for _ in range(2 if arch == "lstm" else 1)]
    j = tuple(jnp.asarray(x) for x in leaves)
    t = tuple(torch.from_numpy(x.copy()) for x in leaves)
    return (j, t) if arch == "lstm" else (j[0], t[0])


def leaves(carry):
    return carry if isinstance(carry, tuple) else (carry,)


def start(cfg, B, seed):
    jk, tk = env_keys(seed, n=B)
    return jbatch.reset_batch(cfg, jk)[0], batch.reset_batch(cfg, tk)[0]


def run(fn, cfg, params, ts, carry, g, masked):
    B = ts.agent_pos.shape[0]
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    mask = (torch.zeros(T, B, cfg.num_agents, 5, dtype=torch.bool)
            if masked else None)
    logits = torch.zeros(T, B, cfg.num_agents, 5)
    out = fn(cfg, params, ts, carry, u, pick, drop, g, logits=logits,
             mask=mask)
    return out, logits, mask


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_chunk_matches_twin(name):
    """The composed plain stages against the twin on the same draws and
    numpy gumbel noise: state, obs, actions, rewards, deliveries and the
    mask bit-equal; logits, values, log-probs and the carry within 1e-6
    (the cell's product over ``[e | h]`` in one sum)."""
    cfg, arch, hidden, layers, masked, B = CASES[name]
    _, params = numpy_weights(cfg, arch, hidden, layers, seed=3)
    _, ts = start(cfg, B, seed=4)
    _, carry = numpy_carry(arch, B, cfg.num_agents, hidden, seed=5)
    g = torch.from_numpy(np.random.default_rng(6).gumbel(
        size=(T, 5, B * cfg.num_agents)).astype(np.float32))
    (s1, c1, *o1), l1, m1 = run(act_rnn.act_rnn_steps_staged, cfg, params,
                                ts, carry, g, masked)
    (s2, c2, *o2), l2, m2 = run(act_rnn.act_rnn_steps_reference, cfg,
                                params, ts, carry, g, masked)
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    for k, i in (("obs", 0), ("action", 1), ("reward", 4),
                 ("delivered", 5)):
        assert_bits(o2[i].numpy(), o1[i], k)
    pairs = [("log_prob", o1[2], o2[2]), ("value", o1[3], o2[3]),
             ("logits", l1, l2)] + [("carry", a, b) for a, b in
                                    zip(leaves(c1), leaves(c2))]
    for k, a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6,
                                   err_msg=k)
    if masked:
        assert torch.equal(m1, m2) and not bool(m1.all())
    assert bool(torch.isfinite(o1[3]).all())


@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_chunk_matches_pallas_kernel(name):
    """The composed plain stages against ``ppo_rnn_rollout_pallas`` in
    interpret mode on JAX's gumbel stream, from the same carry: obs,
    actions, rewards, deliveries, mask and final state bit-equal; values,
    log-probs and the carry within 1e-5 (``tests/test_torch_rnn.py``'s
    bounds: f32 sums in another order, torch's exp/log/tanh against
    XLA's)."""
    cfg, arch, hidden, layers, masked, B = CASES[name]
    tree, params = numpy_weights(cfg, arch, hidden, layers, seed=7)
    js, ts = start(cfg, B, seed=8)
    jc, tc = numpy_carry(arch, B, cfg.num_agents, hidden, seed=9)
    j_new, j_roll, _, _, j_carry = ppo_rnn_rollout_pallas(
        cfg, tree, js, jc, T, jax.random.PRNGKey(10), B, True, masked, arch)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(10), T,
                                      (5, B * cfg.num_agents))
    (new, carry, obs, action, lp, value, reward, delivered), _, mask = run(
        act_rnn.act_rnn_steps_staged, cfg, params, ts, tc, to_torch(g),
        masked)
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    if masked:
        assert_bits(j_roll.mask, mask, "mask")
    for got, want, what in ((value, j_roll.value, "value"),
                            (lp, j_roll.log_prob, "log_prob"),
                            *((a, b, "carry") for a, b in
                              zip(leaves(carry), leaves(j_carry)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_stages_match_twin_step(name):
    """Each plain stage, through ``act_rnn_stage`` on CPU tensors (which
    launches nothing), against the twin's first step: the encoder layers
    give ``apply_rnn``'s encoder rows, the cell on ``[e | h]`` its new
    carry, the head its logits and value, each within 1e-6; the env stage
    the twin's first step (state, action, reward, deliveries, the mask
    and the next observation bit-equal). ``cell_weights`` holds every
    gate kernel once in ``cell_columns``' order; an unknown stage and an
    encoder layer past the last are refused."""
    cfg, arch, hidden, layers, masked, B = CASES[name]
    _, params = numpy_weights(cfg, arch, hidden, layers, seed=11)
    _, ts = start(cfg, B, seed=12)
    _, carry = numpy_carry(arch, B, cfg.num_agents, hidden, seed=13)
    A, N = cfg.num_agents, B * cfg.num_agents
    obs = batch.observe_batch(cfg, ts)
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, 1)
    g = torch.from_numpy(np.random.default_rng(14).gumbel(
        size=(1, 5, N)).astype(np.float32))
    before = act_rnn.act_rnn_stage.launches
    kw = dict(u=u, pick=pick, drop=drop, g=g, mask_on=masked)

    def stage(name, inputs, layer=0):
        return act_rnn.act_rnn_stage(name, cfg, params, ts, inputs,
                                     layer=layer, **kw)

    x = obs.reshape(N, -1)
    for layer in range(layers - 1):
        x = stage("encoder", {"x": x}, layer)["y"]
    h, c = act_rnn.split_carry(carry, arch == "lstm")
    cell = stage("cell", {"eh": torch.cat([x, h.reshape(N, -1)], 1),
                          "c": None if c is None else c.reshape(N, -1)})
    head = stage("head", {"h": cell["h"]})["head"]
    with torch.no_grad():
        lg, v, want_carry = apply_rnn(params, obs, carry)
    want_c, want_h = act_rnn.split_carry(want_carry, arch == "lstm")[::-1]
    pairs = [("h", cell["h"], want_h), ("head", head, torch.cat(
        [lg, v[..., None]], -1))]
    if c is None:
        assert cell["c"] is None
    else:
        pairs.append(("c", cell["c"], want_c))
    for k, a, b in pairs:
        np.testing.assert_allclose(a.numpy(), b.reshape(N, -1).numpy(),
                                   rtol=0, atol=1e-6, err_msg=k)
    out = stage("env", {"head": head})
    mask = torch.zeros(1, B, A, 5, dtype=torch.bool) if masked else None
    ref = act_rnn.act_rnn_steps_reference(cfg, params, ts, carry, u, pick,
                                          drop, g, mask=mask)
    for f in STATE_FIELDS[:-2]:
        assert torch.equal(getattr(out["state"], f), getattr(ref[0], f)), f
    assert torch.equal(out["action"], ref[3][0])
    assert_bits(ref[6][0].numpy(), out["reward"], "reward")
    assert torch.equal(out["delivered"], ref[7][0])
    assert torch.equal(out["obs"], batch.observe_batch(cfg, out["state"]))
    if masked:
        assert torch.equal(out["mask"], mask[0])
    assert act_rnn.act_rnn_stage.launches == before
    # The cell's columns: every (unit, set) once, each a gate's row.
    unit, sets = act_rnn.cell_columns(hidden)
    live = unit < hidden
    assert sorted(zip(unit[live].tolist(), sets[live].tolist())) == [
        (j, s) for j in range(hidden) for s in range(4)]
    w = act_rnn.cell_weights(params)
    assert w.shape == (unit.numel(), x.shape[1] + hidden)
    assert not bool(w[~live].any())
    with pytest.raises(ValueError, match="stage must be one of"):
        stage("hidden", {"x": x})
    with pytest.raises(ValueError, match="the encoder stage runs layers"):
        stage("encoder", {"x": x}, layers - 1)

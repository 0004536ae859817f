"""The recurrent (GRU / LSTM) policy, K7's plain twin and recurrent serving
against the JAX package, on the CPU; the port's own config and its device
default.

The flax ``ActorCriticRNN``'s weights go to the port through
``params_from_flax``; ``ppo_rnn_rollout_pallas`` runs in interpret mode.
With the JAX gumbel stream fed in, obs, actions, rewards, deliveries and
the final state are bit-equal; values, log-probs and the carry are within
1e-5 (f32 sums in another order, torch's exp/log/tanh against XLA's). The
CUDA kernel is checked on the card by test_torch_kernels_gpu.py and
chip_smoke.py. Every call to the port passes ``device="cpu"``: without it
the port's entry points ask for the card.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import config as jconfig
from warehouse_tpu import rng as jrng
from warehouse_tpu.config import shelves_config, small_config
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.pallas.act import ppo_rnn_rollout_pallas
from warehouse_tpu.serve import Policy as JPolicy
from warehouse_tpu_torch import config as tconfig
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels.act import ppo_rollout
from warehouse_tpu_torch.kernels.act_rnn import (act_rnn_steps, pack_rnn,
                                                 ppo_rnn_rollout,
                                                 ppo_rnn_rollout_reference,
                                                 unpack_rnn)
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.serve import Policy

from test_torch_env import assert_state, env_keys
from test_torch_rng import assert_bits, to_torch

B, T, HIDDEN = 32, 4, 16
CFG = small_config(max_steps=T)  # the chunk ends with the episode
WALLED = shelves_config(max_steps=T, num_agents=3, queue_capacity=6,
                        init_requests=3)
CELLS = ["gru", "lstm"]


def flax_and_port(cfg, arch, num_layers=2, seed=0):
    jm = j_make_model(cfg, arch=arch, hidden_dim=HIDDEN,
                      num_layers=num_layers)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.obs_dim)),
                     jm.initial_carry((1,)))
    m = make_model(cfg, arch, HIDDEN, num_layers, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return jm, params, m


def random_carry(arch, n, A, seed):
    """A seeded numpy carry as (jax, torch): h, or the LSTM's (c, h)."""
    r = np.random.default_rng(seed)
    leaves = [0.5 * r.standard_normal((n, A, HIDDEN)).astype(np.float32)
              for _ in range(2 if arch == "lstm" else 1)]
    j = tuple(jnp.asarray(x) for x in leaves)
    t = tuple(torch.from_numpy(x.copy()) for x in leaves)
    return (j, t) if arch == "lstm" else (j[0], t[0])


def leaves(carry):
    return carry if isinstance(carry, tuple) else (carry,)


# ---- the model -----------------------------------------------------------------

@pytest.mark.parametrize("num_layers", [2, 3])
@pytest.mark.parametrize("arch", CELLS)
def test_rnn_forward_matches_flax(arch, num_layers):
    """Logits, value and carry over 3 chained steps (rtol 1e-5, atol
    1e-6: one dense chain of f32 sums in another order)."""
    cfg = small_config()
    jm, params, m = flax_and_port(cfg, arch, num_layers)
    assert len(m.encoder) == max(num_layers - 1, 1)
    jc, tc = random_carry(arch, 8, cfg.num_agents, 1)
    r = np.random.default_rng(2)
    for step in range(3):
        obs = r.random((8, cfg.num_agents, cfg.obs_dim), np.float32)
        j_logits, j_value, jc = jm.apply(params, jnp.asarray(obs), jc)
        with torch.no_grad():
            logits, value, tc = m(torch.from_numpy(obs), tc)
        for got, want in ((logits, j_logits), (value, j_value),
                          *zip(leaves(tc), leaves(jc))):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step}")


@pytest.mark.parametrize("arch", CELLS)
def test_rnn_init_follows_flax_and_is_seeded(arch):
    """Encoder orthogonal sqrt(2), heads 0.01 / 1.0, recurrent kernels
    orthogonal, input kernels lecun-normal, biases zero, the same bits
    from the same generator seed; the zero initial carry."""
    cfg = small_config()
    a, b = (make_model(cfg, arch, 32, 2, torch.Generator().manual_seed(1),
                       "cpu") for _ in range(2))
    for (name, pa), pb in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(pa, pb), name
        if name.endswith(".bias"):
            assert not pa.any(), name
    ortho = [(a.encoder[0].weight, 2 ** 0.5), (a.logits.weight, 0.01),
             (a.value.weight, 1.0)]
    ortho += [(a.cell[g].weight, 1.0) for g in a.cell if g[0] == "h"]
    for w, gain in ortho:
        w = w.detach().double()
        gram = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        torch.testing.assert_close(gram, gain ** 2 * torch.eye(
            min(w.shape), dtype=torch.float64), rtol=0, atol=1e-5)
    stds = [float(a.cell[g].weight.detach().std()) for g in a.cell
            if g[0] == "i"]
    assert all(abs(s * 32 ** 0.5 - 1.0) < 0.2 for s in stds), stds
    carry = a.initial_carry((3, cfg.num_agents))
    assert len(leaves(carry)) == (2 if arch == "lstm" else 1)
    assert all(x.shape == (3, cfg.num_agents, 32) and not x.any()
               for x in leaves(carry))


@pytest.mark.parametrize("arch", CELLS)
def test_params_from_flax_checks_every_shape(arch):
    cfg = small_config()
    _, params, m = flax_and_port(cfg, arch)
    tree = jax.tree.map(np.asarray, params)["params"]
    cell = "GRUCell_0" if arch == "gru" else "OptimizedLSTMCell_0"
    gate = "hr" if arch == "gru" else "hf"
    bad = [
        {**tree, cell: {**tree[cell], gate: {
            **tree[cell][gate],
            "kernel": tree[cell][gate]["kernel"][:, :-1]}}},
        {**tree, cell: {k: v for k, v in tree[cell].items() if k != gate}},
        {**tree, "Dense_0": {"kernel": tree["Dense_0"]["kernel"][:, :-1],
                             "bias": tree["Dense_0"]["bias"][:-1]}},
        {**tree, "Dense_2": {"kernel": np.zeros((HIDDEN, 2), np.float32),
                             "bias": np.zeros(2, np.float32)}},
        {**tree, "Conv_0": tree["Dense_0"]},
    ]
    for broken in bad:
        with pytest.raises(ValueError):
            params_from_flax({"params": broken})
    good = params_from_flax(tree)
    assert good.keys() == m.state_dict().keys()
    flat = pack_rnn(good)
    assert flat.numel() == sum(v.numel() for v in good.values())
    back = unpack_rnn(flat, good)
    assert all(torch.equal(back[k], good[k]) for k in good)


# ---- K7's twin against the TPU kernel in interpret mode -------------------------

@pytest.fixture(scope="module", params=[("gru", False), ("lstm", False),
                                        ("gru", True), ("lstm", True)],
                ids=lambda p: f"{p[0]}{'-masked' if p[1] else ''}")
def setup(request):
    arch, masked = request.param
    cfg = WALLED if masked else CFG
    jm, params, m = flax_and_port(cfg, arch)
    jk, tk = env_keys(0, n=B)
    js, _ = jbatch.reset_batch(cfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    jc, tc = random_carry(arch, B, cfg.num_agents, 3)
    out = ppo_rnn_rollout_pallas(cfg, params, js, jc, T,
                                 jax.random.PRNGKey(7), B, True, masked, arch)
    return arch, masked, cfg, jm, params, m, js, ts, jc, tc, out


def test_rnn_twin_with_jax_gumbel_bit_exact(setup):
    (arch, masked, cfg, jm, params, m, js, ts, jc, tc,
     (j_new, j_roll, _, _, j_carry)) = setup
    A = cfg.num_agents
    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), T, (5, B * A))
    mask = torch.zeros(T, B, A, 5, dtype=torch.bool) if masked else None
    new, carry, obs, action, lp, value, reward, delivered = act_rnn_steps(
        cfg, dict(m.named_parameters()), ts, tc, u, pick, drop, to_torch(g),
        mask=mask)
    assert_bits(j_roll.obs, obs, "obs")
    assert_bits(j_roll.action, action, "action")
    assert_bits(j_roll.reward, reward, "reward")
    assert_bits(j_roll.delivered, delivered, "delivered")
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert_bits(getattr(j_new, f), getattr(new, f), f)
    if masked:
        assert_bits(j_roll.mask, mask, "mask")
        assert not bool(mask.all())
    for got, want, what in ((value, j_roll.value, "value"),
                            (lp, j_roll.log_prob, "log_prob"),
                            *((a, b, "carry") for a, b in
                              zip(leaves(carry), leaves(j_carry)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5, err_msg=what)


def test_rnn_wrapper_outputs_and_keys(setup):
    (arch, masked, cfg, jm, params, m, js, ts, jc, tc,
     (j_new, j_roll, j_rk, j_nk, j_carry)) = setup
    new, roll, rk, nk, carry = ppo_rnn_rollout(
        cfg, m, ts, tc, T, rng.prng_key(7), mask_actions=masked)
    assert_bits(j_rk, rk, "reset_key_last")
    assert_bits(j_nk, nk, "next key")
    assert_bits(j_new.t, new.t, "t")
    assert_bits(j_new.key, new.key, "key")
    assert_bits(j_roll.truncated, roll.truncated, "truncated")
    assert bool(roll.truncated[-1].all())
    assert not bool(roll.truncated[:-1].any())
    assert torch.equal(roll.raw_reward, roll.reward)
    # The carry comes back unreset although every env truncated.
    assert all(bool(x.any()) for x in leaves(carry))
    # The twin is the CPU path, for a model and for its params dict.
    ref = ppo_rnn_rollout_reference(cfg, dict(m.named_parameters()), ts, tc,
                                    T, rng.prng_key(7), mask_actions=masked)
    assert_state(new, ref[0])
    for x, y in zip(roll, ref[1]):
        assert torch.equal(x, y)
    for x, y in zip(leaves(carry), leaves(ref[4])):
        assert torch.equal(x, y)


def test_rnn_rollout_gates():
    cfg = small_config()
    m = make_model(cfg, "gru", HIDDEN, device="cpu")
    ts, _ = batch.reset_batch(cfg, env_keys(1, n=4)[1])
    carry = m.initial_carry((4, cfg.num_agents))
    key = rng.prng_key(0)
    # Like the JAX function, it has no shaping parameter at all.
    with pytest.raises(TypeError, match="shaping_coef"):
        ppo_rnn_rollout(cfg, m, ts, carry, T, key, shaping_coef=0.1)
    with pytest.raises(NotImplementedError):
        ppo_rnn_rollout(cfg.replace(global_obs=True), m, ts, carry, T, key)
    with pytest.raises(ValueError):
        ppo_rnn_rollout(cfg.replace(auto_reset=True), m, ts, carry, T, key)
    # K2's wrapper names the recurrent kernel's instead of "not ported".
    with pytest.raises(ValueError, match="ppo_rnn_rollout"):
        ppo_rollout(cfg, make_model(cfg, hidden_dim=HIDDEN, device="cpu"), ts,
                    T, key, arch="gru")


# ---- serving ---------------------------------------------------------------------

@pytest.mark.parametrize("arch", CELLS)
def test_rnn_serve_matches_jax(arch):
    """Two chained ``compute_actions`` calls: argmax actions bit-equal,
    the carry within 1e-5; the sampled path on one key; the zero initial
    state."""
    cfg = small_config()
    jm, params, m = flax_and_port(cfg, arch, seed=3)
    jpol, pol = JPolicy(cfg, jm, params, arch=arch), Policy(cfg, m)
    assert pol.recurrent and pol.arch == arch
    j_state, state = jpol.initial_state(6), pol.get_initial_state(6)
    for a, b in zip(leaves(state), leaves(j_state)):
        assert a.shape == b.shape and not a.any()
    r = np.random.default_rng(1)
    for call in range(2):
        obs = r.random((6, cfg.num_agents, cfg.obs_dim), np.float32)
        j_acts, j_state = jpol.compute_actions(obs, j_state)
        acts, state = pol.compute_actions(obs, state)
        assert acts.dtype == torch.int32
        assert_bits(j_acts, acts, f"call {call} actions")
        for a, b in zip(leaves(state), leaves(j_state)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)
    # No state given: the policy starts from its initial state.
    a0, s0 = pol.compute_actions(obs)
    a1, s1 = pol.compute_actions(obs, pol.initial_state(6))
    assert torch.equal(a0, a1)
    assert all(torch.equal(x, y) for x, y in zip(leaves(s0), leaves(s1)))
    single, _ = pol.compute_single_action(obs[0])
    np.testing.assert_array_equal(single, a0[0].numpy())
    e1, _ = pol.compute_actions(obs, explore=True, seed=7)
    e2, _ = pol.compute_actions(obs, explore=True, seed=7)
    assert torch.equal(e1, e2)
    with pytest.raises(ValueError):
        Policy(cfg, m, arch="mlp")


# ---- the port's own config, and the card by default ----------------------------

@pytest.mark.parametrize("name", ["EnvConfig", "TrainConfig"])
def test_config_copy_equals_the_jax_package_field_by_field(name):
    jc, tc = getattr(jconfig, name), getattr(tconfig, name)
    assert jc is not tc
    jf, tf = dataclasses.fields(jc), dataclasses.fields(tc)
    assert [(f.name, f.type, f.default) for f in jf] == [
        (f.name, f.type, f.default) for f in tf]
    kw = (dict(height=7, num_agents=3, walls=(1, 2)) if name == "EnvConfig"
          else dict(num_envs=64, hidden_dim=32, pallas_block=128,
                    mask_actions=True))
    assert dataclasses.asdict(jc(**kw)) == dataclasses.asdict(tc(**kw))
    assert jc(**kw).to_json() == tc(**kw).to_json()


@pytest.mark.parametrize("preset", ["small_config", "medium_config",
                                    "large_config", "shelves_config"])
def test_config_presets_equal_the_jax_package(preset):
    j, t = getattr(jconfig, preset)(), getattr(tconfig, preset)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert (j.obs_dim, j.window_size, j.num_actions) == (
        t.obs_dim, t.window_size, t.num_actions)
    assert (jconfig.ADAM_B1, jconfig.ADAM_B2, jconfig.ADAM_EPS) == (
        tconfig.ADAM_B1, tconfig.ADAM_B2, tconfig.ADAM_EPS)


def _entry_points():
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.evaluate import evaluate_policy, policy_fn_for
    from warehouse_tpu_torch.evaluate import main as eval_main
    from warehouse_tpu_torch.train import (make_train, make_train_impala,
                                           make_train_rnn)
    from warehouse_tpu_torch.train.__main__ import main as train_main

    cfg = tconfig.small_config(max_steps=8)
    tcfg = TrainConfig(num_envs=4, unroll_length=4, num_minibatches=2,
                       hidden_dim=8, impala_rmsprop=False)
    return {
        "make_train": lambda **kw: make_train(cfg, tcfg, **kw),
        "make_train_impala": lambda **kw: make_train_impala(cfg, tcfg, **kw),
        "make_train_rnn": lambda **kw: make_train_rnn(cfg, tcfg, "gru", **kw),
        "make_model": lambda **kw: make_model(cfg, hidden_dim=8, **kw),
        "make_model_rnn": lambda **kw: make_model(cfg, "lstm", 8, **kw),
        "evaluate_policy": lambda **kw: evaluate_policy(
            cfg, policy_fn_for("greedy", cfg), 2, **kw),
        "train_cli": lambda **kw: train_main(
            ["--env", "small", "--num-envs", "4", "--num-updates", "1",
             "--metrics-path", "/dev/null"]
            + (["--cpu"] if kw else [])),
        "evaluate_cli": lambda **kw: eval_main(
            ["--env", "small", "--episodes", "2"]
            + (["--device", "cpu"] if kw else [])),
    }


@pytest.mark.parametrize("name", [
    "make_train", "make_train_impala", "make_train_rnn", "make_model",
    "make_model_rnn", "evaluate_policy", "train_cli", "evaluate_cli"])
def test_entry_points_need_the_card_unless_asked_for_the_cpu(name,
                                                             monkeypatch):
    """With no CUDA device each entry point raises (a CLI exits non-zero)
    and names the fix; with ``device="cpu"`` / ``--cpu`` / ``--device
    cpu`` it runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises((RuntimeError, SystemExit)) as e:
        call()
    if isinstance(e.value, SystemExit):
        assert e.value.code not in (0, None)
    assert "cpu" in str(e.value) and "CUDA" in str(e.value)
    call(device="cpu")

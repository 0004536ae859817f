"""The per-step acting phase (``train.ppo.step_rollout``, ROADMAP M-4b), on
the CPU, against the JAX trainers' XLA route.

Where no acting kernel takes a configuration, the JAX trainer resolves its
acting phase to the XLA scan (``warehouse_tpu/train/ppo.py:431-476``,
``train/impala.py:279-312``); the port acts through ``step_rollout`` on
every device, names the route ``"step"`` in ``backends``, and keeps the
learner kernel where the JAX gate keeps its own (on the CPU, its twin).
Each case runs 3 updates from one carried-over state (JAX on the CPU
resolves ``auto`` to XLA): env state, obs and keys bit-equal after every
update (no action flipped, every key split the JAX scaffold's), metrics
within 2e-4 + 1e-3 relative, params and the first moment at the bounds of
``tests/test_torch_m4.py``, the bf16 case in norm (``BF16_NORM``).

``max_steps = 6`` at T = 4 ends an episode inside the second chunk (the
in-step reset: every env's ``t`` is 2 after it) and on the third chunk's
last step. Held here: PPO with the MLP and the CNN, each with
``bootstrap_truncated`` too, masked and shaped on a walled map, the CNN
with global observations on the 11x11 shelves map (both phases plain, as
the JAX VMEM gates send them to XLA); IMPALA with global observations (K5's
twin learning from the per-step phase), bf16 (both phases plain), ragged
(K5's twin with a ``done`` inside the chunk), the CNN and the attention
torso (both plain). The attention torso's PPO cases are in
``tests/test_torch_attn.py``, the recurrent ones in
``tests/test_torch_step_acting_rnn.py``.
"""

import jax
import numpy as np
import pytest

from warehouse_tpu.config import EnvConfig, TrainConfig, shelves_config
from warehouse_tpu.config import small_config
from warehouse_tpu.train.impala import make_train_impala as j_make_impala
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.train import (impala_runner_state_from_jax,
                                       make_train, make_train_impala,
                                       runner_state_from_jax)
from warehouse_tpu_torch.train.impala import rollout_problems_impala
from warehouse_tpu_torch.train.ppo import grad_problems, rollout_problems

from test_torch_m4 import BF16_NORM, assert_norm, assert_tree, moments
from test_torch_rng import assert_bits

RAGGED = small_config(max_steps=6)
WALLED = EnvConfig(height=5, width=5, num_agents=2, queue_capacity=4,
                   init_requests=2, spawn_prob=0.5, walls=(10, 11, 13, 14),
                   max_steps=6)
BASE = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   kl_coeff=0.1, entropy_coef_final=0.001)
STEP_PLAIN = {"rollout": "step", "grad": "plain"}


def run_ragged(jtr, tr, rs, jrs, ts_after=(4, 2, 0), n=3):
    """n updates on both: env state, obs and keys bit-equal after each,
    metrics within 2e-4 + 1e-3 relative; every env's ``t`` after update u
    is ``ts_after[u]`` (at max_steps 6 and T = 4 the second chunk resets
    in its second step)."""
    for u in range(n):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert_bits(jrs.obs, rs.obs, f"update {u} obs")
        assert bool((rs.env_state.t == ts_after[u]).all()), (u, rs.env_state.t)
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    return rs, jrs


def assert_learned(rs, jrs, bf16=False, adam=True):
    """Params (and Adam's first moment) against the JAX trainer's."""
    params = params_from_flax(jax.tree.map(np.asarray, jrs.params))
    if bf16:
        assert_norm(rs.params, params, *BF16_NORM["params"], "params")
    else:
        assert_tree(rs.params, params, 2e-4, 5e-5, "params")
    if not adam:
        return
    mu, want = moments(rs.opt_state, jrs.opt_state, jrs.params)
    if bf16:
        assert_norm(mu, want, *BF16_NORM["mu"], "mu")
    else:
        assert_tree(mu, want, 2e-4, 5e-6, "mu")


PPO_CASES = {
    # name: (env, arch, TrainConfig change, num_envs, t after each update)
    "mlp_ragged": (RAGGED, "mlp", {}, 16, (4, 2, 0)),
    "cnn_ragged": (RAGGED, "cnn", {}, 16, (4, 2, 0)),
    "mlp_ragged_bootstrap": (RAGGED, "mlp", dict(bootstrap_truncated=True),
                             16, (4, 2, 0)),
    "cnn_ragged_bootstrap": (RAGGED, "cnn", dict(bootstrap_truncated=True),
                             16, (4, 2, 0)),
    "mlp_walled_masked_shaped": (WALLED, "mlp", dict(
        mask_actions=True, shaping_coef=0.1), 16, (4, 2, 0)),
    # The 11x11 global CNN: both phases plain, no episode end inside.
    "cnn_global_shelves": (shelves_config(max_steps=8, global_obs=True),
                           "cnn", {}, 8, (4, 0, 4)),
}


@pytest.mark.parametrize("case", sorted(PPO_CASES))
def test_ppo_step_acting_matches_jax_xla(case):
    cfg, arch, change, B, ts = PPO_CASES[case]
    tcfg = BASE.replace(num_envs=B, **change)
    jtr = j_make_train(cfg, tcfg, arch=arch)
    assert jtr.backends == {"rollout": "xla", "grad": "xla"}
    tr = make_train(cfg, tcfg, arch=arch, device="cpu")
    assert rollout_problems(cfg, tcfg, arch) and tr.backends == STEP_PLAIN
    # The learner kernel where the JAX gate keeps its own: its twin here.
    assert bool(grad_problems(cfg, tcfg, arch, None)) == (
        case == "cnn_global_shelves")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    rs, jrs = run_ragged(jtr, tr, rs, jrs, ts)
    assert_learned(rs, jrs)


IMPALA_CASES = {
    # name: (env, arch, TrainConfig change, t after each update)
    "global_obs": (small_config(max_steps=8, global_obs=True), "mlp", {},
                   (4, 0, 4)),
    "bf16": (small_config(max_steps=8), "mlp", dict(model_dtype="bfloat16"),
             (4, 0, 4)),
    "ragged": (RAGGED, "mlp", {}, (4, 2, 0)),
    "ragged_bootstrap": (RAGGED, "mlp", dict(bootstrap_truncated=True),
                         (4, 2, 0)),
    "cnn": (RAGGED, "cnn", {}, (4, 2, 0)),
    "attn": (RAGGED, "attn", {}, (4, 2, 0)),
}


@pytest.mark.parametrize("case", sorted(IMPALA_CASES))
def test_impala_step_acting_matches_jax_xla(case):
    """K5's twin learns where the JAX gate keeps its kernel (the MLP in
    float32: global observations, a ``done`` inside the chunk); the bf16
    model, the CNN and the attention torso learn plain, at the model's
    precision."""
    cfg, arch, change, ts = IMPALA_CASES[case]
    tcfg = BASE.replace(impala_rmsprop=False, **change)
    jtr = j_make_impala(cfg, tcfg, arch=arch)
    tr = make_train_impala(cfg, tcfg, arch=arch, device="cpu")
    assert rollout_problems_impala(cfg, tcfg, arch)
    assert tr.backends == STEP_PLAIN
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = impala_runner_state_from_jax(jax.tree.map(np.asarray, jrs), tcfg)
    rs, jrs = run_ragged(jtr, tr, rs, jrs, ts)
    assert_learned(rs, jrs, bf16=case == "bf16")


@pytest.mark.parametrize("bootstrap", [False, True])
def test_step_rollout_matches_a_step_by_step_loop(bootstrap):
    """``step_rollout`` makes its draws in bulk and remakes the env draws
    after a tick where some env reset: with episodes ending at different
    ticks of the chunk (each env's ``t`` moved to its own distance from
    the end), its trajectory, state, keys and observations are bit-equal
    to a loop that splits the key, samples and steps one tick at a time
    (``sample_action``, ``step_autoreset_batch`` drawing from the state's
    keys), shaped and masked on the walled map."""
    import torch

    from warehouse_tpu_torch import rng
    from warehouse_tpu_torch.config import EnvConfig as TEnvConfig
    from warehouse_tpu_torch.config import TrainConfig as TTrainConfig
    from warehouse_tpu_torch.env.batch import reset_batch, step_autoreset_batch
    from warehouse_tpu_torch.models import make_model
    from warehouse_tpu_torch.models.policy import apply
    from warehouse_tpu_torch.ops.move import valid_action_mask
    from warehouse_tpu_torch.ops.pathing import potential
    from warehouse_tpu_torch.ops.ppo_update import NEG_INF, sample_action
    from warehouse_tpu_torch.train.ppo import step_rollout

    cfg = TEnvConfig(height=5, width=5, num_agents=2, queue_capacity=4,
                     init_requests=2, spawn_prob=0.5, walls=(10, 11, 13, 14),
                     max_steps=6)
    tcfg = TTrainConfig(mask_actions=True, shaping_coef=0.1,
                        bootstrap_truncated=bootstrap)
    B, T = 12, 8
    state, obs = reset_batch(cfg, rng.fold_in(rng.prng_key(3),
                                              torch.arange(B)))
    state = state.replace(t=torch.arange(B, dtype=torch.int32) % 6)
    params = dict(make_model(cfg, hidden_dim=16, device="cpu",
                             generator=torch.Generator().manual_seed(0))
                  .named_parameters())
    key = rng.prng_key(4)

    def policy(o, c):
        return (*apply(params, o), None)

    got = step_rollout(cfg, tcfg, policy, state, obs, T, key)
    s, o, k, rows = state, obs, key, []
    with torch.no_grad():
        for _ in range(T):
            k, akey = rng.split(k, 2)
            logits, value = apply(params, o)
            mask = valid_action_mask(cfg, s.agent_pos)
            action, lp = sample_action(akey, torch.where(mask, logits,
                                                         NEG_INF))
            phi = potential(cfg, s)
            s, ts = step_autoreset_batch(cfg, s, action)
            done = ts.truncated[:, None].float()
            shaped = ts.reward + np.float32(0.1) * (
                np.float32(0.99) * potential(cfg, s) * (1.0 - done) - phi)
            boot = apply(params, ts.final_obs)[1] if bootstrap else (
                torch.zeros_like(value))
            rows.append((o, action, lp, value, shaped, ts.truncated, boot))
            o = ts.obs
    new, roll, last_obs, next_key, boot, _ = got
    want = [torch.stack(x) for x in zip(*rows)]
    assert int(want[5].sum()) > B  # some envs end twice, at other ticks
    for g, w in zip((roll.obs, roll.action, roll.log_prob, roll.value,
                     roll.reward, roll.truncated, boot), want):
        assert torch.equal(g, w)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(new, f), getattr(s, f)), f
    assert torch.equal(last_obs, o) and torch.equal(next_key, k)

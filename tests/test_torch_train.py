"""The port's PPO trainer against the JAX trainer, its gates, and its CLI.

The trainer case carries a JAX ``RunnerState`` into the port
(``runner_state_from_jax``) and runs 3 updates on both from it: the JAX
single-device trainer on the CPU (XLA backends, env minibatches, one
shuffle per update) and the port on the CPU (the plain twins of K2 and
K3). Seed 0 was chosen with no action flip: the logits differ from XLA's
by ulps, and one flipped sample would make the env states diverge, so the
bit-equal env states, keys and deliveries after every update are what
shows that none flipped. Metrics and params are held to the JAX suite's
own bounds for two SGD backends (``tests/test_grad_kernel.py``): 2e-4 +
1e-3 relative, and rtol 2e-4 / atol 5e-5.
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.parallel.distributed import process_group
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.train import make_train, runner_state_from_jax
from warehouse_tpu_torch.train.__main__ import main as cli_main

from test_torch_rng import assert_bits, to_torch

CFG = small_config(max_steps=8)
BASE = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   kl_coeff=0.1, entropy_coef_final=0.001)


def assert_params(port, jax_params, rtol, atol, what=""):
    from warehouse_tpu_torch.models import params_from_flax

    want = params_from_flax(jax.tree.map(np.asarray, jax_params))
    for k, v in want.items():
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


@pytest.mark.parametrize("bootstrap", [False, True])
def test_train_steps_match_jax_trainer(bootstrap):
    tcfg = BASE.replace(bootstrap_truncated=bootstrap)
    jtr = j_make_train(CFG, tcfg)
    tr = make_train(CFG, tcfg, device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    assert rs.key.shape == (2,) and rs.opt_state.count == 0
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
        assert float(m["deliveries_per_env_step"]) == float(
            jm["deliveries_per_env_step"])
    assert int(rs.update_idx) == int(jrs.update_idx) == 3
    assert rs.opt_state.count == 3 * BASE.ppo_epochs * BASE.num_minibatches
    assert_params(rs.params, jrs.params, 2e-4, 5e-5, "params")
    _, mu, _ = find_adam_state(jrs.opt_state)
    assert_params(rs.opt_state.mu, mu, 2e-4, 5e-6, "mu")


def test_masked_train_steps_match_jax_trainer():
    """``mask_actions=True``: K2's twin floors the invalid moves, the SGD
    phase re-applies the mask; held to the JAX trainer as above."""
    tcfg = BASE.replace(mask_actions=True)
    jtr = j_make_train(CFG, tcfg)
    tr = make_train(CFG, tcfg, device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    for u in range(3):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    assert_params(rs.params, jrs.params, 2e-4, 5e-5, "params")


@pytest.mark.parametrize("layout", ["small", "walled"])
def test_shaped_masked_train_steps_match_jax_trainer(layout):
    """``mask_actions=True, shaping_coef=0.02`` with ``max_steps = 2 *
    unroll_length``, so the 3 updates cross an episode boundary: the JAX
    trainer's XLA route takes ``phi`` of the next state after the
    auto-reset and cuts it by ``1 - done``; the port takes it on the
    pre-reset state inside the acting twin and cuts it the same way. Env
    state, keys and deliveries bit-equal, metrics (``reward_per_step`` is
    the raw reward's) and params at this file's tolerances."""
    from warehouse_tpu.config import EnvConfig

    cfg = CFG if layout == "small" else EnvConfig(
        height=5, width=5, num_agents=2, queue_capacity=4, init_requests=2,
        spawn_prob=0.5, walls=(10, 11, 13, 14), max_steps=8)
    tcfg = BASE.replace(mask_actions=True, shaping_coef=0.02)
    jtr = j_make_train(cfg, tcfg.replace(rollout_backend="xla",
                                         grad_backend="xla"))
    tr = make_train(cfg, tcfg, device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    raw = []
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
        assert float(m["deliveries_per_env_step"]) == float(
            jm["deliveries_per_env_step"])
        raw.append(float(m["reward_per_step"]))
    assert int(rs.env_state.t[0]) == 4  # 12 steps: one boundary crossed
    assert_params(rs.params, jrs.params, 2e-4, 5e-5, "params")
    # The shaping changed what was learned, not what was reported: the
    # unshaped run from the same state reports the same first raw reward.
    plain = make_train(cfg, BASE.replace(mask_actions=True), device="cpu")
    rs0 = runner_state_from_jax(jax.tree.map(
        np.asarray, jtr.init(jax.random.PRNGKey(0))))
    rs1, m0 = plain.train_step(rs0)
    assert float(m0["reward_per_step"]) == raw[0]
    shaped1, _ = tr.train_step(rs0)
    assert any(not torch.equal(rs1.params[k], shaped1.params[k])
               for k in rs1.params)


def test_init_matches_jax_init():
    """Env resets from fold_in(ekey, i) and the shard key fold_in(skey, 0)
    bit-equal; the params come from a torch.Generator (not flax's bits)."""
    jrs = j_make_train(CFG, BASE).init(jax.random.PRNGKey(3))
    tr = make_train(CFG, BASE, device="cpu")
    rs = tr.init(rng.prng_key(3))
    for f in STATE_FIELDS:
        assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f), f)
    assert_bits(jrs.obs, rs.obs, "obs")
    assert torch.equal(rs.key, to_torch(jrs.key).reshape(2))
    assert rs.params.keys() == tr.model.state_dict().keys()
    again = tr.init(rng.prng_key(3))
    assert all(torch.equal(rs.params[k], again.params[k]) for k in rs.params)


def test_train_many_runs_and_learns_something():
    tr = make_train(CFG, BASE, device="cpu")
    rs0 = tr.init(rng.prng_key(1))
    rs, ms = tr.train_many(rs0, 2)
    assert int(rs.update_idx) == 2
    assert all(v.shape == (2,) and bool(torch.isfinite(v).all())
               for v in ms.values())
    assert any(not torch.equal(rs.params[k], rs0.params[k])
               for k in rs.params)
    # plain_step is the same update through the twins: on the CPU, equal.
    a, ma = tr.train_step(rs0)
    b, mb = tr.plain_step(rs0)
    assert torch.equal(a.env_state.agent_pos, b.env_state.agent_pos)
    assert float(ma["loss"]) == pytest.approx(float(mb["loss"]), rel=1e-6)


STEP_ROUTE = {"rollout": "step", "grad": "plain"}


# Each case keeps the id it had while it was refused: the attention torso
# and an unroll length that does not divide max_steps are built now, acting
# per step; a mesh (a world-1 gloo group) takes the meshed route.
@pytest.mark.parametrize("change, error", [
    pytest.param(dict(arch="attn"), None, id="change0-NotImplementedError"),
    (dict(policy_groups=(0, 1)), None),  # ported: the trainer is built
    pytest.param(dict(mesh=True), None, id="change2-NotImplementedError"),
    (dict(model_dtype="bfloat16"), None),  # ported: the trainer is built
    (dict(minibatch_mode="flat"), None),  # ported: the learner runs plain
    (dict(epoch_shuffle="each"), None),  # ported: the learner runs plain
    (dict(micro_batches=2), None),  # ported: the learner runs plain
    (dict(flat_optimizer=True), None),  # ported: the learner runs plain
    (dict(global_obs=True), None),  # ported: the trainer is built
    (dict(rollout_backend="xla"), ValueError),
    (dict(grad_backend="xla"), ValueError),
    (dict(num_envs=15), ValueError),
    pytest.param(dict(unroll_length=3), None, id="change12-ValueError"),
])
def test_gates_raise(change, error, tmp_path):
    change = dict(change)
    kw = {k: change.pop(k) for k in ("arch", "policy_groups", "mesh")
          if k in change}
    cfg = CFG.replace(global_obs=change.pop("global_obs", False))
    if kw.pop("mesh", False):
        # A world-1 data mesh: the meshed route runs (K4's gradient
        # averaged over one rank, then the step).
        with process_group(tmp_path / "store") as mesh:
            tr = make_train(cfg, BASE.replace(**change), device="cpu",
                            mesh=mesh, **kw)
            assert tr.mesh is mesh
            assert tr.backends == {"rollout": "plain", "grad": "plain"}
            rs, m = tr.train_step(tr.init_global(rng.prng_key(0)))
            assert int(rs.update_idx) == 1 and all(
                bool(torch.isfinite(v)) for v in m.values())
        return
    if error is None:
        tr = make_train(cfg, BASE.replace(**change), device="cpu", **kw)
        assert tr.policy_groups == kw.get("policy_groups")
        if kw.get("arch") == "attn" or "unroll_length" in change:
            # Acting per step, the learner plain; one update runs.
            assert tr.backends == STEP_ROUTE
            rs, m = tr.train_step(tr.init(rng.prng_key(0)))
            assert int(rs.update_idx) == 1 and all(
                bool(torch.isfinite(v)) for v in m.values())
            return
        assert tr.backends == {"rollout": "plain", "grad": "plain"}
        model = tr.model.policies[1] if tr.policy_groups else tr.model
        assert model.hidden[0].in_features == cfg.obs_dim == (
            131 if cfg.global_obs else 106)
        return
    with pytest.raises(error):
        make_train(cfg, BASE.replace(**change), device="cpu", **kw)


def test_cli_runs_two_updates(tmp_path):
    path = tmp_path / "metrics.jsonl"
    cli_main(["--env", "small", "--env-config", '{"max_steps": 8}',
              "--num-envs", "16", "--unroll-length", "4", "--num-updates",
              "2", "--num-minibatches", "2", "--ppo-epochs", "2",
              "--hidden-dim", "16", "--log-every", "1", "--eval-every", "2",
              "--eval-episodes", "4", "--device", "cpu", "--metrics-path",
              str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["meta"] and recs[0]["device"] == "cpu"
    steps = [r for r in recs[1:] if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["env_steps_per_sec"] > 0 for r in steps)
    assert any("eval_mean_episode_return" in r for r in recs)


# The flags the CLI now takes (the id of each case kept): each runs one
# small update on the CPU instead of exiting, the first five through the
# per-step acting phase, M-6's two through the plain twins.
LIFTED_FLAGS = ({"--global-obs"}, {"--arch", "attn"}, {"--model-dtype"},
                {"--shaping-coef"}, {"--bootstrap-truncated"},
                {"--tensorboard-dir"}, {"--profile-dir"})
M6_FLAGS = ({"--tensorboard-dir"}, {"--profile-dir"})


@pytest.mark.parametrize("flags", [["--algo", "impala", "--global-obs"],
                                   ["--arch", "attn"],
                                   ["--algo", "impala", "--policy-groups",
                                    "0,1"],
                                   ["--tensorboard-dir", "tb"],
                                   ["--algo", "impala", "--model-dtype",
                                    "bfloat16"],
                                   ["--arch", "gru", "--shaping-coef",
                                    "0.1"],
                                   ["--profile-dir", "p"],
                                   ["--arch", "gru", "--bootstrap-truncated"],
                                   ["--grad-backend", "xla"]])
def test_cli_exits_on_unported_flags(flags, tmp_path, monkeypatch):
    """The flags still refused exit non-zero (the JAX CLI's own gate on
    IMPALA with policy groups, the 'xla' backend); the ones this port has
    since taken (IMPALA with global observations or bf16, the attention
    torso, the recurrent trainer's shaping and bootstrap, all through the
    per-step acting phase; M-6's ``--tensorboard-dir`` and
    ``--profile-dir``, whose relative directories land in the working
    directory) run, and the meta line names the route."""
    path = tmp_path / "m.jsonl"
    monkeypatch.chdir(tmp_path)
    if any(set(flags) >= lifted for lifted in LIFTED_FLAGS):
        cli_main(["--env", "small", "--env-config", '{"max_steps": 8}',
                  "--num-envs", "8", "--unroll-length", "4",
                  "--num-updates", "1", "--num-minibatches", "2",
                  "--ppo-epochs", "1", "--hidden-dim", "16", "--device",
                  "cpu", "--metrics-path", str(path), *flags])
        meta = json.loads(path.read_text().splitlines()[0])
        m6 = any(set(flags) >= lifted for lifted in M6_FLAGS)
        assert meta["backends"] == (
            {"rollout": "plain", "grad": "plain"} if m6 else STEP_ROUTE), meta
        return
    with pytest.raises(SystemExit) as e:
        cli_main(["--num-envs", "16", "--device", "cpu", "--metrics-path",
                  str(path), *flags])
    assert e.value.code not in (0, None)


def test_cli_module_runs():
    """``python -m warehouse_tpu_torch.train --help`` in a fresh process."""
    out = subprocess.run([sys.executable, "-m", "warehouse_tpu_torch.train",
                          "--help"], capture_output=True, text=True,
                         timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout

"""The env kernels at (agents, queue) pairs outside the presets (ROADMAP
T-5) on the CPU: their plain twins, and ``kernels/build.py``'s library for
a pair.

At (6, 8) (medium with 6 agents) and (12, 24) (the 15x15 map with 12
agents), B = 8, T = 8, from a batched reset:

- K1's twin (``greedy_rollout`` on a CPU state) against
  ``greedy_rollout_pallas`` in interpret mode at (6, 8), and against a scan
  of the JAX engine under the JAX greedy policy at both pairs: every state
  field and the deliveries bit-equal (the reward sum within an ulp a step:
  XLA on the CPU contracts its multiply-add chain, as
  ``test_torch_rollout.py`` says);
- K2's (MLP), K10's (CNN) and K7's (GRU) twins (``act_steps`` /
  ``act_cnn_steps`` / ``act_rnn_steps`` on CPU tensors), and K2's with one
  policy per agent at (12, 24), against the JAX package's XLA route on
  the same gumbel noise (``rng.batched_gumbel_stream``): the flax model on
  the JAX engine's observations, the first argmax of logits + noise, the
  JAX engine's step. Observations, actions, rewards, deliveries and the
  env fields are bit-equal; values within 1e-5 and log-probs within 1e-4
  (float32 sums in another order), as ``test_torch_act.py`` holds them.
  The Pallas acting kernels are not run here: in interpret mode their
  unrolled trace at 6 agents takes more than 8 minutes to compile on a
  CPU host (K1's at 12 agents more than 10 minutes and 13 GB); the JAX
  tests hold them to this XLA route.

``build.pair_library``'s name, compile commands, log and refusals run with
``subprocess`` mocked, since the CPU has no ``nvcc``.
"""

import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import config as jconfig
from warehouse_tpu import rng as jrng
from warehouse_tpu.baselines.greedy import greedy_actions as j_greedy
from warehouse_tpu.env import batch as jbatch
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.models import make_multi_policy_model as j_multi
from warehouse_tpu.pallas.rollout import greedy_rollout_pallas
from warehouse_tpu_torch import config
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import act, build
from warehouse_tpu_torch.kernels.act_rnn import act_rnn_steps
from warehouse_tpu_torch.kernels.rollout import greedy_rollout
from warehouse_tpu_torch.models import (make_model, make_multi_policy_model,
                                        params_from_flax)

from test_torch_env import assert_state, env_keys
from test_torch_rng import assert_bits, to_torch

B, T, HIDDEN = 8, 8, 16
PAIRS = {"a6q8": ("medium", {"num_agents": 6}),
         "a12q24": ("large", {"num_agents": 12, "queue_capacity": 24,
                              "init_requests": 12})}


def configs(pair, **kw):
    preset, over = PAIRS[pair]
    return (getattr(jconfig, f"{preset}_config")(**over, **kw),
            getattr(config, f"{preset}_config")(**over, **kw))


def resets(pair, seed=0, **kw):
    jcfg, cfg = configs(pair, **kw)
    jk, tk = env_keys(seed, n=B)
    js, _ = jbatch.reset_batch(jcfg, jk)
    ts, _ = batch.reset_batch(cfg, tk)
    return jcfg, cfg, js, ts


def assert_env_fields(js, ts, what):
    for f in STATE_FIELDS[:-2]:  # t and key are the wrappers'
        assert_bits(getattr(js, f), getattr(ts, f), f"{what} {f}")


# ---- K1 --------------------------------------------------------------------

def test_k1_twin_matches_pallas_interpret_at_6_agents():
    jcfg, cfg, js, ts = resets("a6q8", max_steps=10**9)
    new, deliv, rew = greedy_rollout(cfg, ts, T)
    p_state, p_deliv, p_rew = greedy_rollout_pallas(jcfg, js, T, B, True)
    assert_state(p_state, new, "vs pallas")
    assert_bits(p_deliv, deliv, "delivered vs pallas")
    ulp = np.spacing(np.abs(np.asarray(p_rew)).max() + 1)
    np.testing.assert_allclose(rew.numpy(), np.asarray(p_rew), rtol=0,
                               atol=T * ulp)


j_greedy_batch = jax.jit(jax.vmap(j_greedy, in_axes=(None, 0)),
                         static_argnums=0)


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_k1_twin_matches_engine_scan(pair):
    """T greedy ticks of the JAX engine from the same resets: the final
    state, t and key included, and each env's deliveries."""
    jcfg, cfg, js, ts = resets(pair, seed=2, max_steps=10**9)
    new, deliv, _ = greedy_rollout(cfg, ts, 3 * T)
    total = np.zeros(B, np.int64)
    for _ in range(3 * T):
        js, jts = jbatch.step_batch(jcfg, js, j_greedy_batch(jcfg, js))
        total += np.asarray(jts.delivered).sum(-1)
    assert_state(js, new, "vs engine scan")
    np.testing.assert_array_equal(total, deliv.numpy())


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_evaluate_greedy_is_evaluate_policy_through_k1(pair):
    """The evaluate CLI's greedy baseline (one ``greedy_rollout`` an
    episode batch) against ``evaluate_policy`` under ``greedy_actions``:
    deliveries equal, returns within 1e-6 relative (K1 sums the team's
    reward a step, ``evaluate_policy`` each agent's)."""
    from warehouse_tpu_torch.evaluate import (evaluate_greedy,
                                              evaluate_policy, policy_fn_for)

    _, cfg = configs(pair, max_steps=24)
    got = evaluate_greedy(cfg, B, seed=3, device="cpu")
    want = evaluate_policy(cfg, policy_fn_for("greedy", cfg), B, seed=3,
                           device="cpu")
    assert got.keys() == want.keys()
    assert (got["mean_deliveries_per_episode"]
            == want["mean_deliveries_per_episode"] > 0)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6), k


# ---- K2, K10, K7 against the XLA route ------------------------------------

def xla_act(jcfg, apply, js, g, A, carry=None):
    """The JAX XLA acting route on the gumbel noise ``g [T, 5, B*A]``:
    ``apply(obs[, carry]) -> (logits, value[, carry])`` on the JAX
    engine's observations, the first argmax of logits + noise, the stable
    log-softmax, the engine's step. Returns the final state, the stacked
    (obs, action, log_prob, value, reward, delivered) and the carry."""
    obs = jbatch.observe_batch(jcfg, js)
    outs = []
    for t in range(g.shape[0]):
        if carry is None:
            logits, value = apply(obs)
        else:
            logits, value, carry = apply(obs, carry)
        z = logits + jnp.transpose(g[t]).reshape(B, A, 5)
        action = jnp.argmax(z, -1).astype(jnp.int32)
        lp = jnp.take_along_axis(jax.nn.log_softmax(logits), action[..., None],
                                 -1)[..., 0]
        js, ts = jbatch.step_batch(jcfg, js, action)
        outs.append((obs, action, lp, value, ts.reward,
                     ts.delivered.sum(-1).astype(jnp.int32)))
        obs = ts.obs
    return js, [np.stack([np.asarray(o[i]) for o in outs])
                for i in range(6)], carry


def draws(cfg, ts, A):
    from warehouse_tpu_torch import rng

    _, u, pick, drop, _ = rng.batched_step_draws(ts.key, cfg, T)
    _, g = jrng.batched_gumbel_stream(jax.random.PRNGKey(7), T, (5, B * A))
    return u, pick, drop, g


def assert_act(cfg, jnew, jouts, new, outs, what):
    obs, action, lp, value, reward, delivered = outs
    for name, want, got in zip(("obs", "action", "reward", "delivered"),
                               (jouts[0], jouts[1], jouts[4], jouts[5]),
                               (obs, action, reward, delivered)):
        assert_bits(want, got, f"{what} {name}")
    assert_env_fields(jnew, new, what)
    np.testing.assert_allclose(value.numpy(), jouts[3], rtol=0, atol=1e-5)
    np.testing.assert_allclose(lp.numpy(), jouts[2], rtol=0, atol=1e-4)
    assert int(delivered.sum()) >= 0 and action.shape == (T, B,
                                                          cfg.num_agents)


@pytest.mark.parametrize("arch", ["mlp", "cnn"])
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_k2_k10_twins_match_the_xla_route(pair, arch):
    jcfg, cfg, js, ts = resets(pair, seed=1)
    A = cfg.num_agents
    jm = j_make_model(jcfg, arch=arch, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, jcfg.obs_dim)))
    m = make_model(cfg, arch, HIDDEN, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    u, pick, drop, g = draws(cfg, ts, A)
    steps = act.act_cnn_steps if arch == "cnn" else act.act_steps
    new, *outs = steps(cfg, m, ts, u, pick, drop, to_torch(g))
    jnew, jouts, _ = xla_act(jcfg, lambda o: jm.apply(params, o), js, g, A)
    assert_act(cfg, jnew, jouts, new, outs, f"K{10 if arch == 'cnn' else 2}")


def test_k2_twin_one_policy_per_agent_at_12_agents():
    """Twelve policy groups, one per agent (the acting kernels take as many
    groups as agents past 8: ``act.max_groups``)."""
    jcfg, cfg, js, ts = resets("a12q24", seed=4)
    A, groups = cfg.num_agents, tuple(range(12))
    assert act.max_groups(cfg) == 12 == act._group_args(cfg, groups)[0]
    jm = j_multi(jcfg, groups, hidden_dim=HIDDEN)
    params = jm.init(jax.random.PRNGKey(5), jnp.zeros((1, jcfg.obs_dim)),
                     jnp.zeros(1, jnp.int32))
    m = make_multi_policy_model(cfg, groups, hidden_dim=HIDDEN, device="cpu")
    m.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in
                       params_from_flax(jax.tree.map(np.asarray,
                                                     params)).items()})
    u, pick, drop, g = draws(cfg, ts, A)
    new, *outs = act.act_steps(cfg, m, ts, u, pick, drop, to_torch(g),
                               groups=groups)
    gids = jnp.broadcast_to(jnp.arange(A), (B, A))
    jnew, jouts, _ = xla_act(jcfg, lambda o: jm.apply(params, o, gids), js,
                             g, A)
    assert_act(cfg, jnew, jouts, new, outs, "K2 per agent")
    with pytest.raises(ValueError, match=r"\[0, 12\)"):
        act._group_args(cfg, (12,) + groups[1:])


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_k7_twin_matches_the_xla_route(pair):
    """The GRU from a seeded random carry: the carry within 1e-5 too."""
    jcfg, cfg, js, ts = resets(pair, seed=6)
    A = cfg.num_agents
    jm = j_make_model(jcfg, arch="gru", hidden_dim=HIDDEN, num_layers=1)
    params = jm.init(jax.random.PRNGKey(8), jnp.zeros((1, jcfg.obs_dim)),
                     jm.initial_carry((1,)))
    m = make_model(cfg, "gru", HIDDEN, 1, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    h = 0.5 * np.random.default_rng(9).standard_normal(
        (B, A, HIDDEN)).astype(np.float32)
    u, pick, drop, g = draws(cfg, ts, A)
    new, carry, *outs = act_rnn_steps(cfg, dict(m.named_parameters()), ts,
                                      torch.from_numpy(h.copy()), u, pick,
                                      drop, to_torch(g))
    jnew, jouts, jcarry = xla_act(
        jcfg, lambda o, c: jm.apply(params, o, c), js, g, A,
        carry=jnp.asarray(h))
    assert_act(cfg, jnew, jouts, new, outs, "K7")
    np.testing.assert_allclose(carry.numpy(), np.asarray(jcarry), rtol=0,
                               atol=1e-5)


# ---- the pair's library ----------------------------------------------------

class FakeProc:
    """A finished ``nvcc`` with the given exit code."""

    def __init__(self, cmd, returncode):
        self.cmd, self.returncode = cmd, returncode

    def communicate(self):
        return "ptxas info : Used 40 registers", (
            "" if self.returncode == 0 else "error: something")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """``build`` with its build directory in ``tmp_path``, ``nvcc`` found,
    ``Popen`` / ``run`` recorded (each ``nvcc -c`` exits with
    ``codes[source]``, 0 by default; the link writes its output) and
    ``ctypes.CDLL`` a stand-in."""
    calls = {"popen": [], "run": [], "loaded": [], "codes": {}}
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "/x/nvcc")

    def popen(cmd, **kw):
        calls["popen"].append(cmd)
        return FakeProc(cmd, calls["codes"].get(cmd[-1].split("/")[-1], 0))

    def run(cmd, **kw):
        calls["run"].append(cmd)
        out = cmd[cmd.index("-o") + 1]
        open(out, "wb").close()
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class Lib:
        def __init__(self, path):
            calls["loaded"].append(path)

    monkeypatch.setattr(build.subprocess, "Popen", popen)
    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build.ctypes, "CDLL", Lib)
    build.pair_library.cache_clear()
    build.library.cache_clear()
    yield calls
    build.pair_library.cache_clear()
    build.library.cache_clear()


def test_pair_library_compiles_the_env_sources_for_the_pair(fake_build):
    lib = build.pair_library(6, 8)
    cmds = fake_build["popen"]
    assert sorted(c[-1].split("/")[-1] for c in cmds) == sorted(
        build.ENV_SOURCES)
    for c in cmds:
        assert c[:2] == ["/x/nvcc", *build.ARCH_FLAGS]
        assert "-DWH_PAIR_A=6" in c and "-DWH_PAIR_R=8" in c
        assert c[c.index("-o") + 1].endswith(".o") and "-c" in c
    (link,) = fake_build["run"]
    assert "-shared" in link
    name = f"libwarehouse_{build.pair_stem(6, 8)}.so"
    assert fake_build["loaded"] == [str(build.BUILD_DIR / name)]
    assert (build.BUILD_DIR / name).exists()
    assert "Used 40 registers" in build.build_log(6, 8)
    # A process builds a pair at most once; a preset takes the library.
    assert build.pair_library(6, 8) is lib and build.env_library(6, 8) is lib
    assert len(fake_build["popen"]) == 4
    build.env_library(4, 8)
    assert len(fake_build["popen"]) == 4 + len(list(build.CSRC.glob("*.cu")))
    assert all("-DWH_PAIR_A=4" not in c for c in fake_build["popen"][4:])


def test_pair_library_is_named_by_the_sources_and_the_pair(fake_build,
                                                           monkeypatch):
    a = build.pair_stem(6, 8)
    assert a.startswith("env-a6-q8-") and a != build.pair_stem(12, 24)
    monkeypatch.setattr(build, "_sources_digest", lambda: "0" * 16)
    assert build.pair_stem(6, 8) != a


def test_a_failed_pair_build_raises_with_its_log(fake_build):
    fake_build["codes"]["act.cu"] = 1
    with pytest.raises(RuntimeError, match="nvcc failed") as e:
        build.pair_library(12, 24)
    assert "act.cu (1)" in str(e.value) and "error: something" in str(
        e.value)
    assert str(build.BUILD_DIR / f"build-{build.pair_stem(12, 24)}.log") in (
        str(e.value))
    assert not fake_build["run"] and not fake_build["loaded"]
    assert not list(build.BUILD_DIR.glob("*.so"))


@pytest.mark.parametrize("A,R", [(0, 4), (129, 258), (4, 0)])
def test_pair_refusals(A, R, fake_build):
    with pytest.raises(ValueError, match="128 agents"):
        build.pair_library(A, R)
    assert not fake_build["popen"]


def test_act_entry_points_refuse_more_agents_than_an_env_stage_takes():
    cfg = config.medium_config(num_agents=130, queue_capacity=8,
                               init_requests=4, height=15, width=15)
    m = make_model(cfg, hidden_dim=HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="128 agents"):
        act.check_act_fits(cfg, m, torch.device("cpu"))


def test_grouped_learner_cap_is_refused_by_name():
    """K3 / K4 take a group map over at most 16 agents and 16 groups (4
    bits an agent in ``mlp_learner.cuh``), one policy per agent at (12,
    24) among them; past that the trainer's check names ROADMAP T-7."""
    from warehouse_tpu_torch.kernels import sgd

    for groups in (None, tuple(range(12)), tuple(range(16)), (0,) * 16):
        sgd.check_group_map(groups)
    for groups in (tuple(range(17)), (0,) * 17):
        with pytest.raises(ValueError, match="T-7"):
            sgd.check_group_map(groups)

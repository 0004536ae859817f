"""The port's NumPy oracle (``warehouse_tpu_torch/oracle``, ROADMAP M-10)
on the CPU.

``OracleEnv`` on ``TorchDrawSource`` against the JAX package's
``OracleEnv`` on ``JaxDrawSource``, and against the port's engine step
for step (as ``tests/test_parity.py`` holds the JAX pair), at the
(agents, queue) pairs (2, 4), (4, 8), (6, 8) and (12, 24): each on its
open map with the ego window and on the walled shelves layout with the
global view, both with the auto-reset inside the run. Every state field,
the draw key, the observations, rewards, flags and events are bit-equal.
``greedy_actions`` / ``greedy_bfs_actions`` equal the JAX oracle's, and
the dict-API wrapper's ``"oracle"`` backend equals the JAX wrapper's and
the port's ``"torch"`` backend, with the demo CLI on it.
"""

import jax
import numpy as np
import pytest
import torch

from warehouse_tpu import config as jconfig
from warehouse_tpu.env.wrapper import WarehouseMultiAgentEnv as JEnv
from warehouse_tpu.oracle import JaxDrawSource
from warehouse_tpu.oracle import OracleEnv as JOracleEnv
from warehouse_tpu.oracle import greedy_actions as j_greedy
from warehouse_tpu.oracle import greedy_bfs_actions as j_greedy_bfs
from warehouse_tpu_torch import config, rng
from warehouse_tpu_torch.env import engine
from warehouse_tpu_torch.env.wrapper import WarehouseMultiAgentEnv
from warehouse_tpu_torch.oracle import (NumpyDrawSource, OracleEnv,
                                        TorchDrawSource, greedy_actions,
                                        greedy_bfs_actions)

STEPS = 30      # steps of each run: past two auto-resets
MAX_STEPS = 12  # the episode length of every case
# (preset, overrides) of each pair on its open map; the walled case puts
# the same pair on the shelves layout (11 x 11, 18 wall cells).
PAIRS = {"a2q4": ("small", {}), "a4q8": ("medium", {}),
         "a6q8": ("medium", {"num_agents": 6}),
         "a12q24": ("large", {"num_agents": 12, "queue_capacity": 24,
                              "init_requests": 12})}
FIELDS = ("agent_pos", "agent_req", "carrying", "req_pickup", "req_drop",
          "req_status", "req_agent")


def configs(pair, walled):
    """(JAX config, port config) of a case: the open preset with the ego
    window, or the shelves layout with the global view; auto-reset on."""
    preset, kw = PAIRS[pair]
    kw = dict(kw, max_steps=MAX_STEPS, auto_reset=True)
    if walled:
        A = kw.get("num_agents",
                   getattr(config, f"{preset}_config")().num_agents)
        kw = {"queue_capacity": 2 * A, "init_requests": A, **kw,
              "num_agents": A, "global_obs": True}
        preset = "shelves"
    return (getattr(jconfig, f"{preset}_config")(**kw),
            getattr(config, f"{preset}_config")(**kw))


CASES = [(p, w) for p in PAIRS for w in (False, True)]
IDS = [f"{p}-{'walled_global' if w else 'open'}" for p, w in CASES]


def assert_oracle_state(want, got, what):
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f"{what} {f}")
    assert got.t == want.t, what


def actions(gen, A, t, state, cfg):
    """Greedy on even steps, seeded random moves on odd ones."""
    if t % 2 == 0:
        return greedy_actions(cfg, state)
    return gen.integers(0, 5, A)


@pytest.mark.parametrize("pair,walled", CASES, ids=IDS)
def test_oracle_matches_jax_oracle(pair, walled):
    jcfg, cfg = configs(pair, walled)
    seed = 3 + CASES.index((pair, walled))
    jsrc = JaxDrawSource(jax.random.PRNGKey(seed))
    src = TorchDrawSource(seed)
    jenv, env = JOracleEnv(jcfg, jsrc), OracleEnv(cfg, src)
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    gen = np.random.default_rng(seed)
    resets = 0
    for t in range(STEPS):
        assert_oracle_state(jenv.state, env.state, f"t={t}")
        np.testing.assert_array_equal(src.key.numpy(),
                                      np.asarray(jsrc._key, np.int64))
        a = actions(gen, cfg.num_agents, t, env.state, cfg)
        jo, jr, jterm, jtrunc, jinfo = jenv.step(a)
        o, r, term, trunc, info = env.step(a)
        assert o.dtype == np.float32 and r.dtype == np.float32
        np.testing.assert_array_equal(o, jo, err_msg=f"obs t={t}")
        np.testing.assert_array_equal(r, jr, err_msg=f"reward t={t}")
        assert (term, trunc) == (jterm, jtrunc)
        for k in jinfo:
            np.testing.assert_array_equal(info[k], jinfo[k], err_msg=k)
        resets += bool(trunc)
    assert resets == STEPS // MAX_STEPS
    assert o.shape == (cfg.num_agents, cfg.obs_dim)


@pytest.mark.parametrize("pair,walled", CASES, ids=IDS)
def test_oracle_matches_port_engine(pair, walled):
    """The oracle against ``engine.reset`` / ``engine.step`` at B = 1 from
    the same key, step for step across the auto-resets: the state, its
    key and t, observations, rewards, flags and events."""
    _, cfg = configs(pair, walled)
    key = rng.prng_key(7)
    src = TorchDrawSource(key)
    env = OracleEnv(cfg, src)
    obs = env.reset()
    state, eobs = engine.reset(cfg, key.reshape(1, 2))
    np.testing.assert_array_equal(obs, eobs[0].numpy())
    gen = np.random.default_rng(1)
    for t in range(STEPS):
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(env.state, f)),
                getattr(state, f)[0].numpy(), err_msg=f"{f} t={t}")
        assert env.state.t == int(state.t[0])
        assert torch.equal(src.key, state.key[0])
        a = actions(gen, cfg.num_agents, t, env.state, cfg)
        o, r, term, trunc, info = env.step(a)
        state, ts = engine.step(cfg, state,
                                torch.as_tensor(a, dtype=torch.int32)[None])
        np.testing.assert_array_equal(o, ts.obs[0].numpy(), f"obs t={t}")
        np.testing.assert_array_equal(r, ts.reward[0].numpy(),
                                      f"reward t={t}")
        assert (term, trunc) == (bool(ts.terminated[0]),
                                 bool(ts.truncated[0]))
        for k in ("picked", "delivered", "collided"):
            np.testing.assert_array_equal(info[k],
                                          getattr(ts, k)[0].numpy(), k)


@pytest.mark.parametrize("pair,walled", CASES, ids=IDS)
def test_greedy_actions_match_jax_oracle(pair, walled):
    """Both baselines on every state of a run, the open cases' greedy and
    the walled cases' BFS greedy driving it."""
    jcfg, cfg = configs(pair, walled)
    env = OracleEnv(cfg, TorchDrawSource(5))
    env.reset()
    acted = 0
    for t in range(STEPS):
        for port_fn, jax_fn, c, jc in (
                (greedy_actions, j_greedy, cfg, jcfg),
                (greedy_bfs_actions, j_greedy_bfs, cfg, jcfg)):
            got, want = port_fn(c, env.state), jax_fn(jc, env.state)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=f"t={t}")
        a = (greedy_bfs_actions if walled else greedy_actions)(cfg,
                                                               env.state)
        acted += int((a != 0).sum())
        env.step(a)
    assert acted > 0


def test_torch_draw_source_takes_a_seed_or_key_words():
    cfg = config.medium_config()
    a = OracleEnv(cfg, TorchDrawSource(9)).reset()
    b = OracleEnv(cfg, TorchDrawSource(rng.prng_key(9))).reset()
    c = OracleEnv(cfg, TorchDrawSource([0, 9])).reset()
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    with pytest.raises(AssertionError, match="no step"):
        TorchDrawSource(9).reset_from_step(cfg)


def test_numpy_draw_source_matches_jax_oracle_copy():
    """The standalone numpy stream is the JAX oracle's, draw for draw."""
    from warehouse_tpu.oracle import NumpyDrawSource as JNumpyDrawSource

    jcfg, cfg = configs("a6q8", True)
    jenv = JOracleEnv(jcfg, JNumpyDrawSource(4))
    env = OracleEnv(cfg, NumpyDrawSource(4))
    np.testing.assert_array_equal(env.reset(), jenv.reset())
    for t in range(STEPS):
        a = greedy_bfs_actions(cfg, env.state)
        np.testing.assert_array_equal(env.step(a)[0], jenv.step(a)[0])
        assert_oracle_state(jenv.state, env.state, f"t={t}")


@pytest.mark.parametrize("pair", ["a4q8", "a12q24"])
def test_wrapper_oracle_backend_matches_jax_and_torch(pair):
    """``backend="oracle"`` step by step against the JAX wrapper's oracle
    backend and the port's ``"torch"`` backend (seeded random moves,
    across the auto-reset): every dict, the renders and ``numpy_state``."""
    jcfg, cfg = configs(pair, False)
    je = JEnv(jcfg, backend="oracle")
    oe = WarehouseMultiAgentEnv(cfg, backend="oracle", device="cpu")
    te = WarehouseMultiAgentEnv(cfg, backend="torch", device="cpu")
    outs = [e.reset(seed=2) for e in (je, oe, te)]
    gen = np.random.default_rng(2)
    for t in range(STEPS):
        jo = outs[0][0]
        for o in (outs[1][0], outs[2][0]):
            for a in jo:
                np.testing.assert_array_equal(o[a], jo[a], f"{a} t={t}")
        assert oe.render() == je.render() == te.render(), t
        np.testing.assert_array_equal(oe.render("rgb_array"),
                                      te.render("rgb_array"))
        ns, tn = oe.numpy_state(), te.numpy_state()
        for f in vars(tn):
            np.testing.assert_array_equal(getattr(ns, f), getattr(tn, f), f)
        acts = {a: int(gen.integers(0, 5)) for a in oe.possible_agents}
        outs = [e.step(acts) for e in (je, oe, te)]
        assert outs[1][1:] == outs[0][1:] == outs[2][1:], t
        assert oe.agents == je.agents == te.agents
        np.testing.assert_array_equal(oe.agent_pos(),
                                      te.agent_pos().numpy())


def test_demo_oracle_backend_is_the_torch_episode(capsys):
    """``demo --backend oracle`` prints the episode ``--backend torch``
    does (greedy and the BFS greedy)."""
    from warehouse_tpu_torch import demo

    for policy in ("greedy", "greedy_bfs"):
        outs = []
        for backend in ("oracle", "torch"):
            demo.main(["--env", "shelves", "--cpu", "--steps", "20",
                       "--policy", policy, "--backend", backend, "--render"])
            outs.append(capsys.readouterr().out)
        assert outs[0] == outs[1] and "deliveries:" in outs[0]

"""The port's dict API (ROADMAP M-5) on the CPU, against the JAX package:
the RLlib-style wrapper step by step against the JAX wrapper (obs,
rewards, terminated / truncated, infos, both renders), its spaces and
refusals, the PettingZoo adapter under ``parallel_api_test``, the
registry, ``Policy.compute_actions_dict`` against the JAX ``Policy`` (MLP
masked, GRU with its carry) with the weights carried across by
``params_from_flax``, and the demo CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu import registry as j_registry
from warehouse_tpu.config import medium_config as j_medium
from warehouse_tpu.config import small_config as j_small
from warehouse_tpu.env.wrapper import WarehouseMultiAgentEnv as JEnv
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.serve import Policy as JPolicy
from warehouse_tpu_torch import EnvConfig, medium_config, registry
from warehouse_tpu_torch import small_config
from warehouse_tpu_torch.env.pettingzoo_adapter import WarehouseParallelEnv
from warehouse_tpu_torch.env.render import render_rgb, save_gif
from warehouse_tpu_torch.env.wrapper import WarehouseMultiAgentEnv
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.serve import Policy


def env_pair(seed, auto_reset):
    jcfg = j_medium(max_steps=40, auto_reset=auto_reset)
    cfg = medium_config(max_steps=40, auto_reset=auto_reset)
    return (JEnv(jcfg, backend="jax"),
            WarehouseMultiAgentEnv(cfg, device="cpu", seed=seed))


@pytest.mark.parametrize("seed", [0, 1])
def test_wrapper_matches_jax_step_by_step(seed):
    """64 steps across the truncation at 40 (seed 1 with the auto-reset):
    every dict and both renders equal the JAX wrapper's."""
    je, e = env_pair(seed, auto_reset=seed == 1)
    jo, jinfo = je.reset(seed=seed)
    o, info = e.reset()
    assert info == jinfo
    gen = np.random.default_rng(seed)
    for t in range(64):
        for a in jo:
            assert o[a].dtype == np.float32
            np.testing.assert_array_equal(o[a], jo[a], err_msg=f"{t} {a}")
        assert e.render() == je.render(), t
        np.testing.assert_array_equal(e.render("rgb_array"),
                                      je.render("rgb_array"))
        acts = {a: int(gen.integers(0, 5)) for a in e.possible_agents}
        jo, jr, jterm, jtrunc, jinfo = je.step(acts)
        o, r, term, trunc, info = e.step(acts)
        assert (r, term, trunc, info) == (jr, jterm, jtrunc, jinfo), t
        assert e.agents == je.agents
    assert trunc["__all__"] == (seed == 0)  # past max_steps without reset


def test_spaces_match_jax_and_are_cached():
    je, e = env_pair(0, False)
    for a in e.possible_agents:
        assert e.observation_space(a) == je.observation_space(a)
        assert e.action_space(a) == je.action_space(a)
        assert e.observation_space(a) is e.observation_space(a)
        assert e.action_space(a) is e.action_space(a)


def test_refusals():
    # The NumPy oracle's backend is ported (tests/test_torch_oracle.py).
    oracle = WarehouseMultiAgentEnv(small_config(), backend="oracle",
                                    device="cpu")
    assert oracle.backend == "oracle" and oracle.reset(seed=0)[1] == {
        a: {} for a in oracle.possible_agents}
    with pytest.raises(ValueError, match="unknown backend"):
        WarehouseMultiAgentEnv(small_config(), backend="jax", device="cpu")
    env = WarehouseMultiAgentEnv(small_config(), device="cpu")
    env.reset(seed=0)
    with pytest.raises(ValueError, match="invalid action"):
        env.step({"agent_0": 7, "agent_1": 0})


def test_reset_from_an_explicit_key():
    """``options={"key": k}`` resets from k: the episode that
    ``evaluate_policy`` plays as its env 0 (``fold_in(PRNGKey(s), 0)``)."""
    from warehouse_tpu_torch import rng
    from warehouse_tpu_torch.env import engine

    cfg = small_config()
    key = rng.fold_in(rng.prng_key(7), 0)
    env = WarehouseMultiAgentEnv(cfg, device="cpu")
    obs, _ = env.reset(options={"key": key})
    _, want = engine.reset(cfg, key[None])
    assert np.array_equal(np.stack([obs[a] for a in env.possible_agents]),
                          want[0].numpy())


def test_render_rgb_and_gif(tmp_path):
    from PIL import Image

    cfg = EnvConfig(height=5, width=5, num_agents=2, queue_capacity=4,
                    init_requests=2, max_steps=8, walls=(12,))
    env = WarehouseMultiAgentEnv(cfg, device="cpu")
    env.reset(seed=0)
    img = env.render(mode="rgb_array")
    assert img.shape == (80, 80, 3) and img.dtype == np.uint8
    assert (img[2 * 16 + 8, 2 * 16 + 8] < 100).all()  # the wall cell
    assert np.array_equal(img, render_rgb(cfg, env.numpy_state()))
    frames = [img]
    for _ in range(3):
        env.step({a: 4 for a in env.possible_agents})
        frames.append(env.render(mode="rgb_array"))
    save_gif(frames, str(tmp_path / "ep.gif"))
    assert Image.open(tmp_path / "ep.gif").n_frames == 4


def test_pettingzoo_api_compliance():
    from pettingzoo.test import parallel_api_test

    env = WarehouseParallelEnv(small_config(max_steps=12), device="cpu")
    parallel_api_test(env, num_cycles=30)
    obs, _ = env.reset(seed=0)
    for _ in range(12):
        _, _, term, trunc, _ = env.step({a: 0 for a in env.agents})
        assert "__all__" not in term and "__all__" not in trunc
    assert env.agents == [] and all(trunc.values())


def test_registry_matches_jax():
    assert registry.registered() == j_registry.registered()
    for name in registry.registered():
        assert (registry.make_config(name, max_steps=7).to_json()
                == j_registry.make_config(name, max_steps=7).to_json())
    env = registry.make_env("warehouse-small", device="cpu")
    obs, _ = env.reset(seed=0)
    assert set(obs) == {"agent_0", "agent_1"}
    penv = registry.make_parallel_env("warehouse-small", device="cpu")
    assert len(penv.reset(seed=0)[0]) == 2
    registry.register("warehouse-test-tiny",
                      lambda **kw: EnvConfig(height=3, width=3,
                                             num_agents=1, queue_capacity=1,
                                             init_requests=1, **kw))
    assert "warehouse-test-tiny" in registry.registered()
    with pytest.raises(ValueError, match="already registered"):
        registry.register("warehouse-test-tiny", lambda **kw: None)
    with pytest.raises(KeyError, match="unknown env"):
        registry.make_config("warehouse-nope")


def policies(arch, jcfg, cfg, mask):
    jm = j_make_model(jcfg, arch=arch, hidden_dim=16)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, jcfg.obs_dim)),
                     *((jm.initial_carry((1,)),) if arch == "gru" else ()))
    m = make_model(cfg, arch, hidden_dim=16, device="cpu")
    m.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return (JPolicy(jcfg, jm, params, arch=arch, mask_actions=mask),
            Policy(cfg, m, arch=arch, mask_actions=mask))


@pytest.mark.parametrize("arch,mask", [("mlp", True), ("gru", False)])
def test_compute_actions_dict_matches_jax(arch, mask):
    """Each policy drives its own wrapper 24 steps on a walled map (the
    mask floors the moves into the wall): the same action dicts, the
    GRU's carry threaded on both sides."""
    walls = dict(height=5, width=5, num_agents=2, queue_capacity=4,
                 init_requests=2, max_steps=24, walls=(7, 12, 17))
    jcfg, cfg = j_small(**walls), small_config(**walls)
    jpol, pol = policies(arch, jcfg, cfg, mask)
    je, e = JEnv(jcfg), WarehouseMultiAgentEnv(cfg, device="cpu")
    jo, _ = je.reset(seed=4)
    o, _ = e.reset(seed=4)
    jc, c = jpol.initial_state(1), pol.initial_state(1)
    for t in range(24):
        ja, jc = jpol.compute_actions_dict(je, jo, state=jc)
        a, c = pol.compute_actions_dict(e, o, state=c)
        assert a == ja, t
        jo, *_ = je.step(ja)
        o, *_ = e.step(a)
    if arch == "gru":
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)


def test_demo_runs_headless_and_writes_a_gif(tmp_path, capsys):
    from PIL import Image

    from warehouse_tpu_torch import demo

    gif = tmp_path / "demo.gif"
    demo.main(["--env", "small", "--cpu", "--steps", "6", "--policy",
               "greedy_bfs", "--render", "--gif", str(gif)])
    out = capsys.readouterr().out
    assert "episode finished after 6 steps" in out and "t=6" in out
    assert Image.open(gif).n_frames == 7
    # The oracle's backend plays the same episode.
    demo.main(["--env", "small", "--cpu", "--steps", "6", "--policy",
               "greedy_bfs", "--render", "--backend", "oracle"])
    assert capsys.readouterr().out == out.replace(
        f"gif written: {gif} (7 frames)\n", "")


def test_demo_serves_a_checkpoint(tmp_path, capsys):
    """A checkpoint the train CLI wrote (with its meta file) through
    ``Policy.from_checkpoint``, then the same params without the meta file
    through the rebuild from ``--arch`` / ``--hidden-dim``: the same
    episode."""
    from warehouse_tpu_torch import demo
    from warehouse_tpu_torch.train.__main__ import main as train_main

    ckpt = tmp_path / "ckpt"
    train_main(["--env", "small", "--env-config", '{"max_steps": 8}',
                "--num-envs", "8", "--unroll-length", "4", "--num-updates",
                "1", "--num-minibatches", "2", "--ppo-epochs", "1",
                "--hidden-dim", "16", "--device", "cpu", "--metrics-path",
                str(tmp_path / "m.jsonl"), "--checkpoint-every", "1",
                "--checkpoint-dir", str(ckpt)])
    args = ["--env", "small", "--cpu", "--steps", "8", "--policy",
            "checkpoint", "--checkpoint-dir", str(ckpt), "--hidden-dim",
            "16"]
    capsys.readouterr()
    demo.main(args)
    served = capsys.readouterr().out
    (ckpt / "policy_meta.json").unlink()
    demo.main(args)
    assert capsys.readouterr().out == served
    assert "episode finished after 8 steps" in served

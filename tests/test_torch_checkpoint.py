"""Checkpoints, ``--resume``, self-describing checkpoint directories and
``evaluate --policy checkpoint`` of the port
(``warehouse_tpu_torch/train/checkpoint.py``, ``serve.py``, ``evaluate.py``,
``train/__main__.py``), on the CPU.

The resume cases follow ``tests/test_checkpoint.py``: a run saved at update
2 and restored into a fresh state continues to update 4 with every leaf of
its runner state bit-equal to the uninterrupted run's. The meta file is
held key for key against the JAX package's ``write_policy_meta``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import warehouse_tpu as wj
import warehouse_tpu_torch as wt
from warehouse_tpu.serve import write_policy_meta as j_write_policy_meta
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.evaluate import (checkpoint_policy_fn,
                                          evaluate_policy, main as eval_main,
                                          params_policy_fn)
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.models.policy import apply_rnn, initial_carry
from warehouse_tpu_torch.ops.ppo_update import first_argmax
from warehouse_tpu_torch.serve import META_NAME, Policy, write_policy_meta
from warehouse_tpu_torch.train import (make_train, make_train_impala,
                                       make_train_rnn)
from warehouse_tpu_torch.train import checkpoint
from warehouse_tpu_torch.train.__main__ import main as train_main

CFG = wt.small_config(max_steps=8)
TCFG = wt.TrainConfig(num_envs=16, unroll_length=4, num_updates=4,
                      num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                      kl_coeff=0.1, entropy_coef_final=0.001)
WALLED = wt.EnvConfig(height=5, width=5, num_agents=2, queue_capacity=4,
                      init_requests=2, spawn_prob=0.5, max_steps=8,
                      walls=(10, 11, 13, 14))


def build(kind):
    if kind == "impala":
        return make_train_impala(CFG, TCFG, device="cpu")
    if kind == "impala_adam":
        return make_train_impala(CFG, TCFG.replace(impala_rmsprop=False),
                                 device="cpu")
    if kind in ("gru", "lstm"):
        return make_train_rnn(CFG, TCFG, arch=kind, device="cpu")
    if kind == "ppo_shaped":
        return make_train(WALLED, TCFG.replace(mask_actions=True,
                                               shaping_coef=0.02),
                          device="cpu")
    return make_train(CFG, TCFG, arch="cnn" if kind == "cnn" else "mlp",
                      device="cpu")


def leaves(tree, path="state"):
    """``(path, leaf)`` of every tensor and number of a runner state."""
    if isinstance(tree, torch.Tensor) or isinstance(tree, (int, float)):
        yield path, tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            yield from leaves(getattr(tree, f.name), f"{path}.{f.name}")
    elif hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, f"{path}.{k}")
    else:
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}[{i}]")


def assert_same_state(a, b):
    la, lb = list(leaves(a)), list(leaves(b))
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.device == y.device, path
            assert torch.equal(x, y), path
        else:
            assert type(x) is type(y) and x == y, path


@pytest.mark.parametrize("kind", ["ppo", "ppo_shaped", "cnn", "impala",
                                  "impala_adam", "gru", "lstm"])
def test_resume_is_bit_exact(kind, tmp_path):
    tr = build(kind)
    rs = tr.init(rng.prng_key(0))
    rs, _ = tr.train_many(rs, 2)
    path = checkpoint.save(str(tmp_path), 2, rs)
    assert os.path.basename(path) == "step_00000002"
    full, _ = tr.train_many(rs, 2)

    target = build(kind).init(rng.prng_key(123))  # structure, other values
    step, restored = checkpoint.restore_latest(str(tmp_path), target)
    assert step == 2
    assert type(restored) is type(rs)
    assert_same_state(restored, rs)
    n_leaves = len(list(leaves(rs)))
    assert n_leaves >= 9 + 3 * len(rs.params) - (
        len(rs.params) if kind == "impala" else 0)
    resumed, _ = build(kind).train_many(restored, 2)
    assert int(resumed.update_idx) == 4
    assert_same_state(resumed, full)


def test_latest_step_counts_only_finished_checkpoints(tmp_path):
    d = str(tmp_path / "ckpt")
    assert checkpoint.latest_step(d) is None  # no directory yet
    assert checkpoint.restore_latest(d, {}) is None
    tree = {"params": {"w": torch.arange(3.0)}, "n": 3}
    checkpoint.save(d, 2, tree)
    for leftover in ("step_00000005.tmp", "step_00000007.123.tmp",
                     "step_x", "policy_meta.json", "xstep_00000009"):
        (tmp_path / "ckpt" / leftover).write_bytes(b"partial")
    assert checkpoint.latest_step(d) == 2
    checkpoint.save(d, 11, tree)
    assert checkpoint.latest_step(d) == 11
    assert sorted(n for n in os.listdir(d) if n.startswith("step_0")) == [
        "step_00000002", "step_00000005.tmp", "step_00000007.123.tmp",
        "step_00000011"]
    step, back = checkpoint.restore_latest(d, tree)
    assert step == 11 and back["n"] == 3
    assert torch.equal(back["params"]["w"], tree["params"]["w"])


def test_checkpoint_file_is_plain_containers(tmp_path):
    """The file holds dicts, lists, tensors and numbers only, so it loads
    with ``weights_only=True`` and without the port's classes."""
    tr = build("lstm")
    rs = tr.init(rng.prng_key(1))
    path = checkpoint.save(str(tmp_path), 0, rs)
    plain = torch.load(path, map_location="cpu", weights_only=True)
    assert set(plain) == set(rs._fields)
    assert set(plain["opt_state"]) == {"count", "mu", "nu"}
    assert isinstance(plain["carry"], list) and len(plain["carry"]) == 2
    assert plain["env_state"]["key"].dtype == torch.int64
    assert plain["opt_state"]["count"] == 0


def test_restore_refuses_a_state_that_does_not_fit(tmp_path):
    rs = build("ppo").init(rng.prng_key(0))
    checkpoint.save(str(tmp_path), 1, rs)
    wide = make_train(CFG, TCFG.replace(hidden_dim=32),
                      device="cpu").init(rng.prng_key(0))
    with pytest.raises(ValueError, match="hidden.0.weight"):
        checkpoint.restore(str(tmp_path), 1, wide)
    other = build("gru").init(rng.prng_key(0))
    with pytest.raises(ValueError, match="other fields"):
        checkpoint.restore(str(tmp_path), 1, other)


def test_restore_params_needs_no_model(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        checkpoint.restore_params(str(tmp_path), device="cpu")
    tr = build("ppo")
    rs = tr.init(rng.prng_key(0))
    checkpoint.save(str(tmp_path), 1, rs)
    rs2, _ = tr.train_step(rs)
    checkpoint.save(str(tmp_path), 2, rs2)
    latest = checkpoint.restore_params(str(tmp_path), device="cpu")
    first = checkpoint.restore_params(str(tmp_path), 1, device="cpu")
    assert latest.keys() == rs.params.keys()
    for k in latest:
        assert torch.equal(latest[k], rs2.params[k]), k
        assert torch.equal(first[k], rs.params[k]), k
        assert latest[k].device.type == "cpu"


def test_restore_params_default_device_is_the_card(tmp_path):
    checkpoint.save(str(tmp_path), 1, {"params": {"w": torch.zeros(2)}})
    if torch.cuda.is_available():
        got = checkpoint.restore_params(str(tmp_path))
        assert got["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            checkpoint.restore_params(str(tmp_path))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Policy.from_checkpoint(str(tmp_path))


@pytest.mark.parametrize("arch, mask", [("mlp", True), ("cnn", False),
                                        ("gru", False), ("lstm", True)])
def test_policy_meta_keys_equal_the_jax_files(arch, mask, tmp_path):
    kw = dict(hidden_dim=32, num_layers=2, mask_actions=mask)
    j_path = j_write_policy_meta(str(tmp_path / "jax"),
                                 wj.shelves_config(max_steps=64),
                                 wj.TrainConfig(**kw), arch=arch)
    path = write_policy_meta(str(tmp_path / "port"),
                             wt.shelves_config(max_steps=64),
                             wt.TrainConfig(**kw), arch=arch)
    assert os.path.basename(path) == META_NAME == os.path.basename(j_path)
    with open(path) as f, open(j_path) as jf:
        meta, j_meta = json.load(f), json.load(jf)
    assert meta == j_meta
    assert list(meta) == list(j_meta) == [
        "env_config", "arch", "hidden_dim", "num_layers", "model_dtype",
        "mask_actions", "policy_groups"]


@pytest.mark.parametrize("arch", ["mlp", "cnn", "gru", "lstm"])
def test_policy_from_checkpoint_acts_as_policy_of_the_model(arch, tmp_path):
    cfg = WALLED
    tcfg = TCFG.replace(mask_actions=True)
    tr = (make_train_rnn if arch in ("gru", "lstm") else make_train)(
        cfg, tcfg, arch=arch, device="cpu")
    rs, _ = tr.train_step(tr.init(rng.prng_key(2)))
    d = str(tmp_path)
    write_policy_meta(d, cfg, tcfg, arch=arch)
    checkpoint.save(d, 1, rs)
    loaded = Policy.from_checkpoint(d, device="cpu")
    assert loaded.arch == arch and loaded.mask_actions
    assert loaded.env_cfg == cfg
    model = make_model(cfg, arch, tcfg.hidden_dim, tcfg.num_layers,
                       device="cpu")
    model.load_state_dict(rs.params)
    direct = Policy(cfg, model, mask_actions=True)
    gen = np.random.default_rng(0)
    obs = gen.random((6, cfg.num_agents, cfg.obs_dim), np.float32)
    pos = rs.env_state.agent_pos[:6]
    state_a = state_b = None
    for explore in (False, True):
        a, state_a = loaded.compute_actions(obs, state_a, explore=explore,
                                            seed=3, agent_pos=pos)
        b, state_b = direct.compute_actions(obs, state_b, explore=explore,
                                            seed=3, agent_pos=pos)
        assert torch.equal(a, b)
    assert Policy.from_checkpoint(d, step=1, device="cpu").arch == arch


def test_policy_from_checkpoint_refusals(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError, match=META_NAME):
        Policy.from_checkpoint(d, device="cpu")
    # A policy-groups checkpoint loads: the multi-policy model rebuilt from
    # the meta's groups holds the saved params.
    g = str(tmp_path / "groups")
    write_policy_meta(g, CFG, TCFG, policy_groups=(0, 1))
    rs = make_train(CFG, TCFG, policy_groups=(0, 1),
                    device="cpu").init(rng.prng_key(1))
    checkpoint.save(g, 1, rs)
    grouped = Policy.from_checkpoint(g, device="cpu")
    assert grouped.policy_groups == (0, 1)
    loaded = grouped.model.state_dict()
    assert loaded.keys() == rs.params.keys()
    assert all(torch.equal(loaded[k], rs.params[k]) for k in rs.params)
    # A bf16 run's meta is served (tests/test_torch_bf16.py): it goes on to
    # look for the checkpoints.
    write_policy_meta(d, CFG, TCFG.replace(model_dtype="bfloat16"))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Policy.from_checkpoint(d, device="cpu")
    write_policy_meta(d, CFG, TCFG)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        Policy.from_checkpoint(d, device="cpu")


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_evaluate_policy_init_carry_equals_a_closed_over_carry(arch):
    """A recurrent policy through ``init_carry`` gives the metrics the
    train CLI's earlier closure over a carry list gave."""
    cfg = wt.small_config(max_steps=16)
    model = make_model(cfg, arch, 16, 2, torch.Generator().manual_seed(4),
                       "cpu")
    params = {k: v.detach() for k, v in model.state_dict().items()}
    B = 12
    carry = [initial_carry(arch, (B, cfg.num_agents), 16, "cpu")]

    def closure(state, obs, key):
        logits, _, carry[0] = apply_rnn(params, obs, carry[0])
        return first_argmax(logits, -1).to(torch.int32)

    want = evaluate_policy(cfg, closure, B, seed=3, device="cpu")
    fn, init_carry = params_policy_fn(cfg, params, arch)
    got = evaluate_policy(cfg, fn, B, seed=3, init_carry=init_carry,
                          device="cpu")
    assert got == want
    zero = init_carry(B)
    zero = zero if isinstance(zero, tuple) else (zero,)
    assert all(x.shape == (B, cfg.num_agents, 16) and not x.any()
               for x in zero)
    # The carry matters: an episode with it reset every step differs.
    stateless = evaluate_policy(
        cfg, lambda s, o, k: fn(s, o, k, init_carry(B))[0], B, seed=3,
        device="cpu")
    assert stateless != want


CLI = ["--cpu", "--env", "shelves", "--env-config",
       '{"max_steps": 8, "num_agents": 3, "queue_capacity": 6, '
       '"init_requests": 3}', "--mask-actions", "--shaping-coef", "0.02",
       "--entropy-coef", "0.02", "--entropy-coef-final", "0.002",
       "--num-envs", "16", "--unroll-length", "4", "--num-minibatches", "2",
       "--ppo-epochs", "2", "--hidden-dim", "16", "--log-every", "1"]


def run_cli(d, updates, *extra):
    train_main([*CLI, "--num-updates", "4", "--checkpoint-every", "1",
                "--checkpoint-dir", str(d), "--metrics-path",
                str(d / "metrics.jsonl"), *extra])
    return checkpoint.latest_step(str(d))


def test_cli_checkpoints_resumes_and_evaluates(tmp_path, capsys):
    """The walled-layout flow on the CPU at a small size: train with
    ``--checkpoint-every 1``, stop after update 2 (the later files taken
    away), ``--resume`` to update 4; the resumed run's last checkpoint is
    the uninterrupted run's, bit for bit; then ``evaluate --policy
    checkpoint`` takes ``mask_actions`` from the meta file."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    assert run_cli(whole, 4) == 4
    assert run_cli(cut, 4) == 4
    for step in (3, 4):  # as if the run had died after update 2
        os.remove(cut / f"step_{step:08d}")
    assert checkpoint.latest_step(str(cut)) == 2
    assert run_cli(cut, 4, "--resume") == 4
    a = torch.load(whole / "step_00000004", weights_only=True)
    b = torch.load(cut / "step_00000004", weights_only=True)
    assert_same_state(a, b)
    steps = [json.loads(line).get("step") for line in
             (cut / "metrics.jsonl").read_text().splitlines()]
    assert [s for s in steps if s is not None] == [1, 2, 3, 4, 3, 4]

    with open(whole / META_NAME) as f:
        meta = json.load(f)
    assert meta["mask_actions"] is True and meta["arch"] == "mlp"
    assert meta["hidden_dim"] == 16
    env_args = CLI[:5]
    capsys.readouterr()
    eval_main([*env_args, "--policy", "checkpoint", "--checkpoint-dir",
               str(whole), "--episodes", "8"])
    out = dict(line.split(": ") for line in
               capsys.readouterr().out.strip().splitlines())
    cfg = wt.shelves_config(max_steps=8, num_agents=3, queue_capacity=6,
                            init_requests=3)
    fn, init_carry, mask_on = checkpoint_policy_fn(cfg, str(whole),
                                                   device="cpu")
    assert mask_on and init_carry is None  # picked up from the meta file
    want = evaluate_policy(cfg, fn, 8, device="cpu")
    assert float(out["mean_episode_return"]) == want["mean_episode_return"]
    # The mask is what the meta turned on: masked and unmasked differ.
    params = checkpoint.restore_params(str(whole), device="cpu")
    unmasked = evaluate_policy(cfg, params_policy_fn(cfg, params, "mlp")[0],
                               8, device="cpu")
    masked = evaluate_policy(
        cfg, params_policy_fn(cfg, params, "mlp", mask_actions=True)[0], 8,
        device="cpu")
    assert masked == want and unmasked != want


def test_resume_without_a_checkpoint_starts_from_scratch(tmp_path):
    d = tmp_path / "fresh"
    assert run_cli(d, 4, "--resume") == 4
    first = json.loads((d / "metrics.jsonl").read_text().splitlines()[1])
    assert first["step"] == 1


@pytest.mark.parametrize("arch", ["gru", "cnn"])
def test_evaluate_cli_checkpoint_other_archs(arch, tmp_path, capsys):
    """``evaluate --policy checkpoint`` reads the arch from the meta file,
    ``--sample`` draws through the port's sampler; a wrong ``--arch``
    override does not fit the checkpoint."""
    d = tmp_path / arch
    train_main(["--cpu", "--arch", arch, "--env", "small", "--env-config",
                '{"max_steps": 8}', "--num-envs", "16", "--unroll-length",
                "4", "--num-updates", "1", "--num-minibatches", "2",
                "--ppo-epochs", "1", "--hidden-dim", "16", "--log-every", "1",
                "--checkpoint-every", "1", "--checkpoint-dir", str(d),
                "--metrics-path", str(d / "m.jsonl")])
    capsys.readouterr()
    base = ["--cpu", "--env", "small", "--env-config", '{"max_steps": 8}',
            "--policy", "checkpoint", "--checkpoint-dir", str(d),
            "--episodes", "4"]
    eval_main(base)
    argmax = capsys.readouterr().out
    eval_main([*base, "--sample"])
    sampled = capsys.readouterr().out
    assert "mean_deliveries_per_episode" in argmax and sampled != argmax
    with pytest.raises(RuntimeError, match="state_dict"):
        eval_main([*base, "--arch", "mlp"])
    with pytest.raises(SystemExit, match="no checkpoints"):
        eval_main([*base[:-4], "--checkpoint-dir", str(tmp_path / "none")])


def test_entry_points_exit_without_a_card(tmp_path):
    """Without ``--cpu`` and without a card the new commands exit with the
    device message; none carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for argv in (["--env", "shelves", "--policy", "greedy_bfs"],
                 ["--env", "shelves", "--policy", "checkpoint",
                  "--checkpoint-dir", str(tmp_path)]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            eval_main(argv)
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_main(["--env", "shelves", "--mask-actions", "--shaping-coef",
                    "0.02", "--resume", "--checkpoint-dir", str(tmp_path),
                    "--metrics-path", str(tmp_path / "m.jsonl")])

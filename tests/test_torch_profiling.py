"""The port's utilities (``warehouse_tpu_torch.utils``, ROADMAP M-6) on the
CPU, against the JAX package's ``utils``: the steps/s meter on one clock,
``check_state_invariants`` on engine states and on seven hand-broken
copies (one per invariant), ``trace`` / ``annotate`` and the trainers'
annotated pieces, and the train CLI's ``--tensorboard-dir`` and
``--profile-dir``.
"""

import functools
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from warehouse_tpu.config import medium_config as j_medium
from warehouse_tpu.env.state import EnvState as JEnvState
from warehouse_tpu.utils import debug as j_debug
from warehouse_tpu.utils import profiling as j_profiling
from warehouse_tpu_torch import TrainConfig, medium_config, small_config
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env import engine
from warehouse_tpu_torch.env.state import IN_TRANSIT, PENDING, STATE_FIELDS
from warehouse_tpu_torch.train import make_train
from warehouse_tpu_torch.train.__main__ import main as cli_main
from warehouse_tpu_torch.utils import profiling
from warehouse_tpu_torch.utils import (StepsPerSecond, annotate,
                                       check_state_invariants,
                                       enable_debug_mode, trace)

TINY = ["--env", "small", "--env-config", '{"max_steps": 8}', "--num-envs",
        "8", "--unroll-length", "4", "--num-minibatches", "2",
        "--ppo-epochs", "1", "--hidden-dim", "16", "--device", "cpu"]


def test_steps_per_second_matches_jax(monkeypatch):
    """The same smoothing as JAX ``profiling.py:32-50`` on one sequence of
    clock readings."""
    clock = [0.0, 0.5, 0.75, 1.75, 1.8, 2.9]
    rates = {}
    for name, cls in (("jax", j_profiling.StepsPerSecond),
                      ("port", StepsPerSecond)):
        ticks = iter(clock)
        monkeypatch.setattr("time.perf_counter", lambda: next(ticks))
        meter = cls(alpha=0.3)
        rates[name] = [meter.update(steps) for steps in (0, 100, 40, 300,
                                                          7, 90)]
    assert rates["port"] == rates["jax"]
    assert rates["port"][0] == 0.0 and rates["port"][1] == 200.0


@functools.lru_cache(maxsize=None)
def random_states(cfg, B=32, steps=12, seed=0):
    """The port engine's states after each of ``steps`` random ticks (auto
    reset on, so some envs restart); callers do not modify them."""
    cfg = cfg.replace(auto_reset=True)
    state, _ = engine.reset(cfg, rng.fold_in(rng.prng_key(seed),
                                             torch.arange(B)))
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(steps):
        actions = torch.randint(0, 5, (B, cfg.num_agents), generator=gen,
                                dtype=torch.int32)
        state, _ = engine.step(cfg, state, actions)
        out.append(state)
    return out


def as_jax(state) -> JEnvState:
    """A port state as the JAX package's batched ``EnvState``."""
    fields = {f: getattr(state, f).numpy() for f in STATE_FIELDS}
    fields["key"] = fields["key"].astype(np.uint32)
    return JEnvState(**fields)


def jax_verdicts(cfg, state) -> np.ndarray:
    return np.asarray(jax.vmap(lambda s: j_debug.check_state_invariants(
        cfg, s))(as_jax(state)))


def test_check_state_invariants_matches_jax_on_engine_states():
    """Every env of the port engine's states, and of the JAX engine's
    from the same keys and actions (the two engines are bit-equal), keeps
    the invariants under both checks."""
    from warehouse_tpu.env import batch as jbatch

    cfg, jcfg = medium_config(), j_medium()
    for state in random_states(cfg)[::3]:
        got = check_state_invariants(cfg, state)
        assert got.dtype == torch.bool and got.shape == (32,)
        assert np.array_equal(got.numpy(), jax_verdicts(jcfg, state))
        assert bool(got.all())
    keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(1), i))(
        np.arange(16))
    auto = jcfg.replace(auto_reset=True)
    js, _ = jbatch.reset_batch(auto, keys)
    step = jax.jit(lambda s, a: jbatch.step_batch(auto, s, a)[0])
    for a in np.random.default_rng(1).integers(0, 5, (8, 16, 4), np.int32):
        js = step(js, a)
    want = np.asarray(jax.vmap(lambda s: j_debug.check_state_invariants(
        jcfg, s))(js))
    port = engine.EnvState(**{
        f: torch.from_numpy(np.asarray(getattr(js, f)).astype(
            np.int64 if f == "key" else np.asarray(getattr(js, f)).dtype))
        for f in STATE_FIELDS})
    assert want.all()
    assert np.array_equal(check_state_invariants(cfg, port).numpy(), want)


def _find(state, pred):
    """The first (env, index) pair where ``pred`` holds."""
    hits = torch.nonzero(pred)
    assert len(hits), "no env of the batch has the structure to break"
    return tuple(int(i) for i in hits[0])


def _break(state, name):
    """A copy of ``state`` with one invariant broken in one env; returns
    (copy, env)."""
    s = engine.EnvState(**{f: getattr(state, f).clone()
                           for f in STATE_FIELDS})
    if name == "on_grid":
        b = 3
        s.agent_pos[b, 0, 0] = medium_config().height
    elif name == "no_overlap":
        b = 5
        s.agent_pos[b, 1] = s.agent_pos[b, 0]
    elif name == "agent_pair":  # an agent's request names another agent
        b, a = _find(s, s.agent_req >= 0)
        s.req_agent[b, s.agent_req[b, a]] = (a + 1) % s.agent_req.shape[1]
    elif name == "carrying":  # carrying a request still pending
        b, a = _find(s, (s.agent_req >= 0) & ~s.carrying)
        s.carrying[b, a] = True
    elif name == "request_pair":  # a request's agent does not name it
        b, r = _find(s, (s.req_agent >= 0) & (s.req_status == PENDING))
        s.agent_req[b, s.req_agent[b, r]] = -1
    elif name == "empty_slot":  # an empty slot with an agent
        b, r = _find(s, s.req_status == 0)
        s.req_agent[b, r] = 0
    else:  # "in_transit": a slot in transit without an agent
        b, r = _find(s, (s.req_agent < 0) & (s.req_status == PENDING))
        s.req_status[b, r] = IN_TRANSIT
    return s, b


@pytest.mark.parametrize("name", ["on_grid", "no_overlap", "agent_pair",
                                  "carrying", "request_pair", "empty_slot",
                                  "in_transit"])
def test_check_state_invariants_catches_a_broken_copy(name):
    cfg = medium_config()
    state = random_states(cfg)[-1]
    broken, b = _break(state, name)
    got = check_state_invariants(cfg, broken).numpy()
    assert np.array_equal(got, jax_verdicts(j_medium(), broken))
    assert not got[b]
    assert got.sum() == len(got) - 1


def test_enable_debug_mode():
    try:
        enable_debug_mode()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(False)


def trace_names(log_dir) -> list[str]:
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return [e.get("name") for e in json.load(f)["traceEvents"]]


def test_trace_writes_the_annotated_ranges(tmp_path):
    with trace(str(tmp_path), device="cpu") as prof:
        with annotate("outer_piece", "cpu"):
            with annotate("inner_piece", "cpu"):
                torch.ones(8).cumsum(0)
    names = trace_names(tmp_path)
    assert "outer_piece" in names and "inner_piece" in names
    assert any(n.startswith("aten::") for n in names)
    assert {"outer_piece", "inner_piece"} <= {e.name for e in prof.events()}


def test_range_split_counts_each_piece(tmp_path):
    """``range_split`` on a written trace: nested ranges count once toward
    the covered share, device work goes to the range whose host call
    launched it (by correlation id), wherever it ran."""
    def ev(cat, name, ts, dur, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    events = [
        ev("user_annotation", "update", 0, 100),
        ev("user_annotation", "draws", 5, 40),
        ev("cpu_op", "aten::add", 6, 2), ev("cpu_op", "aten::mul", 10, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1),
        ev("user_annotation", "reset", 50, 45),
        ev("user_annotation", "reset_read", 60, 30),
        ev("cuda_runtime", "cudaLaunchKernel", 55, 1, corr=2),
        ev("cuda_runtime", "cudaMemcpyAsync", 61, 20, corr=3),
        ev("cpu_op", "aten::item", 61, 25),
        ev("kernel", "k1", 200, 500, corr=1),   # device time runs late
        ev("kernel", "k2", 700, 250, corr=2),
        ev("gpu_memcpy", "copy", 950, 10, corr=3),
        ev("cpu_op", "aten::zeros", 120, 3),     # after the update
        ev("user_annotation", "draws", 130, 10)]
    path = tmp_path / "t.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = profiling.range_split(str(path), ("draws", "reset",
                                            "reset_read"), "update")
    assert got["outer_ms"] == 0.1 and got["covered_share"] == 0.85
    assert (got["aten_calls"], got["launches"]) == (3, 2)
    assert got["device_ms"] == pytest.approx(0.76)
    assert got["pieces"]["draws"] == {"host_ms": 0.04, "device_ms": 0.5,
                                      "aten_calls": 2, "launches": 1,
                                      "ranges": 1}
    assert got["pieces"]["reset"]["device_ms"] == pytest.approx(0.26)
    assert got["pieces"]["reset_read"]["launches"] == 0
    assert got["pieces"]["reset_read"]["device_ms"] == pytest.approx(0.01)


# The pieces of an update, as the trainers annotate them: the chunk route
# (the acting kernel's twin on the CPU) and the per-step route.
CHUNK_PIECES = {"permutation", "load_state_dict", "draws", "act_kernel",
                "boundary_reset", "boundary_reset_host_read", "last_value",
                "gae", "learner", "metrics"}
STEP_PIECES = {"permutation", "draws", "policy", "tick", "tick_host_read",
               "last_value", "gae", "learner", "metrics"}


@pytest.mark.parametrize("max_steps,pieces", [(8, CHUNK_PIECES),
                                              (6, STEP_PIECES)])
def test_trainer_update_is_annotated(tmp_path, max_steps, pieces):
    """One PPO update names each of its pieces in the trace, and the
    annotations leave the update's bits as they were."""
    cfg = small_config(max_steps=max_steps)
    tcfg = TrainConfig(num_envs=8, unroll_length=4, num_minibatches=2,
                       ppo_epochs=1, hidden_dim=16, num_updates=2)
    tr = make_train(cfg, tcfg, device="cpu")
    rs0 = tr.init(rng.prng_key(0))
    with trace(str(tmp_path), device="cpu"):
        rs, m = tr.train_step(rs0)
    assert pieces <= set(trace_names(tmp_path))
    again, m2 = tr.train_step(rs0)
    for k in rs.params:
        assert torch.equal(rs.params[k], again.params[k]), k
    assert all(torch.equal(m[k], m2[k]) for k in m)


def test_cli_tensorboard_dir_writes_the_scalars(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    tb = tmp_path / "tb"
    cli_main([*TINY, "--num-updates", "2", "--log-every", "1",
              "--metrics-path", str(tmp_path / "m.jsonl"),
              "--tensorboard-dir", str(tb)])
    assert glob.glob(str(tb / "events.out.tfevents.*"))
    acc = EventAccumulator(str(tb))
    acc.Reload()
    recs = [json.loads(line) for line in
            (tmp_path / "m.jsonl").read_text().splitlines()[1:]]
    for k in ("loss", "deliveries_per_env_step", "env_steps_per_sec"):
        events = acc.Scalars(k)
        assert [e.step for e in events] == [1, 2]
        assert [e.value for e in events] == pytest.approx(
            [r[k] for r in recs], rel=1e-6)


def test_cli_profile_dir_writes_a_trace(tmp_path):
    """The trace covers the second logged chunk (JAX
    ``train/__main__.py:244-250``) and holds the trainer's pieces."""
    prof = tmp_path / "prof"
    cli_main([*TINY, "--num-updates", "3", "--log-every", "1",
              "--metrics-path", str(tmp_path / "m.jsonl"),
              "--profile-dir", str(prof)])
    names = trace_names(prof)
    assert names.count("learner") == 1 and "act_kernel" in names

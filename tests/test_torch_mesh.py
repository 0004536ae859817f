"""The port's data mesh (``warehouse_tpu_torch.parallel``) and a world-1
meshed PPO update against the JAX trainer on a 1-device mesh.

The group here is a world-1 gloo group met through a file under
``tmp_path`` (no port to collide with another worker), destroyed after
each test. The trainer case carries the JAX mesh's initial state into the
port and runs 2 updates on both: JAX ``make_train(..., mesh=make_mesh(
jax.devices()[:1]))`` with the Pallas acting and per-minibatch gradient
kernels (K2, K4) in interpret mode, the port's meshed route with their
twins. Env state and keys bit-equal, metrics and params at the bounds of
``tests/test_torch_train.py`` (2e-4 + 1e-3 relative; rtol 2e-4, atol
5e-5).
"""

import socket

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.parallel.mesh import make_mesh as j_make_mesh
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch import parallel
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.parallel import distributed, mesh as pmesh
from warehouse_tpu_torch.train import make_train, runner_state_from_jax
from warehouse_tpu_torch.utils import (assert_replicated_in_sync,
                                       visualize_sharding)

from test_torch_rng import assert_bits
from test_torch_train import assert_params

CFG = small_config(max_steps=8)
B = 8


def mesh_tcfg(b_local: int, rollout_backend: str = "pallas",
              grad_backend: str = "pallas") -> TrainConfig:
    """The tiny meshed run: T = 4, hidden 16, 1 epoch x 2 minibatches, the
    JAX Pallas kernels in interpret mode (one act block per shard)."""
    return TrainConfig(num_envs=B, unroll_length=4, num_updates=2,
                       num_minibatches=2, ppo_epochs=1, hidden_dim=16,
                       rollout_backend=rollout_backend,
                       grad_backend=grad_backend, pallas_interpret=True,
                       pallas_block=b_local)


def jax_shard(rs_np, rank: int, world: int, sharded=("env_state", "obs",
                                                     "carry")):
    """Shard ``rank`` of a JAX meshed runner state (numpy leaves): its rows
    of the sharded fields, its key row."""
    def rows(x):
        b = x.shape[0] // world
        return x[rank * b:(rank + 1) * b]

    cut = {f: jax.tree.map(rows, getattr(rs_np, f)) for f in sharded
           if hasattr(rs_np, f)}
    return rs_np.replace(key=rs_np.key[rank:rank + 1], **cut)


@pytest.fixture
def world1(tmp_path):
    with distributed.process_group(tmp_path / "store") as mesh:
        yield mesh


def test_make_mesh_world1(world1, capsys):
    m = world1
    assert (m.rank, m.world, m.device.type) == (0, 1, "cpu")
    assert m.shape == {pmesh.DATA_AXIS: 1, pmesh.MODEL_AXIS: 1}
    assert (pmesh.DATA_AXIS, pmesh.MODEL_AXIS, pmesh.POP_AXIS) == (
        "data", "model", "pop")
    assert pmesh.data_sharding(m).spec == ("data",)
    assert pmesh.replicated(m).spec == ()
    x = torch.arange(24).reshape(8, 3)
    assert torch.equal(parallel.shard_batch(m, {"x": x})["x"], x)
    assert torch.equal(pmesh.gather_batch(m, x), x)
    # Rank r of a world of w holds rows [r b, (r + 1) b).
    two = pmesh.DataMesh(None, 1, 2, torch.device("cpu"))
    assert two.rows(8) == slice(4, 8)
    assert torch.equal(pmesh.shard_batch(two, (x,))[0], x[4:])
    with pytest.raises(ValueError, match="shards"):
        two.rows(7)
    # A trainer's whole start cut to rank 1's part is the part it makes.
    tr = make_train(CFG, mesh_tcfg(B // 2), device="cpu", mesh=two)
    key = torch.tensor([0, 7])
    whole, part = tr.init(key), tr.init_global(key)
    cut = tr.shard_runner_state(whole)
    assert whole.key.shape == (2, 2) and whole.obs.shape[0] == B
    for f in STATE_FIELDS:
        assert torch.equal(getattr(cut.env_state, f),
                           getattr(part.env_state, f))
    assert torch.equal(cut.obs, part.obs) and torch.equal(cut.key, part.key)
    assert all(torch.equal(part.params[k], whole.params[k])
               for k in whole.params)
    y = torch.tensor([1.0, 2.0])
    assert torch.equal(m.mean_(y.clone()), y)
    assert "rank 0: rows [0, 8)" in visualize_sharding(x, m)
    assert "rank 0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="model"):
        parallel.make_mesh(model_parallel=2)
    # The (pop, data) mesh over the world of 1: one slice of one data rank.
    with pytest.raises(ValueError, match="1 ranks not divisible by pop=2"):
        pmesh.make_pop_mesh(2)
    pop = pmesh.make_pop_mesh(1)
    assert pop.shape == {"pop": 1, "data": 1} and pop.slice == 0
    assert pop.data.world == 1 and pop.ranks == (0,)
    assert [torch.equal(g, y) for g in pop.gather_slices(y)] == [True]
    assert "rank 0: rows [0, 8)" in visualize_sharding(x, pop)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_maybe_initialize_distributed_reads_both_launchers(monkeypatch):
    env = distributed.launcher_env
    assert env({}) is None
    jx = env({"JAX_COORDINATOR_ADDRESS": "h:1234", "JAX_NUM_PROCESSES": "4",
              "JAX_PROCESS_ID": "2", "LOCAL_RANK": "0"})
    assert jx == {"init_method": "tcp://h:1234", "world": 4, "rank": 2,
                  "local_rank": 0}
    assert env({"COORDINATOR_ADDRESS": "h:1", "JAX_NUM_PROCESSES": "2",
                "JAX_PROCESS_ID": "1"})["rank"] == 1
    tr = env({"MASTER_ADDR": "m", "MASTER_PORT": "29500", "RANK": "3",
              "WORLD_SIZE": "8", "LOCAL_RANK": "1"})
    assert tr == {"init_method": "tcp://m:29500", "world": 8, "rank": 3,
                  "local_rank": 1}
    for k in ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "MASTER_ADDR",
              "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not distributed.maybe_initialize_distributed()
    # torchrun's variables, world 1: gloo on this CPU-only host.
    for k, v in {"MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
                 "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}.items():
        monkeypatch.setenv(k, v)
    try:
        assert distributed.maybe_initialize_distributed(timeout_s=30)
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert not distributed.maybe_initialize_distributed()
    finally:
        dist.destroy_process_group()
    # The JAX variables naming a group that cannot form: it raises.
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", f"localhost:{_free_port()}")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    with pytest.raises(RuntimeError, match="could not form"):
        distributed.maybe_initialize_distributed(timeout_s=1)
    assert not dist.is_initialized()


def test_group_backend_takes_gloo_for_the_cpu_on_a_host_with_cards(
        monkeypatch):
    # A host with one card: the card's rank takes NCCL unless the caller
    # trains on the CPU (--cpu); a rank with no card of its own takes gloo.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    spec = {"init_method": "tcp://m:1", "world": 2, "rank": 0,
            "local_rank": 0}
    assert distributed.group_backend(spec) == "nccl"
    assert distributed.group_backend(spec, torch.device("cuda")) == "nccl"
    assert distributed.group_backend(spec, "cpu") == "gloo"
    assert distributed.group_backend(spec, torch.device("cpu")) == "gloo"
    assert distributed.group_backend({**spec, "local_rank": 1}) == "gloo"


class _TwoRanks:
    """A mesh stand-in whose all-gather returns this rank's bytes and rank
    1's, perturbed at one byte of ``leaf`` when it is set."""
    rank, world = 0, 2

    def __init__(self, perturb_at=None):
        self.perturb_at = perturb_at

    def all_gather(self, x):
        other = x.clone()
        if self.perturb_at is not None and other.numel() > 1:
            other[self.perturb_at] ^= 1
        return [x, other]


def test_assert_replicated_in_sync_names_a_perturbed_leaf(world1):
    tree = {"w": torch.ones(3), "adam": (2, {"mu": torch.zeros(2)}),
            "flag": torch.tensor([True, False])}
    assert_replicated_in_sync(tree, world1)
    assert_replicated_in_sync(tree, _TwoRanks())
    # Byte 12 is the first of /adam/0 (after w's 12 bytes).
    with pytest.raises(AssertionError,
                       match="replicated leaf diverged across shards: "
                             "/adam/0"):
        assert_replicated_in_sync(tree, _TwoRanks(perturb_at=12))
    with pytest.raises(AssertionError, match="/w"):
        assert_replicated_in_sync(tree, _TwoRanks(perturb_at=0))


def test_world1_meshed_ppo_matches_jax_mesh(world1):
    tcfg = mesh_tcfg(B)
    jtr = j_make_train(CFG, tcfg, mesh=j_make_mesh(jax.devices()[:1]))
    tr = make_train(CFG, tcfg, device="cpu", mesh=world1)
    assert tr.backends == {"rollout": "plain", "grad": "plain"}
    jrs = jtr.init_global(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax_shard(jax.tree.map(np.asarray, jrs), 0, 1))
    # The port's own start is the same envs and shard key.
    own = tr.init_global(torch.tensor([0, 0]))
    for f in STATE_FIELDS:
        assert torch.equal(getattr(own.env_state, f), getattr(rs.env_state, f))
    assert torch.equal(own.key, rs.key)
    for u in range(2):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    assert rs.opt_state.count == 2 * tcfg.ppo_epochs * tcfg.num_minibatches
    assert_params(rs.params, jrs.params, 2e-4, 5e-5, "params")
    # World 1 averages nothing: the meshed route is the single-device one.
    one = make_train(CFG, tcfg, device="cpu")
    rs1, _ = one.train_many(own, 2)
    rs2, _ = tr.train_many(own, 2)
    assert all(torch.equal(rs1.params[k], rs2.params[k]) for k in rs1.params)

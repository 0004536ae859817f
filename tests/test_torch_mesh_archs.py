"""World-1 meshed updates of the CNN (K12's twin) and the GRU (K9's twin)
against the JAX trainers on a 1-device mesh, as ``tests/test_torch_mesh.py``
holds the MLP: the JAX mesh's start carried into the port, 2 updates on
both, env state, carry and keys bit-equal, metrics and params at the
bounds of ``tests/test_torch_train.py``; the GRU's carry at 1e-5. JAX acts
through its XLA scan (the same draws as its acting kernels, which
``tests/test_torch_mesh.py`` runs in interpret mode); the GRU learns through
K9's Pallas kernel in interpret mode, the CNN through the XLA meshed
learner (the same loss and gradient, ``pmean``'d at the same point: K10
and K12 in interpret mode take some 12 s more to compile on a CPU)."""

import jax
import numpy as np
import pytest
import torch

from warehouse_tpu.parallel.mesh import make_mesh as j_make_mesh
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu.train.ppo_rnn import make_train_rnn as j_make_train_rnn
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.parallel import distributed
from warehouse_tpu_torch.train import (make_train, make_train_rnn,
                                       runner_state_from_jax,
                                       runner_state_rnn_from_jax)

from test_torch_mesh import B, CFG, jax_shard, mesh_tcfg
from test_torch_rng import assert_bits
from test_torch_train import assert_params


@pytest.mark.parametrize("arch", ["cnn", "gru"])
def test_world1_meshed_update_matches_jax_mesh(arch, tmp_path):
    tcfg = mesh_tcfg(B, "xla", "xla" if arch == "cnn" else "pallas")
    # The port has no backend switch: the same route whatever JAX's.
    port_tcfg = tcfg.replace(rollout_backend="auto", grad_backend="auto")
    jmesh = j_make_mesh(jax.devices()[:1])
    rnn = arch == "gru"
    with distributed.process_group(tmp_path / "store") as mesh:
        if rnn:
            jtr = j_make_train_rnn(CFG, tcfg, arch, mesh=jmesh)
            tr = make_train_rnn(CFG, port_tcfg, arch, device="cpu",
                                mesh=mesh)
            convert = runner_state_rnn_from_jax
        else:
            jtr = j_make_train(CFG, tcfg, arch=arch, mesh=jmesh)
            tr = make_train(CFG, port_tcfg, arch=arch, device="cpu",
                            mesh=mesh)
            convert = runner_state_from_jax
        assert tr.backends == {"rollout": "plain", "grad": "plain"}
        jrs = jtr.init_global(jax.random.PRNGKey(0))
        rs = convert(jax_shard(jax.tree.map(np.asarray, jrs), 0, 1))
        for u in range(2):
            jrs, jm = jtr.train_step(jrs)
            rs, m = tr.train_step(rs)
            for f in STATE_FIELDS:
                assert_bits(getattr(jrs.env_state, f),
                            getattr(rs.env_state, f), f"update {u} {f}")
            assert_bits(np.asarray(jrs.key).reshape(2), rs.key,
                        f"update {u} key")
            for k in jm:
                a, b = float(m[k]), float(jm[k])
                assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
            if rnn:
                np.testing.assert_allclose(rs.carry.numpy(),
                                           np.asarray(jrs.carry), rtol=1e-5,
                                           atol=1e-5)
        assert rs.opt_state.count == 2 * tcfg.num_minibatches
        assert_params(rs.params, jrs.params, 2e-4, 5e-5, arch)
        assert torch.isfinite(m["loss"])

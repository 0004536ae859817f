"""The port's IMPALA pieces against the JAX package: V-trace, RMSProp, the
learner phase and per-minibatch gradients (the plain twins of K5/K6,
which is what their wrappers run on CPU tensors), the trainer, its gates
and its CLI.

The learner cases reuse ``tests/test_impala_kernel.py``'s setup (T = 4,
B = 16, A = 2, D = 26, hidden 16, passes 2, M = 2) and hold the port
against the Pallas kernels in interpret mode and against the XLA
scaffold, with that file's tolerances: f32 sums in another order, nothing
else.

The trainer cases carry a JAX ``ImpalaRunnerState`` into the port and run
3 updates on both: the JAX single-device trainer on the CPU (XLA
backends) and the port on the CPU (the plain twins of K2 and K5). As in
``test_torch_train.py``, the seeds were chosen with no action flip, so
env states, keys, obs and deliveries are bit-equal after every update;
metrics and params are held to ``tests/test_impala.py``'s bounds for two
learner backends (2e-4 + 1e-3 relative; rtol 2e-4 / atol 5e-5).
"""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.ops.vtrace import vtrace as j_vtrace
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.pallas.vtrace_sgd import (find_rms_state,
                                             impala_minibatch_grads_pallas,
                                             impala_sgd_phase_pallas)
from warehouse_tpu.train.impala import make_train_impala as j_make_train
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.parallel.distributed import process_group
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels import vtrace_sgd
from warehouse_tpu_torch.ops.vtrace import vtrace
from warehouse_tpu_torch.optim import (AdamState, ClipAdam, ClipRMSProp,
                                       RMSState, apply_updates,
                                       clip_rms_step, linear_schedule,
                                       make_impala_optimizer,
                                       opt_state_from_optax)
from warehouse_tpu_torch.train import (ImpalaTransition,
                                       impala_runner_state_from_jax,
                                       make_train_impala)
from warehouse_tpu_torch.train.__main__ import main as cli_main
from warehouse_tpu_torch.train.impala import rollout_problems_impala

from test_impala_kernel import (CC, ENT, GAMMA, MAXNORM, PASSES, RHO, VCOEF,
                                M, _env_minibatches, _kernel_inputs,
                                _loss_fn_for, _setup)
from test_impala_kernel import D as J_D
from test_impala_kernel import T as J_T
from test_impala_kernel import A as J_A
from test_torch_rng import assert_bits, to_torch
from test_torch_sgd import assert_tree, t, tree_np
from test_torch_train import assert_params

LOSS_KW = dict(gamma=GAMMA, rho_clip=RHO, c_clip=CC, value_coef=VCOEF)
CFG = small_config(max_steps=8)  # a boundary at the second update
BASE = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, hidden_dim=16)


# ---- ops/vtrace.py -------------------------------------------------------------

@pytest.mark.parametrize("bootstrap", [False, True])
def test_vtrace_matches_jax(bootstrap):
    """vs and pg_advantages within 1e-6: XLA may contract the deltas into
    FMAs."""
    g = np.random.default_rng(0)
    Tn, Bn = 9, 7
    blp = g.normal(size=(Tn, Bn)).astype(np.float32)
    tlp = (blp + g.normal(scale=0.3, size=(Tn, Bn))).astype(np.float32)
    rew, val = (g.normal(size=(Tn, Bn)).astype(np.float32) for _ in range(2))
    done = g.random((Tn, Bn)) < 0.25
    last = g.normal(size=Bn).astype(np.float32)
    boot = g.normal(size=(Tn, Bn)).astype(np.float32) if bootstrap else None
    kw = dict(rho_clip=0.9, c_clip=0.8)
    jvs, jpg = j_vtrace(*map(jnp.asarray, (blp, tlp, rew, val, done, last)),
                        0.97, bootstrap_values=None if boot is None
                        else jnp.asarray(boot), **kw)
    lp = t(tlp).requires_grad_()
    tvs, tpg = vtrace(t(blp), lp, t(rew), t(val), t(done), t(last), 0.97,
                      bootstrap_values=None if boot is None else t(boot),
                      **kw)
    assert not tvs.requires_grad and not tpg.requires_grad
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tpg.numpy(), np.asarray(jpg), rtol=0,
                               atol=1e-6)


# ---- RMSProp ----------------------------------------------------------------

def _rms_chain(anneal):
    lr = optax.linear_schedule(3e-4, 0.0, 10) if anneal else 3e-4
    return optax.chain(optax.clip_by_global_norm(MAXNORM),
                       optax.rmsprop(lr, decay=0.99, eps=0.1))


@pytest.mark.parametrize("anneal", [True, False])
def test_clip_rms_matches_optax(anneal):
    """Twelve steps, alternating gradients far above and below the clip
    norm. Params and nu within 1e-6 relative: the global norm is summed in
    another order, and XLA's rsqrt on the CPU is not torch's (one ulp)."""
    g = np.random.default_rng(0)
    shapes = {"params": {"Dense_0": {"kernel": (6, 4), "bias": (4,)},
                         "Dense_1": {"kernel": (4, 5), "bias": (5,)},
                         "Dense_2": {"kernel": (4, 1), "bias": (1,)}}}
    p_np = jax.tree.map(lambda s: g.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    tx = _rms_chain(anneal)
    opt = ClipRMSProp(linear_schedule(3e-4, 0.0, 10) if anneal else 3e-4,
                      MAXNORM)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree_np(p_np).items()}
    ts = opt.init(tp)
    for i in range(12):
        scale = 3.0 if i % 2 == 0 else 0.01
        grad = jax.tree.map(lambda x: (scale * g.normal(size=x.shape))
                            .astype(np.float32), p_np)
        u, js = tx.update(jax.tree.map(jnp.asarray, grad), js, jp)
        jp = optax.apply_updates(jp, u)
        (lr,) = opt.step_rows(ts.count, 1)
        tu, ts = clip_rms_step(
            {k: torch.from_numpy(v) for k, v in tree_np(grad).items()}, ts,
            lr[0], MAXNORM)
        tp = apply_updates(tp, tu)
        assert_tree(tp, jp, 1e-6, 1e-9, f"step {i} params")
    assert ts.count == 12
    assert_tree(ts.nu, find_rms_state(js), 1e-6, 1e-12, "nu")
    carried = opt_state_from_optax(jax.tree.map(np.asarray, js),
                                   default_count=12)
    assert isinstance(carried, RMSState) and carried.count == 12
    for k in ts.nu:
        torch.testing.assert_close(carried.nu[k], ts.nu[k], rtol=1e-6,
                                   atol=1e-12)


def test_opt_state_from_optax_reads_rmsprop_counts():
    """The annealed chain's count comes from its schedule state; the
    constant-lr chain keeps none and takes ``default_count``."""
    params = {"params": {f"Dense_{i}": {"kernel": jnp.zeros((2, n)),
                                        "bias": jnp.zeros(n)}
                         for i, n in enumerate((2, 5, 1))}}
    for anneal, want in ((True, 5), (False, 7)):
        tx = _rms_chain(anneal)
        s = tx.init(params)
        for _ in range(5):
            _, s = tx.update(jax.tree.map(jnp.ones_like, params), s, params)
        got = opt_state_from_optax(jax.tree.map(np.asarray, s),
                                   default_count=7)
        assert isinstance(got, RMSState) and got.count == want
        assert got.nu["hidden.0.weight"].shape == (2, 2)


def test_make_impala_optimizer_and_step_rows():
    """RMSProp or Adam per ``impala_rmsprop``; the lr row of the fused path
    (``impala.py:499-506``) bit-equal to optax's schedule."""
    tcfg = TrainConfig(num_updates=10, num_minibatches=4, impala_passes=2)
    rms = make_impala_optimizer(tcfg)
    adam = make_impala_optimizer(tcfg.replace(impala_rmsprop=False))
    assert isinstance(rms, ClipRMSProp) and isinstance(adam, ClipAdam)
    sched = optax.linear_schedule(3e-4, 0.0, 10 * 2 * 4)
    (lr,) = rms.step_rows(37, 8)
    np.testing.assert_array_equal(
        lr.numpy(), np.asarray(jax.vmap(sched)(37 + jnp.arange(8)),
                               np.float32))
    const = make_impala_optimizer(tcfg.replace(anneal_lr=False))
    assert torch.equal(const.step_rows(0, 3)[0], torch.full((3,), 3e-4))


# ---- the learner phase and per-minibatch gradients -----------------------------

def port_inputs(params, data, last_obs):
    obs, action, b_lp, reward, done, mask = map(t, data)
    traj = ImpalaTransition(obs, action, b_lp, reward, done, mask,
                            torch.zeros_like(reward))
    port_params = {k: torch.from_numpy(v)
                   for k, v in tree_np(params).items()}
    return port_params, traj, t(last_obs)


@pytest.mark.parametrize("mask_on,use_rms", [(False, True), (True, True),
                                             (False, False), (True, False)])
def test_impala_phase_twin_matches_pallas_and_xla(mask_on, use_rms):
    (model, params, tx, sched, opt_state, data, last_obs) = _setup(
        mask_on, use_rms)
    # The XLA scaffold: train/impala.py's passes x minibatches cadence.
    mbs, last_mbs = _env_minibatches(data, last_obs)
    loss_fn = _loss_fn_for(model, mask_on)
    p_x, opt_x, l_x = params, opt_state, []
    for _ in range(PASSES):
        for m in range(M):
            (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                p_x, jax.tree.map(lambda x: x[m], mbs), last_mbs[m])
            updates, opt_x = tx.update(grads, opt_x, p_x)
            p_x = optax.apply_updates(p_x, updates)
            l_x.append((loss, *aux))
    l_x = [jnp.stack([r[i] for r in l_x]).reshape(PASSES, M)
           for i in range(4)]
    # The Pallas phase kernel in interpret mode.
    n_steps = PASSES * M
    steps = jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_p, opt_p, l_p = impala_sgd_phase_pallas(
        params, opt_state, *_kernel_inputs(data, last_obs),
        jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
        1.0 - 0.999 ** cnt, ENT, num_passes=PASSES, num_minibatches=M,
        unroll_length=J_T, num_agents=J_A, max_grad_norm=MAXNORM,
        mask_actions=mask_on, obs_dim=J_D, use_rms=use_rms, block_envs=8,
        eps=0.1 if use_rms else 1e-5, interpret=True, **LOSS_KW)

    p0, traj, lobs = port_inputs(params, data, last_obs)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    assert isinstance(opt0, RMSState if use_rms else AdamState)
    optimizer = (ClipRMSProp if use_rms else ClipAdam)(
        linear_schedule(3e-4, 0.0, 100), MAXNORM)
    rows = optimizer.step_rows(opt0.count, n_steps)
    vtrace_sgd.impala_sgd_phase.launches = 0
    p_t, opt_t, l_t = vtrace_sgd.impala_sgd_phase(
        p0, opt0, traj, lobs, rows, ENT, num_passes=PASSES,
        num_minibatches=M, max_grad_norm=MAXNORM, mask_actions=mask_on,
        bootstrap_truncated=False, **LOSS_KW)
    assert vtrace_sgd.impala_sgd_phase.launches == 0  # the twin ran
    assert opt_t.count == n_steps and type(opt_t) is type(opt0)
    for p_ref, opt_ref, l_ref in ((p_x, opt_x, l_x), (p_p, opt_p, l_p)):
        for a, b in zip(l_t, l_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=2e-6)
        assert_tree(p_t, p_ref, 1e-5, 1e-6, "params")
        if use_rms:
            nu = find_rms_state(opt_ref)
        else:
            count, mu, nu = find_adam_state(opt_ref)
            assert int(count) == n_steps
            assert_tree(opt_t.mu, mu, 1e-5, 1e-7, "mu")
        assert_tree(opt_t.nu, nu, 1e-5, 1e-10, "nu")


@pytest.mark.parametrize("mask_on", [False, True])
def test_impala_grads_twin_matches_pallas_and_jax_grad(mask_on):
    (model, params, _tx, _s, _o, data, last_obs) = _setup(mask_on, True,
                                                         seed=3)
    mbs, last_mbs = _env_minibatches(data, last_obs)
    loss_fn = _loss_fn_for(model, mask_on)
    obs_bm, fields, lrows = _kernel_inputs(data, last_obs)
    p0, traj, lobs = port_inputs(params, data, last_obs)
    for m in range(M):
        jax_grad = jax.value_and_grad(loss_fn, has_aux=True)(
            params, jax.tree.map(lambda x: x[m], mbs), last_mbs[m])
        pallas = impala_minibatch_grads_pallas(
            params, obs_bm, fields, lrows, m, ENT, num_minibatches=M,
            unroll_length=J_T, num_agents=J_A, mask_actions=mask_on,
            obs_dim=J_D, block_envs=8, interpret=True, **LOSS_KW)
        (l_t, aux_t), g_t = vtrace_sgd.impala_minibatch_grads(
            p0, traj, lobs, m, ENT, num_minibatches=M, mask_actions=mask_on,
            bootstrap_truncated=False, **LOSS_KW)
        for (l_r, aux_r), g_r in (jax_grad, pallas):
            for a, b in zip((l_t, *aux_t), (l_r, *aux_r)):
                assert abs(float(a) - float(b)) < 1e-6
            assert_tree(g_t, g_r, 1e-4, 1e-6, f"grads mb={m}")


# ---- the trainer --------------------------------------------------------------

@pytest.mark.parametrize("change", [
    dict(), dict(impala_rmsprop=False),
    dict(impala_passes=2, bootstrap_truncated=True),
    dict(mask_actions=True, impala_rmsprop=False)],
    ids=["rmsprop", "adam", "passes2-bootstrap", "masked-adam"])
def test_train_steps_match_jax_trainer(change):
    tcfg = BASE.replace(**change)
    jtr = j_make_train(CFG, tcfg)
    tr = make_train_impala(CFG, tcfg, device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = impala_runner_state_from_jax(jax.tree.map(np.asarray, jrs), tcfg)
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
    steps = 3 * tcfg.impala_passes * tcfg.num_minibatches
    assert rs.opt_state.count == steps
    assert_params(rs.params, jrs.params, 2e-4, 5e-5, "params")
    if tcfg.impala_rmsprop:
        nu = find_rms_state(jrs.opt_state)
    else:
        _, mu, nu = find_adam_state(jrs.opt_state)
        assert_params(rs.opt_state.mu, mu, 2e-4, 5e-6, "mu")
    assert_params(rs.opt_state.nu, nu, 2e-4, 1e-9, "nu")


def test_init_matches_jax_init():
    """Env resets from fold_in(ekey, i) and the shard key fold_in(skey, 0)
    bit-equal; the params come from a torch.Generator."""
    jrs = j_make_train(CFG, BASE).init(jax.random.PRNGKey(3))
    tr = make_train_impala(CFG, BASE, device="cpu")
    rs = tr.init(rng.prng_key(3))
    for f in STATE_FIELDS:
        assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f), f)
    assert_bits(jrs.obs, rs.obs, "obs")
    assert torch.equal(rs.key, to_torch(jrs.key).reshape(2))
    assert isinstance(rs.opt_state, RMSState) and rs.opt_state.count == 0
    assert rs.params.keys() == tr.model.state_dict().keys()


def test_train_many_runs_and_plain_step_is_the_cpu_path():
    tr = make_train_impala(CFG, BASE.replace(impala_rmsprop=False),
                          device="cpu")
    rs0 = tr.init(rng.prng_key(1))
    rs, ms = tr.train_many(rs0, 2)
    assert int(rs.update_idx) == 2
    assert all(v.shape == (2,) and bool(torch.isfinite(v).all())
               for v in ms.values())
    assert any(not torch.equal(rs.params[k], rs0.params[k])
               for k in rs.params)
    a, ma = tr.train_step(rs0)
    b, mb = tr.plain_step(rs0)
    assert torch.equal(a.env_state.agent_pos, b.env_state.agent_pos)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)
    assert float(ma["loss"]) == float(mb["loss"])


# Each case keeps the id it had while it was refused: the CNN, bf16,
# global observations and an unroll length that does not divide max_steps
# are built now, acting per step; a mesh (a world-1 gloo group) takes the
# meshed route.
@pytest.mark.parametrize("change, error", [
    pytest.param(dict(arch="cnn"), None, id="change0-NotImplementedError"),
    pytest.param(dict(mesh=True), None, id="change1-NotImplementedError"),
    pytest.param(dict(model_dtype="bfloat16"), None,
                 id="change2-NotImplementedError"),
    (dict(micro_batches=2), None),  # ported: the learner runs plain
    (dict(flat_optimizer=True), None),  # ported: the learner runs plain
    pytest.param(dict(global_obs=True), None,
                 id="change5-NotImplementedError"),
    (dict(rollout_backend="xla"), ValueError),
    (dict(grad_backend="xla"), ValueError),
    (dict(num_envs=15), ValueError),
    pytest.param(dict(unroll_length=3), None, id="change9-ValueError"),
])
def test_gates_raise(change, error, tmp_path):
    change = dict(change)
    kw = {k: change.pop(k) for k in ("arch", "mesh") if k in change}
    cfg = CFG.replace(global_obs=change.pop("global_obs", False))
    if kw.pop("mesh", False):
        # A world-1 data mesh: the meshed route runs (K6's gradient
        # averaged over one rank, then the step).
        with process_group(tmp_path / "store") as mesh:
            tr = make_train_impala(cfg, BASE.replace(**change), device="cpu",
                                   mesh=mesh, **kw)
            assert tr.mesh is mesh
            assert tr.backends == {"rollout": "plain", "grad": "plain"}
            rs, m = tr.train_step(tr.init_global(rng.prng_key(0)))
            assert int(rs.update_idx) == 1 and all(
                bool(torch.isfinite(v)) for v in m.values())
        return
    if error is None:
        tcfg = BASE.replace(**change)
        tr = make_train_impala(cfg, tcfg, device="cpu", **kw)
        if rollout_problems_impala(cfg, tcfg, kw.get("arch", "mlp")):
            # Acting per step; K5's twin learns the MLP in float32.
            assert tr.backends == {"rollout": "step", "grad": "plain"}
            rs, m = tr.train_step(tr.init(rng.prng_key(0)))
            assert int(rs.update_idx) == 1 and all(
                bool(torch.isfinite(v)) for v in m.values())
            return
        assert tr.backends == {"rollout": "plain", "grad": "plain"}
        return
    match = "ROADMAP" if error is NotImplementedError else None
    with pytest.raises(error, match=match):
        make_train_impala(cfg, BASE.replace(**change), device="cpu", **kw)


def test_rmsprop_warns_at_build(caplog):
    """As the JAX trainer (``impala.py:207-213``): building with the
    canonical RMSProp warns and points at --impala-adam; Adam is
    silent."""
    with caplog.at_level(logging.WARNING, logger="warehouse_tpu_torch"):
        make_train_impala(CFG, BASE, device="cpu")
    assert any("impala-adam" in r.message for r in caplog.records
               if r.levelno == logging.WARNING)
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="warehouse_tpu_torch"):
        make_train_impala(CFG, BASE.replace(impala_rmsprop=False),
                          device="cpu")
    assert not any("impala-adam" in r.message for r in caplog.records)


def test_cli_runs_two_impala_updates(tmp_path):
    path = tmp_path / "metrics.jsonl"
    cli_main(["--algo", "impala", "--impala-adam", "--impala-passes", "2",
              "--mask-actions", "--env", "small", "--env-config",
              '{"max_steps": 8}', "--num-envs", "16", "--unroll-length",
              "4", "--num-updates", "2", "--num-minibatches", "2",
              "--hidden-dim", "16", "--log-every", "1", "--device", "cpu",
              "--metrics-path", str(path)])
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert recs[0]["meta"] and recs[0]["algo"] == "impala"
    steps = [r for r in recs[1:] if "loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    assert all(r["env_steps_per_sec"] > 0 and np.isfinite(r["loss"])
               for r in steps)

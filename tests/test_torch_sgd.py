"""The PPO update pieces of the port against the JAX package: optimizer,
GAE, loss, and the SGD phase and per-minibatch gradients (the plain twins
of K3/K4, which is what their wrappers run on CPU tensors).

The SGD-phase cases reuse ``tests/test_grad_kernel.py``'s setup (T = 4,
B = 16, A = 2, D = 26, hidden 16, E = M = 2) and hold the port against
the Pallas kernels in interpret mode and against the XLA scaffold
(``minibatch_epochs`` + optax), with that file's tolerances: f32 sums in
another order, nothing else.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from warehouse_tpu.ops.gae import gae as j_gae
from warehouse_tpu.ops.ppo_update import minibatch_epochs as j_epochs
from warehouse_tpu.ops.ppo_update import ppo_losses as j_losses
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.pallas.sgd import (
    normalize_adv_env_minibatch as j_normalize,
    ppo_minibatch_grads_pallas,
    ppo_sgd_phase_pallas,
)
from warehouse_tpu_torch.kernels import sgd
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.ops.gae import gae
from warehouse_tpu_torch.ops.ppo_update import (NEG_INF, adaptive_kl_coeff,
                                                entropy_coef_at, ppo_losses)
from warehouse_tpu_torch.optim import (ClipAdam, apply_updates,
                                       clip_adam_step, linear_schedule,
                                       opt_state_from_optax)
from warehouse_tpu_torch.train.ppo import Transition
from warehouse_tpu_torch import TrainConfig

from test_grad_kernel import (CLIP, ENT, KL, MAXNORM, VCOEF, E, M,
                              _envmajor_minibatches, _kernel_inputs,
                              _loss_fn_for, _setup)
from test_grad_kernel import D as J_D


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def tree_np(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def assert_tree(port: dict, jax_tree, rtol, atol, what=""):
    want = tree_np(jax_tree)
    assert port.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k], rtol=rtol,
                                   atol=atol, err_msg=f"{what} {k}")


# ---- optim.py -----------------------------------------------------------------

@pytest.mark.parametrize("anneal", [True, False])
def test_clip_adam_matches_optax(anneal):
    """Twelve steps, alternating gradients far above and below the clip
    norm. Params, moments, count and the carried state: rtol 1e-6 (the
    global norm is summed in another order; one ulp on the updates)."""
    rng = np.random.default_rng(0)
    shapes = {"params": {"Dense_0": {"kernel": (6, 4), "bias": (4,)},
                         "Dense_1": {"kernel": (4, 5), "bias": (5,)},
                         "Dense_2": {"kernel": (4, 1), "bias": (1,)}}}
    p_np = jax.tree.map(lambda s: rng.normal(size=s).astype(np.float32),
                        shapes, is_leaf=lambda x: isinstance(x, tuple))
    lr = optax.linear_schedule(3e-4, 0.0, 10) if anneal else 3e-4
    tx = optax.chain(optax.clip_by_global_norm(MAXNORM),
                     optax.adam(lr, b1=0.9, b2=0.999, eps=1e-5))
    opt = ClipAdam(linear_schedule(3e-4, 0.0, 10) if anneal else 3e-4,
                   MAXNORM)
    jp = jax.tree.map(jnp.asarray, p_np)
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in tree_np(p_np).items()}
    ts = opt.init(tp)
    for i in range(12):
        scale = 3.0 if i % 2 == 0 else 0.01
        g = jax.tree.map(lambda x: (scale * rng.normal(size=x.shape))
                         .astype(np.float32), p_np)
        u, js = tx.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        tu, ts = clip_adam_step(
            {k: torch.from_numpy(v) for k, v in tree_np(g).items()}, ts,
            *(r[0] for r in opt.step_rows(ts.count, 1)), MAXNORM)
        tp = apply_updates(tp, tu)
        assert_tree(tp, jp, 1e-6, 1e-9, f"step {i} params")
    count, mu, nu = find_adam_state(js)
    assert ts.count == int(count) == 12
    assert_tree(ts.mu, mu, 1e-6, 1e-9, "mu")
    assert_tree(ts.nu, nu, 1e-6, 1e-12, "nu")
    carried = opt_state_from_optax(jax.tree.map(np.asarray, js))
    assert carried.count == 12
    for a, b in ((carried.mu, ts.mu), (carried.nu, ts.nu)):
        for k in b:
            torch.testing.assert_close(a[k], b[k], rtol=1e-6, atol=1e-12)


def test_step_rows_match_the_jax_rows():
    """The per-step lr and bias-correction rows of the fused path
    (``train/ppo.py:678-686``): lr bit-equal, corrections within 1 ulp
    (``pow`` differs by an ulp between XLA and torch)."""
    sched = optax.linear_schedule(3e-4, 0.0, 100)
    steps = 37 + jnp.arange(8)
    cnt = (steps + 1).astype(jnp.float32)
    lr, bc1, bc2 = ClipAdam(linear_schedule(3e-4, 0.0, 100),
                            MAXNORM).step_rows(37, 8)
    np.testing.assert_array_equal(
        lr.numpy(), np.asarray(jax.vmap(sched)(steps), np.float32))
    for got, want in ((bc1, 1.0 - 0.9 ** cnt), (bc2, 1.0 - 0.999 ** cnt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-7,
                                   atol=0)


def test_opt_state_from_optax_rejects_other_chains():
    state = optax.sgd(0.1).init({"params": {"Dense_0": {
        "kernel": jnp.zeros((2, 2)), "bias": jnp.zeros(2)}}})
    with pytest.raises(ValueError, match="Adam"):
        opt_state_from_optax(jax.tree.map(np.asarray, state))


# ---- GAE, loss, schedules -----------------------------------------------------

@pytest.mark.parametrize("bootstrap", [False, True])
def test_gae_matches_jax(bootstrap):
    """Advantages and targets within 1e-6: XLA may contract the delta
    sums into FMAs."""
    rng = np.random.default_rng(1)
    Tn, Bn = 12, 9
    r = rng.normal(size=(Tn, Bn)).astype(np.float32)
    v = rng.normal(size=(Tn, Bn)).astype(np.float32)
    d = rng.random((Tn, Bn)) < 0.2
    last = rng.normal(size=Bn).astype(np.float32)
    bv = rng.normal(size=(Tn, Bn)).astype(np.float32) if bootstrap else None
    ja, jt = j_gae(jnp.asarray(r), jnp.asarray(v), jnp.asarray(d),
                   jnp.asarray(last), 0.99, 0.95,
                   None if bv is None else jnp.asarray(bv))
    ta, tt = gae(t(r), t(v), t(d), t(last), 0.99, 0.95,
                 None if bv is None else t(bv))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=0, atol=1e-6)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_ppo_losses_and_grads_match_jax(normalize, masked):
    """Loss terms within 1e-6 and d loss / d (logits, value) within 1e-5
    relative (f32 means in another order), masked logits included."""
    rng = np.random.default_rng(2)
    N = 64
    logits = rng.normal(size=(N, 5)).astype(np.float32)
    value = rng.normal(size=N).astype(np.float32)
    action = rng.integers(0, 5, N).astype(np.int32)
    mask = rng.random((N, 5)) > 0.3
    mask[np.arange(N), action] = True
    old_lp = (-1.6 + 0.3 * rng.normal(size=N)).astype(np.float32)
    rest = [rng.normal(size=N).astype(np.float32) for _ in range(3)]
    kw = dict(clip_eps=CLIP, value_coef=VCOEF, ent_coef=ENT, kl_coeff=KL,
              normalize_adv=normalize)

    def j_fn(lg, val):
        if masked:
            lg = jnp.where(jnp.asarray(mask), lg, NEG_INF)
        return j_losses(lg, val, jnp.asarray(action), jnp.asarray(old_lp),
                        *map(jnp.asarray, rest), **kw)

    (jt, jaux), jg = jax.value_and_grad(j_fn, argnums=(0, 1), has_aux=True)(
        jnp.asarray(logits), jnp.asarray(value))
    lg, val = t(logits).requires_grad_(), t(value).requires_grad_()
    masked_lg = torch.where(t(mask), lg, NEG_INF) if masked else lg
    tt, taux = ppo_losses(masked_lg, val, t(action), t(old_lp),
                          *map(t, rest), **kw)
    tg = torch.autograd.grad(tt, (lg, val))
    for a, b in zip((tt, *taux), (jt, *jaux)):
        assert float(a.detach()) == pytest.approx(float(b), rel=1e-6, abs=1e-6)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-7)


def test_schedules_match_jax():
    from warehouse_tpu.ops.ppo_update import adaptive_kl_coeff as j_kl
    from warehouse_tpu.ops.ppo_update import entropy_coef_at as j_ent

    for tcfg in (TrainConfig(entropy_coef_final=0.001, num_updates=7),
                 TrainConfig()):
        for u in (0, 3, 7):
            got = entropy_coef_at(tcfg, torch.tensor(u, dtype=torch.int32))
            assert float(got) == float(j_ent(tcfg, jnp.int32(u)))
    tcfg = TrainConfig(kl_coeff=0.2, kl_target=0.01)
    for kl in (0.001, 0.01, 0.05):
        assert float(adaptive_kl_coeff(tcfg, torch.tensor(0.2), torch.tensor(
            kl))) == pytest.approx(float(j_kl(tcfg, jnp.float32(0.2),
                                                  jnp.float32(kl))))


def test_normalize_adv_env_minibatch_matches_jax():
    adv = np.random.default_rng(4).normal(size=(4, 16, 2)).astype(np.float32)
    np.testing.assert_allclose(
        sgd.normalize_adv_env_minibatch(t(adv), 4).numpy(),
        np.asarray(j_normalize(jnp.asarray(adv), 4)), rtol=0, atol=2e-6)


# ---- the SGD phase and per-minibatch gradients --------------------------------

def port_inputs(params, opt_state, data):
    obs, action, old_lp, old_v, adv_n, tgt, mask = map(t, data)
    zeros = torch.zeros_like(old_v)
    traj = Transition(obs, action, old_lp, old_v, zeros, zeros.bool(), mask,
                      zeros)
    port_params = {k: torch.from_numpy(v)
                   for k, v in tree_np(params).items()}
    return port_params, traj, adv_n, tgt


@pytest.mark.parametrize("mask_on", [False, True])
def test_sgd_phase_twin_matches_pallas_and_xla(mask_on):
    model, params, tx, sched, opt_state, data = _setup(mask_on)
    n_steps = E * M
    # The XLA scaffold on contiguous env minibatches.
    p_x, opt_x, _, l_x = j_epochs(
        params, opt_state, jax.random.PRNGKey(2),
        loss_fn=_loss_fn_for(model, mask_on),
        make_minibatches=lambda _k: _envmajor_minibatches(data),
        num_epochs=E, tx=tx, reshuffle_each_epoch=False)
    # The Pallas phase kernel in interpret mode.
    steps = jnp.arange(n_steps)
    cnt = (steps + 1).astype(jnp.float32)
    p_p, opt_p, l_p = ppo_sgd_phase_pallas(
        params, opt_state, *_kernel_inputs(data),
        jax.vmap(sched)(steps).astype(jnp.float32), 1.0 - 0.9 ** cnt,
        1.0 - 0.999 ** cnt, ENT, KL, num_epochs=E, num_minibatches=M,
        clip_eps=CLIP, value_coef=VCOEF, max_grad_norm=MAXNORM,
        mask_actions=mask_on, obs_dim=J_D, block_envs=8, rows_per_block=4,
        interpret=True)

    p0, traj, adv_n, tgt = port_inputs(params, opt_state, data)
    opt0 = opt_state_from_optax(jax.tree.map(np.asarray, opt_state))
    rows = ClipAdam(linear_schedule(3e-4, 0.0, 100), MAXNORM).step_rows(
        opt0.count, n_steps)
    sgd.ppo_sgd_phase.launches = 0
    p_t, opt_t, l_t = sgd.ppo_sgd_phase(
        p0, opt0, traj, adv_n, tgt, *rows, ENT, KL, num_epochs=E,
        num_minibatches=M, clip_eps=CLIP, value_coef=VCOEF,
        max_grad_norm=MAXNORM, mask_actions=mask_on)
    assert sgd.ppo_sgd_phase.launches == 0  # the twin ran on the CPU
    assert opt_t.count == n_steps
    for p_ref, opt_ref, l_ref in ((p_x, opt_x, l_x), (p_p, opt_p, l_p)):
        for a, b in zip(l_t, l_ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=2e-6)
        assert_tree(p_t, p_ref, 1e-5, 1e-6, "params")
        count, mu, nu = find_adam_state(opt_ref)
        assert int(count) == n_steps
        assert_tree(opt_t.mu, mu, 1e-5, 1e-7, "mu")
        assert_tree(opt_t.nu, nu, 1e-5, 1e-10, "nu")


@pytest.mark.parametrize("mask_on", [False, True])
def test_minibatch_grads_twin_matches_pallas_and_jax_grad(mask_on):
    model, params, _tx, _sched, opt_state, data = _setup(mask_on, seed=3)
    mbs = _envmajor_minibatches(data)
    loss_fn = _loss_fn_for(model, mask_on)
    obs_bm, fields = _kernel_inputs(data)
    p0, traj, adv_n, tgt = port_inputs(params, opt_state, data)
    for mb in range(M):
        ref_mb = jax.tree.map(lambda x: x[mb], mbs)
        jax_grad = jax.value_and_grad(loss_fn, has_aux=True)(params, ref_mb)
        pallas = ppo_minibatch_grads_pallas(
            params, obs_bm, fields, mb, ENT, KL, num_minibatches=M,
            clip_eps=CLIP, value_coef=VCOEF, mask_actions=mask_on,
            obs_dim=J_D, block_envs=8, interpret=True)
        (l_t, aux_t), g_t = sgd.ppo_minibatch_grads(
            p0, traj, adv_n, tgt, mb, ENT, KL, num_minibatches=M,
            clip_eps=CLIP, value_coef=VCOEF, mask_actions=mask_on)
        for (l_r, aux_r), g_r in (jax_grad, pallas):
            for a, b in zip((l_t, *aux_t), (l_r, *aux_r)):
                assert abs(float(a) - float(b)) < 1e-6
            assert_tree(g_t, g_r, 1e-4, 1e-7, f"grads mb={mb}")


def test_pack_round_trip_and_layout():
    """The kernels' flat layout: per layer W [out, in] then b, the head
    stacking the logits rows over the value row."""
    from warehouse_tpu_torch import small_config
    from warehouse_tpu_torch.models import make_model

    m = make_model(small_config(), hidden_dim=8,
                   generator=torch.Generator().manual_seed(0), device="cpu")
    params = dict(m.state_dict())
    flat = sgd.pack(params)
    assert flat.numel() == sum(v.numel() for v in params.values())
    back = sgd.unpack(flat, params)
    assert list(back) == list(params)
    for k in params:
        assert torch.equal(back[k], params[k]), k
    H = 8
    head = flat[-(6 * H + 6):]
    assert torch.equal(head[:5 * H].view(5, H), params["logits.weight"])
    assert torch.equal(head[5 * H:6 * H], params["value.weight"][0])

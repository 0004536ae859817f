"""The recurrent trainer's per-step acting phase and the carry reset of its
plain replay (ROADMAP M-4b), on the CPU, against the JAX trainer's XLA
route.

Where K7 does not take a configuration (``global_obs``, ``shaping_coef``,
``bootstrap_truncated``, ``max_steps % unroll_length != 0``), the JAX
trainer acts through its XLA scan (``warehouse_tpu/train/ppo_rnn.py:288-
332``) and the port through ``train.ppo.step_rollout`` with the recurrent
carry: V of ``final_obs`` from the pre-reset carry, the carry zeroed where
``done``. Where an episode can end inside a chunk, K8's replay (no carry
reset inside a chunk) is refused like the JAX gate refuses its kernel, and
the plain replay zeroes the carry after each ``done`` as the JAX XLA
replay's ``cell_step`` does (:369-380). Held here, each for 3 updates from
one carried-over state (env state, obs and keys bit-equal, metrics within
2e-4 + 1e-3 relative, params and moments at ``tests/test_torch_m4.py``'s
bounds, the carry within 1e-5): the GRU and the LSTM with an episode
ending inside the second chunk; the GRU with global observations, with
shaping and the mask on a walled map and with the truncation bootstrap
(each K8's twin learning from the per-step phase). And ``replay_loss_fn``
alone: with a ``done`` inside the sequence, its loss and gradients against
``jax.value_and_grad`` of the JAX XLA replay's loss; with ``done`` only on
the last step, bit-equal to the replay without ``done`` (K8's twin keeps
its bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.models.policy import make_model as j_make_model
from warehouse_tpu.ops.ppo_update import ppo_losses as j_ppo_losses
from warehouse_tpu.train.ppo_rnn import make_train_rnn as j_make_rnn
from warehouse_tpu_torch.kernels.sgd_rnn import replay_loss_fn
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.train import make_train_rnn, runner_state_rnn_from_jax
from warehouse_tpu_torch.train.ppo_rnn import (grad_problems_rnn,
                                               rollout_problems_rnn)

from test_torch_step_acting import (RAGGED, STEP_PLAIN, WALLED, assert_learned,
                                    run_ragged)

BASE = TrainConfig(num_envs=8, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   kl_coeff=0.1, entropy_coef_final=0.001)
EIGHT = (4, 0, 4)  # t after each update at max_steps 8: the chunk's end

RNN_CASES = {
    # name: (env, arch, TrainConfig change, t after each update)
    "gru_ragged": (RAGGED, "gru", {}, (4, 2, 0)),
    "lstm_ragged": (RAGGED, "lstm", {}, (4, 2, 0)),
    "gru_global_obs": (small_config(max_steps=8, global_obs=True), "gru", {},
                       EIGHT),
    "gru_walled_masked_shaped": (WALLED.replace(max_steps=8), "gru", dict(
        mask_actions=True, shaping_coef=0.1), EIGHT),
    "gru_bootstrap": (small_config(max_steps=8), "gru",
                      dict(bootstrap_truncated=True), EIGHT),
}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_step_acting_matches_jax_xla(case):
    cfg, arch, change, ts = RNN_CASES[case]
    tcfg = BASE.replace(**change)
    jtr = j_make_rnn(cfg, tcfg, arch=arch)
    assert jtr.backends == {"rollout": "xla", "grad": "xla"}
    tr = make_train_rnn(cfg, tcfg, arch=arch, device="cpu")
    assert rollout_problems_rnn(cfg, tcfg) and tr.backends == STEP_PLAIN
    # K8 (its twin here) learns unless an episode can end inside a chunk.
    assert bool(grad_problems_rnn(cfg, tcfg)) == case.endswith("ragged")
    jrs = jtr.init(jax.random.PRNGKey(1))
    rs = runner_state_rnn_from_jax(jax.tree.map(np.asarray, jrs))
    rs, jrs = run_ragged(jtr, tr, rs, jrs, ts)
    for c, jc in zip(jax.tree.leaves(rs.carry), jax.tree.leaves(jrs.carry)):
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=0,
                                   atol=1e-5)
    assert_learned(rs, jrs)


def replay_batch(arch, T=5, B=3, A=2, seed=0):
    """A flax recurrent model's params, and a sequence minibatch of T steps
    made from a seed with numpy (numpy leaves)."""
    cfg = small_config()
    model = j_make_model(cfg, arch, 16, 2)
    r = np.random.default_rng(seed)
    D = cfg.obs_dim
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)),
                        model.initial_carry((1,)))
    batch = dict(
        obs=r.integers(0, 2, (T, B, A, D)).astype(np.float32),
        action=r.integers(0, 5, (T, B, A)).astype(np.int32),
        old_lp=np.log(r.uniform(0.1, 0.3, (T, B, A))).astype(np.float32),
        old_v=r.normal(0, 0.3, (T, B, A)).astype(np.float32),
        adv=r.normal(0, 1, (T, B, A)).astype(np.float32),
        tgt=r.normal(0, 0.5, (T, B, A)).astype(np.float32),
        mask=r.uniform(size=(T, B, A, 5)) < 0.8)
    h0 = [r.normal(0, 0.5, (B, A, 16)).astype(np.float32)
          for _ in range(2 if arch == "lstm" else 1)]
    return model, params, batch, h0


KW = dict(clip_eps=0.2, value_coef=0.5, ent_coef=0.01, kl_coeff=0.05)


def jax_replay_loss(model, params, b, done, h0):
    """The JAX XLA replay's loss (``train/ppo_rnn.py:369-390``): the
    T-step ``cell_step`` scan zeroing the carry after each ``done_t``, the
    mask, ``ppo_losses`` with advantages normalized in the loss."""
    def cell_step(h, xs):
        obs_t, mask_t, done_t = xs
        logits, value, h_new = model.apply(params, obs_t, h)
        logits = jnp.where(mask_t, logits, -1e9)
        h_new = jax.tree.map(lambda x: jnp.where(done_t[..., None], 0.0, x),
                             h_new)
        return h_new, (logits, value)

    _, (logits, value) = jax.lax.scan(
        cell_step, h0, (b["obs"], b["mask"], done))
    return j_ppo_losses(logits, value, b["action"], b["old_lp"], b["old_v"],
                        b["adv"], b["tgt"], clip_eps=KW["clip_eps"],
                        value_coef=KW["value_coef"], ent_coef=KW["ent_coef"],
                        kl_coeff=KW["kl_coeff"])


def torch_mb(b, done, h0):
    fields = tuple(torch.from_numpy(np.asarray(b[k])) for k in (
        "obs", "action", "old_lp", "old_v", "adv", "tgt", "mask"))
    if done is not None:
        fields += (torch.from_numpy(done),)
    carry = [torch.from_numpy(h) for h in h0]
    return fields, tuple(carry) if len(carry) == 2 else carry[0]


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_replay_loss_resets_the_carry_at_done(arch):
    """A ``done`` on step 1 of 5 for some sequences: the loss and every
    gradient against ``jax.value_and_grad`` of the JAX XLA replay, at the
    recurrent twins' tolerances; without the reset the loss differs."""
    model, params, b, h0 = replay_batch(arch)
    done = np.zeros(b["action"].shape, bool)
    done[1, 0] = True
    done[3, 2, 1] = True
    jh0 = tuple(jnp.asarray(h) for h in h0) if arch == "lstm" else (
        jnp.asarray(h0[0]))
    (jl, _), jg = jax.value_and_grad(
        lambda p: jax_replay_loss(model, p, b, done, jh0), has_aux=True)(
        params)
    leaves = {k: v.requires_grad_(True) for k, v in params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    loss_fn = replay_loss_fn(KW["clip_eps"], KW["value_coef"], KW["ent_coef"],
                             KW["kl_coeff"], True, normalize_adv=True)
    total, _ = loss_fn(leaves, torch_mb(b, done, h0))
    grads = torch.autograd.grad(total, list(leaves.values()))
    jl = float(jl)
    assert abs(float(total.detach()) - jl) <= 1e-6 + 1e-5 * abs(jl)
    want = params_from_flax(jax.tree.map(np.asarray, jg))
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    with torch.no_grad():
        unreset, _ = loss_fn(leaves, torch_mb(b, None, h0))
    assert abs(float(unreset) - jl) > 1e-4


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_replay_loss_with_done_on_the_last_step_keeps_its_bits(arch):
    """``done`` only on the chunk's last step (the only place an episode
    ends where K8 learns): loss and gradients bit-equal to the replay
    without ``done``."""
    model, params, b, h0 = replay_batch(arch, seed=1)
    done = np.zeros(b["action"].shape, bool)
    done[-1] = True
    loss_fn = replay_loss_fn(KW["clip_eps"], KW["value_coef"], KW["ent_coef"],
                             KW["kl_coeff"], True)
    out = []
    for d in (None, done):
        leaves = {k: v.requires_grad_(True) for k, v in params_from_flax(
            jax.tree.map(np.asarray, params)).items()}
        total, aux = loss_fn(leaves, torch_mb(b, d, h0))
        out.append((total, aux, torch.autograd.grad(total,
                                                    list(leaves.values()))))
    (t0, a0, g0), (t1, a1, g1) = out
    assert torch.equal(t0, t1)
    assert all(torch.equal(x, y) for x, y in zip(a0, a1))
    assert all(torch.equal(x, y) for x, y in zip(g0, g1))

"""The CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode). The file imports neither jax nor the JAX package, so
it runs where only the port is installed; tests/conftest.py imports jax,
so run it there with ``python -m pytest --noconftest -m gpu
tests/test_torch_kernels_gpu.py``. chip_smoke.py makes the same checks
at the main path's full sizes.
"""

import functools
import sys
from pathlib import Path

import pytest
import torch

from warehouse_tpu_torch import (large_config, medium_config, rng,
                                 shelves_config, small_config)
from warehouse_tpu_torch.env import batch
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.kernels.act import act_steps
from warehouse_tpu_torch.kernels import rollout
from warehouse_tpu_torch.kernels.rollout import (greedy_rollout,
                                                 greedy_rollout_reference,
                                                 spawn_draws_check)
from warehouse_tpu_torch.models import make_model
from warehouse_tpu_torch.ops.move import valid_action_mask

pytestmark = pytest.mark.gpu
N = 1000  # not a multiple of the envs per block: the last block is ragged
PRESETS = {"small": small_config(), "medium": medium_config(),
           "large": large_config(), "shelves": shelves_config()}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the CNN twins' convolutions
    return torch.device("cuda")


def reset(cfg, seed, dev):
    keys = rng.fold_in(rng.prng_key(seed, dev), torch.arange(N, device=dev))
    return batch.reset_batch(cfg, keys)


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_greedy_kernel_bit_equal_to_twin(name, dev):
    cfg = PRESETS[name]
    state, _ = reset(cfg, 2, dev)
    k = greedy_rollout(cfg, state, cfg.max_steps)
    p = greedy_rollout_reference(cfg, state, cfg.max_steps)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(k[0], f), getattr(p[0], f)), f
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[2].view(torch.int32), p[2].view(torch.int32))
    assert int(k[1].sum()) > 0


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_spawn_draws_kernel_bit_equal_to_stream(name, dev):
    """threefry.cuh alone: T ticks of (u, pick, drop) and the final keys,
    bit-equal to ``rng.batched_step_draws``."""
    cfg = PRESETS[name]
    state, _ = reset(cfg, 3, dev)
    got = spawn_draws_check(cfg, state.key, cfg.max_steps)
    want = rng.batched_step_draws(state.key, cfg, cfg.max_steps)[:4]
    for g, w, what in zip(got, want, ("key", "u", "pick", "drop")):
        assert g.dtype == w.dtype and g.shape == w.shape, what
        assert torch.equal(g.view(torch.int32), w.view(torch.int32)), what


def test_greedy_rollout_makes_no_host_draws(dev, monkeypatch):
    """On a CUDA state ``greedy_rollout`` is one K1 launch and no call of
    the host draw stream."""
    cfg = PRESETS["medium"]
    state, _ = reset(cfg, 4, dev)
    want = greedy_rollout_reference(cfg, state, 16)

    def no_host_draws(*args, **kw):
        raise AssertionError("greedy_rollout drew on the host")

    monkeypatch.setattr(rng, "batched_step_draws", no_host_draws)
    n = rollout.greedy_rollout.launches
    got = greedy_rollout(cfg, state, 16)
    assert rollout.greedy_rollout.launches == n + 1
    for f in STATE_FIELDS:
        assert torch.equal(getattr(got[0], f), getattr(want[0], f)), f
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2].view(torch.int32), want[2].view(torch.int32))


@pytest.mark.parametrize("B", [5, 8000, 9000, 17000, 34000, 70000])
def test_greedy_kernel_at_every_block_size(B, dev):
    """K1 takes smaller CTAs for a smaller batch (``k1_threads``: on 132
    SMs 32, 64, 128, 256 and 512 threads for these B): each bit-equal to
    the twin over 16 ticks."""
    cfg = PRESETS["medium"]
    keys = rng.fold_in(rng.prng_key(6, dev), torch.arange(B, device=dev))
    state, _ = batch.reset_batch(cfg, keys)
    k = greedy_rollout(cfg, state, 16)
    p = greedy_rollout_reference(cfg, state, 16)
    for f in STATE_FIELDS:
        assert torch.equal(getattr(k[0], f), getattr(p[0], f)), f
    assert torch.equal(k[1], p[1])
    assert torch.equal(k[2].view(torch.int32), p[2].view(torch.int32))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_act_kernel_matches_plain_path(name, dev):
    """The kernel's actions replayed through the plain engine: obs,
    rewards and deliveries bit-equal; values and log-probs within 1e-4
    of the plain MLP on the kernel's obs."""
    cfg, steps = PRESETS[name], 8
    m = make_model(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    state, _ = reset(cfg, 4, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(1, dev), steps,
                                     (5, N * cfg.num_agents))
    new, obs, action, lp, value, reward, delivered = act_steps(
        cfg, m, state, u, pick, drop, g)
    s = state
    for t in range(steps):
        assert torch.equal(batch.observe_batch(cfg, s), obs[t])
        s, ts = batch.step_batch(cfg, s, action[t])
        assert torch.equal(ts.reward, reward[t])
        assert torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                           delivered[t])
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    with torch.no_grad():
        logits, v = m(obs)
    lp_plain = torch.log_softmax(logits, -1).gather(
        -1, action.long()[..., None])[..., 0]
    assert float((v - value).abs().max()) < 1e-4
    assert float((lp_plain - lp).abs().max()) < 1e-4


@pytest.mark.parametrize("name", ["small", "shelves"])
def test_masked_act_kernel_matches_plain_path(name, dev):
    """K2's masking option: the returned mask is valid_action_mask of the
    replayed positions, no sampled move is masked, the dynamics bit-equal
    to the plain engine replaying the actions, log-probs within 1e-4 of
    the masked log-softmax of the plain MLP."""
    cfg, steps = PRESETS[name], 8
    m = make_model(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    state, _ = reset(cfg, 5, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(2, dev), steps,
                                     (5, N * cfg.num_agents))
    mask = torch.zeros(steps, N, cfg.num_agents, 5, dtype=torch.bool,
                       device=dev)
    new, obs, action, lp, value, reward, delivered = act_steps(
        cfg, m, state, u, pick, drop, g, mask=mask)
    s = state
    for t in range(steps):
        assert torch.equal(mask[t], valid_action_mask(cfg, s.agent_pos))
        assert bool(mask[t].gather(-1, action[t].long()[..., None]).all())
        assert torch.equal(batch.observe_batch(cfg, s), obs[t])
        s, ts = batch.step_batch(cfg, s, action[t])
        assert torch.equal(ts.reward, reward[t])
        assert torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                           delivered[t])
    for f in STATE_FIELDS[:-2]:
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    assert not bool(mask.all())
    with torch.no_grad():
        logits, v = m(obs)
    lp_plain = torch.log_softmax(torch.where(mask, logits, -1e9), -1).gather(
        -1, action.long()[..., None])[..., 0]
    assert float((v - value).abs().max()) < 1e-4
    assert float((lp_plain - lp).abs().max()) < 1e-4


# ---- K3 / K4: the SGD phase and per-minibatch gradients ---------------------

SGD_T, SGD_B, SGD_M, SGD_E = 5, 100, 4, 2  # N = 500 per minibatch: ragged
SGD_KW = dict(clip_eps=0.2, value_coef=0.5)


def sgd_batch(cfg, hidden, dev, seed=0, arch="mlp", groups=None):
    """A seeded synthetic trajectory, params and Adam state on ``dev``;
    with ``groups`` the params of a ``MultiPolicyActorCritic``."""
    from warehouse_tpu_torch.models import make_multi_policy_model
    from warehouse_tpu_torch.kernels.sgd import normalize_adv_env_minibatch
    from warehouse_tpu_torch.optim import AdamState
    from warehouse_tpu_torch.train.ppo import Transition

    g = torch.Generator().manual_seed(seed)
    T, B, A, D = SGD_T, SGD_B, cfg.num_agents, cfg.obs_dim
    action = torch.randint(0, 5, (T, B, A), generator=g, dtype=torch.int32)
    mask = torch.rand(T, B, A, 5, generator=g) > 0.3
    mask[..., 0] = True
    mask.scatter_(-1, action.long()[..., None], True)
    traj = Transition(
        obs=torch.randn(T, B, A, D, generator=g), action=action,
        log_prob=-1.6 + 0.1 * torch.randn(T, B, A, generator=g),
        value=torch.randn(T, B, A, generator=g),
        reward=torch.zeros(T, B, A), done=torch.zeros(T, B, A, dtype=bool),
        mask=mask, boot_value=torch.zeros(T, B, A))
    adv_n = normalize_adv_env_minibatch(torch.randn(T, B, A, generator=g),
                                        SGD_M)
    targets = torch.randn(T, B, A, generator=g)
    model = (make_model(cfg, arch, hidden_dim=hidden, generator=g,
                        device="cpu") if groups is None else
             make_multi_policy_model(cfg, groups, arch, hidden_dim=hidden,
                                     generator=g, device="cpu"))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    opt = AdamState(3, {k: 1e-3 * torch.randn(v.shape, generator=g)
                        for k, v in params.items()},
                    {k: 1e-6 * torch.rand(v.shape, generator=g)
                     for k, v in params.items()})
    to = (lambda x: x.to(dev))
    traj = Transition(*(to(x) for x in traj))
    opt = AdamState(opt.count, *({k: to(v) for k, v in d.items()}
                                 for d in (opt.mu, opt.nu)))
    return ({k: to(v) for k, v in params.items()}, opt, traj, to(adv_n),
            to(targets))


def assert_close_tree(a, b, rtol, atol, what):
    for k in b:
        torch.testing.assert_close(a[k], b[k], rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what} {k}: {m}")


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("hidden", [16, 128])
def test_sgd_phase_kernel_matches_twin(hidden, mask_on, dev):
    """K3 against autograd + optim.py on the same inputs (E = 2, M = 4,
    500 samples per minibatch), and bit-equal to itself on a rerun."""
    from warehouse_tpu_torch.kernels.sgd import (ppo_sgd_phase,
                                                 ppo_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer
    from warehouse_tpu_torch import TrainConfig

    cfg = medium_config()
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=mask_on, **SGD_KW)
    p_k, o_k, l_k = ppo_sgd_phase(*args, **kw)
    p_r, o_r, l_r = ppo_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    assert o_k.count == o_r.count == opt.count + SGD_E * SGD_M
    # f32 sums in another order (split-K over samples vs cuBLAS), 8 steps.
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, o_2, l_2 = ppo_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))


@pytest.mark.parametrize("mask_on", [False, True])
def test_minibatch_grads_kernel_matches_autograd(mask_on, dev):
    from warehouse_tpu_torch.kernels.sgd import (
        ppo_minibatch_grads, ppo_minibatch_grads_reference)

    cfg = medium_config()
    params, _, traj, adv_n, targets = sgd_batch(cfg, 128, dev, seed=3)
    kw = dict(num_minibatches=SGD_M, mask_actions=mask_on, **SGD_KW)
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = ppo_minibatch_grads(params, traj, adv_n,
                                                targets, mb, 0.01, 0.05, **kw)
        (l_r, aux_r), g_r = ppo_minibatch_grads_reference(
            params, traj, adv_n, targets, mb, 0.01, 0.05, **kw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-7, f"grads mb={mb}")


# ---- K5 / K6: the IMPALA learner phase and per-minibatch gradients ----------

VT_T, VT_B, VT_M, VT_P = 5, 100, 4, 2  # N = 500 per minibatch: ragged
VT_KW = dict(gamma=0.99, rho_clip=1.0, c_clip=0.9, value_coef=0.5)


def vtrace_batch(cfg, hidden, dev, seed=0):
    """A seeded synthetic IMPALA trajectory, last obs and params on
    ``dev``; done on random steps, so the traces cross boundaries."""
    from warehouse_tpu_torch.train.impala import ImpalaTransition

    g = torch.Generator().manual_seed(seed)
    T, B, A, D = VT_T, VT_B, cfg.num_agents, cfg.obs_dim
    action = torch.randint(0, 5, (T, B, A), generator=g, dtype=torch.int32)
    mask = torch.rand(T, B, A, 5, generator=g) > 0.3
    mask[..., 0] = True
    mask.scatter_(-1, action.long()[..., None], True)
    traj = ImpalaTransition(
        obs=torch.randn(T, B, A, D, generator=g), action=action,
        behavior_log_prob=-1.6 + 0.1 * torch.randn(T, B, A, generator=g),
        reward=torch.randn(T, B, A, generator=g),
        done=torch.rand(T, B, A, generator=g) < 0.2, mask=mask,
        boot_value=torch.randn(T, B, A, generator=g))
    last_obs = torch.randn(B, A, D, generator=g)
    model = make_model(cfg, hidden_dim=hidden, generator=g)
    params = {k: v.detach().to(dev) for k, v in model.state_dict().items()}
    return (params, ImpalaTransition(*(x.to(dev) for x in traj)),
            last_obs.to(dev), g)


@pytest.mark.parametrize("use_rms", [True, False])
@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("hidden", [16, 128])
def test_impala_phase_kernel_matches_twin(hidden, mask_on, use_rms, dev):
    """K5 against autograd + optim.py on the same inputs (2 passes x M = 4,
    500 samples per minibatch, truncation bootstrap on), and bit-equal to
    itself on a rerun."""
    from warehouse_tpu_torch.kernels.vtrace_sgd import (
        impala_sgd_phase, impala_sgd_phase_reference)
    from warehouse_tpu_torch.optim import (AdamState, ClipAdam, ClipRMSProp,
                                           RMSState, linear_schedule)

    cfg = medium_config()
    params, traj, last_obs, g = vtrace_batch(cfg, hidden, dev)
    nu = {k: (1e-6 * torch.rand(v.shape, generator=g)).to(dev)
          for k, v in params.items()}
    if use_rms:
        opt, optimizer = RMSState(3, nu), ClipRMSProp
    else:
        mu = {k: (1e-3 * torch.randn(v.shape, generator=g)).to(dev)
              for k, v in params.items()}
        opt, optimizer = AdamState(3, mu, nu), ClipAdam
    rows = optimizer(linear_schedule(3e-4, 0.0, 100), 0.5).step_rows(
        opt.count, VT_P * VT_M, dev)
    args = (params, opt, traj, last_obs, rows, 0.01)
    kw = dict(num_passes=VT_P, num_minibatches=VT_M, max_grad_norm=0.5,
              mask_actions=mask_on, bootstrap_truncated=True, **VT_KW)
    p_k, o_k, l_k = impala_sgd_phase(*args, **kw)
    p_r, o_r, l_r = impala_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    assert type(o_k) is type(o_r) and o_k.count == o_r.count == 3 + 8
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    if not use_rms:
        assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    p_2, o_2, l_2 = impala_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))


@pytest.mark.parametrize("bootstrap", [False, True])
@pytest.mark.parametrize("mask_on", [False, True])
def test_impala_grads_kernel_matches_autograd(mask_on, bootstrap, dev):
    from warehouse_tpu_torch.kernels.vtrace_sgd import (
        impala_minibatch_grads, impala_minibatch_grads_reference)

    cfg = medium_config()
    params, traj, last_obs, _ = vtrace_batch(cfg, 128, dev, seed=3)
    kw = dict(num_minibatches=VT_M, mask_actions=mask_on,
              bootstrap_truncated=bootstrap, **VT_KW)
    for mb in range(VT_M):
        (l_k, aux_k), g_k = impala_minibatch_grads(params, traj, last_obs,
                                                   mb, 0.01, **kw)
        (l_r, aux_r), g_r = impala_minibatch_grads_reference(
            params, traj, last_obs, mb, 0.01, **kw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-6, f"grads mb={mb}")


VT_STAGE_CASES = [  # (preset, global view, hidden, layers, mask, bootstrap)
    ("medium", False, 128, 2, True, True), ("medium", False, 16, 3, False,
                                            False),
    ("shelves", True, 128, 2, True, True), ("medium", False, 256, 1, True,
                                            False)]


@pytest.mark.parametrize("name,glob,hidden,layers,mask_on,bootstrap",
                         VT_STAGE_CASES)
def test_vtrace_stage_kernels_match_plain_stages(name, glob, hidden, layers,
                                                 mask_on, bootstrap, dev):
    """Each of K6's five stage kernels (``vtrace_sgd.vtrace_stage``: the
    forward over the samples and the last-obs rows, the head, the V-trace,
    the dgrads, the weight gradients) against its plain stage on the plain
    chain's rows of minibatch 0: 500 samples and 100 last-obs rows (no
    64-row tile and no 256-trace CTA full at the end), hidden 128 x 2
    masked with the truncation bootstrap, 16 x 3 without either, the
    shelves global view's D = 611 and 256 x 1; every output at
    chip_smoke.py's STAGE_TOL elementwise, the loss terms within 1e-6; one
    launch each. The observations are the env's own, of 600 reset envs, as
    in the K4 stage test (a 611-term float32 sum of normal features differs
    between summation orders by more than STAGE_TOL near 0)."""
    from warehouse_tpu_torch.train.impala import ImpalaTransition

    cs = smoke()
    cfg = (GLOBAL if glob else PRESETS)[name]
    _, traj, _, _ = vtrace_batch(cfg, hidden, dev, seed=9)
    _, obs = reset(cfg, 9, dev)
    n = VT_T * VT_B
    traj = ImpalaTransition(obs[:n].reshape(traj.obs.shape).float(),
                            *traj[1:])
    last_obs = obs[n:n + VT_B].float()
    m = make_model(cfg, hidden_dim=hidden, num_layers=layers,
                   generator=torch.Generator().manual_seed(8), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    kw = dict(mask_actions=mask_on, bootstrap_truncated=bootstrap, **VT_KW)
    res, bad, _ = cs.vtrace_stage_run(dev, params, traj, last_obs, 0.01,
                                      VT_M, kw, time_it=False)
    assert not bad, res


def test_vtrace_stage_kernels_match_plain_stages_config4(dev):
    """K6's stage kernels at config 4: chip_smoke.py's IMPALA trajectory (a
    K2 chunk from the trainer's reset, N = 65536 samples and 4096 last-obs
    rows a minibatch, every tile and trace CTA full), as its
    ``vtrace_stage_check`` holds them."""
    cs = smoke()
    tcfg, params, traj, last_obs, kw = cs.impala_inputs(dev, medium_config())
    res, bad, _ = cs.vtrace_stage_run(dev, params, traj, last_obs,
                                      tcfg.entropy_coef,
                                      tcfg.num_minibatches, kw,
                                      time_it=False)
    assert not bad, res


def test_impala_grads_counts_its_stage_kernels(dev):
    """One K6 gradient at 3 hidden layers adds one launch and, to
    ``stage_launches``, the kernels that a profiler trace of it shows; each
    stage's counter moves by the kernels that a trace of that stage run
    alone shows, as the C entry point counted them; the prep's kernel makes
    up the rest."""
    from torch.profiler import ProfilerActivity, profile

    from warehouse_tpu_torch.kernels import vtrace_sgd as vs
    from warehouse_tpu_torch.kernels.sgd import pack

    cfg = medium_config()
    _, traj, last_obs, _ = vtrace_batch(cfg, 16, dev)
    m = make_model(cfg, hidden_dim=16, num_layers=3,
                   generator=torch.Generator().manual_seed(8), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    kw = dict(mask_actions=True, bootstrap_truncated=True, **VT_KW)
    run = vs._Launch(params, traj, last_obs, 0.01, VT_M, **kw)
    p_flat = pack(params)
    grads = torch.empty_like(p_flat)
    sums = torch.empty(4, dtype=torch.float32, device=dev)

    def kernels(fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return sum(e.device_type.name == "CUDA" for e in prof.events())

    names = ["launches", "stage_launches"] + [f"{st}_launches"
                                             for st in vs.VT_STAGES]
    before = {k: getattr(vs.impala_minibatch_grads, k) for k in names}
    whole = kernels(lambda: run.grads(p_flat, 1, grads, sums))
    moved = {k: getattr(vs.impala_minibatch_grads, k) - before[k]
             for k in names}
    assert moved["launches"] == 1 and moved["stage_launches"] == whole
    alone = []
    for i, st in enumerate(vs.VT_STAGES + ("prep",)):
        got = []
        n = kernels(lambda: got.append(run._launch(i, p_flat, 1, grads, sums,
                                                   st)))
        assert got[0] == [n if j == i else 0 for j in range(len(got[0]))], st
        if st != "prep":
            assert moved[f"{st}_launches"] == n, st
        alone.append(n)
    assert sum(alone) == whole and alone[0] == 3 and alone[-1] == 1


# ---- K7: the recurrent acting kernel ----------------------------------------

def rnn_carry(arch, hidden, A, dev, seed, n=N):
    g = torch.Generator().manual_seed(seed)
    h = (0.5 * torch.randn(n, A, hidden, generator=g)).to(dev)
    if arch == "lstm":
        return ((0.5 * torch.randn(n, A, hidden, generator=g)).to(dev), h)
    return h


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("arch", ["gru", "lstm"])
@pytest.mark.parametrize("name,hidden", [("small", 16), ("medium", 128),
                                         ("shelves", 32), ("large", 16)])
def test_rnn_act_kernel_matches_plain_path(name, hidden, arch, mask_on, dev):
    """K7: its actions replayed through the plain engine give bit-equal
    obs, rewards, deliveries and final state (and, masked, the mask of
    ``valid_action_mask`` with no masked move sampled); values, log-probs
    and the final carry within 1e-4 of ``apply_rnn`` stepped over the
    kernel's observations from the same carry (f32 sums in another
    order). N = 1000 envs: the last block is ragged."""
    from warehouse_tpu_torch.kernels.act_rnn import act_rnn_steps
    from warehouse_tpu_torch.models.policy import apply_rnn

    cfg, steps, A = PRESETS[name], 8, PRESETS[name].num_agents
    m = make_model(cfg, arch, hidden_dim=hidden,
                   generator=torch.Generator().manual_seed(0), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    state, _ = reset(cfg, 6, dev)
    carry = rnn_carry(arch, hidden, A, dev, 7)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(3, dev), steps, (5, N * A))
    mask = (torch.zeros(steps, N, A, 5, dtype=torch.bool, device=dev)
            if mask_on else None)
    new, new_carry, obs, action, lp, value, reward, delivered = act_rnn_steps(
        cfg, params, state, carry, u, pick, drop, g, mask=mask)
    torch.cuda.synchronize()
    s, c = state, carry
    for t in range(steps):
        if mask_on:
            assert torch.equal(mask[t], valid_action_mask(cfg, s.agent_pos))
            assert bool(mask[t].gather(-1, action[t].long()[..., None]).all())
        assert torch.equal(batch.observe_batch(cfg, s), obs[t])
        with torch.no_grad():
            logits, v, c = apply_rnn(params, obs[t], c)
        if mask_on:
            logits = torch.where(mask[t], logits, -1e9)
        lp_plain = torch.log_softmax(logits, -1).gather(
            -1, action[t].long()[..., None])[..., 0]
        assert float((v - value[t]).abs().max()) < 1e-4, t
        assert float((lp_plain - lp[t]).abs().max()) < 1e-4, t
        s, ts = batch.step_batch(cfg, s, action[t])
        assert torch.equal(ts.reward, reward[t])
        assert torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                           delivered[t])
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    pairs = zip(new_carry, c) if arch == "lstm" else [(new_carry, c)]
    for a, b in pairs:
        assert float((a - b).abs().max()) < 1e-4


ACT_RNN_STAGE_CASES = [  # (preset, cell, hidden, num_layers, B, masked)
    ("medium", "gru", 128, 2, N, False),
    ("medium", "lstm", 128, 2, N, False),
    ("shelves", "gru", 32, 2, N + 1, True),
    ("small", "lstm", 16, 3, N - 1, False),
    ("large", "gru", 16, 4, N, True)]


@pytest.mark.parametrize("stage", ["encoder", "cell", "head", "env"])
@pytest.mark.parametrize("name,arch,hidden,layers,B,masked",
                         ACT_RNN_STAGE_CASES)
def test_act_rnn_stage_kernels_match_plain_stages(name, arch, hidden, layers,
                                                  B, masked, stage, dev):
    """Each of K7's stage kernels (``act_rnn.act_rnn_stage``: every encoder
    layer, the cell over ``[e | h]``, the head, the env stage) against its
    plain stage on one step's rows from a reset and a random carry (B of
    999-1001 envs: no tile full at the end; 1 to 3 encoder layers, hidden
    16 to 128, so a cell tile of 32 units half padding at 16), masked on
    shelves and the 8-agent preset: the encoder's, cell's and head's rows
    at chip_smoke.py's STAGE_TOL elementwise, the env stage's log-probs
    within TOL and every other output bit-equal; one launch each."""
    cs = smoke()
    res, bad, _ = cs.act_rnn_stage_run(dev, PRESETS[name], arch, hidden, B,
                                       masked, time_it=False,
                                       num_layers=layers)
    assert not [b for b in bad if b.startswith(stage)], (bad, res)


def device_kernels(fn) -> int:
    """The kernels of the port's sources that a profiler trace of ``fn``
    shows on the card. A torch kernel runs first in the trace and is not
    counted: after earlier traces in the process, a trace of the whole
    file's run showed one device event fewer than a C entry point
    launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1.0)
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type.name == "CUDA" and not e.name.startswith(
        ("void at::", "Memcpy", "Memset")) for e in prof.events())


@pytest.mark.parametrize("arch", ["gru", "lstm"])
def test_rnn_act_kernel_counts_its_stage_kernels(arch, dev):
    """One K7 chunk of 4 steps at 2 encoder layers adds one launch and, to
    ``stage_launches``, the kernels that a profiler trace of the C entry
    point's call shows (the wrapper's own torch copies outside it): 2
    encoder, a cell, a head and an env stage (the tick, then the next
    observation rows but on the last step) a step, the prep and the first
    observation's pair; each stage run alone counts the kernels its own
    trace shows. A second launch on the same inputs gives the same
    bits."""
    from warehouse_tpu_torch.kernels import act_rnn as ar

    cfg, steps, A = PRESETS["medium"], 4, PRESETS["medium"].num_agents
    m = make_model(cfg, arch, hidden_dim=16, num_layers=3,
                   generator=torch.Generator().manual_seed(0), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    state, _ = reset(cfg, 6, dev)
    carry = rnn_carry(arch, 16, A, dev, 7)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(3, dev), steps, (5, N * A))
    names = ["launches", "stage_launches"] + [
        f"{st}_launches" for st in ar.ACT_RNN_STAGES]
    before = {k: getattr(ar.act_rnn_steps, k) for k in names}
    first = ar.act_rnn_steps(cfg, params, state, carry, u, pick, drop, g)
    moved = {k: getattr(ar.act_rnn_steps, k) - before[k] for k in names}
    run = ar.ActRnnLaunch(cfg, params, state, carry, u, pick, drop, g)
    got = []
    whole = device_kernels(lambda: got.append(run.launch()))
    assert got[0] == [2 * steps, steps, steps, 2 * steps + 1, 1], got
    assert moved == {"launches": 1, "stage_launches": whole,
                     "encoder_launches": 2 * steps, "cell_launches": steps,
                     "head_launches": steps,
                     "env_launches": 2 * steps + 1}, moved
    assert whole == 6 * steps + 2
    again = run.results(state)
    torch.cuda.synchronize()
    flat = [[getattr(r[0], f) for f in STATE_FIELDS]
            + list(r[1] if arch == "lstm" else (r[1],)) + list(r[2:])
            for r in (first, again)]
    for x, y in zip(*flat):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                           else x, y.view(torch.int32)
                           if y.is_floating_point() else y)
    run = ar.stage_launch(cfg, params, state, u[:1], pick[:1], drop[:1],
                          g[:1])
    obs_next = torch.empty_like(run.io.obs[0])
    for i, st in enumerate(ar.ACT_RNN_STAGES + ("prep",)):
        got = []
        n = device_kernels(lambda: got.append(run.launch(
            st, obs_next if st == "env" else None)))
        assert got[0] == [n if j == i else 0 for j in range(5)], st
        assert n == (2 if st == "env" else 1), st


# ---- K8 / K9: the recurrent SGD phase and per-minibatch gradients -----------

@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("arch", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 128])
def test_rnn_sgd_phase_kernel_matches_twin(hidden, arch, mask_on, dev):
    """K8 against autograd through the T-step replay + optim.py on the
    same inputs (E = 2, M = 4, 100 sequences of 5 steps per minibatch: a
    ragged tile), at K3's tolerances, and bit-equal to itself on a
    rerun."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd_rnn import (
        ppo_rnn_sgd_phase, ppo_rnn_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = medium_config()
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch=arch)
    h0 = rnn_carry(arch, hidden, cfg.num_agents, dev, 11, SGD_B)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, h0, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=mask_on, **SGD_KW)
    p_k, o_k, l_k = ppo_rnn_sgd_phase(*args, **kw)
    p_r, o_r, l_r = ppo_rnn_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    assert o_k.count == o_r.count == opt.count + SGD_E * SGD_M
    # f32 sums in another order (split-K over samples vs cuBLAS), 8 steps.
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, o_2, l_2 = ppo_rnn_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("arch", ["gru", "lstm"])
@pytest.mark.parametrize("layers", [2, 3])
def test_rnn_minibatch_grads_kernel_matches_autograd(layers, arch, mask_on,
                                                     dev):
    """K9 against autograd through the T-step replay, every minibatch, 1
    and 2 encoder layers, hidden 32 (f32 sums in another order: grads rtol
    1e-4 / atol 1e-6, losses atol 2e-6)."""
    from warehouse_tpu_torch.kernels.sgd_rnn import (
        ppo_rnn_minibatch_grads, ppo_rnn_minibatch_grads_reference)

    cfg, hidden = medium_config(), 32
    _, _, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch=arch)
    m = make_model(cfg, arch, hidden_dim=hidden, num_layers=layers,
                   generator=torch.Generator().manual_seed(5), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    h0 = rnn_carry(arch, hidden, cfg.num_agents, dev, 12, SGD_B)
    kw = dict(num_minibatches=SGD_M, mask_actions=mask_on, **SGD_KW)
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = ppo_rnn_minibatch_grads(
            params, traj, adv_n, targets, h0, mb, 0.01, 0.05, **kw)
        (l_r, aux_r), g_r = ppo_rnn_minibatch_grads_reference(
            params, traj, adv_n, targets, h0, mb, 0.01, 0.05, **kw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-6, f"grads mb={mb}")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("arch,hidden,layers,full", [
    ("gru", 32, 3, False), ("gru", 32, 3, True), ("lstm", 32, 3, False),
    ("lstm", 32, 3, True), ("lstm", 192, 2, False)])
def test_rnn_stage_kernels_match_plain_stages(arch, hidden, layers, full,
                                              bf16, dev):
    """Each of K9's six stage kernels (``sgd_rnn.rnn_stage``) against its
    plain stage on the plain chain's rows of minibatch 0, masked: hidden 32
    with 2 encoder layers (the recurrences' weights staged in shared
    memory), on 100 sequences of 5 steps (no recurrent tile of 32
    sequences and no 64-row tile full at the end) or, ``full``, the first
    64 envs' 64 sequences (every tile full); the LSTM at hidden 192, whose
    weights do not fit beside the recurrent tiles (read through L1);
    float32 outputs at chip_smoke.py's STAGE_TOL elementwise, bf16
    operands at GRAD_REL in norm, the loss terms within 1e-6; one launch
    each."""
    from warehouse_tpu_torch.kernels import sgd_rnn
    from warehouse_tpu_torch.train.ppo import Transition

    cs = smoke()
    cfg = medium_config()
    _, _, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, seed=7,
                                           arch=arch)
    m = make_model(cfg, arch, hidden_dim=hidden, num_layers=layers,
                   generator=torch.Generator().manual_seed(8), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    h0 = rnn_carry(arch, hidden, cfg.num_agents, dev, 13, SGD_B)
    if full:
        traj = Transition(*(x[:, :64] for x in traj))
        adv_n, targets = adv_n[:, :64], targets[:, :64]
        h0 = tuple(x[:64] for x in h0) if arch == "lstm" else h0[:64]
    loss_kw = dict(mask_actions=True, **SGD_KW)
    rows, carry = sgd_rnn.minibatch_rows(traj, adv_n, targets, h0, 0, SGD_M)
    chain, want = sgd_rnn.plain_stage_chain(params, rows, carry, 0.01, 0.05,
                                            bf16=bf16, **loss_kw)
    for stage in sgd_rnn.STAGES:
        before = sgd_rnn.rnn_stage.launches
        got = sgd_rnn.rnn_stage(
            stage, params, traj, adv_n, targets, h0, 0, 0.01, 0.05,
            sgd_rnn.stage_inputs(stage, params, chain),
            num_minibatches=SGD_M,
            matmul_dtype="bfloat16" if bf16 else "float32", **loss_kw)
        torch.cuda.synchronize()
        assert sgd_rnn.rnn_stage.launches == before + 1
        res = cs.stage_ratios(got, want[stage], bf16, GRAD_REL)
        assert all(v["ratio"] <= 1.0 for v in res.values()), (stage, res)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,glob,hidden,layers,groups", [
    ("medium", False, 16, 2, None), ("medium", False, 128, 3, None),
    ("shelves", True, 128, 2, None), ("shelves", False, 16, 1,
                                      (0, 0, 0, 1, 1, 1)),
    ("medium", False, 256, 2, (0, 1, 0, 1))])
def test_mlp_stage_kernels_match_plain_stages(name, glob, hidden, layers,
                                              groups, bf16, dev):
    """Each of K4's four stage kernels (``sgd.mlp_stage``) against its
    plain stage on the plain chain's rows of minibatch 0, masked, on 500
    samples (no 64-row tile full at the end): hidden 16 and 128 with 2 and
    3 layers, the global view's D = 611, one layer with two groups on
    shelves, and hidden 256 with the groups ``(0, 1, 0, 1)``; float32
    outputs at chip_smoke.py's STAGE_TOL elementwise, bf16 operands at
    GRAD_REL in norm, the loss terms within 1e-6; one launch each. The
    observations are the env's own, of 500 reset envs (as chip_smoke.py's
    trajectories): on ``sgd_batch``'s normal features a 611-term float32
    sum differs by up to 2.6e-6 between two summation orders, 1.6 times
    STAGE_TOL on an activation near 0 (an H100 80GB HBM3, 700 W)."""
    from warehouse_tpu_torch.kernels import sgd
    from warehouse_tpu_torch.models import make_multi_policy_model
    from warehouse_tpu_torch.train.ppo import Transition

    cs = smoke()
    cfg = (GLOBAL if glob else PRESETS)[name]
    _, _, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, seed=7)
    _, obs = reset(cfg, 7, dev)
    obs = obs[:SGD_T * SGD_B]
    traj = Transition(obs.reshape(traj.obs.shape).float(), *traj[1:])
    gen = torch.Generator().manual_seed(8)
    m = (make_model(cfg, hidden_dim=hidden, num_layers=layers, generator=gen,
                    device=dev) if groups is None else
         make_multi_policy_model(cfg, groups, hidden_dim=hidden,
                                 num_layers=layers, generator=gen,
                                 device=dev))
    params = {k: v.detach() for k, v in m.state_dict().items()}
    loss_kw = dict(mask_actions=True, **SGD_KW)
    rows, counts = sgd.minibatch_rows(traj, adv_n, targets, 0, SGD_M, groups)
    chain, want = sgd.plain_stage_chain(params, rows, counts, 0.01, 0.05,
                                        bf16=bf16, **loss_kw)
    for stage in sgd.STAGES:
        before = sgd.mlp_stage.launches
        got = sgd.mlp_stage(
            stage, params, traj, adv_n, targets, 0, 0.01, 0.05,
            sgd.stage_inputs(stage, params, chain), num_minibatches=SGD_M,
            policy_groups=groups,
            matmul_dtype="bfloat16" if bf16 else "float32", **loss_kw)
        torch.cuda.synchronize()
        assert sgd.mlp_stage.launches == before + 1
        res = cs.stage_ratios(got, want[stage], bf16, GRAD_REL)
        assert all(v["ratio"] <= 1.0 for v in res.values()), (stage, res)


# ---- K10: the CNN acting kernel ----------------------------------------------

@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("name,hidden", [("small", 16), ("medium", 128),
                                         ("shelves", 32), ("large", 16)])
def test_cnn_act_kernel_matches_plain_path(name, hidden, mask_on, dev):
    """K10: its actions replayed through the plain engine give bit-equal
    obs, rewards, deliveries and final state (and, masked, the mask of
    ``valid_action_mask`` with no masked move sampled); logits, values and
    log-probs within 1e-4 of the plain ``ActorCriticCNN`` on the kernel's
    observations (f32 sums in another order). N = 1000 envs: the last
    block is ragged."""
    from warehouse_tpu_torch.kernels.act import act_cnn_steps

    cfg, steps, A = PRESETS[name], 8, PRESETS[name].num_agents
    m = make_model(cfg, "cnn", hidden_dim=hidden,
                   generator=torch.Generator().manual_seed(0), device=dev)
    state, _ = reset(cfg, 8, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(4, dev), steps, (5, N * A))
    logits_k = torch.empty(steps, N, A, 5, device=dev)
    mask = (torch.zeros(steps, N, A, 5, dtype=torch.bool, device=dev)
            if mask_on else None)
    before = act_cnn_steps.launches
    new, obs, action, lp, value, reward, delivered = act_cnn_steps(
        cfg, m, state, u, pick, drop, g, logits=logits_k, mask=mask)
    torch.cuda.synchronize()
    assert act_cnn_steps.launches == before + 1
    s = state
    for t in range(steps):
        if mask_on:
            assert torch.equal(mask[t], valid_action_mask(cfg, s.agent_pos))
            assert bool(mask[t].gather(-1, action[t].long()[..., None]).all())
        assert torch.equal(batch.observe_batch(cfg, s), obs[t])
        s, ts = batch.step_batch(cfg, s, action[t])
        assert torch.equal(ts.reward, reward[t])
        assert torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                           delivered[t])
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    with torch.no_grad():
        logits, v = m(obs)
    assert float((logits - logits_k).abs().max()) < 1e-4
    if mask_on:
        logits = torch.where(mask, logits, -1e9)
    lp_plain = torch.log_softmax(logits, -1).gather(
        -1, action.long()[..., None])[..., 0]
    assert float((v - value).abs().max()) < 1e-4
    assert float((lp_plain - lp).abs().max()) < 1e-4


@pytest.fixture
def torch_default_dev():
    """The card under torch's default flags (cuDNN on, TF32 convolutions
    allowed, no autotuning, nondeterministic algorithms allowed), whatever
    ``dev`` set before; the flags are restored after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
             cudnn.allow_tf32)
    cudnn.enabled, cudnn.benchmark, cudnn.deterministic = True, False, False
    cudnn.allow_tf32 = True
    yield torch.device("cuda")
    cudnn.enabled, cudnn.benchmark, cudnn.deterministic = saved[:3]
    cudnn.allow_tf32 = saved[3]


@pytest.mark.parametrize("name", ["medium", "medium_global"])
def test_plain_cnn_value_is_f32_under_torch_defaults(name, torch_default_dev,
                                                     monkeypatch):
    """The plain CNN (``apply`` in float32, the trainers' last value and
    bootstrap, the plain learner, serving) on the card under torch's
    default flags: every convolution runs through cuDNN in IEEE float32,
    its value within 1e-5 of the CPU twin's and of K10's on the same
    observations (TF32 convolutions put it about 2e-4 off), and the
    global flags are torch's defaults again after it."""
    from warehouse_tpu_torch.kernels.act import act_cnn_steps
    from warehouse_tpu_torch.models.policy import apply

    dev = torch_default_dev
    cfg = {"medium": medium_config(), "medium_global": GLOBAL["medium"]}[name]
    A = cfg.num_agents
    m = make_model(cfg, "cnn", generator=torch.Generator().manual_seed(0),
                   device=dev)
    params = dict(m.named_parameters())
    state, obs = reset(cfg, 3, dev)
    seen, conv2d = [], torch.nn.functional.conv2d

    def spy(x, *args, **kw):
        seen.append((torch.backends.cudnn.is_acceptable(x),
                     torch.backends.cudnn.conv.fp32_precision))
        return conv2d(x, *args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    with torch.no_grad():
        value = apply(params, obs)[1]
    monkeypatch.undo()
    assert seen and all(x == (True, "ieee") for x in seen), seen
    cudnn = torch.backends.cudnn
    assert (cudnn.enabled, cudnn.deterministic, cudnn.allow_tf32) == (
        True, False, True)
    with torch.no_grad():
        twin = apply({k: v.cpu() for k, v in params.items()}, obs.cpu())[1]
    assert float((value.cpu() - twin).abs().max()) <= 1e-5
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, 1)
    _, g = rng.batched_gumbel_stream(rng.prng_key(4, dev), 1, (5, N * A))
    out = act_cnn_steps(cfg, m, state, u, pick, drop, g)
    assert torch.equal(out[1][0], obs)
    assert float((out[4][0] - value).abs().max()) <= 1e-5


# ---- K11 / K12: the CNN SGD phase and per-minibatch gradients ----------------

@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("name,hidden", [("medium", 16), ("medium", 128),
                                         ("small", 32), ("shelves", 32)])
def test_cnn_sgd_phase_kernel_matches_twin(name, hidden, mask_on, dev):
    """K11 against autograd through the true convolutions + optim.py on
    the same inputs (E = 2, M = 4, 5 x 25 x A samples per minibatch: a
    ragged tile), at K3's tolerances, and bit-equal to itself on a
    rerun."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd_cnn import (
        ppo_cnn_sgd_phase, ppo_cnn_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = PRESETS[name]
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch="cnn")
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=mask_on, **SGD_KW)
    p_k, o_k, l_k = ppo_cnn_sgd_phase(*args, **kw)
    p_r, o_r, l_r = ppo_cnn_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    assert o_k.count == o_r.count == opt.count + SGD_E * SGD_M
    # f32 sums in another order (per-CTA and split-K partials vs cuDNN and
    # cuBLAS), 8 steps.
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, o_2, l_2 = ppo_cnn_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))


@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("hidden", [16, 32, 128])
def test_cnn_minibatch_grads_kernel_matches_autograd(hidden, mask_on, dev):
    """K12 against autograd through the true convolutions, every
    minibatch (grads rtol 1e-4 / atol 1e-6, losses atol 1e-6: the JAX
    suite's bounds for the TPU kernel)."""
    from warehouse_tpu_torch.kernels.sgd_cnn import (
        ppo_cnn_minibatch_grads, ppo_cnn_minibatch_grads_reference)

    cfg = medium_config()
    params, _, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, seed=3,
                                                arch="cnn")
    kw = dict(num_minibatches=SGD_M, mask_actions=mask_on, **SGD_KW)
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = ppo_cnn_minibatch_grads(
            params, traj, adv_n, targets, mb, 0.01, 0.05, **kw)
        (l_r, aux_r), g_r = ppo_cnn_minibatch_grads_reference(
            params, traj, adv_n, targets, mb, 0.01, 0.05, **kw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-6, f"grads mb={mb}")


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("name,glob,hidden", [
    ("medium", False, 128), ("medium", True, 128), ("small", False, 32),
    ("shelves", False, 16)])
def test_cnn_stage_kernels_match_plain_stages(name, glob, hidden, bf16, dev):
    """Each of K12's five stage kernels (``sgd_cnn.cnn_stage``) against
    its plain stage on the plain chain's rows of minibatch 0 (N = 500 or
    750: no tile of any stage full at the end), masked: float32 outputs at
    chip_smoke.py's STAGE_TOL elementwise, bf16 operands at GRAD_REL in
    norm (500 random samples, as the bf16 tests below), the loss terms
    within 1e-6; one launch each."""
    from warehouse_tpu_torch.kernels import sgd_cnn

    cs = smoke()
    cfg = (GLOBAL if glob else PRESETS)[name]
    params, _, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, seed=7,
                                                arch="cnn")
    loss_kw = dict(mask_actions=True, **SGD_KW)
    rows = sgd_cnn.minibatch_rows(traj, adv_n, targets, 0, SGD_M)
    chain, want = sgd_cnn.plain_stage_chain(params, rows, 0.01, 0.05,
                                            bf16=bf16, **loss_kw)
    for stage in sgd_cnn.STAGES:
        before = sgd_cnn.cnn_stage.launches
        got = sgd_cnn.cnn_stage(
            stage, params, traj, adv_n, targets, 0, 0.01, 0.05, chain,
            num_minibatches=SGD_M,
            matmul_dtype="bfloat16" if bf16 else "float32", **loss_kw)
        torch.cuda.synchronize()
        assert sgd_cnn.cnn_stage.launches == before + 1
        res = cs.stage_ratios(got, want[stage], bf16, GRAD_REL)
        assert all(v["ratio"] <= 1.0 for v in res.values()), (stage, res)


ACT_CNN_STAGE_CASES = [  # (preset, global view, hidden, groups, B, shaped)
    ("medium", False, 128, None, N, False),
    ("medium", True, 128, (0, 1, 0, 1), N, False),
    ("shelves", False, 128, (0, 0, 0, 1, 1, 1), N + 1, True),
    ("small", True, 16, (1, 0), N - 1, True),
    ("large", False, 32, tuple(range(8)), N, True)]


@pytest.mark.parametrize("name,glob,hidden,groups,B,shaped",
                         ACT_CNN_STAGE_CASES)
def test_act_cnn_stage_kernels_match_plain_stages(name, glob, hidden, groups,
                                                  B, shaped, dev):
    """Each of K10's three stage kernels (``act.act_cnn_stage``) against
    its plain stage on one step's rows (B of 999-1001 envs: no tile of any
    stage full at the end), with and without groups, masked and shaped from
    a mid-episode state: ``conv``'s and ``trunk``'s rows at chip_smoke.py's
    STAGE_TOL elementwise, the env stage's log-probs within TOL and every
    other output bit-equal; one launch each."""
    from warehouse_tpu_torch.models import make_multi_policy_model

    cs = smoke()
    cfg = (GLOBAL if glob else PRESETS)[name]
    gen = torch.Generator().manual_seed(3)
    m = (make_model(cfg, "cnn", hidden_dim=hidden, generator=gen, device=dev)
         if groups is None else make_multi_policy_model(
             cfg, groups, "cnn", hidden_dim=hidden, generator=gen, device=dev))
    res, bad, _ = cs.act_cnn_stage_run(dev, cfg, m, groups, B, shaped,
                                       time_it=False)
    assert not bad, (bad, res)


ACT_MLP_STAGE_CASES = [  # (preset, global view, hidden, groups, B, shaped)
    ("medium", False, 128, None, N, False),
    ("medium", False, 256, None, N, False),
    ("medium", True, 128, (0, 1, 0, 1), N, False),
    ("shelves", True, 128, None, N + 1, True),
    ("shelves", False, 128, (0, 0, 0, 1, 1, 1), N + 1, True),
    ("small", True, 16, (1, 0), N - 1, True),
    ("large", False, 32, tuple(range(8)), N, True)]


@pytest.mark.parametrize("stage", ["hidden", "head", "env"])
@pytest.mark.parametrize("name,glob,hidden,groups,B,shaped",
                         ACT_MLP_STAGE_CASES)
def test_act_mlp_stage_kernels_match_plain_stages(name, glob, hidden, groups,
                                                  B, shaped, stage, dev):
    """Each of K2's three stage kernels (``act.act_mlp_stage``: the first
    hidden layer, the last with the head, the env stage) against its plain
    stage on one step's rows (B of 999-1001 envs: no tile full at the end),
    with and without groups and the global view, masked and shaped from a
    mid-episode state: ``hidden``'s and ``head``'s rows at chip_smoke.py's
    STAGE_TOL elementwise, the env stage's log-probs within TOL and every
    other output bit-equal; one launch each."""
    from warehouse_tpu_torch.models import make_multi_policy_model

    cs = smoke()
    cfg = (GLOBAL if glob else PRESETS)[name]
    gen = torch.Generator().manual_seed(3)
    m = (make_model(cfg, hidden_dim=hidden, generator=gen, device=dev)
         if groups is None else make_multi_policy_model(
             cfg, groups, hidden_dim=hidden, generator=gen, device=dev))
    res, bad, _ = cs.act_mlp_stage_run(dev, cfg, m, groups, B, shaped,
                                       time_it=False)
    assert not [b for b in bad if b.startswith(stage + ".")], (bad, res)


# ---- the potential-shaping option of K2 and K10 ------------------------------

@pytest.mark.parametrize("truncating", [False, True])
@pytest.mark.parametrize("mask_on", [False, True])
@pytest.mark.parametrize("arch", ["mlp", "cnn"])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_shaped_act_kernel_bit_equal_to_formula(name, arch, mask_on,
                                                truncating, dev):
    """``shaping_coef=0.02`` in K2 (``arch="mlp"``) and K10 (``"cnn"``) from
    a mid-episode state, on a chunk inside the episode or one that ends
    it: the kernel's actions replayed through the plain engine give its
    raw reward, and ``ops.pathing.potential`` of the replayed states gives
    its shaped reward through the formula's float32 operation order, bit
    for bit; the twin on the same draws gives the same bits wherever it
    samples the same actions; without the option the kernel returns the
    raw reward's bits."""
    from warehouse_tpu_torch.kernels.act import (Shaping, act_cnn_steps,
                                                 act_steps_reference)
    from warehouse_tpu_torch.kernels.rollout import f32
    from warehouse_tpu_torch.ops.pathing import potential

    cfg, steps, coef, gamma = PRESETS[name], 8, 0.02, 0.99
    A = cfg.num_agents
    m = make_model(cfg, arch, 32, generator=torch.Generator().manual_seed(0),
                   device=dev)
    run = act_cnn_steps if arch == "cnn" else act_steps
    state, _ = reset(cfg, 6, dev)
    keys, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(3, dev), 2 * steps,
                                     (5, N * A))
    # Mid-episode: agents under way, the env keys moved past the chunk.
    t0 = cfg.max_steps - steps if truncating else steps
    state = run(cfg, m, state, u, pick, drop, g[:steps])[0].replace(
        t=torch.full_like(state.t, t0), key=keys)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    g = g[steps:].contiguous()
    done = ((t0 + 1 + torch.arange(steps, device=dev))[:, None]
            >= cfg.max_steps).expand(steps, N).to(torch.float32).contiguous()
    assert bool(done[-1].all()) == truncating
    mask = (torch.zeros(steps, N, A, 5, dtype=torch.bool, device=dev)
            if mask_on else None)
    shaping = Shaping(coef, gamma, done, torch.zeros(steps, N, A, device=dev))
    before = (run.launches, run.shaped_launches)
    new, obs, action, lp, value, reward, delivered = run(
        cfg, m, state, u, pick, drop, g, mask=mask, shaping=shaping)
    assert (run.launches, run.shaped_launches) == (before[0] + 1,
                                                   before[1] + 1)
    bits = lambda x: x.view(torch.int32)
    s = state
    for t in range(steps):
        phi_pre = potential(cfg, s)
        assert torch.equal(batch.observe_batch(cfg, s), obs[t])
        s, ts = batch.step_batch(cfg, s, action[t])
        assert torch.equal(bits(ts.reward), bits(shaping.raw_reward[t]))
        term = f32(gamma) * potential(cfg, s)
        term = term * (1.0 - done[t])[:, None] - phi_pre
        want = ts.reward + f32(coef) * term
        assert torch.equal(bits(want), bits(reward[t])), t
    for f in STATE_FIELDS[:-2]:
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    assert not torch.equal(reward, shaping.raw_reward)

    raw_p = torch.zeros_like(shaping.raw_reward)
    mask_p = None if mask is None else torch.zeros_like(mask)
    twin = act_steps_reference(cfg, m, state, u, pick, drop, g, mask=mask_p,
                               shaping=shaping._replace(raw_reward=raw_p))
    if torch.equal(twin[2], action):
        assert torch.equal(bits(twin[5]), bits(reward))
        assert torch.equal(bits(raw_p), bits(shaping.raw_reward))
        assert torch.equal(twin[1], obs)

    plain = run(cfg, m, state, u, pick, drop, g, mask=mask)
    assert torch.equal(plain[2], action)
    assert torch.equal(bits(plain[5]), bits(shaping.raw_reward))
    assert run.shaped_launches == before[1] + 1


def test_shaped_rollout_wrapper_launches_the_kernel(dev):
    """``ppo_rollout(shaping_coef > 0)`` on a CUDA state goes through the
    kernel (the counts move) and returns the shaped reward beside the raw
    one; the reference wrapper launches nothing."""
    from warehouse_tpu_torch.kernels.act import (ppo_rollout,
                                                 ppo_rollout_reference)

    cfg = shelves_config()
    m = make_model(cfg, generator=torch.Generator().manual_seed(0),
                   device=dev)
    state, _ = reset(cfg, 7, dev)
    before = (act_steps.launches, act_steps.shaped_launches)
    _, roll, _, _ = ppo_rollout(cfg, m, state, 8, rng.prng_key(5, dev),
                                mask_actions=True, shaping_coef=0.02,
                                gamma=0.99)
    assert (act_steps.launches, act_steps.shaped_launches) == (
        before[0] + 1, before[1] + 1)
    assert not torch.equal(roll.reward, roll.raw_reward)
    _, ref, _, _ = ppo_rollout_reference(
        cfg, m, state, 8, rng.prng_key(5, dev), mask_actions=True,
        shaping_coef=0.02, gamma=0.99)
    assert act_steps.launches == before[0] + 1
    if torch.equal(ref.action, roll.action):
        assert torch.equal(ref.reward.view(torch.int32),
                           roll.reward.view(torch.int32))


# ---- global observations (K2, K10), K2 at wide shapes, wide learners (K3-K6)

GLOBAL = {name: cfg.replace(global_obs=True) for name, cfg in PRESETS.items()}


def k2_stage_launches(layers, steps=8):
    """K2's stage kernels in a chunk of ``steps`` at ``layers`` hidden
    layers: a hidden stage per layer but the last, the head, the tick and
    the next observation a step (no observation after the last tick), the
    prep (with a hidden layer) and the first observation's tick-less
    pair."""
    return (layers > 0) + 1 + steps * (max(layers - 1, 0) + 3)


def replay_check(cfg, m, run, dev, mask_on, shaped, steps=8, groups=None,
                 rerun=False):
    """One chunk of ``run`` (K2 or K10) with the logits, and optionally the
    mask and the shaping option (and policy groups): the plain engine
    replaying its actions gives its obs, raw and shaped rewards, deliveries
    and final state bit for bit; logits, values and log-probs within 1e-4
    of the plain model on the kernel's observations (f32 sums in another
    order). With ``rerun`` a second launch on the same inputs gives the
    same bits."""
    from warehouse_tpu_torch.kernels.act import Shaping
    from warehouse_tpu_torch.kernels.rollout import f32
    from warehouse_tpu_torch.ops.pathing import potential

    A, coef, gamma = cfg.num_agents, 0.02, 0.99
    state, _ = reset(cfg, 9, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, steps)
    _, g = rng.batched_gumbel_stream(rng.prng_key(6, dev), steps, (5, N * A))
    logits_k = torch.empty(steps, N, A, 5, device=dev)
    mask = (torch.zeros(steps, N, A, 5, dtype=torch.bool, device=dev)
            if mask_on else None)
    done = torch.zeros(steps, N, device=dev)
    shaping = (Shaping(coef, gamma, done, torch.zeros(steps, N, A, device=dev))
               if shaped else None)
    before = run.launches
    new, obs, action, lp, value, reward, delivered = run(
        cfg, m, state, u, pick, drop, g, logits=logits_k, mask=mask,
        shaping=shaping, **({} if groups is None else {"groups": groups}))
    torch.cuda.synchronize()
    assert run.launches == before + 1
    bits = lambda x: x.view(torch.int32)
    if rerun:
        again = run(cfg, m, state, u, pick, drop, g,
                    shaping=shaping and shaping._replace(
                        raw_reward=torch.zeros_like(shaping.raw_reward)),
                    mask=None if mask is None else torch.zeros_like(mask),
                    **({} if groups is None else {"groups": groups}))
        for f in STATE_FIELDS:
            assert torch.equal(getattr(new, f), getattr(again[0], f)), f
        for x, y in zip((obs, action, lp, value, reward, delivered),
                        again[1:]):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    s = state
    for t in range(steps):
        if mask_on:
            assert torch.equal(mask[t], valid_action_mask(cfg, s.agent_pos))
            assert bool(mask[t].gather(-1, action[t].long()[..., None]).all())
        assert torch.equal(bits(batch.observe_batch(cfg, s)), bits(obs[t])), t
        phi_pre = potential(cfg, s) if shaped else None
        s, ts = batch.step_batch(cfg, s, action[t])
        want = ts.reward
        if shaped:
            assert torch.equal(bits(ts.reward), bits(shaping.raw_reward[t]))
            term = f32(gamma) * potential(cfg, s)
            term = term * (1.0 - done[t])[:, None] - phi_pre
            want = ts.reward + f32(coef) * term
        assert torch.equal(bits(want), bits(reward[t])), t
        assert torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                           delivered[t])
    for f in STATE_FIELDS[:-2]:  # t and key are the wrapper's
        assert torch.equal(getattr(s, f), getattr(new, f)), f
    with torch.no_grad():
        logits, v = (m(obs) if groups is None
                     else m(obs, torch.tensor(groups, device=dev)))
    assert float((logits - logits_k).abs().max()) < 1e-4
    if mask_on:
        logits = torch.where(mask, logits, -1e9)
    lp_plain = torch.log_softmax(logits, -1).gather(
        -1, action.long()[..., None])[..., 0]
    assert float((v - value).abs().max()) < 1e-4
    assert float((lp_plain - lp).abs().max()) < 1e-4


@pytest.mark.parametrize("mask_on,shaped", [(False, False), (True, False),
                                            (True, True)])
@pytest.mark.parametrize("name,hidden", [("small", 16), ("medium", 128),
                                         ("shelves", 128), ("large", 32)])
def test_global_obs_act_kernel_matches_plain_path(name, hidden, mask_on,
                                                  shaped, dev):
    """K2 with the global view (D = 131 / 411 / 611 / 1131), plain,
    masked, masked and shaped: each chunk K2's stage kernels, which their
    launch count shows."""
    cfg = GLOBAL[name]
    m = make_model(cfg, hidden_dim=hidden,
                   generator=torch.Generator().manual_seed(0), device=dev)
    stages = act_steps.stage_launches
    replay_check(cfg, m, act_steps, dev, mask_on, shaped)
    assert act_steps.stage_launches == stages + k2_stage_launches(2)


@pytest.mark.parametrize("name,hidden,layers", [("medium", 256, 2),
                                                ("shelves", 128, 3)])
def test_wide_route_act_kernel_matches_plain_path(name, hidden, layers, dev):
    """K2 on the ego window at hidden 256 and with a third 128-wide layer
    (two hidden stages a step): the stage kernels, which their launch count
    shows."""
    cfg = PRESETS[name]
    m = make_model(cfg, hidden_dim=hidden, num_layers=layers,
                   generator=torch.Generator().manual_seed(0), device=dev)
    stages = act_steps.stage_launches
    replay_check(cfg, m, act_steps, dev, True, False)
    assert act_steps.stage_launches == stages + k2_stage_launches(layers)


@pytest.mark.parametrize("mask_on,shaped", [(False, False), (True, True)])
@pytest.mark.parametrize("name,hidden", [("small", 16), ("medium", 128)])
def test_global_obs_cnn_act_kernel_matches_plain_path(name, hidden, mask_on,
                                                      shaped, dev):
    """K10 with the global view: the grid is the whole map (S = 5 / 9), 5
    channels padded to 8 in shared memory, fewer envs per block."""
    from warehouse_tpu_torch.kernels.act import act_cnn_steps

    cfg = GLOBAL[name]
    m = make_model(cfg, "cnn", hidden_dim=hidden,
                   generator=torch.Generator().manual_seed(0), device=dev)
    replay_check(cfg, m, act_cnn_steps, dev, mask_on, shaped)


def test_global_obs_cnn_refuses_what_it_cannot_hold(dev):
    """The 11 x 11 map's conv tile of 16 samples (K11's smallest) does not
    fit a block beside the conv kernels: the trainer routes both phases
    plain there (acting per step), as the JAX VMEM gates route them to XLA,
    and one update runs, for PPO and for IMPALA (whose per-step CNN is not
    refused by K10's shared memory); a trunk 50 wide (no multiple of 4)
    trains one update through K10 and K11 / K12 on the medium preset, and an
    (agents, queue) pair outside the presets trains through K2."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.act import act_cnn_steps
    from warehouse_tpu_torch.train import make_train, make_train_impala

    tcfg = TrainConfig(num_envs=64, num_updates=2)
    tr = make_train(GLOBAL["shelves"], tcfg, arch="cnn", device=dev)
    assert tr.backends == {"rollout": "step", "grad": "plain"}
    launches = act_cnn_steps.launches
    rs, m = tr.train_step(tr.init(rng.prng_key(0, dev)))
    assert act_cnn_steps.launches == launches
    assert int(rs.update_idx) == 1 and all(bool(torch.isfinite(v))
                                           for v in m.values())
    itr = make_train_impala(GLOBAL["shelves"], tcfg, arch="cnn", device=dev)
    assert itr.backends == {"rollout": "step", "grad": "plain"}
    rs, m = itr.train_step(itr.init(rng.prng_key(0, dev)))
    assert act_cnn_steps.launches == launches
    assert int(rs.update_idx) == 1 and all(bool(torch.isfinite(v))
                                           for v in m.values())
    from warehouse_tpu_torch.kernels.sgd_cnn import ppo_cnn_sgd_phase
    tr = make_train(medium_config(), tcfg.replace(hidden_dim=50), arch="cnn",
                    device=dev)
    assert tr.backends == {"rollout": "cuda", "grad": "cuda"}
    launches, sgd_launches = act_cnn_steps.launches, ppo_cnn_sgd_phase.launches
    rs, m = tr.train_step(tr.init(rng.prng_key(0, dev)))
    assert act_cnn_steps.launches == launches + 1
    assert ppo_cnn_sgd_phase.launches > sgd_launches
    assert int(rs.update_idx) == 1 and all(bool(torch.isfinite(v))
                                           for v in m.values())
    # An (agents, queue) pair outside the presets builds its env kernels at
    # first use (kernels/build.py pair_library) and trains through K2.
    tr = make_train(medium_config(num_agents=3, queue_capacity=6,
                                  init_requests=3), tcfg, device=dev)
    assert tr.backends == {"rollout": "cuda", "grad": "cuda"}
    launches = act_steps.launches
    rs, m = tr.train_step(tr.init(rng.prng_key(0, dev)))
    assert act_steps.launches == launches + 1
    assert int(rs.update_idx) == 1 and all(bool(torch.isfinite(v))
                                           for v in m.values())
    with pytest.raises(ValueError, match="shared memory"):
        make_train(medium_config(), tcfg.replace(hidden_dim=1024),
                   device=dev)


@pytest.mark.parametrize("name,glob,hidden", [("medium", True, 128),
                                              ("shelves", True, 128),
                                              ("medium", False, 256),
                                              ("medium", True, 16)])
def test_wide_sgd_phase_kernel_matches_twin(name, glob, hidden, dev):
    """K3 (and K4 inside it) at wide shapes: D = 411 and 611 at hidden 128
    (the first layer over several chunks of the observation, which the
    chunked launch count shows), the ego window at hidden 256, and D = 411
    at hidden 16, against autograd + optim.py at K3's tolerances with
    masking on, and bit-equal to itself on a rerun."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd import (
        ppo_minibatch_grads, ppo_minibatch_grads_reference, ppo_sgd_phase,
        ppo_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = (GLOBAL if glob else PRESETS)[name]
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=True, **SGD_KW)
    chunked = ppo_sgd_phase.chunked_launches
    p_k, o_k, l_k = ppo_sgd_phase(*args, **kw)
    assert ppo_sgd_phase.chunked_launches == chunked + glob * SGD_E * SGD_M
    p_r, o_r, l_r = ppo_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, o_2, l_2 = ppo_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))
    gkw = dict(num_minibatches=SGD_M, mask_actions=True, **SGD_KW)
    (l_k, aux_k), g_k = ppo_minibatch_grads(params, traj, adv_n, targets, 1,
                                            0.01, 0.05, **gkw)
    (l_r, aux_r), g_r = ppo_minibatch_grads_reference(
        params, traj, adv_n, targets, 1, 0.01, 0.05, **gkw)
    for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert_close_tree(g_k, g_r, 1e-4, 1e-7, "grads")


@pytest.mark.parametrize("use_rms", [True, False])
def test_wide_impala_phase_kernel_matches_twin(use_rms, dev):
    """K5 (and K6 inside it) at hidden 256, on the tile kernels it shares
    with K3, masked with the truncation bootstrap, at K5's tolerances."""
    from warehouse_tpu_torch.kernels.vtrace_sgd import (
        impala_sgd_phase, impala_sgd_phase_reference)
    from warehouse_tpu_torch.optim import (AdamState, ClipAdam, ClipRMSProp,
                                           RMSState, linear_schedule)

    params, traj, last_obs, g = vtrace_batch(medium_config(), 256, dev)
    nu = {k: (1e-6 * torch.rand(v.shape, generator=g)).to(dev)
          for k, v in params.items()}
    if use_rms:
        opt, optimizer = RMSState(3, nu), ClipRMSProp
    else:
        mu = {k: (1e-3 * torch.randn(v.shape, generator=g)).to(dev)
              for k, v in params.items()}
        opt, optimizer = AdamState(3, mu, nu), ClipAdam
    rows = optimizer(linear_schedule(3e-4, 0.0, 100), 0.5).step_rows(
        opt.count, VT_P * VT_M, dev)
    args = (params, opt, traj, last_obs, rows, 0.01)
    kw = dict(num_passes=VT_P, num_minibatches=VT_M, max_grad_norm=0.5,
              mask_actions=True, bootstrap_truncated=True, **VT_KW)
    p_k, o_k, l_k = impala_sgd_phase(*args, **kw)
    p_r, o_r, l_r = impala_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, _, l_2 = impala_sgd_phase(*args, **kw)
    assert all(torch.equal(p_k[k], p_2[k]) for k in p_k)
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))


@pytest.mark.parametrize("name,hidden", [("small", 32), ("medium", 128)])
def test_global_obs_cnn_sgd_kernels_match_twin(name, hidden, dev):
    """K11 and K12 on the global view (S = 5 / 9, conv 0 of 5 channels, a
    tile of 32 / 8 samples), masked, at the ego tests' tolerances; K11
    bit-equal to itself on a rerun; the conv-0 gradient has the true [16,
    5, 3, 3] shape."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd_cnn import (
        ppo_cnn_minibatch_grads, ppo_cnn_minibatch_grads_reference,
        ppo_cnn_sgd_phase, ppo_cnn_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = GLOBAL[name]
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch="cnn")
    assert params["conv.0.weight"].shape == (16, 5, 3, 3)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=True, **SGD_KW)
    small = ppo_cnn_sgd_phase.small_tile_launches
    p_k, o_k, l_k = ppo_cnn_sgd_phase(*args, **kw)
    # The 9 x 9 map's rows leave room for fewer samples a conv tile.
    assert (ppo_cnn_sgd_phase.small_tile_launches
            == small + (name == "medium") * SGD_E * SGD_M)
    p_r, o_r, l_r = ppo_cnn_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, o_2, l_2 = ppo_cnn_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))
    gkw = dict(num_minibatches=SGD_M, mask_actions=True, **SGD_KW)
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = ppo_cnn_minibatch_grads(
            params, traj, adv_n, targets, mb, 0.01, 0.05, **gkw)
        (l_r, aux_r), g_r = ppo_cnn_minibatch_grads_reference(
            params, traj, adv_n, targets, mb, 0.01, 0.05, **gkw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert g_k["conv.0.weight"].shape == (16, 5, 3, 3)
        assert_close_tree(g_k, g_r, 1e-4, 1e-6, f"grads mb={mb}")


# ---- policy groups (K2, K3 / K4) -----------------------------------------------

GROUP_ACT_CASES = [  # (preset, hidden, groups, mask, shaped, global view)
    ("medium", 128, (0, 1, 0, 1), False, False, False),
    ("shelves", 128, (0, 0, 0, 1, 1, 1), True, True, False),
    ("shelves", 128, (1, 0, 0, 1, 1, 0), True, False, False),
    ("medium", 128, (0, 1, 0, 1), True, False, True),
    ("medium", 16, (0, 1, 2, 3), True, True, False),
    ("shelves", 16, (0, 1, 2, 3, 4, 5), False, False, False),
    ("small", 16, (1, 0), True, False, False)]


@pytest.mark.parametrize("name,hidden,groups,mask_on,shaped,glob",
                         GROUP_ACT_CASES)
def test_grouped_act_kernel_matches_plain_path(name, hidden, groups, mask_on,
                                               shaped, glob, dev):
    """K2 with policy groups: each agent's rows through its group's MLP,
    held to the plain multi-policy model on the kernel's observations and
    the plain engine replaying its actions (interleaved groups, groups of
    neighbours, every agent its own policy), masked, shaped, with the
    global view; the group count and the stage count move."""
    from warehouse_tpu_torch.models import make_multi_policy_model

    cfg = (GLOBAL if glob else PRESETS)[name]
    m = make_multi_policy_model(cfg, groups, hidden_dim=hidden,
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
    stages, grouped = act_steps.stage_launches, act_steps.group_launches
    replay_check(cfg, m, act_steps, dev, mask_on, shaped, groups=groups)
    assert act_steps.group_launches == grouped + 1
    assert act_steps.stage_launches == stages + k2_stage_launches(2)


GROUP_SGD_CASES = [("medium", 128, (0, 1, 0, 1)),
                   ("shelves", 128, (0, 0, 0, 1, 1, 1)),
                   ("shelves", 16, (1, 0, 0, 1, 1, 0)),
                   ("medium", 16, (0, 1, 2, 3))]


@pytest.mark.parametrize("name,hidden,groups", GROUP_SGD_CASES)
def test_grouped_sgd_kernels_match_twin(name, hidden, groups, dev):
    """K3 and K4 with policy groups against autograd + optim.py through
    the multi-policy model, at K3's tolerances, masked; K3 bit-equal to
    itself on a rerun; the group counts move by a launch per step."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd import (
        ppo_minibatch_grads, ppo_minibatch_grads_reference, ppo_sgd_phase,
        ppo_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = PRESETS[name]
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev,
                                                  groups=groups)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=True, policy_groups=groups, **SGD_KW)
    grouped = ppo_sgd_phase.group_launches
    p_k, o_k, l_k = ppo_sgd_phase(*args, **kw)
    assert ppo_sgd_phase.group_launches == grouped + SGD_E * SGD_M
    p_r, o_r, l_r = ppo_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, o_2, l_2 = ppo_sgd_phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))
    gkw = dict(num_minibatches=SGD_M, mask_actions=True,
               policy_groups=groups, **SGD_KW)
    grouped = ppo_minibatch_grads.group_launches
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = ppo_minibatch_grads(params, traj, adv_n, targets,
                                                mb, 0.01, 0.05, **gkw)
        (l_r, aux_r), g_r = ppo_minibatch_grads_reference(
            params, traj, adv_n, targets, mb, 0.01, 0.05, **gkw)
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-7, f"grads mb={mb}")
    assert ppo_minibatch_grads.group_launches == grouped + SGD_M


CNN_GROUP_ACT_CASES = [  # (preset, hidden, groups, mask, shaped)
    ("medium", 128, (0, 1, 0, 1), False, False),
    ("shelves", 128, (0, 0, 0, 1, 1, 1), True, True),
    ("shelves", 16, (1, 0, 0, 1, 1, 0), True, False),
    ("small", 16, (1, 0), False, True),
    ("large", 16, (0, 0, 1, 1, 0, 0, 1, 1), True, False),
    # One policy per agent, and two groups on the 9x9 global view.
    ("medium", 128, (0, 1, 2, 3), True, True),
    ("medium_global", 128, (0, 1, 0, 1), True, True),
    ("large", 128, (0, 1, 2, 3, 4, 5, 6, 7), True, True)]


@pytest.mark.parametrize("name,hidden,groups,mask_on,shaped",
                         CNN_GROUP_ACT_CASES)
def test_grouped_cnn_act_kernel_matches_plain_path(name, hidden, groups,
                                                   mask_on, shaped, dev):
    """K10 with policy groups: each agent's rows through its group's
    convolutions, trunk and head (a step's rows group by group, each stage
    tile one group's), held to the plain multi-policy CNN on the kernel's
    observations and
    the plain engine replaying its actions, masked and shaped, on a ragged
    last block; a second launch gives the same bits; the group count
    moves."""
    from warehouse_tpu_torch.kernels.act import act_cnn_steps
    from warehouse_tpu_torch.models import make_multi_policy_model

    cfg = {**PRESETS, "medium_global": GLOBAL["medium"]}[name]
    m = make_multi_policy_model(cfg, groups, "cnn", hidden_dim=hidden,
                                generator=torch.Generator().manual_seed(0),
                                device=dev)
    grouped = act_cnn_steps.group_launches
    replay_check(cfg, m, act_cnn_steps, dev, mask_on, shaped, groups=groups,
                 rerun=True)
    assert act_cnn_steps.group_launches == grouped + 2


@pytest.mark.parametrize("name,groups", [
    ("medium", (0, 1, 2, 3)), ("medium_global", (0, 1, 0, 1)),
    ("large", (0, 1, 2, 3, 4, 5, 6, 7)), ("shelves_global", (0, 0, 0, 1, 1, 1))])
def test_grouped_cnn_refuses_what_it_cannot_hold(name, groups, dev):
    """One policy per agent on config 4 and on the 8-agent preset, and two
    groups on the 9 x 9 global map, build with K10 acting (the learner
    plain) and one update acts through K10's group route; on the 11 x 11
    global map, whose conv tile of 16 samples outgrows a block, the trainer
    acts per step and learns plain (as the JAX VMEM gates send it to XLA),
    and its update launches no K10."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.act import act_cnn_steps
    from warehouse_tpu_torch.train import make_train

    cfg = {**PRESETS, **{f"{k}_global": v for k, v in GLOBAL.items()}}[name]
    tcfg = TrainConfig(num_envs=64, num_updates=2)
    tr = make_train(cfg, tcfg, arch="cnn", policy_groups=groups, device=dev)
    step_route = name == "shelves_global"
    assert tr.backends == {"rollout": "step" if step_route else "cuda",
                           "grad": "plain"}
    grouped = act_cnn_steps.group_launches
    _, m = tr.train_step(tr.init(rng.prng_key(0, dev)))
    assert act_cnn_steps.group_launches == grouped + (not step_route)
    assert all(bool(torch.isfinite(v)) for v in m.values())


def test_grouped_cnn_trainer_matches_plain_step(dev):
    """make_train(arch="cnn") with policy groups on the card: K10 acts with
    groups and the learner is plain (the JAX trainer's is XLA there); one
    update and one through the plain path from the same state agree
    (chip_smoke.py's STEP_METRIC_TOL)."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.act import act_cnn_steps
    from warehouse_tpu_torch.train import make_train

    tcfg = TrainConfig(num_envs=256, num_updates=4, mask_actions=True,
                       shaping_coef=0.02)
    tr = make_train(shelves_config(), tcfg, arch="cnn",
                    policy_groups=(0, 0, 0, 1, 1, 1), device=dev)
    assert tr.backends == {"rollout": "cuda", "grad": "plain"}
    rs0 = tr.init(rng.prng_key(0, dev))
    grouped = act_cnn_steps.group_launches
    _, mk = tr.train_step(rs0)
    assert act_cnn_steps.group_launches == grouped + 1
    _, mp = tr.plain_step(rs0)
    for k in mk:
        a, b = float(mk[k]), float(mp[k])
        assert abs(a - b) <= 5e-5 + 1e-3 * abs(b), (k, a, b)


def test_grouped_trainer_matches_plain_step(dev):
    """make_train with policy groups on the card: one update through K2
    and K3 / K4 and one through the plain twins from the same state agree
    (chip_smoke.py's STEP_METRIC_TOL); the CNN with groups builds with
    K10 acting and the learner plain (test_grouped_cnn_trainer_matches_plain_step
    runs it)."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.train import make_train

    tcfg = TrainConfig(num_envs=256, num_updates=4, mask_actions=True)
    tr = make_train(shelves_config(), tcfg, policy_groups=(0, 0, 0, 1, 1, 1),
                    device=dev)
    rs0 = tr.init(rng.prng_key(0, dev))
    _, mk = tr.train_step(rs0)
    _, mp = tr.plain_step(rs0)
    for k in mk:
        a, b = float(mk[k]), float(mp[k])
        assert abs(a - b) <= 5e-5 + 1e-3 * abs(b), (k, a, b)
    cnn = make_train(medium_config(), tcfg, arch="cnn",
                     policy_groups=(0, 1, 0, 1), device=dev)
    assert cnn.backends == {"rollout": "cuda", "grad": "plain"}


# ---- bf16 operands in the learners (K3 / K4, K8 / K9, K11 / K12) ---------------

# A bf16-operand kernel against its bf16 twin, held in norm with
# chip_smoke.py's helpers: where a float32 value is one ulp off between the
# two (another summation order, another expf) it can round to the
# neighbouring bf16 operand, which moves that product by up to 2^-8, and
# Adam carries that into every later step, so the f32 suite's elementwise
# bounds do not hold. ||kernel - twin|| <= rel ||twin|| + atol sqrt(n): a
# phase's params, moments and losses at chip_smoke.py's BF16_PHASE_REL with
# the f32 table's atol; a gradient at GRAD_REL, with the f32 twin beyond it.
# chip_smoke.py holds gradients at 2e-4, on config-4 trajectories whose
# gradients are coherent sums over 65536 samples; the minibatches here are
# 500 random samples, whose gradients are incoherent, and the kernel-twin
# distance read here on an H100 80GB HBM3 (700 W) is up to 8.4e-4 (K9, the
# GRU at hidden 128; K4 at D = 611 3.8e-4, the rest under 2e-4), the f32
# twin's at least 5.9e-3. GRAD_REL lies between the two.
GRAD_REL = 2e-3


@functools.cache
def smoke():
    """The repository root's chip_smoke.py as a module (it runs nothing
    on import)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def phase_and_grads_check(phase, phase_ref, grads, grads_ref, args, gargs,
                          kw, gkw):
    """The kernel phase and each minibatch's gradient against their twins
    with ``matmul_dtype="bfloat16"`` in norm; the phase bit-equal to itself
    on a rerun, every launch counted as bf16; the f32 twin's gradient
    beyond ``GRAD_REL``."""
    cs = smoke()
    kw, gkw = (dict(d, matmul_dtype="bfloat16") for d in (kw, gkw))
    n_bf = phase.bf16_launches, grads.bf16_launches
    p_k, o_k, l_k = phase(*args, **kw)
    want = phase_ref(*args, **kw)
    torch.cuda.synchronize()
    assert phase.bf16_launches == n_bf[0] + SGD_E * SGD_M
    ratios = cs.phase_norm_ratios((p_k, o_k, l_k), want, cs.SGD_TOL)
    assert max(ratios.values()) <= 1.0, ratios
    p_2, o_2, l_2 = phase(*args, **kw)
    for k in p_k:
        assert torch.equal(p_k[k], p_2[k]) and torch.equal(o_k.nu[k],
                                                           o_2.nu[k]), k
    assert all(torch.equal(a, b) for a, b in zip(l_k, l_2))
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = grads(*gargs(mb), **gkw)
        (l_r, aux_r), g_r = grads_ref(*gargs(mb), **gkw)
        torch.cuda.synchronize()
        r = cs.norm_ratio((l_k, *aux_k), (l_r, *aux_r), GRAD_REL,
                          cs.RNN_MB_LOSS_TOL[1], stack=True)
        assert r <= 1.0, f"losses mb={mb}: {r:.3g} of the bound"
        r = cs.norm_ratio(g_k, g_r, GRAD_REL)
        assert r <= 1.0, f"grads mb={mb}: {r:.3g} of the bound"
    assert grads.bf16_launches == n_bf[1] + 2 * SGD_E * SGD_M + SGD_M
    _, g_f = grads_ref(*gargs(SGD_M - 1),
                       **{k: v for k, v in gkw.items() if k != "matmul_dtype"})
    r = cs.norm_ratio(g_f, g_r, GRAD_REL)
    assert r > 1.0, f"the f32 twin's gradient at {r:.3g} of the bound"


BF16_SGD_CASES = [("medium", False, 128, None), ("medium", False, 16, None),
                  ("shelves", True, 128, None),
                  ("shelves", False, 128, (0, 0, 0, 1, 1, 1))]


@pytest.mark.parametrize("name,glob,hidden,groups", BF16_SGD_CASES)
def test_bf16_sgd_kernels_match_twin(name, glob, hidden, groups, dev):
    """K3 and K4 on bf16 operands against the bf16 twin (``Bf16Linear``):
    config 4's widths, hidden 16, the global view's D = 611 (the chunked
    first layer) and policy groups, masked."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd import (
        ppo_minibatch_grads, ppo_minibatch_grads_reference, ppo_sgd_phase,
        ppo_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = (GLOBAL if glob else PRESETS)[name]
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev,
                                                  groups=groups)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    gkw = dict(num_minibatches=SGD_M, mask_actions=True, **SGD_KW)
    if groups is not None:
        gkw["policy_groups"] = groups
    kw = dict(num_epochs=SGD_E, max_grad_norm=0.5, **gkw)
    phase_and_grads_check(
        ppo_sgd_phase, ppo_sgd_phase_reference, ppo_minibatch_grads,
        ppo_minibatch_grads_reference,
        (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05),
        lambda mb: (params, traj, adv_n, targets, mb, 0.01, 0.05), kw, gkw)


@pytest.mark.parametrize("arch", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [32, 128])
def test_bf16_rnn_sgd_kernels_match_twin(hidden, arch, dev):
    """K8 and K9 on bf16 operands against the bf16 twin, GRU and LSTM,
    masked, from a carry of bf16 values (the trainer's, cast up)."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd_rnn import (
        ppo_rnn_minibatch_grads, ppo_rnn_minibatch_grads_reference,
        ppo_rnn_sgd_phase, ppo_rnn_sgd_phase_reference)
    from warehouse_tpu_torch.models.policy import bf16_round
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = medium_config()
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch=arch)
    h0 = rnn_carry(arch, hidden, cfg.num_agents, dev, 11, SGD_B)
    h0 = tuple(map(bf16_round, h0)) if arch == "lstm" else bf16_round(h0)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    gkw = dict(num_minibatches=SGD_M, mask_actions=True, **SGD_KW)
    kw = dict(num_epochs=SGD_E, max_grad_norm=0.5, **gkw)
    phase_and_grads_check(
        ppo_rnn_sgd_phase, ppo_rnn_sgd_phase_reference,
        ppo_rnn_minibatch_grads, ppo_rnn_minibatch_grads_reference,
        (params, opt, traj, adv_n, targets, h0, *rows, 0.01, 0.05),
        lambda mb: (params, traj, adv_n, targets, h0, mb, 0.01, 0.05), kw,
        gkw)


@pytest.mark.parametrize("name,glob,hidden", [("medium", False, 128),
                                              ("medium", True, 128),
                                              ("small", False, 32)])
def test_bf16_cnn_sgd_kernels_match_twin(name, glob, hidden, dev):
    """K11 and K12 on bf16 operands against the bf16 twin (``Bf16Conv``,
    ``Bf16Linear``) on the ego window (S = 5) and the 9 x 9 global view,
    masked."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd_cnn import (
        ppo_cnn_minibatch_grads, ppo_cnn_minibatch_grads_reference,
        ppo_cnn_sgd_phase, ppo_cnn_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = (GLOBAL if glob else PRESETS)[name]
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch="cnn")
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    gkw = dict(num_minibatches=SGD_M, mask_actions=True, **SGD_KW)
    kw = dict(num_epochs=SGD_E, max_grad_norm=0.5, **gkw)
    phase_and_grads_check(
        ppo_cnn_sgd_phase, ppo_cnn_sgd_phase_reference,
        ppo_cnn_minibatch_grads, ppo_cnn_minibatch_grads_reference,
        (params, opt, traj, adv_n, targets, *rows, 0.01, 0.05),
        lambda mb: (params, traj, adv_n, targets, mb, 0.01, 0.05), kw, gkw)


@pytest.mark.parametrize("arch", ["mlp", "gru", "cnn"])
def test_bf16_launch_leaves_the_f32_route_bit_equal(arch, dev):
    """An f32 phase, a bf16 phase, the f32 phase again: the second f32
    result is bit-equal to the first (the flag is per launch), and the bf16
    one differs from both."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels import sgd, sgd_cnn, sgd_rnn
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = medium_config()
    params, opt, traj, adv_n, targets = sgd_batch(cfg, 128, dev, arch=arch)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    lead = (params, opt, traj, adv_n, targets)
    if arch == "gru":
        lead += (rnn_carry(arch, 128, cfg.num_agents, dev, 11, SGD_B),)
    phase = {"mlp": sgd.ppo_sgd_phase, "gru": sgd_rnn.ppo_rnn_sgd_phase,
             "cnn": sgd_cnn.ppo_cnn_sgd_phase}[arch]
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=True, **SGD_KW)
    p_a, _, l_a = phase(*lead, *rows, 0.01, 0.05, **kw)
    p_b, _, _ = phase(*lead, *rows, 0.01, 0.05, matmul_dtype="bfloat16", **kw)
    p_c, _, l_c = phase(*lead, *rows, 0.01, 0.05, **kw)
    assert all(torch.equal(p_a[k], p_c[k]) for k in p_a)
    assert all(torch.equal(a, b) for a, b in zip(l_a, l_c))
    assert any(not torch.equal(p_a[k], p_b[k]) for k in p_a)
    with pytest.raises(ValueError, match="matmul_dtype"):
        phase(*lead, *rows, 0.01, 0.05, matmul_dtype="float16", **kw)


# ---- the learners on the per-step acting phase's chunks ---------------------

def ragged_impala_chunk(dev, T=24, hidden=128, seed=0):
    """A medium IMPALA chunk of T steps from the per-step acting phase
    (``train.ppo.step_rollout``), its N envs moved 1 to T - 1 steps before
    their episode's end: every env truncates inside the chunk and starts
    anew there."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.models.policy import apply
    from warehouse_tpu_torch.train.impala import ImpalaTransition
    from warehouse_tpu_torch.train.ppo import step_rollout

    cfg = medium_config()
    state, obs = reset(cfg, seed, dev)
    left = torch.randint(1, T, (N,), generator=torch.Generator().manual_seed(
        seed)).to(dev)
    state = state.replace(t=(cfg.max_steps - left).to(state.t))
    m = make_model(cfg, hidden_dim=hidden,
                   generator=torch.Generator().manual_seed(seed), device=dev)
    params = {k: v.detach() for k, v in m.state_dict().items()}
    _, roll, last_obs, _, _, _ = step_rollout(
        cfg, TrainConfig(), lambda o, c: (*apply(params, o), None), state,
        obs, T, rng.prng_key(seed + 1, dev))
    done = roll.truncated[:, :, None].expand_as(roll.reward)
    assert int(done[:-1, :, 0].sum()) == N  # every env, before the last step
    traj = ImpalaTransition(roll.obs, roll.action, roll.log_prob,
                            roll.reward, done, roll.mask,
                            torch.zeros_like(roll.reward))
    return params, traj, last_obs


@pytest.mark.parametrize("use_rms", [True, False])
def test_impala_kernels_on_a_ragged_chunk(use_rms, dev):
    """K5 against its twin and K6 against autograd on a 24-step chunk of
    the per-step acting phase with a truncation inside it in every env
    (IMPALA with ``max_steps % unroll_length != 0``: V-trace cut where
    ``done`` is set), at the K5 / K6 tolerances; K5 bit-equal on a
    rerun."""
    from warehouse_tpu_torch.kernels.vtrace_sgd import (
        impala_minibatch_grads, impala_minibatch_grads_reference,
        impala_sgd_phase, impala_sgd_phase_reference)
    from warehouse_tpu_torch.optim import (ClipAdam, ClipRMSProp,
                                           linear_schedule)

    params, traj, last_obs = ragged_impala_chunk(dev)
    optimizer = (ClipRMSProp if use_rms else ClipAdam)(
        linear_schedule(3e-4, 0.0, 100), 0.5)
    opt = optimizer.init(params)
    rows = optimizer.step_rows(opt.count, VT_M, dev)
    args = (params, opt, traj, last_obs, rows, 0.01)
    kw = dict(num_passes=1, num_minibatches=VT_M, max_grad_norm=0.5,
              mask_actions=False, bootstrap_truncated=False, **VT_KW)
    p_k, o_k, l_k = impala_sgd_phase(*args, **kw)
    p_r, o_r, l_r = impala_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    if not use_rms:
        assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    p_2, _, _ = impala_sgd_phase(*args, **kw)
    assert all(torch.equal(p_k[k], p_2[k]) for k in p_k)
    gkw = dict(num_minibatches=VT_M, mask_actions=False,
               bootstrap_truncated=False, **VT_KW)
    for mb in range(VT_M):
        (l_k, aux_k), g_k = impala_minibatch_grads(params, traj, last_obs,
                                                   mb, 0.01, **gkw)
        (l_r, aux_r), g_r = impala_minibatch_grads_reference(
            params, traj, last_obs, mb, 0.01, **gkw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-6, f"grads mb={mb}")


@pytest.mark.parametrize("arch", ["gru", "lstm"])
@pytest.mark.parametrize("hidden", [16, 128])
def test_rnn_sgd_kernels_at_the_global_width(hidden, arch, dev):
    """K8 against its twin and K9 against autograd on observations D = 411
    wide (the 9x9 global view, which only the per-step acting phase makes
    for the recurrent trainer): K8's shared memory for that first layer,
    at K3's tolerances; K8 bit-equal on a rerun."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.sgd_rnn import (
        check_rnn_learner_fits, ppo_rnn_minibatch_grads,
        ppo_rnn_minibatch_grads_reference, ppo_rnn_sgd_phase,
        ppo_rnn_sgd_phase_reference)
    from warehouse_tpu_torch.optim import make_optimizer

    cfg = GLOBAL["medium"]
    assert cfg.obs_dim == 411
    params, opt, traj, adv_n, targets = sgd_batch(cfg, hidden, dev, arch=arch)
    check_rnn_learner_fits(params, cfg.obs_dim, dev)
    h0 = rnn_carry(arch, hidden, cfg.num_agents, dev, 13, SGD_B)
    rows = make_optimizer(TrainConfig(num_updates=4)).step_rows(
        opt.count, SGD_E * SGD_M, dev)
    args = (params, opt, traj, adv_n, targets, h0, *rows, 0.01, 0.05)
    kw = dict(num_epochs=SGD_E, num_minibatches=SGD_M, max_grad_norm=0.5,
              mask_actions=True, **SGD_KW)
    p_k, o_k, l_k = ppo_rnn_sgd_phase(*args, **kw)
    p_r, o_r, l_r = ppo_rnn_sgd_phase_reference(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(l_k, l_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
    assert_close_tree(p_k, p_r, 1e-5, 1e-6, "params")
    assert_close_tree(o_k.mu, o_r.mu, 1e-5, 1e-7, "mu")
    assert_close_tree(o_k.nu, o_r.nu, 1e-5, 1e-10, "nu")
    p_2, _, _ = ppo_rnn_sgd_phase(*args, **kw)
    assert all(torch.equal(p_k[k], p_2[k]) for k in p_k)
    gkw = dict(num_minibatches=SGD_M, mask_actions=True, **SGD_KW)
    for mb in range(SGD_M):
        (l_k, aux_k), g_k = ppo_rnn_minibatch_grads(
            params, traj, adv_n, targets, h0, mb, 0.01, 0.05, **gkw)
        (l_r, aux_r), g_r = ppo_rnn_minibatch_grads_reference(
            params, traj, adv_n, targets, h0, mb, 0.01, 0.05, **gkw)
        torch.cuda.synchronize()
        for a, b in zip((l_k, *aux_k), (l_r, *aux_r)):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=2e-6)
        assert_close_tree(g_k, g_r, 1e-4, 1e-6, f"grads mb={mb}")


STEP_CASES = {  # name: (trainer, env, TrainConfig change, arch, backends)
    "ppo_ragged": ("ppo", "medium", dict(unroll_length=24), "mlp",
                   {"rollout": "step", "grad": "cuda"}),
    "impala_ragged": ("impala", "medium", dict(unroll_length=24), "mlp",
                      {"rollout": "step", "grad": "cuda"}),
    "gru_global": ("rnn", "medium_global", {}, "gru",
                   {"rollout": "step", "grad": "cuda"}),
    "gru_shelves_shaped": ("rnn", "shelves", dict(
        mask_actions=True, shaping_coef=0.02, bootstrap_truncated=True),
        "gru", {"rollout": "step", "grad": "cuda"}),
    "gru_ragged": ("rnn", "medium", dict(unroll_length=24), "gru",
                   {"rollout": "step", "grad": "plain"}),
    "attn": ("ppo", "medium", {}, "attn",
             {"rollout": "step", "grad": "plain"}),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_step_route_trainers_match_plain_step(case, dev):
    """The trainers' per-step acting phase on the card, with the learner
    kernel where the JAX gate keeps its own: one update and one through
    the plain path from the same state agree (chip_smoke.py's
    STEP_METRIC_TOL), and no acting kernel launches."""
    from warehouse_tpu_torch import TrainConfig
    from warehouse_tpu_torch.kernels.act import act_steps
    from warehouse_tpu_torch.kernels.act_rnn import act_rnn_steps
    from warehouse_tpu_torch.train import (make_train, make_train_impala,
                                           make_train_rnn)

    kind, env, change, arch, backends = STEP_CASES[case]
    cfg = (GLOBAL["medium"] if env == "medium_global" else PRESETS[env])
    make = {"ppo": make_train, "impala": make_train_impala,
            "rnn": make_train_rnn}[kind]
    tcfg = TrainConfig(num_envs=256, num_updates=4, impala_rmsprop=False,
                       **change)
    tr = make(cfg, tcfg, arch=arch, device=dev)
    assert tr.backends == backends
    rs0 = tr.init(rng.prng_key(0, dev))
    acting = act_steps.launches, act_rnn_steps.launches
    _, mk = tr.train_step(rs0)
    assert (act_steps.launches, act_rnn_steps.launches) == acting
    _, mp = tr.plain_step(rs0)
    for k in mk:
        a, b = float(mk[k]), float(mp[k])
        assert abs(a - b) <= 5e-5 + 1e-3 * abs(b), (k, a, b)


@pytest.mark.parametrize("name", ["k3_config4", "k3_groups", "k5_config4",
                                  "k11_config4", "k8_config4", "k8_h50"])
def test_grad_sumsq_kernel_matches_plain_in_four_layouts(name, dev):
    """The sums-of-squares kernel (``sgd.grad_sumsq``, the meshed learners'
    norm of the averaged gradient) on one minibatch's gradient of each
    learner's grads kernel: into a buffer of its own and into the
    workspace, bit-equal to the sums the grads kernel left there and to
    the plain version (K3 with and without groups, K5, K11's conv then
    dense blocks, K8 at config 4 and at hidden 50 through the pad), as
    chip_smoke.py's ``sumsq_check``."""
    cs = smoke()
    assert name in cs.SUMSQ_CASES
    out = cs.sumsq_run(*cs.sumsq_case(dev, name))
    assert out["kernel_equal_reduce"], name
    assert out["plain_equal_reduce"], name
    assert out["workspace_equal_reduce"], name
    assert out["padded"] == (name == "k8_h50")

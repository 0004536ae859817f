"""The IMPALA learner's stages (``kernels/vtrace_sgd.py``), plain, against
the twin and the JAX package on the CPU.

K6's gradient runs on the card as five stage kernels (``csrc/
vtrace_sgd.cu``: the forward over the samples and the last-obs rows, the
head, the V-trace, the dgrads, the weight gradients) after a prep kernel,
each with a plain PyTorch version that takes and gives the same rows. Here
their composition is held against the plain twin
(``impala_minibatch_grads_reference``: autograd through the MLP and
V-trace) for 1 to 3 hidden layers, with and without action masking and
the truncation bootstrap, on an observation wider than 128 features with
a minibatch that no 64-row tile and no 256-trace CTA divides, and against
``impala_minibatch_grads_pallas`` in interpret mode. Inputs come from
numpy seeds. The stage kernels themselves are held against these plain
stages on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest
import torch

from warehouse_tpu.pallas.vtrace_sgd import impala_minibatch_grads_pallas
from warehouse_tpu_torch.kernels import vtrace_sgd
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.train import ImpalaTransition

import test_impala_kernel as ik
from test_torch_impala import port_inputs
from test_torch_sgd_stages import mlp_params

ENT = 0.01
LOSS_KW = dict(gamma=0.99, rho_clip=1.0, c_clip=0.9, value_coef=0.5)
# The JAX suite's bounds (tests/test_impala_kernel.py, chip_smoke.py's
# VT_TOL["grads"]): float32 sums in another order; the loss terms within
# 1e-6.
GRAD_TOL, LOSS_ATOL = (1e-4, 1e-6), 1e-6


def setup(n_hidden: int, seed: int = 0, T: int = 4, B: int = 8, A: int = 2,
          D: int = 13, H: int = 12):
    """MLP params and an IMPALA trajectory ``[T, B, A]`` with its last
    observations ``[B, A, D]``, all from a numpy seed: masked actions,
    dones on random steps (so that traces cross boundaries) and bootstrap
    values."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    action = rng.integers(0, 5, size=(T, B, A)).astype(np.int32)
    mask = rng.random(size=(T, B, A, 5)) > 0.3
    mask[..., 0] = True
    np.put_along_axis(mask, action[..., None].astype(np.int64), True, -1)
    traj = ImpalaTransition(
        t(rng.normal(size=(T, B, A, D)).astype(np.float32)), t(action),
        t((-1.6 + 0.1 * rng.normal(size=(T, B, A))).astype(np.float32)),
        t(rng.normal(size=(T, B, A)).astype(np.float32)),
        t(rng.random(size=(T, B, A)) < 0.2), t(mask),
        t(rng.normal(size=(T, B, A)).astype(np.float32)))
    last_obs = t(rng.normal(size=(B, A, D)).astype(np.float32))
    return mlp_params(rng, D, H, n_hidden), traj, last_obs


def assert_grads(got: dict, want: dict, what: str) -> None:
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1], msg=f"{what} {k}")


def assert_losses(got, want):
    (l_a, aux_a), (l_b, aux_b) = got, want
    for a, b in zip((l_a, *aux_a), (l_b, *aux_b)):
        assert abs(float(a) - float(b)) < LOSS_ATOL


def staged_and_twin(params, traj, last_obs, mb, M, **kw):
    kw = dict(num_minibatches=M, **LOSS_KW, **kw)
    return (vtrace_sgd.vtrace_minibatch_grads_staged(params, traj, last_obs,
                                                     mb, ENT, **kw),
            vtrace_sgd.impala_minibatch_grads_reference(params, traj,
                                                        last_obs, mb, ENT,
                                                        **kw))


CASES = [(n, mask, boot) for n in (1, 2, 3) for mask in (False, True)
         for boot in (False, True)]


@pytest.mark.parametrize("n_hidden,mask_actions,bootstrap_truncated", CASES)
def test_staged_grads_match_twin(n_hidden, mask_actions,
                                 bootstrap_truncated):
    """The five plain stages composed equal the plain twin (autograd
    through the MLP and V-trace), every minibatch."""
    params, traj, last_obs = setup(n_hidden, seed=n_hidden)
    M = 2
    for mb in range(M):
        got, want = staged_and_twin(params, traj, last_obs, mb, M,
                                    mask_actions=mask_actions,
                                    bootstrap_truncated=bootstrap_truncated)
        assert_losses(got[0], want[0])
        assert_grads(got[1], want[1], f"mb={mb}")


def test_staged_grads_match_twin_wide_ragged():
    """An observation 150 wide (more than one 128-column tile of x0) and a
    minibatch of 75 samples with 15 last-obs rows (5 steps of 5 envs of 3
    agents: no 64-row tile full at the end, one trace CTA a quarter full),
    hidden 16, masked, with the bootstrap."""
    params, traj, last_obs = setup(2, seed=4, T=5, B=10, A=3, D=150, H=16)
    for mb in range(2):
        got, want = staged_and_twin(params, traj, last_obs, mb, 2,
                                    mask_actions=True,
                                    bootstrap_truncated=True)
        assert_losses(got[0], want[0])
        assert_grads(got[1], want[1], f"wide, ragged, mb={mb}")


@pytest.mark.parametrize("mask_on", [False, True])
def test_staged_grads_match_pallas(mask_on):
    """The composition against the TPU kernel in interpret mode on the JAX
    suite's inputs (``test_impala_kernel``: D = 26, hidden 16 x 2, dones on
    the last step), every minibatch."""
    _, params, *_, data, last_obs = ik._setup(mask_on, True, seed=3)
    obs_bm, fields, lrows = ik._kernel_inputs(data, last_obs)
    p0, traj, lobs = port_inputs(params, data, last_obs)
    kw = dict(gamma=ik.GAMMA, rho_clip=ik.RHO, c_clip=ik.CC,
              value_coef=ik.VCOEF)
    for m in range(ik.M):
        (l_k, aux_k), g_k = impala_minibatch_grads_pallas(
            params, obs_bm, fields, lrows, m, ik.ENT, num_minibatches=ik.M,
            unroll_length=ik.T, num_agents=ik.A, mask_actions=mask_on,
            obs_dim=ik.D, block_envs=8, interpret=True, **kw)
        got = vtrace_sgd.vtrace_minibatch_grads_staged(
            p0, traj, lobs, m, ik.ENT, num_minibatches=ik.M,
            mask_actions=mask_on, bootstrap_truncated=False, **kw)
        assert_losses(got[0], (l_k, aux_k))
        assert_grads(got[1], params_from_flax(jax.tree.map(np.asarray, g_k)),
                     f"against Pallas, mb={m}")


@pytest.mark.parametrize("stage", vtrace_sgd.VT_STAGES)
def test_vtrace_stage_runs_the_plain_stage_on_the_cpu(stage):
    """``vtrace_stage`` on CPU tensors is its plain stage on the plain
    chain's rows and launches no kernel; the chain's rows have the shapes
    the kernels' workspace views give (3 hidden layers of 12 on a 13-wide
    observation: act and out over the N samples and the nb last-obs rows,
    dz and dout over the samples)."""
    params, traj, last_obs = setup(3, seed=5)
    M, kw = 2, dict(mask_actions=True, bootstrap_truncated=True, **LOSS_KW)
    rows = vtrace_sgd.vtrace_minibatch_rows(traj, last_obs, 1, M)
    T, B, A, D = traj.obs.shape
    N, nb = T * (B // M) * A, (B // M) * A
    # The samples in (step, env, agent) order, then the last-obs rows.
    assert torch.equal(rows[0][:N], traj.obs[:, B // M:].reshape(N, D))
    assert torch.equal(rows[0][N:], last_obs[B // M:].reshape(nb, D))
    assert torch.equal(rows[5], traj.mask[:, B // M:].reshape(N, 5))
    chain, want = vtrace_sgd.vtrace_plain_stage_chain(params, rows, ENT, **kw)
    shapes = {**{f"act{i}": (N + nb, 12) for i in range(3)},
              **{f"dz{i}": (N, 12) for i in range(3)},
              "out": (N + nb, 6), "dout": (N, 6)}
    assert {k: v.shape for k, v in chain.items()} == shapes
    before = vtrace_sgd.vtrace_stage.launches
    out = vtrace_sgd.vtrace_stage(
        stage, params, traj, last_obs, 1, ENT,
        vtrace_sgd.vtrace_stage_inputs(stage, params, chain),
        num_minibatches=M, **kw)
    assert vtrace_sgd.vtrace_stage.launches == before
    assert out.keys() == want[stage].keys()
    for k, v in want[stage].items():
        if k == "losses":
            assert all(torch.equal(a, b) for a, b in zip(out[k], v))
        else:
            assert torch.equal(out[k], v), k
    if stage == "wgrad":
        assert all(out[k].shape == params[k].shape for k in params)


def test_vtrace_stage_refuses_an_unknown_stage():
    params, traj, last_obs = setup(1)
    with pytest.raises(ValueError, match="stage must be one of"):
        vtrace_sgd.vtrace_stage("fold", params, traj, last_obs, 0, ENT, {},
                                num_minibatches=2, mask_actions=False,
                                bootstrap_truncated=False, **LOSS_KW)


"""The MLP learner's stages (``kernels/sgd.py``), plain, against the twin
and the JAX package on the CPU.

K4's gradient runs on the card as four stage kernels (``csrc/sgd.cu``: the
forward, the head and loss, the dgrads, the weight gradients) after a prep
kernel, each with a plain PyTorch version that takes and gives the same
rows. Here their composition is held against the plain twin
(``ppo_minibatch_grads_reference``: autograd through the MLP) for 1 to 3
hidden layers, float32 and bf16 operands, policy groups, an observation
wider than 128 features and a minibatch that no 64-row tile divides, and
against ``ppo_minibatch_grads_pallas`` in interpret mode. Inputs come from
numpy seeds. The stage kernels themselves are held against these plain
stages on the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest
import torch

import test_grad_kernel as mg
import test_torch_groups as tg
from warehouse_tpu.pallas.sgd import ppo_minibatch_grads_pallas
from warehouse_tpu_torch.kernels import sgd
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.train import Transition

from test_torch_sgd import port_inputs

ENT, KL = 0.01, 0.05
HYPER = dict(clip_eps=0.2, value_coef=0.5, mask_actions=True)
# Grads against the twin and the Pallas kernel: the JAX suite's bounds
# (tests/test_grad_kernel.py, chip_smoke.py's SGD_TOL["grads"]), float32
# sums in another order; the loss terms within 1e-6. bf16 operands in norm,
# as chip_smoke.py holds them (BF16_GRAD_REL): a float32 value one ulp off
# can round to the neighbouring bf16 operand.
GRAD_TOL, LOSS_ATOL, BF16_GRAD_REL = (1e-4, 1e-7), 1e-6, 2e-4


def mlp_params(rng, D: int, H: int, n_hidden: int) -> dict:
    """An MLP's params keyed like ``ActorCriticMLP.state_dict``: ``n_hidden``
    tanh layers of width H, then the 5 logits and the value."""
    out, fan_in = {}, D
    for i in range(n_hidden):
        out[f"hidden.{i}.weight"] = rng.normal(size=(H, fan_in)) / fan_in ** .5
        out[f"hidden.{i}.bias"] = 0.1 * rng.normal(size=H)
        fan_in = H
    for name, n in (("logits", 5), ("value", 1)):
        out[f"{name}.weight"] = 0.5 * rng.normal(size=(n, H)) / H ** .5
        out[f"{name}.bias"] = 0.1 * rng.normal(size=n)
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in out.items()}


def setup(n_hidden: int, seed: int = 0, T: int = 4, B: int = 8, A: int = 2,
          D: int = 13, H: int = 12, M: int = 2, groups=None):
    """MLP params (with ``groups`` a multi-policy dict, one MLP per group)
    and a masked trajectory ``[T, B, A]`` of random observations, all from
    a numpy seed."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x))

    action = rng.integers(0, 5, size=(T, B, A)).astype(np.int32)
    mask = rng.random(size=(T, B, A, 5)) > 0.3
    mask[..., 0] = True
    np.put_along_axis(mask, action[..., None].astype(np.int64), True, -1)
    adv = rng.normal(size=(T, B, A)).astype(np.float32)
    g = adv.reshape(T, M, B // M, A)
    adv_n = ((g - g.mean(axis=(0, 2, 3), keepdims=True))
             / (g.std(axis=(0, 2, 3), keepdims=True) + 1e-8)).reshape(T, B,
                                                                    A)
    traj = Transition(
        t(rng.normal(size=(T, B, A, D)).astype(np.float32)), t(action),
        t((-1.6 + 0.1 * rng.normal(size=(T, B, A))).astype(np.float32)),
        t(rng.normal(size=(T, B, A)).astype(np.float32)),
        torch.zeros(T, B, A), torch.zeros(T, B, A, dtype=bool), t(mask),
        torch.zeros(T, B, A))
    tgt = t(rng.normal(size=(T, B, A)).astype(np.float32))
    if groups is None:
        params = mlp_params(rng, D, H, n_hidden)
    else:
        params = {f"policies.{k}.{name}": v
                  for k in range(max(groups) + 1)
                  for name, v in mlp_params(rng, D, H, n_hidden).items()}
    return params, traj, t(adv_n), tgt, M


def norm_ratio(a: dict, b: dict) -> float:
    """The largest ||a - b|| / (BF16_GRAD_REL ||b||) over the tensors."""
    return max(float((a[k].double() - b[k].double()).norm()
                     / (BF16_GRAD_REL * b[k].double().norm())) for k in b)


def assert_grads(got: dict, want: dict, bf16: bool, what: str) -> None:
    assert got.keys() == want.keys()
    if bf16:
        assert norm_ratio(got, want) <= 1.0, what
        return
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=GRAD_TOL[0],
                                   atol=GRAD_TOL[1], msg=f"{what} {k}")


def assert_losses(got, want):
    (l_a, aux_a), (l_b, aux_b) = got, want
    for a, b in zip((l_a, *aux_a), (l_b, *aux_b)):
        assert abs(float(a) - float(b)) < LOSS_ATOL


def staged_and_twin(params, traj, adv_n, tgt, mb, M, **kw):
    kw = dict(num_minibatches=M, **HYPER, **kw)
    return (sgd.mlp_minibatch_grads_staged(params, traj, adv_n, tgt, mb, ENT,
                                           KL, **kw),
            sgd.ppo_minibatch_grads_reference(params, traj, adv_n, tgt, mb,
                                              ENT, KL, **kw))


CASES = [(n, dtype) for n in (1, 2, 3) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("n_hidden,matmul_dtype", CASES)
def test_staged_grads_match_twin(n_hidden, matmul_dtype):
    """The four plain stages composed equal the plain twin (autograd through
    the MLP), every minibatch."""
    params, traj, adv_n, tgt, M = setup(n_hidden)
    for mb in range(M):
        got, want = staged_and_twin(params, traj, adv_n, tgt, mb, M,
                                    matmul_dtype=matmul_dtype)
        assert_losses(got[0], want[0])
        assert_grads(got[1], want[1], matmul_dtype == "bfloat16",
                     f"mb={mb}")


@pytest.mark.parametrize("matmul_dtype", ["float32", "bfloat16"])
def test_staged_grads_match_twin_groups(matmul_dtype):
    """With the policy groups ``(0, 1, 0, 1)`` (the rows group after group,
    each group's through its own MLP and into its slice of the gradient)
    at hidden 8, every minibatch."""
    groups = (0, 1, 0, 1)
    params, traj, adv_n, tgt, M = setup(2, seed=2, A=4, H=8, groups=groups)
    for mb in range(M):
        got, want = staged_and_twin(params, traj, adv_n, tgt, mb, M,
                                    policy_groups=groups,
                                    matmul_dtype=matmul_dtype)
        assert_losses(got[0], want[0])
        assert_grads(got[1], want[1], matmul_dtype == "bfloat16",
                     f"mb={mb}")


@pytest.mark.parametrize("groups", [None, (0, 0, 1)])
def test_staged_grads_match_twin_wide_ragged(groups):
    """An observation 150 wide (more than one 128-column tile of x0) and a
    minibatch of 75 samples (5 steps of 5 envs of 3 agents: no 64-row tile
    full at the end; with groups of 50 and 25 samples), hidden 16."""
    params, traj, adv_n, tgt, M = setup(2, seed=4, T=5, B=10, A=3, D=150,
                                        H=16, groups=groups)
    got, want = staged_and_twin(params, traj, adv_n, tgt, 1, M,
                                policy_groups=groups)
    assert_losses(got[0], want[0])
    assert_grads(got[1], want[1], False, "wide, ragged")


def pallas_case(groups):
    """(Pallas params, its inputs and kwargs, the port's inputs and
    kwargs) on test_grad_kernel's inputs (D = 13, masked), or with
    ``groups`` on test_torch_groups' (D = 26)."""
    if groups is None:
        _, params, _, _, opt_state, data = mg._setup(True, seed=3)
        return (params, mg._kernel_inputs(data),
                dict(obs_dim=mg.D, block_envs=8),
                port_inputs(params, opt_state, data), {}, mg.M)
    _, params, _, _, data = tg.sgd_setup(groups, 3)
    return (params, tg.pallas_inputs(data),
            dict(obs_dim=tg.SD, block_envs=tg.SB // tg.SM,
                 rows_per_block=len(groups), policy_groups=groups),
            tg.port_inputs(params, data), dict(policy_groups=groups), tg.SM)


@pytest.mark.parametrize("groups,matmul_dtype", [
    (None, "float32"), (None, "bfloat16"), ((0, 1, 0, 1), "float32"),
    ((0, 1, 0, 1), "bfloat16")])
def test_staged_grads_match_pallas(groups, matmul_dtype):
    """The composition against the TPU kernel in interpret mode with the
    same ``matmul_dtype`` (and ``policy_groups``), on the JAX suites'
    inputs, the last minibatch; with bf16 operands the float32 composition
    lies outside the bound, so the rounding is there."""
    params, k_in, pk, p_in, gkw, M = pallas_case(groups)
    kw = dict(num_minibatches=M, clip_eps=mg.CLIP, value_coef=mg.VCOEF,
              mask_actions=True)
    (l_k, aux_k), g_k = ppo_minibatch_grads_pallas(
        params, *k_in, M - 1, mg.ENT, mg.KL, interpret=True,
        matmul_dtype=matmul_dtype, **kw, **pk)
    got = sgd.mlp_minibatch_grads_staged(*p_in, M - 1, mg.ENT, mg.KL,
                                         matmul_dtype=matmul_dtype, **gkw,
                                         **kw)
    assert_losses(got[0], (l_k, aux_k))
    want = params_from_flax(jax.tree.map(np.asarray, g_k))
    bf16 = matmul_dtype == "bfloat16"
    assert_grads(got[1], want, bf16, "against Pallas")
    if bf16:
        f32 = sgd.mlp_minibatch_grads_staged(*p_in, M - 1, mg.ENT, mg.KL,
                                             **gkw, **kw)[1]
        assert norm_ratio(f32, want) > 1.0


@pytest.mark.parametrize("stage", sgd.STAGES)
def test_mlp_stage_runs_the_plain_stage_on_the_cpu(stage):
    """``mlp_stage`` on CPU tensors is its plain stage on the plain chain's
    rows and launches no kernel; the chain's rows have the shapes the
    kernels' workspace views give (3 hidden layers of 12 on a 13-wide
    observation, the groups ``(0, 1, 1)``, bf16)."""
    groups = (0, 1, 1)
    params, traj, adv_n, tgt, M = setup(3, seed=5, A=3, groups=groups)
    rows, counts = sgd.minibatch_rows(traj, adv_n, tgt, 0, M, groups)
    N = traj.obs.shape[0] * traj.obs.shape[1] // M * 3
    assert counts == [N // 3, 2 * N // 3]
    # Group 0's rows first: agent 0 of each (step, env); then agents 1, 2.
    w = traj.obs.shape[1] // M
    assert torch.equal(rows[0][:counts[0]],
                       traj.obs[:, :w, 0].reshape(-1, 13))
    assert torch.equal(rows[1][counts[0]:],
                       traj.action[:, :w, 1:].reshape(-1))
    chain, want = sgd.plain_stage_chain(params, rows, counts, ENT, KL,
                                        bf16=True, **HYPER)
    shapes = {f"{k}{i}": (N, 12) for k in ("act", "dz") for i in range(3)}
    assert {k: v.shape for k, v in chain.items()} == {**shapes,
                                                       "dout": (N, 6)}
    before = sgd.mlp_stage.launches
    out = sgd.mlp_stage(stage, params, traj, adv_n, tgt, 0, ENT, KL,
                        sgd.stage_inputs(stage, params, chain),
                        num_minibatches=M, policy_groups=groups,
                        matmul_dtype="bfloat16", **HYPER)
    assert sgd.mlp_stage.launches == before
    assert out.keys() == want[stage].keys()
    for k, v in want[stage].items():
        if k == "losses":
            assert all(torch.equal(a, b) for a, b in zip(out[k], v))
        else:
            assert torch.equal(out[k], v), k
    if stage == "wgrad":
        assert all(out[k].shape == params[k].shape for k in params)


def test_mlp_stage_refuses_an_unknown_stage():
    params, traj, adv_n, tgt, M = setup(1)
    with pytest.raises(ValueError, match="stage must be one of"):
        sgd.mlp_stage("fold", params, traj, adv_n, tgt, 0, ENT, KL, {},
                      num_minibatches=M, **HYPER)

"""The recurrent learner's stages (``kernels/sgd_rnn.py``), plain, against
the twin and the JAX package on the CPU.

K9's gradient runs on the card as six stage kernels (``csrc/sgd_rnn.cu``:
encoder forward, recurrence forward, head and loss, recurrence backward,
encoder backward, weight gradients), each with a plain PyTorch version that
takes and gives the same rows. Here their composition is held against the
plain twin (``ppo_rnn_minibatch_grads_reference``: autograd through the
T-step replay) for the GRU and the LSTM, 1 and 2 encoder layers, float32
and bf16 operands, and against ``ppo_rnn_minibatch_grads_pallas`` in
interpret mode. Inputs come from numpy seeds. The stage kernels themselves
are held against these plain stages on the card
(``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest
import torch

import test_sgd_rnn_kernel as jt
from warehouse_tpu.pallas.sgd_rnn import ppo_rnn_minibatch_grads_pallas
from warehouse_tpu_torch.kernels import sgd_rnn
from warehouse_tpu_torch.models.policy import ActorCriticRNN
from warehouse_tpu_torch.train import Transition

from test_torch_sgd_rnn import assert_tree, port_inputs

ENT, KL = 0.01, 0.05
HYPER = dict(clip_eps=0.2, value_coef=0.5, mask_actions=True)
# Grads against the twin and the Pallas kernel: the JAX suite's bounds
# (tests/test_sgd_rnn_kernel.py:237-244), float32 sums in another order;
# the loss terms within 1e-6. bf16 operands in norm, as chip_smoke.py
# holds them (BF16_GRAD_REL): a float32 value one ulp off can round to the
# neighbouring bf16 operand.
GRAD_TOL, LOSS_ATOL, BF16_GRAD_REL = (1e-4, 1e-6), 1e-6, 2e-4


def setup(cell: str, n_enc: int, seed: int = 0, T: int = 4, B: int = 8,
          A: int = 2, D: int = 13, H: int = 8, M: int = 2):
    """A recurrent policy (encoder widths 12, hidden H) and a masked
    trajectory ``[T, B, A]`` of random observations with a random carry,
    all from a numpy seed."""
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
    old_v = rng.normal(size=(T, B, A)).astype(np.float32)
    traj = Transition(
        t(rng.normal(size=(T, B, A, D)).astype(np.float32)), t(action),
        t((-1.6 + 0.1 * rng.normal(size=(T, B, A))).astype(np.float32)),
        t(old_v), torch.zeros(T, B, A), torch.zeros(T, B, A, dtype=bool),
        t(mask), torch.zeros(T, B, A))
    tgt = t(rng.normal(size=(T, B, A)).astype(np.float32))
    h = t((0.5 * rng.normal(size=(B, A, H))).astype(np.float32))
    carry = ((t((0.5 * rng.normal(size=(B, A, H))).astype(np.float32)), h)
             if cell == "lstm" else h)
    model = ActorCriticRNN(D, 5, cell, (12,) * n_enc, H,
                           torch.Generator().manual_seed(seed + 1))
    params = {k: v.detach() for k, v in model.state_dict().items()}
    return params, traj, t(adv_n), tgt, carry, M


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


CASES = [(cell, n_enc, dtype) for cell in ("gru", "lstm")
         for n_enc in (1, 2) for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("cell,n_enc,matmul_dtype", CASES)
def test_staged_grads_match_twin(cell, n_enc, matmul_dtype):
    """The six plain stages composed equal the plain twin (autograd through
    the T-step replay from the carry), every minibatch."""
    params, traj, adv_n, tgt, carry, M = setup(cell, n_enc)
    for mb in range(M):
        kw = dict(num_minibatches=M, matmul_dtype=matmul_dtype, **HYPER)
        got = sgd_rnn.rnn_minibatch_grads_staged(params, traj, adv_n, tgt,
                                                 carry, mb, ENT, KL, **kw)
        want = sgd_rnn.ppo_rnn_minibatch_grads_reference(
            params, traj, adv_n, tgt, carry, mb, ENT, KL, **kw)
        assert_losses(got[0], want[0])
        assert_grads(got[1], want[1], matmul_dtype == "bfloat16",
                     f"mb={mb}")


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_staged_grads_match_twin_ragged(cell):
    """The same on a minibatch of 15 sequences of 5 steps (3 agents, 5 envs:
    no tile of 32 sequences or 64 rows full), 3 encoder layers, a hidden
    width of 12 and an observation width of 7."""
    params, traj, adv_n, tgt, carry, M = setup(cell, 3, seed=4, T=5, B=10,
                                               A=3, D=7, H=12)
    kw = dict(num_minibatches=M, **HYPER)
    got = sgd_rnn.rnn_minibatch_grads_staged(params, traj, adv_n, tgt, carry,
                                             1, ENT, KL, **kw)
    want = sgd_rnn.ppo_rnn_minibatch_grads_reference(params, traj, adv_n, tgt,
                                                     carry, 1, ENT, KL, **kw)
    assert_losses(got[0], want[0])
    assert_grads(got[1], want[1], False, "ragged")


@pytest.mark.parametrize("cell,matmul_dtype", [("gru", "float32"),
                                               ("lstm", "bfloat16")])
def test_staged_grads_match_pallas(cell, matmul_dtype):
    """The composition against the TPU kernel in interpret mode with the
    same ``matmul_dtype`` on the JAX suite's inputs (masked, 2 encoder
    layers), minibatch 1; with bf16 operands the float32 composition lies
    outside the bound, so the rounding is there."""
    _, params, _, _, opt_state, data, h0 = jt._setup(True, 2, seed=3,
                                                     cell=cell)
    obs_bm, fields, h0_rows = jt._kernel_inputs(data, h0)
    p, _, traj, adv_n, tgt, carry = port_inputs(params, opt_state, data, h0)
    kw = dict(num_minibatches=jt.M, clip_eps=jt.CLIP, value_coef=jt.VCOEF,
              mask_actions=True)
    (l_k, aux_k), g_k = ppo_rnn_minibatch_grads_pallas(
        params, obs_bm, fields, h0_rows, 1, jt.ENT, jt.KL,
        unroll_length=jt.T, num_agents=jt.A, obs_dim=jt.D, block_envs=8,
        interpret=True, matmul_dtype=matmul_dtype, **kw)
    got = sgd_rnn.rnn_minibatch_grads_staged(p, traj, adv_n, tgt, carry, 1,
                                             jt.ENT, jt.KL,
                                             matmul_dtype=matmul_dtype, **kw)
    assert_losses(got[0], ((l_k, aux_k)))
    if matmul_dtype == "float32":
        assert_tree(got[1], g_k, *GRAD_TOL, "grads")
        return
    from warehouse_tpu_torch.models import params_from_flax
    want = params_from_flax(jax.tree.map(np.asarray, g_k))
    assert norm_ratio(got[1], want) <= 1.0
    f32 = sgd_rnn.rnn_minibatch_grads_staged(p, traj, adv_n, tgt, carry, 1,
                                             jt.ENT, jt.KL, **kw)[1]
    assert norm_ratio(f32, want) > 1.0


@pytest.mark.parametrize("stage", sgd_rnn.STAGES)
def test_rnn_stage_runs_the_plain_stage_on_the_cpu(stage):
    """``rnn_stage`` on CPU tensors is its plain stage on the plain chain's
    rows and launches no kernel; the chain's rows have the shapes the
    kernels' workspace views give (LSTM, bf16, 2 encoder layers)."""
    params, traj, adv_n, tgt, carry, M = setup("lstm", 2, seed=5)
    rows, mb_carry = sgd_rnn.minibatch_rows(traj, adv_n, tgt, carry, 0, M)
    T, N, H = traj.obs.shape[0], traj.obs.shape[1] // M * 2, 8
    chain, want = sgd_rnn.plain_stage_chain(params, rows, mb_carry, ENT, KL,
                                            bf16=True, **HYPER)
    shapes = {"act0": (T * N, 12), "act1": (T * N, 12), "gi": (T * N, 4 * H),
              "hs": ((T + 1) * N, H), "cs": ((T + 1) * N, H),
              "gates": (T * N, 4 * H), "dout": (T * N, 6),
              "dhead": (T * N, H), "dp": (T * N, 4 * H),
              "dx": (T * N, 4 * H), "dz0": (T * N, 12), "dz1": (T * N, 12)}
    assert {k: v.shape for k, v in chain.items()} == shapes
    assert torch.equal(chain["hs"][:N], mb_carry[1])
    assert torch.equal(chain["cs"][:N], mb_carry[0])
    assert torch.equal(chain["dx"], chain["dp"])  # the LSTM's
    before = sgd_rnn.rnn_stage.launches
    out = sgd_rnn.rnn_stage(stage, params, traj, adv_n, tgt, carry, 0, ENT,
                            KL, sgd_rnn.stage_inputs(stage, params, chain),
                            num_minibatches=M, matmul_dtype="bfloat16",
                            **HYPER)
    assert sgd_rnn.rnn_stage.launches == before
    assert out.keys() == want[stage].keys()
    for k, v in want[stage].items():
        if k == "losses":
            assert all(torch.equal(a, b) for a, b in zip(out[k], v))
        else:
            assert torch.equal(out[k], v), k
    if stage == "wgrad":
        assert all(out[k].shape == params[k].shape for k in params)


def test_rnn_stage_refuses_an_unknown_stage():
    params, traj, adv_n, tgt, carry, M = setup("gru", 1)
    with pytest.raises(ValueError, match="stage must be one of"):
        sgd_rnn.rnn_stage("fold", params, traj, adv_n, tgt, carry, 0, ENT,
                          KL, {}, num_minibatches=M, **HYPER)

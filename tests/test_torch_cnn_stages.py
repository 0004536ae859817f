"""The CNN learner's stages (``kernels/sgd_cnn.py``), plain, against the
JAX package on the CPU.

K12's gradient runs on the card as five stage kernels (``csrc/sgd_cnn.cu``:
conv forward, trunk forward + loss, trunk dgrad, conv backward, trunk
weight gradients), each with a plain PyTorch version that takes and gives
the same rows. Here their composition is held against the plain twin
(``ppo_cnn_minibatch_grads_reference``: autograd through the true
convolutions) and against ``ppo_cnn_minibatch_grads_pallas`` in interpret
mode, at S = 5 (the small preset's ego window, hidden 16) and S = 9 (the
medium preset's global view, 5 channels, hidden 16), in float32 and with
bf16 operands (``matmul_dtype="bfloat16"``). Inputs come from numpy seeds.
The stage kernels themselves are held against these plain stages on the
card (``tests/test_torch_kernels_gpu.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.config import TrainConfig, medium_config, small_config
from warehouse_tpu.models import make_model as j_make_model
from warehouse_tpu.pallas.act import _pad8
from warehouse_tpu.pallas.sgd import FIELD_ROWS
from warehouse_tpu.pallas.sgd_cnn import ppo_cnn_minibatch_grads_pallas
from warehouse_tpu_torch.kernels import sgd_cnn
from warehouse_tpu_torch.models.policy import bf16_round, cnn_dims

from test_torch_sgd import assert_tree, port_inputs

T, B, M, H = 2, 16, 2, 16
HYPER = dict(num_minibatches=M, clip_eps=0.2, value_coef=0.5,
             mask_actions=True)
ENT, KL = 0.01, 0.05
CASES = {"S5": small_config(), "S9": medium_config(global_obs=True)}
DTYPES = ("float32", "bfloat16")
# Grads against the twin and the Pallas kernel: the JAX suite's bounds for
# the TPU kernel (tests/test_sgd_cnn_kernel.py), float32 sums in another
# order; the loss terms within 1e-6.
GRAD_TOL, LOSS_ATOL = (1e-4, 1e-6), 1e-6


def setup(name: str, seed: int = 0):
    """A flax CNN of hidden 16 and a masked trajectory ``[T, B, A]`` of
    random observations, as ``tests/test_sgd_cnn_kernel.py`` makes them."""
    cfg = CASES[name]
    A, D = cfg.num_agents, cfg.obs_dim
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, A, D)).astype(np.float32)
    action = rng.integers(0, 5, size=(T, B, A)).astype(np.int32)
    old_lp = (-1.6 + 0.1 * rng.normal(size=(T, B, A))).astype(np.float32)
    old_v = rng.normal(size=(T, B, A)).astype(np.float32)
    adv = rng.normal(size=(T, B, A)).astype(np.float32)
    tgt = rng.normal(size=(T, B, A)).astype(np.float32)
    mask = rng.random(size=(T, B, A, 5)) > 0.3
    mask[..., 0] = True
    np.put_along_axis(mask, action[..., None].astype(np.int64), True, -1)
    g = adv.reshape(T, M, B // M, A)
    adv_n = ((g - g.mean(axis=(0, 2, 3), keepdims=True))
             / (g.std(axis=(0, 2, 3), keepdims=True) + 1e-8)).reshape(T, B,
                                                                    A)
    model = j_make_model(cfg, arch="cnn", hidden_dim=H)
    params = model.init(jax.random.PRNGKey(seed + 1),
                        jnp.zeros((1, D), jnp.float32))
    data = tuple(jnp.asarray(x) for x in (obs, action, old_lp, old_v, adv_n,
                                          tgt, mask))
    return cfg, params, data


def pallas_grads(cfg, params, data, mb, matmul_dtype):
    """``ppo_cnn_minibatch_grads_pallas`` in interpret mode on ``data``
    laid out as the TPU kernel takes it (``_kernel_inputs`` there)."""
    obs, action, old_lp, old_v, adv_n, tgt, mask = data
    A, D = cfg.num_agents, cfg.obs_dim
    Dp = _pad8(D)
    obs_bm = jnp.pad(obs.transpose(0, 2, 3, 1),
                     ((0, 0), (0, 0), (0, Dp - D), (0, 0))).reshape(
                         T * A * Dp, B)

    def row(x):
        return x.transpose(0, 2, 1).reshape(T * A, B)

    frows = [row(action.astype(jnp.float32)), row(old_lp), row(old_v),
             row(adv_n), row(tgt)]
    frows += [row(mask[..., r].astype(jnp.float32)) for r in range(5)]
    frows += [jnp.zeros((T * A, B), jnp.float32)] * (FIELD_ROWS - len(frows))
    fields = jnp.stack(frows, axis=1).reshape(T * A * FIELD_ROWS, B)
    tcfg = TrainConfig(num_envs=B, unroll_length=T, num_minibatches=M,
                       ppo_epochs=1, hidden_dim=H)
    return ppo_cnn_minibatch_grads_pallas(
        params, obs_bm, fields, mb, ENT, KL, env_cfg=cfg, tcfg=tcfg,
        obs_dim=D, block_envs=B // M, interpret=True,
        matmul_dtype=jnp.bfloat16 if matmul_dtype == "bfloat16"
        else jnp.float32, **HYPER)


def staged(p0, traj, adv_n, tgt, mb, matmul_dtype):
    return sgd_cnn.cnn_minibatch_grads_staged(
        p0, traj, adv_n, tgt, mb, ENT, KL, matmul_dtype=matmul_dtype,
        **HYPER)


def assert_losses(got, want):
    (l_a, aux_a), (l_b, aux_b) = got, want
    for a, b in zip((l_a, *aux_a), (l_b, *aux_b)):
        assert abs(float(a) - float(b)) < LOSS_ATOL


@pytest.mark.parametrize("matmul_dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_grads_match_twin(name, matmul_dtype):
    """The five plain stages composed equal the plain twin (autograd
    through the true convolutions), every minibatch."""
    cfg, params, data = setup(name)
    p0, traj, adv_n, tgt = port_inputs(params, None, data)
    assert cnn_dims(p0)[0] == (5 if name == "S5" else 9)
    for mb in range(M):
        (l_s, aux_s), g_s = staged(p0, traj, adv_n, tgt, mb, matmul_dtype)
        (l_r, aux_r), g_r = sgd_cnn.ppo_cnn_minibatch_grads_reference(
            p0, traj, adv_n, tgt, mb, ENT, KL, matmul_dtype=matmul_dtype,
            **HYPER)
        assert_losses((l_s, aux_s), (l_r, aux_r))
        assert g_s.keys() == g_r.keys()
        for k in g_r:
            torch.testing.assert_close(g_s[k], g_r[k], rtol=GRAD_TOL[0],
                                       atol=GRAD_TOL[1], msg=f"mb={mb} {k}")


@pytest.mark.parametrize("matmul_dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(CASES))
def test_staged_grads_match_pallas(name, matmul_dtype):
    """The composition against the TPU kernel in interpret mode (the
    unrolled-dense convolutions and the conv-basis fold), with the same
    ``matmul_dtype``, on minibatch 1; with bf16 operands the float32
    composition lies outside the bound, so the rounding is there."""
    cfg, params, data = setup(name, seed=3)
    p0, traj, adv_n, tgt = port_inputs(params, None, data)
    want = pallas_grads(cfg, params, data, 1, matmul_dtype)
    got = staged(p0, traj, adv_n, tgt, 1, matmul_dtype)
    assert_losses(got[0], want[0])
    assert_tree(got[1], want[1], *GRAD_TOL, "grads")
    if matmul_dtype == "bfloat16":
        f32 = staged(p0, traj, adv_n, tgt, 1, "float32")[1]
        with pytest.raises(AssertionError):
            assert_tree(f32, want[1], *GRAD_TOL, "grads")


@pytest.mark.parametrize("stage", sgd_cnn.STAGES)
def test_cnn_stage_runs_the_plain_stage_on_the_cpu(stage):
    """``cnn_stage`` on CPU tensors is its plain stage on the plain chain's
    rows, launches no kernel; the chain's rows have the kernels' shapes
    (bf16: the conv outputs stored rounded; d1 zero where a1 is not
    positive) and the gradients their params' shapes."""
    cfg, params, data = setup("S9", seed=5)
    p0, traj, adv_n, tgt = port_inputs(params, None, data)
    rows = sgd_cnn.minibatch_rows(traj, adv_n, tgt, 0, M)
    N, (S, (C0, C1, C2), _) = rows[0].shape[0], cnn_dims(p0)
    chain, want = sgd_cnn.plain_stage_chain(
        p0, rows, ENT, KL, bf16=True, clip_eps=0.2, value_coef=0.5,
        mask_actions=True)
    shapes = {"a0": (N, S * S * C1), "a1": (N, S * S * C2 + 6), "h": (N, H),
              "dout": (N, 6), "dzt": (N, H), "d1": (N, S * S * C2)}
    assert {k: v.shape for k, v in chain.items()} == shapes
    a0, a1, d1 = chain["a0"], chain["a1"], chain["d1"]
    assert torch.equal(a1, bf16_round(a1)) and torch.equal(a0, bf16_round(a0))
    assert bool((d1[a1[:, :S * S * C2] <= 0] == 0).all())
    before = sgd_cnn.cnn_stage.launches
    out = sgd_cnn.cnn_stage(stage, p0, traj, adv_n, tgt, 0, ENT, KL, chain,
                            matmul_dtype="bfloat16", **HYPER)
    assert sgd_cnn.cnn_stage.launches == before
    assert out.keys() == want[stage].keys()
    for k, v in want[stage].items():
        if k == "losses":
            assert all(torch.equal(a, b) for a, b in zip(out[k], v))
        else:
            assert torch.equal(out[k], v), k
    keys = {"conv_bwd": sgd_cnn.CONV_KEYS, "trunk_wgrad": sgd_cnn.DENSE_KEYS}
    if stage in keys:
        assert tuple(out) == keys[stage]
        assert all(out[k].shape == p0[k].shape for k in out)


def test_cnn_stage_refuses_an_unknown_stage():
    _, params, data = setup("S5")
    p0, traj, adv_n, tgt = port_inputs(params, None, data)
    with pytest.raises(ValueError, match="stage must be one of"):
        sgd_cnn.cnn_stage("fold", p0, traj, adv_n, tgt, 0, ENT, KL, {},
                          **HYPER)

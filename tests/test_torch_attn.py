"""The attention torso (``models.policy.ActorCriticAttn``, ROADMAP M-7) on
the CPU, against flax's ``ActorCriticAttn`` and the JAX PPO trainer.

- The forward alone through ``params_from_flax``: the ego window (hidden 16
  and config 4's 128) and the global view, float32 within 1e-5 of flax's
  ``apply``. The flax-bf16 forward: whole, in norm (logits and values
  within 3% of flax's bf16 model in relative norm: XLA:CPU rounds its bf16
  gelu in an order no per-op rounding reproduces); with the gelu computed
  in float32 and rounded once on both sides, every other part (the bf16
  Dense layers, LayerNorm, the attention's products and softmax) within
  1e-3, a bound the float32 forward fails (it lies 0.6-2.0% from flax's
  bf16 model); the bf16 gelu alone within 1e-3 of XLA's in norm.
- ``params_from_flax`` of the attention tree: its shapes, its errors, and
  a ``policies_g`` tree of attention torsos; the port's initialisation
  (unit LayerNorm scales, zero biases, ``pos_embed`` normal(0.02)).
- The PPO trainer with ``arch="attn"``, one shared policy and policy groups
  ``(1, 0)``, against the JAX trainer's XLA route for 3 updates across an
  episode end inside a chunk (``tests/test_torch_step_acting.py``'s
  bounds): both phases plain, acting per step.
- The CLI with ``--arch attn``, its checkpoint served by
  ``Policy.from_checkpoint`` and evaluated by ``evaluate --arch attn``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from warehouse_tpu.config import TrainConfig, medium_config, small_config
from warehouse_tpu.models.policy import make_model as j_make_model
from warehouse_tpu.models.policy import make_multi_policy_model as j_make_multi
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.evaluate import main as eval_main
from warehouse_tpu_torch.models import make_model, params_from_flax
from warehouse_tpu_torch.models.policy import apply
from warehouse_tpu_torch.serve import Policy
from warehouse_tpu_torch.train import make_train, runner_state_from_jax
from warehouse_tpu_torch.train.__main__ import main as cli_main

from test_torch_step_acting import (RAGGED, STEP_PLAIN, assert_learned,
                                    run_ragged)

BF16_REL = 3e-2  # relative norm of the flax-bf16 forward's outputs
PARTS_REL = 1e-3  # the same, the gelu in float32 on both sides


def flax_attn(cfg, hidden, layers, dtype=jnp.float32, seed=1):
    model = j_make_model(cfg, "attn", hidden, layers, dtype=dtype)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, cfg.obs_dim)))
    return model, params


def observations(cfg, n=64, seed=0):
    """Grid cells of 0 / 1 and self features in [0, 1), as float32."""
    r = np.random.default_rng(seed)
    obs = r.integers(0, 2, (n, 3, cfg.obs_dim)).astype(np.float32)
    obs[..., -6:] = r.random((n, 3, 6))
    return obs


def rel_norm(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


VIEWS = {"ego_16": (small_config(), 16, 2),
         "ego_config4": (medium_config(), 128, 2),
         "global_16": (small_config(global_obs=True), 16, 1)}


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_attn_forward_matches_flax(view):
    cfg, hidden, layers = VIEWS[view]
    model, params = flax_attn(cfg, hidden, layers)
    sd = params_from_flax(jax.tree.map(np.asarray, params))
    obs = observations(cfg)
    jl, jv = model.apply(params, obs)
    tl, tv = apply(sd, torch.from_numpy(obs))
    assert tl.shape == (64, 3, 5) and tv.shape == (64, 3)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    # The port's own module gives the same outputs from the same params.
    m = make_model(cfg, "attn", hidden, layers, device="cpu")
    m.load_state_dict(sd)
    with torch.no_grad():
        ml, mv = m(torch.from_numpy(obs))
    assert torch.equal(ml, tl) and torch.equal(mv, tv)


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_attn_bf16_forward_matches_flax_in_norm(view):
    cfg, hidden, layers = VIEWS[view]
    model, params = flax_attn(cfg, hidden, layers, jnp.bfloat16)
    sd = params_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                       params))
    obs = observations(cfg, seed=1)
    jl, jv = model.apply(params, obs)
    tl, tv = apply(sd, torch.from_numpy(obs), precision="flax_bf16")
    assert tl.dtype == torch.float32
    assert rel_norm(tl, jl) < BF16_REL and rel_norm(tv, jv) < BF16_REL
    m = make_model(cfg, "attn", hidden, layers, device="cpu",
                   dtype="bfloat16")
    m.load_state_dict(sd)
    with torch.no_grad():
        ml, _ = m(torch.from_numpy(obs))
    assert torch.equal(ml, tl)
    with pytest.raises(ValueError, match="bf16_operands"):
        apply(sd, torch.from_numpy(obs), precision="bf16_operands")


@pytest.mark.parametrize("view", sorted(VIEWS))
def test_attn_bf16_parts_match_flax(view, monkeypatch):
    """The flax-bf16 forward with the one part that XLA:CPU rounds its own
    way, the gelu, computed in float32 and rounded to bf16 once on both
    sides: the port's bf16 Dense layers, LayerNorm, attention products and
    softmax hold flax's within ``PARTS_REL``, which the float32 forward
    does not."""
    import flax.linen as nn
    import warehouse_tpu_torch.models.policy as tp
    j_gelu, t_gelu = nn.gelu, tp._gelu
    monkeypatch.setattr(nn, "gelu", lambda y, approximate=True: j_gelu(
        y.astype(jnp.float32), approximate=approximate).astype(y.dtype))
    monkeypatch.setattr(tp, "_gelu", lambda x: t_gelu(x.float()).to(x.dtype))
    cfg, hidden, layers = VIEWS[view]
    model, params = flax_attn(cfg, hidden, layers, jnp.bfloat16)
    sd = params_from_flax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                       params))
    obs = observations(cfg, seed=1)
    jl, jv = model.apply(params, obs)
    tl, tv = apply(sd, torch.from_numpy(obs), precision="flax_bf16")
    fl, fv = apply(sd, torch.from_numpy(obs))
    assert rel_norm(tl, jl) < PARTS_REL and rel_norm(tv, jv) < PARTS_REL
    assert rel_norm(fl, jl) > PARTS_REL and rel_norm(fv, jv) > PARTS_REL


def test_attn_bf16_gelu_matches_xla_in_norm():
    """The port's bf16 gelu (``jax.nn.gelu``'s operations, each rounded to
    bf16) against XLA:CPU's on the same bf16 inputs, within ``PARTS_REL``
    in relative norm: the one part of the bf16 forward held in norm."""
    from warehouse_tpu_torch.models.policy import _gelu
    x = np.random.default_rng(0).normal(size=4096).astype(np.float32) * 3
    xb = torch.from_numpy(x).bfloat16()
    jg = jax.nn.gelu(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                     approximate=True)
    assert jg.dtype == jnp.bfloat16
    assert rel_norm(_gelu(xb).float(), jg.astype(jnp.float32)) < PARTS_REL


def test_attn_params_from_flax_shapes_init_and_errors():
    cfg = small_config()
    _, params = flax_attn(cfg, 16, 2)
    p = jax.tree.map(np.asarray, params)
    sd = params_from_flax(p)
    m = make_model(cfg, "attn", 16, 2, device="cpu",
                   generator=torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert sd["blocks.1.q.weight"].shape == (8, 8)
    assert sd["blocks.0.mlp_in.weight"].shape == (32, 8)
    assert sd["pos_embed"].shape == (25, 8)
    # Initialisation: LayerNorm scales 1, biases 0, pos_embed ~ N(0, 0.02).
    own = m.state_dict()
    assert all(bool((own[k] == 1).all()) for k in own
               if ".ln" in f".{k}" and k.endswith("weight"))
    assert all(bool((own[k] == 0).all()) for k in own if k.endswith("bias"))
    big = make_model(medium_config(), "attn", 128, 2, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert 0.015 < float(big.pos_embed.detach().std()) < 0.025
    # A tree that lacks a block's layer, or a kernel of another shape.
    broken = {k: v for k, v in p["params"].items() if k != "LayerNorm_3"}
    with pytest.raises(ValueError, match="attention"):
        params_from_flax(broken)
    bad = jax.tree.map(lambda x: x, p)
    bad["params"]["MultiHeadDotProductAttention_0"]["query"]["kernel"] = (
        np.zeros((8, 2, 4), np.float32))
    with pytest.raises(ValueError, match="query"):
        params_from_flax(bad)
    # The global view takes the whole (square) grid, as flax's make_model.
    with pytest.raises(ValueError, match="square"):
        make_model(small_config(global_obs=True, height=6, width=8), "attn",
                   device="cpu")
    # The policies_g tree of two attention torsos.
    mm = j_make_multi(cfg, (1, 0), "attn", 16, 2)
    gp = mm.init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.obs_dim)),
                 jnp.zeros(1, jnp.int32))
    gsd = params_from_flax(jax.tree.map(np.asarray, gp))
    assert "policies.1.pos_embed" in gsd and "policies.0.ln_f.bias" in gsd


@pytest.mark.parametrize("groups", [None, (1, 0)])
def test_attn_ppo_matches_jax_xla(groups):
    """Two blocks with one shared policy, one block in each of two
    groups."""
    tcfg = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                       num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                       num_layers=2 if groups is None else 1,
                       kl_coeff=0.1, entropy_coef_final=0.001)
    gkw = {} if groups is None else {"policy_groups": groups}
    jtr = j_make_train(RAGGED, tcfg, arch="attn", **gkw)
    tr = make_train(RAGGED, tcfg, arch="attn", device="cpu", **gkw)
    assert tr.backends == STEP_PLAIN
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    rs, jrs = run_ragged(jtr, tr, rs, jrs)
    assert_learned(rs, jrs)


def test_attn_cli_checkpoint_served_and_evaluated(tmp_path, capsys):
    ck = tmp_path / "ck"
    path = tmp_path / "m.jsonl"
    cli_main(["--arch", "attn", "--env", "small", "--env-config",
              '{"max_steps": 6}', "--num-envs", "8", "--unroll-length", "4",
              "--num-updates", "2", "--num-minibatches", "2",
              "--ppo-epochs", "1", "--hidden-dim", "16", "--log-every", "1",
              "--checkpoint-every", "2", "--checkpoint-dir", str(ck),
              "--cpu", "--metrics-path", str(path)])
    meta = json.loads(path.read_text().splitlines()[0])
    assert meta["arch"] == "attn" and meta["backends"] == STEP_PLAIN
    pol = Policy.from_checkpoint(str(ck), device="cpu")
    assert pol.arch == "attn" and pol.initial_state() is None
    obs = torch.from_numpy(observations(small_config(), n=5))[:, :2]
    acts, state = pol.compute_actions(obs)
    with torch.no_grad():
        logits, _ = pol.model(obs)
    assert state is None and torch.equal(acts, logits.argmax(-1).int())
    eval_main(["--env", "small", "--env-config", '{"max_steps": 6}', "--cpu",
               "--policy", "checkpoint", "--checkpoint-dir", str(ck),
               "--episodes", "4"])
    assert "mean_episode_return" in capsys.readouterr().out
    rs = make_train(small_config(max_steps=6), TrainConfig(
        num_envs=8, unroll_length=4, hidden_dim=16), arch="attn",
        device="cpu").init(rng.prng_key(0))
    assert set(rs.params) == set(pol.model.state_dict())

"""The learner options that no learner kernel computes (ROADMAP M-4), on
the CPU, against the JAX trainers' XLA learner.

Where a learner kernel refuses an option, the JAX trainer resolves its SGD
phase to XLA and keeps its acting kernel; the port runs that phase in
plain PyTorch (``train/ppo.py`` ``ppo_plain_phase``, ``train/ppo_rnn.py``
``rnn_plain_phase``, ``kernels/vtrace_sgd.py``
``impala_sgd_phase_reference`` with micro-batches and the optimizer's
step) and names the route in ``backends``. Held here:

- ``rng.permutation`` against ``jax.random.permutation`` at N = 262144
  (config 4's flat T * B * A), bit for bit: the per-epoch reshuffle of the
  flat minibatches draws it;
- each option against the JAX trainer on its XLA route for 3 updates from
  one carried-over state, across an episode boundary (max_steps 8, T = 4):
  PPO ``--rllib-cadence`` (flat minibatches, a partition per epoch), env
  minibatches with a partition per epoch, ``micro_batches=2``,
  ``flat_optimizer``, the rllib cadence with policy groups and with
  ``model_dtype="bfloat16"`` (the plain phase differentiates the flax-bf16
  model, as the JAX XLA learner does); the GRU with ``epoch_shuffle=
  "each"`` and with ``flat_optimizer``; IMPALA with ``micro_batches=2`` and
  with ``flat_optimizer``. Env state, obs and keys bit-equal after every
  update (so no action flipped and every key split is the JAX scaffold's),
  metrics within 2e-4 + 1e-3 relative, params and moments at the trainer
  tests' bounds (``tests/test_torch_train.py``); a flattened optax state is
  carried over by ``opt_state_from_optax`` and compared as one vector. The
  bf16 case holds params and moments in norm instead: XLA:CPU runs the
  flax-bf16 graph with some of its bf16 roundings simplified away (its
  bias gradients lie within 0.08% of the float32 ones, the port's one
  rounding per op 1-2% from them), and Adam carries each difference into
  every later step; measured, the params 0.28 and the first moment 0.67 of
  the bounds below (``BF16_NORM``);
- a flat-optimizer run resumed from a checkpoint bit-equal to the
  uninterrupted run;
- the two options the JAX trainers never read: the recurrent trainer's
  ``micro_batches`` and IMPALA's ``shaping_coef`` give the bits of a run
  without them;
- ``backends`` per configuration, and the CLI's meta line.
"""

import json

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from warehouse_tpu.config import TrainConfig, small_config
from warehouse_tpu.pallas.sgd import find_adam_state
from warehouse_tpu.train.impala import make_train_impala as j_make_impala
from warehouse_tpu.train.ppo import make_train as j_make_train
from warehouse_tpu.train.ppo_rnn import make_train_rnn as j_make_rnn
from warehouse_tpu_torch import rng
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.models import params_from_flax
from warehouse_tpu_torch.optim import FLAT, flatten, opt_state_from_optax
from warehouse_tpu_torch.train import (checkpoint, impala_runner_state_from_jax,
                                       make_train, make_train_impala,
                                       make_train_rnn, runner_state_from_jax,
                                       runner_state_rnn_from_jax)
from warehouse_tpu_torch.train.__main__ import main as cli_main
from warehouse_tpu_torch.train.ppo import grad_problems

from test_torch_rng import assert_bits

CFG = small_config(max_steps=8)
BASE = TrainConfig(num_envs=16, unroll_length=4, num_updates=3,
                   num_minibatches=2, ppo_epochs=2, hidden_dim=16,
                   kl_coeff=0.1, entropy_coef_final=0.001)
RLLIB = dict(minibatch_mode="flat", epoch_shuffle="each")
# (rel, atol) of the bf16 case: ||port - jax|| <= rel ||jax|| + atol sqrt(n)
BF16_NORM = {"params": (3e-3, 5e-5), "mu": (1e-2, 5e-6)}


def test_permutation_matches_jax_at_config4_size():
    """config 4's flat sample count, T * B * A = 16 * 4096 * 4: about 8
    ties among 2^18 32-bit sort keys per round, which a stable sort must
    break as XLA's does."""
    n = 16 * 4096 * 4
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        assert_bits(jax.random.permutation(key, n),
                    rng.permutation(rng.prng_key(seed), n), f"seed {seed}")


def moments(state, jrs_opt, jparams):
    """(port mu, JAX mu as the port's layout) for a plain or flat state."""
    want = opt_state_from_optax(jax.tree.map(np.asarray, jrs_opt),
                                params_like=jax.tree.map(np.asarray, jparams))
    return state.mu, want.mu


def assert_tree(port, want, rtol, atol, what):
    assert port.keys() == want.keys(), what
    for k in want:
        np.testing.assert_allclose(port[k].numpy(), want[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{what} {k}")


def assert_norm(port, want, rel, atol, what):
    for k in want:
        bound = rel * float(want[k].norm()) + atol * want[k].numel() ** 0.5
        assert float((port[k] - want[k]).norm()) <= bound, (what, k)


def run_against_jax(jtr, tr, rs, jrs, n=3):
    """n updates on both: env state, obs and keys bit-equal after each,
    metrics within 2e-4 + 1e-3 relative; the episode ends with update 2."""
    for u in range(n):
        jrs, jm = jtr.train_step(jrs)
        rs, m = tr.train_step(rs)
        for f in STATE_FIELDS:
            assert_bits(getattr(jrs.env_state, f), getattr(rs.env_state, f),
                        f"update {u} {f}")
        assert_bits(np.asarray(jrs.key).reshape(2), rs.key, f"update {u} key")
        assert_bits(jrs.obs, rs.obs, f"update {u} obs")
        assert bool((rs.env_state.t == 0).all()) == (u == 1)
        assert m.keys() == jm.keys()
        for k in jm:
            a, b = float(m[k]), float(jm[k])
            assert abs(a - b) < 2e-4 + 1e-3 * abs(b), (u, k, a, b)
    return rs, jrs


PPO_CASES = {
    "rllib_cadence": (RLLIB, None),
    "env_each": (dict(epoch_shuffle="each"), None),
    "micro2": (dict(micro_batches=2), None),
    "flat_optimizer": (dict(flat_optimizer=True), None),
    "rllib_groups": (dict(RLLIB, mask_actions=True), (1, 0)),
    "rllib_bf16": (dict(RLLIB, model_dtype="bfloat16"), None),
}


@pytest.mark.parametrize("case", sorted(PPO_CASES))
def test_ppo_plain_learner_matches_jax_xla(case):
    change, groups = PPO_CASES[case]
    tcfg = BASE.replace(**change)
    gkw = {} if groups is None else {"policy_groups": groups}
    jtr = j_make_train(CFG, tcfg, **gkw)
    assert jtr.backends["grad"] == "xla"
    tr = make_train(CFG, tcfg, device="cpu", **gkw)
    assert grad_problems(CFG, tcfg, "mlp", groups) and tr.backends == {
        "rollout": "plain", "grad": "plain"}
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = runner_state_from_jax(jax.tree.map(np.asarray, jrs))
    rs, jrs = run_against_jax(jtr, tr, rs, jrs)
    assert rs.opt_state.count == 3 * BASE.ppo_epochs * BASE.num_minibatches
    params = params_from_flax(jax.tree.map(np.asarray, jrs.params))
    mu, want = moments(rs.opt_state, jrs.opt_state, jrs.params)
    assert (FLAT in mu) == tcfg.flat_optimizer
    if tcfg.model_dtype == "bfloat16":
        assert tr.model.dtype == torch.bfloat16
        assert_norm(rs.params, params, *BF16_NORM["params"], "params")
        assert_norm(mu, want, *BF16_NORM["mu"], "mu")
        return
    assert_tree(rs.params, params, 2e-4, 5e-5, "params")
    assert_tree(mu, want, 2e-4, 5e-6, "mu")


RNN_CASES = {"each": dict(epoch_shuffle="each"),
             "flat_optimizer": dict(flat_optimizer=True)}


@pytest.mark.parametrize("case", sorted(RNN_CASES))
def test_rnn_plain_learner_matches_jax_xla(case):
    """The GRU: K7's twin acts (the state not permuted with "each"), the
    T-step replay learns from each minibatch's slice of the carry."""
    tcfg = BASE.replace(num_envs=8, **RNN_CASES[case])
    jtr = j_make_rnn(CFG, tcfg, arch="gru")
    tr = make_train_rnn(CFG, tcfg, arch="gru", device="cpu")
    assert tr.backends == {"rollout": "plain", "grad": "plain"}
    jrs = jtr.init(jax.random.PRNGKey(1))
    rs = runner_state_rnn_from_jax(jax.tree.map(np.asarray, jrs))
    rs, jrs = run_against_jax(jtr, tr, rs, jrs)
    np.testing.assert_allclose(rs.carry.numpy(), np.asarray(jrs.carry),
                               rtol=0, atol=1e-5)
    assert_tree(rs.params, params_from_flax(jax.tree.map(np.asarray,
                                                         jrs.params)),
                2e-4, 5e-5, "params")
    mu, want = moments(rs.opt_state, jrs.opt_state, jrs.params)
    assert_tree(mu, want, 2e-4, 5e-6, "mu")


IMPALA_CASES = {"micro2": dict(micro_batches=2),
                "flat_optimizer": dict(flat_optimizer=True)}


@pytest.mark.parametrize("case", sorted(IMPALA_CASES))
def test_impala_plain_learner_matches_jax_xla(case):
    tcfg = BASE.replace(impala_rmsprop=False, **IMPALA_CASES[case])
    jtr = j_make_impala(CFG, tcfg)
    tr = make_train_impala(CFG, tcfg, device="cpu")
    jrs = jtr.init(jax.random.PRNGKey(0))
    rs = impala_runner_state_from_jax(jax.tree.map(np.asarray, jrs), tcfg)
    rs, jrs = run_against_jax(jtr, tr, rs, jrs)
    assert_tree(rs.params, params_from_flax(jax.tree.map(np.asarray,
                                                         jrs.params)),
                2e-4, 5e-5, "params")
    mu, want = moments(rs.opt_state, jrs.opt_state, jrs.params)
    assert_tree(mu, want, 2e-4, 5e-6, "mu")


def test_flat_optax_state_carries_over():
    """A flattened optax Adam state becomes the port's flat state: the
    moments of the flax leaves, in the port's key order."""
    jtr = j_make_train(CFG, BASE.replace(flat_optimizer=True))
    jrs = jtr.init(jax.random.PRNGKey(2))
    jrs, _ = jtr.train_step(jrs)
    _, mu, nu = find_adam_state(jrs.opt_state)
    assert np.asarray(mu).ndim == 1
    st = opt_state_from_optax(jax.tree.map(np.asarray, jrs.opt_state),
                              params_like=jax.tree.map(np.asarray,
                                                       jrs.params))
    # Unflattened through the flax tree, then flattened the port's way:
    # the same vector.
    _, unravel = ravel_pytree(jrs.params)
    want = flatten(params_from_flax(jax.tree.map(np.asarray, unravel(nu))))
    assert_bits(want[FLAT].numpy(), st.nu[FLAT], "nu")
    assert st.count == BASE.ppo_epochs * BASE.num_minibatches
    with pytest.raises(ValueError, match="params_like"):
        opt_state_from_optax(jax.tree.map(np.asarray, jrs.opt_state))


@pytest.mark.parametrize("build", ["ppo", "impala"])
def test_flat_optimizer_resume_is_bit_equal(build, tmp_path):
    """2 updates, a checkpoint, 1 more; restored from the checkpoint, the
    third update gives the same bits."""
    tcfg = BASE.replace(flat_optimizer=True, impala_rmsprop=False)
    make = make_train if build == "ppo" else make_train_impala
    tr = make(CFG, tcfg, device="cpu")
    rs = tr.init(rng.prng_key(4))
    rs, _ = tr.train_many(rs, 2)
    checkpoint.save(str(tmp_path), 2, rs)
    end, _ = tr.train_step(rs)
    _, back = checkpoint.restore_latest(str(tmp_path),
                                        tr.init(rng.prng_key(5)))
    assert list(back.opt_state.mu) == [FLAT]
    again, _ = tr.train_step(back)
    for k in end.params:
        assert torch.equal(end.params[k], again.params[k]), k
    assert torch.equal(end.opt_state.nu[FLAT], again.opt_state.nu[FLAT])


@pytest.mark.parametrize("which", ["rnn_micro_batches", "impala_shaping"])
def test_ignored_options_change_nothing(which):
    """The JAX recurrent trainer never reads ``micro_batches`` and the JAX
    IMPALA trainer never reads ``shaping_coef``: the port's runs with them
    are bit-equal to runs without."""
    if which == "rnn_micro_batches":
        base = BASE.replace(num_envs=8)
        make = lambda t: make_train_rnn(CFG, t, arch="gru", device="cpu")
        other = base.replace(micro_batches=2)
    else:
        base = BASE.replace(impala_rmsprop=False)
        make = lambda t: make_train_impala(CFG, t, device="cpu")
        other = base.replace(shaping_coef=0.1)
    outs = []
    for tcfg in (base, other):
        tr = make(tcfg)
        assert tr.backends == {"rollout": "plain", "grad": "plain"}
        rs, ms = tr.train_many(tr.init(rng.prng_key(6)), 2)
        outs.append((rs, ms))
    (a, ma), (b, mb) = outs
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    for k in ma:
        assert torch.equal(ma[k], mb[k]), k


def test_backends_follow_the_configuration():
    """The options that send the PPO learner to the plain phase, named as
    the JAX trainer's ``_grad_problems`` names them."""
    assert grad_problems(CFG, BASE, "mlp", None) == []
    assert grad_problems(CFG, BASE, "cnn", None) == []
    assert grad_problems(CFG, BASE, "mlp", (0, 1)) == []
    assert grad_problems(CFG, BASE, "cnn", (0, 1)) == [
        "policy_groups with arch='cnn' (the CNN learner kernel is "
        "single-policy)"]
    for change in (dict(minibatch_mode="flat"), dict(epoch_shuffle="each"),
                   dict(micro_batches=2), dict(flat_optimizer=True)):
        assert len(grad_problems(CFG, BASE.replace(**change), "mlp",
                                 None)) == 1
    with pytest.raises(ValueError, match="micro_batches"):
        make_train(CFG, BASE.replace(micro_batches=3), device="cpu")


def test_cli_rllib_cadence_and_meta_line(tmp_path):
    """``--rllib-cadence --micro-batches 2`` trains 2 updates on the CPU;
    the meta line records the backends; IMPALA with ``--micro-batches 2``
    too."""
    for algo, flags in (("ppo", ["--rllib-cadence", "--micro-batches", "2"]),
                        ("impala", ["--impala-adam", "--micro-batches", "2"])):
        path = tmp_path / f"{algo}.jsonl"
        cli_main(["--cpu", "--algo", algo, "--env", "small", "--env-config",
                  '{"max_steps": 8}', "--num-envs", "16", "--unroll-length",
                  "4", "--num-updates", "2", "--num-minibatches", "2",
                  "--hidden-dim", "16", "--log-every", "1", "--metrics-path",
                  str(path), *flags])
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        assert recs[0]["backends"] == {"rollout": "plain", "grad": "plain"}
        steps = [r for r in recs[1:] if "loss" in r]
        assert [r["step"] for r in steps] == [1, 2]
        assert all(np.isfinite(r["loss"]) for r in steps)

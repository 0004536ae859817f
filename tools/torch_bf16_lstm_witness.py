#!/usr/bin/env python3
"""How far the recurrent learners' bf16 twins (K8 / K9's plain versions)
lie from the Pallas kernels with ``matmul_dtype="bfloat16"``, and how far
two bf16 computations that differ by float32 roundings lie from each
other, on the JAX suite's inputs at any hidden width.

    JAX_PLATFORMS=cpu python3 tools/torch_bf16_lstm_witness.py \
        [cell:width:seed ...]        (default lstm:50:0 ... lstm:50:5)

Runs on the CPU, as the tests do: the Pallas kernels in interpret mode
(``tests/test_sgd_rnn_kernel.py``'s ``_setup`` at that width and seed,
minibatches of 64 samples), the port's twins on CPU tensors. One JSON line
a case. For each minibatch's gradient, in units of 2e-4 in relative norm
(``||a - b|| / (2e-4 ||b||)``): the bf16 twin against the Pallas kernel,
the float32 twin against it, both against the bf16 twin run in float64
(the same roundings of the operands to bf16, the sums in float64), and the
bf16 twin moved by one float32 ulp of its params (12 random moves) against
itself. For the phase (E x M = 4 steps): params, mu and nu, the twin and
the float32 twin against the Pallas kernel in units of 3e-3 in relative
norm with the float32 bounds' atol.
"""

from __future__ import annotations

import json
import sys

sys.path.insert(0, "tests")
sys.path.insert(0, ".")

import conftest  # noqa: E402,F401  (JAX on the CPU)
import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_sgd_rnn_kernel as jt  # noqa: E402
from test_torch_rng import to_torch  # noqa: E402
from test_torch_sgd_rnn import port_inputs  # noqa: E402
from test_torch_widths import adam_rows  # noqa: E402
from warehouse_tpu.pallas.sgd import find_adam_state  # noqa: E402
from warehouse_tpu.pallas.sgd_rnn import (  # noqa: E402
    ppo_rnn_minibatch_grads_pallas, ppo_rnn_sgd_phase_pallas)
from warehouse_tpu_torch.kernels import sgd_rnn  # noqa: E402
from warehouse_tpu_torch.models import params_from_flax  # noqa: E402

GRAD_REL, PHASE_REL = 2e-4, 3e-3
ATOL = dict(params=1e-6, mu=1e-7, nu=1e-10)
BF = dict(matmul_dtype="bfloat16")


def to_port(tree) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in params_from_flax(
        jax.tree.map(np.asarray, tree)).items()}


def as_f64(x):
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: as_f64(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(as_f64, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(as_f64, x))
    return x


def ratio(a: dict, b: dict, rel: float, atol: float = 0.0) -> float:
    return max(float((a[k].double() - b[k].double()).norm()
                     / (rel * b[k].double().norm()
                        + atol * b[k].numel() ** 0.5)) for k in b)


def one_ulp(params: dict, seed: int) -> dict:
    """Each param moved by one float32 ulp, up or down at random."""
    g = torch.Generator().manual_seed(seed)
    return {k: torch.nextafter(v, torch.where(
        torch.rand(v.shape, generator=g) < 0.5, -torch.inf, torch.inf))
        for k, v in params.items()}


def case(cell: str, width: int, seed: int) -> dict:
    jt.H = width
    _, params, _, sched, opt_state, data, h0 = jt._setup(True, 1, seed=seed,
                                                         cell=cell)
    obs_bm, fields, h0_rows = jt._kernel_inputs(data, h0)
    p, opt, traj, adv_n, tgt, carry = port_inputs(params, opt_state, data,
                                                  h0)
    kw = dict(num_minibatches=jt.M, clip_eps=jt.CLIP, value_coef=jt.VCOEF,
              mask_actions=True)
    pk = dict(unroll_length=jt.T, num_agents=jt.A, obs_dim=jt.D,
              block_envs=8, interpret=True)

    def twin(pp, rest=(traj, adv_n, tgt, carry), **dt):
        return lambda mb: sgd_rnn.ppo_rnn_minibatch_grads_reference(
            pp, *rest, mb, jt.ENT, jt.KL, **dt, **kw)[1]
    out = {"cell": cell, "width": width, "seed": seed, "grads": []}
    for mb in range(jt.M):
        g_k = to_port(ppo_rnn_minibatch_grads_pallas(
            params, obs_bm, fields, h0_rows, mb, jt.ENT, jt.KL, **pk, **BF,
            **kw)[1])
        g_t = twin(p, **BF)(mb)
        g_d = twin(as_f64(p), as_f64((traj, adv_n, tgt, carry)), **BF)(mb)
        out["grads"].append({
            "mb": mb, "twin_vs_pallas": ratio(g_t, g_k, GRAD_REL),
            "f32_twin_vs_pallas": ratio(twin(p)(mb), g_k, GRAD_REL),
            "twin_vs_f64_sums": ratio(g_t, g_d, GRAD_REL),
            "pallas_vs_f64_sums": ratio(g_k, g_d, GRAD_REL),
            "one_ulp_twin_vs_twin": sorted(
                ratio(twin(one_ulp(p, 100 + i), **BF)(mb), g_t, GRAD_REL)
                for i in range(12))})
    rows = adam_rows(sched, opt_state, jt.E * jt.M)
    p_k, opt_k, _ = ppo_rnn_sgd_phase_pallas(
        params, opt_state, obs_bm, fields, h0_rows, *rows, jt.ENT, jt.KL,
        num_epochs=jt.E, max_grad_norm=jt.MAXNORM, **pk, **BF, **kw)
    _, mu_k, nu_k = find_adam_state(opt_k)
    want = dict(params=to_port(p_k), mu=to_port(mu_k), nu=to_port(nu_k))
    out["phase"] = {}
    for name, dt in (("twin_vs_pallas", BF), ("f32_twin_vs_pallas", {})):
        pt, ot, _ = sgd_rnn.ppo_rnn_sgd_phase(
            p, opt, traj, adv_n, tgt, carry, *(to_torch(r) for r in rows),
            jt.ENT, jt.KL, num_epochs=jt.E, max_grad_norm=jt.MAXNORM, **dt,
            **kw)
        got = dict(params=pt, mu=ot.mu, nu=ot.nu)
        out["phase"][name] = {q: ratio(got[q], want[q], PHASE_REL, ATOL[q])
                              for q in want}
    return out


def main(argv) -> int:
    for arg in argv or [f"lstm:50:{s}" for s in range(6)]:
        cell, width, seed = arg.split(":")
        print(json.dumps(case(cell, int(width), int(seed))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

#!/usr/bin/env python3
"""Where the recurrent learner's phase (K8) parts from its plain twin on a
trajectory that K7 made: a sample at the PPO value clip.

    python tools/torch_k8_boundary.py

Needs one CUDA card. On ``chip_smoke.rnn_inputs``' config-4 GRU and LSTM
inputs (the trainer's reset and initial params, a random carry), it makes
the trajectory twice: through the acting kernel K7 and through K7's plain
twin. For each it prints one JSON line with K8's phase (16 steps) against
the float32 twin and against a float64 twin, in units of chip_smoke.py's
``SGD_TOL`` (the largest ratio and its parameter). For the K7-made GRU
trajectory it then takes K8's first step and, at K8's params after it,
holds minibatch 1's gradient from K9 and from the float32 twin against the
float64 twin's, and prints the samples whose loss derivative dL/dv differs
between float32 and float64: their step, env and agent, value, old value
and v - old_v, beside the value clip ``clip_eps``. A sample that sits
within rounding of ``old_v -+ clip_eps`` takes the clipped branch (dL/dv =
0) on one side and the unclipped one on the other, so the two float32
phases part there whatever either's arithmetic.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from warehouse_tpu_torch import medium_config  # noqa: E402
from warehouse_tpu_torch.kernels import act_rnn, sgd_rnn  # noqa: E402
from warehouse_tpu_torch.models.policy import apply_rnn  # noqa: E402
from warehouse_tpu_torch.ops.ppo_update import ppo_losses  # noqa: E402


def to64(x):
    """``x`` with every float32 tensor in float64 (dicts, named tuples,
    tuples)."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.dtype == torch.float32 else x
    if isinstance(x, dict):
        return {k: to64(v) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(to64(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(to64(v) for v in x)
    return x


def inputs(dev, cfg, arch, made_by):
    """``chip_smoke.rnn_inputs`` with the chunk made by ``made_by``: "k7"
    (the kernel) or "twin"."""
    return cs.rnn_inputs(dev, cfg, arch, rollout=(
        act_rnn.ppo_rnn_rollout if made_by == "k7"
        else act_rnn.ppo_rnn_rollout_reference))


def worst(a, b, tol):
    ratios = {k: cs.tol_ratio(a[k], b[k].float(), *tol) for k in a}
    k = max(ratios, key=ratios.get)
    return [k, ratios[k]]


def phase_line(dev, cfg, arch, made_by):
    tcfg, tr, rs, traj, adv_n, targets, h0, ent = inputs(dev, cfg, arch,
                                                         made_by)
    E, M = tcfg.ppo_epochs, tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, E * M, dev)
    args = (rs.params, rs.opt_state, traj, adv_n, targets, h0, *rows, ent,
            rs.kl_coeff)
    kw = dict(num_epochs=E, num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
              mask_actions=False)
    pk, ok, _ = sgd_rnn.ppo_rnn_sgd_phase(*args, **kw)
    pr, orf, _ = sgd_rnn.ppo_rnn_sgd_phase_reference(*args, **kw)
    p6, o6, _ = sgd_rnn.ppo_rnn_sgd_phase_reference(*to64(args), **kw)
    out = {"arch": arch, "chunk_made_by": made_by}
    for name, (a, b, c) in (("params", (pk, pr, p6)),
                            ("nu", (ok.nu, orf.nu, o6.nu))):
        tol = cs.SGD_TOL[name]
        out[name] = {"k8_vs_twin": worst(a, b, tol),
                     "k8_vs_f64": worst(a, c, tol),
                     "twin_vs_f64": worst(b, c, tol)}
    print(json.dumps(out), flush=True)


def boundary_lines(dev, cfg):
    """K8's first step on the K7-made GRU chunk, then minibatch 1 at its
    params: the gradients and the samples whose dL/dv flips."""
    tcfg, tr, rs, traj, adv_n, targets, h0, ent = inputs(dev, cfg, "gru",
                                                         "k7")
    M = tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, 1, dev)
    kw = dict(num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, mask_actions=False)
    # K8's first step of the phase: K9's gradient of minibatch 0, then the
    # clip + Adam kernel.
    run = sgd_rnn.RnnLaunch(rs.params, traj, adv_n, targets, h0, ent,
                            rs.kl_coeff, M, tcfg.clip_eps, tcfg.value_coef,
                            False)
    p_flat, m_flat, v_flat = (act_rnn.pack_rnn(t) for t in (
        rs.params, rs.opt_state.mu, rs.opt_state.nu))
    g_flat = torch.empty_like(p_flat)
    run.grads(p_flat, 0, g_flat, torch.empty(4, device=dev))
    run.clip_adam(p_flat, m_flat, v_flat, g_flat,
                  [r.float().contiguous() for r in rows], 0,
                  tcfg.max_grad_norm)
    p1 = act_rnn.unpack_rnn(p_flat, rs.params)
    grads = {}
    for name, conv in (("k9", None), ("twin", lambda x: x), ("f64", to64)):
        if conv is None:
            _, grads[name] = sgd_rnn.ppo_rnn_minibatch_grads(
                p1, traj, adv_n, targets, h0, 1, ent, rs.kl_coeff, **kw)
        else:
            _, grads[name] = sgd_rnn.ppo_rnn_minibatch_grads_reference(
                *conv((p1, traj, adv_n, targets, h0)), 1, ent,
                rs.kl_coeff, **kw)
    print(json.dumps({
        "minibatch": 1, "at": "K8's params after its first step",
        "value_bias_grad": {k: float(g["value.bias"][0])
                            for k, g in grads.items()},
        "k9_vs_f64": worst(grads["k9"], grads["f64"], cs.RNN_GRAD_TOL),
        "twin_vs_f64": worst(grads["twin"], grads["f64"], cs.RNN_GRAD_TOL),
        "k9_vs_twin": worst(grads["k9"], grads["twin"], cs.RNN_GRAD_TOL)}),
        flush=True)
    mb = sgd_rnn.seq_minibatches(traj, adv_n, targets, h0, M)[1]
    w = traj.obs.shape[1] // M
    per = {}
    for name, conv in (("f32", lambda x: x), ("f64", to64)):
        (obs, action, old_lp, old_v, adv, tgt, _), carry = conv(mb)
        params = conv(p1)
        with torch.no_grad():
            lgs, vs = [], []
            for t in range(obs.shape[0]):
                lg, v, carry = apply_rnn(params, obs[t], carry)
                lgs.append(lg)
                vs.append(v)
        lg = torch.stack(lgs).requires_grad_(True)
        v = torch.stack(vs).requires_grad_(True)
        total, _ = ppo_losses(lg, v, action, old_lp, old_v, adv, tgt,
                              clip_eps=tcfg.clip_eps,
                              value_coef=tcfg.value_coef, ent_coef=ent,
                              kl_coeff=rs.kl_coeff, normalize_adv=False)
        per[name] = (torch.autograd.grad(total, v)[0].double(),
                     v.detach().double(), old_v.double())
    # A sample's dL/dv is about 4e-6 at config 4 (value_coef over 65536
    # samples): float32 rounding moves it by 1e-12, a branch by all of it.
    flip = ((per["f32"][0] - per["f64"][0]).abs() > 1e-9).nonzero()
    for t, b, a in flip.tolist():
        print(json.dumps({
            "flipped_sample": {"t": t, "env": 1 * w + b, "agent": a},
            "dL_dv_f32": float(per["f32"][0][t, b, a]),
            "dL_dv_f64": float(per["f64"][0][t, b, a]),
            "v_f32": float(per["f32"][1][t, b, a]),
            "v_f64": float(per["f64"][1][t, b, a]),
            "old_v": float(per["f64"][2][t, b, a]),
            "v_minus_old_v_f64": float(per["f64"][1][t, b, a]
                                       - per["f64"][2][t, b, a]),
            "v_minus_old_v_f32": float(per["f32"][1][t, b, a]
                                       - per["f32"][2][t, b, a]),
            "clip_eps": tcfg.clip_eps}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_k8_boundary: needs a CUDA device", file=sys.stderr)
        return 1
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = medium_config()
    for made_by in ("k7", "twin"):
        for arch in ("gru", "lstm"):
            phase_line(dev, cfg, arch, made_by)
    boundary_lines(dev, cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())

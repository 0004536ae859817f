#!/usr/bin/env python3
"""Why a float32 learner phase (K3 / K11) parts from its plain twin as a
whole while each of its steps holds: the phase step by step against a
float32 twin, a float64 twin and a CPU twin, over seeds, with the samples
that sit on other sides of a relu or a clip in the kernel's state and in
the twin's.

    python tools/torch_phase_witness.py [k11_h50] [k11_h64] [k3_deep8]

Needs one CUDA card. For each case (K11 at trunk width 50 and at 64, K3 at
8 hidden layers of 128; config 4's trajectory from ``chip_smoke.
sgd_inputs`` with ``chip_smoke.SEED`` set to each seed) it prints JSON
lines, each ratio in units of chip_smoke.py's tolerance (``CNN_TOL`` /
``SGD_TOL``, the largest over the tensors of params, mu or nu):

- ``whole``: the kernel's phase (16 steps) against the float32 twin, the
  float64 twin and (first seed) the float32 twin on the CPU; the float32
  twins against the float64 twin;
- one line a step s: the kernel's step and the float32 and float64 twins'
  steps from the kernel's state before it (``step_*``); the kernel's chain
  of one-step phases against the float32 and the float64 twins' chains
  (``traj_*``); and, on minibatch s's samples in the kernel's state and in
  the float32 twin's (both evaluated in float64), the count of samples or
  units on other sides of each branch (``flips``): conv 0's and conv 1's
  relus (CNN), the PPO ratio clip taken, the value clip taken outside
  ``clip_eps``;
- whether the chain of one-step phases gives the whole phase's bits.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from warehouse_tpu_torch.kernels import build, sgd, sgd_cnn  # noqa: E402
from warehouse_tpu_torch.models.policy import apply  # noqa: E402
from warehouse_tpu_torch.ops.ppo_update import (  # noqa: E402
    action_log_prob_entropy)
from warehouse_tpu_torch.train import Transition  # noqa: E402

SEEDS = {"k11_h50": (0, 1, 2), "k11_h64": (0, 1), "k3_deep8": (0, 1)}


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def on(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, dict):
        return {k: on(v, dev) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(on(v, dev) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(on(v, dev) for v in x)
    return x


def ratios(a, b, tol) -> dict:
    """{params, mu, nu: largest tolerance ratio} of ``(params, AdamState)``
    ``a`` against ``b``."""
    (pa, oa), (pb, ob) = a, b
    return {"params": cs.tree_err(pa, pb, *tol["params"])[1],
            "mu": cs.tree_err(oa.mu, ob.mu, *tol["mu"])[1],
            "nu": cs.tree_err(oa.nu, ob.nu, *tol["nu"])[1]}


def branches(params, rows, cnn: bool, clip_eps: float, mask_actions: bool):
    """Each sample's (or relu unit's) side of every branch, in float64."""
    obs, action, old_lp, old_v, adv, tgt, mask = cs.as_f64(rows)
    p = cs.as_f64(params)
    out = {}
    if cnn:
        a0, a1 = sgd_cnn.conv_forward_plain(p, obs)
        out["relu0"], out["relu1"] = a0 > 0, a1 > 0
    logits, value = apply(p, obs)
    if mask_actions:
        logits = logits.masked_fill(~mask, -1e30)
    lp, _ = action_log_prob_entropy(logits, action)
    r = torch.exp(lp - old_lp)
    out["pg_clip"] = torch.clamp(r, 1 - clip_eps, 1 + clip_eps) * adv < r * adv
    vc = old_v + torch.clamp(value - old_v, -clip_eps, clip_eps)
    out["v_clip"] = (((vc - tgt) ** 2 > (value - tgt) ** 2)
                     & ((value - old_v).abs() > clip_eps))
    return out


def case(tag: str, dev, seed: int, cpu_twin: bool) -> None:
    cnn = tag.startswith("k11")
    shape = ((50 if tag == "k11_h50" else 64, cs.HIDDEN[1]) if cnn
             else (cs.HIDDEN[0], 8))
    tcfg = cs.shape_tcfg(cs.CNN_SCHEDULE if cnn else cs.TRAIN_SCHEDULE,
                         shape)
    phase, ref, tol = ((sgd_cnn.ppo_cnn_sgd_phase,
                        sgd_cnn.ppo_cnn_sgd_phase_reference, cs.CNN_TOL)
                       if cnn else (sgd.ppo_sgd_phase,
                                    sgd.ppo_sgd_phase_reference, cs.SGD_TOL))
    cs.SEED = seed
    tcfg, tr, rs, traj, adv_n, targets, ent = cs.sgd_inputs(
        dev, cs.medium_config(), "cnn" if cnn else "mlp", tcfg.num_updates,
        tcfg)
    E, M = tcfg.ppo_epochs, tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, E * M, dev)
    args = (rs.params, rs.opt_state, traj, adv_n, targets, *rows, ent,
            rs.kl_coeff)
    kw = dict(num_epochs=E, num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
              mask_actions=tcfg.mask_actions)
    t0 = time.perf_counter()
    K = phase(*args, **kw)[:2]
    T = ref(*args, **kw)[:2]
    D = ref(*cs.as_f64(args), **kw)[:2]
    whole = {"kernel_vs_twin32": ratios(K, T, tol),
             "kernel_vs_twin64": ratios(K, D, tol),
             "twin32_vs_twin64": ratios(T, D, tol)}
    if cpu_twin:
        C = on(ref(*on(args, "cpu"), **kw)[:2], dev)
        whole.update(cpu_twin32_vs_twin32=ratios(C, T, tol),
                     cpu_twin32_vs_twin64=ratios(C, D, tol),
                     kernel_vs_cpu_twin32=ratios(K, C, tol))
    emit({"case": tag, "seed": seed, "whole": whole})

    w = traj.obs.shape[1] // M

    def step_args(p, o, s, a=args):
        cut = functools.partial(cs.env_cols, lo=(s % M) * w, w=w)
        return ((p, o, Transition(*map(cut, a[2])), cut(a[3]), cut(a[4]),
                 *(r[s:s + 1] for r in a[5:8]), a[8], a[9]),
                {**kw, "num_epochs": 1, "num_minibatches": 1})

    a64 = cs.as_f64(args)
    k_s = t_s = (rs.params, rs.opt_state)
    d_s = cs.as_f64(k_s)
    for s in range(E * M):
        mb = sgd_cnn.minibatch_rows(traj, adv_n, targets, s % M, M)
        bk = branches(k_s[0], mb, cnn, tcfg.clip_eps, tcfg.mask_actions)
        bt = branches(t_s[0], mb, cnn, tcfg.clip_eps, tcfg.mask_actions)
        sa, skw = step_args(*k_s, s)
        k1 = phase(*sa, **skw)[:2]
        t1 = ref(*sa, **skw)[:2]
        d1 = ref(*step_args(*cs.as_f64(k_s), s, a64)[0], **skw)[:2]
        t_s = ref(*step_args(*t_s, s)[0], **skw)[:2]
        d_s = ref(*step_args(*d_s, s, a64)[0], **skw)[:2]
        k_s = k1
        emit({"case": tag, "seed": seed, "step": s,
              "flips": {k: int((bk[k] != bt[k]).sum()) for k in bk},
              "step_kernel_vs_twin32": ratios(k1, t1, tol),
              "step_twin32_vs_twin64": ratios(t1, d1, tol),
              "traj_kernel_vs_twin32": ratios(k_s, t_s, tol),
              "traj_twin32_vs_twin64": ratios(t_s, d_s, tol)})
    emit({"case": tag, "seed": seed, "chained_steps_bit_equal_phase":
          all(cs.bits_equal(k_s[0][k], K[0][k]) for k in K[0]),
          "seconds": time.perf_counter() - t0})


def main(argv) -> int:
    print(cs.nvidia_smi(), flush=True)
    if not torch.cuda.is_available():
        print("torch_phase_witness: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    build.library()
    for tag in argv or list(SEEDS):
        for i, seed in enumerate(SEEDS[tag]):
            case(tag, dev, seed, cpu_twin=i == 0)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

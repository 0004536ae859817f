#!/usr/bin/env python3
"""Time the plain CNN learner phase on one GPU under three convolution
settings, in turns, to price ``models.policy.conv_flags``:

- ``torch_default``: no scope, torch's default flags (TF32 convolutions,
  nondeterministic algorithms allowed): what the port ran before the
  scope;
- ``ieee``: IEEE float32 convolutions alone;
- ``conv_flags``: the scope the port runs, IEEE float32 and deterministic
  algorithms without autotuning.

    python tools/torch_conv_flags_cost.py

The phase is the grouped-CNN shelves recipe's (``--arch cnn
--policy-groups 0,0,0,1,1,1``, 2048 envs, 16 steps of 49152 samples
through both CNNs: ``chip_smoke.groups_tcfg``). Each turn (order A, B, C,
C, B, A) runs one update of warm-up and 3 timed ones from the same state,
the learner phase by CUDA events. Prints the card's name and power limit,
one JSON line per turn, then the median of each setting.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from warehouse_tpu_torch import shelves_config  # noqa: E402
from warehouse_tpu_torch.models import policy  # noqa: E402
from warehouse_tpu_torch.train import make_train  # noqa: E402


@contextlib.contextmanager
def ieee_only():
    conv = torch.backends.cudnn.conv
    saved = conv.fp32_precision
    conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        conv.fp32_precision = saved


SETTINGS = {"torch_default": contextlib.nullcontext, "ieee": ieee_only,
            "conv_flags": policy.conv_flags}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_conv_flags_cost: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    tr = make_train(shelves_config(), cs.groups_tcfg(), arch="cnn",
                    device=dev, policy_groups=cs.GROUPS)
    rs0 = tr.init(cs.rng.prng_key(0, dev))
    names = list(SETTINGS)
    times = {n: [] for n in names}
    real = policy.conv_flags
    try:
        for name in names + names[::-1]:
            policy.conv_flags = SETTINGS[name]
            rs, sgd = rs0, []
            for u in range(4):
                marks = cs.Marks()
                rs, _ = tr.train_step(rs, mark=marks)
                if u:
                    sgd.append(marks.split()["sgd"])
            times[name] += sgd
            print(json.dumps({"setting": name, "learner_ms": sgd}),
                  flush=True)
    finally:
        policy.conv_flags = real
    print(json.dumps({"median_learner_ms": {
        n: statistics.median(t) for n, t in times.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

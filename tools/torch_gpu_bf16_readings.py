#!/usr/bin/env python3
"""Run the card-only tests and report the bf16 norm ratios they read.

    python3 tools/torch_gpu_bf16_readings.py [pytest arguments, e.g. -k bf16]

Run from the repository root on a machine with a CUDA device. It runs
``tests/test_torch_kernels_gpu.py`` (``-m gpu``, without
``tests/conftest.py``) with chip_smoke.py's ``norm_ratio`` wrapped to
record every value the bf16 tests read, then prints one JSON line: for the
kernel-against-twin gradients, the phases and the f32 twin's gradients,
the count and the largest and smallest ratio (a ratio is the distance in units of the bound the test
used: at most 1 passes). It exits with pytest's code.
"""

import json
import linecache
import sys

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import chip_smoke as cs  # noqa: E402
import pytest  # noqa: E402

seen = {"grad": [], "phase": [], "f32_grad": []}
_norm_ratio = cs.norm_ratio


def norm_ratio(a, b, rel, atol=0.0, stack=False):
    r = _norm_ratio(a, b, rel, atol, stack)
    caller = sys._getframe(1)
    line = linecache.getline(caller.f_code.co_filename, caller.f_lineno)
    if "g_f" in line:  # the test's f32-twin gradient
        seen["f32_grad"].append(r)
    else:
        seen["phase" if rel == cs.BF16_PHASE_REL else "grad"].append(r)
    return r


def main(argv) -> int:
    cs.norm_ratio = norm_ratio
    rc = pytest.main(["--noconftest", "-q", "-p", "no:cacheprovider", "-m",
                      "gpu", "tests/test_torch_kernels_gpu.py", *argv])
    print(json.dumps({k: {"n": len(v), "max": max(v, default=None),
                          "min": min(v, default=None)}
                      for k, v in seen.items()}))
    return int(rc)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

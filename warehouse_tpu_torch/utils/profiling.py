"""Tracing and profiling (counterpart of ``warehouse_tpu/utils/profiling.py``).

``trace(log_dir)`` records the enclosed block with ``torch.profiler``
(host operators, and the card's kernels and copies on a CUDA device) and
writes a Chrome / Perfetto trace into ``log_dir`` through
``torch.profiler.tensorboard_trace_handler``, which needs no TensorBoard
package. ``annotate(name)`` names a range of host work inside such a trace
(``torch.profiler.record_function``) and, on a CUDA device, in NVTX.
``range_split`` reads such a trace back: each named range's host and
device time, ``aten::`` calls and kernel launches. ``StepsPerSecond`` is
the host-side wall-clock throughput meter.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

from ..device import resolve_device


def _on_cuda(device) -> bool:
    return resolve_device(device).type == "cuda"


@contextlib.contextmanager
def trace(log_dir: str, device=None):
    """Profile the enclosed block into ``log_dir`` (a
    ``*.pt.trace.json`` file per trace); yields the ``torch.profiler``
    object, whose events can be read after the block. Traces the card
    unless ``device="cpu"``."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if _on_cuda(device):
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


@contextlib.contextmanager
def annotate(name: str, device=None):
    """A named range of the enclosed host work in profiler traces; on a
    CUDA device (the card unless ``device="cpu"``) also an NVTX range. It
    adds no device work and no synchronisation."""
    nvtx = _on_cuda(device)
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


# Host calls that launch device work, as the trace names them.
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
            "cuLaunchKernelEx")


def trace_file(log_dir: str) -> str:
    """The newest trace that ``trace`` wrote into ``log_dir``."""
    files = [os.path.join(log_dir, f) for f in os.listdir(log_dir)
             if f.endswith(".pt.trace.json")]
    if not files:
        raise FileNotFoundError(f"no *.pt.trace.json under {log_dir}")
    return max(files, key=os.path.getmtime)


def range_split(path: str, names, outer: str) -> dict:
    """The ``annotate`` ranges named in ``names`` inside the first range
    ``outer`` of the trace at ``path``, each name's instances summed:
    ``host_ms`` (the ranges' host time), ``device_ms`` (the kernels, copies
    and sets that host calls inside them started), ``aten_calls``,
    ``launches`` and ``ranges``. Also ``outer_ms`` and the same counts for
    the whole outer range, and ``covered_share``: the host time of the
    ranges that no other named range holds over ``outer_ms``."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    out_ev = next(e for e in spans if e["name"] == outer)
    lo, hi = out_ev["ts"], out_ev["ts"] + out_ev["dur"]

    def inside(e, a, b):
        return a <= e["ts"] and e["ts"] + e.get("dur", 0) <= b

    ranges = [e for e in spans if e["name"] in names and inside(e, lo, hi)]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::")]
    # The host's CUDA API calls (runtime and lower-level), whose correlation
    # ids the device's kernels, copies and sets carry.
    calls = [e for e in events if e.get("cat", "").startswith("cuda_")]
    device = {}
    for e in events:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            corr = e.get("args", {}).get("correlation")
            device[corr] = device.get(corr, 0.0) + e["dur"]

    def counts(a, b):
        mine = [c for c in calls if inside(c, a, b)]
        return {"aten_calls": sum(inside(o, a, b) for o in ops),
                "launches": sum(c["name"] in LAUNCHES for c in mine),
                "device_ms": sum(device.get(c.get("args", {}).get(
                    "correlation"), 0.0) for c in mine) / 1e3}

    pieces = {}
    for r in ranges:
        end = r["ts"] + r["dur"]
        p = pieces.setdefault(r["name"], {"host_ms": 0.0, "device_ms": 0.0,
                                          "aten_calls": 0, "launches": 0,
                                          "ranges": 0})
        p["host_ms"] += r["dur"] / 1e3
        p["ranges"] += 1
        for k, v in counts(r["ts"], end).items():
            p[k] += v
    top = [r for r in ranges if not any(
        o is not r and inside(r, o["ts"], o["ts"] + o["dur"])
        and o["dur"] > r["dur"] for o in ranges)]
    return {"outer_ms": out_ev["dur"] / 1e3, **counts(lo, hi),
            "covered_share": sum(r["dur"] for r in top) / out_ev["dur"],
            "pieces": pieces}


class StepsPerSecond:
    """Wall-clock env-steps/s meter with exponential smoothing."""

    def __init__(self, alpha: float = 0.3) -> None:
        self._alpha = alpha
        self._t = None
        self.rate = 0.0

    def update(self, steps: int) -> float:
        now = time.perf_counter()
        if self._t is not None:
            inst = steps / (now - self._t)
            self.rate = (
                inst if self.rate == 0.0
                else self._alpha * inst + (1 - self._alpha) * self.rate
            )
        self._t = now
        return self.rate

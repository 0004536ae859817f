"""Where the port's entry points run: on the card unless the caller asks
for the CPU.

Every entry point takes ``device=None`` and resolves it here. There is no
silent CPU path: without a CUDA device ``default_device`` raises and names
the way to ask for the CPU (``device="cpu"``, or ``--cpu`` on a CLI),
where the kernels' plain PyTorch twins run.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``torch.device("cuda")``, or a ``RuntimeError`` without one."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: warehouse_tpu_torch runs on the GPU by default; "
            "pass device=\"cpu\" (or --cpu / --device cpu on a command line) "
            "to run the plain PyTorch paths on the CPU")
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the card. Asking
    for a CUDA device that is not there raises like ``default_device``."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda":
        default_device()
    return device

"""The batched warehouse engine in PyTorch."""

from .engine import reset, step
from .state import EMPTY, IN_TRANSIT, PENDING, EnvState, TimeStep

__all__ = ["reset", "step", "EnvState", "TimeStep", "EMPTY", "PENDING",
           "IN_TRANSIT"]

"""Profiling and debugging utilities (counterpart of
``warehouse_tpu/utils``)."""

from .debug import check_state_invariants, enable_debug_mode
from .profiling import StepsPerSecond, annotate, trace

__all__ = ["trace", "annotate", "StepsPerSecond", "enable_debug_mode",
           "check_state_invariants"]

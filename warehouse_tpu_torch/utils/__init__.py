"""Profiling and debugging utilities (counterpart of
``warehouse_tpu/utils``)."""

from .debug import (assert_replicated_in_sync, check_state_invariants,
                    enable_debug_mode, visualize_sharding)
from .profiling import StepsPerSecond, annotate, trace

__all__ = ["trace", "annotate", "StepsPerSecond", "enable_debug_mode",
           "check_state_invariants", "assert_replicated_in_sync",
           "visualize_sharding"]

"""Batched tensor ops implementing the env sub-steps (docs/SEMANTICS.md §4)."""

from .assign import assign_requests
from .move import resolve_moves, valid_action_mask
from .obs import observe
from .vtrace import vtrace

__all__ = ["resolve_moves", "valid_action_mask", "assign_requests",
           "observe", "vtrace"]

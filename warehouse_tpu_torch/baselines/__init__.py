"""Baseline policies (greedy nearest-request, uniform random)."""

from .greedy import greedy_actions
from .random import random_actions

__all__ = ["greedy_actions", "random_actions"]

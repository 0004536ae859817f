"""Actor-critic policy models (PyTorch)."""

from .policy import ActorCriticMLP, make_model, params_from_flax

__all__ = ["ActorCriticMLP", "make_model", "params_from_flax"]

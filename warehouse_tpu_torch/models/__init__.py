"""Actor-critic policy models (PyTorch)."""

from .policy import (ActorCriticCNN, ActorCriticMLP, ActorCriticRNN,
                     apply_rnn, initial_carry, make_model, params_from_flax)

__all__ = ["ActorCriticCNN", "ActorCriticMLP", "ActorCriticRNN", "apply_rnn",
           "initial_carry", "make_model", "params_from_flax"]

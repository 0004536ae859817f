"""Actor-critic policy models (PyTorch)."""

from .policy import (ActorCriticCNN, ActorCriticMLP, ActorCriticRNN,
                     MultiPolicyActorCritic, apply_rnn, initial_carry,
                     make_model, make_multi_policy_model, params_from_flax)

__all__ = ["ActorCriticCNN", "ActorCriticMLP", "ActorCriticRNN",
           "MultiPolicyActorCritic", "apply_rnn", "initial_carry",
           "make_model", "make_multi_policy_model", "params_from_flax"]

"""The PPO actor-learner on one device (``python -m warehouse_tpu_torch.train``)."""

from .ppo import (PPOTrainer, RunnerState, Transition, make_train,
                  runner_state_from_jax)

__all__ = ["make_train", "PPOTrainer", "RunnerState", "Transition",
           "runner_state_from_jax"]

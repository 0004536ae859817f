"""The PPO, recurrent PPO and IMPALA actor-learners on one device
(``python -m warehouse_tpu_torch.train``)."""

from .impala import (ImpalaRunnerState, ImpalaTrainer, ImpalaTransition,
                     impala_runner_state_from_jax, make_train_impala)
from .ppo import (PPOTrainer, RunnerState, Transition, make_train,
                  runner_state_from_jax)
from .ppo_rnn import (PPORNNTrainer, RunnerStateRNN, make_train_rnn,
                      runner_state_rnn_from_jax)

__all__ = ["make_train", "PPOTrainer", "RunnerState", "Transition",
           "runner_state_from_jax", "make_train_impala", "ImpalaTrainer",
           "ImpalaRunnerState", "ImpalaTransition",
           "impala_runner_state_from_jax", "make_train_rnn", "PPORNNTrainer",
           "RunnerStateRNN", "runner_state_rnn_from_jax"]

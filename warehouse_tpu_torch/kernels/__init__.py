"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain twins.

Each wrapper launches its kernel on a CUDA tensor and runs its plain
PyTorch twin on a CPU tensor; ``<wrapper>.launches`` counts the kernel
launches. The sources in ``csrc/`` are compiled at first use
(``build.library``; the env kernels K1, K2, K7 and K10 for an (agents,
queue) pair outside the presets into that pair's own library,
``build.pair_library``).
"""

from .act import ActRollout, ppo_rollout, ppo_rollout_reference
from .act_rnn import ppo_rnn_rollout, ppo_rnn_rollout_reference
from .rollout import greedy_rollout, greedy_rollout_reference
from .sgd import (grad_sumsq, grad_sumsq_plain, ppo_minibatch_grads,
                  ppo_minibatch_grads_reference, ppo_sgd_phase,
                  ppo_sgd_phase_reference)
from .sgd_cnn import (ppo_cnn_minibatch_grads,
                      ppo_cnn_minibatch_grads_reference, ppo_cnn_sgd_phase,
                      ppo_cnn_sgd_phase_reference)
from .sgd_rnn import (ppo_rnn_minibatch_grads,
                      ppo_rnn_minibatch_grads_reference, ppo_rnn_sgd_phase,
                      ppo_rnn_sgd_phase_reference)
from .vtrace_sgd import (impala_minibatch_grads,
                         impala_minibatch_grads_reference, impala_sgd_phase,
                         impala_sgd_phase_reference)

__all__ = ["ActRollout", "greedy_rollout", "greedy_rollout_reference",
           "ppo_rollout", "ppo_rollout_reference", "ppo_sgd_phase",
           "ppo_sgd_phase_reference", "ppo_minibatch_grads",
           "ppo_minibatch_grads_reference", "impala_sgd_phase",
           "impala_sgd_phase_reference", "impala_minibatch_grads",
           "impala_minibatch_grads_reference", "ppo_rnn_rollout",
           "ppo_rnn_rollout_reference", "ppo_rnn_sgd_phase",
           "ppo_rnn_sgd_phase_reference", "ppo_rnn_minibatch_grads",
           "ppo_rnn_minibatch_grads_reference", "ppo_cnn_sgd_phase",
           "ppo_cnn_sgd_phase_reference", "ppo_cnn_minibatch_grads",
           "ppo_cnn_minibatch_grads_reference", "grad_sumsq",
           "grad_sumsq_plain"]

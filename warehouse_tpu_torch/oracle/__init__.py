"""NumPy oracle: the readable, step-for-step executable spec (counterpart
of ``warehouse_tpu/oracle/``, written apart from the engine). The port's
engine and env kernels are held against it."""

from .draws import NumpyDrawSource, TorchDrawSource
from .env import OracleEnv, OracleState
from .greedy import greedy_actions, greedy_bfs_actions

__all__ = [
    "NumpyDrawSource",
    "OracleEnv",
    "OracleState",
    "TorchDrawSource",
    "greedy_actions",
    "greedy_bfs_actions",
]

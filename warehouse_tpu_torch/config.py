"""Frozen configuration dataclasses of the port.

The port's own copy of the JAX package's ``config`` module (the port
imports nothing of that package): the same classes, fields, defaults and
presets, so an ``EnvConfig`` or ``TrainConfig`` built from the same
keywords is equal field by field (``tests/test_torch_slice.py`` holds the
two against each other). Static fields (grid size, agent count, queue
capacity, obs radius) fix tensor shapes and the CUDA kernels' template
instances; spec in docs/SEMANTICS.md §12. The block and backend knobs of
the TPU kernels are kept as fields and ignored by the port.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Warehouse environment configuration (docs/SEMANTICS.md §12)."""

    height: int = 9
    width: int = 9
    num_agents: int = 4
    queue_capacity: int = 8
    spawn_prob: float = 0.25
    init_requests: int = 4
    max_steps: int = 128
    obs_radius: int = 2
    global_obs: bool = False
    # Static obstacle layout: row-major cell ids of wall/shelf cells
    # (docs/SEMANTICS.md §1a). Empty = open floor. A frozen tuple so the
    # config stays hashable (layout is a SHAPE-like compile-time constant).
    walls: tuple = ()
    # Rewards (docs/SEMANTICS.md §8). Penalties are negative values.
    delivery_reward: float = 1.0
    pickup_reward: float = 0.1
    step_penalty: float = -0.01
    collision_penalty: float = -0.1
    auto_reset: bool = False

    def __post_init__(self) -> None:
        if self.height < 1 or self.width < 1:
            raise ValueError("grid must be at least 1x1")
        if self.num_agents < 1 or self.num_agents > self.height * self.width:
            raise ValueError("num_agents must fit on the grid")
        if self.init_requests > self.queue_capacity:
            raise ValueError("init_requests exceeds queue_capacity")
        if self.obs_radius < 0:
            raise ValueError("obs_radius must be >= 0")
        if not 0.0 <= self.spawn_prob <= 1.0:
            raise ValueError("spawn_prob must be in [0, 1]")
        walls = tuple(self.walls)
        object.__setattr__(self, "walls", walls)
        if len(set(walls)) != len(walls):
            raise ValueError("duplicate wall cells")
        if any(not 0 <= w < self.num_cells for w in walls):
            raise ValueError("wall cell out of range")
        if self.num_agents > self.num_cells - len(walls):
            raise ValueError("num_agents must fit on free cells")

    # ---- derived shapes -------------------------------------------------
    @property
    def num_cells(self) -> int:
        return self.height * self.width

    @property
    def window_size(self) -> int:
        return 2 * self.obs_radius + 1

    @property
    def num_obs_channels(self) -> int:
        """Grid channels per obs cell (docs/SEMANTICS.md §10): global view
        carries an extra traversability channel (ch4, walls)."""
        return 5 if self.global_obs else 4

    @property
    def obs_dim(self) -> int:
        """Flat per-agent observation length (docs/SEMANTICS.md §10)."""
        if self.global_obs:
            return 5 * self.height * self.width + 6
        return 4 * self.window_size * self.window_size + 6

    @property
    def num_actions(self) -> int:
        return 5

    @property
    def free_cells(self) -> tuple:
        """Row-major cell ids that are NOT walls (docs/SEMANTICS.md §9:
        random cell draws index into this list)."""
        wall_set = set(self.walls)
        return tuple(c for c in range(self.num_cells)
                     if c not in wall_set)

    @property
    def num_free(self) -> int:
        return self.num_cells - len(self.walls)

    # ---- (de)serialization ---------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "EnvConfig":
        d = dict(d)
        if "walls" in d:
            d["walls"] = tuple(d["walls"])
        return cls(**d)

    def replace(self, **kw: Any) -> "EnvConfig":
        return dataclasses.replace(self, **kw)


# The benchmark presets (BASELINE.md; queue_capacity = 2*A,
# init_requests = A per docs/SEMANTICS.md §12).
def small_config(**kw: Any) -> EnvConfig:
    """5x5, 2 agents — BASELINE.json config 1."""
    base = dict(height=5, width=5, num_agents=2, queue_capacity=4,
                init_requests=2)
    base.update(kw)
    return EnvConfig(**base)


def medium_config(**kw: Any) -> EnvConfig:
    """9x9, 4 agents — BASELINE.json configs 2 & 4."""
    base = dict(height=9, width=9, num_agents=4, queue_capacity=8,
                init_requests=4)
    base.update(kw)
    return EnvConfig(**base)


def large_config(**kw: Any) -> EnvConfig:
    """15x15, 8 agents — BASELINE.json config 3 (stress)."""
    base = dict(height=15, width=15, num_agents=8, queue_capacity=16,
                init_requests=8)
    base.update(kw)
    return EnvConfig(**base)


def shelves_config(**kw: Any) -> EnvConfig:
    """11x11 with four 3-cell shelf racks — a classic warehouse aisle
    layout (docs/SEMANTICS.md §1a)."""

    def cells(rc_list):
        return tuple(r * 11 + c for r, c in rc_list)

    racks = []
    for r in (2, 5, 8):
        for c0 in (2, 7):
            racks += [(r, c0), (r, c0 + 1), (r, c0 + 2)]
    base = dict(height=11, width=11, num_agents=6, queue_capacity=12,
                init_requests=6, walls=cells(racks))
    base.update(kw)
    return EnvConfig(**base)


# Adam hyperparameters, defined once: ``optim.py``'s clip + Adam and the
# learner kernels' Adam step read these.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Actor-learner configuration (PPO, recurrent PPO, IMPALA)."""

    num_envs: int = 4096          # env batch
    unroll_length: int = 16       # T: rollout length per update
    num_updates: int = 200
    # PPO
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    ppo_epochs: int = 4
    num_minibatches: int = 4
    # RLlib-style adaptive KL penalty (off by default).
    kl_coeff: float = 0.0
    kl_target: float = 0.01
    adaptive_kl: bool = True
    learning_rate: float = 3e-4
    max_grad_norm: float = 0.5
    anneal_lr: bool = True
    # Run the optimizer on the raveled parameter vector (optax.flatten);
    # the learner phase then runs plain.
    flat_optimizer: bool = False
    # Linear entropy-coefficient anneal: entropy_coef -> entropy_coef_final
    # over num_updates. Negative = disabled (constant entropy_coef).
    entropy_coef_final: float = -1.0
    # Minibatch construction for feed-forward PPO ("env" | "flat").
    # "env": each minibatch is a random set of env trajectories. "flat":
    # a fresh permutation of all T*B*A samples (the learner runs plain).
    minibatch_mode: str = "env"
    # Epoch shuffle cadence ("once" | "each"). "once": one permutation per
    # update; the epochs revisit the same minibatch partition. "each": a
    # fresh permutation every epoch (the learner runs plain).
    epoch_shuffle: str = "once"
    # Split each minibatch gradient into K micro-batch grads averaged
    # before one optimizer step. 1 = off; > 1 runs the learner plain.
    micro_batches: int = 1
    # Bootstrap value targets through time-limit truncations: at a
    # truncation boundary GAE/V-trace use V of the true final state as the
    # next-state value instead of 0. Off = truncation as termination.
    bootstrap_truncated: bool = False
    # Potential-based reward shaping coefficient (0 = off): the PPO MLP
    # and CNN trainers add coef * (gamma * phi(s') * (1 - done) - phi(s))
    # with phi = -BFS distance to the agent's target (ops/pathing.py).
    shaping_coef: float = 0.0
    # Mask actions that walk into walls / off the grid at the policy
    # logits (ops/move.py valid_action_mask). The mask is stored with the
    # trajectory and re-applied in the loss.
    mask_actions: bool = False
    # IMPALA / V-trace (train/impala.py; used only with algo="impala").
    rho_clip: float = 1.0         # V-trace IS clip for targets and pg
    c_clip: float = 1.0           # V-trace IS clip for trace cutting
    impala_passes: int = 1        # replays of each rollout
    impala_rmsprop: bool = True   # IMPALA's canonical optimizer; False = adam
    # Model
    hidden_dim: int = 128
    num_layers: int = 2
    # Compute dtype of the policy torso ("float32" | "bfloat16"): bf16
    # operands in PPO's learner kernels, the bf16 model for last values and
    # serving (train/ppo.py, train/ppo_rnn.py); IMPALA refuses it.
    model_dtype: str = "float32"
    # Backend switches and block knobs of the TPU kernels. The port has no
    # backend switch (the device picks kernel or plain twin; "xla" is
    # refused) and ignores the block knobs; the fields stay so that the
    # two packages' configs compare equal.
    rollout_backend: str = "auto"
    pallas_block: int = 512
    pallas_interpret: bool = False
    grad_backend: str = "auto"
    sgd_block_envs: int = 1024
    sgd_rows_per_block: int = 8
    sgd_rnn_block_envs: int = 256
    impala_block_envs: int = 128
    # Infra
    seed: int = 0
    checkpoint_every: int = 50
    checkpoint_dir: str = "checkpoints"
    metrics_path: str = "metrics.jsonl"

    def __post_init__(self) -> None:
        # Central validation: every trainer reads these fields, so a
        # mistyped value fails at construction.
        checks = {
            "minibatch_mode": ("flat", "env"),
            "epoch_shuffle": ("each", "once"),
            "rollout_backend": ("auto", "xla", "pallas"),
            "grad_backend": ("auto", "xla", "pallas"),
            "model_dtype": ("float32", "bfloat16"),
        }
        for field, allowed in checks.items():
            val = getattr(self, field)
            if val not in allowed:
                raise ValueError(
                    f"{field} must be one of {allowed}, got {val!r}")
        if self.micro_batches < 1:
            raise ValueError("micro_batches must be >= 1")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainConfig":
        return cls(**d)

    def replace(self, **kw: Any) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

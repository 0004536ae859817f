"""Process-group formation (counterpart of
``warehouse_tpu/parallel/distributed.py``).

The JAX package runs one process per host over all of its devices and
forms the global mesh with ``jax.distributed.initialize``; PyTorch runs one
process per card, so a rank here is a process with one device, and the
group is ``torch.distributed``'s. ``maybe_initialize_distributed`` forms it
from a launcher's variables: the JAX coordination variables the JAX
function reads, or torchrun's. NCCL joins ranks that each have a card of
their own, gloo ranks on the CPU. ``process_group`` forms one from a file
store (a test's ranks, or one process that wants a world-1 group) and
destroys it on exit.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("warehouse_tpu_torch")

TIMEOUT_S = 600  # a rank waits this long for the others before it raises


def launcher_env(environ=None) -> dict | None:
    """The group a launcher's variables describe, or None where they
    describe none: ``{"init_method", "world", "rank", "local_rank"}``. The
    JAX coordination variables (``JAX_COORDINATOR_ADDRESS`` or
    ``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``)
    come first, as ``warehouse_tpu/parallel/distributed.py:28-33`` reads
    them; then torchrun's (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``). The local rank (the card's index on
    its host) is ``LOCAL_RANK`` where it is set, else the rank modulo the
    host's cards."""
    env = os.environ if environ is None else environ
    addr = env.get("JAX_COORDINATOR_ADDRESS") or env.get(
        "COORDINATOR_ADDRESS")
    nproc, pid = env.get("JAX_NUM_PROCESSES"), env.get("JAX_PROCESS_ID")
    if addr and nproc and pid is not None:
        method, world, rank = f"tcp://{addr}", int(nproc), int(pid)
    elif all(env.get(k) for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                                  "WORLD_SIZE")):
        method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        world, rank = int(env["WORLD_SIZE"]), int(env["RANK"])
    else:
        return None
    local = env.get("LOCAL_RANK")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    local = int(local) if local is not None else rank % max(cards, 1)
    return {"init_method": method, "world": world, "rank": rank,
            "local_rank": local}


def _init(backend: str, init_method: str, world: int, rank: int,
          timeout_s: float, local_rank: int | None = None) -> None:
    if backend == "nccl" and local_rank is not None:
        torch.cuda.set_device(local_rank)
    try:
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    except Exception as e:  # the group did not form: no single-device run
        raise RuntimeError(
            f"rank {rank} of {world} could not form a {backend} group via "
            f"{init_method}: {e}") from e


def group_backend(spec: dict, device=None) -> str:
    """The backend of the group ``spec`` (``launcher_env``) describes:
    gloo where the caller trains on the CPU (``device`` a CPU device,
    whatever cards the host has) or this rank's card ``cuda:local_rank``
    does not exist; NCCL otherwise."""
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    cuda = (torch.cuda.is_available()
            and spec["local_rank"] < torch.cuda.device_count())
    return "nccl" if cuda else "gloo"


def maybe_initialize_distributed(timeout_s: float = TIMEOUT_S,
                                 device=None) -> bool:
    """Form the default process group where a launcher's variables
    describe one (``launcher_env``), on ``group_backend``'s backend for
    ``device`` (the device the caller trains on; None: the card), under
    NCCL this rank's card made the current device. Returns True if it
    formed a group; False without the variables or with a group already
    formed. A group the variables describe that does not form raises
    ``RuntimeError``: the run does not go on as one device."""
    spec = launcher_env()
    if spec is None or dist.is_initialized():
        return False
    backend = group_backend(spec, device)
    _init(backend, spec["init_method"], spec["world"], spec["rank"],
          timeout_s, spec["local_rank"] if backend == "nccl" else None)
    logger.info("torch.distributed initialized: rank %d/%d, %s via %s",
                spec["rank"], spec["world"], backend, spec["init_method"])
    return True


@contextlib.contextmanager
def process_group(store_path, backend: str = "gloo", rank: int = 0,
                  world: int = 1, timeout_s: float = 120,
                  local_rank: int = 0):
    """The default group of ``world`` ranks met through the file
    ``store_path`` (absent before the first rank arrives), as a
    ``DataMesh``; destroyed on exit. With NCCL the rank's card is
    ``cuda:local_rank``."""
    from .mesh import make_mesh

    _init(backend, f"file://{os.fspath(store_path)}", world, rank, timeout_s,
          local_rank if backend == "nccl" else None)
    try:
        yield make_mesh()
    finally:
        dist.destroy_process_group()

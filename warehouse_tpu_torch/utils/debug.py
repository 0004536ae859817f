"""Debug mode and state validation (counterpart of
``warehouse_tpu/utils/debug.py``).

``check_state_invariants`` checks the docs/SEMANTICS.md §2 invariants of a
batched state, one verdict per env; ``enable_debug_mode`` turns on
autograd's anomaly detection (NaN trapping in the backward passes).
``assert_replicated_in_sync`` catches ranks of a data mesh whose
replicated state diverged; ``visualize_sharding`` prints which rank holds
which rows of a sharded batch. Both take a ``(pop, data)`` mesh too, and
then act on this rank's slice: its data ranks' group.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from ..env.state import EMPTY, IN_TRANSIT, EnvState


def enable_debug_mode() -> None:
    """Anomaly detection in autograd: a backward pass that makes a NaN
    raises, naming the forward operation."""
    torch.autograd.set_detect_anomaly(True)


def check_state_invariants(cfg: EnvConfig, state: EnvState) -> torch.Tensor:
    """bool[B]: True for each env whose state keeps every §2 invariant
    (the JAX function's seven, on a batch): agents on the grid, no two on
    one cell, an agent's request names it back (an agent without one
    carries nothing), carrying iff its request is in transit, a request's
    agent names it back, an empty slot has no agent, a slot in transit
    has one."""
    A, R = cfg.num_agents, cfg.queue_capacity
    pos = state.agent_pos
    dev = pos.device
    pos_ok = ((pos >= 0).all(-1).all(-1)
              & (pos[..., 0] < cfg.height).all(-1)
              & (pos[..., 1] < cfg.width).all(-1))
    cells = pos[..., 0] * cfg.width + pos[..., 1]
    distinct = ((cells[:, :, None] != cells[:, None, :])
                | torch.eye(A, dtype=torch.bool, device=dev))
    no_overlap = distinct.all(-1).all(-1)

    has = state.agent_req >= 0
    safe = state.agent_req.clamp(0, R - 1).long()
    agents = torch.arange(A, dtype=state.req_agent.dtype, device=dev)
    pair_ok = torch.where(has, torch.gather(state.req_agent, 1, safe)
                          == agents, ~state.carrying).all(-1)
    carry_ok = torch.where(
        has, state.carrying == (torch.gather(state.req_status, 1, safe)
                                == IN_TRANSIT),
        ~state.carrying).all(-1)

    r_has = state.req_agent >= 0
    r_safe = state.req_agent.clamp(0, A - 1).long()
    slots = torch.arange(R, dtype=state.agent_req.dtype, device=dev)
    rpair_ok = torch.where(r_has, torch.gather(state.agent_req, 1, r_safe)
                           == slots, True).all(-1)
    empty_ok = torch.where(state.req_status == EMPTY, ~r_has, True).all(-1)
    transit_ok = torch.where(state.req_status == IN_TRANSIT, r_has,
                             True).all(-1)
    return (pos_ok & no_overlap & pair_ok & carry_ok & rpair_ok & empty_ok
            & transit_ok)


def _leaves(tree, path=""):
    """``(path, tensor)`` for every leaf of a tree of dicts, tuples and
    tensors; a number becomes a 0-d tensor."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, (bool, int, float)):
        yield path, torch.tensor(tree)


def _data_mesh(mesh):
    """A ``DataMesh``, or a ``PopMesh``'s slice of it."""
    return getattr(mesh, "data", mesh)


def assert_replicated_in_sync(tree, mesh) -> None:
    """Check that every leaf of ``tree`` is bit-identical on every rank of
    ``mesh`` (a collective: every rank calls it), the divergence detector
    of JAX ``utils/debug.py:67``; of a ``PopMesh``, on every data rank of
    this rank's slice (a population member's replicas). The leaves' bytes
    travel in one all-gather; a leaf that differs between two ranks raises
    ``AssertionError`` on every rank, naming it."""
    mesh = _data_mesh(mesh)
    leaves = [(p, x.detach().cpu().contiguous().reshape(-1).view(torch.uint8))
              for p, x in _leaves(tree)]
    flat = torch.cat([b for _, b in leaves]) if leaves else torch.zeros(
        0, dtype=torch.uint8)
    sizes = mesh.all_gather(torch.tensor([flat.numel()]))
    if any(int(s) != flat.numel() for s in sizes):
        raise AssertionError("replicated leaf diverged across shards: the "
                             f"trees differ in size ({[int(s) for s in sizes]}"
                             " bytes)")
    gathered = mesh.all_gather(flat)
    off = 0
    for path, b in leaves:
        n = b.numel()
        if any(not torch.equal(g[off:off + n], gathered[0][off:off + n])
               for g in gathered[1:]):
            raise AssertionError(
                f"replicated leaf diverged across shards: {path or '/'}")
        off += n


def visualize_sharding(x: torch.Tensor, mesh) -> str:
    """Print, and return, which rank holds which rows of the batch that
    ``x`` (this rank's rows) is a shard of (a collective), as JAX
    ``utils/debug.py:80`` draws a sharded array; of a ``PopMesh``, over
    this rank's slice."""
    mesh = _data_mesh(mesh)
    counts = [int(c) for c in mesh.all_gather(torch.tensor([x.shape[0]]))]
    starts = [sum(counts[:r]) for r in range(len(counts))]
    lines = [f"{sum(counts)} rows x {tuple(x.shape[1:])} over "
             f"'data' ({mesh.world} ranks)"]
    lines += [f"  rank {r}: rows [{lo}, {lo + n})"
              + (" <- this rank" if r == mesh.rank else "")
              for r, (lo, n) in enumerate(zip(starts, counts))]
    text = "\n".join(lines)
    print(text)
    return text

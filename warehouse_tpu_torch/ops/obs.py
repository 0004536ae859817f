"""Observation construction (docs/SEMANTICS.md §10) on batched tensors.

Counterpart of ``warehouse_tpu/ops/obs.py``. Channels come from comparing
window-cell coordinates with entity positions, so out-of-grid cells fall
out as zeros. The self features are normalised by multiplying with the
float32 reciprocal of the grid side, never by dividing: the spec pins the
multiply (division differs by an ulp for some widths).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EnvConfig

PENDING = 1


def targets(cfg: EnvConfig, agent_pos, agent_req, carrying, req_pickup,
            req_drop):
    """(has_task bool[B, A], target int32[B, A, 2]): the assigned pickup
    cell, the drop cell once carrying, the agent's own cell without a task."""
    has_task = agent_req >= 0
    idx = agent_req.clamp(0, cfg.queue_capacity - 1).long()[..., None]
    idx = idx.expand(*idx.shape[:-1], 2)
    my_pickup = torch.gather(req_pickup, 1, idx)
    my_drop = torch.gather(req_drop, 1, idx)
    tgt = torch.where(carrying[..., None], my_drop, my_pickup)
    return has_task, torch.where(has_task[..., None], tgt, agent_pos)


def inv_side(n: int) -> float:
    """float32(1) / float32(n), the exact multiplier of the features."""
    return float(np.float32(1.0) / np.float32(n))


def feats(cfg: EnvConfig, agent_pos, carrying, has_task, tgt):
    """Self features [row/H, col/W, carrying, has_task, drow/H, dcol/W]."""
    inv_h, inv_w = inv_side(cfg.height), inv_side(cfg.width)
    delta = torch.where(has_task[..., None], tgt - agent_pos, 0)
    f = torch.float32
    return torch.stack([
        agent_pos[..., 0].to(f) * inv_h,
        agent_pos[..., 1].to(f) * inv_w,
        carrying.to(f),
        has_task.to(f),
        delta[..., 0].to(f) * inv_h,
        delta[..., 1].to(f) * inv_w,
    ], dim=-1)


def _on(r, c, pos):
    """[..., n] cells (r, c) vs entities pos[B, E, 2] -> bool[..., n, E]."""
    return (r[..., None] == pos[:, None, None, :, 0]) & (
        c[..., None] == pos[:, None, None, :, 1])


def observe(cfg: EnvConfig, agent_pos, agent_req, carrying, req_pickup,
            req_drop, req_status) -> torch.Tensor:
    """Per-agent flat observations, float32[B, A, obs_dim]."""
    H, W = cfg.height, cfg.width
    dev = agent_pos.device
    has_task, tgt = targets(cfg, agent_pos, agent_req, carrying, req_pickup,
                            req_drop)
    f = feats(cfg, agent_pos, carrying, has_task, tgt)
    pending = (req_status == PENDING)[:, None, None, :]
    B, A = agent_pos.shape[:2]
    if cfg.global_obs:
        n = H * W
        cells = torch.arange(n, dtype=torch.int32, device=dev)
        r = (cells // W).expand(B, A, n)
        c = (cells % W).expand(B, A, n)
    else:
        k, S = cfg.obs_radius, cfg.window_size
        n = S * S
        offs = torch.arange(n, dtype=torch.int32, device=dev)
        r = agent_pos[..., 0:1] + (offs // S - k)           # [B, A, n]
        c = agent_pos[..., 1:2] + (offs % S - k)
    me_tgt = ((r == tgt[..., 0:1]) & (c == tgt[..., 1:2])
              & has_task[..., None])
    pend = (_on(r, c, req_pickup) & pending).any(-1)
    agents = _on(r, c, agent_pos)                             # [B, A, n, A]
    if cfg.global_obs:
        me = (r == agent_pos[..., 0:1]) & (c == agent_pos[..., 1:2])
        free = torch.ones(n, dtype=torch.bool, device=dev)
        if cfg.walls:
            free[list(cfg.walls)] = False
        chans = [me, agents.any(-1) & ~me, pend, me_tgt,
                 free.expand(B, A, n)]
    else:
        valid = (r >= 0) & (r < H) & (c >= 0) & (c < W)
        if cfg.walls:
            walls = torch.tensor(cfg.walls, dtype=torch.int32, device=dev)
            valid = valid & ~((r * W + c)[..., None] == walls).any(-1)
        chans = [agents.any(-1), pend, me_tgt, valid]
    grid = torch.stack(chans, dim=-1).to(torch.float32).reshape(B, A, -1)
    return torch.cat([grid, f], dim=-1)

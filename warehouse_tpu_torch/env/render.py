"""ASCII and RGB rendering of one env's state (counterpart of
``warehouse_tpu/env/render.py``, NumPy only, copied so that the port
imports nothing of the JAX package). The state's fields must already be
NumPy arrays or convertible by ``np.asarray`` (the dict-API wrapper moves
the port's tensors to the host first).

Legend:
  .   empty floor          p   pending pickup cell
  #   wall/shelf
  d   drop cell of an active (assigned or in-transit) request
  0-9 agent index (uppercase hex letter if carrying: A=agent 10 is not
      supported beyond 36 agents)
  *   agent standing on a request cell
"""

from __future__ import annotations

import numpy as np

from ..config import EnvConfig

PENDING, IN_TRANSIT = 1, 2


def render_ascii(cfg: EnvConfig, state) -> str:
    """state: one env's fields, each convertible by ``np.asarray``."""
    pos = np.asarray(state.agent_pos)
    carrying = np.asarray(state.carrying)
    rp = np.asarray(state.req_pickup)
    rd = np.asarray(state.req_drop)
    st = np.asarray(state.req_status)

    grid = np.full((cfg.height, cfg.width), ".", dtype="<U2")
    for w in cfg.walls:
        grid[w // cfg.width, w % cfg.width] = "#"
    for r in range(cfg.queue_capacity):
        if st[r] == PENDING:
            grid[rp[r, 0], rp[r, 1]] = "p"
    for r in range(cfg.queue_capacity):
        if st[r] in (PENDING, IN_TRANSIT):
            cell = grid[rd[r, 0], rd[r, 1]]
            grid[rd[r, 0], rd[r, 1]] = "d" if cell == "." else "*"
    for i in range(cfg.num_agents):
        ch = format(i, "x")
        if carrying[i]:
            ch = ch.upper()
        cell = grid[pos[i, 0], pos[i, 1]]
        grid[pos[i, 0], pos[i, 1]] = ch if cell == "." else ch
    border = "+" + "-" * cfg.width + "+"
    rows = ["|" + "".join(row) + "|" for row in grid]
    t = int(np.asarray(state.t))
    return "\n".join([f"t={t}", border, *rows, border])


# ---- RGB rendering (gymnasium "rgb_array" mode) ------------------------

# Colors (RGB uint8).
_FLOOR = (245, 245, 245)
_WALL = (60, 60, 60)
_GRIDLINE = (210, 210, 210)
_PICKUP = (66, 135, 245)      # pending pickup: blue
_DROP = (250, 180, 60)        # active drop cell: orange
_AGENT = (46, 160, 67)        # agent: green
_AGENT_CARRY = (200, 50, 50)  # carrying agent: red


def render_rgb(cfg: EnvConfig, state, cell_px: int = 16) -> np.ndarray:
    """uint8[H*cell_px, W*cell_px, 3] image of the state.

    Pure NumPy (no matplotlib dependency in the hot path); agents are
    filled circles over cell-colored floor, carrying agents red. Used by
    the dict-API wrapper's ``render(mode="rgb_array")`` and the demo
    CLI's ``--gif`` writer (SURVEY.md C14).
    """
    pos = np.asarray(state.agent_pos)
    carrying = np.asarray(state.carrying)
    rp = np.asarray(state.req_pickup)
    rd = np.asarray(state.req_drop)
    st = np.asarray(state.req_status)

    cell = np.zeros((cfg.height, cfg.width, 3), np.uint8)
    cell[:] = _FLOOR
    for w in cfg.walls:
        cell[w // cfg.width, w % cfg.width] = _WALL
    for r in range(cfg.queue_capacity):
        if st[r] == PENDING:
            cell[rp[r, 0], rp[r, 1]] = _PICKUP
    for r in range(cfg.queue_capacity):
        if st[r] in (PENDING, IN_TRANSIT):
            cell[rd[r, 0], rd[r, 1]] = _DROP

    img = np.repeat(np.repeat(cell, cell_px, 0), cell_px, 1)
    # Grid lines.
    img[::cell_px, :] = _GRIDLINE
    img[:, ::cell_px] = _GRIDLINE

    # Agents as filled circles.
    yy, xx = np.mgrid[:cell_px, :cell_px]
    c = (cell_px - 1) / 2.0
    disk = ((yy - c) ** 2 + (xx - c) ** 2) <= (0.38 * cell_px) ** 2
    for i in range(cfg.num_agents):
        color = _AGENT_CARRY if carrying[i] else _AGENT
        r0, c0 = pos[i, 0] * cell_px, pos[i, 1] * cell_px
        tile = img[r0:r0 + cell_px, c0:c0 + cell_px]
        tile[disk] = color
    return img


def save_gif(frames, path: str, fps: int = 8) -> None:
    """Write a list of rgb uint8 frames as an animated GIF (PIL)."""
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)

"""K7: the acting-phase kernel of the recurrent (GRU / LSTM) policy and its
plain twin.

Counterpart of ``warehouse_tpu/pallas/act.py`` ``ppo_rnn_rollout_pallas``
(:747). ``ppo_rnn_rollout`` runs T acting steps — observe, encoder, cell,
heads, gumbel-argmax sample, env tick — with the recurrent carry threaded
over the steps, and returns ``(EnvState, ActRollout, reset_key_last,
next_key, new_carry)`` like the JAX wrapper. ``new_carry`` is NOT reset at
episode boundaries: the caller zeroes it where the chunk truncated (the
trainer acts through K7 only where an episode ends on a chunk's last
step). The env draws
and the gumbel noise are K2's streams (``rng.batched_step_draws``,
``rng.batched_gumbel_stream(key, T, (5, B*A))``). On a CUDA tensor the
CUDA kernel (``csrc/act_rnn.cu``) runs; on a CPU tensor the plain twin
does.

The kernel runs each step as stage kernels over all of the step's ``B A``
rows (``b A + a``): a tanh layer a launch per encoder layer, the cell as
one product over ``[e | h]`` with the gates in its epilogue, the head, and
K2's env stage. Their plain versions (``act_encoder_plain``,
``act_cell_plain`` on ``cell_weights``' column layout,
``act_rnn_head_plain``, ``act.act_env_plain``) compose into
``act_rnn_steps_staged``; ``act_rnn_stage`` runs one of them through its
kernel on the card. The tests hold these against the twin and the Pallas
kernel; nothing on the main path calls them.

The carry is ``h float32[B, A, H]`` for the GRU, the tuple ``(c, h)`` of two
such tensors for the LSTM. ``mask_actions`` works as in K2; like the JAX
function, it has no reward shaping and raises on global observations
(``NotImplementedError``): the recurrent trainer acts with those options
through its per-step phase (``train.ppo.step_rollout``), as the JAX
trainer does through its XLA scan.

``pack_rnn`` / ``unpack_rnn`` lay a recurrent policy's params dict out as
the flat vector the recurrent kernels read (``csrc/rnn_cell.cuh``): the
encoder layers, the stacked input-side gate kernels (and GRU biases), the
stacked recurrent gate kernels and their biases, the fused head.
"""

from __future__ import annotations

import torch

from ..config import EnvConfig
from ..env import engine
from ..env.state import EnvState
from ..models.policy import (ActorCriticRNN, apply_rnn, cell_type_of,
                             num_encoder)
from ..ops.move import valid_action_mask
from ..ops.obs import inv_side
from ..ops.ppo_update import NEG_INF, sample_action_with_gumbel
from . import act, build
from .act import _KernelIO, chunk_rollout, env_stage_outputs
from .rollout import f32

GATE_ORDER = {"gru": ("r", "z", "n"), "lstm": ("i", "f", "g", "o")}


def rnn_layout(params) -> list[list[str]]:
    """The packed vector as a list of segments, each a list of params keys
    whose tensors are concatenated along dim 0 (so a segment is one matrix
    ``[out, in]`` or one bias vector)."""
    cell = cell_type_of(params)
    gates = GATE_ORDER[cell]
    segs = []
    for i in range(num_encoder(params)):
        segs += [[f"encoder.{i}.weight"], [f"encoder.{i}.bias"]]
    segs.append([f"cell.i{g}.weight" for g in gates])
    if cell == "gru":
        segs.append([f"cell.i{g}.bias" for g in gates])
    segs.append([f"cell.h{g}.weight" for g in gates])
    segs.append(["cell.hn.bias"] if cell == "gru"
                else [f"cell.h{g}.bias" for g in gates])
    segs += [["logits.weight", "value.weight"], ["logits.bias", "value.bias"]]
    return segs


def pack_rnn(tree) -> torch.Tensor:
    """A recurrent params-shaped dict as the kernels' flat float32 vector."""
    return torch.cat([tree[k].detach().reshape(-1)
                      for seg in rnn_layout(tree) for k in seg]
                     ).to(torch.float32).contiguous()


def unpack_rnn(flat: torch.Tensor, like) -> dict:
    """Inverse of ``pack_rnn``: views of ``flat`` with ``like``'s keys and
    shapes."""
    out, off = {}, 0
    for seg in rnn_layout(like):
        for k in seg:
            n = like[k].numel()
            out[k] = flat[off:off + n].view(like[k].shape)
            off += n
    return {k: out[k] for k in like}


def rnn_dims(params, D: int) -> tuple[list[int], int, bool]:
    """``(dims, H, lstm)``: the obs width then the encoder widths, the
    cell's hidden width and its type, with every shape checked."""
    cell = cell_type_of(params)
    dims = [D] + [params[f"encoder.{i}.weight"].shape[0]
                  for i in range(num_encoder(params))]
    H = params["cell.hn.weight" if cell == "gru"
               else "cell.ho.weight"].shape[0]
    for i, (fan_in, fan_out) in enumerate(zip(dims, dims[1:])):
        if params[f"encoder.{i}.weight"].shape != (fan_out, fan_in):
            raise ValueError(f"encoder.{i}: shape does not fit widths {dims}")
    for g in GATE_ORDER[cell]:
        if (params[f"cell.i{g}.weight"].shape != (H, dims[-1])
                or params[f"cell.h{g}.weight"].shape != (H, H)):
            raise ValueError(f"cell gate {g}: shape does not fit widths "
                             f"{dims[-1]} -> {H}")
    if params["logits.weight"].shape != (5, H) or (
            params["value.weight"].shape != (1, H)):
        raise ValueError("the recurrent kernels take a 5-action head and a "
                         "value head on the cell's output")
    return dims, H, cell == "lstm"


def check_act_rnn_fits(cfg: EnvConfig, params, dev=None):
    """K7's ``(dims, H, lstm)`` for ``params`` on ``cfg``; raises
    ``ValueError``, before any library call, for an (agents, queue) pair
    no env stage can be built for (``build.check_pair``) or params that do
    not fit the observation. Any hidden and encoder width and any number of
    encoder layers: the stages' tiles pad each width."""
    build.check_pair(cfg.num_agents, cfg.queue_capacity)
    return rnn_dims(params, cfg.obs_dim)


def split_carry(carry, lstm: bool):
    """``(h, c)`` float32 contiguous tensors of a carry (``c`` None for the
    GRU)."""
    if lstm:
        c, h = carry
        return (h.to(torch.float32).contiguous(),
                c.to(torch.float32).contiguous())
    return carry.to(torch.float32).contiguous(), None


def act_rnn_steps_reference(cfg: EnvConfig, params: dict, state: EnvState,
                            carry, u, pick, drop, g, logits=None, mask=None):
    """Plain PyTorch twin of the kernel: T = ``u.shape[0]`` steps of
    observe -> ``apply_rnn`` -> sample -> ``engine.tick`` on the given
    draws and gumbel noise ``g [T, 5, B*A]``. Returns ``(state, carry, obs,
    action, log_prob, value, reward, delivered)``, the last six stacked
    over T. ``logits`` / ``mask`` ``[T, B, A, 5]``, if given, receive the
    raw logits / turn masking on and receive the valid-action mask."""
    outs = []
    with torch.no_grad():
        for t in range(u.shape[0]):
            obs = engine.observe_state(cfg, state)
            lg, value, carry = apply_rnn(params, obs, carry)
            if logits is not None:
                logits[t] = lg
            if mask is not None:
                mask[t] = valid_action_mask(cfg, state.agent_pos)
                lg = torch.where(mask[t], lg, NEG_INF)
            action, lp = sample_action_with_gumbel(lg, g[t])
            state, picked, delivered, collided = engine.tick(
                cfg, state, action, u[t], pick[t], drop[t])
            reward = engine.rewards(cfg, picked, delivered, collided)
            outs.append((obs, action, lp, value, reward,
                         delivered.sum(-1, dtype=torch.int32)))
    return (state, carry, *(torch.stack(x) for x in zip(*outs)))


def _round32(x: int) -> int:
    return -(-x // 32) * 32


class ActRnnLaunch:
    """One K7 call on the card: the checked inputs and outputs (K2's
    ``_KernelIO`` and the carry), the packed params and the workspace (the
    stages' padded kernels, the observation rows ``xs``, the encoder rows,
    the two row buffers ``[e | h]``, the LSTM's ``c``, ``head [N, 8]``, the
    env states), and its C arguments."""

    def __init__(self, cfg, params, state, carry, u, pick, drop, g,
                 logits=None, mask=None):
        dev = state.agent_pos.device
        A = cfg.num_agents
        self.dims, self.H, self.lstm = check_act_rnn_fits(cfg, params, dev)
        dims = build.int_array(self.dims)
        self.lib = lib = build.env_library(A, cfg.queue_capacity)
        self.weights = pack_rnn(params).to(dev)
        n_enc = len(self.dims) - 1
        if self.weights.numel() != lib.wh_rnn_param_floats(
                n_enc, dims, self.H, int(self.lstm)):
            raise ValueError("packed params do not fit the kernel's layout")
        self.io = _KernelIO(cfg, state, u, pick, drop, g, logits, mask)
        B = self.io.B
        self.h0, self.c0 = split_carry(carry, self.lstm)
        if any(x is not None and (x.shape != (B, A, self.H)
                                  or x.device != dev)
               for x in (self.h0, self.c0)):
            raise ValueError(f"carry must be [B, A, H] = {(B, A, self.H)} "
                             f"on {dev}")
        self.h_out = torch.empty_like(self.h0)
        self.c_out = torch.empty_like(self.c0) if self.lstm else None
        self.shape = (A, cfg.queue_capacity, B, n_enc, dims, self.H,
                      int(self.lstm))
        self.work = torch.empty(lib.wh_act_rnn_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)
        io = self.io

        def ptr(x):
            return None if x is None else x.data_ptr()

        self.args = [
            A, cfg.queue_capacity, B, io.T, cfg.height, cfg.width,
            f32(cfg.spawn_prob), cfg.window_size, cfg.obs_radius, cfg.obs_dim,
            inv_side(cfg.height), inv_side(cfg.width), f32(cfg.step_penalty),
            f32(cfg.pickup_reward), f32(cfg.delivery_reward),
            f32(cfg.collision_penalty), n_enc, dims, self.H, int(self.lstm),
            io.walls.data_ptr(), self.weights.data_ptr(),
            self.work.data_ptr(), *(x.data_ptr() for x in io.ins),
            self.h0.data_ptr(), ptr(self.c0),
            *(x.data_ptr() for x in io.draws),
            *(x.data_ptr() for x in io.outs), self.h_out.data_ptr(),
            ptr(self.c_out), io.obs.data_ptr(), io.action.data_ptr(),
            io.log_prob.data_ptr(), io.value.data_ptr(),
            io.reward.data_ptr(), io.delivered.data_ptr(), ptr(io.logits),
            ptr(io.mask)]
        self.stream = build.stream_handle(dev)

    def rows(self) -> dict:
        """The workspace's step rows, as views at their natural widths:
        ``x`` the observation rows (encoder layer 0's input), ``enc`` the
        two buffers of the encoder layers but the last (None with one
        layer), ``rb`` the first row buffer ``[e | h]`` whole (pad columns
        zero past E and past H), ``e`` its e part, ``h`` the h parts of
        both row buffers, ``c [N, H]`` (None for the GRU) and ``head [N,
        8]``."""
        out = (build.L * 8)()
        build.check(self.lib.wh_act_rnn_layout(*self.shape, out),
                    "wh_act_rnn_layout", self.lib)
        n = self.io.B * self.shape[0]
        dims, H = self.dims, self.H

        def view(off, width):
            return self.work[off:off + n * width].view(n, width)

        Ep = _round32(dims[-1])
        K = Ep + _round32(H)
        EL = max([_round32(d) for d in dims[1:-1]], default=0)
        rb = [view(out[3 + i], K) for i in range(2)]
        return {"x": view(out[0], _round32(dims[0])),
                "enc": [view(out[1 + i], EL) for i in range(2)]
                if EL else None,
                "rb": rb[0], "e": rb[0][:, :dims[-1]],
                "h": [b[:, Ep:Ep + H] for b in rb],
                "c": view(out[5], H) if self.lstm else None,
                "head": view(out[6], 8)}

    def _io_views(self, stage: str, layer: int):
        """``(inputs, outputs)``: the workspace views a stage reads and
        writes, by ``act_rnn_stage``'s names."""
        r = self.rows()
        L = len(self.dims) - 1
        if stage == "encoder":
            x = r["x"] if layer == 0 else r["enc"][(layer - 1) % 2]
            y = (r["e"] if layer == L - 1
                 else r["enc"][layer % 2][:, :self.dims[layer + 1]])
            return {"x": x}, {"y": y}
        if stage == "cell":  # its outputs: the final carry, T = 1
            return {"e": r["e"], "h": r["h"][0], "c": r["c"],
                    "rb": r["rb"]}, {}
        if stage == "head":
            return {"h": r["h"][1]}, {"head": r["head"][:, :6]}
        return {"head": r["head"]}, {}

    def fill(self, stage: str, inputs: dict, layer: int = 0):
        """Writes a stage's input rows (``act_rnn_stage``'s names,
        unpadded) where its kernel reads them, the pad columns zero;
        returns the env stage's buffer for the next observation rows
        (else None)."""
        views, _ = self._io_views(stage, layer)
        if stage == "encoder":
            views["x"].zero_()
            views["x"][:, :inputs["x"].shape[1]] = inputs["x"]
        elif stage == "cell":
            E = self.dims[-1]
            views["rb"].zero_()
            views["e"].copy_(inputs["eh"][:, :E])
            views["h"].copy_(inputs["eh"][:, E:])
            if self.lstm:
                views["c"].copy_(inputs["c"])
        elif stage == "head":
            views["h"].copy_(inputs["h"])
        else:
            views["head"].zero_()
            views["head"][:, :6] = inputs["head"]
            return torch.empty_like(self.io.obs[0])
        return None

    def outputs(self, stage: str, state, obs_next, layer: int = 0) -> dict:
        """A stage's outputs after its launch, as ``act_rnn_stage`` names
        them."""
        if stage == "cell":
            n = self.h_out.numel() // self.H
            return {"h": self.h_out.view(n, self.H).clone(),
                    "c": (self.c_out.view(n, self.H).clone()
                          if self.lstm else None)}
        if stage == "env":
            return env_stage_outputs(self.io, state, obs_next)
        return {k: v.clone()
                for k, v in self._io_views(stage, layer)[1].items()}

    def launch(self, stage=None, obs_next=None, layer: int = 0) -> list:
        """The whole chunk (``stage`` None), one of ``ACT_RNN_STAGES`` of
        its step 0 on the rows the workspace holds (``encoder``: layer
        ``layer``; the env stage writes the next observation rows into
        ``obs_next``), or ``"prep"`` alone. Returns the kernels it
        launched, as the C entry point counted them: the encoder stages',
        the cell stages', the head stages', the env stages', the prep's."""
        launched = (build.L * 5)()
        if stage is None:
            err = self.lib.wh_act_rnn_rollout(*self.args, launched,
                                              self.stream)
            build.check(err, "ppo_rnn_rollout kernel launch", self.lib)
        else:
            err = self.lib.wh_act_rnn_stage(
                (ACT_RNN_STAGES + ("prep",)).index(stage), layer, *self.args,
                None if obs_next is None else obs_next.data_ptr(), launched,
                self.stream)
            build.check(err, f"K7 stage {stage} launch", self.lib)
        return list(launched)

    def results(self, state):
        new, *outs = self.io.results(state)
        carry = (self.c_out, self.h_out) if self.lstm else self.h_out
        return (new, carry, *outs)


def act_rnn_steps(cfg: EnvConfig, params: dict, state: EnvState, carry, u,
                  pick, drop, g, logits=None, mask=None):
    """T recurrent acting steps on precomputed draws and gumbel noise: the
    CUDA kernel for CUDA tensors, the plain twin for CPU tensors. Same
    arguments and returns as ``act_rnn_steps_reference``."""
    dev = state.agent_pos.device
    if dev.type == "cpu":
        return act_rnn_steps_reference(cfg, params, state, carry, u, pick,
                                       drop, g, logits, mask)
    if dev.type != "cuda":
        raise ValueError(f"act_rnn_steps: unsupported device {dev}")
    run = ActRnnLaunch(cfg, params, state, carry, u, pick, drop, g, logits,
                       mask)
    enc, cell, head, env, prep = run.launch()
    f = act_rnn_steps
    f.launches += 1
    f.encoder_launches += enc
    f.cell_launches += cell
    f.head_launches += head
    f.env_launches += env
    f.stage_launches += enc + cell + head + env + prep
    return run.results(state)


act_rnn_steps.launches = 0
# The stage kernels those launches ran, as the C entry point counts them
# where it launches them: a step's encoder layers, cell, head and env
# stage (the tick, then the next observation rows but on the last step),
# and the prep and the first observation's pair.
act_rnn_steps.stage_launches = 0
act_rnn_steps.encoder_launches = 0  # of them, the encoder stages' kernels
act_rnn_steps.cell_launches = 0     # the cell stages'
act_rnn_steps.head_launches = 0     # the head stages'
act_rnn_steps.env_launches = 0      # the env stages' (tick and observation)


# ---- K7's stages, plain -----------------------------------------------------

ACT_RNN_STAGES = ("encoder", "cell", "head", "env")
CELL_UNITS = 32  # hidden units of one of the cell stage's 128-column tiles


def cell_columns(H: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(unit, set)`` of each column of the cell stage's product, in the
    kernel's order (``csrc/act_rnn.cu`` ``cell_col``): tiles of 128 columns,
    each every gate set of 32 hidden units; within a tile, each warp's 32
    columns are its 8 units' 4 sets, set-major. Sets: GRU ``r``, ``z``,
    ``n_in`` (the input side of n), ``q`` (``W_hn h + b_hn``); LSTM ``i``,
    ``f``, ``g``, ``o``. Units at or past H are padding."""
    cc = torch.arange(-(-H // CELL_UNITS) * 128)
    tile, cc = cc // 128, cc % 128
    unit = tile * CELL_UNITS + 8 * (cc // 32) + cc % 8
    return unit, cc // 8 % 4


def cell_weights(params) -> torch.Tensor:
    """The cell stage's kernel ``[columns, E + H]`` over ``[e | h]``, in
    ``cell_columns``' order: each column its unit's row of its set's input
    kernel then of its recurrent kernel, zero for the GRU's ``n_in`` on
    the h part, its ``q`` on the e part, and the padding units."""
    gates = GATE_ORDER[cell_type_of(params)]
    wi = torch.cat([params[f"cell.i{g}.weight"] for g in gates])
    wh = torch.cat([params[f"cell.h{g}.weight"] for g in gates])
    H, E = wh.shape[1], wi.shape[1]
    if len(gates) == 3:  # GRU: sets r, z, n_in, q
        zi, zh = wi.new_zeros(H, E), wh.new_zeros(H, H)
        wi = torch.cat([wi, zi])
        wh = torch.cat([wh[:2 * H], zh, wh[2 * H:]])
    full = torch.cat([wi, wh], 1)  # [4 H, E + H], set-major
    unit, sets = cell_columns(H)
    live = unit < H
    out = full.new_zeros(unit.numel(), E + H)
    out[live] = full[(sets * H + unit)[live]]
    return out


def act_encoder_plain(params: dict, layer: int, x):
    """Stage ``encoder``: ``tanh(x W^T + b)`` of encoder layer ``layer``
    on the rows ``x``."""
    return torch.tanh(x @ params[f"encoder.{layer}.weight"].T
                      + params[f"encoder.{layer}.bias"])


def act_cell_plain(params: dict, eh, c=None) -> dict:
    """Stage ``cell``: the cell on the rows ``eh = [e | h]`` (and the
    LSTM's ``c``): the product ``eh W^T`` on ``cell_weights``' columns,
    then flax's cell math on each unit's sets; ``h`` and ``c`` (None for
    the GRU) by name."""
    H = params["logits.weight"].shape[1]
    pre = eh @ cell_weights(params).T
    unit, sets = cell_columns(H)
    live = unit < H
    by = pre.new_empty(eh.shape[0], 4, H)
    by[:, sets[live], unit[live]] = pre[:, live]
    a0, a1, a2, a3 = by.unbind(1)
    h = eh[:, eh.shape[1] - H:]
    if c is None:
        r = torch.sigmoid(a0 + params["cell.ir.bias"])
        z = torch.sigmoid(a1 + params["cell.iz.bias"])
        n = torch.tanh(a2 + params["cell.in.bias"]
                       + r * (a3 + params["cell.hn.bias"]))
        return {"h": (1.0 - z) * n + z * h, "c": None}
    i = torch.sigmoid(a0 + params["cell.hi.bias"])
    f = torch.sigmoid(a1 + params["cell.hf.bias"])
    g = torch.tanh(a2 + params["cell.hg.bias"])
    o = torch.sigmoid(a3 + params["cell.ho.bias"])
    c = f * c + i * g
    return {"h": o * torch.tanh(c), "c": c}


def act_rnn_head_plain(params: dict, h):
    """Stage ``head``: ``head [N, 6]``, the 5 logits and the value of the
    cell's output rows ``h``."""
    w = torch.cat([params["logits.weight"], params["value.weight"]])
    return h @ w.T + torch.cat([params["logits.bias"], params["value.bias"]])


def act_rnn_steps_staged(cfg: EnvConfig, params: dict, state: EnvState,
                         carry, u, pick, drop, g, logits=None, mask=None):
    """K7's plain stages composed, step by step, on the rows in the
    kernel's order (row ``b A + a``): ``act_rnn_steps_reference``'s
    arguments and returns."""
    B, A = state.agent_pos.shape[:2]
    N = B * A
    lstm = cell_type_of(params) == "lstm"
    h, c = split_carry(carry, lstm)
    h = h.reshape(N, -1)
    c = None if c is None else c.reshape(N, -1)
    order = torch.arange(N)
    obs, outs = engine.observe_state(cfg, state), []
    with torch.no_grad():
        for t in range(u.shape[0]):
            x = obs.reshape(N, -1)
            for layer in range(num_encoder(params)):
                x = act_encoder_plain(params, layer, x)
            cell = act_cell_plain(params, torch.cat([x, h], 1), c)
            h, c = cell["h"], cell["c"]
            out = act.act_env_plain(cfg, state, act_rnn_head_plain(params, h),
                                    order, u[t], pick[t], drop[t], g[t],
                                    mask is not None)
            if logits is not None:
                logits[t] = out["logits"]
            if mask is not None:
                mask[t] = out["mask"]
            outs.append((obs, out["action"], out["log_prob"], out["value"],
                         out["reward"], out["delivered"]))
            state, obs = out["state"], out["obs"]
    hc = h.view(B, A, -1)
    new_carry = (c.view(B, A, -1), hc) if lstm else hc
    return (state, new_carry, *(torch.stack(x) for x in zip(*outs)))


def act_rnn_stage(stage: str, cfg: EnvConfig, params: dict,
                  state: EnvState, inputs: dict, u, pick, drop, g,
                  mask_on: bool = False, layer: int = 0) -> dict:
    """One of ``ACT_RNN_STAGES`` of one step, on rows ``b A + a``:
    ``encoder`` takes encoder layer ``layer``'s input rows ``x`` (the
    observation rows for layer 0) and gives its output ``y``; ``cell``
    takes ``eh = [e | h]`` (and the LSTM's ``c``) and gives ``h`` and
    ``c`` (None for the GRU); ``head`` takes the cell's output rows ``h``
    and gives ``head [N, 6]``; ``env`` takes ``head`` and the step's state
    and draws (``u``, ``pick``, ``drop`` ``[1, B]``, ``g [1, 5, B A]``)
    and gives ``act.act_env_plain``'s outputs. The stage's kernel on CUDA
    tensors (after the prep), its plain version on CPU ones; ``launches``
    counts the kernel launches."""
    if stage not in ACT_RNN_STAGES:
        raise ValueError(f"stage must be one of {ACT_RNN_STAGES}, "
                         f"got {stage!r}")
    n_enc = num_encoder(params)
    if stage == "encoder" and not 0 <= layer < n_enc:
        raise ValueError(f"the encoder stage runs layers 0 to {n_enc - 1}, "
                         f"got {layer}")
    dev = state.agent_pos.device
    B, A = state.agent_pos.shape[:2]
    if dev.type == "cpu":
        with torch.no_grad():
            if stage == "encoder":
                return {"y": act_encoder_plain(params, layer, inputs["x"])}
            if stage == "cell":
                return act_cell_plain(params, inputs["eh"], inputs.get("c"))
            if stage == "head":
                return {"head": act_rnn_head_plain(params, inputs["h"])}
            return act.act_env_plain(cfg, state, inputs["head"],
                                     torch.arange(B * A), u[0], pick[0],
                                     drop[0], g[0], mask_on)
    run = stage_launch(cfg, params, state, u, pick, drop, g, mask_on)
    run.launch("prep")
    obs_next = run.fill(stage, inputs, layer)
    run.launch(stage, obs_next, layer)
    act_rnn_stage.launches += 1
    return run.outputs(stage, state, obs_next, layer)


act_rnn_stage.launches = 0


def stage_launch(cfg: EnvConfig, params: dict, state: EnvState, u, pick,
                 drop, g, mask_on: bool = False) -> ActRnnLaunch:
    """An ``ActRnnLaunch`` of one step (T = 1) for the stage calls, with
    the logits (and, with ``mask_on``, the mask) kept and a zero carry:
    the cell stage's rows come from its inputs."""
    B, A = state.agent_pos.shape[:2]
    dev = state.agent_pos.device
    _, H, lstm = rnn_dims(params, cfg.obs_dim)
    h = torch.zeros(B, A, H, device=dev)
    return ActRnnLaunch(
        cfg, params, state, (torch.zeros_like(h), h) if lstm else h, u,
        pick, drop, g, torch.empty(1, B, A, 5, device=dev),
        torch.empty(1, B, A, 5, dtype=torch.bool, device=dev)
        if mask_on else None)


def _params_of(model_or_params) -> dict:
    if isinstance(model_or_params, ActorCriticRNN):
        return dict(model_or_params.named_parameters())
    return model_or_params


def _rollout(steps, cfg: EnvConfig, params, state: EnvState, carry, T: int,
             key: torch.Tensor, mask_actions: bool = False):
    if cfg.auto_reset:
        raise ValueError("ppo_rnn_rollout: auto_reset is handled by the "
                         "caller")
    if cfg.global_obs:  # the TPU kernel has none (pallas/act.py:763-764)
        raise NotImplementedError(
            "ppo_rnn_rollout: the recurrent acting kernel has no global view, "
            "as the TPU kernel has none; the recurrent trainer acts with "
            "global_obs through its per-step phase")
    params = _params_of(params)

    def run_steps(u, pick, drop, g, mask, shaping):
        new, new_carry, *outs = steps(cfg, params, state, carry, u, pick,
                                      drop, g, mask=mask)
        return (new, *outs, new_carry)

    return chunk_rollout(run_steps, cfg, state, T, key, mask_actions)


def ppo_rnn_rollout(cfg: EnvConfig, params, state: EnvState, carry, T: int,
                    key: torch.Tensor, **options):
    """T acting steps of the recurrent policy (an ``ActorCriticRNN`` or its
    params dict), through the kernel on a CUDA state: ``(EnvState,
    ActRollout, reset_key_last, next_key, new_carry)``. ``options``:
    ``mask_actions``."""
    return _rollout(act_rnn_steps, cfg, params, state, carry, T, key,
                    **options)


def ppo_rnn_rollout_reference(cfg: EnvConfig, params, state: EnvState, carry,
                              T: int, key: torch.Tensor, **options):
    """The plain PyTorch twin of ``ppo_rnn_rollout`` on any device."""
    return _rollout(act_rnn_steps_reference, cfg, params, state, carry, T,
                    key, **options)

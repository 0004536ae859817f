"""Actor-critic policies (counterpart of ``warehouse_tpu/models/policy.py``).

Ported: the feed-forward MLP, the conv-torso CNN, the attention torso and
the recurrent (GRU / LSTM) policy, each a shared-parameter per-agent
actor-critic applied to ``[..., obs_dim]`` observations, and
``MultiPolicyActorCritic``: K independent feed-forward policies selected
per sample by a group id (``make_multi_policy_model``). Initialisation
follows the flax models — orthogonal kernels with gain √2 on the hidden
(encoder) layers, 0.01 on the logits head and 1.0 on the value head,
lecun-normal input kernels and orthogonal recurrent kernels in the cell,
lecun-normal convs, trunk and attention layers (flax's defaults), the
attention's positional embedding normal(0.02), unit LayerNorm scales, zero
biases — drawn from an explicit ``torch.Generator`` (the numbers differ
from flax's; ``params_from_flax`` carries a flax model's weights over).

The CNN (``ActorCriticCNN``) splits the flat observation into the grid
``[S, S, C]`` (channel-last, as ``ops/obs.py`` lays it out) and the 6 self
features; 3x3 ``SAME`` convs with relu; the result is flattened
channel-last (``(r * S + c) * OC + oc``, flax's NHWC order, so the trunk's
columns are flax's) and the features are joined after it; a tanh trunk;
the two heads.

The attention torso (``ActorCriticAttn``, flax ``ActorCriticAttn``) makes
one token of each of the S x S grid cells (its C channels through a Dense
to ``d_model``, plus a learned positional embedding) and one [task] token
first (the 6 self features through a Dense), then ``num_blocks`` pre-LN
encoder blocks (LayerNorm, 4-head self-attention, residual; LayerNorm,
Dense to 4 d, the tanh-approximated gelu, Dense back, residual), a final
LayerNorm of the [task] token and the two heads. flax's defaults are
written out: LayerNorm's epsilon 1e-6 and its mean and variance as ``E[x]``
and ``E[x²] - E[x]²``; the query divided by ``sqrt(d / heads)`` before its
product with the keys; the query, key and value kernels ``[d, heads, d /
heads]`` and the out kernel ``[heads, d / heads, d]`` held as ``Linear``
weights ``[heads * d / heads, d]`` and ``[d, heads * d / heads]``.

The recurrent cells are flax 0.12's, written out as explicit ``Linear``
layers named like flax's sub-modules (``torch.nn.GRUCell``/``LSTMCell``
order their gates and place their biases differently):

- GRU: ``r = σ(W_ir x + b_ir + W_hr h)``, ``z = σ(W_iz x + b_iz + W_hz h)``,
  ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``, ``h' = (1 - z) n + z h``
  (biases on ``ir``, ``iz``, ``in``, ``hn`` only); carry ``h``.
- LSTM (``OptimizedLSTMCell``): ``i, f, o = σ(W_i* x + W_h* h + b_h*)``,
  ``g = tanh(W_ig x + W_hg h + b_hg)``, ``c' = f c + i g``,
  ``h' = o tanh(c')`` (biases on the ``h*`` side only); carry ``(c, h)``.

The apply functions take one ``precision`` of three (``PRECISIONS``),
each on float32 params: ``"float32"``, and two bfloat16 modes:

- ``"flax_bf16"`` is the flax model built with ``dtype=bfloat16`` (a
  model made with ``dtype="bfloat16"``; the trainers' last value and
  bootstrap, serving): the observation is
  cast to bf16; each Dense or Conv is the float32 product of the rounded
  operands, rounded, then its bias added in bf16; every activation and
  gate op runs on bf16 values, rounding its result (torch's bf16
  elementwise ops, as XLA lowers flax's: a sigmoid is ``1 / (1 +
  exp(-x))``, each op rounded); logits and value come out float32. The
  recurrent carry is bf16. The attention's LayerNorms take their
  statistics in float32 and round their output, as flax's do; its softmax
  is bf16 ops (``exp(x - max) / sum``); its positional
  embedding is a float32 param rounded where it is added (flax keeps it in
  bf16).
- ``"bf16_operands"`` is the learner kernels' ``matmul_dtype="bfloat16"``
  (``pallas/sgd.py:181-191``): each product rounds both of its operands to
  bf16 and accumulates in float32, its backward too (``Bf16Linear``,
  ``Bf16Conv``), and everything else stays float32. The SGD twins use it.

Every convolution, forward and backward, runs under ``conv_flags``: on
the card cuDNN's float32 convolutions are IEEE float32 (torch's default is
TF32) and deterministic, so the plain CNN learner gives the same bits on
every run.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..config import EnvConfig
from ..device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(dtype) -> torch.dtype:
    """``"float32"`` / ``"bfloat16"`` (``TrainConfig.model_dtype``'s names)
    or the torch dtype itself, as the torch dtype."""
    if dtype in DTYPES.values():
        return dtype
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {sorted(DTYPES)}, got "
                         f"{dtype!r}")
    return DTYPES[dtype]


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to the nearest bfloat16 (ties to even, as XLA's
    convert and ``__float2bfloat16_rn``), kept in ``x``'s dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


class Bf16Linear(torch.autograd.Function):
    """``x @ w.T`` on bf16-rounded operands with float32 accumulation, and
    its backward written out as the TPU kernel's products: ``r(g) @ r(w)``
    and ``r(g).T @ r(x)``, each rounding its operands. (Autograd through
    ``.bfloat16().float()`` casts would instead round each gradient after
    its product.)"""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = bf16_round(x), bf16_round(w)
        ctx.save_for_backward(xr, wr)
        return F.linear(xr, wr)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = bf16_round(g)
        gx = gr @ wr if ctx.needs_input_grad[0] else None
        gw = (gr.reshape(-1, gr.shape[-1]).T @ xr.reshape(-1, xr.shape[-1])
              if ctx.needs_input_grad[1] else None)
        return gx, gw


@contextlib.contextmanager
def conv_flags():
    """cuDNN's float32 convolutions in IEEE float32, with deterministic
    algorithms and no autotuning, whatever the global flags say: torch's
    default runs them in TF32 (about 3 decimal digits), and cuDNN's
    fastest weight-gradient algorithms sum in an order that varies from run
    to run. The precision is set through ``cudnn.conv.fp32_precision``
    alone: ``cudnn.flags(allow_tf32=...)`` reads the legacy flag, which
    raises where a caller set the new one, and ``flags()`` with its
    defaults turns cuDNN off. The flags are global, so autograd's backward
    thread sees them too; each ``Function`` below sets them in its backward
    as well as its forward."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
             cudnn.conv.fp32_precision)
    cudnn.enabled, cudnn.benchmark, cudnn.deterministic = True, False, True
    cudnn.conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        cudnn.enabled, cudnn.benchmark, cudnn.deterministic = saved[:3]
        cudnn.conv.fp32_precision = saved[3]


def _conv_grads(ctx, g, x, w, bias: bool):
    """The input, weight and bias gradients of the 3x3 ``SAME``
    convolution that ``ctx`` needs (``aten.convolution_backward``, autograd's
    own call for ``F.conv2d``), under ``conv_flags``."""
    with conv_flags():
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g, x, w, [w.shape[0]] if bias else None, [1, 1], [1, 1], [1, 1],
            False, [0, 0], 1,
            [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
             bias and ctx.needs_input_grad[2]])
    return gx, gw, gb


class F32Conv(torch.autograd.Function):
    """``F.conv2d(x, w, b, padding=1)``, the 3x3 ``SAME`` convolution of
    ``x [N, IC, S, S]`` with ``w [OC, IC, 3, 3]`` (and bias ``b [OC]`` or
    None), forward and backward under ``conv_flags``: IEEE float32 and the
    same bits on every run."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.bias = b is not None
        with conv_flags():
            return F.conv2d(x, w, b, padding=1)

    @staticmethod
    def backward(ctx, g):
        return _conv_grads(ctx, g, *ctx.saved_tensors, ctx.bias)


class Bf16Conv(torch.autograd.Function):
    """The 3x3 ``SAME`` convolution of ``x [N, IC, S, S]`` with ``w [OC,
    IC, 3, 3]`` on bf16-rounded operands with float32 accumulation; its
    backward convolves the rounded gradient with the rounded other
    operand. Both under ``conv_flags``."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = bf16_round(x), bf16_round(w)
        ctx.save_for_backward(xr, wr)
        with conv_flags():
            return F.conv2d(xr, wr, padding=1)

    @staticmethod
    def backward(ctx, g):
        return _conv_grads(ctx, bf16_round(g), *ctx.saved_tensors,
                           False)[:2]


PRECISIONS = ("float32", "bf16_operands", "flax_bf16")


def model_precision(dtype) -> str:
    """The precision of a model at compute ``dtype``: ``"flax_bf16"`` for
    bfloat16, else ``"float32"``."""
    return "flax_bf16" if torch_dtype(dtype) == torch.bfloat16 else "float32"


class Precision:
    """The products and casts of one apply at ``precision`` (one of
    ``PRECISIONS``): float32 (``F.linear`` / ``F.conv2d`` as they were),
    the kernels' bf16 operands or the flax-bf16 forward."""

    def __init__(self, precision="float32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got "
                             f"{precision!r}")
        self.operands = precision == "bf16_operands"
        self.flax = precision == "flax_bf16"

    def input(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16) if self.flax else x

    def output(self, x: torch.Tensor) -> torch.Tensor:
        return x.float() if self.flax else x

    def sigmoid(self, x: torch.Tensor) -> torch.Tensor:
        """``jax.nn.sigmoid``: on bf16 values XLA computes ``1 / (1 +
        exp(-x))`` one op at a time, each result rounded to bf16."""
        if self.flax:
            return 1.0 / (1.0 + torch.exp(-x))
        return torch.sigmoid(x)

    def linear(self, x, w, b=None):
        if self.operands:
            y = Bf16Linear.apply(x, w)
        elif self.flax:
            y = F.linear(bf16_round(x.float()), bf16_round(w)).bfloat16()
        else:
            return F.linear(x, w, b)
        return y if b is None else y + b.to(y.dtype)

    def conv(self, x, w, b):
        if self.operands:
            y = Bf16Conv.apply(x, w)
        elif self.flax:
            y = F32Conv.apply(bf16_round(x.float()), bf16_round(w),
                              None).bfloat16()
        else:
            return F32Conv.apply(x, w, b)
        return y + b.to(y.dtype)[:, None, None]


class ActorCriticMLP(nn.Module):
    def __init__(self, obs_dim: int, num_actions: int,
                 hidden_dims: Sequence[int] = (128, 128),
                 generator: torch.Generator | None = None,
                 dtype="float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)  # the compute dtype, as flax's
        dims = (obs_dim, *hidden_dims)
        self.hidden = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.logits = nn.Linear(dims[-1], num_actions)
        self.value = nn.Linear(dims[-1], 1)
        gains = [math.sqrt(2.0)] * len(self.hidden) + [0.01, 1.0]
        with torch.no_grad():
            for layer, gain in zip(self.layers(), gains):
                nn.init.orthogonal_(layer.weight, gain, generator=generator)
                layer.bias.zero_()

    def layers(self) -> list[nn.Linear]:
        """Hidden layers, then the logits head, then the value head."""
        return [*self.hidden, self.logits, self.value]

    def forward(self, obs: torch.Tensor):
        """obs float32[..., obs_dim] -> (logits [..., 5], value [...])."""
        return apply(dict(self.named_parameters()), obs,
                     precision=model_precision(self.dtype))


def num_hidden(params: dict) -> int:
    return sum(1 for k in params if k.endswith(".weight")) - 2


def apply(params: dict, obs: torch.Tensor, group_ids=None, *,
          precision="float32"):
    """The feed-forward policy on a params dict keyed like
    ``ActorCriticMLP.state_dict``, ``ActorCriticCNN.state_dict`` or
    ``ActorCriticAttn.state_dict`` (the functional form the trainer and
    the SGD twins use); for a ``MultiPolicyActorCritic``'s dict, each
    sample's group's outputs, its group from ``group_ids`` (ints
    broadcastable to ``obs.shape[:-1]``, e.g. the ``[A]`` agent -> group
    map). ``precision``: one of ``PRECISIONS`` (the module docstring)."""
    if is_multi(params):
        if group_ids is None:
            raise ValueError("multi-policy params need the samples' "
                             "policy_groups")
        return apply_multi(params, obs, group_ids, precision=precision)
    if is_cnn(params):
        return apply_cnn(params, obs, precision=precision)
    if is_attn(params):
        return apply_attn(params, obs, precision=precision)
    pr = Precision(precision)
    x = pr.input(obs)
    for i in range(num_hidden(params)):
        x = torch.tanh(pr.linear(x, params[f"hidden.{i}.weight"],
                                 params[f"hidden.{i}.bias"]))
    value = pr.linear(x, params["value.weight"], params["value.bias"])
    return (pr.output(pr.linear(x, params["logits.weight"],
                                params["logits.bias"])),
            pr.output(value.squeeze(-1)))


CNN_CHANNELS = (16, 32)  # ActorCriticCNN's conv widths (fixed, as flax's)
N_SELF = 6               # self features after the grid in an observation


def lecun_normal_(w: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default kernel init: a normal of variance ``1 / fan_in``
    truncated at two standard deviations (and rescaled to keep that
    variance). ``w`` is ``[out, in, ...]``."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


class ActorCriticCNN(nn.Module):
    """3x3 ``SAME`` convs (relu) over the ``[S, S, C]`` grid of the
    observation, the self features joined after the channel-last flatten,
    a tanh trunk, logits and value heads."""

    def __init__(self, num_actions: int, window_size: int,
                 in_channels: int = 4,
                 channels: Sequence[int] = CNN_CHANNELS, hidden: int = 128,
                 generator: torch.Generator | None = None,
                 dtype="float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        chans = (in_channels, *channels)
        self.conv = nn.ModuleList(
            nn.Conv2d(i, o, 3, padding=1) for i, o in zip(chans, chans[1:]))
        self.trunk = nn.Linear(window_size ** 2 * chans[-1] + N_SELF, hidden)
        self.logits = nn.Linear(hidden, num_actions)
        self.value = nn.Linear(hidden, 1)
        with torch.no_grad():
            for layer in (*self.conv, self.trunk):
                lecun_normal_(layer.weight, generator)
            nn.init.orthogonal_(self.logits.weight, 0.01, generator=generator)
            nn.init.orthogonal_(self.value.weight, 1.0, generator=generator)
            for name, p in self.named_parameters():
                if name.endswith(".bias"):
                    p.zero_()

    def forward(self, obs: torch.Tensor):
        """obs float32[..., obs_dim] -> (logits [..., 5], value [...])."""
        return apply_cnn(dict(self.named_parameters()), obs,
                         precision=model_precision(self.dtype))


def is_cnn(params: dict) -> bool:
    return "conv.0.weight" in params


def num_conv(params: dict) -> int:
    return sum(1 for k in params
               if k.startswith("conv.") and k.endswith(".weight"))


def cnn_dims(params: dict) -> tuple[int, tuple[int, ...], int]:
    """``(S, chans, hidden)``: the grid side, the channel chain ``(C_in,
    c1, ...)`` and the trunk width of a CNN params dict, shapes checked."""
    chans = [params["conv.0.weight"].shape[1]]
    for i in range(num_conv(params)):
        w = params[f"conv.{i}.weight"]
        if w.shape[1:] != (chans[-1], 3, 3) or (
                params[f"conv.{i}.bias"].shape != (w.shape[0],)):
            raise ValueError(f"conv.{i}: weight {tuple(w.shape)} does not "
                             f"continue the channels {chans}")
        chans.append(w.shape[0])
    hidden, trunk_in = params["trunk.weight"].shape
    side = math.isqrt(max(trunk_in - N_SELF, 0) // chans[-1])
    if side < 1 or side * side * chans[-1] + N_SELF != trunk_in:
        raise ValueError(f"trunk.weight {tuple(params['trunk.weight'].shape)}"
                         f" does not take a square grid of {chans[-1]} "
                         f"channels and {N_SELF} features")
    return side, tuple(chans), hidden


def apply_cnn(params: dict, obs: torch.Tensor, *, precision="float32"):
    """The CNN on a params dict keyed like ``ActorCriticCNN.state_dict``."""
    pr = Precision(precision)
    S, chans, _ = cnn_dims(params)
    grid_len = S * S * chans[0]
    if obs.shape[-1] != grid_len + N_SELF:
        raise ValueError(f"obs width {obs.shape[-1]} is not the {S}x{S}x"
                         f"{chans[0]} grid plus {N_SELF} features")
    lead = obs.shape[:-1]
    obs = pr.input(obs)
    x = obs[..., :grid_len].reshape(-1, S, S, chans[0]).permute(0, 3, 1, 2)
    for i in range(len(chans) - 1):
        x = F.relu(pr.conv(x, params[f"conv.{i}.weight"],
                           params[f"conv.{i}.bias"]))
    x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # channel-last, as flax
    x = torch.cat([x, obs[..., grid_len:]], dim=-1)
    x = torch.tanh(pr.linear(x, params["trunk.weight"], params["trunk.bias"]))
    value = pr.linear(x, params["value.weight"], params["value.bias"])
    return (pr.output(pr.linear(x, params["logits.weight"],
                                params["logits.bias"])),
            pr.output(value.squeeze(-1)))


ATTN_HEADS = 4       # ActorCriticAttn's heads (flax's num_heads default)
LN_EPS = 1e-6        # flax nn.LayerNorm's epsilon


class ActorCriticAttn(nn.Module):
    """Self-attention over the S x S grid cells and a [task] token (the
    module docstring): ``d_model`` wide, ``num_blocks`` pre-LN blocks of
    ``ATTN_HEADS`` heads."""

    def __init__(self, num_actions: int, window_size: int,
                 in_channels: int = 4, d_model: int = 64,
                 num_blocks: int = 2,
                 generator: torch.Generator | None = None,
                 dtype="float32"):
        super().__init__()
        if d_model % ATTN_HEADS:
            raise ValueError(f"d_model={d_model} does not split into "
                             f"{ATTN_HEADS} heads")
        self.dtype = torch_dtype(dtype)
        d = d_model
        self.cell_embed = nn.Linear(in_channels, d)
        self.pos_embed = nn.Parameter(torch.empty(window_size ** 2, d))
        self.task_embed = nn.Linear(N_SELF, d)
        self.blocks = nn.ModuleList(nn.ModuleDict({
            "ln1": nn.LayerNorm(d, eps=LN_EPS),
            "q": nn.Linear(d, d), "k": nn.Linear(d, d), "v": nn.Linear(d, d),
            "out": nn.Linear(d, d),
            "ln2": nn.LayerNorm(d, eps=LN_EPS),
            "mlp_in": nn.Linear(d, 4 * d), "mlp_out": nn.Linear(4 * d, d)})
            for _ in range(num_blocks))
        self.ln_f = nn.LayerNorm(d, eps=LN_EPS)
        self.logits = nn.Linear(d, num_actions)
        self.value = nn.Linear(d, 1)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".bias"):
                    p.zero_()
            for ln in (self.ln_f, *(b[n] for b in self.blocks
                                    for n in ("ln1", "ln2"))):
                ln.weight.fill_(1.0)
            layers = [self.cell_embed, self.task_embed, *(
                blk[n] for blk in self.blocks
                for n in ("q", "k", "v", "out", "mlp_in", "mlp_out"))]
            for layer in layers:
                lecun_normal_(layer.weight, generator)
            nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
            nn.init.orthogonal_(self.logits.weight, 0.01, generator=generator)
            nn.init.orthogonal_(self.value.weight, 1.0, generator=generator)

    def forward(self, obs: torch.Tensor):
        """obs float32[..., obs_dim] -> (logits [..., 5], value [...])."""
        return apply_attn(dict(self.named_parameters()), obs,
                          precision=model_precision(self.dtype))


def is_attn(params: dict) -> bool:
    return "pos_embed" in params


def num_blocks(params: dict) -> int:
    return sum(1 for k in params
               if k.startswith("blocks.") and k.endswith(".q.weight"))


def _layer_norm(pr: Precision, x, w, b):
    """flax ``nn.LayerNorm``: float32 statistics ``E[x]``, ``E[x²] -
    E[x]²`` (floored at 0), ``(x - mean) * (rsqrt(var + eps) * scale) +
    bias``; rounded to bf16 at the flax-bf16 precision."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * w)
    return (y + b).to(x.dtype)


def _gelu(x):
    """``jax.nn.gelu(x, approximate=True)`` in its operation order."""
    c = math.sqrt(2.0 / math.pi)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x)))))


def _product(pr: Precision, a, b):
    """``a @ b`` of two activations: float32, or at the flax-bf16 precision
    the float32 product of the rounded operands, rounded."""
    if pr.flax:
        return (a.float() @ b.float()).bfloat16()
    return a @ b


def apply_attn(params: dict, obs: torch.Tensor, *, precision="float32"):
    """The attention torso on a params dict keyed like
    ``ActorCriticAttn.state_dict``, at ``precision`` "float32" or
    "flax_bf16" (no learner kernel takes it, so it has no bf16-operands
    form)."""
    pr = Precision(precision)
    if pr.operands:
        raise ValueError("the attention torso has no bf16_operands form: no "
                         "learner kernel computes it")
    d, C = params["cell_embed.weight"].shape
    SS = params["pos_embed"].shape[0]
    grid_len = SS * C
    if obs.shape[-1] != grid_len + N_SELF:
        raise ValueError(f"obs width {obs.shape[-1]} is not {SS} cells of {C}"
                         f" channels plus {N_SELF} features")
    lead = obs.shape[:-1]
    obs = pr.input(obs).reshape(-1, obs.shape[-1])
    N, h = obs.shape[0], ATTN_HEADS

    def lin(name, x):
        return pr.linear(x, params[f"{name}.weight"], params[f"{name}.bias"])

    cells = obs[:, :grid_len].reshape(N, SS, C)
    x = lin("cell_embed", cells) + params["pos_embed"].to(obs.dtype)
    task = lin("task_embed", obs[:, grid_len:])[:, None]
    x = torch.cat([task, x], dim=1)                      # [N, 1 + S*S, d]
    L = x.shape[1]
    depth = torch.tensor(d // h, dtype=torch.float32).sqrt().to(obs.dtype)
    for i in range(num_blocks(params)):
        blk = f"blocks.{i}"
        y = _layer_norm(pr, x, params[f"{blk}.ln1.weight"],
                        params[f"{blk}.ln1.bias"])
        q, k, v = (lin(f"{blk}.{n}", y).reshape(N, L, h, d // h)
                   .transpose(1, 2) for n in "qkv")      # [N, h, L, d/h]
        scores = _product(pr, q / depth, k.transpose(-1, -2))
        e = torch.exp(scores - scores.amax(-1, keepdim=True))
        w = e / e.sum(-1, keepdim=True)  # jax.nn.softmax, at bf16 too
        y = _product(pr, w, v).transpose(1, 2).reshape(N, L, d)
        x = x + lin(f"{blk}.out", y)
        y = _layer_norm(pr, x, params[f"{blk}.ln2.weight"],
                        params[f"{blk}.ln2.bias"])
        x = x + lin(f"{blk}.mlp_out", _gelu(lin(f"{blk}.mlp_in", y)))
    y = _layer_norm(pr, x[:, 0], params["ln_f.weight"], params["ln_f.bias"])
    value = lin("value", y).squeeze(-1)
    return (pr.output(lin("logits", y)).reshape(*lead, -1),
            pr.output(value).reshape(lead))


GRU_GATES = ("ir", "iz", "in", "hr", "hz", "hn")   # flax GRUCell sub-modules
GRU_BIASED = ("ir", "iz", "in", "hn")
LSTM_GATES = ("ii", "if", "ig", "io", "hi", "hf", "hg", "ho")
LSTM_BIASED = ("hi", "hf", "hg", "ho")


def cell_gates(cell_type: str) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(gate names, the biased ones) of a cell type."""
    if cell_type == "gru":
        return GRU_GATES, GRU_BIASED
    if cell_type == "lstm":
        return LSTM_GATES, LSTM_BIASED
    raise ValueError(f"unknown cell_type {cell_type!r}")


class ActorCriticRNN(nn.Module):
    """Encoder (tanh ``Linear`` layers) -> GRU/LSTM cell -> logits and value
    heads. ``forward(obs, carry) -> (logits, value, new_carry)``, one
    step; the carry is ``h [..., H]`` (GRU) or ``(c, h)`` (LSTM)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 cell_type: str = "gru", hidden_dims: Sequence[int] = (128,),
                 rnn_hidden: int = 128,
                 generator: torch.Generator | None = None,
                 dtype="float32"):
        super().__init__()
        self.dtype = torch_dtype(dtype)
        gates, biased = cell_gates(cell_type)
        self.cell_type, self.rnn_hidden = cell_type, rnn_hidden
        dims = (obs_dim, *hidden_dims)
        self.encoder = nn.ModuleList(
            nn.Linear(i, o) for i, o in zip(dims[:-1], dims[1:]))
        self.cell = nn.ModuleDict({
            g: nn.Linear(dims[-1] if g[0] == "i" else rnn_hidden, rnn_hidden,
                         bias=g in biased) for g in gates})
        self.logits = nn.Linear(rnn_hidden, num_actions)
        self.value = nn.Linear(rnn_hidden, 1)
        with torch.no_grad():
            for layer in self.encoder:
                nn.init.orthogonal_(layer.weight, math.sqrt(2.0),
                                    generator=generator)
            for g in gates:
                w = self.cell[g].weight
                if g[0] == "i":   # lecun_normal: std = sqrt(1 / fan_in)
                    nn.init.normal_(w, 0.0, 1.0 / math.sqrt(w.shape[1]),
                                    generator=generator)
                else:
                    nn.init.orthogonal_(w, generator=generator)
            nn.init.orthogonal_(self.logits.weight, 0.01, generator=generator)
            nn.init.orthogonal_(self.value.weight, 1.0, generator=generator)
            for name, p in self.named_parameters():
                if name.endswith(".bias"):
                    p.zero_()

    def forward(self, obs: torch.Tensor, carry):
        return apply_rnn(dict(self.named_parameters()), obs, carry,
                         precision=model_precision(self.dtype))

    def initial_carry(self, batch_shape: tuple, device=None):
        """Zero carry for a batch (the episode-start state), on the
        model's device unless told otherwise; bf16 in a bf16 model."""
        device = device or self.logits.weight.device
        return initial_carry(self.cell_type, batch_shape, self.rnn_hidden,
                             device, self.dtype)


def initial_carry(cell_type: str, batch_shape: tuple, rnn_hidden: int,
                  device=None, dtype="float32"):
    h = torch.zeros(*batch_shape, rnn_hidden, dtype=torch_dtype(dtype),
                    device=device)
    return (h, h.clone()) if cell_type == "lstm" else h


def cell_type_of(params: dict) -> str:
    """"gru" or "lstm", from a recurrent policy's params dict."""
    if "cell.hr.weight" in params:
        return "gru"
    if "cell.hi.weight" in params:
        return "lstm"
    raise ValueError("not a recurrent policy's params: no cell.* entries")


def num_encoder(params: dict) -> int:
    return sum(1 for k in params
               if k.startswith("encoder.") and k.endswith(".weight"))


def apply_rnn(params: dict, obs: torch.Tensor, carry, *,
              precision="float32"):
    """One step of the recurrent policy on a params dict keyed like
    ``ActorCriticRNN.state_dict``: ``(logits, value, new_carry)``. At
    ``precision="flax_bf16"`` the carry is bf16 (flax's cell with
    ``dtype=bfloat16``: each inner Dense rounds, the gate arithmetic runs
    in bf16)."""
    pr = Precision(precision)

    def lin(name, x):
        return pr.linear(x, params[f"{name}.weight"],
                         params.get(f"{name}.bias"))

    x = pr.input(obs)
    for i in range(num_encoder(params)):
        x = torch.tanh(lin(f"encoder.{i}", x))
    sigmoid = pr.sigmoid
    if cell_type_of(params) == "gru":
        h = carry
        r = sigmoid(lin("cell.ir", x) + lin("cell.hr", h))
        z = sigmoid(lin("cell.iz", x) + lin("cell.hz", h))
        n = torch.tanh(lin("cell.in", x) + r * lin("cell.hn", h))
        h = (1.0 - z) * n + z * h
        carry = h
    else:
        c, h = carry
        i = sigmoid(lin("cell.ii", x) + lin("cell.hi", h))
        f = sigmoid(lin("cell.if", x) + lin("cell.hf", h))
        g = torch.tanh(lin("cell.ig", x) + lin("cell.hg", h))
        o = sigmoid(lin("cell.io", x) + lin("cell.ho", h))
        c = f * c + i * g
        h = o * torch.tanh(c)
        carry = (c, h)
    return (pr.output(lin("logits", h)), pr.output(lin("value", h).squeeze(-1)),
            carry)


FEED_FORWARD = ("mlp", "cnn", "attn")  # the archs without a carry


def make_model(cfg: EnvConfig, arch: str = "mlp", hidden_dim: int = 128,
               num_layers: int = 2, generator: torch.Generator | None = None,
               device=None, dtype="float32") -> nn.Module:
    """The policy for ``arch`` ("mlp", "cnn", "attn", "gru" or "lstm") on
    ``device``: the card by default, the CPU with ``device="cpu"``;
    ``dtype`` its compute dtype (float32 params either way). The CNN
    ignores ``num_layers``; the attention torso is ``hidden_dim // 2``
    wide with ``num_layers`` blocks (flax ``make_model``). The grid of
    both is the ego window, or the whole (square) grid with
    ``cfg.global_obs``."""
    if arch == "mlp":
        model = ActorCriticMLP(cfg.obs_dim, cfg.num_actions,
                               (hidden_dim,) * num_layers, generator, dtype)
    elif arch == "cnn":
        if cfg.global_obs and cfg.height != cfg.width:
            raise ValueError("cnn+global_obs requires a square grid")
        model = ActorCriticCNN(
            cfg.num_actions, cfg.height if cfg.global_obs else cfg.window_size,
            cfg.num_obs_channels, hidden=hidden_dim, generator=generator,
            dtype=dtype)
    elif arch == "attn":
        if cfg.global_obs and cfg.height != cfg.width:
            raise ValueError("attn+global_obs requires a square grid")
        model = ActorCriticAttn(
            cfg.num_actions, cfg.height if cfg.global_obs else cfg.window_size,
            cfg.num_obs_channels, hidden_dim // 2, num_layers, generator,
            dtype)
    elif arch in ("gru", "lstm"):
        model = ActorCriticRNN(cfg.obs_dim, cfg.num_actions, arch,
                               (hidden_dim,) * max(num_layers - 1, 1),
                               hidden_dim, generator, dtype)
    else:
        raise ValueError(f"unknown arch {arch!r}")
    return model.to(resolve_device(device))


class MultiPolicyActorCritic(nn.Module):
    """K independent feed-forward policies (``policies``: MLP, CNN or
    attention) with
    a static agent -> policy map (RLlib's ``policy_mapping_fn``):
    ``forward(obs, group_ids)`` returns each sample's group's ``(logits,
    value)``. All K sub-models run on every sample and each sample takes
    its group's outputs by index (``torch.where``); flax's one-hot sum
    gives the same values wherever the outputs are finite."""

    def __init__(self, policies: Sequence[nn.Module]):
        super().__init__()
        self.policies = nn.ModuleList(policies)

    def forward(self, obs: torch.Tensor, group_ids):
        return apply_multi(dict(self.named_parameters()), obs, group_ids,
                           precision=model_precision(self.policies[0].dtype))


def is_multi(params: dict) -> bool:
    return any(k.startswith("policies.") for k in params)


def num_groups(params: dict) -> int:
    return len({k.split(".")[1] for k in params if k.startswith("policies.")})


def group_params(params: dict, g: int) -> dict:
    """Group ``g``'s sub-model params of a multi-policy dict, keyed like
    the sub-model's own ``state_dict``."""
    prefix = f"policies.{g}."
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def apply_multi(params: dict, obs: torch.Tensor, group_ids, *,
                precision="float32"):
    """``MultiPolicyActorCritic`` on its params dict: every group's
    sub-model on all of ``obs``, then each sample's group's outputs;
    ``precision`` as ``apply``'s."""
    gids = torch.as_tensor(group_ids, device=obs.device)
    logits = value = None
    for g in range(num_groups(params)):
        lg, v = apply(group_params(params, g), obs, precision=precision)
        if logits is None:
            logits, value = lg, v
        else:
            sel = gids == g
            logits = torch.where(sel[..., None], lg, logits)
            value = torch.where(sel, v, value)
    return logits, value


def make_multi_policy_model(cfg: EnvConfig, policy_groups, arch: str = "mlp",
                            hidden_dim: int = 128, num_layers: int = 2,
                            generator: torch.Generator | None = None,
                            device=None,
                            dtype="float32") -> MultiPolicyActorCritic:
    """K sub-models of ``arch`` ("mlp", "cnn" or "attn", drawn from
    ``generator`` in group order, at compute ``dtype``) for
    ``policy_groups``, a tuple of one group id ``0..K-1`` per agent, on
    ``device`` (the card by default); raises the JAX package's two ``ValueError``s for another
    map."""
    if len(policy_groups) != cfg.num_agents:
        raise ValueError("policy_groups must have one entry per agent")
    k = max(policy_groups) + 1
    if sorted(set(policy_groups)) != list(range(k)):
        raise ValueError("group ids must be 0..K-1 with no gaps")
    if arch not in FEED_FORWARD:
        raise ValueError(f"policy_groups with arch={arch!r}: the groups "
                         "take feed-forward policies")
    return MultiPolicyActorCritic(
        [make_model(cfg, arch, hidden_dim, num_layers, generator, device,
                    dtype) for _ in range(k)]).to(resolve_device(device))


def _dense_np(sub, name: str, fan_in, bias: bool = True):
    """A flax Dense's ``kernel [in, out]`` (and bias) as ``Linear`` weight
    ``[out, in]`` (and bias), shapes checked."""
    kernel = np.asarray(sub["kernel"], np.float32)
    if kernel.ndim != 2 or (fan_in is not None and kernel.shape[0] != fan_in):
        raise ValueError(f"{name}: kernel {kernel.shape}, expected input "
                         f"width {fan_in}")
    if ("bias" in sub) != bias:
        raise ValueError(f"{name}: bias {'missing' if bias else 'unexpected'}")
    out = {"weight": torch.from_numpy(kernel.T.copy())}
    if bias:
        b = np.asarray(sub["bias"], np.float32)
        if b.shape != (kernel.shape[1],):
            raise ValueError(f"{name}: kernel {kernel.shape}, bias {b.shape}")
        out["bias"] = torch.from_numpy(b.copy())
    return out


def _rnn_params_from_flax(dense: dict) -> dict:
    """The ``ActorCriticRNN`` tree: ``Dense_*`` in index order are the
    encoder layers, then the logits and value heads (the heads come after
    the cell in call order); ``GRUCell_0`` / ``OptimizedLSTMCell_0`` hold
    one sub-module per gate."""
    cell_name = "GRUCell_0" if "GRUCell_0" in dense else "OptimizedLSTMCell_0"
    cell_type = "gru" if cell_name == "GRUCell_0" else "lstm"
    gates, biased = cell_gates(cell_type)
    names = sorted((n for n in dense if n.startswith("Dense_")),
                   key=lambda s: int(s.split("_")[1]))
    extra = set(dense) - set(names) - {cell_name}
    if len(names) < 3 or extra:
        raise ValueError(f"not a recurrent actor-critic: layers "
                         f"{sorted(dense)}")
    *enc_n, logit_n, value_n = names
    out, fan_in = {}, None
    for i, name in enumerate(enc_n):
        layer = _dense_np(dense[name], name, fan_in)
        fan_in = layer["weight"].shape[0]
        out.update({f"encoder.{i}.{k}": v for k, v in layer.items()})
    cell = dense[cell_name]
    if set(cell) != set(gates):
        raise ValueError(f"{cell_name}: gates {sorted(cell)}, expected "
                         f"{sorted(gates)}")
    H = np.asarray(cell[gates[-1]]["kernel"]).shape[1]
    for g in gates:
        layer = _dense_np(cell[g], f"{cell_name}/{g}",
                          fan_in if g[0] == "i" else H, bias=g in biased)
        if layer["weight"].shape[0] != H:
            raise ValueError(f"{cell_name}/{g}: {layer['weight'].shape[0]} "
                             f"outputs, expected {H}")
        out.update({f"cell.{g}.{k}": v for k, v in layer.items()})
    for key, name in (("logits", logit_n), ("value", value_n)):
        layer = _dense_np(dense[name], name, H)
        out.update({f"{key}.{k}": v for k, v in layer.items()})
    if out["value.weight"].shape[0] != 1:
        raise ValueError(f"{value_n}: value head has "
                         f"{out['value.weight'].shape[0]} outputs, expected 1")
    return out


def _cnn_params_from_flax(dense: dict) -> dict:
    """The ``ActorCriticCNN`` tree: ``Conv_i`` kernels ``[3, 3, IC, OC]``
    become ``conv.i.weight [OC, IC, 3, 3]``; ``Dense_0`` is the trunk,
    ``Dense_1`` the logits head and ``Dense_2`` the value head."""
    convs = sorted((n for n in dense if n.startswith("Conv_")),
                   key=lambda s: int(s.split("_")[1]))
    if set(dense) - set(convs) != {"Dense_0", "Dense_1", "Dense_2"}:
        raise ValueError(f"not a CNN actor-critic: layers {sorted(dense)}")
    out, chan = {}, None
    for i, name in enumerate(convs):
        kernel = np.asarray(dense[name]["kernel"], np.float32)
        bias = np.asarray(dense[name]["bias"], np.float32)
        if (kernel.ndim != 4 or kernel.shape[:2] != (3, 3)
                or chan not in (None, kernel.shape[2])
                or bias.shape != (kernel.shape[3],)):
            raise ValueError(f"{name}: kernel {kernel.shape}, bias "
                             f"{bias.shape}, expected [3, 3, "
                             f"{chan or 'IC'}, OC] and [OC]")
        chan = kernel.shape[3]
        out[f"conv.{i}.weight"] = torch.from_numpy(
            kernel.transpose(3, 2, 0, 1).copy())
        out[f"conv.{i}.bias"] = torch.from_numpy(bias.copy())
    fan_in = None
    for key, name in (("trunk", "Dense_0"), ("logits", "Dense_1"),
                      ("value", "Dense_2")):
        layer = _dense_np(dense[name], name, fan_in)
        if key == "trunk":
            fan_in = layer["weight"].shape[0]
        out.update({f"{key}.{k}": v for k, v in layer.items()})
    if out["value.weight"].shape[0] != 1:
        raise ValueError(f"Dense_2: value head has "
                         f"{out['value.weight'].shape[0]} outputs, expected 1")
    cnn_dims(out)  # the trunk takes the last conv's square grid + features
    return out


def _attn_params_from_flax(dense: dict) -> dict:
    """The ``ActorCriticAttn`` tree: ``Dense_0`` the cell embedding,
    ``Dense_1`` the task embedding, ``pos_embed``; block i's
    ``LayerNorm_{2i}``, ``MultiHeadDotProductAttention_i`` (query / key /
    value kernels ``[d, heads, d / heads]``, out ``[heads, d / heads,
    d]``), ``LayerNorm_{2i+1}``, ``Dense_{2+2i}`` and ``Dense_{3+2i}``; the
    last LayerNorm, then the logits and value heads."""
    nb = sum(1 for n in dense if n.startswith("MultiHeadDotProductAttention_"))
    want = ({"pos_embed", "Dense_0", "Dense_1"}
            | {f"Dense_{i}" for i in range(2, 4 + 2 * nb)}
            | {f"LayerNorm_{i}" for i in range(2 * nb + 1)}
            | {f"MultiHeadDotProductAttention_{i}" for i in range(nb)})
    if set(dense) != want:
        raise ValueError(f"not an attention actor-critic: layers "
                         f"{sorted(dense)}")
    pos = np.asarray(dense["pos_embed"], np.float32)
    d = pos.shape[1]
    out = {"pos_embed": torch.from_numpy(pos.copy())}

    def dense_at(key, name, fan_in):
        layer = _dense_np(dense[name], name, fan_in)
        out.update({f"{key}.{k}": v for k, v in layer.items()})

    def norm_at(key, name):
        sub = dense[name]
        for k, flax_k in (("weight", "scale"), ("bias", "bias")):
            v = np.asarray(sub[flax_k], np.float32)
            if v.shape != (d,):
                raise ValueError(f"{name}/{flax_k}: {v.shape}, expected "
                                 f"({d},)")
            out[f"{key}.{k}"] = torch.from_numpy(v.copy())

    dense_at("cell_embed", "Dense_0", None)
    dense_at("task_embed", "Dense_1", N_SELF)
    for i in range(nb):
        blk = f"blocks.{i}"
        norm_at(f"{blk}.ln1", f"LayerNorm_{2 * i}")
        mha = dense[f"MultiHeadDotProductAttention_{i}"]
        for n, flax_n in (("q", "query"), ("k", "key"), ("v", "value")):
            kernel = np.asarray(mha[flax_n]["kernel"], np.float32)
            if kernel.shape != (d, ATTN_HEADS, d // ATTN_HEADS):
                raise ValueError(f"{flax_n}: kernel {kernel.shape}, expected "
                                 f"{(d, ATTN_HEADS, d // ATTN_HEADS)}")
            out[f"{blk}.{n}.weight"] = torch.from_numpy(
                kernel.reshape(d, d).T.copy())
            out[f"{blk}.{n}.bias"] = torch.from_numpy(np.asarray(
                mha[flax_n]["bias"], np.float32).reshape(d).copy())
        kernel = np.asarray(mha["out"]["kernel"], np.float32)
        if kernel.shape != (ATTN_HEADS, d // ATTN_HEADS, d):
            raise ValueError(f"out: kernel {kernel.shape}, expected "
                             f"{(ATTN_HEADS, d // ATTN_HEADS, d)}")
        out[f"{blk}.out.weight"] = torch.from_numpy(
            kernel.reshape(d, d).T.copy())
        out[f"{blk}.out.bias"] = torch.from_numpy(
            np.asarray(mha["out"]["bias"], np.float32).copy())
        norm_at(f"{blk}.ln2", f"LayerNorm_{2 * i + 1}")
        dense_at(f"{blk}.mlp_in", f"Dense_{2 + 2 * i}", d)
        dense_at(f"{blk}.mlp_out", f"Dense_{3 + 2 * i}", 4 * d)
    norm_at("ln_f", f"LayerNorm_{2 * nb}")
    dense_at("logits", f"Dense_{2 + 2 * nb}", d)
    dense_at("value", f"Dense_{3 + 2 * nb}", d)
    if out["value.weight"].shape[0] != 1:
        raise ValueError("the value head has "
                         f"{out['value.weight'].shape[0]} outputs, expected 1")
    return out


def params_from_flax(params_np) -> dict:
    """A flax ``ActorCriticMLP``'s, ``ActorCriticCNN``'s,
    ``ActorCriticAttn``'s or ``ActorCriticRNN``'s params (nested dict of
    numpy arrays, with or without the top ``"params"`` level) as the
    ``state_dict`` of this module's counterpart. ``Dense_i`` are taken in index order — hidden
    (encoder) layers or the CNN's trunk, logits head, value head — and
    each kernel ``[in, out]`` becomes a ``Linear.weight [out, in]``; a
    recurrent tree's cell gates become ``cell.<gate>.*``, a CNN tree's
    ``Conv_i`` become ``conv.i.*``, an attention tree's layers the names
    of ``_attn_params_from_flax``. A ``MultiPolicyActorCritic`` tree
    (``policies_g`` sub-trees, g = 0..K-1) becomes ``policies.g.*`` keys,
    each sub-tree converted as above. Every shape is checked."""
    dense = params_np.get("params", params_np)
    if any(n.startswith("policies_") for n in dense):
        names = {f"policies_{g}" for g in range(len(dense))}
        if set(dense) != names:
            raise ValueError(f"not a multi-policy tree with groups 0..K-1: "
                             f"{sorted(dense)}")
        return {f"policies.{g}.{k}": v for g in range(len(dense))
                for k, v in params_from_flax(dense[f"policies_{g}"]).items()}
    if "GRUCell_0" in dense or "OptimizedLSTMCell_0" in dense:
        return _rnn_params_from_flax(dense)
    if "pos_embed" in dense:
        return _attn_params_from_flax(dense)
    if any(n.startswith("Conv_") for n in dense):
        return _cnn_params_from_flax(dense)
    names = sorted(dense, key=lambda s: int(s.split("_")[1]))
    if len(names) < 2 or any(not n.startswith("Dense_") for n in names):
        raise ValueError(f"not an MLP actor-critic: layers {names}")
    keys = [f"hidden.{i}" for i in range(len(names) - 2)] + ["logits",
                                                             "value"]
    out, fan_in = {}, None
    for key, name in zip(keys, names):
        layer = _dense_np(dense[name], name, fan_in)
        if key != "logits":
            fan_in = layer["weight"].shape[0]
        out.update({f"{key}.{k}": v for k, v in layer.items()})
    if out["value.weight"].shape[0] != 1:
        raise ValueError(f"{names[-1]}: value head has "
                         f"{out['value.weight'].shape[0]} outputs, expected 1")
    return out

"""K8/K9: the recurrent PPO learner's SGD phase and per-minibatch
sequence-replay gradients, and their plain twins.

Counterparts of ``warehouse_tpu/pallas/sgd_rnn.py``
``ppo_rnn_sgd_phase_pallas`` (:551) and ``ppo_rnn_minibatch_grads_pallas``
(:665). A minibatch is env columns ``[m B/M, (m+1) B/M)`` of the
trajectory: ``B/M * A`` sequences of T steps, replayed through the
recurrent policy from the rollout-start carry ``h0`` with no carry reset
inside the chunk (the trainer only lets an episode end on a chunk's last
step), then the clipped-PPO loss over all their samples.
``ppo_rnn_sgd_phase`` runs ``num_epochs x num_minibatches`` optimizer
steps (loss, truncated-BPTT gradient, optax clip + Adam);
``ppo_rnn_minibatch_grads`` one minibatch's loss and gradient. On a CUDA
tensor the kernels of ``csrc/sgd_rnn.cu`` run; on a CPU tensor the plain
twins: autograd through a Python loop over T of ``models.policy.apply_rnn``,
``ops.ppo_update.ppo_losses`` and ``optim.py``.

Inputs as ``kernels/sgd.py``'s, with ``params`` keyed like
``ActorCriticRNN.state_dict`` and ``h0`` the carry the rollout started from
(already env-permuted): ``float32[B, A, H]``, or the LSTM's ``(c, h)``.
``matmul_dtype="bfloat16"`` runs every product of the replay and its
backward on bf16-rounded operands with float32 accumulation
(``pallas/sgd_rnn.py:116-119``), GRU and LSTM alike; the gate arithmetic
stays float32. The trainer hands a bf16 carry in cast up to float32.

One minibatch's gradient runs on the card as six stages, each a kernel
shaped by its products (``csrc/sgd_rnn.cu``), with a plain version here
that takes and gives the same rows (``T N`` rows of the minibatch's ``N``
sequences, row ``t N + n`` step t of sequence n):

- ``enc_forward_plain``: the tanh encoder layers ``act0..`` and the gates'
  input side ``gi = e Wi^T (+ bi)`` over all rows at once;
- ``rec_forward_plain``: the recurrence from the carry: ``hs`` (h_0..h_T,
  ``(T + 1) N`` rows), the LSTM's ``cs`` and the post-activation ``gates``
  (GRU r, z, n and q = Whn h + bhn; LSTM i, f, g, o);
- ``head_loss_plain``: the head and the clipped-PPO loss on h_1..h_T, the
  head's adjoint ``dout`` and its part of dh, ``dhead = dout Whead``;
- ``rec_backward_plain``: the recurrence in reverse t: ``dp`` (the gates'
  pre-activation deltas) and ``dx`` (the recurrent side's: the GRU's with
  ``dq`` in the n gate's place; the LSTM's is ``dp``);
- ``enc_backward_plain``: ``de = dp Wi`` through tanh', then the earlier
  encoder layers: ``dz0..``;
- ``wgrad_plain``: every weight's and bias's gradient from those rows.

``plain_stage`` runs one by name, ``plain_stage_chain`` all six in turn,
``rnn_minibatch_grads_staged`` composes them into the contract of
``ppo_rnn_minibatch_grads_reference``; ``rnn_stage`` runs one stage's
kernel on given input rows (its plain version on a CPU tensor), for the
stages' checks on the card.
"""

from __future__ import annotations

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS
from ..models.policy import apply_rnn, bf16_round, num_encoder
from ..ops.ppo_update import NEG_INF, minibatch_epochs, ppo_losses
from ..optim import AdamState, adam_update_fn
from . import build
from .act_rnn import (GATE_ORDER, pack_rnn, rnn_dims, split_carry,
                      unpack_rnn)
from .sgd import (SqLayout, TrajLaunch, _device_of, _head_w, _losses,
                  _rounder, check_matmul_dtype, env_minibatches,
                  minibatch_grads_on_card, operand_precision,
                  sgd_phase_on_card)

STAGES = ("enc_fwd", "rec_fwd", "head_loss", "rec_bwd", "enc_bwd", "wgrad")


def _carry_slice(h0, lo: int, hi: int):
    if isinstance(h0, tuple):
        return tuple(x[lo:hi] for x in h0)
    return h0[lo:hi]


def seq_minibatches(traj, adv_n, targets, h0, num_minibatches: int):
    """The M sequence minibatches ``((obs, action, old_lp, old_v, adv,
    target, mask), h_init)``: env-column slices of the ``[T, B, A, ...]``
    fields and of the carry."""
    w = traj.obs.shape[1] // num_minibatches
    return [(mb, _carry_slice(h0, m * w, (m + 1) * w))
            for m, mb in enumerate(env_minibatches(traj, adv_n, targets,
                                                   num_minibatches))]


def zero_where(done: torch.Tensor, carry):
    """The carry (a tensor ``[..., H]`` or the LSTM's tuple) zeroed where
    ``done [...]``, in its own dtype."""
    def zero(x):
        return torch.where(done[..., None], torch.zeros((), dtype=x.dtype,
                                                        device=x.device), x)
    return tuple(map(zero, carry)) if isinstance(carry, tuple) else zero(
        carry)


def replay_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff, mask_actions,
                   precision="float32", normalize_adv=False):
    """The loss of one sequence minibatch ``((obs, action, old_lp, old_v,
    adv, target, mask[, done]), h_init)``: the T-step replay through
    ``apply_rnn`` at ``precision``, then the PPO loss; ``normalize_adv``
    normalizes the advantages over the minibatch (the JAX XLA learner's
    loss), else they arrive normalized (the kernels'). Given ``done [T,
    ...]``, the carry is zeroed after step t where ``done[t]``, as the JAX
    XLA replay's ``cell_step`` does (``train/ppo_rnn.py:369-380``): an
    episode that ended inside the chunk starts the next from zero. A
    ``done`` set on the last step only changes nothing."""
    def loss_fn(params, mb):
        (obs, action, old_lp, old_v, adv, tgt, mask, *done), carry = mb
        logits, values = [], []
        for t in range(obs.shape[0]):
            lg, v, carry = apply_rnn(params, obs[t], carry,
                                     precision=precision)
            if done:
                carry = zero_where(done[0][t], carry)
            logits.append(lg)
            values.append(v)
        logits, value = torch.stack(logits), torch.stack(values)
        if mask_actions:
            logits = torch.where(mask, logits, NEG_INF)
        return ppo_losses(logits, value, action, old_lp, old_v, adv, tgt,
                          clip_eps=clip_eps, value_coef=value_coef,
                          ent_coef=ent_coef, kl_coeff=kl_coeff,
                          normalize_adv=normalize_adv)
    return loss_fn


def ppo_rnn_sgd_phase_reference(params, opt_state: AdamState, traj, adv_n,
                                targets, h0, lr_row, bc1_row, bc2_row,
                                ent_coef, kl_coeff, *, num_epochs: int,
                                num_minibatches: int, clip_eps: float,
                                value_coef: float, max_grad_norm: float,
                                mask_actions: bool,
                                matmul_dtype: str = "float32", mesh=None):
    """The plain twin of ``ppo_rnn_sgd_phase``, on any device (with
    ``mesh``, of its meshed route)."""
    return minibatch_epochs(
        params, opt_state,
        loss_fn=replay_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff,
                               mask_actions, operand_precision(matmul_dtype)),
        minibatches=seq_minibatches(traj, adv_n, targets, h0,
                                    num_minibatches),
        num_epochs=num_epochs, update_fn=adam_update_fn(
            (lr_row, bc1_row, bc2_row), opt_state.count, max_grad_norm),
        mesh=mesh)


def ppo_rnn_minibatch_grads_reference(params, traj, adv_n, targets, h0,
                                      mb_idx: int, ent_coef, kl_coeff, *,
                                      num_minibatches: int, clip_eps: float,
                                      value_coef: float, mask_actions: bool,
                                      matmul_dtype: str = "float32"):
    """The plain twin of ``ppo_rnn_minibatch_grads``: autograd through the
    T-step replay of one minibatch."""
    mb = seq_minibatches(traj, adv_n, targets, h0, num_minibatches)[mb_idx]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, aux = replay_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff,
                                mask_actions, operand_precision(matmul_dtype)
                                )(leaves, mb)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return ((total.detach(), tuple(a.detach() for a in aux)),
            dict(zip(leaves, grads)))


# ---- the stages, plain ------------------------------------------------------

def minibatch_rows(traj, adv_n, targets, h0, mb_idx: int,
                   num_minibatches: int):
    """Minibatch ``mb_idx``'s ``((obs, action, old_lp, old_v, adv, target,
    mask), carry)``: the fields as rows ``[T N, ...]`` in the kernels' order
    (time step, then env, then agent) and the carry's ``[N, H]`` leaves
    (the LSTM's ``(c, h)``)."""
    mb, carry = seq_minibatches(traj, adv_n, targets, h0,
                                num_minibatches)[mb_idx]
    rows = tuple(x.reshape(-1, *x.shape[3:]) for x in mb)
    flat = tuple(x.reshape(-1, x.shape[-1]).float()
                 for x in (carry if isinstance(carry, tuple) else (carry,)))
    return rows, (flat if isinstance(carry, tuple) else flat[0])


def _lstm(params) -> bool:
    return "cell.ii.weight" in params


def _gates(params, side: str, what: str = "weight"):
    """The G gates' ``cell.{side}*`` tensors stacked in the packed order."""
    cell = "lstm" if _lstm(params) else "gru"
    return torch.cat([params[f"cell.{side}{g}.{what}"]
                      for g in GATE_ORDER[cell]])


def enc_forward_plain(params, obs, bf16: bool = False) -> dict:
    """Stage A: ``act{l}`` (each encoder layer's tanh output) and ``gi [T N,
    G H]``, the gates' input side (with the GRU's input biases)."""
    r = _rounder(bf16)
    out, x = {}, obs
    for i in range(num_encoder(params)):
        x = torch.tanh(r(x) @ r(params[f"encoder.{i}.weight"]).T
                       + params[f"encoder.{i}.bias"])
        out[f"act{i}"] = x
    gi = r(x) @ r(_gates(params, "i")).T
    out["gi"] = gi if _lstm(params) else gi + _gates(params, "i", "bias")
    return out


def rec_forward_plain(params, gi, carry, bf16: bool = False) -> dict:
    """Stage B: T steps of the cell from ``carry`` (``[N, H]``, the LSTM's
    ``(c, h)``) on ``gi``'s rows: ``hs`` (h_0..h_T), the LSTM's ``cs``
    (c_0..c_T) and ``gates [T N, 4 H]`` (GRU r, z, n, q; LSTM i, f, g,
    o)."""
    r = _rounder(bf16)
    lstm = _lstm(params)
    c, h = carry if lstm else (None, carry)
    N, H = h.shape
    wh = r(_gates(params, "h")).T
    hs, cs, gates = [h], [c], []
    for t in range(gi.shape[0] // N):
        gx = gi[t * N:(t + 1) * N]
        gh = r(h) @ wh
        if lstm:
            pre = gx + (gh + _gates(params, "h", "bias"))
            i, f, o = (torch.sigmoid(pre[:, k * H:(k + 1) * H])
                       for k in (0, 1, 3))
            g = torch.tanh(pre[:, 2 * H:3 * H])
            c = f * c + i * g
            h = o * torch.tanh(c)
            gates.append(torch.cat([i, f, g, o], 1))
            cs.append(c)
        else:
            rg = torch.sigmoid(gx[:, :H] + gh[:, :H])
            z = torch.sigmoid(gx[:, H:2 * H] + gh[:, H:2 * H])
            q = gh[:, 2 * H:] + params["cell.hn.bias"]
            n = torch.tanh(gx[:, 2 * H:] + rg * q)
            h = (1.0 - z) * n + z * h
            gates.append(torch.cat([rg, z, n, q], 1))
        hs.append(h)
    out = {"hs": torch.cat(hs), "gates": torch.cat(gates)}
    if lstm:
        out["cs"] = torch.cat(cs)
    return out


def head_loss_plain(params, hs, rows, ent_coef, kl_coeff, *, clip_eps: float,
                    value_coef: float, mask_actions: bool,
                    bf16: bool = False) -> dict:
    """Stage C: the head on h_1..h_T (``hs`` past its first N rows), the
    loss's derivative with respect to its outputs ``dout [T N, 6]`` (the
    PPO loss of ``rows``, averaged over the T N samples), the head's part
    of dh ``dhead = dout Whead`` and the loss terms ``losses``."""
    r = _rounder(bf16)
    _, action, old_lp, old_v, adv, tgt, mask = rows
    wh, bh = _head_w(params)
    h = hs[hs.shape[0] - action.shape[0]:]
    out = (r(h) @ r(wh).T + bh).detach().requires_grad_(True)
    with torch.enable_grad():
        logits, value = out[:, :5], out[:, 5]
        if mask_actions:
            logits = torch.where(mask, logits, NEG_INF)
        total, aux = ppo_losses(logits, value, action, old_lp, old_v, adv,
                                tgt, clip_eps=clip_eps, value_coef=value_coef,
                                ent_coef=ent_coef, kl_coeff=kl_coeff,
                                normalize_adv=False)
        dout, = torch.autograd.grad(total, out)
    return {"dout": dout, "dhead": r(dout) @ r(wh),
            "losses": (total.detach(), *(a.detach() for a in aux))}


def rec_backward_plain(params, gates, hs, cs, dhead,
                       bf16: bool = False) -> dict:
    """Stage D: the cell's adjoint in reverse t from the stored ``gates``,
    ``hs`` (and ``cs``) and the head's ``dhead``: ``dp [T N, G H]``, the
    gates' pre-activation deltas, and ``dx``, the recurrent side's (the
    GRU's n part is dq = dpn r, the delta of q = Whn h + bhn; the LSTM's
    is dp); dh_prev = d z (GRU) + dx Wh."""
    r = _rounder(bf16)
    lstm = _lstm(params)
    wh = r(_gates(params, "h"))
    TN, H = dhead.shape
    N = hs.shape[0] - TN
    dh = torch.zeros(N, H, dtype=dhead.dtype, device=dhead.device)
    dc = torch.zeros_like(dh)
    dps, dxs = [], []
    for t in range(TN // N - 1, -1, -1):
        sl = slice(t * N, (t + 1) * N)
        d = dh + dhead[sl]
        gt = gates[sl]
        if lstm:
            i, f, g, o = (gt[:, k * H:(k + 1) * H] for k in range(4))
            tc = torch.tanh(cs[(t + 1) * N:(t + 2) * N])
            dcv = dc + d * o * (1.0 - tc * tc)
            dc = dcv * f
            dp = torch.cat([dcv * g * i * (1.0 - i),
                            dcv * cs[sl] * f * (1.0 - f),
                            dcv * i * (1.0 - g * g),
                            d * tc * o * (1.0 - o)], 1)
            dx, dh = dp, r(dp) @ wh
        else:
            rg, z, n, q = (gt[:, k * H:(k + 1) * H] for k in range(4))
            dpn = d * (1.0 - z) * (1.0 - n * n)
            dpz = d * (hs[sl] - n) * z * (1.0 - z)
            dpr = dpn * q * rg * (1.0 - rg)
            dp = torch.cat([dpr, dpz, dpn], 1)
            dx = torch.cat([dpr, dpz, dpn * rg], 1)
            dh = d * z + r(dx) @ wh
        dps.append(dp)
        dxs.append(dx)
    return {"dp": torch.cat(dps[::-1]), "dx": torch.cat(dxs[::-1])}


def enc_backward_plain(params, dp, acts, bf16: bool = False) -> dict:
    """Stage E: the last encoder layer's delta ``(dp Wi) (1 - act²)``, then
    each earlier layer's ``dz{l-1} = (dz{l} W_l) (1 - act{l-1}²)``."""
    r = _rounder(bf16)
    L = len(acts)
    dz = (r(dp) @ r(_gates(params, "i"))) * (1.0 - acts[-1] ** 2)
    out = {f"dz{L - 1}": dz}
    for i in range(L - 1, 0, -1):
        dz = ((r(dz) @ r(params[f"encoder.{i}.weight"]))
              * (1.0 - acts[i - 1] ** 2))
        out[f"dz{i - 1}"] = dz
    return out


def wgrad_plain(params, obs, chain: dict, bf16: bool = False) -> dict:
    """Stage F: every parameter's gradient, keyed like ``params``, from
    the rows the stages before made: ``delta^T prev`` over the T N rows for
    each matrix, the deltas' sums for the biases."""
    r = _rounder(bf16)
    lstm = _lstm(params)
    L = num_encoder(params)
    gates = GATE_ORDER["lstm" if lstm else "gru"]
    dp, dx, dout = chain["dp"], chain["dx"], chain["dout"]
    TN = dp.shape[0]
    hs = chain["hs"]
    H = hs.shape[1]
    out = {}
    prev = obs
    for i in range(L):
        dz = chain[f"dz{i}"]
        out[f"encoder.{i}.weight"] = r(dz).T @ r(prev)
        out[f"encoder.{i}.bias"] = dz.sum(0)
        prev = chain[f"act{i}"]
    gwi, gwh = r(dp).T @ r(prev), r(dx).T @ r(hs[:TN])
    for k, g in enumerate(gates):
        out[f"cell.i{g}.weight"] = gwi[k * H:(k + 1) * H]
        out[f"cell.h{g}.weight"] = gwh[k * H:(k + 1) * H]
        if lstm:
            out[f"cell.h{g}.bias"] = dx[:, k * H:(k + 1) * H].sum(0)
        else:
            out[f"cell.i{g}.bias"] = dp[:, k * H:(k + 1) * H].sum(0)
    if not lstm:
        out["cell.hn.bias"] = dx[:, 2 * H:].sum(0)
    dwh, dbh = r(dout).T @ r(hs[hs.shape[0] - TN:]), dout.sum(0)
    out.update({"logits.weight": dwh[:5], "logits.bias": dbh[:5],
                "value.weight": dwh[5:], "value.bias": dbh[5:]})
    return {k: out[k] for k in params}


def _acts(params, rows: dict) -> list:
    return [rows[f"act{i}"] for i in range(num_encoder(params))]


def stage_inputs(stage: str, params, chain: dict) -> dict:
    """The rows of ``chain`` (``plain_stage_chain``'s) that ``stage``
    reads, by name."""
    L = num_encoder(params)
    acts = [f"act{i}" for i in range(L)]
    names = {"enc_fwd": [], "rec_fwd": ["gi"], "head_loss": ["hs"],
             "rec_bwd": ["gates", "hs", "dhead"] + (
                 ["cs"] if _lstm(params) else []),
             "enc_bwd": ["dp"] + acts,
             "wgrad": acts + [f"dz{i}" for i in range(L)]
             + ["dp", "dx", "hs", "dout"]}[stage]
    return {k: chain[k] for k in names}


def plain_stage(stage: str, params, rows, carry, inputs: dict, ent_coef,
                kl_coeff, *, clip_eps: float, value_coef: float,
                mask_actions: bool, bf16: bool = False) -> dict:
    """One of the ``STAGES``, plain, on minibatch ``rows`` and ``carry``
    (``minibatch_rows``') and the input rows ``inputs`` it takes (by the
    names ``stage_inputs`` gives): its outputs by name."""
    if stage == "enc_fwd":
        return enc_forward_plain(params, rows[0], bf16)
    if stage == "rec_fwd":
        return rec_forward_plain(params, inputs["gi"], carry, bf16)
    if stage == "head_loss":
        return head_loss_plain(params, inputs["hs"], rows, ent_coef,
                               kl_coeff, clip_eps=clip_eps,
                               value_coef=value_coef,
                               mask_actions=mask_actions, bf16=bf16)
    if stage == "rec_bwd":
        return rec_backward_plain(params, inputs["gates"], inputs["hs"],
                                  inputs.get("cs"), inputs["dhead"], bf16)
    if stage == "enc_bwd":
        return enc_backward_plain(params, inputs["dp"],
                                  _acts(params, inputs), bf16)
    return wgrad_plain(params, rows[0], inputs, bf16)


def plain_stage_chain(params, rows, carry, ent_coef, kl_coeff, **kw):
    """The ``STAGES`` plain, each on the rows the ones before it made:
    ``(chain, outputs)``, the rows by name and each stage's outputs by
    stage. ``kw``: those of ``plain_stage``."""
    chain, outputs = {}, {}
    for stage in STAGES:
        outputs[stage] = plain_stage(stage, params, rows, carry,
                                     stage_inputs(stage, params, chain),
                                     ent_coef, kl_coeff, **kw)
        if stage != "wgrad":
            chain.update((k, v) for k, v in outputs[stage].items()
                         if k != "losses")
    return chain, outputs


def rnn_minibatch_grads_staged(params, traj, adv_n, targets, h0, mb_idx: int,
                               ent_coef, kl_coeff, *, num_minibatches: int,
                               clip_eps: float, value_coef: float,
                               mask_actions: bool,
                               matmul_dtype: str = "float32"):
    """The six plain stages composed:
    ``ppo_rnn_minibatch_grads_reference``'s ``((total, (pg, v, ent, kl)),
    grads)``."""
    rows, carry = minibatch_rows(traj, adv_n, targets, h0, mb_idx,
                                 num_minibatches)
    _, out = plain_stage_chain(
        params, rows, carry, ent_coef, kl_coeff, clip_eps=clip_eps,
        value_coef=value_coef, mask_actions=mask_actions,
        bf16=check_matmul_dtype(matmul_dtype))
    losses = out["head_loss"]["losses"]
    return (losses[0], losses[1:]), out["wgrad"]


# ---- the kernels ------------------------------------------------------------

def check_rnn_learner_fits(params, obs_dim: int, dev):
    """K8 / K9's ``(dims, H, lstm)`` for ``params`` on observations
    ``obs_dim`` wide; raises ``ValueError`` for params that do not fit the
    observation (before any library call) or a shared-memory need the
    kernels do not take. Any hidden and encoder width and any number of
    encoder layers."""
    dims, H, lstm = rnn_dims(params, obs_dim)
    smem = build.library().wh_rnn_sgd_smem_bytes(
        len(dims) - 1, build.int_array(dims), H, int(lstm))
    limit = build.smem_limit(dev, smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"recurrent SGD kernels need {smem} bytes of shared memory "
            f"per block for widths {dims}, {H}; the card allows {limit}")
    return dims, H, lstm


def pad_rnn_params(params, Hq: int) -> dict:
    """``params`` at hidden width ``Hq`` >= H, zeros past the natural
    entries: each gate's rows and (the recurrent weights) columns, each
    bias, the head's columns; the encoder as it is. Packed by ``pack_rnn``
    it is the padded net's vector of ``csrc/sgd_rnn.cu`` (``PadMap``)."""
    _, H, _ = rnn_dims(params, params["encoder.0.weight"].shape[1])
    p = Hq - H
    out = {}
    for k, v in params.items():
        if k.startswith("cell.") and v.dim() == 2:  # rows; h-side columns
            v = torch.nn.functional.pad(
                v, (0, p if k.startswith("cell.h") else 0, 0, p))
        elif k.startswith("cell.") or k in ("logits.weight", "value.weight"):
            v = torch.nn.functional.pad(v, (0, p))  # a bias; head columns
        out[k] = v
    return out


def rnn_sq_layout(params, run=None) -> SqLayout:
    """K8's layout: the gradient scattered into the net the kernels run, at
    H rounded up to 4 (``pad_rnn_params``), one segment."""
    _, H, _ = rnn_dims(params, params["encoder.0.weight"].shape[1])
    Hq = -(-H // 4) * 4
    n = sum(v.numel() for v in params.values())
    if Hq == H:
        return SqLayout(((0, n),), n, None, run)
    padded = pad_rnn_params(params, Hq)

    def pad(grads):
        return pack_rnn(pad_rnn_params(unpack_rnn(grads, params), Hq))
    return SqLayout(((0, sum(v.numel() for v in padded.values())),), n, pad,
                    run)


class RnnLaunch(TrajLaunch):
    """``TrajLaunch`` for the recurrent entry points (``csrc/sgd_rnn.cu``),
    with the rollout-start carry."""

    SUMSQ, SQ_LAYOUT = "wh_rnn_sgd_sumsq", "wh_rnn_sgd_sq_layout"

    def __init__(self, params, traj, adv_n, targets, h0, *args,
                 matmul_dtype="float32"):
        super().__init__(traj, adv_n, targets, *args,
                         matmul_dtype=matmul_dtype)
        dev = traj.obs.device
        _, B, A, D = traj.obs.shape
        dims, H, lstm = check_rnn_learner_fits(params, D, dev)
        self.h0, self.c0 = split_carry(h0, lstm)
        if any(x is not None and (x.shape != (B, A, H) or x.device != dev)
               for x in (self.h0, self.c0)):
            raise ValueError(f"h0 must be [B, A, H] = {(B, A, H)} on {dev}")
        lib = self.lib
        dims_arr = build.int_array(dims)
        net = (len(dims) - 1, dims_arr, H, int(lstm))
        self.shape = (*net, *self.tbam)
        self.n_params = lib.wh_rnn_param_floats(*net)
        self.widths = (dims, H, lstm)
        self.work = torch.empty(lib.wh_rnn_sgd_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)
        self.sq_layout = rnn_sq_layout(params, self)

    def _args(self, p_flat, mb: int, grads, sums) -> list:
        if p_flat.numel() != self.n_params:
            raise ValueError("packed params do not fit the kernel's layout")
        return [*self.shape, mb, *self.batch_ptrs(), self.h0.data_ptr(),
                None if self.c0 is None else self.c0.data_ptr(),
                p_flat.data_ptr(), self.scal.data_ptr(), *self.coefs,
                self.work.data_ptr(), grads.data_ptr(), sums.data_ptr(),
                int(self.bf16), self.stream]

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K9's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        err = self.lib.wh_rnn_sgd_grads(*self._args(p_flat, mb, grads, sums))
        build.check(err, "ppo_rnn_minibatch_grads kernel launch")
        ppo_rnn_minibatch_grads.launches += 1
        ppo_rnn_minibatch_grads.bf16_launches += self.bf16

    def clip_adam(self, p_flat, m_flat, v_flat, grads, rows, step: int,
                  max_grad_norm: float) -> None:
        """K8's optimizer kernel after ``grads``: clip + Adam in place."""
        err = self.lib.wh_rnn_sgd_clip_adam(
            *self.shape, step, p_flat.data_ptr(), m_flat.data_ptr(),
            v_flat.data_ptr(), grads.data_ptr(),
            *(r.data_ptr() for r in rows), max_grad_norm, ADAM_B1,
            1.0 - ADAM_B1, ADAM_B2, 1.0 - ADAM_B2, ADAM_EPS,
            self.work.data_ptr(), self.stream)
        build.check(err, "ppo_rnn_sgd_phase kernel launch")
        ppo_rnn_sgd_phase.launches += 1
        ppo_rnn_sgd_phase.bf16_launches += self.bf16

    def rows(self) -> dict:
        """The stages' rows in the workspace, as views ``[rows, blocks,
        width]`` at their natural widths: one block for most, a block per
        gate for ``gi``, ``gates``, ``dp`` and ``dx`` (``plain_stage_chain``'s
        ``[rows, blocks * width]`` once flattened). The stages run at H
        rounded up to 4 (``csrc/sgd_rnn.cu``): each gate's block is that
        many columns apart, and the buffers' pad columns lie beyond each
        view."""
        dims, H, lstm = self.widths
        out = (build.L * (12 + 3 * (len(dims) - 1)))()
        build.check(self.lib.wh_rnn_sgd_layout(*self.shape, out),
                    "wh_rnn_sgd_layout")
        G = 4 if lstm else 3
        TN = self.mb_n
        N = TN // self.tbam[0]
        Hq = out[11]
        # name -> (offset, rows, row stride, blocks, block stride, width)
        shape = {"gi": (out[1], TN, G * Hq, G, Hq, H),
                 "hs": (out[2], TN + N, Hq, 1, Hq, H),
                 "cs": (out[3], TN + N, Hq, 1, Hq, H),
                 "gates": (out[4], TN, 4 * Hq, 4, Hq, H),
                 "dout": (out[5], TN, 8, 1, 8, 6),
                 "dhead": (out[6], TN, Hq, 1, Hq, H),
                 "dp": (out[7], TN, out[10], G, Hq, H),
                 "dx": (out[8], TN, out[10], G, Hq, H)}
        for i, e in enumerate(dims[1:]):
            act, dz, ld = out[12 + 3 * i:15 + 3 * i]
            shape[f"act{i}"] = (act, TN, ld, 1, ld, e)
            shape[f"dz{i}"] = (dz, TN, ld, 1, ld, e)
        views = {}
        for k, (off, n, ld, blocks, bs, w) in shape.items():
            if off >= 0:
                views[k] = self.work[off:off + n * ld].view(n, ld)[
                    :, :blocks * bs].view(n, blocks, bs)[:, :, :w]
        return views

    def fill(self, inputs: dict) -> None:
        """Writes a stage's input rows (``stage_inputs``' names) into the
        workspace, the pad columns zero."""
        views = self.rows()
        for k, v in inputs.items():
            full = views[k].as_strided(
                (views[k].shape[0], views[k].stride(0)),
                (views[k].stride(0), 1))
            full.zero_()
            views[k].copy_(v.reshape(views[k].shape))

    def launch_stage(self, stage: str, p_flat, mb: int, grads, sums) -> None:
        """One stage's kernels (after the weight copies and the observation
        rows) on the rows the workspace holds."""
        err = self.lib.wh_rnn_sgd_stage(STAGES.index(stage),
                                        *self._args(p_flat, mb, grads, sums))
        build.check(err, f"recurrent learner stage {stage} launch")
        rnn_stage.launches += 1


def rnn_stage(stage: str, params, traj, adv_n, targets, h0, mb_idx: int,
              ent_coef, kl_coeff, inputs: dict, *, num_minibatches: int,
              clip_eps: float, value_coef: float, mask_actions: bool,
              matmul_dtype: str = "float32") -> dict:
    """One of the ``STAGES`` of minibatch ``mb_idx``'s gradient on the
    input rows ``inputs`` (``stage_inputs``' names, the plain stages'
    shapes), its outputs as ``plain_stage`` gives them. The stage's kernel
    on CUDA tensors, its plain version on CPU ones. ``launches`` counts
    the kernel launches."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    bf16 = check_matmul_dtype(matmul_dtype)
    kw = dict(clip_eps=clip_eps, value_coef=value_coef,
              mask_actions=mask_actions)
    if _device_of(traj).type == "cpu":
        rows, carry = minibatch_rows(traj, adv_n, targets, h0, mb_idx,
                                     num_minibatches)
        return plain_stage(stage, params, rows, carry, inputs, ent_coef,
                           kl_coeff, bf16=bf16, **kw)
    run = RnnLaunch(params, traj, adv_n, targets, h0, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    matmul_dtype=matmul_dtype)
    run.fill(inputs)
    p_flat = pack_rnn(params)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=p_flat.device)
    run.launch_stage(stage, p_flat, mb_idx, grads, sums)
    views = run.rows()
    if stage == "wgrad":
        return {k: v.clone() for k, v in unpack_rnn(grads, params).items()}
    names = {"enc_fwd": [k for k in views if k.startswith("act")] + ["gi"],
             "rec_fwd": ["hs", "gates"] + (["cs"] if "cs" in views else []),
             "head_loss": ["dout", "dhead"], "rec_bwd": ["dp", "dx"],
             "enc_bwd": [k for k in views if k.startswith("dz")]}[stage]
    out = {k: views[k].clone().reshape(views[k].shape[0], -1)
           for k in names}
    if stage == "head_loss":
        out["losses"] = _losses(sums, run.mb_n, value_coef, ent_coef,
                                kl_coeff)
    return out


rnn_stage.launches = 0


def ppo_rnn_sgd_phase(params, opt_state: AdamState, traj, adv_n, targets, h0,
                      lr_row, bc1_row, bc2_row, ent_coef, kl_coeff, *,
                      num_epochs: int, num_minibatches: int, clip_eps: float,
                      value_coef: float, max_grad_norm: float,
                      mask_actions: bool, matmul_dtype: str = "float32",
                      mesh=None):
    """The whole recurrent SGD phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent, kl)`` tuple of ``[E, M]`` tensors.
    On CUDA tensors each step is K9's gradient kernels, then K8's clip +
    Adam kernel on the packed params and moments; on CPU tensors the plain
    twin runs. With ``mesh``, the meshed learner: each step's K9 gradient
    averaged over the ranks before the step (``sgd.sgd_phase_on_card``).
    ``launches`` counts the optimizer kernel."""
    if _device_of(traj).type == "cpu":
        return ppo_rnn_sgd_phase_reference(
            params, opt_state, traj, adv_n, targets, h0, lr_row, bc1_row,
            bc2_row, ent_coef, kl_coeff, num_epochs=num_epochs,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, max_grad_norm=max_grad_norm,
            mask_actions=mask_actions, matmul_dtype=matmul_dtype, mesh=mesh)
    run = RnnLaunch(params, traj, adv_n, targets, h0, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  matmul_dtype=matmul_dtype)
    return sgd_phase_on_card(
        run, pack_rnn, unpack_rnn, params, opt_state,
        (lr_row, bc1_row, bc2_row), ent_coef, kl_coeff,
        num_epochs=num_epochs, num_minibatches=num_minibatches,
        value_coef=value_coef, max_grad_norm=max_grad_norm, mesh=mesh)


ppo_rnn_sgd_phase.launches = 0
ppo_rnn_sgd_phase.bf16_launches = 0  # those on bf16 operands


def ppo_rnn_minibatch_grads(params, traj, adv_n, targets, h0, mb_idx: int,
                            ent_coef, kl_coeff, *, num_minibatches: int,
                            clip_eps: float, value_coef: float,
                            mask_actions: bool, matmul_dtype: str = "float32"):
    """One minibatch's sequence-replay loss and gradient: ``((total, (pg,
    v, ent, kl)), grads)``. The kernels on CUDA tensors, the plain twin on
    CPU ones. ``launches`` counts their launches, inside
    ``ppo_rnn_sgd_phase`` too."""
    if _device_of(traj).type == "cpu":
        return ppo_rnn_minibatch_grads_reference(
            params, traj, adv_n, targets, h0, mb_idx, ent_coef, kl_coeff,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, mask_actions=mask_actions,
            matmul_dtype=matmul_dtype)
    run = RnnLaunch(params, traj, adv_n, targets, h0, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  matmul_dtype=matmul_dtype)
    return minibatch_grads_on_card(
        run, pack_rnn, unpack_rnn, params, mb_idx, ent_coef, kl_coeff,
        num_minibatches=num_minibatches, value_coef=value_coef)


ppo_rnn_minibatch_grads.launches = 0
ppo_rnn_minibatch_grads.bf16_launches = 0

"""K3/K4: the PPO SGD phase and per-minibatch gradients (MLP), and their
plain twins.

Counterparts of ``warehouse_tpu/pallas/sgd.py`` ``ppo_sgd_phase_pallas``
(:691) and ``ppo_minibatch_grads_pallas`` (:818). ``ppo_sgd_phase`` runs
the whole SGD phase of one update — ``num_epochs x num_minibatches``
optimizer steps, each the clipped-PPO loss of one minibatch, its
gradient and the optax clip + Adam step — and ``ppo_minibatch_grads``
one minibatch's loss and gradient. Minibatch ``m`` is env columns
``[m B/M, (m+1) B/M)`` of the trajectory; the trainer randomizes the
composition by permuting the env state before the rollout. On a CUDA
tensor the kernels of ``csrc/sgd.cu`` run, reading the act phase's
``obs [T, B, A, D]`` in place; on a CPU tensor the plain twins run:
autograd through ``ops.ppo_update.ppo_losses`` and ``optim.py``.

One minibatch's gradient runs on the card as stages, each a kernel shaped
by its products (``csrc/sgd.cu``), with a plain version here that takes and
gives the same rows (the minibatch's N samples, with policy groups group
after group, each group's in (time step, env, agent) order:
``minibatch_rows``):

- ``fwd_plain``: each hidden layer's tanh output ``act0..`` over all rows;
- ``head_loss_plain``: the head and the clipped-PPO loss on the last
  layer, the head's adjoint ``dout [N, 6]`` and the last layer's delta
  ``(dout W_head) (1 - act²)``;
- ``dgrad_plain``: the earlier layers' deltas ``dz{l-1} = (dz{l} W_l)
  (1 - act{l-1}²)``;
- ``wgrad_plain``: every weight's and bias's gradient from those rows.

``plain_stage`` runs one by name, ``plain_stage_chain`` all four in turn,
``mlp_minibatch_grads_staged`` composes them into the contract of
``ppo_minibatch_grads_reference``; ``mlp_stage`` runs one stage's kernel
on given input rows (its plain version on a CPU tensor), for the stages'
checks on the card. Any observation width, hidden width and number of
hidden layers from 1 runs (a global view's 611); ``check_learner_fits``
raises for an MLP without hidden layers (the JAX kernel raises too) and
for a last hidden layer too wide for the head stage's 64 rows to fit the
card's shared memory.

With ``policy_groups`` (one group id per agent, the JAX wrappers' name)
``params`` is a ``MultiPolicyActorCritic``'s dict: sample ``(t, b, a)``
goes through group ``policy_groups[a]``'s MLP, its gradient to that group's
params; the loss still averages over every sample of the minibatch, and one
global-norm clip and one Adam step span all groups (``pallas/sgd.py:293-306``).
The kernels' flat vector holds the groups' packed params in group order.

``matmul_dtype="bfloat16"`` (the JAX wrappers' parameter) runs every
product of the forward and the backward on bf16-rounded operands with
float32 accumulation, as the TPU kernel's ``dot`` does (``pallas/sgd.py:
181-191``); the loss chain, the bias gradients, the clip and Adam stay
float32. The kernels take it as a compile-time flag; the twins use
``models.policy.Bf16Linear``. Any other value than ``"float32"`` or
``"bfloat16"`` raises ``ValueError``.

Inputs: ``params`` a dict keyed like ``ActorCriticMLP.state_dict`` (or a
``MultiPolicyActorCritic``'s, with ``policy_groups``);
``traj`` anything with the trajectory fields ``obs``, ``action``,
``log_prob``, ``value`` (``[T, B, A]``) and ``mask`` (``bool[T, B, A,
5]``; read only with ``mask_actions``); ``adv_n`` advantages normalized
per minibatch (``normalize_adv_env_minibatch``); ``targets``; for the
phase, the per-step rows ``lr_row``, ``bc1_row``, ``bc2_row`` (float32
``[E*M]``, ``optim.ClipAdam.step_rows``). ``ent_coef`` and ``kl_coeff``
are floats or 0-d tensors. The TPU's 16-row field pack, 8-row head
padding and block knobs have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS

from ..models.policy import (apply, bf16_round, group_params, is_multi,
                             num_groups, num_hidden)
from ..ops.ppo_update import NEG_INF, minibatch_epochs, ppo_losses
from ..optim import AdamState, adam_update_fn
from . import build

N_ACT = 5
STAGES = ("fwd", "head_loss", "dgrad", "wgrad")


def normalize_adv_env_minibatch(advantages: torch.Tensor,
                                num_minibatches: int) -> torch.Tensor:
    """Advantages ``[T, B, A]`` normalized per contiguous-env minibatch
    (mean and population std over its ``T x B/M x A`` samples)."""
    T, B, A = advantages.shape
    g = advantages.reshape(T, num_minibatches, B // num_minibatches, A)
    mean = g.mean(dim=(0, 2, 3), keepdim=True)
    std = g.std(dim=(0, 2, 3), correction=0, keepdim=True)
    return ((g - mean) / (std + 1e-8)).reshape(T, B, A)


def env_minibatches(traj, adv_n, targets, num_minibatches: int):
    """The M minibatches ``(obs, action, old_lp, old_v, adv, target,
    mask)`` as env-column slices of the ``[T, B, A, ...]`` fields."""
    B = traj.obs.shape[1]
    if B % num_minibatches:
        raise ValueError(f"B={B} not divisible by {num_minibatches} "
                         "minibatches")
    w = B // num_minibatches
    fields = (traj.obs, traj.action, traj.log_prob, traj.value, adv_n,
              targets, traj.mask)
    return [tuple(x[:, m * w:(m + 1) * w] for x in fields)
            for m in range(num_minibatches)]


def check_matmul_dtype(matmul_dtype) -> bool:
    """Whether ``matmul_dtype`` asks for bf16 operands; ``ValueError`` for
    anything but ``"float32"`` and ``"bfloat16"``."""
    if matmul_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"matmul_dtype must be 'float32' or 'bfloat16', "
                         f"got {matmul_dtype!r}")
    return matmul_dtype == "bfloat16"


def operand_precision(matmul_dtype) -> str:
    """The twins' ``models.policy`` precision for ``matmul_dtype``:
    ``"bf16_operands"`` for ``"bfloat16"``, else ``"float32"``."""
    return "bf16_operands" if check_matmul_dtype(matmul_dtype) else "float32"


def _loss_fn(clip_eps, value_coef, ent_coef, kl_coeff, mask_actions,
             policy_groups=None, matmul_dtype="float32"):
    precision = operand_precision(matmul_dtype)
    gids = None if policy_groups is None else torch.tensor(
        [int(g) for g in policy_groups])

    def loss_fn(params, mb):
        obs, action, old_lp, old_v, adv, tgt, mask = mb
        logits, value = apply(params, obs, gids, precision=precision)
        if mask_actions:
            logits = torch.where(mask, logits, NEG_INF)
        return ppo_losses(logits, value, action, old_lp, old_v, adv, tgt,
                          clip_eps=clip_eps, value_coef=value_coef,
                          ent_coef=ent_coef, kl_coeff=kl_coeff,
                          normalize_adv=False)
    return loss_fn


def ppo_sgd_phase_reference(params, opt_state: AdamState, traj, adv_n,
                            targets, lr_row, bc1_row, bc2_row, ent_coef,
                            kl_coeff, *, num_epochs: int,
                            num_minibatches: int, clip_eps: float,
                            value_coef: float, max_grad_norm: float,
                            mask_actions: bool, policy_groups=None,
                            matmul_dtype: str = "float32", mesh=None):
    """The plain twin of ``ppo_sgd_phase``, on any device; with ``mesh``,
    that of its meshed route (``ppo_minibatch_grads_reference``'s gradient
    each step, averaged over the ranks before the step)."""
    return minibatch_epochs(
        params, opt_state,
        loss_fn=_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff,
                         mask_actions, policy_groups, matmul_dtype),
        minibatches=env_minibatches(traj, adv_n, targets, num_minibatches),
        num_epochs=num_epochs, update_fn=adam_update_fn(
            (lr_row, bc1_row, bc2_row), opt_state.count, max_grad_norm),
        mesh=mesh)


def ppo_minibatch_grads_reference(params, traj, adv_n, targets, mb_idx: int,
                                  ent_coef, kl_coeff, *,
                                  num_minibatches: int, clip_eps: float,
                                  value_coef: float, mask_actions: bool,
                                  policy_groups=None,
                                  matmul_dtype: str = "float32"):
    """The plain twin of ``ppo_minibatch_grads``: autograd on one
    minibatch."""
    mb = env_minibatches(traj, adv_n, targets, num_minibatches)[mb_idx]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, aux = _loss_fn(clip_eps, value_coef, ent_coef, kl_coeff,
                          mask_actions, policy_groups,
                          matmul_dtype)(leaves, mb)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return ((total.detach(), tuple(a.detach() for a in aux)),
            dict(zip(leaves, grads)))


# ---- the stages, plain ------------------------------------------------------

def group_agents(policy_groups, A: int) -> list[list[int]]:
    """Each policy group's agents in order (one group of all ``A``
    without groups)."""
    if policy_groups is None:
        return [list(range(A))]
    return [[a for a in range(A) if policy_groups[a] == g]
            for g in range(max(policy_groups) + 1)]


def minibatch_rows(traj, adv_n, targets, mb_idx: int, num_minibatches: int,
                   policy_groups=None):
    """Minibatch ``mb_idx``'s ``(obs, action, old_lp, old_v, adv, target,
    mask)`` as rows ``[N, ...]`` in the kernels' order: group after group,
    each group's in (time step, env, agent) order; and each group's count
    of rows."""
    mb = env_minibatches(traj, adv_n, targets, num_minibatches)[mb_idx]
    agents = group_agents(policy_groups, traj.obs.shape[2])
    rows = tuple(torch.cat([x[:, :, a].reshape(-1, *x.shape[3:])
                            for a in agents]) for x in mb)
    return rows, [mb[1][:, :, a].numel() for a in agents]


def _rounder(bf16: bool):
    return bf16_round if bf16 else (lambda x: x)


def _groups(params, counts) -> list:
    """``(params, row slice)`` per policy group: each group's sub-model
    params (``params`` itself without groups) and its rows."""
    multi, out, lo = is_multi(params), [], 0
    for g, n in enumerate(counts):
        out.append((group_params(params, g) if multi else params,
                    slice(lo, lo + n)))
        lo += n
    return out


def _head_w(p):
    """The fused head ``[6, H]`` (5 logits, then the value) and its
    bias."""
    return (torch.cat([p["logits.weight"], p["value.weight"]]),
            torch.cat([p["logits.bias"], p["value.bias"]]))


def _n_hidden(params) -> int:
    return num_hidden(group_params(params, 0) if is_multi(params)
                      else params)


def fwd_plain(params, obs, counts, bf16: bool = False) -> dict:
    """Stage A: ``act{l}``, each hidden layer's tanh output, every group's
    rows through its params."""
    r = _rounder(bf16)
    acts = [[] for _ in range(_n_hidden(params))]
    for p, sl in _groups(params, counts):
        x = obs[sl]
        for i, a in enumerate(acts):
            x = torch.tanh(r(x) @ r(p[f"hidden.{i}.weight"]).T
                           + p[f"hidden.{i}.bias"])
            a.append(x)
    return {f"act{i}": torch.cat(a) for i, a in enumerate(acts)}


def head_loss_plain(params, h, rows, counts, ent_coef, kl_coeff, *,
                    clip_eps: float, value_coef: float, mask_actions: bool,
                    bf16: bool = False) -> dict:
    """Stage C: the head on the last layer's rows ``h``, the loss's
    derivative with respect to its outputs ``dout [N, 6]`` (the PPO loss of
    ``rows``, averaged over the N samples), the last layer's delta
    ``dz{L-1} = (dout W_head) (1 - h²)`` and the loss terms ``losses``."""
    r = _rounder(bf16)
    _, action, old_lp, old_v, adv, tgt, mask = rows
    groups = _groups(params, counts)
    out = torch.cat([r(h[sl]) @ r(_head_w(p)[0]).T + _head_w(p)[1]
                     for p, sl in groups]).detach().requires_grad_(True)
    with torch.enable_grad():
        logits, value = out[:, :5], out[:, 5]
        if mask_actions:
            logits = torch.where(mask, logits, NEG_INF)
        total, aux = ppo_losses(logits, value, action, old_lp, old_v, adv,
                                tgt, clip_eps=clip_eps, value_coef=value_coef,
                                ent_coef=ent_coef, kl_coeff=kl_coeff,
                                normalize_adv=False)
        dout, = torch.autograd.grad(total, out)
    dz = torch.cat([(r(dout[sl]) @ r(_head_w(p)[0])) * (1.0 - h[sl] ** 2)
                    for p, sl in groups])
    return {"dout": dout, f"dz{_n_hidden(params) - 1}": dz,
            "losses": (total.detach(), *(a.detach() for a in aux))}


def dgrad_plain(params, dz, acts, counts, bf16: bool = False) -> dict:
    """Stage E: from the last layer's delta ``dz``, each earlier layer's
    ``dz{l-1} = (dz{l} W_l) (1 - act{l-1}²)``; ``acts`` the activations
    of every layer but the last."""
    r = _rounder(bf16)
    out = {}
    for i in range(len(acts), 0, -1):
        dz = torch.cat([(r(dz[sl]) @ r(p[f"hidden.{i}.weight"]))
                        * (1.0 - acts[i - 1][sl] ** 2)
                        for p, sl in _groups(params, counts)])
        out[f"dz{i - 1}"] = dz
    return out


def wgrad_plain(params, obs, chain: dict, counts, bf16: bool = False) -> dict:
    """Stage F: every parameter's gradient, keyed like ``params``, from the
    rows the stages before made: ``delta^T prev`` over each group's rows
    for each matrix, the deltas' sums for the biases."""
    r = _rounder(bf16)
    L, out = _n_hidden(params), {}
    for g, (_, sl) in enumerate(_groups(params, counts)):
        pre = f"policies.{g}." if is_multi(params) else ""
        prev = obs[sl]
        for i in range(L):
            dz = chain[f"dz{i}"][sl]
            out[f"{pre}hidden.{i}.weight"] = r(dz).T @ r(prev)
            out[f"{pre}hidden.{i}.bias"] = dz.sum(0)
            prev = chain[f"act{i}"][sl]
        dout = chain["dout"][sl]
        dwh, dbh = r(dout).T @ r(prev), dout.sum(0)
        out.update({f"{pre}logits.weight": dwh[:5], f"{pre}logits.bias":
                    dbh[:5], f"{pre}value.weight": dwh[5:],
                    f"{pre}value.bias": dbh[5:]})
    return {k: out[k] for k in params}


def stage_inputs(stage: str, params, chain: dict) -> dict:
    """The rows of ``chain`` (``plain_stage_chain``'s) that ``stage``
    reads, by name."""
    L = _n_hidden(params)
    acts = [f"act{i}" for i in range(L)]
    names = {"fwd": [], "head_loss": [acts[-1]],
             "dgrad": [f"dz{L - 1}"] + acts[:-1],
             "wgrad": acts + [f"dz{i}" for i in range(L)] + ["dout"]}[stage]
    return {k: chain[k] for k in names}


def plain_stage(stage: str, params, rows, counts, inputs: dict, ent_coef,
                kl_coeff, *, clip_eps: float, value_coef: float,
                mask_actions: bool, bf16: bool = False) -> dict:
    """One of the ``STAGES``, plain, on minibatch ``rows`` and its groups'
    row ``counts`` (``minibatch_rows``') and the input rows ``inputs`` it
    takes (by the names ``stage_inputs`` gives): its outputs by name."""
    L = _n_hidden(params)
    if stage == "fwd":
        return fwd_plain(params, rows[0], counts, bf16)
    if stage == "head_loss":
        return head_loss_plain(params, inputs[f"act{L - 1}"], rows, counts,
                               ent_coef, kl_coeff, clip_eps=clip_eps,
                               value_coef=value_coef,
                               mask_actions=mask_actions, bf16=bf16)
    if stage == "dgrad":
        return dgrad_plain(params, inputs[f"dz{L - 1}"],
                           [inputs[f"act{i}"] for i in range(L - 1)], counts,
                           bf16)
    return wgrad_plain(params, rows[0], inputs, counts, bf16)


def plain_stage_chain(params, rows, counts, ent_coef, kl_coeff, **kw):
    """The ``STAGES`` plain, each on the rows the ones before it made:
    ``(chain, outputs)``, the rows by name and each stage's outputs by
    stage. ``kw``: those of ``plain_stage``."""
    chain, outputs = {}, {}
    for stage in STAGES:
        outputs[stage] = plain_stage(stage, params, rows, counts,
                                     stage_inputs(stage, params, chain),
                                     ent_coef, kl_coeff, **kw)
        if stage != "wgrad":
            chain.update((k, v) for k, v in outputs[stage].items()
                         if k != "losses")
    return chain, outputs


def mlp_minibatch_grads_staged(params, traj, adv_n, targets, mb_idx: int,
                               ent_coef, kl_coeff, *, num_minibatches: int,
                               clip_eps: float, value_coef: float,
                               mask_actions: bool, policy_groups=None,
                               matmul_dtype: str = "float32"):
    """The four plain stages composed: ``ppo_minibatch_grads_reference``'s
    ``((total, (pg, v, ent, kl)), grads)``."""
    rows, counts = minibatch_rows(traj, adv_n, targets, mb_idx,
                                  num_minibatches, policy_groups)
    _, out = plain_stage_chain(
        params, rows, counts, ent_coef, kl_coeff, clip_eps=clip_eps,
        value_coef=value_coef, mask_actions=mask_actions,
        bf16=check_matmul_dtype(matmul_dtype))
    losses = out["head_loss"]["losses"]
    return (losses[0], losses[1:]), out["wgrad"]


# ---- the kernels ------------------------------------------------------------

def _layer_keys(params) -> list[tuple[list[str], list[str]]]:
    """Per dense layer of the packed vector: (weight keys, bias keys);
    the head fuses logits and value. A multi-policy dict's layers come
    group after group."""
    if is_multi(params):
        return [([f"policies.{g}.{k}" for k in wk],
                 [f"policies.{g}.{k}" for k in bk])
                for g in range(num_groups(params))
                for wk, bk in _layer_keys(group_params(params, g))]
    keys = [([f"hidden.{i}.weight"], [f"hidden.{i}.bias"])
            for i in range(num_hidden(params))]
    return keys + [(["logits.weight", "value.weight"],
                    ["logits.bias", "value.bias"])]


def pack(tree) -> torch.Tensor:
    """A params-shaped dict as the kernels' flat float32 vector: per layer
    ``W [out, in]`` then ``b [out]`` (torch's layout), the head as the
    6 x H stack of the logits and value rows."""
    parts = []
    for wk, bk in _layer_keys(tree):
        parts += [tree[k].reshape(-1) for k in wk + bk]
    return torch.cat(parts).to(torch.float32).contiguous()


def unpack(flat: torch.Tensor, like) -> dict:
    """Inverse of ``pack``: views of ``flat`` with ``like``'s keys and
    shapes."""
    out, off = {}, 0
    for wk, bk in _layer_keys(like):
        for k in wk + bk:
            n = like[k].numel()
            out[k] = flat[off:off + n].view(like[k].shape)
            off += n
    return {k: out[k] for k in like}


def _dims(params, D: int) -> list[int]:
    """The input width then the hidden widths of an MLP params dict or, for
    a multi-policy dict, of every group (which must agree)."""
    if is_multi(params):
        dims = [_dims(group_params(params, g), D)
                for g in range(num_groups(params))]
        if any(d != dims[0] for d in dims):
            raise ValueError(f"the policy groups' widths differ: {dims}")
        return dims[0]
    dims = [D] + [params[f"hidden.{i}.weight"].shape[0]
                  for i in range(num_hidden(params))]
    if params["logits.weight"].shape != (N_ACT, dims[-1]):
        raise ValueError("the SGD kernels take a 5-action MLP head")
    for i, (fan_in, fan_out) in enumerate(zip(dims, dims[1:])):
        if params[f"hidden.{i}.weight"].shape != (fan_out, fan_in):
            raise ValueError(f"hidden.{i}: shape does not fit widths {dims}")
    return dims


def _f32(x, dev) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(())


def learner_dims(params, obs_dim: int, what: str) -> list[int]:
    """``_dims`` for the MLP learner kernels (K3-K6), which take any width
    and any number of hidden layers from 1: ``ValueError`` naming ``what``
    for an MLP without hidden layers, before any library call (the JAX
    kernels raise there too)."""
    dims = _dims(params, obs_dim)
    if len(dims) < 2:
        raise ValueError(f"{what} takes an MLP with at least 1 hidden layer, "
                         f"got widths {dims}")
    return dims


def check_stage_smem(lib, n_hidden: int, dims_arr, dims, dev, what: str):
    """Raise unless the stage kernels' shared memory for these widths
    (``wh_sgd_stage_smem_bytes``: K3/K4, K5/K6) fits the card."""
    smem = lib.wh_sgd_stage_smem_bytes(n_hidden, dims_arr)
    limit = build.smem_limit(dev, smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block for "
            f"widths {dims} (64 rows of the last hidden layer in the head "
            f"stage; at least 1 hidden layer); the card allows {limit}")


MAX_GROUP_AGENTS = 16  # agents of a grouped batch (mlp_learner.cuh MAXK)


def check_group_map(policy_groups) -> None:
    """Raise ``ValueError`` for a group map K3 / K4 cannot hold: more than
    16 agents or 16 groups (``mlp_learner.cuh`` enumerates a group's agents
    in 4 bits each of 64; ROADMAP T-7). None (one policy) fits."""
    if policy_groups is None:
        return
    n, k = len(policy_groups), max(int(g) for g in policy_groups) + 1
    if n > MAX_GROUP_AGENTS or k > MAX_GROUP_AGENTS:
        raise ValueError(
            f"K3 / K4 take a policy-group map over at most "
            f"{MAX_GROUP_AGENTS} agents and {MAX_GROUP_AGENTS} groups, got "
            f"{n} agents in {k} groups (ROADMAP T-7)")


def check_learner_fits(params, obs_dim: int, dev,
                       what: str = "SGD kernel") -> None:
    """Raise ``ValueError`` unless the PPO learner kernels (K3/K4) take
    these params (a multi-policy dict's groups too) on observations
    ``obs_dim`` wide on the CUDA device ``dev``. A trainer calls it when it
    is built."""
    dims = learner_dims(params, obs_dim, what)
    check_stage_smem(build.library(), len(dims) - 1, build.int_array(dims),
                     dims, dev, what)


def layout_slots(dims) -> int:
    """Slots of the MLP learners' ``*_layout`` entry points: x0's and
    dout's offsets and x0's row stride, then each hidden layer's act and dz
    offsets and row stride."""
    return 3 + 3 * (len(dims) - 1)


def stage_views(work, layout, dims, n: int, n_fwd: int | None = None) -> dict:
    """The MLP learner stages' rows in the workspace ``work`` as views at
    their natural widths, from a C ``*_layout`` entry point's
    ``layout_slots`` slots ``layout`` (``mlp_stages.cuh`` ``stage_layout``):
    ``act{i}`` over ``n_fwd`` rows (default ``n``), ``dz{i}`` and ``dout``
    over ``n``, and where ``n_fwd > n`` also ``out``, dout's buffer over
    ``n_fwd`` rows. The buffers' pad columns (to multiples of 32; dout's to
    8) lie beyond each view."""
    n_fwd = n if n_fwd is None else n_fwd

    def view(off, rows, ld, w):
        return work[off:off + rows * ld].view(rows, ld)[:, :w]

    views = {}
    for i, e in enumerate(dims[1:]):
        act, dz, ld = layout[3 + 3 * i:6 + 3 * i]
        views[f"act{i}"] = view(act, n_fwd, ld, e)
        views[f"dz{i}"] = view(dz, n, ld, e)
    views["dout"] = view(layout[1], n, 8, 6)
    if n_fwd > n:
        views["out"] = view(layout[1], n_fwd, 8, 6)
    return views


def fill_views(views: dict, inputs: dict) -> None:
    """Writes ``inputs`` into the ``stage_views`` of the same names, the pad
    columns zero."""
    for k, v in inputs.items():
        full = views[k].as_strided((views[k].shape[0], views[k].stride(0)),
                                   (views[k].stride(0), 1))
        full.zero_()
        views[k].copy_(v)


# ---- the sums of squares of a given gradient (F-10) ------------------------

RED = 256  # gradients a block of the sums of squares (mlp_learner.cuh RED)


class SqLayout(NamedTuple):
    """How a learner's kernels cut its packed gradient of ``n`` floats for
    the global norm (``reduce_kernel``'s partition,
    ``csrc/mlp_learner.cuh``): ``segments``, ``(start, length)`` runs of the
    vector the sums read, each cut into blocks of ``RED``, the blocks' sums
    one segment's after another's; ``pad`` a function from the packed
    gradient to that vector (K8's net padded to H rounded up to 4), or None
    for the packed gradient itself; ``run`` the launch whose library and
    workspace the kernel uses (None on the CPU)."""
    segments: tuple
    n: int
    pad: Callable | None = None
    run: object = None

    @property
    def sums(self) -> int:
        """The number of sums: a block's each."""
        return sum(-(-length // RED) for _, length in self.segments)


def mlp_sq_layout(params, run=None) -> SqLayout:
    """K3's and K5's layout: each policy group's gradient (one without
    groups) a segment, group after group."""
    k = num_groups(params) if is_multi(params) else 1
    n = sum(v.numel() for v in params.values()) // k
    return SqLayout(tuple((g * n, n) for g in range(k)), k * n, None, run)


def block_sumsq_plain(x: torch.Tensor) -> torch.Tensor:
    """The sums of squares of ``x``'s blocks of ``RED`` (the last one
    zero-filled) in ``reduce_kernel``'s order: each block's squares summed
    by the shared-memory tree, ``sh[t] += sh[t + w]`` for w = 128, 64, ...,
    1; IEEE float32 products and sums on either device, so the kernel's
    bits."""
    n = x.numel()
    sh = torch.zeros(-(-n // RED) * RED, dtype=torch.float32, device=x.device)
    sh[:n] = x.reshape(-1)
    sh = (sh * sh).view(-1, RED)
    w = RED // 2
    while w:
        sh = sh[:, :w] + sh[:, w:2 * w]
        w //= 2
    return sh[:, 0].contiguous()


def grad_sumsq_plain(grads: torch.Tensor, layout: SqLayout) -> torch.Tensor:
    """The plain version of ``grad_sumsq``: the packed gradient's sums of
    squares in ``layout``."""
    v = grads if layout.pad is None else layout.pad(grads)
    return torch.cat([block_sumsq_plain(v[s:s + n]) for s, n in
                      layout.segments])


def grad_sumsq(grads: torch.Tensor, layout: SqLayout, sq=None):
    """The sums of squares of the packed gradient ``grads`` in the blocks a
    learner's global norm reads (``layout``), as its grads kernel leaves
    them for its own gradient. On a CUDA tensor the kernel
    (``sumsq_kernel`` through ``layout.run``'s library entry point): into
    ``sq`` or, None, into the run's workspace, where its clip step reads
    them (the meshed route after the all-reduce); on a CPU tensor the plain
    version, returned. ``launches`` counts the calls that launch the kernel
    (K11's call launches it twice: the conv blocks, then the dense
    blocks)."""
    if grads.dtype != torch.float32 or grads.numel() != layout.n:
        raise ValueError(f"grad_sumsq takes the packed float32 gradient of "
                         f"{layout.n} floats, got {grads.dtype} "
                         f"{tuple(grads.shape)}")
    if sq is not None and (sq.dtype != torch.float32 or not sq.is_contiguous()
                           or sq.numel() != layout.sums
                           or sq.device != grads.device):
        raise ValueError(f"grad_sumsq writes {layout.sums} contiguous float32 "
                         f"sums on {grads.device}")
    if grads.device.type == "cpu":
        out = grad_sumsq_plain(grads, layout)
        return out if sq is None else sq.copy_(out)
    if layout.run is None:
        raise ValueError("grad_sumsq on the card takes a learner launch's "
                         "layout (its shapes and workspace)")
    layout.run.sumsq(grads.contiguous(), sq)
    grad_sumsq.launches += 1
    return sq


grad_sumsq.launches = 0


class SumsqEntry:
    """A learner launch's sums-of-squares entry points: ``SUMSQ`` and
    ``SQ_LAYOUT`` name its library's, which take the launch's ``shape``
    and ``work``space."""

    SUMSQ = SQ_LAYOUT = ""

    def sumsq(self, grads, sq=None) -> None:
        """The sums-of-squares kernel on ``grads``: into ``sq``, or the
        workspace."""
        err = getattr(self.lib, self.SUMSQ)(
            *self.shape, grads.data_ptr(), None if sq is None
            else sq.data_ptr(), self.work.data_ptr(), self.stream)
        build.check(err, "grad_sumsq kernel launch")

    def sq_view(self) -> torch.Tensor:
        """The sums of squares in the workspace, where the grads kernel
        writes them and the clip step reads them."""
        out = (build.L * 3)()
        build.check(getattr(self.lib, self.SQ_LAYOUT)(*self.shape, out),
                    self.SQ_LAYOUT)
        return self.work[out[0]:out[0] + out[1]]


class TrajLaunch(SumsqEntry):
    """One trajectory's inputs checked and laid out for a PPO learner's C
    entry points. A subclass adds its net's shape, the scratch its entry
    points share, the launches ``grads`` and ``clip_adam``, the names of its
    sums-of-squares entry points and its ``sq_layout``; ``bf16`` is the
    gradient entry point's flag for bf16 operands."""

    def __init__(self, traj, adv_n, targets, ent_coef, kl_coeff,
                 num_minibatches, clip_eps, value_coef, mask_actions,
                 matmul_dtype="float32"):
        self.bf16 = check_matmul_dtype(matmul_dtype)
        dev = traj.obs.device
        T, B, A, _ = traj.obs.shape
        M = num_minibatches
        if B % M:
            raise ValueError(f"B={B} not divisible by {M} minibatches")
        self.obs = traj.obs.to(torch.float32).contiguous()
        self.fields = [traj.action.to(torch.int32).contiguous()] + [
            x.to(torch.float32).contiguous()
            for x in (traj.log_prob, traj.value, adv_n, targets)]
        if any(f.shape != (T, B, A) for f in self.fields):
            raise ValueError("trajectory fields must be [T, B, A]")
        self.mask = None
        if mask_actions:
            self.mask = traj.mask.to(torch.uint8).contiguous()
            if self.mask.shape != (T, B, A, N_ACT):
                raise ValueError("mask must be [T, B, A, 5]")
        self.lib = build.library()
        self.scal = torch.stack([_f32(ent_coef, dev), _f32(kl_coeff, dev)])
        self.tbam = (T, B, A, M)
        self.mb_n = T * (B // M) * A
        self.coefs = (clip_eps, 1.0 - clip_eps, 1.0 + clip_eps, value_coef,
                      1.0 / self.mb_n)
        self.stream = build.stream_handle(dev)

    def batch_ptrs(self) -> list:
        """obs, the five fields and the mask, as the C entry points take
        them."""
        return [self.obs.data_ptr(), *(f.data_ptr() for f in self.fields),
                None if self.mask is None else self.mask.data_ptr()]


class MlpLaunch(TrajLaunch):
    """``TrajLaunch`` for the MLP's entry points (``csrc/sgd.cu``); with
    ``policy_groups`` the params are a multi-policy dict's."""

    SUMSQ, SQ_LAYOUT = "wh_sgd_sumsq", "wh_sgd_sq_layout"

    def __init__(self, params, traj, *args, policy_groups=None,
                 matmul_dtype="float32"):
        super().__init__(traj, *args, matmul_dtype=matmul_dtype)
        dev = traj.obs.device
        dims = _dims(params, traj.obs.shape[-1])
        multi = is_multi(params)
        k = num_groups(params) if multi else 1
        if multi != (policy_groups is not None) or multi and (
                len(policy_groups) != self.tbam[2]
                or max(policy_groups) + 1 != k):
            raise ValueError(f"params of {k} policies do not fit "
                             f"policy_groups={policy_groups}")
        check_group_map(policy_groups)
        gmap = None if policy_groups is None else build.int_array(
            [int(g) for g in policy_groups])
        self.grouped = policy_groups is not None
        self.shape = (len(dims) - 1, build.int_array(dims), *self.tbam, k,
                      gmap)
        check_stage_smem(self.lib, *self.shape[:2], dims, dev, "SGD kernel")
        self.dims = dims
        self.chunked = dims[0] > 128
        self.work = torch.empty(self.lib.wh_sgd_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)
        self.sq_layout = mlp_sq_layout(params, self)

    def _args(self, p_flat, mb: int, grads, sums) -> list:
        return [*self.shape, mb, *self.batch_ptrs(), p_flat.data_ptr(),
                self.scal.data_ptr(), *self.coefs, self.work.data_ptr(),
                grads.data_ptr(), sums.data_ptr(), int(self.bf16), self.stream]

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K4's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        err = self.lib.wh_sgd_grads(*self._args(p_flat, mb, grads, sums))
        build.check(err, "ppo_minibatch_grads kernel launch")
        ppo_minibatch_grads.launches += 1
        ppo_minibatch_grads.chunked_launches += self.chunked
        ppo_minibatch_grads.group_launches += self.grouped
        ppo_minibatch_grads.bf16_launches += self.bf16

    def clip_adam(self, p_flat, m_flat, v_flat, grads, rows, step: int,
                  max_grad_norm: float) -> None:
        """K3's optimizer kernel after ``grads``: clip + Adam in place."""
        err = self.lib.wh_sgd_clip_adam(
            *self.shape, step, p_flat.data_ptr(), m_flat.data_ptr(),
            v_flat.data_ptr(), grads.data_ptr(),
            *(r.data_ptr() for r in rows), max_grad_norm, ADAM_B1,
            1.0 - ADAM_B1, ADAM_B2, 1.0 - ADAM_B2, ADAM_EPS,
            self.work.data_ptr(), self.stream)
        build.check(err, "ppo_sgd_phase kernel launch")
        ppo_sgd_phase.launches += 1
        ppo_sgd_phase.chunked_launches += self.chunked
        ppo_sgd_phase.group_launches += self.grouped
        ppo_sgd_phase.bf16_launches += self.bf16

    def rows(self) -> dict:
        """The stages' rows in the workspace, as views at their natural
        widths (``plain_stage_chain``'s names and shapes)."""
        out = (build.L * layout_slots(self.dims))()
        build.check(self.lib.wh_sgd_layout(*self.shape, out), "wh_sgd_layout")
        return stage_views(self.work, out, self.dims, self.mb_n)

    def fill(self, inputs: dict) -> None:
        """Writes a stage's input rows (``stage_inputs``' names) into the
        workspace, the pad columns zero."""
        fill_views(self.rows(), inputs)

    def launch_stage(self, stage: str, p_flat, mb: int, grads, sums) -> None:
        """One stage's kernels (after the weight copies and the observation
        rows) on the rows the workspace holds."""
        err = self.lib.wh_sgd_stage(STAGES.index(stage),
                                    *self._args(p_flat, mb, grads, sums))
        build.check(err, f"MLP learner stage {stage} launch")
        mlp_stage.launches += 1


def mlp_stage(stage: str, params, traj, adv_n, targets, mb_idx: int,
              ent_coef, kl_coeff, inputs: dict, *, num_minibatches: int,
              clip_eps: float, value_coef: float, mask_actions: bool,
              policy_groups=None, matmul_dtype: str = "float32") -> dict:
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
        rows, counts = minibatch_rows(traj, adv_n, targets, mb_idx,
                                      num_minibatches, policy_groups)
        return plain_stage(stage, params, rows, counts, inputs, ent_coef,
                           kl_coeff, bf16=bf16, **kw)
    run = MlpLaunch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    policy_groups=policy_groups, matmul_dtype=matmul_dtype)
    run.fill(inputs)
    p_flat = pack(params)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=p_flat.device)
    run.launch_stage(stage, p_flat, mb_idx, grads, sums)
    if stage == "wgrad":
        return {k: v.clone() for k, v in unpack(grads, params).items()}
    views = run.rows()
    L = len(run.dims) - 1
    names = {"fwd": [f"act{i}" for i in range(L)],
             "head_loss": ["dout", f"dz{L - 1}"],
             "dgrad": [f"dz{i}" for i in range(L - 1)]}[stage]
    out = {k: views[k].clone() for k in names}
    if stage == "head_loss":
        out["losses"] = _losses(sums, run.mb_n, value_coef, ent_coef,
                                kl_coeff)
    return out


mlp_stage.launches = 0


def _losses(sums, mb_n, value_coef, ent_coef, kl_coeff):
    """``(total, pg, v, ent, kl)`` from the per-step metric sums."""
    pg = -sums[..., 0] / mb_n
    v = 0.5 * sums[..., 1] / mb_n
    ent = sums[..., 2] / mb_n
    kl = sums[..., 3] / mb_n
    return pg + value_coef * v - ent_coef * ent + kl_coeff * kl, pg, v, ent, kl


def _device_of(traj) -> torch.device:
    dev = traj.obs.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"SGD kernels: unsupported device {dev}")
    return dev


def sgd_phase_on_card(run: TrajLaunch, pack_fn, unpack_fn, params,
                      opt_state: AdamState, rows, ent_coef, kl_coeff, *,
                      num_epochs: int, num_minibatches: int,
                      value_coef: float, max_grad_norm: float, mesh=None):
    """``num_epochs x num_minibatches`` steps of ``run.grads`` then
    ``run.clip_adam`` on the packed params and moments, with no host
    synchronisation between them: ``(params, opt_state, losses)``. With
    ``mesh`` (the meshed route, JAX ``train/ppo.py:694-708``) each step's
    gradient and its four metric sums lie in one buffer, averaged over the
    mesh's ranks by one ``all_reduce`` between the two launches; then
    ``grad_sumsq`` takes the averaged gradient's sums of squares, so that
    the step clips by its global norm (JAX ``pmean``s before optax's clip,
    ``warehouse_tpu/ops/ppo_update.py:241-245``), in place of the rank's own
    gradient's that the grads kernel left."""
    M, n_steps = num_minibatches, num_epochs * num_minibatches
    p_flat, m_flat, v_flat = (pack_fn(t) for t in (params, opt_state.mu,
                                                   opt_state.nu))
    rows = [r.to(device=p_flat.device, dtype=torch.float32).contiguous()
            for r in rows]
    sums = torch.empty(n_steps, 4, dtype=torch.float32, device=p_flat.device)
    # The gradient, then a step's four metric sums: on a mesh, one buffer
    # and one collective.
    n = p_flat.numel()
    buf = torch.empty(n + 4, dtype=torch.float32, device=p_flat.device)
    grads = buf[:n]
    for s in range(n_steps):
        run.grads(p_flat, s % M, grads, sums[s] if mesh is None else buf[n:])
        if mesh is not None:
            mesh.mean_(buf)
            sums[s] = buf[n:]
            grad_sumsq(grads, run.sq_layout)
        run.clip_adam(p_flat, m_flat, v_flat, grads, rows, s, max_grad_norm)
    losses = _losses(sums.reshape(num_epochs, M, 4), run.mb_n, value_coef,
                     ent_coef, kl_coeff)
    new_opt = AdamState(opt_state.count + n_steps, unpack_fn(m_flat, params),
                        unpack_fn(v_flat, params))
    return unpack_fn(p_flat, params), new_opt, losses


def minibatch_grads_on_card(run: TrajLaunch, pack_fn, unpack_fn, params,
                            mb_idx: int, ent_coef, kl_coeff, *,
                            num_minibatches: int, value_coef: float):
    """One ``run.grads`` launch: ``((total, (pg, v, ent, kl)), grads)``."""
    if not 0 <= mb_idx < num_minibatches:
        raise ValueError(f"mb_idx={mb_idx} out of range")
    p_flat = pack_fn(params)
    grads = torch.empty_like(p_flat)
    sums = torch.empty(4, dtype=torch.float32, device=p_flat.device)
    run.grads(p_flat, mb_idx, grads, sums)
    total, *aux = _losses(sums, run.mb_n, value_coef, ent_coef, kl_coeff)
    return (total, tuple(aux)), unpack_fn(grads, params)


def ppo_sgd_phase(params, opt_state: AdamState, traj, adv_n, targets,
                  lr_row, bc1_row, bc2_row, ent_coef, kl_coeff, *,
                  num_epochs: int, num_minibatches: int, clip_eps: float,
                  value_coef: float, max_grad_norm: float,
                  mask_actions: bool, policy_groups=None,
                  matmul_dtype: str = "float32", mesh=None):
    """The whole SGD phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent, kl)`` tuple of ``[E, M]``
    tensors. On CUDA tensors each step is K4's gradient kernels, then K3's
    clip + Adam kernel on the packed params and moments; on CPU tensors
    the plain twin runs. With ``mesh`` it is the meshed learner: the
    trajectory laid out once (one ``MlpLaunch`` an update), each step's K4
    gradient and loss sums averaged over the ranks by one ``all_reduce``,
    then the step (``sgd_phase_on_card``). ``launches`` counts the
    optimizer kernel."""
    if _device_of(traj).type == "cpu":
        return ppo_sgd_phase_reference(
            params, opt_state, traj, adv_n, targets, lr_row, bc1_row,
            bc2_row, ent_coef, kl_coeff, num_epochs=num_epochs,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, max_grad_norm=max_grad_norm,
            mask_actions=mask_actions, policy_groups=policy_groups,
            matmul_dtype=matmul_dtype, mesh=mesh)
    run = MlpLaunch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    policy_groups=policy_groups, matmul_dtype=matmul_dtype)
    return sgd_phase_on_card(
        run, pack, unpack, params, opt_state, (lr_row, bc1_row, bc2_row),
        ent_coef, kl_coeff, num_epochs=num_epochs,
        num_minibatches=num_minibatches, value_coef=value_coef,
        max_grad_norm=max_grad_norm, mesh=mesh)


ppo_sgd_phase.launches = 0
# The launches on observations wider than 128 features (a global view).
ppo_sgd_phase.chunked_launches = 0
ppo_sgd_phase.group_launches = 0  # those that routed samples by group
ppo_sgd_phase.bf16_launches = 0   # those on bf16 operands


def ppo_minibatch_grads(params, traj, adv_n, targets, mb_idx: int, ent_coef,
                        kl_coeff, *, num_minibatches: int, clip_eps: float,
                        value_coef: float, mask_actions: bool,
                        policy_groups=None, matmul_dtype: str = "float32"):
    """One minibatch's loss and gradient: ``((total, (pg, v, ent, kl)),
    grads)``, the ``value_and_grad`` contract. The kernels on CUDA
    tensors, the plain twin on CPU ones. ``launches`` counts their
    launches, inside ``ppo_sgd_phase`` too."""
    if _device_of(traj).type == "cpu":
        return ppo_minibatch_grads_reference(
            params, traj, adv_n, targets, mb_idx, ent_coef, kl_coeff,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, mask_actions=mask_actions,
            policy_groups=policy_groups, matmul_dtype=matmul_dtype)
    run = MlpLaunch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    policy_groups=policy_groups, matmul_dtype=matmul_dtype)
    return minibatch_grads_on_card(
        run, pack, unpack, params, mb_idx, ent_coef, kl_coeff,
        num_minibatches=num_minibatches, value_coef=value_coef)


ppo_minibatch_grads.launches = 0
ppo_minibatch_grads.chunked_launches = 0
ppo_minibatch_grads.group_launches = 0
ppo_minibatch_grads.bf16_launches = 0

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

The kernels keep a tile of 64 samples' activations in shared memory and
read every matrix from device memory, the first layer over chunks of 128
observation features (``csrc/mlp_learner.cuh``), so any observation width
runs (a global view's 611); ``check_learner_fits`` raises for hidden layers
too wide for a tile's rows to fit the card's shared memory.

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

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS

from ..models.policy import (apply, group_params, is_multi, num_groups,
                             num_hidden)
from ..ops.ppo_update import NEG_INF, minibatch_epochs, ppo_losses
from ..optim import AdamState, adam_update_fn
from . import build

N_ACT = 5


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
                            matmul_dtype: str = "float32"):
    """The plain twin of ``ppo_sgd_phase``, on any device."""
    return minibatch_epochs(
        params, opt_state,
        loss_fn=_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff,
                         mask_actions, policy_groups, matmul_dtype),
        minibatches=env_minibatches(traj, adv_n, targets, num_minibatches),
        num_epochs=num_epochs, update_fn=adam_update_fn(
            (lr_row, bc1_row, bc2_row), opt_state.count, max_grad_norm))


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


def check_tile_smem(lib, n_hidden: int, dims_arr, dims, dev, what: str):
    """Raise unless the tile kernels' shared memory for these widths
    (``wh_sgd_smem_bytes``; K3-K6 share the layout) fits the card."""
    smem = lib.wh_sgd_smem_bytes(n_hidden, dims_arr)
    limit = build.smem_limit(dev, smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"{what} needs {smem} bytes of shared memory per block for "
            f"widths {dims} (64 rows of every hidden layer and of a "
            f"128-column input chunk; 1 to 4 hidden layers); the card "
            f"allows {limit}")


def check_learner_fits(params, obs_dim: int, dev,
                       what: str = "SGD kernel") -> None:
    """Raise ``ValueError`` unless the MLP learner kernels (K3-K6) take
    these params (a multi-policy dict's groups: K3/K4) on observations
    ``obs_dim`` wide on the CUDA device ``dev``. A trainer calls it when it
    is built."""
    dims = _dims(params, obs_dim)
    check_tile_smem(build.library(), len(dims) - 1, build.int_array(dims),
                    dims, dev, what)


class TrajLaunch:
    """One trajectory's inputs checked and laid out for a PPO learner's C
    entry points. A subclass adds its net's shape, the scratch its two
    entry points share, and the launches ``grads`` and ``clip_adam``;
    ``bf16`` is the gradient entry point's flag for bf16 operands."""

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


class _Launch(TrajLaunch):
    """``TrajLaunch`` for the MLP's entry points (``csrc/sgd.cu``); with
    ``policy_groups`` the params are a multi-policy dict's."""

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
        gmap = None if policy_groups is None else build.int_array(
            [int(g) for g in policy_groups])
        self.grouped = policy_groups is not None
        self.shape = (len(dims) - 1, build.int_array(dims), *self.tbam, k,
                      gmap)
        check_tile_smem(self.lib, *self.shape[:2], dims, dev, "SGD kernel")
        self.chunked = self.lib.wh_sgd_obs_chunks(*self.shape[:2]) > 1
        self.work = torch.empty(self.lib.wh_sgd_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K4's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        err = self.lib.wh_sgd_grads(
            *self.shape, mb, *self.batch_ptrs(), p_flat.data_ptr(),
            self.scal.data_ptr(), *self.coefs, self.work.data_ptr(),
            grads.data_ptr(), sums.data_ptr(), int(self.bf16), self.stream)
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
                      value_coef: float, max_grad_norm: float):
    """``num_epochs x num_minibatches`` steps of ``run.grads`` then
    ``run.clip_adam`` on the packed params and moments, with no host
    synchronisation between them: ``(params, opt_state, losses)``."""
    M, n_steps = num_minibatches, num_epochs * num_minibatches
    p_flat, m_flat, v_flat = (pack_fn(t) for t in (params, opt_state.mu,
                                                   opt_state.nu))
    rows = [r.to(device=p_flat.device, dtype=torch.float32).contiguous()
            for r in rows]
    grads = torch.empty_like(p_flat)
    sums = torch.empty(n_steps, 4, dtype=torch.float32, device=p_flat.device)
    for s in range(n_steps):
        run.grads(p_flat, s % M, grads, sums[s])
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
                  matmul_dtype: str = "float32"):
    """The whole SGD phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent, kl)`` tuple of ``[E, M]``
    tensors. On CUDA tensors each step is K4's gradient kernels, then K3's
    clip + Adam kernel on the packed params and moments; on CPU tensors
    the plain twin runs. ``launches`` counts the optimizer kernel."""
    if _device_of(traj).type == "cpu":
        return ppo_sgd_phase_reference(
            params, opt_state, traj, adv_n, targets, lr_row, bc1_row,
            bc2_row, ent_coef, kl_coeff, num_epochs=num_epochs,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, max_grad_norm=max_grad_norm,
            mask_actions=mask_actions, policy_groups=policy_groups,
            matmul_dtype=matmul_dtype)
    run = _Launch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  policy_groups=policy_groups, matmul_dtype=matmul_dtype)
    return sgd_phase_on_card(
        run, pack, unpack, params, opt_state, (lr_row, bc1_row, bc2_row),
        ent_coef, kl_coeff, num_epochs=num_epochs,
        num_minibatches=num_minibatches, value_coef=value_coef,
        max_grad_norm=max_grad_norm)


ppo_sgd_phase.launches = 0
# The launches whose first layer ran over more than one chunk of the
# observation (a global view's width).
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
    run = _Launch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  policy_groups=policy_groups, matmul_dtype=matmul_dtype)
    return minibatch_grads_on_card(
        run, pack, unpack, params, mb_idx, ent_coef, kl_coeff,
        num_minibatches=num_minibatches, value_coef=value_coef)


ppo_minibatch_grads.launches = 0
ppo_minibatch_grads.chunked_launches = 0
ppo_minibatch_grads.group_launches = 0
ppo_minibatch_grads.bf16_launches = 0

"""K5/K6: the IMPALA learner phase and per-minibatch V-trace gradients
(MLP), and their plain twins.

Counterparts of ``warehouse_tpu/pallas/vtrace_sgd.py``
``impala_sgd_phase_pallas`` (:445) and ``impala_minibatch_grads_pallas``
(:553). ``impala_sgd_phase`` runs the whole learner phase of one update —
``num_passes x num_minibatches`` optimizer steps, each the V-trace loss
of one minibatch (``train/impala.py:325-354``), its gradient and the
optax clip + RMSProp or Adam step — and ``impala_minibatch_grads`` one
minibatch's loss and gradient. Minibatch ``m`` is env columns ``[m B/M,
(m+1) B/M)`` of the ``[T, B, A, ...]`` trajectory and step ``s`` uses
minibatch ``s % M``: passes revisit the same slices
(``impala.py:356-424``). On a CUDA tensor the kernels of
``csrc/vtrace_sgd.cu`` run, reading the act phase's ``obs [T, B, A, D]``
in place; on a CPU tensor the plain twins run: autograd through the loss
below, ``ops.vtrace`` and ``optim.py``.

Inputs: ``params`` a dict keyed like ``ActorCriticMLP.state_dict``;
``traj`` anything with the fields ``obs``, ``action``,
``behavior_log_prob``, ``reward``, ``done`` (``[T, B, A]``), ``mask``
(``bool[T, B, A, 5]``; read only with ``mask_actions``) and
``boot_value`` (read only with ``bootstrap_truncated``); ``last_obs [B,
A, D]``, the observations after the chunk (V(s_T)); ``rows`` the
optimizer's per-step rows (``ClipRMSProp.step_rows`` or
``ClipAdam.step_rows``), the optimizer chosen by ``opt_state``'s type
(``RMSState`` or ``AdamState``). The TPU's field pack, last-obs pack,
8-row padding and block knobs have no counterpart here.
"""

from __future__ import annotations

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS

from ..models.policy import apply
from ..ops.ppo_update import (NEG_INF, action_log_prob_entropy,
                              minibatch_epochs)
from ..ops.vtrace import vtrace
from ..optim import (RMS_DECAY, RMS_EPS, AdamState, RMSState,
                     adam_update_fn, rms_update_fn)
from . import build
from .sgd import _device_of, _dims, _f32, check_tile_smem, pack, unpack

N_ACT = 5


def check_impala_fits(params, obs_dim: int, dev) -> None:
    """Raise ``ValueError`` unless the IMPALA learner kernels (K5/K6, the
    tile route) take these params on observations ``obs_dim`` wide on the
    CUDA device ``dev``. The trainer calls it when it is built."""
    dims = _dims(params, obs_dim)
    check_tile_smem(build.library(), len(dims) - 1, build.int_array(dims),
                    dims, dev, "IMPALA learner kernel")


def env_minibatches(traj, last_obs, num_minibatches: int):
    """The M minibatches ``(obs, action, behavior_log_prob, reward, done,
    mask, boot_value, last_obs)`` as env-column slices."""
    B = traj.obs.shape[1]
    if B % num_minibatches:
        raise ValueError(f"B={B} not divisible by {num_minibatches} "
                         "minibatches")
    w = B // num_minibatches
    fields = (traj.obs, traj.action, traj.behavior_log_prob, traj.reward,
              traj.done, traj.mask, traj.boot_value)
    return [tuple(x[:, m * w:(m + 1) * w] for x in fields)
            + (last_obs[m * w:(m + 1) * w],)
            for m in range(num_minibatches)]


def _loss_fn(ent_coef, *, gamma, rho_clip, c_clip, value_coef,
             mask_actions, bootstrap_truncated):
    """The V-trace loss of one minibatch (``impala.py:325-354``):
    ``(total, (pg_loss, v_loss, entropy))``."""
    def loss_fn(params, mb):
        obs, action, b_lp, reward, done, mask, boot, last_obs = mb
        logits, value = apply(params, obs)
        if mask_actions:
            logits = torch.where(mask, logits, NEG_INF)
        lp, entropy = action_log_prob_entropy(logits, action)
        _, last_value = apply(params, last_obs)
        vs, pg_adv = vtrace(b_lp, lp, reward, value, done, last_value, gamma,
                            rho_clip=rho_clip, c_clip=c_clip,
                            bootstrap_values=(boot if bootstrap_truncated
                                              else None))
        pg_loss = -(lp * pg_adv).mean()
        v_loss = 0.5 * ((value - vs) ** 2).mean()
        total = pg_loss + value_coef * v_loss - ent_coef * entropy
        return total, (pg_loss, v_loss, entropy)
    return loss_fn


def split_envs(mb, k: int) -> list:
    """A minibatch of ``env_minibatches`` as ``k`` micro-batches of
    consecutive env columns (``train/impala.py:374-390``)."""
    w = mb[-1].shape[0] // k
    return [tuple(x[:, j * w:(j + 1) * w] for x in mb[:-1])
            + (mb[-1][j * w:(j + 1) * w],) for j in range(k)]


def impala_sgd_phase_reference(params, opt_state, traj, last_obs, rows,
                               ent_coef, *, num_passes: int,
                               num_minibatches: int, max_grad_norm: float,
                               micro_batches: int = 1, update_fn=None,
                               **loss_kw):
    """The plain twin of ``impala_sgd_phase``, on any device. As the plain
    learner phase (ROADMAP M-4) it also takes what no kernel does:
    ``micro_batches`` env-axis micro-batches per minibatch, exact for
    V-trace (the mean of their gradients, one step), and ``update_fn``,
    the optimizer's step (``optim.ClipAdam.update_fn``, flat or not); by
    default the step of ``opt_state``'s type with ``rows``."""
    if update_fn is None:
        update_fn = (rms_update_fn if isinstance(opt_state, RMSState)
                     else adam_update_fn)(rows, opt_state.count,
                                          max_grad_norm)
    return minibatch_epochs(
        params, opt_state, loss_fn=_loss_fn(ent_coef, **loss_kw),
        minibatches=env_minibatches(traj, last_obs, num_minibatches),
        num_epochs=num_passes, update_fn=update_fn,
        micro_batches=micro_batches, split_micro=split_envs)


def impala_minibatch_grads_reference(params, traj, last_obs, mb_idx: int,
                                     ent_coef, *, num_minibatches: int,
                                     **loss_kw):
    """The plain twin of ``impala_minibatch_grads``: autograd on one
    minibatch."""
    mb = env_minibatches(traj, last_obs, num_minibatches)[mb_idx]
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    total, aux = _loss_fn(ent_coef, **loss_kw)(leaves, mb)
    grads = torch.autograd.grad(total, list(leaves.values()))
    return ((total.detach(), tuple(a.detach() for a in aux)),
            dict(zip(leaves, grads)))


# ---- the kernels ------------------------------------------------------------

class _Launch:
    """One trajectory's inputs checked and laid out for the C entry points
    (``csrc/vtrace_sgd.cu``), with the scratch they share."""

    def __init__(self, params, traj, last_obs, ent_coef, num_minibatches, *,
                 gamma, rho_clip, c_clip, value_coef, mask_actions,
                 bootstrap_truncated):
        dev = traj.obs.device
        T, B, A, D = traj.obs.shape
        M = num_minibatches
        if B % M:
            raise ValueError(f"B={B} not divisible by {M} minibatches")
        dims = _dims(params, D)
        self.obs = traj.obs.to(torch.float32).contiguous()
        self.last_obs = last_obs.to(torch.float32).contiguous()
        if self.last_obs.shape != (B, A, D):
            raise ValueError("last_obs must be [B, A, D]")
        self.fields = [traj.action.to(torch.int32).contiguous()] + [
            x.to(torch.float32).contiguous()
            for x in (traj.behavior_log_prob, traj.reward)] + [
            traj.done.to(torch.bool).contiguous()]
        if any(f.shape != (T, B, A) for f in self.fields):
            raise ValueError("trajectory fields must be [T, B, A]")
        self.mask = self.boot = None
        if mask_actions:
            self.mask = traj.mask.to(torch.bool).contiguous()
            if self.mask.shape != (T, B, A, N_ACT):
                raise ValueError("mask must be [T, B, A, 5]")
        if bootstrap_truncated:
            self.boot = traj.boot_value.to(torch.float32).contiguous()
            if self.boot.shape != (T, B, A):
                raise ValueError("boot_value must be [T, B, A]")
        self.lib = lib = build.library()
        self.shape = (len(dims) - 1, build.int_array(dims), T, B, A, M)
        check_tile_smem(lib, *self.shape[:2], dims, dev,
                        "IMPALA learner kernel")
        self.work = torch.empty(lib.wh_vtrace_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)
        self.scal = _f32(ent_coef, dev).reshape(1)
        self.mb_n = T * (B // M) * A
        self.coefs = (gamma, rho_clip, c_clip, value_coef, 1.0 / self.mb_n)
        self.stream = build.stream_handle(dev)

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K6's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        ptr = (lambda x: None if x is None else x.data_ptr())
        err = self.lib.wh_vtrace_grads(
            *self.shape, mb, self.obs.data_ptr(), self.last_obs.data_ptr(),
            *(f.data_ptr() for f in self.fields), ptr(self.mask),
            ptr(self.boot), p_flat.data_ptr(), self.scal.data_ptr(),
            *self.coefs, self.work.data_ptr(), grads.data_ptr(),
            sums.data_ptr(), self.stream)
        build.check(err, "impala_minibatch_grads kernel launch")
        impala_minibatch_grads.launches += 1

    def step(self, p_flat, moments, grads, rows, step: int,
             max_grad_norm: float) -> None:
        """K5's optimizer kernel after ``grads``: clip + RMSProp (one
        moment, ``nu``) or Adam (``mu``, ``nu``) in place."""
        if len(moments) == 1:
            err = self.lib.wh_vtrace_clip_rms(
                *self.shape, step, p_flat.data_ptr(), moments[0].data_ptr(),
                grads.data_ptr(), rows[0].data_ptr(), max_grad_norm,
                RMS_DECAY, 1.0 - RMS_DECAY, RMS_EPS, self.work.data_ptr(),
                self.stream)
        else:
            err = self.lib.wh_vtrace_clip_adam(
                *self.shape, step, p_flat.data_ptr(),
                *(m.data_ptr() for m in moments), grads.data_ptr(),
                *(r.data_ptr() for r in rows), max_grad_norm, ADAM_B1,
                1.0 - ADAM_B1, ADAM_B2, 1.0 - ADAM_B2, ADAM_EPS,
                self.work.data_ptr(), self.stream)
        build.check(err, "impala_sgd_phase kernel launch")
        impala_sgd_phase.launches += 1


def _losses(sums, mb_n, value_coef, ent_coef):
    """``(total, pg, v, ent)`` from the per-step metric sums
    (``vtrace_sgd.py:545-549``)."""
    pg = -sums[..., 0] / mb_n
    v = 0.5 * sums[..., 1] / mb_n
    ent = sums[..., 2] / mb_n
    return pg + value_coef * v - ent_coef * ent, pg, v, ent


def impala_sgd_phase(params, opt_state: RMSState | AdamState, traj,
                     last_obs, rows, ent_coef, *, num_passes: int,
                     num_minibatches: int, max_grad_norm: float, gamma: float,
                     rho_clip: float, c_clip: float, value_coef: float,
                     mask_actions: bool, bootstrap_truncated: bool):
    """The whole learner phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent)`` tuple of ``[passes, M]``
    tensors. On CUDA tensors each step is K6's gradient kernels, then K5's
    clip + RMSProp or Adam kernel on the packed params and moments; on CPU
    tensors the plain twin runs. ``launches`` counts the optimizer
    kernel."""
    loss_kw = dict(gamma=gamma, rho_clip=rho_clip, c_clip=c_clip,
                   value_coef=value_coef, mask_actions=mask_actions,
                   bootstrap_truncated=bootstrap_truncated)
    M, n_steps = num_minibatches, num_passes * num_minibatches
    if _device_of(traj).type == "cpu":
        return impala_sgd_phase_reference(
            params, opt_state, traj, last_obs, rows, ent_coef,
            num_passes=num_passes, num_minibatches=M,
            max_grad_norm=max_grad_norm, **loss_kw)
    run = _Launch(params, traj, last_obs, ent_coef, M, **loss_kw)
    p_flat = pack(params)
    rms = isinstance(opt_state, RMSState)
    moments = [pack(opt_state.nu)] if rms else [pack(opt_state.mu),
                                                 pack(opt_state.nu)]
    rows = [r.to(device=p_flat.device, dtype=torch.float32).contiguous()
            for r in rows]
    grads = torch.empty_like(p_flat)
    sums = torch.empty(n_steps, 4, dtype=torch.float32, device=p_flat.device)
    for s in range(n_steps):
        run.grads(p_flat, s % M, grads, sums[s])
        run.step(p_flat, moments, grads, rows, s, max_grad_norm)
    losses = _losses(sums.reshape(num_passes, M, 4), run.mb_n, value_coef,
                     ent_coef)
    count = opt_state.count + n_steps
    trees = [unpack(m, params) for m in moments]
    new_opt = RMSState(count, *trees) if rms else AdamState(count, *trees)
    return unpack(p_flat, params), new_opt, losses


impala_sgd_phase.launches = 0


def impala_minibatch_grads(params, traj, last_obs, mb_idx: int, ent_coef, *,
                           num_minibatches: int, gamma: float,
                           rho_clip: float, c_clip: float, value_coef: float,
                           mask_actions: bool, bootstrap_truncated: bool):
    """One minibatch's V-trace loss and gradient: ``((total, (pg, v,
    ent)), grads)``, the ``value_and_grad`` contract. The kernels on CUDA
    tensors, the plain twin on CPU ones. ``launches`` counts their
    launches, inside ``impala_sgd_phase`` too."""
    loss_kw = dict(gamma=gamma, rho_clip=rho_clip, c_clip=c_clip,
                   value_coef=value_coef, mask_actions=mask_actions,
                   bootstrap_truncated=bootstrap_truncated)
    if _device_of(traj).type == "cpu":
        return impala_minibatch_grads_reference(
            params, traj, last_obs, mb_idx, ent_coef,
            num_minibatches=num_minibatches, **loss_kw)
    if not 0 <= mb_idx < num_minibatches:
        raise ValueError(f"mb_idx={mb_idx} out of range")
    run = _Launch(params, traj, last_obs, ent_coef, num_minibatches,
                  **loss_kw)
    p_flat = pack(params)
    grads = torch.empty_like(p_flat)
    sums = torch.empty(4, dtype=torch.float32, device=p_flat.device)
    run.grads(p_flat, mb_idx, grads, sums)
    total, *aux = _losses(sums, run.mb_n, value_coef, ent_coef)
    return (total, tuple(aux)), unpack(grads, params)


impala_minibatch_grads.launches = 0

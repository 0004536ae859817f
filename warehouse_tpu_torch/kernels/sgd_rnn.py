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
"""

from __future__ import annotations

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS
from ..models.policy import apply_rnn
from ..ops.ppo_update import NEG_INF, minibatch_epochs, ppo_losses
from ..optim import AdamState, adam_update_fn
from . import build
from .act_rnn import pack_rnn, rnn_dims, split_carry, unpack_rnn
from .sgd import (TrajLaunch, _device_of, env_minibatches,
                  minibatch_grads_on_card, operand_precision,
                  sgd_phase_on_card)


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


def replay_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff, mask_actions,
                   precision="float32", normalize_adv=False):
    """The loss of one sequence minibatch ``((obs, action, old_lp, old_v,
    adv, target, mask), h_init)``: the T-step replay through ``apply_rnn``
    at ``precision``, then the PPO loss; ``normalize_adv`` normalizes the
    advantages over the minibatch (the JAX XLA learner's loss), else they
    arrive normalized (the kernels')."""
    def loss_fn(params, mb):
        (obs, action, old_lp, old_v, adv, tgt, mask), carry = mb
        logits, values = [], []
        for t in range(obs.shape[0]):
            lg, v, carry = apply_rnn(params, obs[t], carry,
                                     precision=precision)
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
                                matmul_dtype: str = "float32"):
    """The plain twin of ``ppo_rnn_sgd_phase``, on any device."""
    return minibatch_epochs(
        params, opt_state,
        loss_fn=replay_loss_fn(clip_eps, value_coef, ent_coef, kl_coeff,
                               mask_actions, operand_precision(matmul_dtype)),
        minibatches=seq_minibatches(traj, adv_n, targets, h0,
                                    num_minibatches),
        num_epochs=num_epochs, update_fn=adam_update_fn(
            (lr_row, bc1_row, bc2_row), opt_state.count, max_grad_norm))


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


# ---- the kernels ------------------------------------------------------------

class _Launch(TrajLaunch):
    """``TrajLaunch`` for the recurrent entry points (``csrc/sgd_rnn.cu``),
    with the rollout-start carry."""

    def __init__(self, params, traj, adv_n, targets, h0, *args,
                 matmul_dtype="float32"):
        super().__init__(traj, adv_n, targets, *args,
                         matmul_dtype=matmul_dtype)
        dev = traj.obs.device
        _, B, A, D = traj.obs.shape
        dims, H, lstm = rnn_dims(params, D)
        self.h0, self.c0 = split_carry(h0, lstm)
        if any(x is not None and (x.shape != (B, A, H) or x.device != dev)
               for x in (self.h0, self.c0)):
            raise ValueError(f"h0 must be [B, A, H] = {(B, A, H)} on {dev}")
        lib = self.lib
        dims_arr = build.int_array(dims)
        net = (len(dims) - 1, dims_arr, H, int(lstm))
        self.shape = (*net, *self.tbam)
        smem = lib.wh_rnn_sgd_smem_bytes(*net)
        limit = build.smem_limit(dev, smem)
        if not 0 < smem <= limit:
            raise ValueError(
                f"recurrent SGD kernels need {smem} bytes of shared memory "
                f"per block for widths {dims}, {H}; the card allows {limit}")
        self.n_params = lib.wh_rnn_param_floats(*net)
        self.work = torch.empty(lib.wh_rnn_sgd_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K9's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        if p_flat.numel() != self.n_params:
            raise ValueError("packed params do not fit the kernel's layout")
        err = self.lib.wh_rnn_sgd_grads(
            *self.shape, mb, *self.batch_ptrs(), self.h0.data_ptr(),
            None if self.c0 is None else self.c0.data_ptr(),
            p_flat.data_ptr(), self.scal.data_ptr(), *self.coefs,
            self.work.data_ptr(), grads.data_ptr(), sums.data_ptr(),
            int(self.bf16), self.stream)
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


def ppo_rnn_sgd_phase(params, opt_state: AdamState, traj, adv_n, targets, h0,
                      lr_row, bc1_row, bc2_row, ent_coef, kl_coeff, *,
                      num_epochs: int, num_minibatches: int, clip_eps: float,
                      value_coef: float, max_grad_norm: float,
                      mask_actions: bool, matmul_dtype: str = "float32"):
    """The whole recurrent SGD phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent, kl)`` tuple of ``[E, M]`` tensors.
    On CUDA tensors each step is K9's gradient kernels, then K8's clip +
    Adam kernel on the packed params and moments; on CPU tensors the plain
    twin runs. ``launches`` counts the optimizer kernel."""
    if _device_of(traj).type == "cpu":
        return ppo_rnn_sgd_phase_reference(
            params, opt_state, traj, adv_n, targets, h0, lr_row, bc1_row,
            bc2_row, ent_coef, kl_coeff, num_epochs=num_epochs,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, max_grad_norm=max_grad_norm,
            mask_actions=mask_actions, matmul_dtype=matmul_dtype)
    run = _Launch(params, traj, adv_n, targets, h0, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  matmul_dtype=matmul_dtype)
    return sgd_phase_on_card(
        run, pack_rnn, unpack_rnn, params, opt_state,
        (lr_row, bc1_row, bc2_row), ent_coef, kl_coeff,
        num_epochs=num_epochs, num_minibatches=num_minibatches,
        value_coef=value_coef, max_grad_norm=max_grad_norm)


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
    run = _Launch(params, traj, adv_n, targets, h0, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  matmul_dtype=matmul_dtype)
    return minibatch_grads_on_card(
        run, pack_rnn, unpack_rnn, params, mb_idx, ent_coef, kl_coeff,
        num_minibatches=num_minibatches, value_coef=value_coef)


ppo_rnn_minibatch_grads.launches = 0
ppo_rnn_minibatch_grads.bf16_launches = 0

"""K11/K12: the PPO SGD phase and per-minibatch gradients of the CNN
policy, and their plain twins.

Counterparts of ``warehouse_tpu/pallas/sgd_cnn.py``
``ppo_cnn_sgd_phase_pallas`` (:482) and ``ppo_cnn_minibatch_grads_pallas``
(:595), with the contracts of ``kernels.sgd.ppo_sgd_phase`` and
``ppo_minibatch_grads``: ``params`` is a dict keyed like
``ActorCriticCNN.state_dict``, everything else as there. On a CUDA tensor
the kernels of ``csrc/sgd_cnn.cu`` run on the packed vector of
``kernels.act.pack_cnn``, reading the act phase's ``obs [T, B, A, D]`` in
place; on a CPU tensor the plain twins run, which are the MLP's: autograd
through ``models.policy.apply`` (true convolutions for a CNN params dict),
``ops.ppo_update.ppo_losses`` and ``optim.py``.

The kernels compute the convolutions and their gradients in the 3x3 basis
(``csrc/cnn_net.cuh``), so the TPU kernel's unrolled matrices, their
rebuild and the gradient fold have no counterpart, nor have its VMEM
estimate and block knobs. They take two convs on the observation's grid,
the ego window or with global observations the whole (square) map, whose
5 channels are padded to 8 in shared memory only, and float32. A tile is
as many samples as fit one block's shared memory (32 on the 5 x 5 window,
8 on a 9 x 9 map); ``check_cnn_learner_fits`` raises for a grid of which
not 8 fit (the 11 x 11 map). ``matmul_dtype="bfloat16"`` runs every
product on bf16-rounded operands with float32 accumulation, the
convolutions and their gradients too (``pallas/sgd_cnn.py:213-216``); the
twins use ``models.policy.Bf16Conv`` and ``Bf16Linear``.
"""

from __future__ import annotations

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS
from ..models.policy import is_cnn
from ..optim import AdamState
from . import build
from .act import cnn_kernel_dims, pack_cnn, unpack_cnn
from .sgd import (TrajLaunch, _device_of, minibatch_grads_on_card,
                  ppo_minibatch_grads_reference, ppo_sgd_phase_reference,
                  sgd_phase_on_card)


def _check_cnn(params) -> None:
    if not is_cnn(params):
        raise ValueError("the CNN learner takes an ActorCriticCNN's params "
                         f"(conv.*, trunk.*), got {sorted(params)}")


def ppo_cnn_sgd_phase_reference(params, opt_state: AdamState, traj, adv_n,
                                targets, lr_row, bc1_row, bc2_row, ent_coef,
                                kl_coeff, **kw):
    """The plain twin of ``ppo_cnn_sgd_phase``, on any device: the MLP
    learner's twin on the CNN's params."""
    _check_cnn(params)
    return ppo_sgd_phase_reference(params, opt_state, traj, adv_n, targets,
                                   lr_row, bc1_row, bc2_row, ent_coef,
                                   kl_coeff, **kw)


def ppo_cnn_minibatch_grads_reference(params, traj, adv_n, targets,
                                      mb_idx: int, ent_coef, kl_coeff, **kw):
    """The plain twin of ``ppo_cnn_minibatch_grads``: autograd on one
    minibatch through the true convolutions."""
    _check_cnn(params)
    return ppo_minibatch_grads_reference(params, traj, adv_n, targets,
                                         mb_idx, ent_coef, kl_coeff, **kw)


def check_cnn_learner_fits(params, obs_dim: int, dev) -> tuple:
    """The kernels' ``(S, C0, C1, C2, H)`` for these params on
    observations ``obs_dim`` wide; raises ``ValueError`` unless the CNN
    learner kernels (K11/K12) take them on the CUDA device ``dev``. A
    trainer calls it when it is built."""
    _check_cnn(params)
    net = cnn_kernel_dims(params, obs_dim)
    smem = build.library().wh_cnn_sgd_smem_bytes(*net)
    limit = build.smem_limit(dev, smem)
    if not 0 < smem <= limit:
        raise ValueError(
            f"CNN SGD kernels need {smem} bytes of shared memory per block "
            f"for a tile of 8 samples at (S, channels, hidden) = {net}; the "
            f"card allows {limit}")
    return net


class _Launch(TrajLaunch):
    """``TrajLaunch`` for the CNN's entry points (``csrc/sgd_cnn.cu``)."""

    def __init__(self, params, traj, *args, matmul_dtype="float32"):
        _check_cnn(params)
        super().__init__(traj, *args, matmul_dtype=matmul_dtype)
        dev = traj.obs.device
        net = check_cnn_learner_fits(params, traj.obs.shape[-1], dev)
        self.n_params = self.lib.wh_cnn_param_floats(*net)
        # A grid larger than the ego window (the whole map of a global
        # view) leaves room for fewer samples a tile than the full 32.
        self.small_tile = self.lib.wh_cnn_sgd_small_tile(*net) == 1
        T, B, A, M = self.tbam
        self.shape = (*net, T, B, A, M)
        self.work = torch.empty(
            self.lib.wh_cnn_sgd_workspace_floats(*self.shape),
            dtype=torch.float32, device=dev)

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K12's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        if p_flat.numel() != self.n_params:
            raise ValueError("packed params do not fit the kernel's layout")
        err = self.lib.wh_cnn_sgd_grads(
            *self.shape, mb, *self.batch_ptrs(), p_flat.data_ptr(),
            self.scal.data_ptr(), *self.coefs, self.work.data_ptr(),
            grads.data_ptr(), sums.data_ptr(), int(self.bf16), self.stream)
        build.check(err, "ppo_cnn_minibatch_grads kernel launch")
        ppo_cnn_minibatch_grads.launches += 1
        ppo_cnn_minibatch_grads.small_tile_launches += self.small_tile
        ppo_cnn_minibatch_grads.bf16_launches += self.bf16

    def clip_adam(self, p_flat, m_flat, v_flat, grads, rows, step: int,
                  max_grad_norm: float) -> None:
        """K11's optimizer kernel after ``grads``: clip + Adam in place."""
        err = self.lib.wh_cnn_sgd_clip_adam(
            *self.shape, step, p_flat.data_ptr(), m_flat.data_ptr(),
            v_flat.data_ptr(), grads.data_ptr(),
            *(r.data_ptr() for r in rows), max_grad_norm, ADAM_B1,
            1.0 - ADAM_B1, ADAM_B2, 1.0 - ADAM_B2, ADAM_EPS,
            self.work.data_ptr(), self.stream)
        build.check(err, "ppo_cnn_sgd_phase kernel launch")
        ppo_cnn_sgd_phase.launches += 1
        ppo_cnn_sgd_phase.small_tile_launches += self.small_tile
        ppo_cnn_sgd_phase.bf16_launches += self.bf16


def ppo_cnn_sgd_phase(params, opt_state: AdamState, traj, adv_n, targets,
                      lr_row, bc1_row, bc2_row, ent_coef, kl_coeff, *,
                      num_epochs: int, num_minibatches: int, clip_eps: float,
                      value_coef: float, max_grad_norm: float,
                      mask_actions: bool, matmul_dtype: str = "float32"):
    """The whole CNN SGD phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent, kl)`` tuple of ``[E, M]``
    tensors. On CUDA tensors each step is K12's gradient kernels, then
    K11's clip + Adam kernel on the packed params and moments; on CPU
    tensors the plain twin runs. ``launches`` counts the optimizer
    kernel."""
    if _device_of(traj).type == "cpu":
        return ppo_cnn_sgd_phase_reference(
            params, opt_state, traj, adv_n, targets, lr_row, bc1_row,
            bc2_row, ent_coef, kl_coeff, num_epochs=num_epochs,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, max_grad_norm=max_grad_norm,
            mask_actions=mask_actions, matmul_dtype=matmul_dtype)
    run = _Launch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  matmul_dtype=matmul_dtype)
    return sgd_phase_on_card(
        run, pack_cnn, unpack_cnn, params, opt_state,
        (lr_row, bc1_row, bc2_row), ent_coef, kl_coeff,
        num_epochs=num_epochs, num_minibatches=num_minibatches,
        value_coef=value_coef, max_grad_norm=max_grad_norm)


ppo_cnn_sgd_phase.launches = 0
# The launches whose tiles held fewer samples than the full 32: a grid the
# size of the map (global observations), not the ego window.
ppo_cnn_sgd_phase.small_tile_launches = 0
ppo_cnn_sgd_phase.bf16_launches = 0  # those on bf16 operands


def ppo_cnn_minibatch_grads(params, traj, adv_n, targets, mb_idx: int,
                            ent_coef, kl_coeff, *, num_minibatches: int,
                            clip_eps: float, value_coef: float,
                            mask_actions: bool, matmul_dtype: str = "float32"):
    """One minibatch's loss and gradient of the CNN policy: ``((total,
    (pg, v, ent, kl)), grads)``. The kernels on CUDA tensors, the plain
    twin on CPU ones. ``launches`` counts their launches, inside
    ``ppo_cnn_sgd_phase`` too."""
    if _device_of(traj).type == "cpu":
        return ppo_cnn_minibatch_grads_reference(
            params, traj, adv_n, targets, mb_idx, ent_coef, kl_coeff,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, mask_actions=mask_actions,
            matmul_dtype=matmul_dtype)
    run = _Launch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                  num_minibatches, clip_eps, value_coef, mask_actions,
                  matmul_dtype=matmul_dtype)
    return minibatch_grads_on_card(
        run, pack_cnn, unpack_cnn, params, mb_idx, ent_coef, kl_coeff,
        num_minibatches=num_minibatches, value_coef=value_coef)


ppo_cnn_minibatch_grads.launches = 0
ppo_cnn_minibatch_grads.small_tile_launches = 0
ppo_cnn_minibatch_grads.bf16_launches = 0

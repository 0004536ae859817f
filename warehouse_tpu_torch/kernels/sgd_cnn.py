"""K11/K12: the PPO SGD phase and per-minibatch gradients of the CNN
policy, their stages and their plain twins.

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

One minibatch's gradient runs as five stages, each a kernel shaped by its
products (``csrc/sgd_cnn.cu``), with a plain version here that takes and
returns the same rows (``N`` samples of the minibatch, time-major):

- ``conv_forward_plain``: both convolutions with relu: ``a0 [N, S² C1]``
  and the trunk's input ``a1 [N, S² C2 + 6]`` (channel-last, then the self
  features);
- ``trunk_forward_plain``: the tanh trunk, the head, the clipped-PPO loss
  and its derivative: ``h``, ``dout [N, 6]``, ``dzt`` (the trunk's delta)
  and the loss terms;
- ``trunk_dgrad_plain``: conv 1's delta ``d1 = (dzt Wt) * (a1 > 0)``;
- ``conv_backward_plain``: conv 0's delta and both convs' gradients;
- ``trunk_wgrad_plain``: the trunk's and the head's gradients.

``plain_stage`` runs one by name, ``plain_stage_chain`` all five in turn,
``cnn_minibatch_grads_staged`` composes them into the contract of
``ppo_cnn_minibatch_grads_reference``; ``cnn_stage`` runs one stage's
kernel on given input rows (its plain version on a CPU tensor), for the
stages' checks on the card.

The kernels compute the convolutions and their gradients in the 3x3 basis,
so the TPU kernel's unrolled matrices, their rebuild and the gradient fold
have no counterpart, nor have its VMEM estimate and block knobs. They take
the model's conv widths (16, 32), at most 8 observation channels (the
global view's 5 are padded to 8 in shared memory only) and a square grid
whose conv tiles fit one block's shared memory: the 5 x 5 ego window and
the 9 x 9 map (16 samples a conv-forward tile and 8 a conv-backward tile
there); ``check_cnn_learner_fits`` raises for the others (the 11 x 11
map). ``matmul_dtype="bfloat16"`` runs the products on the tensor cores
on bf16-rounded operands with float32 sums, the convolutions and their
gradients too (``pallas/sgd_cnn.py:213-216``; the twins use
``models.policy.Bf16Conv`` and ``Bf16Linear``); float32 runs them as
FFMA on the CUDA cores.
"""

from __future__ import annotations

import torch

from ..config import ADAM_B1, ADAM_B2, ADAM_EPS
from ..models.policy import bf16_round, cnn_dims, conv_flags, is_cnn
from ..ops.ppo_update import NEG_INF, ppo_losses
from ..optim import AdamState
from . import build
from .act import cnn_kernel_dims, pack_cnn, unpack_cnn
from .sgd import (SqLayout, TrajLaunch, _device_of, _losses,
                  check_matmul_dtype, env_minibatches, minibatch_grads_on_card,
                  ppo_minibatch_grads_reference, ppo_sgd_phase_reference,
                  sgd_phase_on_card)

STAGES = ("conv_fwd", "trunk_fwd", "trunk_dgrad", "conv_bwd", "trunk_wgrad")
CONV_KEYS = ("conv.0.weight", "conv.0.bias", "conv.1.weight", "conv.1.bias")
DENSE_KEYS = ("trunk.weight", "trunk.bias", "logits.weight", "logits.bias",
              "value.weight", "value.bias")


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


# ---- the stages, plain ------------------------------------------------------

def minibatch_rows(traj, adv_n, targets, mb_idx: int, num_minibatches: int):
    """Minibatch ``mb_idx``'s ``(obs, action, old_lp, old_v, adv, target,
    mask)`` as rows ``[N, ...]`` in the kernels' sample order (time step,
    then env, then agent)."""
    mb = env_minibatches(traj, adv_n, targets, num_minibatches)[mb_idx]
    return tuple(x.reshape(-1, *x.shape[3:]) for x in mb)


def _rounder(bf16: bool):
    return bf16_round if bf16 else (lambda x: x)


def _img(rows, S: int, C: int):
    """``[N, S² C]`` channel-last rows as ``[N, C, S, S]``."""
    return rows.reshape(-1, S, S, C).permute(0, 3, 1, 2)


def _rows(img):
    """Inverse of ``_img``."""
    return img.permute(0, 2, 3, 1).reshape(img.shape[0], -1)


def _conv_backward(g, x, w):
    """(input gradient, weight gradient) of the 3x3 SAME convolution, under
    ``conv_flags``."""
    with conv_flags():
        gx, gw, _ = torch.ops.aten.convolution_backward(
            g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
            [True, True, False])
    return gx, gw


def conv_forward_plain(params, obs, bf16: bool = False):
    """Stage A: ``(a0 [N, S² C1], a1 [N, S² C2 + 6])``, relu after each
    conv; with ``bf16`` the conv operands rounded and ``a0``, ``a1`` stored
    rounded (they only ever feed products, and their masks keep their
    sign)."""
    r = _rounder(bf16)
    S, (C0, C1, C2), _ = cnn_dims(params)
    grid = S * S * C0
    x = r(obs)
    with conv_flags():
        z0 = torch.nn.functional.conv2d(
            _img(x[:, :grid], S, C0), r(params["conv.0.weight"]), padding=1)
        a0 = r(torch.relu(z0 + params["conv.0.bias"][:, None, None]))
        z1 = torch.nn.functional.conv2d(a0, r(params["conv.1.weight"]),
                                        padding=1)
    a1 = r(torch.relu(z1 + params["conv.1.bias"][:, None, None]))
    return _rows(a0), torch.cat([_rows(a1), x[:, grid:]], dim=-1)


def _head_w(params):
    """The fused head ``[6, H]`` (5 logits, then the value) and its bias."""
    return (torch.cat([params["logits.weight"], params["value.weight"]]),
            torch.cat([params["logits.bias"], params["value.bias"]]))


def trunk_forward_plain(params, a1, rows, ent_coef, kl_coeff, *,
                        clip_eps: float, value_coef: float,
                        mask_actions: bool, bf16: bool = False):
    """Stage B: ``(h, dout, dzt, losses)``: the trunk ``h = tanh(a1 Wt^T +
    bt)``, the head's outputs' loss derivative ``dout [N, 6]`` (the PPO
    loss of ``minibatch_rows``' ``rows``, averaged over the N samples), the
    trunk's delta ``dzt = (dout Wh) (1 - h²)`` and the loss terms
    ``(total, pg, v, ent, kl)``."""
    r = _rounder(bf16)
    _, action, old_lp, old_v, adv, tgt, mask = rows
    wh, bh = _head_w(params)
    h = torch.tanh(r(a1) @ r(params["trunk.weight"]).T
                   + params["trunk.bias"])
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
    dzt = (r(dout) @ r(wh)) * (1.0 - h * h)
    return h, dout, dzt, (total.detach(), *(a.detach() for a in aux))


def trunk_dgrad_plain(params, dzt, a1, bf16: bool = False):
    """Stage C: conv 1's delta ``d1 [N, S² C2] = (dzt Wt[:, :S² C2])``
    where ``a1 > 0``."""
    r = _rounder(bf16)
    n = params["trunk.weight"].shape[1] - 6
    return (r(dzt) @ r(params["trunk.weight"][:, :n])) * (a1[:, :n] > 0)


def conv_backward_plain(params, obs, a0, d1, bf16: bool = False) -> dict:
    """Stage D: the gradients of both convs (``CONV_KEYS``): conv 1's from
    ``d1`` and ``a0``, conv 0's delta (conv 1's transposed convolution of
    ``d1`` where ``a0 > 0``), conv 0's from it and the observation's grid;
    the biases sum the float32 deltas."""
    r = _rounder(bf16)
    S, (C0, C1, C2), _ = cnn_dims(params)
    x = _img(r(obs[:, :S * S * C0]), S, C0)
    a0i, d1i = _img(a0, S, C1), _img(d1, S, C2)
    gx, gw1 = _conv_backward(r(d1i), r(a0i), r(params["conv.1.weight"]))
    d0 = gx * (a0i > 0)
    _, gw0 = _conv_backward(r(d0), x, r(params["conv.0.weight"]))
    return {"conv.0.weight": gw0, "conv.0.bias": d0.sum(dim=(0, 2, 3)),
            "conv.1.weight": gw1, "conv.1.bias": d1i.sum(dim=(0, 2, 3))}


def trunk_wgrad_plain(a1, dzt, h, dout, bf16: bool = False) -> dict:
    """Stage E: the trunk's and the head's gradients (``DENSE_KEYS``)."""
    r = _rounder(bf16)
    dwh, dbh = r(dout).T @ r(h), dout.sum(0)
    return {"trunk.weight": r(dzt).T @ r(a1), "trunk.bias": dzt.sum(0),
            "logits.weight": dwh[:5], "logits.bias": dbh[:5],
            "value.weight": dwh[5:], "value.bias": dbh[5:]}


def plain_stage(stage: str, params, rows, inputs: dict, ent_coef, kl_coeff,
                *, clip_eps: float, value_coef: float, mask_actions: bool,
                bf16: bool = False) -> dict:
    """One of the ``STAGES``, plain, on minibatch ``rows``
    (``minibatch_rows``) and the input rows ``inputs`` it takes (by the
    names ``cnn_stage`` gives): its outputs by name."""
    if stage == "conv_fwd":
        return dict(zip(("a0", "a1"), conv_forward_plain(params, rows[0],
                                                         bf16)))
    if stage == "trunk_fwd":
        return dict(zip(("h", "dout", "dzt", "losses"), trunk_forward_plain(
            params, inputs["a1"], rows, ent_coef, kl_coeff, bf16=bf16,
            clip_eps=clip_eps, value_coef=value_coef,
            mask_actions=mask_actions)))
    if stage == "trunk_dgrad":
        return {"d1": trunk_dgrad_plain(params, inputs["dzt"], inputs["a1"],
                                        bf16)}
    if stage == "conv_bwd":
        return conv_backward_plain(params, rows[0], inputs["a0"],
                                   inputs["d1"], bf16)
    return trunk_wgrad_plain(inputs["a1"], inputs["dzt"], inputs["h"],
                             inputs["dout"], bf16)


def plain_stage_chain(params, rows, ent_coef, kl_coeff, **kw):
    """The ``STAGES`` plain, each on the rows the ones before it made:
    ``(chain, outputs)``, the rows (``a0``, ``a1``, ``h``, ``dout``,
    ``dzt``, ``d1``) and each stage's outputs by stage. ``kw``: those of
    ``plain_stage``."""
    chain, outputs = {}, {}
    for stage in STAGES:
        outputs[stage] = plain_stage(stage, params, rows, chain, ent_coef,
                                     kl_coeff, **kw)
        chain.update((k, v) for k, v in outputs[stage].items()
                     if k in ("a0", "a1", "h", "dout", "dzt", "d1"))
    return chain, outputs


def cnn_minibatch_grads_staged(params, traj, adv_n, targets, mb_idx: int,
                               ent_coef, kl_coeff, *, num_minibatches: int,
                               clip_eps: float, value_coef: float,
                               mask_actions: bool,
                               matmul_dtype: str = "float32"):
    """The five plain stages composed: ``ppo_cnn_minibatch_grads_reference``'s
    ``((total, (pg, v, ent, kl)), grads)``."""
    _check_cnn(params)
    rows = minibatch_rows(traj, adv_n, targets, mb_idx, num_minibatches)
    _, out = plain_stage_chain(
        params, rows, ent_coef, kl_coeff, clip_eps=clip_eps,
        value_coef=value_coef, mask_actions=mask_actions,
        bf16=check_matmul_dtype(matmul_dtype))
    losses = out["trunk_fwd"]["losses"]
    grads = {**out["conv_bwd"], **out["trunk_wgrad"]}
    return (losses[0], losses[1:]), {k: grads[k] for k in params}


# ---- the kernels ------------------------------------------------------------

def check_cnn_learner_fits(params, obs_dim: int, dev) -> tuple:
    """The kernels' ``(S, C0, C1, C2, H)`` for these params on
    observations ``obs_dim`` wide; raises ``ValueError`` unless the CNN
    learner kernels (K11/K12) take them on the CUDA device ``dev``. A
    trainer calls it when it is built."""
    _check_cnn(params)
    net = cnn_kernel_dims(params, obs_dim)
    smem = build.library().wh_cnn_sgd_smem_bytes(*net)
    if smem == 0:
        raise ValueError(
            f"the CNN SGD kernels take conv widths (16, 32) and at most 8 "
            f"observation channels, not (S, channels, hidden) = {net}")
    limit = build.smem_limit(dev, smem)
    if smem > limit:
        raise ValueError(
            f"CNN SGD kernels need {smem} bytes of shared memory per block "
            f"for conv tiles of 16 (forward) and 8 (backward) samples at "
            f"(S, channels, hidden) = {net}; the card allows {limit}")
    return net


def cnn_sq_layout(params, run=None) -> SqLayout:
    """K11's layout: the conv layers' gradient (first in the packed
    vector), then the dense layers'."""
    n_conv = sum(params[k].numel() for k in CONV_KEYS)
    n = sum(v.numel() for v in params.values())
    return SqLayout(((0, n_conv), (n_conv, n - n_conv)), n, None, run)


class CnnLaunch(TrajLaunch):
    """``TrajLaunch`` for the CNN's entry points (``csrc/sgd_cnn.cu``)."""

    SUMSQ, SQ_LAYOUT = "wh_cnn_sgd_sumsq", "wh_cnn_sgd_sq_layout"

    def __init__(self, params, traj, *args, matmul_dtype="float32"):
        _check_cnn(params)
        super().__init__(traj, *args, matmul_dtype=matmul_dtype)
        dev = traj.obs.device
        net = check_cnn_learner_fits(params, traj.obs.shape[-1], dev)
        self.n_params = self.lib.wh_cnn_param_floats(*net)
        # A grid larger than the ego window (the whole map of a global
        # view) leaves room for fewer samples a conv tile.
        self.small_tile = self.lib.wh_cnn_sgd_small_tile(*net) == 1
        T, B, A, M = self.tbam
        self.shape = (*net, T, B, A, M)
        self.work = torch.empty(
            self.lib.wh_cnn_sgd_workspace_floats(*self.shape),
            dtype=torch.float32, device=dev)
        self.sq_layout = cnn_sq_layout(params, self)

    def _args(self, p_flat, mb: int, grads, sums) -> list:
        if p_flat.numel() != self.n_params:
            raise ValueError("packed params do not fit the kernel's layout")
        return [*self.shape, mb, *self.batch_ptrs(), p_flat.data_ptr(),
                self.scal.data_ptr(), *self.coefs, self.work.data_ptr(),
                grads.data_ptr(), sums.data_ptr(), int(self.bf16),
                self.stream]

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K12's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        err = self.lib.wh_cnn_sgd_grads(*self._args(p_flat, mb, grads, sums))
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

    def rows(self) -> dict:
        """The stages' rows in the workspace, as views: ``a0 [N, S² C1]``,
        ``a1 [N, KT]``, ``h [N, H]``, ``dzt [N, HK]``, ``dout [N, 8]``,
        ``d1 [N, S² C2]`` (KT and HK: the trunk's input and width padded
        to 32 with zeros)."""
        out = (build.L * 8)()
        build.check(self.lib.wh_cnn_sgd_layout(*self.shape, out),
                    "wh_cnn_sgd_layout")
        S, _, C1, C2, H = self.shape[:5]
        N = self.mb_n
        widths = (S * S * C1, out[6], H, out[7], 8, S * S * C2)
        return {k: self.work[out[i]:out[i] + N * w].view(N, w)
                for i, (k, w) in enumerate(zip(
                    ("a0", "a1", "h", "dzt", "dout", "d1"), widths))}

    def fill(self, inputs: dict) -> None:
        """Writes a stage's input rows (``cnn_stage``'s names, unpadded)
        into the workspace, padding with zeros."""
        views = self.rows()
        for k, v in inputs.items():
            views[k].zero_()
            views[k][:, :v.shape[1]] = v

    def launch_stage(self, stage: str, p_flat, mb: int, grads, sums) -> None:
        """One stage's kernel on the rows the workspace holds."""
        err = self.lib.wh_cnn_sgd_stage(STAGES.index(stage),
                                        *self._args(p_flat, mb, grads, sums))
        build.check(err, f"CNN learner stage {stage} launch")
        cnn_stage.launches += 1


def cnn_stage(stage: str, params, traj, adv_n, targets, mb_idx: int,
              ent_coef, kl_coeff, inputs: dict, *, num_minibatches: int,
              clip_eps: float, value_coef: float, mask_actions: bool,
              matmul_dtype: str = "float32") -> dict:
    """One of the ``STAGES`` of minibatch ``mb_idx``'s gradient on the
    input rows ``inputs`` (as the plain stages name and shape them), its
    outputs as a dict: ``conv_fwd`` (no inputs) gives ``a0``, ``a1``;
    ``trunk_fwd`` (``a1``) gives ``h``, ``dout``, ``dzt`` and ``losses``;
    ``trunk_dgrad`` (``dzt``, ``a1``) gives ``d1``; ``conv_bwd`` (``a0``,
    ``d1``) and ``trunk_wgrad`` (``a1``, ``dzt``, ``h``, ``dout``) give
    their gradients. The stage's kernel on CUDA tensors, its plain version
    on CPU ones. ``launches`` counts the kernel launches."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    _check_cnn(params)
    bf16 = check_matmul_dtype(matmul_dtype)
    if _device_of(traj).type == "cpu":
        rows = minibatch_rows(traj, adv_n, targets, mb_idx, num_minibatches)
        return plain_stage(stage, params, rows, inputs, ent_coef, kl_coeff,
                           clip_eps=clip_eps, value_coef=value_coef,
                           mask_actions=mask_actions, bf16=bf16)
    run = CnnLaunch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    matmul_dtype=matmul_dtype)
    run.fill(inputs)
    p_flat = pack_cnn(params)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=p_flat.device)
    run.launch_stage(stage, p_flat, mb_idx, grads, sums)
    views = run.rows()
    H, D = params["trunk.weight"].shape
    if stage == "conv_fwd":
        return {"a0": views["a0"].clone(), "a1": views["a1"][:, :D].clone()}
    if stage == "trunk_fwd":
        return {"h": views["h"].clone(), "dout": views["dout"][:, :6].clone(),
                "dzt": views["dzt"][:, :H].clone(),
                "losses": _losses(sums, run.mb_n, value_coef, ent_coef,
                                  kl_coeff)}
    if stage == "trunk_dgrad":
        return {"d1": views["d1"].clone()}
    g = unpack_cnn(grads, params)
    return {k: g[k] for k in (CONV_KEYS if stage == "conv_bwd"
                              else DENSE_KEYS)}


cnn_stage.launches = 0


def ppo_cnn_sgd_phase(params, opt_state: AdamState, traj, adv_n, targets,
                      lr_row, bc1_row, bc2_row, ent_coef, kl_coeff, *,
                      num_epochs: int, num_minibatches: int, clip_eps: float,
                      value_coef: float, max_grad_norm: float,
                      mask_actions: bool, matmul_dtype: str = "float32",
                      mesh=None):
    """The whole CNN SGD phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent, kl)`` tuple of ``[E, M]``
    tensors. On CUDA tensors each step is K12's gradient kernels, then
    K11's clip + Adam kernel on the packed params and moments; on CPU
    tensors the plain twin runs. With ``mesh``, the meshed learner: each
    step's K12 gradient averaged over the ranks before the step
    (``sgd.sgd_phase_on_card``). ``launches`` counts the optimizer
    kernel."""
    if _device_of(traj).type == "cpu":
        return ppo_cnn_sgd_phase_reference(
            params, opt_state, traj, adv_n, targets, lr_row, bc1_row,
            bc2_row, ent_coef, kl_coeff, num_epochs=num_epochs,
            num_minibatches=num_minibatches, clip_eps=clip_eps,
            value_coef=value_coef, max_grad_norm=max_grad_norm,
            mask_actions=mask_actions, matmul_dtype=matmul_dtype, mesh=mesh)
    run = CnnLaunch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    matmul_dtype=matmul_dtype)
    return sgd_phase_on_card(
        run, pack_cnn, unpack_cnn, params, opt_state,
        (lr_row, bc1_row, bc2_row), ent_coef, kl_coeff,
        num_epochs=num_epochs, num_minibatches=num_minibatches,
        value_coef=value_coef, max_grad_norm=max_grad_norm, mesh=mesh)


ppo_cnn_sgd_phase.launches = 0
# The launches whose conv tiles held fewer samples than on the 5 x 5 ego
# window: a grid the size of the map (global observations).
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
    run = CnnLaunch(params, traj, adv_n, targets, ent_coef, kl_coeff,
                    num_minibatches, clip_eps, value_coef, mask_actions,
                    matmul_dtype=matmul_dtype)
    return minibatch_grads_on_card(
        run, pack_cnn, unpack_cnn, params, mb_idx, ent_coef, kl_coeff,
        num_minibatches=num_minibatches, value_coef=value_coef)


ppo_cnn_minibatch_grads.launches = 0
ppo_cnn_minibatch_grads.small_tile_launches = 0
ppo_cnn_minibatch_grads.bf16_launches = 0

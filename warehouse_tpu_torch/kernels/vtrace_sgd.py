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

One minibatch's gradient runs on the card as stages, each a kernel shaped
by its products (``csrc/vtrace_sgd.cu``, on the PPO learner's stages), with
a plain version here that takes and gives the same rows: the minibatch's N
samples in (time step, env, agent) order, then its nb = B/M * A last-obs
rows (``vtrace_minibatch_rows``):

- ``fwd``: each hidden layer's tanh output ``act0..`` over all N + nb rows
  (``sgd.fwd_plain``);
- ``head``: the head's outputs ``out [N + nb, 6]`` (5 logits, the value);
- ``trace``: V-trace and the loss on the samples' outputs, the bootstrap
  value from the last-obs rows' (stop-gradient), the loss's derivative
  ``dout [N, 6]`` and the loss terms;
- ``dgrad``: the last layer's delta ``(dout W_head) (1 - act²)``, then the
  earlier layers' (``sgd.dgrad_plain``), on the N samples only;
- ``wgrad``: every weight's and bias's gradient from the samples' rows
  (``sgd.wgrad_plain``).

``vtrace_plain_stage`` runs one by name, ``vtrace_plain_stage_chain`` all
five in turn, ``vtrace_minibatch_grads_staged`` composes them into the
contract of ``impala_minibatch_grads_reference``; ``vtrace_stage`` runs
one stage's kernel on given input rows (its plain version on a CPU
tensor), for the stages' checks on the card.

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
from . import build, sgd
from .sgd import (SumsqEntry, _device_of, _dims, _f32, check_stage_smem,
                  grad_sumsq, learner_dims, mlp_sq_layout, pack, unpack)

N_ACT = 5
VT_STAGES = ("fwd", "head", "trace", "dgrad", "wgrad")


def check_impala_fits(params, obs_dim: int, dev) -> None:
    """Raise ``ValueError`` unless the IMPALA learner kernels (K5/K6) take
    these params on observations ``obs_dim`` wide on the CUDA device
    ``dev``: the head stage's 64 rows of the last hidden layer in shared
    memory. The trainer calls it when it is built."""
    dims = learner_dims(params, obs_dim, "IMPALA learner kernel")
    check_stage_smem(build.library(), len(dims) - 1, build.int_array(dims),
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


def _vtrace_loss(logits, value, last_value, fields, ent_coef, *, gamma,
                 rho_clip, c_clip, value_coef, mask_actions,
                 bootstrap_truncated):
    """The V-trace loss of one minibatch's head outputs (``impala.py:
    325-354``), time first: ``(total, (pg_loss, v_loss, entropy))``;
    ``fields`` are ``(action, behavior_log_prob, reward, done, mask,
    boot_value)``."""
    action, b_lp, reward, done, mask, boot = fields
    if mask_actions:
        logits = torch.where(mask, logits, NEG_INF)
    lp, entropy = action_log_prob_entropy(logits, action)
    vs, pg_adv = vtrace(b_lp, lp, reward, value, done, last_value, gamma,
                        rho_clip=rho_clip, c_clip=c_clip,
                        bootstrap_values=boot if bootstrap_truncated else None)
    pg_loss = -(lp * pg_adv).mean()
    v_loss = 0.5 * ((value - vs) ** 2).mean()
    total = pg_loss + value_coef * v_loss - ent_coef * entropy
    return total, (pg_loss, v_loss, entropy)


def _loss_fn(ent_coef, precision="float32", **loss_kw):
    """The V-trace loss of one minibatch of ``env_minibatches``, the model
    (any feed-forward policy) applied at ``precision``: ``(total,
    (pg_loss, v_loss, entropy))``."""
    def loss_fn(params, mb):
        obs, *fields, last_obs = mb
        logits, value = apply(params, obs, precision=precision)
        _, last_value = apply(params, last_obs, precision=precision)
        return _vtrace_loss(logits, value, last_value, fields, ent_coef,
                            **loss_kw)
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
                               precision: str = "float32", mesh=None,
                               **loss_kw):
    """The plain twin of ``impala_sgd_phase``, on any device. As the plain
    learner phase (ROADMAP M-4) it also takes what no kernel does:
    ``micro_batches`` env-axis micro-batches per minibatch, exact for
    V-trace (the mean of their gradients, one step), ``update_fn``, the
    optimizer's step (``optim.ClipAdam.update_fn``, flat or not; by
    default the step of ``opt_state``'s type with ``rows``), and any
    feed-forward model at ``precision`` (the flax-bf16 forward for a bf16
    model, as the JAX XLA learner differentiates it). With ``mesh`` each
    step's gradient and losses are averaged over its ranks before the step
    (the JAX learner's ``pmean``, ``train/impala.py:408-411``)."""
    if update_fn is None:
        update_fn = (rms_update_fn if isinstance(opt_state, RMSState)
                     else adam_update_fn)(rows, opt_state.count,
                                          max_grad_norm)
    return minibatch_epochs(
        params, opt_state, loss_fn=_loss_fn(ent_coef, precision, **loss_kw),
        minibatches=env_minibatches(traj, last_obs, num_minibatches),
        num_epochs=num_passes, update_fn=update_fn,
        micro_batches=micro_batches, split_micro=split_envs, mesh=mesh)


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


# ---- the stages, plain ------------------------------------------------------

def vtrace_minibatch_rows(traj, last_obs, mb_idx: int, num_minibatches: int):
    """Minibatch ``mb_idx``'s rows in the kernels' order: ``(x, action,
    behavior_log_prob, reward, done, mask, boot_value)``, ``x [N + nb, D]``
    the N samples' observations in (time step, env, agent) order, then the
    nb last-obs rows in (env, agent) order; the fields ``[N, ...]``."""
    obs, *fields, lobs = env_minibatches(traj, last_obs,
                                         num_minibatches)[mb_idx]
    D = obs.shape[-1]
    x = torch.cat([obs.reshape(-1, D), lobs.reshape(-1, D)])
    return (x, *(f.reshape(-1, *f.shape[3:]) for f in fields))


def head_plain(params, h) -> dict:
    """The head's outputs ``out [rows, 6]`` (5 logits, then the value) on
    the last layer's rows ``h``."""
    w, b = sgd._head_w(params)
    return {"out": h @ w.T + b}


def trace_plain(out, rows, ent_coef, **loss_kw) -> dict:
    """V-trace and the loss on the N samples' head outputs (the first N
    rows of ``out``), the last nb rows' values the bootstrap (stop-
    gradient): the loss's derivative ``dout [N, 6]`` and ``losses``,
    ``(total, pg, v, ent)``."""
    N = rows[1].shape[0]
    nb = out.shape[0] - N
    o = out[:N].detach().requires_grad_(True)
    with torch.enable_grad():
        t = o.reshape(N // nb, nb, 6)
        fields = tuple(f.reshape(N // nb, nb, *f.shape[1:]) for f in rows[1:])
        total, aux = _vtrace_loss(t[..., :5], t[..., 5], out[N:, 5].detach(),
                                  fields, ent_coef, **loss_kw)
        dout, = torch.autograd.grad(total, o)
    return {"dout": dout, "losses": (total.detach(),
                                     *(a.detach() for a in aux))}


def vt_dgrad_plain(params, dout, acts) -> dict:
    """The samples' deltas: ``dz{L-1} = (dout W_head) (1 - act{L-1}²)``,
    then ``sgd.dgrad_plain``'s; ``acts`` every layer's activations (their
    first N rows are the samples')."""
    N, L = dout.shape[0], len(acts)
    dz = (dout @ sgd._head_w(params)[0]) * (1.0 - acts[-1][:N] ** 2)
    return {f"dz{L - 1}": dz, **sgd.dgrad_plain(params, dz, acts[:-1], [N])}


def vtrace_stage_inputs(stage: str, params, chain: dict) -> dict:
    """The rows of ``chain`` (``vtrace_plain_stage_chain``'s) that
    ``stage`` reads, by name."""
    L = sgd._n_hidden(params)
    acts = [f"act{i}" for i in range(L)]
    names = {"fwd": [], "head": [acts[-1]], "trace": ["out"],
             "dgrad": ["dout"] + acts,
             "wgrad": acts + [f"dz{i}" for i in range(L)] + ["dout"]}[stage]
    return {k: chain[k] for k in names}


def vtrace_plain_stage(stage: str, params, rows, inputs: dict, ent_coef,
                       **loss_kw) -> dict:
    """One of the ``VT_STAGES``, plain, on minibatch ``rows``
    (``vtrace_minibatch_rows``') and the input rows ``inputs`` it takes
    (by the names ``vtrace_stage_inputs`` gives): its outputs by name.
    ``loss_kw``: ``gamma``, ``rho_clip``, ``c_clip``, ``value_coef``,
    ``mask_actions``, ``bootstrap_truncated``."""
    L, N = sgd._n_hidden(params), rows[1].shape[0]
    if stage == "fwd":
        return sgd.fwd_plain(params, rows[0], [rows[0].shape[0]])
    if stage == "head":
        return head_plain(params, inputs[f"act{L - 1}"])
    if stage == "trace":
        return trace_plain(inputs["out"], rows, ent_coef, **loss_kw)
    if stage == "dgrad":
        return vt_dgrad_plain(params, inputs["dout"],
                              [inputs[f"act{i}"] for i in range(L)])
    return sgd.wgrad_plain(params, rows[0], inputs, [N])


def vtrace_plain_stage_chain(params, rows, ent_coef, **loss_kw):
    """The ``VT_STAGES`` plain, each on the rows the ones before it made:
    ``(chain, outputs)``, the rows by name and each stage's outputs by
    stage."""
    chain, outputs = {}, {}
    for stage in VT_STAGES:
        outputs[stage] = vtrace_plain_stage(
            stage, params, rows, vtrace_stage_inputs(stage, params, chain),
            ent_coef, **loss_kw)
        if stage != "wgrad":
            chain.update((k, v) for k, v in outputs[stage].items()
                         if k != "losses")
    return chain, outputs


def vtrace_minibatch_grads_staged(params, traj, last_obs, mb_idx: int,
                                  ent_coef, *, num_minibatches: int,
                                  **loss_kw):
    """The five plain stages composed: ``impala_minibatch_grads_reference``'s
    ``((total, (pg, v, ent)), grads)``."""
    rows = vtrace_minibatch_rows(traj, last_obs, mb_idx, num_minibatches)
    _, out = vtrace_plain_stage_chain(params, rows, ent_coef, **loss_kw)
    losses = out["trace"]["losses"]
    return (losses[0], losses[1:]), out["wgrad"]


# ---- the kernels ------------------------------------------------------------

class _Launch(SumsqEntry):
    """One trajectory's inputs checked and laid out for the C entry points
    (``csrc/vtrace_sgd.cu``), with the scratch they share."""

    SUMSQ, SQ_LAYOUT = "wh_vtrace_sumsq", "wh_vtrace_sq_layout"

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
        check_stage_smem(lib, *self.shape[:2], dims, dev,
                         "IMPALA learner kernel")
        self.dims = dims
        self.nb = (B // M) * A
        self.work = torch.empty(lib.wh_vtrace_workspace_floats(*self.shape),
                                dtype=torch.float32, device=dev)
        self.sq_layout = mlp_sq_layout(params, self)
        self.scal = _f32(ent_coef, dev).reshape(1)
        self.mb_n = T * (B // M) * A
        self.coefs = (gamma, rho_clip, c_clip, value_coef, 1.0 / self.mb_n)
        self.stream = build.stream_handle(dev)

    def _launch(self, stage: int, p_flat, mb: int, grads, sums,
                what: str) -> list:
        """``wh_vtrace_grads`` with ``stage`` (-1 the whole gradient, 0-4
        one of the ``VT_STAGES`` alone, 5 the prep alone): the kernels it
        launched, by stage (``VT_STAGES``, then the prep)."""
        ptr = (lambda x: None if x is None else x.data_ptr())
        launched = (build.L * (len(VT_STAGES) + 1))()
        err = self.lib.wh_vtrace_grads(
            stage, *self.shape, mb, self.obs.data_ptr(),
            self.last_obs.data_ptr(), *(f.data_ptr() for f in self.fields),
            ptr(self.mask), ptr(self.boot), p_flat.data_ptr(),
            self.scal.data_ptr(), *self.coefs, self.work.data_ptr(),
            ptr(grads), ptr(sums), launched, self.stream)
        build.check(err, what)
        return list(launched)

    def grads(self, p_flat, mb: int, grads, sums) -> None:
        """K6's kernels: minibatch ``mb``'s gradient into ``grads``, its
        metric sums into ``sums [4]``."""
        launched = self._launch(-1, p_flat, mb, grads, sums,
                                "impala_minibatch_grads kernel launch")
        f = impala_minibatch_grads
        f.launches += 1
        f.stage_launches += sum(launched)
        for stage, n in zip(VT_STAGES, launched):
            setattr(f, f"{stage}_launches", getattr(f, f"{stage}_launches")
                    + n)

    def rows(self) -> dict:
        """The stages' rows in the workspace, as views at their natural
        widths (``vtrace_plain_stage_chain``'s names and shapes): ``act``
        and ``out`` over the N samples and the nb last-obs rows, ``dz`` and
        ``dout`` over the samples (``dout`` the first N rows of ``out``'s
        buffer)."""
        out = (build.L * sgd.layout_slots(self.dims))()
        build.check(self.lib.wh_vtrace_layout(*self.shape, out),
                    "wh_vtrace_layout")
        return sgd.stage_views(self.work, out, self.dims, self.mb_n,
                               self.mb_n + self.nb)

    def fill(self, inputs: dict) -> None:
        """Writes a stage's input rows (``vtrace_stage_inputs``' names) into
        the workspace, the pad columns zero."""
        sgd.fill_views(self.rows(), inputs)

    def prep(self, p_flat, mb: int) -> None:
        """The prep kernel alone: minibatch ``mb``'s sample and last-obs
        rows and the padded weight copies, which the stages read."""
        self._launch(len(VT_STAGES), p_flat, mb, None, None,
                     "IMPALA learner prep launch")

    def launch_stage(self, stage: str, p_flat, mb: int, grads, sums) -> None:
        """One stage's kernels alone on the rows the workspace holds (after
        ``prep`` and ``fill``)."""
        self._launch(VT_STAGES.index(stage), p_flat, mb, grads, sums,
                     f"IMPALA learner stage {stage} launch")
        vtrace_stage.launches += 1

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
                     mask_actions: bool, bootstrap_truncated: bool,
                     mesh=None):
    """The whole learner phase: ``(params, opt_state, losses)`` with
    ``losses`` the ``(total, pg, v, ent)`` tuple of ``[passes, M]``
    tensors. On CUDA tensors each step is K6's gradient kernels, then K5's
    clip + RMSProp or Adam kernel on the packed params and moments; on CPU
    tensors the plain twin runs. With ``mesh``, the meshed learner (JAX
    ``train/impala.py:518-527``): the trajectory laid out once, each step's
    K6 gradient and loss sums in one buffer averaged over the ranks by one
    ``all_reduce``, the averaged gradient's sums of squares
    (``sgd.grad_sumsq``, the norm the clip reads), then the step.
    ``launches`` counts the optimizer kernel."""
    loss_kw = dict(gamma=gamma, rho_clip=rho_clip, c_clip=c_clip,
                   value_coef=value_coef, mask_actions=mask_actions,
                   bootstrap_truncated=bootstrap_truncated)
    M, n_steps = num_minibatches, num_passes * num_minibatches
    if _device_of(traj).type == "cpu":
        return impala_sgd_phase_reference(
            params, opt_state, traj, last_obs, rows, ent_coef,
            num_passes=num_passes, num_minibatches=M,
            max_grad_norm=max_grad_norm, mesh=mesh, **loss_kw)
    run = _Launch(params, traj, last_obs, ent_coef, M, **loss_kw)
    p_flat = pack(params)
    rms = isinstance(opt_state, RMSState)
    moments = [pack(opt_state.nu)] if rms else [pack(opt_state.mu),
                                                 pack(opt_state.nu)]
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
        run.step(p_flat, moments, grads, rows, s, max_grad_norm)
    losses = _losses(sums.reshape(num_passes, M, 4), run.mb_n, value_coef,
                     ent_coef)
    count = opt_state.count + n_steps
    trees = [unpack(m, params) for m in moments]
    new_opt = RMSState(count, *trees) if rms else AdamState(count, *trees)
    return unpack(p_flat, params), new_opt, losses


impala_sgd_phase.launches = 0


def vtrace_stage(stage: str, params, traj, last_obs, mb_idx: int, ent_coef,
                 inputs: dict, *, num_minibatches: int, gamma: float,
                 rho_clip: float, c_clip: float, value_coef: float,
                 mask_actions: bool, bootstrap_truncated: bool) -> dict:
    """One of the ``VT_STAGES`` of minibatch ``mb_idx``'s gradient on the
    input rows ``inputs`` (``vtrace_stage_inputs``' names, the plain
    stages' shapes), its outputs as ``vtrace_plain_stage`` gives them. The
    stage's kernel on CUDA tensors, its plain version on CPU ones.
    ``launches`` counts the kernel launches."""
    if stage not in VT_STAGES:
        raise ValueError(f"stage must be one of {VT_STAGES}, got {stage!r}")
    loss_kw = dict(gamma=gamma, rho_clip=rho_clip, c_clip=c_clip,
                   value_coef=value_coef, mask_actions=mask_actions,
                   bootstrap_truncated=bootstrap_truncated)
    if _device_of(traj).type == "cpu":
        rows = vtrace_minibatch_rows(traj, last_obs, mb_idx, num_minibatches)
        return vtrace_plain_stage(stage, params, rows, inputs, ent_coef,
                                  **loss_kw)
    run = _Launch(params, traj, last_obs, ent_coef, num_minibatches,
                  **loss_kw)
    run.fill(inputs)
    p_flat = pack(params)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=p_flat.device)
    run.prep(p_flat, mb_idx)
    run.launch_stage(stage, p_flat, mb_idx, grads, sums)
    if stage == "wgrad":
        return {k: v.clone() for k, v in unpack(grads, params).items()}
    views = run.rows()
    L = len(run.dims) - 1
    names = {"fwd": [f"act{i}" for i in range(L)], "head": ["out"],
             "trace": ["dout"], "dgrad": [f"dz{i}" for i in range(L)]}[stage]
    out = {k: views[k].clone() for k in names}
    if stage == "trace":
        out["losses"] = _losses(sums, run.mb_n, value_coef, ent_coef)
    return out


vtrace_stage.launches = 0


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
# The kernels those launches ran, as the C entry point counts them where it
# launches them: all of them (with the prep), then each stage's (the
# trace's with its metric sums, the weight gradients' with their reduce).
impala_minibatch_grads.stage_launches = 0
impala_minibatch_grads.fwd_launches = 0
impala_minibatch_grads.head_launches = 0
impala_minibatch_grads.trace_launches = 0
impala_minibatch_grads.dgrad_launches = 0
impala_minibatch_grads.wgrad_launches = 0

"""Train CLI: ``python -m warehouse_tpu_torch.train``.

The PPO (``--arch mlp|cnn|attn|gru|lstm``) and IMPALA (``--algo impala``,
a feed-forward arch) subset of ``python -m warehouse_tpu.train`` with the
same flag names, plus
``--device``: the run is on the card unless ``--cpu`` / ``--device cpu``
asks for the CPU, and exits when it finds no card. Metrics go to a JSONL
file (and, with ``--tensorboard-dir``, to TensorBoard event files) whose
first line records the
trainer's ``backends`` (each phase's route: ``"cuda"``, ``"plain"``, or
``"step"`` for the per-step acting phase, as the JAX CLI records its
resolved backends), ``env_steps_per_sec`` included;
``--eval-every`` runs the argmax policy through
``evaluate.evaluate_policy``. ``--checkpoint-every N`` saves the whole
runner state every N updates under ``--checkpoint-dir`` beside a
``policy_meta.json`` that makes the directory self-describing, and
``--resume`` continues from the latest checkpoint there, bit for bit.
``--profile-dir D`` writes a ``torch.profiler`` trace of the second
logged chunk of updates (``--log-every`` of them) into D, as the JAX CLI
traces its second chunk.

Several ranks, one per card (``torchrun --nproc_per_node=N -m
warehouse_tpu_torch.train ...``, or the JAX coordination variables), train
on a data mesh as the JAX CLI does over its devices (``warehouse_tpu/train/
__main__.py:143-191``): the process group forms before anything touches the
card, each rank steps ``--num-envs / N`` envs, and the gradient is averaged
over the ranks once per minibatch (``--single-device``: each rank alone);
``--cpu`` takes a gloo group on a host with cards. Rank 0 alone writes the metrics, the policy meta, the checkpoints (the
whole state, every rank's envs gathered) and the profile, and evaluates;
``--resume`` reads on every rank, each taking its part.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import time

import torch

from ..config import TrainConfig
from ..configs_cli import (add_device_args, add_env_args, device_from_args,
                           env_config_from_args)

from .. import rng
from ..evaluate import evaluate_policy, params_policy_fn
from ..parallel import make_mesh, maybe_initialize_distributed
from ..serve import write_policy_meta
from ..utils.profiling import trace
from .checkpoint import restore_latest, save
from .impala import make_train_impala
from .metrics import MetricsLogger
from .ppo import make_train, unshard_runner_state
from .ppo_rnn import make_train_rnn



def main(argv=None) -> None:
    p = argparse.ArgumentParser("warehouse_tpu_torch.train")
    add_env_args(p)
    add_device_args(p)
    p.add_argument("--algo", choices=["ppo", "impala"], default="ppo",
                   help="impala = the V-trace actor-learner")
    p.add_argument("--rho-clip", type=float, default=1.0,
                   help="V-trace rho-bar importance clip (impala only)")
    p.add_argument("--c-clip", type=float, default=1.0,
                   help="V-trace c-bar trace clip (impala only)")
    p.add_argument("--impala-passes", type=int, default=1,
                   help="replays of each rollout per update (impala only)")
    p.add_argument("--impala-adam", action="store_true",
                   help="Adam instead of IMPALA's canonical RMSProp "
                        "(impala only); RMSProp's eps=0.1 damps this "
                        "env's small gradients")
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--unroll-length", type=int, default=16)
    p.add_argument("--num-updates", type=int, default=200)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--ppo-epochs", type=int, default=4)
    p.add_argument("--num-minibatches", type=int, default=4)
    p.add_argument("--entropy-coef", type=float, default=0.01)
    p.add_argument("--entropy-coef-final", type=float, default=-1.0,
                   help="linear entropy anneal target over num_updates "
                        "(negative = constant --entropy-coef)")
    p.add_argument("--shaping-coef", type=float, default=0.0,
                   help="potential-based reward shaping on the BFS "
                        "distance to the agent's target (0 = off; PPO "
                        "with any arch; IMPALA ignores it, as the JAX "
                        "trainer does)")
    p.add_argument("--mask-actions", action="store_true",
                   help="mask wall/out-of-grid moves at the policy logits")
    p.add_argument("--minibatch-mode", choices=["flat", "env"],
                   default="env")
    p.add_argument("--epoch-shuffle", choices=["each", "once"],
                   default="once")
    p.add_argument("--rllib-cadence", action="store_true",
                   help="--minibatch-mode flat --epoch-shuffle each")
    p.add_argument("--bootstrap-truncated", action="store_true",
                   help="bootstrap value targets through time-limit "
                        "truncations instead of treating them as terminals")
    p.add_argument("--kl-coeff", type=float, default=0.0,
                   help="initial adaptive-KL penalty coefficient (0 = off)")
    p.add_argument("--kl-target", type=float, default=0.01)
    p.add_argument("--hidden-dim", type=int, default=128)
    p.add_argument("--model-dtype", choices=["float32", "bfloat16"],
                   default="float32",
                   help="bfloat16: the learner kernels multiply bf16 "
                        "operands with float32 sums, the last values and "
                        "serving use the bf16 model, acting in a kernel "
                        "stays float32; where a phase has no kernel (IMPALA "
                        "acts per step) it runs the bf16 model")
    p.add_argument("--arch", choices=["mlp", "cnn", "attn", "gru", "lstm"],
                   default="mlp",
                   help="mlp, the conv-torso cnn, the attention torso attn "
                        "or the recurrent gru / lstm policy (gru, lstm: PPO "
                        "only); attn, and IMPALA with cnn, act per step and "
                        "learn in plain PyTorch")
    p.add_argument("--policy-groups", default=None)
    p.add_argument("--rollout-backend", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="the device picks kernel or plain twin; 'xla' is "
                        "refused")
    p.add_argument("--grad-backend", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="the device picks kernel or plain twin; 'xla' is "
                        "refused")
    p.add_argument("--pallas-block", type=int, default=512,
                   help="TPU block size; ignored by the port")
    p.add_argument("--micro-batches", type=int, default=1,
                   help="gradient micro-batches per minibatch (PPO and "
                        "IMPALA: the learner runs plain; the recurrent "
                        "trainer ignores it, as the JAX one does)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save the runner state every N updates (0 = off)")
    p.add_argument("--checkpoint-dir", default="checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint under "
                        "--checkpoint-dir")
    p.add_argument("--metrics-path", default="metrics.jsonl")
    p.add_argument("--tensorboard-dir", default=None,
                   help="also write the logged scalars as TensorBoard "
                        "event files here")
    p.add_argument("--single-device", action="store_true",
                   help="with several ranks (torchrun), no data mesh: "
                        "each rank trains the whole batch alone and rank 0 "
                        "alone writes files")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the second "
                        "--log-every chunk of updates here")
    p.add_argument("--eval-every", type=int, default=0,
                   help="run a greedy-argmax evaluation every N updates "
                        "(0 = off)")
    p.add_argument("--eval-episodes", type=int, default=128)
    args = p.parse_args(argv)
    if args.rllib_cadence:
        args.minibatch_mode = "flat"
        args.epoch_shuffle = "each"
    policy_groups = None
    if args.policy_groups:
        policy_groups = tuple(int(x) for x in args.policy_groups.split(","))
        # The JAX CLI's gates (warehouse_tpu/train/__main__.py:199-210).
        if args.arch in ("gru", "lstm"):
            raise SystemExit("--policy-groups is not supported with "
                             "recurrent archs")
        if args.eval_every:
            raise SystemExit("--eval-every with --policy-groups: the "
                             "evaluation takes a shared policy")

    if args.algo == "impala" and (args.arch in ("gru", "lstm")
                                  or policy_groups is not None):
        raise SystemExit("--algo impala supports feed-forward archs with a "
                         "shared policy")

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    log = logging.getLogger("warehouse_tpu_torch")
    device = device_from_args(args)  # what was asked for; no card touched
    # The group forms before anything touches the card (NCCL makes this
    # rank's card the current one; --cpu takes gloo).
    maybe_initialize_distributed(device=device)
    grouped = torch.distributed.is_initialized()
    mesh = None
    if (grouped and not args.single_device
            and torch.distributed.get_world_size() > 1):
        mesh = make_mesh()
        log.info("mesh: rank %d of %d (%s)", mesh.rank, mesh.world,
                 mesh.backend)
    # The rank that writes files, with a mesh or without one.
    lead = not grouped or torch.distributed.get_rank() == 0
    env_cfg = env_config_from_args(args)
    tcfg = TrainConfig(
        num_envs=args.num_envs, unroll_length=args.unroll_length,
        num_updates=args.num_updates, learning_rate=args.lr,
        ppo_epochs=args.ppo_epochs, num_minibatches=args.num_minibatches,
        entropy_coef=args.entropy_coef,
        entropy_coef_final=args.entropy_coef_final,
        shaping_coef=args.shaping_coef, mask_actions=args.mask_actions,
        minibatch_mode=args.minibatch_mode, epoch_shuffle=args.epoch_shuffle,
        bootstrap_truncated=args.bootstrap_truncated,
        kl_coeff=args.kl_coeff, kl_target=args.kl_target,
        hidden_dim=args.hidden_dim, model_dtype=args.model_dtype,
        rollout_backend=args.rollout_backend,
        grad_backend=args.grad_backend, pallas_block=args.pallas_block,
        micro_batches=args.micro_batches, seed=args.seed,
        checkpoint_every=args.checkpoint_every,
        checkpoint_dir=args.checkpoint_dir,
        metrics_path=args.metrics_path, rho_clip=args.rho_clip,
        c_clip=args.c_clip, impala_passes=args.impala_passes,
        impala_rmsprop=not args.impala_adam)
    recurrent = args.arch in ("gru", "lstm")
    build = (make_train_impala if args.algo == "impala"
             else make_train_rnn if recurrent else make_train)
    groups_kw = {} if policy_groups is None else {
        "policy_groups": policy_groups}
    try:
        trainer = build(env_cfg, tcfg, arch=args.arch, device=device,
                        mesh=mesh, **groups_kw)
    except (NotImplementedError, ValueError) as e:
        raise SystemExit(str(e)) from e
    log.info("device: %s  env: %s", device, env_cfg.to_json())
    if args.checkpoint_every and lead:
        # Serving and evaluation rebuild the model from this file alone.
        write_policy_meta(args.checkpoint_dir, env_cfg, tcfg, arch=args.arch,
                          policy_groups=policy_groups)

    key = rng.prng_key(args.seed, device)
    rs = trainer.init_global(key)
    start_update = 0
    if args.resume:
        # A checkpoint holds the whole state; each rank takes its part.
        restored = restore_latest(args.checkpoint_dir,
                                  rs if mesh is None else trainer.init(key))
        if restored is not None:
            start_update, rs = restored
            rs = trainer.shard_runner_state(rs)
            log.info("resumed from update %d", start_update)
    metrics = MetricsLogger(args.metrics_path if lead else None,
                            args.tensorboard_dir if lead else None)
    metrics.log_meta({"algo": args.algo, "arch": args.arch,
                      "backends": trainer.backends, "device": str(device),
                      "kernels": device.type == "cuda",
                      "world": 1 if mesh is None else mesh.world})
    steps_per_update = tcfg.num_envs * tcfg.unroll_length
    t_last = time.time()
    try:
        for u in range(start_update, tcfg.num_updates, args.log_every):
            n = min(args.log_every, tcfg.num_updates - u)
            profiled = (bool(args.profile_dir) and u == args.log_every
                        and lead)
            with (trace(args.profile_dir, device) if profiled
                  else contextlib.nullcontext()):
                rs, ms = trainer.train_many(rs, n)
                if profiled and device.type == "cuda":
                    torch.cuda.synchronize(device)
            if profiled:
                log.info("profiler trace written to %s", args.profile_dir)
            scalars = {k: float(v[-1]) for k, v in ms.items()}
            dt = time.time() - t_last
            t_last = time.time()
            scalars["env_steps_per_sec"] = steps_per_update * n / dt
            metrics.log(u + n, scalars)
            if args.checkpoint_every and (
                    (u + n) % args.checkpoint_every == 0):
                whole = unshard_runner_state(rs, mesh)  # every rank calls
                if lead:
                    log.info("checkpoint: %s",
                             save(args.checkpoint_dir, u + n, whole))
            if lead and args.eval_every and (u + n) % args.eval_every == 0:
                # The trainer's model, at its compute dtype (the JAX CLI's
                # trainer.model.apply).
                policy_fn, init_carry = params_policy_fn(
                    env_cfg, rs.params, args.arch, dtype=tcfg.model_dtype)
                ev = evaluate_policy(env_cfg, policy_fn, args.eval_episodes,
                                     seed=args.seed + u,
                                     init_carry=init_carry, device=device)
                metrics.log(u + n, {f"eval_{k}": v for k, v in ev.items()
                                    if k != "episodes"})
                t_last = time.time()
    finally:
        metrics.close()
    log.info("done: %d updates, %d env steps", tcfg.num_updates,
             tcfg.num_updates * steps_per_update)


if __name__ == "__main__":
    main()

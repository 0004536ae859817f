#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root, with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``warehouse_tpu_torch/kernels/csrc/`` (the
library, and at once the env kernels K1, K2, K7 and K10 for each
(agents, queue) pair of PAIRS outside the presets, each pair's library
with its build seconds and K1's registers and stack on a line of its own)
and

1. ``k1_check``: holds the draw stream of ``threefry.cuh`` alone (one
   launch writes T = 128 ticks of spawn draws and the final keys) bit-equal
   to ``rng.batched_step_draws`` on all four presets at B = 4096; then the
   greedy-rollout kernel (K1, which makes each env's draws in registers)
   against its plain PyTorch twin (the host draw stream, then the plain
   ticks), bit for bit on every state field, ``key`` and ``t`` included,
   on the medium and shelves configs (B = 4096, T = 128), then at B =
   131072, and times both there;
2. ``k2_check``: holds the act-phase kernel (K2: stage kernels a step
   over all of its rows) against the plain engine
   replaying its actions (obs, rewards, deliveries, final state bit-equal)
   and against the plain MLP (logits, values, log-probs within 1e-4), at
   B = 4096, T = 16, hidden 128 x 2, and times it beside its twin; then
   its action-masking option on the walled shelves config (6 agents): the
   same checks on the masked logits, the returned mask equal to
   ``valid_action_mask`` of the replayed positions, no masked move
   sampled;
3. ``k3_check``: one config-4 trajectory (a K2 chunk from a reset, then
   GAE); the SGD-phase kernel (K3: E = 4 epochs x M = 4 minibatches of
   65536 samples, K4's gradient kernels then clip + Adam per step)
   against its plain twin (autograd + ``optim.py``) on per-step losses,
   params and Adam moments, a second K3 run bit-equal to the first, both
   timed;
4. ``k4_check``: the per-minibatch gradient kernels (K4) against autograd
   on the same trajectory, all 4 minibatches, timed; then
   ``mlp_stage_check``: K4's four stage kernels (forward, head and loss,
   dgrads, weight gradients), each against its plain stage
   (``kernels.sgd``) on the plain chain's rows of minibatch 0, on the
   config-4 trajectory (N = 65536) and on a ragged slice of it (N = 500),
   each stage timed by CUDA events beside its plain stage (also at D =
   611, at hidden 256, with groups and with bf16 operands, in the checks
   below);
5. ``k5_check``: one config-4 IMPALA trajectory (a K2 chunk from the
   trainer's reset, then the boundary reset); the IMPALA learner phase
   (K5: passes x M = 4 minibatches, K6's gradient kernels then clip +
   RMSProp or Adam per step) against its plain twin for passes 1 and 2
   and both optimizers, a second K5 run bit-equal to the first, one pass
   of each optimizer timed (Adam the main path's);
6. ``k6_check``: the per-minibatch V-trace gradient kernels (K6) against
   autograd on the same trajectory, all 4 minibatches, timed; then
   ``vtrace_stage_check``: K6's five stage kernels (forward, head,
   V-trace, dgrads, weight gradients), each against its plain stage
   (``kernels.vtrace_sgd``) on the plain chain's rows of minibatch 0, on
   the config-4 trajectory (N = 65536 samples and 4096 last-obs rows), on
   a ragged slice of it (N = 500, masked, with the truncation bootstrap)
   and at hidden 256, each stage timed by CUDA events beside its plain
   stage;
7. ``k1_episodes`` (main path): 8 greedy episodes through
   ``greedy_rollout`` (K1 alone, its draws on the card) at B = 131072,
   T = max_steps = 128, each from a batched reset, with env-steps/s beside
   one episode of the plain path;
8. ``slice`` (main path): one episode of the acting phase at BASELINE
   config 4 — 8 chunks of K2 with the boundary reset after each — timed
   against the plain path, then ``serve.Policy.compute_actions``;
9. ``train`` (main path): ``train.make_train`` at BASELINE config 4 from
   ``PRNGKey(0)``, the first 50 updates of an 80-update run (its lr
   schedule) through ``train_step`` (K2 + K3/K4), with
   the update time split into acting, GAE and SGD by CUDA events, a
   learning check on deliveries per env-step, 3 updates of the plain path
   from the same state for their time, then the trained policy served;
10. ``impala_train`` (main path): ``train.make_train_impala`` at BASELINE
   config 4 with Adam (``--impala-adam``) on the 300-update schedule of
   the JAX curve ``runs/r4_curves/config4_impala_fused_adam.jsonl``, from
   ``PRNGKey(0)``: its first 220 updates through ``train_step`` (K2 +
   K5/K6) with the acting/learner split by CUDA events, a learning check
   on deliveries per env-step over updates 211-220, 3 plain-path updates
   from the same state, then the trained policy served;
11. ``k7_check``: the recurrent acting kernel (K7: stage kernels a step
   over all of its rows) at B = 4096, T = 16, hidden 128, for the GRU, the
   LSTM and the GRU with action masking on shelves: obs, rewards,
   deliveries and final state bit-equal to the plain engine replaying its
   actions, values, log-probs, logits and the carry within 1e-4 of the
   plain recurrent policy stepped over its observations, timed beside its
   twin; then ``act_rnn_stage_check``: K7's four stage kernels (encoder,
   cell, head, env), each against its plain stage (``kernels.act_rnn``) on
   one step's rows, for the GRU and the LSTM at config 4, the masked GRU
   on shelves and a ragged B = 1001, a chunk's rerun bit-equal, each stage
   timed alone by CUDA events beside its plain stage, its bound and, for
   the cell, ``torch.nn.GRUCell`` / ``LSTMCell`` on the same rows;
12. ``k8_check`` / ``k9_check``: one config-4 recurrent trajectory per
   cell (a chunk of K7's plain twin from the trainer's reset, then GAE;
   ``rnn_inputs`` says why not K7's); the recurrent
   SGD phase (K8: 16 steps of 4096 sequences x 16 steps, K9's gradient
   kernels then clip + Adam per step) against its plain twin (autograd
   through the T-step replay + ``optim.py``) on per-step losses, params
   and Adam moments, a second K8 run bit-equal to the first; K9 against
   autograd on all 4 minibatches; both timed; then ``rnn_stage_check``:
   K9's six stage kernels (encoder forward, recurrence forward, head and
   loss, recurrence backward, encoder backward, weight gradients), each
   against its plain stage (``kernels.sgd_rnn``) on the plain chain's rows
   of minibatch 0, for the GRU and the LSTM, on the config-4 trajectory
   (N = 4096 sequences) and on a ragged slice of it (N = 100 sequences of
   5 steps), each stage timed by CUDA events beside its plain stage;
13. ``rnn_train`` (main path): ``train.make_train_rnn`` at BASELINE config
   4 from ``PRNGKey(0)`` on a 300-update schedule, the first 40 updates,
   for ``gru`` then ``lstm``, through ``train_step`` (K7 + K8/K9) with the
   update split into acting, GAE and SGD by CUDA events, a learning check
   on deliveries per env-step over updates 31-40, 3 plain-path updates
   from the same state, then the trained policy served with its carry;
14. ``k10_check``: the CNN acting kernel (K10: three stage kernels a
   step over all of its rows) at B = 4096, T = 16, convs 4 -> 16 -> 32 on
   the 5x5 window, trunk 806 -> 128, on medium and, with action masking, on
   shelves: the checks of ``k2_check`` against the plain ``ActorCriticCNN``
   (true convolutions), timed beside its twin;
15. ``k11_check`` / ``k12_check``: one config-4 CNN trajectory (a K10 chunk
   from the trainer's reset, then GAE); the CNN SGD phase (K11: 16 steps of
   65536 samples, K12's gradient kernels then clip + Adam per step) against
   its plain twin (autograd through the true convolutions + ``optim.py``)
   on per-step losses, params and Adam moments, a second K11 run bit-equal
   to the first; K12 against autograd on all 4 minibatches; both timed;
   then ``cnn_stage_check``: K12's five stage kernels (conv forward, trunk
   forward + loss, trunk dgrad, conv backward, trunk weight gradients),
   each against its plain stage (``kernels.sgd_cnn``) on the plain chain's
   rows of minibatch 0, on the config-4 trajectory and on a ragged slice of
   it (N = 500), each stage timed by CUDA events beside its plain stage;
16. ``cnn_train`` (main path): ``train.make_train(arch="cnn")`` at BASELINE
   config 4 from ``PRNGKey(0)`` on a 300-update schedule, the first 50
   updates through ``train_step`` (K10 + K11/K12) with the update split
   into acting, GAE and SGD by CUDA events, a learning check on deliveries
   per env-step over updates 41-50, 3 plain-path updates from the same
   state, then the trained policy served; the curve goes to
   ``runs/torch_cnn/metrics.jsonl``;
17. ``t1_check``: the potential-shaping option of K2 and K10
   (``shaping_coef=0.02``, with action masking) on medium and shelves at
   B = 4096, T = 16, on a chunk from a mid-episode state and on one that
   truncates: the checks of ``k2_check``, with the shaped reward bit-equal
   to the formula evaluated by the plain engine and ``ops.pathing.potential``
   on the kernel's actions, the raw reward bit-equal to the engine's, and
   every output bit-equal to the plain twin on the same draws wherever the
   twin samples the same actions; the launch counts show that the kernel
   ran; timed beside its twin and beside the kernel without the option;
18. ``shelves_train`` (main path): the walled-layout recipe as the train CLI
   builds it (``--env shelves --mask-actions --shaping-coef 0.02
   --entropy-coef 0.02 --entropy-coef-final 0.002``, 4096 envs, T = 16, the
   300-update schedule of the JAX run ``runs/shelves3``), its first 100
   updates through ``train_step`` (shaped K2 + K3/K4) with the split by CUDA
   events and a learning check on deliveries per env-step over updates
   91-100; a checkpoint saved at update 50 and at the end; the one of update
   50 restored and run to the end, params bit-equal to the uninterrupted
   run's; then ``evaluate``'s ``greedy``, ``greedy_bfs`` and ``checkpoint``
   policies on 256 shelves episodes (``greedy_bfs`` must beat ``greedy``, the
   checkpoint ``greedy_bfs``); the metrics of every update go to
   ``runs/torch_shelves/metrics.jsonl`` (the same bits on every run);
19. ``shelves_cnn_train`` (main path): 10 updates of the same recipe with
   ``--arch cnn`` (shaped K10 + K11/K12), finite metrics and moved params;
20. ``global_check``: the global-observation option of K2 and K10 and the
   widths it brings, with the checks of ``k2_check`` / ``k3_check`` /
   ``k4_check`` / ``k5_check``: K2 on shelves with the global view (D = 611,
   masked and shaped, B = 2048, the recipe's shapes) and on medium (D =
   411, B = 4096), each counted on K2's stage kernels; K10 on medium (the 9x9
   map as the CNN's grid, 5 channels); K3 / K4 at D = 611 on a trajectory
   of the recipe; K11 / K12 at S = 9 and ``cnn_stage_check`` there (full
   and ragged); and, at config 4 with hidden 256 (the
   ``hidden256_train`` path's shapes): K2 (``hidden256_check``), K3 / K4
   and K5; and ``act_cnn_stage_check``: K10's
   three stage kernels (``conv``: both convolutions; ``trunk``: the trunk
   and the head; ``env``: sample, tick, next observation), each against
   its plain stage (``kernels.act``) on one step's rows, at config 4 (B =
   4096), on a ragged B = 1001, on the 9x9 global view (ungrouped and ``(0,
   1, 0, 1)``) and on the shelves groups recipe (masked, shaped, B = 2048):
   the rows within STAGE_TOL, the env stage's log-probs within TOL and its
   other outputs bit-equal, each stage timed by CUDA events beside its
   plain stage and its bound; and ``act_mlp_stage_check``: K2's three
   stage kernels (``hidden``: the first hidden layer; ``head``: the last
   hidden layer and the head; ``env``, K10's), the same checks at config 4,
   on a ragged B = 1001, at hidden 256, on the shelves global recipe (D =
   611, masked, shaped, B = 2048) and on the shelves groups recipe;
21. ``shelves_global_train`` (main path): the full shelves recipe with
   ``--global-obs`` as the train CLI builds it (2048 envs, T = 16, MLP 611
   -> 128 -> 128 -> 6, the 300-update schedule of the JAX run
   ``runs/r3_curves/shelves_global_fused.jsonl``), its first 100 updates
   through ``train_step`` (global, masked, shaped K2 +
   K3/K4 with the first layer in chunks), a learning check on deliveries per env-step over updates 91-100,
   a checkpoint at 100; ``evaluate``'s ``checkpoint`` policy on 256
   episodes (masked argmax, and sampled) against ``greedy_bfs``, and
   ``serve.Policy.from_checkpoint``; the curve goes to
   ``runs/torch_shelves_global/metrics.jsonl``;
22. ``cnn_global_train`` (main path): 5 config-4 updates of ``--arch cnn
   --global-obs`` (K10 on the 9x9 map + K11/K12), finite metrics, moved
   params, the first update's metrics beside the plain path's;
23. ``hidden256_train`` (main path): 3 config-4 updates at ``--hidden-dim
   256`` (K2, K3/K4), the first update's metrics beside
   the plain path's;
24. ``groups_check``: the policy-groups option of K2 and K3/K4, with the
   checks of ``k2_check`` / ``k3_check`` / ``k4_check`` against the plain
   multi-policy model: K2 at config 4 with the interleaved groups ``(0, 1,
   0, 1)`` and on shelves with ``(0, 0, 0, 1, 1, 1)``, masked and shaped,
   at B = 2048 (the recipe's shapes), each counted as grouped; K3 /
   K4 on a trajectory of that recipe;
25. ``shelves_groups_train`` (main path): the walled recipe with
   ``--policy-groups 0,0,0,1,1,1`` as the train CLI builds it (2048 envs,
   T = 16, two MLPs 106 -> 128 -> 128 -> 6, the 300-update schedule of the
   JAX run ``runs/r5_curves/shelves_groups_fused.jsonl``), the first update
   held against the plain path's, then its first 100 updates through
   ``train_step`` (grouped, masked, shaped K2 + grouped
   K3/K4), a learning check on deliveries per env-step over updates 91-100,
   a checkpoint at 100 whose ``serve.Policy.from_checkpoint`` gives the
   trained model's argmax actions; the curve goes to
   ``runs/torch_shelves_groups/metrics.jsonl``;
26. ``bf16_check``: the learners on bf16 operands (``--model-dtype
   bfloat16``, ``matmul_dtype="bfloat16"``) against their bf16 twins
   (``Bf16Linear`` / ``Bf16Conv``), with the checks of ``k3_check`` /
   ``k4_check`` / ``k8_check`` / ``k9_check``: K3 / K4 at config 4, at D =
   611 (the shelves global recipe) and with the groups ``(0, 0, 0, 1, 1,
   1)``; K8 / K9 for the LSTM and the GRU from a carry of bf16 values; K11 /
   K12 on the 5x5 window and the 9x9 map: every tensor held in norm,
   ||kernel - twin|| <= 2e-4 ||twin|| for a gradient and 3e-3 ||twin|| +
   the f32 atol x sqrt(n) for a phase's params, moments and losses, the
   f32 twin beyond each bound; K3, K8 and K11 reruns bit-equal; K9's and
   K12's stage kernels against the bf16 plain stages (config 4 full and
   ragged, for K12 the 9x9 map too) at 2e-4 in norm;
27. ``gru_bf16_train`` (main path): ``--arch gru --model-dtype bfloat16`` at
   config 4 (the JAX package's recurrent fast config,
   ``runs/r3_curves/config4_gru_fast.jsonl``), the first update held against
   the plain path's, then the first 40 updates of a 300-update run (K7 in
   float32 + K8/K9 on bf16 operands, a bf16 carry), a learning check on
   deliveries per env-step over updates 31-40, the trained policy served
   with its bf16 carry; the curve goes to ``runs/torch_gru_bf16/
   metrics.jsonl``;
28. ``ppo_bf16_train`` / ``cnn_bf16_train`` (main paths): 10 config-4
   updates of the MLP (K2 + K3/K4 on bf16 operands) and of the CNN (K10 +
   K11/K12 on bf16 operands) at ``--model-dtype bfloat16``, the first
   update held against the plain path's, the trained policy served;
29. ``k10_groups_check``: K10 with policy groups (each row through its
   agent's group's convolutions, trunk and head; a step's rows group by
   group, each stage tile one group's) with
   the checks of ``k2_check`` against the plain multi-policy CNN: at config
   4 with ``(0, 1, 0, 1)`` (B = 4096, T = 16) and on shelves with ``(0, 0,
   0, 1, 1, 1)``, masked and shaped, at B = 2048 (the recipe's shapes);
   then one policy per agent at config 4 ``(0, 1, 2, 3)``, two groups on
   the 9x9 global view and one policy per agent on the 8-agent preset
   (masked and shaped), each launched twice on the same inputs, bit-equal;
   each counted on the group route; an ungrouped K10 launch after them
   bit-equal to one before them;
30. ``repro_check``: the plain CNN learner's bits: 5 updates of the
   grouped-CNN shelves recipe twice, params, moments, env state and key
   bit-equal, then a run saved at update 3 and restored to 5 bit-equal to
   the unbroken one (``models.policy.conv_flags``: IEEE float32,
   deterministic cuDNN); the whole script runs under torch's default
   flags;
31. ``shelves_cnn_groups_train`` (main path): the walled recipe with
   ``--arch cnn --policy-groups 0,0,0,1,1,1`` at 2048 envs, its
   ``backends`` ``{"rollout": "cuda", "grad": "plain"}`` (the JAX trainer's
   fused CNN learner is single-policy, so its SGD phase is XLA there and
   plain PyTorch here), the first update held against the plain path's,
   then its first 100 updates of a 300-update run (grouped, masked, shaped
   K10 + the plain learner), a learning check on deliveries per env-step
   over updates 91-100, a checkpoint at 100 served by
   ``Policy.from_checkpoint``; the curve goes to
   ``runs/torch_shelves_cnn_groups/metrics.jsonl``;
32. ``rllib_cadence_train`` (main path): config 4 with ``--rllib-cadence``
   (flat minibatches reshuffled every epoch), the first 50 of 80 updates
   (K2 + the plain flat SGD phase), a learning check over updates 41-50;
33. ``cnn_per_agent_train`` (main path): config 4 with ``--arch cnn
   --policy-groups 0,1,2,3`` (one CNN per agent), as the grouped CNN path
   above: the first update against the plain path's, 50 updates of a
   300-update run, a learning check over updates 41-50, the checkpoint
   served; the curve goes to ``runs/torch_cnn_per_agent/metrics.jsonl``;
34. ``cnn_global_groups_train`` (main path): 3 config-4 updates of ``--arch
   cnn --global-obs --policy-groups 0,1,0,1`` (K10 on the 9x9 map, the
   plain learner), the first update against the plain path's;
35. ``m4_check``: 3 config-4 updates of PPO with ``--micro-batches 2``, PPO
   with the flat optimizer, the GRU with ``--epoch-shuffle each``, IMPALA
   (Adam) with ``--micro-batches 2`` and with the flat optimizer, each
   update held against ``plain_step`` from the same state, the acting
   kernel and the plain learner's split timed, ``backends`` printed;
36. ``per_step_check`` (ROADMAP F-c17), inside ``k3_check`` / ``k5_check``
   / ``k8_check`` at config 4 (K3, K11, K5 Adam, K8 GRU and LSTM, and K8
   at D = 411): each optimizer step of the phase as a one-step phase
   through the kernel from the kernel's own params and moments before it,
   against the twin's step from that same state, at the phase's
   tolerances, beside the whole-phase comparison;
37. the learners' inputs from the per-step acting phase: ``k5_check`` and
   ``k6_check`` on a config-4 IMPALA chunk of 24 steps with a truncation
   inside it in every env (``impala_inputs(ragged=True)``), ``k8_check``
   and ``k9_check`` for the GRU on the 9x9 global view (D = 411, a chunk
   of the per-step phase), each with a ``bound`` line; ``step_sync_check``:
   24 config-4 ticks on the same draws through ``engine.step`` and through
   ``step_autoreset_batch`` (its host read of ``truncated.any()``), timed
   in turns;
38. the per-step acting phase's main paths (``train.ppo.step_rollout``,
   where no acting kernel takes the configuration, as the JAX trainers
   then act through their XLA scan; no acting kernel may launch there):
   ``ragged_train`` (config-4 PPO at ``--unroll-length 24``: an episode
   ends inside a chunk; K3 / K4 learn; the first update against the plain
   path's, 50 updates of an 80-update run, a learning check over updates
   41-50), ``impala_ragged_train`` (IMPALA, T = 24, K5 / K6, 5 updates),
   ``rnn_global_train`` (the GRU on the 9x9 global view, D = 411, K8 /
   K9, 5 updates), ``rnn_shelves_train`` (the GRU on shelves, masked,
   shaped, ``--bootstrap-truncated``, K8 / K9, 5 updates),
   ``impala_global_train`` (shelves, D = 611, 2048 envs, masked, K5 / K6,
   5 updates), each with its first update against the plain path's; and
   with both phases plain, ``impala_bf16_train`` (5 updates),
   ``shelves_cnn_global_train`` (the CNN on the 11x11 global map, 2048
   envs, 3), ``attn_train`` (config-4 PPO with the attention torso, 2) and
   ``impala_cnn_train`` (3); each prints its ``backends``, its update's
   split by the trainer's marks, its trained env-steps/s, and serves the
   trained policy;
39. ``acting_split``: one update each of config-4 ``train``,
   ``impala_train`` and ``ragged_train`` after 2 of warm-up, under
   ``utils.profiling.trace``: each piece the trainers annotate (the draw
   streams, the acting kernel's launch, the boundary reset and its host
   read, ``load_state_dict``, the permutation, the per-step phase's policy
   and tick with its host read, the bootstrap and last-value forwards, GAE,
   the learner, the metrics) with its host ms, device ms, ``aten::`` calls
   and kernel launches read from the trace file, the update's host time and
   the share the pieces cover (at least 0.9), and the device work still
   queued when ``train_step`` returns;
40. ``invariants``: ``utils.debug.check_state_invariants`` true on every env
   after a K1 episode at B = 131072 and after a K2 chunk at config 4, false
   on the one env of a copy where two agents stand on one cell;
41. ``dict_api``: the dict-API wrapper of ``registry.make_env(
   "warehouse-medium")`` on the card for one 128-step episode under
   ``greedy_bfs`` (its env-steps/s and ANSI render), then one served by
   ``Policy.compute_actions_dict`` from a checkpoint that 3 config-4 updates
   write; each episode's returns and deliveries equal to
   ``evaluate_policy``'s on the same env key and policy; then the NumPy
   oracle's backend (``backend="oracle"``, M-10) against ``"torch"`` on the
   card over one episode under the oracle's ``greedy_bfs``: observations,
   rewards, dones, infos and renders equal at every step;
42. ``sweep`` (main path): ``train.sweep.run_sweep`` over 2 learning rates x
   2 seeds at 256 envs, T = 16, 10 updates (K2 + K3 / K4), each seed's
   metrics bit-equal to a standalone ``make_train(...).train_many`` from
   its key and to its row; then ``run_asha`` on the same grid with rungs 2,
   4; every row's ``backends`` the kernels';
43. ``pbt`` (main path; no kernel may launch): ``train.pbt.run_pbt`` with 4
   members, perturb interval 3, 2 intervals, 256 envs (plain on the card,
   as the JAX PBT reaches no Pallas kernel); after the exploit every
   replaced member's params and Adam moments bit-equal to its source's, its
   learning rate the source's x 1.2 or / 1.2, or a resample from the space;
44. ``mesh_world1_train`` (main path): a world-1 NCCL group on a file store
   and on it, at config 4 from ``PRNGKey(0)``, 3 meshed updates each of PPO
   (K2 + K4), the CNN (K10 + K12), the GRU (K7 + K9) and IMPALA with Adam
   (K2 + K6): each update's grads-kernel launches and all-reduces equal to
   epochs x minibatches (IMPALA: passes x minibatches), each followed by
   the sums-of-squares kernel on the averaged gradient (``grad_sumsq``),
   its split into acting, the grads kernel, the all-reduce and the clip +
   optimizer step by CUDA events, and the same update through
   ``plain_step`` from the same state: env state bit-equal, metrics within
   STEP_METRIC_TOL, params within the learner's tolerance;
45. ``mesh_two_ranks`` (main path): two spawned processes sharing the card
   in a gloo group (NCCL refuses two ranks on one device), PPO at config 4
   with 2048 envs a rank, 3 updates, ``assert_replicated_in_sync`` on the
   params and Adam state after each; rank 0's metrics, deliveries per
   env-step finite and positive; the ranks' launch counts added to the
   main path's;
   ``mesh_clip_ranks`` (main path; ROADMAP F-10): two such ranks at config
   4 with 1024 envs a rank and ``max_grad_norm = 1e-3``, where every step
   clips: one meshed update each of PPO (K4, K3), the GRU (K9, K8), the
   CNN (K12, K11) and IMPALA with Adam and RMSProp (K6, K5), the ranks
   bit-identical and each within its learner's bound of the plain twins'
   world-2 update (which clip by the averaged gradient's norm), each
   step's averaged norm printed beside each rank's own
   (``tools/torch_mesh_clip.py``, which runs it on a parent commit too).
   Then the wall seconds of items 39-45 and their share of the script's.
46. ``pair_checks``: the env kernels at the pairs outside the presets
   (ROADMAP T-5), each from its pair's library: K1 at (6, 8) on medium (B =
   4096) and at (12, 24) on the 15x15 map (B = 8192, BASELINE config 3's),
   one greedy episode bit-equal to its twin on every state field, then one
   tick a launch for the whole episode with the first 8 envs bit-equal at
   every tick to the port's NumPy oracle (``OracleEnv`` +
   ``oracle.greedy_actions`` on ``TorchDrawSource`` from each env's key:
   state, key, deliveries and reward-sum bits) and the chained ticks equal
   to the one launch, timed beside its twin with its ``k1_int_ops`` bound;
   K2, K7 (GRU) and K10 at (6, 8) and K2 at (12, 24) without groups and with
   one policy per agent, with ``k2_check`` / ``k7_check``'s checks; K3 /
   K4 with that 12-policy map (1024 envs) with ``k3_check`` / ``k4_check``'s;
47. the pairs' main paths: ``pair_ppo_train`` (``python -m
   warehouse_tpu_torch.train --env medium --env-config '{"num_agents":
   6}'``, 3 updates in this process: K2 + K3 / K4, the metrics file's
   backends the kernels'), ``pair_gru_train`` (K7 + K8 / K9) and
   ``pair_cnn_train`` (K10 + K11 / K12) at (6, 8), ``pair_groups_train``
   (one policy per agent at (12, 24), 1024 envs: grouped K2 + K3 / K4),
   each 3 updates with the first against the plain path's, and
   ``pair_evaluate`` (``python -m warehouse_tpu_torch.evaluate --policy
   greedy`` at both pairs, K1's batch there: one K1 launch an episode
   batch, its metrics equal to ``evaluate_greedy``'s);
48. ``shape_checks`` (run with the checks, before the main paths): the
   kernels at the widths and depths they took last (ROADMAP T-6), each
   check as at config 4 with its tolerance there: K7 (GRU, LSTM), K8 / K9
   (GRU and LSTM, float32 and bf16) at hidden and encoder width 50, K7-K9
   at 4 encoder layers (num_layers 5); K10 at trunk width 50 (the ego
   window, the 9x9 global view, groups ``(0, 1, 0, 1)``), K11 / K12 there
   (float32 and bf16; the 9x9 view); K2-K6 at 5 and at 8 hidden layers of
   128, K5 with RMSProp and Adam, K2 and K3 / K4 with the shelves groups,
   K3 at D = 611 and K3 / K4 in bf16 at 5 layers; and the stage kernels of
   K2, K4, K6, K7, K9, K10 and K12 at those shapes. The float32 K3 / K11
   phases at these shapes are held as a whole and step by step from the
   kernel's own state (``per_step_check``); K3 at 8 layers and K11 at
   trunk 50 on the ego window as a whole only where float32 arithmetic
   holds it (the float32 twin within the tolerance of its float64 run),
   and their whole phase equal in bits to its steps chained (F-c17).
   Then each check's wall seconds;
49. T-6's main paths at config 4, 3 updates each, the first against the
   plain path's from the same state: ``gru_h50_train`` and
   ``cnn_h50_train`` (``python -m warehouse_tpu_torch.train --arch gru``
   / ``--arch cnn --hidden-dim 50`` in this process, the metrics file's
   backends the kernels'; then the CLI's trainer, one update against the
   plain path's), ``lstm_h50_train`` (bf16 products: K7, K8 / K9 in
   bf16), ``mlp_deep_train`` and ``mlp_deep8_train`` (PPO at 5 and 8
   hidden layers: K2, K3 / K4), ``impala_deep_train`` and
   ``impala_deep8_train`` (Adam: K2, K5 / K6), ``gru_deep_train`` (4
   encoder layers: K7, K8 / K9) and ``mesh_shapes_train`` (one world-1
   meshed update each of the GRU at hidden 50, K9, and of PPO at 5 layers,
   K4, against the plain twins');
50. ``sumsq_check`` (run with the checks): the sums-of-squares kernel
   (``sgd.grad_sumsq``, ``csrc/mlp_learner.cuh`` ``sumsq_kernel``) after
   each learner's grads kernel on one config-4 minibatch: K3 with and
   without the groups ``(0, 1, 0, 1)``, K5, K11 (conv blocks, then dense),
   K8 (GRU) at hidden 128 and 50 (the net padded to 52), into a buffer and
   into the workspace, bit-equal to ``reduce_kernel``'s sums and to the
   plain version; K3's case timed beside the plain version and
   ``torch.linalg.vector_norm``;
51. the population axis (ROADMAP M-8b), after ``pop_references`` (the
   sweep below and PBT in turn in this process; PBT's rows are item 43's):
   ``pop_sweep_ranks`` (main path): two spawned gloo ranks,
   ``make_pop_mesh(2)`` as ``seed_mesh``: ``run_trial`` and ``run_asha``
   (rungs 2, 4) with 4 seeds at 256 envs, T = 16, a slice's 2 seeds on
   each rank through K2 and K3 / K4, every seed's metrics on every rank
   and the ASHA rows bit-equal to the in-turn sweep's; ``pop_pbt_ranks``
   (main path; no kernel may launch): ``run_pbt`` (4 members, interval 3,
   2 intervals, 256 envs) on two ranks at pop 2, data 1, its rows
   bit-equal to item 43's, then on four ranks at pop 2, data 2: each
   member's params and Adam state in sync on its slice after every
   update, each replaced member equal shard by shard to its source, the
   rows equal on the ranks and every score finite.

Every main path but ``shelves_cnn_groups_train``, ``rllib_cadence_train``,
``cnn_per_agent_train`` and ``cnn_global_groups_train`` (acting kernel,
plain learner), the per-step paths of item 38 (``{"rollout": "step",
...}``) and PBT reports ``backends`` ``{"rollout": "cuda", "grad":
"cuda"}``. The checks (1-6, 11, 12, 14, 15, 17, 20, 24, 26, 29, 30, 35-37,
39-41, 48, 50) run before the main paths.

Each phase prints one JSON line; any failure ends the run with a
non-zero exit. The kernels' launch counts are zeroed just before each
main path and read just after it. The last lines are the kernels' JSON line
(each kernel's launches on the main paths, its error against its twin, its
time beside the twin's and beside its bound: the larger of its inputs and
outputs' bytes over 3.35 TB/s and its float operations over 67 TFLOP/s,
the card's published float32 rates, or for K1 its integer operations:
the ALU-only ones over the INT32 rate (64 lanes an SM, Hopper white paper,
x the SMs x the SM clock that ``nvidia-smi`` reads) or all of them over
twice that (adds also issue on the FMA pipe), whichever is larger
(``k1_int_ops``), or for a bf16 entry over the tensor
cores' 989 TFLOP/s, or for K7's cell stage three times its operations
over their 495 TF32 TFLOP/s, with ``cuda_core_bound_ms`` at 67 TFLOP/s
beside it; ``library_ms`` where one PyTorch call computes the same
function, K7's cell stage's ``torch.nn.GRUCell``, ``grad_sumsq``'s
``torch.linalg.vector_norm``, else null), the card's
name and power limit from ``nvidia-smi``, and the device line.
There is no CPU path: without a CUDA device the script exits non-zero.

``python3 chip_smoke.py --profile-rnn`` (``--profile-cnn``) runs, instead
of all this, a ``torch.profiler`` trace of 3 recurrent updates per cell (3
CNN updates) and prints the device time per update by kernel name;
``--mesh`` runs items 44-45 alone, ``--pairs`` items 46-47, ``--pop``
items 50, 51 and ``mesh_clip_ranks`` (after the build); ``--mesh-cards``,
on a machine with
several cards, runs PPO at config 4 with 4096 envs a rank on a world-1
NCCL group, on one NCCL rank per card, and on one rank per card with one
intra-op thread each, the ranks in sync after every update, and prints
each rank's update split and all-reduce ms and the mesh's env-steps/s
beside world 1's.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from warehouse_tpu_torch import (TrainConfig, large_config, medium_config,
                                 registry, rng, shelves_config, small_config)
from warehouse_tpu_torch import oracle as oracle_mod
from warehouse_tpu_torch.baselines.greedy import greedy_bfs_actions
from warehouse_tpu_torch.env.batch import (observe_batch, reset_batch,
                                           reset_truncated_batch,
                                           step_autoreset_batch, step_batch)
from warehouse_tpu_torch.env import engine
from warehouse_tpu_torch.env.state import STATE_FIELDS
from warehouse_tpu_torch.evaluate import (checkpoint_policy_fn,
                                          evaluate_policy, policy_fn_for)
from warehouse_tpu_torch.kernels import (act, act_rnn, build, rollout, sgd,
                                         sgd_cnn, sgd_rnn, vtrace_sgd)
from warehouse_tpu_torch.models import (ActorCriticCNN, make_model,
                                        make_multi_policy_model)
from warehouse_tpu_torch.models.policy import (apply, apply_rnn, bf16_round,
                                               cnn_dims, group_params,
                                               is_multi, model_precision)
from warehouse_tpu_torch.ops.gae import gae
from warehouse_tpu_torch.ops.move import valid_action_mask
from warehouse_tpu_torch.ops.pathing import potential
from warehouse_tpu_torch.ops.ppo_update import entropy_coef_at, first_argmax
from warehouse_tpu_torch.optim import make_impala_optimizer
from warehouse_tpu_torch.serve import Policy, write_policy_meta
from warehouse_tpu_torch.train import (ImpalaTransition, Transition,
                                       make_train, make_train_impala,
                                       make_train_rnn)
from warehouse_tpu_torch.train import checkpoint, pbt, sweep
from warehouse_tpu_torch.train.ppo import step_rollout
from warehouse_tpu_torch.utils import check_state_invariants, profiling

SEED = 0
TOL = 1e-4  # MLP outputs: f32 sums in another order, tanh/exp/log ulps
CHECK_B = 4096      # envs in the kernel-vs-twin checks
EPISODE_B = 131072  # envs per greedy episode (bench.py:70)
EPISODES = 8        # greedy episodes timed (bench.py:93)
SLICE_B, SLICE_T = 4096, 16  # BASELINE config 4: num_envs, unroll_length
HIDDEN = (128, 2)   # BASELINE config 4: hidden_dim, num_layers
TRAIN_SCHEDULE = 80  # the train phase's run length (its lr schedule)
TRAIN_UPDATES = 50  # updates of it that the train phase runs
LEARN_MIN = 0.15    # mean deliveries/env-step over updates 41-50
IMPALA_SCHEDULE = 300  # the impala_train phase's run length (the JAX curve's)
IMPALA_UPDATES = 220  # updates of it that the impala_train phase runs
IMPALA_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 211-220
RNN_SCHEDULE = 300  # the rnn_train phase's run length (its lr schedule)
RNN_UPDATES = 40    # updates of it that the rnn_train phase runs, per cell
RNN_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 31-40
CNN_SCHEDULE = 300  # the cnn_train phase's run length (the JAX curve's)
CNN_UPDATES = 50    # updates of it that the cnn_train phase runs
CNN_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 41-50
CNN_METRICS_OUT = "runs/torch_cnn/metrics.jsonl"  # cnn_train's curve
SHAPING = (0.02, 0.99)  # the walled recipe's shaping_coef, and gamma
SHELVES_SCHEDULE = 300  # the shelves_train run length (the JAX run's)
SHELVES_UPDATES = 100   # updates of it that the shelves_train phase runs
SHELVES_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 91-100
SHELVES_CNN_UPDATES = 10  # updates of the shelves_cnn_train phase
EVAL_EPISODES = 256     # episodes of each evaluated policy (the CLI's)
METRICS_OUT = "runs/torch_shelves/metrics.jsonl"  # the port's curve
GLOBAL_B = 2048         # envs of the global-obs shelves recipe (the JAX run's)
GLOBAL_UPDATES = 100    # updates of its 300-update schedule that run here
GLOBAL_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 91-100
GLOBAL_METRICS_OUT = "runs/torch_shelves_global/metrics.jsonl"
CNN_GLOBAL_UPDATES = 5  # updates of the cnn_global_train phase
WIDE_HIDDEN = 256       # the hidden256_train path's hidden width
WIDE_UPDATES = 3        # updates of the hidden256_train phase
CONFIG4_GROUPS = (0, 1, 0, 1)  # interleaved groups on config 4's 4 agents
GROUPS = (0, 0, 0, 1, 1, 1)    # the shelves agents' two policy groups
GROUPS_B = 2048         # envs of the groups recipe (the JAX record's size)
GROUPS_UPDATES = 100    # updates of its 300-update schedule that run here
GROUPS_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 91-100
GROUPS_METRICS_OUT = "runs/torch_shelves_groups/metrics.jsonl"
CNN_GROUPS_UPDATES = 100  # updates of the shelves_cnn_groups_train phase
CNN_GROUPS_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 91-100
CNN_GROUPS_METRICS_OUT = "runs/torch_shelves_cnn_groups/metrics.jsonl"
RLLIB_LEARN_MIN = 0.15  # rllib_cadence_train: over updates 41-50
PER_AGENT = (0, 1, 2, 3)  # one CNN per config-4 agent (RLlib's per-agent map)
CNN_PER_AGENT_UPDATES = 50  # of its 300-update schedule (cnn_train's depth)
CNN_PER_AGENT_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 41-50
CNN_PER_AGENT_METRICS_OUT = "runs/torch_cnn_per_agent/metrics.jsonl"
CNN_GLOBAL_GROUPS_UPDATES = 3  # updates of the cnn_global_groups_train path
REPRO_UPDATES, REPRO_SAVE = 5, 3  # repro_check: run length, checkpoint
M4_UPDATES = 3          # m4_check: updates per case
KERNELS = {"rollout": "cuda", "grad": "cuda"}  # a path's routes: kernels
PLAIN_GRAD = {"rollout": "cuda", "grad": "plain"}  # acting kernel, plain SGD
# Per-step acting (train.ppo.step_rollout) with a learner kernel, or plain.
STEP_KERNEL = {"rollout": "step", "grad": "cuda"}
STEP_PLAIN = {"rollout": "step", "grad": "plain"}
RAGGED_UNROLL = 24      # config 4's 128 steps: 128 % 24 = 8, episodes end
#                         inside a chunk (ragged_train, impala_ragged_train)
RAGGED_UPDATES = 50     # ragged_train: updates of its 80-update schedule
RAGGED_LEARN_MIN = 0.15  # mean deliveries/env-step over updates 41-50
STEP_UPDATES = {"impala_ragged_train": 5, "rnn_global_train": 5,
                "rnn_shelves_train": 5, "impala_global_train": 5,
                "impala_bf16_train": 5, "shelves_cnn_global_train": 3,
                "attn_train": 2, "impala_cnn_train": 3}
# A kernel update's metrics against the plain path's from the same state
# (tests/test_torch_train.py's bound on the JAX trainer's metrics).
STEP_METRIC_TOL = (1e-3, 5e-5)
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory (published)
PEAK_F32_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
PEAK_BF16_PER_S = 989e12    # H100 SXM bf16 x bf16 -> f32, tensor cores, dense
PEAK_TF32_PER_S = 495e12    # H100 SXM tf32 x tf32 -> f32, tensor cores, dense
INT32_LANES_PER_SM = 64     # Hopper SM: INT32 results a clock (white paper)
SLEEP_CYCLES = 1_000_000    # timed_after's hold: ~0.5 ms at the H100's clock
# K3/K4 against the plain twin at config 4: (rtol, atol) per quantity.
# The JAX suite's bounds (tests/test_grad_kernel.py:151-166, 185-190,
# set at 16 samples per minibatch); both sides sum 65536 samples per step
# in f32, in another order.
SGD_TOL = {"losses": (1e-5, 2e-6), "params": (1e-5, 1e-6),
           "mu": (1e-5, 1e-7), "nu": (1e-5, 1e-10), "grads": (1e-4, 1e-7)}
# K5/K6 against the plain twin at config 4: the JAX suite's bounds
# (tests/test_impala_kernel.py:159-177, 198-203).
VT_TOL = {"losses": (1e-5, 2e-6), "params": (1e-5, 1e-6),
          "mu": (1e-5, 1e-7), "nu": (1e-5, 1e-10), "grads": (1e-4, 1e-6),
          "mb_losses": (0.0, 1e-6)}
# K9's gradients and losses against autograd: the JAX suite's bounds
# (tests/test_sgd_rnn_kernel.py:237-244).
RNN_GRAD_TOL = (1e-4, 1e-6)
RNN_MB_LOSS_TOL = (0.0, 1e-6)
# K11/K12 against the plain twin at config 4: the JAX suite's bounds
# (tests/test_sgd_cnn_kernel.py:154-159, 188-203), set at 16 samples per
# minibatch.
CNN_TOL = {"losses": (1e-5, 2e-6), "params": (1e-5, 1e-6),
           "mu": (1e-5, 1e-7), "nu": (1e-5, 1e-10), "grads": (1e-4, 1e-6),
           "mb_losses": (0.0, 1e-6)}
# bf16 operands (matmul_dtype="bfloat16"): a learner kernel against its bf16
# twin. Where a float32 value is one ulp off between the two (another
# summation order, another expf) it can round to the neighbouring bf16
# operand, which moves that product by up to 2^-8, and Adam carries such a
# change into every later step: the f32 bounds above do not hold
# elementwise. Each tensor is held in norm instead, ||kernel - twin|| <=
# rel ||twin|| + atol sqrt(n) (``norm_ratio`` at most 1): a minibatch's
# gradient at BF16_GRAD_REL with atol 0, a phase's params, moments and
# losses at BF16_PHASE_REL with the f32 table's atol (a bias that Adam moves
# from zero has a small norm). Measured on the H100 at config 4, D = 611,
# groups and S = 9: gradients at most 2.2e-5 apart in relative norm, the
# f32 twin 4.3e-3 to 0.038 away; phases at most 0.28 of their bound, the
# f32 twin 3.4 to 56 times it. The f32 twin, which rounds nothing, must lie
# beyond both bounds (``f32_twin_ratio``), so that each bound tells a
# kernel that skips the rounding of an operand from one that does not.
BF16 = "bfloat16"
BF16_GRAD_REL, BF16_PHASE_REL = 2e-4, 3e-3
# K12's and K9's stage kernels against their plain stages
# (cnn_stage_check, rnn_stage_check): every float32 output at CNN_TOL's
# gradient bound (the JAX suite's, rtol 1e-4 / atol 1e-6, RNN_GRAD_TOL's
# too): the stages sum in float32 in another order. A ragged trajectory:
# the first RAGGED_T steps of RAGGED_B envs (N = 500 samples per minibatch
# at 4 agents, which no conv or trunk tile divides; 100 sequences, which no
# recurrent tile of 32 divides).
STAGE_TOL = CNN_TOL["grads"]
RAGGED_T, RAGGED_B = 5, 100
CNN_STAGE_INPUTS = {"conv_fwd": (), "trunk_fwd": ("a1",),
                    "trunk_dgrad": ("dzt", "a1"), "conv_bwd": ("a0", "d1"),
                    "trunk_wgrad": ("a1", "dzt", "h", "dout")}
# K10's stage kernels (act_cnn_stage_check) on a ragged B: 4004 rows at 4
# agents, which no stage's tile divides.
ACT_RAGGED_B = 1001
BF16_FF_UPDATES = 10  # updates of the ppo_bf16_train and cnn_bf16_train paths
BF16_METRICS_OUT = "runs/torch_gru_bf16/metrics.jsonl"


def nvidia_smi() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    out = res.stdout.strip()
    return out.splitlines()[0] if out else (
        f"nvidia-smi failed: {res.stderr.strip()}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


class Timer:
    """CUDA-event timer over a region of device work, in milliseconds."""

    def __enter__(self):
        self.start = torch.cuda.Event(enable_timing=True)
        self.end = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        self.end.synchronize()
        self.ms = self.start.elapsed_time(self.end)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def timed(fn, n):
    """Median milliseconds of n runs of ``fn``."""
    times = []
    for _ in range(n):
        with Timer() as tm:
            fn()
        times.append(tm.ms)
    return median(times)


def timed_after(setup, fn, n):
    """Median milliseconds of n runs of ``fn``, each after an untimed
    ``setup`` (the inputs that ``fn`` overwrites, refilled). A sleep on the
    stream after ``setup`` holds the card while the host queues ``fn``, so
    its host time stays out of the reading."""
    times = []
    for _ in range(n):
        setup()
        torch.cuda._sleep(SLEEP_CYCLES)
        with Timer() as tm:
            fn()
        times.append(tm.ms)
    return median(times)


def state_equal(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in STATE_FIELDS)


def bits_equal(x, y) -> bool:
    return torch.equal(x.view(torch.int32), y.view(torch.int32))


def max_abs_diff(a, b) -> float:
    return max(float((getattr(a, f).double() - getattr(b, f).double())
                     .abs().max()) for f in STATE_FIELDS)


def nbytes(*xs) -> int:
    """Bytes of the tensors in ``xs`` (dicts, tuples, states and None
    allowed)."""
    total = 0
    for x in xs:
        if x is None:
            continue
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            total += nbytes(*x.values())
        elif hasattr(x, "_fields") or isinstance(x, (tuple, list)):
            total += nbytes(*x)
        else:
            total += nbytes(*(getattr(x, f) for f in STATE_FIELDS))
    return total


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    """The SM clock that ``nvidia-smi`` reads (``clocks.max.sm``, the
    boost clock)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    return float(res.stdout.split()[0]) * 1e6


def bound(n_bytes: float, flops: float, bf16: bool = False,
          tf32: bool = False, int_ops: dict | None = None) -> dict:
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the operations at the
    card's peak for their operands, whichever is larger: float32's or, with
    ``bf16`` (products of bf16 operands summed in float32), the tensor
    cores' bf16 rate, or, with ``tf32`` (float32 products as 3xTF32: three
    TF32 products each), three times the operations at the tensor cores'
    TF32 rate. A bf16 or tf32 bound also gives ``cuda_core_bound_ms``, the
    same work at the float32 rate of the CUDA cores. ``int_ops`` (K1's env
    work, ``k1_int_ops`` times the env-ticks: ``alu`` and ``total``) adds
    the integer bound, the larger of the ALU-only operations at
    INT32_LANES_PER_SM and all of them at twice that (the SM issues 4
    warp-instructions a clock, and adds also go to the FMA pipe as IMAD),
    times the SMs and ``sm_clock_hz``; the line then also gives
    ``bytes_bound_ms`` and ``int_ops_bound_ms``. Elsewhere integer env work
    is not counted."""
    by_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    by_ops = (3.0 * flops / PEAK_TF32_PER_S if tf32 else flops / (
        PEAK_BF16_PER_S if bf16 else PEAK_F32_PER_S)) * 1e3
    by_int = 0.0
    if int_ops:
        lanes = INT32_LANES_PER_SM * sm_clock_hz() * (
            torch.cuda.get_device_properties(0).multi_processor_count)
        by_int = max(int_ops["alu"] / lanes,
                     int_ops["total"] / (2 * lanes)) * 1e3
    by_ops = max(by_ops, by_int)
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": n_bytes, "flops": flops,
            **({"int_ops": int_ops["total"], "int_alu_ops": int_ops["alu"],
                "bytes_bound_ms": by_bytes, "int_ops_bound_ms": by_int,
                "sm_clock_hz": sm_clock_hz()} if int_ops else {}),
            **({"cuda_core_bound_ms": max(
                by_bytes, flops / PEAK_F32_PER_S * 1e3)}
               if bf16 or tf32 else {})}


def k1_int_ops(A: int, R: int) -> dict:
    """Integer operations that one env-tick of K1's function needs, counted
    by hand as Hopper instructions, each doing as much as one can: ISETP (a
    compare, ANDed into one predicate it takes), PLOP3 (any logic of three
    predicates), SEL (a select), LOP3 (any logic of three words), SHF (a
    shift or rotate), IABS, IADD3 (a sum of three, one an immediate), IMAD
    (a multiply-add, or its high word). Loads and their addresses, loop
    control, the float work (``bound``'s flops) and the limit of seven
    predicate registers are not counted, so the code needs more. Two
    kinds: ``alu``, which only the INT32 pipe executes, and ``arith``
    (IADD3, IMAD), which ptxas also issues as IMAD on the FMA pipe.

    - draws (``threefry.cuh`` ``spawn_draws``: 14 hashes, 9 distinct keys):
      a hash's 20 rounds of IADD3, SHF and LOP3 (the add also takes the
      previous block's x0 injection), its 5 x1 injections and last x0
      injection (26 arith, 40 alu), x1's start when its counter is not 0
      (5 hashes); a key's parity word (1 alu); the 5 xors of
      ``random_bits``, ``uniform``'s shift and or; each randint's 3 exact
      modulos (IMAD.HI, 2 IADD3, IMAD; 2 SHF) and fold (IMAD): 13 arith,
      6 alu;
    - per agent: its request read once for the tick (target, pickup and
      delivery read the same cells, which change only after delivery;
      the status before pickup): per slot a compare and 5 selects; the
      request and carry tests (2); the target (4 selects); the step
      straight from the deltas (2 arith; 4 compares, 4 selects, the
      moving flag; 2 arith for the cell); rule 1's two unsigned bounds,
      the wall index (1 arith) and the wall test (3);
    - movement: rule 2, 3 a pair and 1 an agent; every ordered pair's
      "candidate of i on the cell of j" (2 compares), which rules 3 and 4
      share; rule 3, 3 a pair and 1 an agent; rule 4, A passes of 1 an
      ordered pair and 1 an agent; the cell, 2 selects, and the collision
      flag, 1 an agent;
    - pickup: 5 an agent, 1 an agent and slot, 1 a slot; delivery: 3 and
      2 an agent, 1 an agent and slot, 6 selects a slot; spawn: the draw's
      compare, 8 a slot (the first-empty flag and its update, 6 selects;
      the cells' rows and columns could come from a table of them, as
      the ids do); assignment: 2 a slot (pending, unclaimed), per agent and
      slot the distance (3 arith, 2 IABS), the compare, 2 selects and the
      claim's 3, per agent 3;
    - the tick's counts: a predicated add an agent for each of 3, and the
      deliveries' sum."""
    pairs, ordered = A * (A - 1) // 2, A * (A - 1)
    draws_alu = 14 * 40 + 9 + 5 + 2 + 2 * 6
    draws_arith = 14 * 26 + 5 + 2 * 13
    agents_alu = A * (6 * R + 2 + 4 + 9 + 3)
    agents_arith = A * (4 + 1)
    movement = (3 * pairs + (A - 1) + 2 * ordered + 3 * pairs + A
                + A * (ordered + A) + 3 * A)
    pickup = 5 * A + A * R + R
    delivery = 3 * A + A * R + 6 * R + 2 * A
    spawn = 1 + 8 * R
    assign_alu, assign_arith = 2 * R + A * R * 8 + 3 * A, A * R * 3
    tick_alu = (agents_alu + movement + pickup + delivery + spawn
                + assign_alu)
    tick_arith = agents_arith + assign_arith + 3 * A + 1
    return {"draws": draws_alu + draws_arith, "tick": tick_alu + tick_arith,
            "alu": draws_alu + tick_alu, "arith": draws_arith + tick_arith,
            "total": draws_alu + tick_alu + draws_arith + tick_arith}


def mlp_macs(params) -> tuple[int, int]:
    """(multiply-adds per sample of the MLP forward, of its backward to the
    layers' inputs: every layer but the first)."""
    ws = [v for k, v in params.items() if k.endswith(".weight")]
    fwd = sum(w.numel() for w in ws)
    return fwd, fwd - params["hidden.0.weight"].numel()


def cnn_macs(params) -> tuple[int, int]:
    """(multiply-adds per sample of the CNN's forward as true convolutions,
    of its backward to the layers' inputs: every layer but the first conv,
    the trunk without its self-feature columns). A 3x3 SAME conv on an
    S x S grid has (3S - 2)^2 valid (position, tap) pairs."""
    S, chans, hidden = cnn_dims(params)
    pairs = (3 * S - 2) ** 2
    convs = [pairs * i * o for i, o in zip(chans, chans[1:])]
    heads = 6 * hidden
    fwd = sum(convs) + params["trunk.weight"].numel() + heads
    return fwd, sum(convs[1:]) + hidden * S * S * chans[-1] + heads


def ff_macs(params) -> tuple[int, int]:
    """``cnn_macs`` or ``mlp_macs``, by the params' keys; of one group's
    sub-model for a multi-policy dict (a sample runs its group's only)."""
    if is_multi(params):
        params = group_params(params, 0)
    return (cnn_macs if "conv.0.weight" in params else mlp_macs)(params)


def rnn_macs(params) -> tuple[int, int]:
    """(multiply-adds per sample of the recurrent policy's forward, of its
    backward to the layers' inputs: every matrix but the first encoder
    layer's)."""
    ws = [v for k, v in params.items() if k.endswith(".weight")]
    fwd = sum(w.numel() for w in ws)
    return fwd, fwd - params["encoder.0.weight"].numel()


def reset_envs(cfg, B, seed, dev):
    """Env b resets from fold_in(PRNGKey(seed), b), as bench.py does."""
    keys = rng.fold_in(rng.prng_key(seed, dev), torch.arange(B, device=dev))
    return reset_batch(cfg, keys)


def k1_check(dev):
    """The draw stream of ``threefry.cuh`` alone bit-equal to
    ``rng.batched_step_draws`` on all four presets; K1 bit-equal to its twin
    (the host draw stream, then the plain ticks) on every state field, with
    deliveries and reward-sum bits, on medium and shelves at B = 4096, then
    at the main path's B = 131072, both timed there; its bound from bytes
    and from integer operations (``k1_int_ops``)."""
    for name, cfg in (("small", small_config()), ("medium", medium_config()),
                      ("large", large_config()),
                      ("shelves", shelves_config())):
        T = cfg.max_steps
        state, _ = reset_envs(cfg, CHECK_B, SEED + 5, dev)
        got = rollout.spawn_draws_check(cfg, state.key, T)
        want = rng.batched_step_draws(state.key, cfg, T)[:4]
        require(all(g.shape == w.shape and bits_equal(g, w)
                    for g, w in zip(got, want)),
                f"K1 draws {name}: threefry.cuh differs from rng.py")
        emit({"phase": "k1_draws_check", "config": name, "B": CHECK_B,
              "T": T, "bit_equal": True})
    B = CHECK_B
    for name, cfg in (("medium", medium_config()),
                      ("shelves", shelves_config())):
        T = cfg.max_steps
        state, _ = reset_envs(cfg, B, SEED, dev)
        ks, kd, kr = rollout.greedy_rollout(cfg, state, T)
        ps, pd, pr = rollout.greedy_rollout_reference(cfg, state, T)
        torch.cuda.synchronize()
        require(state_equal(ks, ps), f"K1 {name}: state differs from twin")
        require(torch.equal(kd, pd), f"K1 {name}: deliveries differ")
        require(bits_equal(kr, pr), f"K1 {name}: reward sums differ")
        emit({"phase": "k1_check", "config": name, "B": B, "T": T,
              "bit_equal": True, "deliveries": int(kd.sum())})

    cfg = medium_config()
    B, T = EPISODE_B, cfg.max_steps
    state, _ = reset_envs(cfg, B, SEED, dev)
    ks, kd, kr = rollout.greedy_rollout(cfg, state, T)
    ps, pd, pr = rollout.greedy_rollout_reference(cfg, state, T)
    err = max(max_abs_diff(ks, ps), float((kd - pd).abs().max()),
              float((kr - pr).abs().max()))
    require(err == 0.0 and bits_equal(kr, pr),
            f"K1 at B={B}: kernel differs from twin")
    k_ms = timed(lambda: rollout.greedy_rollout(cfg, state, T), 5)
    p_ms = timed(lambda: rollout.greedy_rollout_reference(cfg, state, T), 3)
    ops = k1_int_ops(cfg.num_agents, cfg.queue_capacity)
    # 8 float operations per env-step: the reward sum's products and adds.
    bnd = bound(nbytes(state, ks, kd, kr, rollout.map_tables(cfg, dev)),
                8.0 * B * T, int_ops={k: float(ops[k]) * B * T
                                      for k in ("alu", "total")})
    emit({"phase": "k1_check", "config": "medium", "B": B, "T": T,
          "bit_equal": True, "kernel_ms": k_ms, "plain_ms": p_ms,
          "kernel_env_steps_per_s": B * T / (k_ms / 1e3),
          "plain_env_steps_per_s": B * T / (p_ms / 1e3),
          "int_ops_per_env_tick": ops, **bnd})
    return err, k_ms, p_ms, bnd


def cnn_model(cfg, dev, hidden=HIDDEN[0]):
    """A seeded ``ActorCriticCNN`` at config 4's hidden width (or
    ``hidden``)."""
    return make_model(cfg, "cnn", hidden_dim=hidden,
                      generator=torch.Generator().manual_seed(SEED),
                      device=dev)


def shaped_start(cfg, model, state, truncating, dev, groups=None):
    """A start state for the shaping checks: ``state`` after one unshaped
    chunk (mid-episode: agents on their way, requests in transit), with
    the step counter moved so that the next chunk ends with the episode
    when ``truncating``."""
    new, _, _, _ = act.ppo_rollout(
        cfg, model, state, SLICE_T, rng.prng_key(SEED + 11, dev),
        arch="cnn" if act.is_cnn_model(model) else "mlp",
        policy_groups=groups)
    if truncating:
        new = new.replace(t=torch.full_like(new.t, cfg.max_steps - SLICE_T))
    return new, observe_batch(cfg, new)


def k2_stage_bytes(cfg, layers, model, groups, B, T) -> float:
    """Bytes K2's stage kernels move through device memory in a chunk of T
    steps: each step's observation rows (the obs output and the zero-padded
    copy the first layer reads, its width rounded up to 32), each hidden
    stage's input rows read and output rows written, the head stage's
    input rows read and head rows [N, 8] written, the env stage's head rows
    read, its outputs written (action, log-prob, value, reward, logits,
    mask) and the env states read and written; float32 and int32 at 4
    bytes, the mask at 1."""
    A, N = cfg.num_agents, B * cfg.num_agents
    first = act.group_models(model, groups)[0]
    dims = [cfg.obs_dim] + [lin.out_features for lin in first.hidden]
    ld = [-(-d // 32) * 32 for d in dims]
    rows = N * (dims[0] + ld[0])
    rows += sum(N * (ld[i] + ld[i + 1]) for i in range(max(layers - 1, 0)))
    rows += N * (ld[max(layers - 1, 0)] + 8) + N * (8 + 4 + 5)
    states = 2 * B * (4 * A + 6 * cfg.queue_capacity)
    return float(T * (4 * (rows + states) + N * 5))


def k2_check(dev, name, cfg, model, mask_actions=False, shaped=False,
             truncating=False, B=CHECK_B, phase=None, groups=None,
             rerun=False):
    """K2 (or, for a CNN model, K10) against the plain engine replaying
    its actions and the plain model on its observations, then timed beside
    its twin; with ``mask_actions`` also its mask against
    ``valid_action_mask``; with ``shaped`` its potential-shaping option
    from a mid-episode state (``truncating``: the chunk ends with the
    episode): the shaped reward against the formula on the replayed
    states' potentials, the raw reward against the engine's, everything
    against the twin where it samples the same actions, and the launch
    counts: the count of stage kernels must move by the chunk's stage
    launches. With ``cfg.global_obs`` the same checks hold the kernel's
    global view to the plain engine's, and the count of global launches
    must move. With ``groups`` the model is a ``MultiPolicyActorCritic`` held to
    the plain multi-policy model (of MLPs: K2; of CNNs: K10), and the count
    of grouped launches must move. With ``rerun`` a second launch on the
    same inputs must give the same bits."""
    cnn = act.is_cnn_model(model)
    K, steps = ("K10", act.act_cnn_steps) if cnn else ("K2", act.act_steps)
    T, A = SLICE_T, cfg.num_agents
    state, obs0 = reset_envs(cfg, B, SEED + 1, dev)
    if shaped:
        state, obs0 = shaped_start(cfg, model, state, truncating, dev, groups)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, T)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), T,
                                     (5, B * A))
    logits_k = torch.empty(T, B, A, 5, device=dev)
    mask = (torch.empty(T, B, A, 5, dtype=torch.bool, device=dev)
            if mask_actions else None)
    shaping = done = None
    if shaped:
        done = ((state.t[None] + 1 + torch.arange(T, device=dev)[:, None])
                >= cfg.max_steps).to(torch.float32)
        require(bool(done[-1].all()) == truncating and not bool(
            done[:-1].any()), f"{K}: truncation flags of the chunk")
        shaping = act.Shaping(*SHAPING, done, torch.empty(T, B, A, device=dev))
    gkw = {} if groups is None else {"groups": groups}

    def launch_counts():
        return (steps.launches, steps.shaped_launches, steps.global_launches,
                steps.stage_launches, steps.group_launches)

    # The stage kernels of a chunk: K10's conv, trunk and env a step, the
    # prep and the first observation; K2's hidden stages (every hidden layer
    # but the last), head, env (the tick) and observation a step (none after
    # the last tick), the prep (with a hidden layer: a launch for each 8 of
    # its copies, the layers' and the head's, pad_jobs.cuh) and the first
    # observation (env and observation).
    layers = 0 if cnn else len(act.group_models(model, groups)[0].hidden)
    stages = 3 * T + 2 if cnn else (
        (layers > 0) * -(-(layers + 1) // 8) + 1
        + T * (max(layers - 1, 0) + 3))
    counts = launch_counts()
    ks, obs, action, lp, value, reward, delivered = steps(
        cfg, model, state, u, pick, drop, g, logits=logits_k, mask=mask,
        shaping=shaping, **gkw)
    torch.cuda.synchronize()
    require(launch_counts()
            == (counts[0] + 1, counts[1] + int(shaped),
                counts[2] + int(cfg.global_obs), counts[3] + stages,
                counts[4] + int(groups is not None)),
            f"{K}: the launch counts did not show the kernel's launch and "
            f"its route: {counts} -> {launch_counts()}")

    # Dynamics: the plain engine replays the kernel's actions.
    s = state
    require(bits_equal(obs[0], obs0), f"{K}: first obs differs")
    for t in range(T):
        if mask_actions:
            require(torch.equal(mask[t], valid_action_mask(cfg, s.agent_pos)),
                    f"{K}: mask differs from valid_action_mask t={t}")
            require(bool(mask[t].gather(-1, action[t].long()[..., None])
                         .all()), f"{K}: a masked move was sampled t={t}")
        phi_pre = potential(cfg, s) if shaped else None
        s, ts = step_batch(cfg, s, action[t])
        want = ts.reward
        if shaped:  # the formula, one rounded float32 operation at a time
            require(bits_equal(ts.reward, shaping.raw_reward[t]),
                    f"{K}: raw reward t={t}")
            term = rollout.f32(SHAPING[1]) * potential(cfg, s)
            term = term * (1.0 - done[t])[:, None] - phi_pre
            want = ts.reward + rollout.f32(SHAPING[0]) * term
        require(bits_equal(want, reward[t]), f"{K}: reward t={t}")
        require(torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                            delivered[t]), f"{K}: deliveries t={t}")
        if t + 1 < T:
            require(bits_equal(ts.obs, obs[t + 1]), f"{K}: obs t={t + 1}")
    require(state_equal(s.replace(t=state.t, key=state.key), ks),
            f"{K}: final state differs")
    twin_equal = None
    if shaped:
        # The twin on the same draws: bit-equal wherever it samples the
        # kernel's actions (its logits differ from the kernel's by ulps, so
        # a sample on a near-tie may flip and the envs part ways).
        require(not torch.equal(reward, shaping.raw_reward),
                f"{K}: the shaping changed no reward")
        raw_p = torch.empty_like(shaping.raw_reward)
        mask_p = torch.empty_like(mask) if mask_actions else None
        ps, obs_p, action_p, _, _, reward_p, deliv_p = (
            act.act_steps_reference(cfg, model, state, u, pick, drop, g,
                                    mask=mask_p,
                                    shaping=shaping._replace(raw_reward=raw_p),
                                    **gkw))
        twin_equal = torch.equal(action_p, action)
        if twin_equal:
            require(state_equal(ps, ks) and bits_equal(obs_p, obs)
                    and bits_equal(reward_p, reward)
                    and bits_equal(raw_p, shaping.raw_reward)
                    and torch.equal(deliv_p, delivered)
                    and (mask_p is None or torch.equal(mask_p, mask)),
                    f"{K}: shaped kernel differs from its twin")
        require((steps.launches, steps.shaped_launches)
                == (counts[0] + 1, counts[1] + 1),
                f"{K}: the twin's run moved a launch count")

    # Policy head: the plain model on the kernel's observations.
    with torch.no_grad():
        logits, val = (model(obs) if groups is None else
                       model(obs, torch.tensor(groups, device=dev)))
    sampled = torch.where(mask, logits, -1e9) if mask_actions else logits
    lp_plain = torch.log_softmax(sampled, -1).gather(
        -1, action.long()[..., None])[..., 0]
    err = {"logits": float((logits - logits_k).abs().max()),
           "value": float((val - value).abs().max()),
           "log_prob": float((lp_plain - lp).abs().max())}
    z = sampled.reshape(T, B * A, 5).transpose(1, 2) + g      # [T, 5, N]
    top2 = z.topk(2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1]).reshape(T, B, A) > TOL
    agree = bool(((first_argmax(z, 1).reshape(T, B, A) == action)
                  | ~clear).all())
    require(max(err.values()) <= TOL, f"{K}: policy outputs off by {err}")
    require(agree, f"{K}: actions differ where the top-two gap is clear")
    if rerun:
        again = steps(cfg, model, state, u, pick, drop, g,
                      mask=None if mask is None else torch.empty_like(mask),
                      shaping=shaping and shaping._replace(
                          raw_reward=torch.empty_like(shaping.raw_reward)),
                      **gkw)
        require(state_equal(again[0], ks) and all(
            bits_equal(a, b) for a, b in zip(
                again[1:], (obs, action, lp, value, reward, delivered))),
            f"{K}: a second launch on the same inputs gave other bits")

    # The kernel alone and its twin on the same inputs, main-path shapes.
    k_ms = timed(lambda: steps(cfg, model, state, u, pick, drop, g,
                               mask=mask, shaping=shaping, **gkw), 5)
    p_ms = timed(lambda: act.act_steps_reference(
        cfg, model, state, u, pick, drop, g, mask=mask, shaping=shaping,
        **gkw), 3)
    out = {"phase": phase or ("t1_check" if shaped else f"{K.lower()}_check"),
           "kernel": K, "config": name, "global_obs": cfg.global_obs,
           "obs_dim": cfg.obs_dim, "mask_actions": mask_actions,
           "stage_launches": stages, "policy_groups": groups,
           "B": B, "T": T, "max_abs_err": err, "tol": TOL,
           "rerun_bit_equal": True if rerun else None,
           "actions_agree_where_gap_gt_tol": agree,
           "clear_share": float(clear.float().mean()),
           "kernel_ms": k_ms, "plain_ms": p_ms}
    if mask_actions:
        out["masked_share"] = float(1.0 - mask.float().mean())
        # The option's cost: the kernel without it on the same inputs.
        out["unmasked_kernel_ms"] = timed(
            lambda: steps(cfg, model, state, u, pick, drop, g, **gkw), 5)
    n_table = 0
    if shaped:
        out.update({"shaping_coef": SHAPING[0], "gamma": SHAPING[1],
                    "truncating": truncating, "bit_equal": True,
                    "twin_samples_the_same_actions": twin_equal,
                    "shaped_share": float((reward != shaping.raw_reward)
                                          .float().mean()),
                    # The option's cost: the kernel without it.
                    "unshaped_kernel_ms": timed(
                        lambda: steps(cfg, model, state, u, pick, drop, g,
                                      mask=mask, **gkw), 5)})
        n_table = 4 * cfg.num_cells ** 2  # the int32 table, read once
    fwd, _ = ff_macs(dict(model.named_parameters()))
    if not cnn:
        # K2's stage design: its own bytes through device memory beside the
        # float operations (the larger of the two times).
        out["stage_bound"] = bound(
            k2_stage_bytes(cfg, layers, model, groups, B, T),
            2.0 * fwd * T * B * A)
    emit(out)
    # With shaping: the table, the flags and the raw reward beside K2's
    # tensors, and 6 float operations per agent and step. With groups every
    # group's weights are read, and each row runs one group's forward.
    bnd = bound(nbytes(state, ks, u, pick, drop, g, obs, action, lp, value,
                       reward, delivered, mask, shaping and shaping.done,
                       shaping and shaping.raw_reward,
                       dict(model.named_parameters())) + n_table,
                (2.0 * fwd + (6.0 if shaped else 0.0)) * T * B * A)
    return max(err.values()), k_ms, p_ms, bnd


def tol_ratio(a, b, rtol, atol) -> float:
    """max |a - b| / (atol + rtol |b|): at most 1 within tolerance."""
    return float(((a.double() - b.double()).abs()
                  / (atol + rtol * b.double().abs())).max())


def tree_err(a, b, rtol, atol):
    """(max abs error, max tolerance ratio) over a dict or tuple."""
    pairs = ([(a[k], b[k]) for k in b] if isinstance(b, dict)
             else zip(a, b))
    errs = [(float((x.double() - y.double()).abs().max()),
             tol_ratio(x, y, rtol, atol)) for x, y in pairs]
    return max(e for e, _ in errs), max(r for _, r in errs)


def norm_ratio(a, b, rel, atol=0.0, stack=False) -> float:
    """The largest ||a - b|| / (rel ||b|| + atol sqrt(n)) over a dict's or a
    tuple's tensors: at most 1 within the bf16 bound. With ``stack`` the
    tuple's tensors count as one (the loss terms, whose KL term is near
    zero on a first epoch)."""
    if stack:
        a, b = (torch.stack(tuple(a)),), (torch.stack(tuple(b)),)
    pairs = ([(a[k], b[k]) for k in b] if isinstance(b, dict)
             else zip(a, b))
    return max(float((x.double() - y.double()).norm()
                     / (rel * y.double().norm()
                        + atol * y.numel() ** 0.5).clamp_min(1e-30))
               for x, y in pairs)


def phase_norm_ratios(a, b, tol) -> dict:
    """{quantity: ``norm_ratio``} of a phase's ``(params, optimizer state,
    losses)`` ``a`` against ``b`` at BF16_PHASE_REL with ``tol``'s atol."""
    (pa, oa, la), (pb, ob, lb) = a, b
    pairs = {"losses": (la, lb), "params": (pa, pb), "mu": (oa.mu, ob.mu),
             "nu": (oa.nu, ob.nu)}
    return {k: norm_ratio(*v, BF16_PHASE_REL, tol[k][1], stack=k == "losses")
            for k, v in pairs.items()}


def f32_twin_ratio(ref, args, kw, want, tol=None) -> float:
    """How far the f32 twin (``ref`` without ``matmul_dtype``) lies from the
    bf16 twin's result ``want``, in units of the bf16 bound: with ``tol``,
    a phase's largest ``phase_norm_ratios``; without, a minibatch's
    gradient at BF16_GRAD_REL. The check requires it above 1."""
    got = ref(*args, **{k: v for k, v in kw.items() if k != "matmul_dtype"})
    if tol is not None:
        return max(phase_norm_ratios(got, want, tol).values())
    return norm_ratio(got[1], want[1], BF16_GRAD_REL)


def emit_bound(kernel, config, res):
    """Prints a check's kernel and plain times beside its bound (the
    instances that the kernels line does not carry); returns ``res``, the
    check's ``(max_abs_err, ms, plain_ms, bound)``."""
    _, k_ms, p_ms, bnd = res
    emit({"phase": "bound", "kernel": kernel, "config": config, "ms": k_ms,
          "plain_ms": p_ms, **bnd})
    return res


def within(err, ratios) -> bool:
    """``err`` ({key: (max abs error, max ratio)}) in bounds: every ratio at
    most 1 or, with ``ratios`` (a bf16 check's ``norm_ratio``s), every one
    of those at most 1."""
    return all(r <= 1.0 for r in (
        ratios.values() if ratios is not None else (r for _, r in
                                                     err.values())))


def check_line(K, bf16, phase):
    """The JSON line's head: the f32 check's phase, or ``bf16_check`` with
    the kernel named."""
    return ({"phase": "bf16_check", "kernel": K.lower(),
             "matmul_dtype": BF16} if bf16 else {"phase": phase})


def env_cols(x, lo: int, w: int):
    """Env columns ``[lo, lo + w)`` of a ``[T, B, ...]`` tensor, contiguous."""
    return x[:, lo:lo + w].contiguous()


def as_f64(x):
    """``x`` (a tensor, or dicts, tuples and named tuples of them) with its
    floating tensors in float64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: as_f64(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(as_f64, x))
    if isinstance(x, (tuple, list)):
        return type(x)(map(as_f64, x))
    return x


def state_ratio(a, b, tol) -> float:
    """The largest tolerance ratio of a phase's ``(params, optimizer
    state)`` ``a`` against ``b``: params, nu and (Adam) mu."""
    (pa, oa), (pb, ob) = a, b
    pairs = [(pa, pb, "params"), (oa.nu, ob.nu, "nu")]
    if hasattr(oa, "mu"):
        pairs.append((oa.mu, ob.mu, "mu"))
    return max(tree_err(x, y, *tol[k])[1] for x, y, k in pairs)


def per_step_check(K, phase, phase_ref, params, opt, step_args, n, tol,
                   whole=None):
    """Each of a learner phase's ``n`` optimizer steps as a phase of one
    step through the kernel, from the kernel's own params and optimizer
    state before it, against the twin's step from that same state, at
    ``tol`` (ROADMAP F-c17). Both sides of a step start from the same bits,
    so a branch of the loss (the PPO value or ratio clip, V-trace's clips,
    a relu) can part them only where one step's own rounding puts a sample
    on the other side; the whole-phase comparison beside it lets a rounding
    apart after one step choose the branch of every later step.
    ``step_args(params, opt, s) -> (args, kw)`` gives step s's one-step
    phase: minibatch ``s % M``'s env columns, step s's optimizer rows.

    With ``whole``, the kernel's whole phase ``(params, optimizer state)``:
    the chain of one-step launches must give its bits (so each step of the
    phase's own call is one held here), and each step also runs the twin in
    float64 from the kernel's state. Returns the worst ratios and, with
    ``whole``, each step's float32 twin against that float64 twin (how far
    float32 arithmetic itself lies from the step there)."""
    worst, step_f64 = {}, []
    for s in range(n):
        args, kw = step_args(params, opt, s)
        pk, ok, lk = phase(*args, **kw)
        pr, orf, lr_ = phase_ref(*args, **kw)
        pairs = {"losses": (lk, lr_), "params": (pk, pr),
                 "nu": (ok.nu, orf.nu)}
        if hasattr(ok, "mu"):
            pairs["mu"] = (ok.mu, orf.mu)
        for k, v in pairs.items():
            worst[k] = tuple(map(max, worst.get(k, (0.0, 0.0)),
                                 tree_err(*v, *tol[k])))
        if whole is not None:
            step_f64.append(state_ratio(
                (pr, orf), phase_ref(*as_f64(args), **kw)[:2], tol))
        params, opt = pk, ok
    torch.cuda.synchronize()
    chained = None
    if whole is not None:
        wp, wo = whole
        chained = (all(bits_equal(params[k], wp[k]) for k in wp)
                   and all(bits_equal(a[k], b[k])
                           for f in ("mu", "nu") if hasattr(wo, f)
                           for a, b in [(getattr(opt, f), getattr(wo, f))]
                           for k in b))
    emit({"phase": "per_step_check", "kernel": K, "steps": n,
          "max_abs_err": {k: e for k, (e, _) in worst.items()},
          "tol_ratio": {k: r for k, (_, r) in worst.items()},
          "tol": {k: tol[k] for k in worst},
          **({"chain_bit_equal_whole_phase": chained,
              "step_twin32_vs_twin64": step_f64} if whole is not None
             else {})})
    require(all(r <= 1.0 for _, r in worst.values()),
            f"{K}: a step from the kernel's own state differs from the "
            f"twin's step: {worst}")
    require(chained is not False, f"{K}: the whole phase's bits differ "
            "from its steps' chained one by one")
    return worst, step_f64


def sgd_inputs(dev, cfg, arch="mlp", schedule=TRAIN_SCHEDULE, tcfg=None,
               groups=None):
    """One trajectory for the SGD checks, config 4's or ``tcfg``'s: a K2
    (``arch="cnn"``: K10) chunk from the trainer's reset with the
    trainer's options (and its policy ``groups``), then GAE and the
    per-minibatch normalization."""
    tcfg = tcfg or TrainConfig(num_updates=schedule)
    tr = make_train(cfg, tcfg, arch=arch, device=dev, policy_groups=groups)
    rs = tr.init(rng.prng_key(SEED + 5, dev))
    tr.model.load_state_dict(rs.params)
    new, roll, _, _ = act.ppo_rollout(
        cfg, tr.model, rs.env_state, SLICE_T, rng.prng_key(SEED + 6, dev),
        arch=arch, mask_actions=tcfg.mask_actions,
        shaping_coef=tcfg.shaping_coef, gamma=tcfg.gamma,
        policy_groups=groups)
    done = roll.truncated[:, :, None].expand_as(roll.reward)
    traj = Transition(roll.obs, roll.action, roll.log_prob, roll.value,
                      roll.reward, done, roll.mask,
                      torch.zeros_like(roll.value))
    _, last_value = apply(rs.params, observe_batch(cfg, new),
                          None if groups is None
                          else torch.tensor(groups, device=dev))
    adv, targets = gae(roll.reward, roll.value, done, last_value,
                       tcfg.gamma, tcfg.gae_lambda)
    adv_n = sgd.normalize_adv_env_minibatch(adv, tcfg.num_minibatches)
    ent = entropy_coef_at(tcfg, rs.update_idx)
    return tcfg, tr, rs, traj, adv_n, targets, ent


def k3_check(dev, cfg, cnn=False, tcfg=None, name="config4", groups=None,
             bf16=False, per_step=False, phase_gate=True):
    """K3 or, with ``cnn``, K11 against its plain twin, a rerun, timed;
    on config 4's trajectory or one of ``tcfg`` on ``cfg``; with
    ``groups``, K3 on the multi-policy params, its group count moving by a
    launch per step; with ``bf16``, both on bf16 operands; with
    ``per_step``, each step also from the kernel's own state
    (``per_step_check``). Without ``phase_gate`` (K3 at 8 hidden layers,
    K11 at trunk 50 on the ego window) the whole phase is held step by
    step: each step from the kernel's own state at the tolerance, the
    phase's own call equal in bits to those steps chained, and the whole
    phase's distance from the twin may pass the tolerance only where
    float32 arithmetic itself misses it: where the float32 twin lies
    beyond the tolerance from its float64 run, over the phase or in one
    step from the kernel's state (F-c17: one rounding apart can put a
    sample on the other side of a relu or a clip, and Adam carries that
    into every later step)."""
    per_step = per_step or not phase_gate
    K, phase, phase_ref, tol = (
        ("K11", sgd_cnn.ppo_cnn_sgd_phase,
         sgd_cnn.ppo_cnn_sgd_phase_reference, CNN_TOL) if cnn else
        ("K3", sgd.ppo_sgd_phase, sgd.ppo_sgd_phase_reference, SGD_TOL))
    tcfg, tr, rs, traj, adv_n, targets, ent = sgd_inputs(
        dev, cfg, "cnn" if cnn else "mlp",
        CNN_SCHEDULE if cnn else TRAIN_SCHEDULE, tcfg, groups)
    E, M = tcfg.ppo_epochs, tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, E * M, dev)
    args = (rs.params, rs.opt_state, traj, adv_n, targets, *rows, ent,
            rs.kl_coeff)
    kw = dict(num_epochs=E, num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
              mask_actions=tcfg.mask_actions,
              **({} if groups is None else {"policy_groups": groups}),
              **({"matmul_dtype": BF16} if bf16 else {}))
    what = K + (" bf16" if bf16 else "")
    grouped = getattr(phase, "group_launches", 0)
    n_bf16 = phase.bf16_launches
    pk, ok, lk = phase(*args, **kw)
    require(getattr(phase, "group_launches", 0)
            == grouped + (E * M if groups else 0),
            f"{what}: the group count did not show the group route")
    require(phase.bf16_launches == n_bf16 + (E * M if bf16 else 0),
            f"{what}: the bf16 count did not show the bf16 route")
    pr, orf, lr_ = phase_ref(*args, **kw)
    p2, o2, l2 = phase(*args, **kw)
    torch.cuda.synchronize()
    pairs = {"losses": (lk, lr_), "params": (pk, pr), "mu": (ok.mu, orf.mu),
             "nu": (ok.nu, orf.nu)}
    err = {k: tree_err(*v, *tol[k]) for k, v in pairs.items()}
    if bf16:
        ratios = phase_norm_ratios((pk, ok, lk), (pr, orf, lr_), tol)
        f32_ratio = f32_twin_ratio(phase_ref, args, kw, (pr, orf, lr_), tol)
    else:
        ratios = None
    bit_equal = (all(bits_equal(pk[k], p2[k]) and bits_equal(ok.mu[k],
                                                             o2.mu[k])
                     and bits_equal(ok.nu[k], o2.nu[k]) for k in pk)
                 and all(bits_equal(a, b) for a, b in zip(lk, l2)))
    moved = max(float((pk[k] - rs.params[k]).abs().max()) for k in pk)
    if per_step:
        w = traj.obs.shape[1] // M

        def step_args(p, o, s):
            lo = (s % M) * w
            cut = functools.partial(env_cols, lo=lo, w=w)
            return ((p, o, Transition(*map(cut, traj)), cut(adv_n),
                     cut(targets), *(r[s:s + 1] for r in rows), ent,
                     rs.kl_coeff),
                    {**kw, "num_epochs": 1, "num_minibatches": 1})
        _, step_f64 = per_step_check(
            K, phase, phase_ref, rs.params, rs.opt_state, step_args, E * M,
            tol, whole=None if phase_gate else (pk, ok))
    f64 = {}
    if not phase_gate:
        pd, od, _ = phase_ref(*as_f64(args), **kw)
        f64 = {"twin32_vs_twin64": state_ratio((pr, orf), (pd, od), tol),
               "kernel_vs_twin64": state_ratio((pk, ok), (pd, od), tol),
               "step_twin32_vs_twin64_max": max(step_f64)}
    k_ms = timed(lambda: phase(*args, **kw), 5)
    p_ms = timed(lambda: phase_ref(*args, **kw), 3)
    emit({**check_line(K, bf16, f"{K.lower()}_check"), "config": name,
          "obs_dim": cfg.obs_dim, "B": traj.obs.shape[1], "T": SLICE_T,
          "policy_groups": groups, "epochs": E, "minibatches": M,
          "samples_per_minibatch": traj.obs.shape[0] * traj.obs.shape[1]
          * cfg.num_agents // M,
          "max_abs_err": {k: e for k, (e, _) in err.items()},
          "tol_ratio": {k: r for k, (_, r) in err.items()},
          "tol": {k: tol[k] for k in err},
          **({"norm_ratio": ratios, "rel_bound": BF16_PHASE_REL,
              "f32_twin_norm_ratio": f32_ratio} if bf16 else {}),
          "bit_equal_rerun": bit_equal, "max_param_step": moved,
          "whole_phase_gate": phase_gate,
          **({"whole_phase_f64": f64} if f64 else {}), "kernel_ms": k_ms,
          "plain_ms": p_ms})
    f32_misses = bool(f64) and max(f64["twin32_vs_twin64"],
                                   f64["step_twin32_vs_twin64_max"]) > 1.0
    require(within(err, ratios) or f32_misses,
            f"{what} differs from its twin: {err} {ratios} {f64}")
    require(not bf16 or f32_ratio > 1.0,
            f"{what}: the f32 twin lies within the bf16 bound")
    require(bit_equal, f"{what}: a second run gave other bits")
    require(moved > 0.0, f"{what} did not move the params")
    fwd, dx = ff_macs(rs.params)
    n = traj.obs.shape[0] * traj.obs.shape[1] * cfg.num_agents  # per epoch
    bnd = bound(nbytes(traj.obs, traj.action, traj.log_prob, traj.value,
                       adv_n, targets, rows, lk)
                + 2 * nbytes(rs.params, rs.opt_state.mu, rs.opt_state.nu),
                2.0 * (2 * fwd + dx) * n * E, bf16)
    return err["params"][0], k_ms, p_ms, bnd


def k4_check(dev, cfg, cnn=False, tcfg=None, name="config4", groups=None,
             bf16=False):
    """K4 or, with ``cnn``, K12 against autograd on every minibatch (with
    ``groups``: of the multi-policy loss; with ``bf16``: both on bf16
    operands)."""
    K, grads_fn, grads_ref, tol, loss_key = (
        ("K12", sgd_cnn.ppo_cnn_minibatch_grads,
         sgd_cnn.ppo_cnn_minibatch_grads_reference, CNN_TOL, "mb_losses")
        if cnn else
        ("K4", sgd.ppo_minibatch_grads, sgd.ppo_minibatch_grads_reference,
         SGD_TOL, "losses"))
    tcfg, tr, rs, traj, adv_n, targets, ent = sgd_inputs(
        dev, cfg, "cnn" if cnn else "mlp",
        CNN_SCHEDULE if cnn else TRAIN_SCHEDULE, tcfg, groups)
    M = tcfg.num_minibatches
    kw = dict(num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, mask_actions=tcfg.mask_actions,
              **({} if groups is None else {"policy_groups": groups}),
              **({"matmul_dtype": BF16} if bf16 else {}))
    what = K + (" bf16" if bf16 else "")
    worst = {"losses": (0.0, 0.0), "grads": (0.0, 0.0)}
    ratios = {"losses": 0.0, "grads": 0.0} if bf16 else None
    for mb in range(M):
        (lk, auxk), gk = grads_fn(
            rs.params, traj, adv_n, targets, mb, ent, rs.kl_coeff, **kw)
        (lr_, auxr), gr = grads_ref(
            rs.params, traj, adv_n, targets, mb, ent, rs.kl_coeff, **kw)
        torch.cuda.synchronize()
        for key, a, b, t in (("losses", (lk, *auxk), (lr_, *auxr),
                              tol[loss_key]),
                             ("grads", gk, gr, tol["grads"])):
            worst[key] = tuple(map(max, worst[key], tree_err(a, b, *t)))
            if bf16:
                ratios[key] = max(ratios[key], norm_ratio(
                    a, b, BF16_GRAD_REL, t[1] if key == "losses" else 0.0,
                    stack=key == "losses"))
    if bf16:  # the f32 twin beyond the bound, on the last minibatch
        f32_ratio = f32_twin_ratio(grads_ref, (rs.params, traj, adv_n,
                                               targets, M - 1, ent,
                                               rs.kl_coeff), kw, (None, gr))
    args = (rs.params, traj, adv_n, targets, 0, ent, rs.kl_coeff)
    k_ms = timed(lambda: grads_fn(*args, **kw), 5)
    p_ms = timed(lambda: grads_ref(*args, **kw), 3)
    emit({**check_line(K, bf16, f"{K.lower()}_check"), "config": name,
          "obs_dim": cfg.obs_dim, "policy_groups": groups, "minibatches": M,
          "max_abs_err": {k: e for k, (e, _) in worst.items()},
          "tol_ratio": {k: r for k, (_, r) in worst.items()},
          "tol": {"losses": tol[loss_key], "grads": tol["grads"]},
          **({"norm_ratio": ratios, "rel_bound": BF16_GRAD_REL,
              "f32_twin_norm_ratio": f32_ratio} if bf16 else {}),
          "kernel_ms": k_ms, "plain_ms": p_ms})
    require(within(worst, ratios),
            f"{what} differs from autograd: {worst} {ratios}")
    require(not bf16 or f32_ratio > 1.0,
            f"{what}: the f32 twin's gradient lies within the bf16 bound")
    fwd, dx = ff_macs(rs.params)
    bnd = bound(nbytes(traj.obs, traj.action, traj.log_prob, traj.value,
                       adv_n, targets) / M + 2 * nbytes(rs.params),
                2.0 * (2 * fwd + dx) * traj.action.numel() / M, bf16)
    return worst["grads"][0], k_ms, p_ms, bnd


def stage_ratios(got, want, bf16, rel=BF16_GRAD_REL) -> dict:
    """{output: {"max_abs_err", "ratio"}} of a stage kernel's outputs
    ``got`` (``sgd_cnn.cnn_stage``'s or ``sgd_rnn.rnn_stage``'s) against
    the plain stage's ``want``:
    float32 at STAGE_TOL elementwise, with ``bf16`` in norm at ``rel``;
    the loss terms at CNN_TOL's mb_losses. A ratio above 1 fails."""
    res = {}
    for k, w in want.items():
        g, w = ((torch.stack(got[k]), torch.stack(w)) if k == "losses"
                else (got[k], w))
        e, r = tree_err((g,), (w,), *(
            CNN_TOL["mb_losses"] if k == "losses" else STAGE_TOL))
        if bf16 and k != "losses":
            r = norm_ratio((g,), (w,), rel)
        res[k] = {"max_abs_err": e, "ratio": r}
    return res


def cnn_stage_check(dev, cfg, name="config4", bf16=False, ragged=False,
                    hidden=HIDDEN[0]):
    """K12's five stage kernels (``sgd_cnn.STAGES``), each against its plain
    stage on the plain chain's rows of minibatch 0 of a CNN trajectory of
    ``cfg`` (config 4's shapes; with ``ragged`` its first 5 steps of 100
    envs: N = 500, no tile full at the end), then timed on those rows.
    float32 outputs within STAGE_TOL elementwise; with ``bf16`` (against
    the bf16 plain stages) each tensor within BF16_GRAD_REL in norm; the
    loss terms within CNN_TOL's mb_losses. The trunk ``hidden`` wide."""
    tcfg, _, rs, traj, adv_n, targets, ent = sgd_inputs(
        dev, cfg, "cnn", CNN_SCHEDULE,
        TrainConfig(num_updates=CNN_SCHEDULE, hidden_dim=hidden))
    if ragged:
        traj = Transition(*(x[:RAGGED_T, :RAGGED_B] for x in traj))
        adv_n, targets = (x[:RAGGED_T, :RAGGED_B] for x in (adv_n, targets))
    p, kl, M = rs.params, rs.kl_coeff, tcfg.num_minibatches
    loss_kw = dict(clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                   mask_actions=tcfg.mask_actions)
    md = BF16 if bf16 else "float32"
    rows = sgd_cnn.minibatch_rows(traj, adv_n, targets, 0, M)
    chain, want = sgd_cnn.plain_stage_chain(p, rows, ent, kl, bf16=bf16,
                                            **loss_kw)
    run = sgd_cnn.CnnLaunch(p, traj, adv_n, targets, ent, kl, M,
                            tcfg.clip_eps, tcfg.value_coef,
                            tcfg.mask_actions, matmul_dtype=md)
    p_flat = act.pack_cnn(p)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=dev)
    out, bad = {}, []
    for stage in sgd_cnn.STAGES:
        before = sgd_cnn.cnn_stage.launches
        got = sgd_cnn.cnn_stage(stage, p, traj, adv_n, targets, 0, ent, kl,
                                chain, matmul_dtype=md, num_minibatches=M,
                                **loss_kw)
        torch.cuda.synchronize()
        require(sgd_cnn.cnn_stage.launches == before + 1,
                f"cnn stage {stage}: the launch count did not move")
        res = stage_ratios(got, want[stage], bf16)
        bad += [f"{stage}.{k}" for k, v in res.items() if v["ratio"] > 1.0]
        run.fill({k: chain[k] for k in CNN_STAGE_INPUTS[stage]})
        ms = timed(lambda: run.launch_stage(stage, p_flat, 0, grads, sums), 5)
        out[stage] = {"outputs": res, "ms": ms, "plain_ms": timed(
            lambda: sgd_cnn.plain_stage(stage, p, rows, chain, ent, kl,
                                        bf16=bf16, **loss_kw), 3)}
    emit({**check_line("K12", bf16, "cnn_stage_check"), "config": name,
          "hidden_dim": hidden,
          "ragged": ragged, "samples": rows[0].shape[0],
          "small_conv_tiles": run.small_tile,
          "ratio": "norm_ratio at BF16_GRAD_REL" if bf16 else
          "tol_ratio at STAGE_TOL", "stages": out})
    require(not bad, f"K12 stages differ from their plain stages: {bad}")
    return out


def act_cnn_stage_run(dev, cfg, model, groups=None, B=CHECK_B,
                      shaped=False, time_it=True):
    """K10's three stage kernels (``act.ACT_CNN_STAGES``) on one step's
    rows of ``cfg`` (with ``shaped``, masked and shaped from a mid-episode
    state), each against its plain stage on the plain chain's inputs:
    ``conv``'s ``a1`` and ``trunk``'s head rows within STAGE_TOL
    elementwise (float32 sums in another order), the env stage's
    log-probs within TOL and every other output bit-equal (the same head
    rows in: the same samples, ticks, rewards and observations). Returns
    ``(results, failures, times)``: per stage its outputs' max_abs_err
    and ratio, the failing outputs, and (``time_it``) the kernel's and the
    plain stage's milliseconds by CUDA events beside the stage's bound."""
    A = cfg.num_agents
    state, obs = reset_envs(cfg, B, SEED + 1, dev)
    if shaped:
        state, obs = shaped_start(cfg, model, state, False, dev, groups)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, 1)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), 1,
                                     (5, B * A))
    shaping = sh = None
    if shaped:
        done = (state.t + 1 >= cfg.max_steps).to(torch.float32)
        shaping = act.Shaping(*SHAPING, done[None],
                              torch.empty(1, B, A, device=dev))
        sh = (*SHAPING, done)
    order = act.act_cnn_rows(cfg, B, groups)
    row_group = act.act_cnn_row_groups(cfg, order, groups)
    order = order.to(dev)
    params = act.cnn_group_params(model, groups)

    def plain(stage, x):
        with torch.no_grad():
            if stage == "conv":
                return {"a1": act.act_conv_plain(
                    params, x.reshape(B * A, -1)[order], row_group)}
            if stage == "trunk":
                return {"head": act.act_trunk_plain(params, x, row_group)}
            return act.act_env_plain(cfg, state, x, order, u[0], pick[0],
                                     drop[0], g[0], shaped, sh)

    inputs = {"conv": obs}
    want = {"conv": plain("conv", obs)}
    inputs["trunk"] = want["conv"]["a1"]
    want["trunk"] = plain("trunk", inputs["trunk"])
    inputs["env"] = want["trunk"]["head"]
    want["env"] = plain("env", inputs["env"])
    kw = dict(mask_on=shaped, shaping=shaping, groups=groups)
    run = act.ActCnnLaunch(cfg, model, state, u, pick, drop, g,
                           torch.empty(1, B, A, 5, device=dev),
                           torch.empty(1, B, A, 5, dtype=torch.bool,
                                       device=dev) if shaped else None,
                           shaping, groups)
    S, C0, C1, C2, H = run.net
    N, pairs = B * A, (3 * S - 2) ** 2
    flops = {"conv": 2.0 * N * pairs * C1 * (C0 + C2),
             "trunk": 2.0 * N * (S * S * C2 + 6 + 6) * H, "env": 0.0}
    res, bad, times = {}, [], {}
    for stage in act.ACT_CNN_STAGES:
        key = {"conv": "obs", "trunk": "a1", "env": "head"}[stage]
        before = act.act_cnn_stage.launches
        got = act.act_cnn_stage(stage, cfg, model, state,
                                {key: inputs[stage]}, u, pick, drop, g, **kw)
        torch.cuda.synchronize()
        require(act.act_cnn_stage.launches == before + 1,
                f"K10 stage {stage}: the launch count did not move")
        out = {}
        for k, w in want[stage].items():
            x = got[k]
            if k == "state":
                out[k] = {"bit_equal": all(torch.equal(
                    getattr(x, f), getattr(w, f)) for f in STATE_FIELDS[:-2])}
            elif w is None:
                out[k] = {"bit_equal": x is None}
            elif stage != "env" or k == "log_prob":
                e, r = tree_err((x,), (w,), *(STAGE_TOL if stage != "env"
                                             else (0.0, TOL)))
                out[k] = {"max_abs_err": e, "ratio": r}
            else:
                out[k] = {"bit_equal": torch.equal(
                    x.view(torch.int32) if x.dtype == torch.float32 else x,
                    w.view(torch.int32) if w.dtype == torch.float32 else w)}
        bad += [f"{stage}.{k}" for k, v in out.items()
                if v.get("ratio", 0.0) > 1.0 or v.get("bit_equal") is False]
        res[stage] = out
        if time_it:
            nxt = run.fill(stage, {key: inputs[stage]})
            n_bytes = nbytes(inputs[stage], want[stage]) + (
                nbytes(dict(model.named_parameters()))
                if stage != "env" else 0)
            times[stage] = {
                "ms": timed(lambda: run.launch(stage, nxt), 5),
                "plain_ms": timed(lambda: plain(stage, inputs[stage]), 3),
                **bound(n_bytes, flops[stage])}
    return res, bad, times


def act_cnn_stage_check(dev, cfg, name, groups=None, B=CHECK_B,
                        shaped=False, hidden=HIDDEN[0]):
    """``act_cnn_stage_run`` on the seeded config-4 CNN (or multi-policy
    CNN with ``groups``) of ``cfg``: the stage kernels against their plain
    stages on one step's rows, then timed; fails on any output off its
    bound."""
    model = (cnn_model(cfg, dev, hidden) if groups is None
             else cnn_groups_model(cfg, groups, dev, hidden))
    res, bad, times = act_cnn_stage_run(dev, cfg, model, groups, B, shaped)
    emit({"phase": "act_cnn_stage_check", "kernel": "K10", "config": name,
          "hidden_dim": hidden,
          "global_obs": cfg.global_obs, "policy_groups": groups, "B": B,
          "rows": B * cfg.num_agents, "masked_shaped": shaped,
          "tol": {"rows": STAGE_TOL, "log_prob": TOL}, "stages": {
              st: {"outputs": res[st], **times[st]} for st in res}})
    require(not bad, f"K10 stages differ from their plain stages: {bad}")
    return times


def act_mlp_stage_run(dev, cfg, model, groups=None, B=CHECK_B,
                      shaped=False, time_it=True):
    """K2's stage kernels (``act.ACT_MLP_STAGES``: the first hidden layer,
    the last hidden layer with the head, the env stage) on one step's rows
    of ``cfg`` (with ``shaped``, masked and shaped from a mid-episode
    state), each against its plain stage on the plain chain's inputs: the
    hidden and head rows within STAGE_TOL elementwise, the env stage's
    log-probs within TOL and every other output bit-equal. Returns
    ``(results, failures, times)`` as ``act_cnn_stage_run``; a stage's
    time takes in the prep kernel (the layers' padded kernels), as the
    trunk stage's does there."""
    A = cfg.num_agents
    state, obs = reset_envs(cfg, B, SEED + 1, dev)
    if shaped:
        state, obs = shaped_start(cfg, model, state, False, dev, groups)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, 1)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), 1,
                                     (5, B * A))
    shaping = sh = None
    if shaped:
        done = (state.t + 1 >= cfg.max_steps).to(torch.float32)
        shaping = act.Shaping(*SHAPING, done[None],
                              torch.empty(1, B, A, device=dev))
        sh = (*SHAPING, done)
    order = act.act_cnn_rows(cfg, B, groups)
    row_group = act.act_cnn_row_groups(cfg, order, groups)
    order = order.to(dev)
    models = act.group_models(model, groups)
    dims = [models[0].hidden[0].in_features] + [
        lin.out_features for lin in models[0].hidden]
    L = len(dims) - 1
    require(L >= 2, "act_mlp_stage_run takes 2 hidden layers or more")

    def plain(stage, x, layer=0):
        with torch.no_grad():
            if stage == "hidden":
                return {"h": act.act_hidden_plain(models, layer, x,
                                                  row_group)}
            if stage == "head":
                return {"head": act.act_head_plain(models, x, row_group)}
            return act.act_env_plain(cfg, state, x, order, u[0], pick[0],
                                     drop[0], g[0], shaped, sh)

    # Each hidden layer but the last on the plain chain's rows: the first
    # is the "hidden" stage's entry; the deeper ones are checked too.
    x = obs.reshape(B * A, -1)[order]
    layer_in = []
    for layer in range(L - 1):
        layer_in.append(x)
        x = plain("hidden", x, layer)["h"]
    inputs = {"hidden": layer_in[0]}
    want = {"hidden": plain("hidden", inputs["hidden"])}
    inputs["head"] = x
    want["head"] = plain("head", inputs["head"])
    inputs["env"] = want["head"]["head"]
    want["env"] = plain("env", inputs["env"])
    kw = dict(mask_on=shaped, shaping=shaping, groups=groups)
    run = act.ActMlpLaunch(cfg, model, state, u, pick, drop, g,
                           torch.empty(1, B, A, 5, device=dev),
                           torch.empty(1, B, A, 5, dtype=torch.bool,
                                       device=dev) if shaped else None,
                           shaping, groups)
    N = B * A
    flops = {"hidden": 2.0 * N * dims[0] * dims[1],
             "head": 2.0 * N * (dims[L - 1] + 6) * dims[L], "env": 0.0}
    layer = {"hidden": 0, "head": L - 1, "env": L - 1}
    res, bad, times = {}, [], {}
    for deeper in range(1, L - 1):
        got = act.act_mlp_stage("hidden", cfg, model, state,
                                {"x": layer_in[deeper]}, u, pick, drop, g,
                                layer=deeper, **kw)
        torch.cuda.synchronize()
        e, r = tree_err((got["h"],), (layer_in[deeper + 1]
                                      if deeper + 2 < L else x,), *STAGE_TOL)
        res[f"hidden{deeper}"] = {"h": {"max_abs_err": e, "ratio": r}}
        if r > 1.0:
            bad.append(f"hidden{deeper}.h")
    for stage in act.ACT_MLP_STAGES:
        key = "head" if stage == "env" else "x"
        before = act.act_mlp_stage.launches
        got = act.act_mlp_stage(stage, cfg, model, state,
                                {key: inputs[stage]}, u, pick, drop, g, **kw)
        torch.cuda.synchronize()
        require(act.act_mlp_stage.launches == before + 1,
                f"K2 stage {stage}: the launch count did not move")
        out = {}
        for k, w in want[stage].items():
            x = got[k]
            if k == "state":
                out[k] = {"bit_equal": all(torch.equal(
                    getattr(x, f), getattr(w, f)) for f in STATE_FIELDS[:-2])}
            elif w is None:
                out[k] = {"bit_equal": x is None}
            elif stage != "env" or k == "log_prob":
                e, r = tree_err((x,), (w,), *(STAGE_TOL if stage != "env"
                                             else (0.0, TOL)))
                out[k] = {"max_abs_err": e, "ratio": r}
            else:
                out[k] = {"bit_equal": torch.equal(
                    x.view(torch.int32) if x.dtype == torch.float32 else x,
                    w.view(torch.int32) if w.dtype == torch.float32 else w)}
        bad += [f"{stage}.{k}" for k, v in out.items()
                if v.get("ratio", 0.0) > 1.0 or v.get("bit_equal") is False]
        res[stage] = out
        if time_it:
            nxt = run.fill(stage, {key: inputs[stage]}, layer[stage])
            n_bytes = nbytes(inputs[stage], want[stage]) + (
                nbytes(dict(model.named_parameters()))
                if stage != "env" else 0)
            times[stage] = {
                "ms": timed(lambda: run.launch(stage, nxt, layer[stage]), 5),
                "plain_ms": timed(lambda: plain(stage, inputs[stage]), 3),
                "max_abs_err": max([v.get("max_abs_err", 0.0)
                                    for v in out.values()]),
                **bound(n_bytes, flops[stage])}
    return res, bad, times


def act_mlp_stage_check(dev, cfg, name, model, groups=None, B=CHECK_B,
                        shaped=False):
    """``act_mlp_stage_run`` on ``model`` (an MLP, or with ``groups`` a
    multi-policy MLP) of ``cfg``: K2's stage kernels against their plain
    stages on one step's rows, then timed; fails on any output off its
    bound. Returns each stage's ``(max_abs_err, ms, plain_ms, bound)``."""
    res, bad, times = act_mlp_stage_run(dev, cfg, model, groups, B, shaped)
    emit({"phase": "act_mlp_stage_check", "kernel": "K2", "config": name,
          "global_obs": cfg.global_obs, "obs_dim": cfg.obs_dim,
          "policy_groups": groups, "B": B, "rows": B * cfg.num_agents,
          "masked_shaped": shaped,
          "tol": {"rows": STAGE_TOL, "log_prob": TOL}, "stages": {
              st: {"outputs": res[st], **times.get(st, {})} for st in res}})
    require(not bad, f"K2 stages differ from their plain stages: {bad}")
    return {st: (t["max_abs_err"], t["ms"], t["plain_ms"], t)
            for st, t in times.items()}


def mlp_stage_check(dev, cfg, name="config4", bf16=False, ragged=False,
                    tcfg=None, groups=None):
    """K4's four stage kernels (``sgd.STAGES``), each against its plain
    stage on the plain chain's rows of minibatch 0 of an MLP trajectory of
    ``cfg`` (``sgd_inputs``: config 4's N = 65536 samples, or ``tcfg``'s
    shapes and ``groups``; with ``ragged`` its first 5 steps of 100 envs: N
    = 500, no 64-row tile full at the end), then timed on those rows.
    float32 outputs within STAGE_TOL elementwise; with ``bf16`` (against
    the bf16 plain stages) each tensor within BF16_GRAD_REL in norm; the
    loss terms within CNN_TOL's mb_losses."""
    tcfg, _, rs, traj, adv_n, targets, ent = sgd_inputs(dev, cfg, tcfg=tcfg,
                                                        groups=groups)
    if ragged:
        traj = Transition(*(x[:RAGGED_T, :RAGGED_B] for x in traj))
        adv_n, targets = (x[:RAGGED_T, :RAGGED_B] for x in (adv_n, targets))
    p, kl, M = rs.params, rs.kl_coeff, tcfg.num_minibatches
    loss_kw = dict(clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                   mask_actions=tcfg.mask_actions)
    md = BF16 if bf16 else "float32"
    rows, counts = sgd.minibatch_rows(traj, adv_n, targets, 0, M, groups)
    chain, want = sgd.plain_stage_chain(p, rows, counts, ent, kl, bf16=bf16,
                                        **loss_kw)
    run = sgd.MlpLaunch(p, traj, adv_n, targets, ent, kl, M,
                        tcfg.clip_eps, tcfg.value_coef, tcfg.mask_actions,
                        policy_groups=groups, matmul_dtype=md)
    p_flat = sgd.pack(p)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=dev)
    out, bad = {}, []
    for stage in sgd.STAGES:
        inputs = sgd.stage_inputs(stage, p, chain)
        before = sgd.mlp_stage.launches
        got = sgd.mlp_stage(stage, p, traj, adv_n, targets, 0, ent, kl,
                            inputs, num_minibatches=M, policy_groups=groups,
                            matmul_dtype=md, **loss_kw)
        torch.cuda.synchronize()
        require(sgd.mlp_stage.launches == before + 1,
                f"mlp stage {stage}: the launch count did not move")
        res = stage_ratios(got, want[stage], bf16)
        bad += [f"{stage}.{k}" for k, v in res.items() if v["ratio"] > 1.0]
        run.fill(inputs)
        ms = timed(lambda: run.launch_stage(stage, p_flat, 0, grads, sums), 5)
        out[stage] = {"outputs": res, "ms": ms, "plain_ms": timed(
            lambda: sgd.plain_stage(stage, p, rows, counts, inputs, ent, kl,
                                    bf16=bf16, **loss_kw), 3)}
    emit({**check_line("K4", bf16, "mlp_stage_check"), "config": name,
          "ragged": ragged, "samples": rows[0].shape[0],
          "obs_dim": cfg.obs_dim, "hidden": run.dims[1:],
          "policy_groups": groups,
          "ratio": "norm_ratio at BF16_GRAD_REL" if bf16 else
          "tol_ratio at STAGE_TOL", "stages": out})
    require(not bad, f"K4 stages differ from their plain stages: {bad}")
    return out


def impala_inputs(dev, cfg, hidden=HIDDEN[0], ragged=False,
                  layers=HIDDEN[1]):
    """One config-4 IMPALA trajectory: a K2 chunk from the trainer's reset
    and the boundary reset after it (``last_obs``); with ``ragged``, a
    chunk of ``RAGGED_UNROLL`` steps of the per-step phase from the reset
    states moved 1 to 23 steps before their episode's end, so that every
    env truncates inside the chunk (at its own step) and starts anew."""
    tcfg = TrainConfig(num_updates=IMPALA_SCHEDULE, impala_rmsprop=False,
                       hidden_dim=hidden, num_layers=layers)
    tr = make_train_impala(cfg, tcfg, device=dev)
    rs = tr.init(rng.prng_key(SEED + 7, dev))
    tr.model.load_state_dict(rs.params)
    if ragged:
        T = RAGGED_UNROLL
        left = torch.randint(1, T, rs.env_state.t.shape,
                             generator=torch.Generator().manual_seed(SEED))
        state = rs.env_state.replace(
            t=(cfg.max_steps - left).to(rs.env_state.t).to(dev))
        _, roll, last_obs, _, _, _ = step_rollout(
            cfg, tcfg, lambda o, c: (*apply(rs.params, o), None), state,
            observe_batch(cfg, state), T, rng.prng_key(SEED + 8, dev))
    else:
        new, roll, reset_key, _ = act.ppo_rollout(
            cfg, tr.model, rs.env_state, SLICE_T, rng.prng_key(SEED + 8, dev))
        _, last_obs, _ = reset_truncated_batch(cfg, new, reset_key)
    traj = ImpalaTransition(
        roll.obs, roll.action, roll.log_prob, roll.reward,
        roll.truncated[:, :, None].expand_as(roll.reward), roll.mask,
        torch.zeros_like(roll.reward))
    kw = dict(gamma=tcfg.gamma, rho_clip=tcfg.rho_clip, c_clip=tcfg.c_clip,
              value_coef=tcfg.value_coef, mask_actions=False,
              bootstrap_truncated=False)
    return tcfg, rs.params, traj, last_obs, kw


def k5_check(dev, cfg, hidden=HIDDEN[0], ragged=False, layers=HIDDEN[1]):
    """K5 against its twin for passes 1 and 2, RMSProp and Adam; a rerun
    bit-equal; one pass of each optimizer timed (Adam the main path's, with
    a ``bound`` line for RMSProp), and the Adam pass step by step from the
    kernel's own state (``per_step_check``). At another ``hidden`` width,
    or on the ``ragged`` chunk of ``impala_inputs`` (truncations inside
    it), only the main path's case runs; at another number of hidden
    ``layers``, one pass of each optimizer."""
    tcfg, params, traj, last_obs, kw = impala_inputs(dev, cfg, hidden,
                                                     ragged, layers)
    M = tcfg.num_minibatches
    results, worst = [], {k: (0.0, 0.0) for k in ("losses", "params", "mu",
                                                  "nu")}
    times = {}
    full = (hidden, layers) == HIDDEN and not ragged
    both = full or layers != HIDDEN[1]
    for use_rms in ((True, False) if both else (False,)):
        for passes in ((1, 2) if full else (1,)):
            tc = tcfg.replace(impala_rmsprop=use_rms, impala_passes=passes)
            optimizer = make_impala_optimizer(tc)
            opt = optimizer.init(params)
            rows = optimizer.step_rows(opt.count, passes * M, dev)
            args = (params, opt, traj, last_obs, rows, tc.entropy_coef)
            pkw = dict(num_passes=passes, num_minibatches=M,
                       max_grad_norm=tc.max_grad_norm, **kw)
            pk, ok, lk = vtrace_sgd.impala_sgd_phase(*args, **pkw)
            pr, orf, lr_ = vtrace_sgd.impala_sgd_phase_reference(*args, **pkw)
            p2, o2, l2 = vtrace_sgd.impala_sgd_phase(*args, **pkw)
            torch.cuda.synchronize()
            err = {"losses": tree_err(lk, lr_, *VT_TOL["losses"]),
                   "params": tree_err(pk, pr, *VT_TOL["params"]),
                   "nu": tree_err(ok.nu, orf.nu, *VT_TOL["nu"])}
            if not use_rms:
                err["mu"] = tree_err(ok.mu, orf.mu, *VT_TOL["mu"])
            for k, e in err.items():
                worst[k] = tuple(map(max, worst[k], e))
            bit_equal = (all(bits_equal(pk[k], p2[k])
                             and bits_equal(ok.nu[k], o2.nu[k]) for k in pk)
                         and all(bits_equal(a, b) for a, b in zip(lk, l2)))
            moved = max(float((pk[k] - params[k]).abs().max()) for k in pk)
            results.append({"optimizer": "rmsprop" if use_rms else "adam",
                            "passes": passes,
                            "tol_ratio": {k: r for k, (_, r) in err.items()},
                            "bit_equal_rerun": bit_equal,
                            "max_param_step": moved})
            require(all(r <= 1.0 for _, r in err.values()),
                    f"K5 ({results[-1]['optimizer']}, {passes} passes) "
                    f"differs from its twin: {err}")
            require(bit_equal, "K5: a second run gave other bits")
            require(moved > 0.0, "K5 did not move the params")
            if passes == 1:
                times[results[-1]["optimizer"]] = (
                    timed(lambda: vtrace_sgd.impala_sgd_phase(*args, **pkw),
                          5),
                    timed(lambda: vtrace_sgd.impala_sgd_phase_reference(
                        *args, **pkw), 3))
            if passes == 1 and not use_rms and (hidden, layers) == HIDDEN:
                w = traj.obs.shape[1] // M

                def step_args(p, o, s, rows=rows, pkw=pkw, tc=tc):
                    lo = (s % M) * w
                    cut = functools.partial(env_cols, lo=lo, w=w)
                    return ((p, o, ImpalaTransition(*map(cut, traj)),
                             last_obs[lo:lo + w].contiguous(),
                             tuple(r[s:s + 1] for r in rows),
                             tc.entropy_coef),
                            {**pkw, "num_minibatches": 1})
                per_step_check("K5 ragged" if ragged else "K5",
                               vtrace_sgd.impala_sgd_phase,
                               vtrace_sgd.impala_sgd_phase_reference,
                               params, opt, step_args, M, VT_TOL)
    done_inside = int(traj.done[:-1, :, 0].sum())
    emit({"phase": "k5_check", "hidden": hidden, "num_layers": layers,
          "B": traj.obs.shape[1],
          "T": traj.obs.shape[0], "ragged": ragged,
          "truncations_inside_the_chunk": done_inside,
          "minibatches": M, "samples_per_minibatch":
          traj.obs.shape[0] * traj.obs.shape[1] * cfg.num_agents // M,
          "cases": results,
          "max_abs_err": {k: e for k, (e, _) in worst.items()},
          "tol_ratio": {k: r for k, (_, r) in worst.items()}, "tol": VT_TOL,
          "timed": "1 pass; adam the main path's",
          "kernel_ms": times["adam"][0], "plain_ms": times["adam"][1],
          **({"rmsprop_kernel_ms": times["rmsprop"][0],
              "rmsprop_plain_ms": times["rmsprop"][1]}
             if "rmsprop" in times else {})})
    require(not ragged or done_inside == traj.obs.shape[1],
            "K5: the ragged chunk does not end every episode inside it")
    # The timed cases, 1 pass; the last-obs rows are forward only. RMSProp
    # moves a moment fewer than Adam.
    fwd, dx = mlp_macs(params)
    flops = 2.0 * ((2 * fwd + dx) * traj.action.numel()
                   + fwd * last_obs[..., 0].numel())
    data = nbytes(traj.obs, traj.action, traj.behavior_log_prob, traj.reward,
                  last_obs)
    if "rmsprop" in times:
        emit_bound("K5 rmsprop", "config4",
                   (worst["params"][0], *times["rmsprop"],
                    bound(data + 4 * nbytes(params), flops)))
    return (worst["params"][0], *times["adam"],
            bound(data + 6 * nbytes(params), flops))


def k6_check(dev, cfg, ragged=False, shape=HIDDEN):
    """K6 against autograd on every minibatch, timed; on config 4's chunk or
    the ``ragged`` one of ``impala_inputs``, of a model ``shape``
    (hidden_dim, num_layers) wide and deep."""
    tcfg, params, traj, last_obs, kw = impala_inputs(
        dev, cfg, shape[0], ragged, shape[1])
    M, ent = tcfg.num_minibatches, tcfg.entropy_coef
    worst = {"mb_losses": (0.0, 0.0), "grads": (0.0, 0.0)}
    for mb in range(M):
        (lk, auxk), gk = vtrace_sgd.impala_minibatch_grads(
            params, traj, last_obs, mb, ent, num_minibatches=M, **kw)
        (lr_, auxr), gr = vtrace_sgd.impala_minibatch_grads_reference(
            params, traj, last_obs, mb, ent, num_minibatches=M, **kw)
        torch.cuda.synchronize()
        for name, e in (("mb_losses", tree_err((lk, *auxk), (lr_, *auxr),
                                               *VT_TOL["mb_losses"])),
                        ("grads", tree_err(gk, gr, *VT_TOL["grads"]))):
            worst[name] = tuple(map(max, worst[name], e))
    args = (params, traj, last_obs, 0, ent)
    k_ms = timed(lambda: vtrace_sgd.impala_minibatch_grads(
        *args, num_minibatches=M, **kw), 5)
    p_ms = timed(lambda: vtrace_sgd.impala_minibatch_grads_reference(
        *args, num_minibatches=M, **kw), 3)
    emit({"phase": "k6_check", "hidden_dim": shape[0],
          "num_layers": shape[1], "minibatches": M, "T": traj.obs.shape[0],
          "ragged": ragged,
          "max_abs_err": {k: e for k, (e, _) in worst.items()},
          "tol_ratio": {k: r for k, (_, r) in worst.items()},
          "tol": {k: VT_TOL[k] for k in worst},
          "kernel_ms": k_ms, "plain_ms": p_ms})
    require(all(r <= 1.0 for _, r in worst.values()),
            f"K6 differs from autograd: {worst}")
    fwd, dx = mlp_macs(params)
    bnd = bound(nbytes(traj.obs, traj.action, traj.behavior_log_prob,
                       traj.reward, last_obs) / M + 2 * nbytes(params),
                2.0 * ((2 * fwd + dx) * traj.action.numel()
                       + fwd * last_obs[..., 0].numel()) / M)
    return worst["grads"][0], k_ms, p_ms, bnd


def vtrace_stage_run(dev, params, traj, last_obs, ent, M, kw,
                     time_it=True):
    """K6's five stage kernels (``vtrace_sgd.VT_STAGES``: the forward over
    the samples and the last-obs rows, the head, the V-trace, the dgrads,
    the weight gradients), each against its plain stage on the plain
    chain's rows of minibatch 0 of the IMPALA trajectory ``traj``: every
    output within STAGE_TOL elementwise, the loss terms within CNN_TOL's
    mb_losses; with ``time_it`` each stage's kernels timed alone by CUDA
    events (the prep once before, the stage's input rows refilled before
    each run: the trace writes its deltas over its input) beside its plain
    stage and its bound: the bytes the stage itself reads and writes, at
    their natural widths. Returns ``(results, failures, times)``."""
    rows = vtrace_sgd.vtrace_minibatch_rows(traj, last_obs, 0, M)
    chain, want = vtrace_sgd.vtrace_plain_stage_chain(params, rows, ent, **kw)
    run = vtrace_sgd._Launch(params, traj, last_obs, ent, M, **kw)
    p_flat = sgd.pack(params)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=dev)
    x, *fields = rows
    N, n_all = fields[0].shape[0], x.shape[0]
    L = sgd._n_hidden(params)
    fwd, dx = mlp_macs(params)
    head = params["logits.weight"].numel() + params["value.weight"].numel()
    flops = {"fwd": 2.0 * n_all * (fwd - head), "head": 2.0 * n_all * head,
             "trace": 0.0, "dgrad": 2.0 * N * dx, "wgrad": 2.0 * N * fwd}
    # What each stage reads besides its input rows (the first N of them
    # where it runs on the samples alone) and writes: the trace reads the
    # four fields, the mask and boot values where their options are on.
    hidden_p = {k: v for k, v in params.items() if k.startswith("hidden.")}
    head_p = {k: v for k, v in params.items() if k not in hidden_p}
    used = fields[:4] + [f for f, on in zip(
        fields[4:], (kw["mask_actions"], kw["bootstrap_truncated"])) if on]
    reads = {"fwd": (x, hidden_p), "head": (head_p,), "trace": used,
             "dgrad": ({k: v for k, v in params.items()
                        if k.endswith(".weight") and k != "hidden.0.weight"},),
             "wgrad": (x[:N],)}
    res, bad, times = {}, [], {}
    for stage in vtrace_sgd.VT_STAGES:
        inputs = vtrace_sgd.vtrace_stage_inputs(stage, params, chain)
        before = vtrace_sgd.vtrace_stage.launches
        got = vtrace_sgd.vtrace_stage(stage, params, traj, last_obs, 0, ent,
                                      inputs, num_minibatches=M, **kw)
        torch.cuda.synchronize()
        require(vtrace_sgd.vtrace_stage.launches == before + 1,
                f"vtrace stage {stage}: the launch count did not move")
        res[stage] = stage_ratios(got, want[stage], False)
        bad += [f"{stage}.{k}" for k, v in res[stage].items()
                if v["ratio"] > 1.0]
        if time_it:
            run.prep(p_flat, 0)
            rows_in = {k: v if stage in ("head", "trace") else v[:N]
                       for k, v in inputs.items()}
            times[stage] = {
                "ms": timed_after(
                    lambda: run.fill(inputs),
                    lambda: run.launch_stage(stage, p_flat, 0, grads, sums),
                    5),
                "plain_ms": timed(lambda: vtrace_sgd.vtrace_plain_stage(
                    stage, params, rows, inputs, ent, **kw), 3),
                "max_abs_err": max(v["max_abs_err"]
                                   for v in res[stage].values()),
                **bound(nbytes(rows_in, want[stage], *reads[stage]),
                        flops[stage])}
    return res, bad, times


def vtrace_stage_check(dev, cfg, name, hidden=HIDDEN[0], ragged=False,
                       layers=HIDDEN[1]):
    """``vtrace_stage_run`` on the config-4 IMPALA trajectory of
    ``impala_inputs`` (N = 65536 samples and 4096 last-obs rows a
    minibatch), or with ``ragged`` its first 5 steps of 100 envs, masked
    and with the truncation bootstrap (N = 500, no 64-row tile full at the
    end; nb = 100, no trace CTA full): K6's stage kernels against their
    plain stages, then timed; fails on any output off its bound. Returns
    each stage's ``(max_abs_err, ms, plain_ms, bound)``."""
    tcfg, params, traj, last_obs, kw = impala_inputs(dev, cfg, hidden,
                                                     layers=layers)
    M = tcfg.num_minibatches
    if ragged:  # a random mask that keeps each taken action, random boots
        traj = ImpalaTransition(*(x[:RAGGED_T, :RAGGED_B] for x in traj))
        g = torch.Generator().manual_seed(SEED + 11)
        mask = torch.rand(traj.mask.shape, generator=g) > 0.3
        mask[..., 0] = True
        mask.scatter_(-1, traj.action.long().cpu()[..., None], True)
        traj = traj._replace(mask=mask.to(dev), boot_value=torch.randn(
            traj.reward.shape, generator=g).to(dev))
        last_obs = last_obs[:RAGGED_B]
        kw = dict(kw, mask_actions=True, bootstrap_truncated=True)
    res, bad, times = vtrace_stage_run(dev, params, traj, last_obs,
                                       tcfg.entropy_coef, M, kw)
    emit({"phase": "vtrace_stage_check", "kernel": "K6", "config": name,
          "ragged": ragged, "hidden": hidden, "num_layers": layers,
          "samples": traj.action[:, :traj.action.shape[1] // M].numel(),
          "last_obs_rows": last_obs[:last_obs.shape[0] // M, :, 0].numel(),
          "masked_bootstrap": ragged, "tol": STAGE_TOL,
          "stages": {st: {"outputs": res[st], **times[st]} for st in res}})
    require(not bad, f"K6 stages differ from their plain stages: {bad}")
    return {st: (t["max_abs_err"], t["ms"], t["plain_ms"], t)
            for st, t in times.items()}


def carry_leaves(carry):
    return carry if isinstance(carry, tuple) else (carry,)


def k7_check(dev, name, cfg, arch, mask_actions=False, shape=HIDDEN):
    """K7 against the plain engine replaying its actions and the plain
    recurrent policy stepped over its observations from the same carry,
    then timed beside its twin; the model ``shape`` (hidden_dim,
    num_layers) wide and deep."""
    B, T, A = CHECK_B, SLICE_T, cfg.num_agents
    model = make_model(cfg, arch, shape[0], shape[1],
                       torch.Generator().manual_seed(SEED), dev)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    state, obs0 = reset_envs(cfg, B, SEED + 1, dev)
    gen = torch.Generator().manual_seed(SEED + 9)
    carry = tuple((0.5 * torch.randn(B, A, shape[0], generator=gen)).to(dev)
                  for _ in range(2 if arch == "lstm" else 1))
    carry = carry if arch == "lstm" else carry[0]
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, T)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), T,
                                     (5, B * A))
    logits_k = torch.empty(T, B, A, 5, device=dev)
    mask = (torch.empty(T, B, A, 5, dtype=torch.bool, device=dev)
            if mask_actions else None)
    ks, kc, obs, action, lp, value, reward, delivered = act_rnn.act_rnn_steps(
        cfg, params, state, carry, u, pick, drop, g, logits=logits_k,
        mask=mask)
    torch.cuda.synchronize()

    s, c = state, carry
    err = {"logits": 0.0, "value": 0.0, "log_prob": 0.0}
    agree, clear_n = True, 0.0
    require(bits_equal(obs[0], obs0), "K7: first obs differs")
    for t in range(T):
        if mask_actions:
            require(torch.equal(mask[t], valid_action_mask(cfg, s.agent_pos)),
                    f"K7: mask differs from valid_action_mask t={t}")
            require(bool(mask[t].gather(-1, action[t].long()[..., None])
                         .all()), f"K7: a masked move was sampled t={t}")
        with torch.no_grad():
            logits, val, c = apply_rnn(params, obs[t], c)
        sampled = (torch.where(mask[t], logits, -1e9) if mask_actions
                   else logits)
        lp_plain = torch.log_softmax(sampled, -1).gather(
            -1, action[t].long()[..., None])[..., 0]
        for k, d in (("logits", logits - logits_k[t]),
                     ("value", val - value[t]),
                     ("log_prob", lp_plain - lp[t])):
            err[k] = max(err[k], float(d.abs().max()))
        z = sampled.reshape(B * A, 5).t() + g[t]                  # [5, N]
        top2 = z.topk(2, dim=0).values
        clear = (top2[0] - top2[1]).reshape(B, A) > TOL
        agree &= bool(((first_argmax(z, 0).reshape(B, A) == action[t])
                       | ~clear).all())
        clear_n += float(clear.float().mean()) / T
        s, ts = step_batch(cfg, s, action[t])
        require(bits_equal(ts.reward, reward[t]), f"K7: reward t={t}")
        require(torch.equal(ts.delivered.sum(-1, dtype=torch.int32),
                            delivered[t]), f"K7: deliveries t={t}")
        if t + 1 < T:
            require(bits_equal(ts.obs, obs[t + 1]), f"K7: obs t={t + 1}")
    require(state_equal(s.replace(t=state.t, key=state.key), ks),
            "K7: final state differs")
    err["carry"] = max(float((a - b).abs().max())
                       for a, b in zip(carry_leaves(kc), carry_leaves(c)))
    require(max(err.values()) <= TOL, f"K7: policy outputs off by {err}")
    require(agree, "K7: actions differ where the top-two gap is clear")

    k_ms = timed(lambda: act_rnn.act_rnn_steps(cfg, params, state, carry, u,
                                               pick, drop, g, mask=mask), 5)
    p_ms = timed(lambda: act_rnn.act_rnn_steps_reference(
        cfg, params, state, carry, u, pick, drop, g, mask=mask), 3)
    out = {"phase": "k7_check", "config": name, "arch": arch,
           "hidden_dim": shape[0], "num_layers": shape[1],
           "mask_actions": mask_actions, "B": B, "T": T, "max_abs_err": err,
           "tol": TOL, "actions_agree_where_gap_gt_tol": agree,
           "clear_share": clear_n, "kernel_ms": k_ms, "plain_ms": p_ms}
    if mask_actions:
        out["masked_share"] = float(1.0 - mask.float().mean())
    emit(out)
    fwd, _ = rnn_macs(params)
    bnd = bound(nbytes(state, ks, carry, kc, u, pick, drop, g, obs, action,
                       lp, value, reward, delivered, mask, params),
                2.0 * fwd * T * B * A)
    return max(err.values()), k_ms, p_ms, bnd


def library_cell(params, eh, c=None):
    """``torch.nn.GRUCell`` / ``LSTMCell`` holding the cell's weights
    (flax's GRU is torch's with b_hr = b_hz = 0; the LSTM's input side has
    no bias) and a call of it on the rows ``eh = [e | h]``: the PyTorch call
    for the cell stage's function, timed beside it, used nowhere in the
    port."""
    H = params["logits.weight"].shape[1]
    E = eh.shape[1] - H
    lstm = c is not None
    gates = act_rnn.GATE_ORDER["lstm" if lstm else "gru"]
    cell = (torch.nn.LSTMCell if lstm else torch.nn.GRUCell)(
        E, H, device=eh.device)
    with torch.no_grad():
        cell.weight_ih.copy_(torch.cat([params[f"cell.i{g}.weight"]
                                        for g in gates]))
        cell.weight_hh.copy_(torch.cat([params[f"cell.h{g}.weight"]
                                        for g in gates]))
        if lstm:
            cell.bias_ih.zero_()
            cell.bias_hh.copy_(torch.cat([params[f"cell.h{g}.bias"]
                                          for g in gates]))
        else:
            cell.bias_ih.copy_(torch.cat([params[f"cell.i{g}.bias"]
                                          for g in gates]))
            cell.bias_hh.zero_()
            cell.bias_hh[2 * H:] = params["cell.hn.bias"]
    e, h = eh[:, :E].contiguous(), eh[:, E:].contiguous()

    def call():
        with torch.no_grad():
            return cell(e, (h, c)) if lstm else cell(e, h)

    return call


def act_rnn_stage_run(dev, cfg, arch, hidden=HIDDEN[0], B=CHECK_B,
                      masked=False, time_it=True, num_layers=HIDDEN[1]):
    """K7's stage kernels (``act_rnn.ACT_RNN_STAGES``: each encoder layer,
    the cell, the head, the env stage) on one step's rows of ``cfg`` from a
    reset and a random carry (with ``masked``, action masking on), each
    against its plain stage on the plain chain's inputs: the encoder,
    cell and head rows within STAGE_TOL elementwise, the env stage's
    log-probs within TOL and every other output bit-equal. With
    ``time_it`` each stage's kernel is timed alone by CUDA events (the
    prep once, the stage's inputs refilled before each run) beside its
    plain stage and its bound (the bytes the stage reads and writes, or
    its operations: the cell's at the tensor cores' TF32 rate, three
    products a k, beside the CUDA cores' float32 rate), and the cell beside
    ``library_cell``. Returns ``(results, failures, times)``."""
    A, N = cfg.num_agents, B * cfg.num_agents
    model = make_model(cfg, arch, hidden, num_layers,
                       torch.Generator().manual_seed(SEED), dev)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    state, obs = reset_envs(cfg, B, SEED + 1, dev)
    gen = torch.Generator().manual_seed(SEED + 9)
    h = (0.5 * torch.randn(N, hidden, generator=gen)).to(dev)
    c = ((0.5 * torch.randn(N, hidden, generator=gen)).to(dev)
         if arch == "lstm" else None)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, 1)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), 1, (5, N))
    n_enc = sum(k.startswith("encoder.") and k.endswith(".weight")
                for k in params)
    stages = [("encoder", l) for l in range(n_enc)] + [
        (st, 0) for st in act_rnn.ACT_RNN_STAGES[1:]]
    order = torch.arange(N, device=dev)

    def plain(stage, layer, x):
        with torch.no_grad():
            if stage == "encoder":
                return {"y": act_rnn.act_encoder_plain(params, layer,
                                                       x["x"])}
            if stage == "cell":
                return act_rnn.act_cell_plain(params, x["eh"], x.get("c"))
            if stage == "head":
                return {"head": act_rnn.act_rnn_head_plain(params, x["h"])}
            return act.act_env_plain(cfg, state, x["head"], order, u[0],
                                     pick[0], drop[0], g[0], masked)

    inputs, want, x = {}, {}, obs.reshape(N, -1)
    for stage, layer in stages:
        key = stage if stage != "encoder" else f"encoder{layer}"
        if stage == "encoder":
            inputs[key] = {"x": x}
        elif stage == "cell":
            inputs[key] = {"eh": torch.cat([x, h], 1), "c": c}
        elif stage == "head":
            inputs[key] = {"h": want["cell"]["h"]}
        else:
            inputs[key] = {"head": want["head"]["head"]}
        want[key] = plain(stage, layer, inputs[key])
        if stage == "encoder":
            x = want[key]["y"]
    E = x.shape[1]
    run = act_rnn.stage_launch(cfg, params, state, u, pick, drop, g, masked)
    gate_macs = (4 if arch == "lstm" else 3) * hidden * (E + hidden)
    w_bytes = {k: nbytes({n: v for n, v in params.items()
                          if n.startswith(p)})
               for k, p in (("cell", "cell."), ("head", ("logits.",
                                                         "value.")))}
    res, bad, times = {}, [], {}
    for stage, layer in stages:
        key = stage if stage != "encoder" else f"encoder{layer}"
        before = act_rnn.act_rnn_stage.launches
        got = act_rnn.act_rnn_stage(stage, cfg, params, state, inputs[key],
                                    u, pick, drop, g, masked, layer)
        torch.cuda.synchronize()
        require(act_rnn.act_rnn_stage.launches == before + 1,
                f"K7 stage {key}: the launch count did not move")
        out = {}
        for k, w in want[key].items():
            y = got[k]
            if k == "state":
                out[k] = {"bit_equal": all(torch.equal(
                    getattr(y, f), getattr(w, f)) for f in STATE_FIELDS[:-2])}
            elif w is None:
                out[k] = {"bit_equal": y is None}
            elif stage != "env" or k == "log_prob":
                e, r = tree_err((y,), (w,), *(STAGE_TOL if stage != "env"
                                             else (0.0, TOL)))
                out[k] = {"max_abs_err": e, "ratio": r}
            else:
                out[k] = {"bit_equal": torch.equal(
                    y.view(torch.int32) if y.dtype == torch.float32 else y,
                    w.view(torch.int32) if w.dtype == torch.float32 else w)}
        bad += [f"{key}.{k}" for k, v in out.items()
                if v.get("ratio", 0.0) > 1.0 or v.get("bit_equal") is False]
        res[key] = out
        if not time_it:
            continue
        if stage == "encoder":
            lin = params[f"encoder.{layer}.weight"]
            n_bytes = nbytes(inputs[key], want[key], lin,
                             params[f"encoder.{layer}.bias"])
            bnd = bound(n_bytes, 2.0 * N * lin.numel())
        elif stage == "cell":
            # The cell's rows in and out, c in and out, its weights.
            bnd = bound(nbytes(inputs[key], want[key]) + w_bytes["cell"],
                        2.0 * N * gate_macs, tf32=True)
        elif stage == "head":
            bnd = bound(nbytes(inputs[key], want[key]) + w_bytes["head"],
                        2.0 * N * 6 * hidden)
        else:
            bnd = bound(nbytes(inputs[key], want[key], state, u, pick, drop,
                               g), 0.0)
        run.launch("prep")
        nxt = []
        times[key] = {
            "ms": timed_after(
                lambda: nxt.append(run.fill(stage, inputs[key], layer)),
                lambda: run.launch(stage, nxt[-1], layer), 5),
            "plain_ms": timed(lambda: plain(stage, layer, inputs[key]), 3),
            "max_abs_err": max([v.get("max_abs_err", 0.0)
                                for v in out.values()]),
            "library_ms": None, **bnd}
        if stage == "cell":
            call = library_cell(params, inputs[key]["eh"], c)
            lib = call()
            lib_h = lib[0] if arch == "lstm" else lib
            prev = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            try:
                times[key]["library_ms"] = timed(call, 5)
            finally:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = prev
            times[key]["library_max_abs_diff"] = float(
                (lib_h - want[key]["h"]).abs().max())
    return res, bad, times


def act_rnn_stage_check(dev, cfg, name, arch, B=CHECK_B, masked=False,
                        shape=HIDDEN):
    """``act_rnn_stage_run`` for ``arch`` on ``cfg`` at hidden 128 x 2
    (one encoder layer): K7's stage kernels against their plain stages on
    one step's rows, then timed; then one K7 chunk of T = 16 from the same
    reset launched twice, bit-equal. Fails on any output off its bound or
    a rerun that differs. Returns each stage's ``(max_abs_err, ms,
    plain_ms, bound, library_ms)``."""
    res, bad, times = act_rnn_stage_run(dev, cfg, arch, shape[0], B=B,
                                        masked=masked, num_layers=shape[1])
    T, A = SLICE_T, cfg.num_agents
    model = make_model(cfg, arch, shape[0], shape[1],
                       torch.Generator().manual_seed(SEED), dev)
    params = {k: v.detach() for k, v in model.state_dict().items()}
    state, _ = reset_envs(cfg, B, SEED + 1, dev)
    carry = model.initial_carry((B, A))
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, T)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), T,
                                     (5, B * A))
    mask = (torch.empty(T, B, A, 5, dtype=torch.bool, device=dev)
            if masked else None)
    runs = [act_rnn.act_rnn_steps(cfg, params, state, carry, u, pick, drop,
                                  g, mask=mask) for _ in range(2)]
    torch.cuda.synchronize()
    flat = [[getattr(r[0], f) for f in STATE_FIELDS]
            + list(carry_leaves(r[1])) + list(r[2:]) for r in runs]
    rerun = all(bits_equal(x, y) if x.dtype == torch.float32
                else torch.equal(x, y) for x, y in zip(*flat))
    emit({"phase": "act_rnn_stage_check", "kernel": "K7", "config": name,
          "arch": arch, "hidden_dim": shape[0], "num_layers": shape[1],
          "B": B, "rows": B * A, "masked": masked,
          "tol": {"rows": STAGE_TOL, "log_prob": TOL},
          "rerun_bit_equal": rerun, "stages": {
              st: {"outputs": res[st], **times[st]} for st in res}})
    require(not bad, f"K7 stages differ from their plain stages: {bad}")
    require(rerun, "K7: a rerun of the chunk gave other bits")
    return {st: (t["max_abs_err"], t["ms"], t["plain_ms"], t,
                 t["library_ms"]) for st, t in times.items()}


def rnn_inputs(dev, cfg, arch, bf16=False,
               rollout=act_rnn.ppo_rnn_rollout_reference, shape=HIDDEN):
    """One config-4 recurrent trajectory for the K8/K9 checks: a chunk of
    ``rollout`` (K7's plain twin; with global observations the trainer's
    per-step phase, D = 411 on the 9x9 map) from the trainer's reset and a
    random carry (of bf16 values with ``bf16``, as a bf16 run's carry cast
    up),
    then GAE and the per-minibatch normalization. The learner's checks take
    the twin's chunk so that their inputs do not move with K7's bits: on
    the chunk K7 makes at its 3xTF32 bits, one sample's value sits 5e-9
    past the PPO value clip after K8's first update in float64, 7.5e-8
    inside it in float32 (K9 and the twin alike), and K8's phase and its
    twin's part at that branch (``tools/torch_k8_boundary.py``). The model
    ``shape`` (hidden_dim, num_layers) wide and deep."""
    tcfg = TrainConfig(num_updates=RNN_SCHEDULE, hidden_dim=shape[0],
                       num_layers=shape[1])
    tr = make_train_rnn(cfg, tcfg, arch, device=dev)
    rs = tr.init(rng.prng_key(SEED + 5, dev))
    gen = torch.Generator().manual_seed(SEED + 10)
    h0 = tuple((0.5 * torch.randn(x.shape, generator=gen)).to(dev)
               for x in carry_leaves(rs.carry))
    h0 = tuple(map(bf16_round, h0)) if bf16 else h0
    h0 = h0 if arch == "lstm" else h0[0]
    if cfg.global_obs:  # K7 has no global view: the trainer's per-step phase
        _, roll, last_obs, _, _, last_h = step_rollout(
            cfg, tcfg, lambda o, c: apply_rnn(rs.params, o, c), rs.env_state,
            rs.obs, SLICE_T, rng.prng_key(SEED + 6, dev), h0)
    else:
        new, roll, _, _, last_h = rollout(
            cfg, rs.params, rs.env_state, h0, SLICE_T,
            rng.prng_key(SEED + 6, dev))
        last_obs = observe_batch(cfg, new)
    done = roll.truncated[:, :, None].expand_as(roll.reward)
    traj = Transition(roll.obs, roll.action, roll.log_prob, roll.value,
                      roll.reward, done, roll.mask,
                      torch.zeros_like(roll.value))
    with torch.no_grad():
        _, last_value, _ = apply_rnn(rs.params, last_obs, last_h)
    adv, targets = gae(roll.reward, roll.value, done, last_value,
                       tcfg.gamma, tcfg.gae_lambda)
    adv_n = sgd.normalize_adv_env_minibatch(adv, tcfg.num_minibatches)
    ent = entropy_coef_at(tcfg, rs.update_idx)
    return tcfg, tr, rs, traj, adv_n, targets, h0, ent


def k8_check(dev, cfg, arch, bf16=False, shape=HIDDEN, plain_reps=3):
    tcfg, tr, rs, traj, adv_n, targets, h0, ent = rnn_inputs(
        dev, cfg, arch, bf16, shape=shape)
    E, M = tcfg.ppo_epochs, tcfg.num_minibatches
    rows = tr.optimizer.step_rows(rs.opt_state.count, E * M, dev)
    args = (rs.params, rs.opt_state, traj, adv_n, targets, h0, *rows, ent,
            rs.kl_coeff)
    kw = dict(num_epochs=E, num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, max_grad_norm=tcfg.max_grad_norm,
              mask_actions=False, **({"matmul_dtype": BF16} if bf16 else {}))
    K = "K8 bf16" if bf16 else "K8"
    n_bf16 = sgd_rnn.ppo_rnn_sgd_phase.bf16_launches
    pk, ok, lk = sgd_rnn.ppo_rnn_sgd_phase(*args, **kw)
    require(sgd_rnn.ppo_rnn_sgd_phase.bf16_launches
            == n_bf16 + (E * M if bf16 else 0),
            f"{K}: the bf16 count did not show the bf16 route")
    pr, orf, lr_ = sgd_rnn.ppo_rnn_sgd_phase_reference(*args, **kw)
    p2, o2, l2 = sgd_rnn.ppo_rnn_sgd_phase(*args, **kw)
    torch.cuda.synchronize()
    pairs = {"losses": (lk, lr_), "params": (pk, pr), "mu": (ok.mu, orf.mu),
             "nu": (ok.nu, orf.nu)}
    err = {k: tree_err(*v, *SGD_TOL[k]) for k, v in pairs.items()}
    if bf16:
        ratios = phase_norm_ratios((pk, ok, lk), (pr, orf, lr_), SGD_TOL)
        f32_ratio = f32_twin_ratio(sgd_rnn.ppo_rnn_sgd_phase_reference, args,
                                   kw, (pr, orf, lr_), SGD_TOL)
    else:
        ratios = None
    bit_equal = (all(bits_equal(pk[k], p2[k]) and bits_equal(ok.mu[k],
                                                             o2.mu[k])
                     and bits_equal(ok.nu[k], o2.nu[k]) for k in pk)
                 and all(bits_equal(a, b) for a, b in zip(lk, l2)))
    moved = max(float((pk[k] - rs.params[k]).abs().max()) for k in pk)
    k_ms = timed(lambda: sgd_rnn.ppo_rnn_sgd_phase(*args, **kw), 3)
    p_ms = timed(lambda: sgd_rnn.ppo_rnn_sgd_phase_reference(*args, **kw),
                 plain_reps)
    emit({**check_line("K8", bf16, "k8_check"), "arch": arch,
          "hidden_dim": shape[0], "num_layers": shape[1],
          "B": traj.obs.shape[1],
          "T": SLICE_T, "epochs": E, "minibatches": M,
          "sequences_per_minibatch":
          traj.obs.shape[1] * cfg.num_agents // M,
          "max_abs_err": {k: e for k, (e, _) in err.items()},
          "tol_ratio": {k: r for k, (_, r) in err.items()}, "tol": SGD_TOL,
          **({"norm_ratio": ratios, "rel_bound": BF16_PHASE_REL,
              "f32_twin_norm_ratio": f32_ratio} if bf16 else {}),
          "bit_equal_rerun": bit_equal, "max_param_step": moved,
          "kernel_ms": k_ms, "plain_ms": p_ms})
    require(within(err, ratios),
            f"{K} ({arch}) differs from its twin: {err} {ratios}")
    require(not bf16 or f32_ratio > 1.0,
            f"{K} ({arch}): the f32 twin lies within the bf16 bound")
    require(bit_equal, f"{K} ({arch}): a second run gave other bits")
    require(moved > 0.0, f"{K} ({arch}) did not move the params")
    if not bf16:  # F-c17: each step from the kernel's own state
        w = traj.obs.shape[1] // M

        def step_args(p, o, s):
            lo = (s % M) * w
            cut = functools.partial(env_cols, lo=lo, w=w)
            carry = tuple(x[lo:lo + w].contiguous() for x in carry_leaves(h0))
            return ((p, o, Transition(*map(cut, traj)), cut(adv_n),
                     cut(targets), carry if arch == "lstm" else carry[0],
                     *(r[s:s + 1] for r in rows), ent, rs.kl_coeff),
                    {**kw, "num_epochs": 1, "num_minibatches": 1})
        per_step_check(f"{K} {arch}" + (" D=%d" % cfg.obs_dim
                                        if cfg.global_obs else ""),
                       sgd_rnn.ppo_rnn_sgd_phase,
                       sgd_rnn.ppo_rnn_sgd_phase_reference, rs.params,
                       rs.opt_state, step_args, E * M, SGD_TOL)
    fwd, dx = rnn_macs(rs.params)
    bnd = bound(nbytes(traj.obs, traj.action, traj.log_prob, traj.value,
                       adv_n, targets, h0, rows, lk)
                + 2 * nbytes(rs.params, rs.opt_state.mu, rs.opt_state.nu),
                2.0 * (2 * fwd + dx) * traj.action.numel() * E, bf16)
    return err["params"][0], k_ms, p_ms, bnd


def k9_check(dev, cfg, arch, bf16=False, shape=HIDDEN):
    tcfg, tr, rs, traj, adv_n, targets, h0, ent = rnn_inputs(
        dev, cfg, arch, bf16, shape=shape)
    M = tcfg.num_minibatches
    kw = dict(num_minibatches=M, clip_eps=tcfg.clip_eps,
              value_coef=tcfg.value_coef, mask_actions=False,
              **({"matmul_dtype": BF16} if bf16 else {}))
    worst = {"losses": (0.0, 0.0), "grads": (0.0, 0.0)}
    ratios = {"losses": 0.0, "grads": 0.0} if bf16 else None
    for mb in range(M):
        (lk, auxk), gk = sgd_rnn.ppo_rnn_minibatch_grads(
            rs.params, traj, adv_n, targets, h0, mb, ent, rs.kl_coeff, **kw)
        (lr_, auxr), gr = sgd_rnn.ppo_rnn_minibatch_grads_reference(
            rs.params, traj, adv_n, targets, h0, mb, ent, rs.kl_coeff, **kw)
        torch.cuda.synchronize()
        for name, a, b, t in (("losses", (lk, *auxk), (lr_, *auxr),
                               RNN_MB_LOSS_TOL),
                              ("grads", gk, gr, RNN_GRAD_TOL)):
            worst[name] = tuple(map(max, worst[name], tree_err(a, b, *t)))
            if bf16:
                ratios[name] = max(ratios[name], norm_ratio(
                    a, b, BF16_GRAD_REL, t[1] if name == "losses" else 0.0,
                    stack=name == "losses"))
    if bf16:  # the f32 twin beyond the bound, on the last minibatch
        f32_ratio = f32_twin_ratio(
            sgd_rnn.ppo_rnn_minibatch_grads_reference,
            (rs.params, traj, adv_n, targets, h0, M - 1, ent, rs.kl_coeff),
            kw, (None, gr))
    args = (rs.params, traj, adv_n, targets, h0, 0, ent, rs.kl_coeff)
    k_ms = timed(lambda: sgd_rnn.ppo_rnn_minibatch_grads(*args, **kw), 5)
    p_ms = timed(lambda: sgd_rnn.ppo_rnn_minibatch_grads_reference(
        *args, **kw), 3)
    emit({**check_line("K9", bf16, "k9_check"), "arch": arch,
          "hidden_dim": shape[0], "num_layers": shape[1],
          "minibatches": M,
          "max_abs_err": {k: e for k, (e, _) in worst.items()},
          "tol_ratio": {k: r for k, (_, r) in worst.items()},
          "tol": {"losses": RNN_MB_LOSS_TOL, "grads": RNN_GRAD_TOL},
          **({"norm_ratio": ratios, "rel_bound": BF16_GRAD_REL,
              "f32_twin_norm_ratio": f32_ratio} if bf16 else {}),
          "kernel_ms": k_ms, "plain_ms": p_ms})
    K = "K9 bf16" if bf16 else "K9"
    require(within(worst, ratios),
            f"{K} ({arch}) differs from autograd: {worst} {ratios}")
    require(not bf16 or f32_ratio > 1.0,
            f"{K} ({arch}): the f32 twin's gradient lies within the bf16 "
            "bound")
    fwd, dx = rnn_macs(rs.params)
    bnd = bound(nbytes(traj.obs, traj.action, traj.log_prob, traj.value,
                       adv_n, targets, h0) / M + 2 * nbytes(rs.params),
                2.0 * (2 * fwd + dx) * traj.action.numel() / M, bf16)
    return worst["grads"][0], k_ms, p_ms, bnd


def rnn_stage_check(dev, cfg, arch, bf16=False, ragged=False, shape=HIDDEN):
    """K9's six stage kernels (``sgd_rnn.STAGES``), each against its plain
    stage on the plain chain's rows of minibatch 0 of a config-4 recurrent
    trajectory (``rnn_inputs``: N = 4096 sequences of 16 steps; with
    ``ragged`` its first 5 steps of 100 envs: N = 100, no recurrent tile
    full at the end), then timed on those rows. float32 outputs within
    RNN_GRAD_TOL elementwise; with ``bf16`` (against the bf16 plain
    stages) each tensor within BF16_GRAD_REL in norm; the loss terms within
    RNN_MB_LOSS_TOL. The model ``shape`` (hidden_dim, num_layers) wide and
    deep."""
    tcfg, _, rs, traj, adv_n, targets, h0, ent = rnn_inputs(
        dev, cfg, arch, bf16, shape=shape)
    if ragged:
        traj = Transition(*(x[:RAGGED_T, :RAGGED_B] for x in traj))
        adv_n, targets = (x[:RAGGED_T, :RAGGED_B] for x in (adv_n, targets))
        h0 = tuple(x[:RAGGED_B] for x in h0) if arch == "lstm" else h0[
            :RAGGED_B]
    p, kl, M = rs.params, rs.kl_coeff, tcfg.num_minibatches
    loss_kw = dict(clip_eps=tcfg.clip_eps, value_coef=tcfg.value_coef,
                   mask_actions=False)
    md = BF16 if bf16 else "float32"
    rows, carry = sgd_rnn.minibatch_rows(traj, adv_n, targets, h0, 0, M)
    chain, want = sgd_rnn.plain_stage_chain(p, rows, carry, ent, kl,
                                            bf16=bf16, **loss_kw)
    run = sgd_rnn.RnnLaunch(p, traj, adv_n, targets, h0, ent, kl, M,
                            tcfg.clip_eps, tcfg.value_coef, False,
                            matmul_dtype=md)
    p_flat = act_rnn.pack_rnn(p)
    grads = torch.zeros_like(p_flat)
    sums = torch.zeros(4, dtype=torch.float32, device=dev)
    out, bad = {}, []
    for stage in sgd_rnn.STAGES:
        inputs = sgd_rnn.stage_inputs(stage, p, chain)
        before = sgd_rnn.rnn_stage.launches
        got = sgd_rnn.rnn_stage(stage, p, traj, adv_n, targets, h0, 0, ent,
                                kl, inputs, matmul_dtype=md,
                                num_minibatches=M, **loss_kw)
        torch.cuda.synchronize()
        require(sgd_rnn.rnn_stage.launches == before + 1,
                f"rnn stage {stage}: the launch count did not move")
        res = stage_ratios(got, want[stage], bf16)
        bad += [f"{stage}.{k}" for k, v in res.items() if v["ratio"] > 1.0]
        run.fill(inputs)
        ms = timed(lambda: run.launch_stage(stage, p_flat, 0, grads, sums), 5)
        out[stage] = {"outputs": res, "ms": ms, "plain_ms": timed(
            lambda: sgd_rnn.plain_stage(stage, p, rows, carry, inputs, ent,
                                        kl, bf16=bf16, **loss_kw), 3)}
    emit({**check_line("K9", bf16, "rnn_stage_check"), "arch": arch,
          "hidden_dim": shape[0], "num_layers": shape[1],
          "ragged": ragged, "sequences": rows[0].shape[0] // traj.obs.shape[0],
          "steps": traj.obs.shape[0],
          "ratio": "norm_ratio at BF16_GRAD_REL" if bf16 else
          "tol_ratio at RNN_GRAD_TOL", "stages": out})
    require(not bad, f"K9 stages differ from their plain stages: {bad}")
    return out


def k1_episodes(dev):
    """Greedy episodes through ``greedy_rollout`` (one K1 launch, its draws
    on the card), each from a batched reset; the first episode also
    through the plain path."""
    cfg = medium_config()
    B, T = EPISODE_B, cfg.max_steps
    episode_ms, total_d = [], 0
    for i in range(EPISODES):
        state, _ = reset_envs(cfg, B, 100 + i, dev)
        torch.cuda.synchronize()
        with Timer() as tm:
            final, deliv, rew = rollout.greedy_rollout(cfg, state, T)
        episode_ms.append(tm.ms)
        total_d += int(deliv.sum())
        require(bool((final.t == T).all() and torch.isfinite(rew).all()),
                "K1 episode: bad final step count or reward")
        if i == 0:
            with Timer() as tp:
                plain = rollout.greedy_rollout_reference(cfg, state, T)
            plain_ms = tp.ms
            require(state_equal(final, plain[0])
                    and torch.equal(deliv, plain[1]),
                    "K1 episode differs from the plain path")
    require(total_d > 0, "K1 episodes delivered nothing")
    ms = median(episode_ms)
    emit({"phase": "k1_episodes", "B": B, "T": T, "episodes": EPISODES,
          "episode_ms_median": ms, "episode_ms": episode_ms,
          "plain_episode_ms": plain_ms,
          "env_steps_per_s": B * T / (ms / 1e3),
          "plain_env_steps_per_s": B * T / (plain_ms / 1e3),
          "deliveries_per_env_step": total_d / (EPISODES * B * T)})


def run_slice(dev, cfg, model, rollout_fn):
    """One episode of config-4 acting: 8 chunks + the boundary reset."""
    state, _ = reset_envs(cfg, SLICE_B, SEED + 3, dev)
    key = rng.prng_key(SEED + 4, dev)
    torch.cuda.synchronize()
    deliv, chunk_ms = 0, []
    with Timer() as total:
        for _ in range(cfg.max_steps // SLICE_T):
            with Timer() as tc:
                new, roll, reset_key, key = rollout_fn(cfg, model, state,
                                                       SLICE_T, key)
            chunk_ms.append(tc.ms)
            state, obs, _ = reset_truncated_batch(cfg, new, reset_key)
            deliv += int(roll.delivered.sum())
    require(bool((state.t == 0).all()), "slice: envs were not reset")
    require(bool(torch.isfinite(roll.value).all()
                 and torch.isfinite(roll.log_prob).all()),
            "slice: non-finite policy outputs")
    return total.ms, chunk_ms, deliv, obs


def slice_phase(dev, cfg, model):
    B, steps = SLICE_B, SLICE_B * cfg.max_steps
    k_ms, k_chunks, k_del, obs = run_slice(dev, cfg, model, act.ppo_rollout)
    p_ms, p_chunks, p_del, _ = run_slice(dev, cfg, model,
                                         act.ppo_rollout_reference)
    require(k_del > 0, "slice delivered nothing")

    # Serving on the post-episode observations.
    acts, _ = Policy(cfg, model).compute_actions(obs)
    with torch.no_grad():
        logits, _ = model(obs)
    require(acts.shape == (B, cfg.num_agents) and acts.dtype == torch.int32,
            "serve: bad action shape")
    require(torch.equal(acts, first_argmax(logits, -1).to(torch.int32)),
            "serve: actions differ from the argmax of the plain logits")
    emit({"phase": "slice", "B": B, "T": SLICE_T,
          "chunks": cfg.max_steps // SLICE_T,
          "kernel_ms": k_ms, "plain_ms": p_ms,
          "kernel_chunk_ms": k_chunks, "plain_chunk_ms": p_chunks,
          "kernel_env_steps_per_s": steps / (k_ms / 1e3),
          "plain_env_steps_per_s": steps / (p_ms / 1e3),
          "kernel_deliveries_per_env_step": k_del / steps,
          "plain_deliveries_per_env_step": p_del / steps,
          "serve_batch": [B, cfg.num_agents, cfg.obs_dim]})


class Marks:
    """CUDA events at the phase boundaries of one update (``mark``)."""

    def __init__(self):
        self.events = [("start", torch.cuda.Event(enable_timing=True))]
        self.events[0][1].record()

    def __call__(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def split(self):
        """ms per phase, and the rest of the update as "glue"."""
        self("end")
        self.events[-1][1].synchronize()
        out = {name: a.elapsed_time(b) for (_, a), (name, b)
               in zip(self.events, self.events[1:])}
        out["glue"] = out.pop("end")
        out["total"] = sum(out.values())
        return out


def median_split(splits):
    return {k: median([s[k] for s in splits]) for k in splits[0]}


def run_updates(tr, n, what, dev, hook=None, backends=KERNELS, plain_n=3):
    """n updates of ``tr.train_step`` from ``PRNGKey(0)`` with the phase
    split of each by CUDA events, then ``plain_n`` of ``tr.plain_step``
    from the same initial state (none where both phases are plain: the
    same update): the final state and a dict of the timings, the
    per-update deliveries and the largest parameter change. ``hook(u, rs,
    metrics)``, if given, is called after update ``u`` (from 1). The
    trainer's routes must be ``backends``."""
    require(tr.backends == backends,
            f"{what}: backends {tr.backends}, expected {backends}")
    B, T = tr.tcfg.num_envs, tr.tcfg.unroll_length
    rs0 = tr.init(rng.prng_key(0, dev))
    rs, splits, deliveries = rs0, [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        marks = Marks()
        rs, m = tr.train_step(rs, mark=marks)
        splits.append(marks.split())
        require(all(bool(torch.isfinite(v)) for v in m.values()),
                f"{what}: non-finite metrics {m}")
        deliveries.append(float(m["deliveries_per_env_step"]))
        if hook is not None:
            hook(len(deliveries), rs, m)
    wall = time.perf_counter() - t0
    require(int(rs.update_idx) == n, f"{what}: update count")
    moved = max(float((rs.params[k] - rs0.params[k]).abs().max())
                for k in rs.params)
    require(moved > 0.0, f"{what}: params did not move")

    out = {"B": B, "T": T, "updates": n, "backends": tr.backends,
           "update_ms_median": median([s["total"] for s in splits]),
           "split_ms_median": median_split(splits),
           "env_steps_per_sec": B * T * n / wall,
           "deliveries_per_env_step": deliveries, "max_param_change": moved}
    if plain_n:
        plain, rp = [], rs0
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(plain_n):
            marks = Marks()
            rp, _ = tr.plain_step(rp, mark=marks)
            plain.append(marks.split())
        plain_wall = time.perf_counter() - t1
        out.update(plain_update_ms_median=median([s["total"] for s in plain]),
                   plain_split_ms_median=median_split(plain),
                   plain_env_steps_per_sec=B * T * plain_n / plain_wall)
    return rs, out


def serve_mlp(cfg, tr, rs):
    """The trained feed-forward (MLP or CNN, with or without policy
    groups) policy served on the run's last observations."""
    tr.model.load_state_dict(rs.params)
    groups = getattr(tr, "policy_groups", None)  # IMPALA's has none
    acts, _ = Policy(cfg, tr.model, policy_groups=groups).compute_actions(
        rs.obs)
    with torch.no_grad():
        logits, _ = apply(rs.params, rs.obs, None if groups is None else
                          torch.tensor(groups, device=rs.obs.device),
                          precision=model_precision(tr.tcfg.model_dtype))
    require(acts.shape == rs.obs.shape[:2] and torch.equal(
        acts, first_argmax(logits, -1).to(torch.int32)),
        "serve: actions differ from the argmax of the trained policy")


def train_phase(dev, cfg):
    """50 config-4 updates through the kernels, then 3 of the plain path
    from the same initial state, then the trained policy served."""
    tr = make_train(cfg, TrainConfig(num_updates=TRAIN_SCHEDULE), device=dev)
    rs, out = run_updates(tr, TRAIN_UPDATES, "train", dev)
    serve_mlp(cfg, tr, rs)
    late = sum(out["deliveries_per_env_step"][-10:]) / 10
    emit({"phase": "train", **out, "deliveries_41_50": late,
          "learn_min": LEARN_MIN})
    require(late >= LEARN_MIN,
            f"train: deliveries/env-step {late} over updates 41-50 is "
            f"below {LEARN_MIN}")


def impala_train_phase(dev, cfg):
    """The first 220 config-4 IMPALA updates (Adam) of a 300-update run
    through the kernels, then 3 of the plain path from the same initial
    state, then the trained policy served."""
    tcfg = TrainConfig(num_updates=IMPALA_SCHEDULE, impala_rmsprop=False)
    tr = make_train_impala(cfg, tcfg, device=dev)
    rs, out = run_updates(tr, IMPALA_UPDATES, "impala_train", dev)
    serve_mlp(cfg, tr, rs)
    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    emit({"phase": "impala_train", "optimizer": "adam", **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(50, IMPALA_UPDATES + 1, 50)},
          "deliveries_211_220": late, "learn_min": IMPALA_LEARN_MIN})
    require(late >= IMPALA_LEARN_MIN,
            f"impala_train: deliveries/env-step {late} over updates "
            f"211-220 is below {IMPALA_LEARN_MIN}")


def rnn_train_phase(dev, cfg, arch):
    """The first 40 config-4 recurrent PPO updates of a 300-update run
    through the kernels, then 3 of the plain path from the same initial
    state, then the trained policy served with its carry."""
    tr = make_train_rnn(cfg, TrainConfig(num_updates=RNN_SCHEDULE), arch,
                        device=dev)
    rs, out = run_updates(tr, RNN_UPDATES, f"rnn_train ({arch})", dev)
    late = sum(out["deliveries_per_env_step"][-10:]) / 10
    serve_rnn(cfg, tr, rs)
    emit({"phase": "rnn_train", "arch": arch, **out,
          "deliveries_31_40": late, "learn_min": RNN_LEARN_MIN})
    require(late >= RNN_LEARN_MIN,
            f"rnn_train ({arch}): deliveries/env-step {late} over updates "
            f"31-40 is below {RNN_LEARN_MIN}")


def serve_rnn(cfg, tr, rs):
    """The trained recurrent policy served at its compute dtype: two
    chained calls that thread the carry (bf16 in a bf16 model)."""
    tr.model.load_state_dict(rs.params)
    policy = Policy(cfg, tr.model)
    acts, carry = policy.compute_actions(rs.obs, rs.carry)
    with torch.no_grad():
        logits, _, want = apply_rnn(
            rs.params, rs.obs, rs.carry,
            precision=model_precision(tr.model.dtype))
    require(acts.shape == rs.obs.shape[:2] and torch.equal(
        acts, first_argmax(logits, -1).to(torch.int32)),
        "serve: actions differ from the argmax of the trained policy")
    require(all(torch.equal(a, b) and a.dtype == tr.model.dtype
                for a, b in zip(carry_leaves(carry), carry_leaves(want))),
            "serve: the carry differs from the policy's")
    acts2, carry2 = policy.compute_actions(rs.obs, carry)
    require(acts2.shape == acts.shape and all(
        bool(torch.isfinite(x).all()) and x.shape == y.shape
        and x.dtype == y.dtype
        for x, y in zip(carry_leaves(carry2), carry_leaves(carry))),
        "serve: bad second call")


def cnn_train_phase(dev, cfg):
    """The first 50 config-4 CNN PPO updates of a 300-update run through
    the kernels, then 3 of the plain path from the same initial state, then
    the trained policy served; the curve to ``runs/torch_cnn/metrics.jsonl``
    (the same bits on every run)."""
    tcfg = TrainConfig(num_updates=CNN_SCHEDULE)
    tr = make_train(cfg, tcfg, arch="cnn", device=dev)
    rows = []

    def hook(u, rs, m):
        rows.append({"step": u, **{k: float(v) for k, v in m.items()}})

    rs, out = run_updates(tr, CNN_UPDATES, "cnn_train", dev, hook)
    serve_mlp(cfg, tr, rs)
    os.makedirs(os.path.dirname(CNN_METRICS_OUT), exist_ok=True)
    with open(CNN_METRICS_OUT, "w") as f:
        f.write(json.dumps({"meta": True, "algo": "ppo", "arch": "cnn",
                            "env": "medium", "backends": tr.backends,
                            "device": torch.cuda.get_device_name(0),
                            "train_config": json.loads(tcfg.to_json())})
                + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)
    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    emit({"phase": "cnn_train", **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(10, CNN_UPDATES + 1, 10)},
          "deliveries_41_50": late, "learn_min": CNN_LEARN_MIN,
          "metrics_file": CNN_METRICS_OUT})
    require(late >= CNN_LEARN_MIN,
            f"cnn_train: deliveries/env-step {late} over updates 41-50 is "
            f"below {CNN_LEARN_MIN}")


def shelves_tcfg():
    """The walled-layout recipe's TrainConfig, as the train CLI builds it
    from ``--mask-actions --shaping-coef 0.02 --entropy-coef 0.02
    --entropy-coef-final 0.002`` on the JAX run's 300-update schedule."""
    return TrainConfig(num_updates=SHELVES_SCHEDULE, entropy_coef=0.02,
                       entropy_coef_final=0.002, mask_actions=True,
                       shaping_coef=SHAPING[0])


def shelves_train_phase(dev, cfg):
    """The first 100 updates of the walled-layout recipe through the
    kernels, checkpointed at update 50 and at the end; the checkpoint of
    update 50 restored and run to the end; then the three evaluations."""
    tcfg = shelves_tcfg()
    tr = make_train(cfg, tcfg, device=dev)
    n, mid = SHELVES_UPDATES, SHELVES_UPDATES // 2
    rows = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_policy_meta(ckpt_dir, cfg, tcfg, arch="mlp")

        def hook(u, rs, m):
            rows.append({"step": u, **{k: float(v) for k, v in m.items()}})
            if u in (mid, n):
                checkpoint.save(ckpt_dir, u, rs)

        rs, out = run_updates(tr, n, "shelves_train", dev, hook)
        require(checkpoint.latest_step(ckpt_dir) == n,
                "shelves_train: the last checkpoint is not the latest")

        # Resume: the mid-run checkpoint into a fresh state, to the end.
        resumed = checkpoint.restore(ckpt_dir, mid,
                                     tr.init(rng.prng_key(SEED + 12, dev)))
        require(int(resumed.update_idx) == mid
                and resumed.opt_state.count == mid * tcfg.ppo_epochs
                * tcfg.num_minibatches, "shelves_train: restored counters")
        for _ in range(n - mid):
            resumed, _ = tr.train_step(resumed)
        resume_equal = (
            all(bits_equal(resumed.params[k], rs.params[k])
                and bits_equal(resumed.opt_state.nu[k], rs.opt_state.nu[k])
                for k in rs.params)
            and state_equal(resumed.env_state, rs.env_state)
            and torch.equal(resumed.key, rs.key))
        saved = checkpoint.restore_params(ckpt_dir, device=dev)
        require(all(bits_equal(saved[k], rs.params[k]) for k in saved),
                "shelves_train: the last checkpoint's params differ")

        # The other two commands, and the checkpoint's evaluation.
        evals = {}
        for policy in ("greedy", "greedy_bfs"):
            evals[policy] = evaluate_policy(
                cfg, policy_fn_for(policy, cfg), EVAL_EPISODES, SEED,
                device=dev)
        fn, init_carry, mask_on = checkpoint_policy_fn(cfg, ckpt_dir,
                                                       device=dev)
        require(mask_on, "evaluate: the meta file did not turn the mask on")
        evals["checkpoint"] = evaluate_policy(
            cfg, fn, EVAL_EPISODES, SEED, init_carry=init_carry, device=dev)
    serve_mlp(cfg, tr, rs)
    os.makedirs(os.path.dirname(METRICS_OUT), exist_ok=True)
    with open(METRICS_OUT, "w") as f:
        f.write(json.dumps({"meta": True, "algo": "ppo", "arch": "mlp",
                            "env": "shelves", "device":
                            torch.cuda.get_device_name(0),
                            "train_config": json.loads(tcfg.to_json())})
                + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)

    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    per_episode = {k: v["mean_deliveries_per_episode"]
                   for k, v in evals.items()}
    emit({"phase": "shelves_train", **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(20, n + 1, 20)},
          "deliveries_91_100": late, "learn_min": SHELVES_LEARN_MIN,
          "resume_from": mid, "resume_bit_equal": resume_equal,
          "eval_episodes": EVAL_EPISODES,
          "eval_deliveries_per_episode": per_episode,
          "eval_mean_episode_return": {k: v["mean_episode_return"]
                                       for k, v in evals.items()},
          "metrics_file": METRICS_OUT})
    require(late >= SHELVES_LEARN_MIN,
            f"shelves_train: deliveries/env-step {late} over updates 91-100 "
            f"is below {SHELVES_LEARN_MIN}")
    require(resume_equal, "shelves_train: the resumed run differs from the "
            "uninterrupted one")
    require(per_episode["greedy_bfs"] > per_episode["greedy"],
            f"evaluate: greedy_bfs does not beat greedy: {per_episode}")
    require(per_episode["checkpoint"] >= per_episode["greedy_bfs"],
            f"evaluate: the checkpoint is below greedy_bfs: {per_episode}")


def shelves_cnn_train_phase(dev, cfg):
    """10 updates of the walled-layout recipe with the CNN policy: the
    shaped K10 on a trained path."""
    tr = make_train(cfg, shelves_tcfg(), arch="cnn", device=dev)
    seen = []
    rs, out = run_updates(
        tr, SHELVES_CNN_UPDATES, "shelves_cnn_train", dev,
        lambda u, rs, m: seen.append(float(m["reward_per_step"])))
    serve_mlp(cfg, tr, rs)
    emit({"phase": "shelves_cnn_train", **out, "raw_reward_per_step": seen})


def global_tcfg():
    """The full shelves recipe's TrainConfig with global observations: the
    walled recipe at the JAX record's 2048 envs (docs/RESULTS.md:554)."""
    return shelves_tcfg().replace(num_envs=GLOBAL_B)


def shelves_global_train_phase(dev, cfg):
    """The first 100 updates of the full shelves recipe with
    ``--global-obs`` through the kernels, a checkpoint at the end, then
    its evaluation (masked argmax and sampled) against ``greedy_bfs`` and
    the policy served from the checkpoint directory."""
    tcfg, n = global_tcfg(), GLOBAL_UPDATES
    tr = make_train(cfg, tcfg, device=dev)
    rows = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_policy_meta(ckpt_dir, cfg, tcfg, arch="mlp")

        def hook(u, rs, m):
            rows.append({"step": u, **{k: float(v) for k, v in m.items()}})
            if u == n:
                checkpoint.save(ckpt_dir, u, rs)

        rs, out = run_updates(tr, n, "shelves_global_train", dev, hook)
        evals = {"greedy_bfs": evaluate_policy(
            cfg, policy_fn_for("greedy_bfs", cfg), EVAL_EPISODES, SEED,
            device=dev)}
        for label, sample in (("checkpoint_argmax", False),
                              ("checkpoint_sampled", True)):
            fn, init_carry, mask_on = checkpoint_policy_fn(
                cfg, ckpt_dir, sample=sample, device=dev)
            require(mask_on, "evaluate: the meta file did not turn the mask "
                    "on")
            evals[label] = evaluate_policy(cfg, fn, EVAL_EPISODES, SEED,
                                           init_carry=init_carry, device=dev)
        # The directory describes itself: the env with its global view, the
        # model's widths and the mask come from the meta file.
        served = Policy.from_checkpoint(ckpt_dir, device=dev)
        require(served.env_cfg.global_obs and served.mask_actions
                and served.env_cfg.obs_dim == cfg.obs_dim,
                "serve: the checkpoint's meta lost the global view")
        acts, _ = served.compute_actions(rs.obs)
        with torch.no_grad():
            logits, _ = apply(rs.params, rs.obs)
        require(torch.equal(acts, first_argmax(logits, -1).to(torch.int32)),
                "serve: the checkpoint's policy differs from the trained one")
    os.makedirs(os.path.dirname(GLOBAL_METRICS_OUT), exist_ok=True)
    with open(GLOBAL_METRICS_OUT, "w") as f:
        f.write(json.dumps({"meta": True, "algo": "ppo", "arch": "mlp",
                            "env": "shelves", "global_obs": True, "device":
                            torch.cuda.get_device_name(0),
                            "train_config": json.loads(tcfg.to_json())})
                + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)

    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    per_episode = {k: v["mean_deliveries_per_episode"]
                   for k, v in evals.items()}
    used = ("argmax" if per_episode["checkpoint_argmax"]
            > per_episode["greedy_bfs"] else "sampled")
    emit({"phase": "shelves_global_train", "obs_dim": cfg.obs_dim, **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(20, n + 1, 20)},
          "deliveries_91_100": late, "learn_min": GLOBAL_LEARN_MIN,
          "eval_episodes": EVAL_EPISODES,
          "eval_deliveries_per_episode": per_episode,
          "eval_gate_used": used, "metrics_file": GLOBAL_METRICS_OUT})
    require(late >= GLOBAL_LEARN_MIN,
            f"shelves_global_train: deliveries/env-step {late} over updates "
            f"91-100 is below {GLOBAL_LEARN_MIN}")
    require(per_episode[f"checkpoint_{used}"] > per_episode["greedy_bfs"],
            f"evaluate: the global-obs checkpoint is below greedy_bfs: "
            f"{per_episode}")


def cnn_global_train_phase(dev, cfg):
    """5 config-4 updates of the CNN policy on global observations (K10 on
    the whole map + K11/K12), after one update through the kernels and one
    through the plain path from the same state, whose metrics must
    agree."""
    tr = make_train(cfg, TrainConfig(num_updates=CNN_SCHEDULE), arch="cnn",
                    device=dev)
    first = first_update_vs_plain(tr, dev, "cnn_global_train")
    rs, out = run_updates(tr, CNN_GLOBAL_UPDATES, "cnn_global_train", dev)
    serve_mlp(cfg, tr, rs)
    emit({"phase": "cnn_global_train", "obs_dim": cfg.obs_dim, **out,
          "first_update_kernel_vs_plain": first, "tol": STEP_METRIC_TOL})


def cnn_global_groups_train_phase(dev, cfg):
    """3 config-4 updates of ``--arch cnn --global-obs --policy-groups
    0,1,0,1``: K10 on the 9x9 map with two groups, the plain learner
    through both CNNs at S = 9; the first update against the plain path's,
    then the trained policy served."""
    tr = make_train(cfg, TrainConfig(num_updates=CNN_SCHEDULE), arch="cnn",
                    device=dev, policy_groups=CONFIG4_GROUPS)
    first = first_update_vs_plain(tr, dev, "cnn_global_groups_train")
    rs, out = run_updates(tr, CNN_GLOBAL_GROUPS_UPDATES,
                          "cnn_global_groups_train", dev, backends=PLAIN_GRAD)
    serve_mlp(cfg, tr, rs)
    emit({"phase": "cnn_global_groups_train", "obs_dim": cfg.obs_dim,
          "policy_groups": CONFIG4_GROUPS, **out,
          "first_update_kernel_vs_plain": first, "tol": STEP_METRIC_TOL})


def first_update_vs_plain(tr, dev, what):
    """One update through the kernels and one through the plain path from
    the same state: their metrics, which must agree."""
    rs0 = tr.init(rng.prng_key(0, dev))
    _, mk = tr.train_step(rs0)
    _, mp = tr.plain_step(rs0)
    rtol, atol = STEP_METRIC_TOL
    first = {k: (float(mk[k]), float(mp[k])) for k in mk}
    require(all(abs(a - b) <= atol + rtol * abs(b) for a, b in first.values()),
            f"{what}: the first update differs from the plain path's: {first}")
    return first


def hidden256_tcfg():
    return TrainConfig(num_updates=TRAIN_SCHEDULE, hidden_dim=WIDE_HIDDEN)


def hidden256_train_phase(dev, cfg):
    """3 config-4 PPO updates at hidden 256: K2's stage kernels and K3/K4
    at that width. First one update through the kernels and one through the plain
    path from the same state, whose metrics must agree."""
    tr = make_train(cfg, hidden256_tcfg(), device=dev)
    first = first_update_vs_plain(tr, dev, "hidden256_train")
    rs, out = run_updates(tr, WIDE_UPDATES, "hidden256_train", dev)
    serve_mlp(cfg, tr, rs)
    emit({"phase": "hidden256_train", "hidden_dim": WIDE_HIDDEN, **out,
          "first_update_kernel_vs_plain": first, "tol": STEP_METRIC_TOL})


def groups_tcfg():
    """The walled recipe with policy groups, as the train CLI builds it from
    ``--policy-groups 0,0,0,1,1,1`` at the JAX record's 2048 envs (2048 x
    16 env-steps per update in ``runs/r5_curves/shelves_groups_fused.jsonl``,
    docs/RESULTS.md:260-266)."""
    return shelves_tcfg().replace(num_envs=GROUPS_B)


def groups_model(cfg, groups, dev, shape=HIDDEN):
    """A seeded ``MultiPolicyActorCritic`` of config 4's MLPs."""
    return make_multi_policy_model(
        cfg, groups, hidden_dim=shape[0], num_layers=shape[1],
        generator=torch.Generator().manual_seed(SEED), device=dev)


def groups_check(dev, cfg, shelves):
    """K2 with policy groups at config 4 (interleaved) and on the shelves
    recipe's shapes (masked, shaped, 2048 envs): a step's rows group by
    group, each tile of its stage kernels one group's; K3 / K4 with groups
    on a trajectory of the recipe. Returns the (K2, K3, K4) results at the
    recipe's shapes for the kernels line."""
    k2_check(dev, "medium_groups", cfg, groups_model(cfg, CONFIG4_GROUPS, dev),
             phase="groups_check", groups=CONFIG4_GROUPS)
    k2 = k2_check(dev, "shelves_groups", shelves,
                  groups_model(shelves, GROUPS, dev), True, shaped=True,
                  B=GROUPS_B, phase="groups_check", groups=GROUPS)
    k3 = k3_check(dev, shelves, tcfg=groups_tcfg(), name="shelves_groups",
                  groups=GROUPS)
    k4 = k4_check(dev, shelves, tcfg=groups_tcfg(), name="shelves_groups",
                  groups=GROUPS)
    mlp_stage_check(dev, shelves, name="shelves_groups", tcfg=groups_tcfg(),
                    groups=GROUPS)
    return k2, k3, k4


def shelves_groups_train_phase(dev, cfg):
    """The first update of the walled recipe with policy groups against the
    plain path's, then its first 100 updates through the kernels, a
    checkpoint at the end served by ``Policy.from_checkpoint``."""
    tcfg, n = groups_tcfg(), GROUPS_UPDATES
    tr = make_train(cfg, tcfg, device=dev, policy_groups=GROUPS)
    first = first_update_vs_plain(tr, dev, "shelves_groups_train")
    rows = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_policy_meta(ckpt_dir, cfg, tcfg, arch="mlp",
                          policy_groups=GROUPS)

        def hook(u, rs, m):
            rows.append({"step": u, **{k: float(v) for k, v in m.items()}})
            if u == n:
                checkpoint.save(ckpt_dir, u, rs)

        rs, out = run_updates(tr, n, "shelves_groups_train", dev, hook)
        # The trained model served, and the directory served by itself.
        tr.model.load_state_dict(rs.params)
        gids = torch.tensor(GROUPS, device=dev)
        with torch.no_grad():
            logits, _ = apply(rs.params, rs.obs, gids)
        want = first_argmax(logits, -1).to(torch.int32)
        acts, _ = Policy(cfg, tr.model, policy_groups=GROUPS).compute_actions(
            rs.obs)
        served = Policy.from_checkpoint(ckpt_dir, device=dev)
        acts_ckpt, _ = served.compute_actions(rs.obs)
        require(served.policy_groups == GROUPS and served.mask_actions,
                "serve: the checkpoint's meta lost the groups or the mask")
        require(torch.equal(acts, want) and torch.equal(acts_ckpt, want),
                "serve: the checkpoint's policy differs from the trained one")
    os.makedirs(os.path.dirname(GROUPS_METRICS_OUT), exist_ok=True)
    with open(GROUPS_METRICS_OUT, "w") as f:
        f.write(json.dumps({"meta": True, "algo": "ppo", "arch": "mlp",
                            "env": "shelves", "policy_groups": list(GROUPS),
                            "device": torch.cuda.get_device_name(0),
                            "train_config": json.loads(tcfg.to_json())})
                + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)

    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    emit({"phase": "shelves_groups_train", "policy_groups": GROUPS, **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(20, n + 1, 20)},
          "deliveries_91_100": late, "learn_min": GROUPS_LEARN_MIN,
          "first_update_kernel_vs_plain": first, "tol": STEP_METRIC_TOL,
          "served_actions_equal": True, "metrics_file": GROUPS_METRICS_OUT})
    require(late >= GROUPS_LEARN_MIN,
            f"shelves_groups_train: deliveries/env-step {late} over updates "
            f"91-100 is below {GROUPS_LEARN_MIN}")


def bf16_check(dev, cfg, shelves, shelves_g, medium_g):
    """The learners on bf16 operands against their bf16 twins: K3 / K4 at
    config 4, D = 611 and with groups; K8 / K9 for the LSTM and the GRU;
    K11 / K12 on the 5x5 window and the 9x9 map. Returns config 4's
    results (the GRU's for K8 / K9) for the kernels line."""
    out = {"ppo_sgd_phase_bf16": k3_check(dev, cfg, bf16=True),
           "ppo_minibatch_grads_bf16": k4_check(dev, cfg, bf16=True)}
    for c, kw in ((shelves_g, dict(tcfg=global_tcfg(),
                                   name="shelves_global")),
                  (shelves, dict(tcfg=groups_tcfg(), name="shelves_groups",
                                 groups=GROUPS))):
        k3_check(dev, c, bf16=True, **kw)
        k4_check(dev, c, bf16=True, **kw)
        mlp_stage_check(dev, c, bf16=True, **kw)
    mlp_stage_check(dev, cfg, bf16=True)
    mlp_stage_check(dev, cfg, bf16=True, ragged=True)
    emit_bound("K8 lstm bf16", "config4",
               k8_check(dev, cfg, "lstm", bf16=True))
    emit_bound("K9 lstm bf16", "config4",
               k9_check(dev, cfg, "lstm", bf16=True))
    out["ppo_rnn_sgd_phase_bf16"] = k8_check(dev, cfg, "gru", bf16=True)
    out["ppo_rnn_minibatch_grads_bf16"] = k9_check(dev, cfg, "gru", bf16=True)
    for arch in ("gru", "lstm"):
        rnn_stage_check(dev, cfg, arch, bf16=True)
        rnn_stage_check(dev, cfg, arch, bf16=True, ragged=True)
    out["ppo_cnn_sgd_phase_bf16"] = k3_check(dev, cfg, cnn=True, bf16=True)
    out["ppo_cnn_minibatch_grads_bf16"] = k4_check(dev, cfg, cnn=True,
                                                   bf16=True)
    k3_check(dev, medium_g, cnn=True, name="medium_global", bf16=True)
    k4_check(dev, medium_g, cnn=True, name="medium_global", bf16=True)
    cnn_stage_check(dev, cfg, bf16=True)
    cnn_stage_check(dev, cfg, bf16=True, ragged=True)
    cnn_stage_check(dev, medium_g, name="medium_global", bf16=True)
    return out


def gru_bf16_train_phase(dev, cfg):
    """``--arch gru --model-dtype bfloat16`` at config 4: the first update
    against the plain path's, then the first 40 updates of a 300-update run
    (the schedule of ``runs/r3_curves/config4_gru_fast.jsonl``) through K7
    and K8/K9 on bf16 operands, the carry bf16 after every update, the
    trained policy served with its bf16 carry; the curve to
    ``runs/torch_gru_bf16/metrics.jsonl``."""
    tcfg = TrainConfig(num_updates=RNN_SCHEDULE, model_dtype=BF16)
    tr = make_train_rnn(cfg, tcfg, "gru", device=dev)
    first = first_update_vs_plain(tr, dev, "gru_bf16_train")
    rows = []

    def hook(u, rs, m):
        require(rs.carry.dtype == torch.bfloat16,
                f"gru_bf16_train: the carry left bf16 at update {u}")
        rows.append({"step": u, **{k: float(v) for k, v in m.items()}})

    rs, out = run_updates(tr, RNN_UPDATES, "gru_bf16_train", dev, hook)
    serve_rnn(cfg, tr, rs)
    os.makedirs(os.path.dirname(BF16_METRICS_OUT), exist_ok=True)
    with open(BF16_METRICS_OUT, "w") as f:
        f.write(json.dumps({"meta": True, "algo": "ppo", "arch": "gru",
                            "env": "medium", "model_dtype": BF16,
                            "device": torch.cuda.get_device_name(0),
                            "train_config": json.loads(tcfg.to_json())})
                + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)
    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    emit({"phase": "gru_bf16_train", **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(10, RNN_UPDATES + 1, 10)},
          "deliveries_31_40": late, "learn_min": RNN_LEARN_MIN,
          "first_update_kernel_vs_plain": first, "tol": STEP_METRIC_TOL,
          "metrics_file": BF16_METRICS_OUT})
    require(late >= RNN_LEARN_MIN,
            f"gru_bf16_train: deliveries/env-step {late} over updates "
            f"31-40 is below {RNN_LEARN_MIN}")


def ff_bf16_train_phase(dev, cfg, arch):
    """10 config-4 updates of the MLP (``arch="mlp"``: K2 + K3/K4) or the
    CNN (K10 + K11/K12) at ``--model-dtype bfloat16``, after one update
    through the kernels and one through the plain path from the same
    state, whose metrics must agree; the trained policy served."""
    what = "ppo_bf16_train" if arch == "mlp" else "cnn_bf16_train"
    schedule = CNN_SCHEDULE if arch == "cnn" else TRAIN_SCHEDULE
    tr = make_train(cfg, TrainConfig(num_updates=schedule, model_dtype=BF16),
                    arch=arch, device=dev)
    first = first_update_vs_plain(tr, dev, what)
    rs, out = run_updates(tr, BF16_FF_UPDATES, what, dev)
    serve_mlp(cfg, tr, rs)
    emit({"phase": what, **out, "first_update_kernel_vs_plain": first,
          "tol": STEP_METRIC_TOL})


def cnn_groups_model(cfg, groups, dev, hidden=HIDDEN[0]):
    """A seeded ``MultiPolicyActorCritic`` of config 4's CNNs."""
    return make_multi_policy_model(
        cfg, groups, "cnn", hidden_dim=hidden,
        generator=torch.Generator().manual_seed(SEED), device=dev)


def k10_groups_check(dev, cfg, shelves):
    """K10 with policy groups against the plain multi-policy CNN at config
    4 ``(0, 1, 0, 1)`` and on the shelves recipe's shapes (``(0, 0, 0, 1,
    1, 1)``, masked, shaped, 2048 envs); then at the maps whose rows only
    one group at a time fits: one policy per agent at config 4 ``(0, 1, 2,
    3)`` (the ``cnn_per_agent_train`` path's shapes), two groups on the 9x9
    global view (``cnn_global_groups_train``'s) and one policy per agent on
    the 8-agent preset, masked and shaped, each launched twice on the same
    inputs, bit-equal; an ungrouped K10 launch after them bit-equal to one
    before them. Returns the results of the shelves recipe, of one policy
    per agent and of the global view for the kernels line."""
    model = cnn_model(cfg, dev)
    state, _ = reset_envs(cfg, CHECK_B, SEED + 1, dev)
    _, u, pick, drop, _ = rng.batched_step_draws(state.key, cfg, SLICE_T)
    _, g = rng.batched_gumbel_stream(rng.prng_key(SEED + 2, dev), SLICE_T,
                                     (5, CHECK_B * cfg.num_agents))
    before = act.act_cnn_steps(cfg, model, state, u, pick, drop, g)
    k2_check(dev, "medium_cnn_groups", cfg,
             cnn_groups_model(cfg, CONFIG4_GROUPS, dev),
             phase="k10_groups_check", groups=CONFIG4_GROUPS)
    out = k2_check(dev, "shelves_cnn_groups", shelves,
                   cnn_groups_model(shelves, GROUPS, dev), True, shaped=True,
                   B=GROUPS_B, phase="k10_groups_check", groups=GROUPS)
    per_agent = k2_check(dev, "medium_cnn_per_agent", cfg,
                         cnn_groups_model(cfg, PER_AGENT, dev),
                         phase="k10_groups_check", groups=PER_AGENT,
                         rerun=True)
    medium_g = cfg.replace(global_obs=True)
    glob = k2_check(dev, "medium_global_cnn_groups", medium_g,
                    cnn_groups_model(medium_g, CONFIG4_GROUPS, dev),
                    phase="k10_groups_check", groups=CONFIG4_GROUPS,
                    rerun=True)
    large = large_config()
    eight = tuple(range(large.num_agents))
    emit_bound("K10 groups", "large_cnn_per_agent", k2_check(
        dev, "large_cnn_per_agent", large, cnn_groups_model(large, eight,
                                                            dev), True,
        shaped=True, phase="k10_groups_check", groups=eight, rerun=True))
    after = act.act_cnn_steps(cfg, model, state, u, pick, drop, g)
    torch.cuda.synchronize()
    require(state_equal(before[0], after[0]) and all(
        bits_equal(a, b) for a, b in zip(before[1:], after[1:])),
        "K10: an ungrouped launch after the grouped ones gave other bits")
    emit({"phase": "k10_groups_check", "config": "medium",
          "ungrouped_bits_equal_after_grouped": True})
    return out, per_agent, glob


def grouped_cnn_curve(dev, cfg, tcfg, groups, n, what, env, metrics_out,
                      learn_min):
    """The first update of the grouped-CNN trainer against the plain path's,
    then its first ``n`` updates (K10 with groups + the plain learner), a
    checkpoint at the end served by ``Policy.from_checkpoint``, the curve to
    ``metrics_out``, a learning check on deliveries per env-step over the
    last 10 updates."""
    tr = make_train(cfg, tcfg, arch="cnn", device=dev, policy_groups=groups)
    first = first_update_vs_plain(tr, dev, what)
    rows = []
    with tempfile.TemporaryDirectory() as ckpt_dir:
        write_policy_meta(ckpt_dir, cfg, tcfg, arch="cnn",
                          policy_groups=groups)

        def hook(u, rs, m):
            rows.append({"step": u, **{k: float(v) for k, v in m.items()}})
            if u == n:
                checkpoint.save(ckpt_dir, u, rs)

        rs, out = run_updates(tr, n, what, dev, hook, backends=PLAIN_GRAD)
        gids = torch.tensor(groups, device=dev)
        with torch.no_grad():
            logits, _ = apply(rs.params, rs.obs, gids)
        want = first_argmax(logits, -1).to(torch.int32)
        served = Policy.from_checkpoint(ckpt_dir, device=dev)
        acts, _ = served.compute_actions(rs.obs)
        require(served.policy_groups == groups and served.arch == "cnn"
                 and served.mask_actions == tcfg.mask_actions,
                 "serve: the checkpoint's meta lost the CNN, groups or mask")
        require(torch.equal(acts, want),
                "serve: the checkpoint's policy differs from the trained one")
    os.makedirs(os.path.dirname(metrics_out), exist_ok=True)
    with open(metrics_out, "w") as f:
        f.write(json.dumps({"meta": True, "algo": "ppo", "arch": "cnn",
                            "env": env, "policy_groups": list(groups),
                            "backends": tr.backends,
                            "device": torch.cuda.get_device_name(0),
                            "train_config": json.loads(tcfg.to_json())})
                + "\n")
        f.writelines(json.dumps(r) + "\n" for r in rows)
    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    emit({"phase": what, "policy_groups": groups, **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(10, n + 1, 10)},
          f"deliveries_{n - 9}_{n}": late, "learn_min": learn_min,
          "first_update_kernel_vs_plain": first, "tol": STEP_METRIC_TOL,
          "served_actions_equal": True, "metrics_file": metrics_out})
    require(late >= learn_min,
            f"{what}: deliveries/env-step {late} over updates {n - 9}-{n} is "
            f"below {learn_min}")


def shelves_cnn_groups_train_phase(dev, cfg):
    """The walled recipe with ``--arch cnn --policy-groups 0,0,0,1,1,1`` at
    2048 envs: grouped K10 acting and the plain learner, 100 updates of its
    300-update schedule, the curve to
    ``runs/torch_shelves_cnn_groups/metrics.jsonl``."""
    grouped_cnn_curve(dev, cfg, groups_tcfg(), GROUPS, CNN_GROUPS_UPDATES,
                      "shelves_cnn_groups_train", "shelves",
                      CNN_GROUPS_METRICS_OUT, CNN_GROUPS_LEARN_MIN)


def cnn_per_agent_train_phase(dev, cfg):
    """Config 4 with ``--arch cnn --policy-groups 0,1,2,3``: one CNN per
    agent, K10 acting with one group per agent and the plain learner, 50
    updates of its 300-update schedule (``cnn_train``'s), the curve to
    ``runs/torch_cnn_per_agent/metrics.jsonl``."""
    grouped_cnn_curve(dev, cfg, TrainConfig(num_updates=CNN_SCHEDULE),
                      PER_AGENT, CNN_PER_AGENT_UPDATES, "cnn_per_agent_train",
                      "medium", CNN_PER_AGENT_METRICS_OUT,
                      CNN_PER_AGENT_LEARN_MIN)


def repro_check(dev, cfg):
    """The plain CNN learner on the card gives the same bits on every run:
    5 updates of the grouped-CNN shelves recipe twice from ``PRNGKey(0)``,
    params, Adam moments, env state and key bit-equal; then a run saved at
    update 3, restored into a fresh state and run to 5, bit-equal to the
    unbroken run. Both runs' updates timed by CUDA events."""
    tcfg = groups_tcfg()
    tr = make_train(cfg, tcfg, arch="cnn", device=dev, policy_groups=GROUPS)
    require(tr.backends == PLAIN_GRAD, f"repro_check: backends {tr.backends}")

    def run(rs, n, hook=None):
        splits = []
        for u in range(n):
            marks = Marks()
            rs, _ = tr.train_step(rs, mark=marks)
            splits.append(marks.split())
            if hook:
                hook(u + 1, rs)
        return rs, splits

    def same(a, b):
        return (all(bits_equal(a.params[k], b.params[k])
                    and bits_equal(a.opt_state.mu[k], b.opt_state.mu[k])
                    and bits_equal(a.opt_state.nu[k], b.opt_state.nu[k])
                    for k in a.params)
                and state_equal(a.env_state, b.env_state)
                and torch.equal(a.key, b.key))

    with tempfile.TemporaryDirectory() as ckpt_dir:
        def save_at(u, rs):
            if u == REPRO_SAVE:
                checkpoint.save(ckpt_dir, u, rs)

        first, splits = run(tr.init(rng.prng_key(0, dev)), REPRO_UPDATES,
                            save_at)
        second, splits2 = run(tr.init(rng.prng_key(0, dev)), REPRO_UPDATES)
        resumed = checkpoint.restore(ckpt_dir, REPRO_SAVE,
                                     tr.init(rng.prng_key(SEED + 12, dev)))
        resumed, _ = run(resumed, REPRO_UPDATES - REPRO_SAVE)
    rerun_equal, resume_equal = same(first, second), same(first, resumed)
    emit({"phase": "repro_check", "policy_groups": GROUPS, "B": tcfg.num_envs,
          "updates": REPRO_UPDATES, "resume_from": REPRO_SAVE,
          "rerun_bit_equal": rerun_equal, "resume_bit_equal": resume_equal,
          "sgd_ms": [s["sgd"] for s in splits + splits2],
          "update_ms": [s["total"] for s in splits + splits2]})
    require(rerun_equal, "repro_check: two runs of the plain CNN learner "
            "gave other bits")
    require(resume_equal, "repro_check: the resumed run differs from the "
            "unbroken one")


def rllib_cadence_train_phase(dev, cfg):
    """Config 4 with ``--rllib-cadence`` (flat minibatches, a fresh
    partition every epoch): the first 50 updates of an 80-update run through
    K2 and the plain flat SGD phase, then the trained policy served."""
    tcfg = TrainConfig(num_updates=TRAIN_SCHEDULE, minibatch_mode="flat",
                       epoch_shuffle="each")
    tr = make_train(cfg, tcfg, device=dev)
    rs, out = run_updates(tr, TRAIN_UPDATES, "rllib_cadence_train", dev,
                          backends=PLAIN_GRAD)
    serve_mlp(cfg, tr, rs)
    deliveries = out["deliveries_per_env_step"]
    late = sum(deliveries[-10:]) / 10
    emit({"phase": "rllib_cadence_train", **out,
          "deliveries_at": {u: deliveries[u - 1]
                            for u in range(10, TRAIN_UPDATES + 1, 10)},
          "deliveries_41_50": late, "learn_min": RLLIB_LEARN_MIN})
    require(late >= RLLIB_LEARN_MIN,
            f"rllib_cadence_train: deliveries/env-step {late} over updates "
            f"41-50 is below {RLLIB_LEARN_MIN}")


def m4_check(dev, cfg):
    """3 config-4 updates of each learner option that no kernel computes
    (ROADMAP M-4): the acting kernel and the plain learner, each update held
    against ``plain_step`` from the same state (its metrics within
    ``STEP_METRIC_TOL``), the phases timed by CUDA events."""
    adam = dict(num_updates=IMPALA_SCHEDULE, impala_rmsprop=False)
    cases = [
        ("ppo_micro_batches_2", make_train, "mlp",
         TrainConfig(num_updates=TRAIN_SCHEDULE, micro_batches=2)),
        ("ppo_flat_optimizer", make_train, "mlp",
         TrainConfig(num_updates=TRAIN_SCHEDULE, flat_optimizer=True)),
        ("gru_epoch_shuffle_each", make_train_rnn, "gru",
         TrainConfig(num_updates=RNN_SCHEDULE, epoch_shuffle="each")),
        ("impala_micro_batches_2", make_train_impala, "mlp",
         TrainConfig(micro_batches=2, **adam)),
        ("impala_flat_optimizer", make_train_impala, "mlp",
         TrainConfig(flat_optimizer=True, **adam))]
    rtol, atol = STEP_METRIC_TOL
    for name, build_fn, arch, tcfg in cases:
        tr = build_fn(cfg, tcfg, arch=arch, device=dev)
        require(tr.backends == PLAIN_GRAD,
                f"m4_check {name}: backends {tr.backends}")
        rs, splits, worst = tr.init(rng.prng_key(0, dev)), [], 0.0
        for u in range(M4_UPDATES):
            marks = Marks()
            nxt, mk = tr.train_step(rs, mark=marks)
            splits.append(marks.split())
            _, mp = tr.plain_step(rs)
            for k in mk:
                a, b = float(mk[k]), float(mp[k])
                worst = max(worst, abs(a - b) / (atol + rtol * abs(b)))
            rs = nxt
        require(worst <= 1.0, f"m4_check {name}: an update differs from the "
                f"plain path's ({worst} of the tolerance)")
        emit({"phase": "m4_check", "case": name, "backends": tr.backends,
              "updates": M4_UPDATES, "B": tcfg.num_envs,
              "split_ms_median": median_split(splits),
              "worst_metric_vs_plain_in_tol": worst, "tol": STEP_METRIC_TOL})


def step_sync_check(dev, cfg, T=RAGGED_UNROLL, n=7):
    """The host read of ``truncated.any()`` that ``step_autoreset_batch``
    makes each tick of the per-step phase: T config-4 ticks on the same
    actions and the same draws (made beforehand, as the phase makes them;
    no env truncates) through ``engine.step`` and through
    ``step_autoreset_batch``, n runs of each in turns by CUDA events (which
    see the card idle while the host waits on the read); the difference
    of the medians a tick, beside both sides' spread."""
    cfg = cfg.replace(auto_reset=False)
    state, _ = reset_envs(cfg, SLICE_B, SEED + 12, dev)
    actions = torch.randint(0, 5, (T, SLICE_B, cfg.num_agents),
                            generator=torch.Generator().manual_seed(SEED),
                            dtype=torch.int32).to(dev)
    draws = rng.chained_step_draws(state.key, cfg, T)

    def run(step):
        s = state
        for t in range(T):
            s, _ = step(cfg, s, actions[t],
                        rng.StepDraws(*(x[t] for x in draws)))
        return s

    require(state_equal(run(engine.step), run(step_autoreset_batch)),
            "step_sync_check: the auto-reset step moved a state it should "
            "not reset")
    times = {"step": [], "autoreset": []}
    for _ in range(n):
        for name, fn in (("step", engine.step),
                         ("autoreset", step_autoreset_batch)):
            with Timer() as tm:
                run(fn)
            times[name].append(tm.ms)
    plain_ms, reset_ms = median(times["step"]), median(times["autoreset"])
    emit({"phase": "step_sync_check", "B": SLICE_B, "ticks": T, "runs": n,
          "step_ms": sorted(times["step"]),
          "step_autoreset_batch_ms": sorted(times["autoreset"]),
          "host_read_ms_per_tick": (reset_ms - plain_ms) / T})


def step_route_phase(dev, name, cfg, make, tcfg, n, backends, arch="mlp",
                     learn_min=None):
    """A main path where no acting kernel takes the configuration
    (``backends["rollout"] == "step"``: the per-step phase, as the JAX
    trainer acts through its XLA scan): where the learner is a kernel,
    the first update against the plain path's; then ``n`` updates from
    ``PRNGKey(0)``, each split by the trainer's marks (acting, GAE, SGD /
    learner), the trained env-steps/s, the trained policy served; with
    ``learn_min``, a learning check over the last 10 updates."""
    tr = make(cfg, tcfg, arch=arch, device=dev)
    require(tr.backends == backends,
            f"{name}: backends {tr.backends}, expected {backends}")
    kernel = backends["grad"] == "cuda"
    first = first_update_vs_plain(tr, dev, name) if kernel else None
    rs, out = run_updates(tr, n, name, dev, backends=backends,
                          plain_n=3 if kernel else 0)
    (serve_rnn if arch in ("gru", "lstm") else serve_mlp)(cfg, tr, rs)
    line = {"phase": name, "arch": arch, "obs_dim": cfg.obs_dim,
            "model_dtype": tcfg.model_dtype, **out}
    if kernel:
        line.update(first_update_kernel_vs_plain=first, tol=STEP_METRIC_TOL)
    if learn_min is not None:
        late = sum(out["deliveries_per_env_step"][-10:]) / 10
        line.update(deliveries_last_10=late, learn_min=learn_min)
    emit(line)
    if learn_min is not None:
        require(late >= learn_min,
                f"{name}: deliveries/env-step {late} over the last 10 "
                f"updates is below {learn_min}")


def step_route_paths(dev, cfg, shelves, shelves_g, medium_g):
    """The main paths of the per-step acting phase: ``(name, fn, kernels
    that must launch, kernels that must not)`` for ``main_path``."""
    adam = dict(num_updates=IMPALA_SCHEDULE, impala_rmsprop=False)
    shelves_rnn = TrainConfig(num_updates=RNN_SCHEDULE, mask_actions=True,
                              shaping_coef=SHAPING[0], gamma=SHAPING[1],
                              bootstrap_truncated=True)
    cases = [
        # name, env, trainer, TrainConfig, arch, backends, learner kernels
        ("ragged_train", cfg, make_train, TrainConfig(
            num_updates=TRAIN_SCHEDULE, unroll_length=RAGGED_UNROLL), "mlp",
         STEP_KERNEL, ["ppo_sgd_phase", "ppo_minibatch_grads"]),
        ("impala_ragged_train", cfg, make_train_impala, TrainConfig(
            unroll_length=RAGGED_UNROLL, **adam), "mlp", STEP_KERNEL,
         ["impala_sgd_phase", "impala_minibatch_grads", *K6_STAGES]),
        ("rnn_global_train", medium_g, make_train_rnn,
         TrainConfig(num_updates=RNN_SCHEDULE), "gru", STEP_KERNEL,
         ["ppo_rnn_sgd_phase", "ppo_rnn_minibatch_grads"]),
        ("rnn_shelves_train", shelves, make_train_rnn, shelves_rnn, "gru",
         STEP_KERNEL, ["ppo_rnn_sgd_phase", "ppo_rnn_minibatch_grads"]),
        ("impala_global_train", shelves_g, make_train_impala, TrainConfig(
            num_envs=GLOBAL_B, mask_actions=True, **adam), "mlp",
         STEP_KERNEL, ["impala_sgd_phase", "impala_minibatch_grads",
                       *K6_STAGES]),
        ("impala_bf16_train", cfg, make_train_impala,
         TrainConfig(model_dtype=BF16, **adam), "mlp", STEP_PLAIN, []),
        ("shelves_cnn_global_train", shelves_g, make_train, global_tcfg(),
         "cnn", STEP_PLAIN, []),
        ("attn_train", cfg, make_train, TrainConfig(
            num_updates=TRAIN_SCHEDULE), "attn", STEP_PLAIN, []),
        ("impala_cnn_train", cfg, make_train_impala, TrainConfig(**adam),
         "cnn", STEP_PLAIN, [])]
    acting = ["ppo_rollout", "ppo_rollout_cnn", "ppo_rnn_rollout"]
    learners = ["ppo_sgd_phase", "impala_sgd_phase", "ppo_rnn_sgd_phase",
                "ppo_cnn_sgd_phase"]
    out = []
    for name, env, make, tcfg, arch, backends, kernels in cases:
        n = RAGGED_UPDATES if name == "ragged_train" else STEP_UPDATES[name]
        gate = RAGGED_LEARN_MIN if name == "ragged_train" else None
        fn = functools.partial(step_route_phase, dev, name, env, make, tcfg,
                               n, backends, arch, gate)
        out.append((name, fn, kernels,
                    acting + [k for k in learners if k not in kernels]))
    return out


# ---- the utilities, the dict API and the sweeps (ROADMAP M-6, M-5, M-9) --

# The pieces of an update that the trainers annotate (utils.profiling), as
# acting_split reads them from one update's trace.
SPLIT_PIECES = ("permutation", "load_state_dict", "draws", "act_kernel",
                "boundary_reset", "boundary_reset_host_read", "bootstrap",
                "last_value", "gae", "learner", "metrics", "policy", "tick",
                "tick_host_read")
SPLIT_MIN_SHARE = 0.9   # of an update's host time the pieces must cover
SWEEP_B, SWEEP_UPDATES = 256, 10  # each sweep trial: envs, updates a seed
SWEEP_GRID = {"learning_rate": [3e-4, 1e-3]}
SWEEP_SEEDS, ASHA_RUNGS = 2, (2, 4)
PBT_SPACE = {"learning_rate": {"loguniform": [1e-4, 1e-2]},
             "entropy_coef": {"uniform": [0.005, 0.02]}}
PBT_POPULATION, PBT_INTERVAL, PBT_INTERVALS = 4, 3, 2
DICT_SEED = 11          # the dict-API episodes' env key: fold_in(PRNGKey, 0)
MODULE_SECONDS = {}     # each of these phases' wall seconds


@functools.lru_cache(maxsize=None)
def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    return nvidia_smi()


def timed_phase(name):
    """Records the decorated phase's wall seconds in MODULE_SECONDS."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                MODULE_SECONDS[name] = time.perf_counter() - t0
        return run
    return wrap


@timed_phase("acting_split")
def acting_split(dev, cfg):
    """One update of config-4 ``train``, ``impala_train`` and
    ``ragged_train`` (the per-step route) after 2 of warm-up, under
    ``utils.profiling.trace``: each annotated piece's host ms, device ms,
    ``aten::`` calls and kernel launches from the trace file, the update's
    host time, the share the pieces cover (at least SPLIT_MIN_SHARE) and
    the device work still queued when ``train_step`` returns."""
    paths = {
        "train": (make_train, TrainConfig(num_updates=TRAIN_SCHEDULE)),
        "impala_train": (make_train_impala, TrainConfig(
            num_updates=IMPALA_SCHEDULE, impala_rmsprop=False)),
        "ragged_train": (make_train, TrainConfig(
            num_updates=TRAIN_SCHEDULE, unroll_length=RAGGED_UNROLL))}
    for name, (make, tcfg) in paths.items():
        tr = make(cfg, tcfg, device=dev)
        rs = tr.init(rng.prng_key(0, dev))
        for _ in range(2):
            rs, _ = tr.train_step(rs)
        with tempfile.TemporaryDirectory() as d:
            torch.cuda.synchronize()
            with profiling.trace(d, dev):
                t0 = time.perf_counter()
                with torch.profiler.record_function("update"):
                    rs, m = tr.train_step(rs)
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            path = profiling.trace_file(d)
            size = os.path.getsize(path)
            require(size > 0, f"acting_split {name}: an empty trace")
            split = profiling.range_split(path, SPLIT_PIECES, "update")
        require(all(bool(torch.isfinite(v)) for v in m.values()),
                f"acting_split {name}: non-finite metrics")
        emit({"phase": "acting_split", "path": name, "card": card(),
              "backends": tr.backends, "B": tcfg.num_envs,
              "T": tcfg.unroll_length, "update_host_ms": (t1 - t0) * 1e3,
              "drain_ms": (t2 - t1) * 1e3, "trace_file_bytes": size,
              "min_share": SPLIT_MIN_SHARE, **split})
        require(split["covered_share"] >= SPLIT_MIN_SHARE,
                f"acting_split {name}: the pieces cover "
                f"{split['covered_share']:.3f} of the update")


@timed_phase("invariants")
def invariants_check(dev, cfg, model):
    """``utils.debug.check_state_invariants`` on every env after a K1
    episode at B = 131072 and after a K2 chunk at config 4; false on the one
    env of a copy where two agents stand on one cell."""
    state, _ = reset_envs(cfg, EPISODE_B, SEED + 20, dev)
    final, _, _ = rollout.greedy_rollout(cfg, state, cfg.max_steps)
    k1 = check_state_invariants(cfg, final)
    require(k1.shape == (EPISODE_B,) and bool(k1.all()),
            f"invariants: {int((~k1).sum())} envs broken after a K1 episode")
    state, _ = reset_envs(cfg, SLICE_B, SEED + 21, dev)
    new, _, _, _ = act.ppo_rollout(cfg, model, state, SLICE_T,
                                   rng.prng_key(SEED + 22, dev))
    k2 = check_state_invariants(cfg, new)
    require(bool(k2.all()),
            f"invariants: {int((~k2).sum())} envs broken after a K2 chunk")
    broken = new.replace(agent_pos=new.agent_pos.clone())
    broken.agent_pos[7, 1] = broken.agent_pos[7, 0]
    bad = check_state_invariants(cfg, broken)
    require(not bool(bad[7]) and int(bad.sum()) == SLICE_B - 1,
            "invariants: two agents on one cell went unseen")
    emit({"phase": "invariants", "k1_envs": EPISODE_B, "k1_ok": int(k1.sum()),
          "k2_envs": SLICE_B, "k2_ok": int(k2.sum()),
          "broken_copy_ok": int(bad.sum())})


def wrapper_episode(env, act_fn, key):
    """One episode of the dict-API wrapper from the env key ``key``:
    per-agent float32 returns summed as ``evaluate_policy`` sums them, the
    deliveries and the steps."""
    obs, _ = env.reset(options={"key": key})
    ret = np.zeros((1, env.cfg.num_agents), np.float32)
    deliveries, steps = 0, 0
    while True:
        obs, rew, term, trunc, info = env.step(act_fn(obs))
        ret += np.array([[rew[a] for a in env.possible_agents]], np.float32)
        deliveries += sum(info[a]["delivered"] for a in env.possible_agents)
        steps += 1
        if trunc["__all__"] or term["__all__"]:
            return ret, deliveries, steps


def same_episode(what, ret, deliveries, ev):
    """The wrapper's episode against ``evaluate_policy``'s one episode."""
    got = {"mean_agent_return": float(ret.mean()),
           "mean_episode_return": float(ret.sum(-1).mean()),
           "mean_deliveries_per_episode": float(deliveries)}
    require(all(got[k] == ev[k] for k in got),
            f"dict_api {what}: {got} against evaluate_policy's {ev}")
    return got


@timed_phase("dict_api")
def dict_api_check(dev, cfg):
    """The dict API on the card (nothing of gymnasium, pettingzoo or PIL):
    a 128-step episode of ``registry.make_env("warehouse-medium")`` under
    ``greedy_bfs``, its ANSI render and env-steps/s; a checkpoint that 3
    config-4 updates write, served by ``Policy.compute_actions_dict`` for
    an episode; each episode's returns equal to ``evaluate_policy``'s on the
    same env key and policy."""
    env = registry.make_env("warehouse-medium", device=dev)
    key = rng.fold_in(rng.prng_key(DICT_SEED, dev), 0)

    def bfs(obs):
        acts = greedy_bfs_actions(cfg, env.state)[0].cpu().numpy()
        return {a: int(acts[i]) for i, a in enumerate(env.possible_agents)}

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ret, deliveries, steps = wrapper_episode(env, bfs, key)
    wall = time.perf_counter() - t0
    require(steps == cfg.max_steps, f"dict_api: {steps} steps")
    bfs_ev = same_episode("greedy_bfs", ret, deliveries, evaluate_policy(
        cfg, policy_fn_for("greedy_bfs", cfg), 1, seed=DICT_SEED,
        device=dev))
    text = env.render()
    require(len(text.splitlines()) == cfg.height + 3
            and text.startswith(f"t={cfg.max_steps}"), "dict_api: render")

    tcfg = TrainConfig(num_updates=TRAIN_SCHEDULE)
    tr = make_train(cfg, tcfg, device=dev)
    rs, _ = tr.train_many(tr.init(rng.prng_key(0, dev)), 3)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 3, rs)
        write_policy_meta(d, cfg, tcfg, arch="mlp")
        policy = Policy.from_checkpoint(d, device=dev)
        ev = evaluate_policy(cfg, checkpoint_policy_fn(cfg, d, device=dev)[0],
                             1, seed=DICT_SEED, device=dev)
    ret, deliveries, _ = wrapper_episode(
        env, lambda obs: policy.compute_actions_dict(env, obs)[0], key)
    ckpt_ev = same_episode("checkpoint", ret, deliveries, ev)
    oracle = oracle_backend_check(dev, key)
    emit({"phase": "dict_api", "env": "warehouse-medium", "steps": steps,
          "env_steps_per_sec": steps / wall, "episode_s": wall,
          "greedy_bfs": bfs_ev, "checkpoint": ckpt_ev,
          "render_lines": len(text.splitlines()), "oracle_backend": oracle})


def oracle_backend_check(dev, key):
    """``registry.make_env("warehouse-medium", backend="oracle")`` (the
    NumPy oracle, M-10) against ``backend="torch"`` on the card over one
    episode from the env key ``key``, the oracle's ``greedy_bfs`` acting
    for both: observations, rewards, terminated / truncated and infos
    equal at every step, and the renders."""
    envs = {b: registry.make_env("warehouse-medium", backend=b, device=dev)
            for b in ("oracle", "torch")}
    cfg = envs["torch"].cfg
    outs = {b: e.reset(options={"key": key}) for b, e in envs.items()}
    steps, deliveries, walls = 0, 0, {b: 0.0 for b in envs}
    while True:
        obs = {b: o[0] for b, o in outs.items()}
        require(all(np.array_equal(obs["oracle"][a], obs["torch"][a])
                    for a in envs["torch"].possible_agents),
                f"dict_api oracle: observations differ at step {steps}")
        require(envs["oracle"].render() == envs["torch"].render(),
                f"dict_api oracle: renders differ at step {steps}")
        acts = oracle_mod.greedy_bfs_actions(cfg, envs["oracle"].state)
        act = {a: int(acts[i])
               for i, a in enumerate(envs["torch"].possible_agents)}
        for b, e in envs.items():
            t0 = time.perf_counter()
            outs[b] = e.step(act)
            walls[b] += time.perf_counter() - t0
        require(outs["oracle"][1:] == outs["torch"][1:],
                f"dict_api oracle: rewards, dones or infos differ at step "
                f"{steps}")
        steps += 1
        deliveries += sum(i["delivered"] for i in outs["torch"][4].values())
        if outs["torch"][3]["__all__"]:
            break
    require(steps == cfg.max_steps, f"dict_api oracle: {steps} steps")
    return {"steps": steps, "deliveries": deliveries, "equal": True,
            "oracle_steps_per_sec": steps / walls["oracle"],
            "torch_steps_per_sec": steps / walls["torch"]}


@timed_phase("sweep")
def sweep_phase(dev, cfg, out):
    """``run_sweep`` over 2 learning rates x 2 seeds at 256 envs, T = 16,
    10 updates (K2 + K3 on the card), then ``run_asha`` on the same grid
    with rungs 2, 4; each run's stacked metrics, as its trials train, go
    into ``out`` for ``sweep_check``."""
    tcfg = TrainConfig(num_envs=SWEEP_B, unroll_length=SLICE_T,
                       num_updates=SWEEP_UPDATES)
    train_seeds = sweep._train_seeds
    calls = []

    def recorded(trainer, states, n):
        states, metrics = train_seeds(trainer, states, n)
        calls.append((trainer.tcfg, n, metrics))
        return states, metrics

    sweep._train_seeds = recorded
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out["rows"], out["best"] = sweep.run_sweep(
            cfg, tcfg, SWEEP_GRID, num_seeds=SWEEP_SEEDS,
            last_k=SWEEP_UPDATES, device=dev)
        out["sweep_s"] = time.perf_counter() - t0
        out["sweep_calls"], calls = calls, []
        t1 = time.perf_counter()
        out["asha_rows"], out["asha_best"] = sweep.run_asha(
            cfg, tcfg, SWEEP_GRID, rung_updates=ASHA_RUNGS,
            num_seeds=SWEEP_SEEDS, device=dev)
        out["asha_s"] = time.perf_counter() - t1
        out["asha_calls"] = calls
    finally:
        sweep._train_seeds = train_seeds


def replay_seeds(dev, cfg, calls, run):
    """Each recorded ``(tcfg, n, metrics)`` call of a sweep's run against
    standalone ``make_train(...).train_many`` runs from each seed's key
    ``fold_in(PRNGKey(tcfg.seed), s)``: one trainer and one state per seed for each tcfg, continued call after
    call as ASHA's rungs continue them; every metric bit-equal."""
    standalone = {}
    for tcfg, n, metrics in calls:
        if tcfg.to_json() not in standalone:
            tr = make_train(cfg, tcfg, device=dev)
            base = rng.prng_key(tcfg.seed, dev)
            standalone[tcfg.to_json()] = (tr, [
                tr.init(rng.fold_in(base, s)) for s in range(SWEEP_SEEDS)])
        tr, states = standalone[tcfg.to_json()]
        for s in range(SWEEP_SEEDS):
            states[s], m = tr.train_many(states[s], n)
            require(m.keys() == metrics.keys() and all(
                np.array_equal(metrics[k][s], m[k].cpu().numpy())
                for k in m),
                f"sweep: {run}'s seed {s} at lr {tcfg.learning_rate} differs "
                "from a standalone run from its key")
    return len(calls)


@timed_phase("sweep_check")
def sweep_check(dev, cfg, out):
    """After the counted run: every seed's metrics of ``run_sweep`` and of
    each ``run_asha`` rung bit-equal to standalone ``make_train(...)
    .train_many`` runs from its key, and each ``run_sweep`` row's score
    and final values those of the standalone run."""
    require(replay_seeds(dev, cfg, out["sweep_calls"], "run_sweep")
            == len(sweep._grid_points(SWEEP_GRID)),
            "sweep: run_sweep did not train every point once")
    require(replay_seeds(dev, cfg, out["asha_calls"], "run_asha")
            == len(sweep._grid_points(SWEEP_GRID)) + 1,
            "sweep: run_asha did not train every point, then one survivor")
    for tcfg, _, metrics in out["sweep_calls"]:
        for s in range(SWEEP_SEEDS):
            row = next(r for r in out["rows"] if r.get("overrides")
                       == {"learning_rate": tcfg.learning_rate}
                       and r.get("seed") == s)
            curve = metrics["deliveries_per_env_step"]
            require(row["score"] == float(curve.mean(axis=1)[s])
                    and row["final"] == {k: float(v[s, -1])
                                         for k, v in metrics.items()},
                    f"sweep: the row of lr {tcfg.learning_rate} seed {s} is "
                    "not its run's")
    require(all(r["backends"] == KERNELS
                for r in out["rows"] + out["asha_rows"]),
            "sweep: a trial left the kernel routes")
    emit({"phase": "sweep", "card": card(), "B": SWEEP_B, "T": SLICE_T,
          "updates": SWEEP_UPDATES, "seeds": SWEEP_SEEDS, "grid": SWEEP_GRID,
          "sweep_s": out["sweep_s"], "asha_s": out["asha_s"],
          "summary": out["best"], "asha_rows": out["asha_rows"]})


def _tree_equal(a, b) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def expected_explore(scores, lrs, ents, space, gen, quantile, resample_prob,
                     sign):
    """Tune's PBT exploit and explore as the JAX loop draws them from
    ``gen``: the sources of the bottom quantile, drawn from the top one,
    and each one's new learning rate and entropy coefficient, with how
    each came (resampled, x 1.2 or / 1.2)."""
    P = len(scores)
    ranked = np.argsort(sign * scores)[::-1]
    n_q = max(1, int(np.ceil(P * quantile)))
    top, bottom = ranked[:n_q], ranked[P - n_q:]
    src = np.arange(P)
    src[bottom] = gen.choice(top, size=len(bottom))
    hp = {"learning_rate": lrs[src].copy(), "entropy_coef": ents[src].copy()}
    how = {int(i): {} for i in bottom}
    for i in bottom:
        for name in ("learning_rate", "entropy_coef"):
            if name not in space:
                continue
            if gen.random() < resample_prob:
                spec = space[name]
                if "loguniform" in spec:
                    lo, hi = spec["loguniform"]
                    hp[name][i] = np.exp(gen.uniform(np.log(lo), np.log(hi)))
                else:
                    hp[name][i] = gen.uniform(*spec["uniform"])
                how[int(i)][name] = "resample"
            elif gen.random() < 0.5:
                hp[name][i] *= 1.2
                how[int(i)][name] = "x1.2"
            else:
                hp[name][i] *= 1 / 1.2
                how[int(i)][name] = "/1.2"
    return src, bottom, hp["learning_rate"], hp["entropy_coef"], how


@timed_phase("pbt")
def pbt_phase(dev, cfg, out=None):
    """``run_pbt`` with a population of 4, perturb interval 3, 2 intervals
    at 256 envs (plain on the card, as the JAX PBT reaches no kernel): after
    each exploit every replaced member's params and Adam moments equal its
    source's, and the sources, learning rates and entropy coefficients are
    exactly those that replaying the run's generator from just before the
    exploit gives (x 1.2, / 1.2 or a resample from the space)."""
    seen = []
    exploit = pbt.exploit_explore

    def checked(members, scores, lrs, ents, space, rng_np, quantile,
                resample_prob, sign, mesh=None):
        replay = np.random.default_rng()
        replay.bit_generator.state = rng_np.bit_generator.state
        out, src, bottom, new_lrs, new_ents = exploit(
            members, scores, lrs, ents, space, rng_np, quantile,
            resample_prob, sign, mesh)
        w_src, w_bottom, w_lrs, w_ents, how = expected_explore(
            scores, lrs, ents, space, replay, quantile, resample_prob, sign)
        require(np.array_equal(src, w_src)
                and np.array_equal(np.sort(bottom), np.sort(w_bottom)),
                f"pbt: sources {src.tolist()}, replayed {w_src.tolist()}")
        require(np.array_equal(new_lrs, w_lrs)
                and np.array_equal(new_ents, w_ents),
                f"pbt: explored lrs {new_lrs.tolist()} entropy "
                f"{new_ents.tolist()}, replayed {w_lrs.tolist()} "
                f"{w_ents.tolist()}")
        for i in bottom:
            s = members[src[i]]
            require(_tree_equal(out[i].params, s.params)
                    and _tree_equal(out[i].opt_state.mu, s.opt_state.mu)
                    and _tree_equal(out[i].opt_state.nu, s.opt_state.nu)
                    and out[i].opt_state.count == s.opt_state.count,
                    f"pbt: member {i} is not a copy of member {src[i]}")
            seen.append({"member": int(i), "source": int(src[i]),
                         "lr_from": float(lrs[src[i]]),
                         "lr_to": float(new_lrs[i]),
                         "ent_from": float(ents[src[i]]),
                         "ent_to": float(new_ents[i]), "how": how[int(i)]})
        return out, src, bottom, new_lrs, new_ents

    pbt.exploit_explore = checked
    try:
        t0 = time.perf_counter()
        res = pbt_run(dev, cfg)
        wall = time.perf_counter() - t0
    finally:
        pbt.exploit_explore = exploit
    require(len(seen) >= 1, "pbt: no member was replaced")
    require(all(np.isfinite(r["score"]) for r in res.rows[:-1])
            and np.isfinite(res.best["best_score"]), "pbt: non-finite score")
    emit({"phase": "pbt", "card": card(), "B": SWEEP_B, "T": SLICE_T,
          "population": PBT_POPULATION, "interval": PBT_INTERVAL,
          "intervals": PBT_INTERVALS, "seconds": wall, "exploits": seen,
          "rows": res.rows})
    if out is not None:  # pop_pbt_ranks' in-turn reference
        out["rows"] = res.rows


# ---- the data mesh (M-8) ----------------------------------------------------

MESH_UPDATES = 3        # updates of each meshed trainer
MESH_RANK_ENVS = 2048   # envs of each of the two ranks on the one card
MESH_TIMEOUT_S = 300    # a rank's wait for the other before it raises
# The meshed learners at config 4: (name, trainer, its options, arch, the
# grads kernel's wrapper, the launch class whose gradient and step are
# timed, its step method's name, the twin comparison's tolerances).
MESH_PATHS = [
    ("ppo", make_train, dict(num_updates=TRAIN_SCHEDULE), "mlp",
     sgd.ppo_minibatch_grads, sgd.MlpLaunch, "clip_adam", SGD_TOL),
    ("cnn", make_train, dict(num_updates=CNN_SCHEDULE), "cnn",
     sgd_cnn.ppo_cnn_minibatch_grads, sgd_cnn.CnnLaunch, "clip_adam",
     CNN_TOL),
    ("gru", make_train_rnn, dict(num_updates=RNN_SCHEDULE), "gru",
     sgd_rnn.ppo_rnn_minibatch_grads, sgd_rnn.RnnLaunch, "clip_adam",
     SGD_TOL),
    ("impala", make_train_impala,
     dict(num_updates=IMPALA_SCHEDULE, impala_rmsprop=False), "mlp",
     vtrace_sgd.impala_minibatch_grads, vtrace_sgd._Launch, "step", VT_TOL)]


class Spans:
    """CUDA events around every call of some methods, by label: the device
    time each took, summed (``ms``) and reset by ``take``. The wrapped
    methods run unchanged (their launch counts too)."""

    def __init__(self, methods):
        self.methods, self.spans = methods, {k: [] for k in methods.values()}

    def __enter__(self):
        self.saved = []
        for (owner, name), label in self.methods.items():
            orig = getattr(owner, name)
            self.saved.append((owner, name, orig))

            def wrapped(*a, _orig=orig, _label=label, **k):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = _orig(*a, **k)
                e1.record()
                self.spans[_label].append((e0, e1))
                return out
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self.saved:
            setattr(owner, name, orig)

    def take(self) -> dict:
        torch.cuda.synchronize()
        out = {k: sum(a.elapsed_time(b) for a, b in v)
               for k, v in self.spans.items()}
        out.update({f"{k}_calls": len(v) for k, v in self.spans.items()})
        for v in self.spans.values():
            v.clear()
        return out


class TimedMesh:
    """A ``DataMesh`` whose ``mean_`` (the learner's one all-reduce a
    step) is timed by ``Spans``; everything else is the mesh's."""

    def __init__(self, mesh):
        self._mesh = mesh

    def __getattr__(self, name):
        return getattr(self._mesh, name)

    def mean_(self, x):
        return self._mesh.mean_(x)


@timed_phase("mesh_world1_train")
def mesh_world1_train(dev, paths=None, updates=None,
                      phase="mesh_world1_train"):
    """A world-1 NCCL group (a file store in a temporary directory) and on
    it, for PPO (K2 + K4), the CNN (K10 + K12), the GRU (K7 + K9) and
    IMPALA with Adam (K2 + K6) at config 4 (or ``paths``, MESH_PATHS'
    kind), 3 meshed updates (or ``updates``) from
    ``PRNGKey(0)``: each update's grads-kernel launches (``epochs x
    minibatches``, each followed by one all-reduce and one sums-of-squares
    launch), its time split into acting, the grads kernel, the all-reduce,
    the sums of squares and the step (CUDA events around each), and the
    same update through the plain twins from the same state
    (``plain_step``: the same meshed route, its all-reduce included): env
    state bit-equal, metrics within STEP_METRIC_TOL, params within the
    learner's tolerance."""
    paths = MESH_PATHS if paths is None else paths
    updates = MESH_UPDATES if updates is None else updates
    from warehouse_tpu_torch.parallel.distributed import process_group

    with tempfile.TemporaryDirectory() as tmp, process_group(
            os.path.join(tmp, "store"), backend="nccl",
            timeout_s=MESH_TIMEOUT_S) as mesh:
        for name, make, kw, arch, grads, launch, step_name, tol in paths:
            tcfg = TrainConfig(**kw)
            timed_mesh = TimedMesh(mesh)
            tr = make(medium_config(), tcfg, arch=arch, device=dev,
                      mesh=timed_mesh)
            require(tr.backends == KERNELS and tr.mesh is timed_mesh,
                    f"mesh_world1_train {name}: {tr.backends}")
            per_update = (tcfg.impala_passes if name == "impala"
                          else tcfg.ppo_epochs) * tcfg.num_minibatches
            rs = tr.init_global(rng.prng_key(0, dev))
            rows = []
            with Spans({(launch, "grads"): "grads",
                        (launch, step_name): "step",
                        (TimedMesh, "mean_"): "all_reduce",
                        (sgd.SumsqEntry, "sumsq"): "sumsq"}) as spans:
                for u in range(updates):
                    n0 = grads.launches
                    marks = Marks()
                    nxt, m = tr.train_step(rs, mark=marks)
                    split = marks.split()
                    launched = grads.launches - n0
                    pieces = spans.take()
                    twin, mt = tr.plain_step(rs)
                    spans.take()
                    rtol, atol = STEP_METRIC_TOL
                    metric_ok = all(
                        abs(float(m[k]) - float(mt[k]))
                        <= atol + rtol * abs(float(mt[k])) for k in m)
                    p_err = tree_err(nxt.params, twin.params, *tol["params"])
                    row = {"update": u + 1, "grads_launches": launched,
                           "update_ms": split["total"],
                           "acting_ms": split["acting"],
                           "grads_ms": pieces["grads"],
                           "grads_ms_per_minibatch": pieces["grads"]
                           / max(pieces["grads_calls"], 1),
                           "all_reduce_ms": pieces["all_reduce"],
                           "all_reduces": pieces["all_reduce_calls"],
                           "sumsq_ms": pieces["sumsq"],
                           "sumsq_calls": pieces["sumsq_calls"],
                           "step_ms": pieces["step"],
                           "twin_env_state_equal": state_equal(
                               nxt.env_state, twin.env_state),
                           "twin_metrics_within": metric_ok,
                           "twin_params_max_abs_err": p_err[0],
                           "twin_params_tol_ratio": p_err[1],
                           "deliveries_per_env_step":
                               float(m["deliveries_per_env_step"])}
                    rows.append(row)
                    require(launched == per_update
                            and pieces["all_reduce_calls"] == per_update
                            and pieces["sumsq_calls"] == per_update,
                            f"mesh_world1_train {name}: {launched} grads "
                            f"launches and {pieces['all_reduce_calls']} "
                            f"all-reduces in update {u + 1}, not "
                            f"{per_update}")
                    require(all(bool(torch.isfinite(v)) for v in m.values()),
                            f"mesh_world1_train {name}: metrics {m}")
                    require(row["twin_env_state_equal"] and metric_ok
                            and p_err[1] <= 1.0,
                            f"mesh_world1_train {name}: update {u + 1} "
                            f"differs from the twins' {row}")
                    rs = nxt
            emit({"phase": phase, "path": name,
                  "backend": mesh.backend, "world": mesh.world,
                  "B": tcfg.num_envs, "T": tcfg.unroll_length,
                  "grads_launches_per_update": per_update,
                  "param_tol": tol["params"], "card": card(),
                  "updates": rows,
                  "median_ms": {k: median([r[k] for r in rows]) for k in (
                      "update_ms", "acting_ms", "grads_ms",
                      "grads_ms_per_minibatch", "all_reduce_ms", "sumsq_ms",
                      "step_ms")}})


def mesh_rank(rank: int, world: int, backend: str, envs: int, threads,
              store: str, out: str) -> None:
    """One rank of ``mesh_ranks``: on ``cuda:rank`` with NCCL (a card a
    rank), on ``cuda:0`` with gloo; 3 meshed PPO updates of its ``envs``
    envs at config 4, the ranks' params and Adam state checked
    bit-identical after each, each update split into acting, GAE and the
    learner and the learner's all-reduces timed by CUDA events, and each
    update held against the same update through the plain twins from the
    same state (``plain_step``: the gradient averaged over the ranks by
    ``DataMesh.mean_grads``): env state bit-equal, metrics within
    STEP_METRIC_TOL, params within SGD_TOL. With ``threads``, torch's
    intra-op threads set to it; its results to ``out``."""
    from warehouse_tpu_torch.parallel.distributed import process_group
    from warehouse_tpu_torch.utils import assert_replicated_in_sync

    if threads:
        torch.set_num_threads(threads)
    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    with process_group(store, backend=backend, rank=rank, world=world,
                       timeout_s=MESH_TIMEOUT_S,
                       local_rank=dev.index) as mesh:
        tcfg = TrainConfig(num_envs=world * envs, num_updates=TRAIN_SCHEDULE)
        tr = make_train(medium_config(), tcfg, device=dev,
                        mesh=TimedMesh(mesh))
        rs = tr.init_global(rng.prng_key(0, dev))
        rows = []
        with Spans({(TimedMesh, "mean_"): "all_reduce"}) as spans:
            torch.cuda.synchronize()
            for u in range(MESH_UPDATES):
                t0 = time.perf_counter()
                marks = Marks()
                nxt, m = tr.train_step(rs, mark=marks)
                split = marks.split()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                pieces = spans.take()
                assert_replicated_in_sync((nxt.params, nxt.opt_state), mesh)
                twin, mt = tr.plain_step(rs)
                rtol, atol = STEP_METRIC_TOL
                metric_ok = all(abs(float(m[k]) - float(mt[k]))
                                <= atol + rtol * abs(float(mt[k])) for k in m)
                p_err = tree_err(nxt.params, twin.params, *SGD_TOL["params"])
                row = {"update_ms": ms, "split_ms": split,
                       "all_reduce_ms": pieces["all_reduce"],
                       "all_reduces": pieces["all_reduce_calls"],
                       "twin_env_state_equal": state_equal(nxt.env_state,
                                                           twin.env_state),
                       "twin_metrics_within": metric_ok,
                       "twin_params_max_abs_err": p_err[0],
                       "twin_params_tol_ratio": p_err[1],
                       **{k: float(v) for k, v in m.items()}}
                rows.append(row)
                require(row["twin_env_state_equal"] and metric_ok
                        and p_err[1] <= 1.0,
                        f"mesh_rank {rank} of {world} ({backend}): update "
                        f"{u + 1} differs from the twins' {row}")
                rs = nxt
        torch.save({"rank": rank, "rows": rows, "envs": int(rs.obs.shape[0]),
                    **launch_counts()}, out)


def mesh_rank_entry(rank, world, backend, envs, threads, store, outs):
    mesh_rank(rank, world, backend, envs, threads, store, outs[rank])


def mesh_ranks(world: int, backend: str, envs: int, threads=None) -> tuple:
    """``world`` spawned ``mesh_rank`` processes: their results and the
    wall seconds. The ranks' launch counts are added to this process's,
    where the main path reads them."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            mesh_rank_entry,
            args=(world, backend, envs, threads, os.path.join(tmp, "store"),
                  outs),
            nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                require(time.perf_counter() - t0 < 2 * MESH_TIMEOUT_S,
                        f"mesh_ranks: {world} {backend} ranks did not "
                        "finish")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        wall = time.perf_counter() - t0
        res = [torch.load(o, weights_only=False) for o in outs]
    add_launches(res)
    require(all(r["envs"] == envs for r in res),
            f"mesh_ranks: a rank does not hold its {envs} envs")
    require(all(r["rows"][-1]["loss"] == res[0]["rows"][-1]["loss"]
                for r in res), "mesh_ranks: the ranks' averaged losses differ")
    return res, wall


@timed_phase("mesh_two_ranks")
def mesh_two_ranks(dev):
    """Two processes on the one card, a gloo group (NCCL refuses two ranks
    on one device), PPO at config 4 with 2048 envs a rank: 3 meshed
    updates, the ranks in sync after each and each held against the plain
    twins' world-2 update from the same state; rank 0's metrics,
    deliveries per env-step finite and positive."""
    res, wall = mesh_ranks(2, "gloo", MESH_RANK_ENVS)
    rows = res[0]["rows"]
    dels = [r["deliveries_per_env_step"] for r in rows]
    emit({"phase": "mesh_two_ranks", "world": 2, "backend": "gloo",
          "envs_per_rank": res[0]["envs"], "card": card(),
          "wall_s": wall, "rank0": rows,
          "grads_launches": [r["launches"]["ppo_minibatch_grads"]
                             for r in res]})
    require(all(np.isfinite(d) and d > 0 for d in dels),
            f"mesh_two_ranks: deliveries per env-step {dels}")


MESH_CARD_ENVS = 4096   # envs a rank in ``--mesh-cards``: config 4's


def mesh_cards():
    """``--mesh-cards`` on a machine with several cards: PPO at config 4,
    4096 envs a rank, on a world-1 NCCL group and then on one NCCL rank
    per card (NVLink), 3 updates each, the ranks in sync after each, then
    the same mesh with one intra-op thread a rank: each rank's update ms,
    its split and its all-reduce ms, and the env-steps/s of the whole mesh
    beside world 1's."""
    n = torch.cuda.device_count()
    require(n > 1, f"--mesh-cards needs more than one card, found {n}")
    base = None
    for world, threads in ((1, None), (n, None), (n, 1)):
        res, wall = mesh_ranks(world, "nccl", MESH_CARD_ENVS, threads)
        # Updates 2-3 (the first builds and warms up), slowest rank.
        upd = [max(r["rows"][u]["update_ms"] for r in res)
               for u in range(1, MESH_UPDATES)]
        rate = (world * MESH_CARD_ENVS * TrainConfig().unroll_length
                / (median(upd) / 1e3))
        base = base or rate
        emit({"phase": "mesh_cards", "world": world, "backend": "nccl",
              "threads": threads or torch.get_num_threads(),
              "envs_per_rank": MESH_CARD_ENVS, "card": card(),
              "wall_s": wall, "update_ms": upd,
              "rank_update_ms": [[round(row["update_ms"], 2)
                                  for row in r["rows"]] for r in res],
              "rank_split_ms": [{k: round(v, 2) for k, v in
                                 r["rows"][-1]["split_ms"].items()}
                                for r in res],
              "all_reduce_ms": [[r["rows"][u]["all_reduce_ms"]
                                 for u in range(MESH_UPDATES)] for r in res],
              "all_reduces": res[0]["rows"][-1]["all_reduces"],
              "env_steps_per_sec": rate, "speedup_vs_world1": rate / base,
              "deliveries_per_env_step": [
                  r["deliveries_per_env_step"] for r in res[0]["rows"]]})


# ---- F-10: the meshed clip by the averaged gradient ------------------------

# The sums-of-squares kernel's layouts: K3 at config 4 and with groups (a
# segment a group), K5, K11 (conv blocks, then dense), K8 at config 4 and
# at hidden 50 (the net padded to 52).
SUMSQ_CASES = ("k3_config4", "k3_groups", "k5_config4", "k11_config4",
               "k8_config4", "k8_h50")


def sumsq_case(dev, name):
    """``(launch, packed params)`` of one of SUMSQ_CASES on its config-4
    trajectory (``sgd_inputs``, ``impala_inputs``, ``rnn_inputs``)."""
    cfg = medium_config()
    if name.startswith("k3"):
        groups = CONFIG4_GROUPS if name == "k3_groups" else None
        tcfg, _, rs, traj, adv_n, targets, ent = sgd_inputs(dev, cfg,
                                                            groups=groups)
        return sgd.MlpLaunch(
            rs.params, traj, adv_n, targets, ent, rs.kl_coeff,
            tcfg.num_minibatches, tcfg.clip_eps, tcfg.value_coef,
            tcfg.mask_actions, policy_groups=groups), sgd.pack(rs.params)
    if name == "k5_config4":
        tcfg, params, traj, last_obs, kw = impala_inputs(dev, cfg)
        return vtrace_sgd._Launch(params, traj, last_obs, tcfg.entropy_coef,
                                  tcfg.num_minibatches, **kw), sgd.pack(params)
    if name == "k11_config4":
        tcfg, _, rs, traj, adv_n, targets, ent = sgd_inputs(
            dev, cfg, "cnn", CNN_SCHEDULE)
        return sgd_cnn.CnnLaunch(
            rs.params, traj, adv_n, targets, ent, rs.kl_coeff,
            tcfg.num_minibatches, tcfg.clip_eps, tcfg.value_coef,
            tcfg.mask_actions), act.pack_cnn(rs.params)
    tcfg, _, rs, traj, adv_n, targets, h0, ent = rnn_inputs(
        dev, cfg, "gru", shape=SHAPE_H50 if name == "k8_h50" else HIDDEN)
    return sgd_rnn.RnnLaunch(
        rs.params, traj, adv_n, targets, h0, ent, rs.kl_coeff,
        tcfg.num_minibatches, tcfg.clip_eps, tcfg.value_coef,
        tcfg.mask_actions), act_rnn.pack_rnn(rs.params)


def sumsq_run(run, p_flat) -> dict:
    """Minibatch 1's gradient through ``run``'s grads kernel, then the
    sums-of-squares kernel on it into a buffer of its own and into the
    workspace (zeroed first), and the plain version: whether each is
    bit-equal to the sums the grads kernel left (``reduce_kernel``'s)."""
    grads = torch.empty_like(p_flat)
    sums = torch.empty(4, dtype=torch.float32, device=p_flat.device)
    run.grads(p_flat, 1, grads, sums)
    left = run.sq_view().clone()
    own = torch.empty_like(left)
    sgd.grad_sumsq(grads, run.sq_layout, own)
    plain = sgd.grad_sumsq_plain(grads, run.sq_layout)
    run.sq_view().zero_()
    sgd.grad_sumsq(grads, run.sq_layout)
    return {"n_params": p_flat.numel(), "sums": left.numel(),
            "segments": run.sq_layout.segments,
            "padded": run.sq_layout.pad is not None,
            "kernel_equal_reduce": bits_equal(own, left),
            "plain_equal_reduce": plain.shape == left.shape
            and bits_equal(plain, left),
            "workspace_equal_reduce": bits_equal(run.sq_view(), left),
            "grads": grads, "own": own, "plain": plain}


@timed_phase("sumsq_check")
def sumsq_check(dev):
    """The sums-of-squares kernel (``sgd.grad_sumsq``, F-10) after each
    learner's grads kernel, in its four layouts (SUMSQ_CASES): on one
    minibatch's gradient, into a buffer of its own and into the workspace,
    bit-equal to the sums of squares the grads kernel left there
    (``reduce_kernel``'s) and to the plain version (``sumsq_run``). K3's
    config-4 case timed (``timed_after``) beside the plain version and
    ``torch.linalg.vector_norm`` of the same gradient; its bound n_params x
    4 bytes read and the sums written at 3.35 TB/s."""
    rows, res = {}, None
    for name in SUMSQ_CASES:
        run, p_flat = sumsq_case(dev, name)
        out = sumsq_run(run, p_flat)
        grads, own = out.pop("grads"), out.pop("own")
        plain = out.pop("plain")
        rows[name] = out
        require(all(v for k, v in out.items() if k.endswith("_reduce")),
                f"sumsq_check {name}: {out}")
        if name == "k3_config4":
            n, layout = p_flat.numel(), run.sq_layout
            ms = timed_after(lambda: None,
                             lambda: sgd.grad_sumsq(grads, layout, own), 20)
            plain_ms = timed_after(
                lambda: None, lambda: sgd.grad_sumsq_plain(grads, layout), 20)
            lib_ms = timed_after(
                lambda: None, lambda: torch.linalg.vector_norm(grads), 20)
            res = (float((own - plain).abs().max()), ms, plain_ms,
                   bound(4.0 * (n + own.numel()), 2.0 * n), lib_ms)
            out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=res[3]["bound_ms"])
        del run, p_flat, grads, own, plain
    emit({"phase": "sumsq_check", "card": card(), "cases": rows})
    return res


def launch_counts() -> dict:
    """This process's launch counts: each wrapper's, then each option's."""
    return {"launches": {k: w.launches for k, w in COUNTED.items()},
            "option_launches": {k: getattr(w, c) for k, (w, c)
                                in OPTION_COUNTED.items()}}


def add_launches(res: list) -> None:
    """Spawned ranks' ``launch_counts`` added to this process's, where the
    main path reads them."""
    for k, w in COUNTED.items():
        w.launches += sum(r["launches"][k] for r in res)
    for k, (w, c) in OPTION_COUNTED.items():
        setattr(w, c, getattr(w, c) + sum(r["option_launches"][k]
                                          for r in res))


@timed_phase("mesh_clip_ranks")
def mesh_clip_ranks(dev):
    """Two spawned ranks on the one card (a gloo group), config 4 at 1024
    envs a rank and ``max_grad_norm = 1e-3``, where every step clips: one
    meshed update each of PPO (K4, K3's clip + Adam), the GRU (K9, K8), the
    CNN (K12, K11) and IMPALA with Adam and with RMSProp (K6, K5), each
    after the all-reduce through the sums-of-squares kernel on the averaged
    gradient: the ranks bit-identical, each within the learners' bound of
    the plain twins' world-2 update (which clips by the averaged norm, as
    JAX does), each step's averaged norm beside each rank's own
    (``tools/torch_mesh_clip.py``, which runs the same check on another
    tree's package: a parent commit's)."""
    sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "tools"))
    import torch_mesh_clip as clip

    res, wall = clip.clip_ranks(2, clip.RANK_ENVS, counts=launch_counts)
    add_launches(res)
    out = clip.verdict(res)
    emit({"phase": "mesh_clip_ranks", "card": card(), "world": 2,
          "backend": "gloo", "envs_per_rank": clip.RANK_ENVS,
          "max_grad_norm": clip.CLIP_NORM, "wall_s": wall, **out})
    require(out["ok"], "mesh_clip_ranks: a meshed update did not clip by "
            "the averaged gradient's norm: "
            + str([p["path"] for p in out["paths"] if not p["ok"]]))


# ---- M-8b: the population axis ----------------------------------------------

POP_SEEDS = 4          # pop_sweep_ranks' seeds: 2 a slice
POP_RANKS = 4          # pop_pbt_ranks' second mesh: pop 2 x data 2


def rank_entry(rank, world, fn, args, store, outs):
    """One spawned rank of ``gloo_ranks`` on ``cuda:0``: ``fn(dev, *args)``
    in a gloo group of ``world``; its result and launch counts to
    ``outs[rank]``."""
    from warehouse_tpu_torch.parallel.distributed import process_group

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with process_group(store, backend="gloo", rank=rank, world=world,
                       timeout_s=MESH_TIMEOUT_S, local_rank=0):
        res = fn(dev, *args)
    torch.save({"res": res, **launch_counts()}, outs[rank])


def gloo_ranks(world: int, fn, *args) -> tuple:
    """``world`` spawned ``rank_entry`` processes sharing the one card (NCCL
    refuses two ranks on one device): their results in rank order and the
    wall seconds; their launch counts added to this process's."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        t0 = time.perf_counter()
        ctx = mp.start_processes(
            rank_entry, args=(world, fn, args, os.path.join(tmp, "store"),
                              outs),
            nprocs=world, join=False, start_method="spawn")
        try:
            while not ctx.join(timeout=5):
                require(time.perf_counter() - t0 < 2 * MESH_TIMEOUT_S,
                        f"gloo_ranks: {world} ranks of {fn.__name__} did "
                        "not finish")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
        wall = time.perf_counter() - t0
        res = [torch.load(o, weights_only=False) for o in outs]
    add_launches(res)
    return res, wall


def sweep_tcfg():
    return TrainConfig(num_envs=SWEEP_B, unroll_length=SLICE_T,
                       num_updates=SWEEP_UPDATES)


def pop_sweep(dev, cfg, seed_mesh=None) -> dict:
    """``run_trial`` with POP_SEEDS seeds and ``run_asha`` over SWEEP_GRID
    with rungs ASHA_RUNGS and POP_SEEDS seeds, at PR 21's sweep sizes."""
    _, trial = sweep.run_trial(cfg, sweep_tcfg(), POP_SEEDS,
                               seed_mesh=seed_mesh, device=dev)
    asha, _ = sweep.run_asha(cfg, sweep_tcfg(), SWEEP_GRID,
                             rung_updates=ASHA_RUNGS, num_seeds=POP_SEEDS,
                             seed_mesh=seed_mesh, device=dev)
    return {"trial": trial, "asha": asha}


def pop_sweep_rank(dev):
    """A rank of ``pop_sweep_ranks``: the sweep with ``seed_mesh`` pop 2."""
    from warehouse_tpu_torch.parallel.mesh import make_pop_mesh

    return pop_sweep(dev, medium_config(), make_pop_mesh(2))


@timed_phase("pop_sweep_ranks")
def pop_sweep_ranks(dev, ref):
    """Two spawned ranks, ``seed_mesh`` pop 2 (a slice a rank, 2 seeds
    each): ``run_trial`` and ``run_asha`` with 4 seeds at 256 envs, T = 16,
    through K2 and K3 / K4 on each rank; the metrics (every seed's, on
    every rank) and the ASHA rows bit-equal to ``ref``, the same sweep in
    turn in this process on the same card."""
    res, wall = gloo_ranks(2, pop_sweep_rank)
    for r, out in enumerate(res):
        got = out["res"]
        require(got["trial"].keys() == ref["trial"].keys() and all(
            np.array_equal(got["trial"][k], ref["trial"][k])
            for k in ref["trial"]),
            f"pop_sweep_ranks: rank {r}'s run_trial metrics differ from the "
            "in-turn sweep's")
        require(got["asha"] == ref["asha"],
                f"pop_sweep_ranks: rank {r}'s ASHA rows differ")
        require(all(out["launches"][k] > 0 for k in (
            "ppo_rollout", "ppo_sgd_phase", "ppo_minibatch_grads")),
            f"pop_sweep_ranks: rank {r} did not train through K2 and K3: "
            f"{out['launches']}")
    emit({"phase": "pop_sweep_ranks", "card": card(), "world": 2,
          "pop": 2, "seeds": POP_SEEDS, "B": SWEEP_B, "T": SLICE_T,
          "wall_s": wall, "in_turn_s": ref["seconds"],
          "rank_launches": [{k: out["launches"][k] for k in (
              "ppo_rollout", "ppo_sgd_phase", "ppo_minibatch_grads")}
              for out in res],
          "asha_best": ref["asha"][-1]})


def pbt_run(dev, cfg, mesh=None):
    """``run_pbt`` at pbt_phase's sizes: 4 members, interval 3, 2
    intervals, 256 envs."""
    return pbt.run_pbt(cfg, TrainConfig(num_envs=SWEEP_B,
                                        unroll_length=SLICE_T), PBT_SPACE,
                       population_size=PBT_POPULATION,
                       perturb_interval=PBT_INTERVAL,
                       num_intervals=PBT_INTERVALS, mesh=mesh, device=dev)


def member_digest(member) -> str:
    """sha256 of a member's whole state, its leaves' bytes in order."""
    import hashlib

    from warehouse_tpu_torch.parallel.mesh import _tree_map

    h = hashlib.sha256()
    _tree_map(lambda x: h.update(x.detach().contiguous().reshape(-1).view(
        torch.uint8).cpu().numpy().tobytes()) or x, member)
    return h.hexdigest()


def pop_pbt_rank(dev, pop: int):
    """A rank of ``pop_pbt_ranks``: ``run_pbt`` on a ``(pop, world / pop)``
    mesh; with data ranks, each member's params and Adam state checked in
    sync on its slice after every update (``train_chunk`` one update at a
    time), and each exploit's every member's digest, before and after,
    gathered from every rank."""
    from warehouse_tpu_torch.parallel.mesh import make_pop_mesh
    from warehouse_tpu_torch.utils import assert_replicated_in_sync

    mesh = make_pop_mesh(pop)
    make, exploit, seen = pbt.make_pbt_trainer, pbt.exploit, []

    def checked_trainer(*a, **kw):
        init, chunk, get_lr, with_hp = make(*a, **kw)

        def chunk_synced(members, n):
            steps = []
            for _ in range(n):
                members, m = chunk(members, 1)
                for member in members:
                    assert_replicated_in_sync(
                        (member.params, member.opt_state), mesh)
                steps.append(m)
            return members, {k: torch.cat([s[k] for s in steps], 1)
                             for k in steps[0]}
        return init, chunk_synced, get_lr, with_hp

    def digests(members):
        mine = torch.tensor([[int(c, 16) for c in member_digest(m)[:15]]
                             for m in members], dtype=torch.int64)
        return [x.tolist() for x in mesh.whole.all_gather(mine)]

    def recorded(members, src, m=None):
        before = digests(members)
        out = exploit(members, src, m)
        seen.append({"src": [int(s) for s in src], "before": before,
                     "after": digests(out)})
        return out

    pbt.make_pbt_trainer, pbt.exploit = checked_trainer, recorded
    try:
        res = pbt_run(dev, medium_config(), mesh)
    finally:
        pbt.make_pbt_trainer, pbt.exploit = make, exploit
    return {"rows": res.rows, "exploits": seen, "slice": mesh.slice,
            "data_index": mesh.data.rank, "data": mesh.data.world}


@timed_phase("pop_pbt_ranks")
def pop_pbt_ranks(dev, ref_rows):
    """``run_pbt`` (4 members, interval 3, 2 intervals, 256 envs; plain, as
    the JAX PBT reaches no kernel) on two spawned ranks at pop 2, data 1:
    its rows bit-equal to ``ref_rows``, the same run in turn in this
    process on the same card; then on four ranks at pop 2, data 2: each
    member's params and Adam state in sync on its slice's two data ranks
    after every update, each member an exploit replaced equal, shard by
    shard (rank ``(s, d)`` against rank ``(s', d)``), to its source before
    the exploit, the rows equal on every rank and every score finite."""
    res2, wall2 = gloo_ranks(2, pop_pbt_rank, 2)
    for r, out in enumerate(res2):
        require(out["res"]["rows"] == ref_rows,
                f"pop_pbt_ranks: rank {r}'s rows at pop 2 x data 1 differ "
                "from the in-turn run's")
    res4, wall4 = gloo_ranks(POP_RANKS, pop_pbt_rank, 2)
    rows = res4[0]["res"]["rows"]
    require(all(out["res"]["rows"] == rows for out in res4),
            "pop_pbt_ranks: the ranks' rows at pop 2 x data 2 differ")
    require(all(np.isfinite(r["score"]) for r in rows[:-1])
            and np.isfinite(rows[-1]["best_score"]),
            "pop_pbt_ranks: a non-finite score")
    per = PBT_POPULATION // 2
    copies = 0
    for ex in res4[0]["res"]["exploits"]:
        for i, s in enumerate(ex["src"]):
            for d in range(POP_RANKS // 2):
                want = ex["before"][(s // per) * 2 + d][s % per]
                got = ex["after"][(i // per) * 2 + d][i % per]
                require(got == want, f"pop_pbt_ranks: member {i}'s data "
                        f"shard {d} is not member {s}'s after the exploit")
            copies += int(s != i)
    require(copies >= 1, "pop_pbt_ranks: no member was replaced")
    emit({"phase": "pop_pbt_ranks", "card": card(), "B": SWEEP_B,
          "T": SLICE_T, "population": PBT_POPULATION,
          "interval": PBT_INTERVAL, "intervals": PBT_INTERVALS,
          "pop2_data1_wall_s": wall2, "pop2_data2_wall_s": wall4,
          "exploit_sources": [ex["src"] for ex in res4[0]["res"]["exploits"]],
          "replaced": copies, "pop2_data2_rows": rows})


def pop_main_paths(dev, refs):
    """The population axis' main paths after their in-turn references
    (``refs``: the sweep's and PBT's in this process): (name, phase, kernels
    it must launch, kernels it must not)."""
    return [
        ("pop_sweep_ranks", lambda: pop_sweep_ranks(dev, refs["sweep"]),
         ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase", "ppo_minibatch_grads"],
         []),
        ("pop_pbt_ranks", lambda: pop_pbt_ranks(dev, refs["pbt"]), [],
         ["ppo_rollout", "ppo_rollout_cnn", "ppo_rnn_rollout",
          "ppo_sgd_phase", "impala_sgd_phase", "ppo_rnn_sgd_phase",
          "ppo_cnn_sgd_phase", "grad_sumsq"])]


@timed_phase("pop_references")
def pop_references(dev, pbt_rows=None) -> dict:
    """The population paths' in-turn references on this card: the sweep of
    ``pop_sweep`` without a mesh and, unless ``pbt_rows`` (pbt_phase's
    rows, the same run) are given, ``pbt_run``'s rows."""
    t0 = time.perf_counter()
    ref = pop_sweep(dev, medium_config())
    ref["seconds"] = time.perf_counter() - t0
    if pbt_rows is None:
        pbt_rows = pbt_run(dev, medium_config()).rows
    return {"sweep": ref, "pbt": pbt_rows}


# Each kernel's wrapper, where its launch count lives.
COUNTED = {"greedy_rollout": rollout.greedy_rollout,
           "ppo_rollout": act.act_steps,
           "ppo_sgd_phase": sgd.ppo_sgd_phase,
           "ppo_minibatch_grads": sgd.ppo_minibatch_grads,
           "impala_sgd_phase": vtrace_sgd.impala_sgd_phase,
           "impala_minibatch_grads": vtrace_sgd.impala_minibatch_grads,
           "ppo_rnn_rollout": act_rnn.act_rnn_steps,
           "ppo_rnn_sgd_phase": sgd_rnn.ppo_rnn_sgd_phase,
           "ppo_rnn_minibatch_grads": sgd_rnn.ppo_rnn_minibatch_grads,
           "ppo_rollout_cnn": act.act_cnn_steps,
           "ppo_cnn_sgd_phase": sgd_cnn.ppo_cnn_sgd_phase,
           "ppo_cnn_minibatch_grads": sgd_cnn.ppo_cnn_minibatch_grads,
           "grad_sumsq": sgd.grad_sumsq}
# An option's or a route's launches are counted beside each wrapper's own:
# (wrapper, the counter's name).
OPTION_COUNTED = {
    "ppo_rollout_shaped": (act.act_steps, "shaped_launches"),
    "ppo_rollout_cnn_shaped": (act.act_cnn_steps, "shaped_launches"),
    "ppo_rollout_global": (act.act_steps, "global_launches"),
    "ppo_rollout_stages": (act.act_steps, "stage_launches"),
    "ppo_rollout_hidden": (act.act_steps, "hidden_launches"),
    "ppo_rollout_head": (act.act_steps, "head_launches"),
    "ppo_rollout_env": (act.act_steps, "env_launches"),
    "impala_minibatch_grads_stages": (vtrace_sgd.impala_minibatch_grads,
                                      "stage_launches"),
    "ppo_rnn_rollout_stages": (act_rnn.act_rnn_steps, "stage_launches"),
    **{f"ppo_rnn_rollout_{st}": (act_rnn.act_rnn_steps, f"{st}_launches")
       for st in act_rnn.ACT_RNN_STAGES},
    **{f"impala_minibatch_grads_{st}": (vtrace_sgd.impala_minibatch_grads,
                                        f"{st}_launches")
       for st in vtrace_sgd.VT_STAGES},
    "ppo_rollout_cnn_global": (act.act_cnn_steps, "global_launches"),
    "ppo_sgd_phase_global": (sgd.ppo_sgd_phase, "chunked_launches"),
    "ppo_minibatch_grads_global": (sgd.ppo_minibatch_grads,
                                   "chunked_launches"),
    "ppo_cnn_sgd_phase_global": (sgd_cnn.ppo_cnn_sgd_phase,
                                 "small_tile_launches"),
    "ppo_cnn_minibatch_grads_global": (sgd_cnn.ppo_cnn_minibatch_grads,
                                       "small_tile_launches"),
    "ppo_rollout_groups": (act.act_steps, "group_launches"),
    "ppo_rollout_cnn_groups": (act.act_cnn_steps, "group_launches"),
    "ppo_rollout_cnn_stages": (act.act_cnn_steps, "stage_launches"),
    "ppo_sgd_phase_groups": (sgd.ppo_sgd_phase, "group_launches"),
    "ppo_minibatch_grads_groups": (sgd.ppo_minibatch_grads,
                                   "group_launches"),
    "ppo_sgd_phase_bf16": (sgd.ppo_sgd_phase, "bf16_launches"),
    "ppo_minibatch_grads_bf16": (sgd.ppo_minibatch_grads, "bf16_launches"),
    "ppo_rnn_sgd_phase_bf16": (sgd_rnn.ppo_rnn_sgd_phase, "bf16_launches"),
    "ppo_rnn_minibatch_grads_bf16": (sgd_rnn.ppo_rnn_minibatch_grads,
                                     "bf16_launches"),
    "ppo_cnn_sgd_phase_bf16": (sgd_cnn.ppo_cnn_sgd_phase, "bf16_launches"),
    "ppo_cnn_minibatch_grads_bf16": (sgd_cnn.ppo_cnn_minibatch_grads,
                                     "bf16_launches")}


# K2's stage kernels, counted on every path that acts through K2: all of
# them, then each stage's.
K2_STAGES = ["ppo_rollout_stages", "ppo_rollout_hidden", "ppo_rollout_head",
             "ppo_rollout_env"]
# K7's stage kernels, counted on every path that acts through K7: all of
# them, then each stage's.
K7_STAGES = ["ppo_rnn_rollout_stages"] + [
    f"ppo_rnn_rollout_{st}" for st in act_rnn.ACT_RNN_STAGES]
# K6's stage kernels, counted on every path that learns through K5 / K6:
# all of them, then each stage's.
K6_STAGES = ["impala_minibatch_grads_stages"] + [
    f"impala_minibatch_grads_{st}" for st in vtrace_sgd.VT_STAGES]


def main_path(name, fn, kernels, absent=()):
    """Runs one main path with every launch count zeroed just before it;
    reads the counts just after and requires each of ``kernels`` and none
    of ``absent`` (the kernels a route does not take)."""
    for wrapper in COUNTED.values():
        wrapper.launches = 0
    for wrapper, counter in OPTION_COUNTED.values():
        setattr(wrapper, counter, 0)
    fn()
    counts = {k: w.launches for k, w in COUNTED.items()}
    counts.update({k: getattr(w, c) for k, (w, c) in OPTION_COUNTED.items()})
    emit({"phase": "launches", "path": name, "launches": counts})
    require(all(counts[k] > 0 for k in kernels),
            f"{name}: a kernel of the path never launched: {counts}")
    require(all(counts[k] == 0 for k in absent),
            f"{name}: a kernel off the path's route launched: {counts}")
    return counts


# mesh_clip_ranks' kernels: the five learners' grads and step kernels, the
# sums of squares between them, the acting kernels.
CLIP_KERNELS = ["ppo_rollout", *K2_STAGES, "ppo_minibatch_grads",
                "ppo_sgd_phase", "ppo_rnn_rollout", "ppo_rnn_minibatch_grads",
                "ppo_rnn_sgd_phase", "ppo_rollout_cnn",
                "ppo_cnn_minibatch_grads", "ppo_cnn_sgd_phase",
                "impala_minibatch_grads", "impala_sgd_phase", "grad_sumsq"]


def mesh_main_paths(dev):
    """The data mesh's main paths: (name, phase, kernels it must launch)."""
    return [
        ("mesh_world1_train", lambda: mesh_world1_train(dev),
         ["ppo_rollout", *K2_STAGES, "ppo_minibatch_grads",
          "ppo_rollout_cnn", "ppo_rollout_cnn_stages",
          "ppo_cnn_minibatch_grads", "ppo_rnn_rollout", *K7_STAGES,
          "ppo_rnn_minibatch_grads", "impala_minibatch_grads", *K6_STAGES,
          "grad_sumsq"]),
        ("mesh_two_ranks", lambda: mesh_two_ranks(dev),
         ["ppo_rollout", *K2_STAGES, "ppo_minibatch_grads", "grad_sumsq"]),
        ("mesh_clip_ranks", lambda: mesh_clip_ranks(dev), CLIP_KERNELS)]


# ---- the env kernels at (agents, queue) pairs outside the presets --------

# The pairs the smoke builds and drives (ROADMAP T-5), each built at first
# use into a library of its own (kernels/build.py pair_library): medium
# with 6 agents (the train CLI's --env medium --env-config
# '{"num_agents": 6}', queue 8), and the 15x15 map with 12 agents, queue
# 24 and 12 initial requests. K1's batch at each: 4096, and BASELINE
# config 3's 8192.
PAIRS = {"a6q8": medium_config(num_agents=6),
         "a12q24": large_config(num_agents=12, queue_capacity=24,
                                init_requests=12)}
PAIR_K1_B = {"a6q8": CHECK_B, "a12q24": 8192}
PAIR_CLI_ENV = {"a6q8": ["--env", "medium", "--env-config",
                         '{"num_agents": 6}'],
                "a12q24": ["--env", "large", "--env-config",
                           '{"num_agents": 12, "queue_capacity": 24, '
                           '"init_requests": 12}']}
ORACLE_ENVS = 8     # envs of K1's step-for-step check against the oracle
PAIR_UPDATES = 3    # updates of each pair main path
PAIR_GROUPS_B = 1024  # envs of the 12-policy path at (12, 24)
PER_AGENT_12 = tuple(range(12))  # one policy per agent at (12, 24)
PAIR_K1_LAUNCHES = {}  # K1's launches by pair in the pair_evaluate path
STACK = re.compile(r"(\d+) bytes stack frame")
REGS = re.compile(r"Used (\d+) registers")


def build_phase(dev):
    """The library and every pair's library at once (one thread each, each
    starting its nvcc processes together): each build's wall seconds
    beside the others on a line of its own, the build logs to stderr."""
    jobs = {"library": build.library,
            **{name: functools.partial(build.pair_library, c.num_agents,
                                       c.queue_capacity)
               for name, c in PAIRS.items()}}

    def run(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        futs = {name: ex.submit(run, fn) for name, fn in jobs.items()}
        secs = {name: f.result() for name, f in futs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "builds_s": secs, "note": "all builds at once, on the host's "
          "cores together"})
    for name, c in PAIRS.items():
        emit({"phase": "build_pair", "pair": name,
              "agents_queue": [c.num_agents, c.queue_capacity],
              "seconds": secs[name], "sources": list(build.ENV_SOURCES),
              "k1": k1_ptxas(c.num_agents, c.queue_capacity)})
    print(build.build_log(), file=sys.stderr)
    for c in PAIRS.values():
        print(build.build_log(c.num_agents, c.queue_capacity),
              file=sys.stderr)


def k1_ptxas(A, R) -> dict:
    """K1's instance at (A, R) as ``-Xptxas -v`` reports it: registers a
    thread, stack frame and spill bytes."""
    name = f"greedy_rollout_kernelILi{A}ELi{R}E"
    lines = build.build_log(A, R).splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            for nxt in lines[i + 1:i + 4]:
                if m := STACK.search(nxt):
                    nums = [int(x) for x in re.findall(r"(\d+) bytes", nxt)]
                    out.update(stack_frame=nums[0], spill_stores=nums[1],
                               spill_loads=nums[2])
                if m := REGS.search(nxt):
                    out["registers"] = int(m.group(1))
    return out


def oracle_state_equal(st, key, ks, b) -> bool:
    """The oracle's state (and its draw key) against env ``b`` of the
    batched state ``ks`` (on the CPU)."""
    fields = ("agent_pos", "agent_req", "carrying", "req_pickup",
              "req_drop", "req_status", "req_agent")
    return (all(np.array_equal(np.asarray(getattr(st, f)),
                               getattr(ks, f)[b].numpy()) for f in fields)
            and st.t == int(ks.t[b]) and torch.equal(key, ks.key[b]))


def k1_oracle_check(dev, name, cfg, state):
    """K1 one tick a launch over the whole batch (``state``, env b reset
    from ``fold_in(PRNGKey(SEED), b)``), T = max_steps launches, against
    the port's NumPy oracle (``OracleEnv`` + ``greedy_actions`` on
    ``TorchDrawSource`` from env b's reset key) on the first ORACLE_ENVS
    envs: the reset, then every state field and the key after every tick,
    the tick's deliveries and the bits of its reward sum
    (``rollout.reward_sum_step`` of the oracle's event counts); then the
    chained ticks' final state equal to one launch of the whole episode."""
    T, n, f = cfg.max_steps, ORACLE_ENVS, torch.float32
    keys = rng.fold_in(rng.prng_key(SEED), torch.arange(n))
    envs = [oracle_mod.OracleEnv(cfg, oracle_mod.TorchDrawSource(k))
            for k in keys]

    def head(st):  # the first n envs of a batched state, on the CPU
        return st.replace(**{k: getattr(st, k)[:n].cpu()
                             for k in STATE_FIELDS})

    s, sc = state, head(state)
    for b, env in enumerate(envs):
        env.reset()
        require(oracle_state_equal(env.state, env.draws.key, sc, b),
                f"K1 {name}: env {b}'s reset differs from the oracle's")
    t0 = time.perf_counter()
    for t in range(T):
        s, kd, kr = rollout.greedy_rollout(cfg, s, 1)
        sc, kd, kr = head(s), kd[:n].cpu(), kr[:n].cpu()
        for b, env in enumerate(envs):
            _, _, _, _, info = env.step(
                oracle_mod.greedy_actions(cfg, env.state))
            counts = [torch.tensor(float(info[k].sum()), dtype=f)
                      for k in ("picked", "delivered", "collided")]
            require(oracle_state_equal(env.state, env.draws.key, sc, b),
                    f"K1 {name}: env {b} differs from the oracle at tick {t}")
            require(int(kd[b]) == int(info["delivered"].sum()) and bits_equal(
                kr[b:b + 1], rollout.reward_sum_step(cfg, *counts)[None]),
                f"K1 {name}: env {b}'s deliveries or reward sum differ from "
                f"the oracle's at tick {t}")
    wall = time.perf_counter() - t0
    whole = rollout.greedy_rollout(cfg, state, T)[0]
    require(state_equal(s, whole),
            f"K1 {name}: {T} one-tick launches differ from one launch")
    return {"oracle_envs": n, "ticks": T, "oracle_bit_equal": True,
            "chained_equal_one_launch": True, "oracle_check_s": wall}


def pair_checks(dev) -> dict:
    """The env kernels at each pair of PAIRS: K1 (``k1_pair_check``), K2,
    K7 (GRU) and K10 at (6, 8), K2 at (12, 24) with and without one policy
    per agent, K3 / K4 with that group map: each with the checks it has at
    the presets (the env fields bit-equal, the policy outputs within TOL,
    the learner within SGD_TOL). Returns the kernels line's results by
    row name."""
    c6, c12 = PAIRS["a6q8"], PAIRS["a12q24"]
    rows = {f"greedy_rollout_{n}": k1_pair_check(dev, n, c, PAIR_K1_B[n])
            for n, c in PAIRS.items()}
    rows["ppo_rollout_a6q8"] = k2_check(dev, "medium_a6q8", c6,
                                        mlp_model(c6, dev),
                                        phase="pair_check")
    rows["ppo_rnn_rollout_a6q8"] = k7_check(dev, "medium_a6q8", c6, "gru")
    rows["ppo_rollout_cnn_a6q8"] = k2_check(dev, "medium_a6q8", c6,
                                            cnn_model(c6, dev),
                                            phase="pair_check")
    emit_bound("K2", "large_a12q24", k2_check(
        dev, "large_a12q24", c12, mlp_model(c12, dev), phase="pair_check"))
    rows["ppo_rollout_groups_a12q24"] = k2_check(
        dev, "large_a12q24_per_agent", c12,
        groups_model(c12, PER_AGENT_12, dev), phase="pair_check",
        groups=PER_AGENT_12)
    tcfg = TrainConfig(num_envs=PAIR_GROUPS_B)
    emit_bound("K3 groups", "large_a12q24_per_agent", k3_check(
        dev, c12, tcfg=tcfg, name="large_a12q24_per_agent",
        groups=PER_AGENT_12))
    emit_bound("K4 groups", "large_a12q24_per_agent", k4_check(
        dev, c12, tcfg=tcfg, name="large_a12q24_per_agent",
        groups=PER_AGENT_12))
    return rows


def mlp_model(cfg, dev, hidden=HIDDEN[0], layers=HIDDEN[1]):
    """A seeded ``ActorCriticMLP`` of config 4's depth and width (or
    ``layers`` hidden layers ``hidden`` wide)."""
    return make_model(cfg, hidden_dim=hidden, num_layers=layers,
                      generator=torch.Generator().manual_seed(SEED),
                      device=dev)


def k1_pair_check(dev, name, cfg, B):
    """K1 at a pair: one greedy episode at B envs bit-equal to its twin on
    every state field, deliveries and reward-sum bits; the first
    ORACLE_ENVS envs step for step against the NumPy oracle
    (``k1_oracle_check``); both timed; the bound from bytes and from
    ``k1_int_ops``; the instance's registers and stack."""
    T = cfg.max_steps
    state, _ = reset_envs(cfg, B, SEED, dev)
    ks, kd, kr = rollout.greedy_rollout(cfg, state, T)
    ps, pd, pr = rollout.greedy_rollout_reference(cfg, state, T)
    err = max(max_abs_diff(ks, ps), float((kd - pd).abs().max()),
              float((kr - pr).abs().max()))
    require(err == 0.0 and state_equal(ks, ps) and bits_equal(kr, pr),
            f"K1 {name}: kernel differs from twin")
    oracle = k1_oracle_check(dev, name, cfg, state)
    k_ms = timed(lambda: rollout.greedy_rollout(cfg, state, T), 5)
    p_ms = timed(lambda: rollout.greedy_rollout_reference(cfg, state, T), 3)
    ops = k1_int_ops(cfg.num_agents, cfg.queue_capacity)
    bnd = bound(nbytes(state, ks, kd, kr, rollout.map_tables(cfg, dev)),
                8.0 * B * T, int_ops={k: float(ops[k]) * B * T
                                      for k in ("alu", "total")})
    emit({"phase": "pair_check", "kernel": "K1", "config": name,
          "agents_queue": [cfg.num_agents, cfg.queue_capacity], "B": B,
          "T": T, "bit_equal": True, "deliveries": int(kd.sum()), **oracle,
          "kernel_ms": k_ms, "plain_ms": p_ms,
          "kernel_env_steps_per_s": B * T / (k_ms / 1e3),
          "k1_ptxas": k1_ptxas(cfg.num_agents, cfg.queue_capacity),
          "int_ops_per_env_tick": ops, **bnd})
    return err, k_ms, p_ms, bnd


def cli_train(dev, out_dir, name, argv, n, make=None, arch="mlp"):
    """``python -m warehouse_tpu_torch.train`` with ``argv`` (config 4's
    other settings) for ``n`` updates, in this process: its metrics
    file's backends the kernels', its metrics finite; with ``make``, then
    the CLI's trainer at the same settings (medium, ``--hidden-dim``) for
    one update through the kernels and one through the plain path from the
    same state, whose metrics must agree."""
    from warehouse_tpu_torch.train.__main__ import main as train_main

    path = os.path.join(out_dir, f"{name}.jsonl")
    train_main([*argv, "--num-updates", str(n), "--log-every", "1",
                "--metrics-path", path])
    with open(path) as fh:
        lines = [json.loads(x) for x in fh]
    meta, rows = lines[0], lines[1:]
    require(meta.get("backends") == KERNELS,
            f"{name}: backends {meta.get('backends')}")
    require(len(rows) == n and all(
        np.isfinite(v) for r in rows for v in r.values()
        if isinstance(v, float)), f"{name}: metrics {rows}")
    line = {"phase": name, "cli": argv, "updates": n,
            "backends": meta["backends"], "last": rows[-1]}
    if make is not None:
        hidden = int(argv[argv.index("--hidden-dim") + 1])
        tr = make(medium_config(), TrainConfig(hidden_dim=hidden), arch,
                  device=dev)
        line.update(first_update_vs_plain=first_update_vs_plain(tr, dev,
                                                                 name),
                    tol=STEP_METRIC_TOL)
    emit(line)


def short_train(dev, name, make, cfg, tcfg, n, **kw):
    """``n`` updates of a trainer through the kernels, the first against
    the plain path's from the same state."""
    tr = make(cfg, tcfg, device=dev, **kw)
    first = first_update_vs_plain(tr, dev, name)
    _, out = run_updates(tr, n, name, dev, plain_n=0)
    emit({"phase": name, "agents_queue": [cfg.num_agents,
                                          cfg.queue_capacity],
          "hidden_dim": tcfg.hidden_dim, "num_layers": tcfg.num_layers,
          "model_dtype": tcfg.model_dtype, "first_update_vs_plain": first,
          "tol": STEP_METRIC_TOL, **out})


def pair_evaluate(dev):
    """``python -m warehouse_tpu_torch.evaluate --policy greedy`` at each
    pair, in this process (K1: one launch of the whole episode), at K1's
    batch of the pair: deliveries and returns printed, equal to
    ``evaluate_greedy``'s."""
    from warehouse_tpu_torch.evaluate import evaluate_greedy
    from warehouse_tpu_torch.evaluate import main as eval_main

    import contextlib
    import io

    for name, cfg in PAIRS.items():
        buf, n0 = io.StringIO(), rollout.greedy_rollout.launches
        with contextlib.redirect_stdout(buf):
            eval_main([*PAIR_CLI_ENV[name], "--policy", "greedy",
                       "--episodes", str(PAIR_K1_B[name])])
        PAIR_K1_LAUNCHES[name] = rollout.greedy_rollout.launches - n0
        got = dict(line.split(": ") for line in buf.getvalue().splitlines())
        want = evaluate_greedy(cfg, PAIR_K1_B[name], 0, dev)
        require({k: float(v) for k, v in got.items()} == {
            k: float(v) for k, v in want.items()},
            f"pair_evaluate {name}: {got} against {want}")
        require(want["mean_deliveries_per_episode"] > 0,
                f"pair_evaluate {name}: no deliveries")
        emit({"phase": "pair_evaluate", "pair": name, **want})


def pair_main_paths(dev, out_dir):
    """The pairs' main paths: (name, phase, kernels it must launch)."""
    c6, c12 = PAIRS["a6q8"], PAIRS["a12q24"]
    return [
        ("pair_ppo_train", lambda: cli_train(
            dev, out_dir, "pair_ppo_train", PAIR_CLI_ENV["a6q8"],
            PAIR_UPDATES),
         ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase",
          "ppo_minibatch_grads"]),
        ("pair_gru_train", lambda: short_train(
            dev, "pair_gru_train", make_train_rnn, c6,
            TrainConfig(num_updates=RNN_SCHEDULE), PAIR_UPDATES, arch="gru"),
         ["ppo_rnn_rollout", *K7_STAGES, "ppo_rnn_sgd_phase",
          "ppo_rnn_minibatch_grads"]),
        ("pair_cnn_train", lambda: short_train(
            dev, "pair_cnn_train", make_train, c6,
            TrainConfig(num_updates=CNN_SCHEDULE), PAIR_UPDATES, arch="cnn"),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_stages", "ppo_cnn_sgd_phase",
          "ppo_cnn_minibatch_grads"]),
        ("pair_groups_train", lambda: short_train(
            dev, "pair_groups_train", make_train, c12,
            TrainConfig(num_envs=PAIR_GROUPS_B, num_updates=TRAIN_SCHEDULE),
            PAIR_UPDATES, policy_groups=PER_AGENT_12),
         ["ppo_rollout", "ppo_rollout_groups", *K2_STAGES,
          "ppo_sgd_phase_groups", "ppo_minibatch_grads_groups"]),
        ("pair_evaluate", lambda: pair_evaluate(dev), ["greedy_rollout"])]


# ---- the TPU kernels' widths and depths (ROADMAP T-6) --------------------

# The shapes the kernels took only once any width and depth ran: a hidden
# width of 50 (no multiple of 4: K7's cell and encoder, K8 / K9's cell,
# K10-K12's trunk), 5 MLP hidden layers (K2-K6; 4 recurrent encoder
# layers at num_layers 5, as make_model builds them: K7-K9) and 8 MLP
# hidden layers (more than a launch of the prep's or stage F's table
# holds before they were split: the depth cap is gone, not moved).
SHAPE_H50 = (50, HIDDEN[1])
SHAPE_DEEP = (HIDDEN[0], 5)
SHAPE_DEEP8 = (HIDDEN[0], 8)
SHAPE_UPDATES = 3  # updates of each shape main path
SHAPE_SECONDS = {}  # each shape check's wall seconds


def shape_tcfg(schedule, shape, **kw):
    return TrainConfig(num_updates=schedule, hidden_dim=shape[0],
                       num_layers=shape[1], **kw)


def shape_checks(dev) -> dict:
    """Every kernel at the widths and depths of ROADMAP T-6, against its
    plain twin at the tolerance of its preset's check (each check as at
    config 4): K7-K9 at hidden 50 (GRU and LSTM, K8 / K9 in float32 and
    bf16) and at 4 encoder layers; K10-K12 at trunk width 50 (the ego
    window, the 9x9 global view, K10 with groups, K11 / K12 in bf16);
    K2-K6 at 5 and 8 hidden layers, K3 / K4 with groups, at D = 611 and
    in bf16 at 5, K5 with RMSProp and Adam; and the stage kernels at those
    shapes. Returns the kernels line's entries (the others print a bound
    line)."""
    cfg, shelves = medium_config(), shelves_config()
    medium_g, shelves_g = (c.replace(global_obs=True) for c in (cfg, shelves))
    out = {}

    def run(key, fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        SHAPE_SECONDS[key] = time.perf_counter() - t0
        return res

    # K7-K9: hidden 50, then 4 encoder layers.
    h50, deep = SHAPE_H50, SHAPE_DEEP
    out["ppo_rnn_rollout_h50"] = run("k7_gru_h50", k7_check, dev,
                                     "medium_h50", cfg, "gru", shape=h50)
    emit_bound("K7 lstm", "config4_h50", run(
        "k7_lstm_h50", k7_check, dev, "medium_h50", cfg, "lstm", shape=h50))
    out["ppo_rnn_rollout_deep"] = run("k7_gru_deep", k7_check, dev,
                                      "medium_enc4", cfg, "gru", shape=deep)
    out["ppo_rnn_sgd_phase_h50"] = run("k8_gru_h50", k8_check, dev, cfg,
                                       "gru", shape=h50, plain_reps=1)
    out["ppo_rnn_minibatch_grads_h50"] = run("k9_gru_h50", k9_check, dev,
                                             cfg, "gru", shape=h50)
    emit_bound("K8 lstm", "config4_h50", run(
        "k8_lstm_h50", k8_check, dev, cfg, "lstm", shape=h50, plain_reps=1))
    emit_bound("K9 lstm", "config4_h50", run(
        "k9_lstm_h50", k9_check, dev, cfg, "lstm", shape=h50))
    emit_bound("K8 bf16", "config4_h50", run(
        "k8_gru_h50_bf16", k8_check, dev, cfg, "gru", True, shape=h50, plain_reps=1))
    emit_bound("K9 bf16", "config4_h50", run(
        "k9_gru_h50_bf16", k9_check, dev, cfg, "gru", True, shape=h50))
    out["ppo_rnn_sgd_phase_h50_bf16"] = run(
        "k8_lstm_h50_bf16", k8_check, dev, cfg, "lstm", True, shape=h50, plain_reps=1)
    out["ppo_rnn_minibatch_grads_h50_bf16"] = run(
        "k9_lstm_h50_bf16", k9_check, dev, cfg, "lstm", True, shape=h50)
    out["ppo_rnn_sgd_phase_deep"] = run("k8_gru_deep", k8_check, dev, cfg,
                                        "gru", shape=deep, plain_reps=1)
    out["ppo_rnn_minibatch_grads_deep"] = run("k9_gru_deep", k9_check, dev,
                                              cfg, "gru", shape=deep)
    for arch in ("gru", "lstm"):
        run(f"act_rnn_stages_{arch}_h50", act_rnn_stage_check, dev, cfg,
            "config4_h50", arch, shape=h50)
    run("act_rnn_stages_gru_deep", act_rnn_stage_check, dev, cfg,
        "config4_enc4", "gru", shape=deep)
    run("rnn_stages_gru_h50", rnn_stage_check, dev, cfg, "gru", shape=h50)
    run("rnn_stages_lstm_h50_bf16", rnn_stage_check, dev, cfg, "lstm", True,
        shape=h50)
    run("rnn_stages_gru_h50_ragged", rnn_stage_check, dev, cfg, "gru",
        ragged=True, shape=h50)
    run("rnn_stages_gru_deep", rnn_stage_check, dev, cfg, "gru", shape=deep)
    # K10-K12: trunk width 50.
    W = h50[0]
    out["ppo_rollout_cnn_h50"] = run("k10_h50", k2_check, dev, "medium_h50",
                                     cfg, cnn_model(cfg, dev, W))
    emit_bound("K10", "medium_global_h50", run(
        "k10_global_h50", k2_check, dev, "medium_global_h50", medium_g,
        cnn_model(medium_g, dev, W), phase="global_check"))
    emit_bound("K10 groups", "config4_h50", run(
        "k10_groups_h50", k2_check, dev, "medium_h50_groups", cfg,
        cnn_groups_model(cfg, CONFIG4_GROUPS, dev, W),
        groups=CONFIG4_GROUPS))
    ctc = shape_tcfg(CNN_SCHEDULE, h50)
    out["ppo_cnn_sgd_phase_h50"] = run("k11_h50", k3_check, dev, cfg,
                                       cnn=True, tcfg=ctc, name="config4_h50",
                                       phase_gate=False)
    out["ppo_cnn_minibatch_grads_h50"] = run(
        "k12_h50", k4_check, dev, cfg, cnn=True, tcfg=ctc, name="config4_h50")
    emit_bound("K11 bf16", "config4_h50", run(
        "k11_h50_bf16", k3_check, dev, cfg, cnn=True, tcfg=ctc,
        name="config4_h50", bf16=True))
    emit_bound("K12 bf16", "config4_h50", run(
        "k12_h50_bf16", k4_check, dev, cfg, cnn=True, tcfg=ctc,
        name="config4_h50", bf16=True))
    emit_bound("K11", "medium_global_h50", run(
        "k11_global_h50", k3_check, dev, medium_g, cnn=True, tcfg=ctc,
        name="medium_global_h50", per_step=True))
    run("cnn_stages_h50", cnn_stage_check, dev, cfg, "config4_h50", hidden=W)
    run("cnn_stages_global_h50", cnn_stage_check, dev, medium_g,
        "medium_global_h50", hidden=W)
    run("act_cnn_stages_h50", act_cnn_stage_check, dev, cfg, "config4_h50",
        hidden=W)
    run("act_cnn_stages_groups_h50", act_cnn_stage_check, dev, cfg,
        "config4_h50_groups", groups=CONFIG4_GROUPS, hidden=W)
    # K2-K6: 5 and 8 hidden layers.
    for tag, shape in (("deep", SHAPE_DEEP), ("deep8", SHAPE_DEEP8)):
        L = shape[1]
        ptc = shape_tcfg(TRAIN_SCHEDULE, shape)
        out[f"ppo_rollout_{tag}"] = run(
            f"k2_{tag}", k2_check, dev, f"medium_{tag}", cfg,
            mlp_model(cfg, dev, *shape))
        out[f"ppo_sgd_phase_{tag}"] = run(f"k3_{tag}", k3_check, dev, cfg,
                                          tcfg=ptc, name=f"config4_{tag}",
                                          per_step=True,
                                          phase_gate=tag == "deep")
        out[f"ppo_minibatch_grads_{tag}"] = run(
            f"k4_{tag}", k4_check, dev, cfg, tcfg=ptc, name=f"config4_{tag}")
        out[f"impala_sgd_phase_{tag}"] = run(f"k5_{tag}", k5_check, dev,
                                             cfg, layers=L)
        out[f"impala_minibatch_grads_{tag}"] = run(f"k6_{tag}", k6_check,
                                                   dev, cfg, shape=shape)
    dtc = shape_tcfg(TRAIN_SCHEDULE, deep)
    emit_bound("K2 groups", "shelves_groups_deep", run(
        "k2_groups_deep", k2_check, dev, "shelves_groups_deep", shelves,
        groups_model(shelves, GROUPS, dev, deep), True, groups=GROUPS))
    gtc = groups_tcfg().replace(num_layers=deep[1])
    emit_bound("K3 groups", "shelves_groups_deep", run(
        "k3_groups_deep", k3_check, dev, shelves, tcfg=gtc,
        name="shelves_groups_deep", groups=GROUPS, per_step=True))
    emit_bound("K4 groups", "shelves_groups_deep", run(
        "k4_groups_deep", k4_check, dev, shelves, tcfg=gtc,
        name="shelves_groups_deep", groups=GROUPS))
    emit_bound("K3", "shelves_global_deep", run(
        "k3_global_deep", k3_check, dev, shelves_g,
        tcfg=global_tcfg().replace(num_layers=deep[1]),
        name="shelves_global_deep", per_step=True))
    emit_bound("K3 bf16", "config4_deep", run(
        "k3_deep_bf16", k3_check, dev, cfg, tcfg=dtc, name="config4_deep",
        bf16=True))
    emit_bound("K4 bf16", "config4_deep", run(
        "k4_deep_bf16", k4_check, dev, cfg, tcfg=dtc, name="config4_deep",
        bf16=True))
    run("act_mlp_stages_deep", act_mlp_stage_check, dev, cfg, "config4_deep",
        mlp_model(cfg, dev, *deep))
    run("mlp_stages_deep", mlp_stage_check, dev, cfg, "config4_deep",
        tcfg=dtc)
    run("vtrace_stages_deep", vtrace_stage_check, dev, cfg, "config4_deep",
        layers=deep[1])
    emit({"phase": "shape_seconds", "seconds": SHAPE_SECONDS,
          "total_s": sum(SHAPE_SECONDS.values())})
    return out


# The meshed learners at T-6's shapes: the GRU at hidden 50 (K9), PPO at 5
# hidden layers (K4), one world-1 update each.
SHAPE_MESH_PATHS = [
    ("gru_h50", make_train_rnn, dict(num_updates=RNN_SCHEDULE,
                                     hidden_dim=SHAPE_H50[0]), "gru",
     sgd_rnn.ppo_rnn_minibatch_grads, sgd_rnn.RnnLaunch, "clip_adam",
     SGD_TOL),
    ("ppo_deep", make_train, dict(num_updates=TRAIN_SCHEDULE,
                                  num_layers=SHAPE_DEEP[1]), "mlp",
     sgd.ppo_minibatch_grads, sgd.MlpLaunch, "clip_adam", SGD_TOL)]


def shape_main_paths(dev, out_dir):
    """T-6's main paths at config 4: (name, phase, kernels it must
    launch)."""
    rnn = ["ppo_rnn_rollout", *K7_STAGES, "ppo_rnn_sgd_phase",
           "ppo_rnn_minibatch_grads"]
    mlp = ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase", "ppo_minibatch_grads"]
    impala = ["ppo_rollout", *K2_STAGES, "impala_sgd_phase",
              "impala_minibatch_grads", *K6_STAGES]
    cfg, W = medium_config(), str(SHAPE_H50[0])
    return [
        ("gru_h50_train", lambda: cli_train(
            dev, out_dir, "gru_h50_train", ["--arch", "gru", "--hidden-dim",
                                            W], SHAPE_UPDATES, make_train_rnn,
            "gru"), rnn),
        ("lstm_h50_train", lambda: short_train(
            dev, "lstm_h50_train", make_train_rnn, cfg,
            shape_tcfg(RNN_SCHEDULE, SHAPE_H50, model_dtype=BF16),
            SHAPE_UPDATES, arch="lstm"),
         ["ppo_rnn_rollout", *K7_STAGES, "ppo_rnn_sgd_phase_bf16",
          "ppo_rnn_minibatch_grads_bf16"]),
        ("cnn_h50_train", lambda: cli_train(
            dev, out_dir, "cnn_h50_train", ["--arch", "cnn", "--hidden-dim",
                                            W], SHAPE_UPDATES, make_train,
            "cnn"),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_stages", "ppo_cnn_sgd_phase",
          "ppo_cnn_minibatch_grads"]),
        ("mlp_deep_train", lambda: short_train(
            dev, "mlp_deep_train", make_train, cfg,
            shape_tcfg(TRAIN_SCHEDULE, SHAPE_DEEP), SHAPE_UPDATES), mlp),
        ("mlp_deep8_train", lambda: short_train(
            dev, "mlp_deep8_train", make_train, cfg,
            shape_tcfg(TRAIN_SCHEDULE, SHAPE_DEEP8), SHAPE_UPDATES), mlp),
        ("impala_deep_train", lambda: short_train(
            dev, "impala_deep_train", make_train_impala, cfg,
            shape_tcfg(IMPALA_SCHEDULE, SHAPE_DEEP, impala_rmsprop=False),
            SHAPE_UPDATES), impala),
        ("impala_deep8_train", lambda: short_train(
            dev, "impala_deep8_train", make_train_impala, cfg,
            shape_tcfg(IMPALA_SCHEDULE, SHAPE_DEEP8, impala_rmsprop=False),
            SHAPE_UPDATES), impala),
        ("gru_deep_train", lambda: short_train(
            dev, "gru_deep_train", make_train_rnn, cfg,
            shape_tcfg(RNN_SCHEDULE, SHAPE_DEEP), SHAPE_UPDATES, arch="gru"),
         rnn),
        ("mesh_shapes_train", lambda: mesh_world1_train(
            dev, SHAPE_MESH_PATHS, 1, "mesh_shapes_train"),
         ["ppo_rnn_rollout", *K7_STAGES, "ppo_rnn_minibatch_grads",
          "ppo_rollout", *K2_STAGES, "ppo_minibatch_grads", "grad_sumsq"])]


# The kernels line's T-6 entries: (source, TPU kernel, main path whose
# launches of the named wrapper count).
SHAPE_SOURCES = {
    "ppo_rnn_rollout_h50": ("act_rnn.cu", "pallas/act.py:747",
                            "gru_h50_train", "ppo_rnn_rollout"),
    "ppo_rnn_rollout_deep": ("act_rnn.cu", "pallas/act.py:747",
                             "gru_deep_train", "ppo_rnn_rollout"),
    "ppo_rnn_sgd_phase_h50": ("sgd_rnn.cu", "pallas/sgd_rnn.py:551",
                              "gru_h50_train", "ppo_rnn_sgd_phase"),
    "ppo_rnn_minibatch_grads_h50": ("sgd_rnn.cu", "pallas/sgd_rnn.py:665",
                                    "gru_h50_train",
                                    "ppo_rnn_minibatch_grads"),
    "ppo_rnn_sgd_phase_h50_bf16": ("sgd_rnn.cu", "pallas/sgd_rnn.py:551",
                                   "lstm_h50_train",
                                   "ppo_rnn_sgd_phase_bf16"),
    "ppo_rnn_minibatch_grads_h50_bf16": ("sgd_rnn.cu",
                                         "pallas/sgd_rnn.py:665",
                                         "lstm_h50_train",
                                         "ppo_rnn_minibatch_grads_bf16"),
    "ppo_rnn_sgd_phase_deep": ("sgd_rnn.cu", "pallas/sgd_rnn.py:551",
                               "gru_deep_train", "ppo_rnn_sgd_phase"),
    "ppo_rnn_minibatch_grads_deep": ("sgd_rnn.cu", "pallas/sgd_rnn.py:665",
                                     "gru_deep_train",
                                     "ppo_rnn_minibatch_grads"),
    "ppo_rollout_cnn_h50": ("act_cnn.cu", "pallas/act.py:1073",
                            "cnn_h50_train", "ppo_rollout_cnn"),
    "ppo_cnn_sgd_phase_h50": ("sgd_cnn.cu", "pallas/sgd_cnn.py:482",
                              "cnn_h50_train", "ppo_cnn_sgd_phase"),
    "ppo_cnn_minibatch_grads_h50": ("sgd_cnn.cu", "pallas/sgd_cnn.py:595",
                                    "cnn_h50_train",
                                    "ppo_cnn_minibatch_grads"),
    **{f"{k}_{tag}": (src, tpu, path.format(tag), w)
       for tag in ("deep", "deep8")
       for k, src, tpu, path, w in (
           ("ppo_rollout", "act.cu", "pallas/act.py:1028",
            "mlp_{}_train", "ppo_rollout"),
           ("ppo_sgd_phase", "sgd.cu", "pallas/sgd.py:691",
            "mlp_{}_train", "ppo_sgd_phase"),
           ("ppo_minibatch_grads", "sgd.cu", "pallas/sgd.py:818",
            "mlp_{}_train", "ppo_minibatch_grads"),
           ("impala_sgd_phase", "vtrace_sgd.cu", "pallas/vtrace_sgd.py:445",
            "impala_{}_train", "impala_sgd_phase"),
           ("impala_minibatch_grads", "vtrace_sgd.cu",
            "pallas/vtrace_sgd.py:553", "impala_{}_train",
            "impala_minibatch_grads"))}}


def shape_launches(paths: dict) -> dict:
    """The T-6 entries' launches, from their main paths."""
    return {name: paths[path][wrapper]
            for name, (_, _, path, wrapper) in SHAPE_SOURCES.items()}


def shape_kernel_rows(checks: dict, launches: dict) -> list:
    """The kernels line's rows of the T-6 entries."""
    csrc = "warehouse_tpu_torch/kernels/csrc/"
    return [kernel_row(name, csrc + src, "warehouse_tpu/" + tpu,
                       launches[name], checks[name])
            for name, (src, tpu, _, _) in SHAPE_SOURCES.items()]


def kernel_row(name, source, replaces, launches, res) -> dict:
    """One entry of the kernels line from a check's ``(max_abs_err, ms,
    plain_ms, bound[, library_ms])``."""
    err, ms, plain_ms, bnd, *lib = res
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bnd["bound_ms"], "bound_by": bnd["bound_by"],
            "library_ms": lib[0] if lib else None,
            "bound_bytes": bnd["bytes"], "bound_flops": bnd["flops"],
            **{k: bnd[k] for k in ("int_ops", "int_alu_ops",
                                   "bytes_bound_ms", "int_ops_bound_ms",
                                   "cuda_core_bound_ms") if k in bnd}}


def update_profile(dev, cfg, arch):
    """``torch.profiler`` over 3 config-4 updates of the recurrent
    (``arch`` "gru" / "lstm") or the CNN trainer (after 2 of warm-up):
    device milliseconds per update by kernel name, the device's busy share
    of the profiled wall."""
    from torch.profiler import ProfilerActivity, profile

    if arch == "cnn":
        tr = make_train(cfg, TrainConfig(num_updates=CNN_SCHEDULE),
                        arch="cnn", device=dev)
    else:
        tr = make_train_rnn(cfg, TrainConfig(num_updates=RNN_SCHEDULE), arch,
                            device=dev)
    rs = tr.init(rng.prng_key(0, dev))
    for _ in range(2):
        rs, _ = tr.train_step(rs)
    torch.cuda.synchronize()
    n, t0 = 3, time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            rs, _ = tr.train_step(rs)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((getattr(e, "device_time_total", 0.0) / 1e3 / n, e.key,
                    e.count // n) for e in prof.key_averages()
                   if getattr(e, "device_time_total", 0.0) > 0
                   and e.device_type.name != "CPU"), reverse=True)
    busy = sum(ms for ms, _, _ in rows)
    emit({"phase": "update_profile", "arch": arch, "updates": n,
          "profiled_wall_ms_per_update": wall_ms / n,
          "device_ms_per_update": busy,
          "device_busy_share": busy * n / wall_ms,
          "kernels": len(rows),
          "top": [{"name": k[:60], "ms_per_update": ms, "launches": c}
                  for ms, k, c in rows[:12]]})


def main(argv=()) -> int:
    t_start = time.perf_counter()
    print(nvidia_smi(), flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)

    build_phase(dev)
    profiled = [a for flag, archs in (("--profile-rnn", ("gru", "lstm")),
                                      ("--profile-cnn", ("cnn",)))
                if flag in argv for a in archs]
    if profiled:  # a profile instead of the smoke run
        for arch in profiled:
            update_profile(dev, medium_config(), arch)
        print(nvidia_smi(), flush=True)
        return 0
    if "--mesh-cards" in argv:  # one NCCL rank a card, against world 1
        mesh_cards()
        print(nvidia_smi(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    if "--mesh" in argv:  # the data mesh's paths alone
        for name, fn, kernels in mesh_main_paths(dev):
            main_path(name, fn, kernels)
        print(nvidia_smi(), flush=True)
        return 0
    if "--pop" in argv:  # F-10's checks and the population axis alone
        sumsq_check(dev)
        main_path("mesh_clip_ranks", lambda: mesh_clip_ranks(dev),
                  CLIP_KERNELS)
        refs = pop_references(dev)
        for name, fn, kernels, absent in pop_main_paths(dev, refs):
            main_path(name, fn, kernels, absent)
        print(nvidia_smi(), flush=True)
        return 0
    if "--pairs" in argv:  # the pairs' checks and main paths alone
        pair_checks(dev)
        with tempfile.TemporaryDirectory() as d:
            for name, fn, kernels in pair_main_paths(dev, d):
                main_path(name, fn, kernels)
        print(nvidia_smi(), flush=True)
        return 0

    checks = {"greedy_rollout": k1_check(dev)}
    cfg = medium_config()
    model = make_model(cfg, hidden_dim=HIDDEN[0], num_layers=HIDDEN[1],
                       generator=torch.Generator().manual_seed(SEED),
                       device=dev)
    checks["ppo_rollout"] = k2_check(dev, "medium", cfg, model)
    shelves = shelves_config()
    k2_check(dev, "shelves", shelves,
             make_model(shelves, hidden_dim=HIDDEN[0], num_layers=HIDDEN[1],
                        generator=torch.Generator().manual_seed(SEED),
                        device=dev), mask_actions=True)
    checks["ppo_sgd_phase"] = k3_check(dev, cfg, per_step=True)
    checks["ppo_minibatch_grads"] = k4_check(dev, cfg)
    mlp_stage_check(dev, cfg)
    mlp_stage_check(dev, cfg, ragged=True)
    checks["impala_sgd_phase"] = k5_check(dev, cfg)
    checks["impala_minibatch_grads"] = k6_check(dev, cfg)
    # K6's stage kernels: config 4 (into the kernels line), a ragged slice
    # (masked, with the bootstrap) and hidden 256.
    for st, res in vtrace_stage_check(dev, cfg, "config4").items():
        checks[f"impala_minibatch_grads_{st}"] = res
    vtrace_stage_check(dev, cfg, "config4_ragged", ragged=True)
    vtrace_stage_check(dev, cfg, "config4_hidden256", hidden=WIDE_HIDDEN)
    # The recurrent kernels: the LSTM's checks run too; the GRU's numbers
    # (the CLI's first recurrent cell) go into the kernels line.
    emit_bound("K7 lstm", "config4", k7_check(dev, "medium", cfg, "lstm"))
    k7_check(dev, "shelves", shelves, "gru", mask_actions=True)
    checks["ppo_rnn_rollout"] = k7_check(dev, "medium", cfg, "gru")
    # K7's stage kernels, one step's rows each: the GRU at config 4 (into
    # the kernels line), the LSTM, the masked GRU on shelves, a ragged B.
    for st, res in act_rnn_stage_check(dev, cfg, "config4", "gru").items():
        checks[f"ppo_rnn_rollout_{st.rstrip('0123456789')}"] = res
    for st, res in act_rnn_stage_check(dev, cfg, "config4", "lstm").items():
        emit_bound(f"K7 lstm {st}", "config4", res[:4])
    act_rnn_stage_check(dev, shelves, "shelves_masked", "gru", masked=True)
    act_rnn_stage_check(dev, cfg, "config4_ragged", "gru", B=ACT_RAGGED_B)
    emit_bound("K8 lstm", "config4", k8_check(dev, cfg, "lstm"))
    emit_bound("K9 lstm", "config4", k9_check(dev, cfg, "lstm"))
    checks["ppo_rnn_sgd_phase"] = k8_check(dev, cfg, "gru")
    checks["ppo_rnn_minibatch_grads"] = k9_check(dev, cfg, "gru")
    for arch in ("gru", "lstm"):
        rnn_stage_check(dev, cfg, arch)
        rnn_stage_check(dev, cfg, arch, ragged=True)
    # The CNN kernels, against true convolutions (IEEE float32 in cuDNN:
    # models.policy.conv_flags).
    checks["ppo_rollout_cnn"] = k2_check(dev, "medium", cfg,
                                         cnn_model(cfg, dev))
    k2_check(dev, "shelves", shelves, cnn_model(shelves, dev),
             mask_actions=True)
    checks["ppo_cnn_sgd_phase"] = k3_check(dev, cfg, cnn=True, per_step=True)
    checks["ppo_cnn_minibatch_grads"] = k4_check(dev, cfg, cnn=True)
    cnn_stage_check(dev, cfg)
    cnn_stage_check(dev, cfg, ragged=True)
    # The shaping option of K2 and K10: medium and shelves, a mid-episode
    # chunk and a truncating one; the shelves mid-episode numbers (the
    # trained path's shapes) go into the kernels line.
    for key, models in (("ppo_rollout_shaped", None),
                        ("ppo_rollout_cnn_shaped", cnn_model)):
        for name, c in (("medium", cfg), ("shelves", shelves)):
            m = (models(c, dev) if models else make_model(
                c, hidden_dim=HIDDEN[0], num_layers=HIDDEN[1],
                generator=torch.Generator().manual_seed(SEED), device=dev))
            k2_check(dev, name, c, m, True, shaped=True, truncating=True)
            res = k2_check(dev, name, c, m, True, shaped=True)
        checks[key] = res
    # Global observations and hidden 256: the recipe's shapes (shelves, D =
    # 611, 2048 envs, masked and shaped) go into the kernels line for K2 /
    # K3 / K4, medium's 9x9 map for the CNN kernels, config 4 at hidden 256
    # (the hidden256_train path's shapes) for K2 at that width; K3 / K4 are
    # held at that width too.
    shelves_g, medium_g = (c.replace(global_obs=True) for c in (shelves, cfg))

    k2_check(dev, "medium_global", medium_g, mlp_model(medium_g, dev),
             phase="global_check")
    checks["ppo_rollout_global"] = k2_check(
        dev, "shelves_global", shelves_g, mlp_model(shelves_g, dev), True,
        shaped=True, B=GLOBAL_B, phase="global_check")
    checks["ppo_rollout_hidden256"] = k2_check(
        dev, "medium_hidden256", cfg, mlp_model(cfg, dev, WIDE_HIDDEN),
        phase="hidden256_check")
    checks["ppo_rollout_cnn_global"] = k2_check(
        dev, "medium_global", medium_g, cnn_model(medium_g, dev),
        phase="global_check")
    checks["ppo_sgd_phase_global"] = k3_check(
        dev, shelves_g, tcfg=global_tcfg(), name="shelves_global")
    checks["ppo_minibatch_grads_global"] = k4_check(
        dev, shelves_g, tcfg=global_tcfg(), name="shelves_global")
    emit_bound("K3", "config4_hidden256", k3_check(
        dev, cfg, tcfg=hidden256_tcfg(), name="config4_hidden256"))
    emit_bound("K4", "config4_hidden256", k4_check(
        dev, cfg, tcfg=hidden256_tcfg(), name="config4_hidden256"))
    mlp_stage_check(dev, shelves_g, name="shelves_global",
                    tcfg=global_tcfg())
    mlp_stage_check(dev, cfg, name="config4_hidden256",
                    tcfg=hidden256_tcfg())
    checks["ppo_cnn_sgd_phase_global"] = k3_check(
        dev, medium_g, cnn=True, name="medium_global")
    checks["ppo_cnn_minibatch_grads_global"] = k4_check(
        dev, medium_g, cnn=True, name="medium_global")
    cnn_stage_check(dev, medium_g, name="medium_global")
    cnn_stage_check(dev, medium_g, name="medium_global", ragged=True)
    # K10's stage kernels, one step's rows each: config 4, a ragged B, the
    # 9x9 global view (with its two groups too) and the shelves groups
    # recipe (masked, shaped, 2048 envs).
    act_cnn_stage_check(dev, cfg, "config4")
    act_cnn_stage_check(dev, cfg, "config4_ragged", B=ACT_RAGGED_B)
    act_cnn_stage_check(dev, medium_g, "medium_global")
    act_cnn_stage_check(dev, medium_g, "medium_global_groups",
                        groups=CONFIG4_GROUPS)
    act_cnn_stage_check(dev, shelves, "shelves_groups", groups=GROUPS,
                        B=GROUPS_B, shaped=True)
    # K2's stage kernels, one step's rows each: config 4 (into the kernels
    # line), a ragged B, hidden 256, the shelves global recipe (D = 611,
    # masked, shaped, 2048 envs) and the shelves groups recipe.
    k2_stages = act_mlp_stage_check(dev, cfg, "config4", model)
    act_mlp_stage_check(dev, cfg, "config4_ragged", model, B=ACT_RAGGED_B)
    act_mlp_stage_check(dev, cfg, "config4_hidden256",
                        mlp_model(cfg, dev, WIDE_HIDDEN))
    act_mlp_stage_check(dev, shelves_g, "shelves_global",
                        mlp_model(shelves_g, dev),
                        B=GLOBAL_B, shaped=True)
    act_mlp_stage_check(dev, shelves, "shelves_groups",
                        groups_model(shelves, GROUPS, dev), groups=GROUPS,
                        B=GROUPS_B, shaped=True)
    for st in act.ACT_MLP_STAGES:
        checks[f"ppo_rollout_{st}"] = k2_stages[st]
    emit_bound("K5", "config4_hidden256", k5_check(dev, cfg,
                                                   hidden=WIDE_HIDDEN))
    # Policy groups: the recipe's shapes go into the kernels line.
    (checks["ppo_rollout_groups"], checks["ppo_sgd_phase_groups"],
     checks["ppo_minibatch_grads_groups"]) = groups_check(dev, cfg, shelves)
    # bf16 operands in the learners: config 4's numbers (the GRU's for K8 /
    # K9) go into the kernels line.
    checks.update(bf16_check(dev, cfg, shelves, shelves_g, medium_g))
    # K10 with groups: the shelves recipe's shapes, one policy per agent and
    # the global view go into the kernels line.
    (checks["ppo_rollout_cnn_groups"], checks["ppo_rollout_cnn_per_agent"],
     checks["ppo_rollout_cnn_groups_global"]) = k10_groups_check(dev, cfg,
                                                                  shelves)
    # The plain CNN learner gives the same bits on every run.
    repro_check(dev, shelves)
    # The learner options no kernel computes, on the card.
    m4_check(dev, cfg)
    # The learners' inputs from the per-step acting phase: K5 / K6 on a
    # chunk of 24 steps with a truncation inside it in every env, K8 / K9 at
    # D = 411 (the GRU on the 9x9 global view).
    emit_bound("K5 ragged", "config4_T24", k5_check(dev, cfg, ragged=True))
    emit_bound("K6 ragged", "config4_T24", k6_check(dev, cfg, ragged=True))
    emit_bound("K8 global", "medium_global_D411",
               k8_check(dev, medium_g, "gru"))
    emit_bound("K9 global", "medium_global_D411",
               k9_check(dev, medium_g, "gru"))
    step_sync_check(dev, cfg)
    # The utilities and the dict API (M-6, M-5): the acting split of three
    # trainers' updates, the state invariants after K1 and K2, the wrapper,
    # the registry and serving by dict on the card.
    acting_split(dev, cfg)
    invariants_check(dev, cfg, model)
    dict_api_check(dev, cfg)
    # The TPU kernels' widths and depths (T-6): their checks, into the
    # kernels line with their main paths' launches.
    shape_res = shape_checks(dev)
    # The meshed learners' sums of squares of the averaged gradient (F-10).
    checks["grad_sumsq"] = sumsq_check(dev)

    # ---- the main paths: each counted from just before it -------------
    rnn_kernels = ["ppo_rnn_rollout", *K7_STAGES, "ppo_rnn_sgd_phase",
                   "ppo_rnn_minibatch_grads"]
    # Each main path's launch counts, in the order the paths run.
    paths = {name: main_path(name, fn, kernels) for name, fn, kernels in [
        ("k1_episodes", lambda: k1_episodes(dev),
         ["greedy_rollout"]),
        ("slice", lambda: slice_phase(dev, cfg, model),
         ["ppo_rollout", *K2_STAGES]),
        ("train", lambda: train_phase(dev, cfg),
         ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase",
          "ppo_minibatch_grads"]),
        ("impala_train", lambda: impala_train_phase(dev, cfg),
         ["ppo_rollout", *K2_STAGES, "impala_sgd_phase",
          "impala_minibatch_grads", *K6_STAGES]),
        ("rnn_train_gru", lambda: rnn_train_phase(dev, cfg, "gru"),
         rnn_kernels),
        ("rnn_train_lstm", lambda: rnn_train_phase(dev, cfg, "lstm"),
         rnn_kernels),
        ("cnn_train", lambda: cnn_train_phase(dev, cfg),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_stages", "ppo_cnn_sgd_phase",
          "ppo_cnn_minibatch_grads"]),
        ("shelves_train", lambda: shelves_train_phase(dev, shelves),
         ["ppo_rollout", *K2_STAGES, "ppo_rollout_shaped", "ppo_sgd_phase",
          "ppo_minibatch_grads"]),
        ("shelves_cnn_train",
         lambda: shelves_cnn_train_phase(dev, shelves),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_shaped",
          "ppo_rollout_cnn_stages", "ppo_cnn_sgd_phase",
          "ppo_cnn_minibatch_grads"]),
        ("shelves_global_train",
         lambda: shelves_global_train_phase(dev, shelves_g),
         ["ppo_rollout_global", *K2_STAGES,
          "ppo_rollout_shaped", "ppo_sgd_phase_global",
          "ppo_minibatch_grads_global"]),
        ("cnn_global_train",
         lambda: cnn_global_train_phase(dev, medium_g),
         ["ppo_rollout_cnn_global", "ppo_rollout_cnn_stages",
          "ppo_cnn_sgd_phase_global", "ppo_cnn_minibatch_grads_global"]),
        ("hidden256_train",
         lambda: hidden256_train_phase(dev, cfg),
         ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase",
          "ppo_minibatch_grads"]),
        ("shelves_groups_train",
         lambda: shelves_groups_train_phase(dev, shelves),
         ["ppo_rollout_groups", *K2_STAGES,
          "ppo_rollout_shaped", "ppo_sgd_phase_groups",
          "ppo_minibatch_grads_groups"]),
        ("gru_bf16_train", lambda: gru_bf16_train_phase(dev, cfg),
         ["ppo_rnn_rollout", *K7_STAGES, "ppo_rnn_sgd_phase_bf16",
          "ppo_rnn_minibatch_grads_bf16"]),
        ("ppo_bf16_train",
         lambda: ff_bf16_train_phase(dev, cfg, "mlp"),
         ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase_bf16",
          "ppo_minibatch_grads_bf16"]),
        ("cnn_bf16_train",
         lambda: ff_bf16_train_phase(dev, cfg, "cnn"),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_stages",
          "ppo_cnn_sgd_phase_bf16", "ppo_cnn_minibatch_grads_bf16"]),
        ("shelves_cnn_groups_train",
         lambda: shelves_cnn_groups_train_phase(dev, shelves),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_groups",
          "ppo_rollout_cnn_shaped", "ppo_rollout_cnn_stages"]),
        ("rllib_cadence_train",
         lambda: rllib_cadence_train_phase(dev, cfg),
         ["ppo_rollout", *K2_STAGES]),
        ("cnn_per_agent_train",
         lambda: cnn_per_agent_train_phase(dev, cfg),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_groups",
          "ppo_rollout_cnn_stages"]),
        ("cnn_global_groups_train",
         lambda: cnn_global_groups_train_phase(dev, medium_g),
         ["ppo_rollout_cnn", "ppo_rollout_cnn_groups",
          "ppo_rollout_cnn_global", "ppo_rollout_cnn_stages"])]}
    # The per-step acting phase's paths (no acting kernel launches).
    paths.update({name: main_path(name, fn, kernels, absent)
                  for name, fn, kernels, absent in step_route_paths(
                      dev, cfg, shelves, shelves_g, medium_g)})
    # The sweeps (M-9): every trial through K2 and K3; PBT plain, as the JAX
    # PBT reaches no kernel.
    swept = {}
    paths["sweep"] = main_path(
        "sweep", lambda: sweep_phase(dev, cfg, swept),
        ["ppo_rollout", *K2_STAGES, "ppo_sgd_phase", "ppo_minibatch_grads"])
    sweep_check(dev, cfg, swept)
    pbt_out = {}
    paths["pbt"] = main_path(
        "pbt", lambda: pbt_phase(dev, cfg, pbt_out), [],
        ["ppo_rollout", "ppo_rollout_cnn", "ppo_rnn_rollout", "ppo_sgd_phase",
         "impala_sgd_phase", "ppo_rnn_sgd_phase", "ppo_cnn_sgd_phase"])
    # The data mesh (M-8): the meshed learners through the grads kernels,
    # each step clipped by the averaged gradient (F-10).
    paths.update({name: main_path(name, fn, kernels)
                  for name, fn, kernels in mesh_main_paths(dev)})
    # The population axis (M-8b): the sweep's seed_mesh and PBT's (pop,
    # data) mesh on spawned ranks, against their in-turn runs.
    refs = pop_references(dev, pbt_out["rows"])
    paths.update({name: main_path(name, fn, kernels, absent)
                  for name, fn, kernels, absent in pop_main_paths(dev,
                                                                  refs)})
    # The env kernels at the pairs outside the presets (T-5): their checks,
    # then their main paths.
    checks.update(pair_checks(dev))
    with tempfile.TemporaryDirectory() as d:
        paths.update({name: main_path(name, fn, kernels)
                      for name, fn, kernels in pair_main_paths(dev, d)})
        paths.update({name: main_path(name, fn, kernels)
                      for name, fn, kernels in shape_main_paths(dev, d)})
    wall = time.perf_counter() - t_start
    emit({"phase": "module_phases", "seconds": MODULE_SECONDS,
          "total_s": sum(MODULE_SECONDS.values()), "script_s": wall,
          "share": sum(MODULE_SECONDS.values()) / wall})
    launches = {k: sum(p[k] for p in paths.values())
                for k in paths["k1_episodes"]}
    # K10's group route with one policy per agent and on the 9x9 map: the
    # launches of the paths that run them.
    launches["ppo_rollout_cnn_per_agent"] = paths["cnn_per_agent_train"][
        "ppo_rollout_cnn_groups"]
    launches["ppo_rollout_cnn_groups_global"] = paths[
        "cnn_global_groups_train"]["ppo_rollout_cnn_groups"]
    # K2 at hidden 256: the launches of the path that runs it.
    launches["ppo_rollout_hidden256"] = paths["hidden256_train"][
        "ppo_rollout"]
    # The env kernels at the pairs: the launches of the pair paths.
    launches.update({
        **{f"greedy_rollout_{n}": k for n, k in PAIR_K1_LAUNCHES.items()},
        "ppo_rollout_a6q8": paths["pair_ppo_train"]["ppo_rollout"],
        "ppo_rnn_rollout_a6q8": paths["pair_gru_train"]["ppo_rnn_rollout"],
        "ppo_rollout_cnn_a6q8": paths["pair_cnn_train"]["ppo_rollout_cnn"],
        "ppo_rollout_groups_a12q24": paths["pair_groups_train"][
            "ppo_rollout_groups"]})

    csrc = "warehouse_tpu_torch/kernels/csrc/"
    sources = {
        "greedy_rollout": ("rollout.cu", "pallas/rollout.py:516"),
        "ppo_rollout": ("act.cu", "pallas/act.py:1028"),
        # K2's stage kernels at config 4, one step's rows: a hidden layer
        # (the TPU kernel's layer loop), the last layer with the head, and
        # the env stage (mask, sample, tick, next observation).
        "ppo_rollout_hidden": ("act.cu", "pallas/act.py:375"),
        "ppo_rollout_head": ("act_stages.cuh", "pallas/act.py:385"),
        "ppo_rollout_env": ("act_stages.cuh", "pallas/act.py:411"),
        "ppo_sgd_phase": ("sgd.cu", "pallas/sgd.py:691"),
        "ppo_minibatch_grads": ("sgd.cu", "pallas/sgd.py:818"),
        "impala_sgd_phase": ("vtrace_sgd.cu", "pallas/vtrace_sgd.py:445"),
        "impala_minibatch_grads": ("vtrace_sgd.cu",
                                   "pallas/vtrace_sgd.py:553"),
        # K6's stage kernels at config 4, one minibatch's rows: the hidden
        # layers' forward (_learner_block's layer loop), the head, V-trace
        # and the loss's derivative, the backward to the hidden layers, the
        # weight gradients.
        "impala_minibatch_grads_fwd": ("mlp_stages.cuh",
                                       "pallas/vtrace_sgd.py:168"),
        "impala_minibatch_grads_head": ("vtrace_sgd.cu",
                                        "pallas/vtrace_sgd.py:170"),
        "impala_minibatch_grads_trace": ("vtrace_sgd.cu",
                                         "pallas/vtrace_sgd.py:221"),
        "impala_minibatch_grads_dgrad": ("vtrace_sgd.cu",
                                         "pallas/vtrace_sgd.py:269"),
        "impala_minibatch_grads_wgrad": ("mlp_stages.cuh",
                                         "pallas/vtrace_sgd.py:267"),
        "ppo_rnn_rollout": ("act_rnn.cu", "pallas/act.py:747"),
        # K7's stage kernels at config 4 (GRU), one step's rows: the encoder
        # layer, the cell as one product over [e | h] with the gates in its
        # epilogue, the head, and the env stage (mask, sample, tick, next
        # observation); the cell's library_ms is torch.nn.GRUCell's.
        "ppo_rnn_rollout_encoder": ("act_stages.cuh", "pallas/act.py:590"),
        "ppo_rnn_rollout_cell": ("act_rnn.cu", "pallas/act.py:593"),
        "ppo_rnn_rollout_head": ("act_rnn.cu", "pallas/act.py:613"),
        "ppo_rnn_rollout_env": ("act_stages.cuh", "pallas/act.py:626"),
        "ppo_rnn_sgd_phase": ("sgd_rnn.cu", "pallas/sgd_rnn.py:551"),
        "ppo_rnn_minibatch_grads": ("sgd_rnn.cu", "pallas/sgd_rnn.py:665"),
        "ppo_rollout_cnn": ("act_cnn.cu", "pallas/act.py:1073"),
        "ppo_cnn_sgd_phase": ("sgd_cnn.cu", "pallas/sgd_cnn.py:482"),
        "ppo_cnn_minibatch_grads": ("sgd_cnn.cu", "pallas/sgd_cnn.py:595"),
        # The shaping option of the two acting kernels (_phi_row and the
        # shaped reward of _act_kernel), at the shelves recipe's shapes.
        "ppo_rollout_shaped": ("act_common.cuh", "pallas/act.py:266"),
        "ppo_rollout_cnn_shaped": ("act_common.cuh", "pallas/act.py:457"),
        # The global-observation option of the two acting kernels
        # (_obs_rows_global), and the learners at the widths it brings: the
        # MLP learner's chunked first layer at D = 611, the CNN learner on
        # the 9x9 map with 5 input channels; K2 at hidden 256 without the
        # global view.
        "ppo_rollout_global": ("act.cu", "pallas/act.py:193"),
        "ppo_rollout_hidden256": ("act.cu", "pallas/act.py:1028"),
        "ppo_rollout_cnn_global": ("act_cnn.cu", "pallas/act.py:339"),
        "ppo_sgd_phase_global": ("mlp_stages.cuh", "pallas/sgd.py:691"),
        "ppo_minibatch_grads_global": ("mlp_stages.cuh",
                                       "pallas/sgd.py:818"),
        "ppo_cnn_sgd_phase_global": ("sgd_cnn.cu", "pallas/sgd_cnn.py:482"),
        "ppo_cnn_minibatch_grads_global": ("sgd_cnn.cu",
                                           "pallas/sgd_cnn.py:595"),
        # The policy-groups option: K2 selecting each agent's group's
        # weights, the fused SGD phase and the per-minibatch gradient
        # routing each sample to its group's params (one clip and one Adam
        # over all groups), at the shelves groups recipe's shapes.
        "ppo_rollout_groups": ("act.cu", "pallas/act.py:1062"),
        "ppo_sgd_phase_groups": ("sgd.cu", "pallas/sgd.py:293"),
        "ppo_minibatch_grads_groups": ("sgd.cu", "pallas/sgd.py:454"),
        # bf16 operands with float32 sums in the learners (matmul_dtype=
        # "bfloat16"): the flag BF of bf16_round.cuh through each learner's
        # tile kernels, transposed copies and weight gradients, at config 4.
        "ppo_sgd_phase_bf16": ("sgd.cu", "pallas/sgd.py:691"),
        "ppo_minibatch_grads_bf16": ("sgd.cu", "pallas/sgd.py:818"),
        "ppo_rnn_sgd_phase_bf16": ("sgd_rnn.cu", "pallas/sgd_rnn.py:551"),
        "ppo_rnn_minibatch_grads_bf16": ("sgd_rnn.cu",
                                         "pallas/sgd_rnn.py:665"),
        "ppo_cnn_sgd_phase_bf16": ("sgd_cnn.cu", "pallas/sgd_cnn.py:482"),
        "ppo_cnn_minibatch_grads_bf16": ("sgd_cnn.cu",
                                         "pallas/sgd_cnn.py:595"),
        # The policy-groups option of the CNN arm: each row through its
        # agent's group's convolutions, trunk and head (a step's rows group
        # by group, each stage tile one group's), at the shelves CNN groups
        # recipe's shapes, with one policy per agent at config 4, and with
        # two groups on config 4's 9x9 global view.
        "ppo_rollout_cnn_groups": ("act_cnn.cu", "pallas/act.py:1062"),
        "ppo_rollout_cnn_per_agent": ("act_cnn.cu", "pallas/act.py:1062"),
        "ppo_rollout_cnn_groups_global": ("act_cnn.cu",
                                          "pallas/act.py:1062"),
        # The env kernels at (agents, queue) pairs outside the presets,
        # each from its pair's own library (build.pair_library): K1 at
        # (6, 8) and (12, 24), K2, K7 (GRU) and K10 at (6, 8), K2 with one
        # policy per agent at (12, 24).
        "greedy_rollout_a6q8": ("rollout.cu", "pallas/rollout.py:516"),
        "greedy_rollout_a12q24": ("rollout.cu", "pallas/rollout.py:516"),
        "ppo_rollout_a6q8": ("act.cu", "pallas/act.py:1028"),
        "ppo_rnn_rollout_a6q8": ("act_rnn.cu", "pallas/act.py:747"),
        "ppo_rollout_cnn_a6q8": ("act_cnn.cu", "pallas/act.py:1073"),
        "ppo_rollout_groups_a12q24": ("act.cu", "pallas/act.py:1062"),
        # The meshed learners' sums of squares of the averaged gradient
        # (F-10): the global norm of _clip_adam_step, which the Pallas
        # learners take in the kernel on one device; its launches those of
        # the meshed paths, one a step.
        "grad_sumsq": ("mlp_learner.cuh", "pallas/sgd.py:226")}
    # library_ms: no single PyTorch call computes a whole rollout or a
    # whole learner phase, so it is null for every kernel here but K7's
    # cell stage (torch.nn.GRUCell on the same rows) and grad_sumsq
    # (torch.linalg.vector_norm of the same gradient).
    emit({"kernels": [
        kernel_row(name, csrc + src, "warehouse_tpu/" + replaces,
                   launches[name], checks[name])
        for name, (src, replaces) in sources.items()]
        + shape_kernel_rows(shape_res, shape_launches(paths))})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

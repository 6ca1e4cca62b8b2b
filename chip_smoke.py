#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``self_play_racing_tpu_torch``).

  python3 chip_smoke.py

Needs one CUDA card (it exits non-zero and prints no result without one) and the
CUDA toolkit's ``nvcc``: it builds the hand-written kernels from ``csrc/`` first.
Phases, each of which fails the run on error (the launch counters are set to 0
just before each path is driven and read just after):

1. the card (name, power limit) and the kernels' build;
2. K1 ``raycast_walls`` against its plain PyTorch version at the main path's shapes
   (canonical 16-track pool gathered to 4096 envs, 11 rays, 896 segments), plus the
   all-miss/padding case: hit/no-hit identical, distances bitwise equal except
   near-ties within 2 ulp; its launch plan; kernel time (CUDA events around 10
   eager launches, and around a CUDA graph of 20 launches), bound and plain time;
3. K2 ``progress_and_collision`` against its plain version at [4096, 5, 512]:
   index, progress and crashed equal; the same timings; then both at the self-play
   launch (rays [4096, 2, 11] against [4096, 1, 1, 896] segment rows, cars [4096, 2]
   against [4096, 1, 512] waypoint rows, K2 also against a launch on rows expanded
   per car), timed eager and in a graph beside their bounds, and in a graph that
   launches K1 and then K2 on the same rows, as the env step does (K2 then finds
   its rows evicted from the L2);
4. K6 ``compute_gae`` against its plain version at [256, 4096] on a seeded
   rollout-like batch, plus the all-done and no-done cases, ``train single``'s
   [2048, 16] and a ragged [256, 4113]: bitwise equal; timed warm (back to back)
   and cold (after a 128 MB write that flushes the L2), eager and in a CUDA graph,
   beside its bound;
5. K7 ``mixbits_permutation`` against its plain version for 10 epochs x 16,384
   units: exactly equal, and a permutation;
6. K3 ``raycast_cars``, K4 ``rectangles_intersect`` and K5 ``car_update`` against
   their plain versions at the self-play path's shapes (4096 envs x 2 cars, 11 rays
   per car) and at 8 cars: all bitwise equal; the same timings;
6b. the envs' two kernels, which run K3 inside K1's block and K5 inside K2's:
   ``raycast_walls_and_cars`` at 1, 2 and 8 cars (rays [4096, A, 11] against the
   [4096, 896] segment rows and the row's cars) and ``car_step_and_query`` at 2 and
   8 cars against [4096, 1, 512] waypoint rows and at one car against [4096, 512]:
   each bitwise equal to the standalone kernels it replaces on the same inputs and
   to its plain version (the sensing by K1's rule: its wall part is K1's fold);
   timed eager and in a CUDA graph beside its bound, and beside the chain of
   launches it replaces (the PyTorch ops that built their inputs and the
   standalone kernels) in one CUDA graph; then ``car_step_and_query`` with the
   pair test (K4 and the velocity ladder in its block), as the multi-car env calls
   it, at 2, 3 and 8 cars: bitwise equal to the kernel without it followed by K4,
   the mask, the sum and the ladder, and to its plain version, with the cars that
   touch 1, 2 and 3+ partners counted; timed beside that chain in one CUDA graph;
7. the single-car main path: ``models/single_agent.npz`` driving 4096 envs for 256
   steps of sample_action + vector.step (the env step's two launches: the
   transition ``single_transition`` once per step (on the tiled pool by its kernel
   of several rows a block, ``single_transition_rows``), the observation
   ``single_observe`` once per step plus once for the reset; the narrow K1 and
   ``car_step_and_query`` not at all);
8. single-car training: ``PPOTrainer`` at the bench width (the canonical pool
   gathered to 4096 envs, 256 steps, batch 1,048,576): one warm-up update, then
   timed updates (single_observe = single_transition = 256, K6 = K7 = 1 per
   update), finite losses and moved parameters;
9. the ``train single`` entry point at its defaults (16 envs x 2048 steps) for two
   updates in a temporary directory; the saved policy must load;
10. this slice's main path, self-play training at ``train scale``'s width: a
   ``SelfPlayTrainer`` on the canonical pool tiled over 4096 envs, 256 steps, 2
   cars, opponents per env from a pool of 5, uniform sampling, with
   ``snapshot_freq`` set to 1 so that every update after the first races pool
   opponents: one warm-up update, then timed updates with each update's
   ms, its rollout/minibatch split, the pool and the learner's win rate
   (the env step's multi_observe = multi_transition = 256, K6 = K7 = 1 per update,
   and the narrow env kernels and the standalone K1, K2, K3, K4 and K5 not at all);
11. the ``train scale`` and ``train multi`` entry points at their defaults for two
   updates each in a temporary directory; the saved policies must load and the
   repo's tracked models and data stay untouched;
12. checkpoints on the card: a checkpoint at update 2 resumed into a fresh trainer
   (parameters, Adam state, pool and counters equal), the repo's format-v0
   ``models/checkpoint_update_90.npz`` (when the checkout holds it) and the reference's
   ``.pth`` training checkpoint;
13. evaluation on the 40 x 5 grid (sampled, seed 42) through ``evaluate.eval()``:
   ``models/single_agent.npz`` and, with two cars, ``models/self_play_agent.npz``,
   success_rate >= 0.95 each, their ``eval_info_<label>.json`` written into a
   temporary directory (no chart) and read back;
14. serving latency and throughput at batches 1, 64, 1024, 8192;

and for procgen and the capacity layouts (the pool resident, each env's rows read
by id in the three env kernels):

a. a 16-track procgen pool built on the card, against the CPU's float64 pool from
   the same uniforms (atol 1e-3, seg_c 0.1); W and S printed (384, 768);
b. K1, ``raycast_walls_and_cars`` and ``car_step_and_query`` (with the pair test and
   single-car) with row ids on the canonical pool (W 512, S 896) and the procgen
   pool, tiled, grouped and by arbitrary ids over 4096 envs: bitwise the kernels on
   the gathered rows and their plain versions (the raycasts by K1's rule); timed in
   CUDA graphs beside the gathered rows, bounds counting each distinct row once,
   and the transition also right after the sensing, as the env step runs it;
c. the single-car main path (after phase 7) and the self-play main path (after
   phase 10) again on the canonical pool tiled, through the row-id kernels: the
   same final observations, every update's seeded numbers to the printed digit, and
   the peak memory of both self-play runs;
d. ``train scale --resample-tracks-every 1 --pooled-geometry tiled`` and
   ``grouped`` for two updates each (after phase 11): the pools of the two updates
   differ (digests printed), the envs run on the last, the policy loads, no tracked
   file changes;
e. what ``evaluate --multi models/self_play_agent_dr_500M.npz --procgen`` runs
   (after phase 13; ``eval()`` without the chart, then ``procgen_transfer``):
   success rate on 40 unseen procgen tracks >= 0.80, beside the JAX package's
   recorded 0.95 on its own tracks;
f. a 32-step self-play rollout at 65,536 envs, tiled and gathered: peak memory of
   each, the same final observations;

and for tournament and match play (after phase 14):

g. the round robin of the 8B-, 4B- and 1B-step scale agents and
   ``models/self_play_agent.npz`` at the tournament CLI's defaults (20 tracks x 2
   runs, seed 42, sampled, 3000 steps at most), one policy per seat: every match
   accounts for its 40 envs, the ratings are finite, the 8B and 4B agents rank
   first and second in either order, then the 1B agent and last
   ``self_play_agent.npz``, as ``data/tournament.json`` ranks them (both win
   matrices printed); ms a match and a step; launches one observation
   (``multi_observe``) and one transition (``multi_transition``) a step plus the
   reset's observation, the narrow env kernels and the standalone K1-K5 none; one match played twice from
   its seed gives the same accumulators; the 1B agent beats a random-init policy;
   ``record_trajectory_match`` and ``record_trajectory_single`` on the held-out
   track (seed 123, width 7) give one row per step of the episode (no row after the
   done step); the tournament CLI writes its JSON into a temporary directory, read
   back, and no tracked file changes. Nothing is rendered: the card's machine has
   no pygame, cv2 or matplotlib.

and for data-parallel training over ``torch.distributed`` (after phase g):

h. ``train scale``'s self-play (the canonical pool tiled over 4096 envs, 256 steps,
   2 cars, snapshot_freq 1): two updates without torch.distributed (graphed),
   then the same seeded run through ``parallel.mesh.distributed_init`` (NCCL, one
   process) with ``shard()`` applied, so that every collective of the
   data-parallel path runs over a group of one, twice: graphed (the collectives
   captured with the steps; every replay under
   ``torch.cuda.set_sync_debug_mode("error")``) and with ``eager=True``: both
   runs' parameters, Adam moments and count, every per-minibatch stat,
   minibatches_applied, the pool and the PFSP counters bitwise the run without a
   group; the ms/update and the minibatch loop's ms of the three runs and the
   graphed runs' capture seconds printed; the ``dist.all_reduce`` calls of the
   eager world-1 run counted (3 and one a minibatch run: the advantage moments'
   two, the gradients' one a minibatch, the metrics' one) against the count
   before the moments were reduced once an update (1 and three a minibatch run),
   and the all-reduces each graph captured; then one update over two processes
   on the card
   (2048 envs each, in a gloo group, since NCCL refuses two ranks on one GPU)
   against one process with 4096 envs and ``data_shards = 2``: the final
   observations bitwise and the episodes equal (the same rollout),
   minibatches_applied equal, the first epoch's per-minibatch stats within rtol
   1e-4 / atol 1e-7, parameters within 1e-3 absolute (the float32 minibatch loop
   drifts over its 160 steps, ``DP_ATOL``; a control run from params one ulp up
   prints its own distance) and bitwise equal on the two ranks; each rank launches
   ``multi_observe`` and ``multi_transition`` (by row id) 256 times and K6 and K7
   once an update; last ``python -m
   self_play_racing_tpu_torch.parallel.scaling`` at world 1 writes its
   ``scaling_sweep_v1`` JSON into a temporary directory, printed, and no tracked
   file changes;

and for the Gymnasium adapters, the SB3 baseline and tensor parallelism (after
phase h, each printing its wall seconds):

i. whether gymnasium imported (the adapters run on their stand-in spaces without
   it); ``RacingEnv`` at float32 on the card against the same adapter on the CPU
   in float32 for one episode of seeded actions on the canonical pool's track 0
   (width 7): the same done step, the observations within ``ADAPTER_OBS_ATOL``
   (largest gap printed), one ``single_observe`` and one ``single_transition``
   launch a step (one more observation for the reset), ms a step; ``MultiRacingEnv``
   (2 cars) behind ``SelfPlayWrapper`` with ``models/self_play_agent.npz``'s
   (params, log_std) as the opponent and the same policy's greedy action for the
   agent, one episode: one ``multi_observe`` and one ``multi_transition`` a step,
   the spaces printed; ``evaluate --sb3
   models/sb3_baseline_agent_general.zip`` through ``eval()`` on an 8 x 2 grid
   into a temporary directory, success_rate >= 0.95 and avg_steps printed; ``python
   -m self_play_racing_tpu_torch.train sb3 --num-envs 2 --total-timesteps 4096``
   from a temporary directory: the ``.zip`` and ``training_info_sb3.json`` written
   and read back, the model loads on the card and drives two episodes (300 steps
   at most) through ``evaluate_sb3_agent_overall``, and no tracked file changes;
j. tensor-parallel towers: two gloo processes on the one card (NCCL refuses two
   ranks on a GPU) on a mesh of data 1 x model 2, each running one single-car PPO
   update (4096 x 256, towers of 128, the canonical pool tiled) and one self-play
   update (phase h's, towers of 128), after a warm-up update, against one process
   unsharded with the same seed: each rank holds actor[0].w [15, 64] and
   actor[1].w [64, 128] with the Adam moments alike, minibatches_applied equal, the
   gathered parameters within the larger of ``TP_ATOL`` and ``TP_CONTROL_FACTOR``
   times the distance of a control run (one process from params one ulp up) of one
   process's, and bitwise equal on both ranks, the
   self-play snapshot the whole parameters, a rank's launches 256 of the env
   kernels (by row id) and K6 and K7 once an update; ms/update of both printed;

and for the update as device programs (every trainer above runs its rollout and
minibatch steps as replayed CUDA graphs, ``agent/ppo.py``, unless it has a gloo
process group or ``eager=True``):

k. graph against eager: single-car training (4096 x 256) and phase 10's self-play
   (4096 x 256 x 2 cars, ``snapshot_freq`` 1), each on the canonical pool gathered
   and tiled, each run twice from one seed, graphed and with
   ``PPOTrainer(eager=True)``: a warm-up update (the first capture), 3 timed
   updates, one after ``set_track`` to ``train scale``'s procgen pool (W 384, S
   768: the graphs are captured again) and one with ``reset_envs_each_update`` and
   a KL target of 0.002 (a new update step): every metric of every update (the
   seeded numbers the phases above print among them), the final parameters, Adam
   moments and count, observations and done flags, and the launch counts bitwise
   equal; a KL exit in every run; every replay under
   ``torch.cuda.set_sync_debug_mode("error")``; the timed updates launch the env
   kernels 256 times and K6 and K7 once. Printed for every update: ms, the
   rollout's host and device ms a step (CUDA events), the minibatch loop's ms and
   minibatches, the capture seconds, and for every run its peak memory; a captured
   minibatch step's kernel nodes, counted from the graph and listed by name
   (``kernel_node_names``, with its moments graph's), at most
   ``MINIBATCH_KERNEL_NODES``;

and for the evaluation, match and recorder loops as device programs (on the card
every loop of ``utils/metrics.py`` replays its step captured as a CUDA graph
between its every-32-steps checks, so phases 13, e and g above run graphed):

l. graph against eager (``eager=True``): the 40 x 5 evaluations of phase 13
   (single car and two cars, sampled, seed 42; every per-episode field), phase g's
   round robin (wins, draws and Elo; its 12 matches share one capture) and the
   three recorders on the held-out track (``record_trajectory_single``, ``_multi``
   and ``_match``, sampled from seed 0; every array), each bitwise with equal
   launch counts and loop steps, every replay under
   ``torch.cuda.set_sync_debug_mode("error")``. Printed for each: wall seconds
   graphed and eager, ms a step (host, and device between CUDA events), the
   captures and their seconds, the graphs' own buffers and private pools
   (``pool_bytes``), the checked replays;

and for the multi-car env step as two kernels (``multi.transition`` runs the whole
reward, termination and placement tail in one launch, ``multi.observe`` writes the
whole observation row in one; since their redesign, ``csrc/multi_transition.cu`` and
``csrc/multi_observe.cu``, and on fewer env rows than ``ops/_cuda.py``'s
``TRANSITION_SMALL_BELOW`` and ``OBSERVE_SMALL_BELOW`` the first kernels, a block a
row, ``multi_transition_small`` and ``multi_observe_small``):

m. m.1 (after 6b) both against their plain versions (the narrow kernels and PyTorch,
   what the env ran before) on ``crafted_state`` at 1, 2, 3 and 8 cars over 4096
   envs (the redesigned kernels) and 48 envs (the first ones) of the canonical pool,
   gathered and tiled, the sensing clamped and not: every output bitwise (-0.0
   apart from 0.0), every branch of the tail taken at 4096 (counts printed), the
   observation also bitwise the fold's shape model (``shape_model_observe``: K1's
   runs stopped at each row's real extent); the redesigned kernels timed at 4096 x
   2 tiled and the first ones at 48 x 2 gathered, eager and in a CUDA graph, beside
   their plain versions, bounds and issue floors (the inner loops' SASS
   instructions, ``cuobjdump``, over the warp-steps the rows need), with their
   registers (``-Xptxas -v``). m.2 and m.3
   (after l): a 256-step self-play
   rollout of ``SCALE_1B_MODEL`` (learner and every opponent) at 4096 x 2 on the
   tiled pool, eager with every call also run as its plain version (every output
   of every step bitwise), then graphed with the kernels and with the plain
   versions (every step's buffers and the final state bitwise); the kernel nodes of
   one captured rollout step of each (at least 100 fewer with the kernels) and its
   device ms a step, in turns;

and for the PPO minibatch step's kernels around the MLPs (``ops/minibatch.py``), right
after m.1:

n. ``ppo_head`` (the whole loss past the MLPs: the per-row work, the means, the
   entropy and the loss's sum, one launch forward and one backward) on
   ``crafted_minibatch`` (rows that take every branch: the ratio clipped above,
   below and not, pg1 == pg2, the value clipped, tied, at its clamp's bounds) at
   65,536, 16,384, 4097 and 1 rows and through the unit index, with a group's moments
   and the minibatch's own at a row of a moments table, its gradients from the loss at
   1 and 0.7: d/d mu and d/d v bitwise the plain composition's autograd, the loss and
   stats bitwise their numpy transcription (``head_sums_model``) and within
   ``ops/minibatch.py``'s stated tolerance of the float64 sums, clip_frac bitwise the
   composition's; ``advantage_moments`` (every minibatch's advantage mean and std, one
   launch an update) bitwise its transcription (``moments_model``) and within the
   tolerance of float64 at ``train scale``'s width, two shards, units of 3 and 1, one
   row (std NaN); ``adam_tail`` (the clip, Adam, the masked apply, the stats row and
   the counters in one launch) bitwise its plain version applied, clipped, masked by
   the KL exit and after it, also on a group's flat-buffer views; one update of 160
   minibatches at 4096 x 256 with the kernels bitwise run to run and with every field
   gathered, and its parameters and Adam moments bitwise the same update with the
   head and tail plain on the kernel's moments (the stats within 1e-5); a minibatch
   step runs no PyTorch reduction; all timed eager and in a CUDA graph beside their
   plain versions and bounds, the tail beside ``torch._fused_adam_`` over the same 12
   tensors and the moments beside ``torch.std_mean`` on the gathered minibatches.
   Every training path counts the head's and the tail's launches once a minibatch
   step and the moments' once an update (``learner``: exactly from the loop's
   computed minibatches where the phase times the loop, else checked whole epochs);
   the update's runs take the MLP kernels of phase p;

and for the minibatch step's actor and critic MLPs (``ops/mlp.py``: one launch of
``mlp_forward`` for both towers, one of ``mlp_backward`` and one of
``mlp_grad_reduce`` a minibatch step, on every whole-tower training path, the
reduce also giving the gradients' global norm in that launch where there is no group;
with a group the reduce's norm-only mode, ``mlp_grad_norm``, once a minibatch step
after the all-reduce (phase h counts it); a tensor-parallel rank's slices keep the
Megatron composition and ``ppo.global_norm`` and launch none), right after n:

p. the three kernels against the plain composition (cuBLAS and autograd) at the
   towers of ``MLP_TOWERS`` (obs_dim 15, 19, 23, 43 and 184 on (64, 64), 15 and 19
   on (128, 128); obs_dim is a run-time argument, the hidden widths are compiled)
   and 65,536, 16,384, 4097 and 1 rows: mu, v and the 12 gradients each within
   max(``MLP_REL_FLOOR`` x the tensor's scale, ``MLP_CONTROL_FACTOR`` x the plain
   composition's own distance with the rows in two halves), both also against the
   float64 composition (printed); two runs bitwise; through the unit index bitwise
   the gathered rows; float64, non-contiguous, other hidden widths and an obs_dim
   past a block's shared memory refused before any launch, the wrapper's least
   shared bytes the kernel's; the forward row-invariant bitwise (``mlp_row_invariance``);
   each kernel timed eager and in a CUDA graph (by row and by unit id) beside its
   bound (the forward's and the backward's own operations as 3xTF32 on the tensor
   cores, the forward the backward recomputes a line of its own, each also as
   float32 FFMA; the reduce's its adds, and its bytes only where its partials outgrow
   the 50 MB L2, beside its launch floor) and the composition's forward and backward,
   at 65,536 and 16,384 rows; the reduce's global norm (``ppo.norm_route``) at every
   tower of ``MLP_TOWERS`` at 65,536 and 4097 rows (``hold_grad_norm``): within
   max(``MLP_REL_FLOOR`` x the float64 norm of the same flat, ``MLP_CONTROL_FACTOR`` x
   ``ppo.global_norm``'s own distance from it), the flat bitwise the norm-less
   launch's, the norm-only mode over that flat bitwise the fused norm, and three
   replays of a CUDA graph bitwise with the ticket's counter back at 0
   (``hold_norm_replays``), the reduce timed with its norm beside ``torch.sum`` and
   the composition it replaces in a graph; and ``train scale --agents 3`` (towers of
   23 inputs), one update at its defaults, launching the MLP kernels once a
   minibatch step;

and for the rollout step's policy as two kernels (``ops/policy.py``,
``csrc/policy.cu``: kernel A ``policy_act`` runs the normaliser, both towers, the
sample and its log-prob and writes row t of the rollout's obs, actions, log-probs
and values, once a rollout step on every path with whole towers, and the actor alone
for evaluation, serving and the adapters; kernel B ``pool_act`` the pool opponents'
actions, once a self-play step, and a match's one policy a seat):

q. (right after p) both against the plain composition at the towers of
   ``POLICY_TOWERS`` (obs_dim 15, 19, 23, 43 on (64, 64), 19 on (128, 128)) and 1,
   64, 4096, 4097 and 8192 rows (kernel B at ``POOL_SHAPES`` envs x opponent seats):
   mu and v within phase p's rule, and kernel A's bitwise ``mlp_forward``'s on the
   same rows; everything after the towers (the normaliser's row, the sample, its
   log-prob, the uniform actions, the ``use_policy`` select, car 0) bitwise the
   composition applied to the kernels' own mu, sampled and greedy, with and without
   the normaliser and the critic, kernel B with an [envs] index of 5 members, a 0-d
   index and one member a seat, through ``opponent_actions``,
   ``opponent_actions_all_seats`` and ``_seat_actions``; the buffers' other rows
   untouched, two runs bitwise, a row (an env) alone bitwise its row in a batch,
   graphed bitwise eager; kernel B's mu bitwise ``mlp_forward``'s actor on each
   member's rows, also with the per-env members of ``POOL_DISTRIBUTIONS`` (skewed,
   two live, absent from whole ranges, all random); every tower tensor an unaligned
   view bitwise the aligned; float64, strided rows, other widths, a float index and a
   noise of another shape refused before any launch; the kernels' shared bytes as
   ``_cuda.policy_shared_bytes`` counts them; each timed eager and in a CUDA graph at
   4096 rows of (19, 64, 64) and (15, 64, 64) beside the composition it replaces in
   a graph, its bound (3xTF32 on the tensor cores), the launch floor and, where the
   checkout holds their source, the kernels they replaced in turns
   (``parent_graph_ms``); every update's first minibatch of phases 10 and k has
   approx_kl and clip_frac exactly 0 (``first_minibatches_exact``);

and for the single-car env step as two launches (``single.transition`` runs
``csrc/single_transition.cu``, the step, the track query and the whole reward and
termination tail, a warp a row, and on the tiled pool from
SINGLE_TRANSITION_ROWS_FROM rows its kernel of several rows a block, the step and
the tail a thread a car, a block's rows sharing one staged pool row;
``single.observe`` the multi-car observation kernel at one car a row without its car
pass, a row's rays in four groups; every single-car path above counts them as
``single_transition`` and ``single_observe``, the kernel of several rows a block
also as ``single_transition_rows``, and the narrow K1 and ``car_step_and_query`` 0):

o. o.1 (right after p) both against their plain versions (the narrow kernels and
   PyTorch, what the env ran before these kernels) on ``crafted_single_state`` at 1, 16,
   48, 200 and 4096 env rows of the canonical pool, gathered and tiled, the speed
   weight the config's (sensing unclamped) and an annealed tensor on the card
   (sensing clamped), every eighth car 70 m off its track for the observation, the
   transition as the env picks it and, tiled, by each of its kernels: every output bitwise,
   every branch of the tail taken at 4096 (counts printed); o.4 each kernel timed at
   4096 where the env runs it (a warp a row gathered, the rest on the tiled pool),
   eager and in a CUDA graph, beside its plain version, bound and issue floor, with
   its registers, and at 4096, gathered and tiled, in turns: the observation at the
   multi-car plan (a warp a row's 11 rays) and the narrow K1 alone on the same rays,
   the transition's kernels (tiled both, gathered a warp a row, the only one it
   takes). o.2
   and o.3 (after m.3): a 256-step
   single-car rollout of ``models/single_agent.npz`` at 4096 envs on the tiled
   pool, the speed weight a tensor in the trainer's aux, eager with every call also
   run as its plain version (every output of every step bitwise), then graphed with
   the kernels and with the plain versions (every step's buffers and the final
   state bitwise); the kernel nodes of one captured rollout step of each (at least
   40 fewer with the kernels) and its device ms a step, in turns; then the anneal as
   the trainer runs it, a new weight tensor at each of two more rollouts of the
   captured graphs (the second taken in by copy at its replay), bitwise an eager
   rollout at that weight and apart from the first.

and for the NEXT_STEP autoreset inside the transitions' launch (``csrc/autoreset.cuh``:
each transition entry's autoreset mode writes the reset rows' fresh state and info,
the masks, the episode statistics, the rollout's reward, done and episode rows and
t + 1, and on the multi-car env the PFSP counts; every path above whose vector steps
run on the card, phases 7, 8, 9, 10, 11, c, h, j and k, takes that fused route, one
transition launch a step, counted also as ``single_transition_autoreset`` (and
``single_transition_rows_autoreset``) and ``multi_transition_autoreset`` (and
``multi_transition_small_autoreset``); phases m.2 and o.2 keep the composition
route, to hold the plain mode over a rollout):

r. r.1 (after o.1) the four entries in their autoreset mode against the composition,
   the same kernel's plain mode followed by the PyTorch glue, called explicitly, on
   ``crafted_state`` (rows that finish, crash and truncate this step) with pending
   resets on none, some and all rows, at 16, 48 and 4096 env rows gathered and tiled,
   1 and 2 cars, the pool's index one for all and per env: every state field, info,
   reward, flag, record, buffer row, t + 1 and ``extra`` bitwise (-0.0 apart from
   0.0), one autoreset launch by the kernel the env picks; each entry graphed
   bitwise eager; r.3 each entry timed where ``AUTORESET_TIMED`` says, eager and in a
   CUDA graph, beside the composition, its plain mode alone and its bound (the
   autoreset's bytes added); r.2 (last) 256-step rollouts, graphed, through the fused
   route and through the composition, self-play at 4096 envs x 2 cars on the tiled
   pool (phase m.2's) and single-car at 4096 envs (phase o.2's): every step's
   buffers, ``extra`` and the final state bitwise, the autoreset mode launched once
   a step; a captured rollout step's kernel and copy nodes and its device ms a step,
   in turns.

Phases k, m.3, o.3 and r.2 count a captured step's nodes from the graph itself
(``graph_nodes``: those phases capture under ``kept_graphs``, ``keep_graph=True``); a
profiled replay, which can drop events, only times the kernels it recorded.

The line before the last is one JSON object with every kernel's numbers (``ms`` the
eager back-to-back time, ``graph_ms`` the CUDA-graph replay time, ``launches`` the
count on the self-play path of phase 10, or for K1, the narrow
``car_step_and_query`` and the single-car env's ``single_observe`` and
``single_transition`` on the single-car main path of phase 7, as ``launches_path``
says (the narrow two 0 there, and ``single_*`` also ``launches_row_ids`` on the
tiled pool, phase o.3's ``rollout_step_nodes`` and ``in_turns_graph_us``; the
transition's kernel of several rows a block, ``single_transition_rows``, on the
single-car main path on the tiled pool); the self-play path runs K1, K3, K4, K5 and K2 inside ``multi_observe`` and
``multi_transition``, so the narrow ``raycast_walls_and_cars`` and K2-K5 count 0
there; K1 and K2 also ``selfplay_ms``,
``selfplay_graph_ms`` and ``selfplay_bound_ms`` at the self-play launch and
``cold_graph_ms`` after the other kernel in the env step's order; the envs' two
narrow kernels also the ``chain_ms`` and ``chain_graph_ms`` of what they replace, the
transition's numbers those of its pair-test instantiation, with ``no_pairs_*``
beside them; ``multi_observe`` and ``multi_transition`` their ``plain_graph_ms``,
``issue_floor_ms``, ``registers``, ``launches_row_ids`` and phase m.3's
``rollout_step_nodes``, and ``multi_observe_small`` and ``multi_transition_small``
the same numbers at 48 envs with ``launches`` counted on phase g's round robin; the
env step's counts by kernel (``per_kernel``: ``multi_observe`` and
``multi_transition`` the redesigned kernels' launches alone); K6 also its cold times; the three
``*_row_ids`` entries their row-id launches on the canonical pool tiled, with
``gathered_graph_ms`` and the ``procgen_*`` numbers beside them, and launches on
phase c's runs; ``launches_match`` every kernel's count on phase g's tournament;
``launches_data_parallel_world1`` its count on phase h's graphed world-1 run of two
updates (counted from the replays) and ``launches_data_parallel_ranks`` on each of the two ranks' update;
``launches_adapter`` its count over phase i's two adapter episodes and
``launches_tensor_parallel`` on each of phase j's two ranks, its single-car and
self-play updates summed; ``launches_graphed`` its count over phase k's graphed
self-play run's 3 timed updates on the tiled pool; ``launches_loops_graphed`` its
count over phase l's graphed runs, as replays; the three MLP kernels of phase p
their largest error and error over bound, the composition's forward and backward
(``plain_ms``, the forward's ``plain_graph_ms``), the four ``*_autoreset`` entries
phase r.3's times (``plain_ms`` and ``plain_graph_ms`` the composition's,
``plain_mode_graph_ms`` the plain mode's alone, ``no_pool_graph_ms`` the multi-car
entries' without the PFSP counts), their ``launches`` on the single-car
main path (gathered; the rows kernel tiled), self-play training and ``train multi``
(the first kernel) and phase r.2's ``rollout_step_nodes``, the backward's
``recompute_bound_ms`` (the forward it recomputes), the forward's and the backward's
``ffma_bound_ms`` (and ``recompute_ffma_bound_ms``), the reduce's ``launch_floor_ms``
and, under ``at``, the times at the other towers and rows); the last line is ``{"ok": true,
"device": {...}}``.
"""
from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import ctypes
import dataclasses
import functools
import gc
import hashlib
import itertools
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from self_play_racing_tpu_torch import _graph
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch.agent import ppo
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer, make_single_env_hooks
from self_play_racing_tpu_torch.configs import base_config, self_play_config
from self_play_racing_tpu_torch.envs import multi as menv
from self_play_racing_tpu_torch.envs import normalize as obsnorm
from self_play_racing_tpu_torch.envs import procgen as pg
from self_play_racing_tpu_torch.envs import selfplay
from self_play_racing_tpu_torch.envs import single as senv
from self_play_racing_tpu_torch.envs import track as trk
from self_play_racing_tpu_torch.envs import vector
from self_play_racing_tpu_torch import evaluate
from self_play_racing_tpu_torch import render
from self_play_racing_tpu_torch import tournament
from self_play_racing_tpu_torch.evaluate import load_policy_bundle
from self_play_racing_tpu_torch.models import actor_critic as net
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import dynamics
from self_play_racing_tpu_torch.ops import gae
from self_play_racing_tpu_torch.ops import geometry as geo
from self_play_racing_tpu_torch.ops import minibatch as mbops
from self_play_racing_tpu_torch.ops import mlp as mlpops
from self_play_racing_tpu_torch.ops import policy as polops
from self_play_racing_tpu_torch.ops import prng
from self_play_racing_tpu_torch.parallel import mesh as pmesh
from self_play_racing_tpu_torch.serve import Policy, bench
from self_play_racing_tpu_torch.utils import metrics
from self_play_racing_tpu_torch.utils import viz
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

MODEL = "models/single_agent.npz"
SCALE_1B_MODEL = "models/self_play_agent_scale_1B.npz"
MULTI_MODEL = "models/self_play_agent.npz"
# the domain-randomized agent the JAX package trained on procedural pools
DR_MODEL = "models/self_play_agent_dr_500M.npz"
PROCGEN_FLOOR = 0.80
CAPACITY_ENVS = 65_536
CAPACITY_STEPS = 32
# phase (g): the tournament's agents, in data/tournament.json's order of rank
TOURNAMENT_ENVS = 40  # a match: the 20 x 2 evaluation grid (tournament.py)
# phase m.1's few envs: under both of ops/_cuda.py's *_SMALL_BELOW, a multiple of the
# canonical pool's 16 tracks (tiled)
FEW_ENVS = 48
TOURNAMENT_MODELS = ["models/self_play_agent_scale_8B.npz", "models/self_play_agent_scale_4B.npz",
                     "models/self_play_agent_scale_1B.npz", "models/self_play_agent.npz"]
V0_CHECKPOINT = "models/checkpoint_update_90.npz"
TORCH_CHECKPOINT = "models/reference_selfplay_checkpoint_update_90.pth"
# what the self-play phases must leave untouched
TRACKED = [MULTI_MODEL, "data/training_info_self_play.json", "data/tournament.json",
           "models/sb3_baseline_agent_general.zip", "data/training_info_sb3.json",
           "data/eval_info_sb3.json",
           *(f"models/checkpoint_update_{u}.npz" for u in range(10, 100, 10))]
NUM_ENVS = 4096
NUM_AGENTS = 2
NUM_TRACKS = 16
STEPS = 256
# Published H100 SXM peaks: HBM bandwidth and f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# and the dense TF32 rate of its tensor cores
PEAK_TF32_OPS_PER_S = 495e12
# and float64 outside the tensor cores (NVIDIA's H100 SXM data sheet)
PEAK_F64_OPS_PER_S = 34e12
# f32 operations per ray-segment pair in K1: cn 4, dotp 3, sn 4, |dotp| 1, hit test
# 7 (2 products, 4 compares, |sn|), |cn| + select 2, the ratio compare 5
K1_OPS_PER_PAIR = 26
# per query-waypoint pair in K2: dx, dy 2, d^2 3, compare 1, projection 3, selects 2
K2_OPS_PER_PAIR = 11
# per sample in K6: nt = 1 - done, g*nt, *v_next, +r, -v, gl*nt, *carry, +delta, +v
K6_OPS_PER_SAMPLE = 9
# per index in K7: four rounds of or, multiply, add, and, shift, xor
K7_OPS_PER_INDEX = 24
# K3: per ray and car the skip test (2 differences, 2 squares, a sum, sqrt, compare);
# per ray and edge of a car that is not skipped: dotp 3, |dotp| and its compare 2,
# v1 2, the two numerators 6 and divisions 2, four compares and the min 5
K3_OPS_PER_RAY_CAR = 7
K3_OPS_PER_RAY_EDGE = 20
# K4: per pair and axis: the normal 3, 8 projections of 3, 6 min/max, 2 compares, or
K4_OPS_PER_PAIR_AXIS = 36
# K5: per car: heading 4 (with the fmod and its sign fix), cos and sin 2, body frame
# 6, throttle/drag/friction 7, world frame 6, speed 4, clamp 4 (division, compare,
# 2 products), position 4, the crashed selects 5
K5_OPS_PER_CAR = 42
SP_TRAIN_UPDATES = 3
TRAIN_UPDATES = 3
SUCCESS_FLOOR = 0.95


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def per_launch_ms(fn, windows=21, launches=10) -> float:
    """Median over ``windows`` of the per-launch time of ``launches`` back-to-back
    calls, from CUDA events, after a warm-up. Back-to-back launches keep the host's
    launch overhead out of the window once the queue is ahead of the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def graph_ms(fn, windows=21, launches=20) -> float:
    """Median over ``windows`` of the per-launch device time of ``launches`` calls
    captured in one CUDA graph and replayed (CUDA events around each replay), so no
    host launch overhead sits between the launches: the kernel's own time even
    where a launch from Python costs more than the kernel."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int, ops_per_s: float = PEAK_F32_OPS_PER_S):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def car_poses(track, rng, dev):
    """Cars near random centreline waypoints with random headings."""
    n = track.wp_x.shape[0]
    n_wp = track.n_wp.cpu().numpy()
    i = torch.as_tensor(rng.integers(0, n_wp), device=dev)
    rows = torch.arange(n, device=dev)
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    x = track.wp_x[rows, i] + f32(rng.uniform(-8, 8, n))
    y = track.wp_y[rows, i] + f32(rng.uniform(-8, 8, n))
    return x.contiguous(), y.contiguous(), f32(rng.uniform(0, 2 * np.pi, n))


def hold_k1(k, p, max_dist, what):
    """K1's rule against its plain version: hit/no-hit identical, every distance
    within 2 ulp (near-ties, where two hit ratios agree to within the rounding of
    the cross products). Returns the count of non-identical rays and the max |err|."""
    if not torch.equal(k == max_dist, p == max_dist):
        raise AssertionError(f"K1 {what}: hit/no-hit differs from the plain version")
    ulp = torch.nextafter(p.abs(), torch.full_like(p, float("inf"))) - p.abs()
    if bool(((k - p).abs() > 2 * ulp).any()):
        raise AssertionError(f"K1 {what}: a ray differs from the plain version by more than 2 ulp")
    return int((k != p).sum()), float((k - p).abs().max())


def check_k1(track, cfg, rng, dev):
    x, y, ang = car_poses(track, rng, dev)
    world = ang[:, None] + torch.as_tensor(cfg.sensor_angles(), dtype=torch.float32, device=dev)
    rays = [x[:, None].expand(world.shape).contiguous(),
            y[:, None].expand(world.shape).contiguous(), torch.cos(world), torch.sin(world)]
    segs = [getattr(track, f)[:, None, :] for f in ("seg_sx", "seg_sy", "seg_vx", "seg_vy")]
    seg_c = track.seg_c[:, None, :]
    max_dist = cfg.max_sensor_range
    k = geo.raycast_walls(*rays, *segs, max_dist, seg_c=seg_c)
    p = geo.raycast_walls_plain(*rays, *segs, max_dist, seg_c=seg_c)
    torch.cuda.synchronize()
    n_differ, max_err = hold_k1(k, p, max_dist, "single car")
    print(f"K1 raycast_walls [{NUM_ENVS}, {world.shape[1]}] x {segs[0].shape[-1]} segments: "
          f"{n_differ} non-identical rays (near-ties within 2 ulp), max |err| {max_err:g}, "
          f"{float((k < max_dist).float().mean()):.3f} of rays hit")
    if n_differ:
        differ = k != p
        print(f"K1 near-tie rays: kernel {k[differ][:8].tolist()} plain {p[differ][:8].tolist()}")

    # all-miss rays and zero-direction padding give max_dist exactly; a hit among
    # padding still wins; the kernel forms seg_c itself when it is not given
    sx = torch.tensor([-5.0, -3.0, -8.0, 0, 0, 0, 0], device=dev)
    sy = torch.tensor([-2.0, 1.0, 4.0, 0, 0, 0, 0], device=dev)
    vx = torch.tensor([0.0, 1.5, 2.0, 0, 0, 0, 0], device=dev)
    vy = torch.tensor([3.0, 0.5, -1.0, 0, 0, 0, 0], device=dev)
    ox = torch.tensor([1.0, 1.0, 1.0, -4.0], device=dev)
    oy = torch.tensor([0.0, 2.5, -4.0, 0.0], device=dev)
    dx = torch.tensor([1.0, 1.0, 1.0, -1.0], device=dev)
    dy = torch.zeros(4, device=dev)
    small_k = geo.raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, 50.0)
    small_p = geo.raycast_walls_plain(ox, oy, dx, dy, sx, sy, vx, vy, 50.0)
    if not (torch.equal(small_k, small_p) and small_k[:3].eq(50.0).all()
            and abs(float(small_k[3]) - 1.0) < 1e-6):
        raise AssertionError(f"K1 padding/all-miss case: {small_k.tolist()} vs {small_p.tolist()}")
    print(f"K1 all-miss/padding case: {small_k.tolist()} (kernel == plain)")

    out = torch.empty_like(k)
    rows, r, s = NUM_ENVS, world.shape[1], segs[0].shape[-1]
    print(f"K1 plan [{rows}, {r}] x {s}: "
          f"{_cuda.raycast_walls_plan(r, s)}")
    launch = lambda: _cuda.launch_raycast_walls(*rays, *segs, seg_c, out, rows, r, s, max_dist)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    plain_ms = per_launch_ms(lambda: geo.raycast_walls_plain(*rays, *segs, max_dist, seg_c=seg_c),
                             windows=3, launches=2)
    b_ms, b_by = bound_ms(nbytes(*rays, *segs, seg_c, out), rows * r * s * K1_OPS_PER_PAIR)
    print(f"K1 time {ms * 1e3:.1f} us eager back-to-back "
          f"({g_ms * 1e3:.1f} us in a CUDA graph), "
          f"bound {b_ms * 1e3:.1f} us ({b_by}), plain {plain_ms * 1e3:.1f} us")
    return {"name": "raycast_walls", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/raycast_walls.cu",
            "replaces": "self_play_racing_tpu/ops/geometry.py:26",
            "max_abs_err": max_err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_k2(track, cfg, rng, dev):
    x, y, ang = car_poses(track, rng, dev)
    cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
    args = (x, y, cx, cy, track.wp_x, track.wp_y, track.nrm_x, track.nrm_y,
            track.n_wp, track.track_width)
    kp, kc = geo.progress_and_collision(*args)
    pp, pc = geo.progress_and_collision_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kp, pp) and torch.equal(kc, pc)):
        raise AssertionError(f"K2: {int((kp != pp).sum())} progress and "
                             f"{int((kc != pc).sum())} crashed values differ from plain")
    max_err = float((kp - pp).abs().max())
    print(f"K2 progress_and_collision [{NUM_ENVS}, {1 + cx.shape[-1]}, {track.wp_x.shape[-1]}]: "
          f"progress and crashed equal to plain ({int(kc.sum())} crashed)")
    progress = torch.empty_like(kp)
    crashed = torch.empty_like(kc)
    w = track.wp_x.shape[-1]
    print(f"K2 plan [{NUM_ENVS}] x {w}: "
          f"{_cuda.progress_collision_plan(1, cx.shape[-1], w)}")
    launch = lambda: _cuda.launch_progress_and_collision(
        *args, progress, crashed, NUM_ENVS, 1, cx.shape[-1], w)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    plain_ms = per_launch_ms(lambda: geo.progress_and_collision_plain(*args), windows=3, launches=5)
    b_ms, b_by = k2_bound(x, cx, track, progress, crashed)
    print(f"K2 time {ms * 1e3:.1f} us eager back-to-back "
          f"({g_ms * 1e3:.1f} us in a CUDA graph), "
          f"bound {b_ms * 1e3:.1f} us ({b_by}), plain {plain_ms * 1e3:.1f} us")
    return {"name": "progress_and_collision", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/progress_collision.cu",
            "replaces": "self_play_racing_tpu/ops/geometry.py:176",
            "max_abs_err": max_err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def k2_bound(x, cx, track, progress, crashed):
    """K2's bound: the cars' centres, corners, waypoint counts and widths, every
    waypoint position of the rows and, of the normals, only the two at each
    corner's nearest waypoint, read once; the outputs written once; 11 operations
    per query-waypoint pair."""
    cars, corners = x.numel(), cx.shape[-1]
    w = track.wp_x.shape[-1]
    read = (4 * cars * (2 + 2 * corners) + nbytes(track.wp_x, track.wp_y)
            + 8 * cars * corners + 8 * cars)
    return bound_ms(read + nbytes(progress, crashed), cars * (1 + corners) * w * K2_OPS_PER_PAIR)


def race_poses(track, rng, dev, a):
    """``a`` cars per env near one random centreline waypoint, within a few metres
    of each other (so rays hit cars and cars touch), random headings: [N, A]."""
    x, y, _ = car_poses(track, rng, dev)
    n = x.shape[0]
    def f32(*shape, lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=dev)
    xs = (x[:, None] + f32(n, a, lo=-4, hi=4)).contiguous()
    ys = (y[:, None] + f32(n, a, lo=-4, hi=4)).contiguous()
    return xs, ys, f32(n, a, lo=0, hi=2 * np.pi)


def car_rays(cfg, x, y, ang):
    """Every car's sensor rays from its centre, as the multi-car env casts them:
    origins and directions [N, A, R] (materialized)."""
    world = ang[:, :, None] + torch.as_tensor(cfg.sensor_angles(), dtype=torch.float32,
                                              device=x.device)
    shape = world.shape
    return [x[:, :, None].expand(shape).contiguous(), y[:, :, None].expand(shape).contiguous(),
            torch.cos(world), torch.sin(world)]


def check_selfplay_launches(track, cfg, rng, dev, k1, k2):
    """K1 and K2 as the multi-car env launches them (envs/multi.py:172 and :232):
    rays [N, A, R] against segment rows [N, 1, 1, S], cars [N, A] against waypoint
    rows [N, 1, W]; held to their plain versions (K2 also to a launch on rows
    expanded per car), timed eager and in a CUDA graph beside their bounds, then
    in a CUDA graph that launches K1 and then K2 on the same rows, as the env step
    does: K1's 73 MB of segment rows evict K2's rows from the 50 MB L2, so K2 runs
    cold. Each kernel's cold time there is the pair's time less the other kernel's
    own graph time. Adds ``selfplay_ms``, ``selfplay_graph_ms``,
    ``selfplay_bound_ms`` and ``cold_graph_ms`` to the two kernels' entries."""
    x, y, ang = race_poses(track, rng, dev, NUM_AGENTS)
    rays = car_rays(cfg, x, y, ang)
    segs = [getattr(track, f)[:, None, None, :] for f in ("seg_sx", "seg_sy", "seg_vx",
                                                          "seg_vy", "seg_c")]
    max_dist = cfg.max_sensor_range
    k = geo.raycast_walls(*rays, *segs[:4], max_dist, seg_c=segs[4])
    p = geo.raycast_walls_plain(*rays, *segs[:4], max_dist, seg_c=segs[4])
    torch.cuda.synchronize()
    n_differ, max_err = hold_k1(k, p, max_dist, "self-play launch")
    rows, r, s = NUM_ENVS, NUM_AGENTS * rays[0].shape[-1], segs[0].shape[-1]
    print(f"K1 raycast_walls rays [{NUM_ENVS}, {NUM_AGENTS}, {rays[0].shape[-1]}] x rows "
          f"[{NUM_ENVS}, 1, 1, {s}]: {n_differ} non-identical rays (near-ties within 2 ulp), "
          f"max |err| {max_err:g}; plan {_cuda.raycast_walls_plan(r, s)}")
    k1["max_abs_err"] = max(k1["max_abs_err"], max_err)
    out = torch.empty_like(k)
    k1_launch = lambda: _cuda.launch_raycast_walls(*rays, *segs, out, rows, r, s, max_dist)
    k1_ms, k1_graph = per_launch_ms(k1_launch), graph_ms(k1_launch)
    k1_bound, k1_by = bound_ms(nbytes(*rays, *segs, out), rows * r * s * K1_OPS_PER_PAIR)
    print(f"K1 self-play launch: {k1_ms * 1e3:.1f} us eager back-to-back "
          f"({k1_graph * 1e3:.1f} us in a CUDA graph), bound {k1_bound * 1e3:.1f} us ({k1_by})")

    cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
    wp = [getattr(track, f)[:, None, :] for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")]
    tail = (track.n_wp[:, None], track.track_width[:, None])
    kp, kc = geo.progress_and_collision(x, y, cx, cy, *wp, *tail)
    pp, pc = geo.progress_and_collision_plain(x, y, cx, cy, *wp, *tail)
    w = track.wp_x.shape[-1]
    ep, ec = geo.progress_and_collision(
        x, y, cx, cy, *(t.expand(NUM_ENVS, NUM_AGENTS, w).contiguous() for t in wp), *tail)
    torch.cuda.synchronize()
    if not (torch.equal(kp, pp) and torch.equal(kc, pc) and torch.equal(kp, ep)
            and torch.equal(kc, ec)):
        raise AssertionError("K2 on shared waypoint rows differs from plain or from "
                             "expanded rows")
    progress, crashed = torch.empty_like(kp), torch.empty_like(kc)
    n_wp, width = (t.expand(NUM_ENVS, NUM_AGENTS).contiguous() for t in tail)
    cx, cy = cx.contiguous(), cy.contiguous()
    k2_launch = lambda: _cuda.launch_progress_and_collision(
        x, y, cx, cy, *wp, n_wp, width, progress, crashed, NUM_ENVS, NUM_AGENTS,
        cx.shape[-1], w)
    k2_ms, k2_graph = per_launch_ms(k2_launch), graph_ms(k2_launch)
    k2_b, k2_by = k2_bound(x, cx, track, progress, crashed)
    print(f"K2 progress_and_collision cars [{NUM_ENVS}, {NUM_AGENTS}] x rows "
          f"[{NUM_ENVS}, 1, {w}]: bitwise equal to plain and to expanded rows "
          f"({int(kc.sum())} crashed); plan "
          f"{_cuda.progress_collision_plan(NUM_AGENTS, cx.shape[-1], w)}; "
          f"{k2_ms * 1e3:.1f} us eager back-to-back ({k2_graph * 1e3:.1f} us in a CUDA graph), "
          f"bound {k2_b * 1e3:.1f} us ({k2_by})")

    def step_pair():
        k1_launch()
        k2_launch()
    pair = graph_ms(step_pair)
    k1_cold, k2_cold = pair - k2_graph, pair - k1_graph
    print(f"K1 then K2 on the same rows in a CUDA graph: {pair * 1e3:.1f} us a pair; K2 cold "
          f"{k2_cold * 1e3:.1f} us (warm {k2_graph * 1e3:.1f}), K1 {k1_cold * 1e3:.1f} us "
          f"(alone {k1_graph * 1e3:.1f})")
    for entry, own, graph, bound, cold in ((k1, k1_ms, k1_graph, k1_bound, k1_cold),
                                          (k2, k2_ms, k2_graph, k2_b, k2_cold)):
        entry.update(selfplay_ms=own, selfplay_graph_ms=graph, selfplay_bound_ms=bound,
                     cold_graph_ms=cold)


def check_k3(track, cfg, rng, dev):
    """K3 at the self-play shapes (and at 8 cars): every car's rays against the
    cars of its env, the own car skipped by the radius test."""
    results = {}
    for a in (NUM_AGENTS, 8):
        x, y, ang = race_poses(track, rng, dev, a)
        cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
        rays = car_rays(cfg, x, y, ang)
        cars = [cx[:, None, None], cy[:, None, None], x[:, None, None, :].contiguous(),
                y[:, None, None, :].contiguous()]
        k = geo.raycast_cars(*rays, *cars, cfg.max_sensor_range)
        p = geo.raycast_cars_plain(*rays, *cars, cfg.max_sensor_range)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K3 at {a} cars: {int((k != p).sum())} rays differ from plain")
        hit = float((k < cfg.max_sensor_range).float().mean())
        print(f"K3 raycast_cars rays [{NUM_ENVS}, {a}, {rays[0].shape[-1]}] x {a} cars: "
              f"bitwise equal to plain, {hit:.3f} of rays hit a car")
        results[a] = (rays, cars, k)
    rays, cars, k = results[NUM_AGENTS]
    out = torch.empty_like(k)
    r = rays[0].shape[-1]
    launch = lambda: _cuda.launch_raycast_cars(*rays, *cars, out, NUM_ENVS, NUM_AGENTS * r,
                                               NUM_AGENTS, cfg.max_sensor_range)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    plain_ms = per_launch_ms(lambda: geo.raycast_cars_plain(*rays, *cars, cfg.max_sensor_range),
                             windows=5, launches=5)
    # the edge work is done only for cars outside the skip radius of the ray
    cdx = cars[2] - rays[0][..., None]
    cdy = cars[3] - rays[1][..., None]
    seen = int((torch.sqrt(cdx * cdx + cdy * cdy) >= 0.5).sum())
    ops = k.numel() * NUM_AGENTS * K3_OPS_PER_RAY_CAR + seen * 4 * K3_OPS_PER_RAY_EDGE
    b_ms, b_by = bound_ms(nbytes(*rays, *cars, out), ops)
    print(f"K3 time {ms * 1e3:.2f} us eager back-to-back ({g_ms * 1e3:.2f} us in a CUDA "
          f"graph), bound {b_ms * 1e3:.3f} us ({b_by}), plain {plain_ms * 1e3:.1f} us")
    return {"name": "raycast_cars", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/raycast_cars.cu",
            "replaces": "self_play_racing_tpu/ops/geometry.py:243",
            "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_k4(track, cfg, rng, dev):
    """K4 at the self-play shapes (and at 8 cars): the SAT test of every pair."""
    for a in (8, NUM_AGENTS):
        x, y, ang = race_poses(track, rng, dev, a)
        cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
        cx, cy = cx.contiguous(), cy.contiguous()
        k = geo.rectangles_intersect_pairs(cx, cy)
        p = geo.rectangles_intersect_pairs_plain(cx, cy)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            raise AssertionError(f"K4 at {a} cars: {int((k != p).sum())} pairs differ from plain")
        off = k[:, ~torch.eye(a, dtype=torch.bool, device=dev)]
        print(f"K4 rectangles_intersect pairs [{NUM_ENVS}, {a}, {a}]: equal to plain, "
              f"{float(off.float().mean()):.3f} of distinct pairs touch")
    out = torch.empty_like(k)
    launch = lambda: _cuda.launch_rectangles_intersect(cx, cy, out, NUM_ENVS, a)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    plain_ms = per_launch_ms(lambda: geo.rectangles_intersect_pairs_plain(cx, cy),
                             windows=5, launches=5)
    b_ms, b_by = bound_ms(nbytes(cx, cy, out), out.numel() * 4 * K4_OPS_PER_PAIR_AXIS)
    print(f"K4 time {ms * 1e3:.2f} us eager back-to-back ({g_ms * 1e3:.2f} us in a CUDA "
          f"graph), bound {b_ms * 1e3:.3f} us ({b_by}), plain {plain_ms * 1e3:.1f} us")
    return {"name": "rectangles_intersect", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/rectangles_intersect.cu",
            "replaces": "self_play_racing_tpu/ops/geometry.py:217",
            "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def check_k5(track, cfg, rng, dev):
    """K5 at the self-play shapes (and at 8 cars), crashed cars and the speed clamp
    included; bitwise, the heading's cos/sin too."""
    for a in (8, NUM_AGENTS):
        x, y, ang = race_poses(track, rng, dev, a)
        def f32(lo, hi):
            return torch.as_tensor(rng.uniform(lo, hi, (NUM_ENVS, a)), dtype=torch.float32,
                                   device=dev)
        args = (x, y, ang, f32(-35, 35), f32(-35, 35),
                torch.as_tensor(rng.random((NUM_ENVS, a)) < 0.1, device=dev),
                f32(-1, 1), f32(0, 1))
        k = dynamics.car_update(*args, cfg.dt, cfg.car)
        p = dynamics.car_update_plain(*args, cfg.dt, cfg.car)
        torch.cuda.synchronize()
        for name, kt, pt in zip(("x", "y", "angle", "vx", "vy"), k, p):
            if not torch.equal(kt, pt):
                ulps = ((kt - pt).abs() / (torch.nextafter(pt.abs(), pt.abs() + 1)
                                           - pt.abs())).max()
                raise AssertionError(f"K5 at {a} cars: {name} differs from plain in "
                                     f"{int((kt != pt).sum())} cars, up to {float(ulps):.0f} ulp")
        print(f"K5 car_update [{NUM_ENVS}, {a}]: bitwise equal to plain (cos/sin included)")
    outs = [torch.empty_like(x) for _ in range(5)]
    consts = [np.float32(v) for v in (cfg.car.steering_speed, cfg.car.acceleration,
                                      cfg.car.drag, cfg.car.lateral_friction, cfg.car.grip,
                                      cfg.car.max_speed, cfg.dt, 2 * np.pi)]
    launch = lambda: _cuda.launch_car_update(*args, *outs, x.numel(), consts)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    plain_ms = per_launch_ms(lambda: dynamics.car_update_plain(*args, cfg.dt, cfg.car),
                             windows=5, launches=5)
    b_ms, b_by = bound_ms(nbytes(*args, *outs), x.numel() * K5_OPS_PER_CAR)
    print(f"K5 time {ms * 1e3:.2f} us eager back-to-back ({g_ms * 1e3:.2f} us in a CUDA "
          f"graph), bound {b_ms * 1e3:.3f} us ({b_by}), plain {plain_ms * 1e3:.1f} us")
    return {"name": "car_update", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/car_update.cu",
            "replaces": "self_play_racing_tpu/ops/dynamics.py:37",
            "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def sensing_inputs(track, cfg, rng, dev, a):
    """Poses of ``a`` cars per env and the sensing's inputs as the multi-car env
    passes them: poses [N, A], sensor angles [R], segment rows [N, S]."""
    x, y, ang = race_poses(track, rng, dev, a)
    rel = torch.as_tensor(cfg.sensor_angles(), dtype=torch.float32, device=dev)
    segs = [getattr(track, f) for f in ("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c")]
    return (x, y, ang.contiguous(), rel, *segs, cfg.car.length / 2, cfg.car.width / 2,
            cfg.max_sensor_range)


def sensing_chain(x, y, ang, rel, sx, sy, vx, vy, c, hl, hw, max_dist):
    """What the multi-car env launched before ``raycast_walls_and_cars``: the rays
    and corners in PyTorch, the K1 and K3 kernels, their minimum."""
    world = ang[:, :, None] + rel
    ox, oy = x[:, :, None].expand(world.shape), y[:, :, None].expand(world.shape)
    dx, dy = torch.cos(world), torch.sin(world)
    wall = geo.raycast_walls(ox, oy, dx, dy, *(t[:, None, None, :] for t in (sx, sy, vx, vy)),
                             max_dist, seg_c=c[:, None, None, :])
    ccx, ccy = geo.car_corners(x, y, ang, hl, hw)
    cars = geo.raycast_cars(ox, oy, dx, dy, ccx[:, None, None], ccy[:, None, None],
                            x[:, None, None, :].contiguous(), y[:, None, None, :].contiguous(),
                            max_dist)
    return torch.minimum(wall, cars)


def step_inputs(track, cfg, rng, dev, a):
    """``a`` cars per env (crashed ~10%, speeds above the clamp) and the waypoint
    rows as the envs pass them: [N, 1, W] rows with one value per row, or at one car
    the single-car env's [N] cars against [N, W] rows."""
    x, y, ang = race_poses(track, rng, dev, a)
    def f32(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (NUM_ENVS, a)), dtype=torch.float32,
                               device=dev)
    cars = [x, y, ang.contiguous(), f32(-35, 35), f32(-35, 35),
            torch.as_tensor(rng.random((NUM_ENVS, a)) < 0.1, device=dev), f32(-1, 1), f32(0, 1)]
    wp = [getattr(track, f) for f in ("wp_x", "wp_y", "nrm_x", "nrm_y", "n_wp", "track_width")]
    if a == 1:
        return [t[:, 0].contiguous() for t in cars], wp
    return cars, [t[:, None] for t in wp]


def transition_constants(cfg):
    """The ten float32 constants the transition kernel's launcher takes: K5's eight,
    then the car's half length and half width."""
    return [np.float32(v) for v in (cfg.car.steering_speed, cfg.car.acceleration,
                                    cfg.car.drag, cfg.car.lateral_friction, cfg.car.grip,
                                    cfg.car.max_speed, cfg.dt, 2 * np.pi,
                                    cfg.car.length / 2, cfg.car.width / 2)]


def step_chain(cars, wp, cfg):
    """What the envs launched before ``car_step_and_query``: K5, car_corners in
    PyTorch, K2."""
    state = dynamics.car_update(*cars, cfg.dt, cfg.car)
    ccx, ccy = geo.car_corners(state[0], state[1], state[2], cfg.car.length / 2,
                               cfg.car.width / 2)
    return (*state, ccx, ccy, *geo.progress_and_collision(state[0], state[1], ccx, ccy, *wp))


def check_env_kernels(track, cfg, rng, dev):
    """The envs' two kernels against the standalone kernels they replace and their
    plain versions, at 1, 2 and 8 cars; timed at the self-play shapes (and the
    transition at one car), beside their bounds and the chains they replace."""
    max_dist = cfg.max_sensor_range
    sensing = {}
    for a in (1, NUM_AGENTS, 8):
        args = sensing_inputs(track, cfg, rng, dev, a)
        k = geo.raycast_walls_and_cars(*args)
        p = geo.raycast_walls_and_cars_plain(*args)
        chain = sensing_chain(*args)
        torch.cuda.synchronize()
        if not torch.equal(k, chain):
            raise AssertionError(f"raycast_walls_and_cars at {a} cars: {int((k != chain).sum())} "
                                 "rays differ from K1 and K3 on the same inputs")
        n_differ, max_err = hold_k1(k, p, max_dist, f"raycast_walls_and_cars at {a} cars")
        print(f"raycast_walls_and_cars rays [{NUM_ENVS}, {a}, {k.shape[-1]}] x "
              f"{args[4].shape[-1]} segments and {a} cars: bitwise equal to K1 + K3; against "
              f"plain {n_differ} non-identical rays (K1's near-ties within 2 ulp), max |err| "
              f"{max_err:g}; plan "
              f"{_cuda.raycast_walls_and_cars_plan(a, k.shape[-1], args[4].shape[-1])}")
        sensing[a] = (args, k, max_err)
    args, k, _ = sensing[NUM_AGENTS]
    x, y, ang, rel, *segs = args[:9]
    hl, hw = np.float32(args[9]), np.float32(args[10])
    rows, r, s = NUM_ENVS, rel.shape[0], segs[0].shape[-1]
    out = torch.empty_like(k)
    launch = lambda: _cuda.launch_raycast_walls_and_cars(
        x, y, ang, rel, *segs, out, rows, NUM_AGENTS, r, s, hl, hw, max_dist)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    chain_ms = per_launch_ms(lambda: sensing_chain(*args))
    chain_g = graph_ms(lambda: sensing_chain(*args))
    plain_ms = per_launch_ms(lambda: geo.raycast_walls_and_cars_plain(*args), windows=3,
                             launches=2)
    # K1's operations at the self-play launch plus K3's, counted from the data: the
    # skip test for every ray and car, the edges of the cars outside the radius
    cdx = x[:, None, :] - x[:, :, None]
    cdy = y[:, None, :] - y[:, :, None]
    seen = int((torch.sqrt(cdx * cdx + cdy * cdy) >= 0.5).sum()) * r
    ops = (out.numel() * s * K1_OPS_PER_PAIR + out.numel() * NUM_AGENTS * K3_OPS_PER_RAY_CAR
           + seen * 4 * K3_OPS_PER_RAY_EDGE)
    b_ms, b_by = bound_ms(nbytes(x, y, ang, rel, *segs, out), ops)
    print(f"raycast_walls_and_cars time {ms * 1e3:.1f} us eager back-to-back ({g_ms * 1e3:.1f} "
          f"us in a CUDA graph), bound {b_ms * 1e3:.1f} us ({b_by}), plain {plain_ms * 1e3:.1f} "
          f"us; the chain it replaces (rays and corners, K1, K3, minimum: "
          f"{chain_ms * 1e3:.1f} us eager, {chain_g * 1e3:.1f} us in a CUDA graph)")
    entries = [{"name": "raycast_walls_and_cars", "route": "cuda",
                "source": "self_play_racing_tpu_torch/csrc/raycast_walls_and_cars.cu",
                "replaces": "self_play_racing_tpu/ops/geometry.py:243",
                "fused_with": "self_play_racing_tpu/ops/geometry.py:26",
                "max_abs_err": max(e for _, _, e in sensing.values()), "ms": ms,
                "graph_ms": g_ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": None, "chain_ms": chain_ms, "chain_graph_ms": chain_g}]

    steps = {}
    for a in (1, NUM_AGENTS, 8):
        cars, wp = step_inputs(track, cfg, rng, dev, a)
        k = dynamics.car_step_and_query(*cars, cfg.dt, cfg.car, *wp)
        p = dynamics.car_step_and_query_plain(*cars, cfg.dt, cfg.car, *wp)
        chain = step_chain(cars, wp, cfg)
        torch.cuda.synchronize()
        for name, kt, pt, ct in zip(("x", "y", "angle", "vx", "vy", "corners_x", "corners_y",
                                     "progress", "hit_wall"), k, p, chain):
            if not (torch.equal(kt, pt) and torch.equal(kt, ct)):
                raise AssertionError(f"car_step_and_query at {a} cars: {name} differs from "
                                     f"plain in {int((kt != pt).sum())} and from K5 + "
                                     f"car_corners + K2 in {int((kt != ct).sum())} cars")
        print(f"car_step_and_query cars {list(cars[0].shape)} x rows {list(wp[0].shape)}: "
              f"bitwise equal to plain and to K5 + car_corners + K2 ({int(k[8].sum())} hit a "
              f"wall, {int(cars[5].sum())} crashed before); plan "
              f"{_cuda.car_step_query_plan(a, wp[0].shape[-1])}")
        steps[a] = (cars, wp, k)
    timings = {}
    for a in (NUM_AGENTS, 1):
        cars, wp, k = steps[a]
        w = wp[0].shape[-1]
        per_row = [t.reshape(NUM_ENVS).contiguous() for t in wp[4:]]
        outs = [torch.empty_like(t) for t in k]
        consts = transition_constants(cfg)
        launch = lambda: _cuda.launch_car_step_and_query(
            *cars, *wp[:4], *per_row, *outs, NUM_ENVS, a, w, consts)
        ms, g_ms = per_launch_ms(launch), graph_ms(launch)
        chain_ms = per_launch_ms(lambda: step_chain(cars, wp, cfg))
        chain_g = graph_ms(lambda: step_chain(cars, wp, cfg))
        plain_ms = per_launch_ms(lambda: dynamics.car_step_and_query_plain(
            *cars, cfg.dt, cfg.car, *wp), windows=5, launches=5)
        # K2's bytes (the rows' positions, the normals at the corners' winners, one
        # count and width a row) plus K5's (its fields in and out), and the corners
        n = cars[0].numel()
        read = nbytes(*cars, wp[0], wp[1], *per_row) + 8 * n * 4
        b_ms, b_by = bound_ms(read + nbytes(*outs), n * (5 * w * K2_OPS_PER_PAIR + K5_OPS_PER_CAR))
        print(f"car_step_and_query cars {list(cars[0].shape)}: {ms * 1e3:.1f} us eager "
              f"back-to-back ({g_ms * 1e3:.1f} us in a CUDA graph), bound {b_ms * 1e3:.2f} us "
              f"({b_by}), plain {plain_ms * 1e3:.1f} us; the chain it replaces (K5, "
              f"car_corners, K2: {chain_ms * 1e3:.1f} us eager, {chain_g * 1e3:.1f} us in a "
              f"CUDA graph)")
        timings[a] = (ms, g_ms, plain_ms, b_ms, b_by, chain_ms, chain_g)
    ms, g_ms, plain_ms, b_ms, b_by, chain_ms, chain_g = timings[NUM_AGENTS]
    entries.append({"name": "car_step_and_query", "route": "cuda",
                    "source": "self_play_racing_tpu_torch/csrc/car_step_and_query.cu",
                    "replaces": "self_play_racing_tpu/ops/dynamics.py:37",
                    "fused_with": "self_play_racing_tpu/ops/geometry.py:176",
                    "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                    "chain_ms": chain_ms, "chain_graph_ms": chain_g,
                    "single_car_ms": timings[1][0], "single_car_graph_ms": timings[1][1],
                    "single_car_bound_ms": timings[1][3],
                    "single_car_chain_graph_ms": timings[1][6]})
    return entries


def contact_chain(cars, wp, cfg):
    """What the multi-car env launched before the pair test moved into
    ``car_step_and_query``: the kernel without it, K4 over the row's pairs, the
    mask, the sum, the velocity ladder and the touch penalty."""
    out = dynamics.car_step_and_query(*cars, cfg.dt, cfg.car, *wp)
    nvx, nvy = out[3], out[4]
    a = cars[0].shape[-1]
    hits = geo.rectangles_intersect_pairs(out[5], out[6])
    hits = hits & ~torch.eye(a, dtype=torch.bool, device=hits.device)
    num_hits = hits.sum(dim=-1)
    for m in range(a - 1):
        more = num_hits > m
        nvx = torch.where(more, nvx * cfg.collision_speed_scale, nvx)
        nvy = torch.where(more, nvy * cfg.collision_speed_scale, nvy)
    penalty = -cfg.touch_penalty * num_hits.to(torch.float32)
    return (*out[:3], nvx, nvy, *out[5:], num_hits.to(torch.int32)), penalty


def check_contacts(track, cfg, rng, dev, entry):
    """``car_step_and_query`` with the pair test, as the multi-car env calls it: at
    2, 3 and 8 cars bitwise equal to the chain it replaces (the kernel without the
    pair test, K4, the mask, the sum and the ladder) and to its plain version,
    with the cars touching 1, 2 and 3+ partners counted; timed at the self-play
    shapes beside its bound and the chain in one CUDA graph. Puts the folded
    kernel's numbers (the self-play path's instantiation) into ``entry`` and keeps
    the numbers without the pair test beside them."""
    scale = cfg.collision_speed_scale
    names = ("x", "y", "angle", "vx", "vy", "corners_x", "corners_y", "progress",
             "hit_wall", "num_hits")
    folded = {}
    for a in (NUM_AGENTS, 3, 8):
        cars, wp = step_inputs(track, cfg, rng, dev, a)
        k = dynamics.car_step_and_query(*cars, cfg.dt, cfg.car, *wp, collision_speed_scale=scale)
        p = dynamics.car_step_and_query_plain(*cars, cfg.dt, cfg.car, *wp,
                                              collision_speed_scale=scale)
        chain, _ = contact_chain(cars, wp, cfg)
        torch.cuda.synchronize()
        for name, kt, pt, ct in zip(names, k, p, chain):
            if not (torch.equal(kt, pt) and torch.equal(kt, ct)):
                raise AssertionError(f"car_step_and_query with contacts at {a} cars: {name} "
                                     f"differs from plain in {int((kt != pt).sum())} and from "
                                     f"the chain in {int((kt != ct).sum())} cars")
        hits = k[9]
        touching = [int((hits == 1).sum()), int((hits == 2).sum()), int((hits >= 3).sum())]
        if touching[0] == 0 or (a > 2 and touching[1] + touching[2] == 0):
            raise AssertionError(f"car_step_and_query with contacts at {a} cars: cars touching "
                                 f"1, 2, 3+ partners {touching}; the check needs contacts")
        print(f"car_step_and_query with the pair test, cars [{NUM_ENVS}, {a}] x rows "
              f"{list(wp[0].shape)}: bitwise equal to plain and to the kernel + K4 + mask + "
              f"sum + ladder; cars touching 1 / 2 / 3+ partners {touching[0]} / {touching[1]} "
              f"/ {touching[2]}; plan "
              f"{_cuda.car_step_query_plan(a, wp[0].shape[-1], True)}")
        folded[a] = (cars, wp, k)
    cars, wp, k = folded[NUM_AGENTS]
    w = wp[0].shape[-1]
    per_row = [t.reshape(NUM_ENVS).contiguous() for t in wp[4:]]
    outs = [torch.empty_like(t) for t in k]
    consts = transition_constants(cfg)
    launch = lambda: _cuda.launch_car_step_and_query(
        *cars, *wp[:4], *per_row, *outs[:9], NUM_ENVS, NUM_AGENTS, w, consts, outs[9],
        np.float32(scale))
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)

    def env_folded():  # what the env now runs: the one call and the touch penalty
        out = dynamics.car_step_and_query(*cars, cfg.dt, cfg.car, *wp,
                                          collision_speed_scale=scale)
        return -cfg.touch_penalty * out[9].to(torch.float32)
    env_g = graph_ms(env_folded)
    chain_ms = per_launch_ms(lambda: contact_chain(cars, wp, cfg))
    chain_g = graph_ms(lambda: contact_chain(cars, wp, cfg))
    plain_ms = per_launch_ms(lambda: dynamics.car_step_and_query_plain(
        *cars, cfg.dt, cfg.car, *wp, collision_speed_scale=scale), windows=5, launches=5)
    n = cars[0].numel()
    read = nbytes(*cars, wp[0], wp[1], *per_row) + 8 * n * 4
    ops = (n * (5 * w * K2_OPS_PER_PAIR + K5_OPS_PER_CAR)
           + NUM_ENVS * NUM_AGENTS * NUM_AGENTS * 4 * K4_OPS_PER_PAIR_AXIS)
    b_ms, b_by = bound_ms(read + nbytes(*outs), ops)
    print(f"car_step_and_query with the pair test, cars [{NUM_ENVS}, {NUM_AGENTS}]: "
          f"{ms * 1e3:.1f} us eager back-to-back ({g_ms * 1e3:.1f} us in a CUDA graph; "
          f"without the pair test {entry['graph_ms'] * 1e3:.1f} us), bound {b_ms * 1e3:.2f} us "
          f"({b_by}), plain {plain_ms * 1e3:.1f} us; with the env's touch penalty "
          f"{env_g * 1e3:.1f} us in a CUDA graph against the chain it replaces (the kernel, "
          f"K4, mask, sum, ladder, penalty: {chain_ms * 1e3:.1f} us eager, "
          f"{chain_g * 1e3:.1f} us in a CUDA graph)")
    entry.update(no_pairs_ms=entry["ms"], no_pairs_graph_ms=entry["graph_ms"],
                 no_pairs_bound_ms=entry["bound_ms"], no_pairs_chain_graph_ms=entry["chain_graph_ms"],
                 ms=ms, graph_ms=g_ms, bound_ms=b_ms, bound_by=b_by, plain_ms=plain_ms,
                 env_graph_ms=env_g, chain_ms=chain_ms, chain_graph_ms=chain_g,
                 fused_with=entry["fused_with"] + ", self_play_racing_tpu/ops/geometry.py:217")


def l2_flush(dev):
    """A write of 128 MB, more than the H100's 50 MB L2: what a kernel reads after
    it comes from HBM."""
    buf = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    return buf.zero_


def cold_ms(fn, flush, windows=21):
    """Median over ``windows`` of ``fn``'s time right after ``flush``: CUDA events
    around ``fn`` alone (the flush keeps the queue ahead of the card, so no host
    launch gap falls inside)."""
    fn()
    times = []
    for _ in range(windows):
        flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cold_graph_ms(fn, flush, launches=10):
    """``fn``'s per-launch device time in a CUDA graph of ``launches`` (flush, fn)
    pairs, less that of a graph of the flushes alone."""
    def pair():
        flush()
        fn()
    return graph_ms(pair, launches=launches) - graph_ms(flush, launches=launches)


def gae_inputs(gen, steps, envs, dev):
    """A rollout-like batch: small progress rewards with rare crash penalties,
    values around the returns' scale, ~1/300 of steps ending an episode."""
    shape = (steps, envs)
    rewards = torch.rand(shape, generator=gen, device=dev) * 2.0
    crash = torch.rand(shape, generator=gen, device=dev) < 1 / 300
    rewards = torch.where(crash, rewards - 60.0, rewards)
    values = torch.randn(shape, generator=gen, device=dev) * 10.0 + 20.0
    next_value = torch.randn((envs,), generator=gen, device=dev) * 10.0 + 20.0
    next_done = torch.rand((envs,), generator=gen, device=dev) < 1 / 300
    return rewards, crash, values, next_value, next_done


def check_k6(dev):
    """K6 bitwise against its plain version on a rollout-like batch at the main
    path's [256, 4096] (and its all-done and no-done cases), at ``train single``'s
    default [2048, 16] and at a ragged [256, 4113]; timed warm (back to back) and
    cold (after an L2 flush), eager and in a CUDA graph, beside its bound."""
    gen = torch.Generator(device=dev).manual_seed(6)
    rewards, crash, values, next_value, next_done = gae_inputs(gen, STEPS, NUM_ENVS, dev)
    cases = {"rollout-like": (rewards, crash, values, next_value, next_done),
             "all-done": (rewards, torch.ones_like(crash), values, next_value,
                          torch.ones_like(next_done)),
             "no-done": (rewards, torch.zeros_like(crash), values, next_value,
                         torch.zeros_like(next_done)),
             "train single [2048, 16]": gae_inputs(gen, 2048, 16, dev),
             f"ragged [{STEPS}, {NUM_ENVS + 17}]": gae_inputs(gen, STEPS, NUM_ENVS + 17, dev)}
    max_err = 0.0
    for name, args in cases.items():
        ka, kr = gae.compute_gae(*args, 0.99, 0.95)
        pa, pr = gae.compute_gae_plain(*args, 0.99, 0.95)
        torch.cuda.synchronize()
        if not (torch.equal(ka, pa) and torch.equal(kr, pr)):
            raise AssertionError(f"K6 {name}: {int((ka != pa).sum())} advantages and "
                                 f"{int((kr != pr).sum())} returns differ from plain")
        max_err = max(max_err, float((ka - pa).abs().max()), float((kr - pr).abs().max()))
    print(f"K6 compute_gae: advantages and returns bitwise equal to plain ({', '.join(cases)}; "
          f"{int(crash.sum())} terminal steps at [{STEPS}, {NUM_ENVS}])")
    adv, ret = torch.empty_like(rewards), torch.empty_like(rewards)
    g, gl = float(np.float32(0.99)), float(np.float32(0.99 * 0.95))
    flush = l2_flush(dev)
    b_ms, b_by = bound_ms(nbytes(rewards, crash, values, next_value, next_done, adv, ret),
                          STEPS * NUM_ENVS * K6_OPS_PER_SAMPLE)
    launch = lambda: _cuda.launch_compute_gae(
        rewards, crash, values, next_value, next_done, adv, ret, STEPS, NUM_ENVS, g, gl)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    c_ms, cg_ms = cold_ms(launch, flush), cold_graph_ms(launch, flush)
    small = cases["train single [2048, 16]"]
    s_adv, s_ret = torch.empty_like(small[0]), torch.empty_like(small[0])
    s_launch = lambda: _cuda.launch_compute_gae(*small, s_adv, s_ret, 2048, 16, g, gl)
    s_bound, _ = bound_ms(nbytes(*small, s_adv, s_ret), 2048 * 16 * K6_OPS_PER_SAMPLE)
    s_graph = graph_ms(s_launch)
    plain_ms = per_launch_ms(lambda: gae.compute_gae_plain(
        rewards, crash, values, next_value, next_done, 0.99, 0.95), windows=3, launches=2)
    print(f"K6 [{STEPS}, {NUM_ENVS}]: warm {ms * 1e3:.1f} us eager back-to-back, "
          f"{g_ms * 1e3:.1f} us in a CUDA graph; cold (after a 128 MB L2 flush) "
          f"{c_ms * 1e3:.1f} us eager, {cg_ms * 1e3:.1f} us in a CUDA graph; bound "
          f"{b_ms * 1e3:.1f} us ({b_by}), plain {plain_ms * 1e3:.1f} us; [2048, 16] "
          f"{s_graph * 1e3:.1f} us in a CUDA graph (bound {s_bound * 1e3:.2f} us)")
    return {"name": "compute_gae", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/gae.cu",
            "replaces": "self_play_racing_tpu/ops/gae.py:24",
            "max_abs_err": max_err, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "cold_ms": c_ms, "cold_graph_ms": cg_ms,
            "train_single_graph_ms": s_graph, "train_single_bound_ms": s_bound}


def check_k7(dev, n_units):
    """K7 for every epoch of one update at the bench width."""
    epochs = base_config().update_epochs
    gen = torch.Generator(device=dev).manual_seed(7)
    consts = prng.draw_constants((epochs, 1), gen, device=dev)
    k = prng.mixbits_permutation(consts, n_units)
    p = prng.mixbits_permutation_plain(consts, n_units)
    torch.cuda.synchronize()
    if not torch.equal(k, p):
        raise AssertionError(f"K7: {int((k != p).sum())} indices differ from plain")
    arange = torch.arange(n_units, dtype=torch.int32, device=dev)
    if not torch.equal(torch.sort(k, dim=-1).values, arange.expand(k.shape)):
        raise AssertionError("K7: an output is not a permutation")
    print(f"K7 mixbits_permutation [{epochs}, 1, {n_units}]: equal to plain, "
          f"each row a permutation")
    out = torch.empty_like(k)
    log2_n = n_units.bit_length() - 1
    launch = lambda: _cuda.launch_mixbits_permutation(consts, out, epochs, log2_n)
    ms, g_ms = per_launch_ms(launch), graph_ms(launch)
    plain_ms = per_launch_ms(lambda: prng.mixbits_permutation_plain(consts, n_units),
                             windows=5, launches=5)
    b_ms, b_by = bound_ms(nbytes(consts, out), epochs * n_units * K7_OPS_PER_INDEX)
    print(f"K7 time {ms * 1e3:.2f} us eager back-to-back "
          f"({g_ms * 1e3:.2f} us in a CUDA graph), "
          f"bound {b_ms * 1e3:.2f} us ({b_by}), plain {plain_ms * 1e3:.1f} us")
    return {"name": "mixbits_permutation", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/mixbits_permutation.cu",
            "replaces": "self_play_racing_tpu/ops/prng.py:21",
            "max_abs_err": float((k - p).abs().max()), "ms": ms, "graph_ms": g_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


PROCGEN_TRACKS = 16
# phase (a): the card's float32 pool against the CPU's float64 pool from the same
# uniforms. float32 alone moves waypoints by ~7e-5 m, segment vectors by ~2.4e-4 and
# seg_c (a difference of products ~1e3) by ~0.02 on the CPU (20 pools of 16 tracks)
PROCGEN_ATOL = 1e-3
PROCGEN_SEG_C_ATOL = 0.1


def procgen_on_card(dev):
    """Phase (a): a 16-track procedural pool built on the card from uniforms drawn
    there, against the pool the CPU builds in float64 from the same uniforms."""
    t0 = time.perf_counter()
    u = pg.draw_track_uniforms(torch.Generator(device=dev).manual_seed(7), PROCGEN_TRACKS, 12)
    pool = pg.pool_from_uniforms(u)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cpu = pg.TrackUniforms(**{f.name: getattr(u, f.name).cpu().double()
                              for f in dataclasses.fields(u)})
    ref = pg.pool_from_uniforms(cpu, dtype=torch.float32)
    worst = {}
    for f in dataclasses.fields(trk.TrackArrays):
        a, b = getattr(pool, f.name).cpu().double(), getattr(ref, f.name).double()
        worst[f.name] = float((a - b).abs().max())
        tol = PROCGEN_SEG_C_ATOL if f.name == "seg_c" else PROCGEN_ATOL
        if a.shape != b.shape or not worst[f.name] <= tol:
            raise AssertionError(f"procgen {f.name}: card vs CPU float64 {worst[f.name]:g} > {tol}")
    w, s = pool.wp_x.shape[-1], pool.seg_sx.shape[-1]
    if (w, s) != (384, 768):
        raise AssertionError(f"procgen pool W={w}, S={s}; expected 384, 768")
    print(f"procgen: {PROCGEN_TRACKS} tracks x 12 points built on the card in {dt * 1e3:.1f} ms; "
          f"W {w}, S {s}; against the CPU's float64 pool from the same uniforms: positions "
          f"within {max(worst[k] for k in ('wp_x', 'wp_y', 'seg_sx', 'seg_sy')):.2e}, segment "
          f"vectors {max(worst['seg_vx'], worst['seg_vy']):.2e}, seg_c {worst['seg_c']:.2e} "
          f"(atol {PROCGEN_ATOL:g}, seg_c {PROCGEN_SEG_C_ATOL:g})")
    return pool


def row_id_layouts(pool, rng):
    """The pool over NUM_ENVS envs tiled (env i on track i % T), grouped (blocks of
    N / T envs) and by arbitrary ids (the even rows only, repeated, in no order)."""
    t = pool.num_tracks
    return {"tiled": trk.tiled_pooled_tracks(pool, NUM_ENVS),
            "grouped": trk.grouped_pooled_tracks(pool, rng.permutation(t), NUM_ENVS // t),
            "arbitrary": trk.pooled_tracks(pool, rng.choice(np.arange(0, t, 2), NUM_ENVS))}


def row_id_inputs(layout, cfg, mcfg, rng, dev):
    """The three kernels' inputs on a layout, as the envs pass them: the pool's rows
    with the row ids, and the same on the gathered rows. Returns {kernel: (args
    with ids, args gathered, their keyword arguments, the gathered call's)}."""
    pool, ids = layout.pool, layout.ids
    g = trk.gather_tracks(pool, ids)
    x, y, ang = car_poses(g, rng, dev)
    world = ang[:, None] + torch.as_tensor(cfg.sensor_angles(), dtype=torch.float32, device=dev)
    rays = [x[:, None].expand(world.shape).contiguous(), y[:, None].expand(world.shape).contiguous(),
            torch.cos(world), torch.sin(world)]
    seg_names = ("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c")
    k1 = lambda tr: (*rays, *(getattr(tr, f)[:, None, :] for f in seg_names[:4]),  # noqa: E731
                     cfg.max_sensor_range)
    sense = sensing_inputs(g, mcfg, rng, dev, NUM_AGENTS)
    pooled_sense = (*sense[:4], *(getattr(pool, f) for f in seg_names), *sense[9:])
    cars, wp = step_inputs(g, mcfg, rng, dev, NUM_AGENTS)
    pooled_wp = [getattr(pool, f)[:, None] for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")] + wp[4:]
    one, wp1 = step_inputs(g, mcfg, rng, dev, 1)
    pooled_wp1 = [getattr(pool, f) for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")] + wp1[4:]
    scale = {"collision_speed_scale": mcfg.collision_speed_scale}
    spec = (mcfg.dt, mcfg.car)
    return {"raycast_walls": (k1(pool), k1(g), {"seg_c": pool.seg_c[:, None, :]},
                              {"seg_c": g.seg_c[:, None, :]}),
            "raycast_walls_and_cars": (pooled_sense, sense, {}, {}),
            "car_step_and_query": ((*cars, *spec, *pooled_wp), (*cars, *spec, *wp), scale, scale),
            "car_step_and_query single-car": ((*one, *spec, *pooled_wp1), (*one, *spec, *wp1),
                                              {}, {})}


ROW_ID_FNS = {
    "raycast_walls": (geo.raycast_walls, geo.raycast_walls_plain),
    "raycast_walls_and_cars": (geo.raycast_walls_and_cars, geo.raycast_walls_and_cars_plain),
    "car_step_and_query": (dynamics.car_step_and_query, dynamics.car_step_and_query_plain),
    "car_step_and_query single-car": (dynamics.car_step_and_query,
                                      dynamics.car_step_and_query_plain),
}


def hold_row_ids(layout, cfg, mcfg, rng, dev, what):
    """Each kernel with row ids bitwise itself on the gathered rows, and its plain
    version with row ids (the raycasts by K1's rule). Returns the inputs and the
    max |err| against the plain versions."""
    inputs = row_id_inputs(layout, cfg, mcfg, rng, dev)
    ids = layout.ids
    errs = {}
    for name, (args, gathered, kw, gkw) in inputs.items():
        kernel, plain = ROW_ID_FNS[name]
        k = kernel(*args, **kw, row_ids=ids)
        kg = kernel(*gathered, **gkw)
        p = plain(*args, **kw, row_ids=ids)
        torch.cuda.synchronize()
        k, kg, p = ((t,) if isinstance(t, torch.Tensor) else t for t in (k, kg, p))
        for i, (a, b, c) in enumerate(zip(k, kg, p)):
            if not torch.equal(a, b):
                raise AssertionError(f"{name} with row ids ({what}): output {i} differs from the "
                                     f"kernel on the gathered rows in {int((a != b).sum())} places")
            if name.startswith("raycast"):
                hold_k1(a, c, cfg.max_sensor_range, f"{name} with row ids ({what})")
            elif not torch.equal(a, c):
                raise AssertionError(f"{name} with row ids ({what}): output {i} differs from "
                                     f"plain in {int((a != c).sum())} places")
            if a.is_floating_point():
                errs[name] = max(errs.get(name, 0.0), float((a - c).abs().max()))
    return inputs, errs


def time_row_ids(layout, inputs, mcfg, dev):
    """The three kernels' graph time with row ids against the gathered rows' on a
    layout, eager time and plain time with ids, and their bounds with the rows
    counted once per distinct row. Returns {kernel: numbers}."""
    pool, ids = layout.pool, layout.ids
    distinct = int(torch.unique(ids).numel())
    rows = lambda *names: distinct * sum(  # noqa: E731
        getattr(pool, f)[0].numel() * 4 for f in names)
    out = {}
    max_dist = mcfg.max_sensor_range
    # K1, the single-car launch
    args, gathered, kw, gkw = inputs["raycast_walls"]
    rays, r, s = args[:4], args[0].shape[-1], args[4].shape[-1]
    res = torch.empty_like(args[0])
    k1 = lambda segs, c, rid: lambda: _cuda.launch_raycast_walls(  # noqa: E731
        *rays, *segs, c, res, NUM_ENVS, r, s, max_dist, row_ids=rid)
    plain = functools.partial(geo.raycast_walls_plain, *args, **kw, row_ids=ids)
    b = bound_ms(nbytes(*rays, ids, res) + rows("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c"),
                 NUM_ENVS * r * s * K1_OPS_PER_PAIR)
    out["raycast_walls"] = (k1(args[4:8], kw["seg_c"], ids), k1(gathered[4:8], gkw["seg_c"], None),
                            plain, b)
    # the self-play sensing
    args, gathered, _, _ = inputs["raycast_walls_and_cars"]
    x, y, ang, rel = args[:4]
    hl, hw = np.float32(args[9]), np.float32(args[10])
    res2 = torch.empty(x.shape + rel.shape, dtype=torch.float32, device=dev)
    sense = lambda segs, rid: lambda: _cuda.launch_raycast_walls_and_cars(  # noqa: E731
        x, y, ang, rel, *segs, res2, NUM_ENVS, NUM_AGENTS, rel.shape[0], segs[0].shape[-1], hl,
        hw, max_dist, row_ids=rid)
    cdx, cdy = x[:, None, :] - x[:, :, None], y[:, None, :] - y[:, :, None]
    seen = int((torch.sqrt(cdx * cdx + cdy * cdy) >= 0.5).sum()) * rel.shape[0]
    ops = (res2.numel() * s * K1_OPS_PER_PAIR + res2.numel() * NUM_AGENTS * K3_OPS_PER_RAY_CAR
           + seen * 4 * K3_OPS_PER_RAY_EDGE)
    b = bound_ms(nbytes(x, y, ang, rel, ids, res2)
                 + rows("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c"), ops)
    out["raycast_walls_and_cars"] = (
        sense(args[4:9], ids), sense(gathered[4:9], None),
        functools.partial(geo.raycast_walls_and_cars_plain, *args, row_ids=ids), b)
    # the transition with the pair test, as the multi-car env calls it
    args, gathered, kw, _ = inputs["car_step_and_query"]
    cars, wp, gwp = args[:8], args[10:14], gathered[10:14]
    w = wp[0].shape[-1]
    per_env = [t.reshape(NUM_ENVS).contiguous() for t in args[14:16]]
    outs = [torch.empty_like(cars[0]) for _ in range(5)] + [
        torch.empty(cars[0].shape + (4,), device=dev) for _ in range(2)] + [
        torch.empty_like(cars[0]), torch.empty(cars[0].shape, dtype=torch.bool, device=dev),
        torch.empty(cars[0].shape, dtype=torch.int32, device=dev)]
    consts = transition_constants(mcfg)
    step = lambda rows_, rid: lambda: _cuda.launch_car_step_and_query(  # noqa: E731
        *cars, *rows_, *per_env, *outs[:9], NUM_ENVS, NUM_AGENTS, w, consts, outs[9],
        np.float32(mcfg.collision_speed_scale), row_ids=rid)
    n = cars[0].numel()
    b = bound_ms(nbytes(*cars, ids, *per_env, *outs) + rows("wp_x", "wp_y") + 8 * n * 4,
                 n * (5 * w * K2_OPS_PER_PAIR + K5_OPS_PER_CAR)
                 + NUM_ENVS * NUM_AGENTS * NUM_AGENTS * 4 * K4_OPS_PER_PAIR_AXIS)
    out["car_step_and_query"] = (step(wp, ids), step(gwp, None),
                                 functools.partial(dynamics.car_step_and_query_plain, *args,
                                                   **kw, row_ids=ids), b)
    numbers = {}
    for name, (with_ids, on_gathered, plain, (b_ms, b_by)) in out.items():
        numbers[name] = {"ms": per_launch_ms(with_ids), "graph_ms": graph_ms(with_ids),
                         "gathered_graph_ms": graph_ms(on_gathered),
                         "plain_ms": per_launch_ms(plain, windows=3, launches=2),
                         "bound_ms": b_ms, "bound_by": b_by, "distinct_rows": distinct}
    # the transition as the env step runs it, right after the sensing: its time in
    # a graph of (sensing, transition) pairs less the sensing's own; on the
    # gathered rows the sensing's 73 MB evict the transition's rows from the L2
    sense, step = out["raycast_walls_and_cars"], out["car_step_and_query"]
    for key, k, base in (("after_sensing_graph_ms", 0, "graph_ms"),
                         ("gathered_after_sensing_graph_ms", 1, "gathered_graph_ms")):
        def pair(a=sense[k], b=step[k]):
            a()
            b()
        numbers["car_step_and_query"][key] = (
            graph_ms(pair) - numbers["raycast_walls_and_cars"][base])
    return numbers


def check_row_ids(canonical, procgen, cfg, mcfg, rng, dev):
    """Phase (b): the three kernels with row ids on the canonical pool (W 512, S 896)
    and the procgen pool (W 384, S 768), tiled, grouped and by arbitrary ids, each
    bitwise the kernel on the gathered rows and its plain version; timed on the
    tiled layouts beside the gathered rows. Returns the kernels-line entries."""
    timed = {}
    errs = {}
    for label, pool in (("canonical", canonical), ("procgen", procgen)):
        shape = f"W {pool.wp_x.shape[-1]}, S {pool.seg_sx.shape[-1]}"
        for kind, layout in row_id_layouts(pool, rng).items():
            inputs, e = hold_row_ids(layout, cfg, mcfg, rng, dev, f"{label} {kind}")
            for k, v in e.items():
                errs[k] = max(errs.get(k, 0.0), v)
            print(f"row ids, {label} pool ({shape}) {kind} over {NUM_ENVS} envs "
                  f"({int(torch.unique(layout.ids).numel())} distinct rows): K1, "
                  f"raycast_walls_and_cars, car_step_and_query (pair test and single-car) "
                  f"bitwise the kernels on the gathered rows and their plain versions "
                  f"(raycasts by K1's rule)")
            if kind == "tiled":
                timed[label] = time_row_ids(layout, inputs, mcfg, dev)
        step = timed[label]["car_step_and_query"]
        print(f"car_step_and_query right after the sensing, {label} tiled ({shape}), in a CUDA "
              f"graph of the pair less the sensing: {step['after_sensing_graph_ms'] * 1e3:.1f} us "
              f"by row id, {step['gathered_after_sensing_graph_ms'] * 1e3:.1f} us on the gathered "
              f"rows")
        for name, t in timed[label].items():
            print(f"{name} with row ids, {label} tiled ({shape}): {t['graph_ms'] * 1e3:.1f} us in "
                  f"a CUDA graph against {t['gathered_graph_ms'] * 1e3:.1f} us on the gathered "
                  f"rows; {t['ms'] * 1e3:.1f} us eager; bound {t['bound_ms'] * 1e3:.2f} us "
                  f"({t['bound_by']}, {t['distinct_rows']} distinct rows read once); plain "
                  f"{t['plain_ms'] * 1e3:.1f} us")
    sources = {"raycast_walls": ("raycast_walls.cu", "self_play_racing_tpu/ops/geometry.py:26"),
               "raycast_walls_and_cars": ("raycast_walls_and_cars.cu",
                                          "self_play_racing_tpu/ops/geometry.py:243"),
               "car_step_and_query": ("car_step_and_query.cu",
                                      "self_play_racing_tpu/ops/dynamics.py:37")}
    entries = []
    for name, (src, replaces) in sources.items():
        c, p = timed["canonical"][name], timed["procgen"][name]
        entries.append({
            "name": f"{name}_row_ids", "route": "cuda",
            "source": f"self_play_racing_tpu_torch/csrc/{src}", "replaces": replaces,
            "also_replaces": "self_play_racing_tpu/envs/track.py:351",
            "max_abs_err": errs[name], "ms": c["ms"], "graph_ms": c["graph_ms"],
            "gathered_graph_ms": c["gathered_graph_ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": None,
            "procgen_ms": p["ms"], "procgen_graph_ms": p["graph_ms"],
            "procgen_gathered_graph_ms": p["gathered_graph_ms"],
            "procgen_bound_ms": p["bound_ms"], "procgen_plain_ms": p["plain_ms"],
            **{k: c[k] for k in ("after_sensing_graph_ms", "gathered_after_sensing_graph_ms")
               if k in c}})
    return entries


COUNTERS = {
    "raycast_walls": (geo, "raycast_walls_launches"),
    "progress_and_collision": (geo, "progress_and_collision_launches"),
    "raycast_cars": (geo, "raycast_cars_launches"),
    "rectangles_intersect": (geo, "rectangles_intersect_launches"),
    "car_update": (dynamics, "car_update_launches"),
    "raycast_walls_and_cars": (geo, "raycast_walls_and_cars_launches"),
    "car_step_and_query": (dynamics, "car_step_and_query_launches"),
    "raycast_walls_row_ids": (geo, "raycast_walls_row_id_launches"),
    "raycast_walls_and_cars_row_ids": (geo, "raycast_walls_and_cars_row_id_launches"),
    "car_step_and_query_row_ids": (dynamics, "car_step_and_query_row_id_launches"),
    "multi_observe": (menv, "observe_launches"),
    "multi_transition": (menv, "transition_launches"),
    "multi_observe_row_ids": (menv, "observe_row_id_launches"),
    "multi_transition_row_ids": (menv, "transition_row_id_launches"),
    "multi_observe_small": (menv, "observe_small_launches"),
    "multi_transition_small": (menv, "transition_small_launches"),
    "single_observe": (senv, "observe_launches"),
    "single_transition": (senv, "transition_launches"),
    "single_observe_row_ids": (senv, "observe_row_id_launches"),
    "single_transition_row_ids": (senv, "transition_row_id_launches"),
    "single_transition_rows": (senv, "transition_rows_launches"),
    "multi_transition_autoreset": (menv, "transition_autoreset_launches"),
    "multi_transition_small_autoreset": (menv, "transition_autoreset_small_launches"),
    "single_transition_autoreset": (senv, "transition_autoreset_launches"),
    "single_transition_rows_autoreset": (senv, "transition_autoreset_rows_launches"),
    "compute_gae": (gae, "compute_gae_launches"),
    "mixbits_permutation": (prng, "mixbits_permutation_launches"),
    "ppo_head": (mbops, "ppo_head_launches"),
    "ppo_head_backward": (mbops, "ppo_head_backward_launches"),
    "adam_tail": (mbops, "adam_tail_launches"),
    "advantage_moments": (mbops, "advantage_moments_launches"),
    "mlp_forward": (mlpops, "mlp_forward_launches"),
    "mlp_backward": (mlpops, "mlp_backward_launches"),
    "mlp_grad_reduce": (mlpops, "mlp_grad_reduce_launches"),
    "mlp_grad_norm": (mlpops, "mlp_grad_norm_launches"),
    "policy_act": (polops, "policy_act_launches"),
    "pool_act": (polops, "pool_act_launches"),
}
# the learner's kernels: one launch of each a minibatch_step; and the advantages'
# moments, one launch an update
LEARNER = ("ppo_head", "ppo_head_backward", "adam_tail")
MOMENTS = "advantage_moments"
# the MLP kernels: one launch of each a minibatch_step on whole towers, none on a
# tensor-parallel rank (its slices run the Megatron composition); with a group also
# the reduce's norm-only mode once a minibatch_step (ppo.norm_route)
TOWERS = ("mlp_forward", "mlp_backward", "mlp_grad_reduce")


def policy(steps: int, selfplay: bool = False, towers: bool = True) -> dict:
    """The rollout policy's expected launches in ``steps`` rollout steps: kernel A
    (``policy_act``) once a step where the towers are whole (none on a
    tensor-parallel rank, whose slices keep the composition), kernel B
    (``pool_act``) once a self-play step (the pool is whole on every rank)."""
    return {"policy_act": steps if towers else 0, "pool_act": steps if selfplay else 0}


def zero_counts():
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read_counts():
    return {name: getattr(module, attr) for name, (module, attr) in COUNTERS.items()}


def per_kernel(launches):
    """``launches`` (read_counts) by kernel: the env steps' ``multi_observe``,
    ``multi_transition`` and ``single_transition`` counters count every launch of the
    three functions, of which ``*_small`` counts the first kernels' and
    ``single_transition_rows`` that of several rows a block; here the other kernels'
    alone; the same for the transitions' autoreset mode (``*_autoreset``, the
    launches of the vector step's fused route, also counted without the suffix)."""
    out = dict(launches)
    for name in ("multi_observe", "multi_transition"):
        out[name] -= out[f"{name}_small"]
    out["multi_transition_autoreset"] -= out["multi_transition_small_autoreset"]
    out["single_transition"] -= out["single_transition_rows"]
    out["single_transition_autoreset"] -= out["single_transition_rows_autoreset"]
    return out


def counts(envs=None, tiled=False, autoreset=False, **nonzero):
    """The expected counts: those given, every other kernel 0; on a multi-car path
    of ``envs`` env rows also its env-step launches by the first kernels, under
    ``ops/_cuda.py``'s OBSERVE_SMALL_BELOW and TRANSITION_SMALL_BELOW rows, and on a
    single-car path on the tiled layout (``tiled``) its transition's by the kernel of
    several rows a block, from SINGLE_TRANSITION_ROWS_FROM rows. On a path whose
    vector steps take the fused route (``autoreset``: every rollout) every transition
    launch is also the autoreset mode's."""
    out = {name: nonzero.get(name, 0) for name in COUNTERS}
    if envs is not None and envs < _cuda.OBSERVE_SMALL_BELOW:
        out["multi_observe_small"] = out["multi_observe"]
    if envs is not None and envs < _cuda.TRANSITION_SMALL_BELOW:
        out["multi_transition_small"] = out["multi_transition"]
    if tiled and envs >= _cuda.SINGLE_TRANSITION_ROWS_FROM:
        out["single_transition_rows"] = out["single_transition"]
    if autoreset:
        for name in ("multi_transition", "multi_transition_small", "single_transition",
                     "single_transition_rows"):
            out[f"{name}_autoreset"] = out[name]
    return out


def first_minibatches_exact(first: list, what: str) -> None:
    """Every update's first minibatch recomputes the rollout's log-probs from the
    same parameters: the rollout's policy kernel and the minibatch step's MLP and
    loss-head kernels share their device code (``csrc/mlp_tower.cuh``,
    ``csrc/normal_lp.cuh``), so its approx_kl and clip_frac are exactly 0."""
    if not first or any(kl != 0.0 or clip != 0.0 for kl, clip in first):
        raise AssertionError(f"{what}: the first minibatches' (approx_kl, clip_frac) "
                             f"{first}, expected exactly 0 each")
    print(f"{what}: approx_kl and clip_frac exactly 0 at the first minibatch of each of "
          f"{len(first)} updates")


def learner(launches, cfg, updates: int, computed=None, towers: bool = True,
            group: bool = False) -> dict:
    """The learner kernels' expected launches in ``updates`` updates: one of each a
    ``minibatch_step`` call (with ``towers``, the whole-tower paths, the MLP kernels'
    too, and with a ``group`` also the reduce's norm-only mode; a tensor-parallel rank
    launches none of them), and the loop runs every epoch up to the KL exit's whole
    (the exit's rest masked); the advantages' moments once an update. With
    ``computed`` (the minibatches each update computed) exactly that; without, the
    count ``launches`` holds, once it is the same for every one of them and whole
    epochs, at least one and at most ``cfg.update_epochs`` an update."""
    kernels = LEARNER + (TOWERS + (("mlp_grad_norm",) if group else ()) if towers else ())
    m = cfg.num_minibatches
    if computed is not None:
        return {**dict.fromkeys(kernels, sum(-(-c // m) * m for c in computed)),
                MOMENTS: updates}
    n = launches["adam_tail"]
    if (any(launches[k] != n for k in kernels) or n % m
            or not updates * m <= n <= updates * cfg.update_epochs * m):
        raise AssertionError(f"learner kernels {[launches[k] for k in kernels]} launches in "
                             f"{updates} updates of {cfg.update_epochs} x {m} minibatches")
    return {**dict.fromkeys(kernels, n), MOMENTS: updates}


def rollout(params, log_std, cfg, track, vstate, obs, gen, steps):
    """The bench loop: sample_action + vector.step with NEXT_STEP autoreset, through
    the single-car hooks' step (the transition kernel's autoreset mode).
    Returns the final (vstate, obs), a device flag that every obs and reward was
    finite, and the device count of episodes that ended."""
    finite = torch.ones((), dtype=torch.bool, device=obs.device)
    ended = torch.zeros((), dtype=torch.int64, device=obs.device)
    hooks = make_single_env_hooks(cfg)
    for _ in range(steps):
        noise = net.sample_noise((obs.shape[0], cfg.action_dim), gen, device=obs.device)
        action, _, _ = net.sample_action(params, log_std, obs, noise)
        vstate, obs, reward, done, *_ = vector.step(
            vstate, action, lambda s, a, g, p, st: hooks.step(track, s, a, g, p, st, None),
            lambda s: hooks.observe(track, s))
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
        ended += done.sum()
    return vstate, obs, finite, ended


@torch.no_grad()
def main_path(track, cfg, dev, card, label=""):
    """The single-car rollout on ``track`` (per-env rows, or a layout whose kernels
    read pool rows by id). Returns the launch counts and the final observations."""
    model, _ = interop.load_npz(MODEL, device=dev)
    params, log_std = model.params(), model.log_std
    gen = torch.Generator(device=dev).manual_seed(0)

    # warm-up on its own state: cuBLAS handles, allocator
    state, obs = senv.reset(cfg, track)
    rollout(params, log_std, cfg, track, vector.init(state, NUM_ENVS), obs, gen, 8)
    torch.cuda.synchronize()

    zero_counts()
    t0 = time.perf_counter()
    state, obs = senv.reset(cfg, track)
    vstate, obs, finite, ended = rollout(params, log_std, cfg, track,
                                         vector.init(state, NUM_ENVS), obs, gen, STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    expected = counts(NUM_ENVS, tiled=isinstance(track, trk.TiledPooledTracks), autoreset=True,
                      single_observe=STEPS + 1, single_transition=STEPS, **policy(STEPS))
    if isinstance(track, trk.LAYOUTS):
        expected.update(single_observe_row_ids=STEPS + 1, single_transition_row_ids=STEPS)
    what = f"main path{label}"
    print(f"{what}: {NUM_ENVS} envs x {STEPS} steps in {dt:.3f} s = "
          f"{NUM_ENVS * STEPS / dt:,.0f} env-steps/s on {card}; launches {launches}")
    if launches != expected:
        raise AssertionError(f"{what} launches {launches}, expected {expected}")
    if not bool(finite) or obs.shape != (NUM_ENVS, cfg.obs_dim):
        raise AssertionError(f"{what}: non-finite obs or reward, or wrong obs shape")
    print(f"{what}: obs {tuple(obs.shape)} and rewards finite; {int(ended)} episodes "
          f"ended in the run")
    return launches, obs


@contextlib.contextmanager
def minibatch_loops(updates: int, around=contextlib.nullcontext, first=None):
    """Times the minibatch loop of each update run inside the block, so that an
    update's wall time splits into its rollout, GAE and permutations (before the
    loop) and the loop. Yields a list that gains ``(seconds, computed
    minibatches)`` per update; each loop runs inside ``around()``; ``first`` (a
    list) gains each update's first minibatch's (approx_kl, clip_frac). The loop is
    ``ppo.run_ppo_update``, which ``update_step`` calls through its module, so it
    is swapped there for the block; the block fails unless exactly ``updates``
    loops were timed."""
    run_update = ppo.run_ppo_update
    loops = []

    def timed(*args, **kwargs):
        with around():
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = run_update(*args, **kwargs)
            torch.cuda.synchronize()
        loops.append((time.perf_counter() - t, int(out[2]["computed"].sum())))
        if first is not None:
            first.append((float(out[2]["approx_kl"][0, 0]), float(out[2]["clip_frac"][0, 0])))
        return out

    ppo.run_ppo_update = timed
    try:
        yield loops
    finally:
        ppo.run_ppo_update = run_update
    if len(loops) != updates:
        raise AssertionError(f"timed {len(loops)} minibatch loops, expected {updates}")


def training(track, env_cfg, card):
    """The single-car trainer at the bench width."""
    cfg = base_config(num_envs=NUM_ENVS, num_steps=STEPS,
                      total_timesteps=NUM_ENVS * STEPS * 100)
    t0 = time.perf_counter()
    trainer = PPOTrainer(cfg, env_cfg, track)
    metrics = []
    trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
    torch.cuda.synchronize()
    print(f"train: trainer built and warm-up update in {time.perf_counter() - t0:.1f} s "
          f"({metrics[0]['minibatches_applied']:.0f} minibatches applied)")
    before = [p.detach().clone() for p in trainer.runner.train.model.parameters()]
    zero_counts()
    wall = []
    with minibatch_loops(TRAIN_UPDATES) as loops:
        for _ in range(TRAIN_UPDATES):
            t = time.perf_counter()
            trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
    launches = read_counts()
    for i, (dt, (up, computed), m) in enumerate(zip(wall, loops, metrics[1:])):
        epochs = -(-computed // cfg.num_minibatches)
        print(f"train update {i + 1}: {dt * 1e3:.1f} ms = {cfg.batch_size / dt:,.0f} env-steps/s; "
              f"rollout + GAE + permutations {(dt - up) * 1e3:.1f} ms, minibatch loop "
              f"{up * 1e3:.1f} ms; minibatches_applied {m['minibatches_applied']:.0f}, "
              f"kl_stopped {m['kl_stopped']:.0f}, approx_kl {m['approx_kl']:.5f}, "
              f"host reads of the exit flag {min(epochs, cfg.update_epochs - 1)}; "
              f"pg_loss {m['pg_loss']:.5f} v_loss {m['v_loss']:.3f} "
              f"episodes {m['episodes']:.0f} mean_ep_return {m['mean_ep_return']:.2f}")
    print(f"train: median {statistics.median(wall) * 1e3:.1f} ms/update at {NUM_ENVS} x {STEPS} "
          f"on {card}; launches {launches}")
    n = STEPS * TRAIN_UPDATES
    expected = counts(autoreset=True, single_observe=n, single_transition=n, **policy(n),
                      compute_gae=TRAIN_UPDATES, mixbits_permutation=TRAIN_UPDATES,
                      **learner(launches, cfg, TRAIN_UPDATES, [c for _, c in loops]))
    if launches != expected:
        raise AssertionError(f"training launches {launches}, expected {expected}")
    for m in metrics:
        if not all(np.isfinite(m[k]) for k in ("pg_loss", "v_loss", "mean_reward", "approx_kl")):
            raise AssertionError(f"training: non-finite metrics {m}")
    after = list(trainer.runner.train.model.parameters())
    if all(torch.equal(a, b) for a, b in zip(after, before)):
        raise AssertionError("training: the timed updates left every parameter unchanged")


def entry_point(card):
    """``train single`` at its defaults for two updates, in a temporary directory."""
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_counts()
            t0 = time.perf_counter()
            trainer = ttrain.main(["single", "--num-updates", "2"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_counts()
            params, log_std, _ = load_policy_bundle("models/single_agent.npz")
        finally:
            os.chdir(cwd)
    cfg = trainer.cfg
    print(f"train single: {cfg.num_envs} envs x {cfg.num_steps} steps, 2 updates in "
          f"{dt:.1f} s on {card}; launches {launches}; saved policy loads "
          f"({len(params['actor'])} layers per tower, log_std {log_std.tolist()})")
    steps = 2 * cfg.num_steps
    expected = counts(cfg.num_envs, autoreset=True, single_observe=steps + 1,
                      single_transition=steps,
                      compute_gae=2, mixbits_permutation=2, **learner(launches, cfg, 2),
                      **policy(steps))
    if launches != expected:
        raise AssertionError(f"train single launches {launches}, expected {expected}")


def memory_window():
    """Frees what the card's allocator caches and starts a peak-memory window;
    returns the bytes allocated at its start."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def selfplay_training(make_track, card, label=""):
    """Scale-mode self-play at its full width on the geometry ``make_track()``
    builds (inside the peak-memory window). Returns the launch counts of the timed
    updates, each update's seeded numbers as printed, and the peak memory the run
    allocated over what was allocated before it."""
    cfg = self_play_config(num_envs=NUM_ENVS, num_steps=STEPS,
                           total_timesteps=1_000_000_000, opponent_per_env=True,
                           reset_envs_each_update=False, snapshot_freq=1)
    what = f"self-play{label}"
    print(f"{what}: train scale's config with snapshot_freq overridden "
          f"{self_play_config().snapshot_freq} -> 1 (pool opponents from the second update)")
    base = memory_window()
    t0 = time.perf_counter()
    track = make_track()
    trainer = SelfPlayTrainer(cfg, menv.MultiRacingConfig(num_agents=NUM_AGENTS,
                                                          num_sensors=11), track)
    metrics = []
    trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
    torch.cuda.synchronize()
    print(f"{what}: trainer built and warm-up update in {time.perf_counter() - t0:.1f} s")
    zero_counts()
    wall, pools, first = [], [], []
    with minibatch_loops(SP_TRAIN_UPDATES, first=first) as loops:
        for _ in range(SP_TRAIN_UPDATES):
            t = time.perf_counter()
            trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
            torch.cuda.synchronize()
            wall.append(time.perf_counter() - t)
            pools.append(trainer.pool_count)
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() - base
    info = trainer.training_info
    seeded = []
    for i, (dt, (up, _), m, pool) in enumerate(zip(wall, loops, metrics[1:], pools)):
        games = m["_extra"][cfg.pool_size:].sum()
        wins = m["_extra"][:cfg.pool_size].sum()
        seeded.append(f"minibatches_applied {m['minibatches_applied']:.0f}, approx_kl "
                      f"{m['approx_kl']:.5f}, mean_ep_return {m['mean_ep_return']:.2f} over "
                      f"{m['episodes']:.0f} episodes; pool {pool}, learner won {wins:.0f} of "
                      f"{games:.0f} races against the pool")
        print(f"{what} update {i + 1}: {dt * 1e3:.1f} ms = {cfg.batch_size / dt:,.0f} "
              f"env-steps/s; rollout + GAE + permutations {(dt - up) * 1e3:.1f} ms, "
              f"minibatch loop {up * 1e3:.1f} ms; {seeded[-1]}")
    print(f"{what}: median {statistics.median(wall) * 1e3:.1f} ms/update at {NUM_ENVS} x "
          f"{STEPS} x {NUM_AGENTS} cars on {card}; pool win rate history "
          f"{info['pool_win_rate']}; launches {launches}; peak memory "
          f"{peak / 2**20:,.1f} MiB over the {base / 2**20:,.1f} MiB allocated before "
          f"(torch.cuda.max_memory_allocated {(peak + base) / 2**20:,.1f} MiB)")
    n = STEPS * SP_TRAIN_UPDATES
    expected = counts(cfg.num_envs, autoreset=True, multi_observe=n, multi_transition=n,
                      **policy(n, selfplay=True),
                      compute_gae=SP_TRAIN_UPDATES, mixbits_permutation=SP_TRAIN_UPDATES,
                      **learner(launches, cfg, SP_TRAIN_UPDATES, [c for _, c in loops]))
    if isinstance(track, trk.LAYOUTS):
        expected.update(multi_observe_row_ids=n, multi_transition_row_ids=n)
    if launches != expected:
        raise AssertionError(f"{what} launches {launches}, expected {expected}")
    for m in metrics:
        if not all(np.isfinite(m[k]) for k in ("pg_loss", "v_loss", "mean_reward", "approx_kl")):
            raise AssertionError(f"{what}: non-finite metrics {m}")
    if pools != [1, 2, 3] or sum(m["_extra"][cfg.pool_size:].sum() for m in metrics[1:]) == 0:
        raise AssertionError(f"{what}: pool counts {pools} or no race against the pool")
    first_minibatches_exact(first, what)
    return launches, seeded, peak


def file_digests():
    digests = {}
    for path in TRACKED:
        if os.path.exists(path):
            with open(path, "rb") as f:
                digests[path] = hashlib.sha256(f.read()).hexdigest()
    return digests


def selfplay_entry_points(card):
    """``train scale`` and ``train multi`` at their defaults, two updates each, in
    temporary directories; the repo's tracked files must not change. Returns each
    run's launch counts by mode."""
    before = file_digests()
    cwd = os.getcwd()
    runs = {"scale": "models/self_play_agent_scale_1B.npz",
            "multi": "models/self_play_agent.npz"}
    by_mode = {}
    for mode, out in runs.items():
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            try:
                zero_counts()
                t0 = time.perf_counter()
                trainer = ttrain.main([mode, "--num-updates", "2"])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                launches = read_counts()
                params, log_std, _ = load_policy_bundle(out)
            finally:
                os.chdir(cwd)
        cfg = trainer.cfg
        steps = 2 * cfg.num_steps
        # sensing: every step, the construction's reset, and train multi's forced
        # reset before each update
        sensed = steps + 1 + (2 if cfg.reset_envs_each_update else 0)
        expected = counts(cfg.num_envs, autoreset=True, multi_observe=sensed,
                          multi_transition=steps,
                          compute_gae=2, mixbits_permutation=2, **learner(launches, cfg, 2),
                          **policy(steps, selfplay=True))
        print(f"train {mode}: {cfg.num_envs} envs x {cfg.num_steps} steps x 2 cars, 2 updates "
              f"in {dt:.1f} s on {card}; launches {launches}; saved policy loads "
              f"({params['actor'][0][0].shape[0]} inputs, log_std {log_std.tolist()})")
        if launches != expected:
            raise AssertionError(f"train {mode} launches {launches}, expected {expected}")
        by_mode[mode] = launches
    if file_digests() != before:
        raise AssertionError("the self-play entry points wrote the repo's tracked files")
    print(f"train scale/multi left the repo's tracked files untouched ({len(before)} checked)")
    return by_mode


def checkpoints(track, dev):
    """A checkpoint at update 2 resumed into a fresh trainer on the card, and the
    repo's v0 and reference checkpoints loaded onto it."""
    envs = 256
    cfg = self_play_config(num_envs=envs, num_steps=32, total_timesteps=envs * 32 * 10,
                           snapshot_freq=1, opponent_per_env=True,
                           reset_envs_each_update=False)
    env_cfg = menv.MultiRacingConfig(num_agents=NUM_AGENTS, num_sensors=11)
    sub = trk.gather_tracks(track, np.arange(envs))
    with tempfile.TemporaryDirectory() as tmp:
        a = SelfPlayTrainer(cfg, env_cfg, sub)
        a.train(num_updates=2, checkpoint_dir=tmp, checkpoint_every=2)
        b = SelfPlayTrainer(cfg, env_cfg, sub)
        b.load_checkpoint(os.path.join(tmp, "checkpoint_update_2"))
    same = lambda xs, ys: all(torch.equal(x, y) for x, y in zip(xs, ys))
    pool = lambda tr: [t for layers in tr.pool["params"].values() for layer in layers
                       for t in layer] + [tr.pool["log_std"]]
    ta, tb = a.runner.train, b.runner.train
    if not (same(ta.model.parameters(), tb.model.parameters())
            and same(ta.opt_state.mu, tb.opt_state.mu) and same(ta.opt_state.nu, tb.opt_state.nu)
            and ta.opt_state.count == tb.opt_state.count and ta.update == tb.update == 2
            and same(pool(a), pool(b)) and a.num_snapshots == b.num_snapshots == 1
            and (a.pool_wins == b.pool_wins).all() and (a.pool_games == b.pool_games).all()):
        raise AssertionError("checkpoint: the resumed trainer differs from the saved one")
    print(f"checkpoint at update 2 resumed on {dev}: parameters, Adam state (count "
          f"{tb.opt_state.count}), pool ({b.pool_count}) and counters equal")
    ref = SelfPlayTrainer(self_play_config(), env_cfg, trk.gather_tracks(track, np.arange(16)))
    if os.path.exists(V0_CHECKPOINT):
        ref.load_checkpoint(V0_CHECKPOINT)
        print(f"v0 {V0_CHECKPOINT}: update {ref.runner.train.update}, pool {ref.pool_count}")
        if (ref.runner.train.update, ref.pool_count) != (90, 5):
            raise AssertionError("v0 checkpoint: expected update 90 and a pool of 5")
    else:
        print(f"v0 {V0_CHECKPOINT}: not in this checkout; its load is held to the JAX "
              f"package's in the CPU tests (tests/test_torch_selfplay_checkpoint.py)")
    ref.load_torch_checkpoint(TORCH_CHECKPOINT)
    print(f"reference {TORCH_CHECKPOINT}: resumes at update {ref.runner.train.update}, "
          f"pool {ref.pool_count}")
    if (ref.runner.train.update, ref.pool_count) != (91, 5):
        raise AssertionError("reference checkpoint: expected update 91 and a pool of 5")
    ref.train(num_updates=1)  # and trains on from it
    if not all(bool(torch.isfinite(p).all()) for p in ref.runner.train.model.parameters()):
        raise AssertionError("reference checkpoint: training on from it gave non-finite weights")


def evaluation(dev):
    """``evaluate.eval()`` on the 40 x 5 grid (sampled, seed 42) with both policies,
    writing its results into a temporary directory and drawing no chart."""
    t0 = time.perf_counter()
    models = {"single": ("single", MODEL), "self_play": ("multi", MULTI_MODEL)}
    with tempfile.TemporaryDirectory() as tmp:
        by_label = evaluate.eval(models, 40, 5, 42, out_dir=tmp, chart=None, device=dev)
        written = {}
        for label in models:
            with open(os.path.join(tmp, f"eval_info_{label}.json")) as f:
                written[label] = json.load(f)
        files = sorted(os.listdir(tmp))
    dt = time.perf_counter() - t0
    if files != ["eval_info_self_play.json", "eval_info_single.json"]:
        raise AssertionError(f"eval wrote {files}")
    for label, what in (("single", "eval"), ("self_play", f"eval --multi {MULTI_MODEL}")):
        res = written[label]
        if res != json.loads(json.dumps(by_label[label]["results"])) or \
                len(res["all_episodes"]) != 200:
            raise AssertionError(f"eval_info_{label}.json differs from eval()'s results")
        print(f"{what} 40 x 5{', 2 cars' if label == 'self_play' else ''} (sampled, seed 42): "
              f"success_rate={res['success_rate']:.3f} crash_rate={res['crash_rate']:.3f} "
              f"avg_steps={res['avg_steps']:.2f} avg_speed={res['avg_speed']:.3f}")
        if res["success_rate"] < SUCCESS_FLOOR:
            raise AssertionError(f"{what} success_rate {res['success_rate']} < {SUCCESS_FLOOR}")
    print(f"eval(): eval_info_single.json and eval_info_self_play.json written with 200 "
          f"episodes each ({dt:.1f} s)")


def gathered_row_bytes(pool, num_envs: int) -> int:
    """The bytes of the [W] and [S] rows a gathered layout of ``pool`` over
    ``num_envs`` envs holds (4 waypoint and 5 segment fields of float32)."""
    return num_envs * 4 * (4 * pool.wp_x.shape[-1] + 5 * pool.seg_sx.shape[-1])


def pool_digest(pool) -> str:
    return hashlib.sha256(b"".join(getattr(pool, f.name).cpu().numpy().tobytes()
                                   for f in dataclasses.fields(pool))).hexdigest()[:16]


def resampled_entry_points(card):
    """Phase (d): ``train scale --resample-tracks-every 1 --pooled-geometry tiled``
    and ``grouped`` at their defaults for two updates each in temporary
    directories: each update's procgen pool (recorded by its digest) differs, the
    envs run on the last one through the row-id kernels, the written policy loads
    and the repo's tracked files stay untouched."""
    before = file_digests()
    cwd = os.getcwd()
    drawn = []
    procgen_pool = ttrain.procgen_pool

    def recorded(seed, boundary, *args, **kwargs):
        pool = procgen_pool(seed, boundary, *args, **kwargs)
        drawn.append((boundary, pool_digest(pool)))
        return pool

    ttrain.procgen_pool = recorded
    try:
        for layout, kind in (("tiled", trk.TiledPooledTracks),
                             ("grouped", trk.GroupedPooledTracks)):
            drawn.clear()
            with tempfile.TemporaryDirectory() as tmp:
                os.chdir(tmp)
                try:
                    zero_counts()
                    t0 = time.perf_counter()
                    trainer = ttrain.main(["scale", "--resample-tracks-every", "1",
                                           "--pooled-geometry", layout, "--num-updates", "2"])
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                    launches = read_counts()
                    params, _, _ = load_policy_bundle("models/self_play_agent_scale_1B.npz")
                finally:
                    os.chdir(cwd)
            cfg, track = trainer.cfg, trainer.aux["track"]
            steps = 2 * cfg.num_steps
            # sensing: every step, the construction's reset and the reset onto the
            # pool of update 1
            expected = counts(cfg.num_envs, autoreset=True, multi_observe=steps + 2,
                              multi_transition=steps,
                              multi_observe_row_ids=steps + 2,
                              multi_transition_row_ids=steps, compute_gae=2,
                              mixbits_permutation=2, **learner(launches, cfg, 2),
                              **policy(steps, selfplay=True))
            print(f"train scale --resample-tracks-every 1 --pooled-geometry {layout}: "
                  f"{cfg.num_envs} envs x {cfg.num_steps} steps, 2 updates in {dt:.1f} s on "
                  f"{card}; pools by update {drawn}; the envs' geometry {type(track).__name__} "
                  f"over {track.pool.num_tracks} tracks (W {track.pool.wp_x.shape[-1]}, S "
                  f"{track.pool.seg_sx.shape[-1]}); launches {launches}; saved policy loads "
                  f"({params['actor'][0][0].shape[0]} inputs)")
            if [b for b, _ in drawn] != [0, 1] or drawn[0][1] == drawn[1][1]:
                raise AssertionError(f"train scale {layout}: pools {drawn}, expected two that differ")
            if not isinstance(track, kind) or pool_digest(track.pool) != drawn[-1][1]:
                raise AssertionError(f"train scale {layout}: the envs are not on update 1's pool")
            if launches != expected:
                raise AssertionError(f"train scale {layout} launches {launches}, expected {expected}")
    finally:
        ttrain.procgen_pool = procgen_pool
    if file_digests() != before:
        raise AssertionError("the resampled entry points wrote the repo's tracked files")
    print(f"train scale with resampled pools left the repo's tracked files untouched "
          f"({len(before)} checked)")


def procgen_evaluation(dev):
    """Phase (e): what ``evaluate --multi <the domain-randomized agent> --procgen``
    runs, into a temporary directory without the chart (``eval()``, then
    ``procgen_transfer``): the 40 x 5 grid, then 40 unseen procedural tracks built
    on the card; success rate on those >= PROCGEN_FLOOR."""
    with open("data/procgen_generalization.json") as f:
        jax_rate = json.load(f)["dr_500M"]["procgen_unseen"]["success_rate"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        by_label = evaluate.eval({"self_play": ("multi", DR_MODEL)}, 40, 5, 42, out_dir=tmp,
                                 chart=None, device=dev)
        evaluate.procgen_transfer(by_label, [DR_MODEL], num_tracks=40, device=dev)
    dt = time.perf_counter() - t0
    grid, r = by_label["self_play"]["results"], by_label["self_play"]["procgen"]
    print(f"evaluate --multi {DR_MODEL} --procgen ({dt:.1f} s on {dev}): grid 40 x 5 "
          f"success_rate={grid['success_rate']:.3f}; 40 unseen procgen tracks "
          f"success_rate={r['success_rate']:.3f} crash_rate={r['crash_rate']:.3f} "
          f"avg_steps={r['avg_steps']:.2f}; the JAX package recorded {jax_rate:.3f} on its own "
          f"40 unseen tracks (data/procgen_generalization.json, dr_500M): the two draw "
          f"different tracks, as their random streams differ")
    if r["num_episodes"] != 40 or r["success_rate"] < PROCGEN_FLOOR:
        raise AssertionError(f"procgen success_rate {r['success_rate']} < {PROCGEN_FLOOR}")


@torch.no_grad()
def capacity_probe(pool, dev):
    """Phase (f): a 32-step self-play rollout (the trainer's rollout phase) at
    65,536 envs on the canonical pool, tiled and gathered, each in its own
    peak-memory window; the two end in the same observations."""
    env_cfg = menv.MultiRacingConfig(num_agents=NUM_AGENTS, num_sensors=11)
    cfg = self_play_config(num_envs=CAPACITY_ENVS, num_steps=CAPACITY_STEPS,
                           total_timesteps=CAPACITY_ENVS * CAPACITY_STEPS * 10,
                           opponent_per_env=True, reset_envs_each_update=False)
    ids = np.arange(CAPACITY_ENVS) % pool.num_tracks
    final = {}
    for label, make in (("tiled", lambda: trk.tiled_pooled_tracks(pool, CAPACITY_ENVS)),
                        ("gathered", lambda: trk.gather_tracks(pool, ids))):
        base = memory_window()
        track = make()
        geometry = torch.cuda.memory_allocated() - base
        trainer = SelfPlayTrainer(cfg, env_cfg, track)
        noise = net.sample_noise((CAPACITY_STEPS, CAPACITY_ENVS, env_cfg.action_dim),
                                 torch.Generator(device=dev).manual_seed(3), device=dev)
        zero_counts()
        t0 = time.perf_counter()
        _, obs, _, _, traj, stats = ppo.rollout_phase(cfg, trainer.hooks, trainer.runner,
                                                      trainer.aux, trainer.log_std, noise)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        if not (bool(torch.isfinite(obs).all()) and bool(torch.isfinite(stats["reward"]).all())):
            raise AssertionError(f"capacity probe {label}: non-finite observations or rewards")
        row_ids = launches["multi_observe_row_ids"]
        if (launches["multi_observe"], row_ids) != (
                CAPACITY_STEPS, CAPACITY_STEPS if label == "tiled" else 0):
            raise AssertionError(f"capacity probe {label}: launches {launches}")
        print(f"capacity probe, {label}: {CAPACITY_ENVS:,} envs x {CAPACITY_STEPS} steps x "
              f"{NUM_AGENTS} cars in {dt:.2f} s; geometry {geometry / 2**20:,.2f} MiB, peak memory "
              f"{peak / 2**20:,.1f} MiB over the {base / 2**20:,.1f} MiB allocated before "
              f"(torch.cuda.max_memory_allocated {(peak + base) / 2**20:,.1f} MiB); "
              f"sensing launches {CAPACITY_STEPS}, {row_ids} of them by row id")
        final[label] = obs.clone()
        del track, trainer, noise, obs, traj, stats
    if not torch.equal(final["tiled"], final["gathered"]):
        raise AssertionError("capacity probe: the tiled and gathered rollouts end apart")
    pool_bytes = nbytes(*(getattr(pool, f.name) for f in dataclasses.fields(pool)))
    print(f"capacity probe: the tiled and gathered rollouts end in the same observations; "
          f"the gathered rows alone are {gathered_row_bytes(pool, CAPACITY_ENVS) / 1e9:.2f} GB, "
          f"the tiled pool {pool_bytes / 1e3:.1f} KB")


def loop_steps(acc, max_steps: int) -> int:
    """The steps a rollout loop of ``utils/metrics.py`` runs before its every-32-steps
    all-done check stops it: the first multiple of 32 at or past the longest
    episode, or the horizon."""
    longest = int(acc["steps"].max())
    return min(max_steps, -(-longest // 32) * 32)


def match_outcome(acc):
    """(seat-0 wins, seat-1 wins, draws) of a match accumulator, as ``play_match``
    counts them."""
    place = acc["placement"].cpu()
    return (int((place[:, 0] == 1).sum()), int((place[:, 1] == 1).sum()),
            int((place == 0).all(dim=1).sum()))


@contextlib.contextmanager
def timed_matches(matches):
    """Times every ``rollout_match`` run inside the block (host clock, ending in a
    synchronize) and records its loop steps and outcome into ``matches``."""
    real = metrics.rollout_match

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        acc = real(*args, **kwargs)
        torch.cuda.synchronize()
        matches.append({"s": time.perf_counter() - t0,
                        "steps": loop_steps(acc, kwargs["max_steps"]),
                        "outcome": match_outcome(acc)})
        return acc
    metrics.rollout_match = timed
    try:
        yield
    finally:
        metrics.rollout_match = real


def tournament_play(dev, card):
    """Phase (g): the round robin of ``TOURNAMENT_MODELS`` at the CLI's defaults, its
    ranking held to ``data/tournament.json``'s, a match repeated from its seed, the
    1B agent against a random-init policy, the recorders on the held-out track, and
    the CLI into a temporary directory. Returns the tournament's launch counts."""
    with open("data/tournament.json") as f:
        jax_res = json.load(f)
    names = [os.path.basename(m) for m in TOURNAMENT_MODELS]
    matches = []
    zero_counts()
    t0 = time.perf_counter()
    with timed_matches(matches):
        res = tournament.run_tournament(TOURNAMENT_MODELS, device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    m = len(names)
    pairs = [(i, j) for i in range(m) for j in range(m) if i != j]
    steps = [mt["steps"] for mt in matches]
    expected = counts(TOURNAMENT_ENVS, multi_observe=sum(steps) + len(pairs),
                      multi_transition=sum(steps), pool_act=sum(steps))
    print(f"tournament: {m} models, {len(pairs)} matches of 40 envs (20 tracks x 2 runs, "
          f"seed 42, sampled, 3000 steps at most) in {dt:.1f} s on {card}; "
          f"{statistics.median(mt['s'] for mt in matches) * 1e3:.1f} ms a match (median; "
          f"{min(mt['s'] for mt in matches) * 1e3:.1f}-{max(mt['s'] for mt in matches) * 1e3:.1f}), "
          f"{sum(mt['s'] for mt in matches) / sum(steps) * 1e3:.3f} ms a step over "
          f"{sum(steps)} steps ({min(steps)}-{max(steps)} a match); launches {launches}")
    if launches != expected:
        raise AssertionError(f"tournament launches {launches}, expected {expected}")
    print(f"tournament: one sensing and one transition a step plus the reset's sensing "
          f"({launches['multi_observe'] / sum(steps):.4f} and "
          f"{launches['multi_transition'] / sum(steps):.4f} a step); the narrow env kernels "
          f"and the standalone K1-K5 0")
    for (i, j), mt in zip(pairs, matches):
        if sum(mt["outcome"]) != 40:
            raise AssertionError(f"match {names[i]} vs {names[j]}: {mt['outcome']}")
    wins, draws = np.array(res["wins"]), np.array(res["draws"])
    off = ~np.eye(m, dtype=bool)
    if not ((wins + wins.T + draws)[off] == 80).all() or not np.isfinite(res["elo"]).all():
        raise AssertionError(f"tournament: wins {wins.tolist()}, draws {draws.tolist()}, "
                             f"elo {res['elo']}")
    idx = [jax_res["names"].index(n) for n in names]
    jwins = np.array(jax_res["wins"])[np.ix_(idx, idx)]
    print("tournament wins (row beat column, both seat orders), this run | the JAX "
          "package's data/tournament.json:")
    for i, n in enumerate(names):
        print(f"  {n:>32} {' '.join(f'{w:>3}' for w in wins[i])} | "
              f"{' '.join(f'{w:>3}' for w in jwins[i])}")
    jelo = {n: jax_res["elo"][jax_res["names"].index(n)] for n in names}
    for row in res["ranking"]:
        print(f"  rank {row['rank']}: {row['name']:>32} elo {row['elo']:+.1f} (JAX, 6 models: "
              f"{jelo[row['name']]:+.1f}) W {row['wins']} L {row['losses']} D {row['draws']}")
    order = [row["name"] for row in res["ranking"]]
    if set(order[:2]) != set(names[:2]) or order[2:] != names[2:]:
        raise AssertionError(f"tournament ranking {order}: expected the 8B and 4B agents "
                             f"first, then {names[2]} and {names[3]}, as data/tournament.json")

    # one match played twice from its seed
    stacks = tournament.stack_bundles([load_policy_bundle(p, dev) for p in TOURNAMENT_MODELS[:2]],
                                      19)
    grid, _, _ = metrics.build_eval_grid(20, 2, 42, device=dev)
    cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)
    runs = [metrics.rollout_match(*stacks, cfg, grid, torch.Generator(device=dev).manual_seed(
        tournament.pair_seed(42, 1))) for _ in range(2)]
    if any(not torch.equal(runs[0][k], runs[1][k]) for k in runs[0]):
        raise AssertionError("a match played twice from one seed differs")
    if match_outcome(runs[0]) != matches[0]["outcome"]:
        raise AssertionError(f"the repeated match {match_outcome(runs[0])} differs from the "
                             f"tournament's {matches[0]['outcome']}")
    print(f"tournament: {names[0]} vs {names[1]} played twice from pair seed "
          f"{tournament.pair_seed(42, 1)}: every accumulator equal, outcome "
          f"{match_outcome(runs[0])} as in the tournament (the grid: W "
          f"{grid.wp_x.shape[-1]}, S {grid.seg_sx.shape[-1]})")

    # the 1B agent against a random-init policy (tests/test_tournament.py's match)
    random_ = (net.init_params(torch.Generator().manual_seed(123), 19, 2, device=dev),
               torch.full((2,), -0.5, device=dev), None)
    small, _, _ = metrics.build_eval_grid(3, 1, 42, device=dev)
    wa, wb, d = tournament.play_match(load_policy_bundle(TOURNAMENT_MODELS[2], dev), random_,
                                      small, torch.Generator(device=dev).manual_seed(7),
                                      max_steps=1500)
    print(f"tournament: {names[2]} against a random-init policy on 3 tracks: "
          f"{wa} wins, {wb} losses, {d} draws")
    if not wa > wb:
        raise AssertionError("the 1B agent does not beat a random-init policy")

    recorders(dev, card)

    # the CLI at its defaults, its JSON into a temporary directory
    before = file_digests()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "tournament.json")
        t0 = time.perf_counter()
        cli = tournament.main([TOURNAMENT_MODELS[0], TOURNAMENT_MODELS[3], "--out", out])
        dt = time.perf_counter() - t0
        with open(out) as f:
            written = json.load(f)
        files = os.listdir(tmp)
    if written != json.loads(json.dumps(cli)) or files != ["tournament.json"] or \
            sorted(written) != sorted(jax_res):
        raise AssertionError(f"the tournament CLI wrote {files}: {sorted(written)}")
    # a 2-model round robin seeds its pairs i*2 + j, not the 4-model run's i*4 + j
    again = tournament.run_tournament([TOURNAMENT_MODELS[0], TOURNAMENT_MODELS[3]], device=dev)
    if written != json.loads(json.dumps(again)):
        raise AssertionError(f"the CLI wrote {written}, run_tournament gives {again}")
    if file_digests() != before:
        raise AssertionError("the tournament CLI wrote the repo's tracked files")
    print(f"tournament CLI ({names[0]} vs {names[3]}, defaults, {dt:.1f} s): JSON read back "
          f"with JAX's keys, equal to run_tournament's on the two; tracked files untouched "
          f"({len(before)} checked)")
    return launches


def recorders(dev, card):
    """``record_trajectory_match`` (8B vs 4B) and ``record_trajectory_single`` on the
    held-out track (seed 123, width 7), greedy: one row per step the episode ran,
    as many as the rollout loop's own count, no row after the done step."""
    _, track = render._held_out_track(123, 7.0, dev)
    mcfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)
    scfg = senv.RacingConfig(num_sensors=11)
    bundles = [load_policy_bundle(p, dev) for p in TOURNAMENT_MODELS[:2]]
    params, log_std, _ = load_policy_bundle(MODEL, dev)
    cases = [
        ("match", lambda gen: viz.record_trajectory_match(bundles, mcfg, track, gen),
         lambda gen: metrics.rollout_match(*tournament.stack_bundles(bundles, mcfg.obs_dim),
                                           mcfg, track, gen, deterministic=True),
         3000, ("multi_observe", "multi_transition"), "pool_act"),
        ("single", lambda gen: viz.record_trajectory_single(params, log_std, scfg, track, gen),
         lambda gen: metrics.rollout_single(params, log_std, scfg, track, gen,
                                            deterministic=True),
         2000, ("single_observe", "single_transition"), "policy_act"),
    ]
    # the policy: one policy a seat in a match (kernel B's seat mode), kernel A alone
    for label, record, rollout_fn, horizon, (sensing, stepping), acting in cases:
        zero_counts()
        t0 = time.perf_counter()
        traj = record(torch.Generator(device=dev).manual_seed(0))
        dt = time.perf_counter() - t0
        launches = read_counts()
        acc = rollout_fn(torch.Generator(device=dev).manual_seed(0))
        n = int(acc["steps"][0])
        steps = loop_steps(acc, horizon)
        shape = (n, 2) if label == "match" else (n,)
        if not (len(traj["x"]) == n < horizon and traj["x"].shape == shape
                and traj["active"].all() and np.isfinite(traj["x"]).all()):
            raise AssertionError(f"record_trajectory_{label}: {len(traj['x'])} rows of "
                                 f"{traj['x'].shape}, the episode ran {n} steps")
        if launches != counts(1, **{sensing: steps + 1, stepping: steps, acting: steps}):
            raise AssertionError(f"record_trajectory_{label} launches {launches}")
        print(f"record_trajectory_{label} on the held-out track (seed 123, width 7): {n} rows "
              f"{traj['x'].shape}, the episode's {n} steps, no row after the done step; final "
              f"progress {np.round(np.atleast_1d(traj['progress'][-1]), 4).tolist()}; "
              f"{dt * 1e3:.0f} ms on {card}; launches {sensing} {steps + 1}, "
              f"{stepping} {steps}")


# ------------------------------------------------ phase (h): data-parallel training

DP_UPDATES = 2
DP_WORLD = 2
# The 2-rank update against one process with data_shards = 2. The rollouts must be
# the same bitwise (each env's row is computed alike at 2048 envs and at 4096); the
# minibatch loop cannot be: its gradient is the mean of two half-minibatch means
# and its advantage moments are combined from the halves, which round otherwise in
# float32 than one global mean. The first epoch's per-minibatch stats hold to
# DP_STAT_RTOL / DP_STAT_ATOL. Over 160 Adam steps the loop amplifies those
# roundings (the per-epoch drift is printed), as it amplifies params one ulp
# apart, so the parameters are held to DP_ATOL, about three steps of lr 3e-4,
# beside that one-ulp control, printed with them.
DP_STAT_RTOL, DP_STAT_ATOL = 1e-4, 1e-7
DP_ATOL = 1e-3


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dp_config(data_shards: int = 1):
    """``train scale``'s config at its width, with snapshot_freq 1 (pool opponents
    from the second update on), as phase 10 runs it."""
    return self_play_config(num_envs=NUM_ENVS, num_steps=STEPS,
                            total_timesteps=1_000_000_000, opponent_per_env=True,
                            reset_envs_each_update=False, snapshot_freq=1,
                            data_shards=data_shards)


def dp_trainer(cfg, dev, eager=False):
    """Phase h's self-play trainer on the canonical pool tiled over the envs, built
    alike on every rank from the seed (``eager`` as ``SelfPlayTrainer`` takes it)."""
    pool = canonical_bench_pool(NUM_TRACKS, device=dev)
    return SelfPlayTrainer(cfg, menv.MultiRacingConfig(num_agents=NUM_AGENTS, num_sensors=11),
                           trk.tiled_pooled_tracks(pool, cfg.num_envs), eager=eager)


def dp_expected(cfg, updates: int, launches, towers: bool = True, group: bool = True):
    """The launches of ``updates`` updates on one rank (``num_envs / data_shards``
    envs): the sensing and the transition (by row id) every step, K6 and K7 once an
    update, the learner's kernels once a minibatch run (``learner``, checked on
    ``launches``; the MLP kernels where ``towers``, not on a tensor-parallel rank,
    and in a ``group`` the reduce's norm-only mode with them)."""
    n = cfg.num_steps * updates
    return counts(cfg.num_envs // cfg.data_shards, autoreset=True, multi_observe=n,
                  multi_transition=n,
                  multi_observe_row_ids=n, multi_transition_row_ids=n,
                  **policy(n, selfplay=True, towers=towers),
                  compute_gae=updates, mixbits_permutation=updates,
                  **learner(launches, cfg, updates, towers=towers, group=group))


def dp_train(trainer, updates: int):
    """``updates`` updates of ``trainer``, each timed (host clock to a
    synchronize) with its minibatch loop. Returns the ms of each update and of
    its loop, their metrics, their per-minibatch stats (``ppo.run_ppo_update``'s,
    recorded through its module) and the launches of the run."""
    run_update = ppo.run_ppo_update
    stats, metrics, wall, loop = [], [], [], []

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()

    def recording(*args, **kwargs):
        sync()
        t = time.perf_counter()
        out = run_update(*args, **kwargs)
        sync()
        loop.append((time.perf_counter() - t) * 1e3)
        stats.append(out[2])
        return out

    ppo.run_ppo_update = recording
    try:
        zero_counts()
        for _ in range(updates):
            t = time.perf_counter()
            trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
            sync()
            wall.append((time.perf_counter() - t) * 1e3)
        launches = read_counts()
    finally:
        ppo.run_ppo_update = run_update
    return {"wall": wall, "loop": loop}, metrics, stats, launches


def ms_line(ms) -> str:
    """Each update's ms and, in brackets, its minibatch loop's."""
    return " / ".join(f"{w:.1f} ({l:.1f})" for w, l in zip(ms["wall"], ms["loop"]))


def dp_state(trainer):
    """What the world-1 run must hold bitwise: parameters, Adam moments and count,
    the pool and the PFSP counters."""
    adam = trainer.runner.train.opt_state
    pool = [t for layers in trainer.pool["params"].values() for layer in layers
            for t in layer] + [trainer.pool["log_std"]]
    return {"params": [p.detach() for p in trainer.runner.train.model.parameters()],
            "mu": list(adam.mu), "nu": list(adam.nu), "count": adam.count,
            "pool": pool, "num_snapshots": trainer.num_snapshots,
            "pool_wins": trainer.pool_wins.tolist(), "pool_games": trainer.pool_games.tolist()}


@contextlib.contextmanager
def all_reduce_calls():
    """Counts the calls of ``dist.all_reduce`` inside the block: yields [calls
    made eagerly (warm-ups included), calls made while a CUDA graph captures]."""
    all_reduce = dist.all_reduce
    calls = [0, 0]

    def counting(*args, **kwargs):
        calls[int(torch.cuda.is_available() and torch.cuda.is_current_stream_capturing())] += 1
        return all_reduce(*args, **kwargs)

    dist.all_reduce = counting
    try:
        yield calls
    finally:
        dist.all_reduce = all_reduce


def minibatches_run(stats) -> int:
    """The minibatches an update's loop ran: every epoch up to the exit's, whole
    (the exit's epoch runs masked to its end)."""
    e, m = stats["computed"].shape
    return -(-int(stats["computed"].sum()) // m) * m


def data_parallel_world_one(dev, card):
    """Phase h.1: two updates of train scale's self-play at 4096 x 256 x 2 cars
    without torch.distributed, then the same seeded run through
    ``distributed_init`` (NCCL, one process) and ``shard()``, graphed and with
    ``eager=True``: every collective of the data-parallel path runs over a group
    of one, and both runs must be the undistributed one bitwise. Returns the
    graphed run's launches (counted from its replays)."""
    cfg = dp_config()
    plain = dp_trainer(cfg, dev)
    p_wall, p_metrics, p_stats, p_launches = dp_train(plain, DP_UPDATES)
    p_capture = plain.update_step.graphs.capture_seconds
    want = dp_state(plain)
    del plain
    runs = {}
    pmesh.distributed_init(f"127.0.0.1:{free_port()}", 1, 0, device=dev)
    try:
        mesh = pmesh.make_mesh(dev)
        backend = dist.get_backend(mesh.group)
        for mode in ("graphed", "eager"):
            sharded = dp_trainer(cfg, dev, eager=mode == "eager")
            sharded.shard(mesh)
            sync_check = replays_without_sync() if mode == "graphed" else \
                contextlib.nullcontext([0])
            with all_reduce_calls() as calls, sync_check as replays:
                wall, metrics, stats, launches = dp_train(sharded, DP_UPDATES)
            graphs = sharded.update_step.graphs
            runs[mode] = {"wall": wall, "metrics": metrics, "stats": stats,
                          "launches": launches, "state": dp_state(sharded),
                          "calls": calls, "replays": replays[0], "graphs": graphs,
                          "capture": 0.0 if graphs is None else graphs.capture_seconds}
            del sharded
    finally:
        dist.destroy_process_group()
    if backend != ("nccl" if dev.type == "cuda" else "gloo") or mesh.world != 1:
        raise AssertionError(f"world-1 run on {backend} over {mesh.world} ranks")
    g, e = runs["graphed"], runs["eager"]
    if dev.type == "cuda" and (
            g["graphs"] is None or g["graphs"].minibatch_graph.moments_step is None
            or e["graphs"] is not None or g["replays"] < DP_UPDATES * cfg.num_steps):
        raise AssertionError(f"world 1: the NCCL run is not graphed ({g['replays']} replays) "
                             f"or the eager run is")
    run = [minibatches_run(st) for st in e["stats"]]
    reduces, before = 3 * len(run) + sum(run), len(run) + 3 * sum(run)
    print(f"data parallel, world 1 ({backend}, shard() applied), graphed: {ms_line(g['wall'])} "
          f"ms/update (the minibatch loop's), capture {g['capture']:.3f} s, {g['replays']} "
          f"replays without a sync; eager=True: {ms_line(e['wall'])}; without "
          f"torch.distributed, graphed: {ms_line(p_wall)}, capture {p_capture:.3f} s "
          f"({cfg.num_envs} x {cfg.num_steps} x {NUM_AGENTS} cars on {card}); "
          f"minibatches_applied {[int(m['minibatches_applied']) for m in g['metrics']]}; pool "
          f"{g['state']['num_snapshots']} snapshots, learner won {g['state']['pool_wins']} of "
          f"{g['state']['pool_games']}; launches {g['launches']}")
    print(f"data parallel, world 1: the eager run's updates ran {run} minibatches and made "
          f"{e['calls'][0]} all-reduces ({reduces} = 3 an update + 1 a minibatch run; "
          f"{before} = 1 an update + 3 a minibatch run before the advantage moments were "
          f"reduced once an update); the graphed run's captures hold {g['calls'][1]} "
          f"all-reduce nodes (the minibatch step's 1, the advantage moments' 2, at each "
          f"capture) and it called {g['calls'][0]} eagerly (warm-ups and the metrics)")
    if e["calls"] != [reduces, 0]:
        raise AssertionError(f"world 1 eager: {e['calls']} all-reduces, expected {reduces}")
    for mode, r in runs.items():
        for launches, group in ((p_launches, False), (r["launches"], True)):
            if launches != dp_expected(cfg, DP_UPDATES, launches, group=group):
                raise AssertionError(f"data parallel world 1 launches {launches}, expected "
                                     f"{dp_expected(cfg, DP_UPDATES, launches, group=group)}")
        got = r["state"]
        diffs = [k for k in ("count", "num_snapshots", "pool_wins", "pool_games")
                 if got[k] != want[k]]
        diffs += [k for k in ("params", "mu", "nu", "pool")
                  if not all(torch.equal(a, b) for a, b in zip(got[k], want[k]))]
        for k in ppo.STAT_NAMES:
            if not all(np.array_equal(a[k], b[k]) for a, b in zip(r["stats"], p_stats)):
                diffs.append(f"per-minibatch {k}")
        if [m["minibatches_applied"] for m in r["metrics"]] != \
                [m["minibatches_applied"] for m in p_metrics]:
            diffs.append("minibatches_applied")
        if diffs or len(r["stats"]) != DP_UPDATES:
            raise AssertionError(f"data parallel world 1 ({mode}) differs from the "
                                 f"undistributed run in {diffs}")
    print("data parallel, world 1, graphed and eager=True: params, Adam moments and count, "
          "every per-minibatch stat, minibatches_applied, the pool and the PFSP counters "
          "bitwise the undistributed graphed run's")
    print(f"data parallel, world 1: the reduce's norm-only mode launched "
          f"{g['launches']['mlp_grad_norm']} times graphed and {e['launches']['mlp_grad_norm']} "
          f"eager (once a minibatch step, as mlp_grad_reduce: "
          f"{g['launches']['mlp_grad_reduce']}), without torch.distributed "
          f"{p_launches['mlp_grad_norm']} (the norm fused into the reduce)")
    return g["launches"]


def dp_rank(rank, world, backend, port, out, cfg, device, eager_too=False):
    """A rank of ``data_parallel_ranks``: its share of ``cfg``'s envs on
    ``device``, one update (graphed where the group is NCCL's), and with
    ``eager_too`` one more of a trainer built alike with ``eager=True``; the
    results saved to ``out``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pmesh.distributed_init(f"127.0.0.1:{port}", world, rank, backend=backend, device=dev)
    try:
        mesh = pmesh.make_mesh(dev)
        warm = dp_trainer(cfg, dev)  # so that the timed update is not the process's first
        warm.shard(mesh)
        dp_train(warm, 1)
        del warm
        result = {"backend": dist.get_backend(mesh.group), "world": mesh.world, "device": dev}
        for mode in ("default", "eager") if eager_too else ("default",):
            trainer = dp_trainer(cfg, dev, eager=mode == "eager")
            trainer.shard(mesh)
            wall, metrics, stats, launches = dp_train(trainer, 1)
            result[mode] = {
                "graphed": trainer.update_step.graphs is not None,
                "envs": trainer.runner.done.shape[0], "wall": wall, "metrics": metrics,
                "stats": stats, "launches": launches, "obs": trainer.runner.obs.cpu(),
                "params": [p.detach().cpu() for p in trainer.runner.train.model.parameters()]}
            del trainer
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


def max_abs(xs, ys) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(xs, ys))


def run_rank_processes(target, world, backend, per_rank, timeout):
    """``target(r, world, backend, port, out_r, *per_rank(r))`` in ``world`` spawned
    processes joining one port; each saves its result to ``out_r``. Kills them at
    ``timeout`` seconds and raises unless all exit 0. Returns the results in rank
    order."""
    ctx = mp.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=target,
                             args=(r, world, backend, port, outs[r], *per_rank(r)))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise AssertionError(f"{target.__name__} ranks exited with {codes}")
        return [torch.load(o, weights_only=False) for o in outs]


def bitwise(a, b) -> bool:
    """Whether two results (tensors, arrays, numbers, or dicts and lists of them)
    are equal to the bit (NaN equal to NaN)."""
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(bitwise(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bitwise(x, y) for x, y in zip(a, b))
    return bool(np.array_equal(a, b, equal_nan=True))


def graphed_against_eager(what, graphed, eager, control, keys=()):
    """Holds a rank's graphed update against its ``eager=True`` update from the same
    seed (``graphed``, ``eager``: dicts with "params", "metrics" and the ``keys``):
    bitwise, or else the parameters within ``control`` (a one-ulp control's
    distance) with the minibatches applied equal, the reason printed: the group's
    sums round otherwise in a graph than eagerly (NCCL may pick another algorithm or
    protocol inside a graph; ``NCCL_ALGO=Ring NCCL_PROTO=Simple`` fixes one for
    both). Returns the max abs distance of the parameters."""
    absd = max_abs(graphed["params"], eager["params"])
    same = all(bitwise(graphed[k], eager[k]) for k in ("params", "metrics", *keys))
    algo = (f"NCCL_ALGO={os.environ['NCCL_ALGO']} NCCL_PROTO={os.environ.get('NCCL_PROTO')}"
            if "NCCL_ALGO" in os.environ else "NCCL's own choice of algorithm")
    if same:
        print(f"{what}: graphed = eager bitwise ({algo})")
        return absd
    applied = [m["minibatches_applied"] for m in graphed["metrics"]], \
        [m["minibatches_applied"] for m in eager["metrics"]]
    print(f"{what}: graphed != eager bitwise ({algo}): params "
          f"{absd:.3e} apart, the one-ulp control {control:.3e}; minibatches_applied "
          f"{applied[0]} and {applied[1]}: the group's sums round otherwise in the "
          f"graphs' NCCL kernels than in the eager ones")
    if absd > control or applied[0] != applied[1]:
        raise AssertionError(f"{what}: graphed {absd:.3e} from eager, beyond the one-ulp "
                             f"control's {control:.3e}, or another exit")
    return absd


def data_parallel_ranks(dev, card, world=DP_WORLD, backend="gloo", devices=None,
                        rollout_bitwise=True, eager_too=False):
    """One update over ``world`` processes (``4096 / world`` envs each, the group's
    ``backend``, rank r on ``devices[r]``, by default all on ``dev``) against one
    process on ``dev`` with 4096 envs and data_shards = world, and the same process
    from params one ulp up (the control); each process's timed update follows a
    warm-up update of a throwaway trainer. Phase h.2 runs two gloo processes on the
    one card (NCCL refuses two ranks on one GPU; gloo all-reduces CUDA tensors), so
    eagerly; ``scripts/data_parallel_cards.py`` one NCCL process a card, graphed,
    and with ``eager_too`` each rank also runs the update with ``eager=True``,
    held to the graphed one (``graphed_against_eager``). ``rollout_bitwise``
    requires every rank's final observations to be bitwise one process's rows;
    otherwise they are counted and printed. Returns each rank's launches (of the
    graphed update)."""
    devices = [str(dev)] * world if devices is None else devices
    cfg = dp_config(world)
    dp_train(dp_trainer(cfg, dev), 1)  # warm-up
    one = dp_trainer(cfg, dev)
    o_wall, o_metrics, o_stats, _ = dp_train(one, 1)
    want = [p.detach().cpu() for p in one.runner.train.model.parameters()]
    want_obs = one.runner.obs.cpu()
    del one
    nudged = dp_trainer(cfg, dev)
    with torch.no_grad():
        for p in nudged.runner.train.model.parameters():
            p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    dp_train(nudged, 1)
    control = max_abs([p.detach().cpu() for p in nudged.runner.train.model.parameters()], want)
    del nudged
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = run_rank_processes(dp_rank, world, backend,
                               lambda r: (cfg, devices[r], eager_too), 300)
    m1 = o_metrics[0]
    print(f"data parallel, one process, data_shards={world}: {ms_line(o_wall)} ms/update "
          f"at {cfg.num_envs} envs; minibatches_applied {m1['minibatches_applied']:.0f}, "
          f"episodes {m1['episodes']:.0f}, mean_ep_return {m1['mean_ep_return']:.4f}; "
          f"from params one ulp up its params end {control:.3e} apart at most")
    n = cfg.num_envs // world
    graphed = backend == "nccl" and dev.type == "cuda"
    equal = []
    for r, ranked in enumerate(ranks):
        got = ranked["default"]
        m, st, ref = got["metrics"][0], got["stats"][0], o_stats[0]
        absd = max_abs(got["params"], want)
        same = int((got["obs"] == want_obs[r * n:(r + 1) * n]).all(dim=1).sum())
        equal.append(same)
        with np.errstate(invalid="ignore"):  # epochs past a KL exit are 0 / 0
            drift = {k: np.abs(st[k] - ref[k]).max(axis=1) / np.abs(ref[k]).max(axis=1)
                     for k in ("approx_kl", "loss")}
        eager = "" if "eager" not in ranked else \
            f"; eager=True {ms_line(ranked['eager']['wall'])} ms/update"
        print(f"data parallel, rank {r} of {ranked['world']} ({ranked['backend']} on "
              f"{ranked['device']}, {got['envs']} envs, "
              f"{'graphed' if got['graphed'] else 'eager'}): {ms_line(got['wall'])} "
              f"ms/update{eager}; "
              f"minibatches_applied {m['minibatches_applied']:.0f}, episodes "
              f"{m['episodes']:.0f}, mean_ep_return {m['mean_ep_return']:.4f}; final obs "
              f"bitwise one process's rows in {same} of {n} envs; "
              f"per-minibatch drift from one process by epoch, approx_kl "
              f"{np.array2string(drift['approx_kl'], precision=2)}, loss "
              f"{np.array2string(drift['loss'], precision=2)}; params max abs {absd:.3e} "
              f"(atol {DP_ATOL:g}; the one-ulp control {control:.3e}); launches "
              f"{got['launches']}")
        if (ranked["backend"], ranked["world"], got["envs"]) != (backend, world, n) or \
                got["graphed"] != graphed:
            raise AssertionError(f"rank {r}: {ranked['backend']}, world {ranked['world']}, "
                                 f"{got['envs']} envs, graphed {got['graphed']}")
        if rollout_bitwise and (m["episodes"] != m1["episodes"] or same != n):
            raise AssertionError(f"rank {r}: the rollout differs from one process's rows")
        if m["minibatches_applied"] != m1["minibatches_applied"]:
            raise AssertionError(f"rank {r} applied {m['minibatches_applied']} minibatches, "
                                 f"one process {m1['minibatches_applied']}")
        if not np.array_equal(st["computed"], ref["computed"]) or not all(
                np.allclose(st[k][0], ref[k][0], rtol=DP_STAT_RTOL, atol=DP_STAT_ATOL)
                for k in ppo.STAT_NAMES[:6]):
            raise AssertionError(f"rank {r}: the first epoch's per-minibatch stats are "
                                 f"beyond rtol {DP_STAT_RTOL}, atol {DP_STAT_ATOL}")
        if absd > DP_ATOL:
            raise AssertionError(f"rank {r}: params {absd:.3e} from one process's, beyond "
                                 f"{DP_ATOL}")
        for mode in ("default", "eager") if eager_too else ("default",):
            expected = dp_expected(cfg, 1, ranked[mode]["launches"])
            if ranked[mode]["launches"] != expected:
                raise AssertionError(f"rank {r} ({mode}) launches {ranked[mode]['launches']}, "
                                     f"expected {expected}")
        if eager_too:
            if ranked["eager"]["graphed"]:
                raise AssertionError(f"rank {r}: the eager=True run built graphs")
            graphed_against_eager(f"data parallel, rank {r}", got, ranked["eager"], control,
                                  keys=("obs",))
    for mode in ("default", "eager") if eager_too else ("default",):
        if not all(torch.equal(a, b) for got in ranks[1:]
                   for a, b in zip(ranks[0][mode]["params"], got[mode]["params"])):
            raise AssertionError(f"the ranks hold different parameters ({mode})")
    rollout = ("the rollout bitwise one process's" if rollout_bitwise else
               f"final obs bitwise one process's in {sum(equal)} of {cfg.num_envs} envs")
    print(f"data parallel, {world} ranks: the reduce's norm-only mode launched "
          f"{[got['default']['launches']['mlp_grad_norm'] for got in ranks]} times on the ranks "
          f"(mlp_grad_reduce {[got['default']['launches']['mlp_grad_reduce'] for got in ranks]})")
    print(f"data parallel, {world} ranks ({backend}, {'graphed' if graphed else 'eager'}): "
          f"{rollout}, minibatches_applied equal, the first epoch's stats within rtol "
          f"{DP_STAT_RTOL:g} / atol {DP_STAT_ATOL:g}, params within {DP_ATOL:g} of one "
          f"process's and bitwise equal on every rank, on {card}")
    return [got["default"]["launches"] for got in ranks]


def scaling_cli(card):
    """Phase h.4: ``python -m self_play_racing_tpu_torch.parallel.scaling`` at world 1
    on the card, writing its artifact into a temporary directory."""
    before = file_digests()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "scaling.json")
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "self_play_racing_tpu_torch.parallel.scaling",
                              "--out", out], capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if res.returncode:
            raise AssertionError(f"scaling CLI exited {res.returncode}:\n{res.stderr[-3000:]}")
        with open(out) as f:
            art = json.load(f)
    print(f"scaling CLI at world 1 in {dt:.1f} s on {card}: {json.dumps(art)}")
    row = art["rows"][0]
    if (art["schema"], art["num_processes"], row["devices"]) != ("scaling_sweep_v1", 1, 1) \
            or not np.isfinite(row["env_steps_per_s"]):
        raise AssertionError(f"scaling artifact {art}")
    if file_digests() != before:
        raise AssertionError("the scaling CLI wrote the repo's tracked files")


def data_parallel(dev, card):
    """Phase h; returns the launches of h.1 (per rank, 2 updates) and of h.2's
    ranks (1 update each)."""
    world_one = data_parallel_world_one(dev, card)
    ranks = data_parallel_ranks(dev, card)
    scaling_cli(card)
    return world_one, ranks


# ------------------------------------- phase (i): the gym adapters and the SB3 leg

SB3_MODEL = "models/sb3_baseline_agent_general.zip"
ADAPTER_TRACK_WIDTH = 7.0
# The card's adapter against the CPU's, both float32: the kernels are bitwise their
# plain versions, but the elementwise cos/sin/sqrt of the step round differently
# on the card and in the CPU's math library (ulps), which the car's state carries
# from step to step. ADAPTER_OBS_ATOL bounds the observations' gap (unit-scale
# features; a ray is a hit distance over 50).
ADAPTER_OBS_ATOL = 1e-3
SB3_GRID = (8, 2)  # tracks x runs of the reduced --sb3 grid


def timed(what):
    """Prints the wall seconds of the block it wraps."""
    @contextlib.contextmanager
    def block():
        t0 = time.perf_counter()
        yield
        print(f"{what}: {time.perf_counter() - t0:.1f} s wall")
    return block()


def canonical_control_points():
    """The canonical pool's control points (``canonical_bench_pool``'s draw)."""
    np.random.seed(1)
    return trk.gen_tracks(num_tracks=NUM_TRACKS, seed=1)


def racing_env_episode(env, rng, max_steps=2000):
    """One episode of ``env`` under actions drawn from ``rng``; its observations
    (reset included) and the step it ended at."""
    obs, _ = env.reset()
    seen = [obs]
    for t in range(max_steps):
        obs, _, term, trunc, _ = env.step(rng.uniform([-1.0, 0.3], [1.0, 1.0]))
        seen.append(obs)
        if term or trunc:
            return np.stack(seen), t + 1
    return np.stack(seen), max_steps


def adapter_single(dev, card):
    """Phase i.1: ``RacingEnv`` at float32 on the card against the same adapter on
    the CPU, one episode of seeded actions on the canonical pool's track 0."""
    from self_play_racing_tpu_torch.envs import gym_adapter

    cps = canonical_control_points()
    kw = dict(num_sensors=11, track_pool=cps, track_id=0, track_width=ADAPTER_TRACK_WIDTH)
    card_env = gym_adapter.RacingEnv(**kw, device=dev)
    cpu_env = gym_adapter.RacingEnv(**kw, dtype=torch.float32, device="cpu")
    if card_env.track.wp_x.dtype != torch.float32:
        raise AssertionError(f"RacingEnv on {dev} runs {card_env.track.wp_x.dtype}")
    racing_env_episode(card_env, np.random.default_rng(1), 8)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    got, steps = racing_env_episode(card_env, np.random.default_rng(0))
    dt = time.perf_counter() - t0
    launches = read_counts()
    want, want_steps = racing_env_episode(cpu_env, np.random.default_rng(0))
    gap = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    print(f"RacingEnv on the card: one episode of {steps} steps (the CPU adapter's "
          f"{want_steps}) in {dt:.3f} s = {dt / steps * 1e3:.3f} ms a step, one host "
          f"copy each, on {card}; largest observation gap to the CPU {gap:.3e} "
          f"(atol {ADAPTER_OBS_ATOL:g}); launches {launches}")
    if steps != want_steps:
        raise AssertionError(f"RacingEnv: the card's episode ends at {steps}, the CPU's "
                             f"at {want_steps}")
    if gap > ADAPTER_OBS_ATOL:
        raise AssertionError(f"RacingEnv: observations {gap:.3e} from the CPU's")
    expected = counts(1, single_observe=steps + 1, single_transition=steps)
    if launches != expected:
        raise AssertionError(f"RacingEnv launches {launches}, expected {expected}")
    return launches, dt / steps


def adapter_selfplay(dev, card):
    """Phase i.2: ``MultiRacingEnv(num_agents=2)`` behind ``SelfPlayWrapper``, its
    opponent ``models/self_play_agent.npz``'s (params, log_std), the agent the same
    policy's greedy action, for one episode on the canonical pool's track 0."""
    from self_play_racing_tpu_torch.envs import gym_adapter

    params, log_std = evaluate.load_policy(MULTI_MODEL, device=dev)
    env = gym_adapter.SelfPlayWrapper(gym_adapter.MultiRacingEnv(
        num_agents=2, num_sensors=11, track_pool=canonical_control_points(), track_id=0,
        track_width=ADAPTER_TRACK_WIDTH, device=dev))
    env.set_opponent((params, log_std))
    spaces = {k: type(getattr(env, k)).__module__ + "." + type(getattr(env, k)).__name__
              for k in ("action_space", "observation_space")}
    if env.observation_space.shape != (19,) or env.action_space.shape != (2,):
        raise AssertionError(f"SelfPlayWrapper spaces {spaces}")

    def act(obs):
        with torch.no_grad():
            a = net.deterministic_action(params, torch.as_tensor(obs, device=dev)[None])
        return a[0].cpu().numpy()

    np.random.seed(0)
    zero_counts()
    t0 = time.perf_counter()
    obs, _ = env.reset()
    steps, total = 0, 0.0
    for steps in range(1, 3001):
        obs, reward, done, _, info = env.step(act(obs))
        total += reward
        if done:
            break
    dt = time.perf_counter() - t0
    launches = read_counts()
    print(f"SelfPlayWrapper on the card (2 cars, opponent {MULTI_MODEL} sampled, agent "
          f"greedy): {steps} steps in {dt:.3f} s = {dt / steps * 1e3:.3f} ms a step; "
          f"return {total:.2f}, placement {info.get('placement')}, finished "
          f"{info['finished']}; spaces {spaces}; launches {launches}")
    if not done:
        raise AssertionError("SelfPlayWrapper: the episode did not end in 3000 steps")
    # kernel A twice a step: the agent's greedy action and the opponent's sample
    expected = counts(1, multi_observe=steps + 1, multi_transition=steps,
                      policy_act=2 * steps)
    if launches != expected:
        raise AssertionError(f"SelfPlayWrapper launches {launches}, expected {expected}")
    return launches


def sb3_evaluation(dev, card):
    """Phase i.3: ``evaluate --sb3 models/sb3_baseline_agent_general.zip`` through
    ``eval()`` on the reduced grid, into a temporary directory."""
    tracks, runs = SB3_GRID
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        by_label = evaluate.eval({"sb3": ("sb3", SB3_MODEL)}, tracks, runs, 42, out_dir=tmp,
                                 chart=None, device=dev)
        with open(os.path.join(tmp, "eval_info_sb3.json")) as f:
            res = json.load(f)
    dt = time.perf_counter() - t0
    steps = sum(e["steps"] for e in res["all_episodes"])
    print(f"evaluate --sb3 {SB3_MODEL} {tracks} x {runs} (deterministic, seed 42): "
          f"success_rate={res['success_rate']:.3f} crash_rate={res['crash_rate']:.3f} "
          f"avg_steps={res['avg_steps']:.2f} avg_speed={res['avg_speed']:.3f}; {steps} "
          f"adapter steps in {dt:.1f} s = {dt / steps * 1e3:.3f} ms a step on {card}")
    if res != json.loads(json.dumps(by_label["sb3"]["results"])) or \
            len(res["all_episodes"]) != tracks * runs:
        raise AssertionError("eval_info_sb3.json differs from eval()'s results")
    if res["success_rate"] < SUCCESS_FLOOR:
        raise AssertionError(f"--sb3 success_rate {res['success_rate']} < {SUCCESS_FLOOR}")


def sb3_training(dev, card):
    """Phase i.4: ``train sb3 --num-envs 2 --total-timesteps 4096`` (one 2048-step
    rollout an env, 10 epochs of 64-sample minibatches) from a temporary directory;
    the model loads and drives two episodes."""
    from self_play_racing_tpu_torch.interop import sb3_compat

    before = file_digests()
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", "self_play_racing_tpu_torch.train", "sb3",
                              "--num-envs", "2", "--total-timesteps", "4096"], cwd=tmp,
                             env=env, capture_output=True, text=True, timeout=600)
        dt = time.perf_counter() - t0
        if res.returncode:
            raise AssertionError(f"train sb3 exited {res.returncode}:\n{res.stderr[-3000:]}")
        with open(os.path.join(tmp, "data", "training_info_sb3.json")) as f:
            curve = json.load(f)
        path = os.path.join(tmp, "models", "sb3_baseline_agent_general.zip")
        model = sb3_compat.PPO.load(path, device=dev)
        results = evaluate.evaluate_sb3_agent_overall(path, num_tracks=2, num_runs=1,
                                                      max_steps=300, device=dev)
    print(f"train sb3 --num-envs 2 --total-timesteps 4096: {dt:.1f} s on {card} (the "
          f"process included); {model.num_timesteps} timesteps on {model.device}; curve "
          f"{curve}; the saved model drives 2 episodes: steps "
          f"{[e['steps'] for e in results['all_episodes']]}")
    if model.num_timesteps != 4096 or model.device.type != "cuda" or \
            len(curve["steps"]) != len(curve["rewards"]) or \
            len(results["all_episodes"]) != 2:
        raise AssertionError("train sb3: the saved model or its curve is not what was asked")
    if file_digests() != before:
        raise AssertionError("train sb3 wrote the repo's tracked files")


def adapters(dev, card):
    """Phase i; returns the launches of i.1's and i.2's episodes, summed."""
    try:
        import gymnasium  # noqa: F401
        gym_line = f"gymnasium {gymnasium.__version__} imported"
    except ImportError:
        gym_line = "gymnasium is not installed: the adapters run on their stand-ins"
    print(f"adapters: {gym_line}")
    with timed("phase i.1 (RacingEnv)"):
        single, step_s = adapter_single(dev, card)
    with timed("phase i.2 (SelfPlayWrapper)"):
        multi = adapter_selfplay(dev, card)
    with timed("phase i.3 (evaluate --sb3)"):
        sb3_evaluation(dev, card)
    with timed("phase i.4 (train sb3)"):
        sb3_training(dev, card)
    return {k: single[k] + multi[k] for k in COUNTERS}


# ------------------------------------------ phase (j): tensor-parallel towers

TP_MODEL = 2
TP_HIDDEN = (128, 128)
# One update with the towers split over two ranks against one process unsharded:
# the partial products are summed in another order, so the rollout's actions and
# the minibatch loop's steps round otherwise in float32, and the loop amplifies
# that as it amplifies params one ulp apart. So each config has a control, the
# unsharded update from params one ulp up, and the parameters are held to the
# larger of TP_ATOL (phase h's bound) and TP_CONTROL_FACTOR times the control's
# distance: the split may move them no further than a few one-ulp nudges do.
TP_ATOL = 1e-3
TP_CONTROL_FACTOR = 4


def tp_configs():
    """Phase j's two configs: single-car PPO at 4096 x 256 and phase h's self-play
    (snapshot_freq 1), both with towers of 128."""
    return {"single": base_config(num_envs=NUM_ENVS, num_steps=STEPS,
                                  total_timesteps=NUM_ENVS * STEPS * 100, hidden=TP_HIDDEN),
            "selfplay": dataclasses.replace(dp_config(), hidden=TP_HIDDEN)}


def tp_trainer(name, cfg, dev, eager=False):
    """Phase j's trainers on the canonical pool tiled: ``PPOTrainer`` for
    "single", phase h's ``SelfPlayTrainer`` for "selfplay" (``eager`` as the
    trainers take it)."""
    if name == "selfplay":
        return dp_trainer(cfg, dev, eager)
    pool = canonical_bench_pool(NUM_TRACKS, device=dev)
    return PPOTrainer(cfg, senv.RacingConfig(num_sensors=11),
                      trk.tiled_pooled_tracks(pool, cfg.num_envs), eager=eager)


def tp_expected(cfg, launches):
    """A rank's launches in one single-car update on the tiled pool (the learner's
    kernels as ``learner`` checks them on ``launches``; no MLP kernel: the rank's
    slices run the Megatron composition)."""
    n = cfg.num_steps
    return counts(cfg.num_envs, autoreset=True, tiled=True, single_observe=n,
                  single_transition=n,
                  single_observe_row_ids=n, single_transition_row_ids=n, compute_gae=1,
                  mixbits_permutation=1, **policy(n, towers=False),
                  **learner(launches, cfg, 1, towers=False))


def tp_runs(cfgs, dev, mesh=None, eager=False, warm=True):
    """One update of each of ``cfgs``' trainers (``tp_trainer``, ``eager`` as it
    takes it), sharded over ``mesh`` when given, with ``warm`` the first after a
    warm-up update of a throwaway trainer (so that no timed update is the
    process's first); then a snapshot of the self-play learner. Returns what phase
    j compares, on the host."""
    out = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        if i == 0 and warm:
            throwaway = tp_trainer(name, cfg, dev)
            if mesh is not None:
                throwaway.shard(mesh)
            dp_train(throwaway, 1)
            del throwaway
        trainer = tp_trainer(name, cfg, dev, eager)
        if mesh is not None:
            trainer.shard(mesh)
        train = trainer.runner.train
        shapes = [[tuple(t.shape) for t in ts] for ts in
                  (list(train.model.parameters()), train.opt_state.mu, train.opt_state.nu)]
        wall, metrics, _, launches = dp_train(trainer, 1)
        params = [p.cpu() for p in trainer.full_state()[0]]
        out[name] = {"wall": wall, "metrics": metrics, "launches": launches,
                     "shapes": shapes, "params": params,
                     "graphed": trainer.update_step.graphs is not None}
        if name == "selfplay":
            trainer.snapshot_agent()
            out[name]["slot"] = [t[0].cpu() for layers in trainer.pool["params"].values()
                                 for layer in layers for t in layer]
    return out


def tp_rank(rank, world, backend, port, out, cfgs, device, eager_too=False):
    """A rank of ``tensor_parallel_ranks``: ``tp_runs`` on a mesh of
    ``world / TP_MODEL`` data rows x ``TP_MODEL`` model ranks (graphed where the
    groups are NCCL's), and with ``eager_too`` again with ``eager=True``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pmesh.distributed_init(f"127.0.0.1:{port}", world, rank, backend=backend, device=dev)
    try:
        mesh = pmesh.make_mesh(dev, model_parallel=TP_MODEL)
        result = {"default": tp_runs(cfgs, dev, mesh),
                  "mesh": (dict(mesh.shape), mesh.rank, mesh.model_rank,
                           dist.get_backend(mesh.all_group))}
        if eager_too:
            result["eager"] = tp_runs(cfgs, dev, mesh, eager=True, warm=False)
    finally:
        dist.destroy_process_group()
    torch.save(result, out)


def tensor_parallel_ranks(dev, card, world=TP_MODEL, backend="gloo", devices=None,
                          cfgs=None, eager_too=False):
    """Phase j: one single-car update (4096 x 256, towers of 128, the canonical
    pool tiled) and one self-play update (phase h's, towers of 128) over ``world``
    processes on a mesh of ``world / 2`` data rows x 2 model ranks (``backend``,
    rank r on ``devices[r]``, by default all on ``dev``), against one process
    unsharded with the same seed, and the same process from params one ulp up (the
    control). Phase j runs two gloo processes on the one card (NCCL refuses two
    ranks on one GPU), so eagerly; ``scripts/tensor_parallel_cards.py`` one NCCL
    process a card, graphed, and with ``eager_too`` each rank also runs both
    updates with ``eager=True``, held to the graphed ones
    (``graphed_against_eager``). ``cfgs``: ``tp_configs()`` unless given. Returns
    each rank's launches (of the graphed updates), both updates summed."""
    devices = [str(dev)] * world if devices is None else devices
    cfgs = tp_configs() if cfgs is None else cfgs
    one = tp_runs(cfgs, dev)
    control, bound = {}, {}
    for name, cfg in cfgs.items():
        nudged = tp_trainer(name, cfg, dev)
        with torch.no_grad():
            for p in nudged.runner.train.model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
        dp_train(nudged, 1)
        control[name] = max_abs([p.detach().cpu()
                                 for p in nudged.runner.train.model.parameters()],
                                one[name]["params"])
        bound[name] = max(TP_ATOL, TP_CONTROL_FACTOR * control[name])
        del nudged
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = run_rank_processes(tp_rank, world, backend,
                               lambda r: (cfgs, devices[r], eager_too), 400)
    for name in ("single", "selfplay"):
        m1 = one[name]["metrics"][0]
        print(f"tensor parallel, one process unsharded ({name}): "
              f"{ms_line(one[name]['wall'])} ms/update; minibatches_applied "
              f"{m1['minibatches_applied']:.0f}, episodes {m1['episodes']:.0f}, "
              f"mean_ep_return {m1['mean_ep_return']:.4f}; from params one ulp up its "
              f"params end {control[name]:.3e} apart at most (bound {bound[name]:.3e})")
    obs_dim = senv.RacingConfig(num_sensors=11).obs_dim
    want_shapes = [(obs_dim, TP_HIDDEN[0] // TP_MODEL), (TP_HIDDEN[0] // TP_MODEL,),
                   (TP_HIDDEN[0] // TP_MODEL, TP_HIDDEN[1]), (TP_HIDDEN[1],)]
    graphed = backend == "nccl" and dev.type == "cuda"
    for r, ranked in enumerate(ranks):
        got = ranked["default"]
        shape, data_index, model_index, group_backend = ranked["mesh"]
        if shape != {"data": world // TP_MODEL, "model": TP_MODEL} or \
                (data_index, model_index) != (r // TP_MODEL, r % TP_MODEL) or \
                group_backend != backend:
            raise AssertionError(f"rank {r}: mesh {ranked['mesh']}")
        for name in ("single", "selfplay"):
            g, o = got[name], one[name]
            m, m1 = g["metrics"][0], o["metrics"][0]
            absd = max_abs(g["params"], o["params"])
            eager = "" if "eager" not in ranked else \
                f"; eager=True {ms_line(ranked['eager'][name]['wall'])} ms/update"
            print(f"tensor parallel, rank {r} of {world} ({backend} on {devices[r]}, data "
                  f"{data_index} x model {model_index}, {name}, "
                  f"{'graphed' if g['graphed'] else 'eager'}): {ms_line(g['wall'])} "
                  f"ms/update{eager}; actor[0].w {g['shapes'][0][0]}, actor[1].w "
                  f"{g['shapes'][0][2]}; minibatches_applied {m['minibatches_applied']:.0f}, "
                  f"episodes {m['episodes']:.0f}, mean_ep_return {m['mean_ep_return']:.4f}; "
                  f"gathered params max abs {absd:.3e} from one process's (bound "
                  f"{bound[name]:.3e}; the one-ulp control {control[name]:.3e}); launches "
                  f"{g['launches']}")
            params, mu, nu = g["shapes"]
            if name == "single" and (params[:4] != want_shapes or mu != params or
                                     nu != params):
                raise AssertionError(f"rank {r}: local shapes {g['shapes']}")
            if m["minibatches_applied"] != m1["minibatches_applied"]:
                raise AssertionError(f"rank {r} ({name}) applied {m['minibatches_applied']} "
                                     f"minibatches, one process {m1['minibatches_applied']}")
            if absd > bound[name]:
                raise AssertionError(f"rank {r} ({name}): params {absd:.3e} from one "
                                     f"process's, beyond {bound[name]:.3e}")
            want = tp_expected(cfgs[name], g["launches"]) if name == "single" else \
                dp_expected(cfgs[name], 1, g["launches"], towers=False)
            if g["launches"] != want or g["graphed"] != graphed:
                raise AssertionError(f"rank {r} ({name}) launches {g['launches']}, "
                                     f"expected {want}; graphed {g['graphed']}")
            if eager_too:
                e = ranked["eager"][name]
                if e["launches"] != want or e["graphed"]:
                    raise AssertionError(f"rank {r} ({name}, eager=True) launches "
                                         f"{e['launches']}, graphed {e['graphed']}")
                graphed_against_eager(f"tensor parallel, rank {r} ({name})", g, e,
                                      control[name])
        slot, full = got["selfplay"]["slot"], got["selfplay"]["params"]
        if [t.shape for t in slot] != [t.shape for t in full] or \
                not all(torch.equal(a, b) for a, b in zip(slot, full)):
            raise AssertionError(f"rank {r}: the pool snapshot is not the whole params")
        snap = max_abs(slot, one["selfplay"]["slot"])
        if snap > bound["selfplay"]:
            raise AssertionError(f"rank {r}: the snapshot is {snap:.3e} from one process's")
    for mode in ("default", "eager") if eager_too else ("default",):
        for name in ("single", "selfplay"):
            if not all(torch.equal(a, b) for got in ranks[1:] for a, b in
                       zip(ranks[0][mode][name]["params"], got[mode][name]["params"])):
                raise AssertionError(f"the ranks gather different parameters ({name}, "
                                     f"{mode})")
    print(f"tensor parallel, {world} ranks ({backend}): slices of the towers and their "
          f"Adam moments as param_shardings splits them, minibatches_applied equal, the "
          f"gathered params within max({TP_ATOL:g}, {TP_CONTROL_FACTOR} x the one-ulp "
          f"control) of one process's and bitwise equal on every rank, the self-play "
          f"snapshot the whole params, on {card}")
    return [{k: got["default"]["single"]["launches"][k]
             + got["default"]["selfplay"]["launches"][k] for k in COUNTERS} for got in ranks]



# ------------------------------------------------ phase (k): graph against eager

GRAPH_UPDATES = 3
# a captured minibatch step with no group holds at most this many kernel nodes: the
# rows' index_select, the MLP forward, the loss head, the loss's unit gradient, the
# head's backward, the MLP backward and reduce, the tail (8) and room for two
MINIBATCH_KERNEL_NODES = 10
# the last update of each run: a reset of every env (the stale-observation rebuild)
# and a target low enough that it takes the KL exit
GRAPH_KL_TARGET = 0.002


def graph_configs():
    """Phase k's configs at ``train scale``'s width: single-car PPO at 4096 x 256
    and phase 10's self-play (2 cars, opponents per env, ``snapshot_freq`` 1)."""
    return {
        "single-car": base_config(num_envs=NUM_ENVS, num_steps=STEPS,
                                  total_timesteps=NUM_ENVS * STEPS * 100),
        "self-play": self_play_config(num_envs=NUM_ENVS, num_steps=STEPS,
                                      total_timesteps=1_000_000_000, opponent_per_env=True,
                                      reset_envs_each_update=False, snapshot_freq=1),
    }


@contextlib.contextmanager
def rollout_clock():
    """Times each rollout of an update inside the block, graphed
    (``UpdateGraphs.rollout_phase``) or eager (``ppo.rollout_phase``): the host
    seconds of the call (what the host spends issuing it; nothing inside it waits
    for the card) and the device seconds between CUDA events recorded around it.
    Yields the list of (host, device) seconds."""
    originals = (ppo.rollout_phase, ppo.UpdateGraphs.rollout_phase)
    records = []

    def clocked(fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t = time.perf_counter()
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            host = time.perf_counter() - t
            torch.cuda.synchronize()
            records.append((host, start.elapsed_time(end) / 1e3))
            return out
        return timed

    ppo.rollout_phase = clocked(originals[0])
    ppo.UpdateGraphs.rollout_phase = clocked(originals[1])
    try:
        yield records
    finally:
        ppo.rollout_phase, ppo.UpdateGraphs.rollout_phase = originals


@contextlib.contextmanager
def replays_without_sync():
    """Every CUDA-graph replay inside the block runs under
    ``torch.cuda.set_sync_debug_mode("error")``, so a call inside a replay that
    synchronizes with the card raises. Yields a list whose one entry counts the
    replays."""
    replay = _graph.CapturedStep.replay
    count = [0]

    def checked(self, times=1):
        torch.cuda.set_sync_debug_mode("error")
        try:
            replay(self, times)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        count[0] += times

    _graph.CapturedStep.replay = checked
    try:
        yield count
    finally:
        _graph.CapturedStep.replay = replay


@contextlib.contextmanager
def kept_graphs():
    """Inside the block the CUDA graphs PyTorch captures keep their graph
    (``keep_graph=True``; still instantiated at the end of the capture, as by
    default), so that ``graph_nodes`` can count a captured step's nodes."""
    real = torch.cuda.CUDAGraph

    class Kept(real):
        def __init__(self, keep_graph=False):
            super().__init__(True)

        def capture_end(self):
            super().capture_end()
            self.instantiate()

    torch.cuda.CUDAGraph = Kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = real


def graph_nodes(graph) -> dict:
    """The nodes of a CUDA graph captured under ``kept_graphs``, counted from the graph
    itself (the driver's ``cuGraphGetNodes`` and ``cuGraphNodeGetType``): its kernel
    nodes, its copy and set nodes (memcpy, memset) and any others."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    handle = graph.raw_cuda_graph()
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kinds = collections.Counter()
    kind = ctypes.c_int(-1)
    for node in nodes:
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        kinds[kind.value] += 1
    # CUgraphNodeType: 0 kernel, 1 memcpy, 2 memset
    return {"kernel_nodes": kinds.pop(0, 0), "copy_nodes": kinds.pop(1, 0) + kinds.pop(2, 0),
            "other_nodes": sum(kinds.values())}


class _KernelNodeParams(ctypes.Structure):
    """``CUDA_KERNEL_NODE_PARAMS_v2`` (cuda.h)."""
    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("shared_bytes", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def kernel_node_names(graph) -> dict:
    """The kernel nodes of a CUDA graph captured under ``kept_graphs``, counted by the
    name of the kernel each launches (``cuGraphKernelNodeGetParams``, then
    ``cuFuncGetName`` or ``cuKernelGetName``), demangled by ``c++filt`` where the
    machine has it and cut at 100 characters; "?" where neither call names it."""
    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphKernelNodeGetParams_v2.argtypes = [ctypes.c_void_p,
                                                   ctypes.POINTER(_KernelNodeParams)]
    handle = graph.raw_cuda_graph()
    count = ctypes.c_size_t(0)
    if cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * count.value)()
    if cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    getters = [(field, getattr(cuda, fn)) for field, fn in (("func", "cuFuncGetName"),
                                                            ("kern", "cuKernelGetName"))
               if hasattr(cuda, fn)]
    for _, fn in getters:
        fn.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_void_p]
    mangled = []
    kind = ctypes.c_int(-1)
    for node in nodes:
        if cuda.cuGraphNodeGetType(node, ctypes.byref(kind)) != 0 or kind.value != 0:
            continue
        p = _KernelNodeParams()
        name = "?"
        if cuda.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(p)) == 0:
            for field, fn in getters:
                out = ctypes.c_char_p()
                if getattr(p, field) and fn(ctypes.byref(out), getattr(p, field)) == 0 \
                        and out.value:
                    name = out.value.decode()
                    break
        mangled.append(name)
    try:
        plain = subprocess.run(["c++filt"], input="\n".join(mangled), capture_output=True,
                               text=True, check=True, timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = mangled
    if len(plain) != len(mangled):
        plain = mangled
    return dict(collections.Counter(n.removeprefix("void ")[:100] for n in plain))


def replay_nodes(graph) -> dict:
    """A captured step (``graph``, captured under ``kept_graphs``): its nodes by type
    from the graph itself (``graph_nodes``), then one replay under the profiler: the
    kernels it recorded (``profiled_kernels``) and their summed time (us). The
    profiler can drop a replay's events, and it also records what the replay launches
    outside the graph (with a registered generator, PyTorch's two fills of its seed
    and offset before the graph), so the nodes are not counted from it."""
    out = graph_nodes(graph)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
    out.update(profiled_kernels=0, kernel_us=0.0)
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and "memcpy" not in evt.name.lower() and "memset" not in evt.name.lower()):
            out["profiled_kernels"] += 1
            out["kernel_us"] += evt.time_range.elapsed_us()
    return out


def profiled(nodes) -> str:
    """What the profiler saw of ``replay_nodes``' replay, as the phases print it."""
    return (f"{nodes['kernel_us']:.1f} us over the {nodes['profiled_kernels']} kernels the "
            f"profiler recorded")


def minibatch_step_nodes(graph) -> dict:
    """``replay_nodes`` of a captured minibatch step (``ppo.UpdateGraphs.minibatch_graph``)
    with the loop's exit flag set, so that it moves no parameter or moment (the
    warm-ups' mask), and the kernel nodes by name of the step and of its moments
    graph (``kernel_node_names``). The loop's carry is reset after it."""
    graph.loop.reset()
    graph.loop.stop.fill_(True)
    out = replay_nodes(graph.step.graph)
    graph.loop.reset()
    out["kernels"] = kernel_node_names(graph.step.graph)
    out["moments_kernels"] = kernel_node_names(graph.moments_step.graph)
    return out


def graph_run(kind, cfg, pool, layout, eager, card):
    """One phase-k trainer on ``layout(pool)``: a warm-up update (the graphs'
    first capture), ``GRAPH_UPDATES`` timed updates, one on a resampled pool
    (``set_track`` to train scale's procgen pool, which the graphs are captured
    again for), and one with ``reset_envs_each_update`` and ``GRAPH_KL_TARGET``
    (a new update step). Returns what phase k compares and prints."""
    base = memory_window()
    t0 = time.perf_counter()
    if kind == "self-play":
        trainer = SelfPlayTrainer(cfg, menv.MultiRacingConfig(num_agents=NUM_AGENTS,
                                                              num_sensors=11),
                                  layout(pool), eager=eager)
    else:
        trainer = PPOTrainer(cfg, senv.RacingConfig(num_sensors=11), layout(pool),
                             eager=eager)
    metrics = []
    trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    graphs = trainer.update_step.graphs
    captures = [0.0 if graphs is None else graphs.capture_seconds]
    walls, launches, labels = [], [], []
    n = GRAPH_UPDATES + 2
    sync_check = contextlib.nullcontext([0]) if eager else replays_without_sync()
    first = []
    with rollout_clock() as rollouts, minibatch_loops(n, first=first) as loops, \
            sync_check as replays:
        for u in range(n):
            label = "timed"
            if u == GRAPH_UPDATES:
                trainer.set_track(layout(ttrain.procgen_pool(cfg.seed, u, NUM_TRACKS,
                                                             device=pool.wp_x.device)))
                label = "resampled pool (set_track)"
            elif u == GRAPH_UPDATES + 1:
                trainer.cfg = dataclasses.replace(trainer.cfg, reset_envs_each_update=True,
                                                  kl_target=GRAPH_KL_TARGET)
                trainer.update_step = ppo.make_update_step(trainer.cfg, trainer.hooks, 2,
                                                           eager=eager)
                label = f"reset_envs_each_update, kl_target {GRAPH_KL_TARGET}"
            graphs = trainer.update_step.graphs
            c0 = 0.0 if graphs is None or u == GRAPH_UPDATES + 1 else graphs.capture_seconds
            zero_counts()
            t = time.perf_counter()
            trainer.train(num_updates=1, on_update=lambda tr, m: metrics.append(m))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            launches.append(read_counts())
            labels.append(label)
            captures.append(0.0 if graphs is None else graphs.capture_seconds - c0)
    peak = torch.cuda.max_memory_allocated() - base
    graphs = trainer.update_step.graphs
    held = None if graphs is None else graphs.memory()
    params, mu, nu = trainer.full_state()
    state = [t.detach().cpu() for t in params + mu + nu] + [
        trainer.runner.obs.cpu(), trainer.runner.done.cpu()]
    nodes = None if graphs is None else minibatch_step_nodes(graphs.minibatch_graph)
    first_minibatches_exact(first, f"phase k {kind} {'eager' if eager else 'graphed'}")
    return {"metrics": metrics, "walls": walls, "rollouts": rollouts, "loops": loops,
            "launches": launches, "labels": labels, "captures": captures, "warm": warm,
            "peak": peak, "base": base, "held": held, "replays": replays[0], "state": state,
            "count": trainer.runner.train.opt_state.count, "steps": cfg.num_steps,
            "minibatch_nodes": nodes}


def graph_against_eager(pool, card):
    """Phase k: ``graph_run`` graphed and eager for single-car and self-play
    training on the canonical pool gathered and tiled. Every metric of every
    update (the seeded numbers the other phases print among them), the final
    parameters, Adam moments and count, observations and done flags, and every
    update's launch counts must be bitwise equal, each run must take the KL exit
    at least once, and no replay may synchronize. Returns the launch counts of the
    graphed self-play run on the tiled pool's timed updates."""
    layouts = {
        "gathered": lambda p: trk.gather_tracks(p, np.arange(NUM_ENVS) % p.num_tracks),
        "tiled": lambda p: trk.tiled_pooled_tracks(p, NUM_ENVS),
    }
    out = None
    for kind, cfg in graph_configs().items():
        for where, layout in layouts.items():
            runs = {}
            for mode in ("graphed", "eager"):
                r = runs[mode] = graph_run(kind, cfg, pool, layout, mode == "eager", card)
                what = f"phase k {kind} {where} {mode}"
                for i, label in enumerate(r["labels"]):
                    (host, device), (loop, computed) = r["rollouts"][i], r["loops"][i]
                    m = r["metrics"][i + 1]
                    print(f"{what} update {i + 1} ({label}): {r['walls'][i] * 1e3:.1f} ms; "
                          f"rollout {device * 1e3:.1f} ms on the card, host "
                          f"{host / r['steps'] * 1e3:.4f} ms a step, device "
                          f"{device / r['steps'] * 1e3:.4f} ms a step (CUDA events); "
                          f"GAE + permutations + host "
                          f"{(r['walls'][i] - loop - device) * 1e3:.1f} ms; minibatch loop "
                          f"{loop * 1e3:.1f} ms, {computed} minibatches, "
                          f"{loop / computed * 1e3:.3f} ms each; capture "
                          f"{r['captures'][i + 1]:.3f} s; minibatches_applied "
                          f"{m['minibatches_applied']:.0f}, kl_stopped {m['kl_stopped']:.0f}, "
                          f"approx_kl {m['approx_kl']:.5f}, mean_ep_return "
                          f"{m['mean_ep_return']:.2f} over {m['episodes']:.0f} episodes")
                held = "" if r["held"] is None else (
                    f" (the last update's graphs own {r['held']['static_bytes'] / 2**20:,.1f} "
                    f"MiB of buffers and reserved {r['held']['pool_bytes'] / 2**20:,.1f} MiB "
                    f"for their private pools)")
                if r["minibatch_nodes"] is not None:
                    mb = r["minibatch_nodes"]
                    print(f"{what}: one replay of the captured minibatch step (masked): "
                          f"{mb['kernel_nodes']} kernel nodes, {mb['copy_nodes']} copy and "
                          f"set nodes (counted from the graph), the kernels {profiled(mb)} "
                          f"on {card}; its kernel nodes {mb['kernels']}; the moments "
                          f"graph's {mb['moments_kernels']}")
                    if mb["kernel_nodes"] > MINIBATCH_KERNEL_NODES:
                        raise AssertionError(f"{what}: {mb['kernel_nodes']} kernel nodes in a "
                                             f"minibatch step, over {MINIBATCH_KERNEL_NODES}")
                print(f"{what}: trainer and warm-up update {r['warm']:.1f} s (capture "
                      f"{r['captures'][0]:.3f} s); timed median "
                      f"{statistics.median(r['walls'][:GRAPH_UPDATES]) * 1e3:.1f} ms/update; "
                      f"peak memory {r['peak'] / 2**20:,.1f} MiB over the "
                      f"{r['base'] / 2**20:,.1f} MiB allocated before{held}; {r['replays']} "
                      f"replays without a sync; launches {r['launches'][0]} on {card}")
            g, e = runs["graphed"], runs["eager"]
            what = f"phase k {kind} {where}"
            for i, (a, b) in enumerate(zip(g["metrics"], e["metrics"])):
                if a.keys() != b.keys() or not all(
                        np.array_equal(a[k], b[k], equal_nan=True) for k in a):
                    raise AssertionError(f"{what}: update {i} metrics graphed {a} != eager {b}")
            if g["launches"] != e["launches"]:
                raise AssertionError(f"{what}: launches graphed {g['launches']} != eager "
                                     f"{e['launches']}")
            if g["count"] != e["count"] or not all(
                    torch.equal(a, b) for a, b in zip(g["state"], e["state"])):
                raise AssertionError(f"{what}: the final parameters, Adam state or "
                                     "observations differ graphed against eager")
            if not any(m["kl_stopped"] for m in g["metrics"]):
                raise AssertionError(f"{what}: no update took the KL exit")
            if g["replays"] < (GRAPH_UPDATES + 2) * cfg.num_steps:
                raise AssertionError(f"{what}: {g['replays']} replays checked")
            sensing, stepping = (("multi_observe", "multi_transition") if kind == "self-play"
                                 else ("single_observe", "single_transition"))
            expected = counts(cfg.num_envs, autoreset=True, tiled=where == "tiled",
                              **{sensing: STEPS, stepping: STEPS, "compute_gae": 1,
                                 "mixbits_permutation": 1},
                              **policy(STEPS, selfplay=kind == "self-play"))
            if where == "tiled":
                expected.update({f"{sensing}_row_ids": STEPS, f"{stepping}_row_ids": STEPS})
            if any(c != {**expected, **learner(c, cfg, 1)}
                   for c in g["launches"][:GRAPH_UPDATES]):
                raise AssertionError(f"{what}: launches {g['launches']}, expected {expected}")
            print(f"{what}: graphed = eager bitwise over {len(g['metrics'])} updates (metrics, "
                  f"parameters, Adam moments and count {g['count']}, observations, launches); "
                  f"timed median {statistics.median(g['walls'][:GRAPH_UPDATES]) * 1e3:.1f} "
                  f"ms/update graphed, {statistics.median(e['walls'][:GRAPH_UPDATES]) * 1e3:.1f} "
                  f"eager; peak memory {g['peak'] / 2**20:,.1f} MiB graphed, "
                  f"{e['peak'] / 2**20:,.1f} eager")
            if kind == "self-play" and where == "tiled":
                out = {k: sum(c[k] for c in g["launches"][:GRAPH_UPDATES]) for k in COUNTERS}
    return out


# ------------------------------------- phase (l): the loops as device programs


@contextlib.contextmanager
def eager_loops():
    """Inside the block the evaluation, match and recorder loops run eagerly
    (``utils/metrics.py``'s loops with ``eager=True``): the reference the graphed
    loops are held to."""
    real = (metrics._rollout_single_acc, metrics._rollout_multi_acc)
    metrics._rollout_single_acc = functools.partial(real[0], eager=True)
    metrics._rollout_multi_acc = functools.partial(real[1], eager=True)
    try:
        yield
    finally:
        metrics._rollout_single_acc, metrics._rollout_multi_acc = real


@contextlib.contextmanager
def loop_clock():
    """Times every loop run inside the block (``metrics._run_loop``): the host
    seconds of the call, ending in a synchronize, the device seconds between CUDA
    events recorded around it, each less the seconds of a capture made inside the
    call, and the steps its chunk loop (``metrics._drive``) ran. Yields a dict of
    their sums and the number of loops."""
    run, drive = metrics._run_loop, metrics._drive
    total = {"host": 0.0, "device": 0.0, "steps": 0, "loops": 0}

    def driven(*args, **kwargs):
        steps = drive(*args, **kwargs)
        total["steps"] += steps
        return steps

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        captured = metrics.loop_graphs.capture_seconds
        t = time.perf_counter()
        start.record()
        out = run(*args, **kwargs)
        end.record()
        torch.cuda.synchronize()
        captured = metrics.loop_graphs.capture_seconds - captured
        total["host"] += time.perf_counter() - t - captured
        total["device"] += start.elapsed_time(end) / 1e3 - captured
        total["loops"] += 1
        return out

    metrics._run_loop, metrics._drive = timed, driven
    try:
        yield total
    finally:
        metrics._run_loop, metrics._drive = run, drive


def loop_run(fn, graphed: bool):
    """``fn()`` graphed (every replay under ``set_sync_debug_mode("error")``, the
    loop graphs' cache emptied first, so that the run's captures are counted) or
    inside ``eager_loops``. Returns its result, wall seconds, launch counts, the
    loop clock's sums, the captures, capture seconds and checked replays, and the
    memory the run's loop graphs hold (``LoopGraphs.memory``)."""
    graphs = metrics.loop_graphs
    if graphed:
        graphs.clear()
    captures, capture_s = graphs.captures, graphs.capture_seconds
    checks = replays_without_sync() if graphed else contextlib.nullcontext([0])
    with (contextlib.nullcontext() if graphed else eager_loops()), checks as replays, \
            loop_clock() as clock:
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    return {"out": out, "wall": wall, "launches": launches, "clock": clock,
            "captures": graphs.captures - captures,
            "capture_s": graphs.capture_seconds - capture_s, "replays": replays[0],
            "memory": graphs.memory()}


def loop_line(what, g, e, card) -> str:
    cg, ce = g["clock"], e["clock"]
    return (f"{what}: graphed {g['wall']:.3f} s against eager {e['wall']:.3f} s on {card} "
            f"({cg['loops']} loops, {cg['steps']} steps); a step graphed "
            f"{cg['host'] / cg['steps'] * 1e3:.4f} ms host, "
            f"{cg['device'] / cg['steps'] * 1e3:.4f} ms device (CUDA events), eager "
            f"{ce['host'] / ce['steps'] * 1e3:.4f} ms host, "
            f"{ce['device'] / ce['steps'] * 1e3:.4f} ms device (both less the captures); "
            f"{g['captures']} captures in {g['capture_s']:.3f} s, the graphs' buffers "
            f"{g['memory']['static_bytes'] / 2**20:,.2f} MiB and private pools "
            f"{g['memory']['pool_bytes'] / 2**20:,.2f} MiB (pool_bytes); {g['replays']} "
            f"replays without a sync; launches {({k: v for k, v in g['launches'].items() if v})}")


def loops_graphed(dev, card):
    """Phase l: the evaluation, match and recorder loops graphed against
    ``eager=True``: the 40 x 5 evaluations (single car and two cars, sampled, seed
    42), the round robin of ``TOURNAMENT_MODELS`` at the CLI's defaults and the
    three recorders on the held-out track, each bitwise, with equal launch counts,
    no replay syncing and one capture for the round robin's 12 matches. Returns
    the launch counts of the graphed runs, summed."""
    total = {k: 0 for k in COUNTERS}

    def held(what, fn, same):
        g, e = loop_run(fn, True), loop_run(fn, False)
        if not same(g["out"], e["out"]):
            raise AssertionError(f"phase l {what}: graphed differs from eager")
        if g["launches"] != e["launches"]:
            raise AssertionError(f"phase l {what}: launches graphed {g['launches']} != "
                                 f"eager {e['launches']}")
        if g["replays"] == 0 or g["clock"]["steps"] != e["clock"]["steps"]:
            raise AssertionError(f"phase l {what}: {g['replays']} replays, steps graphed "
                                 f"{g['clock']['steps']}, eager {e['clock']['steps']}")
        for k, v in g["launches"].items():
            total[k] += v
        print(loop_line(f"phase l {what}", g, e, card))
        return g, e

    grid = metrics.build_eval_grid(40, 5, 42, device=dev)
    for what, fn, path in (("eval 40 x 5", evaluate.evaluate_single_agent_overall, MODEL),
                           ("eval --multi 40 x 5, 2 cars", evaluate.evaluate_multi_agent_overall,
                            MULTI_MODEL)):
        g, _ = held(what, lambda: fn(grid, path, seed=42),
                    lambda a, b: a["all_episodes"] == b["all_episodes"] and a == b)
        res = g["out"]
        print(f"phase l {what} (sampled, seed 42): every per-episode field of the 200 "
              f"episodes equal graphed and eager; success_rate={res['success_rate']:.3f} "
              f"avg_steps={res['avg_steps']:.2f}")

    g, _ = held("round robin", lambda: tournament.run_tournament(TOURNAMENT_MODELS, device=dev),
                lambda a, b: (a["wins"], a["draws"], a["elo"]) == (b["wins"], b["draws"],
                                                                   b["elo"]))
    if g["captures"] != 1:
        raise AssertionError(f"phase l round robin: {g['captures']} captures for its 12 "
                             f"matches, expected 1")
    print(f"phase l round robin: wins, draws and Elo equal graphed and eager; the 12 matches "
          f"shared one capture ({g['capture_s']:.3f} s); ranking "
          f"{[row['name'] for row in g['out']['ranking']]}")

    _, track = render._held_out_track(123, 7.0, dev)
    mcfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)
    scfg = senv.RacingConfig(num_sensors=11)
    bundles = [load_policy_bundle(p, dev) for p in TOURNAMENT_MODELS[:2]]
    single = load_policy_bundle(MODEL, dev)
    multi = load_policy_bundle(MULTI_MODEL, dev)

    def gen():
        return torch.Generator(device=dev).manual_seed(0)

    def same_traj(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[k], b[k]) for k in a)

    for what, fn in (
            ("record_trajectory_single", lambda: viz.record_trajectory_single(
                *single[:2], scfg, track, gen(), obs_norm=single[2])),
            ("record_trajectory_multi", lambda: viz.record_trajectory_multi(
                *multi[:2], mcfg, track, gen(), obs_norm=multi[2])),
            ("record_trajectory_match", lambda: viz.record_trajectory_match(
                bundles, mcfg, track, gen()))):
        g, _ = held(what, fn, same_traj)
        print(f"phase l {what} on the held-out track: {len(g['out']['x'])} rows "
              f"{g['out']['x'].shape}, every array equal graphed and eager")
    return total


# ------------------------------------ phase (m): the multi-car env step as two kernels

# a config whose max_steps lets a car finish past step 4500, where the time bonus
# (300 - steps / 15) clamps at 0
CRAFTED_MAX_STEPS = 6000
# the car scenarios of crafted_state: (lap fraction of the car's waypoint,
# last_progress, cp25, cp50, cp75); None is drawn at random
SCENARIOS = {
    "finish": (0.02, 0.95, (True, True, True)),
    "lap wrap backwards": (0.97, 0.05, None),
    "cp25": (0.30, 0.29, (False, False, False)),
    "cp50": (0.55, 0.54, (True, False, False)),
    "cp75": (0.80, 0.79, (True, True, False)),
    "skipped checkpoint": (0.55, 0.54, (False, False, False)),
    "crash": (None, None, None),
    "crashed before": (None, None, None),
    "finished before": (None, None, (True, True, True)),
    "driving": (None, None, None),
}
# an env's row of cars by env index % 8: 1 truncates, 2 finishes car 0 past step
# 4500, 3 stacks every car on car 0 (touching pairs), 4 crashes every car before at
# one progress (exact score ties, which the higher seat wins)
ROW_TRUNCATES, ROW_LATE_FINISH, ROW_TOUCHING, ROW_TIES = 1, 2, 3, 4


def crafted_state(track, num_agents, max_steps, seed, dtype=torch.float32, device=None):
    """(state, action): a ``menv.MultiState`` on ``track`` (per-env rows or a
    layout) whose envs drive every branch of the transition's tail, and actions
    [N, A, 2] beyond the clip. Each car sits near a centreline waypoint in one of
    ``SCENARIOS`` (a crash: 3 m beyond the track's width), heading along the track
    at up to 35 m/s; rows by env index as the ``ROW_*`` constants say. Made with
    NumPy from ``seed``, so that the JAX package can be handed the same state."""
    rows = trk.resolve(track)
    wx, wy, nx, ny = (getattr(rows, f).detach().cpu().double().numpy()
                      for f in ("wp_x", "wp_y", "nrm_x", "nrm_y"))
    n_wp = rows.n_wp.cpu().numpy().astype(np.int64)
    width = rows.track_width.detach().cpu().double().numpy()
    n, a = n_wp.shape[0], num_agents
    rng = np.random.default_rng(seed)
    names = list(SCENARIOS)
    kind = rng.integers(0, len(names), (n, a))
    steps = rng.integers(0, min(3000, max_steps - 1), n)
    env = np.arange(n) % 8
    steps[env == ROW_TRUNCATES] = max_steps - 1
    steps[env == ROW_LATE_FINISH] = min(4600, max_steps - 1)
    kind[env == ROW_LATE_FINISH, 0] = names.index("finish")
    kind[env == ROW_TIES] = names.index("crashed before")
    frac = rng.uniform(0.0, 1.0, (n, a))
    lp = np.clip(frac - rng.uniform(0.0, 0.004, (n, a)), 0.0, None)
    cps = rng.random((n, a, 3)) < 0.5
    for i, name in enumerate(names):
        f, last, flags = SCENARIOS[name]
        sel = kind == i
        if f is not None:
            frac[sel], lp[sel] = f, last
        if flags is not None:
            cps[sel] = flags
    tie = env == ROW_TIES
    frac[tie] = frac[tie][:, :1]
    lp[tie] = frac[tie]
    crashed_before = kind == names.index("crashed before")
    lp[crashed_before] = frac[crashed_before]
    finished = kind == names.index("finished before")
    finished_step = np.where(finished, rng.integers(1, np.maximum(steps, 1) + 1)[:, None], 0)

    k = np.round(frac * n_wp[:, None]).astype(np.int64) % n_wp[:, None]
    r = np.arange(n)[:, None]
    nxt = (k + 1) % n_wp[:, None]
    heading = np.arctan2(wy[r, nxt] - wy[r, k], wx[r, nxt] - wx[r, k])
    heading = np.mod(heading + rng.normal(0.0, 0.2, (n, a)), 2 * np.pi)
    off = rng.uniform(-1.0, 1.0, (n, a))
    crash = kind == names.index("crash")
    off[crash] = np.sign(off[crash] + 1e-9) * np.broadcast_to(width[:, None] + 3.0, (n, a))[crash]
    x = wx[r, k] + nx[r, k] * off
    y = wy[r, k] + ny[r, k] * off
    speed = rng.uniform(0.0, 35.0, (n, a))
    vx = speed * np.cos(heading) + rng.normal(0.0, 1.0, (n, a))
    vy = speed * np.sin(heading) + rng.normal(0.0, 1.0, (n, a))
    touch = env == ROW_TOUCHING
    for j in range(1, a):
        x[touch, j] = x[touch, 0] + 0.7 * j
        y[touch, j] = y[touch, 0] - 0.4 * j
        heading[touch, j] = heading[touch, 0]

    def t(v, dt=dtype):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=dt, device=device)

    b, i32 = torch.bool, torch.int32
    state = menv.MultiState(
        x=t(x), y=t(y), angle=t(heading), vx=t(vx), vy=t(vy), progress=t(lp),
        crashed=t(crashed_before, b), finished=t(finished, b), steps=t(steps, i32),
        last_progress=t(lp), last_steering=t(rng.uniform(-1.0, 1.0, (n, a))),
        cp25=t(cps[..., 0], b), cp50=t(cps[..., 1], b), cp75=t(cps[..., 2], b),
        has_crashed=t(crashed_before, b), finished_step=t(finished_step, i32),
        placement=t(np.zeros((n, a)), i32))
    action = np.stack([rng.uniform(-1.3, 1.3, (n, a)), rng.uniform(-1.4, 1.4, (n, a))], -1)
    return state, t(action, torch.float32)


def crafted_single_state(track, max_steps, seed, dtype=torch.float32, device=None):
    """(state, action): ``crafted_state`` at one car a row as a ``senv.RacingState``
    and actions [N, 2] beyond the clip, whose envs drive every branch of the
    single-car transition's tail (with ``CRAFTED_MAX_STEPS`` a finish past step
    2000, where the time bonus, 200 - steps / 10, clamps at 0)."""
    state, action = crafted_state(track, 1, max_steps, seed, dtype, device)

    def one(t):
        return t[:, 0].contiguous()

    car = senv.CarState(**{f: one(getattr(state, f)) for f in
                           ("x", "y", "angle", "vx", "vy", "progress", "crashed", "finished")})
    return senv.RacingState(car=car, steps=state.steps, last_progress=one(state.last_progress),
                            last_steering=one(state.last_steering), cp25=one(state.cp25),
                            cp50=one(state.cp50), cp75=one(state.cp75)), one(action)


def single_tail_branches(state, out):
    """How many envs of one single-car transition took each branch of its tail."""
    new, _, terminated, truncated, info = out
    fin = new.car.finished & ~state.car.finished
    p, lp = new.car.progress, state.last_progress
    return {
        "finish": int(fin.sum()), "finish past step 2000": int((fin & (new.steps > 2000)).sum()),
        "lap wrap forwards": int(((lp > 0.9) & (p < 0.1)).sum()),
        "lap wrap backwards": int(((lp < 0.1) & (p > 0.9)).sum()),
        "cp25": int((new.cp25 & ~state.cp25).sum()),
        "cp50": int((new.cp50 & ~state.cp50).sum()),
        "cp75": int((new.cp75 & ~state.cp75).sum()),
        "skipped checkpoint": int((~state.cp25 & (p >= 0.5) & (p < 0.6) & ~new.cp50).sum()),
        "crash": int((new.car.crashed & ~state.car.crashed).sum()),
        "crashed before": int(state.car.crashed.sum()),
        "speed reward": int((~new.car.crashed & (info["progress_delta"] > 0)).sum()),
        "truncated": int(truncated.sum()), "terminated": int(terminated.sum()),
    }


def single_transition_fields(out) -> dict:
    """Every output of ``senv.transition``, by name."""
    state, reward, terminated, truncated, info = out
    fields = {f"car_{f.name}": getattr(state.car, f.name)
              for f in dataclasses.fields(state.car)}
    fields.update({f.name: getattr(state, f.name) for f in dataclasses.fields(state)
                   if f.name != "car"})
    fields.update(reward=reward, terminated=terminated, truncated=truncated,
                  **{f"info_{k}": v for k, v in info.items()})
    return fields


def tail_branches(state, out):
    """How many cars (or envs) of one transition took each branch of its tail."""
    new, _, terminated, truncated, _ = out
    fin = new.finished & ~state.finished
    late = new.steps[:, None].expand_as(fin) > 4500
    p, lp = new.progress, state.last_progress
    same = lambda f: (f == f[:, :1]).all(dim=-1)
    done = terminated | truncated
    return {
        "finish": int(fin.sum()), "finish past step 4500": int((fin & late).sum()),
        "lap wrap forwards": int(((lp > 0.9) & (p < 0.1)).sum()),
        "lap wrap backwards": int(((lp < 0.1) & (p > 0.9)).sum()),
        "cp25": int((new.cp25 & ~state.cp25).sum()),
        "cp50": int((new.cp50 & ~state.cp50).sum()),
        "cp75": int((new.cp75 & ~state.cp75).sum()),
        "skipped checkpoint": int((~state.cp25 & (p >= 0.5) & (p < 0.6) & ~new.cp50).sum()),
        "crash": int((new.has_crashed & ~state.has_crashed).sum()),
        "crashed before": int(state.has_crashed.sum()),
        "truncated": int(truncated.sum()), "terminated": int(terminated.sum()),
        "placed": int((new.placement > 0).sum()),
        "exact ties": int((done & same(new.progress) & same(new.crashed)
                           & same(new.finished) & same(new.finished_step)).sum())
        if new.x.shape[1] > 1 else 0,
    }


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two tensors hold the same bits: shape, dtype and every bit (-0.0 is
    not 0.0)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))
    return torch.equal(a, b)


def transition_fields(out) -> dict:
    """Every output of ``multi.transition``, by name."""
    state, reward, terminated, truncated, info = out
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    fields.update(reward=reward, terminated=terminated, truncated=truncated,
                  **{f"info_{k}": v for k, v in info.items()})
    return fields


def differing(got: dict, want: dict) -> dict:
    """The fields whose bits differ, with the number of elements that differ."""
    return {k: int((got[k] != want[k]).sum()) if got[k].shape == want[k].shape else -1
            for k in want if not same_bits(got[k], want[k])}


def env_step_bound(cfg, track, state, action, outs, obs, extra=(0, 0)):
    """The bounds of ``multi.transition`` and ``multi.observe`` on these inputs:
    each input read once (the distinct rows of a layout once) and each output
    written once over 3.35 TB/s, against the operations the data needs (K1's fold
    over each row's real segments, up to its last one of nonzero direction, and
    K3's car pass counted from the cars' places; K2's search over each row's real
    waypoints; K5 and K4's pair test) and the tails' (a few tens a car) over 67
    TFLOP/s; ``extra`` (bytes, operations) the transition's beside them."""
    rows, row_ids = trk.rows_of(track)
    used = (rows.wp_x.shape[0] if row_ids is None
            else int(torch.unique(row_ids).numel()))
    n, a = state.x.shape
    w, s, r = rows.wp_x.shape[-1], rows.seg_sx.shape[-1], cfg.num_sensors
    fields = [getattr(state, f.name) for f in dataclasses.fields(state)]
    per_env = trk.scalars_of(track)
    t_in = nbytes(*fields, action, per_env.n_wp, per_env.track_width) + used * w * 2 * 4 \
        + 8 * n * a * 4  # the rows' positions, the normals at the corners' winners
    real_wp = int(per_env.n_wp.clamp(0, w).sum())
    t_ops = a * 5 * real_wp * K2_OPS_PER_PAIR \
        + n * a * (K5_OPS_PER_CAR + TAIL_OPS_PER_CAR) + n * a * a * (4 * K4_OPS_PER_PAIR_AXIS + 2)
    transition = bound_ms(t_in + nbytes(*outs) + extra[0], t_ops + extra[1])
    cdx = state.x[:, None, :] - state.x[:, :, None]
    cdy = state.y[:, None, :] - state.y[:, :, None]
    seen = int((torch.sqrt(cdx * cdx + cdy * cdy) >= 0.5).sum()) * r
    o_in = nbytes(state.x, state.y, state.angle, state.vx, state.vy, state.last_steering,
                  per_env.max_track_distance) + used * s * 5 * 4
    seg_vx, seg_vy = geo.pool_rows(row_ids, rows.seg_vx, rows.seg_vy)
    real = (seg_vx != 0) | (seg_vy != 0)
    real_segs = int(torch.where(real, torch.arange(1, s + 1, device=real.device), 0)
                    .amax(dim=-1).sum())
    o_ops = (a * r * real_segs * K1_OPS_PER_PAIR + n * a * r * a * K3_OPS_PER_RAY_CAR
             + seen * 4 * K3_OPS_PER_RAY_EDGE + n * a * a * OBS_OPS_PER_PAIR)
    return transition, bound_ms(o_in + nbytes(obs), o_ops)


# per car, the transition's tail: the clip 5, progress and crash 3, delta 10, the
# reward's terms and sums 24, the checkpoints 12, the score 8
TAIL_OPS_PER_CAR = 62
# per ordered pair of a row's cars, the observation's columns: cos and sin 2, four
# rotated differences of 4 products and sums, 2 divisions, 4 clamps of 2
OBS_OPS_PER_PAIR = 32


def shape_model_observe(cfg, track, state):
    """``multi.observe_plain`` with the wall fold in the kernels' reduction shape,
    each run stopped at its row's real extent (``geo.raycast_walls_fold_shape``), in
    PyTorch on the tensors' device: the model the redesigned ``multi_observe`` is
    held to for its rays, bitwise."""
    real = (geo.raycast_walls_and_cars, geo.raycast_walls_plain)
    geo.raycast_walls_and_cars = geo.raycast_walls_and_cars_plain
    geo.raycast_walls_plain = functools.partial(geo.raycast_walls_fold_shape,
                                                stop_at_extent=True)
    try:
        return menv.observe_plain(cfg, track, state)
    finally:
        geo.raycast_walls_and_cars, geo.raycast_walls_plain = real


def kernel_registers(report: str, kernel_word: str) -> dict:
    """The registers ``-Xptxas -v`` gave each instantiation of a kernel (by mangled
    name) in an ``nvcc`` report (``_cuda.build_report``; empty where it was cached)."""
    regs, current = {}, None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            current = found.group(1)
        used = re.search(r"Used (\d+) registers", line)
        if used and current and kernel_word in current:
            regs[current] = int(used.group(1))
    return regs


def sass_loops(sass: str, kernel_word: str) -> list:
    """The innermost loops (backward branches with no other inside) of each function
    of ``cuobjdump -sass`` output whose name holds ``kernel_word``: [{"function",
    "instructions", "ops"}], ops the count of each opcode in the loop's body (from
    the branch's target to it)."""
    loops = []
    for block in sass.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel_word not in name:
            continue
        instrs = [(int(m.group(1), 16), m.group(2)) for m in
                  re.finditer(r"/\*([0-9a-f]{4,})\*/\s+([^;/]*?)\s*;", block)]
        spans = []
        for addr, ins in instrs:
            branch = re.search(r"\bBRA\b\S*\s+(?:`\()?0x([0-9a-f]+)", ins)
            if branch and int(branch.group(1), 16) < addr:
                spans.append((int(branch.group(1), 16), addr))
        for lo, hi in spans:
            if any(lo <= a < b <= hi and (a, b) != (lo, hi) for a, b in spans):
                continue
            ops = {}
            body = [b for a, b in instrs if lo <= a <= hi]
            for b in body:
                op = re.sub(r"^@!?U?P\w+\s+", "", b).split()[0].split(".")[0]
                ops[op] = ops.get(op, 0) + 1
            loops.append({"function": name, "ops": ops, "instructions": len(body)})
    return loops


def kernel_sass(library) -> str:
    """``cuobjdump -sass`` of a built library (default: this build of
    ``csrc/<library>.cu``)."""
    if not os.path.isabs(str(library)):
        library = _cuda._target(_cuda.CSRC_DIR / f"{library}.cu")
    cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(library)], check=True, capture_output=True,
                          text=True, timeout=300).stdout


def top_sm_clock_hz() -> float:
    return 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        check=True, capture_output=True, text=True, timeout=60).stdout.split()[0])


def inner_loop(loops: list, select_per_step: int, kernel_word: str):
    """(instructions a step, the loop) of the loop with the most FSEL among those
    of ``kernel_word``'s instantiations that multiply (the fold's and the search's;
    not the selects of a minimum over stored results), taking ``select_per_step``
    FSEL a step (two a ray-segment step of the fold, one a query-waypoint step of the
    search)."""
    mine = [lp for lp in loops if kernel_word in lp["function"] and lp["ops"].get("FMUL")]
    loop = max(mine, key=lambda lp: lp["ops"].get("FSEL", 0), default=None)
    if not loop or not loop["ops"].get("FSEL"):
        return None, loop
    return loop["instructions"] / (loop["ops"]["FSEL"] / select_per_step), loop


def observe_warp_steps(extents, length, groups, rows_per_block, threads) -> int:
    """Warp-steps of ``multi_observe``'s fold on env rows of these real extents:
    the block's (row, run, group) items a lane each, group fastest, every warp as
    long as its longest lane (``csrc/multi_observe.cu``)."""
    total = 0
    for b in range(0, len(extents), rows_per_block):
        lanes = [min(length, e - j * length) for e in extents[b:b + rows_per_block]
                 for j in range(-(-e // length)) for _ in range(groups)]
        for k in range(0, len(lanes), threads):
            chunk = lanes[k:k + threads]
            total += sum(max(chunk[w:w + 32]) for w in range(0, len(chunk), 32))
    return total


def env_step_issue_floors(track, cfg):
    """The issue floors of the env step's two launches on ``track`` at ``cfg``'s
    cars, by the kernels their plans pick for its env rows: the warp instructions
    of their inner loops that the rows need, at one instruction a cycle on each of
    132 SMs x 4 schedulers at the card's top SM clock, from this build's SASS. The
    redesigned fold's warp-steps are counted from each row's real extent and its
    search's 32-waypoint chunks over the real waypoints, a warp a car; the first
    kernels fold every run to the padded end and search every waypoint. Returns
    ({kernel: issue_floor_ms}, {kernel: instructions a step or None}, {kernel: (the
    library, the mangled-name fragment of the instantiation this launch runs)}),
    the kernels named as the kernels line names them."""
    rows, row_ids = trk.rows_of(track)
    per_env = trk.scalars_of(track)
    if row_ids is not None:
        ids = row_ids.long()
        seg_vx, seg_vy = rows.seg_vx.index_select(0, ids), rows.seg_vy.index_select(0, ids)
    else:
        seg_vx, seg_vy = rows.seg_vx, rows.seg_vy
    s, w = seg_vx.shape[-1], rows.wp_x.shape[-1]
    real = (seg_vx != 0) | (seg_vy != 0)
    extents = torch.where(real, torch.arange(1, s + 1, device=real.device), 0).amax(dim=-1)
    n, a = extents.numel(), cfg.num_agents
    plan = _cuda.multi_observe_plan(a, cfg.num_sensors, s, n)
    tplan = _cuda.multi_transition_plan(a, w, a > 1, n)
    groups = -(-a * cfg.num_sensors // plan.rays_per_lane)
    rate = 132 * 4 * top_sm_clock_hz()
    # the instantiations this launch runs, by their mangled names:
    # multi_observe_kernel<R, per_car, shared row>, multi_transition_kernel<pairs>, and
    # the first
    # kernels' raycast_walls_and_cars_kernel<R, kObs>, car_step_and_query_kernel<kPairs, kTail>
    if plan.small:
        observe = ("multi_observe_small", "raycast_walls_and_cars",
                   f"raycast_walls_and_cars_kernelILi{plan.rays_per_lane}ELb1E",
                   n * groups * -(-s // 32))
    else:
        observe = ("multi_observe", "multi_observe",
                   f"multi_observe_kernelILi{plan.rays_per_lane}ELb{int(plan.per_car)}ELb0E",
                   observe_warp_steps(extents.tolist(), -(-s // 32), groups,
                                      plan.rows_per_block, plan.threads))
    if tplan.small:
        transition = ("multi_transition_small", "car_step_and_query",
                      f"car_step_and_query_kernelILb{int(a > 1)}ELb1E", n * a * -(-w // 32))
    else:
        transition = ("multi_transition", "multi_transition",
                      f"multi_transition_kernelILb{int(a > 1)}E",
                      (-(-per_env.n_wp.clamp(0, w) // 32)).sum().item() * a)
    floors, per_step, words = {}, {}, {}
    for (name, library, word, steps), select in ((observe, 2 * plan.rays_per_lane),
                                                 (transition, 5)):
        per_step[name], _ = inner_loop(sass_loops(kernel_sass(library), word), select, word)
        words[name] = (library, word)
        if per_step[name]:
            floors[name] = steps * per_step[name] / rate * 1e3
    return floors, per_step, words


def check_env_step(pool, rng, dev):
    """Phase m.1: ``multi.transition`` and ``multi.observe``, one launch each on the
    card (the redesigned kernels, ``csrc/multi_transition.cu`` and
    ``csrc/multi_observe.cu``; on 48 envs the first ones, a block a row, which the
    env launches on few rows), against their plain versions (the narrow kernels'
    wrappers and PyTorch, what the env ran before) on ``crafted_state`` at 1, 2, 3
    and 8 cars over 4096 and 48 envs of the canonical pool, gathered and
    tiled, the sensing unclamped and clamped: every output bitwise; each branch of
    the tail taken (counts printed); the observation also bitwise its shape model
    (``shape_model_observe``). Then the redesigned kernels timed at 4096 x 2 cars on
    the tiled pool and the first ones at 48 x 2 gathered, eager (the wrapper's host
    work included) and in a CUDA graph, beside the plain versions, their bounds and
    their issue floors, with their registers. Returns the four kernels' entries."""
    widths = {envs: {"gathered": trk.gather_tracks(pool, np.arange(envs) % NUM_TRACKS),
                     "tiled": trk.tiled_pooled_tracks(pool, envs)}
              for envs in (NUM_ENVS, FEW_ENVS)}
    layouts = widths[NUM_ENVS]
    def counters():
        return (menv.transition_launches, menv.observe_launches,
                menv.transition_row_id_launches, menv.observe_row_id_launches,
                menv.transition_small_launches, menv.observe_small_launches)

    for a, (envs, where), clamp in itertools.product(
            (1, NUM_AGENTS, 3, 8), [(e, w) for e in widths for w in widths[e]], (False, True)):
        track = widths[envs][where]
        cfg = menv.MultiRacingConfig(num_agents=a, num_sensors=11,
                                     max_steps=CRAFTED_MAX_STEPS, clamp_sensor_range=clamp)
        state, action = crafted_state(track, a, cfg.max_steps, seed=a, device=dev)
        before = counters()
        out = menv.transition(cfg, track, state, action)
        obs = menv.observe(cfg, track, out[0])
        tiled = int(where == "tiled")
        step = (1, 1, tiled, tiled, int(envs < _cuda.TRANSITION_SMALL_BELOW),
                int(envs < _cuda.OBSERVE_SMALL_BELOW))
        if [c - b for c, b in zip(counters(), before)] != list(step):
            raise AssertionError(f"phase m.1 {a} cars x {envs} envs {where}: the kernels' "
                                 f"counters")
        plain = menv.transition_plain(cfg, track, state, action)
        plain_obs = menv.observe_plain(cfg, track, out[0])
        got, want = transition_fields(out), transition_fields(plain)
        bad = differing(got, want)
        if bad or not same_bits(obs, plain_obs):
            raise AssertionError(
                f"phase m.1 {a} cars x {envs} envs {where} clamp {clamp}: transition fields "
                f"{bad} and {int((obs != plain_obs).sum())} observation entries differ from "
                f"the plain versions")
        model = shape_model_observe(cfg, track, out[0])
        if not same_bits(obs, model):
            raise AssertionError(
                f"phase m.1 {a} cars x {envs} envs {where} clamp {clamp}: "
                f"{int((obs != model).sum())} observation entries differ from the fold's "
                f"shape model")
        del model
        branches = tail_branches(state, out)
        if a > 1 and envs == NUM_ENVS and where == "tiled" and not clamp:
            missing = [k for k, v in branches.items() if v == 0]
            if missing:
                raise AssertionError(f"phase m.1 {a} cars: no car took {missing}")
        kernels = ("the redesigned kernels" if not any(step[4:]) else
                   "the first kernels" if all(step[4:]) else "a first and a redesigned kernel")
        print(f"phase m.1 multi.transition + multi.observe ({kernels}), {a} cars x {envs} "
              f"envs {where}{', sensing clamped' if clamp else ''}: every output bitwise the "
              f"plain versions, the observation bitwise the fold's shape model; branches "
              f"{branches}")
    cfg = menv.MultiRacingConfig(num_agents=NUM_AGENTS, num_sensors=11)
    entries = []
    # the redesigned kernels at the self-play width, the first ones at a match's
    for track, what in ((layouts["tiled"], f"{NUM_ENVS} x {NUM_AGENTS} cars on the tiled pool"),
                        (widths[FEW_ENVS]["gathered"], f"{FEW_ENVS} x {NUM_AGENTS} cars gathered")):
        state, action = crafted_state(track, NUM_AGENTS, cfg.max_steps, seed=7, device=dev)
        out = menv.transition(cfg, track, state, action)
        obs = menv.observe(cfg, track, state)
        (t_bound, t_by), (o_bound, o_by) = env_step_bound(
            cfg, track, state, action, transition_fields(out).values(), obs)
        floors, per_step, words = env_step_issue_floors(track, cfg)
        o_name, t_name = (next(n for n in words if n.startswith(kernel))
                          for kernel in ("multi_observe", "multi_transition"))
        calls = {t_name: (lambda: menv.transition(cfg, track, state, action),
                          lambda: menv.transition_plain(cfg, track, state, action),
                          "self_play_racing_tpu/envs/multi.py:266", (t_bound, t_by)),
                 o_name: (lambda: menv.observe(cfg, track, state),
                          lambda: menv.observe_plain(cfg, track, state),
                          "self_play_racing_tpu/envs/multi.py:146", (o_bound, o_by))}
        for name, (fn, plain, replaces, (b_ms, b_by)) in calls.items():
            ms, g_ms = per_launch_ms(fn), graph_ms(fn)
            plain_ms, plain_g = per_launch_ms(plain, windows=5, launches=5), graph_ms(plain)
            library, word = words[name]
            regs = kernel_registers(_cuda.build_report.get(library, ""), word)
            floor = floors.get(name)
            print(f"phase m.1 {name} at {what}: {ms * 1e3:.1f} us eager back-to-back with "
                  f"the wrapper's host work ({g_ms * 1e3:.1f} us in a CUDA graph), bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), issue floor "
                  f"{'not measured' if floor is None else f'{floor * 1e3:.2f} us'} "
                  f"({per_step.get(name)} SASS instructions an inner-loop step); registers "
                  f"{regs or 'not measured (cached build)'}; the plain version (the narrow "
                  f"kernel and PyTorch, what the env ran before) {plain_ms * 1e3:.1f} us "
                  f"eager, {plain_g * 1e3:.1f} us in a CUDA graph")
            entries.append({"name": name, "route": "cuda",
                            "source": f"self_play_racing_tpu_torch/csrc/{library}.cu",
                            "replaces": replaces, "max_abs_err": 0.0, "ms": ms,
                            "graph_ms": g_ms, "plain_ms": plain_ms, "plain_graph_ms": plain_g,
                            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                            "issue_floor_ms": floor, "registers": regs,
                            "timed_at": what})
    return entries


def rollout_with(env_step, trainer, log_std, noise, gen_state, graphed, env=menv,
                 graphs=None):
    """One rollout of ``trainer`` (its runner, aux and hooks) on ``noise``, from the
    runner's generator at ``gen_state``, with ``env.transition`` and
    ``env.observe`` (the multi-car env's, or the single-car env's) as ``env_step``
    gives them ("kernel": the two launches; "plain": the plain versions, the narrow
    kernels and PyTorch, as the parent ran). Graphed (``ppo.UpdateGraphs``: new, or
    ``graphs`` run again) or eager. Returns (outputs, graphs)."""
    gen = trainer.runner.vec.generator
    real = (env.transition, env.observe)
    if env_step == "plain":
        env.transition, env.observe = env.transition_plain, env.observe_plain
    try:
        gen.set_state(gen_state)
        if graphed:
            graphs = graphs or ppo.UpdateGraphs()
            out = graphs.rollout_phase(trainer.cfg, trainer.hooks, trainer.runner,
                                       trainer.aux, log_std, noise)
        else:
            graphs = None
            out = ppo.rollout_phase(trainer.cfg, trainer.hooks, trainer.runner, trainer.aux,
                                    log_std, noise)
        torch.cuda.synchronize()
    finally:
        env.transition, env.observe = real
    vec, obs, done, _, traj, step_out = out
    leaves = {f"final {p}": t for p, t in _graph.tensor_leaves((vec, obs, done))}
    leaves.update({f"step {k}": v for k, v in step_out.items()})
    return {k: v.clone() for k, v in leaves.items()}, graphs


@contextlib.contextmanager
def both_env_steps(mismatches, env=menv, fields=transition_fields):
    """Inside the block ``env.transition`` and ``env.observe`` run the kernel and,
    on the same inputs, the plain version, and return the kernel's outputs;
    ``mismatches`` gains a device flag for each output (``fields``) whose bits
    differ."""
    real = (env.transition, env.observe)

    def transition(*args, **kwargs):
        got = real[0](*args, **kwargs)
        want = fields(env.transition_plain(*args, **kwargs))
        for k, v in fields(got).items():
            mismatches.append(same_bits_device(v, want[k]))
        return got

    def observe(cfg, track, state):
        got = real[1](cfg, track, state)
        mismatches.append(same_bits_device(got, env.observe_plain(cfg, track, state)))
        return got

    env.transition, env.observe = transition, observe
    try:
        yield mismatches
    finally:
        env.transition, env.observe = real


def same_bits_device(a, b) -> torch.Tensor:
    """A device flag: 1 where ``a`` and ``b`` differ in any bit, read later, so that
    the check does not wait on the card every step."""
    if a.is_floating_point():
        bits = {4: torch.int32, 8: torch.int64}[a.element_size()]
        a, b = a.contiguous().view(bits), b.contiguous().view(bits)
    return (a != b).any().to(torch.int32)


def rollout_step_profile(rollout, steps: int) -> dict:
    """A captured rollout step (``ppo.UpdateGraphs.rollout``, captured under
    ``kept_graphs``): its nodes and one replay under the profiler (``replay_nodes``),
    then ``steps`` replays between CUDA events (device ms a step). The graph's step
    counter is set back before each, so the replays stay inside its buffers.
    ``scripts/torch_step_profile.py`` keeps a copy, so that it runs on a checkout
    that predates this one."""
    rollout.carry.t.zero_()
    out = replay_nodes(rollout.step.graph)
    rollout.carry.t.zero_()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        rollout.step.graph.replay()
    end.record()
    end.synchronize()
    out["ms_per_step"] = start.elapsed_time(end) / steps
    return out


def selfplay_rollout_trainer(pool, dev):
    """Phase m.2's and r.2's self-play rollout: (trainer, log_std, noise, the vector
    env's generator state) of a ``SelfPlayTrainer`` at 4096 envs x 2 cars on the tiled
    canonical pool, the learner and every opponent ``SCALE_1B_MODEL`` (its
    parameters loaded, and its snapshot the pool's one member), opponents per env."""
    cfg = self_play_config(num_envs=NUM_ENVS, num_steps=STEPS, total_timesteps=1_000_000_000,
                           opponent_per_env=True, reset_envs_each_update=False,
                           snapshot_freq=1)
    env_cfg = menv.MultiRacingConfig(num_agents=NUM_AGENTS, num_sensors=11)
    trainer = SelfPlayTrainer(cfg, env_cfg, trk.tiled_pooled_tracks(pool, NUM_ENVS))
    agent, _ = interop.load_npz(SCALE_1B_MODEL, device=dev)
    with torch.no_grad():
        for p, q in zip(trainer.runner.train.model.parameters(), agent.parameters()):
            p.copy_(q)
        trainer.snapshot_agent()
        trainer.pool["log_std"][0].copy_(agent.log_std)
    trainer.select_opponent()
    log_std = agent.log_std.detach().clone()
    noise = net.sample_noise((STEPS, NUM_ENVS, 2), torch.Generator(device=dev).manual_seed(4),
                             device=dev)
    return trainer, log_std, noise, trainer.runner.vec.generator.get_state()


def env_step_rollout(pool, dev, card):
    """Phase m.2 and m.3: a 256-step self-play rollout at 4096 envs x 2 cars on the
    tiled canonical pool, the learner and every opponent ``SCALE_1B_MODEL`` (its
    parameters loaded into a ``SelfPlayTrainer``, and its snapshot the pool's one
    member): eagerly with every ``multi.transition`` and ``multi.observe`` call also
    run as its plain version on the same inputs (every output of every step
    bitwise); then graphed (``ppo.UpdateGraphs``, as the trainer runs it) with the
    two kernels and with the plain versions (the parent's composition): every
    step's buffers and the final state bitwise. Then the kernel nodes of one
    captured rollout step of each and its device time a step, and the kernel
    graph's gain. The vector steps take the composition route (the transition's
    plain mode and the autoreset in PyTorch; phase r holds the fused route). Returns
    the node counts."""
    trainer, log_std, noise, gen_state = selfplay_rollout_trainer(pool, dev)
    trainer.hooks = composed_hooks(trainer.hooks)

    flags = []
    t0 = time.perf_counter()
    with both_env_steps(flags):
        eager, _ = rollout_with("kernel", trainer, log_std, noise, gen_state, graphed=False)
    calls = len(flags)
    bad = int(torch.stack(flags).sum()) if flags else -1
    # a step: one transition (the state's fields, reward, the two flags, info's
    # eight entries) and one observe (the refresh of the merged state)
    if bad != 0 or calls != STEPS * (len(dataclasses.fields(menv.MultiState)) + 3 + 8 + 1):
        raise AssertionError(f"phase m.2: {bad} of {calls} outputs differ from the plain "
                             "versions over the eager rollout")
    print(f"phase m.2 eager rollout, {STEPS} steps x {NUM_ENVS} envs x {NUM_AGENTS} cars "
          f"({SCALE_1B_MODEL} learner and opponents, tiled pool): every output of every "
          f"multi.transition and multi.observe call ({calls} outputs) bitwise the plain "
          f"versions on the same inputs ({time.perf_counter() - t0:.1f} s); "
          f"{int(eager['step ep_mask'].sum())} episodes ended")
    runs = {}
    for env_step in ("kernel", "plain"):
        out, graphs = rollout_with(env_step, trainer, log_std, noise, gen_state, graphed=True)
        runs[env_step] = (out, graphs)
    (k_out, k_graphs), (p_out, p_graphs) = runs["kernel"], runs["plain"]
    for what, got in (("graphed plain", p_out), ("eager", eager)):
        bad = {k: int((k_out[k] != got[k]).sum()) for k in k_out if not same_bits(k_out[k], got[k])}
        if bad or k_out.keys() != got.keys():
            raise AssertionError(f"phase m.2: the graphed kernel rollout differs from the "
                                 f"{what} rollout in {bad}")
    print(f"phase m.2 graphed rollout ({STEPS} replays): the kernels' rollout bitwise the "
          f"graphed plain versions' and the eager rollout's, every step's {len(k_out)} "
          f"buffers and the final state")
    nodes = {}
    for env_step, graphs in (("kernel", k_graphs), ("plain", p_graphs), ("kernel", k_graphs),
                             ("plain", p_graphs)):
        nodes.setdefault(env_step, []).append(rollout_step_profile(graphs.rollout, STEPS))
    k_nodes = nodes["kernel"][0]["kernel_nodes"]
    p_nodes = nodes["plain"][0]["kernel_nodes"]
    print(f"phase m.3 one captured self-play rollout step (4096 x 2 cars, tiled) on {card}: "
          f"kernel nodes {k_nodes} with the two env kernels against {p_nodes} with the plain "
          f"versions (the parent's env step), copy nodes {nodes['kernel'][0]['copy_nodes']} "
          f"and {nodes['plain'][0]['copy_nodes']} (counted from the graphs); the kernels' "
          f"time in one replay {profiled(nodes['kernel'][0])} and "
          f"{profiled(nodes['plain'][0])}; "
          f"a step between CUDA events over {STEPS} replays, in turns kernel, plain, kernel, "
          f"plain: {[round(r['ms_per_step'], 4) for r in nodes['kernel']]} ms and "
          f"{[round(r['ms_per_step'], 4) for r in nodes['plain']]} ms")
    if p_nodes - k_nodes < 100:
        raise AssertionError(f"phase m.3: {k_nodes} kernel nodes a step against {p_nodes}; "
                             "expected at least 100 fewer")
    return nodes


# ------------------------------------ phase (n): the minibatch step's two kernels

# the minibatch of train scale's width (4096 x 256 / 16) and a four-card rank's part
MINIBATCH_ROWS = (65_536, 16_384)
HEAD_CLIP = 0.2  # base_config's clip_coef
# rows of crafted_minibatch, by i % 8: 0 ratio and value unclipped (pg1 == pg2), 1 the
# ratio clipped above, 2 below, 3 the advantage at the group's mean (normalized 0), 4
# the value clipped, 5 the value losses tied, 6 the value at its old value, 7 the
# value's clamp at its bounds
HEAD_ROW_KINDS = 8
# float32 operations a row: the head's forward (the log-prob 16, the ratio 3, the
# advantage 3, the surrogates 7, the value loss 10, the flag 3) and its backward (the
# maxima's two upstream gradients 4, the forward again, then 30); float64 operations
# a row: the forward's four sums, and the moments' add, deviation, square and add
HEAD_FORWARD_OPS = 42
HEAD_BACKWARD_OPS = 76
HEAD_SUM_OPS = 4
MOMENT_OPS = 4
# the tail's float32 operations an element: the clip 2, the moments 6, the step 6,
# the apply 2
TAIL_OPS = 16
# the loss's coefficients the head cases take: base_config's clip_coef, ent_coef and
# vf_coef
HEAD_COEFS = (HEAD_CLIP, 0.01, 0.5)
# the moments table's row a head case reads: the rows before it hold other moments
MOMENT_ROW = 2


def crafted_minibatch(n: int, rng, dtype=np.float32, clip: float = HEAD_CLIP,
                      boundaries: bool = True) -> dict:
    """An ``n``-row minibatch for the loss head (numpy arrays of ``dtype``) whose
    rows take every branch, by ``i % HEAD_ROW_KINDS`` (see there): the actor's
    ``mu`` [n, 2] and critic's ``v`` [n], the actions, old log-probs, advantages,
    returns and old values, ``log_std`` [2], and ``moments`` (mean, std) as a group
    hands them (kind 3 rows sit at the mean). ``boundaries``: kind 7 puts v - values
    at exactly -+clip (its float in ``dtype``), where PyTorch's clamp passes the
    gradient and JAX's clip halves it; else kind 7 rows are kind 0's."""
    kind = np.arange(n) % HEAD_ROW_KINDS
    log_std = np.array([-0.5, -0.9])
    mu = rng.uniform(-0.95, 0.95, (n, 2))
    actions = np.clip(mu + np.exp(log_std) * rng.normal(size=(n, 2)), -1.0, 1.0)
    lp = (-((actions - mu) ** 2) / (2 * np.exp(2 * log_std)) - log_std
          - 0.5 * np.log(2 * np.pi)).sum(-1)
    log_ratio = np.select([kind == 1, kind == 2],
                          [rng.uniform(0.3, 1.0, n), rng.uniform(-1.0, -0.3, n)],
                          rng.uniform(-0.1, 0.1, n))
    advantages = rng.normal(0.0, 2.0, n)
    mean, std = 0.5, float(np.std(advantages, ddof=1)) if n > 1 else 1.0
    advantages[kind == 3] = mean
    v = rng.uniform(-2.0, 2.0, n)
    sign = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    values = np.select([kind == 4, kind == 5, kind == 6],
                       [v + sign * rng.uniform(0.3, 1.0, n), np.full(n, 0.25), v],
                       v + rng.uniform(-0.15, 0.15, n))
    v[kind == 5] = 0.375  # v - values = 0.125: v_clip is v, the two losses tie
    if boundaries:
        edge = kind == 7
        values[edge] = 0.0
        v[edge] = sign[edge] * float(dtype(clip))
    returns = v + rng.normal(0.0, 1.0, n)
    cast = lambda a: np.asarray(a, dtype)
    return {"mu": cast(mu), "v": cast(v), "actions": cast(actions),
            "logprobs": cast(lp - log_ratio), "advantages": cast(advantages),
            "returns": cast(returns), "values": cast(values), "log_std": cast(log_std),
            "moments": (cast(mean), cast(std))}


def flat_moments(advantages: torch.Tensor):
    """(moments, at) for ``ppo._ppo_loss`` on one flat minibatch: its advantages [n]
    normalized by their own mean and unbiased std, as ``run_ppo_update`` forms them
    without a group (``ppo.advantage_moments`` of the rows as one unit), and row 0."""
    at = torch.zeros((1,), dtype=torch.int64, device=advantages.device)
    return mbops.advantage_moments(advantages.reshape(1, -1), at.reshape(1, 1)), at


def sum_bound(x: np.ndarray, torch_mean: float) -> tuple[float, float]:
    """(the float64 mean of the float32 rows ``x``, the distance a kernel's mean of
    them may lie from it): max(``mbops.SUM_REL_FLOOR`` x mean(|x|), ``mbops.SUM_CONTROL_FACTOR``
    x |``torch_mean``, PyTorch's float32 mean of the same rows, - the float64
    mean|)."""
    x = np.asarray(x, np.float64)
    mean = float(x.mean())
    return mean, max(mbops.SUM_REL_FLOOR * float(np.abs(x).mean()),
                     mbops.SUM_CONTROL_FACTOR * abs(float(torch_mean) - mean))


def std_bound(x: np.ndarray, torch_std: float) -> tuple[float, float]:
    """``sum_bound`` for the unbiased std: the float64 std of the rows ``x`` and
    max(``mbops.SUM_REL_FLOOR`` x it, ``mbops.SUM_CONTROL_FACTOR`` x |``torch_std`` - it|)."""
    x = np.asarray(x, np.float64)
    std = float(x.std(ddof=1)) if x.size > 1 else float("nan")
    return std, max(mbops.SUM_REL_FLOOR * std, mbops.SUM_CONTROL_FACTOR * abs(float(torch_std) - std))


def moments_table(mean: torch.Tensor, std: torch.Tensor):
    """(table, at): a moments table [MOMENT_ROW + 1, 2] whose row ``MOMENT_ROW``
    holds (``mean``, ``std``) and the rows before it other moments, and that row
    (int64 [1]), as the update's table and ``loop.i`` hand them to the head."""
    row = torch.stack([mean, std]).detach()
    table = torch.stack([row * 2.0 + 1.0 for _ in range(MOMENT_ROW)] + [row])
    return table, torch.full((1,), MOMENT_ROW, dtype=torch.int64, device=row.device)


def head_tensors(case: dict, dev, own_moments: bool = False) -> dict:
    """``crafted_minibatch``'s arrays as tensors on ``dev`` (``mu`` and ``v``
    requiring gradients), with the moments the loss would take: the group's, or
    with ``own_moments`` the advantages' own mean and unbiased std as the update
    forms them (``flat_moments``: on the card the moments kernel). ``mean`` and
    ``std`` 0-d for the per-row version, and ``moments`` and ``at``
    (``moments_table``) for the head."""
    t = {k: torch.as_tensor(v, device=dev) for k, v in case.items() if k != "moments"}
    t["mu"].requires_grad_(True)
    t["v"].requires_grad_(True)
    if own_moments:
        table, _ = flat_moments(t["advantages"])
        t["mean"], t["std"] = table[0].unbind()
    else:
        t["mean"], t["std"] = (torch.as_tensor(m, device=dev) for m in case["moments"])
    t["moments"], t["at"] = moments_table(t["mean"], t["std"])
    return t


def unit_head_tensors(n_units: int, block: int, ids, rng, dev, own_moments: bool = False):
    """``head_tensors`` for a minibatch read through the unit index: a
    ``crafted_minibatch`` over ``n_units`` units of ``block`` rows, the actions,
    old log-probs, advantages, returns and old values as the rollout's units
    [n_units, block, ...], ``mu`` and ``v`` the minibatch's rows at unit ids ``ids``
    (``unit_ids``, int64), as ``minibatch_step`` hands them to the head; with
    ``own_moments`` the moments of the minibatch's own advantages
    (``mbops.advantage_moments`` at its ids)."""
    whole = head_tensors(crafted_minibatch(n_units * block, rng), dev)
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.int64, device=dev)
    rows = (ids[:, None] * block + torch.arange(block, device=dev)).reshape(-1)
    t = {k: whole[k].detach().reshape((n_units, block) + whole[k].shape[1:])
         for k in ("actions", "logprobs", "advantages", "returns", "values")}
    t.update({k: whole[k].detach()[rows].contiguous() for k in ("mu", "v")})
    t["log_std"], t["unit_ids"] = whole["log_std"], ids
    t["mu"].requires_grad_(True)
    t["v"].requires_grad_(True)
    if own_moments:
        t["mean"], t["std"] = mbops.advantage_moments(t["advantages"], ids[None])[0].unbind()
    else:
        t["mean"], t["std"] = whole["mean"], whole["std"]
    t["moments"], t["at"] = moments_table(t["mean"], t["std"])
    return t


# the head's arguments (``mbops.ppo_head``), and the per-row version's
# (``mbops.ppo_head_plain``, on gathered rows)
HEAD_ARGS = ("mu", "v", "actions", "logprobs", "advantages", "returns", "values", "log_std",
             "moments", "at")
ROW_ARGS = HEAD_ARGS[:-2] + ("mean", "std")


def head_outputs(head, t: dict, g_loss: float = 1.0):
    """``head`` (``mbops.ppo_head`` or ``ppo_head_loss_plain``) on tensors ``t``:
    its loss and stats, and the gradients of ``mu`` and ``v`` from the loss's
    upstream gradient ``g_loss``."""
    loss, stats = head(*(t[k] for k in HEAD_ARGS), *HEAD_COEFS, t.get("unit_ids"))
    grads = torch.autograd.grad(loss, (t["mu"], t["v"]), torch.full_like(loss, g_loss))
    return [loss.detach(), stats] + list(grads)


HEAD_OUTPUTS = ("loss", "stats", "d/d mu", "d/d v")
# what hold_head holds: the per-row values the sums take, and the stats
HEAD_ROW_VALUES = ("-log_ratio", "max(pg1, pg2)", "max of the value losses", "clip flag")
STAT_KEYS = ppo.STAT_NAMES[:6]


def gathered_rows(t: dict) -> dict:
    """``t``'s unit-indexed fields gathered at its unit ids (``t`` itself without
    ids)."""
    if t.get("unit_ids") is None:
        return t
    out = dict(t)
    for k in ("actions", "logprobs", "advantages", "returns", "values"):
        out[k] = mbops.gather_units(t[k], t["unit_ids"])
    return out


def head_row_values(t: dict) -> list:
    """The four per-row float32 values the head's sums take, by the plain per-row
    composition on ``t``'s gathered rows, as numpy arrays."""
    g = gathered_rows(t)
    with torch.no_grad():
        rows = mbops.ppo_head_plain(*(g[k].detach() for k in ROW_ARGS), HEAD_CLIP)
    return [r.cpu().numpy() for r in rows]


def head_stat_bounds(values: list, t: dict) -> list:
    """(float64 value, bound) of each of ``STAT_KEYS`` from the per-row ``values``
    (``head_row_values``): the means by ``sum_bound`` (PyTorch's float32 mean
    of the same rows as the control), v_loss half the value maximum's, the entropy
    exact, clip_frac 0 (bitwise), the loss the sum of its three terms' bounds."""
    f32 = np.float32
    clip, ent_coef, vf_coef = HEAD_COEFS
    torch_mean = lambda x: float(torch.as_tensor(x).mean())
    kl, pg, vm = (sum_bound(x, torch_mean(x)) for x in values[:3])
    ls = t["log_std"].detach().cpu().numpy().astype(np.float64)
    ent = float(f32(f32(f32(ls[0]) + f32(0.5 + 0.5 * np.log(2 * np.pi)))
                    + f32(f32(ls[1]) + f32(0.5 + 0.5 * np.log(2 * np.pi)))))
    v_loss = (0.5 * vm[0], 0.5 * vm[1])
    loss = (pg[0] - ent_coef * ent + vf_coef * v_loss[0],
            pg[1] + vf_coef * v_loss[1] + abs(ent_coef * ent) * mbops.SUM_REL_FLOOR)
    n = values[3].size
    clip_frac = (float(f32(f32(values[3].sum()) * (f32(1.0) / f32(n)))), 0.0)
    return [loss, pg, v_loss, (ent, 0.0), kl, clip_frac]


def head_sums_shape() -> tuple:
    """(threads a block of the head, threads a block of the moments, blocks a cluster
    of the moments): ``csrc/ppo_head.cu``'s kThreads, kMomentThreads and
    kMomentCluster, read from the source."""
    src = (Path(__file__).resolve().parent / "self_play_racing_tpu_torch" / "csrc"
           / "ppo_head.cu").read_text()
    return tuple(int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
                 for name in ("kThreads", "kMomentThreads", "kMomentCluster"))


def warp_tree(v: np.ndarray) -> np.ndarray:
    """Lane 0's sum after ``csrc/ppo_head.cu:warp_sum``'s shuffle tree (offsets 16,
    8, 4, 2, 1) of the lanes' float64 values ``v`` [..., 32]."""
    v = np.array(v, np.float64)
    for o in (16, 8, 4, 2, 1):
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
    return v[..., 0]


def in_order(v: np.ndarray) -> np.ndarray:
    """``v`` [..., k] summed over its last axis from the first, one add at a time."""
    t = v[..., 0].copy()
    for j in range(1, v.shape[-1]):
        t = t + v[..., j]
    return t


def block_tree(v: np.ndarray) -> np.ndarray:
    """A block's threads' float64 values ``v`` [..., threads] summed as the kernels'
    block sums take them: each warp's by ``warp_tree``, then the warps' in order."""
    return in_order(warp_tree(v.reshape(v.shape[:-1] + (v.shape[-1] // 32, 32))))


def head_sums_model(values: list, log_std, coefs=HEAD_COEFS) -> np.ndarray:
    """``csrc/ppo_head.cu``'s forward past the rows, in numpy: the four per-row float32
    ``values`` [n] (``head_row_values``) summed in float64, block b of kThreads rows
    by ``block_tree``; the last block's thread t the blocks' partials t, t +
    kThreads, ... in order from 0, then ``block_tree``; the stats formed in float32
    as the kernel forms them. Returns the stats [6] (``STAT_KEYS``; the loss is the
    first) as float32."""
    threads, _, _ = head_sums_shape()
    f32 = np.float32
    n = values[0].size
    blocks = -(-n // threads)
    rows = np.zeros((4, blocks * threads))
    rows[:, :n] = np.stack([np.asarray(x, np.float64) for x in values])
    partial = block_tree(rows.reshape(4, blocks, threads))
    passes = -(-blocks // threads)
    padded = np.zeros((4, passes * threads))
    padded[:, :blocks] = partial
    acc = np.zeros((4, threads))
    for j in range(passes):
        acc = acc + padded[:, j * threads:(j + 1) * threads]
    total = block_tree(acc)
    clip, ent_coef, vf_coef = coefs
    ls = np.asarray(log_std, f32)
    c = f32(0.5 + 0.5 * np.log(2 * np.pi))
    approx_kl, pg_loss = f32(total[0] / n), f32(total[1] / n)
    v_loss = f32(f32(total[2] / n) * f32(0.5))
    entropy = f32(f32(f32(ls[0] + c) + f32(ls[1] + c)) + f32(0.0))
    clip_frac = f32(f32(total[3]) * (f32(1.0) / f32(n)))
    loss = f32(f32(pg_loss + f32(f32(-entropy) * f32(ent_coef))) + f32(v_loss * f32(vf_coef)))
    return np.array([loss, pg_loss, v_loss, entropy, approx_kl, clip_frac], np.float32)


def moment_order(n: int, threads: int) -> np.ndarray:
    """The moments kernel's order over a minibatch's ``n`` flat rows (row r: unit
    ``ids[r // block]``, offset ``r % block``) among a cluster's ``threads`` threads:
    [passes, threads], entry [i, g] the row thread g adds i-th, g + i x threads, or -1
    past the last row."""
    r = np.arange(-(-n // threads) * threads).reshape(-1, threads)
    return np.where(r < n, r, -1)


def thread_sums(values: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Each thread's float64 sum from 0 of ``values`` at its rows of ``order`` in
    order (``moment_order``)."""
    acc = np.zeros(order.shape[1])
    for i in range(order.shape[0]):
        acc = acc + np.where(order[i] >= 0, values[np.maximum(order[i], 0)], 0.0)
    return acc


def moments_model(advantages: np.ndarray, index: np.ndarray) -> np.ndarray:
    """``csrc/ppo_head.cu:advantage_moments_kernel`` in numpy: the advantages
    [units, block] float32 at each row of ``index`` [rows, ids], flat; each of the
    cluster's threads' deviations d from the minibatch's first row (``moment_order``)
    summed in float64, d and d * d, each block's threads by ``block_tree`` and the
    blocks in rank order from 0; mean = shift + S / n, var = (Q - S * S / n) / (n - 1),
    negative var 0; [rows, 2] float32."""
    _, threads, cluster = head_sums_shape()
    x = np.asarray(advantages, np.float64)
    out = []
    for ids in np.asarray(index):
        rows = x[ids].reshape(-1)
        n = rows.size
        order = moment_order(n, cluster * threads)
        d = rows - rows[0]
        sums = []
        for v in (d, d * d):
            blocks = block_tree(thread_sums(v, order).reshape(cluster, threads))
            total = 0.0
            for c in range(cluster):
                total = total + blocks[c]
            sums.append(total)
        s, q = sums
        with np.errstate(invalid="ignore", divide="ignore"):
            var = (q - s * s / n) / (n - 1)
            std = np.sqrt(0.0 if var < 0.0 else var)
        out.append((np.float32(rows[0] + s / n), np.float32(std)))
    return np.array(out, np.float32).reshape(-1, 2)


def hold_head(t: dict, g_loss: float, what: str) -> float:
    """The head's kernels against the plain composition on ``t``: d/d mu and d/d v
    bitwise (given the same moments), the stats bitwise ``head_sums_model`` (the
    kernel's order, from the per-row values) and within ``head_stat_bounds`` of the
    float64 sums, clip_frac bitwise the composition's, the loss the first stat.
    Returns the largest distance of a stat from the composition's."""
    got = head_outputs(mbops.ppo_head, t, g_loss)
    want = head_outputs(mbops.ppo_head_loss_plain, t, g_loss)
    torch.cuda.synchronize()
    bad = [name for name, g, w in zip(HEAD_OUTPUTS[2:], got[2:], want[2:])
           if not same_bits(g, w)]
    if bad:
        raise AssertionError(f"phase n ppo_head {what}: {bad} differ from the plain version")
    stats = got[1].cpu().numpy()
    values = head_row_values(t)
    model = head_sums_model(values, t["log_std"].detach().cpu().numpy())
    if not np.array_equal(stats.view(np.int32), model.view(np.int32)):
        raise AssertionError(f"phase n ppo_head {what}: the stats {stats} are not the "
                             f"transcription's {model}")
    if not same_bits(got[0], got[1][0]) or not same_bits(got[1][5], want[1][5]):
        raise AssertionError(f"phase n ppo_head {what}: the loss is not its first stat or "
                             f"clip_frac differs from the composition's")
    for k, s, (ref, bound) in zip(STAT_KEYS, stats, head_stat_bounds(values, t)):
        if not abs(float(s) - ref) <= bound:
            raise AssertionError(f"phase n ppo_head {what}: {k} {float(s)!r} is "
                                 f"{abs(float(s) - ref):.3g} from the float64 {ref!r}, "
                                 f"over its bound {bound:.3g}")
    return float((got[1].double() - want[1].double()).abs().max())


def tail_state(dev, seed: int, hidden=(64, 64), obs_dim: int = 19, steps: int = 160):
    """A learner's tail inputs at ``train scale``'s widths: the 12 parameter tensors
    of a ``obs_dim`` -> ``hidden`` -> {2, 1} policy, gradients, Adam moments after
    some steps, the bias tables of an update of ``steps`` minibatches and a fresh
    ``ppo.MinibatchLoop``."""
    gen = torch.Generator().manual_seed(seed)
    params = [p.detach().to(dev) for p in net.ActorCritic(
        net.init_params(gen, obs_dim, 2, hidden=hidden), torch.zeros(2)).parameters()]
    like = lambda p, s: (torch.randn(p.shape, generator=gen) * s).to(dev)
    grads = [like(p, 0.003) for p in params]
    mu = [like(p, 0.01) for p in params]
    nu = [like(p, 0.001).square() for p in params]
    bc1, bc2 = (torch.as_tensor(ppo.bias_correction_table(b, 7, steps, torch.float32),
                                device=dev) for b in (ppo.ADAM_B1, ppo.ADAM_B2))
    return params, grads, mu, nu, bc1, bc2, ppo.MinibatchLoop.zeros(steps, dev)


# the tail's cases: (approx_kl, the loop's exit flag before, gradient scale): applied
# below the clip, applied and clipped, masked by trig, masked by an earlier exit
TAIL_CASES = {"applied": (0.001, False, 1.0), "applied, clipped": (0.001, False, 100.0),
              "trig": (0.5, False, 1.0), "after the exit": (0.001, True, 1.0)}


def tail_stats(kl: float, dev, dtype=torch.float32) -> torch.Tensor:
    """Six stats [6] (``STAT_KEYS``) with approx_kl ``kl``, as the head writes them."""
    return torch.tensor([0.31, -0.02, 0.45, 1.9, kl, 0.11], dtype=dtype, device=dev)


def run_tail(tail, state, kl: float, stop: bool, scale: float, dev, at: int = 3):
    """``tail`` (``mbops.adam_tail`` or ``adam_tail_plain``) on a copy of ``state``'s
    parameters and moments (its gradients as given, times ``scale``), with the loop at minibatch ``at`` (``at - 1`` applied, ``stop`` its exit flag)
    and the stats' approx_kl ``kl``; returns everything it writes."""
    params, grads, mu, nu, bc1, bc2, loop = state
    params, mu, nu = ([x.clone() for x in xs] for xs in (params, mu, nu))
    loop = ppo.MinibatchLoop(i=torch.full((1,), at, dtype=torch.int64, device=dev),
                             applied=torch.full((1,), at - 1, dtype=torch.int64, device=dev),
                             stop=torch.tensor(stop, device=dev), stats=loop.stats.clone())
    if scale != 1.0:
        grads = [g * scale for g in grads]
    g_norm = ppo.global_norm(grads)
    lr = torch.tensor(2.5e-4, device=dev)
    tail(params, grads, mu, nu, g_norm, tail_stats(kl, dev), bc1, bc2, lr, loop, 0.5, 0.02)
    return params + mu + nu + [loop.i, loop.applied, loop.stop, loop.stats]


def gathered_minibatch_step(cfg, model, log_std, lr, units, index, bc1, bc2, mu, nu, loop,
                            moments, mesh=None) -> None:
    """``ppo.minibatch_step`` with every field of the minibatch gathered and the loss
    on the gathered ``ppo.Batch`` (no unit index): the step before the loss head read
    its fields through the unit ids, to hold the index route to and time it
    against (patched in for ``ppo.minibatch_step``)."""
    rows = index.index_select(0, loop.i)[0]
    mb = ppo.Batch(*(mbops.gather_units(x, rows) for x in units))
    ppo.apply_minibatch(cfg, model, log_std, lr, mb, bc1, bc2, mu, nu, loop, moments, mesh)


def plain_head_and_tail():
    """The minibatch step's head and tail as their plain versions for the block, on
    the moments kernel's table (``minibatch_step`` reaches them through
    ``ops.minibatch``'s attributes), so that every gradient is the kernels' bitwise
    and only the stats' sums round otherwise."""
    return _patched(mbops, ppo_head=mbops.ppo_head_loss_plain,
                    adam_tail=mbops.adam_tail_plain)


@contextlib.contextmanager
def _patched(module, **attrs):
    saved = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def update_with(cfg, dev, seed: int, plain=None):
    """One ``run_ppo_update`` (eager) of a fresh policy on a seeded rollout-like batch
    at ``cfg``'s width, with the kernels or inside ``plain()``
    (``plain_head_and_tail``): what it trains and its stats."""
    gen = torch.Generator().manual_seed(seed)
    train = ppo.init_train_state(gen, cfg, 19, 2, device=dev)
    b = cfg.batch_size
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape, s=1.0: torch.randn(shape, generator=g, device=dev) * s
    obs = rnd(b, 19)
    with torch.no_grad():
        mu, v = train.model(obs)
        actions = (mu + 0.6 * rnd(b, 2)).clamp(-1, 1)
        lp = net.normal_log_prob(actions, mu, torch.full((2,), -0.5, device=dev))
    flat = ppo.Batch(obs, actions, lp + rnd(b, s=0.05), rnd(b, s=2.0), v + rnd(b), v)
    _, n_units, _ = ppo.minibatch_layout(cfg)
    perms = prng.epoch_permutation(g, n_units, shape=(cfg.update_epochs, 1), device=dev)
    with plain() if plain is not None else contextlib.nullcontext():
        opt, stopped, stats = ppo.run_ppo_update(
            cfg, train.model, train.opt_state, torch.full((2,), -0.5, device=dev), 2.5e-4,
            flat, perms)
    torch.cuda.synchronize()
    return list(train.model.parameters()) + opt.mu + opt.nu, (stopped, stats)


def same_stats(a: dict, b: dict) -> bool:
    """Two updates' per-minibatch stats (``run_ppo_update``'s) bitwise equal."""
    return all(np.array_equal(a[k], b[k]) for k in ppo.STAT_NAMES)


# the minibatch step's unit index: the self-play minibatch's 1024 units of 64 rows,
# a rank's 256, and an odd count of rows (units of 3: a chunk's rows read one by one)
UNIT_BLOCKS = {65_536: 64, 16_384: 64, 4095: 3}


def unit_case(n: int, rng, dev, own_moments: bool = False) -> dict:
    """``unit_head_tensors`` for an ``n``-row minibatch of ``UNIT_BLOCKS[n]``-row units
    drawn without repeats from twice as many."""
    block = UNIT_BLOCKS[n]
    ids = rng.permutation(2 * n // block)[:n // block]
    return unit_head_tensors(2 * n // block, block, ids, rng, dev, own_moments)


def hold_tail_replays(dev, replays: int = 16) -> None:
    """One ``adam_tail`` launch captured in a CUDA graph and replayed ``replays``
    times against as many eager steps of the plain version: parameters, moments and
    stats rows bitwise, and the counters advanced once a replay."""
    params, grads, mu, nu, bc1, bc2, loop = tail_state(dev, 8, steps=2 * replays)
    ref = ([p.clone() for p in params], [m.clone() for m in mu], [v.clone() for v in nu],
           ppo.MinibatchLoop.zeros(2 * replays, dev))
    g_norm = ppo.global_norm(grads)
    stats = tail_stats(0.001, dev)
    lr = torch.tensor(2.5e-4, device=dev)
    loop.stop.fill_(True)  # a masked warm-up: it moves the loop alone
    mbops.adam_tail(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop, 0.5, 0.02)
    loop.reset()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        mbops.adam_tail(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop, 0.5, 0.02)
    torch.cuda.synchronize()
    if int(loop.i):
        raise AssertionError("phase n adam_tail: the capture ran the kernel")
    for _ in range(replays):
        graph.replay()
        mbops.adam_tail_plain(ref[0], grads, ref[1], ref[2], g_norm, stats, bc1, bc2, lr,
                              ref[3], 0.5, 0.02)
    torch.cuda.synchronize()
    if not (int(loop.i) == int(loop.applied) == replays and all(
            same_bits(a, b) for a, b in zip(params + mu + nu + [loop.stats],
                                            ref[0] + ref[1] + ref[2] + [ref[3].stats]))):
        raise AssertionError(f"phase n adam_tail: {replays} graph replays differ from as "
                             f"many plain steps (i {int(loop.i)}, applied "
                             f"{int(loop.applied)})")


class OpCounter(TorchDispatchMode):
    """The ATen operators run inside the block, by name."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.counts[name] = self.counts.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# the ATen reductions of the loss and the advantages that a minibatch step on the
# card no longer makes
LOSS_REDUCTIONS = ("mean", "std", "var", "std_mean", "var_mean", "sum")


def minibatch_inputs(cfg, dev, seed: int = 4):
    """A fresh train state and ``minibatch_step``'s inputs (log_std, lr, units, index,
    bc1, bc2) at ``cfg``'s width: random units in ``shard_blocks``' layout, the
    epochs' minibatch index and the bias tables of a whole update."""
    train = ppo.init_train_state(torch.Generator().manual_seed(seed), cfg, 19, 2, device=dev)
    block, n_units, _ = ppo.minibatch_layout(cfg)
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev)
    units = ppo.Batch(rnd(n_units, block, 19), rnd(n_units, block, 2).clamp(-1, 1),
                      rnd(n_units, block), rnd(n_units, block), rnd(n_units, block),
                      rnd(n_units, block))
    perms = prng.epoch_permutation(g, n_units, shape=(cfg.update_epochs, 1), device=dev)
    index = ppo.minibatch_index(cfg, perms)
    bc1, bc2 = (torch.as_tensor(ppo.bias_correction_table(b, 0, index.shape[0],
                                                          torch.float32), device=dev)
                for b in (ppo.ADAM_B1, ppo.ADAM_B2))
    return train, (torch.full((2,), -0.5, device=dev), torch.tensor(2.5e-4, device=dev),
                   units, index, bc1, bc2)


def ops_of_a_minibatch_step(dev) -> dict:
    """The ATen operators one eager ``minibatch_step`` runs at ``train scale``'s
    width, by name, through the unit index and with every field gathered
    (``gathered_minibatch_step``)."""
    cfg = base_config(num_envs=NUM_ENVS, num_steps=STEPS)
    train, inputs = minibatch_inputs(cfg, dev)
    moments = ppo.advantage_moments(cfg, inputs[2], inputs[3])
    counts = {}
    for name, step in (("unit index", ppo.minibatch_step),
                       ("every field gathered", gathered_minibatch_step)):
        opt = train.opt_state
        with OpCounter() as ops:
            step(cfg, train.model, *inputs, [m.clone() for m in opt.mu],
                 [v.clone() for v in opt.nu], ppo.MinibatchLoop.zeros(inputs[3].shape[0], dev),
                 moments)
        counts[name] = ops.counts
    torch.cuda.synchronize()
    return counts


def hold_moments(dev) -> float:
    """``advantage_moments``' kernel against its transcription (bitwise) and the
    float64 moments of the same rows (within ``sum_bound``, ``std_bound``; the
    plain table the control) at ``train scale``'s width (160 minibatches of 1024
    units of 64), a rank's of two data shards, units of 3 and of 1, and one-row
    minibatches (std NaN, as the plain version's). Returns the largest distance from
    the plain table."""
    err = 0.0
    cases = {"train scale": (base_config(num_envs=NUM_ENVS, num_steps=STEPS), 2),
             "two shards": (base_config(num_envs=NUM_ENVS, num_steps=STEPS, data_shards=2), 2),
             "units of 3": (base_config(num_envs=96, num_steps=64, shuffle_block_size=3), 160),
             "units of 1": (base_config(num_envs=64, num_steps=64, shuffle_block_size=1), 160)}
    for name, (cfg, model_rows) in cases.items():
        _, inputs = minibatch_inputs(cfg, dev)
        units, index = inputs[2], inputs[3]
        adv = units.advantages
        got = mbops.advantage_moments(adv, index).cpu().numpy()
        plain = mbops.advantage_moments_plain(adv, index).cpu().numpy()
        x, ids = adv.cpu().numpy(), index.cpu().numpy()
        model = moments_model(x, ids[:model_rows])
        if not np.array_equal(got[:model_rows].view(np.int32), model.view(np.int32)):
            raise AssertionError(f"phase n advantage_moments {name}: not the transcription's")
        rows = x[ids].reshape(ids.shape[0], -1)
        for i in range(ids.shape[0]):
            for j, bound in ((0, sum_bound), (1, std_bound)):
                ref, tol = bound(rows[i], float(plain[i, j]))
                if not abs(float(got[i, j]) - ref) <= tol:
                    raise AssertionError(f"phase n advantage_moments {name}, minibatch {i}: "
                                         f"{'std' if j else 'mean'} {float(got[i, j])!r} is "
                                         f"{abs(float(got[i, j]) - ref):.3g} from {ref!r}, "
                                         f"over {tol:.3g}")
        err = max(err, float(np.abs(got.astype(np.float64) - plain).max()))
        print(f"phase n advantage_moments {name}: {index.shape[0]} minibatches of "
              f"{index.shape[1]} units of {adv.shape[1]}: within max({mbops.SUM_REL_FLOOR} x "
              f"the scale, {mbops.SUM_CONTROL_FACTOR} x the plain table's distance) of "
              f"float64, the first {model_rows} bitwise the transcription; largest distance "
              f"from the plain table {err:.3g}")
    one = torch.randn((4, 1), device=dev)
    idx = torch.arange(4, device=dev)[:, None]
    got, plain = mbops.advantage_moments(one, idx), mbops.advantage_moments_plain(one, idx)
    if not (torch.equal(got[:, 0], plain[:, 0]) and bool(got[:, 1].isnan().all())
            and bool(plain[:, 1].isnan().all())):
        raise AssertionError("phase n advantage_moments: one-row minibatches are not (x, NaN)")
    return err


def check_minibatch_kernels(dev, card):
    """Phase n: ``ppo_head`` (forward and backward) and ``adam_tail`` against their
    plain versions on the card: the head on ``crafted_minibatch`` at
    ``MINIBATCH_ROWS``, an odd count and one row, with the group's moments and its
    own (row ``MOMENT_ROW`` of a table), d/d mu and d/d v bitwise the composition's
    from the loss at gradient 1 and 0.7, the stats bitwise their transcription and
    within the stated tolerance of float64, and through the unit index at
    ``UNIT_BLOCKS``' rows; ``advantage_moments`` (``hold_moments``); the tail, one
    cluster, in ``TAIL_CASES`` on ``tail_state``'s 12 tensors and on views of one
    flat buffer (a group's gradients), and over 16 replays of a CUDA graph; then one
    update of 160 minibatches at ``train scale``'s width with the kernels, with the
    head and tail plain on the kernel's moments (parameters and Adam moments bitwise,
    the stats within the tolerance) and with every field gathered (bitwise), and run
    to run (bitwise). Timed as the kernels line needs; returns its four entries."""
    rng = np.random.default_rng(17)
    head_err = 0.0
    for n in MINIBATCH_ROWS + (4097, 1):
        case = crafted_minibatch(n, rng)
        for own in (False, True) if n > 1 else (False,):
            t = head_tensors(case, dev, own)
            for g_loss in (1.0, 0.7):
                head_err = max(head_err, hold_head(t, g_loss, f"{n} rows, gradient {g_loss}"))
    for n in UNIT_BLOCKS:
        for own in (False, True):
            t = unit_case(n, rng, dev, own)
            for g_loss in (1.0, 0.7):
                head_err = max(head_err, hold_head(t, g_loss, f"{n} rows by unit id, "
                                                              f"gradient {g_loss}"))
    print(f"phase n ppo_head: d/d mu, d/d v bitwise the plain composition's autograd; the "
          f"loss and stats bitwise the kernel's transcription and within "
          f"max({mbops.SUM_REL_FLOOR} x mean(|x|), {mbops.SUM_CONTROL_FACTOR} x |torch's "
          f"float32 mean - float64|) of the float64 sums (the loss on its three terms, "
          f"clip_frac bitwise the composition's), at {MINIBATCH_ROWS + (4097, 1)} rows and "
          f"through the unit index at {tuple(UNIT_BLOCKS)} rows (units of "
          f"{tuple(UNIT_BLOCKS.values())}), every branch ({HEAD_ROW_KINDS} row kinds), the "
          f"group's moments and the minibatch's own; largest stat distance from the "
          f"composition {head_err:.3g}")
    moments_err = hold_moments(dev)
    state = tail_state(dev, 5)
    tail_err = 0.0
    for name, (kl, stop, scale) in TAIL_CASES.items():
        got = run_tail(mbops.adam_tail, state, kl, stop, scale, dev)
        want = run_tail(mbops.adam_tail_plain, state, kl, stop, scale, dev)
        torch.cuda.synchronize()
        if not all(same_bits(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"phase n adam_tail {name}: differs from the plain version")
        tail_err = max(tail_err, max(float((a.double() - b.double()).abs().max())
                                     for a, b in zip(got, want)))
    params, grads, mu, nu, bc1, bc2, loop = state
    flat = torch.cat([g.reshape(-1) for g in grads] + [torch.zeros(6, device=dev)])
    views, at = [], 0
    for g in grads:
        views.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    got = run_tail(mbops.adam_tail, (params, views, mu, nu, bc1, bc2, loop), 0.001, False,
                   1.0, dev)
    want = run_tail(mbops.adam_tail_plain, state, 0.001, False, 1.0, dev)
    if not all(same_bits(a, b) for a, b in zip(got, want)):
        raise AssertionError("phase n adam_tail on a flat buffer's views: differs")
    hold_tail_replays(dev)
    print(f"phase n adam_tail (one thread block cluster): parameters, moments, stats row "
          f"and counters bitwise the plain "
          f"composition ({', '.join(TAIL_CASES)}; a group's flat-buffer views; 16 graph "
          f"replays, the counters at 16)")
    cfg = base_config(num_envs=NUM_ENVS, num_steps=STEPS, kl_target=float("inf"))
    runs = {"kernels": update_with(cfg, dev, 3), "again": update_with(cfg, dev, 3),
            "plain head and tail": update_with(cfg, dev, 3, plain_head_and_tail)}
    with _patched(ppo, minibatch_step=gathered_minibatch_step):
        runs["every field gathered"] = update_with(cfg, dev, 3)
    kern = runs["kernels"]
    for what in ("again", "every field gathered"):
        if not (all(same_bits(a, b) for a, b in zip(kern[0], runs[what][0]))
                and kern[1][0] == runs[what][1][0] and same_stats(kern[1][1], runs[what][1][1])):
            raise AssertionError(f"phase n: an update with the kernels differs from one "
                                 f"{what}")
    plain = runs["plain head and tail"]
    if not all(same_bits(a, b) for a, b in zip(kern[0], plain[0])):
        raise AssertionError("phase n: an update with the kernels trains otherwise than one "
                             "with the head and tail plain on the same moments")
    if not np.array_equal(kern[1][1]["clip_frac"], plain[1][1]["clip_frac"]):
        raise AssertionError("phase n: the update's clip_frac differs from the plain head's")
    stat_gap = {k: float(np.abs(kern[1][1][k].astype(np.float64) - plain[1][1][k]).max())
                for k in STAT_KEYS}
    scale = {k: float(np.abs(plain[1][1][k]).max()) for k in STAT_KEYS}
    if any(stat_gap[k] > mbops.SUM_REL_FLOOR * max(scale[k], 1.0) for k in STAT_KEYS):
        raise AssertionError(f"phase n: the update's stats {stat_gap} from the plain head's")
    print(f"phase n: one update of {cfg.update_epochs * cfg.num_minibatches} minibatches "
          f"at {NUM_ENVS} x {STEPS} with the kernels bitwise run to run and bitwise the one "
          f"with every field gathered (parameters, Adam moments, every stat); the head and "
          f"tail plain on the kernel's moments train the same parameters and Adam moments "
          f"bitwise, clip_frac bitwise, the other stats at most {stat_gap} apart")
    ops = ops_of_a_minibatch_step(dev)
    reductions = {k: v for k, v in ops["unit index"].items() if k in LOSS_REDUCTIONS}
    if reductions:
        raise AssertionError(f"phase n: a minibatch step runs PyTorch reductions {reductions}")
    gathers = {k: v.get("index_select", 0) for k, v in ops.items()}
    print(f"phase n: a minibatch step's ATen operators through the unit index "
          f"{ops['unit index']} (no reduction of the loss or the advantages); gathers "
          f"(index_select) {gathers}")
    return time_minibatch_kernels(dev, card, head_err, moments_err, tail_err, gathers)


def head_bytes(n: int, backward: bool, unit_rows: int = 0) -> int:
    """The bytes ``ppo_head`` must move at ``n`` rows: each row's inputs read once
    (mu 2, v, the action 2, the old log-prob, the advantage, the return, the old
    value), log_std, the moments' row and its index; the forward's outputs written
    once (the loss and six stats), the backward's (3 floats a row) and its upstream
    gradient; with the unit index its ``unit_rows`` int64 ids."""
    out = 3 * n + 1 if backward else 7
    return 4 * (9 * n + 2 + 2 + out) + 8 + 8 * unit_rows


def moments_bytes(adv: torch.Tensor, index: torch.Tensor) -> int:
    """The bytes the moments launch must move: each distinct advantage row it reads
    once, the unit ids, the table written."""
    distinct = int(torch.unique(index).numel()) * adv.shape[1]
    return 4 * distinct + 8 * index.numel() + 4 * 2 * index.shape[0]


def f64_as_f32_ops(ops: int) -> float:
    """``ops`` float64 operations as float32 ones at the card's two peaks."""
    return ops * PEAK_F32_OPS_PER_S / PEAK_F64_OPS_PER_S


def time_minibatch_kernels(dev, card, head_err: float, moments_err: float, tail_err: float,
                           gathers: dict):
    """The kernels line's entries for ``ppo_head``, ``ppo_head_backward``,
    ``advantage_moments`` and ``adam_tail``: at each of ``MINIBATCH_ROWS`` the head
    eager and in a CUDA graph, with every field gathered and through the unit index,
    beside the plain composition and the bound; the moments at ``train scale``'s
    width, eager and in a graph, beside the plain loop, its bound and
    ``torch.std_mean`` on the gathered minibatches (two calls with the gather: no
    library call computes it, so its line's library_ms is null); and the tail beside
    its plain version and ``torch._fused_adam_`` over the same 12 tensors, eager and in
    a CUDA graph (a library call that computes Adam alone, rounds otherwise and never
    runs on the path)."""
    rng = np.random.default_rng(18)
    head, back = {}, {}
    consts = mbops._head_constants(*HEAD_COEFS)
    for n in MINIBATCH_ROWS:
        t = head_tensors(crafted_minibatch(n, rng), dev)
        args = [t[k].detach() for k in HEAD_ARGS]
        u = unit_case(n, rng, dev)
        u_args, ids = [u[k].detach() for k in HEAD_ARGS], u["unit_ids"]
        loss, stats = torch.empty((), device=dev), torch.empty((6,), device=dev)
        fwd = lambda: _cuda.launch_ppo_head_forward(args, consts, loss, stats, n)
        fwd_ids = lambda: _cuda.launch_ppo_head_forward(u_args, consts, loss, stats, n, ids)
        g_mu, g_v = torch.empty((n, 2), device=dev), torch.empty((n,), device=dev)
        one = torch.ones((), device=dev)
        bwd = lambda: _cuda.launch_ppo_head_backward(args, consts, one, g_mu, g_v, n)
        bwd_ids = lambda: _cuda.launch_ppo_head_backward(u_args, consts, one, g_mu, g_v, n,
                                                         ids)
        plain_f = lambda: mbops.ppo_head_loss_plain(*args, *HEAD_COEFS)
        mu_, v_ = args[0].clone().requires_grad_(True), args[1].clone().requires_grad_(True)

        def plain_b():
            out = mbops.ppo_head_loss_plain(mu_, v_, *args[2:], *HEAD_COEFS)
            torch.autograd.grad(out[0], (mu_, v_))

        f_ops = n * HEAD_FORWARD_OPS + f64_as_f32_ops(n * HEAD_SUM_OPS)
        f_bound = bound_ms(head_bytes(n, False), f_ops)
        b_bound = bound_ms(head_bytes(n, True), n * HEAD_BACKWARD_OPS)
        head[n] = (per_launch_ms(fwd), graph_ms(fwd), per_launch_ms(plain_f), *f_bound,
                   per_launch_ms(fwd_ids), graph_ms(fwd_ids),
                   bound_ms(head_bytes(n, False, ids.numel()), f_ops)[0])
        back[n] = (per_launch_ms(bwd), graph_ms(bwd), per_launch_ms(plain_b), *b_bound,
                   per_launch_ms(bwd_ids), graph_ms(bwd_ids),
                   bound_ms(head_bytes(n, True, ids.numel()), n * HEAD_BACKWARD_OPS)[0])
        for what, d in (("forward", head[n]), ("backward", back[n])):
            ms, g_ms, p_ms, b_ms, b_by, i_ms, i_g_ms, i_b_ms = d
            print(f"phase n ppo_head {what} at {n} rows: {ms * 1e3:.2f} us eager back-to-back, "
                  f"{g_ms * 1e3:.2f} us in a CUDA graph; through the unit index "
                  f"{i_ms * 1e3:.2f} us eager, {i_g_ms * 1e3:.2f} us in a graph; bound "
                  f"{b_ms * 1e3:.2f} us ({b_by}), {i_b_ms * 1e3:.2f} us by unit id; plain "
                  f"{p_ms * 1e3:.1f} us, on {card}")
    cfg = base_config(num_envs=NUM_ENVS, num_steps=STEPS)
    _, inputs = minibatch_inputs(cfg, dev)
    adv, index = inputs[2].advantages, inputs[3]
    table = torch.empty((index.shape[0], 2), device=dev)
    mom = lambda: _cuda.launch_advantage_moments(adv, index, table)
    gathered = adv[index].reshape(index.shape[0], -1)
    m_ms, m_graph = per_launch_ms(mom), graph_ms(mom)
    m_plain = per_launch_ms(lambda: mbops.advantage_moments_plain(adv, index), windows=5,
                            launches=2)
    std_mean = per_launch_ms(lambda: torch.std_mean(gathered, dim=1))
    m_bound = bound_ms(moments_bytes(adv, index), f64_as_f32_ops(index.numel() * adv.shape[1]
                                                                  * MOMENT_OPS))
    print(f"phase n advantage_moments: {index.shape[0]} minibatches of {index.shape[1]} "
          f"units of {adv.shape[1]}: {m_ms * 1e3:.2f} us eager, {m_graph * 1e3:.2f} us in a "
          f"CUDA graph; bound {m_bound[0] * 1e3:.2f} us ({m_bound[1]}: the "
          f"{moments_bytes(adv, index) / 1e6:.1f} MB of distinct rows); plain "
          f"{m_plain * 1e3:.1f} us; torch.std_mean on the minibatches gathered "
          f"{std_mean * 1e3:.2f} us, on {card}")
    # every timed launch applies a step: the loop's tables hold more rows than the
    # windows take
    params, grads, mu, nu, bc1, bc2, loop = tail_state(dev, 6, steps=4096)
    stats = tail_stats(0.001, dev)
    lr = torch.tensor(2.5e-4, device=dev)
    g_norm = ppo.global_norm(grads)
    tail = lambda fn: lambda: fn(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop,
                                 0.5, 0.02)
    t_ms, t_graph, t_plain = (per_launch_ms(tail(mbops.adam_tail)),
                              graph_ms(tail(mbops.adam_tail)),
                              per_launch_ms(tail(mbops.adam_tail_plain)))
    if int(loop.applied) != int(loop.i) or int(loop.i) >= loop.stats.shape[0]:
        raise AssertionError(f"phase n adam_tail timing: {int(loop.applied)} applied of "
                             f"{int(loop.i)} launches")
    steps = [torch.full((), 7.0, device=dev) for _ in params]
    fused = lambda: torch._fused_adam_(params, grads, mu, nu, [], steps, lr=2.5e-4, beta1=0.9,
                                       beta2=0.999, weight_decay=0.0, eps=1e-5, amsgrad=False,
                                       maximize=False)
    library, library_graph = per_launch_ms(fused), graph_ms(fused)
    elements = sum(p.numel() for p in params)
    t_bound = bound_ms(4 * nbytes(*params) + 3 * nbytes(*params), elements * TAIL_OPS)
    print(f"phase n adam_tail over {len(params)} tensors ({elements} floats): "
          f"{t_ms * 1e3:.2f} us eager back-to-back, {t_graph * 1e3:.2f} us in a CUDA graph; "
          f"bound {t_bound[0] * 1e3:.3f} us "
          f"({t_bound[1]}); plain {t_plain * 1e3:.1f} us; torch._fused_adam_ "
          f"{library * 1e3:.2f} us eager, {library_graph * 1e3:.2f} us in a graph, on {card}")
    big, small = MINIBATCH_ROWS
    registers = lambda src, word: kernel_registers(_cuda.build_report.get(src, ""), word)
    entry = lambda name, src, replaces, err, d, word: {
        "name": name, "route": "cuda", "source": src, "replaces": replaces,
        "max_abs_err": err, "ms": d[big][0], "graph_ms": d[big][1], "plain_ms": d[big][2],
        "bound_ms": d[big][3], "bound_by": d[big][4], "library_ms": None,
        "unit_index_ms": d[big][5], "unit_index_graph_ms": d[big][6],
        "unit_index_bound_ms": d[big][7], "rows": big,
        "registers": registers("ppo_head", word), "gathers_a_minibatch_step": gathers,
        f"ms_{small}_rows": d[small][0], f"graph_ms_{small}_rows": d[small][1],
        f"plain_ms_{small}_rows": d[small][2], f"bound_ms_{small}_rows": d[small][3],
        f"unit_index_graph_ms_{small}_rows": d[small][6]}
    src = "self_play_racing_tpu_torch/csrc/ppo_head.cu"
    return [entry("ppo_head", src, "self_play_racing_tpu/agent/ppo.py:189", head_err, head,
                  "ppo_head_forward"),
            entry("ppo_head_backward", src, "self_play_racing_tpu/agent/ppo.py:313", head_err,
                  back, "ppo_head_backward"),
            {"name": "advantage_moments", "route": "cuda", "source": src,
             "replaces": "self_play_racing_tpu/agent/ppo.py:195", "max_abs_err": moments_err,
             "ms": m_ms, "graph_ms": m_graph, "plain_ms": m_plain, "bound_ms": m_bound[0],
             "bound_by": m_bound[1], "library_ms": None, "std_mean_on_gathered_ms": std_mean,
             "minibatches": index.shape[0], "rows": index.shape[1] * adv.shape[1],
             "registers": registers("ppo_head", "advantage_moments")},
            {"name": "adam_tail", "route": "cuda",
             "source": "self_play_racing_tpu_torch/csrc/adam_tail.cu",
             "replaces": "self_play_racing_tpu/agent/ppo.py:117", "max_abs_err": tail_err,
             "ms": t_ms, "graph_ms": t_graph, "plain_ms": t_plain, "bound_ms": t_bound[0],
             "bound_by": t_bound[1], "library_ms": library, "library_graph_ms": library_graph,
             "tensors": len(params), "elements": elements,
             "registers": registers("adam_tail", "adam_tail")}]


# ------------------------------------------ phase (p): the minibatch step's MLPs

# The MLP kernels (csrc/mlp_towers.cu) sum each product in their own order (3xTF32 on
# the tensor cores), the weight and bias gradients over each block's 64-row tiles and
# then the blocks in 8 groups; cuBLAS and autograd sum in theirs. So each output and gradient tensor is held to the plain
# composition within max(MLP_REL_FLOOR x the tensor's largest |plain value|,
# MLP_CONTROL_FACTOR x the control), the control being the plain composition's own
# distance when the same rows run in two halves (the halves' gradients summed): one
# more order of the same sums, which the kernels' order is another draw of. The floor,
# 1e-5 of the tensor's scale (~84 float32 ulps of it), covers what the control cannot
# see: mu and v, whose rows cuBLAS may round alike at either row count. Bitwise where
# nothing is summed otherwise: two runs, the unit index against the gathered rows, and
# graph replays against eager.
MLP_REL_FLOOR = 1e-5
MLP_CONTROL_FACTOR = 8
MLP_ROWS = (65_536, 16_384, 4097, 1)
# the towers phase p holds the kernels at: single-car (15 inputs at 11 sensors) and
# self-play at 2, 3 and 8 cars (11 + 4 x cars inputs) on every config's (64, 64), the
# widest obs_dim a block takes there, and phase j's towers of 128
MLP_TOWERS = ((15, 64, 64), (19, 64, 64), (23, 64, 64), (43, 64, 64), (184, 64, 64),
              (15, 128, 128), (19, 128, 128))
# the H100's L2 cache: the blocks' partials up to this size are still there when the
# reduce reads them right after the backward wrote them
L2_BYTES = 50_000_000
MLP_OUTPUTS = ("mu", "v") + tuple(f"{tower}.{p}" for tower in ("actor", "critic")
                                  for p in ("w1", "b1", "w2", "b2", "w3", "b3"))


def mlp_macs(obs_dim: int, h1: int, h2: int):
    """Multiply-adds a row of both towers: the forward, and the backward (every weight
    gradient, the input gradients of the upper two layers a tower)."""
    forward = 2 * (obs_dim * h1 + h1 * h2) + 3 * h2
    backward = 2 * (obs_dim * h1 + 2 * h1 * h2) + 2 * 3 * h2
    return forward, backward


def mlp_case(obs_dim: int, hidden, n: int, seed: int, dtype=np.float32) -> dict:
    """Whole towers obs_dim -> hidden -> {2, 1} in the JAX package's layout (weights
    (in, out) ~ N(0, 1.5^2 / fan_in), biases ~ N(0, 0.2^2)), observations ~ N(0, 1)
    [n, obs_dim] and the upstream gradients of mu [n, 2] and v [n] ~ N(0, 1) / n (the
    loss takes means), numpy arrays of ``dtype`` drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    dims = (obs_dim,) + tuple(hidden)
    cast = lambda a: np.asarray(a, dtype)

    def tower(out):
        return [(cast(rng.normal(0.0, 1.5 / np.sqrt(din), (din, dout))),
                 cast(rng.normal(0.0, 0.2, dout)))
                for din, dout in zip(dims, dims[1:] + (out,))]

    return {"params": {"actor": tower(2), "critic": tower(1)},
            "obs": cast(rng.normal(size=(n, obs_dim))),
            "g_mu": cast(rng.normal(size=(n, 2)) / max(n, 1)),
            "g_v": cast(rng.normal(size=n) / max(n, 1))}


def mlp_tensors(case: dict, dev, dtype=None):
    """``mlp_case``'s arrays on ``dev`` (cast to ``dtype`` where given): (params, the
    12 parameter tensors requiring gradients in ``model.parameters()`` order, obs,
    g_mu, g_v)."""
    t = lambda a, **kw: torch.tensor(a, device=dev, dtype=dtype, **kw)
    params = {tower: [tuple(t(a, requires_grad=True) for a in layer) for layer in layers]
              for tower, layers in case["params"].items()}
    leaves = [x for tower in ("actor", "critic") for layer in params[tower] for x in layer]
    return (params, leaves) + tuple(t(case[k]) for k in ("obs", "g_mu", "g_v"))


def mlp_run(fn, params, leaves, obs, g_mu, g_v, unit_ids=None) -> list:
    """``fn`` (``mlpops.actor_critic_mlp`` or its plain version) and its gradients
    from ``g_mu`` and ``g_v``: [mu, v, the 12 gradients]."""
    mu, v = fn(params, obs, unit_ids)
    return [mu.detach(), v.detach()] + list(
        torch.autograd.grad((mu, v), leaves, (g_mu, g_v)))


def mlp_control(params, leaves, obs, g_mu, g_v) -> list:
    """The plain composition on the rows in two halves: mu and v concatenated, the
    gradients the sum of the halves'."""
    h = obs.shape[0] // 2
    a, b = (mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, obs[s], g_mu[s], g_v[s])
            for s in (slice(0, h), slice(h, None)))
    return [torch.cat([a[0], b[0]]), torch.cat([a[1], b[1]])] + [
        x + y for x, y in zip(a[2:], b[2:])]


def mlp_errors(got, want) -> list:
    return [float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
            for g, w in zip(got, want)]


def mlp_bounds(plain, control) -> list:
    """Each tensor's tolerance (see MLP_REL_FLOOR)."""
    return [max(MLP_REL_FLOOR * (float(p.abs().max()) if p.numel() else 0.0),
                MLP_CONTROL_FACTOR * e) for p, e in zip(plain, mlp_errors(control, plain))]


def mlp_counts():
    return tuple(read_counts()[k] for k in TOWERS)


def hold_mlp(dims, n: int, dev, seed: int) -> dict:
    """The MLP kernels against the plain composition on the card at ``dims`` and ``n``
    rows: every output and gradient within ``mlp_bounds``, a second run bitwise the
    first, one launch of each kernel a run; and both against the float64 composition
    (printed). Returns the largest error and error/bound ratio."""
    d, h1, h2 = dims
    case = mlp_case(d, (h1, h2), n, seed)
    params, leaves, obs, g_mu, g_v = mlp_tensors(case, dev)
    before = mlp_counts()
    got = mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    again = mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)
    if [b - a for a, b in zip(before, mlp_counts())] != [2, 2, 2]:
        raise AssertionError(f"phase p {dims} at {n} rows: launches {before} -> "
                             f"{mlp_counts()}, expected 2 of each")
    want = mlp_run(mlpops.actor_critic_mlp_plain, params, leaves, obs, g_mu, g_v)
    bounds = mlp_bounds(want, mlp_control(params, leaves, obs, g_mu, g_v))
    ref = mlp_run(mlpops.actor_critic_mlp_plain, *mlp_tensors(case, dev, torch.float64))
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"phase p {dims} at {n} rows: two runs differ")
    errs = mlp_errors(got, want)
    bad = {name: (e, b) for name, e, b in zip(MLP_OUTPUTS, errs, bounds) if not e <= b}
    if bad:
        raise AssertionError(f"phase p {dims} at {n} rows: beyond the tolerance "
                             f"(error, bound): {bad}")
    ratio, worst = max((e / b if b else 0.0, name) for name, e, b in
                       zip(MLP_OUTPUTS, errs, bounds))
    k64, p64 = max(mlp_errors(got, ref)), max(mlp_errors(want, ref))
    print(f"phase p {dims} at {n} rows: every output and gradient within its bound, "
          f"at most {ratio:.3f} of it ({worst}); largest error {max(errs):.3e}; against "
          f"float64 the kernels {k64:.3e}, the plain composition {p64:.3e}; two runs "
          f"bitwise")
    return {"max_abs_err": max(errs), "ratio": ratio, "f64_kernels": k64, "f64_plain": p64}


def norm_bound(flat, composition) -> tuple:
    """(the float64 norm of the flat gradient ``flat``, the reduce's tolerance on its
    norm: max(MLP_REL_FLOOR x that norm, MLP_CONTROL_FACTOR x the distance of
    ``composition``, ``ppo.global_norm``'s float32 norm of the same flat, from it))."""
    n64 = float(flat.double().square().sum().sqrt())
    return n64, max(MLP_REL_FLOOR * n64, MLP_CONTROL_FACTOR * abs(float(composition) - n64))


def hold_grad_norm(dims, n: int, dev, seed: int) -> dict:
    """The reduce's global norm at ``dims`` and ``n`` rows through
    ``actor_critic_mlp(..., norm)``: the 12 gradients bitwise those of the norm-less
    launch, the norm within ``norm_bound`` of the float64 norm of the same flat, and
    ``mlpops.grad_norm`` (the norm-only mode) over that flat bitwise the fused norm;
    one launch of each mode a call. Returns the error, its bound and their ratio."""
    d, h1, h2 = dims
    case = mlp_case(d, (h1, h2), n, seed)
    params, leaves, obs, g_mu, g_v = mlp_tensors(case, dev)
    norm = torch.full((), float("nan"), device=dev)
    before = read_counts()
    mu, v = mlpops.actor_critic_mlp(params, obs, None, norm)
    fused = torch.autograd.grad((mu, v), leaves, (g_mu, g_v))
    plain = mlp_run(mlpops.actor_critic_mlp, params, leaves, obs, g_mu, g_v)[2:]
    flat = torch.cat([g.reshape(-1) for g in fused])
    only = mlpops.grad_norm(flat)
    composition = ppo.global_norm(list(fused))
    torch.cuda.synchronize()
    got = {k: read_counts()[k] - before[k] for k in ("mlp_grad_reduce", "mlp_grad_norm")}
    if got != {"mlp_grad_reduce": 2, "mlp_grad_norm": 1}:
        raise AssertionError(f"phase p norm {dims} at {n} rows: launches {got}")
    if not all(same_bits(a, b) for a, b in zip(fused, plain)):
        raise AssertionError(f"phase p norm {dims} at {n} rows: the flat gradient differs "
                             f"from the norm-less launch's")
    if not same_bits(only, norm):
        raise AssertionError(f"phase p norm {dims} at {n} rows: the norm-only mode "
                             f"{float(only)!r} differs from the fused norm {float(norm)!r}")
    n64, bound = norm_bound(flat, composition)
    err = abs(float(norm) - n64)
    if not err <= bound:
        raise AssertionError(f"phase p norm {dims} at {n} rows: {float(norm)!r} is {err:.3e} "
                             f"from the float64 norm {n64!r}, beyond {bound:.3e}")
    return {"err": err, "bound": bound, "ratio": err / bound if bound else 0.0,
            "composition_err": abs(float(composition) - n64), "norm": n64}


def hold_norm_replays(dev, replays: int = 3) -> None:
    """The reduce with its norm (train scale's partials: towers (19, 64, 64) at
    65,536 rows) captured in a CUDA graph and replayed ``replays`` times: the flat
    gradient and the norm bitwise the eager launch's after each, and the ticket's
    counter 0 after each."""
    dims, n = (19, 64, 64), 65_536
    _, leaves, obs, g_mu, g_v = mlp_tensors(mlp_case(dims[0], dims[1:], n, seed=31), dev)
    w = [x.detach() for x in leaves]
    partial = torch.empty((_cuda.mlp_partial_rows(n), sum(x.numel() for x in w)), device=dev)
    _cuda.launch_mlp_backward(obs, None, w, g_mu, g_v, partial, n, dims)
    flat, norm = torch.empty((partial.shape[1],), device=dev), torch.empty((), device=dev)
    _cuda.launch_mlp_grad_reduce(partial, flat, norm)
    want = (flat.clone(), norm.clone())
    ticket = _cuda.grad_norm_ticket(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        _cuda.launch_mlp_grad_reduce(partial, flat, norm)
    for i in range(replays):
        flat.zero_()
        norm.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        if not (same_bits(flat, want[0]) and same_bits(norm, want[1])):
            raise AssertionError(f"phase p norm: replay {i + 1} differs from the eager launch")
        if int(ticket.item()) != 0:
            raise AssertionError(f"phase p norm: the ticket's counter is {int(ticket.item())} "
                                 f"after replay {i + 1}")


def check_grad_norm(dev, card) -> dict:
    """The reduce's norm: ``hold_grad_norm`` at every tower of ``MLP_TOWERS`` at
    65,536 and 4097 rows, and ``hold_norm_replays``. Returns the largest error over
    its bound."""
    out = {}
    for i, dims in enumerate(MLP_TOWERS):
        for n in (65_536, 4097):
            out[dims, n] = hold_grad_norm(dims, n, dev, seed=500 + 10 * i + n % 7)
    hold_norm_replays(dev)
    worst = max(out, key=lambda k: out[k]["ratio"])
    print(f"phase p norm: the reduce's global norm within max({MLP_REL_FLOOR:g} x the "
          f"float64 norm of the same flat, {MLP_CONTROL_FACTOR} x ppo.global_norm's distance "
          f"from it) at {MLP_TOWERS} x (65536, 4097) rows, at most "
          f"{out[worst]['ratio']:.3f} of it ({worst}: error {out[worst]['err']:.3e}, the "
          f"composition's {out[worst]['composition_err']:.3e}, norm {out[worst]['norm']:.6g}); "
          f"the flat gradient bitwise the norm-less launch's, the norm-only mode bitwise the "
          f"fused norm, three graph replays bitwise with the ticket's counter at 0, on {card}")
    return {"norm_max_err": max(c["err"] for c in out.values()),
            "norm_max_err_over_bound": out[worst]["ratio"],
            "norm_composition_max_err": max(c["composition_err"] for c in out.values())}


def mlp_units(case: dict, n: int, block: int, dev, seed: int):
    """``case``'s observations as the rollout's units: [2 n / block, block, obs_dim]
    (the case's rows among twice as many) and the unit ids that read them back in
    order, int64."""
    rng = np.random.default_rng(seed)
    ids = rng.permutation(2 * n // block)[:n // block]
    units = rng.normal(size=(2 * n // block, block, case["obs"].shape[1])).astype(np.float32)
    units[ids] = case["obs"].reshape(n // block, block, -1)
    return (torch.as_tensor(units, device=dev),
            torch.as_tensor(ids, dtype=torch.int64, device=dev))


def mlp_refusals(dev) -> None:
    """No fallback: float64, non-contiguous tensors, hidden widths outside
    ``_cuda.MLP_HIDDEN`` and an obs_dim past a block's shared memory raise before any
    launch; and the wrapper's least shared bytes are the kernel's own
    (``mlp_shared_bytes``) at every obs_dim to 256 and a few widths, so what the
    wrapper takes is what the kernels take."""
    lib = _cuda._mlp_lib()
    for h1, h2 in _cuda.MLP_HIDDEN + ((64, 32), (96, 96), (256, 256)):
        for d in range(0, 257):
            want = _cuda.mlp_shared_bytes(d, h1, h2) if _cuda.mlp_takes(d, h1, h2) else 0
            if lib.mlp_shared_bytes(d, h1, h2) != want:
                raise AssertionError(f"phase p: shared bytes at ({d}, {h1}, {h2}): kernel "
                                     f"{lib.mlp_shared_bytes(d, h1, h2)}, wrapper {want}")
    params, leaves, obs, _, _ = mlp_tensors(mlp_case(19, (64, 64), 256, 0), dev)
    before = mlp_counts()
    refused = 0
    wide = {t: [tuple(x.double() for x in layer) for layer in ls] for t, ls in params.items()}
    odd = mlp_tensors(mlp_case(19, (64, 32), 256, 0), dev)[0]
    past = _cuda.mlp_max_obs_dim(128, 128) + 1
    far, _, far_obs, _, _ = mlp_tensors(mlp_case(past, (128, 128), 256, 0), dev)
    for what, p, o in (("float64", wide, obs.double()), ("non-contiguous", params,
                                                          obs.t().contiguous().t()),
                       ("towers (19, 64, 32)", odd, obs),
                       (f"towers ({past}, 128, 128)", far, far_obs)):
        try:
            mlpops.actor_critic_mlp(p, o)
        except (TypeError, ValueError):
            refused += 1
        else:
            raise AssertionError(f"phase p: actor_critic_mlp took {what} tensors")
    if refused != 4 or mlp_counts() != before:
        raise AssertionError("phase p: a refused call launched a kernel")


def mlp_row_invariance(dims, dev) -> None:
    """The forward is row-invariant, bitwise: on a permutation of 4097 rows it gives
    the permutation of its outputs, and on row 0 alone row 0 of its outputs at 65,536
    rows (what ROADMAP.md's row-invariance rests on)."""
    d, h1, h2 = dims
    case = mlp_case(d, (h1, h2), 65_536, seed=21)
    params, _, obs, _, _ = mlp_tensors(case, dev)
    perm = torch.as_tensor(np.random.default_rng(22).permutation(4097), device=dev)
    with torch.no_grad():
        some = mlpops.actor_critic_mlp(params, obs[:4097].contiguous())
        permuted = mlpops.actor_critic_mlp(params, obs[:4097][perm].contiguous())
        every = mlpops.actor_critic_mlp(params, obs)
        first = mlpops.actor_critic_mlp(params, obs[:1].contiguous())
    torch.cuda.synchronize()
    if not all(same_bits(p, x[perm]) for p, x in zip(permuted, some)):
        raise AssertionError(f"phase p {dims}: the forward of permuted rows is not the "
                             f"permuted forward")
    if not all(same_bits(f, x[:1]) for f, x in zip(first, every)):
        raise AssertionError(f"phase p {dims}: row 0 alone differs from row 0 of 65,536")


def check_mlp_kernels(dev, card) -> dict:
    """Phase p: ``ops.mlp.actor_critic_mlp``'s three kernels against the plain
    composition (``hold_mlp``) at ``MLP_TOWERS`` and ``MLP_ROWS``; through the unit
    index (``UNIT_BLOCKS``' rows and units, the main paths' towers) bitwise the
    kernels on the gathered rows; the refusals; the reduce's global norm
    (``check_grad_norm``). Returns what the kernels line needs of it: the kernels'
    errors by (towers, rows), and the norm's."""
    out = {}
    for i, dims in enumerate(MLP_TOWERS):
        for n in MLP_ROWS:
            out[dims, n] = hold_mlp(dims, n, dev, seed=100 * i + n % 97)
    for dims in ((19, 64, 64), (15, 64, 64)):
        for n, block in UNIT_BLOCKS.items():
            case = mlp_case(dims[0], dims[1:], n, seed=n)
            params, leaves, obs, g_mu, g_v = mlp_tensors(case, dev)
            units, ids = mlp_units(case, n, block, dev, seed=n + 1)
            got = mlp_run(mlpops.actor_critic_mlp, params, leaves, units, g_mu, g_v, ids)
            want = mlp_run(mlpops.actor_critic_mlp, params, leaves,
                           mbops.gather_units(units, ids), g_mu, g_v)
            torch.cuda.synchronize()
            if not all(same_bits(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"phase p {dims}: the unit index at {n} rows differs "
                                     f"from the gathered rows")
    for dims in MLP_TOWERS:
        mlp_row_invariance(dims, dev)
    mlp_refusals(dev)
    norm = check_grad_norm(dev, card)
    print(f"phase p: the MLP kernels within max({MLP_REL_FLOOR:g} x scale, "
          f"{MLP_CONTROL_FACTOR} x the two-halves control) of the plain composition at "
          f"{MLP_TOWERS} x {MLP_ROWS} rows (largest ratio "
          f"{max(r['ratio'] for r in out.values()):.3f}); through the unit index bitwise "
          f"the gathered rows at {tuple(UNIT_BLOCKS.items())}; the forward row-invariant "
          f"bitwise (4097 rows permuted, row 0 alone against 65,536); float64, non-contiguous, "
          f"other hidden widths and an obs_dim past a block's memory refused, on {card}")
    return out, norm


def mlp_bounds_ms(dims, n: int):
    """(forward, backward, recompute, reduce) bounds at ``n`` rows, each (ms, by):
    the forward's and the backward's multiply-adds (the backward's own: every weight
    gradient and the upper layers' input gradients) as the kernels run them, 3xTF32
    on the tensor cores (three TF32 products a multiply-add, 2 operations each, at
    ``PEAK_TF32_OPS_PER_S``), against their bytes (the observations, the upstream
    gradients, mu and v, the parameters, the blocks' partials); the forward that the
    backward kernel recomputes, its own line, at the forward's operations; the
    reduce's adds, and its bytes only where the partials outgrow ``L2_BYTES``: below
    that they are in the L2 (the backward wrote them just before), which the guide's
    table gives no rate for, so there the reduce is read against its launch floor
    (``time_mlp_kernels``); its operations are the adds, and the norm's square and add
    a parameter and add a block. Then the (forward, backward, recompute) bounds of the
    same multiply-adds as float32 FFMA."""
    d, h1, h2 = dims
    forward, backward = mlp_macs(d, h1, h2)
    params = 2 * (d * h1 + h1 + h1 * h2 + h2) + 3 * h2 + 3
    partial = 4 * _cuda.mlp_partial_rows(n) * params
    moved = (4 * (n * (d + 3) + params), 4 * (n * (d + 3) + params) + partial, 0)
    macs = (forward, backward, forward)
    tf32 = [bound_ms(b, 3 * 2 * n * m, PEAK_TF32_OPS_PER_S) for b, m in zip(moved, macs)]
    ffma = tuple(bound_ms(b, 2 * n * m)[0] for b, m in zip(moved, macs))
    reduce = bound_ms(partial + 4 * params if partial > L2_BYTES else 0,
                      _cuda.mlp_partial_rows(n) * params + 2 * params
                      + _cuda.mlp_grad_norm_blocks(params))
    return (*tf32, reduce), ffma


def mlp_occupancy(dims) -> dict:
    """The forward's and the backward's shared bytes and blocks an SM at ``dims``
    (the kernel's ``mlp_launch_plan``, and ``mlp_blocks_per_sm`` from the CUDA
    occupancy calculator), and whether the backward accumulates in shared memory."""
    import ctypes

    lib, plan = _cuda._mlp_lib(), (ctypes.c_longlong * 5)()
    err = lib.mlp_launch_plan(*dims, plan)
    if err:
        raise RuntimeError(f"mlp_launch_plan{dims}: cudaError {err}")
    return {"forward_shared_bytes": plan[1], "backward_shared_bytes": plan[3],
            "forward_blocks_per_sm": lib.mlp_blocks_per_sm(*dims, 0),
            "backward_blocks_per_sm": lib.mlp_blocks_per_sm(*dims, 1),
            "backward_accumulates_in_shared_memory": bool(plan[4])}


def time_mlp_kernels(dev, card, checked) -> list:
    """The kernels line's entries for ``mlp_forward``, ``mlp_backward`` and
    ``mlp_grad_reduce``: each launch eager and in a CUDA graph at the main paths'
    widths (65,536 and 16,384 rows; self-play's 19 inputs, single-car's 15, phase j's
    towers of 128), by row and through the unit index, beside the 3xTF32 bound and
    the FFMA one; the plain composition (cuBLAS, autograd), the forward
    eager and in a graph, the backward eager (a plain capture of autograd's backward
    failed on the card); the reduce as the main path launches it, with the global
    norm, beside the same launch without it, its norm-only mode over the flat,
    ``torch.sum`` over the blocks' partials (the one PyTorch call that sums them,
    never on the path), the ``ppo.global_norm`` composition over the 12 gradients
    that the norm replaces, in a graph, and the reduce's own launch floor (one row of
    one parameter, in a graph). The towers of 3 and 8 cars (23 and 43 inputs) too.
    ``checked``: ``check_mlp_kernels``' result."""
    checked, norm_checked = checked
    rows = {}
    one, one_out = torch.zeros((1, 1), device=dev), torch.empty((1,), device=dev)
    floor = graph_ms(lambda: _cuda.launch_mlp_grad_reduce(one, one_out))
    for dims, n in (((19, 64, 64), 65_536), ((19, 64, 64), 16_384), ((15, 64, 64), 65_536),
                    ((23, 64, 64), 65_536), ((43, 64, 64), 65_536), ((19, 128, 128), 65_536)):
        case = mlp_case(dims[0], dims[1:], n, seed=7)
        params, leaves, obs, g_mu, g_v = mlp_tensors(case, dev)
        units, ids = mlp_units(case, n, 64, dev, seed=8)
        w = [x.detach() for x in leaves]
        mu, v = torch.empty((n, 2), device=dev), torch.empty((n,), device=dev)
        partial = torch.empty((_cuda.mlp_partial_rows(n), sum(x.numel() for x in w)),
                              device=dev)
        flat, norm = torch.empty((partial.shape[1],), device=dev), torch.empty((), device=dev)
        fwd = lambda o=obs, i=None: _cuda.launch_mlp_forward(o, i, w, mu, v, n, dims)
        bwd = lambda o=obs, i=None: _cuda.launch_mlp_backward(o, i, w, g_mu, g_v, partial, n,
                                                              dims)
        red = lambda: _cuda.launch_mlp_grad_reduce(partial, flat, norm)
        bare = lambda: _cuda.launch_mlp_grad_reduce(partial, flat)
        only = lambda: _cuda.launch_mlp_grad_norm(flat, norm)
        with torch.no_grad():
            plain_f = lambda: mlpops.actor_critic_mlp_plain(params, obs)
            p_f = (per_launch_ms(plain_f), graph_ms(plain_f))
        mu_p, v_p = mlpops.actor_critic_mlp_plain(params, obs)
        plain_b = lambda: torch.autograd.grad((mu_p, v_p), leaves, (g_mu, g_v),
                                              retain_graph=True)
        library = lambda: torch.sum(partial, 0)
        bwd()
        red()
        views, at = [], 0
        for x in w:
            views.append(flat[at:at + x.numel()].view_as(x))
            at += x.numel()
        composition = lambda: ppo.global_norm(views)
        (f_b, b_b, c_b, r_b), (f_ffma, b_ffma, c_ffma) = mlp_bounds_ms(dims, n)
        r = rows[dims, n] = {
            "forward": (per_launch_ms(fwd), graph_ms(fwd), graph_ms(lambda: fwd(units, ids)),
                        *p_f, *f_b, f_ffma),
            "backward": (per_launch_ms(bwd), graph_ms(bwd), graph_ms(lambda: bwd(units, ids)),
                         per_launch_ms(plain_b), *b_b, c_b[0], b_ffma, c_ffma),
            "reduce": (per_launch_ms(red), graph_ms(red), per_launch_ms(library),
                       graph_ms(library), *r_b, floor, graph_ms(bare), graph_ms(only),
                       per_launch_ms(composition), graph_ms(composition))}
        f, b, rd = r["forward"], r["backward"], r["reduce"]
        print(f"phase p {dims} at {n} rows, us: forward {f[0] * 1e3:.2f} eager, "
              f"{f[1] * 1e3:.2f} in a graph ({f[2] * 1e3:.2f} by unit id), bound "
              f"{f[5] * 1e3:.2f} (3xTF32 on the tensor cores, {f[6]}; as FFMA "
              f"{f[7] * 1e3:.2f}), the "
              f"composition {f[3] * 1e3:.1f} eager, {f[4] * 1e3:.1f} in a graph; backward "
              f"{b[0] * 1e3:.2f} eager, {b[1] * 1e3:.2f} in a graph ({b[2] * 1e3:.2f} by unit "
              f"id), bound {b[4] * 1e3:.2f} (3xTF32, {b[5]}; the forward it recomputes "
              f"{b[6] * 1e3:.2f} more; as FFMA {b[7] * 1e3:.2f} + {b[8] * 1e3:.2f}), the "
              f"composition's backward {b[3] * 1e3:.1f} eager; reduce with the norm "
              f"{rd[0] * 1e3:.2f} eager, {rd[1] * 1e3:.2f} in a graph (without the norm "
              f"{rd[7] * 1e3:.2f}, the norm-only mode {rd[8] * 1e3:.2f}), bound "
              f"{rd[4] * 1e3:.3f} ({rd[5]}; {partial.numel() * 4 / 1e6:.1f} MB of partials), "
              f"launch floor "
              f"{rd[6] * 1e3:.2f} in a graph, torch.sum {rd[2] * 1e3:.2f} eager, "
              f"{rd[3] * 1e3:.2f} in a graph, the global_norm composition "
              f"{rd[9] * 1e3:.2f} eager, {rd[10] * 1e3:.2f} in a graph; "
              f"{mlp_occupancy(dims)}, on {card}")
    names = {"forward": ("ms", "graph_ms", "unit_index_graph_ms", "plain_ms", "plain_graph_ms",
                         "bound_ms", "bound_by", "ffma_bound_ms"),
             "backward": ("ms", "graph_ms", "unit_index_graph_ms", "plain_ms", "bound_ms",
                          "bound_by", "recompute_bound_ms", "ffma_bound_ms",
                          "recompute_ffma_bound_ms"),
             "reduce": ("ms", "graph_ms", "library_ms", "library_graph_ms", "bound_ms",
                        "bound_by", "launch_floor_ms", "without_norm_graph_ms",
                        "norm_only_graph_ms", "global_norm_ms", "global_norm_graph_ms")}
    ratio = max(c["ratio"] for c in checked.values())
    common = {"route": "cuda", "source": "self_play_racing_tpu_torch/csrc/mlp_towers.cu",
              "max_abs_err": max(c["max_abs_err"] for c in checked.values()),
              "max_err_over_bound": ratio, "rows": 65_536, "towers": [19, 64, 64]}

    def entry(name, key, replaces, **extra):
        main = dict(zip(names[key], rows[(19, 64, 64), 65_536][key]))
        return {"name": name, **common, "replaces": replaces, "library_ms": None,
                "plain_ms": main.get("library_ms"), **main, **extra,
                "at": {"x".join(map(str, dims)) + f"_{n}_rows": dict(zip(names[key],
                                                                         rows[dims, n][key]))
                       for dims, n in rows},
                "registers": kernel_registers(_cuda.build_report.get("mlp_towers", ""),
                                              f"{name}_kernel"),
                "occupancy": {"x".join(map(str, dims)): mlp_occupancy(dims)
                              for dims in MLP_TOWERS}}

    return [entry("mlp_forward", "forward", "self_play_racing_tpu/models/actor_critic.py:68"),
            entry("mlp_backward", "backward", "self_play_racing_tpu/agent/ppo.py:313"),
            entry("mlp_grad_reduce", "reduce", "self_play_racing_tpu/agent/ppo.py:313",
                  replaces_norm="self_play_racing_tpu/agent/ppo.py:121", **norm_checked)]


def train_more_cars(card, cars: int = 3) -> None:
    """``train scale --agents 3`` at its defaults, one update, in a temporary
    directory: its towers of 11 + 4 x 3 = 23 inputs take the MLP kernels once a
    minibatch step, the envs' kernels every step, and the saved policy has 23 finite
    inputs."""
    before = file_digests()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_counts()
            t0 = time.perf_counter()
            trainer = ttrain.main(["scale", "--agents", str(cars), "--num-updates", "1"])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = read_counts()
            params, _, _ = load_policy_bundle("models/self_play_agent_scale_1B.npz")
        finally:
            os.chdir(cwd)
    cfg, obs_dim = trainer.cfg, trainer.env_cfg.obs_dim
    # sensing: every step and the construction's reset
    expected = counts(cfg.num_envs, autoreset=True, multi_observe=cfg.num_steps + 1,
                      multi_transition=cfg.num_steps, compute_gae=1, mixbits_permutation=1,
                      **learner(launches, cfg, 1), **policy(cfg.num_steps, selfplay=True))
    w1 = params["actor"][0][0]
    print(f"phase p: train scale --agents {cars}: {cfg.num_envs} envs x {cfg.num_steps} "
          f"steps x {cars} cars, towers of {obs_dim} inputs, 1 update in {dt:.1f} s on "
          f"{card}; MLP kernels {[launches[k] for k in TOWERS]}; launches {launches}")
    if launches != expected or not launches["mlp_forward"]:
        raise AssertionError(f"train scale --agents {cars} launches {launches}, expected "
                             f"{expected}")
    if obs_dim != 11 + 4 * cars or tuple(w1.shape) != (obs_dim, 64) or not all(
            bool(torch.isfinite(torch.as_tensor(x)).all()) for tower in params.values()
            for layer in tower for x in layer):
        raise AssertionError(f"train scale --agents {cars}: saved policy {tuple(w1.shape)}, "
                             f"obs_dim {obs_dim}, or not finite")
    if file_digests() != before:
        raise AssertionError(f"train scale --agents {cars} wrote the repo's tracked files")


# ------------------------------------ phase (o): the single-car env step as two launches

# the env rows phase o holds the launches at: the adapter's batch of one, `train
# single`'s 16, a match's 48, an evaluation's 200 and the bench width
SINGLE_ROWS = (1, 16, FEW_ENVS, 200, NUM_ENVS)
# env index % 8 of the cars the observation's checks put 70 m off their track,
# facing it, so that walls lie beyond the sensors' range
OFF_TRACK_ROW = 6
# per car, the single-car transition's tail: the clip 4, progress and crash 3,
# delta 10, the reward's terms and selects 14, the checkpoints 12, the finish 9
SINGLE_TAIL_OPS_PER_CAR = 52
# per car, the observation's kinematic columns: cos and sin 2, two rotated components
# of 2 products and a sum, 2 scalings and 2 clamps of 2
SINGLE_OBS_OPS_PER_CAR = 14


def by_row_id(pool, envs):
    """The pool resident, env i reading pool row i % T: tiled where T divides
    ``envs``, else by the same ids as an arbitrary assignment."""
    if envs % pool.num_tracks == 0:
        return trk.tiled_pooled_tracks(pool, envs)
    return trk.pooled_tracks(pool, np.arange(envs) % pool.num_tracks)


def single_off_track(track, state):
    """``state`` with every env of index % 8 == OFF_TRACK_ROW 70 m off its track's
    first waypoint along the normal, facing back at it."""
    rows = trk.resolve(track)
    n = state.car.x.shape[0]
    sel = torch.arange(n, device=state.car.x.device) % 8 == OFF_TRACK_ROW
    nx, ny = rows.nrm_x[:, 0], rows.nrm_y[:, 0]
    car = state.car
    x = torch.where(sel, rows.wp_x[:, 0] + 70.0 * nx, car.x)
    y = torch.where(sel, rows.wp_y[:, 0] + 70.0 * ny, car.y)
    angle = torch.where(sel, torch.remainder(torch.atan2(-ny, -nx), 2 * np.pi), car.angle)
    return dataclasses.replace(state, car=dataclasses.replace(car, x=x, y=y, angle=angle))


def distinct(tensors) -> list:
    """The tensors, each once (an output two fields share is written once)."""
    return list({id(t): t for t in tensors}.values())


def single_step_bound(cfg, track, state, action, out, obs, extra=(0, 0)):
    """The bounds of ``single.transition`` and ``single.observe`` on these inputs:
    each input read once (the distinct rows of a layout once) and each output
    written once over 3.35 TB/s, against the operations the data needs (K2's search
    over each row's real waypoints, K5 and the tail; K1's fold over each row's real
    segments, up to its last one of nonzero direction, and the kinematic columns)
    over 67 TFLOP/s; ``extra`` (bytes, operations) the transition's beside them."""
    rows, row_ids = trk.rows_of(track)
    used = (rows.wp_x.shape[0] if row_ids is None
            else int(torch.unique(row_ids).numel()))
    n = state.car.x.shape[0]
    w, s, r = rows.wp_x.shape[-1], rows.seg_sx.shape[-1], cfg.num_sensors
    per_env = trk.scalars_of(track)
    fields = [getattr(state.car, f.name) for f in dataclasses.fields(state.car)] + [
        getattr(state, f.name) for f in dataclasses.fields(state) if f.name != "car"]
    t_in = nbytes(*fields, action, per_env.n_wp, per_env.track_width) + used * w * 2 * 4 \
        + 4 * n * 2 * 4  # the rows' positions, the normals at the corners' winners
    real_wp = int(per_env.n_wp.clamp(0, w).sum())
    t_ops = 5 * real_wp * K2_OPS_PER_PAIR + n * (K5_OPS_PER_CAR + SINGLE_TAIL_OPS_PER_CAR)
    transition = bound_ms(t_in + nbytes(*distinct(single_transition_fields(out).values()))
                          + extra[0], t_ops + extra[1])
    car = state.car
    o_in = nbytes(car.x, car.y, car.angle, car.vx, car.vy, state.last_steering) \
        + used * s * 5 * 4
    seg_vx, seg_vy = geo.pool_rows(row_ids, rows.seg_vx, rows.seg_vy)
    real = (seg_vx != 0) | (seg_vy != 0)
    real_segs = int(torch.where(real, torch.arange(1, s + 1, device=real.device), 0)
                    .amax(dim=-1).sum())
    o_ops = r * real_segs * K1_OPS_PER_PAIR + n * SINGLE_OBS_OPS_PER_CAR
    return transition, bound_ms(o_in + nbytes(obs), o_ops)


def single_counters():
    return (senv.transition_launches, senv.observe_launches, senv.transition_row_id_launches,
            senv.observe_row_id_launches, senv.transition_rows_launches,
            geo.raycast_walls_launches, dynamics.car_step_and_query_launches)


def multi_plan_observe():
    """The single-car observation at the multi-car plan for the block: one car a row,
    a warp a row's 11 rays."""
    def plan(num_sensors, num_segments, shared_row=False, rows=None):
        return _cuda.multi_observe_plan(1, num_sensors, num_segments)

    return _patched(_cuda, single_observe_plan=plan)


def forced_transition(by_rows):
    """The single-car transition by its kernel of several rows a block (``by_rows``
    True: at every width on the tiled layout, the only one it takes) or a warp a row
    (False: at every width), for the block; None: as the env picks."""
    if by_rows is None:
        return contextlib.nullcontext()
    return _patched(_cuda, SINGLE_TRANSITION_ROWS_FROM=0 if by_rows else sys.maxsize)


def single_issue_floors(track, cfg):
    """The issue floors of the single-car env step's launches on ``track``, as
    ``env_step_issue_floors`` counts them: the observation's fold, its warp-steps from
    each row's real extent in the plan's (row, run, group) items; the search of both
    transition kernels, its 32-waypoint chunks over each row's real waypoints, a warp
    a car; at one instruction a cycle on 132 SMs x 4 schedulers at the top SM clock,
    from this build's SASS. Returns ({kernel: floor_ms}, {kernel: instructions a step
    or None}, {kernel: (library, the instantiation's mangled-name fragment)}) for
    "single_observe", "single_transition" (a warp a row) and "single_transition_rows"
    (several rows a block)."""
    rows, row_ids = trk.rows_of(track)
    per_env = trk.scalars_of(track)
    seg_vx, seg_vy = geo.pool_rows(row_ids, rows.seg_vx, rows.seg_vy)
    s, w = seg_vx.shape[-1], rows.wp_x.shape[-1]
    real = (seg_vx != 0) | (seg_vy != 0)
    extents = torch.where(real, torch.arange(1, s + 1, device=real.device), 0).amax(dim=-1)
    tiled = isinstance(track, trk.TiledPooledTracks)
    plan = _cuda.single_observe_plan(cfg.num_sensors, s, tiled, per_env.n_wp.shape[0])
    if tiled:  # a block's rows are a period apart: the rows in block order
        period = rows.seg_vx.shape[0]
        extents = extents.reshape(-1, period).T.reshape(-1)
    groups = -(-cfg.num_sensors // plan.rays_per_lane)
    chunks = int((-(-per_env.n_wp.clamp(0, w) // 32)).sum())
    rate = 132 * 4 * top_sm_clock_hz()
    launched = {
        "single_observe": ("multi_observe",
                           f"multi_observe_kernelILi{plan.rays_per_lane}ELb{int(plan.per_car)}"
                           f"ELb{int(plan.shared_row)}E",
                           2 * plan.rays_per_lane,
                           observe_warp_steps(extents.tolist(), -(-s // 32), groups,
                                              plan.rows_per_block, plan.threads)),
        "single_transition": ("single_transition", "single_transition_kernel", 5, chunks),
        "single_transition_rows": ("single_transition", "single_transition_rows_kernel", 5,
                                   chunks)}
    floors, per_step, words = {}, {}, {}
    for name, (library, word, select, steps) in launched.items():
        per_step[name], _ = inner_loop(sass_loops(kernel_sass(library), word), select, word)
        words[name] = (library, word)
        if per_step[name]:
            floors[name] = steps * per_step[name] / rate * 1e3
    return floors, per_step, words


def check_single_env_step(pool, dev, card):
    """Phase o.1 and o.4: ``single.transition`` (``csrc/single_transition.cu``: a warp
    a row, and on the tiled layout from SINGLE_TRANSITION_ROWS_FROM rows its kernel of
    several rows a block, the step and the tail a thread a car, a block's rows sharing
    one staged pool row) and ``single.observe`` (the multi-car observation at one car a
    row without its car pass, a row's rays in four groups), one launch each, against
    their plain versions (the narrow kernels and PyTorch, what the env ran before
    these kernels) on ``crafted_single_state`` at 1, 16, 48, 200 and 4096 env rows of the
    canonical pool, gathered and by row id (tiled where 16 divides the rows), the
    speed weight the config's with the sensing unclamped and an annealed tensor with
    it clamped, every eighth car 70 m off its track for the observation, the
    transition as the env picks it and, on the tiled layout, by each kernel at every
    width: every output
    bitwise, each branch of the tail taken at 4096 (counts printed). Then each kernel
    timed at 4096 where the env runs it (the observation and the transition of several
    rows a block on the tiled pool, a warp a row gathered), eager (the wrapper's host
    work included) and in a CUDA graph, beside its plain version, bound and issue
    floor, with its registers; and at 4096, gathered and by row id, in turns: the
    observation at the multi-car plan (a warp a row's 11 rays) and the narrow K1 alone
    on its rays, the transition's two kernels. Returns the three kernels' entries."""
    widths = {envs: {"gathered": trk.gather_tracks(pool, np.arange(envs) % NUM_TRACKS),
                     "by row id": by_row_id(pool, envs)} for envs in SINGLE_ROWS}
    for envs, where, clamp in itertools.product(SINGLE_ROWS, ("gathered", "by row id"),
                                                (False, True)):
        track = widths[envs][where]
        what = f"phase o.1 {envs} envs {where}{', clamped, annealed' if clamp else ''}"
        cfg = senv.RacingConfig(num_sensors=11, max_steps=CRAFTED_MAX_STEPS,
                                clamp_sensor_range=clamp)
        state, action = crafted_single_state(track, cfg.max_steps, seed=envs, device=dev)
        sw = torch.tensor(5.3, device=dev) if clamp else None
        want = single_transition_fields(senv.transition_plain(cfg, track, state, action, sw))
        ids = int(where != "gathered")
        tiled = isinstance(track, trk.TiledPooledTracks)
        by_rows = int(tiled and envs >= _cuda.SINGLE_TRANSITION_ROWS_FROM)
        for force in (None, False, True) if tiled else (None,):
            before = single_counters()
            with forced_transition(force):
                out = senv.transition(cfg, track, state, action, speed_weight=sw)
            far = single_off_track(track, out[0])
            obs = senv.observe(cfg, track, far)
            rows = by_rows if force is None else int(force)
            if [c - b for c, b in zip(single_counters(), before)] != [
                    1, 1, ids, ids, rows, 0, 0]:
                raise AssertionError(f"{what}: the kernels' counters")
            bad = differing(single_transition_fields(out), want)
            plain_obs = senv.observe_plain(cfg, track, far)
            if bad or not same_bits(obs, plain_obs):
                raise AssertionError(f"{what}{', rows a block' if rows else ''}: "
                                     f"transition fields {bad} and "
                                     f"{int((obs != plain_obs).sum())} observation entries "
                                     "differ from the plain versions")
        branches = single_tail_branches(state, out)
        if envs == NUM_ENVS:
            missing = [k for k, v in branches.items() if v == 0]
            if missing:
                raise AssertionError(f"{what}: no env took {missing}")
        print(f"{what}: single.transition (the env's kernel: "
              f"{'several rows a block' if by_rows else 'a warp a row'}"
              f"{'; and each forced' if tiled else ''}) and "
              f"single.observe bitwise the plain versions; {int((obs[:, :11] > 1).sum())} "
              f"rays beyond the range; branches {branches}")

    cfg = senv.RacingConfig(num_sensors=11)
    sw = torch.tensor(5.3, device=dev)
    entries = []
    for name, where in (("single_transition", "gathered"),
                        ("single_transition_rows", "by row id"),
                        ("single_observe", "by row id")):
        track = widths[NUM_ENVS][where]
        state, action = crafted_single_state(track, cfg.max_steps, seed=7, device=dev)
        out = senv.transition(cfg, track, state, action, speed_weight=sw)
        obs = senv.observe(cfg, track, state)
        (t_bound, t_by), (o_bound, o_by) = single_step_bound(cfg, track, state, action, out,
                                                             obs)
        floors, per_step, words = single_issue_floors(track, cfg)
        if name == "single_observe":
            fn = functools.partial(senv.observe, cfg, track, state)
            plain = functools.partial(senv.observe_plain, cfg, track, state)
            replaces, b_ms, b_by = "self_play_racing_tpu/envs/single.py:126", o_bound, o_by
        else:
            fn = functools.partial(senv.transition, cfg, track, state, action, speed_weight=sw)
            plain = functools.partial(senv.transition_plain, cfg, track, state, action,
                                      speed_weight=sw)
            replaces, b_ms, b_by = "self_play_racing_tpu/envs/single.py:155", t_bound, t_by
        before = senv.transition_rows_launches
        ms, g_ms = per_launch_ms(fn), graph_ms(fn)
        if name.startswith("single_transition") and (
                (senv.transition_rows_launches > before) != (name == "single_transition_rows")):
            raise AssertionError(f"phase o.4: {name} is not the kernel the env runs {where}")
        plain_ms, plain_g = per_launch_ms(plain, windows=5, launches=5), graph_ms(plain)
        library, word = words[name]
        regs = kernel_registers(_cuda.build_report.get(library, ""), word)
        floor = floors.get(name)
        what = f"{NUM_ENVS} envs, {'tiled pool' if where == 'by row id' else 'gathered'}"
        print(f"phase o.4 {name} at {what}: {ms * 1e3:.2f} us eager back-to-back with the "
              f"wrapper's host work ({g_ms * 1e3:.2f} us in a CUDA graph), bound "
              f"{b_ms * 1e3:.2f} us ({b_by}), issue floor "
              f"{'not measured' if floor is None else f'{floor * 1e3:.2f} us'} "
              f"({per_step.get(name)} SASS instructions an inner-loop step); registers "
              f"{regs or 'not measured (cached build)'}; the plain version (the narrow "
              f"kernel and PyTorch) {plain_ms * 1e3:.1f} us eager, {plain_g * 1e3:.1f} us "
              f"in a CUDA graph on {card}")
        entries.append({"name": name, "route": "cuda",
                        "source": f"self_play_racing_tpu_torch/csrc/{library}.cu",
                        "replaces": replaces, "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms,
                        "plain_ms": plain_ms, "plain_graph_ms": plain_g, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": None, "issue_floor_ms": floor,
                        "registers": regs, "timed_at": what})
    # at 4096 rows, in turns with the multi-car observation plan and the narrow K1 alone on
    # the same rays (its inputs formed outside the timed calls), and the transition's
    # two kernels
    turns = {}
    for where in ("gathered", "by row id"):
        track = widths[NUM_ENVS][where]
        state, action = crafted_single_state(track, cfg.max_steps, seed=7, device=dev)
        rows, row_ids = trk.rows_of(track)
        car = state.car
        world = car.angle[:, None] + senv._sensor_angles(cfg, car.x.dtype, dev)[None, :]
        k1_in = (car.x[:, None].expand(world.shape), car.y[:, None].expand(world.shape),
                 torch.cos(world), torch.sin(world), rows.seg_sx[:, None, :],
                 rows.seg_sy[:, None, :], rows.seg_vx[:, None, :], rows.seg_vy[:, None, :],
                 cfg.max_sensor_range)
        observe = functools.partial(senv.observe, cfg, track, state)
        transition = functools.partial(senv.transition, cfg, track, state, action,
                                       speed_weight=sw)
        runs = {  # the call and what it runs under
            "single_observe": (observe, contextlib.nullcontext),
            "single_observe (the multi-car plan)": (observe, multi_plan_observe),
            "narrow K1": (lambda: geo.raycast_walls(*k1_in, seg_c=rows.seg_c[:, None, :],
                                                    row_ids=row_ids),
                          contextlib.nullcontext),
            "single_transition": (transition, lambda: forced_transition(False))}
        if isinstance(track, trk.TiledPooledTracks):  # the only layout it takes
            runs["single_transition_rows"] = (transition, lambda: forced_transition(True))
        times = {}
        for name in [*runs, *reversed(list(runs))]:
            fn, around = runs[name]
            with around():
                times.setdefault(name, []).append(round(graph_ms(fn) * 1e3, 2))
        turns[where] = times
    print(f"phase o.4 at {NUM_ENVS} envs, us in a CUDA graph, in turns (each in order, "
          f"then in reverse) on {card}: {turns}")
    for k in entries:
        kernel = k["name"].removesuffix("_rows")
        k["in_turns_graph_us"] = {w: {n: t for n, t in ts.items()
                                      if n.startswith(kernel)
                                      or (n == "narrow K1" and kernel == "single_observe")}
                                  for w, ts in turns.items()}
    return entries


def single_rollout_trainer(pool, dev):
    """Phase o.2's and r.2's single-car rollout: (trainer, log_std, noise, the vector
    env's generator state) of a ``PPOTrainer`` at 4096 envs on the tiled canonical
    pool, ``MODEL``'s parameters loaded, the speed-weight anneal's tensor (6.5) in its
    aux."""
    cfg = base_config(num_envs=NUM_ENVS, num_steps=STEPS,
                      total_timesteps=NUM_ENVS * STEPS * 100, anneal_speed_weight=True)
    trainer = PPOTrainer(cfg, senv.RacingConfig(num_sensors=11),
                         trk.tiled_pooled_tracks(pool, NUM_ENVS))
    agent, _ = interop.load_npz(MODEL, device=dev)
    with torch.no_grad():
        for p, q in zip(trainer.runner.train.model.parameters(), agent.parameters()):
            p.copy_(q)
    trainer.aux["speed_weight"] = trainer._f32(6.5)
    log_std = agent.log_std.detach().clone()
    noise = net.sample_noise((STEPS, NUM_ENVS, 2), torch.Generator(device=dev).manual_seed(4),
                             device=dev)
    return trainer, log_std, noise, trainer.runner.vec.generator.get_state()


def single_env_rollout(pool, dev, card):
    """Phase o.2 and o.3: a 256-step single-car rollout at 4096 envs on the tiled
    canonical pool, ``models/single_agent.npz``'s parameters loaded into a
    ``PPOTrainer`` with the speed-weight anneal's tensor in its aux: eagerly with
    every ``single.transition`` and ``single.observe`` call also run as its plain
    version on the same inputs (every output of every step bitwise); then graphed
    (``ppo.UpdateGraphs``, as the trainer runs it) with the two kernels and with the
    plain versions (the parent's composition): every step's buffers and the final
    state bitwise. Then the kernel nodes of one captured rollout step of each and its
    device time a step, in turns. The vector steps take the composition route (the
    transition's plain mode and the autoreset in PyTorch; phase r holds the fused
    route). Returns the node counts."""
    trainer, log_std, noise, gen_state = single_rollout_trainer(pool, dev)
    trainer.hooks = composed_hooks(trainer.hooks)

    flags = []
    t0 = time.perf_counter()
    with both_env_steps(flags, senv, single_transition_fields):
        eager, _ = rollout_with("kernel", trainer, log_std, noise, gen_state, graphed=False,
                                env=senv)
    calls = len(flags)
    bad = int(torch.stack(flags).sum()) if flags else -1
    # a step: one transition (its state's fields, reward, the two flags, info's eight
    # entries) and one observe (of the merged state)
    per_step = (len(dataclasses.fields(senv.CarState)) + len(dataclasses.fields(senv.RacingState))
                - 1 + 3 + 8 + 1)
    if bad != 0 or calls != STEPS * per_step:
        raise AssertionError(f"phase o.2: {bad} of {calls} outputs differ from the plain "
                             "versions over the eager rollout")
    print(f"phase o.2 eager rollout, {STEPS} steps x {NUM_ENVS} envs ({MODEL}, tiled pool, "
          f"speed weight 6.5 as a tensor): every output of every single.transition and "
          f"single.observe call ({calls} outputs) bitwise the plain versions on the same "
          f"inputs ({time.perf_counter() - t0:.1f} s); {int(eager['step ep_mask'].sum())} "
          f"episodes ended")
    runs = {}
    for env_step in ("kernel", "plain"):
        runs[env_step] = rollout_with(env_step, trainer, log_std, noise, gen_state,
                                      graphed=True, env=senv)
    (k_out, k_graphs), (p_out, p_graphs) = runs["kernel"], runs["plain"]
    for what, got in (("graphed plain", p_out), ("eager", eager)):
        bad = {k: int((k_out[k] != got[k]).sum()) for k in k_out if not same_bits(k_out[k], got[k])}
        if bad or k_out.keys() != got.keys():
            raise AssertionError(f"phase o.2: the graphed kernel rollout differs from the "
                                 f"{what} rollout in {bad}")
    print(f"phase o.2 graphed rollout ({STEPS} replays): the kernels' rollout bitwise the "
          f"graphed plain versions' and the eager rollout's, every step's {len(k_out)} "
          f"buffers and the final state")
    nodes = {}
    for env_step, graphs in (("kernel", k_graphs), ("plain", p_graphs), ("kernel", k_graphs),
                             ("plain", p_graphs)):
        nodes.setdefault(env_step, []).append(rollout_step_profile(graphs.rollout, STEPS))
    k_nodes = nodes["kernel"][0]["kernel_nodes"]
    p_nodes = nodes["plain"][0]["kernel_nodes"]
    print(f"phase o.3 one captured single-car rollout step ({NUM_ENVS} envs, tiled) on {card}: "
          f"kernel nodes {k_nodes} with the two env kernels against {p_nodes} with the plain "
          f"versions (the parent's env step), copy nodes {nodes['kernel'][0]['copy_nodes']} "
          f"and {nodes['plain'][0]['copy_nodes']} (counted from the graphs); the kernels' "
          f"time in one replay {profiled(nodes['kernel'][0])} and "
          f"{profiled(nodes['plain'][0])}; "
          f"a step between CUDA events over {STEPS} replays, in turns kernel, plain, kernel, "
          f"plain: {[round(r['ms_per_step'], 4) for r in nodes['kernel']]} ms and "
          f"{[round(r['ms_per_step'], 4) for r in nodes['plain']]} ms")
    if p_nodes - k_nodes < 40:
        raise AssertionError(f"phase o.3: {k_nodes} kernel nodes a step against {p_nodes}; "
                             "expected at least 40 fewer")
    # the anneal as the trainer runs it: a new weight tensor each update, which makes
    # the captured rollout capture again and take the weight in by copy from then on;
    # the second rollout replays that graph and must see its own weight
    for weight in (9.25, 10.0):
        trainer.aux["speed_weight"] = trainer._f32(weight)
        replayed, k_graphs = rollout_with("kernel", trainer, log_std, noise, gen_state,
                                          graphed=True, env=senv, graphs=k_graphs)
    if ("speed_weight",) not in k_graphs.rollout.aux.copied:
        raise AssertionError("phase o.2: the rollout graph does not copy the speed weight in")
    eager, _ = rollout_with("kernel", trainer, log_std, noise, gen_state, graphed=False,
                            env=senv)
    bad = {k: int((replayed[k] != eager[k]).sum()) for k in eager
           if not same_bits(replayed[k], eager[k])}
    moved = [k for k in k_out if not same_bits(k_out[k], replayed[k])]
    if bad or replayed.keys() != eager.keys() or not moved:
        raise AssertionError(f"phase o.2: the replay at speed weight 10.0 differs from the "
                             f"eager rollout in {bad}, or from the one at 6.5 in none")
    print(f"phase o.2 anneal: the captured rollout replayed with a new speed-weight tensor "
          f"(10.0, taken in by copy) bitwise the eager rollout at 10.0, and apart from the "
          f"rollout at 6.5 in {moved}")
    return nodes


# -------------------------- phase (r): the NEXT_STEP autoreset in the transition kernels

# phase r.1's cases: their rollout buffers' rows (the step writes AUTORESET_T; the other
# rows hold what the case put there), the env rows and the pool's slots
AUTORESET_STEPS = 4
AUTORESET_T = 2
AUTORESET_ROWS = (16, FEW_ENVS, NUM_ENVS)
AUTORESET_POOL = 5
# per env row, the autoreset's operations (the return's add, the length's, the
# selects of the record, the stats and the rows, the masks), and per car the start
# grid's four
AUTORESET_OPS_PER_ROW = 12
AUTORESET_OPS_PER_CAR = 4
# the four entries: (env, layout, env rows, cars) where phase r.3 times them, as the
# env picks the kernel there
AUTORESET_TIMED = {
    "single_transition_autoreset": ("single", "gathered", NUM_ENVS, 1),
    "single_transition_rows_autoreset": ("single", "tiled", NUM_ENVS, 1),
    "multi_transition_autoreset": ("multi", "tiled", NUM_ENVS, NUM_AGENTS),
    "multi_transition_small_autoreset": ("multi", "tiled", FEW_ENVS, NUM_AGENTS),
}


def autoreset_inputs(n, dev, seed, pending, pfsp=None):
    """(pending_reset, stats, rows, pfsp) of a phase r.1 case at ``n`` env rows: the
    rows that reset on none, some (40%) or all of them; a running return and length;
    the rollout's [AUTORESET_STEPS, n] buffers filled with noise, their row
    AUTORESET_T the step's; with ``pfsp`` ("one" or "per env") the pool's
    AUTORESET_POOL slots (an index int64 0-d, or int32 per env with some out of the
    pool; use_policy likewise), ``extra`` at whole counts and the kernel's count
    scratch, zero."""
    rng = np.random.default_rng(seed)
    mask = {"none": np.zeros(n, bool), "all": np.ones(n, bool),
            "some": rng.random(n) < 0.4}[pending]

    def t(v, dtype):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype, device=dev)

    pending_reset = t(mask, torch.bool)
    stats = vector.EpisodeStats(t(rng.normal(0.0, 50.0, n), torch.float32),
                                t(rng.integers(0, 500, n), torch.int32))
    out = {}
    vector.rollout_buffers(out, AUTORESET_STEPS,
                           vector.VecState(None, pending_reset, stats, None))
    for k, v in out.items():
        v.copy_(t(rng.integers(0, 2, v.shape) if v.dtype == torch.bool
                  else rng.integers(-9, 9, v.shape), v.dtype))
    rows = vector.RolloutRows(out, t([AUTORESET_T], torch.int64),
                              t(rng.random(n) < 0.5, torch.bool),
                              torch.empty((1,), dtype=torch.int64, device=dev))
    if pfsp is None:
        return pending_reset, stats, rows, None
    p = AUTORESET_POOL
    if pfsp == "per env":
        idx, use = t(rng.integers(-1, p + 1, n), torch.int32), t(rng.random(n) < 0.8, torch.bool)
    else:
        idx = torch.tensor(2, dtype=torch.int64, device=dev)
        use = torch.tensor(True, device=dev)
    return pending_reset, stats, rows, menv.PFSP(
        idx, use, t(rng.integers(0, 999, 2 * p), torch.float32),
        torch.zeros((2 * p + 1,), dtype=torch.int32, device=dev))


def autoreset_copy(inputs):
    """``inputs`` with the buffers the step writes cloned, so that two runs start
    from the same rows and counts."""
    pending_reset, stats, rows, pfsp = inputs
    rows = vector.RolloutRows({k: v.clone() for k, v in rows.out.items()}, rows.t,
                              rows.entering, torch.empty_like(rows.t_next))
    if pfsp is not None:
        pfsp = pfsp._replace(extra=pfsp.extra.clone(), counts=pfsp.counts.clone())
    return pending_reset, stats, rows, pfsp


def autoreset_calls(kind, cfg, track, state, action, inputs, slots=None, sw=None,
                    copy=True):
    """(fused, composed): the two runs of one phase r case, each returning (its
    ``vector.StepOut``, its inputs); on ``inputs``' copies where ``copy`` (else on
    ``inputs``, as the timings run them). ``fused`` is the env's
    ``transition_autoreset`` (the kernel's autoreset mode); ``composed`` the same
    kernel's plain mode (``transition``) followed by today's PyTorch glue
    (``transition_autoreset_plain`` with ``transition_plain`` patched to the kernel),
    called explicitly."""
    def args():
        return autoreset_copy(inputs) if copy else inputs

    def fused():
        pending_reset, stats, rows, pfsp = copy = args()
        if kind == "single":
            out = senv.transition_autoreset(cfg, track, state, action, pending_reset, stats,
                                            sw, rows)
        else:
            out = menv.transition_autoreset(cfg, track, state, action, pending_reset, stats,
                                            slots, rows, pfsp)
        return out, copy

    def composed():
        pending_reset, stats, rows, pfsp = copy = args()
        if kind == "single":
            out = composed_single(cfg, track, state, action, pending_reset, stats, sw, rows)
        else:
            out = composed_multi(cfg, track, state, action, pending_reset, stats, slots, rows,
                                 pfsp)
        return out, copy

    return fused, composed


def composed_single(cfg, track, state, action, pending_reset, stats, speed_weight=None,
                    rows=None):
    """``single.transition_autoreset`` as the composition: ``single.transition`` (the
    kernel's plain mode, or what a phase puts in its place) and the PyTorch glue,
    ``single.autoreset_plain``."""
    return senv.autoreset_plain(
        cfg, track, senv.transition(cfg, track, state, action, speed_weight=speed_weight),
        pending_reset, stats, rows)


def composed_multi(cfg, track, state, action, pending_reset, stats, position_idx, rows=None,
                   pfsp=None):
    """``multi.transition_autoreset`` as the composition: ``multi.transition`` and
    ``multi.autoreset_plain``."""
    return menv.autoreset_plain(cfg, track, menv.transition(cfg, track, state, action),
                                pending_reset, stats, position_idx, rows, pfsp)


def composed_hooks(hooks):
    """``hooks`` (a trainer's) with their step on the composition route: the envs'
    ``transition_autoreset`` replaced, for each call, by ``composed_single`` and
    ``composed_multi``, so that the vector step runs the transition's plain mode and
    the PyTorch glue in place of its autoreset mode."""
    def step(*args):
        with _patched(senv, transition_autoreset=composed_single), \
                _patched(menv, transition_autoreset=composed_multi):
            return hooks.step(*args)

    return hooks._replace(step=step)


def autoreset_leaves(run) -> dict:
    """Every tensor a run wrote or returned, by place: the step's outputs, the
    rollout's buffers, t + 1 and the PFSP counts."""
    out, (_, _, rows, pfsp) = run
    leaves = {f"step {p}": v for p, v in _graph.tensor_leaves(out)}
    leaves.update({f"rows {k}": v for k, v in rows.out.items()})
    leaves["t_next"] = rows.t_next
    if pfsp is not None:
        leaves["extra"] = pfsp.extra
    return leaves


def autoreset_counters():
    return (senv.transition_autoreset_launches, senv.transition_autoreset_rows_launches,
            menv.transition_autoreset_launches, menv.transition_autoreset_small_launches)


def autoreset_bytes_ops(inputs, n, cars, multi, out) -> tuple:
    """(bytes, operations) the autoreset adds to its transition's: its inputs read
    once (the pending flags, the running return and length, the start pose and on
    the multi-car env its normal and the grid slots, the entering flags and t) and its
    outputs written once (done, the next pending flags, the record, the stats, the
    rows' five entries a row, t + 1, the counts read and written into ``extra``)."""
    pending_reset, stats, rows, pfsp = inputs
    b = nbytes(pending_reset, stats.ep_return, stats.ep_length, rows.entering, rows.t,
               rows.t_next, out.done, out.pending_reset, out.record["return"],
               out.record["length"], out.stats.ep_return, out.stats.ep_length)
    b += n * 4 * 3 + (n * 4 * 2 + n * cars * 8 if multi else 0)
    b += sum(v[0].numel() * v.element_size() for v in rows.out.values())
    if pfsp is not None:
        b += 2 * nbytes(pfsp.extra) + nbytes(pfsp.idx, pfsp.use_policy)
    return b, n * AUTORESET_OPS_PER_ROW + n * cars * AUTORESET_OPS_PER_CAR


def autoreset_setup(kind, track, cars, envs, dev, seed, max_steps=CRAFTED_MAX_STEPS):
    """(cfg, state, action, slots, speed weight) of a phase r case: ``crafted_state``
    (its rows finish, crash and truncate this step) of ``kind`` ("single" or
    "multi"), the multi-car env's grid slots drawn, the single-car speed weight a
    tensor on the card."""
    if kind == "single":
        cfg = senv.RacingConfig(num_sensors=11, max_steps=max_steps)
        state, action = crafted_single_state(track, cfg.max_steps, seed, device=dev)
        return cfg, state, action, None, torch.tensor(5.3, device=dev)
    cfg = menv.MultiRacingConfig(num_agents=cars, num_sensors=11, max_steps=max_steps)
    state, action = crafted_state(track, cars, cfg.max_steps, seed, device=dev)
    slots = menv.random_grid_slots(envs, cars, torch.Generator(device=dev).manual_seed(seed),
                                   device=dev)
    return cfg, state, action, slots, None


def autoreset_case(kind, track, cars, envs, pending, pfsp, dev, seed):
    """One phase r.1 case: the fused run against the composition, every output,
    buffer row, t + 1 and ``extra`` bitwise, and one autoreset launch, by the kernel
    the env picks at ``envs`` rows on ``track`` (AssertionError otherwise). Returns
    (the fused run's ``vector.StepOut``, its inputs, the case's inputs)."""
    cfg, state, action, slots, sw = autoreset_setup(kind, track, cars, envs, dev, seed)
    inputs = autoreset_inputs(envs, dev, seed, pending, pfsp)
    fused, composed = autoreset_calls(kind, cfg, track, state, action, inputs, slots, sw)
    what = (f"{kind} {cars} car{'s' if cars > 1 else ''} x {envs} envs "
            f"{type(track).__name__}, pending {pending}, pool index {pfsp}")
    before = autoreset_counters()
    got = fused()
    ran = [a - b for a, b in zip(autoreset_counters(), before)]
    want = composed()
    if [a - b for a, b in zip(autoreset_counters(), before)] != ran:
        raise AssertionError(f"phase r.1 {what}: the composition ran the autoreset mode")
    small = kind == "multi" and envs < _cuda.TRANSITION_SMALL_BELOW
    by_rows = (kind == "single" and isinstance(track, trk.TiledPooledTracks)
               and envs >= _cuda.SINGLE_TRANSITION_ROWS_FROM)
    first = 0 if kind == "single" else 2
    expect = [0, 0, 0, 0]
    expect[first] = 1
    expect[first + 1] = int(small or by_rows)
    if ran != expect:
        raise AssertionError(f"phase r.1 {what}: autoreset launches {ran}, expected {expect}")
    g, w = autoreset_leaves(got), autoreset_leaves(want)
    bad = [k for k in w if k not in g or not same_bits(g[k].contiguous(), w[k])]
    if bad or g.keys() != w.keys():
        raise AssertionError(f"phase r.1 {what}: {bad} differ from the composition")
    return got[0], got[1], inputs


def autoreset_graphed(kind, track, cars, envs, dev, seed=31) -> None:
    """The autoreset mode captured in a CUDA graph and replayed once gives the eager
    launch's bits in every output, buffer row, t + 1 and ``extra`` (the PFSP counts
    left at 0 by every launch, so a replay needs no memset)."""
    cfg, state, action, slots, sw = autoreset_setup(kind, track, cars, envs, dev, seed)
    inputs = autoreset_inputs(envs, dev, seed, "some", "per env" if kind == "multi" else None)
    eager = autoreset_calls(kind, cfg, track, state, action, inputs, slots, sw)[0]()
    static = autoreset_copy(inputs)
    fused = autoreset_calls(kind, cfg, track, state, action, static, slots, sw, copy=False)[0]
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fused()
    graph.replay()
    torch.cuda.synchronize()
    g, w = autoreset_leaves(captured), autoreset_leaves(eager)
    bad = [k for k in w if not same_bits(g[k].contiguous(), w[k])]
    if bad:
        raise AssertionError(f"phase r {kind} {envs} envs: the graph replay differs from the "
                             f"eager launch in {bad}")


def check_autoreset(pool, dev, card) -> list:
    """Phase r.1 and r.3: the four transition entries in their autoreset mode
    (``csrc/autoreset.cuh``: the NEXT_STEP reset, the merge, the reset info, the masks,
    the episode statistics, the rollout's rows of the step and the PFSP counts in the
    transition's launch) against the composition on the card: the same kernel's plain
    mode and the PyTorch glue (``autoreset_calls``). On ``crafted_state`` (rows that
    finish, crash and truncate this step) with pending resets on none, some and all
    rows, at 16 and 48 env rows (a warp a row, the first multi-car kernel) and 4096
    (the single-car kernel of several rows a block on the tiled pool, a warp a row
    gathered, the redesigned multi-car kernel), gathered and tiled, 1 and 2 cars, the
    pool's index one for all and per env: every state field, info, reward, flag,
    record, buffer row, t + 1 and ``extra`` bitwise (-0.0 apart from 0.0), one
    autoreset launch each, the plain mode's for the composition. Then each entry timed
    where ``AUTORESET_TIMED`` says, eager (with the wrapper's host work) and in a CUDA
    graph, beside the composition, the plain mode alone and its bound. Returns the
    kernels line's four entries."""
    layouts = {}
    cases = 0
    for envs, where in itertools.product(AUTORESET_ROWS, ("gathered", "tiled")):
        layouts[envs, where] = (trk.tiled_pooled_tracks(pool, envs) if where == "tiled"
                                else trk.gather_tracks(pool, np.arange(envs) % NUM_TRACKS))
    for (envs, where), track in layouts.items():
        seen = collections.Counter()
        for kind, cars, pending, pfsp in itertools.chain(
                (("single", 1, p, None) for p in ("none", "some", "all")),
                (("multi", a, p, m) for a in (1, NUM_AGENTS) for p in ("none", "some", "all")
                 for m in ("one", "per env"))):
            out, ran_inputs, inputs = autoreset_case(kind, track, cars, envs, pending, pfsp,
                                                     dev, seed=1000 + cases)
            seen["cases"] += 1
            seen["reset rows"] += int(inputs[0].sum())
            seen["done rows"] += int(out.done.sum())
            seen["truncated rows"] += int(out.truncated.sum())
            if pfsp is not None:
                seen["pfsp counts"] += int((ran_inputs[3].extra - inputs[3].extra).sum())
            cases += 1
        if not (seen["done rows"] and seen["truncated rows"] and seen["reset rows"]
                and seen["pfsp counts"]):
            raise AssertionError(f"phase r.1 {envs} envs {where}: a branch untaken {seen}")
        print(f"phase r.1 {envs} envs {where}: the autoreset mode bitwise the composition "
              f"(the plain mode and the PyTorch glue) in every output, buffer row, t + 1 "
              f"and extra; {dict(seen)}")
    for kind, where, envs, cars in AUTORESET_TIMED.values():
        autoreset_graphed(kind, layouts[envs, where], cars, envs, dev)
    print("phase r.1: each entry's autoreset mode graphed bitwise eager")

    entries = []
    for name, (kind, where, envs, cars) in AUTORESET_TIMED.items():
        track = layouts[envs, where]
        seed = 77
        cfg, state, action, slots, sw = autoreset_setup(kind, track, cars, envs, dev, seed,
                                                        max_steps=3000)
        if kind == "single":
            plain_mode = functools.partial(senv.transition, cfg, track, state, action,
                                           speed_weight=sw)
        else:
            plain_mode = functools.partial(menv.transition, cfg, track, state, action)
        inputs = autoreset_inputs(envs, dev, seed, "some",
                                  "per env" if kind == "multi" else None)
        fused, composed = autoreset_calls(kind, cfg, track, state, action, inputs, slots, sw,
                                          copy=False)
        before = autoreset_counters()
        out = fused()[0]
        ran = [a - b for a, b in zip(autoreset_counters(), before)]
        if name.endswith(("_rows_autoreset", "_small_autoreset")) != (ran[1] + ran[3] == 1):
            raise AssertionError(f"phase r.3: {name} is not the kernel the env runs here")
        plain_out = plain_mode()
        if kind == "single":
            obs = senv.observe(cfg, track, out.env)
            extra = autoreset_bytes_ops(inputs, envs, 1, False, out)
            (b_ms, b_by), _ = single_step_bound(cfg, track, state, action, plain_out, obs,
                                                extra)
        else:
            obs = menv.observe(cfg, track, out.env)
            extra = autoreset_bytes_ops(inputs, envs, cars, True, out)
            (b_ms, b_by), _ = env_step_bound(cfg, track, state, action,
                                             transition_fields(plain_out).values(), obs, extra)
        ms, g_ms = per_launch_ms(fused), graph_ms(fused)
        plain_ms, plain_g = (per_launch_ms(composed, windows=5, launches=5),
                             graph_ms(composed))
        mode_g = graph_ms(plain_mode)
        # the multi-car entries also without the pool: what the PFSP counts and their
        # ticket cost
        no_pool = None if kind == "single" else graph_ms(autoreset_calls(
            kind, cfg, track, state, action, inputs[:3] + (None,), slots, sw, copy=False)[0])
        what = f"{envs} envs x {cars} car{'s' if cars > 1 else ''}, {where}"
        print(f"phase r.3 {name} at {what}: {ms * 1e3:.2f} us eager back-to-back with the "
              f"wrapper's host work, {g_ms * 1e3:.2f} us in a CUDA graph; its plain mode "
              f"alone {mode_g * 1e3:.2f} us in a graph"
              f"{'' if no_pool is None else f', without the pool {no_pool * 1e3:.2f} us'}; "
              f"bound {b_ms * 1e3:.2f} us ({b_by}, "
              f"{extra[0]:,} bytes of it the autoreset's); the composition it replaces (the "
              f"plain mode and the PyTorch glue) {plain_ms * 1e3:.1f} us eager, "
              f"{plain_g * 1e3:.1f} us in a CUDA graph, on {card}")
        library = "single_transition" if kind == "single" else (
            "car_step_and_query" if envs < _cuda.TRANSITION_SMALL_BELOW else "multi_transition")
        replaces = ["self_play_racing_tpu/envs/vector.py:57",
                    "self_play_racing_tpu/agent/ppo.py:373-385"]
        if kind == "multi":
            replaces.append("self_play_racing_tpu/agent/self_play.py:65")
        entries.append({"name": name, "route": "cuda",
                        "source": f"self_play_racing_tpu_torch/csrc/{library}.cu",
                        "replaces": replaces[0], "also_replaces": replaces[1:],
                        "max_abs_err": 0.0, "ms": ms, "graph_ms": g_ms, "plain_ms": plain_ms,
                        "plain_graph_ms": plain_g, "plain_mode_graph_ms": mode_g,
                        "no_pool_graph_ms": no_pool,
                        "bound_ms": b_ms, "bound_by": b_by, "autoreset_bytes": extra[0],
                        "library_ms": None, "timed_at": what, "cases_checked": cases})
    return entries


def autoreset_rollouts(pool, dev, card) -> dict:
    """Phase r.2: 256-step rollouts at the slice's full width, graphed as the trainer
    runs them (``ppo.UpdateGraphs``), each through the vector step's fused route (the
    transition's autoreset mode) and through the composition (``composed_hooks``: the
    plain mode and the PyTorch glue): self-play at 4096 envs x 2 cars on the tiled
    canonical pool with pool opponents per env (phase m.2's), and single-car at 4096
    envs (phase o.2's, the speed weight a tensor), each from ``crafted_state`` with
    pending resets on 40% of the rows, so that rows reset at the first step and end
    at it (the crafted rows that finish, crash and truncate), and drive on after.
    Every step's buffers, ``extra`` and the final state bitwise; the fused route launches the autoreset mode once a step
    and the composition never. Then one captured rollout step of each route: its
    kernel and copy nodes and its device ms a step, in turns fused, composed, fused,
    composed. Returns the node counts by env."""
    results = {}
    for env, make, kernel in (("self-play", selfplay_rollout_trainer,
                               "multi_transition_autoreset"),
                              ("single-car", single_rollout_trainer,
                               "single_transition_autoreset")):
        trainer, log_std, noise, gen_state = make(pool, dev)
        track, runner = trainer.aux["track"], trainer.runner
        if env == "self-play":
            inner, _ = crafted_state(track, NUM_AGENTS, trainer.env_cfg.max_steps, 17,
                                     device=dev)
            state = selfplay.SelfPlayState(inner=inner,
                                           obs_all=menv.observe(trainer.env_cfg, track, inner))
        else:
            state, _ = crafted_single_state(track, trainer.env_cfg.max_steps, 17, device=dev)
        pending = autoreset_inputs(NUM_ENVS, dev, 17, "some")[0]
        trainer.runner = dataclasses.replace(runner, vec=dataclasses.replace(
            runner.vec, env=state, pending_reset=pending))
        hooks = {"fused": trainer.hooks, "composed": composed_hooks(trainer.hooks)}
        runs, launches = {}, {}
        for route in ("fused", "composed"):
            trainer.hooks = hooks[route]
            zero_counts()
            runs[route] = rollout_with("kernel", trainer, log_std, noise, gen_state,
                                       graphed=True)
            launches[route] = read_counts()[kernel]
        (f_out, f_graphs), (c_out, c_graphs) = runs["fused"], runs["composed"]
        bad = [k for k in c_out if k not in f_out or not same_bits(f_out[k], c_out[k])]
        if bad or f_out.keys() != c_out.keys():
            raise AssertionError(f"phase r.2 {env}: the fused rollout differs from the "
                                 f"composed one in {bad}")
        if launches != {"fused": STEPS, "composed": 0}:
            raise AssertionError(f"phase r.2 {env}: {kernel} launches {launches}")
        nodes = {}
        for route, graphs in (("fused", f_graphs), ("composed", c_graphs),
                              ("fused", f_graphs), ("composed", c_graphs)):
            nodes.setdefault(route, []).append(rollout_step_profile(graphs.rollout, STEPS))
        results[env] = nodes
        f0, c0 = nodes["fused"][0], nodes["composed"][0]
        print(f"phase r.2 {env} rollout, {STEPS} steps x {NUM_ENVS} envs, graphed: fused "
              f"bitwise composed in every step's {len(f_out)} buffers, extra and the final "
              f"state ({int(f_out['step ep_mask'].sum())} episodes ended); {kernel} "
              f"{launches['fused']} launches; one captured rollout step on {card}: kernel "
              f"nodes {f0['kernel_nodes']} fused against {c0['kernel_nodes']} composed, copy "
              f"nodes {f0['copy_nodes']} and {c0['copy_nodes']} (counted from the graphs), "
              f"the kernels' time in one replay {profiled(f0)} and {profiled(c0)}; a step between "
              f"CUDA events over {STEPS} replays, in turns fused, composed, fused, composed: "
              f"{[round(r['ms_per_step'], 4) for r in nodes['fused']]} ms and "
              f"{[round(r['ms_per_step'], 4) for r in nodes['composed']]} ms")
        if c0["kernel_nodes"] - f0["kernel_nodes"] < 20:
            raise AssertionError(f"phase r.2 {env}: {f0['kernel_nodes']} kernel nodes a step "
                                 f"against {c0['kernel_nodes']}; expected at least 20 fewer")
    return results


# ------------------------------------------ phase (q): the rollout step's policy

# Kernel A (policy_act) and kernel B (pool_act) run their towers with the minibatch
# forward's device code (csrc/mlp_tower.cuh): mu and v are held to the plain
# composition (cuBLAS) within phase p's rule, max(MLP_REL_FLOOR x the tensor's scale,
# MLP_CONTROL_FACTOR x the composition's own distance with the rows in two halves).
# Everything after the towers is bitwise the composition applied to the kernels' own
# mu, and kernel A's mu and v bitwise mlp_forward's on the same rows.
POLICY_ROWS = (1, 64, 4096, 4097, 8192)
POLICY_STEPS = 3         # a case's noise and buffer rows; the kernel writes row POLICY_T
POLICY_T = 1
POLICY_SENTINEL = 7.0    # what the buffers' other rows hold: the kernel leaves them
POOL_MEMBERS = 5         # phase 10's pool
# (envs, opponent seats) of kernel B's cases: phase 10's 4096 x 1 and its neighbours,
# 3 cars and 8
POOL_SHAPES = ((1, 1), (64, 1), (4096, 1), (4097, 1), (8192, 1), (2048, 2), (512, 7))
POOL_MODES = ("per env", "one", "seat")
# the towers of the bundles the paths run: single-car 15 inputs, self-play 19, 3 cars
# 23, 8 cars 43, at (64, 64); phase j's (128, 128)
POLICY_TOWERS = ((15, 64, 64), (19, 64, 64), (23, 64, 64), (43, 64, 64), (19, 128, 128))
# kernel B's per-env index at the members the trainer's path meets (use_policy all
# True): uniform over the pool, one member on >= 80% of the envs, two live slots of
# five; members in runs of envs, each absent from whole ranges of a block; and the
# empty pool's index (all zeros, use_policy all False: every action random)
POOL_DISTRIBUTIONS = ("uniform", "skewed", "two live", "runs", "all random")


def policy_case(dims, n: int, seed: int, dev) -> dict:
    """``mlp_case``'s towers and observations at ``dims`` and ``n`` rows on ``dev``,
    with a normaliser (mean ~ N(0, 0.5), var ~ U(0.05, 2), feature 0's 1e-4 so that
    its values pass the +-10 clamp), log_std [-0.4, -0.9], noise [POLICY_STEPS, n, 2]
    ~ N(0, 1) and ``t`` = POLICY_T (int64 [1])."""
    d, h1, h2 = dims
    case = mlp_case(d, (h1, h2), n, seed)
    rng = np.random.default_rng(seed + 7)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    var = rng.uniform(0.05, 2.0, d)
    var[0] = 1e-4
    return {"params": {tower: [tuple(f32(a) for a in layer) for layer in layers]
                       for tower, layers in case["params"].items()},
            "obs": f32(case["obs"]),
            "norm": obsnorm.ObsNormState(f32(rng.normal(0.0, 0.5, d)), f32(var), None),
            "log_std": f32([-0.4, -0.9]),
            "noise": f32(rng.standard_normal((POLICY_STEPS, n, 2))),
            "t": torch.full((1,), POLICY_T, dtype=torch.int64, device=dev)}


def policy_buffers(n: int, d: int, dev) -> dict:
    """The rollout's obs, actions, log-probs and values buffers, POLICY_SENTINEL."""
    out = polops.rollout_buffers({}, POLICY_STEPS, torch.empty((n, d), device=dev))
    for v in out.values():
        v.fill_(POLICY_SENTINEL)
    return out


def halves(fn, x):
    """``fn`` on the rows of ``x`` in two halves, concatenated: the control."""
    h = x.shape[0] // 2
    return torch.cat([fn(x[:h]), fn(x[h:])])


def hold_towers(got, plain, control, what: str) -> list:
    """``got`` (the kernels' mu, v) within phase p's rule of ``plain``; returns each
    (error, bound)."""
    errs, bounds = mlp_errors(got, plain), mlp_bounds(plain, control)
    bad = [(e, b) for e, b in zip(errs, bounds) if not e <= b]
    if bad:
        raise AssertionError(f"phase q {what}: beyond the tolerance (error, bound): {bad}")
    return list(zip(errs, bounds))


def untouched(buf, what: str) -> None:
    """The buffer's rows other than POLICY_T still hold POLICY_SENTINEL."""
    others = torch.cat([buf[:POLICY_T], buf[POLICY_T + 1:]])
    if not bool((others == POLICY_SENTINEL).all()):
        raise AssertionError(f"phase q {what}: the kernel wrote outside row {POLICY_T}")


def hold_policy_act(dims, n: int, dev, seed: int) -> list:
    """Kernel A at ``dims`` and ``n`` rows, without and with the normaliser: its mu
    (greedy, the actor alone; the same with the critic given) and v within phase p's
    rule of the composition, and bitwise ``mlp_forward``'s on the rows it wrote; the
    rollout mode's obs row bitwise ``obsnorm.apply``, its action and log-prob rows
    bitwise the composition's sample and log-prob on the kernel's mu (and so its
    returned action, ``sample_action``'s with and without a critic, the sampled
    ``policy_action``'s), the other rows untouched, a second run bitwise; rows run
    alone bitwise their rows in the batch; one launch a call. Returns each (error,
    bound) of mu and v."""
    c = policy_case(dims, n, seed, dev)
    params, obs, norm, ls, noise, t = (c[k] for k in ("params", "obs", "norm", "log_std",
                                                      "noise", "t"))
    actor = {"actor": params["actor"]}
    nt = noise[POLICY_T]
    before, launches, held = read_counts()["policy_act"], 0, []
    for nrm in (None, norm):
        what = f"{dims} at {n} rows, {'with' if nrm else 'without'} the normaliser"
        x = obs if nrm is None else obsnorm.apply(nrm, obs)
        mu = polops.policy_action(actor, ls, obs, None, nrm)
        mu_critic = polops.policy_action(params, ls, obs, None, nrm)
        out, again = policy_buffers(n, dims[0], dev), policy_buffers(n, dims[0], dev)
        act = polops.rollout_sample(params, ls, obs, noise, t, nrm, out)
        polops.rollout_sample(params, ls, obs, noise, t, nrm, again)
        a_s, lp_s, v_s = polops.sample_action(params, ls, x, nt)
        a_n, lp_n, v_n = polops.sample_action(actor, ls, x, nt)
        a_p = polops.policy_action(actor, ls, obs, nt, nrm)
        greedy = polops.deterministic_action(params, x)
        launches += 8
        with torch.no_grad():
            mu_f, v_f = mlpops.actor_critic_mlp(params, out["obs"][POLICY_T])
        a_want = torch.clamp(mu + torch.exp(ls) * nt, -1.0, 1.0)
        lp_want = net.normal_log_prob(a_want, mu, ls)
        row = {k: out[k][POLICY_T] for k in out}
        torch.cuda.synchronize()
        checks = {
            "the obs row is obsnorm.apply's": same_bits(row["obs"], x),
            "mu with the critic given": same_bits(mu_critic, mu),
            "mu is mlp_forward's": same_bits(mu, mu_f),
            "v is mlp_forward's": same_bits(row["values"], v_f),
            "the action row": same_bits(row["actions"], a_want),
            "the returned action": same_bits(act, a_want),
            "the log-prob row": same_bits(row["logprobs"], lp_want),
            "sample_action": (same_bits(a_s, a_want) and same_bits(lp_s, lp_want)
                              and same_bits(v_s, row["values"])),
            "sample_action without a critic": (same_bits(a_n, a_want)
                                               and same_bits(lp_n, lp_want) and v_n is None),
            "the sampled policy_action": same_bits(a_p, a_want),
            "deterministic_action": same_bits(greedy, mu),
            "a second run": all(same_bits(out[k], again[k]) for k in out),
        }
        bad = [k for k, ok in checks.items() if not ok]
        if bad:
            raise AssertionError(f"phase q policy_act {what}: not bitwise: {bad}")
        for k in out:
            untouched(out[k], f"policy_act {what} {k}")
        with torch.no_grad():
            plain = [net.actor_mu(params, x), net.critic_value(params, x)]
            control = [halves(lambda r: net.actor_mu(params, r), x),
                       halves(lambda r: net.critic_value(params, r), x)]
        held += hold_towers([mu, row["values"]], plain, control, f"policy_act {what}")
        for k in sorted({0, n // 2, n - 1}):
            alone = policy_buffers(1, dims[0], dev)
            polops.rollout_sample(params, ls, obs[k:k + 1], noise[:, k:k + 1].contiguous(), t,
                                  nrm, alone)
            launches += 1
            torch.cuda.synchronize()
            if not all(same_bits(alone[f][POLICY_T], out[f][POLICY_T][k:k + 1]) for f in out):
                raise AssertionError(f"phase q policy_act {what}: row {k} alone differs from "
                                     f"its row in the batch")
    if read_counts()["policy_act"] - before != launches:
        raise AssertionError(f"phase q policy_act {dims} at {n} rows: "
                             f"{read_counts()['policy_act'] - before} launches, expected "
                             f"{launches}")
    return held


def pool_case(dims, envs: int, seats: int, mode: str, seed: int, dev) -> dict:
    """Kernel B's inputs: a pool of ``POOL_MEMBERS`` actor towers (``mlp_case``'s; a
    member a seat in seat mode) stacked [P, in, out], log_std [P, 2] ~ U(-1.2, -0.2),
    each member's normaliser as ``policy_case``'s, the env's observations [envs, 1 +
    seats, D] (car 0 the learner's; in seat mode [envs, seats, D]), the noise and
    uniforms [envs x seats, 2], the learner's actions [envs, 2], the members by
    ``mode`` ("per env": an int32 [envs] index over the pool, "one": a 0-d index 3,
    "seat": none) and ``use_policy`` (per env: [envs] bool, about 70% True; one:
    0-d True)."""
    d, h1, h2 = dims
    members = seats if mode == "seat" else POOL_MEMBERS
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
    towers = [mlp_case(d, (h1, h2), 0, seed + 1 + p)["params"]["actor"] for p in range(members)]
    actor = [tuple(f32(np.stack([towers[p][i][j] for p in range(members)])) for j in range(2))
             for i in range(3)]
    var = rng.uniform(0.05, 2.0, (members, d))
    var[:, 0] = 1e-4
    rows = envs * seats
    case = {"actor": actor, "log_std": f32(rng.uniform(-1.2, -0.2, (members, 2))),
            "mean": f32(rng.normal(0.0, 0.5, (members, d))), "var": f32(var),
            "obs_all": f32(rng.normal(size=(envs, seats + (mode != "seat"), d))),
            "noise": f32(rng.standard_normal((rows, 2))), "uniforms": f32(rng.random((rows, 2))),
            "first": f32(rng.uniform(-1, 1, (envs, 2))), "mode": mode}
    if mode == "per env":
        case["member"] = torch.tensor(rng.integers(0, members, envs), dtype=torch.int32,
                                      device=dev)
        case["use"] = torch.tensor(rng.random(envs) < 0.7, device=dev)
    elif mode == "one":
        case["member"] = torch.tensor(3, dtype=torch.int32, device=dev)
        case["use"] = torch.tensor(True, device=dev)
    else:
        case["member"] = case["use"] = None
    return case


def with_members(case, dist: str, seed: int) -> dict:
    """``case`` (a per-env ``pool_case``) with its [envs] index and ``use_policy``
    drawn by ``dist``, one of ``POOL_DISTRIBUTIONS``."""
    envs = case["member"].shape[0]
    rng = np.random.default_rng(seed + 11)
    use = np.ones(envs, bool)
    if dist == "uniform":
        member = rng.integers(0, POOL_MEMBERS, envs)
    elif dist == "skewed":
        member = rng.integers(1, POOL_MEMBERS, envs)
        member[rng.permutation(envs)[:-(-4 * envs // 5)]] = 0
    elif dist == "two live":
        member = rng.integers(0, 2, envs)
    elif dist == "runs":
        member = np.arange(envs) * POOL_MEMBERS // envs
    elif dist == "all random":
        member, use = np.zeros(envs, np.int64), np.zeros(envs, bool)
    else:
        raise ValueError(f"with_members: {dist!r} is not one of {POOL_DISTRIBUTIONS}")
    dev = case["member"].device
    return dict(case, member=torch.tensor(member, dtype=torch.int32, device=dev),
                use=torch.tensor(use, device=dev))


def pool_rows(case, envs: int, seats: int):
    """The members and use_policy flags of the launch's rows (env-major), [rows]."""
    dev = case["obs_all"].device
    if case["mode"] == "seat":
        return torch.arange(seats, device=dev).repeat(envs), None
    member = case["member"].long().expand(envs).repeat_interleave(seats)
    return member, case["use"].expand(envs).repeat_interleave(seats)


def pool_plain_mu(case, obs, member_rows, normalize: bool):
    """The composition's mu of each row under its member (``_pool_actor_mu`` over every
    member, each on its normalised rows, then gathered), [rows, 2]."""
    x = obs.reshape(-1, obs.shape[-1])
    if normalize:
        x = selfplay._normalized(case["mean"][:, None, :], case["var"][:, None, :], x)
    mus = selfplay._pool_actor_mu({"actor": case["actor"]}, x)      # [P, rows, 2]
    return mus[member_rows, torch.arange(mus.shape[1], device=x.device)]


def member_mu_is_mlp_forward(c, obs, mu_rows, member_rows, normalize: bool) -> bool:
    """Kernel B's greedy mu on each member's rows bitwise ``mlp_forward``'s actor mu
    (``mlpops.actor_critic_mlp``, the member's actor with a one-output critic cut from
    it) on those rows, normalised by the member's normaliser where ``normalize``."""
    x = obs.reshape(-1, obs.shape[-1])
    for p in sorted(set(member_rows.tolist())):
        sel = member_rows == p
        xp = x[sel]
        if normalize:
            xp = obsnorm.apply(obsnorm.ObsNormState(c["mean"][p], c["var"][p], None), xp)
        actor = [(w[p], b[p]) for w, b in c["actor"]]
        critic = actor[:2] + [(actor[2][0][:, :1].contiguous(), actor[2][1][:1].contiguous())]
        with torch.no_grad():
            mu_f, _ = mlpops.actor_critic_mlp({"actor": actor, "critic": critic}, xp)
        if not same_bits(mu_rows[sel], mu_f):
            return False
    return True


def hold_pool_act(dims, envs: int, seats: int, mode: str, dev, seed: int,
                  dist: str | None = None) -> list:
    """Kernel B at ``dims``, ``envs`` x ``seats`` rows and the member ``mode`` (per
    env: with the index and ``use_policy`` drawn by ``dist`` of
    ``POOL_DISTRIBUTIONS``, None: ``pool_case``'s), without and with the members'
    normalisers: its mu (greedy) within phase p's rule of the composition and, on
    each member's rows, bitwise ``mlp_forward``'s actor mu; sampled, with the uniform
    actions and ``use_policy`` and the learner's action as car 0 (not in seat mode),
    bitwise the composition on the kernel's mu; the same through
    ``selfplay.opponent_actions`` (the flat rows) and ``opponent_actions_all_seats``
    (the env's draws), in seat mode through ``metrics._seat_actions``; a second run
    bitwise; envs alone bitwise their rows in the batch; one launch a call. Returns
    the (error, bound) of mu."""
    c = pool_case(dims, envs, seats, mode, seed, dev)
    if dist is not None:
        c = with_members(c, dist, seed)
    seat = mode == "seat"
    obs = c["obs_all"] if seat else c["obs_all"][:, 1:]
    member_rows, use_rows = pool_rows(c, envs, seats)
    low, high = selfplay._action_bounds(torch.float32, dev)
    before, launches, held = read_counts()["pool_act"], 0, []
    for normalize in (False, True):
        what = (f"{dims}, {envs} envs x {seats} seats, {mode}, "
                f"{'with' if normalize else 'without'} the normalisers")
        mean, var = (c["mean"], c["var"]) if normalize else (None, None)
        kw = {} if seat else dict(uniforms=c["uniforms"], use_policy=c["use"],
                                  low=selfplay._ACTION_LOW, high=selfplay._ACTION_HIGH,
                                  first=c["first"])
        mu = polops.pool_act(c["actor"], c["log_std"], obs, None, c["member"], mean, var)
        acts = polops.pool_act(c["actor"], c["log_std"], obs, c["noise"], c["member"], mean,
                               var, **kw)
        again = polops.pool_act(c["actor"], c["log_std"], obs, c["noise"], c["member"], mean,
                                var, **kw)
        launches += 3
        mu_rows = mu.reshape(-1, 2)
        want = torch.clamp(mu_rows + torch.exp(c["log_std"])[member_rows] * c["noise"], -1.0,
                           1.0)
        if seat:
            got = acts.reshape(-1, 2)
            routes = []
            if normalize:  # the match loop's stacked seats always carry a normaliser
                routes.append((metrics._seat_actions(
                    {"actor": c["actor"]}, c["log_std"], obs,
                    c["noise"].reshape(envs, seats, 2),
                    obsnorm.ObsNormState(c["mean"], c["var"], None)), acts))
                launches += 1
        else:
            rand = torch.maximum(low, c["uniforms"] * (high - low) + low)
            want = torch.where(use_rows[:, None], want, rand)
            got = acts[:, 1:].reshape(-1, 2)
            opp = {"params": {"actor": c["actor"]}, "log_std": c["log_std"],
                   "idx": c["member"], "use_policy": c["use"], "norm_mean": mean,
                   "norm_var": var}
            flat = dict(opp, idx=c["member"] if c["member"].ndim == 0 else
                        c["member"].repeat_interleave(seats),
                        use_policy=c["use"] if c["use"].ndim == 0 else use_rows)
            flat_acts = selfplay.opponent_actions(None, flat, obs.reshape(-1, dims[0]),
                                                  c["noise"], c["uniforms"])
            gen = torch.Generator(device=dev).manual_seed(seed)
            state = gen.get_state()
            all_seats = selfplay.opponent_actions_all_seats(None, opp, obs, gen,
                                                            first=c["first"])
            gen.set_state(state)
            noise, uniforms = selfplay.opponent_randoms(gen, envs * seats, torch.float32, dev)
            drawn = polops.pool_act(c["actor"], c["log_std"], obs, noise, c["member"], mean,
                                    var, uniforms, c["use"], selfplay._ACTION_LOW,
                                    selfplay._ACTION_HIGH, c["first"])
            launches += 3
            routes = [(flat_acts, got), (all_seats, drawn), (acts[:, 0], c["first"])]
        torch.cuda.synchronize()
        what += "" if dist is None else f", members {dist}"
        if not same_bits(got, want):
            raise AssertionError(f"phase q pool_act {what}: not bitwise the composition on "
                                 f"its mu")
        if not member_mu_is_mlp_forward(c, obs, mu_rows, member_rows, normalize):
            raise AssertionError(f"phase q pool_act {what}: mu is not mlp_forward's on a "
                                 f"member's rows")
        if not (all(same_bits(a, b) for a, b in routes) and same_bits(acts, again)):
            raise AssertionError(f"phase q pool_act {what}: its routes or a second run differ")
        h = envs // 2
        with torch.no_grad():
            plain = pool_plain_mu(c, obs, member_rows, normalize)
            control = torch.cat([pool_plain_mu(c, obs[:h], member_rows[:h * seats], normalize),
                                 pool_plain_mu(c, obs[h:], member_rows[h * seats:], normalize)])
        held += hold_towers([mu_rows], [plain], [control], f"pool_act {what}")
        for e in sorted({0, envs // 2, envs - 1}):
            one = lambda x: x if x is None or x.ndim == 0 else x[e:e + 1]
            rows = slice(e * seats, (e + 1) * seats)
            alone_kw = {} if seat else dict(kw, uniforms=c["uniforms"][rows],
                                            use_policy=one(c["use"]), first=c["first"][e:e + 1])
            alone = polops.pool_act(c["actor"], c["log_std"], obs[e:e + 1], c["noise"][rows],
                                    one(c["member"]), mean, var, **alone_kw)
            launches += 1
            torch.cuda.synchronize()
            if not same_bits(alone, acts[e:e + 1]):
                raise AssertionError(f"phase q pool_act {what}: env {e} alone differs from "
                                     f"its rows in the batch")
    if read_counts()["pool_act"] - before != launches:
        raise AssertionError(f"phase q pool_act {dims} {envs} x {seats} {mode}: "
                             f"{read_counts()['pool_act'] - before} launches, expected "
                             f"{launches}")
    return held


def policy_graphs(dev) -> None:
    """Each kernel captured in a CUDA graph at the main path's shapes (19, 64, 64),
    4096 rows with the normaliser, and replayed twice: bitwise its eager launch."""
    c = policy_case((19, 64, 64), 4096, 41, dev)
    p = pool_case((19, 64, 64), 4096, 1, "per env", 43, dev)
    obs = p["obs_all"][:, 1:]
    bufs = [policy_buffers(4096, 19, dev) for _ in range(2)]

    def a(out):
        return polops.rollout_sample(c["params"], c["log_std"], c["obs"], c["noise"], c["t"],
                                     c["norm"], out)

    def b():
        return polops.pool_act(p["actor"], p["log_std"], obs, p["noise"], p["member"],
                               p["mean"], p["var"], p["uniforms"], p["use"],
                               selfplay._ACTION_LOW, selfplay._ACTION_HIGH, p["first"])

    want_a, want_b = a(bufs[0]), b()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got_a, got_b = a(bufs[1]), b()
    for i in range(2):
        for v in bufs[1].values():
            v.fill_(POLICY_SENTINEL)
        got_a.zero_()
        got_b.zero_()
        graph.replay()
        torch.cuda.synchronize()
        if not (same_bits(got_a, want_a) and same_bits(got_b, want_b)
                and all(same_bits(bufs[0][k], bufs[1][k]) for k in bufs[0])):
            raise AssertionError(f"phase q: graph replay {i + 1} differs from the eager launches")


def policy_refusals(dev) -> None:
    """What the kernels do not take raises before any launch: float64, non-contiguous
    rows, other hidden widths, an index of another dtype, a noise of another shape."""
    c = policy_case((19, 64, 64), 64, 51, dev)
    p = pool_case((19, 64, 64), 64, 1, "per env", 53, dev)
    obs, ls, noise = c["obs"], c["log_std"], c["noise"][POLICY_T]
    narrow = {t: [(w[:, :32].contiguous() if w.ndim == 2 and w.shape[1] == 64 else w[:32]
                   if w.ndim == 1 and w.shape[0] == 64 else w, b) for w, b in c["params"][t]]
              for t in ("actor", "critic")}
    cases = {
        "float64 obs": lambda: polops.sample_action(c["params"], ls, obs.double(), noise),
        "strided features": lambda: polops.deterministic_action(c["params"], obs[:, ::2]),
        "other widths": lambda: polops.deterministic_action(narrow, obs),
        "noise of another shape": lambda: polops.sample_action(c["params"], ls, obs, noise[:7]),
        "a float index": lambda: polops.pool_act(p["actor"], p["log_std"], p["obs_all"][:, 1:],
                                                 p["noise"], p["member"].float()),
        "float64 pool": lambda: polops.pool_act([tuple(t.double() for t in l) for l in p["actor"]],
                                                p["log_std"], p["obs_all"][:, 1:], p["noise"],
                                                p["member"]),
    }
    before = read_counts()
    refused = 0
    for name, call in cases.items():
        try:
            call()
        except (TypeError, ValueError):
            refused += 1
        else:
            raise AssertionError(f"phase q: {name} was taken")
    if read_counts() != before:
        raise AssertionError("phase q: a refused call launched")


def offset_views(tensors, dev):
    """Copies of ``tensors`` as views into one flat buffer, each starting one float
    past a 16-byte boundary (as a view into a flat parameter buffer can): the
    kernels copy such a tensor a float at a time."""
    flat = torch.empty((sum(-(-t.numel() // 4) * 4 + 4 for t in tensors),), device=dev)
    out, at = [], 1
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape).copy_(t))
        at = -(-(at + t.numel()) // 4) * 4 + 1
    return out


def policy_offset_views(dev) -> None:
    """Both kernels with every tower tensor an unaligned view (``offset_views``):
    bitwise their launches on the aligned tensors."""
    c = policy_case((19, 64, 64), 64, 71, dev)
    p = pool_case((19, 64, 64), 64, 1, "per env", 73, dev)
    obs = p["obs_all"][:, 1:]

    def views(layers):
        flat = offset_views([t for layer in layers for t in layer], dev)
        if not all(t.data_ptr() % 16 for t in flat):
            raise AssertionError("phase q: an offset view is 16-byte aligned")
        return [tuple(flat[i:i + 2]) for i in range(0, len(flat), 2)]

    def both(params, actor):
        out = policy_buffers(64, 19, dev)
        polops.rollout_sample(params, c["log_std"], c["obs"], c["noise"], c["t"], c["norm"], out)
        acts = polops.pool_act(actor, p["log_std"], obs, p["noise"], p["member"], p["mean"],
                               p["var"], p["uniforms"], p["use"], selfplay._ACTION_LOW,
                               selfplay._ACTION_HIGH, p["first"])
        return [*out.values(), acts]

    want = both(c["params"], p["actor"])
    got = both({k: views(v) for k, v in c["params"].items()}, views(p["actor"]))
    torch.cuda.synchronize()
    if not all(same_bits(a, b) for a, b in zip(got, want)):
        raise AssertionError("phase q: the kernels on unaligned tower views differ from the "
                             "aligned tensors")


def check_policy_kernels(dev, card) -> dict:
    """Phase q: kernel A (``hold_policy_act``) at ``POLICY_TOWERS`` x ``POLICY_ROWS``,
    kernel B (``hold_pool_act``) at its ``POOL_SHAPES`` in each of ``POOL_MODES`` on
    (19, 64, 64), every tower at 4096 x 1 per env, and the per-env index at each of
    ``POOL_DISTRIBUTIONS`` (4096 x 1, 2048 x 2, 8192 x 1 and 512 x 7); graphed against
    eager (``policy_graphs``); unaligned tower views (``policy_offset_views``); the
    refusals; the kernels' shared bytes as ``_cuda.policy_shared_bytes`` counts them.
    Returns each kernel's largest error and ratio."""
    a, b = [], []
    for i, dims in enumerate(POLICY_TOWERS):
        for n in POLICY_ROWS:
            a += hold_policy_act(dims, n, dev, seed=300 + 10 * i + n % 7)
    for j, (envs, seats) in enumerate(POOL_SHAPES):
        for mode in POOL_MODES:
            b += hold_pool_act((19, 64, 64), envs, seats, mode, dev, seed=400 + 10 * j)
    for i, dims in enumerate(POLICY_TOWERS):
        for mode in POOL_MODES:
            b += hold_pool_act(dims, 4096, 1, mode, dev, seed=480 + i)
    for j, dist in enumerate(POOL_DISTRIBUTIONS):
        for envs, seats in ((4096, 1), (2048, 2), (8192, 1), (512, 7)):
            b += hold_pool_act((19, 64, 64), envs, seats, "per env", dev, seed=500 + 10 * j,
                               dist=dist)
    policy_graphs(dev)
    policy_offset_views(dev)
    policy_refusals(dev)
    lib = _cuda.build()["policy"]
    for dims in POLICY_TOWERS + ((48, 128, 128), (49, 128, 128)):
        for pool in (0, 1):
            if lib.policy_shared_bytes(pool, *dims) != _cuda.policy_shared_bytes(bool(pool), *dims):
                raise AssertionError(f"phase q: policy_shared_bytes({pool}, {dims}) "
                                     f"{lib.policy_shared_bytes(pool, *dims)} on the card, "
                                     f"{_cuda.policy_shared_bytes(bool(pool), *dims)} in ops/_cuda.py")
    out = {}
    for name, held in (("policy_act", a), ("pool_act", b)):
        out[name] = {"max_abs_err": max(e for e, _ in held),
                     "ratio": max(e / bd if bd else 0.0 for e, bd in held)}
    print(f"phase q policy_act: mu and v within max({MLP_REL_FLOOR:g} x scale, "
          f"{MLP_CONTROL_FACTOR} x the two-halves control) of the composition at "
          f"{POLICY_TOWERS} x {POLICY_ROWS} rows, without and with the normaliser (largest "
          f"ratio {out['policy_act']['ratio']:.3f}, error "
          f"{out['policy_act']['max_abs_err']:.3e}); mu and v bitwise mlp_forward's; the "
          f"obs, action and log-prob rows bitwise the composition on its mu, the other rows "
          f"untouched; sample_action with and without a critic, policy_action greedy and "
          f"sampled, deterministic_action bitwise; two runs and rows alone bitwise, on {card}")
    print(f"phase q pool_act: mu within the same rule at {POOL_SHAPES} (envs x opponent "
          f"seats) x {POOL_MODES} on (19, 64, 64) and {POLICY_TOWERS} at 4096 x 1 (largest "
          f"ratio {out['pool_act']['ratio']:.3f}, error {out['pool_act']['max_abs_err']:.3e}); "
          f"the sample, the uniform actions, the mixed use_policy select and car 0 bitwise "
          f"the composition on its mu, and through opponent_actions, "
          f"opponent_actions_all_seats and _seat_actions; mu bitwise mlp_forward's actor on "
          f"each member's rows, also at the per-env members {POOL_DISTRIBUTIONS}; two runs "
          f"and envs alone bitwise; both kernels graphed bitwise eager and on unaligned tower "
          f"views bitwise the aligned; float64, strided rows, other widths, a float index "
          f"and a noise of another shape refused, on {card}")
    return out


def policy_bytes_ops(kind: str, n: int, dims, members: int = POOL_MEMBERS,
                     tower_rows: int | None = None):
    """(bytes, operations) that a call at ``n`` rows must move and do: each input read
    once and each output written once; a row's multiply-adds (kernel A both towers,
    kernel B one member's actor on the ``tower_rows`` rows whose use_policy holds,
    default all) as 3 TF32 products of 2 operations (3xTF32)."""
    d, h1, h2 = dims
    actor = d * h1 + h1 + h1 * h2 + h2 + 2 * h2 + 2
    critic = d * h1 + h1 + h1 * h2 + h2 + h2 + 1
    macs_actor = d * h1 + h1 * h2 + 2 * h2
    if kind == "policy_act":
        floats = (n * d + 2 * n + 2 * d + 2 + actor + critic       # obs, noise, norm, log_std
                  + n * d + 2 * 2 * n + 2 * n)                    # obs row, actions, lp, v
        ops = 6 * n * (macs_actor + d * h1 + h1 * h2 + h2)
        return 4 * floats + 8, ops                                # t
    floats = (n * d + 4 * n + members * (actor + 2 * d + 2)      # obs, noise, uniforms, pool
              + 2 * n + 2 * 2 * n)                               # first; out (2 cars)
    tower_rows = n if tower_rows is None else tower_rows
    return 4 * floats + 4 * n + n, 6 * tower_rows * macs_actor    # index, use_policy


def parent_policy_lib():
    """(``scripts/policy_kernel_split.py`` as a module, its build of the policy kernels
    the port's replaced, ``PARENT``'s ``csrc/policy.cu``), or None where the checkout
    holds neither that commit's history nor its unpacked ``scratch_checkout/``."""
    import importlib.util

    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        "policy_kernel_split.py")
    spec = importlib.util.spec_from_file_location("policy_kernel_split", path)
    split_script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(split_script)
    files = split_script.parent_files()
    return None if files is None else (split_script,
                                       split_script.build_lib(files, "parent", 99))


def time_policy_kernels(dev, card, checked, parent=None) -> list:
    """The kernels line's entries for ``policy_act`` and ``pool_act`` at the self-play
    main path's shapes ((19, 64, 64), 4096 rows with the normaliser; the pool of 5 per
    env, one opponent seat, mixed use_policy): each eager (back to back, with the
    wrapper's host work) and in a CUDA graph, beside the plain composition it replaces
    eager and in a graph (kernel A: the normaliser's apply, the noise row's
    index_select, ``sample_action_plain``, the four index_copy_; kernel B:
    ``opponent_actions_plain`` on the repeated index and the cat), the bound and the
    launch floor (a one-row reduce launch in a graph); in turns with the kernels they
    replaced (``parent``: ``parent_policy_lib``'s build, where the checkout holds
    its source) in a graph, new, parent, parent, new; also at single-car's 15
    inputs."""
    split_script, parent = parent if parent is not None else (None, None)
    one, one_out = torch.zeros((1, 1), device=dev), torch.empty((1,), device=dev)
    floor = graph_ms(lambda: _cuda.launch_mlp_grad_reduce(one, one_out))
    cfg = dataclasses.replace(self_play_config(), normalize_obs=True)
    entries, times = [], {}
    for dims in ((19, 64, 64), (15, 64, 64)):
        c = policy_case(dims, NUM_ENVS, 61, dev)
        out, plain_out = policy_buffers(NUM_ENVS, dims[0], dev), policy_buffers(NUM_ENVS,
                                                                                dims[0], dev)
        a = lambda: polops.rollout_sample(c["params"], c["log_std"], c["obs"], c["noise"],
                                          c["t"], c["norm"], out)

        def a_plain():
            _, rows = ppo.rollout_policy_plain(cfg, c["params"], c["log_std"], c["noise"],
                                               c["obs"], c["t"], c["norm"])
            for k, v in rows.items():
                plain_out[k].index_copy_(0, c["t"], v[None])

        p = pool_case(dims, NUM_ENVS, 1, "per env", 63, dev)
        obs = p["obs_all"][:, 1:]
        opp = {"params": {"actor": p["actor"]}, "log_std": p["log_std"],
               "idx": p["member"].repeat_interleave(1), "use_policy": p["use"],
               "norm_mean": p["mean"], "norm_var": p["var"]}
        b = lambda: polops.pool_act(p["actor"], p["log_std"], obs, p["noise"], p["member"],
                                    p["mean"], p["var"], p["uniforms"], p["use"],
                                    selfplay._ACTION_LOW, selfplay._ACTION_HIGH, p["first"])

        def b_plain():
            acts = selfplay.opponent_actions_plain(None, opp, obs.reshape(NUM_ENVS, -1),
                                                   p["noise"], p["uniforms"])
            return torch.cat([p["first"][:, None], acts[:, None]], dim=1)

        with torch.no_grad():
            for name, fn, plain in (("policy_act", a, a_plain), ("pool_act", b, b_plain)):
                nb, ops = policy_bytes_ops(name, NUM_ENVS, dims,
                                           tower_rows=int(p["use"].sum()) if name == "pool_act"
                                           else None)
                turns = [graph_ms(fn)]
                if parent is not None:
                    for _ in range(2):
                        with split_script.routed(parent):
                            turns.append(graph_ms(fn))
                    turns.append(graph_ms(fn))
                times[name, dims] = (per_launch_ms(fn), graph_ms(fn), per_launch_ms(plain),
                                     graph_ms(plain), *bound_ms(nb, ops, PEAK_TF32_OPS_PER_S),
                                     turns)
    for name, replaces in (("policy_act", "self_play_racing_tpu/agent/ppo.py:362"),
                           ("pool_act", "self_play_racing_tpu/envs/selfplay.py:53")):
        ms, g, p_ms, p_g, bound, by, turns = times[name, (19, 64, 64)]
        s = times[name, (15, 64, 64)]
        parent_ms = (None if len(turns) == 1 else statistics.mean(turns[1:3]),
                     None if len(s[6]) == 1 else statistics.mean(s[6][1:3]))
        if parent_ms[0] is None:
            print(f"phase q {name}: the parent's source is not in this checkout; no turns")
        else:
            print(f"phase q {name} in turns with the kernel it redesigned, us in a graph, new | "
                  f"parent | parent | new: {' | '.join(f'{t * 1e3:.2f}' for t in turns)} at "
                  f"(19, 64, 64), {' | '.join(f'{t * 1e3:.2f}' for t in s[6])} at (15, 64, 64), "
                  f"on {card}")
        print(f"phase q {name} at {NUM_ENVS} rows (19, 64, 64), us: {ms * 1e3:.2f} eager, "
              f"{g * 1e3:.2f} in a graph, bound {bound * 1e3:.3f} ({by}; 3xTF32 on the tensor "
              f"cores), launch floor {floor * 1e3:.2f}; the composition it replaces "
              f"{p_ms * 1e3:.1f} eager, {p_g * 1e3:.1f} in a graph; at 15 inputs "
              f"{s[1] * 1e3:.2f} in a graph (the composition {s[3] * 1e3:.1f}), on {card}")
        entries.append({
            "name": name, "route": "cuda", "source": "self_play_racing_tpu_torch/csrc/policy.cu",
            "replaces": replaces, "max_abs_err": checked[name]["max_abs_err"],
            "max_err_over_bound": checked[name]["ratio"], "ms": ms, "graph_ms": g,
            "plain_ms": p_ms, "plain_graph_ms": p_g, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "launch_floor_ms": floor,
            "parent_graph_ms": parent_ms[0], "turns_graph_ms": turns,
            "at": {"15 inputs": {"graph_ms": s[1], "plain_graph_ms": s[3],
                                 "bound_ms": s[4], "parent_graph_ms": parent_ms[1],
                                 "turns_graph_ms": s[6]}}})
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    # the policy kernels the port's replaced, built beside the port's for phase q's turns
    parent_policy = concurrent.futures.ThreadPoolExecutor(1).submit(parent_policy_lib)
    _cuda.build()
    print(f"kernels built in {_cuda.build_seconds:.1f} s")
    for name, report in _cuda.build_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or report == "cached":
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    cfg = senv.RacingConfig(num_sensors=11)
    pool = canonical_bench_pool(NUM_TRACKS, device=dev)
    track = trk.gather_tracks(pool, np.arange(NUM_ENVS) % NUM_TRACKS)
    if (track.wp_x.shape[-1], track.seg_sx.shape[-1]) != (512, 896):
        raise AssertionError("canonical pool is not W=512, S=896")
    _, n_units, _ = ppo.minibatch_layout(base_config(num_envs=NUM_ENVS, num_steps=STEPS))
    kernels = [check_k1(track, cfg, rng, dev), check_k2(track, cfg, rng, dev)]
    mcfg = menv.MultiRacingConfig(num_agents=NUM_AGENTS, num_sensors=11)
    check_selfplay_launches(track, mcfg, rng, dev, *kernels)
    kernels += [check_k3(track, mcfg, rng, dev), check_k4(track, mcfg, rng, dev),
                check_k5(track, mcfg, rng, dev), check_k6(dev), check_k7(dev, n_units)]
    env_kernels = check_env_kernels(track, mcfg, rng, dev)
    check_contacts(track, mcfg, rng, dev, env_kernels[1])
    kernels += env_kernels
    with timed("phase m.1 (the env step's two kernels against their plain versions)"):
        kernels += check_env_step(pool, rng, dev)
    with timed("phase n (the minibatch step's two kernels against their plain versions)"):
        kernels += check_minibatch_kernels(dev, card)
    with timed("phase p (the minibatch step's MLP kernels against the plain composition)"):
        kernels += time_mlp_kernels(dev, card, check_mlp_kernels(dev, card))
        train_more_cars(card)
    with timed("phase q (the rollout step's policy kernels against the plain composition)"):
        kernels += time_policy_kernels(dev, card, check_policy_kernels(dev, card),
                                       parent_policy.result())
    with timed("phase o.1 and o.4 (the single-car env step's two launches against their "
               "plain versions)"):
        kernels += check_single_env_step(pool, dev, card)
    with timed("phase r.1 and r.3 (the transitions' autoreset mode against the composition)"):
        kernels += check_autoreset(pool, dev, card)
    procgen = procgen_on_card(dev)
    kernels += check_row_ids(pool, procgen, cfg, mcfg, rng, dev)
    single_car, single_obs = main_path(track, cfg, dev, card)
    tiled_single, tiled_obs = main_path(trk.tiled_pooled_tracks(pool, NUM_ENVS), cfg, dev, card,
                                        " (tiled pool, row ids)")
    if not torch.equal(single_obs, tiled_obs):
        raise AssertionError("main path: the tiled run ends apart from the gathered run")
    print("main path: the tiled run ends in the gathered run's observations")
    training(track, cfg, card)
    entry_point(card)
    launches, seeded, peak = selfplay_training(
        lambda: trk.gather_tracks(pool, np.arange(NUM_ENVS) % NUM_TRACKS), card)
    tiled, tiled_seeded, tiled_peak = selfplay_training(
        lambda: trk.tiled_pooled_tracks(pool, NUM_ENVS), card, " (tiled pool, row ids)")
    if tiled_seeded != seeded:
        raise AssertionError(f"self-play tiled {tiled_seeded} differs from gathered {seeded}")
    entry_launches = selfplay_entry_points(card)
    print(f"self-play tiled: every update's seeded numbers equal the gathered run's; peak "
          f"memory {tiled_peak / 2**20:,.1f} MiB tiled, {peak / 2**20:,.1f} MiB gathered "
          f"(the gathered rows are {gathered_row_bytes(pool, NUM_ENVS) / 2**20:,.1f} MiB)")
    launches, tiled = per_kernel(launches), per_kernel(tiled)
    for k in kernels:
        # K1's fold runs inside multi_observe on both main paths, K2 and K5 inside
        # single_transition and multi_transition; the narrow kernels on no main path
        if k["name"] in ("raycast_walls", "raycast_walls_row_ids", "car_step_and_query",
                         "car_step_and_query_row_ids"):
            tiled_path = k["name"].endswith("_row_ids")
            k["launches"] = (tiled_single if tiled_path else single_car)[k["name"]]
            k["launches_path"] = ("single-car main path" + (" on the tiled pool" if tiled_path
                                                            else "")
                                  + ": 0, the env step runs its work as single_observe and "
                                  "single_transition")
            k["launches_selfplay"] = (tiled if tiled_path else launches)[k["name"]]
        elif k["name"] in ("single_observe", "single_transition", "single_transition_rows"):
            # the transition's kernel of several rows a block runs on the tiled pool,
            # a warp a row on the gathered rows
            gathered_run, tiled_run = per_kernel(single_car), per_kernel(tiled_single)
            by_ids = {"single_observe": tiled_run["single_observe_row_ids"],
                      "single_transition": tiled_run["single_transition_row_ids"]
                      - tiled_run["single_transition_rows"],
                      "single_transition_rows": tiled_run["single_transition_rows"]}
            if k["name"] == "single_transition_rows":
                k["launches"] = tiled_run[k["name"]]
                k["launches_path"] = "single-car main path on the tiled pool"
            else:
                k["launches"], k["launches_path"] = gathered_run[k["name"]], "single-car main path"
            k["launches_row_ids"] = by_ids[k["name"]]
            if not k["launches"]:
                raise AssertionError(f"{k['name']}: no launch on {k['launches_path']}")

        elif k["name"] in ("single_transition_autoreset", "single_transition_rows_autoreset"):
            # the bench loop's fused route: a warp a row gathered, several rows a block
            # on the tiled pool
            tiled_path = k["name"] == "single_transition_rows_autoreset"
            k["launches"] = per_kernel(tiled_single if tiled_path else single_car)[k["name"]]
            k["launches_path"] = "single-car main path" + (" on the tiled pool" if tiled_path
                                                           else "")
            if not k["launches"]:
                raise AssertionError(f"{k['name']}: no launch on {k['launches_path']}")
        elif k["name"] == "multi_transition_small_autoreset":
            k["launches"] = per_kernel(entry_launches["multi"])[k["name"]]
            k["launches_path"] = "train multi (16 envs)"
            if not k["launches"]:
                raise AssertionError(f"{k['name']}: no launch in {k['launches_path']}")
        elif k["name"] in ("raycast_walls_and_cars", "raycast_walls_and_cars_row_ids"):
            k["launches"] = (tiled if k["name"].endswith("_row_ids") else launches)[k["name"]]
            k["launches_path"] = ("self-play training: 0, the multi-car env's observe runs "
                                  "its fold and car pass as multi_observe")
        elif k["name"] in ("multi_observe", "multi_transition"):
            k["launches"], k["launches_path"] = launches[k["name"]], "self-play training"
            k["launches_row_ids"] = tiled[f"{k['name']}_row_ids"]
        elif k["name"].endswith("_row_ids"):
            k["launches"] = tiled[k["name"]]
            k["launches_path"] = "self-play training on the tiled pool"
        elif k["name"] == "rectangles_intersect":
            k["launches"] = launches[k["name"]]
            k["launches_path"] = ("self-play training: 0, its pair test runs inside "
                                  "car_step_and_query's block")
        else:
            k["launches"], k["launches_path"] = launches[k["name"]], "self-play training"
            if k["name"] in ("policy_act", "pool_act"):
                k["launches_single_car"] = per_kernel(single_car)[k["name"]]
            if k["name"] == "multi_transition_autoreset" and not k["launches"]:
                raise AssertionError(f"{k['name']}: no launch in self-play training")
    resampled_entry_points(card)
    checkpoints(track, dev)
    evaluation(dev)
    procgen_evaluation(dev)
    capacity_probe(pool, dev)
    bench(Policy(MODEL, device=dev))
    match_launches = tournament_play(dev, card)
    dp_world_one, dp_ranks = data_parallel(dev, card)
    with timed("phase i (adapters and the SB3 leg)"):
        adapter_launches = adapters(dev, card)
    with timed("phase j (tensor-parallel towers)"):
        tp_launches = tensor_parallel_ranks(dev, card)
    # the phases that count a captured step's nodes keep their graphs to count them
    with timed("phase k (graph against eager)"), kept_graphs():
        graph_launches = graph_against_eager(pool, card)
    with timed("phase l (the loops as device programs)"):
        loop_launches = loops_graphed(dev, card)
    with timed("phase m.2-m.3 (the env step's kernels over a graphed rollout)"), kept_graphs():
        nodes = env_step_rollout(pool, dev, card)
    with timed("phase o.2-o.3 (the single-car env step's kernels over a graphed rollout)"), \
            kept_graphs():
        single_nodes = single_env_rollout(pool, dev, card)
    with timed("phase r.2 (the fused route's rollouts against the composition's)"), \
            kept_graphs():
        autoreset_nodes = autoreset_rollouts(pool, dev, card)
    # the kernels line counts by kernel (the redesigned env kernels apart from the
    # first ones, which run on few env rows)
    match_launches, dp_world_one, adapter_launches, graph_launches, loop_launches = map(
        per_kernel, (match_launches, dp_world_one, adapter_launches, graph_launches,
                     loop_launches))
    dp_ranks, tp_launches = ([per_kernel(r) for r in rs] for rs in (dp_ranks, tp_launches))
    for k in kernels:
        k["launches_match"] = match_launches[k["name"]]
        k["launches_data_parallel_world1"] = dp_world_one[k["name"]]
        k["launches_data_parallel_ranks"] = [r[k["name"]] for r in dp_ranks]
        k["launches_adapter"] = adapter_launches[k["name"]]
        k["launches_tensor_parallel"] = [r[k["name"]] for r in tp_launches]
        k["launches_graphed"] = graph_launches[k["name"]]
        k["launches_loops_graphed"] = loop_launches[k["name"]]
        if k["name"] == "mlp_grad_reduce":  # its norm-only mode, on the group paths
            k["norm_only_launches_data_parallel_world1"] = dp_world_one["mlp_grad_norm"]
            k["norm_only_launches_data_parallel_ranks"] = [r["mlp_grad_norm"] for r in dp_ranks]
        if k["name"] in ("multi_observe", "multi_transition"):
            k["rollout_step_nodes"] = nodes
        elif k["name"] in ("single_observe", "single_transition", "single_transition_rows"):
            k["rollout_step_nodes"] = single_nodes
        elif k["name"].endswith("_autoreset"):
            k["rollout_step_nodes"] = autoreset_nodes[
                "single-car" if k["name"].startswith("single") else "self-play"]
        elif k["name"] in ("multi_observe_small", "multi_transition_small"):
            # the env launches the first kernels on few rows: a match's 40 envs
            k["launches"] = match_launches[k["name"]]
            k["launches_path"] = f"the round robin ({TOURNAMENT_ENVS} envs a match)"
            if not k["launches"]:
                raise AssertionError(f"{k['name']}: no launch in the round robin")
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

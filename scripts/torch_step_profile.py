#!/usr/bin/env python3
"""Where one env-step of the PyTorch port's main path, and one minibatch of its PPO
update, spend their time, on the card.

  python scripts/torch_step_profile.py [--steps 32] [--num-envs 4096]
  python scripts/torch_step_profile.py --update [--eager] [--num-envs 4096]
  python scripts/torch_step_profile.py --selfplay [--eager] [--steps 32] [--num-envs 4096]
  python scripts/torch_step_profile.py --match
  add --tiled to any of them: the pool stays resident, tiled over the envs, and the
  env kernels read each env's rows by id (envs/track.py:tiled_pooled_tracks)

Runs chip_smoke.py's main path (``models/single_agent.npz``, canonical 16-track
pool gathered to ``--num-envs`` envs, ``sample_action`` + ``vector.step``) under
``torch.profiler`` for ``--steps`` steps after a warm-up, and prints one JSON
object: host wall time per step, device busy time per step (the sum of kernel
durations in a second, profiled run; kernels of one stream do not overlap), the
device's idle share against the unprofiled wall time, kernel launches per step,
and the kernels that take the most device time. Needs a CUDA
card; prints the card's name and power limit with the numbers.

With ``--update`` it profiles the trainer instead (``base_config`` at
``--num-envs`` x 256 steps on the same pool): after a warm-up update, one update
unprofiled for the wall time of its minibatch loop (``run_ppo_update``) and of the
rest (rollout, GAE, permutations), then the minibatch loop of a second update under
the profiler, reported per computed minibatch, with the host operators that take
the most host time and every copy between host and card the loop made (the
``cudaMemcpyAsync`` calls by the operator that issued them, and the copies the card
ran). The loop runs as replays of a CUDA graph, the trainer's default on the card;
``--eager`` runs it eagerly (``PPOTrainer(eager=True)``). The script only passes
that argument when asked, so a copy of it runs a checkout that predates the graphs.

With ``--selfplay`` it profiles a self-play update at ``train scale``'s width
(``--num-envs`` x 256 steps, 2 cars, opponents per env, ``snapshot_freq`` 1 so the
pool is live after two warm-up updates): one update unprofiled for its wall time
and its rollout/minibatch split, one update under the profiler for its device
time and idle share and the kernels that take the most of it (graphed unless
``--eager``), then ``--steps`` steps of the eager self-play rollout (opponents,
transition, autoreset, refresh: ``ppo.rollout_phase``) alone, unprofiled for the
wall time and under the profiler for the device time, reported per env step and
by group (``rollout_groups``, with the pool's ``opponents``:
``selfplay.opponent_actions_all_seats``, its draws and kernel B).
Graphed, it also reports the captured rollout step itself: the kernel and copy
nodes of one replay and the device ms a step over ``num_steps`` replays.

With ``--eager``, ``--update`` and ``--selfplay`` also break the profiled
minibatches down by the code that issued each launch (``minibatch_groups``): the
gather, the MLPs forward, the loss head forward, the backward of each (a backward
kernel is charged to the group of the forward operator whose autograd node launched
it, by sequence number), the global norm, the clip/Adam/apply tail and the rest of
``minibatch_step`` (masks, stats row, counters), as launches and device us a
minibatch. Graph replays carry no operator, so the graphed loop reports only totals.

With ``--update`` it also reports the single-car rollout step: the trainer's
captured rollout step (``graphed_rollout_step``, where the checkout graphs it), the
eager rollout (``ppo.rollout_phase``, ``--steps`` steps) by the code that issues
each launch (``rollout_groups``: the env's transition and observe, the autoreset
around them in ``vector.step``, the action sampling (kernel A, which also writes
the policy's buffer rows, where the checkout has it), the observation normaliser
and the buffers' writes in the rest of ``rollout_step``), as launches and device us a
step, and the graphed 40 x 5 single-car evaluation (``eval_step``: chip_smoke.py
phase l's, ``models/single_agent.npz``, sampled, seed 42) as ms a step between CUDA
events and launches a step.

With ``--match`` it profiles one tournament match as chip_smoke.py's phase g plays
it: the 8B- against the 4B-step scale agent, one policy per seat, on the 20 x 2
evaluation grid (40 envs, seed 42, sampled, pair seed ``pair_seed(42, 1)``), after
a warm-up match: the match unprofiled for its wall time, then under the profiler,
reported per loop step.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch import interop  # noqa: E402
from self_play_racing_tpu_torch.agent import ppo  # noqa: E402
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer  # noqa: E402
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer  # noqa: E402
from self_play_racing_tpu_torch.configs import base_config, self_play_config  # noqa: E402
from self_play_racing_tpu_torch import evaluate  # noqa: E402
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import normalize as obsnorm  # noqa: E402
from self_play_racing_tpu_torch.envs import selfplay  # noqa: E402
from self_play_racing_tpu_torch.envs import single as senv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.envs import vector  # noqa: E402
from self_play_racing_tpu_torch.models import actor_critic as net  # noqa: E402
from self_play_racing_tpu_torch import tournament  # noqa: E402
from self_play_racing_tpu_torch.evaluate import load_policy_bundle  # noqa: E402
from self_play_racing_tpu_torch.utils import metrics  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402


def _geometry(args, dev):
    """The canonical pool over ``--num-envs`` envs (env i on track i % 16): gathered
    per env, or with ``--tiled`` resident and read by row id."""
    pool = canonical_bench_pool(16, device=dev)
    if args.tiled:
        return trk.tiled_pooled_tracks(pool, args.num_envs)
    return trk.gather_tracks(pool, np.arange(args.num_envs) % 16)


def _device_kernels(prof):
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name][0] += evt.time_range.elapsed_us()
            per_kernel[evt.name][1] += 1
    return per_kernel


# minibatch_step's parts, by the functions that issue them; each is wrapped in a
# profiler range while the loop runs (``annotated``), where the checkout has it
GROUPS = (
    ("mb.step", [(ppo, "minibatch_step")]),
    ("gather", [(ppo, "_minibatch_rows"),
                ("self_play_racing_tpu_torch.ops.minibatch", "gather_units")]),
    ("loss head", [(ppo, "_ppo_loss")]),
    ("mlp", [(net, "actor_mu"), (net, "critic_value"),
             ("self_play_racing_tpu_torch.ops.mlp", "actor_critic_mlp")]),
    ("backward start", [(torch.autograd, "grad")]),
    ("global norm", [(ppo, "global_norm")]),
    ("tail", [(ppo, "clip_by_global_norm"), (ppo, "adam_update"), (ppo, "apply_updates"),
              ("self_play_racing_tpu_torch.ops.minibatch", "adam_tail")]),
)


@contextlib.contextmanager
def annotated(groups=GROUPS):
    """Each function of ``groups`` (those the checkout has) runs inside a profiler
    range named after its group, for the block."""
    import importlib

    saved = []

    def wrap(fn, name):
        @functools.wraps(fn)
        def inner(*a, **k):
            with torch.profiler.record_function(name):
                return fn(*a, **k)
        return inner

    for name, places in groups:
        for module, attr in places:
            if isinstance(module, str):
                try:
                    module = importlib.import_module(module)
                except ImportError:
                    continue
            if hasattr(module, attr):
                saved.append((module, attr, getattr(module, attr)))
                setattr(module, attr, wrap(getattr(module, attr), name))
    try:
        yield
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


# the minibatch step's hand-written kernels, launched through ctypes with no PyTorch
# operator around them, go to their group by the kernel's name (the profiled window
# holds the minibatch loop alone)
MINIBATCH_HAND_KERNELS = {"mlp_forward_kernel": "mlp", "mlp_backward_kernel": "mlp backward",
                          "mlp_grad_reduce_kernel": "mlp backward",
                          "ppo_head_forward_kernel": "loss head",
                          "ppo_head_backward_kernel": "loss head backward",
                          "adam_tail_kernel": "tail"}


def _minibatch_hand_group(name: str):
    return next((g for k, g in MINIBATCH_HAND_KERNELS.items() if k in name), None)


def minibatch_groups(prof) -> dict | None:
    """Launches and device us a minibatch by group, from a profile taken under
    ``annotated``: a kernel belongs to the innermost group range around the operator
    that launched it, or, launched by a backward node (on autograd's thread), to the
    group of the forward operator with that node's sequence number, plus
    " backward"; a hand-written kernel to its group by name
    (``MINIBATCH_HAND_KERNELS``). Kernels inside ``minibatch_step`` but in no group are
    "other"."""
    names = {n for n, _ in GROUPS}
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    hand = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and _minibatch_hand_group(e.name)]

    def group_of(evt):
        """The innermost group around ``evt`` inside ``minibatch_step``, else None."""
        group = None
        while evt is not None:
            if evt.name in names and group is None:
                group = evt.name
            if evt.name == "mb.step":
                return group
            evt = evt.cpu_parent
        return None

    def backward_node(evt):
        while evt is not None:
            if evt.sequence_nr >= 0 and "Backward" in evt.name:
                return evt
            evt = evt.cpu_parent
        return None

    forward = {}
    for e in events:
        if e.sequence_nr >= 0 and "Backward" not in e.name:
            g = group_of(e)
            if g is not None:
                forward.setdefault(e.sequence_nr, g)
    steps = sum(e.name == "mb.step" for e in events)
    if not steps:
        return None
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in hand:  # launched through ctypes: no operator carries them
        out[_minibatch_hand_group(e.name)][0] += 1
        out[_minibatch_hand_group(e.name)][1] += e.time_range.elapsed_us()
    for e in events:
        if not e.kernels:
            continue
        node = backward_node(e)
        if node is not None:
            g = forward.get(node.sequence_nr)
            g = f"{'other' if g == 'mb.step' else g} backward" if g else \
                f"backward, unmapped: {node.name}"
        else:
            g = group_of(e)
            if g is None:
                continue  # outside minibatch_step: the loop's own reads
            g = "other" if g == "mb.step" else g
        for k in e.kernels:
            if _minibatch_hand_group(k.name):
                continue  # counted from the device events
            out[g][0] += 1
            out[g][1] += k.duration
    return {"minibatch_steps": steps,
            "by_group": {g: {"launches_per_minibatch": c / steps,
                             "device_us_per_minibatch": us / steps}
                         for g, (c, us) in sorted(out.items(), key=lambda kv: -kv[1][1])},
            "launches_per_minibatch": sum(c for c, _ in out.values()) / steps,
            "device_us_per_minibatch": sum(us for _, us in out.values()) / steps}


# rollout_step's parts, by the functions that issue them (``rollout_groups``)
ROLLOUT_GROUPS = (
    ("rollout.step", [(ppo, "rollout_step")]),
    ("autoreset", [(vector, "step")]),
    ("env transition", [(senv, "transition"), (menv, "transition")]),
    ("env observe", [(senv, "observe"), (menv, "observe")]),
    ("opponents", [(selfplay, "opponent_actions_all_seats")]),
    ("sampling", [(net, "sample_action"), (ppo, "rollout_policy_plain"),
                  ("self_play_racing_tpu_torch.ops.policy", "rollout_sample")]),
    ("normaliser", [(obsnorm, "update"), (obsnorm, "apply")]),
)


# the env's hand-written kernels, launched through ctypes with no PyTorch operator
# around them, go to their group by the kernel's name
HAND_KERNELS = {"single_transition_kernel": "env transition",
                "single_transition_rows_kernel": "env transition",
                "multi_transition_kernel": "env transition",
                "car_step_and_query_kernel": "env transition",
                "policy_act_kernel": "sampling",
                "pool_act_kernel": "opponents",
                "multi_observe_kernel": "env observe",
                "raycast_walls_and_cars_kernel": "env observe",
                "raycast_walls_kernel": "env observe"}


def _hand_group(name: str):
    return next((g for k, g in HAND_KERNELS.items() if k in name), None)


def rollout_groups(prof, steps: int) -> dict:
    """Launches and device us a rollout step by group, from a profile taken under
    ``annotated(ROLLOUT_GROUPS)``: a kernel belongs to the innermost group range
    around the operator that launched it, a hand-written env kernel to its group by
    name (``HAND_KERNELS``); kernels inside ``rollout_step`` but in no group are
    "buffers" (the [T, N, ...] writes and the carry)."""
    names = {n for n, _ in ROLLOUT_GROUPS}
    out = collections.defaultdict(lambda: [0, 0.0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and _hand_group(e.name):
            out[_hand_group(e.name)][0] += 1
            out[_hand_group(e.name)][1] += e.time_range.elapsed_us()
            continue
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        group, evt = None, e
        while evt is not None:
            if evt.name in names and group is None:
                group = evt.name
            if evt.name == "rollout.step":
                break
            evt = evt.cpu_parent
        if evt is None:
            continue
        group = "buffers" if group == "rollout.step" else group
        for k in e.kernels:
            if _hand_group(k.name):
                continue  # counted from the device events
            out[group][0] += 1
            out[group][1] += k.duration
    return {"by_group": {g: {"launches_per_step": c / steps, "device_us_per_step": us / steps}
                         for g, (c, us) in sorted(out.items(), key=lambda kv: -kv[1][1])},
            "launches_per_step": sum(c for c, _ in out.values()) / steps,
            "device_us_per_step": sum(us for _, us in out.values()) / steps}


def profile_rollout(args, trainer, dev) -> dict:
    """``--steps`` steps of the trainer's eager rollout under the profiler, by
    group."""
    cfg = dataclasses.replace(trainer.cfg, num_steps=args.steps)
    runner = trainer.runner
    noise = net.sample_noise((args.steps, args.num_envs, 2), runner.generator, device=dev)

    def rollout():
        with torch.no_grad():
            ppo.rollout_phase(cfg, trainer.hooks, runner, trainer.aux, trainer.log_std, noise)
        torch.cuda.synchronize()

    rollout()
    t0 = time.perf_counter()
    rollout()
    wall = (time.perf_counter() - t0) / args.steps
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, annotated(ROLLOUT_GROUPS):
        rollout()
    return {"steps": args.steps, "eager_wall_ms_per_step": wall * 1e3,
            **rollout_groups(prof, args.steps)}


def profile_eval(dev) -> dict:
    """The 40 x 5 single-car evaluation (sampled, seed 42) graphed where the
    checkout graphs it: after a run that captures, one run between CUDA events
    (``chip_smoke.loop_clock``) and one under the profiler."""
    grid = metrics.build_eval_grid(40, 5, 42, device=dev)

    def run():
        out = evaluate.evaluate_single_agent_overall(grid, chip_smoke.MODEL, seed=42)
        torch.cuda.synchronize()
        return out

    run()
    with chip_smoke.loop_clock() as clock:
        res = run()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
    kernels = _device_kernels(prof)
    steps = clock["steps"]
    return {"loop_steps": steps, "success_rate": res["success_rate"],
            "host_ms_per_step": clock["host"] / steps * 1e3,
            "device_ms_per_step": clock["device"] / steps * 1e3,
            "kernel_launches_per_step": sum(c for _, c in kernels.values()) / steps,
            "kernel_us_per_step": sum(t for t, _ in kernels.values()) / steps}


def profile_update(args, dev) -> dict:
    cfg = base_config(num_envs=args.num_envs, num_steps=256,
                      total_timesteps=args.num_envs * 256 * 100)
    track = _geometry(args, dev)
    trainer = PPOTrainer(cfg, senv.RacingConfig(num_sensors=11), track,
                         **({"eager": True} if args.eager else {}))
    trainer.train(num_updates=1)  # warm-up
    with chip_smoke.minibatch_loops(1) as loops:
        t0 = time.perf_counter()
        trainer.train(num_updates=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (loop_s, mbs), = loops
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=activities)
    with chip_smoke.minibatch_loops(1, around=lambda: prof) as loops, annotated():
        trainer.train(num_updates=1)
    (profiled_s, n), = loops
    graphs = getattr(trainer.update_step, "graphs", None)
    graphed = (None if graphs is None or getattr(graphs, "rollout", None) is None
               else _graphed_step(graphs.rollout, cfg.num_steps))
    per_kernel = _device_kernels(prof)
    busy_us = sum(t for t, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]
    host = sorted((e for e in prof.key_averages() if e.self_cpu_time_total > 0),
                  key=lambda e: -e.self_cpu_time_total)[: args.top]
    return {
        "card": chip_smoke.card_line(),
        "geometry": "tiled" if args.tiled else "gathered",
        "num_envs": args.num_envs,
        "loop": "eager" if args.eager else "default (graphed where the checkout has graphs)",
        "update_wall_ms": wall * 1e3,
        "rollout_gae_perms_ms": (wall - loop_s) * 1e3,
        "minibatch_loop_ms": loop_s * 1e3,
        "minibatches": mbs,
        "wall_ms_per_minibatch": loop_s * 1e3 / mbs,
        "profiled_minibatches": n,
        "profiled_wall_ms_per_minibatch": profiled_s * 1e3 / n,
        "device_busy_ms_per_minibatch": busy_us / 1e3 / n,
        "device_idle_share": (1.0 - (busy_us / 1e6 / n) / (loop_s / mbs)) if busy_us else None,
        "kernel_launches_per_minibatch": sum(c for _, c in per_kernel.values()) / n,
        "top_kernels": [{"name": name[:90], "ms_per_minibatch": t / 1e3 / n,
                         "launches_per_minibatch": c / n} for name, (t, c) in top],
        "top_host_ops": [{"name": e.key[:60], "host_ms_per_minibatch": e.self_cpu_time_total / 1e3 / n,
                          "calls_per_minibatch": e.count / n} for e in host],
        **_copies(prof, n),
        "groups": minibatch_groups(prof),
        "graphed_rollout_step": graphed,
        "rollout_groups": profile_rollout(args, trainer, dev),
        "eval_step": profile_eval(dev),
    }


def _copies(prof, n) -> dict:
    """The host-card copies in a profile, per minibatch: the ``cudaMemcpyAsync``
    calls by the chain of operators that issued them (outermost first), and the
    copies the card ran by kind."""
    calls = collections.Counter()
    ran = collections.Counter()
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            if "memcpy" in evt.name.lower():
                ran[evt.name] += 1
        elif evt.name == "cudaMemcpyAsync":
            chain, parent = [], evt.cpu_parent
            while parent is not None:
                chain.append(parent.name)
                parent = parent.cpu_parent
            calls[" > ".join(reversed(chain)) or "(no operator)"] += 1
    return {"memcpy_calls_per_minibatch": {k: c / n for k, c in calls.most_common()},
            "memcpy_on_card_per_minibatch": {k: c / n for k, c in ran.most_common()}}


def profile_selfplay(args, dev) -> dict:
    cfg = self_play_config(num_envs=args.num_envs, num_steps=256,
                           total_timesteps=1_000_000_000, opponent_per_env=True,
                           reset_envs_each_update=False, snapshot_freq=1)
    track = _geometry(args, dev)
    trainer = SelfPlayTrainer(cfg, menv.MultiRacingConfig(num_agents=2, num_sensors=11),
                              track, **({"eager": True} if args.eager else {}))
    trainer.train(num_updates=2)  # warm-up; a pool of one from the second update
    with chip_smoke.minibatch_loops(1) as loops:
        t0 = time.perf_counter()
        trainer.train(num_updates=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    (loop_s, mbs), = loops
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof, annotated():
        trainer.train(num_updates=1)
        torch.cuda.synchronize()
    update_kernels = _device_kernels(prof)
    groups = minibatch_groups(prof)
    update_busy_us = sum(t for t, _ in update_kernels.values())
    graphs = getattr(trainer.update_step, "graphs", None)
    graphed = (None if graphs is None or graphs.rollout is None
               else _graphed_step(graphs.rollout, cfg.num_steps))

    short = dataclasses.replace(cfg, num_steps=args.steps)
    runner, log_std = trainer.runner, trainer.log_std
    noise = net.sample_noise((args.steps, args.num_envs, 2), runner.generator, device=dev)

    def rollout():
        with torch.no_grad():
            ppo.rollout_phase(short, trainer.hooks, runner, trainer.aux, log_std, noise)
        torch.cuda.synchronize()

    rollout()
    t0 = time.perf_counter()
    rollout()
    step_wall = (time.perf_counter() - t0) / args.steps
    with torch.profiler.profile(activities=activities) as prof, annotated(ROLLOUT_GROUPS):
        rollout()
    per_kernel = _device_kernels(prof)
    busy_us = sum(t for t, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]
    steps = args.steps
    return {
        "card": chip_smoke.card_line(),
        "geometry": "tiled" if args.tiled else "gathered",
        "num_envs": args.num_envs,
        "cars": 2,
        "pool": trainer.pool_count,
        "update": "eager" if args.eager else "default (graphed where the checkout has graphs)",
        "update_wall_ms": wall * 1e3,
        "rollout_gae_perms_ms": (wall - loop_s) * 1e3,
        "minibatch_loop_ms": loop_s * 1e3,
        "minibatches": mbs,
        "update_device_busy_ms": update_busy_us / 1e3,
        "update_device_idle_share": (1.0 - update_busy_us / 1e3 / (wall * 1e3))
        if update_busy_us else None,
        "update_kernel_launches": sum(c for _, c in update_kernels.values()),
        "update_top_kernels": [
            {"name": name[:90], "ms": t / 1e3, "launches": c}
            for name, (t, c) in sorted(update_kernels.items(),
                                       key=lambda kv: -kv[1][0])[: args.top]],
        "minibatch_groups": groups,
        "graphed_rollout_step": graphed,
        "rollout_steps_profiled": steps,
        "rollout_wall_ms_per_step": step_wall * 1e3,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e3 / steps / (step_wall * 1e3))
        if busy_us else None,
        "kernel_launches_per_step": sum(c for _, c in per_kernel.values()) / steps,
        "top_kernels": [{"name": name[:90], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": c / steps} for name, (t, c) in top],
        "rollout_groups": rollout_groups(prof, steps),
    }


def _graphed_step(rollout, steps: int) -> dict:
    """The trainer's captured rollout step (``ppo.UpdateGraphs.rollout``): one replay
    under the profiler (its kernel nodes, its copy and set nodes, the kernels'
    summed time), then ``steps`` replays between CUDA events (device ms a step).
    The graph's step counter is set back before each, so the replays stay inside
    its [T, N, ...] buffers. A copy of ``chip_smoke.rollout_step_profile``, kept
    here so that this script runs on a checkout that predates it."""
    rollout.carry.t.zero_()
    activities = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        rollout.step.graph.replay()
        torch.cuda.synchronize()
    nodes = collections.Counter()
    busy_us = 0.0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            copy = "memcpy" in evt.name.lower() or "memset" in evt.name.lower()
            nodes["copy_nodes" if copy else "kernel_nodes"] += 1
            busy_us += 0.0 if copy else evt.time_range.elapsed_us()
    rollout.carry.t.zero_()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        rollout.step.graph.replay()
    end.record()
    end.synchronize()
    return {**nodes, "kernel_us_in_one_replay": busy_us,
            "device_ms_per_step": start.elapsed_time(end) / steps}


def profile_match(args, dev) -> dict:
    stacks = tournament.stack_bundles(
        [load_policy_bundle(p, dev) for p in chip_smoke.TOURNAMENT_MODELS[:2]], 19)
    grid, _, _ = metrics.build_eval_grid(20, 2, 42, device=dev)
    cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)

    def match():
        generator = torch.Generator(device=dev).manual_seed(tournament.pair_seed(42, 1))
        acc = metrics.rollout_match(*stacks, cfg, grid, generator)
        torch.cuda.synchronize()
        return acc

    match()
    t0 = time.perf_counter()
    acc = match()
    wall = time.perf_counter() - t0
    steps = chip_smoke.loop_steps(acc, 3000)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        match()
    per_kernel = _device_kernels(prof)
    busy_us = sum(t for t, _ in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]
    return {
        "card": chip_smoke.card_line(),
        "match": " vs ".join(os.path.basename(p) for p in chip_smoke.TOURNAMENT_MODELS[:2]),
        "num_envs": grid.wp_x.shape[0],
        "loop_steps": steps,
        "match_wall_ms": wall * 1e3,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall) if busy_us else None,
        "kernel_launches_per_step": sum(c for _, c in per_kernel.values()) / steps,
        "top_kernels": [{"name": name[:90], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": c / steps} for name, (t, c) in top],
        "rollout_groups": rollout_groups(prof, steps),
    }


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--update", action="store_true",
                   help="profile the PPO update's minibatch loop instead of an env step")
    p.add_argument("--eager", action="store_true",
                   help="with --update or --selfplay: run the update eagerly, not as CUDA "
                        "graphs")
    p.add_argument("--selfplay", action="store_true",
                   help="profile a self-play update and its rollout's env steps")
    p.add_argument("--match", action="store_true",
                   help="profile one tournament match (40 envs, one policy per seat)")
    p.add_argument("--tiled", action="store_true",
                   help="the pool resident, read by row id, instead of per-env rows")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    if args.update:
        print(json.dumps(profile_update(args, dev), indent=1))
        return 0
    if args.match:
        print(json.dumps(profile_match(args, dev), indent=1))
        return 0
    if args.selfplay:
        with torch.enable_grad():
            print(json.dumps(profile_selfplay(args, dev), indent=1))
        return 0
    cfg = senv.RacingConfig(num_sensors=11)
    track = _geometry(args, dev)
    model, _ = interop.load_npz(chip_smoke.MODEL, device=dev)
    params, log_std = model.params(), model.log_std
    gen = torch.Generator(device=dev).manual_seed(0)
    state, obs = senv.reset(cfg, track)
    vstate = vector.init(state, args.num_envs)
    vstate, obs, *_ = chip_smoke.rollout(params, log_std, cfg, track, vstate, obs, gen, 16)
    torch.cuda.synchronize()
    # host wall time without the profiler, whose CPU-side recording slows the host
    t0 = time.perf_counter()
    vstate, obs, *_ = chip_smoke.rollout(params, log_std, cfg, track, vstate, obs, gen,
                                         args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        chip_smoke.rollout(params, log_std, cfg, track, vstate, obs, gen, args.steps)
        torch.cuda.synchronize()

    per_kernel = _device_kernels(prof)
    busy_us = sum(t for t, _ in per_kernel.values())
    launches = sum(n for _, n in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]
    steps = args.steps
    out = {
        "card": chip_smoke.card_line(),
        "geometry": "tiled" if args.tiled else "gathered",
        "num_envs": args.num_envs,
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "env_steps_per_s": args.num_envs * steps / wall,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall) if busy_us else None,
        "kernel_launches_per_step": launches / steps,
        "top_kernels": [{"name": name[:90], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": n / steps} for name, (t, n) in top],
    }
    if not busy_us:
        print("torch_step_profile: the profiler saw no device time", file=sys.stderr)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

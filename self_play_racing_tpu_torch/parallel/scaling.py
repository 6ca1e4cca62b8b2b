"""Scaling measurement of data-parallel PPO and its multi-process launcher (port of
``self_play_racing_tpu/parallel/scaling.py``).

Measures the full PPO update's throughput over the process group, one device a
process, holding the env count *per device* constant (weak scaling: more cards
host more envs). Efficiency(n) = throughput(n) / (n * throughput(1)).

One process (one card):
  python -m self_play_racing_tpu_torch.parallel.scaling --envs-per-device 512 \\
      --out data/scaling_1proc.json

P processes, one card each: ONE command per process, every one with the same
``--coordinator`` (rank 0's address) and its own ``--process-id``:

  # process i of P:
  python -m self_play_racing_tpu_torch.parallel.scaling \\
      --coordinator 10.0.0.1:8476 --num-processes P --process-id i \\
      --envs-per-device 512 \\
      --baseline-json data/scaling_1proc.json --out data/scaling_Pproc.json

Each process owns one device, so a run measures its whole group (a sweep over
sizes is one launch per size). The KL exit decides how many minibatches an update
runs, and it is decided on the group's mean KL, so a row records the minibatches
each timed update computed and applied; ``--kl-target inf`` turns the exit off,
so that every size does the same work a device (update_epochs x
num_minibatches minibatches of the same rows). Rank 0 writes the artifact, schema
"scaling_sweep_v1":

  {"schema": "scaling_sweep_v1", "platform": ..., "num_processes": P,
   "devices_total": D, "envs_per_device": E, "num_steps": T,
   "shard_local_minibatch": true, "rows": [measure() dicts],
   "baseline_env_steps_per_s": <the baseline's largest row's steps/s or null>,
   "efficiency_vs_baseline": <steps/s / (P * baseline) or null>}

Runs on cuda (NCCL) unless ``--device cpu`` (gloo) is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from .._device import resolve_device
from ..agent.ppo import unpack_metrics
from ..agent.trainer import PPOTrainer
from ..configs import base_config
from ..envs import single as senv
from ..envs import track as trk
from . import mesh as pmesh


def measure(num_devices: int, envs_per_device: int = 512, num_steps: int = 128,
            reps: int = 3, seed: int = 1, shard_local: bool = True, device=None,
            kl_target: float | None = None):
    """Updates/s and env-steps/s of a data-parallel PPO update over the process
    group, which must hold ``num_devices`` processes (one device each), with the
    minibatches each timed update computed (the KL exit's included) and applied.
    ``kl_target`` replaces the config's (``inf``: no KL exit).

    ``shard_local`` takes the per-shard minibatch shuffle (``cfg.data_shards`` =
    num_devices: only the gradient and scalar all-reduces in the update phase);
    False the reference-parity global shuffle, which gathers the whole batch on
    every rank."""
    mesh = pmesh.make_mesh(device)
    if num_devices != mesh.world:
        raise ValueError(f"measure: {num_devices} devices requested, the process group "
                         f"holds {mesh.world} (one device a process)")
    num_envs = envs_per_device * num_devices
    kw = {} if kl_target is None else {"kl_target": kl_target}
    cfg = base_config(num_envs=num_envs, num_steps=num_steps,
                      total_timesteps=num_envs * num_steps * 100, seed=seed,
                      data_shards=num_devices if shard_local else 1, **kw)
    np.random.seed(seed)  # gen_tracks draws each track's shape from the global RNG
    cps = trk.gen_tracks(16, seed=seed)
    pool = trk.make_track_pool(cps, [7.0] * 16, device=mesh.device)
    track = trk.gather_tracks(pool, np.arange(num_envs) % 16)
    trainer = PPOTrainer(cfg, senv.RacingConfig(num_sensors=11), track)
    trainer.shard(mesh)
    runner, aux = trainer.runner, trainer.aux

    runner, metrics = trainer.update_step(runner, aux)  # warm-up
    unpack_metrics(metrics)  # the metrics reach the host: the update has ended
    timed = []
    t0 = time.perf_counter()
    for _ in range(reps):
        runner, metrics = trainer.update_step(runner, aux)
        timed.append(unpack_metrics(metrics))
    dt = (time.perf_counter() - t0) / reps
    return {
        "devices": num_devices,
        "num_envs": num_envs,
        "shard_local_minibatch": shard_local,
        "ms_per_update": dt * 1e3,
        "env_steps_per_s": cfg.batch_size / dt,
        "updates_per_s": 1.0 / dt,
        "kl_target": cfg.kl_target,
        # the exit's minibatch is computed and not applied
        "minibatches_computed": [int(m["minibatches_applied"] + m["kl_stopped"])
                                 for m in timed],
        "minibatches_applied": [int(m["minibatches_applied"]) for m in timed],
    }


def _platform(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)} ({dev})"
    return str(dev)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--envs-per-device", type=int, default=512)
    p.add_argument("--num-steps", type=int, default=128)
    p.add_argument("--max-devices", type=int, default=None,
                   help="ignored: each process owns one device, so a run measures "
                        "its whole group (launch fewer processes instead)")
    p.add_argument("--global-shuffle", action="store_true",
                   help="measure the reference-parity global minibatch shuffle "
                        "(the batch gathered on every rank) instead of shard-local")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multi-process: rank 0's address; every process passes the "
                        "same value (torch.distributed)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multi-process: total process count (one per device)")
    p.add_argument("--process-id", type=int, default=None,
                   help="multi-process: this process's rank, 0..num-processes-1")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="artifact path (scaling_sweep_v1 schema); written by "
                        "rank 0 only")
    p.add_argument("--baseline-json", default=None, metavar="JSON",
                   help="single-process artifact to compute multi-process "
                        "efficiency against (its largest-device row)")
    p.add_argument("--kl-target", type=float, default=None,
                   help="the KL exit's threshold (default: the config's; inf: no exit, "
                        "the same minibatches at every size)")
    p.add_argument("--device", default=None, help="default: cuda (NCCL); cpu: gloo")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    pmesh.distributed_init(args.coordinator, args.num_processes, args.process_id,
                           device=dev)
    mesh = pmesh.make_mesh(dev)
    if args.max_devices and args.max_devices != mesh.world and mesh.rank == 0:
        print(f"--max-devices={args.max_devices} ignored: one device a process, the "
              f"group holds {mesh.world}", file=sys.stderr)
    row = measure(mesh.world, args.envs_per_device, args.num_steps,
                  shard_local=not args.global_shuffle, device=mesh.device,
                  kl_target=args.kl_target)
    # against the sweep's first row, which is this row: the JAX package's rule
    # for a multi-process run, which measures its full mesh only
    row["efficiency"] = 1.0 / row["devices"]
    results = [row]
    if mesh.rank == 0:
        print(json.dumps(row))

    baseline = None
    if args.baseline_json and os.path.exists(args.baseline_json):
        with open(args.baseline_json) as f:
            bl = json.load(f)
        # the baseline's full-mesh (largest-device) row is the per-process reference
        baseline = max(bl["rows"], key=lambda r: r["devices"])["env_steps_per_s"]

    if args.out and mesh.rank == 0:
        artifact = {
            "schema": "scaling_sweep_v1",
            "platform": _platform(mesh.device),
            "num_processes": mesh.world,
            "devices_total": mesh.world,
            "envs_per_device": args.envs_per_device,
            "num_steps": args.num_steps,
            "shard_local_minibatch": not args.global_shuffle,
            "rows": results,
            "baseline_env_steps_per_s": baseline,
            "efficiency_vs_baseline": (
                row["env_steps_per_s"] / (mesh.world * baseline) if baseline else None
            ),
        }
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=2)
        print(f"wrote {args.out}")
    pmesh.barrier(mesh)
    if args.coordinator is not None:
        torch.distributed.destroy_process_group()
    return results


if __name__ == "__main__":
    main()

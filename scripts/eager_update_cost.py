#!/usr/bin/env python3
"""What an eager update costs on updates that take the KL exit: the paths that
run without CUDA graphs (no process group with ``eager=True``, world 1 over NCCL,
one NCCL process a card).

  python scripts/eager_update_cost.py             # one card: no group, then world 1
  python scripts/eager_update_cost.py --world 4   # one NCCL process on each of 4 cards

Self-play at ``train scale``'s width, as chip_smoke.py's phase h runs it (4096
envs x 256 steps, 2 cars, opponents per env, ``snapshot_freq`` 1, the canonical
pool tiled), with ``kl_target`` EXIT_KL_TARGET so that updates take the KL exit.
Each run trains UPDATES updates from the seed and times each (host clock to a
synchronize) with its minibatch loop (``chip_smoke.dp_train``); the first includes
the process's first launches. Prints one JSON line a run: the card's name and
power limit, each update's ms and its loop's, and the minibatches each computed
and applied.

On one card: the trainer without a process group, run eagerly (``eager=True``
where the checkout has the CUDA graphs; a checkout from before them is eager
there anyway), then the same seeded trainer through ``distributed_init`` at world
1 over NCCL and ``shard()``. With ``--world N``: N processes, rank r on
``cuda:r``, each with its 4096 / N envs and ``data_shards = N``.

It uses only what checkouts from before the graphs also have, so copy it into a
``git archive`` of the parent and run both checkouts in one call to compare them.
Exits non-zero without a card or when a rank fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import os
import sys
import tempfile

import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer  # noqa: E402
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402

UPDATES = 4
EXIT_KL_TARGET = 0.005


def config(world: int):
    return dataclasses.replace(chip_smoke.dp_config(world), kl_target=EXIT_KL_TARGET)


def trainer(cfg, dev):
    """Phase h's trainer, run eagerly where the checkout has the graphs."""
    eager = ({"eager": True} if "eager" in inspect.signature(SelfPlayTrainer).parameters
             else {})
    pool = canonical_bench_pool(chip_smoke.NUM_TRACKS, device=dev)
    return SelfPlayTrainer(cfg, menv.MultiRacingConfig(num_agents=chip_smoke.NUM_AGENTS,
                                                       num_sensors=11),
                           trk.tiled_pooled_tracks(pool, cfg.num_envs), **eager)


def run(tr, label: str) -> dict:
    ms, _, stats, _ = chip_smoke.dp_train(tr, UPDATES)
    return {"run": label, "card": chip_smoke.card_line(), "envs": tr.runner.done.shape[0],
            "update_ms": ms["wall"], "minibatch_loop_ms": ms["loop"],
            "computed": [int(s["computed"].sum()) for s in stats],
            "applied": [int(s["applied"].sum()) for s in stats]}


def rank_main(rank, world, port, out):
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    pmesh.distributed_init(f"127.0.0.1:{port}", world, rank, backend="nccl", device=dev)
    try:
        tr = trainer(config(world), dev)
        tr.shard(pmesh.make_mesh(dev))
        result = run(tr, f"rank {rank} of {world} over NCCL")
    finally:
        torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(result, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, default=1,
                   help="NCCL processes, one card each (default 1: no group, then world 1)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available() or args.world > torch.cuda.device_count():
        print("eager_update_cost: needs as many CUDA devices as --world", file=sys.stderr)
        return 1
    chip_smoke._cuda.build()
    if args.world == 1:
        dev = torch.device("cuda", 0)
        print(json.dumps(run(trainer(config(1), dev), "no group, eager")))
        pmesh.distributed_init(f"127.0.0.1:{chip_smoke.free_port()}", 1, 0, device=dev)
        try:
            tr = trainer(config(1), dev)
            tr.shard(pmesh.make_mesh(dev))
            print(json.dumps(run(tr, "world 1 over NCCL")))
        finally:
            torch.distributed.destroy_process_group()
        return 0
    ctx = mp.get_context("spawn")
    port = chip_smoke.free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(args.world)]
        procs = [ctx.Process(target=rank_main, args=(r, args.world, port, outs[r]))
                 for r in range(args.world)]
        for proc in procs:
            proc.start()
        for proc in procs:
            proc.join(600)
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        if [proc.exitcode for proc in procs] != [0] * args.world:
            print(f"eager_update_cost: ranks exited {[proc.exitcode for proc in procs]}",
                  file=sys.stderr)
            return 1
        for out in outs:
            with open(out) as f:
                print(json.dumps(json.load(f)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What an update costs as device programs and eagerly, on updates that take the
KL exit: the trainer without a process group and over an NCCL group, each run
from one seed graphed (CUDA graphs, the default on the card) and with
``eager=True``.

  python scripts/eager_update_cost.py             # one card: no group, then world 1
  python scripts/eager_update_cost.py --world 4   # one NCCL process on each of 4 cards
  NCCL_ALGO=Ring NCCL_PROTO=Simple python scripts/eager_update_cost.py --world 4

Self-play at ``train scale``'s width, as chip_smoke.py's phase h runs it (4096
envs x 256 steps, 2 cars, opponents per env, ``snapshot_freq`` 1, the canonical
pool tiled), with ``kl_target`` EXIT_KL_TARGET so that updates take the KL exit.
Each run trains UPDATES updates from the seed and times each (host clock to a
synchronize) with its minibatch loop (``chip_smoke.dp_train``); the first
includes the process's first launches and the graphs' first capture. Prints one
JSON line a run: the card's name and power limit, whether it ran graphed, each
update's ms and its loop's, the minibatches each computed and applied, and the
capture seconds.

On one card: the trainer without a process group, then the same seeded trainer
through ``distributed_init`` at world 1 over NCCL and ``shard()``. With
``--world N``: N processes, rank r on ``cuda:r``, each with its 4096 / N envs and
``data_shards = N``. In each place the graphed run is held to the eager one
(``chip_smoke.graphed_against_eager``): bitwise, or else its parameters within
the distance of a control (the graphed run from params one ulp up) and the same
minibatches applied. The ranks inherit the environment, so
``NCCL_ALGO=Ring NCCL_PROTO=Simple`` before the command makes NCCL take one
algorithm and protocol in the graphs and eagerly.

Exits non-zero without a card, when a rank fails or when a comparison fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.parallel import mesh as pmesh  # noqa: E402

UPDATES = 4
EXIT_KL_TARGET = 0.005
MODES = ("graphed", "eager", "control")


def config(world: int):
    return dataclasses.replace(chip_smoke.dp_config(world), kl_target=EXIT_KL_TARGET)


def run(cfg, dev, mode: str, label: str, mesh=None) -> dict:
    """UPDATES updates of phase h's trainer in ``mode``: "graphed", "eager"
    (``eager=True``) or "control" (graphed, from params one ulp up)."""
    tr = chip_smoke.dp_trainer(cfg, dev, eager=mode == "eager")
    if mode == "control":
        with torch.no_grad():
            for p in tr.runner.train.model.parameters():
                p.copy_(torch.nextafter(p, torch.full_like(p, float("inf"))))
    if mesh is not None:
        tr.shard(mesh)
    ms, metrics, stats, _ = chip_smoke.dp_train(tr, UPDATES)
    graphs = tr.update_step.graphs
    line = {"run": f"{label}, {mode}", "card": chip_smoke.card_line(),
            "envs": tr.runner.done.shape[0], "graphed": graphs is not None,
            "update_ms": ms["wall"], "minibatch_loop_ms": ms["loop"],
            "capture_s": 0.0 if graphs is None else graphs.capture_seconds,
            "computed": [int(s["computed"].sum()) for s in stats],
            "applied": [int(s["applied"].sum()) for s in stats]}
    return {"line": line, "metrics": metrics,
            "params": [p.detach().cpu() for p in tr.runner.train.model.parameters()]}


def compare(cfg, dev, label: str, mesh=None) -> list:
    """The three runs in one place; the graphed run held to the eager one. Returns
    the graphed and eager runs' JSON lines."""
    out = {mode: run(cfg, dev, mode, label, mesh) for mode in MODES}
    if not out["graphed"]["line"]["graphed"] or out["eager"]["line"]["graphed"]:
        raise AssertionError(f"{label}: graphed {out['graphed']['line']['graphed']}, "
                             f"eager=True graphed {out['eager']['line']['graphed']}")
    control = chip_smoke.max_abs(out["control"]["params"], out["graphed"]["params"])
    chip_smoke.graphed_against_eager(label, out["graphed"], out["eager"], control)
    return [out[m]["line"] for m in ("graphed", "eager")]


def rank_main(rank, world, backend, port, out):
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    pmesh.distributed_init(f"127.0.0.1:{port}", world, rank, backend=backend, device=dev)
    try:
        lines = compare(config(world), dev, f"rank {rank} of {world} over NCCL",
                        pmesh.make_mesh(dev))
    finally:
        torch.distributed.destroy_process_group()
    torch.save(lines, out)


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
        lines = compare(config(1), dev, "no group")
        pmesh.distributed_init(f"127.0.0.1:{chip_smoke.free_port()}", 1, 0, device=dev)
        try:
            lines += compare(config(1), dev, "world 1 over NCCL", pmesh.make_mesh(dev))
        finally:
            torch.distributed.destroy_process_group()
    else:
        ranks = chip_smoke.run_rank_processes(rank_main, args.world, "nccl",
                                              lambda r: (), 900)
        lines = [line for rank in ranks for line in rank]
    for line in lines:
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

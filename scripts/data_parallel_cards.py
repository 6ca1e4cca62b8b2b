#!/usr/bin/env python3
"""Data-parallel self-play across the cards of one host, one NCCL process a card.

  python scripts/data_parallel_cards.py [--world N]
  NCCL_ALGO=Ring NCCL_PROTO=Simple python scripts/data_parallel_cards.py

chip_smoke.py's phase h.2 comparison (``chip_smoke.data_parallel_ranks``) with
rank r on ``cuda:r`` over NCCL: one update of ``train scale``'s self-play (4096
envs in all, 256 steps, 2 cars, the canonical pool tiled, snapshot_freq 1) split
over N processes with data_shards = N, against one process on cuda:0 with all 4096
envs and data_shards = N. Each rank runs the update as device programs (its
all-reduces captured in the CUDA graphs) and then, from the same seed, with
``eager=True``. It holds what phase h holds (minibatches_applied, the first
epoch's per-minibatch stats, the parameters within 1e-3 beside a control from
params one ulp up, the ranks bitwise alike, the launches of a rank) but counts
the envs whose final observations are bitwise one process's rather than
requiring all: at 1024 envs a rank's rollout need not round as the 4096-env one
does (``scripts/row_invariance.py`` asks each op). The graphed update is held to
the eager one (``chip_smoke.graphed_against_eager``): bitwise, or else within the
one-ulp control's distance with the same exit, the reason printed. The ranks
inherit the environment, so ``NCCL_ALGO=Ring NCCL_PROTO=Simple`` before the
command makes NCCL take one algorithm and protocol in the graphs and eagerly.
It prints each rank's ms/update, graphed and eager, beside one process's, all
after a warm-up update: strong scaling, the same 4096 envs over N cards. N
defaults to the cards present (at least 2). Exits non-zero on any failure.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, default=None,
                   help="processes, one card each (default: every card)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("data_parallel_cards: no CUDA device", file=sys.stderr)
        return 1
    world = args.world or torch.cuda.device_count()
    if not 2 <= world <= torch.cuda.device_count():
        print(f"data_parallel_cards: {world} processes need as many cards, at least 2; "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 1
    chip_smoke._cuda.build()
    card = chip_smoke.card_line()
    print(f"cards: {card}")
    launches = chip_smoke.data_parallel_ranks(
        torch.device("cuda", 0), card, world=world, backend="nccl",
        devices=[f"cuda:{r}" for r in range(world)], rollout_bitwise=False, eager_too=True)
    print(json.dumps({"world": world, "backend": "nccl", "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

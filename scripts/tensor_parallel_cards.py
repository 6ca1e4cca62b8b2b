#!/usr/bin/env python3
"""Tensor-parallel towers across the cards of one host, one NCCL process a card.

  python scripts/tensor_parallel_cards.py [--world N]
  NCCL_ALGO=Ring NCCL_PROTO=Simple python scripts/tensor_parallel_cards.py

chip_smoke.py's phase j comparison (``chip_smoke.tensor_parallel_ranks``) with
rank r on ``cuda:r`` over NCCL, on a mesh of N / 2 data rows x 2 model ranks
(data 2 x model 2 on four cards): one single-car PPO update (4096 envs x 256
steps, towers of 128, the canonical pool tiled) and one self-play update (phase
h's, towers of 128), after a warm-up update, against one process on cuda:0
unsharded. It holds what phase j holds: each rank's slices of the towers and
their Adam moments, minibatches_applied, the gathered parameters within the
larger of 1e-3 and four times the distance of a control (one process from params
one ulp up) of one process's, the ranks' gathered
parameters bitwise alike, the self-play snapshot the whole parameters, and a
rank's launches. Each rank runs both updates as device programs (the data and
model groups' all-reduces captured in the CUDA graphs) and then, from the same
seed, with ``eager=True``; the graphed updates are held to the eager ones
(``chip_smoke.graphed_against_eager``): bitwise, or else within the one-ulp
control's distance with the same exit, the reason printed. The ranks inherit
the environment, so ``NCCL_ALGO=Ring NCCL_PROTO=Simple`` before the command makes
NCCL take one algorithm and protocol in the graphs and eagerly. It prints each
rank's ms/update, graphed and eager, beside one process's. N defaults to the
cards present (an even number, at least 2). Exits non-zero on any failure.
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
        print("tensor_parallel_cards: no CUDA device", file=sys.stderr)
        return 1
    world = args.world or torch.cuda.device_count()
    if not (2 <= world <= torch.cuda.device_count() and world % chip_smoke.TP_MODEL == 0):
        print(f"tensor_parallel_cards: {world} processes need as many cards and a "
              f"multiple of {chip_smoke.TP_MODEL}; {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 1
    chip_smoke._cuda.build()
    card = chip_smoke.card_line()
    print(f"cards: {card}")
    launches = chip_smoke.tensor_parallel_ranks(
        torch.device("cuda", 0), card, world=world, backend="nccl",
        devices=[f"cuda:{r}" for r in range(world)], eager_too=True)
    print(json.dumps({"world": world, "model_parallel": chip_smoke.TP_MODEL,
                      "backend": "nccl", "launches": launches}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

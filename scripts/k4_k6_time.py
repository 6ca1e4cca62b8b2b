#!/usr/bin/env python3
"""The multi-car env's transition and K6's device time, on the card, to compare
two builds.

  python scripts/k4_k6_time.py

At chip_smoke.py's shapes, through public functions every checkout of the port
has, so the file can be copied into another checkout's ``scripts/`` and run
there in the same chip call:

- ``envs.multi.transition`` (the car step, the track query, the car-pair contacts
  and the rewards) at 4096 envs x 2 cars on the canonical 16-track pool, from
  cars packed around their start line so that some touch: device time of one
  call in a CUDA graph of 20 calls, median of 21 replays (CUDA events), and the
  cars that touch a partner after the step;
- ``ops.gae.compute_gae`` at [256, 4096] (the main path) and [2048, 16] (``train
  single``'s default) on chip_smoke.py's rollout-like batch: warm, a CUDA graph of
  20 back-to-back calls (the 12.6 MB of inputs stay in the 50 MB L2), and cold, a
  graph of 10 (128 MB write, call) pairs less a graph of the 10 writes.

Prints one JSON object: the card's name and power limit and the times in
microseconds.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.ops import gae  # noqa: E402
from self_play_racing_tpu_torch.ops import geometry as geo  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402


def gae_batch(gen, steps, envs, dev):
    """chip_smoke.py's rollout-like batch (rewards, dones, values, next value and
    done), drawn here so that the file runs in checkouts whose chip_smoke.py
    predates its helper."""
    rewards = torch.rand((steps, envs), generator=gen, device=dev) * 2.0
    crash = torch.rand((steps, envs), generator=gen, device=dev) < 1 / 300
    rewards = torch.where(crash, rewards - 60.0, rewards)
    values = torch.randn((steps, envs), generator=gen, device=dev) * 10.0 + 20.0
    next_value = torch.randn((envs,), generator=gen, device=dev) * 10.0 + 20.0
    next_done = torch.rand((envs,), generator=gen, device=dev) < 1 / 300
    return rewards, crash, values, next_value, next_done


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_k6_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    out = {"card": chip_smoke.card_line()}
    n = chip_smoke.NUM_ENVS
    track = trk.gather_tracks(canonical_bench_pool(chip_smoke.NUM_TRACKS, device=dev),
                              np.arange(n) % chip_smoke.NUM_TRACKS)
    cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)
    rng = np.random.default_rng(0)
    state = menv.reset_state(cfg, track, position_idx=np.tile([0, 1], (n, 1)))
    # squeeze the grid: the cars start 1.75 m apart instead of 3.5, so some touch
    state.x = (state.x + state.x.mean(dim=1, keepdim=True)) / 2
    state.y = (state.y + state.y.mean(dim=1, keepdim=True)) / 2
    state.vx = torch.as_tensor(rng.normal(0, 10, (n, 2)), dtype=torch.float32, device=dev)
    state.vy = torch.as_tensor(rng.normal(0, 10, (n, 2)), dtype=torch.float32, device=dev)
    action = torch.as_tensor(rng.uniform(-1, 1, (n, 2, 2)), dtype=torch.float32, device=dev)
    step = lambda: menv.transition(cfg, track, state, action)
    new = step()[0]
    corners = geo.car_corners(new.x, new.y, new.angle, cfg.car.length / 2, cfg.car.width / 2)
    pairs = geo.rectangles_intersect_pairs_plain(*corners)
    out["multi_transition_graph_us"] = chip_smoke.graph_ms(step) * 1e3
    out["multi_transition_cars_touching"] = int((pairs.sum(dim=-1) > 1).sum())

    gen = torch.Generator(device=dev).manual_seed(6)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev).zero_
    for steps, envs in ((chip_smoke.STEPS, n), (2048, 16)):
        args = gae_batch(gen, steps, envs, dev)
        call = lambda: gae.compute_gae(*args, 0.99, 0.95)

        def cold():
            flush()
            call()
        warm = chip_smoke.graph_ms(call)
        cold_ms = chip_smoke.graph_ms(cold, launches=10) - chip_smoke.graph_ms(flush,
                                                                               launches=10)
        out[f"gae_{steps}x{envs}_graph_us"] = warm * 1e3
        out[f"gae_{steps}x{envs}_cold_graph_us"] = cold_ms * 1e3
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())

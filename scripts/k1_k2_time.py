#!/usr/bin/env python3
"""K1's and K2's device and host time at the main paths' shapes, on the card.

  python scripts/k1_k2_time.py

At chip_smoke.py's shapes (the canonical 16-track pool gathered to 4096 envs:
S = 896 segments, W = 512 waypoints; poses from seed 0), through the public
wrappers ``raycast_walls`` and ``progress_and_collision`` with inputs that need no
copy, so that each call is one launch:

- device time: a CUDA graph of 20 calls, median of 21 replays (CUDA events), for
  K1 at [4096, 11] rays (single car) and [4096, 2, 11] against [4096, 1, 1, 896]
  rows (the self-play launch), K2 at [4096] cars and [4096, 2] against
  [4096, 1, 512] rows (shared rows), and K1 then K2 at the self-play shapes in one
  graph (K2 then finds its rows evicted from the L2);
- host time of one eager call: the host clock around 200 back-to-back calls
  (before the card is waited for, so the card's time is not in it), median of 21
  windows; for the wrappers at all four shapes, and for the single-car launches
  through the launchers of ``ops/_cuda.py`` alone (the wrapper's checks, copies
  and allocations left out); in a checkout with launch plans, also the launchers
  with the plan lookup hoisted out (``*_plan_hoisted``).

Every checkout of the port has these wrappers, and launchers that take the
single-car launches' arguments, with these signatures, so the file can be copied
into another checkout's ``scripts/`` and run there, to compare two builds in one
chip call. Prints one JSON object: the card's name and power limit, and the
times in microseconds.
"""
from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402
from self_play_racing_tpu_torch.ops import geometry as geo  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402


def host_us(fn, windows=21, calls=200) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def calls(track, cfg, rng, dev):
    """The four wrapper calls, by name (K1 and K2 at one and two cars per env),
    the two single-car launcher calls, and the plan lookup of each of those."""
    fields = ("seg_sx", "seg_sy", "seg_vx", "seg_vy", "seg_c")
    out = {}
    for a in (1, 2):
        x, y, ang = chip_smoke.race_poses(track, rng, dev, a)
        rays = chip_smoke.car_rays(cfg, x, y, ang)                  # [N, A, 11]
        segs = [getattr(track, f)[:, None, None, :] for f in fields]
        if a == 1:
            x, y, ang = x[:, 0].contiguous(), y[:, 0].contiguous(), ang[:, 0]
            rays = [t[:, 0].contiguous() for t in rays]             # [N, 11]
            segs = [t[:, 0] for t in segs]                          # [N, 1, S]
        cx, cy = (t.contiguous() for t in geo.car_corners(
            x, y, ang, cfg.car.length / 2, cfg.car.width / 2))
        wp = [getattr(track, f) for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")]
        if a == 2:
            wp = [t[:, None, :] for t in wp]                        # [N, 1, W]
        tail = [t.reshape((-1,) + (1,) * (a - 1)).expand(x.shape).contiguous()
                for t in (track.n_wp, track.track_width)]
        out[f"k1_{a}car"] = lambda rays=rays, segs=segs: geo.raycast_walls(
            *rays, *segs[:4], cfg.max_sensor_range, seg_c=segs[4])
        out[f"k2_{a}car"] = lambda args=(x, y, cx, cy, *wp, *tail): \
            geo.progress_and_collision(*args)
        if a == 1:
            n, r, s, w = x.shape[0], rays[0].shape[-1], segs[0].shape[-1], wp[0].shape[-1]
            dist = torch.empty(rays[0].shape, device=dev)
            progress = torch.empty(x.shape, device=dev)
            crashed = torch.empty(x.shape, dtype=torch.bool, device=dev)
            k1_args = (*rays, *segs, dist, n, r, s, cfg.max_sensor_range)
            k2_args = (x, y, cx, cy, *wp, *tail, progress, crashed, n, 1, cx.shape[-1], w)
            out["launch_k1_1car"] = lambda: _cuda.launch_raycast_walls(*k1_args)
            out["launch_k2_1car"] = lambda: _cuda.launch_progress_and_collision(*k2_args)
            lookups = {"launch_k1_1car": ("raycast_walls_plan", (r, s)),
                       "launch_k2_1car": ("progress_collision_plan", (1, cx.shape[-1], w))}
    return out, lookups


def host_us_plan_hoisted(fn, name, args) -> float:
    """The host time of launcher ``fn`` with its plan lookup ``_cuda.<name>``
    replaced by a function that returns the plan already made."""
    lookup = getattr(_cuda, name)
    plan = lookup(*args)
    setattr(_cuda, name, lambda *_: plan)
    try:
        return host_us(fn)
    finally:
        setattr(_cuda, name, lookup)


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_k2_time: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    pool = canonical_bench_pool(16, device=dev)
    track = trk.gather_tracks(pool, np.arange(chip_smoke.NUM_ENVS) % 16)
    cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)
    fns, lookups = calls(track, cfg, np.random.default_rng(0), dev)
    graph_us = {name: chip_smoke.graph_ms(fn) * 1e3 for name, fn in fns.items()
                if not name.startswith("launch")}

    def step_pair():
        fns["k1_2car"]()
        fns["k2_2car"]()
    pair = chip_smoke.graph_ms(step_pair) * 1e3
    graph_us["k1_then_k2_2car"] = pair
    graph_us["k2_2car_cold"] = pair - graph_us["k1_2car"]
    host = {name: host_us(fn) for name, fn in fns.items()}
    if hasattr(_cuda, "raycast_walls_plan"):  # a checkout with launch plans
        for name, (lookup, args) in lookups.items():
            host[f"{name}_plan_hoisted"] = host_us_plan_hoisted(fns[name], lookup, args)
    print(json.dumps({"card": chip_smoke.card_line(), "graph_us": graph_us,
                      "host_us": host}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

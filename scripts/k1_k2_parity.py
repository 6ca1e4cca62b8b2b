#!/usr/bin/env python3
"""A digest of the env kernels' outputs on seeded inputs, to compare two builds.

  python scripts/k1_k2_parity.py

Runs ``raycast_walls`` (K1) and ``progress_and_collision`` (K2) through their
public wrappers on the card at chip_smoke.py's shapes (the canonical 16-track pool
gathered to 4096 envs, single car and two cars per env) and on synthetic rows of
other lengths (segments 1, 33, 864, 1023 and 1024, waypoints 1, 33 and 600, some
cut at an offset so that no row starts 16-byte-aligned); then ``raycast_cars``
(K3) and ``car_update`` (K5) at 1, 2 and 8 cars per env; then 16 steps of the
single-car and the two-car env (``transition`` and ``observe``, which launch the
envs' kernels, whatever they are in the checkout) from seeded states and actions.
Prints one JSON object: the card, and per case the sha256 of the output bytes.
Two checkouts whose kernels are bitwise equal print the same digests; run it in
both, in one chip call, to hold a new kernel to an old one on every case at once.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch._tree import tree_map  # noqa: E402
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import single as senv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.ops import dynamics  # noqa: E402
from self_play_racing_tpu_torch.ops import geometry as geo  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def f32(rng, shape, lo, hi, dev):
    return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=dev)


def env_digests(track, rng, dev) -> dict:
    """16 steps of each env from its reset state under seeded actions: a digest of
    every transition's state, reward and done flags and every observation."""
    n = chip_smoke.NUM_ENVS
    out = {}
    for name, env, cfg in (("single", senv, senv.RacingConfig(num_sensors=11)),
                           ("two-car", menv, menv.MultiRacingConfig(num_agents=2,
                                                                    num_sensors=11))):
        if env is senv:
            state = senv.reset_state(cfg, track)
            shape = (n, 2)
        else:
            slots = torch.as_tensor(np.argsort(rng.random((n, 2)), axis=-1), device=dev)
            state = menv.reset_state(cfg, track, position_idx=slots)
            shape = (n, 2, 2)
        parts = []
        for _ in range(16):
            action = f32(rng, shape, -1, 1, dev)
            state, reward, term, trunc, _ = env.transition(cfg, track, state, action)
            tree_map(parts.append, state)
            parts += [reward, term, trunc, env.observe(cfg, track, state)]
        out[f"env {name} 16 steps"] = digest(*parts)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_k2_parity: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    pool = canonical_bench_pool(16, device=dev)
    track = trk.gather_tracks(pool, np.arange(chip_smoke.NUM_ENVS) % 16)
    cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)
    out = {}
    for a in (1, 2):
        x, y, ang = chip_smoke.race_poses(track, rng, dev, a)
        rays = chip_smoke.car_rays(cfg, x, y, ang)
        segs = [getattr(track, f)[:, None, None, :] for f in ("seg_sx", "seg_sy", "seg_vx",
                                                              "seg_vy", "seg_c")]
        out[f"k1 canonical {a} car"] = digest(geo.raycast_walls(
            *rays, *segs[:4], cfg.max_sensor_range, seg_c=segs[4]))
        cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
        wp = [getattr(track, f)[:, None, :] for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")]
        out[f"k2 canonical {a} car"] = digest(*geo.progress_and_collision(
            x, y, cx, cy, *wp, track.n_wp[:, None], track.track_width[:, None]))
    rows = 300
    for s in (1, 33, 864, 1023, 1024):
        for rays_per_row in (1, 11, 22, 40):
            for offset in (0, 1):
                fields = [f32(rng, (rows * s + offset,), lo, hi, dev)[offset:].view(rows, 1, s)
                          for lo, hi in ((-40, 40), (-40, 40), (-15, 15), (-15, 15))]
                ang = f32(rng, (rows, rays_per_row), 0, 2 * np.pi, dev)
                o = [f32(rng, (rows, 1), -20, 20, dev).expand(rows, rays_per_row)
                     for _ in range(2)]
                res = geo.raycast_walls(o[0], o[1], torch.cos(ang), torch.sin(ang), *fields,
                                        50.0)
                out[f"k1 S={s} rays={rays_per_row} offset={offset}"] = digest(res)
    for w in (1, 33, 600):
        for cars in (1, 2, 8):
            for offset in (0, 3):
                wpx, wpy = (f32(rng, (rows * w + offset,), -30, 30, dev)[offset:].view(rows, 1, w)
                            for _ in range(2))
                nang = f32(rng, (rows * w + offset,), 0, 2 * np.pi, dev)[offset:].view(rows, 1, w)
                x, y = (f32(rng, (rows, cars), -30, 30, dev) for _ in range(2))
                cx, cy = geo.car_corners(x, y, f32(rng, (rows, cars), 0, 6.3, dev), 2.0, 1.0)
                n_wp = torch.full((rows, 1), max(w - 1, 1), dtype=torch.int32, device=dev)
                width = torch.full((rows, 1), 7.0, device=dev)
                res = geo.progress_and_collision(x, y, cx, cy, wpx, wpy, torch.cos(nang),
                                                 torch.sin(nang), n_wp, width)
                out[f"k2 W={w} cars={cars} offset={offset}"] = digest(*res)
    for a in (1, 2, 8):
        x, y, ang = chip_smoke.race_poses(track, rng, dev, a)
        cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
        rays = chip_smoke.car_rays(cfg, x, y, ang)
        out[f"k3 canonical {a} car"] = digest(geo.raycast_cars(
            *rays, cx[:, None, None], cy[:, None, None], x[:, None, None, :].contiguous(),
            y[:, None, None, :].contiguous(), cfg.max_sensor_range))
        shape = (chip_smoke.NUM_ENVS, a)
        state = (x, y, ang, f32(rng, shape, -35, 35, dev), f32(rng, shape, -35, 35, dev),
                 torch.as_tensor(rng.random(shape) < 0.1, device=dev),
                 f32(rng, shape, -1, 1, dev), f32(rng, shape, 0, 1, dev))
        out[f"k5 {a} car"] = digest(*dynamics.car_update(*state, cfg.dt, cfg.car))
    out.update(env_digests(track, rng, dev))
    print(json.dumps({"card": chip_smoke.card_line(), "digests": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

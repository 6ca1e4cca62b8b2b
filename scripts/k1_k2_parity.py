#!/usr/bin/env python3
"""A digest of K1's and K2's outputs on seeded inputs, to compare two builds.

  python scripts/k1_k2_parity.py

Runs ``raycast_walls`` and ``progress_and_collision`` through their public
wrappers on the card at chip_smoke.py's shapes (the canonical 16-track pool
gathered to 4096 envs, single car and two cars per env) and on synthetic rows of
other lengths (segments 1, 33, 864, 1023 and 1024, waypoints 1, 33 and 600, some
cut at an offset so that no row starts 16-byte-aligned), and prints one JSON
object: the card, and per case the sha256 of the output bytes. Two checkouts whose
kernels are bitwise equal print the same digests; run it in both, in one chip
call, to hold a new kernel to an old one on every case at once.
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
from self_play_racing_tpu_torch.envs import multi as menv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.ops import geometry as geo  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def f32(rng, shape, lo, hi, dev):
    return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=dev)


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
    print(json.dumps({"card": chip_smoke.card_line(), "digests": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Whether shared-memory bank conflicts set K1's time, on the card.

  python scripts/k1_bank_conflicts.py [--rows 4096] [--sass DIR]

Times the ``raycast_walls`` kernel of the checkout it lives in (built from
``csrc/`` as the package builds it) on synthetic segment rows at S = 864 and
S = 896 padded segments (and at S = 1024, where L = 32 puts every lane of a
run-major read on one bank), with 11 and 22 rays per row, each in a CUDA graph of
20 launches (median of 21 replays, CUDA events). A kernel in which lane j folds the
run [j*L, (j+1)*L) with L = ceil(S/32) reads shared memory with a stride of L
words: L = 27 (S = 864) is odd and conflict-free, L = 28 (S = 896) puts the 32
lanes on 8 banks, a 4-way conflict on every read. If conflicts set the time, the
per-pair time at S = 864 is well under that at S = 896; a kernel whose layout has
no conflicts takes about the same time per pair at both.

Prints one JSON object with the card's name and power limit and, per shape, the
graph time in microseconds and the time per ray-segment pair in picoseconds.
With ``--sass DIR`` it also writes the SASS (``cuobjdump -sass``) of K1 and K2 to
``DIR/raycast_walls.sass`` and ``DIR/progress_collision.sass``, to count the
instructions of their inner loops.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch.ops import _cuda  # noqa: E402


def synthetic_rows(rng, rows, segs, dev):
    """Random segments in a 80 m square, the last 7 of each row zero-direction
    padding; the kernel forms seg_c itself."""
    def f(lo, hi):
        return torch.as_tensor(rng.uniform(lo, hi, (rows, segs)), dtype=torch.float32, device=dev)
    sx, sy, vx, vy = f(-40, 40), f(-40, 40), f(-15, 15), f(-15, 15)
    for t in (sx, sy, vx, vy):
        t[:, -7:] = 0.0
    return sx, sy, vx, vy


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--sass", default=None, help="directory to write the kernel's SASS to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_bank_conflicts: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _cuda.build()
    rng = np.random.default_rng(0)
    results = []
    for segs in (864, 896, 1024):
        sx, sy, vx, vy = synthetic_rows(rng, args.rows, segs, dev)
        for rays in (11, 22):
            shape = (args.rows, rays)
            def f(lo, hi):
                return torch.as_tensor(rng.uniform(lo, hi, shape), dtype=torch.float32, device=dev)
            ang = f(0, 2 * np.pi)
            ox, oy = f(-20, 20), f(-20, 20)
            dx, dy = torch.cos(ang), torch.sin(ang)
            out = torch.empty(shape, dtype=torch.float32, device=dev)
            launch = lambda: _cuda.launch_raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, None,
                                                        out, args.rows, rays, segs, 50.0)
            us = chip_smoke.graph_ms(launch) * 1e3
            pairs = args.rows * rays * segs
            results.append({"segments": segs, "run_length": -(-segs // 32),
                            "rays_per_row": rays, "rows": args.rows, "graph_us": us,
                            "ps_per_pair": us * 1e6 / pairs})
    if args.sass:
        os.makedirs(args.sass, exist_ok=True)
        cuobjdump = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
        for source in ("raycast_walls.cu", "progress_collision.cu"):
            lib = _cuda._target(_cuda.CSRC_DIR / source)
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                                  text=True, timeout=120).stdout
            with open(os.path.join(args.sass, source.replace(".cu", ".sass")), "w") as fh:
                fh.write(sass)
    print(json.dumps({"card": chip_smoke.card_line(), "device": torch.cuda.get_device_name(0),
                      "build": _cuda.build_report.get("raycast_walls", ""),
                      "k1": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

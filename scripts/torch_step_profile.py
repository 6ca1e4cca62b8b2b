#!/usr/bin/env python3
"""Where one env-step of the PyTorch port's main path spends its time, on the card.

  python scripts/torch_step_profile.py [--steps 32] [--num-envs 4096]

Runs chip_smoke.py's main path (``models/single_agent.npz``, canonical 16-track
pool gathered to ``--num-envs`` envs, ``sample_action`` + ``vector.step``) under
``torch.profiler`` for ``--steps`` steps after a warm-up, and prints one JSON
object: host wall time per step, device busy time per step (the sum of kernel
durations in a second, profiled run; kernels of one stream do not overlap), the
device's idle share against the unprofiled wall time, kernel launches per step,
and the kernels that take the most device time. Needs a CUDA
card; prints the card's name and power limit with the numbers.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from self_play_racing_tpu_torch import interop  # noqa: E402
from self_play_racing_tpu_torch.envs import single as senv  # noqa: E402
from self_play_racing_tpu_torch.envs import track as trk  # noqa: E402
from self_play_racing_tpu_torch.envs import vector  # noqa: E402
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool  # noqa: E402


@torch.no_grad()
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=32)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    cfg = senv.RacingConfig(num_sensors=11)
    pool = canonical_bench_pool(16, device=dev)
    track = trk.gather_tracks(pool, np.arange(args.num_envs) % 16)
    model, _ = interop.load_npz(chip_smoke.MODEL, device=dev)
    params, log_std = model.params(), model.log_std
    gen = torch.Generator(device=dev).manual_seed(0)
    state, obs = senv.reset(cfg, track)
    vstate = vector.init(state, args.num_envs)
    vstate, obs, *_ = chip_smoke.rollout(params, log_std, cfg, track, vstate, obs, gen, 16)
    torch.cuda.synchronize()
    # host wall time without the profiler, whose CPU-side recording slows the host
    t0 = time.perf_counter()
    vstate, obs, *_ = chip_smoke.rollout(params, log_std, cfg, track, vstate, obs, gen,
                                         args.steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        chip_smoke.rollout(params, log_std, cfg, track, vstate, obs, gen, args.steps)
        torch.cuda.synchronize()

    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            per_kernel[evt.name][0] += evt.time_range.elapsed_us()
            per_kernel[evt.name][1] += 1
    busy_us = sum(t for t, _ in per_kernel.values())
    launches = sum(n for _, n in per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[: args.top]
    steps = args.steps
    out = {
        "card": chip_smoke.card_line(),
        "num_envs": args.num_envs,
        "steps": steps,
        "wall_ms_per_step": wall * 1e3 / steps,
        "env_steps_per_s": args.num_envs * steps / wall,
        "device_busy_ms_per_step": busy_us / 1e3 / steps,
        "device_idle_share": (1.0 - busy_us / 1e6 / wall) if busy_us else None,
        "kernel_launches_per_step": launches / steps,
        "top_kernels": [{"name": name[:90], "ms_per_step": t / 1e3 / steps,
                         "launches_per_step": n / steps} for name, (t, n) in top],
    }
    if not busy_us:
        print("torch_step_profile: the profiler saw no device time", file=sys.stderr)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``self_play_racing_tpu_torch``).

  python3 chip_smoke.py

Needs one CUDA card (it exits non-zero and prints no result without one) and the
CUDA toolkit's ``nvcc``: it builds the hand-written kernels from ``csrc/`` first.
Phases, each of which fails the run on error:

1. the card (name, power limit) and the kernels' build;
2. K1 ``raycast_walls`` against its plain PyTorch version at the main path's shapes
   (canonical 16-track pool gathered to 4096 envs, 11 rays, 896 segments), plus the
   all-miss/padding case: hit/no-hit identical, distances bitwise equal except
   near-ties within 2 ulp; kernel time (CUDA events), bound and plain time;
3. K2 ``progress_and_collision`` against its plain version at [4096, 5, 512]:
   index, progress and crashed equal; the same timings;
4. the main path: ``models/single_agent.npz`` driving 4096 envs for 256 steps of
   sample_action + vector.step, with launch counters zeroed before and read after
   (each kernel must have launched once per step, plus K1 once for the reset);
5. evaluation on the 40 x 5 grid (sampled, seed 42): success_rate >= 0.95;
6. serving latency and throughput at batches 1, 64, 1024, 8192.

The line before the last is one JSON object with every kernel's numbers; the last
line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.envs import single as senv
from self_play_racing_tpu_torch.envs import track as trk
from self_play_racing_tpu_torch.envs import vector
from self_play_racing_tpu_torch.evaluate import evaluate_single_agent_overall
from self_play_racing_tpu_torch.models import actor_critic as net
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import geometry as geo
from self_play_racing_tpu_torch.serve import Policy, bench
from self_play_racing_tpu_torch.utils import metrics
from self_play_racing_tpu_torch.utils.profiling import canonical_bench_pool

MODEL = "models/single_agent.npz"
NUM_ENVS = 4096
NUM_TRACKS = 16
STEPS = 256
# Published H100 SXM peaks: HBM bandwidth and f32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# f32 operations per ray-segment pair in K1: cn 4, dotp 3, sn 4, |dotp| 1, hit test
# 7 (2 products, 4 compares, |sn|), |cn| + select 2, the ratio compare 5
K1_OPS_PER_PAIR = 26
# per query-waypoint pair in K2: dx, dy 2, d^2 3, compare 1, projection 3, selects 2
K2_OPS_PER_PAIR = 11
SUCCESS_FLOOR = 0.95


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def per_launch_ms(fn, windows=21, launches=10) -> float:
    """Median over ``windows`` of the per-launch time of ``launches`` back-to-back
    calls, from CUDA events, after a warm-up. Back-to-back launches keep the host's
    launch overhead out of the window once the queue is ahead of the card."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def bound_ms(nbytes: int, ops: int):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def car_poses(track, rng, dev):
    """Cars near random centreline waypoints with random headings."""
    n = track.wp_x.shape[0]
    n_wp = track.n_wp.cpu().numpy()
    i = torch.as_tensor(rng.integers(0, n_wp), device=dev)
    rows = torch.arange(n, device=dev)
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)
    x = track.wp_x[rows, i] + f32(rng.uniform(-8, 8, n))
    y = track.wp_y[rows, i] + f32(rng.uniform(-8, 8, n))
    return x.contiguous(), y.contiguous(), f32(rng.uniform(0, 2 * np.pi, n))


def check_k1(track, cfg, rng, dev):
    x, y, ang = car_poses(track, rng, dev)
    world = ang[:, None] + torch.as_tensor(cfg.sensor_angles(), dtype=torch.float32, device=dev)
    rays = [x[:, None].expand(world.shape).contiguous(),
            y[:, None].expand(world.shape).contiguous(), torch.cos(world), torch.sin(world)]
    segs = [getattr(track, f)[:, None, :] for f in ("seg_sx", "seg_sy", "seg_vx", "seg_vy")]
    seg_c = track.seg_c[:, None, :]
    max_dist = cfg.max_sensor_range
    k = geo.raycast_walls(*rays, *segs, max_dist, seg_c=seg_c)
    p = geo.raycast_walls_plain(*rays, *segs, max_dist, seg_c=seg_c)
    torch.cuda.synchronize()
    differ = k != p
    n_differ = int(differ.sum())
    if not torch.equal(k == max_dist, p == max_dist):
        raise AssertionError("K1: hit/no-hit differs from the plain version")
    ulp = torch.nextafter(p.abs(), torch.full_like(p, float("inf"))) - p.abs()
    if bool(((k - p).abs() > 2 * ulp).any()):
        raise AssertionError("K1: a ray differs from the plain version by more than 2 ulp")
    max_err = float((k - p).abs().max())
    print(f"K1 raycast_walls [{NUM_ENVS}, {world.shape[1]}] x {segs[0].shape[-1]} segments: "
          f"{n_differ} non-identical rays (near-ties within 2 ulp), max |err| {max_err:g}, "
          f"{float((k < max_dist).float().mean()):.3f} of rays hit")
    if n_differ:
        print(f"K1 near-tie rays: kernel {k[differ][:8].tolist()} plain {p[differ][:8].tolist()}")

    # all-miss rays and zero-direction padding give max_dist exactly; a hit among
    # padding still wins; the kernel forms seg_c itself when it is not given
    sx = torch.tensor([-5.0, -3.0, -8.0, 0, 0, 0, 0], device=dev)
    sy = torch.tensor([-2.0, 1.0, 4.0, 0, 0, 0, 0], device=dev)
    vx = torch.tensor([0.0, 1.5, 2.0, 0, 0, 0, 0], device=dev)
    vy = torch.tensor([3.0, 0.5, -1.0, 0, 0, 0, 0], device=dev)
    ox = torch.tensor([1.0, 1.0, 1.0, -4.0], device=dev)
    oy = torch.tensor([0.0, 2.5, -4.0, 0.0], device=dev)
    dx = torch.tensor([1.0, 1.0, 1.0, -1.0], device=dev)
    dy = torch.zeros(4, device=dev)
    small_k = geo.raycast_walls(ox, oy, dx, dy, sx, sy, vx, vy, 50.0)
    small_p = geo.raycast_walls_plain(ox, oy, dx, dy, sx, sy, vx, vy, 50.0)
    if not (torch.equal(small_k, small_p) and small_k[:3].eq(50.0).all()
            and abs(float(small_k[3]) - 1.0) < 1e-6):
        raise AssertionError(f"K1 padding/all-miss case: {small_k.tolist()} vs {small_p.tolist()}")
    print(f"K1 all-miss/padding case: {small_k.tolist()} (kernel == plain)")

    out = torch.empty_like(k)
    rows, r, s = NUM_ENVS, world.shape[1], segs[0].shape[-1]
    ms = per_launch_ms(lambda: _cuda.launch_raycast_walls(
        *rays, *segs, seg_c, out, rows, r, s, max_dist))
    plain_ms = per_launch_ms(lambda: geo.raycast_walls_plain(*rays, *segs, max_dist, seg_c=seg_c),
                             windows=3, launches=2)
    b_ms, b_by = bound_ms(nbytes(*rays, *segs, seg_c, out), rows * r * s * K1_OPS_PER_PAIR)
    print(f"K1 time {ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), "
          f"plain {plain_ms * 1e3:.1f} us")
    return {"name": "raycast_walls", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/raycast_walls.cu",
            "replaces": "self_play_racing_tpu/ops/geometry.py:26",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def check_k2(track, cfg, rng, dev):
    x, y, ang = car_poses(track, rng, dev)
    cx, cy = geo.car_corners(x, y, ang, cfg.car.length / 2, cfg.car.width / 2)
    args = (x, y, cx, cy, track.wp_x, track.wp_y, track.nrm_x, track.nrm_y,
            track.n_wp, track.track_width)
    kp, kc = geo.progress_and_collision(*args)
    pp, pc = geo.progress_and_collision_plain(*args)
    torch.cuda.synchronize()
    if not (torch.equal(kp, pp) and torch.equal(kc, pc)):
        raise AssertionError(f"K2: {int((kp != pp).sum())} progress and "
                             f"{int((kc != pc).sum())} crashed values differ from plain")
    max_err = float((kp - pp).abs().max())
    print(f"K2 progress_and_collision [{NUM_ENVS}, {1 + cx.shape[-1]}, {track.wp_x.shape[-1]}]: "
          f"progress and crashed equal to plain ({int(kc.sum())} crashed)")
    progress = torch.empty_like(kp)
    crashed = torch.empty_like(kc)
    w = track.wp_x.shape[-1]
    ms = per_launch_ms(lambda: _cuda.launch_progress_and_collision(
        *args, progress, crashed, NUM_ENVS, cx.shape[-1], w))
    plain_ms = per_launch_ms(lambda: geo.progress_and_collision_plain(*args), windows=3, launches=5)
    b_ms, b_by = bound_ms(nbytes(x, y, cx, cy, track.wp_x, track.wp_y, track.nrm_x, track.nrm_y,
                                 track.n_wp, track.track_width, progress, crashed),
                          NUM_ENVS * (1 + cx.shape[-1]) * w * K2_OPS_PER_PAIR)
    print(f"K2 time {ms * 1e3:.1f} us, bound {b_ms * 1e3:.1f} us ({b_by}), "
          f"plain {plain_ms * 1e3:.1f} us")
    return {"name": "progress_and_collision", "route": "cuda",
            "source": "self_play_racing_tpu_torch/csrc/progress_collision.cu",
            "replaces": "self_play_racing_tpu/ops/geometry.py:176",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None}


def rollout(params, log_std, cfg, track, vstate, obs, gen, steps):
    """The bench loop: sample_action + vector.step with NEXT_STEP autoreset.
    Returns the final (vstate, obs), a device flag that every obs and reward was
    finite, and the device count of episodes that ended."""
    finite = torch.ones((), dtype=torch.bool, device=obs.device)
    ended = torch.zeros((), dtype=torch.int64, device=obs.device)
    for _ in range(steps):
        noise = net.sample_noise((obs.shape[0], cfg.action_dim), gen, device=obs.device)
        action, _, _ = net.sample_action(params, log_std, obs, noise)
        vstate, obs, reward, done, *_ = vector.step(
            vstate, action,
            lambda s, a, g: senv.transition(cfg, track, s, a),
            lambda s: senv.observe(cfg, track, s),
            lambda g: senv.reset_state(cfg, track),
            info_fn=lambda s: senv.info_from_state(cfg, track, s))
        finite &= torch.isfinite(obs).all() & torch.isfinite(reward).all()
        ended += done.sum()
    return vstate, obs, finite, ended


@torch.no_grad()
def main_path(track, cfg, dev, card):
    model, _ = interop.load_npz(MODEL, device=dev)
    params, log_std = model.params(), model.log_std
    gen = torch.Generator(device=dev).manual_seed(0)

    # warm-up on its own state: cuBLAS handles, allocator
    state, obs = senv.reset(cfg, track)
    rollout(params, log_std, cfg, track, vector.init(state, NUM_ENVS), obs, gen, 8)
    torch.cuda.synchronize()

    geo.raycast_walls_launches = 0
    geo.progress_and_collision_launches = 0
    t0 = time.perf_counter()
    state, obs = senv.reset(cfg, track)
    vstate, obs, finite, ended = rollout(params, log_std, cfg, track,
                                         vector.init(state, NUM_ENVS), obs, gen, STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"raycast_walls": geo.raycast_walls_launches,
                "progress_and_collision": geo.progress_and_collision_launches}
    expected = {"raycast_walls": STEPS + 1, "progress_and_collision": STEPS}
    print(f"main path: {NUM_ENVS} envs x {STEPS} steps in {dt:.3f} s = "
          f"{NUM_ENVS * STEPS / dt:,.0f} env-steps/s on {card}; launches {launches}")
    if launches != expected:
        raise AssertionError(f"main path launches {launches}, expected {expected}")
    if not bool(finite) or obs.shape != (NUM_ENVS, cfg.obs_dim):
        raise AssertionError("main path: non-finite obs or reward, or wrong obs shape")
    print(f"main path: obs {tuple(obs.shape)} and rewards finite; {int(ended)} episodes "
          f"ended in the run")
    return launches


def evaluation(dev):
    t0 = time.perf_counter()
    grid = metrics.build_eval_grid(40, 5, seed=42, device=dev)
    res = evaluate_single_agent_overall(grid, MODEL, seed=42)
    print(f"eval 40 x 5 (sampled, seed 42): success_rate={res['success_rate']:.3f} "
          f"crash_rate={res['crash_rate']:.3f} avg_steps={res['avg_steps']:.2f} "
          f"avg_speed={res['avg_speed']:.3f} ({time.perf_counter() - t0:.1f} s)")
    if res["success_rate"] < SUCCESS_FLOOR:
        raise AssertionError(f"eval success_rate {res['success_rate']} < {SUCCESS_FLOOR}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    _cuda.build()
    print(f"kernels built in {_cuda.build_seconds:.1f} s")
    for name, report in _cuda.build_report.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line or report == "cached":
                print(f"  {name}: {line.strip()}")

    rng = np.random.default_rng(0)
    cfg = senv.RacingConfig(num_sensors=11)
    pool = canonical_bench_pool(NUM_TRACKS, device=dev)
    track = trk.gather_tracks(pool, np.arange(NUM_ENVS) % NUM_TRACKS)
    if (track.wp_x.shape[-1], track.seg_sx.shape[-1]) != (512, 896):
        raise AssertionError("canonical pool is not W=512, S=896")
    kernels = [check_k1(track, cfg, rng, dev), check_k2(track, cfg, rng, dev)]
    launches = main_path(track, cfg, dev, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    evaluation(dev)
    bench(Policy(MODEL, device=dev))
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

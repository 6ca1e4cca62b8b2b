"""Model -> race-video rendering CLI (port of ``self_play_racing_tpu/render.py``).

  python -m self_play_racing_tpu_torch.render --multi models/self_play_agent.npz \\
      --out static/self_play_race.mp4 --track-seed 123
  python -m self_play_racing_tpu_torch.render --grid static/racing_grid.mp4 \\
      --multi a.npz --multi b.npz --single c.npz        # labeled 2-column grid
  python -m self_play_racing_tpu_torch.render --vs a.npz b.npz   # one policy per car

Trajectories are recorded on the card (``utils/viz.record_trajectory_*``; on
``cuda`` unless ``--device`` names another device) and rendered in an offline
host pass (pygame frames, an OpenCV mp4).
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ._device import resolve_device
from .envs import multi as menv
from .envs import single as senv
from .envs import track as trk
from .evaluate import load_policy_bundle
from .utils import viz


def _held_out_track(track_seed: int, width: float = 7.0, device=None):
    """One track outside the training pool stream (a fresh seed), as (its float64
    geometry dict, a batch-1 track on ``device``).

    ``gen_random_track(seed=...)`` reseeds the global NumPy RNG (a quirk of the
    original generator, kept for parity), so the RNG's state is saved and restored
    around it: rendering mid-script leaves the caller's stream where it was."""
    rng_state = np.random.get_state()
    try:
        cps = trk.gen_random_track(12, 60, 15, 0.4, 0.5, seed=track_seed)
    finally:
        np.random.set_state(rng_state)
    geometry = trk.build_track_geometry(cps, width)
    pool = trk.make_track_pool([cps], [width], device=resolve_device(device))
    return geometry, trk.gather_tracks(pool, [0])


def render_model(kind: str, model_path: str, out_path: str, track_seed: int = 123,
                 width: float = 7.0, max_steps: int = 3000, deterministic: bool = True,
                 label: str | None = None, frame_skip: int = 1, seed: int = 0,
                 num_agents: int = 2, device=None):
    """Record one episode of ``model_path`` on a held-out track and write an mp4.
    Random draws come from a generator seeded ``seed`` on ``device``. Returns the
    recorded trajectory dict."""
    dev = resolve_device(device)
    params, log_std, obs_norm = load_policy_bundle(model_path, dev)
    geometry, track = _held_out_track(track_seed, width, dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    if kind == "single":
        env_cfg = senv.RacingConfig(num_sensors=11)
        traj = viz.record_trajectory_single(params, log_std, env_cfg, track, generator,
                                            max_steps=max_steps,
                                            deterministic=deterministic,
                                            obs_norm=obs_norm)
    else:
        env_cfg = menv.MultiRacingConfig(num_agents=num_agents, num_sensors=11)
        traj = viz.record_trajectory_multi(params, log_std, env_cfg, track, generator,
                                           max_steps=max_steps,
                                           deterministic=deterministic,
                                           obs_norm=obs_norm)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    label = label or os.path.splitext(os.path.basename(model_path))[0]
    frames = viz.render_video(geometry, traj, out_path, label=label,
                              frame_skip=frame_skip)
    steps = len(traj["x"])
    prog = np.asarray(traj["progress"])[-1]
    prog0 = float(np.atleast_1d(prog).reshape(-1)[0])
    print(f"{label}: {steps} steps, final progress {prog0*100:.1f}%, "
          f"{frames} frames -> {out_path}")
    return traj


def render_match(model_paths, out_path, track_seed: int = 123, width: float = 7.0,
                 max_steps: int = 3000, deterministic: bool = True,
                 frame_skip: int = 1, seed: int = 0, device=None):
    """Head-to-head race video: one policy per car (a tournament match). Any
    number of models; their observation width must match the seat count they
    were trained at."""
    dev = resolve_device(device)
    bundles = [load_policy_bundle(m, dev) for m in model_paths]
    env_cfg = menv.MultiRacingConfig(num_agents=len(model_paths), num_sensors=11)
    geometry, track = _held_out_track(track_seed, width, dev)
    traj = viz.record_trajectory_match(bundles, env_cfg, track,
                                       torch.Generator(device=dev).manual_seed(seed),
                                       max_steps=max_steps,
                                       deterministic=deterministic)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    names = [os.path.splitext(os.path.basename(m))[0] for m in model_paths]
    label = " vs ".join(names)
    frames = viz.render_video(geometry, traj, out_path, label=label,
                              frame_skip=frame_skip)
    prog = np.asarray(traj["progress"])[-1].reshape(-1)
    summary = ", ".join(f"{n}: {p*100:.1f}%" for n, p in zip(names, prog))
    print(f"match ({label}): {len(traj['x'])} steps, final progress {summary}, "
          f"{frames} frames -> {out_path}")
    return traj


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--single", action="append", default=[],
                   help="single-agent policy path (.npz or .pth)")
    p.add_argument("--multi", action="append", default=[],
                   help="self-play/multi policy path (.npz or .pth)")
    p.add_argument("--vs", nargs="+", default=None, metavar="MODEL",
                   help="head-to-head match: one policy PER CAR (2+ models), "
                        "rendered as a single race video")
    p.add_argument("--out", default=None,
                   help="output mp4 (single model) — default static/<model>_race.mp4")
    p.add_argument("--grid", default=None,
                   help="also compose all rendered videos into this labeled grid mp4")
    p.add_argument("--track-seed", type=int, default=123)
    p.add_argument("--track-width", type=float, default=7.0)
    p.add_argument("--max-steps", type=int, default=3000)
    p.add_argument("--frame-skip", type=int, default=1)
    p.add_argument("--agents", type=int, default=2,
                   help="cars per race for --multi models (policy must have been "
                        "trained at this agent count: obs width depends on it)")
    p.add_argument("--sample", action="store_true",
                   help="sample actions instead of greedy mu")
    p.add_argument("--device", default=None, help="where to record: default cuda")
    args = p.parse_args(argv)

    if args.vs:
        if len(args.vs) < 2:
            raise SystemExit("--vs needs at least 2 models")
        render_match(args.vs, args.out or "static/match_race.mp4",
                     args.track_seed, args.track_width, args.max_steps,
                     deterministic=not args.sample, frame_skip=args.frame_skip,
                     device=args.device)
        return

    jobs = [("single", m) for m in args.single] + [("multi", m) for m in args.multi]
    if not jobs:
        raise SystemExit("pass at least one --single/--multi/--vs model path")
    if args.out and len(jobs) > 1:
        raise SystemExit("--out only applies to a single model; use --grid for many")

    paths, labels = [], []
    for kind, model in jobs:
        label = os.path.splitext(os.path.basename(model))[0]
        out = args.out or f"static/{label}_race.mp4"
        render_model(kind, model, out, args.track_seed, args.track_width,
                     args.max_steps, deterministic=not args.sample, label=label,
                     frame_skip=args.frame_skip, num_agents=args.agents,
                     device=args.device)
        paths.append(out)
        labels.append(label)
    if args.grid and len(paths) >= 2:
        os.makedirs(os.path.dirname(args.grid) or ".", exist_ok=True)
        viz.visualization_grid(paths, labels, args.grid)
        print(f"grid -> {args.grid}")


if __name__ == "__main__":
    main()

"""Evaluation entry point (port of the single-car half of
``self_play_racing_tpu/evaluate.py``).

Runs the evaluation grid (40 tracks x 5 runs, seed 42, widths drawn by run) as one
batched rollout on the card and prints the aggregate. Accepts the repo's ``.npz``
policies and ``.pth`` state dicts of the original torch implementation.

  python -m self_play_racing_tpu_torch.evaluate --single models/single_agent.npz

Multi-car, SB3 and procgen evaluation come with later parts of the port.
"""
from __future__ import annotations

import argparse

import torch

from . import interop
from ._device import resolve_device
from .envs import single as senv
from .models import actor_critic as net
from .utils import metrics as M


def load_policy_bundle(path, device=None, dtype=torch.float32):
    """(params, log_std, obs_norm_or_None). ``obs_norm`` is the running observation
    normalizer saved with policies trained under observation normalization;
    consumers must apply it before the policy."""
    dev = resolve_device(device)
    if path.endswith(".pth") or path.endswith(".pt"):
        params, log_std = net.params_from_torch_state_dict(path, dtype=dtype, device=dev)
        return params, log_std, None
    model, obs_norm = interop.load_npz(path, dtype=dtype, device=dev)
    return model.params(), model.log_std, obs_norm


def evaluate_single_agent_overall(grid, model_path, seed=42, deterministic=False):
    """One batched rollout over the whole grid (from ``metrics.build_eval_grid``,
    on the device it was built on). Sampled actions draw from a generator seeded
    with ``seed`` on that device."""
    track, _, _ = grid
    dev = track.wp_x.device
    params, log_std, obs_norm = load_policy_bundle(model_path, dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    eps = M.rollout_single(params, log_std, senv.RacingConfig(num_sensors=11), track,
                           generator, max_steps=2000, deterministic=deterministic,
                           obs_norm=obs_norm)
    eps = {k: v.cpu().numpy() for k, v in eps.items()}
    results = M.aggregate(eps)
    results["all_episodes"] = [
        {k: (float(v[i]) if v.dtype.kind == "f" else
             (bool(v[i]) if v.dtype.kind == "b" else int(v[i])))
         for k, v in eps.items()}
        for i in range(len(eps["steps"]))
    ]
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--single", action="append", default=[],
                   help="path to a single-car policy (.npz or .pth)")
    for flag in ("--multi", "--sb3"):
        p.add_argument(flag, action="append", default=[], help=argparse.SUPPRESS)
    p.add_argument("--procgen", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--num-tracks", type=int, default=40)
    p.add_argument("--num-runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    later = [f for f, v in (("--multi", args.multi), ("--sb3", args.sb3),
                            ("--procgen", args.procgen)) if v]
    if later:
        raise SystemExit(f"{', '.join(later)}: not ported yet; this port evaluates "
                         "--single policies only")
    if not args.single:
        raise SystemExit("pass at least one --single model path")
    dev = resolve_device(args.device)
    grid = M.build_eval_grid(args.num_tracks, args.num_runs, args.seed, device=dev)
    by_path = {}
    for path in args.single:
        results = evaluate_single_agent_overall(grid, path, seed=args.seed,
                                                deterministic=args.deterministic)
        by_path[path] = results
        print(f"{path}: success_rate={results['success_rate']:.3f} "
              f"crash_rate={results['crash_rate']:.3f} "
              f"avg_speed={results['avg_speed']:.2f} "
              f"avg_steps={results['avg_steps']:.2f}")
    return by_path


if __name__ == "__main__":
    main()

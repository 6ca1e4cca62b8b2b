"""Evaluation entry point (port of ``self_play_racing_tpu/evaluate.py``).

Runs the evaluation grid (40 tracks x 5 runs, seed 42, widths drawn by run) as one
batched rollout on the card and prints the aggregate. Accepts the repo's ``.npz``
policies and ``.pth`` state dicts of the original torch implementation. A
``--multi`` policy drives both cars of a 2-car race (one shared policy); the
episode's numbers are the first finished car's.

  python -m self_play_racing_tpu_torch.evaluate --single models/single_agent.npz
  python -m self_play_racing_tpu_torch.evaluate --multi models/self_play_agent.npz

SB3 and procgen evaluation and the comparison chart come with a later part of the
port.
"""
from __future__ import annotations

import argparse

import torch

from . import interop
from ._device import resolve_device
from .envs import multi as menv
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


def _evaluate_overall(grid, model_path, env_cfg, rollout, max_steps, seed,
                      deterministic):
    """One batched rollout over the whole grid (from ``metrics.build_eval_grid``,
    on the device it was built on). Random draws come from a generator seeded with
    ``seed`` on that device."""
    track, _, _ = grid
    dev = track.wp_x.device
    params, log_std, obs_norm = load_policy_bundle(model_path, dev)
    generator = torch.Generator(device=dev).manual_seed(seed)
    eps = rollout(params, log_std, env_cfg, track, generator, max_steps=max_steps,
                  deterministic=deterministic, obs_norm=obs_norm)
    eps = {k: v.cpu().numpy() for k, v in eps.items()}
    results = M.aggregate(eps)
    results["all_episodes"] = [
        {k: (float(v[i]) if v.dtype.kind == "f" else
             (bool(v[i]) if v.dtype.kind == "b" else int(v[i])))
         for k, v in eps.items()}
        for i in range(len(eps["steps"]))
    ]
    return results


def evaluate_single_agent_overall(grid, model_path, seed=42, deterministic=False):
    """The single-car policy over the grid, 2000 steps at most."""
    return _evaluate_overall(grid, model_path, senv.RacingConfig(num_sensors=11),
                             M.rollout_single, 2000, seed, deterministic)


def evaluate_multi_agent_overall(grid, model_path, seed=42, deterministic=False,
                                 num_agents=2):
    """A shared policy driving all ``num_agents`` cars of each race (it must have
    been trained at that count: the observation width depends on it), 3000 steps
    at most."""
    return _evaluate_overall(grid, model_path,
                             menv.MultiRacingConfig(num_agents=num_agents, num_sensors=11),
                             M.rollout_multi, 3000, seed, deterministic)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--single", action="append", default=[],
                   help="path to a single-car policy (.npz or .pth)")
    p.add_argument("--multi", action="append", default=[],
                   help="path to a self-play/multi-car policy (.npz or .pth)")
    p.add_argument("--sb3", action="append", default=[], help=argparse.SUPPRESS)
    p.add_argument("--procgen", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--num-tracks", type=int, default=40)
    p.add_argument("--num-runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    later = [f for f, v in (("--sb3", args.sb3), ("--procgen", args.procgen)) if v]
    if later:
        raise SystemExit(f"{', '.join(later)}: not ported yet; it comes with slice 4 "
                         "of the port (this port evaluates --single and --multi)")
    if not (args.single or args.multi):
        raise SystemExit("pass at least one --single or --multi model path")
    dev = resolve_device(args.device)
    grid = M.build_eval_grid(args.num_tracks, args.num_runs, args.seed, device=dev)
    by_path = {}
    runs = ([(p, evaluate_single_agent_overall) for p in args.single]
            + [(p, evaluate_multi_agent_overall) for p in args.multi])
    for path, fn in runs:
        results = fn(grid, path, seed=args.seed, deterministic=args.deterministic)
        by_path[path] = results
        print(f"{path}: success_rate={results['success_rate']:.3f} "
              f"crash_rate={results['crash_rate']:.3f} "
              f"avg_speed={results['avg_speed']:.2f} "
              f"avg_steps={results['avg_steps']:.2f}")
    return by_path


if __name__ == "__main__":
    main()

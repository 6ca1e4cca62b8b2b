"""Training entry point (port of ``self_play_racing_tpu/train.py``, mode ``single``).

  python -m self_play_racing_tpu_torch.train single                # on cuda
  python -m self_play_racing_tpu_torch.train single --device cpu

Trains single-car PPO at the reference config (16 envs x 2048 steps, 5M steps) and
writes ``models/single_agent.npz`` and ``data/training_info_single.json`` under the
working directory, as the JAX package's CLI does. The track pool follows the
reference's seed and stream conventions: ``gen_tracks(num_envs, seed)``, then
per-env widths ``randint[6, 10)`` from the global NumPy RNG, identity track
assignment. The other modes (``multi``, ``scale``, ``sb3``, ``all``) come with
later parts of the port and exit with a message.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from ._device import resolve_device
from .agent.trainer import PPOTrainer
from .configs import base_config
from .envs import single as senv
from .envs import track as trk

_LATER = {
    "multi": "self-play training comes with slice 3 of the port",
    "scale": "scale-mode self-play comes with slice 3 of the port",
    "sb3": "the SB3 baseline comes with slice 4 of the port",
    "all": "it includes self-play (slice 3) and the SB3 baseline (slice 4)",
}


def _seed_all(seed: int):
    random.seed(seed)
    np.random.seed(seed)


def make_training_pool(cfg, dtype=torch.float32, device=None):
    """TRACK_POOL + TRACK_WIDTHS + identity assignment, on ``device`` (default
    cuda)."""
    cps = trk.gen_tracks(num_tracks=cfg.num_envs, seed=cfg.seed)
    widths = [float(np.random.randint(6, 10)) for _ in range(cfg.num_envs)]
    pool = trk.make_track_pool(cps, widths, dtype=dtype, device=resolve_device(device))
    return trk.gather_tracks(pool, np.arange(cfg.num_envs))


def train_single(total_timesteps=None, num_envs=None, out="models/single_agent.npz",
                 num_updates=None, device=None, **cfg_overrides):
    overrides = dict(cfg_overrides)
    if total_timesteps:
        overrides["total_timesteps"] = total_timesteps
    if num_envs:
        overrides["num_envs"] = num_envs
    cfg = base_config(**overrides)
    dev = resolve_device(device)
    _seed_all(cfg.seed)
    print("Generating track pool")
    track = make_training_pool(cfg, device=dev)
    env_cfg = senv.RacingConfig(num_sensors=11)

    print("=" * 60)
    print("PPO TRAINING")
    print("=" * 60)
    print(f"Total timesteps: {cfg.total_timesteps:,} | Envs: {cfg.num_envs} | "
          f"Batch: {cfg.batch_size:,} | Updates: {cfg.num_updates} | Device: {dev}")
    trainer = PPOTrainer(cfg, env_cfg, track)
    trainer.train(num_updates=num_updates)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    trainer.save(out)
    os.makedirs("data", exist_ok=True)
    trainer.save_training_info("data/training_info_single.json")
    print(f"Final model saved to {out}")
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["multi", "single", "scale", "sb3", "all"])
    p.add_argument("--total-timesteps", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--num-updates", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="default: cuda")
    # flags of the self-play modes, accepted for the JAX CLI's interface
    p.add_argument("--resume", default=None, metavar="CKPT", help=argparse.SUPPRESS)
    p.add_argument("--agents", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--resample-tracks-every", type=int, default=None, metavar="K",
                   help=argparse.SUPPRESS)
    p.add_argument("--pooled-geometry", nargs="?", const="tiled",
                   choices=["gather", "grouped", "tiled"], default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("--pfsp", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--sensor-lod", type=int, default=None, metavar="K",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.mode in _LATER:
        raise SystemExit(f"train {args.mode}: not ported yet; {_LATER[args.mode]}")
    kw = {}
    if args.seed is not None:
        kw["seed"] = args.seed
    if args.pfsp:
        kw["opponent_sampling"] = "pfsp"
    return train_single(args.total_timesteps, args.num_envs,
                        num_updates=args.num_updates, device=args.device, **kw)


if __name__ == "__main__":
    main()

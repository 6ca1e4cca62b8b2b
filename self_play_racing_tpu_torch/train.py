"""Training entry points (port of ``self_play_racing_tpu/train.py``).

  python -m self_play_racing_tpu_torch.train multi    # self-play PPO, reference config
  python -m self_play_racing_tpu_torch.train single   # single-car PPO
  python -m self_play_racing_tpu_torch.train scale    # scale-mode self-play
                                                      # (4096 envs, per-env opponents)
  python -m self_play_racing_tpu_torch.train sb3      # SB3 PPO baseline through the
                                                      # gym adapter
  python -m self_play_racing_tpu_torch.train all      # multi, then single, then sb3

Every mode runs on cuda unless ``--device cpu`` is given, and writes under the
working directory as the JAX package's CLI does:

- ``single``: 16 envs x 2048 steps, 5M steps; ``models/single_agent.npz`` and
  ``data/training_info_single.json``.
- ``multi``: the reference's self-play config (16 envs x 2048 steps, 3M steps,
  one opponent shared by all envs, every env reset at each update, a snapshot
  every 15 updates into a pool of 5); ``models/self_play_agent.npz``,
  ``data/training_info_self_play.json`` and a full checkpoint in ``models/`` every
  10 updates.
- ``scale``: 4096 envs x 256 steps over a 16-track pool tiled across the envs,
  opponents chosen per env, no forced resets, 1B steps;
  ``models/self_play_agent_scale_1B.npz``,
  ``data/training_info_self_play_scale_1B.json`` and a checkpoint in
  ``models/scale/`` every 200 updates. ``--resample-tracks-every K`` draws a fresh
  procedural pool on the device every K updates (``envs/procgen.py``), keyed by
  the update it starts at, so a resumed run trains on the pool it left;
  ``--pooled-geometry [tiled|grouped|gather]`` keeps the pool resident and lets
  the env kernels read each env's row by id instead of per-env copies.
  ``--coordinator HOST:PORT --num-processes P --process-id i`` (one command per
  process, one card each) trains data parallel over ``torch.distributed`` (NCCL;
  gloo with ``--device cpu``): the envs are split over the processes and the
  minibatch shuffle stays shard-local where the minibatch divides; rank 0 writes
  the files.

- ``sb3``: SB3's default PPO (stable_baselines3 when installed, else the vendored
  ``interop.sb3_compat``) on ``num_envs`` single-car gym adapters (16 by default),
  one host step at a time, each env wrapped in ``EpisodeStatistics``;
  ``models/sb3_baseline_agent_general.zip`` and ``data/training_info_sb3.json``.
  ``--num-envs`` applies here too (the JAX CLI keeps the config's 16).

Track pools follow the reference's seed and stream conventions:
``gen_tracks(num_tracks, seed)``, then widths ``randint[6, 10)`` from the global
NumPy RNG.
"""
from __future__ import annotations

import argparse
import os
import random

import numpy as np
import torch

from ._device import resolve_device
from .agent.self_play import SelfPlayTrainer
from .agent.trainer import PPOTrainer
from .configs import base_config, self_play_config
from .envs import multi as menv
from .envs import procgen as pg
from .envs import single as senv
from .envs import track as trk
from .parallel import mesh as pmesh

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


def train_multi(total_timesteps=None, num_envs=None, out="models/self_play_agent.npz",
                checkpoint_dir="models", num_updates=None, resume_from=None, device=None,
                **cfg_overrides):
    overrides = dict(cfg_overrides)
    if total_timesteps:
        overrides["total_timesteps"] = total_timesteps
    if num_envs:
        overrides["num_envs"] = num_envs
    cfg = self_play_config(**overrides)
    dev = resolve_device(device)
    _seed_all(cfg.seed)
    print("Generating track pool")
    track = make_training_pool(cfg, device=dev)
    env_cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=11)

    print("=" * 60)
    print("SELF PLAY PPO TRAINING")
    print("=" * 60)
    print(f"Total timesteps: {cfg.total_timesteps:,} | Envs: {cfg.num_envs} | "
          f"Batch: {cfg.batch_size:,} | Updates: {cfg.num_updates} | "
          f"Snapshot freq: {cfg.snapshot_freq} | Pool: {cfg.pool_size} | Device: {dev}")
    trainer = SelfPlayTrainer(cfg, env_cfg, track)
    trainer.train(num_updates=num_updates, checkpoint_dir=checkpoint_dir,
                  resume_from=resume_from)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    trainer.save(out)
    os.makedirs("data", exist_ok=True)
    trainer.save_training_info("data/training_info_self_play.json")
    print(f"Final model saved to {out}")
    return trainer


def procgen_pool(seed: int, boundary: int, num_tracks: int, track_points: int = 12,
                 sensor_lod: int = 1, device=None) -> trk.TrackArrays:
    """The procedural pool that ``train scale --resample-tracks-every`` trains on
    from update ``boundary`` on, for a run seeded ``seed``: drawn on ``device``
    from a generator seeded with both (``procgen.pool_generator``)."""
    return pg.gen_track_pool(pg.pool_generator(seed, boundary, device), num_tracks,
                             track_points, sensor_lod=sensor_lod)


def geometry_layout(pool: trk.TrackArrays, num_envs: int, pooled_geometry=False):
    """The geometry ``train scale`` gives its envs from a pool of T tracks:
    ``False`` copies each env's rows (``gather_tracks``, env i on track i % T);
    ``"tiled"`` keeps the pool resident with the same assignment (so every
    trajectory is the copied layout's); ``"grouped"`` gives each track a block of
    N / T consecutive envs (another assignment); ``"gather"`` (or True) keeps it
    resident with env i on track i % T read through arbitrary ids."""
    t = pool.num_tracks
    env_ids = np.arange(num_envs) % t
    if pooled_geometry == "grouped":
        if num_envs % t:
            raise ValueError("grouped geometry needs num_envs % num_tracks == 0")
        return trk.grouped_pooled_tracks(pool, np.arange(t), num_envs // t)
    if pooled_geometry == "tiled":
        return trk.tiled_pooled_tracks(pool, num_envs)
    if pooled_geometry:
        return trk.pooled_tracks(pool, env_ids)
    return trk.gather_tracks(pool, env_ids)


def train_scale(total_timesteps=1_000_000_000, num_envs=4096, num_steps=256,
                num_tracks=16, out="models/self_play_agent_scale_1B.npz",
                info_out="data/training_info_self_play_scale_1B.json",
                num_updates=None, checkpoint_dir="models/scale",
                checkpoint_every=200, resume_from=None, num_agents=2,
                resample_tracks_every=0, track_points=12, pooled_geometry=False,
                sensor_lod=1, device=None, coordinator=None, num_processes=None,
                process_id=None, **cfg_overrides):
    """Scale-mode self-play: env state stays resident, opponents are chosen per
    env, ``num_tracks`` tracks tiled over the envs (env i races track
    i % num_tracks). ``num_agents`` > 2 races the learner against that many
    frozen-pool seats. ``sensor_lod`` > 1 senses against a coarser boundary
    (relaxed sensing; progress, rewards and collisions stay exact).

    ``resample_tracks_every`` K > 0: every K updates a fresh ``num_tracks``-track
    procedural pool of ``track_points`` control points is drawn on the device
    (``procgen_pool``) and every env restarts on it; pools are keyed by the update
    they start at, so a resume lands on the pool that was active at its
    checkpoint. ``pooled_geometry`` (``geometry_layout``) keeps the pool resident
    instead of per-env copies: the capacity path for env counts whose copies do
    not fit.

    Data parallel over the process group (``coordinator``, ``num_processes``,
    ``process_id``: ``parallel.mesh.distributed_init``, or a group the caller
    initialized): with more than one process and ``num_envs`` divisible by
    their number the trainer is sharded, with ``data_shards`` = the number of
    processes where the minibatch divides (shard-local minibatches), else 1 (the
    global shuffle). Every process builds the same run from the seed and keeps
    its envs."""
    dev = resolve_device(device)
    pmesh.distributed_init(coordinator, num_processes, process_id, device=dev)
    mesh = pmesh.make_mesh(dev)
    dev = mesh.device
    n_dev = mesh.world
    overrides = dict(total_timesteps=total_timesteps, num_envs=num_envs,
                     num_steps=num_steps, opponent_per_env=True,
                     reset_envs_each_update=False)
    overrides.update(cfg_overrides)
    # shard-local minibatching needs every minibatch to take an equal stratum from
    # each process's envs: probe the minibatch size of the final overrides, and
    # keep the global shuffle for configs it does not divide
    probe = self_play_config(**overrides)
    use_mesh = n_dev > 1 and probe.num_envs % n_dev == 0
    if (use_mesh and "data_shards" not in cfg_overrides
            and probe.minibatch_size % n_dev == 0):
        overrides["data_shards"] = n_dev
    cfg = self_play_config(**overrides)
    _seed_all(cfg.seed)

    def pool_for_boundary(boundary: int):
        pool = procgen_pool(cfg.seed, boundary, num_tracks, track_points, sensor_lod, dev)
        return geometry_layout(pool, cfg.num_envs, pooled_geometry)

    if resample_tracks_every:
        print(f"Generating {num_tracks}-track pool on {dev} "
              f"(resampled every {resample_tracks_every} updates)")
        track = pool_for_boundary(0)
    else:
        print(f"Generating {num_tracks}-track pool (tiled over {cfg.num_envs} envs)")
        cps = trk.gen_tracks(num_tracks=num_tracks, seed=cfg.seed)
        widths = [float(np.random.randint(6, 10)) for _ in range(num_tracks)]
        pool = trk.make_track_pool(cps, widths, sensor_lod=sensor_lod, device=dev)
        track = geometry_layout(pool, cfg.num_envs, pooled_geometry)
    env_cfg = menv.MultiRacingConfig(num_agents=num_agents, num_sensors=11)

    print("=" * 60)
    print("SELF PLAY PPO TRAINING (SCALE MODE)")
    print("=" * 60)
    print(f"Total timesteps: {cfg.total_timesteps:,} | Envs: {cfg.num_envs} | "
          f"Batch: {cfg.batch_size:,} | Updates: {cfg.num_updates} | "
          f"Snapshot freq: {cfg.snapshot_freq} | Pool: {cfg.pool_size} | Device: {dev}")
    trainer = SelfPlayTrainer(cfg, env_cfg, track)
    if use_mesh:
        layout = (f"shard-local minibatching (data_shards={cfg.data_shards})"
                  if cfg.data_shards > 1 else
                  "global-shuffle minibatching (minibatch size not divisible "
                  "by the device count)")
        print(f"Sharding over {n_dev} devices: mesh {dict(mesh.shape)}, {layout}")
        trainer.shard(mesh)
    if resample_tracks_every:
        applied = {"boundary": 0}

        def resample(update):
            # keyed by the boundary, not fired on multiples: a resume that lands
            # mid-period swaps to the pool that was active at its checkpoint
            boundary = (update // resample_tracks_every) * resample_tracks_every
            if boundary != applied["boundary"]:
                applied["boundary"] = boundary
                return pool_for_boundary(boundary)
            return None

        trainer.track_resampler = resample
    trainer.train(num_updates=num_updates, log_every=50, checkpoint_dir=checkpoint_dir,
                  checkpoint_every=checkpoint_every, resume_from=resume_from)
    if mesh.rank == 0:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        trainer.save(out)
        os.makedirs(os.path.dirname(info_out) or ".", exist_ok=True)
        trainer.save_training_info(info_out)
        print(f"Final model saved to {out}")
    return trainer


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


def train_single_baseline(total_timesteps=None,
                          out="models/sb3_baseline_agent_general",
                          sb3_kwargs=None,
                          info_out="data/training_info_sb3.json",
                          device=None, **cfg_overrides):
    """SB3 PPO on the single-car gym adapter: stable_baselines3 when installed,
    otherwise the vendored ``interop.sb3_compat`` (SB3's defaults in plain torch).
    ``cfg.num_envs`` float32 ``RacingEnv``s on ``device`` over the training pool's
    tracks and widths, each wrapped in ``EpisodeStatistics``; the policy on the
    same device."""
    try:
        from stable_baselines3 import PPO as SB3_PPO
        from stable_baselines3.common.vec_env import DummyVecEnv
    except ImportError:
        from .interop.sb3_compat import PPO as SB3_PPO, DummyVecEnv
        print("stable_baselines3 not installed - using the vendored "
              "sb3_compat PPO (identical defaults, torch)")
    from .envs.gym_adapter import EpisodeStatistics, RacingEnv
    from .interop.sb3_compat import TrainingLoggerCallback

    overrides = dict(cfg_overrides)
    if total_timesteps:
        overrides["total_timesteps"] = total_timesteps
    cfg = base_config(**overrides)
    dev = resolve_device(device)
    _seed_all(cfg.seed)
    cps = trk.gen_tracks(num_tracks=cfg.num_envs, seed=cfg.seed)
    widths = [float(np.random.randint(6, 10)) for _ in range(cfg.num_envs)]

    def make_env(i):
        def thunk():
            return EpisodeStatistics(RacingEnv(num_sensors=11, track_pool=cps, track_id=i,
                                               track_width=widths[i], dtype=torch.float32,
                                               device=dev))
        return thunk

    env = DummyVecEnv([make_env(i) for i in range(cfg.num_envs)])
    model = SB3_PPO("MlpPolicy", env, seed=cfg.seed, device=dev, **(sb3_kwargs or {}))
    model.learn(total_timesteps=cfg.total_timesteps, progress_bar=False,
                callback=TrainingLoggerCallback(save_path=info_out))
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    model.save(out)
    env.close()
    return model


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["multi", "single", "scale", "sb3", "all"])
    p.add_argument("--total-timesteps", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--num-updates", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="multi/scale modes: resume from a full checkpoint (e.g. "
                        "models/checkpoint_update_30) or a reference .pth")
    p.add_argument("--agents", type=int, default=None,
                   help="scale mode: cars per race (learner + N-1 frozen-pool "
                        "opponents; default 2)")
    p.add_argument("--pfsp", action="store_true",
                   help="scale/multi modes: sample pool opponents by "
                        "(1-winrate)^2 instead of uniformly")
    p.add_argument("--sensor-lod", type=int, default=None, metavar="K",
                   help="scale mode: relaxed sensing against a K-x coarser "
                        "boundary (progress, rewards and collisions stay exact)")
    p.add_argument("--resample-tracks-every", type=int, default=None, metavar="K",
                   help="scale mode: draw a fresh procedural track pool on the "
                        "device every K updates (0 = off)")
    p.add_argument("--pooled-geometry", nargs="?", const="tiled",
                   choices=["gather", "grouped", "tiled"], default=None,
                   help="scale mode: keep the [tracks, ...] pool resident and let "
                        "the env kernels read each env's row by id instead of "
                        "per-env copies. 'tiled' (the default when no value is "
                        "given) keeps the arange(N) %% T assignment, so runs equal "
                        "the copied layout's; 'grouped' gives each track a block "
                        "of N/T consecutive envs (another assignment); 'gather' "
                        "reads through arbitrary per-env ids")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="scale mode, data parallel: rank 0's address; every "
                        "process passes the same value (torch.distributed)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="scale mode, data parallel: the number of processes, one "
                        "card each")
    p.add_argument("--process-id", type=int, default=None,
                   help="scale mode, data parallel: this process's rank, "
                        "0..num-processes-1")
    args = p.parse_args(argv)
    kw = {}
    if args.seed is not None:
        kw["seed"] = args.seed
    if args.pfsp:
        kw["opponent_sampling"] = "pfsp"
    if args.mode != "scale":
        # all: multi, then single, then sb3, as the JAX CLI runs them
        out = None
        if args.mode in ("multi", "all"):
            out = train_multi(args.total_timesteps, args.num_envs,
                              num_updates=args.num_updates, resume_from=args.resume,
                              device=args.device, **kw)
        if args.mode in ("single", "all"):
            out = train_single(args.total_timesteps, args.num_envs,
                               num_updates=args.num_updates, device=args.device, **kw)
        if args.mode in ("sb3", "all"):
            skw = dict(kw, num_envs=args.num_envs) if args.num_envs else kw
            out = train_single_baseline(args.total_timesteps, device=args.device, **skw)
        return out
    skw = dict(kw)
    if args.total_timesteps:
        skw["total_timesteps"] = args.total_timesteps
    if args.num_envs:
        skw["num_envs"] = args.num_envs
    if args.agents:
        skw["num_agents"] = args.agents
    if args.sensor_lod:
        skw["sensor_lod"] = args.sensor_lod
    if args.resample_tracks_every is not None:
        skw["resample_tracks_every"] = args.resample_tracks_every
    if args.pooled_geometry:
        skw["pooled_geometry"] = args.pooled_geometry
    trainer = train_scale(num_updates=args.num_updates, resume_from=args.resume,
                          device=args.device, coordinator=args.coordinator,
                          num_processes=args.num_processes, process_id=args.process_id,
                          **skw)
    if args.coordinator is not None:
        torch.distributed.destroy_process_group()
    return trainer


if __name__ == "__main__":
    main()

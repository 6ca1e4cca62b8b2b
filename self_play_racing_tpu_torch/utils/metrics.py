"""Evaluation harness: batched episode rollouts + aggregation (port of the
single-car half of ``self_play_racing_tpu/utils/metrics.py``).

Every (track, run) combination of the evaluation grid is one row of a single env
batch; the rollout is a Python loop over steps with done-latching, and a row's
state and observation freeze once its episode ends.

Per-episode metrics:
 - total_reward: sum of rewards until done (inclusive)
 - steps: steps taken until done (or the horizon cap)
 - progress / finished / crashed / speed: from the final step's info
 - total_distance: sum of |pos_t - pos_{t-1}| from the second step on
 - policies sample actions, or act greedily (tanh mu) with ``deterministic``
"""
from __future__ import annotations

import numpy as np
import torch

from .._tree import where_rows
from ..envs import normalize as obsnorm
from ..envs import single as senv
from ..envs import track as trk
from ..models import actor_critic as net

# rows that finished freeze, so the loop may stop once none is active; it checks
# (one host sync) every this many steps
_ACTIVE_CHECK_EVERY = 32


def _policy_action(params, log_std, obs, generator, deterministic, obs_norm=None):
    if obs_norm is not None:
        obs = obsnorm.apply(obs_norm, obs)
    if deterministic:
        return net.deterministic_action(params, obs)
    mu_dtype = params["actor"][0][0].dtype
    noise = net.sample_noise((obs.shape[0], log_std.shape[-1]), generator,
                             dtype=mu_dtype, device=obs.device)
    action, _, _ = net.sample_action(params, log_std, obs, noise)
    return action


@torch.no_grad()
def rollout_single(params, log_std, env_cfg: senv.RacingConfig, track: trk.TrackArrays,
                   generator=None, max_steps: int = 2000, deterministic: bool = False,
                   obs_norm=None):
    """Latched episode metrics for a batch of single-car envs. Returns a dict of
    [N] tensors (total_reward, steps, progress, finished, crashed, speed,
    total_distance, distance_per_step). Sampled mode draws its noise from
    ``generator``, which lives on the track's device."""
    if not deterministic and generator is None:
        raise ValueError("rollout_single: sampled actions need a generator")
    state, obs = senv.reset(env_cfg, track)
    n = obs.shape[0]
    dtype, dev = state.car.x.dtype, state.car.x.device
    acc = {
        "total_reward": torch.zeros((n,), dtype=dtype, device=dev),
        "steps": torch.zeros((n,), dtype=torch.int32, device=dev),
        "total_distance": torch.zeros((n,), dtype=dtype, device=dev),
        "progress": torch.zeros((n,), dtype=dtype, device=dev),
        "finished": torch.zeros((n,), dtype=torch.bool, device=dev),
        "crashed": torch.zeros((n,), dtype=torch.bool, device=dev),
        "speed": torch.zeros((n,), dtype=dtype, device=dev),
    }
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    for t in range(max_steps):
        if t % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        action = _policy_action(params, log_std, obs.to(torch.float32), generator,
                                deterministic, obs_norm)
        nstate, nobs, rew, term, trunc, info = senv.step(env_cfg, track, state, action)
        done = term | trunc
        step_dist = torch.sqrt((info["x"] - state.car.x) ** 2
                               + (info["y"] - state.car.y) ** 2)
        first_step = acc["steps"] == 0
        acc = {
            "total_reward": acc["total_reward"] + torch.where(active, rew, 0.0),
            "steps": acc["steps"] + active.to(torch.int32),
            "total_distance": acc["total_distance"]
            + torch.where(active & ~first_step, step_dist, 0.0),
            "progress": torch.where(active, info["progress"], acc["progress"]),
            "finished": torch.where(active, info["finished"], acc["finished"]),
            "crashed": torch.where(active, info["crashed"], acc["crashed"]),
            "speed": torch.where(active, info["speed"], acc["speed"]),
        }
        active = active & ~done
        # frozen state once inactive so nothing drifts after the episode ends
        state = where_rows(active, nstate, state)
        obs = torch.where(active[:, None], nobs, obs)
    acc["distance_per_step"] = torch.where(
        acc["steps"] > 1, acc["total_distance"] / acc["steps"], 0.0)
    return acc


def aggregate(episodes: dict) -> dict:
    """Grid aggregation over a dict of per-episode arrays: success and crash rates
    over all episodes, ``avg_*`` over successful episodes, steps per progress over
    episodes with progress > 0.01."""
    episodes = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in episodes.items()}
    total = len(episodes["steps"])
    finished = np.asarray(episodes["finished"], bool)
    crashed = np.asarray(episodes["crashed"], bool)
    progress = np.asarray(episodes["progress"], float)
    steps = np.asarray(episodes["steps"], float)
    succ = finished

    def avg(key):
        vals = np.asarray(episodes[key], float)
        return float(np.mean(vals[succ])) if succ.any() else 0.0

    eff_mask = progress > 0.01
    steps_per_progress = (
        float(np.mean(steps[eff_mask] / progress[eff_mask])) if eff_mask.any() else 0.0
    )
    return {
        "num_episodes": int(total),
        "num_successful": int(succ.sum()),
        "success_rate": float(succ.sum() / total),
        "crash_rate": float(crashed.sum() / total),
        "avg_steps": float(np.mean(steps[succ])) if succ.any() else 0.0,
        "avg_reward": avg("total_reward"),
        "avg_progress": avg("progress"),
        "avg_speed": avg("speed"),
        "avg_distance": avg("total_distance"),
        "avg_steps_per_progress": steps_per_progress,
    }


def build_eval_grid(num_tracks: int = 40, num_runs: int = 5, seed: int = 42,
                    dtype=torch.float32, device=None):
    """The evaluation grid: ``num_tracks`` procedural tracks (global RNG seeded,
    per the gen_tracks quirk) x ``num_runs`` widths drawn as
    RandomState(seed+i).randint(4, 10), indexed by run, not track (a quirk of the
    original protocol).

    Returns (TrackArrays of num_tracks*num_runs rows, track_ids, run_ids).
    """
    np.random.seed(seed)
    cps = trk.gen_tracks(num_tracks=num_tracks, seed=seed)
    widths = [np.random.RandomState(seed + i).randint(4, 10) for i in range(num_tracks)]
    combo_cps, combo_widths, track_ids, run_ids = [], [], [], []
    for t in range(num_tracks):
        for r in range(num_runs):
            combo_cps.append(cps[t])
            combo_widths.append(float(widths[r]))
            track_ids.append(t)
            run_ids.append(r)
    pool = trk.make_track_pool(combo_cps, combo_widths, dtype=dtype, device=device)
    return pool, np.array(track_ids), np.array(run_ids)

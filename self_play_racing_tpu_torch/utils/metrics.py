"""Evaluation harness: batched episode rollouts + aggregation (port of
``self_play_racing_tpu/utils/metrics.py``).

Every (track, run) combination of the evaluation grid is one row of a single env
batch; the rollout is a Python loop over steps with done-latching, and a row's
state and observation freeze once its episode ends.

Per-episode metrics:
 - total_reward: sum of rewards until done (inclusive)
 - steps: steps taken until done (or the horizon cap)
 - progress / finished / crashed / speed: from the final step's info
 - total_distance: sum of |pos_t - pos_{t-1}| from the second step on
 - policies sample actions, or act greedily (tanh mu) with ``deterministic``
 - multi-car: one shared policy drives every car and an episode's numbers are the
   first finished car's, else car 0's (``rollout_multi``); or one policy per seat,
   returning every seat's numbers (``rollout_match``, the tournament's match)

The loops take an optional ``trace`` list that receives each step's car poses,
speed, progress, reward and the rows active entering the step
(``utils/viz.py``'s recorders); they stay on the device until the caller stacks
them.
"""
from __future__ import annotations

import numpy as np
import torch

from .._tree import where_rows
from ..envs import multi as menv
from ..envs import normalize as obsnorm
from ..envs import selfplay
from ..envs import single as senv
from ..envs import track as trk
from ..models import actor_critic as net

# rows that finished freeze, so the loop may stop once none is active; it checks
# (one host sync) every this many steps
_ACTIVE_CHECK_EVERY = 32


def _policy_action(params, log_std, obs, noise, obs_norm=None):
    """The policy's action on ``obs``: greedy (tanh mu) when ``noise`` is None,
    else sampled with that standard-normal noise."""
    if obs_norm is not None:
        obs = obsnorm.apply(obs_norm, obs)
    if noise is None:
        return net.deterministic_action(params, obs)
    action, _, _ = net.sample_action(params, log_std, obs, noise)
    return action


def _seat_actions(params, log_std, obs, noise, obs_norm):
    """One policy per seat: ``params``, ``log_std`` [A, act] and ``obs_norm``
    (mean, var [A, D]) carry a leading seat axis; ``obs`` [N, A, D] and ``noise``
    [N, A, act] or None (greedy). The seats run as one stacked MLP (the self-play
    pool's), seat-major. Returns actions [N, A, act]."""
    x = obs.transpose(0, 1)                                           # [A, N, D]
    x = selfplay._normalized(obs_norm.mean[:, None, :], obs_norm.var[:, None, :], x)
    act = selfplay._pool_actor_mu(params, x)                          # [A, N, act]
    if noise is not None:
        act = torch.clamp(act + torch.exp(log_std)[:, None, :] * noise.transpose(0, 1),
                          -1.0, 1.0)
    return act.transpose(0, 1)


def _step_record(x, y, angle, info, rew, active):
    return {"x": x, "y": y, "angle": angle, "speed": info["speed"],
            "progress": info["progress"], "reward": rew, "active": active}


@torch.no_grad()
def _rollout_single_acc(params, log_std, env_cfg, track, generator, max_steps,
                        deterministic, obs_norm, trace=None):
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
    mu_dtype = params["actor"][0][0].dtype
    for t in range(max_steps):
        if t % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        noise = None if deterministic else net.sample_noise(
            (n, log_std.shape[-1]), generator, dtype=mu_dtype, device=dev)
        action = _policy_action(params, log_std, obs.to(torch.float32), noise, obs_norm)
        nstate, nobs, rew, term, trunc, info = senv.step(env_cfg, track, state, action)
        done = term | trunc
        if trace is not None:
            trace.append(_step_record(nstate.car.x, nstate.car.y, nstate.car.angle,
                                      info, rew, active))
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
    return acc


def rollout_single(params, log_std, env_cfg: senv.RacingConfig, track: trk.TrackArrays,
                   generator=None, max_steps: int = 2000, deterministic: bool = False,
                   obs_norm=None):
    """Latched episode metrics for a batch of single-car envs. Returns a dict of
    [N] tensors (total_reward, steps, progress, finished, crashed, speed,
    total_distance, distance_per_step). Sampled mode draws its noise from
    ``generator``, which lives on the track's device."""
    acc = _rollout_single_acc(params, log_std, env_cfg, track, generator, max_steps,
                              deterministic, obs_norm)
    acc["distance_per_step"] = torch.where(
        acc["steps"] > 1, acc["total_distance"] / acc["steps"], 0.0)
    return acc


@torch.no_grad()
def _rollout_multi_acc(params, log_std, env_cfg, track, generator, max_steps,
                       deterministic, obs_norm, per_seat=False, noise=None, trace=None):
    """The multi-car loop's raw accumulator ([N, A] per car, ``steps`` [N]).
    ``per_seat``: params, log_std and obs_norm carry a leading seat axis (one
    policy per car) and obs_norm is a stacked normalizer, never None. Sampled
    noise is [N, A, act] a step, from ``noise`` [T, N, A, act] when given, else
    from ``generator`` (which also draws the start-grid slots)."""
    state, obs = menv.reset(env_cfg, track, generator)
    n, a = state.x.shape
    dtype, dev = state.x.dtype, state.x.device
    fzeros = torch.zeros((n, a), dtype=dtype, device=dev)
    bfalse = torch.zeros((n, a), dtype=torch.bool, device=dev)
    acc = {
        "total_reward": fzeros, "steps": torch.zeros((n,), dtype=torch.int32, device=dev),
        "total_distance": fzeros, "progress": fzeros, "finished": bfalse,
        "crashed": bfalse, "speed": fzeros,
        "placement": torch.zeros((n, a), dtype=torch.int32, device=dev),
    }
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    mu_dtype = params["actor"][0][0].dtype
    for t in range(max_steps):
        if t % _ACTIVE_CHECK_EVERY == 0 and not bool(active.any()):
            break
        eps = None
        if not deterministic:
            eps = noise[t] if noise is not None else net.sample_noise(
                (n, a, log_std.shape[-1]), generator, dtype=mu_dtype, device=dev)
        obs32 = obs.to(torch.float32)
        if per_seat:
            action = _seat_actions(params, log_std, obs32, eps, obs_norm)
        else:
            action = _policy_action(params, log_std, obs32.reshape(n * a, -1),
                                    None if eps is None else eps.reshape(n * a, -1),
                                    obs_norm).reshape(n, a, -1)
        nstate, nobs, rew, term, trunc, info = menv.step(env_cfg, track, state, action)
        done = term | trunc
        if trace is not None:
            trace.append(_step_record(nstate.x, nstate.y, nstate.angle, info, rew, active))
        step_dist = torch.sqrt((info["x"] - state.x) ** 2 + (info["y"] - state.y) ** 2)
        first_step = acc["steps"] == 0
        act2 = active[:, None]
        acc = {
            "total_reward": acc["total_reward"] + torch.where(act2, rew, 0.0),
            "steps": acc["steps"] + active.to(torch.int32),
            "total_distance": acc["total_distance"]
            + torch.where(act2 & ~first_step[:, None], step_dist, 0.0),
            **{k: torch.where(act2, info[k], acc[k])
               for k in ("progress", "finished", "crashed", "speed", "placement")},
        }
        active = active & ~done
        state = where_rows(active, nstate, state)
        obs = torch.where(active[:, None, None], nobs, obs)
    return acc


def rollout_multi(params, log_std, env_cfg: menv.MultiRacingConfig, track: trk.TrackArrays,
                  generator, max_steps: int = 3000, deterministic: bool = False,
                  obs_norm=None):
    """Shared-policy multi-car rollout: every car is driven by the same policy, on
    the flat [N * A] batch of observations. Returns a dict of [N] tensors
    (total_reward, progress, finished, crashed, speed, placement, total_distance
    and distance_per_step of the chosen car, the episode's steps). ``generator``
    (on the track's device) draws the start-grid slots and the sampled actions'
    noise."""
    acc = _rollout_multi_acc(params, log_std, env_cfg, track, generator, max_steps,
                             deterministic, obs_norm)
    n = acc["steps"].shape[0]
    # the chosen car: the first finished one, else car 0 (argmax of the first True)
    chosen = acc["finished"].to(torch.int8).argmax(dim=1)
    rows = torch.arange(n, device=chosen.device)
    out = {k: v[rows, chosen] for k, v in acc.items() if k != "steps"}
    out["steps"] = acc["steps"]
    out["distance_per_step"] = torch.where(
        out["steps"] > 1, out["total_distance"] / out["steps"], 0.0)
    return out


def rollout_match(params_stack, log_std_stack, obs_norm_stack,
                  env_cfg: menv.MultiRacingConfig, track: trk.TrackArrays, generator,
                  max_steps: int = 3000, deterministic: bool = False, noise=None):
    """Head-to-head match rollout: one policy per seat (tournament play). The
    stacked inputs have a leading ``num_agents`` axis (``tournament.stack_bundles``);
    ``obs_norm_stack`` is a stacked ``ObsNormState`` (identity rows for policies
    trained without normalization). ``generator`` (on the track's device) draws the
    start-grid slots and, in sampled mode, each step's [N, A, 2] noise unless
    ``noise`` [T, N, A, 2] is given. Returns the raw per-seat accumulator: [N, A]
    tensors (placement: 1 = winner, 0 = the episode never ended inside
    ``max_steps``; finished, crashed, progress, total_reward, total_distance,
    speed) and ``steps`` [N]."""
    return _rollout_multi_acc(params_stack, log_std_stack, env_cfg, track, generator,
                              max_steps, deterministic, obs_norm_stack, per_seat=True,
                              noise=noise)


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

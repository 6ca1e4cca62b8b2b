"""Evaluation entry point (port of ``self_play_racing_tpu/evaluate.py``).

Runs the evaluation grid (40 tracks x 5 runs, seed 42, widths drawn by run) as one
batched rollout on the card per model, writes each model's aggregate and episodes
to ``<out_dir>/eval_info_<label>.json`` and draws the comparison chart. Accepts the
repo's ``.npz`` policies and ``.pth`` state dicts of the original torch
implementation. A ``--multi`` policy drives both cars of a 2-car race (one shared
policy); the episode's numbers are the first finished car's.

  python -m self_play_racing_tpu_torch.evaluate --single models/single_agent.npz \
      --multi models/self_play_agent.npz

The CLI writes ``data/eval_info_single.json``, ``data/eval_info_self_play.json``
and ``static/eval_comparison.png`` relative to the working directory, as the JAX
package's does. ``--procgen`` also drives each ``--multi`` policy zero-shot on
``--num-tracks`` unseen procedural tracks built on the card (``envs/procgen.py``)
and prints its gap to the grid. ``--sb3 PATH`` drives an SB3 PPO model (a real
stable_baselines3 ``.zip`` or one the vendored ``interop.sb3_compat`` saved)
deterministically through the gym adapter on the same grid, one env and one host
step at a time, and writes ``eval_info_sb3.json``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

import torch

from . import interop
from ._device import resolve_device
from .envs import multi as menv
from .envs import procgen as pg
from .envs import single as senv
from .models import actor_critic as net
from .utils import metrics as M


def load_policy(path, device=None, dtype=torch.float32):
    """(params, log_std) from .npz (the repo's) or .pth (a state dict of the
    original torch implementation)."""
    params, log_std, _ = load_policy_bundle(path, device, dtype)
    return params, log_std


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


def evaluate_multi_agent_procgen(model_path, num_tracks=40, num_points=12,
                                 width_range=(4.0, 10.0), seed=777, eval_seed=42,
                                 deterministic=False, num_agents=2, max_steps=3000,
                                 device=None):
    """Zero-shot track generalization: the shared-policy multi-car evaluation on
    ``num_tracks`` unseen procedural tracks (one race each) built on ``device``
    from a generator seeded ``seed``; the start grid and the sampled actions draw
    from a generator seeded ``eval_seed``. Returns the aggregate."""
    dev = resolve_device(device)
    pool = pg.gen_track_pool(torch.Generator(device=dev).manual_seed(seed), num_tracks,
                             num_points, width_range=width_range)
    params, log_std, obs_norm = load_policy_bundle(model_path, dev)
    eps = M.rollout_multi(
        params, log_std, menv.MultiRacingConfig(num_agents=num_agents, num_sensors=11),
        pool, torch.Generator(device=dev).manual_seed(eval_seed), max_steps=max_steps,
        deterministic=deterministic, obs_norm=obs_norm)
    return M.aggregate(eps)


def _adapter_episode(env, predict, max_steps=2000):
    """One host-side episode through the gym adapter: the path length integrated
    from the info positions, the final info's stats."""
    obs, _ = env.reset()
    total_reward = 0.0
    total_distance = 0.0
    prev = None
    info = {}
    step = 0
    for step in range(max_steps):
        action = predict(obs)
        obs, reward, terminated, truncated, info = env.step(action)
        total_reward += float(reward)
        pos = info["position"]
        if prev is not None:
            total_distance += float(np.hypot(pos[0] - prev[0], pos[1] - prev[1]))
        prev = pos
        if terminated or truncated:
            break
    return {
        "total_reward": total_reward,
        "steps": step + 1,
        "progress": float(info["progress"]),
        "finished": bool(info["finished"]),
        "crashed": bool(info["crashed"]),
        "speed": float(info["speed"]),
        "total_distance": total_distance,
        "distance_per_step": total_distance / (step + 1) if step > 0 else 0.0,
    }


def evaluate_adapter_agent_overall(predict, num_tracks=40, num_runs=5, seed=42,
                                   max_steps=2000, num_sensors=11, device=None):
    """Grid evaluation for policies that only expose ``predict(obs) -> action``
    (SB3 models, external baselines): one float32 ``RacingEnv`` on ``device`` an
    episode, driven from the host. The batched evaluators' track and width grid
    (``build_eval_grid``, widths drawn by run) and the same aggregation."""
    from .envs import track as trk
    from .envs.gym_adapter import RacingEnv

    dev = resolve_device(device)
    np.random.seed(seed)
    cps = trk.gen_tracks(num_tracks=num_tracks, seed=seed)
    widths = [np.random.RandomState(seed + i).randint(4, 10) for i in range(num_tracks)]
    episodes = []
    for t in range(num_tracks):
        for r in range(num_runs):
            env = RacingEnv(num_sensors=num_sensors, track_pool=cps, track_id=t,
                            track_width=float(widths[r]), dtype=torch.float32, device=dev)
            episodes.append(_adapter_episode(env, predict, max_steps))
    cols = {k: np.asarray([e[k] for e in episodes]) for k in episodes[0]}
    results = M.aggregate(cols)
    results["all_episodes"] = episodes
    return results


def evaluate_sb3_agent_overall(model_path, num_tracks=40, num_runs=5, seed=42,
                               max_steps=2000, device=None):
    """An SB3 PPO model driven deterministically through the gym adapter on
    ``device`` (policy and env). Uses stable_baselines3 when installed, else the
    vendored ``interop.sb3_compat`` loader, which reads both real SB3 archives and
    its own checkpoints."""
    dev = resolve_device(device)
    try:
        from stable_baselines3 import PPO as SB3_PPO
    except ImportError:
        from .interop.sb3_compat import PPO as SB3_PPO
        model = SB3_PPO.load(model_path, device=dev)
    else:
        # real SB3 cannot read the vendored trainer's checkpoints (torch pickles,
        # not SB3 archives): fall back to the vendored loader for those
        try:
            model = SB3_PPO.load(model_path, device=dev)
        except Exception as sb3_err:
            from .interop import sb3_compat
            try:
                model = sb3_compat.PPO.load(model_path, device=dev)
            except Exception:
                raise sb3_err
    return evaluate_adapter_agent_overall(
        lambda obs: model.predict(obs, deterministic=True)[0],
        num_tracks, num_runs, seed, max_steps, device=dev)


def display_comparison(results_files, labels, output_path):
    """Grouped normalized bar chart of the models' results files."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    all_results = []
    for file in results_files:
        with open(file) as f:
            all_results.append(json.load(f))

    categories = ["Success Rate", "Avg Speed\n(normalized)",
                  "Avg Distance\n(normalized)", "Steps / Progress"]
    max_speed = max((r["avg_speed"] for r in all_results if r["avg_speed"] > 0),
                    default=1.0)
    max_distance = max((r["avg_distance"] for r in all_results if r["avg_distance"] > 0),
                       default=1.0)
    max_spp = max((r["avg_steps_per_progress"] for r in all_results), default=1.0) or 1.0

    data = [
        [r["success_rate"],
         r["avg_speed"] / max_speed if r["avg_speed"] > 0 else 0,
         r["avg_distance"] / max_distance if r["avg_distance"] > 0 else 0,
         r["avg_steps_per_progress"] / max_spp]
        for r in all_results
    ]
    x = np.arange(len(categories))
    width = 0.8 / len(data)
    fig, ax = plt.subplots(figsize=(16, 7))
    for i, (agent_data, label) in enumerate(zip(data, labels)):
        offset = (i - len(data) / 2 + 0.5) * width
        ax.bar(x + offset, agent_data, width, label=label, alpha=0.8)
    ax.set_ylabel("Normalized Value")
    ax.set_title("Agent Performance Comparison")
    ax.set_xticks(x)
    ax.set_xticklabels(categories)
    ax.legend(loc="upper right")
    ax.grid(axis="y", alpha=0.3)
    plt.tight_layout()
    plt.savefig(output_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    print(f"Performance comparison chart saved to {output_path}")


def eval(models: dict, num_tracks=40, num_runs=5, seed=42, out_dir="data",
         chart="static/eval_comparison.png", deterministic=False, device=None):
    """The eval flow: ``models`` maps label -> (kind, path) with kind "single",
    "multi" or "sb3". Writes ``<out_dir>/eval_info_<label>.json`` per model (the aggregate
    and ``all_episodes``) and, when ``chart`` is a path, the comparison chart
    there. Returns {label: {"path": json path, "results": results}}."""
    dev = resolve_device(device)
    grid = M.build_eval_grid(num_tracks, num_runs, seed, device=dev)
    os.makedirs(out_dir, exist_ok=True)
    by_label = {}
    for label, (kind, path) in models.items():
        print(f"Evaluating {label} ({kind}) from {path}")
        if kind == "sb3":
            results = evaluate_sb3_agent_overall(path, num_tracks, num_runs, seed,
                                                 device=dev)
        else:
            fn = (evaluate_single_agent_overall if kind == "single"
                  else evaluate_multi_agent_overall)
            results = fn(grid, path, seed=seed, deterministic=deterministic)
        out_path = os.path.join(out_dir, f"eval_info_{label}.json")
        with open(out_path, "w") as f:
            json.dump(results, f, indent=2)
        print(f"  success_rate={results['success_rate']:.3f} "
              f"crash_rate={results['crash_rate']:.3f} "
              f"avg_speed={results['avg_speed']:.2f} "
              f"avg_steps={results['avg_steps']:.2f}")
        by_label[label] = {"path": out_path, "results": results}
    if chart and by_label:
        os.makedirs(os.path.dirname(chart) or ".", exist_ok=True)
        display_comparison([v["path"] for v in by_label.values()],
                           list(by_label), chart)
    return by_label


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--single", action="append", default=[],
                   help="path to a single-car policy (.npz or .pth)")
    p.add_argument("--multi", action="append", default=[],
                   help="path to a self-play/multi-car policy (.npz or .pth)")
    p.add_argument("--sb3", action="append", default=[],
                   help="path to an SB3 PPO model (.zip; stable_baselines3 when "
                        "installed, else the vendored loader)")
    p.add_argument("--procgen", action="store_true",
                   help="also evaluate each --multi policy zero-shot on --num-tracks "
                        "unseen procedural tracks built on the card, and print the "
                        "gap to the grid")
    p.add_argument("--num-tracks", type=int, default=40)
    p.add_argument("--num-runs", type=int, default=5)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    models = {}
    for i, path in enumerate(args.single):
        models[f"single_{i}" if len(args.single) > 1 else "single"] = ("single", path)
    for i, path in enumerate(args.multi):
        models[f"self_play_{i}" if len(args.multi) > 1 else "self_play"] = ("multi", path)
    for i, path in enumerate(args.sb3):
        models[f"sb3_{i}" if len(args.sb3) > 1 else "sb3"] = ("sb3", path)
    if not models:
        raise SystemExit("pass at least one --single/--multi/--sb3 model path")
    by_label = eval(models, args.num_tracks, args.num_runs, args.seed,
                    deterministic=args.deterministic, device=args.device)
    if args.procgen:
        if not args.multi:
            print("--procgen: no --multi models to evaluate (the flag applies to "
                  "multi-car policies)")
        procgen_transfer(by_label, args.multi, num_tracks=args.num_tracks,
                         deterministic=args.deterministic, device=args.device)
    return by_label


def procgen_transfer(by_label, multi_paths, num_tracks=40, deterministic=False,
                     device=None):
    """``--procgen``: each ``--multi`` policy zero-shot on ``num_tracks`` unseen
    procedural tracks, beside its grid result in ``by_label`` (``eval()``'s, held in
    memory, not read back), under which it is stored as ``"procgen"``; prints the
    transfer gap."""
    for i, path in enumerate(multi_paths):
        r = evaluate_multi_agent_procgen(path, num_tracks=num_tracks,
                                         deterministic=deterministic, device=device)
        label = f"self_play_{i}" if len(multi_paths) > 1 else "self_play"
        grid = by_label[label]["results"]
        by_label[label]["procgen"] = r
        print(f"procgen zero-shot ({os.path.basename(path)}): "
              f"success_rate={r['success_rate']:.3f} "
              f"crash_rate={r['crash_rate']:.3f} "
              f"avg_speed={r['avg_speed']:.2f} | transfer gap vs grid: "
              f"success {r['success_rate'] - grid['success_rate']:+.3f} "
              f"speed {r['avg_speed'] - grid['avg_speed']:+.2f}")
    return by_label


if __name__ == "__main__":
    main()

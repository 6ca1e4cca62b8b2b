"""Round-robin tournament between trained policies (port of
``self_play_racing_tpu/tournament.py``).

Every ordered pair of models races head-to-head, one policy per seat, over the
evaluation grid, and a Bradley-Terry fit turns the win matrix into ratings on the
Elo scale. All matches of a pair run as one batched rollout (the whole grid in
lockstep), so an M-model tournament runs M*(M-1) rollouts.

  python -m self_play_racing_tpu_torch.tournament models/a.npz models/b.npz \\
      models/c.pth --tracks 20 --runs 2 --out data/tournament.json

Runs on ``cuda`` unless ``--device`` names another device. Pair (i, j) of M
models draws from a ``torch.Generator`` on that device seeded with
``pair_seed(seed, i*M + j)``, where the JAX package folds ``i*M + j`` into its key;
the two packages' random streams differ, so their matches differ draw for draw.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ._device import resolve_device
from .envs import multi as menv
from .envs import normalize as obsnorm
from .evaluate import load_policy_bundle
from .utils import metrics as M


def stack_bundles(bundles, obs_dim: int):
    """Stack per-model (params, log_std, obs_norm_or_None) into per-seat stacks
    (float32, on the first bundle's device): params with weights [A, in, out] and
    biases [A, out], log_std [A, act], and one ``ObsNormState`` of [A, D] rows.

    All models must share one architecture (the same tower shapes): they are
    raced as one stacked MLP. Models saved without observation normalization get
    identity normalizer rows.
    """
    dev = bundles[0][0]["actor"][0][0].device
    shapes = [{tower: [(tuple(w.shape), tuple(b.shape)) for w, b in params[tower]]
               for tower in sorted(params)} for params, _, _ in bundles]
    if any(s != shapes[0] for s in shapes[1:]):
        raise ValueError(
            f"tournament seats must share one architecture; got param shapes {shapes}")

    def stack(*xs):
        return torch.stack([torch.as_tensor(x, device=dev).detach().to(torch.float32)
                            for x in xs])

    params = {tower: [(stack(*(p[tower][i][0] for p, _, _ in bundles)),
                       stack(*(p[tower][i][1] for p, _, _ in bundles)))
                      for i in range(len(bundles[0][0][tower]))]
              for tower in bundles[0][0]}
    norms = [norm if norm is not None else obsnorm.init(obs_dim, device=dev)
             for _, _, norm in bundles]
    norm = obsnorm.ObsNormState(mean=stack(*(n.mean for n in norms)),
                                var=stack(*(n.var for n in norms)),
                                count=stack(*(n.count for n in norms)))
    return params, stack(*(ls for _, ls, _ in bundles)), norm


def play_match(bundle_a, bundle_b, track, generator, num_sensors: int = 11,
               max_steps: int = 3000, deterministic: bool = False):
    """Race model A (seat 0) against model B (seat 1) on every env of ``track``.

    Returns (wins_a, wins_b, draws) summed over envs. An env whose episode never
    ends inside ``max_steps`` (placement stays 0) counts as a draw.
    """
    env_cfg = menv.MultiRacingConfig(num_agents=2, num_sensors=num_sensors)
    p, ls, nrm = stack_bundles([bundle_a, bundle_b], env_cfg.obs_dim)
    acc = M.rollout_match(p, ls, nrm, env_cfg, track, generator,
                          max_steps=max_steps, deterministic=deterministic)
    place = acc["placement"]                      # [envs, 2]; 1 = winner
    wins_a, wins_b, draws = torch.stack([
        (place[:, 0] == 1).sum(), (place[:, 1] == 1).sum(),
        (place == 0).all(dim=1).sum()]).tolist()
    return wins_a, wins_b, draws


def bradley_terry_elo(wins: np.ndarray, draws: np.ndarray = None,
                      prior: float = 0.1, iters: int = 1000, tol: float = 1e-12):
    """Elo-scale ratings from a win matrix via the Bradley-Terry MM algorithm.

    ``wins[i, j]`` = wins of i over j; draws count half a win each way; ``prior``
    adds a virtual fractional win both ways per pair so undefeated / winless
    models keep finite ratings. Ratings are centered (geometric mean strength 1
    -> mean Elo 0); differences are what matter: P(i beats j) =
    1 / (1 + 10^((elo_j - elo_i)/400)).
    """
    w = np.asarray(wins, float).copy()
    if draws is not None:
        w += np.asarray(draws, float) / 2.0
    n = w.shape[0]
    off = ~np.eye(n, dtype=bool)
    w[off] += prior
    np.fill_diagonal(w, 0.0)
    games = w + w.T
    p = np.ones(n)
    for _ in range(iters):
        denom = games / (p[:, None] + p[None, :])
        np.fill_diagonal(denom, 0.0)
        p_new = w.sum(axis=1) / denom.sum(axis=1)
        p_new /= np.exp(np.mean(np.log(p_new)))
        if np.max(np.abs(p_new - p)) < tol:
            p = p_new
            break
        p = p_new
    return 400.0 * np.log10(p)


def pair_seed(seed: int, pair: int) -> int:
    """The generator seed of match ``pair`` (= i*M + j) of a tournament seeded
    ``seed``: the seed in the high 32 bits, the pair in the low."""
    return (seed << 32) + pair


def run_tournament(model_paths, num_tracks: int = 20, num_runs: int = 2,
                   seed: int = 42, num_sensors: int = 11, max_steps: int = 3000,
                   deterministic: bool = False, device=None):
    """Full round robin: every ordered pair (i seat 0, j seat 1) plays the whole
    evaluation grid once, so each unordered pair is seen from both grid
    positions. Returns {models, names, wins, draws, elo, ranking}."""
    dev = resolve_device(device)
    bundles = [load_policy_bundle(p, dev) for p in model_paths]
    grid_track, _, _ = M.build_eval_grid(num_tracks, num_runs, seed, device=dev)
    m = len(model_paths)
    wins = np.zeros((m, m), int)
    draws = np.zeros((m, m), int)
    for i in range(m):
        for j in range(m):
            if i == j:
                continue
            generator = torch.Generator(device=dev).manual_seed(pair_seed(seed, i * m + j))
            wa, wb, d = play_match(bundles[i], bundles[j], grid_track, generator,
                                   num_sensors=num_sensors, max_steps=max_steps,
                                   deterministic=deterministic)
            wins[i, j] += wa
            wins[j, i] += wb
            draws[i, j] += d
            draws[j, i] += d
    elo = bradley_terry_elo(wins, draws)
    order = np.argsort(-elo)
    names = [os.path.basename(p) for p in model_paths]
    return {
        "models": list(model_paths),
        "names": names,
        "wins": wins.tolist(),
        "draws": draws.tolist(),
        "elo": [float(e) for e in elo],
        "ranking": [
            {"rank": r + 1, "name": names[i], "elo": float(elo[i]),
             "wins": int(wins[i].sum()), "losses": int(wins[:, i].sum()),
             "draws": int(draws[i].sum())}
            for r, i in enumerate(order)
        ],
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("models", nargs="+", help=".npz / .pth policy checkpoints")
    p.add_argument("--tracks", type=int, default=20)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--max-steps", type=int, default=3000)
    p.add_argument("--deterministic", action="store_true")
    p.add_argument("--out", default=None, help="JSON results path")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    if len(args.models) < 2:
        raise SystemExit("need at least 2 models for a tournament")

    results = run_tournament(args.models, num_tracks=args.tracks,
                             num_runs=args.runs, seed=args.seed,
                             max_steps=args.max_steps,
                             deterministic=args.deterministic, device=args.device)
    print(f"{'rank':>4}  {'elo':>7}  {'W':>5} {'L':>5} {'D':>5}  model")
    for row in results["ranking"]:
        print(f"{row['rank']:>4}  {row['elo']:>7.1f}  {row['wins']:>5} "
              f"{row['losses']:>5} {row['draws']:>5}  {row['name']}")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"results -> {args.out}")
    return results


if __name__ == "__main__":
    main()

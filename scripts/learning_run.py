#!/usr/bin/env python3
"""A learning run of the PyTorch port on the card: a ``train`` CLI, then the 40 x 5
evaluation of the policy it wrote.

  python scripts/learning_run.py [--kind scale|single] [--out DIR]

``--kind scale`` (the default) runs ``python -m self_play_racing_tpu_torch.train
scale --total-timesteps 50000000`` (the step count of the JAX package's 50M scale
agent), then what ``python -m self_play_racing_tpu_torch.evaluate --multi
models/self_play_agent_scale_1B.npz`` runs there, beside the JAX package's 50M-step
scale agent (``data/eval_info_self_play_scale_50M.json``). ``--kind single`` runs
``train single`` at its defaults (16 envs x 2048 steps, 5M steps), then what
``evaluate --single models/single_agent.npz`` runs, beside the JAX package's
single-car agent (``data/eval_info_single.json``). Both train in a temporary
working directory (the CLIs write ``models/`` and ``data/`` under it, which at the
repo's root are tracked files) and evaluate through ``evaluate.eval()`` on the 40 x
5 grid (seed 42, sampled), writing ``data/eval_info_<label>.json`` but no chart (the
CLI's chart needs matplotlib, which the card's machine lacks). Prints the card's
name and power limit, each command's wall seconds, the training curve's last
logged mean reward, and the evaluation's success rate and avg_steps beside the JAX
package's; with ``--out`` it copies the run's JSON files there. Exits 1 without a
card, and when the success rate is under 0.95 (the evaluation gate of
chip_smoke.py).
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
SUCCESS_FLOOR = 0.95
# kind: (train arguments, the model it writes, eval label and kind, JAX's record)
KINDS = {
    "scale": (["scale", "--total-timesteps", "50000000"], "self_play_agent_scale_1B.npz",
              ("self_play", "multi"), "eval_info_self_play_scale_50M.json"),
    "single": (["single"], "single_agent.npz", ("single", "single"), "eval_info_single.json"),
}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", choices=sorted(KINDS), default="scale")
    p.add_argument("--out", default=None, help="copy the run's JSON files here")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("learning_run: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    from self_play_racing_tpu_torch import evaluate

    train_args, model_name, (label, kind), jax_record = KINDS[args.kind]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-m", "self_play_racing_tpu_torch.train", *train_args],
                       cwd=tmp, env=env, check=True)
        train_s = time.perf_counter() - t0
        data = os.path.join(tmp, "data")
        model = os.path.join(tmp, "models", model_name)
        t0 = time.perf_counter()
        evaluate.eval({label: (kind, model)}, 40, 5, 42, out_dir=data, chart=None)
        eval_s = time.perf_counter() - t0
        with open(os.path.join(data, f"eval_info_{label}.json")) as f:
            info = json.load(f)
        curves = [n for n in os.listdir(data) if n.startswith("training_info")]
        with open(os.path.join(data, curves[0])) as f:
            curve = json.load(f)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            for name in os.listdir(data):
                if name.endswith(".json"):
                    shutil.copy(os.path.join(data, name), args.out)
    with open(os.path.join(REPO, "data", jax_record)) as f:
        jax_info = json.load(f)
    result = {
        "card": card,
        "command": ["train", *train_args],
        "train_seconds": train_s,
        "evaluate_seconds": eval_s,
        "last_mean_reward": curve["rewards"][-1] if curve.get("rewards") else None,
        "updates_logged": len(curve.get("steps", [])),
        "success_rate": info["success_rate"],
        "avg_steps": info["avg_steps"],
        "crash_rate": info["crash_rate"],
        "jax_record": jax_record,
        "jax_success_rate": jax_info["success_rate"],
        "jax_avg_steps": jax_info["avg_steps"],
    }
    print(json.dumps(result, indent=1))
    return 0 if info["success_rate"] >= SUCCESS_FLOOR else 1


if __name__ == "__main__":
    sys.exit(main())

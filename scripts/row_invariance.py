#!/usr/bin/env python3
"""Whether the self-play rollout's PyTorch ops give an env's row the same bits at
N / k rows as at N, on the card: what a data-parallel rank of 4096 / k envs needs
for its rollout to be bitwise the one-process rollout's rows.

  python scripts/row_invariance.py [--device cuda]

At N = 4096 and k = 2, 4 and 8, on seeded float32 inputs: each GEMM layer of the
learner's 19 -> 64 -> 64 -> {2, 1} MLP (``x @ w + b``), ``actor_mu``,
``critic_value``, ``sample_action`` (on the card one launch of the rollout policy's
kernel A, ``ops/policy.py``), the update's bootstrap value ``policy_value`` (kernel A's
critic on the card) at the default towers and at (256, 256), the opponent pool's
stacked actor
(``envs/selfplay._pool_actor_mu``, 5 members) and, on the card, the pool's kernel B
on a per-env index (``ops.policy.pool_act``), each called on the first N / k rows
and held against the same rows of the call on all N. Prints one JSON object: the
card, and per op and k whether the rows are bitwise equal and their max abs
difference.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from self_play_racing_tpu_torch._device import resolve_device  # noqa: E402
from self_play_racing_tpu_torch.envs import selfplay as sp  # noqa: E402
from self_play_racing_tpu_torch.models import actor_critic as net  # noqa: E402
from self_play_racing_tpu_torch.ops import policy as polops  # noqa: E402

N = 4096
SPLITS = (2, 4, 8)
OBS_DIM = 19
POOL = 5


def ops(dev):
    """name -> fn(rows) giving the op's output on the first ``rows`` rows."""
    gen = torch.Generator().manual_seed(0)
    params = net.init_params(gen, OBS_DIM, 2, device=dev)
    wide = net.init_params(gen, OBS_DIM, 2, hidden=(256, 256), device=dev)
    pool = {"actor": [(torch.stack([w] * POOL) * (1 + 0.1 * torch.arange(
        POOL, device=dev))[:, None, None], torch.stack([b] * POOL))
        for w, b in params["actor"]]}
    g = torch.Generator(device=dev).manual_seed(1)
    obs = torch.randn((N, OBS_DIM), generator=g, device=dev)
    noise = torch.randn((N, 2), generator=g, device=dev)
    log_std = torch.full((2,), -0.5, device=dev)
    hidden = torch.tanh(obs @ params["actor"][0][0] + params["actor"][0][1])
    out = {
        "layer 19x64": lambda r: obs[:r] @ params["actor"][0][0] + params["actor"][0][1],
        "layer 64x64": lambda r: hidden[:r] @ params["actor"][1][0] + params["actor"][1][1],
        "layer 64x2": lambda r: hidden[:r] @ params["actor"][2][0] + params["actor"][2][1],
        "layer 64x1": lambda r: hidden[:r] @ params["critic"][2][0] + params["critic"][2][1],
        "actor_mu": lambda r: net.actor_mu(params, obs[:r]),
        "critic_value": lambda r: net.critic_value(params, obs[:r]),
        "sample_action": lambda r: torch.cat([t.reshape(r, -1) for t in net.sample_action(
            params, log_std, obs[:r], noise[:r])], dim=1),
        "pool actor (5 members)": lambda r: sp._pool_actor_mu(pool, obs[:r]).transpose(0, 1),
        # the update's bootstrap value (on the card kernel A's critic), at the default
        # towers (the compiled route) and at (256, 256) (the general route)
        "policy_value": lambda r: polops.policy_value(params, obs[:r]),
        "policy_value at (256, 256)": lambda r: polops.policy_value(wide, obs[:r]),
    }
    if dev.type == "cuda":  # kernel B, on the card only
        member = torch.randint(0, POOL, (N,), generator=g, device=dev)
        pool_std = log_std.expand(POOL, 2).contiguous()
        out["pool_act (5 members, per env)"] = lambda r: polops.pool_act(
            pool["actor"], pool_std, obs[:r, None], noise[:r], member[:r])[:, 0]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = "cpu" if dev.type != "cuda" else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={dev.index or 0}"], check=True, capture_output=True, text=True).stdout.strip()
    result = {}
    with torch.no_grad():
        for name, fn in ops(dev).items():
            full = fn(N)
            for k in SPLITS:
                part = fn(N // k)
                diff = float((part - full[:N // k]).abs().max())
                result[f"{name}, {N // k} of {N} rows"] = {
                    "bitwise": bool(torch.equal(part, full[:N // k])), "max_abs": diff}
    print(json.dumps({"card": card, "rows": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

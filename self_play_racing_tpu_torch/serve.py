"""Inference/serving: a minimal deployable policy (port of
``self_play_racing_tpu/serve.py``).

Loads a ``.npz`` policy or a ``.pth`` state dict onto the card and serves
deterministic or sampled actions for batches of observations.
``python -m self_play_racing_tpu_torch.serve --model ... --bench`` reports latency
and throughput across batch sizes on the card, host-to-host (numpy in, numpy out).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ._device import resolve_device
from .envs import normalize as obsnorm
from .evaluate import load_policy_bundle
from .models import actor_critic as net


class Policy:
    """Stateless policy server around a checkpoint. Sampled mode draws noise from
    a generator on the policy's device, seeded with 0."""

    def __init__(self, model_path: str, deterministic: bool = True, device=None):
        self.device = resolve_device(device)
        self.params, self.log_std, self.obs_norm = load_policy_bundle(
            model_path, self.device)
        self.deterministic = deterministic
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    @property
    def obs_dim(self) -> int:
        return self.params["actor"][0][0].shape[0]

    def _input(self, obs):
        x = torch.as_tensor(np.asarray(obs, np.float32), device=self.device)
        if self.obs_norm is not None:
            x = obsnorm.apply(self.obs_norm, x)
        return x

    @torch.no_grad()
    def act(self, obs) -> np.ndarray:
        """obs: [batch, obs_dim] (or [obs_dim]) -> actions in [-1, 1]."""
        x = self._input(obs)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if self.deterministic:
            a = net.deterministic_action(self.params, x)
        else:
            noise = net.sample_noise((x.shape[0], self.log_std.shape[-1]),
                                     self.generator, dtype=self.log_std.dtype,
                                     device=self.device)
            a, _, _ = net.sample_action(self.params, self.log_std, x, noise)
        a = a.cpu().numpy()
        return a[0] if squeeze else a

    @torch.no_grad()
    def value(self, obs) -> np.ndarray:
        return net.critic_value(self.params, self._input(obs)).cpu().numpy()


def bench(policy: Policy, obs_dim: int = None, batches=(1, 64, 1024, 8192), reps=20):
    """Mean latency of ``reps`` calls per batch size, after one warm-up
    call; each call copies numpy in and out, so it ends synchronized."""
    obs_dim = obs_dim or policy.obs_dim
    rng = np.random.default_rng(0)
    rows = []
    for b in batches:
        obs = rng.standard_normal((b, obs_dim)).astype(np.float32)
        policy.act(obs)  # warm-up
        t0 = time.perf_counter()
        for _ in range(reps):
            policy.act(obs)
        dt = (time.perf_counter() - t0) / reps
        rows.append({"batch": b, "latency_ms": dt * 1e3, "actions_per_s": b / dt})
        print(f"batch {b:6d}: {dt*1e3:8.3f} ms  {b/dt:,.0f} actions/s")
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", required=True)
    p.add_argument("--bench", action="store_true")
    p.add_argument("--obs-dim", type=int, default=None,
                   help="default: the policy's input width")
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    policy = Policy(args.model, device=args.device)
    if policy.device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(policy.device)}")
    if args.bench:
        bench(policy, args.obs_dim)


if __name__ == "__main__":
    main()

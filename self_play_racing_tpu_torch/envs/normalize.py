"""Running observation normalization (port of ``self_play_racing_tpu/envs/normalize.py``).

Batched Welford-style running mean/variance, merged once per vector step for the
whole [num_envs, obs_dim] batch, and applied to the policy's input with a +-10 clip.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class ObsNormState:
    mean: torch.Tensor   # [D]
    var: torch.Tensor    # [D]
    count: torch.Tensor  # scalar


def init(obs_dim: int, dtype=torch.float32, device=None) -> ObsNormState:
    return ObsNormState(
        mean=torch.zeros((obs_dim,), dtype=dtype, device=device),
        var=torch.ones((obs_dim,), dtype=dtype, device=device),
        count=torch.tensor(1e-4, dtype=dtype, device=device),
    )


def update(state: ObsNormState, obs) -> ObsNormState:
    """Merge one [N, D] batch into the running statistics (parallel Welford)."""
    batch_mean = obs.mean(dim=0)
    batch_var = obs.var(dim=0, correction=0)
    batch_count = torch.full_like(state.count, obs.shape[0])

    delta = batch_mean - state.mean
    tot = state.count + batch_count
    new_mean = state.mean + delta * batch_count / tot
    m_a = state.var * state.count
    m_b = batch_var * batch_count
    m2 = m_a + m_b + delta * delta * state.count * batch_count / tot
    return ObsNormState(mean=new_mean, var=m2 / tot, count=tot)


def apply(state: ObsNormState, obs, clip: float = 10.0, eps: float = 1e-8):
    """Normalized and clipped observations."""
    out = (obs - state.mean) / torch.sqrt(state.var + eps)
    return torch.clamp(out, -clip, clip)

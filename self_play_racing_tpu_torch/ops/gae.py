"""Generalized Advantage Estimation as a reverse-time recurrence (port of
``self_play_racing_tpu/ops/gae.py``).

CleanRL-style GAE with bootstrap from ``next_value``/``next_done``:
``dones[t]`` is the done flag *entering* step t, so the mask of step t is
``1 - dones[t + 1]`` (``1 - next_done`` for the last step); truncation is treated as
termination; ``returns = advantages + values``.

The reference's floating-point order is kept exactly: ``gamma`` and
``gamma * lam`` are rounded once to the rewards' dtype (the product taken in
Python's float64 first), ``delta = rewards + (g * nt) * v_next - values`` left to
right, and ``adv = delta + (gl * nt) * adv_next`` carried backwards one step at a
time. Mixed dtypes promote as in the reference (float32 rewards with float64
values give float64 advantages).

``compute_gae`` (K6) dispatches on the device of ``rewards``: a CPU tensor takes
the plain PyTorch version, a CUDA tensor launches the hand-written kernel
(``csrc/gae.cu``) or raises. ``compute_gae_launches`` counts kernel launches.
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .geometry import _on_cuda

compute_gae_launches = 0


def compute_gae(rewards, dones, values, next_value, next_done, gamma: float, lam: float):
    """rewards/dones/values: [T, N]; next_value/next_done: [N].

    Returns (advantages, returns), both [T, N].
    """
    global compute_gae_launches
    if not _on_cuda(rewards, "compute_gae"):
        return compute_gae_plain(rewards, dones, values, next_value, next_done, gamma, lam)
    out = _compute_gae_cuda(rewards, dones, values, next_value, next_done, gamma, lam)
    compute_gae_launches += 1
    return out


def compute_gae_plain(rewards, dones, values, next_value, next_done, gamma: float,
                      lam: float):
    """Plain PyTorch K6: the whole-array ``delta`` pass, then a Python loop over
    time for the carry."""
    dtype = rewards.dtype
    g = torch.tensor(gamma, dtype=dtype, device=rewards.device)
    gl = torch.tensor(gamma * lam, dtype=dtype, device=rewards.device)
    nonterminal_next = 1.0 - torch.cat(
        [dones[1:].to(dtype), next_done.to(dtype)[None]], dim=0)
    value_next = torch.cat([values[1:], next_value[None]], dim=0)
    deltas = rewards + g * nonterminal_next * value_next - values
    advs = torch.empty_like(deltas)
    running = torch.zeros_like(next_value)
    for t in range(rewards.shape[0] - 1, -1, -1):
        running = deltas[t] + gl * nonterminal_next[t] * running
        advs[t] = running
    return advs, advs + values


def _compute_gae_cuda(rewards, dones, values, next_value, next_done, gamma, lam):
    """K6 on the card: float32 rewards/values, bool dones, all contiguous."""
    dev = rewards.device
    floats = (rewards, values, next_value)
    for t in floats + (dones, next_done):
        if t.device != dev:
            raise ValueError(f"compute_gae: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("compute_gae: inputs must be contiguous")
    if any(t.dtype != torch.float32 for t in floats):
        raise TypeError("compute_gae: the CUDA kernel takes float32 rewards and values, "
                        f"got {[t.dtype for t in floats]}")
    if dones.dtype != torch.bool or next_done.dtype != torch.bool:
        raise TypeError("compute_gae: the CUDA kernel takes bool dones")
    if rewards.ndim != 2:
        raise ValueError(f"compute_gae: rewards must be [T, N], got {tuple(rewards.shape)}")
    steps, n = rewards.shape
    if (values.shape != rewards.shape or dones.shape != rewards.shape
            or next_value.shape != (n,) or next_done.shape != (n,)):
        raise ValueError("compute_gae: shapes must be [T, N] x 3 and [N] x 2")
    adv = torch.empty_like(rewards)
    ret = torch.empty_like(rewards)
    with torch.cuda.device(dev):
        _cuda.launch_compute_gae(rewards, dones, values, next_value, next_done, adv, ret,
                                 steps, n, float(np.float32(gamma)),
                                 float(np.float32(gamma * lam)))
    return adv, ret

"""A CPU model of the rollout policy's two kernels (``csrc/policy.cu``), in float32
PyTorch operations in the kernels' order, taking the tensors that
``ops/_cuda.py:launch_policy_act`` and ``launch_pool_act`` turn into pointers.

Tests patch it in for the launches, so that the wrappers of ``ops/policy.py`` (the
argument checks, the pointer order, the buffers, the row maps) run on the CPU; the
towers are the plain composition here (the kernels' own sums are held to it on the
card, chip_smoke.py phase q). The arguments are checked as the C entry points check
them, raising ``RuntimeError`` where those return ``cudaErrorInvalidValue``.
"""
import math

import torch

from self_play_racing_tpu_torch.models import actor_critic as net
from self_play_racing_tpu_torch.ops import _cuda

LOW = (-1.0, 0.0)
HIGH = (1.0, 1.0)
calls = {"policy_act": 0, "pool_act": 0}


def _invalid(what):
    raise RuntimeError(f"cudaErrorInvalidValue: {what}")


def _normalise(x, mean, var, eps, clip):
    return torch.clamp((x - mean) / torch.sqrt(var + eps), -clip, clip)


def log_prob(action, mu, log_std, half_log_2pi):
    """normal_lp.cuh: ((-(d * d) / (2 exp(2 log_std)) - log_std) - c) a dimension,
    then (a + b) + 0."""
    den = 2.0 * torch.exp(2.0 * log_std)
    d = action - mu
    terms = (-(d * d) / den - log_std) - half_log_2pi
    return (terms[..., 0] + terms[..., 1]) + 0.0


def policy_act(ptrs, n, steps, stride, dims, consts):
    """``policy_act_f32`` on the tensors ``ptrs`` (``ops/_cuda.py``'s order)."""
    calls["policy_act"] += 1
    if len(ptrs) != _cuda.POLICY_ACT_PTRS or len(consts) != 3 or n < 0 or steps < 1:
        _invalid("counts")
    obs, t, noise, mean, var, log_std = ptrs[:6]
    w = ptrs[6:18]
    action, obs_rows, action_rows, lp_rows, v_rows = ptrs[18:]
    d = dims[0]
    if stride < d or _cuda.policy_shared_bytes(False, *dims) == 0:
        _invalid("shape")
    actor, critic = w[:6], w[6:]
    if any(x is None for x in actor) or (any(x is None for x in critic)
                                         and any(x is not None for x in critic)):
        _invalid("towers")
    has_critic = critic[0] is not None
    if (mean is None) != (var is None) or (noise is not None and log_std is None) \
            or (lp_rows is not None and noise is None) or (v_rows is not None and not has_critic) \
            or (action is None and action_rows is None):
        _invalid("outputs")
    if n == 0:
        return
    eps, clip, c = consts
    x = torch.as_strided(obs, (n, d), (stride, 1))
    if mean is not None:
        x = _normalise(x, mean, var, eps, clip)
    row = 0 if t is None else int(t[0])
    if not 0 <= row < steps:
        _invalid("t")
    pairs = lambda ts: [(ts[i], ts[i + 1]) for i in range(0, 6, 2)]
    mu = net.actor_mu({"actor": pairs(actor)}, x)
    act = mu
    if noise is not None:
        nz = noise.reshape(steps, n, 2)[row]
        act = torch.clamp(mu + torch.exp(log_std) * nz, -1.0, 1.0)
        if lp_rows is not None:
            lp_rows.view(steps, n)[row] = log_prob(act, mu, log_std, c)
    if obs_rows is not None:
        obs_rows.view(steps, n, d)[row] = x
    if action is not None:
        action.copy_(act)
    if action_rows is not None:
        action_rows.view(steps, n, 2)[row] = act
    if v_rows is not None:
        v_rows.view(steps, n)[row] = net.critic_value({"critic": pairs(critic)}, x)


def pool_act(ptrs, rows, seats, cars, off, env_stride, members, kind, member64, use_per_env,
             dims, consts):
    """``pool_act_f32`` on the tensors ``ptrs`` (``ops/_cuda.py``'s order)."""
    calls["pool_act"] += 1
    d = dims[0]
    if len(ptrs) != _cuda.POOL_ACT_PTRS or len(consts) != 6 or rows < 0 or seats < 1 \
            or off < 0 or off + seats > cars or env_stride < seats * d or members < 1 \
            or _cuda.policy_shared_bytes(True, *dims) == 0:
        _invalid("shape")
    obs, *w = ptrs[:7]
    log_std, mean, var, member, noise, uniforms, use, first, out = ptrs[7:]
    if (mean is None) != (var is None) or (noise is not None and log_std is None) \
            or ((kind == _cuda.POOL_SEAT) != (member is None)) \
            or (kind == _cuda.POOL_SEAT and members != cars) \
            or (uniforms is not None and use is None) or (first is not None and off != 1):
        _invalid("arguments")
    if rows == 0:
        return
    eps, clip, low0, low1, high0, high1 = consts
    envs = rows // seats
    x = torch.as_strided(obs, (envs, seats, d), (env_stride, d, 1)).reshape(rows, d)
    r = torch.arange(rows)
    env, seat = r // seats, off + r % seats
    if kind == _cuda.POOL_SEAT:
        m = seat
    else:
        m = member.long().reshape(-1)[env if kind == _cuda.POOL_PER_ENV else 0 * env]
    if bool(((m < 0) | (m >= members)).any()):
        _invalid("member")
    if mean is not None:
        x = _normalise(x, mean[m], var[m], eps, clip)
    mu = torch.empty((rows, 2), dtype=torch.float32)
    for p in range(members):
        sel = m == p
        layers = [(w[i][p], w[i + 1][p]) for i in range(0, 6, 2)]
        mu[sel] = net.actor_mu({"actor": layers}, x[sel])
    act = mu
    if noise is not None:
        act = torch.clamp(mu + torch.exp(log_std)[m] * noise, -1.0, 1.0)
    if uniforms is not None:
        low = torch.tensor([low0, low1])
        high = torch.tensor([high0, high1])
        rand = torch.maximum(low, uniforms * (high - low) + low)
        u = use.reshape(-1)[env if use_per_env else 0 * env]
        act = torch.where(u[:, None], act, rand)
    flat = out.reshape(-1, 2)
    flat[env * cars + seat] = act
    if first is not None:
        firsts = r[r % seats == 0] // seats
        flat[firsts * cars] = first[firsts]


def patch(monkeypatch, on_cpu_kernels: bool = True):
    """The launches through this model; with ``on_cpu_kernels`` the wrappers take the
    kernels' route on CPU tensors too (``whole_towers``), as they take it on the card,
    and ``torch.cuda.device`` is a no-op."""
    import contextlib

    from self_play_racing_tpu_torch.envs import selfplay
    from self_play_racing_tpu_torch.ops import policy as polops

    monkeypatch.setattr(_cuda, "launch_policy_act", policy_act)
    monkeypatch.setattr(_cuda, "launch_pool_act", pool_act)
    if on_cpu_kernels:
        monkeypatch.setattr(polops, "_on_cuda", lambda t, name: True)
        monkeypatch.setattr(selfplay, "_on_cuda", lambda t, name: True)
        monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())


HALF_LOG_2PI = float(torch.tensor(0.5 * math.log(2.0 * math.pi), dtype=torch.float32))

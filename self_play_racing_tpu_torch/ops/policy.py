"""The rollout step's policy as two hand-written kernels (``csrc/policy.cu``).

The JAX package samples the learner's action and the frozen opponents' actions
inside the rollout program that XLA compiles for the TPU (``one_step``,
``self_play_racing_tpu/agent/ppo.py:354``; ``sample_action`` and
``deterministic_action``, ``models/actor_critic.py:99`` and ``:118``;
``opponent_actions``, ``envs/selfplay.py:53``; the normaliser,
``envs/normalize.py:49``). In PyTorch each is a chain of cuBLAS GEMMs, bias adds,
``tanh`` and elementwise launches. Here:

- ``policy_act_f32`` (kernel A) runs whole towers (the critic may be absent) on a
  tile of observations, applies the frozen normaliser first where one is given, and
  writes the action (greedy: mu; sampled: ``clamp(mu + exp(log_std) * noise, -1,
  1)``) and, sampled, its log-prob, and the critic's value. ``rollout_sample`` is
  the rollout step's policy in one launch: it reads noise row ``t`` (``t`` on the
  card) and writes row ``t`` of the rollout's obs, actions, log-probs and values
  buffers; ``sample_action``, ``policy_action`` and ``deterministic_action`` are
  the same kernel outside the rollout. Its towers are ``mlp_forward_f32``'s device
  code (``csrc/mlp_tower.cuh``) and its log-prob ``ppo_head``'s
  (``csrc/normal_lp.cuh``), so the first minibatch of an update recomputes the
  rollout's log-prob bitwise.
- ``pool_act_f32`` (kernel B) runs a pool of stacked actor towers [P, in, out] on
  env-major rows: a row's member from an [envs] index, a 0-d index or its seat; each
  member's frozen normaliser and ``exp(log_std)``; then the uniform random action
  and the ``use_policy`` select; out [envs, cars, 2] with the learner's action as
  car 0 where given (``pool_act``).

Dispatch, as every kernel of the port: ``whole_towers`` (a CUDA tensor and whole
towers) takes the kernels; a CUDA tensor they do not take (not float32, not
contiguous where they read it contiguous, other widths) raises, with no fallback.
The CPU, and a tensor-parallel rank's ``ShardedParams`` (the Megatron composition,
as ``ops/mlp.py`` keeps it), take the plain versions, which stay in their modules:
``models/actor_critic.py:sample_action_plain`` and ``deterministic_action_plain``,
``envs/selfplay.py:opponent_actions_plain``, ``agent/ppo.py``'s rollout step body,
``utils/metrics.py:_seat_actions_plain`` and ``policy_action_plain`` below. The
towers' sums run in another order than cuBLAS's, so mu and v are held to the
composition within a stated tolerance (chip_smoke.py phase q); everything after
them is bitwise the composition on the kernels' own mu.

``policy_act_launches`` and ``pool_act_launches`` count kernel launches (plain
integers, incremented only where a kernel launched).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda
from .geometry import _on_cuda
from .minibatch import _check_cuda
from ..envs import normalize as obsnorm
from ..models import actor_critic as net

policy_act_launches = 0
pool_act_launches = 0

# envs/normalize.py:apply's defaults
NORM_CLIP = 10.0
NORM_EPS = 1e-8
_TOWER = 6


def _f32(value: float) -> float:
    """``value`` as PyTorch rounds a Python scalar for a float32 op."""
    return float(np.float32(value))


@functools.lru_cache(maxsize=None)
def _act_constants():
    """policy_act's float32 constants (eps, clip, 0.5 log 2 pi), rounded as PyTorch
    rounds the composition's Python scalars."""
    return _f32(NORM_EPS), _f32(NORM_CLIP), _f32(0.5 * math.log(2.0 * math.pi))


def whole_towers(params, obs) -> bool:
    """Whether ``params`` on ``obs`` take the kernels: a CUDA tensor and whole towers.
    The CPU and a tensor-parallel rank's slices (``params.tp``) take the plain
    versions."""
    return getattr(params, "tp", None) is None and _on_cuda(obs, "policy")


def _layers(params, tower: str) -> list:
    return [t for layer in params.get(tower) or () for t in layer]


def _tower_dims(leaves, outputs: int, name: str, stacked: int = 0):
    """(D, h1, h2) of one tower's six tensors of ``outputs`` outputs (with ``stacked``
    P > 0, each with a leading axis of P), or a raise."""
    shapes = [tuple(t.shape) for t in leaves]
    lead = (stacked,) if stacked else ()
    d, h1 = shapes[0][-2:] if len(shapes) == _TOWER and len(shapes[0]) == 2 + bool(stacked) \
        else (None, None)
    h2 = shapes[2][-1] if len(shapes) == _TOWER and shapes[2] else None
    want = [lead + s for s in ((d, h1), (h1,), (h1, h2), (h2,), (h2, outputs), (outputs,))]
    if shapes != want or d is None or _cuda.policy_shared_bytes(bool(stacked), d, h1, h2) == 0:
        takes = ", ".join(str(h) for h in _cuda.MLP_HIDDEN)
        raise ValueError(f"{name}: the kernel takes towers of three layers with {outputs} "
                         f"outputs at hidden {takes}, whose weights fit a block; got tensors "
                         f"{shapes}")
    return d, h1, h2


def _check_obs(name: str, obs, d: int) -> None:
    if obs.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32 observations, got {obs.dtype}")
    if obs.ndim != 2 or obs.shape[1] != d or (obs.shape[0] > 1 and obs.stride(0) < d) \
            or (d > 1 and obs.stride(1) != 1):
        raise ValueError(f"{name}: obs {tuple(obs.shape)} at strides {obs.stride()}, expected "
                         f"[n, {d}] with each row contiguous")


def _norm_tensors(norm, dev, d: int, name: str):
    """(mean, var) of an ``ObsNormState`` (or None) as the kernel reads them."""
    if norm is None:
        return None, None
    mean, var = norm.mean, norm.var
    _check_cuda(name, dev, (mean, var))
    if mean.shape != (d,) or var.shape != (d,):
        raise ValueError(f"{name}: normaliser {tuple(mean.shape)}, {tuple(var.shape)}, "
                         f"expected [{d}]")
    return mean, var


def _launch_act(name, params, obs, log_std=None, noise=None, norm=None, t=None, steps=1,
                action=None, obs_rows=None, action_rows=None, logprob_rows=None,
                value_rows=None, critic=True) -> None:
    """One launch of ``policy_act_f32`` with its arguments checked: the towers of
    ``params`` (the critic's where ``critic`` and present), ``obs`` [n, D] (rows at
    any stride, each contiguous), ``noise`` [steps, n, 2] or [n, 2] (None: greedy)
    with ``log_std`` [2], ``norm`` an ``ObsNormState`` or None, ``t`` int64 [1] on
    the card (None: row 0), and the outputs (None: not written)."""
    global policy_act_launches
    dev = obs.device
    actor = _layers(params, "actor")
    d, h1, h2 = _tower_dims(actor, 2, name)
    critic_leaves = _layers(params, "critic") if critic else []
    if critic_leaves and _tower_dims(critic_leaves, 1, name) != (d, h1, h2):
        raise ValueError(f"{name}: the critic's towers differ from the actor's")
    _check_obs(name, obs, d)
    n = obs.shape[0]
    _check_cuda(name, dev, actor + critic_leaves)
    mean, var = _norm_tensors(norm, dev, d, name)
    if noise is not None:
        _check_cuda(name, dev, (noise, log_std))
        if noise.shape[-2:] != (n, 2) or noise.numel() != steps * n * 2 or log_std.shape != (2,):
            raise ValueError(f"{name}: noise {tuple(noise.shape)} and log_std "
                             f"{tuple(log_std.shape)}, expected [{steps}, {n}, 2] and [2]")
    if t is not None:
        _check_cuda(name, dev, (t,), torch.int64)
        if t.shape != (1,):
            raise ValueError(f"{name}: t {tuple(t.shape)}, expected [1]")
    outs = [action, obs_rows, action_rows, logprob_rows, value_rows]
    _check_cuda(name, dev, [o for o in outs if o is not None])
    if n == 0:
        return
    ptrs = ([obs, t, noise, mean, var, log_std if noise is not None else None] + actor
            + (critic_leaves or [None] * _TOWER) + outs)
    with torch.cuda.device(dev):
        _cuda.launch_policy_act(ptrs, n, steps, obs.stride(0) if n > 1 else d, (d, h1, h2),
                                _act_constants())
    policy_act_launches += 1


def sample_action(params, log_std, obs, noise):
    """``net.sample_action`` on the card, one launch: (action [n, 2], log-prob [n],
    value [n], None where ``params`` has no critic)."""
    n = obs.shape[0]
    critic = bool(_layers(params, "critic"))
    action = obs.new_empty((n, 2))
    logprob = obs.new_empty((n,))
    value = obs.new_empty((n,)) if critic else None
    _launch_act("sample_action", params, obs, log_std, noise, action=action,
                logprob_rows=logprob, value_rows=value, critic=critic)
    return action, logprob, value


def deterministic_action(params, obs):
    """``net.deterministic_action`` on the card: the actor's mu, one launch."""
    action = obs.new_empty((obs.shape[0], 2))
    _launch_act("deterministic_action", params, obs, action=action, critic=False)
    return action


def policy_action(params, log_std, obs, noise=None, norm=None):
    """The policy's action on ``obs``, normalised first by ``norm`` (an
    ``ObsNormState``) where given: greedy (tanh mu) when ``noise`` is None, else
    sampled with that standard-normal noise. The actor alone (a bundle without a
    critic is taken); on the card one launch of kernel A."""
    if not whole_towers(params, obs):
        return policy_action_plain(params, log_std, obs, noise, norm)
    action = obs.new_empty((obs.shape[0], 2))
    _launch_act("policy_action", params, obs, log_std, noise, norm, action=action,
                critic=False)
    return action


def policy_action_plain(params, log_std, obs, noise=None, norm=None):
    """Plain PyTorch ``policy_action``: ``obsnorm.apply``, then
    ``net.deterministic_action_plain`` or ``net.sample_action_plain``'s action."""
    if norm is not None:
        obs = obsnorm.apply(norm, obs)
    if noise is None:
        return net.deterministic_action_plain(params, obs)
    return net.sample_action_plain(params, log_std, obs, noise)[0]


ROLLOUT_FIELDS = ("obs", "actions", "logprobs", "values")


def rollout_buffers(out: dict, steps: int, obs) -> dict:
    """The rollout's obs, actions, log-probs and values buffers in ``out`` ([steps,
    n, ...], float32 on ``obs``'s device), made where missing."""
    n, d = obs.shape
    shapes = {"obs": (steps, n, d), "actions": (steps, n, 2), "logprobs": (steps, n),
              "values": (steps, n)}
    for k in ROLLOUT_FIELDS:
        if k not in out:
            out[k] = obs.new_empty(shapes[k], dtype=torch.float32)
    return out


def rollout_sample(params, log_std, obs, noise, t, norm, out: dict):
    """The rollout step's policy in one launch of kernel A: ``obs`` [n, D] normalised
    by ``norm`` (None: as it is), both towers, noise row ``t`` of ``noise`` [T, n, 2]
    (``t`` int64 [1] on the card), the sample and its log-prob; writes row ``t`` of
    ``out``'s obs, actions, log-probs and values ([T, n, ...], made by
    ``rollout_buffers`` where missing) and returns the action [n, 2] (the env's)."""
    steps = noise.shape[0]
    rollout_buffers(out, steps, obs)
    action = obs.new_empty((obs.shape[0], 2))
    _launch_act("rollout_sample", params, obs, log_std, noise, norm, t, steps, action=action,
                obs_rows=out["obs"], action_rows=out["actions"],
                logprob_rows=out["logprobs"], value_rows=out["values"])
    return action


def _member_index(member, dev, envs: int, name: str):
    """(tensor, kind, int64) of an opponent index: [envs] (per env) or 0-d (one for
    all), int32 or int64 on the card."""
    member = torch.as_tensor(member, device=dev)
    if member.dtype not in (torch.int32, torch.int64) or member.ndim > 1 \
            or (member.ndim == 1 and member.shape[0] != envs) or not member.is_contiguous():
        raise ValueError(f"{name}: an opponent index int32 or int64, [{envs}] or 0-d; got "
                         f"{member.dtype} {tuple(member.shape)}")
    kind = _cuda.POOL_ONE if member.ndim == 0 else _cuda.POOL_PER_ENV
    return member.reshape(-1), kind, member.dtype == torch.int64


def pool_act(actor, log_std, obs, noise=None, member=None, mean=None, var=None,
             uniforms=None, use_policy=None, low=None, high=None, first=None):
    """A pool of frozen actors on the card, one launch of kernel B.

    ``actor``: the pool's actor layers, stacked [(w [P, in, out], b [P, out])] * 3;
    ``log_std`` [P, 2]; ``obs`` [envs, seats, D] (seat and feature axes contiguous,
    envs at any stride: a view of the env's [envs, cars, D] observations), row r of
    the launch seat r % seats of env r // seats; ``member`` the rows' members: an
    [envs] index, a 0-d index (one member for all), or None for seat mode (seat s is
    member s, P = seats); ``mean``/``var`` [P, D] each member's frozen normaliser or
    None; ``noise`` [envs * seats, 2] (None: greedy); ``uniforms`` [envs * seats, 2]
    with ``use_policy`` ([envs] or 0-d bool) and the bounds ``low``/``high`` (two
    floats each): where ``use_policy`` is False the action is ``maximum(low, u * (high
    - low) + low)``. Returns the actions [envs, seats, 2], or with ``first`` [envs, 2]
    (the learner's) [envs, 1 + seats, 2] with ``first`` as car 0."""
    global pool_act_launches
    name = "pool_act"
    dev = obs.device
    leaves = [t for layer in actor for t in layer]
    members = leaves[0].shape[0] if leaves and leaves[0].ndim == 3 else 0
    d, h1, h2 = _tower_dims(leaves, 2, name, stacked=members)
    _check_cuda(name, dev, leaves)
    if obs.dtype != torch.float32 or obs.ndim != 3 or obs.shape[2] != d \
            or (obs.shape[2] > 1 and obs.stride(2) != 1) \
            or (obs.shape[1] > 1 and obs.stride(1) != d) \
            or (obs.shape[0] > 1 and obs.stride(0) < obs.shape[1] * d):
        raise ValueError(f"{name}: obs {obs.dtype} {tuple(obs.shape)} at strides "
                         f"{obs.stride()}, expected float32 [envs, seats, {d}] with its "
                         f"seats' rows contiguous")
    envs, seats = obs.shape[:2]
    rows = envs * seats
    if member is None:
        if members != seats:
            raise ValueError(f"{name}: seat mode takes a member a seat: {members} members, "
                             f"{seats} seats")
        index, kind, wide = None, _cuda.POOL_SEAT, False
    else:
        index, kind, wide = _member_index(member, dev, envs, name)
    if noise is not None:
        _check_cuda(name, dev, (noise, log_std))
        if noise.shape != (rows, 2) or log_std.shape != (members, 2):
            raise ValueError(f"{name}: noise {tuple(noise.shape)}, log_std "
                             f"{tuple(log_std.shape)}; expected [{rows}, 2], [{members}, 2]")
    if (mean is None) != (var is None):
        raise ValueError(f"{name}: the normaliser needs its mean and var")
    if mean is not None:
        _check_cuda(name, dev, (mean, var))
        if mean.shape != (members, d) or var.shape != (members, d):
            raise ValueError(f"{name}: normaliser {tuple(mean.shape)}, {tuple(var.shape)}, "
                             f"expected [{members}, {d}]")
    use = None
    if uniforms is not None:
        _check_cuda(name, dev, (uniforms,))
        use = torch.as_tensor(use_policy, device=dev)
        if uniforms.shape != (rows, 2) or use.dtype != torch.bool or use.ndim > 1 \
                or (use.ndim == 1 and use.shape[0] != envs) or not use.is_contiguous():
            raise ValueError(f"{name}: uniforms {tuple(uniforms.shape)} and use_policy "
                             f"{use.dtype} {tuple(use.shape)}, expected [{rows}, 2] and "
                             f"bool [{envs}] or 0-d")
    if first is not None:
        _check_cuda(name, dev, (first,))
        if first.shape != (envs, 2):
            raise ValueError(f"{name}: first {tuple(first.shape)}, expected [{envs}, 2]")
    cars = seats + (first is not None)
    out = obs.new_empty((envs, cars, 2))
    if rows == 0:
        return out
    consts = (_f32(NORM_EPS), _f32(NORM_CLIP), *((0.0, 0.0, 0.0, 0.0) if low is None else
                                                  (*map(_f32, low), *map(_f32, high))))
    ptrs = [obs, *leaves, log_std if noise is not None else None, mean, var, index, noise,
            uniforms, use, first, out]
    with torch.cuda.device(dev):
        _cuda.launch_pool_act(ptrs, rows, seats, cars, int(first is not None),
                              obs.stride(0) if envs > 1 else seats * d, members, kind, wide,
                              use is not None and use.ndim == 1, (d, h1, h2), consts)
    pool_act_launches += 1
    return out

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
  row's tower once, under its member, and none where ``use_policy`` is False; each
  member's frozen normaliser and ``exp(log_std)``; then the uniform random action
  and the ``use_policy`` select; out [envs, cars, 2] with the learner's action as
  car 0 where given (``pool_act``).

Dispatch, as every kernel of the port: ``whole_towers`` (a CUDA tensor and whole
towers) takes the kernels; a CUDA tensor they do not take (not float32, not
contiguous where they read it contiguous, towers past the general route's limits)
raises, with no fallback.
The CPU, and a tensor-parallel rank's ``ShardedParams`` (the Megatron composition,
as ``ops/mlp.py`` keeps it), take the plain versions, which stay in their modules:
``models/actor_critic.py:sample_action_plain`` and ``deterministic_action_plain``,
``envs/selfplay.py:opponent_actions_plain``, ``agent/ppo.py``'s rollout step body,
``utils/metrics.py:_seat_actions_plain`` and ``policy_action_plain`` below. The
towers' sums run in another order than cuBLAS's, so mu and v are held to the
composition within a stated tolerance (chip_smoke.py phase q); everything after
them is bitwise the composition on the kernels' own mu.

Each kernel has two routes (``_cuda.mlp_route``, one for a tower in all four MLP
kernels): the compiled one above (three layers at ``_cuda.MLP_HIDDEN``), and the
general one, ``csrc/policy_general.cu``'s ``policy_general_act_f32`` and
``policy_general_pool_f32``, for towers of 1 to ``_cuda.MLP_MAX_HIDDEN_LAYERS`` hidden
layers and widths and obs_dim 1 to ``_cuda.MLP_MAX_WIDTH``: the same arguments and
outputs, the towers run by ``csrc/mlp_stream.cuh``'s per-element routine, so that mu
and v are bitwise ``ops/mlp.py``'s general forward's.

``policy_act_launches`` and ``pool_act_launches`` (the compiled route),
``policy_general_act_launches`` and ``pool_general_act_launches`` (the general route)
count kernel launches (plain integers, incremented only where a kernel launched).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda
from .geometry import _on_cuda
from .minibatch import _check_cuda
from .mlp import tower_shapes
from ..envs import normalize as obsnorm
from ..models import actor_critic as net

policy_act_launches = 0
pool_act_launches = 0
policy_general_act_launches = 0
pool_general_act_launches = 0

# envs/normalize.py:apply's defaults
NORM_CLIP = 10.0
NORM_EPS = 1e-8


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
    """(D, *hidden) of one tower's 2 (L + 1) tensors of ``outputs`` outputs (with
    ``stacked`` P > 0, each with a leading axis of P) that a route of the kernels
    takes (``_cuda.mlp_route``), or a raise."""
    dims = tower_shapes(leaves, outputs, stacked)
    if dims is None:
        raise ValueError(f"{name}: the kernel takes towers obs_dim -> hidden -> {outputs} "
                         f"outputs; got tensors {[tuple(t.shape) for t in leaves]}")
    _cuda.mlp_route(dims[0], dims[1:])  # raises past the general route's limits
    return dims


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
    global policy_act_launches, policy_general_act_launches
    dev = obs.device
    actor = _layers(params, "actor")
    dims = _tower_dims(actor, 2, name)
    d = dims[0]
    critic_leaves = _layers(params, "critic") if critic else []
    if critic_leaves and _tower_dims(critic_leaves, 1, name) != dims:
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
            + (critic_leaves or [None] * len(actor)) + outs)
    stride = obs.stride(0) if n > 1 else d
    with torch.cuda.device(dev):
        if _cuda.mlp_route(d, dims[1:]) == "general":
            _cuda.launch_policy_general_act(ptrs, n, steps, stride, dims, _act_constants())
            policy_general_act_launches += 1
        else:
            _cuda.launch_policy_act(ptrs, n, steps, stride, dims, _act_constants())
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


def policy_value(params, obs):
    """The critic's value [n] of ``obs`` [n, D]: on the card one launch of kernel A
    (both towers, greedy, the action into a scratch), bitwise the value that the
    minibatch forward (``ops/mlp.py``) gives each row, and row-invariant; on the CPU
    and a tensor-parallel rank ``net.critic_value``."""
    if not whole_towers(params, obs):
        return net.critic_value(params, obs)
    action = obs.new_empty((obs.shape[0], 2))
    value = obs.new_empty((1, obs.shape[0]))
    _launch_act("policy_value", params, obs, action=action, value_rows=value)
    return value[0]


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

    ``actor``: the pool's actor layers, stacked [(w [P, in, out], b [P, out])] * (L + 1);
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
    global pool_act_launches, pool_general_act_launches
    name = "pool_act"
    dev = obs.device
    leaves = [t for layer in actor for t in layer]
    members = leaves[0].shape[0] if leaves and leaves[0].ndim == 3 else 0
    dims = _tower_dims(leaves, 2, name, stacked=members)
    d = dims[0]
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
    args = (rows, seats, cars, int(first is not None), obs.stride(0) if envs > 1 else seats * d,
            members, kind, wide, use is not None and use.ndim == 1, dims, consts)
    with torch.cuda.device(dev):
        if _cuda.mlp_route(d, dims[1:]) == "general":
            _cuda.launch_policy_general_pool(ptrs, *args)
            pool_general_act_launches += 1
        else:
            _cuda.launch_pool_act(ptrs, *args)
            pool_act_launches += 1
    return out

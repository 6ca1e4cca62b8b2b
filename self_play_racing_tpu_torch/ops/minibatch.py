"""The PPO minibatch step's work around the MLPs as kernels: the loss head with its
backward (``ppo_head``), every minibatch's advantage moments (``advantage_moments``)
and the clip/Adam/masked-apply tail (``adam_tail``).

The JAX package runs the whole minibatch body (``self_play_racing_tpu/agent/ppo.py``
``body_fn``: the loss, its gradient under ``jax.value_and_grad``, optax's
``clip_by_global_norm`` and ``scale_by_adam``, ``apply_updates`` and the KL exit's
``jnp.where`` masks) as one XLA program on the TPU. The port keeps the gather of the
minibatch's unit ids PyTorch's and runs the rest around the MLPs in hand-written
kernels (``csrc/ppo_head.cu``, ``csrc/adam_tail.cu``):

- ``ppo_head`` is the whole of ``_ppo_loss`` past the MLPs: the per-row work, the
  five means, the entropy and the loss's sum. It dispatches on the device of ``mu``:
  a CPU tensor takes ``ppo_head_loss_plain`` (the PyTorch composition, autograd for
  its gradient), a CUDA tensor ``PPOHead``, a ``torch.autograd.Function`` whose
  forward and backward are one launch each. The backward's gradients are bitwise the
  composition's on the card; the forward's sums are its own, in a fixed order, held
  to the float64 sums within ``SUM_REL_FLOOR`` and ``SUM_CONTROL_FACTOR`` (clip_frac
  bitwise). Given the minibatch's unit ids, it reads the actions, old log-probs,
  advantages, returns and old values where the rollout's units hold them (the plain
  version gathers them first), and the advantages' moments from row ``at`` of the
  update's table.
- ``advantage_moments`` forms that table, every minibatch's advantage mean and
  unbiased std: on the card one launch an update, within the same rule of the
  float64 moments; on the CPU the loop of each minibatch's ``mean()`` and ``std()``.
- ``adam_tail`` dispatches on the device of the parameters: a CPU tensor takes
  ``adam_tail_plain`` (the ``_foreach``/``where`` composition), a CUDA tensor one
  launch of one thread block cluster, bitwise the composition on the card.
- A CUDA tensor of another dtype than float32, or one that is not contiguous,
  raises; there is no fallback from a kernel to its plain version.
- ``ppo_head_launches``, ``ppo_head_backward_launches``,
  ``advantage_moments_launches`` and ``adam_tail_launches`` count kernel launches
  (plain integers, incremented only where a kernel launched).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda
from .geometry import _on_cuda
from ..models import actor_critic as net

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-5
# the advantage normalization's epsilon: (adv - mean) / (std + 1e-8)
ADV_EPS = 1e-8
# The tolerance of the kernels' sums (the loss head's means, the advantages' moments).
# They add float32 rows in float64 in a fixed order, PyTorch in float32 in its own. So
# a kernel's mean m of an n-row float32 value x is held to the float64 mean of the same
# rows within max(SUM_REL_FLOOR x mean(|x|) in float64, SUM_CONTROL_FACTOR x |torch's
# float32 x.mean() - the float64 mean|): no further than a few of PyTorch's own
# roundings, with a floor for where those come out exact. A std takes the float64 std
# as its scale; the loss the sum of its three terms' bounds. clip_frac, a count below
# 2^24 times 1 / n, is bitwise the composition's on the card.
SUM_REL_FLOOR = 1e-5
SUM_CONTROL_FACTOR = 8
STAT_COUNT = 6  # the loss and its stats, agent/ppo.py:STAT_NAMES[:6]

ppo_head_launches = 0
ppo_head_backward_launches = 0
advantage_moments_launches = 0
adam_tail_launches = 0


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a comparison against a tensor of that
    dtype rounds its Python-float operand."""
    return float(torch.tensor(value, dtype=dtype))


def _f32(value: float) -> float:
    """``value`` as PyTorch rounds a Python scalar for a float32 op."""
    return float(np.float32(value))


def _check_cuda(name: str, device: torch.device, tensors, dtype=torch.float32) -> None:
    for t in tensors:
        if t.device != device:
            raise ValueError(f"{name}: tensors on {t.device} and {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the CUDA kernel takes {dtype} tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the CUDA kernel takes contiguous tensors")


# ------------------------------------------------------------------- the loss head

def ppo_head(mu, v, actions, old_logprobs, advantages, returns, values, log_std, moments, at,
             clip_coef: float, ent_coef: float, vf_coef: float, unit_ids=None):
    """``agent/ppo.py:_ppo_loss`` past the MLPs: the clipped loss and its stats.

    ``mu`` [n, 2] is the actor's mean (after its tanh), ``v`` [n] the critic's
    value; the minibatch's actions [n, 2], old log-probs, advantages, returns and old
    values [n]; ``log_std`` [2]; ``moments`` [rows, 2] the update's table of each
    minibatch's advantage mean and unbiased std (``advantage_moments``) and ``at``
    (int64 [1]) this minibatch's row of it. With ``unit_ids`` (int64 [n / block],
    the minibatch's shuffle units) the actions, old log-probs, advantages, returns and
    old values are the rollout's units instead, [units, block, 2] and [units, block]
    (``agent/ppo.py:shard_blocks``), and row r of the minibatch is unit
    ``unit_ids[r // block]``, offset ``r % block``: the kernel reads them there, the
    plain version gathers them first.
    Returns (loss, stats): the loss (0-d, differentiable in ``mu`` and ``v``) and
    [6] ``STAT_NAMES[:6]`` (loss, pg_loss, v_loss, entropy, approx_kl, clip_frac),
    not differentiable. The entropy's log_std is a constant (the port anneals it)."""
    if not _on_cuda(mu, "ppo_head"):
        return ppo_head_loss_plain(mu, v, actions, old_logprobs, advantages, returns,
                                   values, log_std, moments, at, clip_coef, ent_coef,
                                   vf_coef, unit_ids)
    return PPOHead.apply(mu, v, actions, old_logprobs, advantages, returns, values, log_std,
                         moments, at, (float(clip_coef), float(ent_coef), float(vf_coef)),
                         unit_ids)


def gather_units(x: torch.Tensor, unit_ids: torch.Tensor) -> torch.Tensor:
    """The rows of units [units, block, ...] (``agent/ppo.py:shard_blocks``' layout,
    shard and unit axes merged) at ``unit_ids``, flat: [ids * block, ...]; a
    minibatch's field at its unit ids."""
    return x.index_select(0, unit_ids).reshape((-1,) + x.shape[2:])


def ppo_head_plain(mu, v, actions, old_logprobs, advantages, returns, values, log_std,
                   mean, std, clip_coef: float):
    """The head's per-row work, the composition of ``normal_log_prob`` and the loss's
    elementwise operations as ``_ppo_loss`` forms them, on gathered rows with the
    advantages' ``mean`` and ``std`` (0-d). Returns (-log_ratio, max(pg1, pg2),
    max((v - R)^2, (v_clip - R)^2), clip flag), each [n] (the flag float32)."""
    log_ratio = net.normal_log_prob(actions, mu, log_std) - old_logprobs
    ratio = torch.exp(log_ratio)
    adv = (advantages - mean) / (std + ADV_EPS)
    pg1 = -adv * ratio
    pg2 = -adv * torch.clamp(ratio, 1.0 - clip_coef, 1.0 + clip_coef)
    v_clip = values + torch.clamp(v - values, -clip_coef, clip_coef)
    v_max = torch.maximum((v - returns) ** 2, (v_clip - returns) ** 2)
    clipped = ((ratio - 1.0).abs() > clip_coef).to(torch.float32)
    return -log_ratio, torch.maximum(pg1, pg2), v_max, clipped


def ppo_head_loss_plain(mu, v, actions, old_logprobs, advantages, returns, values, log_std,
                        moments, at, clip_coef: float, ent_coef: float, vf_coef: float,
                        unit_ids=None):
    """Plain PyTorch ``ppo_head``: with ``unit_ids`` the five unit fields gathered
    (``gather_units``), the moments' row ``at``, then ``ppo_head_plain`` and the
    composition ``_ppo_loss`` ran around it: ``torch.mean`` of each per-row value,
    ``normal_entropy`` and the loss's sum, the stats stacked (detached)."""
    if unit_ids is not None:
        actions, old_logprobs, advantages, returns, values = (
            gather_units(x, unit_ids)
            for x in (actions, old_logprobs, advantages, returns, values))
    mean, std = moments.index_select(0, at)[0].unbind()
    neg_log_ratio, pg_max, v_max, clipped = ppo_head_plain(
        mu, v, actions, old_logprobs, advantages, returns, values, log_std, mean, std,
        clip_coef)
    approx_kl = torch.mean(neg_log_ratio)  # mean(old - new)
    pg_loss = pg_max.mean()
    v_loss = 0.5 * v_max.mean()
    entropy = net.normal_entropy(log_std, mu.shape[-1], neg_log_ratio.shape)
    e_loss = -entropy.mean()
    loss = pg_loss + ent_coef * e_loss + vf_coef * v_loss
    stats = torch.stack([loss, pg_loss, v_loss, -e_loss, approx_kl, clipped.mean()])
    return loss, stats.detach()


@functools.lru_cache(maxsize=64)
def _head_constants(clip_coef: float, ent_coef: float, vf_coef: float):
    """The kernel's float32 constants (``csrc/ppo_head.cu:HeadArgs``), rounded as
    PyTorch rounds the Python scalars of ``ppo_head_loss_plain``."""
    return (_f32(1.0 - clip_coef), _f32(1.0 + clip_coef), _f32(-clip_coef), _f32(clip_coef),
            _f32(0.5 * math.log(2.0 * math.pi)), _f32(ADV_EPS),
            _f32(0.5 + 0.5 * net._LOG_2PI), _f32(ent_coef), _f32(vf_coef))


def _check_head(inputs, unit_ids) -> None:
    """The shapes ``PPOHead`` takes (see ``ppo_head``)."""
    mu, v, actions, old_logprobs, advantages, returns, values, log_std, moments, at = inputs
    n = mu.shape[0]
    if unit_ids is None:
        lead, what = (n,), "[n]"
    else:
        _check_cuda("ppo_head", mu.device, (unit_ids,), torch.int64)
        block = actions.shape[1] if actions.ndim == 3 else 0
        lead, what = (actions.shape[0], block), "[units, block] with n = ids * block"
        if unit_ids.ndim != 1 or unit_ids.shape[0] * block != n:
            raise ValueError(f"ppo_head: {tuple(unit_ids.shape)} unit ids of {block} rows "
                             f"for {n} rows")
    if (n < 1 or mu.shape != (n, 2) or actions.shape != lead + (2,) or log_std.shape != (2,)
            or v.shape != (n,)
            or any(t.shape != lead for t in (old_logprobs, advantages, returns, values))
            or moments.ndim != 2 or moments.shape[1:] != (2,) or moments.shape[0] < 1
            or at.numel() != 1):
        raise ValueError(f"ppo_head: the kernel takes mu [n >= 1, 2], v [n], the actions, "
                         f"old log-probs, advantages, returns and old values {what} (the "
                         f"actions with 2 more), log_std [2], the moments [rows, 2] and "
                         f"their row [1]")


class PPOHead(torch.autograd.Function):
    """``ppo_head`` on the card: the forward one launch of
    ``csrc/ppo_head.cu:ppo_head_forward_f32`` (the rows, their sums and the loss),
    the backward one of ``ppo_head_backward_f32``, which recomputes the forward's
    intermediates from the saved inputs (through the unit index where one is given).
    The stats are not differentiable."""

    @staticmethod
    def forward(ctx, mu, v, actions, old_logprobs, advantages, returns, values, log_std,
                moments, at, coefs, unit_ids=None):
        global ppo_head_launches
        n = mu.shape[0]
        inputs = (mu, v, actions, old_logprobs, advantages, returns, values, log_std,
                  moments, at)
        _check_cuda("ppo_head", mu.device, inputs[:9])
        _check_cuda("ppo_head", mu.device, (at,), torch.int64)
        _check_head(inputs, unit_ids)
        loss = torch.empty((), dtype=torch.float32, device=mu.device)
        stats = torch.empty((STAT_COUNT,), dtype=torch.float32, device=mu.device)
        constants = _head_constants(*coefs)
        with torch.cuda.device(mu.device):
            _cuda.launch_ppo_head_forward(inputs, constants, loss, stats, n, unit_ids)
        ppo_head_launches += 1
        ctx.save_for_backward(*inputs, unit_ids)
        ctx.constants = constants
        ctx.set_materialize_grads(False)
        ctx.mark_non_differentiable(stats)
        return loss, stats

    @staticmethod
    def backward(ctx, g_loss, _g_stats):
        global ppo_head_backward_launches
        if g_loss is None:
            return (None,) * 12
        *inputs, unit_ids = ctx.saved_tensors
        mu, v = inputs[0], inputs[1]
        if g_loss.device != mu.device or g_loss.dtype != torch.float32 or g_loss.numel() != 1:
            raise ValueError(f"ppo_head backward: the loss's gradient {g_loss.dtype} "
                             f"{tuple(g_loss.shape)} on {g_loss.device}, expected one float32 "
                             f"on {mu.device}")
        g_mu = torch.empty_like(mu)
        g_v = torch.empty_like(v)
        with torch.cuda.device(mu.device):
            _cuda.launch_ppo_head_backward(inputs, ctx.constants, g_loss, g_mu, g_v,
                                           mu.shape[0], unit_ids)
        ppo_head_backward_launches += 1
        return (g_mu, g_v) + (None,) * 10


# ------------------------------------------------------ the advantages' moments

def advantage_moments(advantages: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """[rows, 2]: row i the mean and unbiased std of the advantages of minibatch i,
    the units [units, block] (``agent/ppo.py:shard_blocks``' layout, shard and unit
    axes merged) at unit ids ``index[i]`` ([rows, ids] int64). On a CUDA tensor one
    launch (float64 sums in a fixed order, within ``SUM_REL_FLOOR`` and
    ``SUM_CONTROL_FACTOR`` of the float64 moments), on a CPU one
    ``advantage_moments_plain``."""
    global advantage_moments_launches
    if not _on_cuda(advantages, "advantage_moments"):
        return advantage_moments_plain(advantages, index)
    dev = advantages.device
    _check_cuda("advantage_moments", dev, (advantages,))
    _check_cuda("advantage_moments", dev, (index,), torch.int64)
    if advantages.ndim != 2 or index.ndim != 2 or index.shape[1] < 1 or advantages.numel() < 1:
        raise ValueError(f"advantage_moments: the kernel takes the advantages [units, "
                         f"block] and unit ids [rows, ids >= 1], got "
                         f"{tuple(advantages.shape)} and {tuple(index.shape)}")
    table = torch.empty((index.shape[0], 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch_advantage_moments(advantages, index, table)
    advantage_moments_launches += 1
    return table


def advantage_moments_plain(advantages: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``advantage_moments``: each minibatch's advantages gathered as
    the loss would gather them (``gather_units``), ``mean()`` and
    ``std(correction=1)`` of the flat minibatch (NaN for one row, as there)."""
    rows = []
    for i in range(index.shape[0]):
        adv = gather_units(advantages, index[i])
        std = adv.std(correction=1) if adv.numel() > 1 else torch.full_like(adv[0], math.nan)
        rows.append(torch.stack([adv.mean(), std]))
    return torch.stack(rows) if rows else advantages.new_empty((0, 2))


# -------------------------------------------------------------------- the tail

def clip_by_global_norm(grads, g_norm: torch.Tensor, max_norm: float):
    """``optax.clip_by_global_norm`` as a device select: each gradient as it is
    where ``g_norm < max_norm``, else ``(g / g_norm) * max_norm``. The comparison
    rounds ``max_norm`` to the gradients' dtype. (``torch.nn.utils.clip_grad_norm_``
    divides by ``norm + 1e-6`` instead.)"""
    below = g_norm < max_norm
    clipped = torch._foreach_mul(torch._foreach_div(grads, g_norm), max_norm)
    return [torch.where(below, g, c) for g, c in zip(grads, clipped)]


def adam_update(grads, mu, nu, bc1, bc2, b1: float = ADAM_B1, b2: float = ADAM_B2,
                eps: float = ADAM_EPS):
    """``optax.scale_by_adam`` in its order: the moments, then ``mu_hat /
    (sqrt(nu_hat) + eps)`` with the bias corrections ``bc1``, ``bc2`` of the step's
    count (0-d tensors of the moments' dtype, ``bias_correction_table``'s rows).
    Returns (updates, new mu, new nu)."""
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1), torch._foreach_mul(mu, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                            torch._foreach_mul(nu, b2))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    return list(updates), list(mu), list(nu)


@torch.no_grad()
def apply_updates(params, updates, lr) -> list:
    """``params + (-lr * u)``: the new parameters (``lr`` a number or a 0-d tensor
    of their dtype)."""
    neg = -lr if isinstance(lr, torch.Tensor) else -float(lr)
    return list(torch._foreach_add(params, torch._foreach_mul(updates, neg)))


@functools.lru_cache(maxsize=64)
def _tail_constants(max_norm: float, kl_target: float):
    """The kernel's float32 constants (``csrc/adam_tail.cu:Loop``): max_norm,
    kl_target, b1, 1 - b1, b2, 1 - b2, eps, each rounded as PyTorch rounds the
    Python scalar of ``adam_tail_plain`` (``1 - b1`` taken in float64 first)."""
    return (_f32(max_norm), _in_dtype(kl_target, torch.float32), _f32(ADAM_B1),
            _f32(1 - ADAM_B1), _f32(ADAM_B2), _f32(1 - ADAM_B2), _f32(ADAM_EPS))


@functools.lru_cache(maxsize=64)
def _tail_constant_array(max_norm: float, kl_target: float):
    """``_tail_constants`` as the ctypes array the launch takes, built once."""
    return _cuda._float_array(_tail_constants(max_norm, kl_target))


def adam_tail(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop, max_norm: float,
              kl_target: float) -> None:
    """Everything in a minibatch step after the global norm, in place.

    ``params``, ``grads``, ``mu``, ``nu``: lists of tensors in ``model.parameters()``
    order (on a tensor-parallel rank its slices; with a group the gradients may be
    views of one flat buffer); ``g_norm`` the gradients' global norm (0-d) and
    ``stats`` the minibatch's six stats (``STAT_NAMES[:6]``, ``ppo_head``'s [6]
    buffer, or six 0-d tensors); ``bc1``, ``bc2``
    the bias-correction tables (``bias_correction_table``) and ``lr`` a 0-d tensor;
    ``loop`` a ``MinibatchLoop``. ``trig = approx_kl > kl_target``; where the loop is
    active (no earlier exit) and not ``trig`` the parameters, ``mu`` and ``nu`` take
    Adam's step on the gradients clipped to ``max_norm``; row ``loop.i`` of
    ``loop.stats`` records the stats, applied and active (zeros where not active);
    ``loop.i``, ``loop.applied`` and ``loop.stop`` advance."""
    global adam_tail_launches
    if not _on_cuda(params[0], "adam_tail"):
        adam_tail_plain(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop, max_norm,
                        kl_target)
        return
    dev = params[0].device
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("adam_tail: parameters, gradients and moments differ in number")
    for group in zip(params, grads, mu, nu):
        _check_cuda("adam_tail", dev, group)
        if any(t.shape != group[0].shape for t in group):
            raise ValueError("adam_tail: a parameter, its gradient and moments differ in "
                             "shape")
    scalars = (g_norm, *stats, lr)
    _check_cuda("adam_tail", dev, scalars + (bc1, bc2, loop.stats))
    if len(stats) != 6 or any(t.numel() != 1 for t in scalars):
        raise ValueError("adam_tail: g_norm, the six stats and lr are 0-d")
    _check_cuda("adam_tail", dev, (loop.i, loop.applied), torch.int64)
    _check_cuda("adam_tail", dev, (loop.stop,), torch.bool)
    if (loop.i.numel() != 1 or loop.applied.numel() != 1 or loop.stop.numel() != 1
            or bc1.ndim != 1 or bc2.shape != bc1.shape or loop.stats.ndim != 2
            or loop.stats.shape[1] != 8):
        raise ValueError("adam_tail: the loop's counters are [1], stop 0-d, the bias "
                         "tables [rows] and the stats [rows, 8]")
    with torch.cuda.device(dev):
        _cuda.launch_adam_tail(list(zip(params, grads, mu, nu)),
                               (g_norm, *stats, bc1, bc2, lr, loop.i, loop.applied,
                                loop.stop, loop.stats),
                               _tail_constant_array(max_norm, kl_target), bc1.shape[0],
                               loop.stats.shape[0], dev)
    adam_tail_launches += 1


@torch.no_grad()
def adam_tail_plain(params, grads, mu, nu, g_norm, stats, bc1, bc2, lr, loop,
                    max_norm: float, kl_target: float) -> None:
    """Plain PyTorch ``adam_tail``: ``clip_by_global_norm``, ``adam_update`` and
    ``apply_updates``, a ``where`` a tensor for the masked write, the stats row and
    the counters as device ops."""
    dtype = params[0].dtype
    trig = stats[4] > _in_dtype(kl_target, dtype)
    active = ~loop.stop
    apply = active & ~trig
    grads = clip_by_global_norm(grads, g_norm, max_norm)
    updates, new_mu, new_nu = adam_update(grads, mu, nu,
                                          bc1.index_select(0, loop.applied)[0],
                                          bc2.index_select(0, loop.applied)[0])
    new_params = apply_updates(params, updates, lr)
    for old, new in zip(list(params) + list(mu) + list(nu), new_params + new_mu + new_nu):
        torch.where(apply, new, old, out=old)
    row = torch.stack([s.detach().to(torch.float32) for s in stats]
                      + [apply.to(torch.float32), active.to(torch.float32)])
    loop.stats.index_copy_(0, loop.i, torch.where(active, row, 0.0)[None])
    loop.i += 1
    loop.applied += apply
    loop.stop |= active & trig

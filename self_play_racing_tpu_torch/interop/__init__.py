"""Weights carried across from the JAX package.

- ``params_from_jax`` builds the port's ``ActorCritic`` from the JAX package's
  parameters given as numpy arrays: either its pytree ``{"actor": [(w, b), ...],
  "critic": [...]}`` or the same leaves flattened in tree order (actor layers, then
  critic layers, each ``w`` then ``b``).
- ``load_npz`` reads the repo's ``.npz`` policy format: flat ``p0..p{4L-1}``,
  ``log_std`` and, for policies trained with observation normalization,
  ``obs_mean``/``obs_var``/``obs_count``.
- ``train_state_from_jax`` builds the learner's ``TrainState`` from the JAX
  package's parameters and optax state (``(EmptyState(), ScaleByAdamState(count,
  mu, nu))``, moments in the parameters' pytree layout) given as numpy arrays;
  ``train_state_to_numpy`` goes the other way.
- ``pool_from_jax`` builds the self-play trainer's stacked opponent pool from the
  JAX package's (``params`` with a leading pool axis, ``log_std`` and, when
  present, ``norm_mean``/``norm_var``) given as numpy arrays; ``pool_to_numpy``
  goes the other way. Checkpoint files (``utils.checkpoint``) are the other
  bridge.
- ``interop.sb3_compat`` (a submodule, imported on its own): SB3's default PPO in
  plain torch, for the baseline leg (``train sb3``, ``evaluate --sb3``).
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..agent.ppo import AdamState, TrainState
from ..envs.normalize import ObsNormState
from ..models.actor_critic import ActorCritic


def _flat_leaves(flat_or_pytree):
    if isinstance(flat_or_pytree, dict):
        return [a for tower in ("actor", "critic")
                for layer in flat_or_pytree[tower] for a in layer]
    return list(flat_or_pytree)


def _pytree(leaves):
    """Flat leaves in tree order -> the JAX package's ``{"actor": [(w, b), ...],
    "critic": [...]}`` layout."""
    pairs = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    return {"actor": pairs[: len(pairs) // 2], "critic": pairs[len(pairs) // 2:]}


def params_from_jax(flat_or_pytree, log_std, dtype=torch.float32,
                    device=None) -> ActorCritic:
    """The port's actor-critic holding the JAX package's parameters."""
    dev = resolve_device(device)
    # copies: the model's parameters are trained in place
    leaves = [torch.tensor(np.asarray(a), dtype=dtype, device=dev)
              for a in _flat_leaves(flat_or_pytree)]
    if len(leaves) % 4:
        raise ValueError(f"{len(leaves)} parameter arrays is not 2 towers of (w, b) layers")
    return ActorCritic(_pytree(leaves), torch.as_tensor(np.asarray(log_std), dtype=dtype,
                                                        device=dev))


def load_npz(path, dtype=torch.float32, device=None):
    """(ActorCritic, ObsNormState or None) from a ``.npz`` policy file."""
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as data:
        n = sum(1 for k in data.files if k.startswith("p") and k[1:].isdigit())
        model = params_from_jax([data[f"p{i}"] for i in range(n)], data["log_std"],
                                dtype=dtype, device=dev)
        obs_norm = None
        if "obs_mean" in data.files:
            obs_norm = ObsNormState(
                **{k: torch.as_tensor(data[f"obs_{k}"], device=dev)
                   for k in ("mean", "var", "count")})
    return model, obs_norm


def train_state_from_jax(params, opt_state, update, dtype=torch.float32,
                         device=None) -> TrainState:
    """The port's ``TrainState`` from JAX's params (pytree or flat leaves), the
    optax chain state (any sequence holding one state with ``count``/``mu``/``nu``)
    and the update index, all as numpy arrays."""
    dev = resolve_device(device)
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    leaves = _flat_leaves(params)
    action_dim = np.asarray(leaves[len(leaves) // 2 - 1]).shape[-1]
    model = params_from_jax(leaves, np.zeros((action_dim,)), dtype=dtype, device=dev)

    def moments(tree):
        return [torch.tensor(np.asarray(a), dtype=dtype, device=dev)
                for a in _flat_leaves(tree)]

    return TrainState(model=model,
                      opt_state=AdamState(count=int(np.asarray(adam.count)),
                                          mu=moments(adam.mu), nu=moments(adam.nu)),
                      update=int(np.asarray(update)))


def train_state_to_numpy(train: TrainState):
    """(params, {"count", "mu", "nu"}, update): numpy arrays, params and moments
    in the JAX package's pytree layout, count and update as int32."""
    def host(tensors):
        return _pytree([t.detach().cpu().numpy().copy() for t in tensors])

    adam = train.opt_state
    return (host(train.model.parameters()),
            {"count": np.int32(adam.count), "mu": host(adam.mu), "nu": host(adam.nu)},
            np.int32(train.update))


_POOL_STATS = ("norm_mean", "norm_var")


def pool_from_jax(pool, device=None) -> dict:
    """The port's stacked pool (tensors in the stored dtypes) from the JAX
    package's pool dict of numpy arrays."""
    dev = resolve_device(device)

    def conv(a):
        return torch.tensor(np.asarray(a), device=dev)

    out = {"params": _pytree([conv(a) for a in _flat_leaves(pool["params"])]),
           "log_std": conv(pool["log_std"])}
    for k in _POOL_STATS:
        if pool.get(k) is not None:
            out[k] = conv(pool[k])
    return out


def pool_to_numpy(pool) -> dict:
    """The JAX package's pool layout (numpy arrays) from the port's pool."""
    def host(t):
        return t.detach().cpu().numpy().copy()

    out = {"params": _pytree([host(t) for t in _flat_leaves(pool["params"])]),
           "log_std": host(pool["log_std"])}
    for k in _POOL_STATS:
        if pool.get(k) is not None:
            out[k] = host(pool[k])
    return out

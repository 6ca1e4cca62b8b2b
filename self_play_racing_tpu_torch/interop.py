"""Weights carried across from the JAX package.

- ``params_from_jax`` builds the port's ``ActorCritic`` from the JAX package's
  parameters given as numpy arrays: either its pytree ``{"actor": [(w, b), ...],
  "critic": [...]}`` or the same leaves flattened in tree order (actor layers, then
  critic layers, each ``w`` then ``b``).
- ``load_npz`` reads the repo's ``.npz`` policy format: flat ``p0..p{4L-1}``,
  ``log_std`` and, for policies trained with observation normalization,
  ``obs_mean``/``obs_var``/``obs_count``.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .envs.normalize import ObsNormState
from .models.actor_critic import ActorCritic


def _flat_leaves(flat_or_pytree):
    if isinstance(flat_or_pytree, dict):
        return [a for tower in ("actor", "critic")
                for layer in flat_or_pytree[tower] for a in layer]
    return list(flat_or_pytree)


def params_from_jax(flat_or_pytree, log_std, dtype=torch.float32,
                    device=None) -> ActorCritic:
    """The port's actor-critic holding the JAX package's parameters."""
    dev = resolve_device(device)
    leaves = [torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
              for a in _flat_leaves(flat_or_pytree)]
    if len(leaves) % 4:
        raise ValueError(f"{len(leaves)} parameter arrays is not 2 towers of (w, b) layers")
    half = len(leaves) // 2
    pairs = [(leaves[i], leaves[i + 1]) for i in range(0, len(leaves), 2)]
    params = {"actor": pairs[: half // 2], "critic": pairs[half // 2:]}
    return ActorCritic(params, torch.as_tensor(np.asarray(log_std), dtype=dtype,
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

"""Lockstep vectorization with NEXT_STEP autoreset (port of
``self_play_racing_tpu/envs/vector.py``).

- After an env reports terminated|truncated, its *next* step ignores the action and
  returns the reset observation with reward 0 and done False (Gymnasium 1.x
  NEXT_STEP semantics).
- Per-env running return/length accumulators live in the vector state; the reset
  transition is not counted.
- A ``torch.Generator`` takes the place of the JAX PRNG key: it is handed to the
  transition and reset functions for envs with random dynamics or resets.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .._tree import where_rows


@dataclasses.dataclass
class EpisodeStats:
    """Per-env running episode accumulators."""

    ep_return: torch.Tensor   # [N] running sum of rewards this episode
    ep_length: torch.Tensor   # [N] int32 steps this episode


@dataclasses.dataclass
class VecState:
    """Vectorized env state + autoreset bookkeeping."""

    env: object                      # the batched env state
    pending_reset: torch.Tensor      # [N] bool: env resets on the next step call
    stats: EpisodeStats
    generator: Optional[torch.Generator]  # for envs with random dynamics or resets


def init(env_state, num_envs: int, generator: Optional[torch.Generator] = None,
         dtype=torch.float32) -> VecState:
    """Autoreset bookkeeping for ``env_state``, on the device its tensors live on."""
    dev = _device_of(env_state)
    return VecState(
        env=env_state,
        pending_reset=torch.zeros((num_envs,), dtype=torch.bool, device=dev),
        stats=EpisodeStats(
            ep_return=torch.zeros((num_envs,), dtype=dtype, device=dev),
            ep_length=torch.zeros((num_envs,), dtype=torch.int32, device=dev),
        ),
        generator=generator,
    )


def _device_of(tree) -> torch.device:
    if isinstance(tree, torch.Tensor):
        return tree.device
    for f in dataclasses.fields(tree):
        value = getattr(tree, f.name)
        if isinstance(value, torch.Tensor) or dataclasses.is_dataclass(value):
            return _device_of(value)
    raise ValueError("env state holds no tensor")


def step(
    vstate: VecState,
    action,
    transition_fn: Callable,
    observe_fn: Callable,
    reset_fn: Callable,
    refresh_fn: Optional[Callable] = None,
    info_fn: Optional[Callable] = None,
):
    """One lockstep vector step with NEXT_STEP autoreset.

    transition_fn(state, action, generator) -> (new_state, reward, terminated,
      truncated, info)
    observe_fn(state) -> obs
    reset_fn(generator) -> fresh batched state
    refresh_fn(state) -> (state, obs): optional replacement for observe_fn for envs
      that cache observations in their state; called once on the merged state.
    info_fn(state) -> info: optional reset-info builder with the schema of
      transition_fn's info. Autoreset rows then report the fresh state's info
      instead of the phantom transition of the dead state.

    Returns (new_vstate, obs, reward, done, terminated, truncated, info, record):
    ``record`` holds ``return``/``length``/``mask`` for episodes that finished this
    step (rows where ``mask`` is False are padding) and ``autoreset``, True on rows
    where this step was the reset transition.
    """
    do_reset = vstate.pending_reset
    gen = vstate.generator

    stepped, reward, terminated, truncated, info = transition_fn(vstate.env, action, gen)
    fresh = reset_fn(gen)
    merged = where_rows(do_reset, fresh, stepped)
    if refresh_fn is not None:
        merged, obs = refresh_fn(merged)
    else:
        obs = observe_fn(merged)

    if info_fn is not None:
        info = where_rows(do_reset, info_fn(merged), info)

    reward = reward.masked_fill(do_reset, 0.0)
    terminated = terminated & ~do_reset
    truncated = truncated & ~do_reset
    done = terminated | truncated

    # episode statistics: accumulate, emit at done, clear; the reset step adds 0
    stats = vstate.stats
    ep_return = stats.ep_return + reward.to(stats.ep_return.dtype)
    ep_length = stats.ep_length + (~do_reset).to(torch.int32)
    record = {"return": ep_return, "length": ep_length, "mask": done,
              "autoreset": do_reset}
    new_stats = EpisodeStats(
        ep_return=ep_return.masked_fill(done, 0.0),
        ep_length=ep_length.masked_fill(done, 0),
    )
    new_vstate = VecState(
        env=merged,
        pending_reset=done & ~do_reset,
        stats=new_stats,
        generator=gen,
    )
    return new_vstate, obs, reward, done, terminated, truncated, info, record

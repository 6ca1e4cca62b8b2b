"""Lockstep vectorization with NEXT_STEP autoreset (port of
``self_play_racing_tpu/envs/vector.py``).

- After an env reports terminated|truncated, its *next* step ignores the action and
  returns the reset observation with reward 0 and done False (Gymnasium 1.x
  NEXT_STEP semantics).
- Per-env running return/length accumulators live in the vector state; the reset
  transition is not counted.
- A ``torch.Generator`` takes the place of the JAX PRNG key: it is handed to the
  transition and reset functions for envs with random dynamics or resets.

``step`` mirrors the JAX ``vector.step`` (``self_play_racing_tpu/envs/vector.py:57``),
which XLA fuses with the env step into the rollout's one program. Its ``autoreset_fn``
is the envs' ``transition_autoreset``: the transition, the reset, the merge, the reset
info, the masks and the statistics in one call, on the card the transition kernel in
its autoreset mode (which also writes a rollout's rows of the step; its arguments are
``autoreset_args``), on the CPU the composition ``autoreset`` after the plain
transition.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from .._tree import where_rows
from ..ops import _cuda


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


class StepOut(NamedTuple):
    """A vector step before sensing: the merged env state and what ``step`` returns
    beside the observations, with the new statistics and pending flags."""

    env: object
    reward: torch.Tensor
    done: torch.Tensor
    terminated: torch.Tensor
    truncated: torch.Tensor
    info: dict
    record: dict
    stats: EpisodeStats
    pending_reset: torch.Tensor


# the [T, N] buffers a rollout step writes row t of after the env step, by name
ROW_BUFFERS = ("reward", "done_entering", "ep_return", "ep_length", "ep_mask")
# where a rollout's buffers keep, on the card beside "extra", the multi-car kernels'
# PFSP count scratch (``multi.PFSP.counts``); the rollout's outputs leave it out
PFSP_COUNTS = "_pfsp_counts"


@dataclasses.dataclass
class RolloutRows:
    """A rollout step's rows for ``autoreset_fn`` to write: row ``t`` (int64 [1] on
    the device) of ``out``'s ``ROW_BUFFERS`` ([T, N], ``rollout_buffers``) and, with
    a pool, ``out["extra"]``'s counts; ``entering`` the done flags entering the step,
    ``t_next`` where t + 1 goes."""

    out: dict
    t: torch.Tensor
    entering: torch.Tensor
    t_next: torch.Tensor


def rollout_buffers(out: dict, steps: int, vstate: VecState) -> None:
    """Make the [steps, N] ``ROW_BUFFERS`` in ``out`` where missing, in the dtypes
    the step's rows take."""
    n = vstate.pending_reset.shape[0]
    dev = vstate.pending_reset.device
    dtypes = {"reward": torch.float32, "done_entering": torch.bool,
              "ep_return": vstate.stats.ep_return.dtype,
              "ep_length": vstate.stats.ep_length.dtype, "ep_mask": torch.bool}
    for k in ROW_BUFFERS:
        if k not in out:
            out[k] = torch.empty((steps, n), dtype=dtypes[k], device=dev)


def write_rows(rows: RolloutRows, reward, record) -> None:
    """Row ``rows.t`` of the rollout's buffers from a step's reward and record."""
    mask = record["mask"]
    values = {"reward": reward.to(torch.float32), "done_entering": rows.entering,
              "ep_return": torch.where(mask, record["return"], 0.0),
              "ep_length": torch.where(mask, record["length"], 0), "ep_mask": mask}
    for k, v in values.items():
        rows.out[k].index_copy_(0, rows.t, v[None])


class AutoresetOut(NamedTuple):
    """The transition kernels' autoreset mode's own outputs ([N] each)."""

    done: torch.Tensor
    pending: torch.Tensor
    record_return: torch.Tensor
    record_length: torch.Tensor
    stats_return: torch.Tensor
    stats_length: torch.Tensor

    def step_out(self, state, reward, terminated, truncated, info, pending_reset) -> StepOut:
        record = {"return": self.record_return, "length": self.record_length,
                  "mask": self.done, "autoreset": pending_reset}
        return StepOut(state, reward, self.done, terminated, truncated, info, record,
                       EpisodeStats(self.stats_return, self.stats_length), self.pending)


def autoreset_args(name, n, dev, pending_reset, stats, rows, scalars, position_idx=None,
                   pfsp=None, cars=1):
    """The transition kernels' autoreset arguments (``csrc/autoreset.cuh``): its
    ``_cuda.AUTORESET_PTRS`` pointers in order, its outputs (``AutoresetOut``), the
    rollout's rows, the pool's slots and the PFSP mode. ``scalars`` are the track's
    per-env start scalars (``track.scalars_of``), ``position_idx`` the multi-car
    env's grid slots [N, cars], ``pfsp`` a ``multi.PFSP``. Refuses what the kernels do
    not take (dtypes, shapes, devices) before any launch."""
    def check(what, t, dtype, shape):
        if (not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape
                or t.device != dev or not t.is_contiguous()):
            got = (f"{t.dtype} {tuple(t.shape)} on {t.device}" if isinstance(t, torch.Tensor)
                   else type(t).__name__)
            raise TypeError(f"{name}: {what} must be contiguous {dtype} {shape} on {dev}; "
                            f"got {got}")
        return t

    f32, b8, i32, i64 = torch.float32, torch.bool, torch.int32, torch.int64
    check("pending_reset", pending_reset, b8, (n,))
    check("the running return", stats.ep_return, f32, (n,))
    check("the running length", stats.ep_length, i32, (n,))
    start = [check(f, getattr(scalars, f), f32, (n,)) for f in ("start_x", "start_y",
                                                                "start_angle")]
    grid = [None, None, None]
    if position_idx is not None:
        grid = [check(f, getattr(scalars, f), f32, (n,)) for f in ("start_nx", "start_ny")]
        grid.append(check("position_idx", position_idx, i64, (n, cars)))

    def new(dtype):
        return torch.empty((n,), dtype=dtype, device=dev)

    outs = AutoresetOut(new(b8), new(b8), new(f32), new(i32), new(f32), new(i32))
    row_ptrs, steps = [None] * 8, 0
    if rows is not None:
        buffers = [rows.out[k] for k in ROW_BUFFERS]
        steps = buffers[0].shape[0]
        for k, t, dtype in zip(ROW_BUFFERS, buffers, (f32, b8, f32, i32, b8)):
            check(f"the rollout's {k}", t, dtype, (steps, n))
        row_ptrs = [check("t", rows.t, i64, (1,)), check("t_next", rows.t_next, i64, (1,)),
                    check("the entering done flags", rows.entering, b8, (n,)), *buffers]
    pfsp_ptrs, pool, mode = [None] * 4, 0, 0
    if pfsp is not None:
        pool = pfsp.extra.shape[0] // 2
        check("extra", pfsp.extra, f32, (2 * pool,))
        check("the PFSP counts", pfsp.counts, i32, (2 * pool + 1,))
        idx, use = pfsp.idx, pfsp.use_policy
        if (not isinstance(idx, torch.Tensor) or idx.dtype not in (i32, i64)
                or idx.device != dev or tuple(idx.shape) not in ((), (n,))):
            raise TypeError(f"{name}: the opponent index must be int32 or int64, 0-d or "
                            f"[{n}], on {dev}")
        if (not isinstance(use, torch.Tensor) or use.dtype != b8 or use.device != dev
                or tuple(use.shape) not in ((), (n,))):
            raise TypeError(f"{name}: use_policy must be bool, 0-d or [{n}], on {dev}")
        if pool < 1:
            raise ValueError(f"{name}: a pool of no slots")
        mode = ((_cuda.PFSP_IDX_PER_ENV if idx.ndim else 0)
                | (_cuda.PFSP_IDX_WIDE if idx.dtype == i64 else 0)
                | (_cuda.PFSP_USE_PER_ENV if use.ndim else 0))
        pfsp_ptrs = [idx.contiguous(), use.contiguous(), pfsp.extra, pfsp.counts]
    ptrs = [pending_reset, stats.ep_return, stats.ep_length, *start, *grid, *outs,
            *row_ptrs, *pfsp_ptrs]
    return ptrs, outs, steps, pool, mode


def autoreset(do_reset, stats: EpisodeStats, stepped, fresh, reward, terminated,
              truncated, info, info_fn: Callable) -> StepOut:
    """NEXT_STEP autoreset after a transition: ``fresh`` where ``do_reset`` over
    ``stepped``, ``info_fn(merged)``'s info on those rows (the fresh state's, not the
    dead state's phantom transition), their reward 0 and flags False, and the episode
    statistics (accumulate, emit at done, clear; the reset step adds 0)."""
    merged = where_rows(do_reset, fresh, stepped)
    info = where_rows(do_reset, info_fn(merged), info)

    reward = reward.masked_fill(do_reset, 0.0)
    terminated = terminated & ~do_reset
    truncated = truncated & ~do_reset
    done = terminated | truncated

    ep_return = stats.ep_return + reward.to(stats.ep_return.dtype)
    ep_length = stats.ep_length + (~do_reset).to(torch.int32)
    record = {"return": ep_return, "length": ep_length, "mask": done,
              "autoreset": do_reset}
    new_stats = EpisodeStats(
        ep_return=ep_return.masked_fill(done, 0.0),
        ep_length=ep_length.masked_fill(done, 0),
    )
    return StepOut(merged, reward, done, terminated, truncated, info, record, new_stats,
                   done & ~do_reset)


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
    autoreset_fn: Callable,
    observe_fn: Callable,
    refresh_fn: Optional[Callable] = None,
):
    """One lockstep vector step with NEXT_STEP autoreset.

    autoreset_fn(state, action, generator, pending_reset, stats) -> StepOut: the
      transition and ``autoreset`` (the envs' ``transition_autoreset``)
    observe_fn(state) -> obs
    refresh_fn(state) -> (state, obs): optional replacement for observe_fn for envs
      that cache observations in their state; called once on the merged state.

    Returns (new_vstate, obs, reward, done, terminated, truncated, info, record):
    ``record`` holds ``return``/``length``/``mask`` for episodes that finished this
    step (rows where ``mask`` is False are padding) and ``autoreset``, True on rows
    where this step was the reset transition.
    """
    gen = vstate.generator
    out = autoreset_fn(vstate.env, action, gen, vstate.pending_reset, vstate.stats)
    merged = out.env
    if refresh_fn is not None:
        merged, obs = refresh_fn(merged)
    else:
        obs = observe_fn(merged)
    new_vstate = VecState(env=merged, pending_reset=out.pending_reset, stats=out.stats,
                          generator=gen)
    return (new_vstate, obs, out.reward, out.done, out.terminated, out.truncated, out.info,
            out.record)

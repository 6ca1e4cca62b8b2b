"""Self-play view: seat 0's perspective of the multi-car env, the other seats
driven by frozen snapshot policies (port of ``self_play_racing_tpu/envs/selfplay.py``).

Semantics kept from the JAX package:

 - opponents act on the observation of the *previous* step, cached as ``obs_all``
   in the state, so each step senses once;
 - a pool opponent samples ``clip(mu + exp(log_std) * noise, -1, 1)`` with the
   log_std frozen at its snapshot; where ``use_policy`` is False the action is a
   uniform draw over [-1, 0]..[1, 1], computed from [0, 1) uniforms as
   ``jax.random.uniform`` computes it;
 - with one index per env the actions are computed under every pool member on one
   noise draw and gathered by the index; with one shared index only that member
   runs. Each member normalizes observations with the statistics frozen at its
   snapshot when the pool carries ``norm_mean``/``norm_var``;
 - the opponent seats are flattened env-major into one batch;
 - the returned ``terminated`` is the episode's done (terminated | truncated).

The opponent specification travels in the trainer's ``aux``:
``opp = {"params": stacked pool [P, ...], "log_std": [P, 2], "idx": [N] or 0-d
int, "use_policy": [N] or 0-d bool}`` plus optional ``"norm_mean"``/
``"norm_var"`` [P, obs_dim]. Random inputs (the opponents' normal noise and
uniforms, the start-grid slots of a reset) come from a ``torch.Generator``, through
``opponent_randoms`` and ``multi.random_grid_slots``, or are given.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .._tree import shard_rows
from ..ops import policy as polops
from ..ops.geometry import _on_cuda
from . import multi
from . import normalize as obsnorm
from . import vector
from .track import Track

_ACTION_LOW = (-1.0, 0.0)
_ACTION_HIGH = (1.0, 1.0)


@dataclasses.dataclass
class SelfPlayState:
    inner: multi.MultiState
    obs_all: torch.Tensor  # [N, A, obs_dim] float32: obs of the current state


def reset_state(cfg: multi.MultiRacingConfig, track: Track, generator=None,
                position_idx=None) -> SelfPlayState:
    inner = multi.reset_state(cfg, track, generator, position_idx)
    return SelfPlayState(inner=inner, obs_all=multi.observe(cfg, track, inner))


def opponent_randoms(generator: torch.Generator, rows: int, dtype, device):
    """(noise, uniforms): standard-normal [rows, 2] and [0, 1) [rows, 2] draws for
    ``opponent_actions``."""
    noise = torch.randn((rows, 2), generator=generator, dtype=dtype, device=device)
    uniforms = torch.rand((rows, 2), generator=generator, dtype=dtype, device=device)
    return noise, uniforms


def _pool_actor_mu(params, obs):
    """actor_mu of every pool member: stacked weights [P, in, out], obs [N, D]
    (shared) or [P, N, D] (per member) -> [P, N, act]."""
    layers = params["actor"]
    x = obs.to(layers[0][0].dtype)
    for w, b in layers:
        x = torch.matmul(x, w) + b[:, None, :]
        x = torch.tanh(x)  # hidden tanh and the tanh-bounded mu head
    return x


def _normalized(mean, var, obs):
    return obsnorm.apply(obsnorm.ObsNormState(mean, var, None), obs)


@functools.lru_cache(maxsize=16)
def _action_bounds(dtype, device):
    """The random action's bounds, made once per device: building them from a
    Python list on every step would copy host to device and wait on the stream."""
    return (torch.tensor(_ACTION_LOW, dtype=dtype, device=device),
            torch.tensor(_ACTION_HIGH, dtype=dtype, device=device))


def _pool_kernel(opp, obs, noise, uniforms, member, use_policy, first=None):
    """The pool's actions from ``ops.policy.pool_act`` (kernel B): ``obs`` [envs,
    seats, D], ``member`` and ``use_policy`` [envs] or 0-d."""
    return polops.pool_act(opp["params"]["actor"], opp["log_std"], obs, noise, member,
                           opp.get("norm_mean"), opp.get("norm_var"), uniforms, use_policy,
                           _ACTION_LOW, _ACTION_HIGH, first)


def opponent_actions(cfg: multi.MultiRacingConfig, opp, opp_obs, noise, uniforms):
    """Frozen-opponent actions [N, 2] for one batch of opponent cars.

    ``opp_obs`` [N, obs_dim] (previous-step observations); ``noise`` and
    ``uniforms`` [N, 2] (``opponent_randoms``). A 0-d ``opp["idx"]`` runs that one
    member; an [N] index runs every member on the shared noise and gathers. On the
    card one launch of kernel B (``ops.policy.pool_act``), on the CPU
    ``opponent_actions_plain``."""
    if not _on_cuda(opp_obs, "opponent_actions"):
        return opponent_actions_plain(cfg, opp, opp_obs, noise, uniforms)
    return _pool_kernel(opp, opp_obs[:, None], noise, uniforms, opp["idx"],
                        opp["use_policy"])[:, 0]


def opponent_actions_plain(cfg: multi.MultiRacingConfig, opp, opp_obs, noise, uniforms):
    """Plain PyTorch ``opponent_actions``: the pool's batched GEMMs (every member on
    an [N] index, then the gather), the sample, the uniform action and the select."""
    idx = torch.as_tensor(opp["idx"], device=opp_obs.device)
    normalize = opp.get("norm_mean") is not None
    if idx.ndim == 0:
        def one(t):  # a gather: indexing by a 0-d tensor would read it on the host
            return t.index_select(0, idx.reshape(1).long())[0]
        member_obs = (_normalized(one(opp["norm_mean"]), one(opp["norm_var"]), opp_obs)
                      if normalize else opp_obs)
        layer = [(one(w)[None], one(b)[None]) for w, b in opp["params"]["actor"]]
        mu = _pool_actor_mu({"actor": layer}, member_obs)[0]          # [N, 2]
        policy_act = torch.clamp(mu + torch.exp(one(opp["log_std"])) * noise, -1.0, 1.0)
    else:
        if normalize:
            member_obs = _normalized(opp["norm_mean"][:, None, :],
                                     opp["norm_var"][:, None, :], opp_obs)  # [P, N, D]
        else:
            member_obs = opp_obs
        mus = _pool_actor_mu(opp["params"], member_obs)               # [P, N, 2]
        stds = torch.exp(opp["log_std"])[:, None, :]                  # [P, 1, 2]
        acts = torch.clamp(mus + stds * noise, -1.0, 1.0)
        rows = torch.arange(opp_obs.shape[0], device=opp_obs.device)
        policy_act = acts[idx.expand(rows.shape).long(), rows]        # [N, 2]

    low, high = _action_bounds(policy_act.dtype, policy_act.device)
    rand_act = torch.maximum(low, uniforms.to(policy_act.dtype) * (high - low) + low)
    use = torch.as_tensor(opp["use_policy"], device=opp_obs.device)
    return torch.where(use.expand(opp_obs.shape[:1])[:, None], policy_act, rand_act)


def opponent_actions_all_seats(cfg: multi.MultiRacingConfig, opp, obs_seats, generator,
                               shard=None, first=None):
    """Frozen-opponent actions [N, seats, 2] for all opponent seats in one batch.

    ``obs_seats`` [N, seats, obs_dim]. Each env's opponent drives all of its seats,
    so the seat axis folds into the batch env-major ((env 0, seat 1), (env 0,
    seat 2), ...). The noise and uniforms come from ``opponent_randoms``; with
    ``shard`` = (rank, world) they are this rank's rows of the draw for all
    ``world`` ranks' envs (a data-parallel run). With ``first`` [N, 2] (the
    learner's actions) the multi env's whole action [N, 1 + seats, 2], ``first`` as
    car 0. On the card one launch of kernel B (``ops.policy.pool_act``, which reads
    the seats where ``obs_seats`` views them and writes car 0 itself), on the CPU
    ``opponent_actions_plain`` and a cat."""
    n, seats, d = obs_seats.shape
    dtype = opp["params"]["actor"][0][0].dtype
    if shard is None:
        noise, uniforms = opponent_randoms(generator, n * seats, dtype, obs_seats.device)
    else:
        noise, uniforms = (shard_rows(r, shard) for r in opponent_randoms(
            generator, n * seats * shard[1], dtype, obs_seats.device))
    if _on_cuda(obs_seats, "opponent_actions_all_seats"):
        return _pool_kernel(opp, obs_seats, noise, uniforms, opp["idx"], opp["use_policy"],
                            None if first is None else first.to(torch.float32))
    flat_opp = dict(opp)
    for field in ("idx", "use_policy"):
        v = torch.as_tensor(opp[field], device=obs_seats.device)
        if v.ndim != 0:
            flat_opp[field] = v.repeat_interleave(seats)
    acts = opponent_actions_plain(cfg, flat_opp, obs_seats.reshape(n * seats, d), noise,
                                  uniforms).reshape(n, seats, 2)
    if first is None:
        return acts
    return torch.cat([first.to(torch.float32)[:, None].to(acts.dtype), acts], dim=1)


def _step_inner(cfg, track, opp, state, action0, generator, shard=None):
    actions = opponent_actions_all_seats(cfg, opp, state.obs_all[:, 1:], generator, shard,
                                         first=action0)               # [N, A, 2]
    return multi.transition(cfg, track, state.inner, actions)


def transition(cfg: multi.MultiRacingConfig, track: Track, opp,
               state: SelfPlayState, action0, generator=None):
    """Seat 0's step: the opponents act on their previous-step observations, the
    combined action steps the multi env, and the new state is sensed once.
    Returns (state, reward0 [N], done [N], truncated [N], info0)."""
    inner, rewards, terminated, truncated, info = _step_inner(cfg, track, opp, state,
                                                              action0, generator)
    new_state = SelfPlayState(inner=inner, obs_all=multi.observe(cfg, track, inner))
    info0 = {k: v[:, 0] for k, v in info.items()}
    return new_state, rewards[:, 0], terminated | truncated, truncated, info0


def observe(state: SelfPlayState) -> torch.Tensor:
    return state.obs_all[:, 0]


# The trainer's path: under NEXT_STEP autoreset the reset runs on every step, so
# the deferred variants leave ``obs_all`` stale and ``refresh`` senses once per
# vector step on the merged state. ``shard`` = (rank, world) takes this rank's
# rows of the random draws for all ranks' envs (``multi.reset_state``,
# ``opponent_actions_all_seats``).

def reset_state_deferred(cfg: multi.MultiRacingConfig, track: Track,
                         generator=None, position_idx=None, shard=None) -> SelfPlayState:
    inner = multi.reset_state(cfg, track, generator, position_idx, shard=shard)
    n = inner.x.shape[0]
    return SelfPlayState(inner=inner, obs_all=torch.zeros(
        (n, cfg.num_agents, cfg.obs_dim), dtype=torch.float32, device=inner.x.device))


def transition_deferred(cfg: multi.MultiRacingConfig, track: Track, opp,
                        state: SelfPlayState, action0, generator=None, shard=None):
    """``transition`` without the observe pass; pair with ``refresh``."""
    inner, rewards, terminated, truncated, info = _step_inner(cfg, track, opp, state,
                                                              action0, generator, shard)
    new_state = SelfPlayState(inner=inner, obs_all=state.obs_all)  # stale until refresh
    info0 = {k: v[:, 0] for k, v in info.items()}
    return new_state, rewards[:, 0], terminated | truncated, truncated, info0


def transition_autoreset(cfg: multi.MultiRacingConfig, track: Track, opp,
                         state: SelfPlayState, action0, pending_reset,
                         stats: vector.EpisodeStats, generator=None, shard=None,
                         rows: vector.RolloutRows = None, pool_size: int = 0):
    """Seat 0's vector step with its NEXT_STEP autoreset, the trainer's: the
    opponents' draws and kernel B, then the start-grid slots drawn as ``reset_state``
    draws them (every step, in the order the JAX package's composition takes
    ``generator``'s stream), then ``multi.transition_autoreset``, which on the card is
    one launch. The state's ``obs_all`` is left stale for ``refresh``, which senses
    every row. With ``rows`` and ``pool_size`` > 0 the pool's per-slot wins and games
    (``multi.pfsp_counts``) are added into ``rows.out["extra"]``, made where missing
    (on the card with the kernel's count scratch beside it, under
    ``vector.PFSP_COUNTS``). Returns seat 0's ``vector.StepOut``."""
    actions = opponent_actions_all_seats(cfg, opp, state.obs_all[:, 1:], generator, shard,
                                         first=action0)               # [N, A, 2]
    n = state.inner.x.shape[0]
    dev = state.inner.x.device
    slots = multi.draw_grid_slots(n, cfg.num_agents, generator, dev, shard)
    pfsp = None
    if rows is not None and pool_size > 0:
        if "extra" not in rows.out:
            rows.out["extra"] = torch.zeros((2 * pool_size,), dtype=torch.float32, device=dev)
            if dev.type == "cuda":
                rows.out[vector.PFSP_COUNTS] = torch.zeros((2 * pool_size + 1,),
                                                           dtype=torch.int32, device=dev)
        pfsp = multi.PFSP(torch.as_tensor(opp["idx"], device=dev),
                          torch.as_tensor(opp["use_policy"], device=dev), rows.out["extra"],
                          rows.out.get(vector.PFSP_COUNTS))
    out = multi.transition_autoreset(cfg, track, state.inner, actions, pending_reset, stats,
                                     slots, rows, pfsp)
    return out._replace(env=SelfPlayState(inner=out.env, obs_all=state.obs_all),
                        terminated=out.done,
                        info={k: v[:, 0] for k, v in out.info.items()})


def refresh(cfg: multi.MultiRacingConfig, track: Track, state: SelfPlayState):
    """One observe pass over the (possibly autoreset-merged) state: the refreshed
    state and seat 0's observation."""
    obs_all = multi.observe(cfg, track, state.inner)
    return dataclasses.replace(state, obs_all=obs_all), obs_all[:, 0]

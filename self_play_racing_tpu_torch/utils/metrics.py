"""Evaluation harness: batched episode rollouts + aggregation (port of
``self_play_racing_tpu/utils/metrics.py``).

Every (track, run) combination of the evaluation grid is one row of a single env
batch, with done-latching: a row's state and observation freeze once its episode
ends. Each loop is three parts, as the JAX package's whole-horizon ``lax.scan``
is one program:

- a start (the env reset, eagerly: ``menv.reset`` draws the start-grid slots from
  the caller's generator) building the loop's carry: state, observations, the
  ``active`` rows, the accumulators and a device step index ``t``;
- one step function (``_single_step``, ``_multi_step``) that reads the carry and
  returns the next one, drawing the sampled noise from a generator, or reading row
  ``t`` of a given ``noise``;
- a chunk loop (``_drive``) that reads ``active.any()`` on the host before every
  chunk of at most ``_ACTIVE_CHECK_EVERY`` steps and stops once no row is active.
  On the CPU (or with ``eager=True``) a chunk calls the step function; on a CUDA
  device it replays the step captured as a CUDA graph (``LoopGraphs``) that many
  times. The two draw the same noise and compute the same numbers, bitwise.

Per-episode metrics:
 - total_reward: sum of rewards until done (inclusive)
 - steps: steps taken until done (or the horizon cap)
 - progress / finished / crashed / speed: from the final step's info
 - total_distance: sum of |pos_t - pos_{t-1}| from the second step on
 - policies sample actions, or act greedily (tanh mu) with ``deterministic``
 - multi-car: one shared policy drives every car and an episode's numbers are the
   first finished car's, else car 0's (``rollout_multi``); or one policy per seat,
   returning every seat's numbers (``rollout_match``, the tournament's match)

The loops take an optional ``trace`` dict, which receives [max_steps, N, ...]
device buffers of each step's car poses, speed, progress, reward and the rows
active entering the step (``utils/viz.py``'s recorders): the step function writes
row ``t``, as the JAX recorders' scan outputs are stacked.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np
import torch

from .. import _graph
from .._tree import where_rows
from ..envs import multi as menv
from ..envs import selfplay
from ..envs import single as senv
from ..envs import track as trk
from ..models import actor_critic as net
from ..ops import policy as polops

# rows that finished freeze, so the loop may stop once none is active; it checks
# (one host sync) every this many steps
_ACTIVE_CHECK_EVERY = 32
# the per-step rows a recorder keeps
TRACE_KEYS = ("x", "y", "angle", "speed", "progress", "reward", "active")


def _policy_action(params, log_std, obs, noise, obs_norm=None):
    """The policy's action on ``obs``: greedy (tanh mu) when ``noise`` is None,
    else sampled with that standard-normal noise (``ops.policy.policy_action``: on
    the card one launch of kernel A, the normaliser and the actor alone)."""
    return polops.policy_action(params, log_std, obs, noise, obs_norm)


def _seat_actions(params, log_std, obs, noise, obs_norm):
    """One policy per seat: ``params``, ``log_std`` [A, act] and ``obs_norm``
    (mean, var [A, D]) carry a leading seat axis; ``obs`` [N, A, D] and ``noise``
    [N, A, act] or None (greedy). On the card one launch of kernel B in seat mode
    (``ops.policy.pool_act``), else ``_seat_actions_plain``. Returns actions [N, A,
    act]."""
    if not polops.whole_towers(params, obs):
        return _seat_actions_plain(params, log_std, obs, noise, obs_norm)
    n, a, _ = obs.shape
    return polops.pool_act(params["actor"], log_std, obs,
                           None if noise is None else noise.reshape(n * a, -1),
                           mean=obs_norm.mean, var=obs_norm.var)


def _seat_actions_plain(params, log_std, obs, noise, obs_norm):
    """Plain PyTorch ``_seat_actions``: the seats as one stacked MLP (the self-play
    pool's), seat-major."""
    x = obs.transpose(0, 1)                                           # [A, N, D]
    x = selfplay._normalized(obs_norm.mean[:, None, :], obs_norm.var[:, None, :], x)
    act = selfplay._pool_actor_mu(params, x)                          # [A, N, act]
    if noise is not None:
        act = torch.clamp(act + torch.exp(log_std)[:, None, :] * noise.transpose(0, 1),
                          -1.0, 1.0)
    return act.transpose(0, 1)


# ------------------------------------------------------------- the loops' parts

@dataclasses.dataclass
class LoopCarry:
    """What one loop step reads and writes: the env state and observations, the
    rows still active, the accumulators and the step index ``t`` ([1] int64)."""

    state: object
    obs: torch.Tensor
    active: torch.Tensor
    acc: dict
    t: torch.Tensor


def _start(state, obs, acc) -> LoopCarry:
    dev = obs.device
    return LoopCarry(state=state, obs=obs,
                     active=torch.ones((obs.shape[0],), dtype=torch.bool, device=dev),
                     acc=acc, t=torch.zeros((1,), dtype=torch.int64, device=dev))


def _start_single(env_cfg, track) -> LoopCarry:
    state, obs = senv.reset(env_cfg, track)
    n = obs.shape[0]
    dtype, dev = state.car.x.dtype, state.car.x.device
    return _start(state, obs, {
        "total_reward": torch.zeros((n,), dtype=dtype, device=dev),
        "steps": torch.zeros((n,), dtype=torch.int32, device=dev),
        "total_distance": torch.zeros((n,), dtype=dtype, device=dev),
        "progress": torch.zeros((n,), dtype=dtype, device=dev),
        "finished": torch.zeros((n,), dtype=torch.bool, device=dev),
        "crashed": torch.zeros((n,), dtype=torch.bool, device=dev),
        "speed": torch.zeros((n,), dtype=dtype, device=dev),
    })


def _start_multi(env_cfg, track, generator) -> LoopCarry:
    state, obs = menv.reset(env_cfg, track, generator)
    n, a = state.x.shape
    dtype, dev = state.x.dtype, state.x.device
    fzeros = torch.zeros((n, a), dtype=dtype, device=dev)
    bfalse = torch.zeros((n, a), dtype=torch.bool, device=dev)
    return _start(state, obs, {
        "total_reward": fzeros, "steps": torch.zeros((n,), dtype=torch.int32, device=dev),
        "total_distance": fzeros, "progress": fzeros, "finished": bfalse,
        "crashed": bfalse, "speed": fzeros,
        "placement": torch.zeros((n, a), dtype=torch.int32, device=dev),
    })


def _cars(state):
    """The car poses of a single-car (``state.car``) or multi-car state."""
    return state.car if isinstance(state, senv.RacingState) else state


def _trace_buffers(max_steps: int, carry: LoopCarry) -> dict:
    """Zeroed [max_steps, ...] buffers for a recorder's rows: the car fields shaped
    as the state's x ([N] or [N, A]), ``active`` [max_steps, N]. Rows after an
    early exit stay inactive."""
    x = _cars(carry.state).x
    bufs = {k: x.new_zeros((max_steps,) + x.shape) for k in TRACE_KEYS if k != "active"}
    bufs["active"] = carry.active.new_zeros((max_steps,) + carry.active.shape)
    return bufs


def _write_trace(trace, t, nstate, info, rew, active) -> None:
    cars = _cars(nstate)
    rows = {"x": cars.x, "y": cars.y, "angle": cars.angle, "speed": info["speed"],
            "progress": info["progress"], "reward": rew, "active": active}
    for k, v in rows.items():
        trace[k].index_copy_(0, t, v[None])


def _latched(carry, nstate, nobs, rew, done, info, keys):
    """The next carry after an env step: the active rows' accumulators advanced
    (reward and steps summed, the distance from the second step on, ``keys`` taken
    from ``info``), then every row that is done frozen."""
    state, active, acc = carry.state, carry.active, carry.acc
    old, new = _cars(state), info
    step_dist = torch.sqrt((new["x"] - old.x) ** 2 + (new["y"] - old.y) ** 2)
    first_step = acc["steps"] == 0
    act = active.reshape(active.shape + (1,) * (rew.ndim - 1))
    first = first_step.reshape(act.shape)
    acc = {
        "total_reward": acc["total_reward"] + torch.where(act, rew, 0.0),
        "steps": acc["steps"] + active.to(torch.int32),
        "total_distance": acc["total_distance"]
        + torch.where(act & ~first, step_dist, 0.0),
        **{k: torch.where(act, info[k], acc[k]) for k in keys},
    }
    active = active & ~done
    # frozen state once inactive so nothing drifts after the episode ends
    return LoopCarry(state=where_rows(active, nstate, state),
                     obs=where_rows(active, nobs, carry.obs), active=active, acc=acc,
                     t=carry.t + 1)


def _single_step(env_cfg, deterministic, inputs, generator, carry, trace=None):
    """One step of the single-car loop: the policy on the carry's observations
    (sampled with noise drawn from ``generator`` unless ``deterministic``), the env
    step, the trace rows at ``t`` and the latched accumulators."""
    params, log_std, track = inputs["params"], inputs["log_std"], inputs["track"]
    n = carry.obs.shape[0]
    noise = None if deterministic else net.sample_noise(
        (n, log_std.shape[-1]), generator, dtype=params["actor"][0][0].dtype,
        device=carry.obs.device)
    action = _policy_action(params, log_std, carry.obs.to(torch.float32), noise,
                            inputs["obs_norm"])
    nstate, nobs, rew, term, trunc, info = senv.step(env_cfg, track, carry.state, action)
    if trace is not None:
        _write_trace(trace, carry.t, nstate, info, rew, carry.active)
    return _latched(carry, nstate, nobs, rew, term | trunc, info,
                    ("progress", "finished", "crashed", "speed"))


def _multi_step(env_cfg, deterministic, per_seat, inputs, generator, carry, trace=None):
    """One step of the multi-car loop: noise [N, A, act] from row ``t`` of
    ``inputs["noise"]`` when given, else drawn from ``generator``; the shared
    policy on the flat [N * A] observations, or one policy per seat; the env step,
    the trace rows and the latched per-car accumulators."""
    params, log_std, track = inputs["params"], inputs["log_std"], inputs["track"]
    n, a = carry.active.shape[0], carry.obs.shape[1]
    eps = None
    if not deterministic:
        given = inputs["noise"]
        eps = given.index_select(0, carry.t)[0] if given is not None else net.sample_noise(
            (n, a, log_std.shape[-1]), generator, dtype=params["actor"][0][0].dtype,
            device=carry.obs.device)
    obs32 = carry.obs.to(torch.float32)
    if per_seat:
        action = _seat_actions(params, log_std, obs32, eps, inputs["obs_norm"])
    else:
        action = _policy_action(params, log_std, obs32.reshape(n * a, -1),
                                None if eps is None else eps.reshape(n * a, -1),
                                inputs["obs_norm"]).reshape(n, a, -1)
    nstate, nobs, rew, term, trunc, info = menv.step(env_cfg, track, carry.state, action)
    if trace is not None:
        _write_trace(trace, carry.t, nstate, info, rew, carry.active)
    return _latched(carry, nstate, nobs, rew, term | trunc, info,
                    ("progress", "finished", "crashed", "speed", "placement"))


def _drive(max_steps: int, active, run) -> int:
    """The loop's chunks: before each chunk of ``k = min(32, steps left)`` steps it
    reads ``active()``.any() on the host (the loop's only sync), stops once no row
    is active, else calls ``run(k)``. Returns the steps run."""
    done = 0
    while done < max_steps and bool(active().any()):
        k = min(_ACTIVE_CHECK_EVERY, max_steps - done)
        run(k)
        done += k
    return done


# ------------------------------------------------------- the loops as CUDA graphs

class _LoopGraph:
    """One loop step (``step(inputs, generator, carry, trace)``) captured as a
    CUDA graph (``_graph.CapturedStep``) over static copies of the carry and the
    trace buffers, reading ``inputs`` through a ``_graph.StaticTree``. A sampled
    step draws from a CUDA generator the graph owns and registers; ``run`` loads it
    from the caller's generator before the replays and hands the state back after
    them, so that the caller's generator advances as the eager loop's would."""

    def __init__(self, step, carry, inputs, copied, sampled, trace, key):
        dev = carry.obs.device
        self.key = key
        self.carry = _graph.clone_tree(carry)
        self.inputs = _graph.StaticTree(inputs, copied)
        self.trace = None if trace is None else _graph.clone_tree(trace)
        self.generator = torch.Generator(device=dev) if sampled else None

        def body():
            _graph.load_tree(self.carry, step(self.inputs.tree, self.generator,
                                              self.carry, self.trace))

        self.step = _graph.CapturedStep(body, dev,
                                        [] if self.generator is None else [self.generator],
                                        self.carry.t.zero_)

    def run(self, carry, inputs, generator, trace, max_steps: int) -> dict:
        """The loop from ``carry`` for ``max_steps`` steps at most; returns a copy
        of the accumulators and fills ``trace`` (when given) from the graph's."""
        _graph.load_tree(self.carry, carry)
        self.inputs.load(inputs)
        if trace is not None:
            _graph.load_tree(self.trace, trace)
        if self.generator is not None:
            self.generator.set_state(generator.get_state())
        _drive(max_steps, lambda: self.carry.active, self.step.replay)
        if self.generator is not None:
            generator.set_state(self.generator.get_state())
        if trace is not None:
            _graph.load_tree(trace, self.trace)
        return _graph.clone_tree(self.carry.acc)

    def owned(self) -> list:
        """The tensors the graph owns outside its private pool."""
        return ([t for _, t in _graph.tensor_leaves((self.carry, self.trace))]
                + [t for p, t in _graph.tensor_leaves(self.inputs.tree)
                   if p in self.inputs.copied])


class LoopGraphs:
    """The evaluation, match and recorder loops' captured steps, the port's
    counterpart of the JAX package's ``functools.lru_cache`` of one jitted
    program per (env_cfg, horizon, mode): a graph is kept per loop kind, env
    config, mode and the ``_graph.signature`` of its carry, inputs and trace
    buffers, and reused across calls and models (the horizon is the number of
    replays, so it needs no graph of its own). The ``size`` (8) most recently used
    are kept.

    The policy (params, log_std, obs_norm) is always copied into the graph's own
    buffers: a few KB, new at every tournament match, so the 12 matches of a
    4-model round robin share one capture. The track and a given ``noise`` are read
    in place while the caller hands the same tensors; where it hands another, the
    graph is captured again with that place copied from then on. ``captures`` and
    ``capture_seconds`` count the captures."""

    POLICY = ("params", "log_std", "obs_norm")

    def __init__(self):
        self.size = 8
        self.graphs = collections.OrderedDict()
        self.captures = 0
        self.capture_seconds = 0.0

    def clear(self) -> None:
        self.graphs.clear()

    def run(self, what, step, carry, inputs, generator, trace, max_steps: int) -> dict:
        """``step``'s loop for ``what`` (the loop kind, env config and mode)
        through its graph, captured first where none fits."""
        sampled = generator is not None
        key = (what, sampled, _graph.signature((carry, inputs, trace)))
        graph = self.graphs.pop(key, None)
        moved = frozenset() if graph is None else graph.inputs.moved(inputs)
        if graph is None or moved:
            copied = (frozenset(p for p, _ in _graph.tensor_leaves(inputs)
                                if p[0] in self.POLICY)
                      if graph is None else graph.inputs.copied) | moved
            graph = None  # free the old graph's buffers before the new capture
            while len(self.graphs) >= self.size:
                self.graphs.popitem(last=False)
            t0 = time.perf_counter()
            graph = _LoopGraph(step, carry, inputs, copied, sampled, trace, key)
            self.capture_seconds += time.perf_counter() - t0
            self.captures += 1
        self.graphs[key] = graph
        return graph.run(carry, inputs, generator, trace, max_steps)

    def memory(self) -> dict:
        """Bytes the kept graphs hold: the buffers they own and their private
        pools."""
        graphs = list(self.graphs.values())
        return {"static_bytes": sum(t.nbytes for g in graphs for t in g.owned()),
                "pool_bytes": sum(g.step.pool_bytes for g in graphs)}


loop_graphs = LoopGraphs()


def _run_loop(what, step, carry, inputs, generator, max_steps, trace, eager):
    """The loop of ``step`` from ``carry``: graphed on a CUDA device unless
    ``eager``, else eagerly. Fills ``trace`` (a dict) with the recorder's
    buffers when given. Returns the accumulators."""
    if trace is not None:
        trace.update(_trace_buffers(max_steps, carry))
    if not eager and carry.obs.device.type == "cuda":
        return loop_graphs.run(what, step, carry, inputs, generator, trace, max_steps)
    state = [carry]

    def run(k):
        for _ in range(k):
            state[0] = step(inputs, generator, state[0], trace)

    _drive(max_steps, lambda: state[0].active, run)
    return state[0].acc


@torch.no_grad()
def _rollout_single_acc(params, log_std, env_cfg, track, generator, max_steps,
                        deterministic, obs_norm, trace=None, eager=False):
    """The single-car loop's raw accumulator ([N] tensors). ``trace``: a dict to
    fill with the recorder's buffers. ``eager``: run eagerly on a CUDA device too
    (the reference the graphed loop is held to)."""
    if not deterministic and generator is None:
        raise ValueError("rollout_single: sampled actions need a generator")
    inputs = {"params": params, "log_std": log_std, "obs_norm": obs_norm, "track": track}

    def step(inputs, gen, carry, trace):
        return _single_step(env_cfg, deterministic, inputs, gen, carry, trace)

    return _run_loop(("single", env_cfg, deterministic), step,
                     _start_single(env_cfg, track), inputs,
                     None if deterministic else generator, max_steps, trace, eager)


def rollout_single(params, log_std, env_cfg: senv.RacingConfig, track: trk.TrackArrays,
                   generator=None, max_steps: int = 2000, deterministic: bool = False,
                   obs_norm=None):
    """Latched episode metrics for a batch of single-car envs. Returns a dict of
    [N] tensors (total_reward, steps, progress, finished, crashed, speed,
    total_distance, distance_per_step). Sampled mode draws its noise from
    ``generator``, which lives on the track's device."""
    acc = _rollout_single_acc(params, log_std, env_cfg, track, generator, max_steps,
                              deterministic, obs_norm)
    acc["distance_per_step"] = torch.where(
        acc["steps"] > 1, acc["total_distance"] / acc["steps"], 0.0)
    return acc


@torch.no_grad()
def _rollout_multi_acc(params, log_std, env_cfg, track, generator, max_steps,
                       deterministic, obs_norm, per_seat=False, noise=None, trace=None,
                       eager=False):
    """The multi-car loop's raw accumulator ([N, A] per car, ``steps`` [N]).
    ``per_seat``: params, log_std and obs_norm carry a leading seat axis (one
    policy per car) and obs_norm is a stacked normalizer, never None. Sampled
    noise is [N, A, act] a step, from ``noise`` [T, N, A, act] when given, else
    from ``generator`` (which also draws the start-grid slots). ``trace`` and
    ``eager`` as ``_rollout_single_acc`` takes them."""
    carry = _start_multi(env_cfg, track, generator)
    inputs = {"params": params, "log_std": log_std, "obs_norm": obs_norm, "track": track,
              "noise": None if deterministic else noise}

    def step(inputs, gen, carry, trace):
        return _multi_step(env_cfg, deterministic, per_seat, inputs, gen, carry, trace)

    draws = not deterministic and noise is None
    return _run_loop(("multi", env_cfg, deterministic, per_seat), step, carry, inputs,
                     generator if draws else None, max_steps, trace, eager)


def rollout_multi(params, log_std, env_cfg: menv.MultiRacingConfig, track: trk.TrackArrays,
                  generator, max_steps: int = 3000, deterministic: bool = False,
                  obs_norm=None):
    """Shared-policy multi-car rollout: every car is driven by the same policy, on
    the flat [N * A] batch of observations. Returns a dict of [N] tensors
    (total_reward, progress, finished, crashed, speed, placement, total_distance
    and distance_per_step of the chosen car, the episode's steps). ``generator``
    (on the track's device) draws the start-grid slots and the sampled actions'
    noise."""
    acc = _rollout_multi_acc(params, log_std, env_cfg, track, generator, max_steps,
                             deterministic, obs_norm)
    n = acc["steps"].shape[0]
    # the chosen car: the first finished one, else car 0 (argmax of the first True)
    chosen = acc["finished"].to(torch.int8).argmax(dim=1)
    rows = torch.arange(n, device=chosen.device)
    out = {k: v[rows, chosen] for k, v in acc.items() if k != "steps"}
    out["steps"] = acc["steps"]
    out["distance_per_step"] = torch.where(
        out["steps"] > 1, out["total_distance"] / out["steps"], 0.0)
    return out


def rollout_match(params_stack, log_std_stack, obs_norm_stack,
                  env_cfg: menv.MultiRacingConfig, track: trk.TrackArrays, generator,
                  max_steps: int = 3000, deterministic: bool = False, noise=None):
    """Head-to-head match rollout: one policy per seat (tournament play). The
    stacked inputs have a leading ``num_agents`` axis (``tournament.stack_bundles``);
    ``obs_norm_stack`` is a stacked ``ObsNormState`` (identity rows for policies
    trained without normalization). ``generator`` (on the track's device) draws the
    start-grid slots and, in sampled mode, each step's [N, A, 2] noise unless
    ``noise`` [T, N, A, 2] is given. Returns the raw per-seat accumulator: [N, A]
    tensors (placement: 1 = winner, 0 = the episode never ended inside
    ``max_steps``; finished, crashed, progress, total_reward, total_distance,
    speed) and ``steps`` [N]."""
    return _rollout_multi_acc(params_stack, log_std_stack, env_cfg, track, generator,
                              max_steps, deterministic, obs_norm_stack, per_seat=True,
                              noise=noise)


def aggregate(episodes: dict) -> dict:
    """Grid aggregation over a dict of per-episode arrays: success and crash rates
    over all episodes, ``avg_*`` over successful episodes, steps per progress over
    episodes with progress > 0.01."""
    episodes = {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
                for k, v in episodes.items()}
    total = len(episodes["steps"])
    finished = np.asarray(episodes["finished"], bool)
    crashed = np.asarray(episodes["crashed"], bool)
    progress = np.asarray(episodes["progress"], float)
    steps = np.asarray(episodes["steps"], float)
    succ = finished

    def avg(key):
        vals = np.asarray(episodes[key], float)
        return float(np.mean(vals[succ])) if succ.any() else 0.0

    eff_mask = progress > 0.01
    steps_per_progress = (
        float(np.mean(steps[eff_mask] / progress[eff_mask])) if eff_mask.any() else 0.0
    )
    return {
        "num_episodes": int(total),
        "num_successful": int(succ.sum()),
        "success_rate": float(succ.sum() / total),
        "crash_rate": float(crashed.sum() / total),
        "avg_steps": float(np.mean(steps[succ])) if succ.any() else 0.0,
        "avg_reward": avg("total_reward"),
        "avg_progress": avg("progress"),
        "avg_speed": avg("speed"),
        "avg_distance": avg("total_distance"),
        "avg_steps_per_progress": steps_per_progress,
    }


def build_eval_grid(num_tracks: int = 40, num_runs: int = 5, seed: int = 42,
                    dtype=torch.float32, device=None):
    """The evaluation grid: ``num_tracks`` procedural tracks (global RNG seeded,
    per the gen_tracks quirk) x ``num_runs`` widths drawn as
    RandomState(seed+i).randint(4, 10), indexed by run, not track (a quirk of the
    original protocol).

    Returns (TrackArrays of num_tracks*num_runs rows, track_ids, run_ids).
    """
    np.random.seed(seed)
    cps = trk.gen_tracks(num_tracks=num_tracks, seed=seed)
    widths = [np.random.RandomState(seed + i).randint(4, 10) for i in range(num_tracks)]
    combo_cps, combo_widths, track_ids, run_ids = [], [], [], []
    for t in range(num_tracks):
        for r in range(num_runs):
            combo_cps.append(cps[t])
            combo_widths.append(float(widths[r]))
            track_ids.append(t)
            run_ids.append(r)
    pool = trk.make_track_pool(combo_cps, combo_widths, dtype=dtype, device=device)
    return pool, np.array(track_ids), np.array(run_ids)

"""Multi-car racing env as batched PyTorch functions (port of
``self_play_racing_tpu/envs/multi.py``).

Branch-free over a ``[num_envs, num_agents]`` state layout:

 - per-car obs = ``num_sensors`` rays in a +-pi/2 cone cast against the walls (K1)
   and every car's rectangle (K3), their minimum; 4 kinematic features (the
   angular-velocity feature is always 0); 4 opponent-relative features per
   opponent in seat order without self (relative position over the track's
   max_track_distance, relative velocity over max_speed, in the car's frame).
 - actions: steering clipped to [-1, 1]; throttle ``clip((a + 1) / 2, 0, 1)``
   (not the single env's raw clip).
 - car-car response: the SAT test (K4) over all [N, A, A] pairs with the diagonal
   masked; a car's velocity is multiplied by 0.92 once per colliding partner and
   it takes -5 per partner.
 - reward order: progress, speed, checkpoints, finish with its time bonus, the
   one-time crash penalty, the touch penalty, then +250 to the winner at episode
   end. terminated = any finished | all crashed; truncated at ``max_steps``.
 - placement at episode end: score ``finished*10000 + progress*100 +
   !crashed*10 + 1/finished_step`` ranked descending, the higher seat index
   winning exact ties; 0 until the episode ends.
 - start grid: cars side by side along the start normal, spacing width + 1.5,
   slot ``position_idx`` (given, or a random permutation per env).

On the card an env step is two kernel launches, a block per env or per few envs
(``ops/_cuda.py``'s plans): ``observe`` is the sensing kernel (K1 and K3 of rays
[N, A, R] against the segment rows [N, S] and the row's cars) writing the whole
observation row, and ``transition`` the transition kernel (K5, the corners and K2
of cars [N, A] against waypoint rows [N, 1, W], with more than one car K4 over each
row's pairs and the velocity response) running the whole reward, termination and
placement tail (``csrc/multi_observe.cu``, ``csrc/multi_transition.cu``; on fewer
rows than ``ops/_cuda.py``'s ``OBSERVE_SMALL_BELOW`` and ``TRANSITION_SMALL_BELOW``
the first kernels, a block a row, whose chains are shorter). On CPU tensors they
run ``observe_plain`` and ``transition_plain``: the narrow kernels' wrappers
(``geo.raycast_walls_and_cars``, ``car_step_and_query``, which take their own plain
versions there) and PyTorch around them, the composition the kernels are held to
bitwise on the card. ``observe_launches`` and ``transition_launches`` count the
kernels' launches (``*_row_id_launches`` those reading pool rows by id,
``*_small_launches`` those of the first kernels). The JAX
package's per-seat raycast unroll and its query-layout switch work around XLA
fusion limits and have no counterpart here. The geometry is per-env
``TrackArrays`` or a capacity layout (``envs/track.py``), whose resident pool rows
the two kernels read by row id.

``transition_autoreset`` is a vector step's transition with its NEXT_STEP autoreset
over seat 0's episode, self-play's view (``vector.autoreset``: the reset rows' cars
on the start grid of given slots, their info, the masks, seat 0's episode
statistics, a rollout's rows of the step, and with a pool the PFSP counts
``pfsp_counts`` defines): on the card the same launch in the kernels' autoreset mode
(``csrc/autoreset.cuh``), counted also as ``transition_autoreset_launches``
(``transition_autoreset_small_launches`` by the first kernel); on the CPU
``transition_autoreset_plain``, the composition the mode is held to bitwise.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .._numerics import const_div, div_const, f32_reciprocal
from .._tree import shard_rows
from ..ops import _cuda
from ..ops import geometry as geo
from ..ops.dynamics import DEFAULT_CAR, CarSpec, _step_constants, car_step_and_query
from . import track as trk
from . import vector
from .track import Track

observe_launches = 0
observe_row_id_launches = 0
observe_small_launches = 0
transition_launches = 0
transition_row_id_launches = 0
transition_small_launches = 0
transition_autoreset_launches = 0
transition_autoreset_small_launches = 0


@dataclasses.dataclass(frozen=True)
class MultiRacingConfig:
    """Static configuration (shapes and reward/response constants)."""

    num_agents: int = 2
    num_sensors: int = 11
    max_sensor_range: float = 50.0
    sensor_cone: float = float(np.pi / 2)
    # Clamp sensor reads to max_sensor_range. False keeps the reference's
    # unclamped-hit quirk for the walls (the car rays are clamped either way).
    clamp_sensor_range: bool = False
    dt: float = 0.05
    max_steps: int = 3000
    car: CarSpec = DEFAULT_CAR

    progress_scale: float = 200.0
    speed_scale: float = 18.0
    checkpoint_bonus: float = 25.0
    crash_penalty: float = 160.0
    finish_bonus: float = 100.0
    time_bonus_base: float = 300.0
    time_bonus_divisor: float = 15.0
    touch_penalty: float = 5.0
    collision_speed_scale: float = 0.92
    winner_bonus: float = 250.0

    @property
    def obs_dim(self) -> int:
        return self.num_sensors + 4 + (self.num_agents - 1) * 4

    @property
    def action_dim(self) -> int:
        return 2

    def sensor_angles(self) -> np.ndarray:
        return np.linspace(-self.sensor_cone, self.sensor_cone, self.num_sensors)


@dataclasses.dataclass
class MultiState:
    """Batched state: car fields are [N, A]; ``steps`` is [N] int32."""

    x: torch.Tensor
    y: torch.Tensor
    angle: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    progress: torch.Tensor
    crashed: torch.Tensor        # bool
    finished: torch.Tensor       # bool
    steps: torch.Tensor          # [N] int32
    last_progress: torch.Tensor
    last_steering: torch.Tensor
    cp25: torch.Tensor           # bool checkpoint flags
    cp50: torch.Tensor
    cp75: torch.Tensor
    has_crashed: torch.Tensor    # bool: the crash penalty was paid
    finished_step: torch.Tensor  # [N, A] int32, 0 = not finished
    placement: torch.Tensor      # [N, A] int32, 0 until the episode ends


def random_grid_slots(num_envs: int, num_agents: int, generator: torch.Generator,
                      device=None) -> torch.Tensor:
    """A random permutation of the start-grid slots per env, [N, A] int64."""
    u = torch.rand((num_envs, num_agents), generator=generator, device=device)
    return torch.argsort(u, dim=-1)


def draw_grid_slots(num_envs: int, num_agents: int, generator: torch.Generator, device,
                    shard=None) -> torch.Tensor:
    """``random_grid_slots`` for ``num_envs`` envs; with ``shard`` = (rank, world) this
    rank's rows of the draw for all ``world`` ranks' envs."""
    if shard is None:
        return random_grid_slots(num_envs, num_agents, generator, device=device)
    return shard_rows(random_grid_slots(num_envs * shard[1], num_agents, generator,
                                        device=device), shard)


def reset_state(cfg: MultiRacingConfig, track: Track, generator=None,
                position_idx=None, shard=None) -> MultiState:
    """Fresh state on the staggered start grid. ``position_idx`` [N, A] gives each
    car's grid slot; without it a random permutation per env is drawn from
    ``generator`` (on the track's device). ``shard`` = (rank, world): the track
    holds this rank's envs of a data-parallel run, and the slots are this rank's
    rows of the draw for all ``world`` ranks' envs."""
    rows, _ = trk.rows_of(track)
    start = trk.scalars_of(track)
    dtype = rows.wp_x.dtype
    dev = rows.wp_x.device
    n = start.n_wp.shape[0]
    a = cfg.num_agents
    if position_idx is None:
        if generator is None:
            raise ValueError("reset_state needs a generator or explicit position_idx")
        position_idx = draw_grid_slots(n, a, generator, dev, shard)
    position_idx = torch.as_tensor(position_idx, device=dev)

    spacing = cfg.car.width + 1.5
    center = (a - 1) / 2.0
    offset = (position_idx.to(dtype) - center) * spacing              # [N, A]
    x = start.start_x[:, None] + start.start_nx[:, None] * offset
    y = start.start_y[:, None] + start.start_ny[:, None] * offset
    zeros = torch.zeros((n, a), dtype=dtype, device=dev)
    false = torch.zeros((n, a), dtype=torch.bool, device=dev)
    izeros = torch.zeros((n, a), dtype=torch.int32, device=dev)
    return MultiState(
        x=x, y=y,
        angle=start.start_angle[:, None].to(dtype).expand(n, a).contiguous(),
        vx=zeros, vy=zeros, progress=zeros,
        crashed=false, finished=false,
        steps=torch.zeros((n,), dtype=torch.int32, device=dev),
        last_progress=zeros, last_steering=zeros,
        cp25=false, cp50=false, cp75=false,
        has_crashed=false,
        finished_step=izeros,
        placement=izeros,
    )


@functools.lru_cache(maxsize=16)
def _sensor_angles(cfg: MultiRacingConfig, dtype, device) -> torch.Tensor:
    # made once per device: a host-to-device copy on every step would stall it
    return torch.as_tensor(cfg.sensor_angles(), dtype=dtype, device=device)


@functools.lru_cache(maxsize=16)
def _opponent_index(num_agents: int, device) -> torch.Tensor:
    """[A, A-1]: the other seats of each seat, in seat order."""
    idx = [[j for j in range(num_agents) if j != i] for i in range(num_agents)]
    return torch.as_tensor(np.asarray(idx, np.int64).reshape(num_agents, num_agents - 1),
                           device=device)


def observe(cfg: MultiRacingConfig, track: Track, state: MultiState) -> torch.Tensor:
    """Per-car observations, float32 [N, A, obs_dim]: one kernel launch on the
    card, ``observe_plain`` on the CPU."""
    global observe_launches, observe_row_id_launches, observe_small_launches
    if not geo._on_cuda(state.x, "multi.observe"):
        return observe_plain(cfg, track, state)
    out, small = _observe_cuda(cfg, track, state)
    observe_launches += 1
    observe_row_id_launches += isinstance(track, trk.LAYOUTS)
    observe_small_launches += small
    return out


def observe_plain(cfg: MultiRacingConfig, track: Track, state: MultiState) -> torch.Tensor:
    """Plain version of ``observe``: the sensing kernel's wrapper and PyTorch."""
    dtype, dev = state.x.dtype, state.x.device
    n, a = state.x.shape
    rel = _sensor_angles(cfg, dtype, dev)                             # [R]
    rows, row_ids = trk.rows_of(track)
    dist = geo.raycast_walls_and_cars(
        state.x, state.y, state.angle, rel,
        rows.seg_sx, rows.seg_sy, rows.seg_vx, rows.seg_vy, rows.seg_c,
        cfg.car.length / 2, cfg.car.width / 2, cfg.max_sensor_range, row_ids=row_ids,
    )                                                                 # [N, A, R]
    if cfg.clamp_sensor_range:
        dist = torch.clamp_max(dist, cfg.max_sensor_range)
    rays = div_const(dist.to(torch.float32), cfg.max_sensor_range)

    ca = torch.cos(state.angle)
    sa = torch.sin(state.angle)
    max_speed = cfg.car.max_speed
    v_fwd = torch.clamp(div_const(state.vx * ca + state.vy * sa, max_speed), -1.0, 1.0)
    v_lat = torch.clamp(div_const(-state.vx * sa + state.vy * ca, max_speed), -1.0, 1.0)
    ang_vel = torch.zeros_like(v_fwd)  # reference quirk: always 0.0
    feats = torch.stack([v_fwd, v_lat, ang_vel, state.last_steering], dim=-1)

    # every ordered pair [N, i, j] at once, then seat i's opponents in seat order
    max_td = trk.scalars_of(track).max_track_distance[:, None, None].to(dtype)  # [N, 1, 1]
    rel_x = state.x[:, None, :] - state.x[:, :, None]
    rel_y = state.y[:, None, :] - state.y[:, :, None]
    rel_vx = state.vx[:, None, :] - state.vx[:, :, None]
    rel_vy = state.vy[:, None, :] - state.vy[:, :, None]
    ca_i, sa_i = ca[:, :, None], sa[:, :, None]
    lrx = torch.clamp((rel_x * ca_i + rel_y * sa_i) / max_td, -1.0, 1.0)
    lry = torch.clamp((-rel_x * sa_i + rel_y * ca_i) / max_td, -1.0, 1.0)
    lvx = torch.clamp(div_const(rel_vx * ca_i + rel_vy * sa_i, max_speed), -1.0, 1.0)
    lvy = torch.clamp(div_const(-rel_vx * sa_i + rel_vy * ca_i, max_speed), -1.0, 1.0)
    pair = torch.stack([lrx, lry, lvx, lvy], dim=-1)                  # [N, A, A, 4]
    idx = _opponent_index(a, dev)                                     # [A, A-1]
    opp = torch.take_along_dim(pair, idx[None, :, :, None], dim=2)    # [N, A, A-1, 4]
    opp = opp.reshape(n, a, 4 * (a - 1))
    # A == 1 gives an empty opponent block
    return torch.cat([rays, feats.to(torch.float32), opp.to(torch.float32)], dim=-1)


def _car_fields(name, state, extra, dev):
    """The state's float32 car fields and ``extra`` as the kernels take them:
    contiguous [N, A] on ``dev`` (a no-op for the env's own tensors)."""
    fields = [state.x, state.y, state.angle, state.vx, state.vy] + extra
    geo._check_f32(name, fields, dev)
    if any(t.shape != state.x.shape for t in fields) or state.x.ndim != 2:
        raise ValueError(f"{name}: the car fields must share one shape [N, A]")
    return [t.contiguous() for t in fields]


def _env_rows(name, track, n, dev):
    """(rows, row_ids) of ``track`` for one block per env: per-env rows [N, *] or
    a layout's pool with N row ids."""
    rows, row_ids = trk.rows_of(track)
    if row_ids is not None:
        geo._check_row_ids(name, row_ids, rows.wp_x.shape[0], dev)
        if row_ids.shape[0] != n:
            raise ValueError(f"{name}: {row_ids.shape[0]} row ids for {n} envs")
    elif rows.wp_x.shape[0] != n:
        raise ValueError(f"{name}: {rows.wp_x.shape[0]} track rows for {n} envs; the "
                         "kernel runs one block per env")
    return rows, row_ids


def _observe_cuda(cfg: MultiRacingConfig, track: Track, state: MultiState) -> torch.Tensor:
    """``observe`` on the card: a block per env or per few envs, which stages their
    segment rows (pool row ``row_ids[i]`` with ids) and writes their [A, obs_dim]
    rows. Returns (obs, whether the first kernel ran)."""
    dev = state.x.device
    n, a = state.x.shape
    x, y, angle, vx, vy, last_steering = _car_fields("multi.observe", state,
                                                     [state.last_steering], dev)
    rows, row_ids = _env_rows("multi.observe", track, n, dev)
    segs = [rows.seg_sx, rows.seg_sy, rows.seg_vx, rows.seg_vy, rows.seg_c]
    geo._check_f32("multi.observe", segs, dev)
    if any(t.ndim != 2 or t.shape != segs[0].shape or not t.is_contiguous() for t in segs):
        raise ValueError("multi.observe: the segment fields must share one contiguous "
                         "shape (rows, S)")
    num_segments = segs[0].shape[-1]
    plan = _cuda.multi_observe_plan(a, cfg.num_sensors, num_segments, n)  # refuses first
    max_td = trk.scalars_of(track).max_track_distance.to(torch.float32).contiguous()
    rel = _sensor_angles(cfg, torch.float32, dev)
    obs = torch.empty((n, a, cfg.obs_dim), dtype=torch.float32, device=dev)
    f32 = np.float32
    with torch.cuda.device(dev):
        _cuda.launch_multi_observe(
            x, y, angle, vx, vy, last_steering, max_td, rel, *segs, obs, n, a,
            cfg.num_sensors, num_segments, f32(cfg.car.length / 2), f32(cfg.car.width / 2),
            f32(cfg.max_sensor_range), f32_reciprocal(cfg.max_sensor_range),
            f32_reciprocal(cfg.car.max_speed), cfg.clamp_sensor_range, row_ids=row_ids)
    return obs, plan.small


def _transition_constants(cfg: MultiRacingConfig):
    """The transition kernel's float32 constants, in
    ``csrc/multi_transition.cu:multi_transition_f32``'s order: K5's eight, the
    half length and width, the collision scale, then the reward's (the float32
    reciprocals of max_speed and the time-bonus divisor, through which
    ``div_const`` divides, and the touch penalty negated), then ``reset_state``'s
    start-grid center and spacing as PyTorch takes the Python scalars."""
    f32 = np.float32
    return _step_constants(cfg.dt, cfg.car) + [
        f32(cfg.car.length / 2), f32(cfg.car.width / 2), f32(cfg.collision_speed_scale),
        f32(cfg.progress_scale), f32(cfg.speed_scale), f32_reciprocal(cfg.car.max_speed),
        f32(cfg.checkpoint_bonus), f32(cfg.finish_bonus), f32(cfg.time_bonus_base),
        f32_reciprocal(cfg.time_bonus_divisor), f32(cfg.crash_penalty),
        f32(-cfg.touch_penalty), f32(cfg.winner_bonus),
        f32((cfg.num_agents - 1) / 2.0), f32(cfg.car.width + 1.5)]


def transition(cfg: MultiRacingConfig, track: Track, state: MultiState, action):
    """One step without sensing: (new_state, rewards [N, A], terminated [N],
    truncated [N], info). ``action`` [N, A, 2]. ``terminated`` is the shared
    per-car done; the episode's done is ``terminated | truncated``. One kernel
    launch on the card, ``transition_plain`` on the CPU."""
    global transition_launches, transition_row_id_launches, transition_small_launches
    if not geo._on_cuda(state.x, "multi.transition"):
        return transition_plain(cfg, track, state, action)
    out, small = _transition_cuda(cfg, track, state, action)
    transition_launches += 1
    transition_row_id_launches += isinstance(track, trk.LAYOUTS)
    transition_small_launches += small
    return out


def _transition_cuda(cfg: MultiRacingConfig, track: Track, state: MultiState, action,
                     reset=None):
    """``transition`` on the card: a block per env or per few envs, which stages
    their waypoint rows (pool row ``row_ids[i]`` with ids), steps and queries their
    cars, runs the pair test with more than one car, and writes every output. With
    ``reset`` = (pending_reset, stats, rows, position_idx, pfsp) the kernel's
    autoreset mode. Returns (``transition``'s outputs, with ``reset`` a
    ``vector.StepOut``, and whether the first kernel ran)."""
    dev = state.x.device
    n, a = state.x.shape
    if action.shape != (n, a, 2) or action.device != dev:
        raise ValueError(f"multi.transition: action {tuple(action.shape)} on "
                         f"{action.device}, expected ({n}, {a}, 2) on {dev}")
    action = action.to(torch.float32).contiguous()
    cars = _car_fields("multi.transition", state, [state.progress, state.last_progress], dev)
    flags = [state.crashed, state.finished, state.cp25, state.cp50, state.cp75,
             state.has_crashed]
    ints = [state.finished_step, state.steps]
    if (any(t.dtype != torch.bool or t.shape != (n, a) or t.device != dev for t in flags)
            or any(t.dtype != torch.int32 or t.device != dev for t in ints)
            or state.finished_step.shape != (n, a) or state.steps.shape != (n,)):
        raise TypeError("multi.transition: the flags must be bool [N, A], finished_step "
                        "int32 [N, A] and steps int32 [N] on the cars' device")
    flags = [t.contiguous() for t in flags]
    ints = [t.contiguous() for t in ints]
    rows, row_ids = _env_rows("multi.transition", track, n, dev)
    wp = [rows.wp_x, rows.wp_y, rows.nrm_x, rows.nrm_y]
    geo._check_f32("multi.transition", wp, dev)
    if any(t.ndim != 2 or t.shape != wp[0].shape or not t.is_contiguous() for t in wp):
        raise ValueError("multi.transition: the waypoint fields must share one contiguous "
                         "shape (rows, W)")
    num_waypoints = wp[0].shape[-1]
    pairs = a > 1
    plan = _cuda.multi_transition_plan(a, num_waypoints, pairs, n)  # refuses first
    per_env = trk.scalars_of(track)
    n_wp, width = per_env.n_wp, per_env.track_width
    if (n_wp.dtype != torch.int32 or width.dtype != torch.float32 or n_wp.device != dev
            or width.device != dev or n_wp.shape != (n,) or width.shape != (n,)):
        raise TypeError("multi.transition: n_wp must be int32 [N] and track_width "
                        "float32 [N] on the cars' device")

    def new(dtype, shape=(n, a)):
        return torch.empty(shape, dtype=dtype, device=dev)

    f32, b8, i32 = torch.float32, torch.bool, torch.int32
    nx, ny, nang, nvx, nvy, progress, steering = (new(f32) for _ in range(7))
    crashed, finished, cp25, cp50, cp75, has_crashed = (new(b8) for _ in range(6))
    steps, finished_step, placement = new(i32, (n,)), new(i32), new(i32)
    reward, speed, info_progress = new(f32), new(f32), new(f32)
    terminated, truncated = new(b8, (n,)), new(b8, (n,))
    x, y, angle, vx, vy, old_progress, last_progress = cars
    if reset is None:
        reset_ptrs, outs, rollout_steps, pool, mode = [None] * _cuda.AUTORESET_PTRS, None, 0, 0, 0
    else:
        if a != cfg.num_agents:
            raise ValueError(f"multi.transition_autoreset: {a} cars a row, the config's "
                             f"start grid {cfg.num_agents}")
        pending_reset, stats, rows, position_idx, pfsp = reset
        reset_ptrs, outs, rollout_steps, pool, mode = vector.autoreset_args(
            "multi.transition_autoreset", n, dev, pending_reset, stats, rows, per_env,
            position_idx, pfsp, a)
    ptrs = [x, y, angle, vx, vy, flags[0], action, *wp, row_ids, n_wp.contiguous(),
            width.contiguous(), old_progress, last_progress, *flags[1:], *ints,
            nx, ny, nang, nvx, nvy, progress, steering, crashed, finished, cp25, cp50,
            cp75, has_crashed, steps, finished_step, placement, reward, terminated,
            truncated, speed, info_progress, *reset_ptrs]
    with torch.cuda.device(dev):
        _cuda.launch_multi_transition(ptrs, _transition_constants(cfg), n, a, num_waypoints,
                                      pairs, cfg.max_steps, dev, rollout_steps, pool, mode)
    new_state = MultiState(
        x=nx, y=ny, angle=nang, vx=nvx, vy=nvy,
        progress=progress, crashed=crashed, finished=finished,
        steps=steps, last_progress=progress, last_steering=steering,
        cp25=cp25, cp50=cp50, cp75=cp75,
        has_crashed=has_crashed, finished_step=finished_step, placement=placement,
    )
    info = {
        "x": nx, "y": ny, "speed": speed, "progress": info_progress,
        "crashed": crashed, "finished": finished,
        "reward": reward, "placement": placement,
    }
    if reset is None:
        return (new_state, reward, terminated, truncated, info), plan.small
    return outs.step_out(new_state, reward[:, 0], terminated, truncated, info,
                         reset[0]), plan.small


class PFSP(NamedTuple):
    """A pool's opponents for the PFSP counts: ``idx`` the slot (int32 or int64, [N]
    or 0-d), ``use_policy`` (bool, [N] or 0-d), ``extra`` float32 [2 * pool] that
    ``pfsp_counts`` is added into; on the card ``counts``, the kernel's scratch: int32
    [2 * pool + 1] (the slots' wins, their games, then the launch's ticket), zero,
    which every launch leaves zero, so that a CUDA graph's replays need no memset."""

    idx: torch.Tensor
    use_policy: torch.Tensor
    extra: torch.Tensor
    counts: torch.Tensor = None


def pfsp_counts(idx, use_policy, mask, placement, pool: int) -> torch.Tensor:
    """Per-slot [wins..., games...] float32 [2 * pool] of the episodes that ended
    (``mask`` [N]) against a policy opponent, a win where seat 0's ``placement`` [N]
    is 1 (the JAX package's ``agent/self_play.py:65`` stats)."""
    idx = idx.expand(mask.shape)
    ended = mask & use_policy.expand(mask.shape)
    won = ended & (placement == 1)
    onehot = idx[:, None] == torch.arange(pool, device=idx.device)[None, :]
    wins = torch.sum(onehot & won[:, None], dim=0, dtype=torch.float32)
    games = torch.sum(onehot & ended[:, None], dim=0, dtype=torch.float32)
    return torch.cat([wins, games])


def transition_autoreset(cfg: MultiRacingConfig, track: Track, state: MultiState, action,
                         pending_reset, stats: vector.EpisodeStats, position_idx,
                         rows: vector.RolloutRows = None,
                         pfsp: PFSP = None) -> vector.StepOut:
    """``transition``, ``reset_state`` on the grid slots ``position_idx`` [N, A] and
    ``vector.autoreset`` (with ``info_from_state``) in one, over seat 0's episode: the
    rows in ``pending_reset`` [N] take the fresh state, ``stats`` and the returned
    reward are seat 0's (the info stays every seat's). With ``rows``, also row
    ``rows.t`` of a rollout's buffers and ``rows.t_next``; with ``pfsp``,
    ``pfsp_counts`` added into ``pfsp.extra``. One launch of the transition kernel in
    its autoreset mode on the card, ``transition_autoreset_plain`` on the CPU."""
    global transition_launches, transition_row_id_launches, transition_small_launches
    global transition_autoreset_launches, transition_autoreset_small_launches
    if not geo._on_cuda(state.x, "multi.transition_autoreset"):
        return transition_autoreset_plain(cfg, track, state, action, pending_reset, stats,
                                          position_idx, rows, pfsp)
    out, small = _transition_cuda(cfg, track, state, action,
                                  reset=(pending_reset, stats, rows, position_idx, pfsp))
    transition_launches += 1
    transition_row_id_launches += isinstance(track, trk.LAYOUTS)
    transition_small_launches += small
    transition_autoreset_launches += 1
    transition_autoreset_small_launches += small
    return out


def transition_autoreset_plain(cfg: MultiRacingConfig, track: Track, state: MultiState,
                               action, pending_reset, stats: vector.EpisodeStats,
                               position_idx, rows: vector.RolloutRows = None,
                               pfsp: PFSP = None) -> vector.StepOut:
    """Plain version of ``transition_autoreset``: ``transition_plain``, then
    ``autoreset_plain``."""
    return autoreset_plain(cfg, track, transition_plain(cfg, track, state, action),
                           pending_reset, stats, position_idx, rows, pfsp)


def autoreset_plain(cfg: MultiRacingConfig, track: Track, transitioned, pending_reset,
                    stats: vector.EpisodeStats, position_idx,
                    rows: vector.RolloutRows = None, pfsp: PFSP = None) -> vector.StepOut:
    """What the autoreset mode adds to a transition, in PyTorch, after
    ``transitioned`` (``transition``'s outputs): ``reset_state`` on the grid slots,
    ``vector.autoreset`` on seat 0's reward with ``info_from_state``, the rows as
    ``vector.write_rows`` writes them and ``pfsp_counts`` added into ``pfsp.extra``."""
    stepped, rewards, terminated, truncated, info = transitioned
    fresh = reset_state(cfg, track, position_idx=position_idx)
    out = vector.autoreset(pending_reset, stats, stepped, fresh, rewards[:, 0], terminated,
                           truncated, info, lambda merged: info_from_state(cfg, track, merged))
    if rows is not None:
        vector.write_rows(rows, out.reward, out.record)
        torch.add(rows.t, 1, out=rows.t_next)
    if pfsp is not None:
        pfsp.extra.add_(pfsp_counts(pfsp.idx, pfsp.use_policy, out.record["mask"],
                                    out.info["placement"][:, 0], pfsp.extra.shape[0] // 2))
    return out


def transition_plain(cfg: MultiRacingConfig, track: Track, state: MultiState, action):
    """Plain version of ``transition``: the transition kernel's wrapper
    (``car_step_and_query`` with the pair test) and PyTorch."""
    dtype = state.x.dtype
    n, a = state.x.shape

    steering = torch.clamp(action[..., 0].to(dtype), -1.0, 1.0)
    throttle = torch.clamp((action[..., 1].to(dtype) + 1.0) / 2.0, 0.0, 1.0)

    # the step, the track query and, with more than one car, the car-car contacts
    # (every pair's SAT test; a car's velocity scaled once per partner it touches)
    rows, row_ids = trk.rows_of(track)
    per_env = trk.scalars_of(track)
    nx, ny, nang, nvx, nvy, ccx, ccy, raw_progress, hit_wall, *contacts = car_step_and_query(
        state.x, state.y, state.angle, state.vx, state.vy, state.crashed,
        steering, throttle, cfg.dt, cfg.car,
        rows.wp_x[:, None, :], rows.wp_y[:, None, :],
        rows.nrm_x[:, None, :], rows.nrm_y[:, None, :],
        per_env.n_wp[:, None], per_env.track_width[:, None],
        collision_speed_scale=cfg.collision_speed_scale if a > 1 else None,
        row_ids=row_ids,
    )
    new_progress = torch.where(state.crashed, state.progress, raw_progress)
    crashed = state.crashed | (~state.crashed & hit_wall)

    if a > 1:
        num_hits, = contacts                                          # [N, A]
        touch_penalty = -cfg.touch_penalty * num_hits.to(dtype)
    else:
        touch_penalty = torch.zeros((n, a), dtype=dtype, device=state.x.device)

    steps = state.steps + 1
    p, lp = new_progress, state.last_progress

    # reward, in the reference's order: progress, speed, checkpoints, finish, crash
    delta = p - lp
    delta = torch.where((lp > 0.9) & (p < 0.1), (1.0 - lp) + p, delta)
    delta = torch.where((lp < 0.1) & (p > 0.9), -((1.0 - p) + lp), delta)

    reward = delta * cfg.progress_scale

    speed = torch.sqrt(nvx * nvx + nvy * nvy)
    speed_ratio = torch.clamp(div_const(speed, cfg.car.max_speed), 0.0, 1.0)
    reward = reward + torch.where(~crashed & (delta > 0), speed_ratio * cfg.speed_scale,
                                  0.0)

    hit25 = ~state.cp25 & (p >= 0.25) & (p < 0.35)
    cp25 = state.cp25 | hit25
    hit50 = cp25 & ~state.cp50 & (p >= 0.50) & (p < 0.60)
    cp50 = state.cp50 | hit50
    hit75 = cp50 & ~state.cp75 & (p >= 0.75) & (p < 0.85)
    cp75 = state.cp75 | hit75
    reward = reward + cfg.checkpoint_bonus * (hit25 | hit50 | hit75).to(dtype)

    fin_now = cp25 & cp50 & cp75 & (lp > 0.9) & (p < 0.1) & (delta > 0)
    finished = state.finished | fin_now
    finished_step = torch.where(fin_now, steps[:, None], state.finished_step)
    time_bonus = torch.clamp_min(
        cfg.time_bonus_base - div_const(steps.to(dtype), cfg.time_bonus_divisor)[:, None],
        0.0)
    reward = reward + torch.where(fin_now, cfg.finish_bonus + time_bonus, 0.0)

    crash_now = crashed & ~state.has_crashed
    reward = reward - torch.where(crash_now, cfg.crash_penalty, 0.0)
    has_crashed = state.has_crashed | crash_now

    reward = reward + touch_penalty

    terminated = finished.any(dim=-1) | crashed.all(dim=-1)
    truncated = steps >= cfg.max_steps
    done_all = terminated | truncated

    # placement at episode end: descending score, the higher seat wins exact ties
    fs = torch.where(finished_step != 0, finished_step, 10000).to(dtype)
    score = (finished.to(dtype) * 10000.0 + new_progress * 100.0
             + (~crashed).to(dtype) * 10.0 + const_div(1.0, fs))
    seat = torch.arange(a, device=score.device)
    beats = (score[:, :, None] < score[:, None, :]) | (
        (score[:, :, None] == score[:, None, :]) & (seat[:, None] < seat[None, :]))
    place = 1 + beats.sum(dim=-1).to(torch.int32)                     # [N, A]
    placement = torch.where(done_all[:, None], place, 0).to(torch.int32)
    reward = reward + torch.where(done_all[:, None] & (place == 1), cfg.winner_bonus, 0.0)

    new_state = MultiState(
        x=nx, y=ny, angle=nang, vx=nvx, vy=nvy,
        progress=new_progress, crashed=crashed, finished=finished,
        steps=steps, last_progress=new_progress, last_steering=steering,
        cp25=cp25, cp50=cp50, cp75=cp75,
        has_crashed=has_crashed, finished_step=finished_step, placement=placement,
    )
    info = {
        "x": nx, "y": ny, "speed": speed,
        "progress": torch.where(finished, torch.ones_like(new_progress), new_progress),
        "crashed": crashed, "finished": finished,
        "reward": reward, "placement": placement,
    }
    return new_state, reward, terminated, truncated, info


def info_from_state(cfg: MultiRacingConfig, track: Track, state: MultiState):
    """Info for a state outside any transition (the reset-info contract):
    ``transition``'s schema with reward zeroed."""
    speed = torch.sqrt(state.vx * state.vx + state.vy * state.vy)
    return {
        "x": state.x, "y": state.y, "speed": speed,
        "progress": torch.where(state.finished, torch.ones_like(state.progress),
                                state.progress),
        "crashed": state.crashed, "finished": state.finished,
        "reward": torch.zeros_like(speed), "placement": state.placement,
    }


def reset(cfg: MultiRacingConfig, track: Track, generator=None, position_idx=None):
    """(state, obs) for a fresh batch."""
    state = reset_state(cfg, track, generator, position_idx)
    return state, observe(cfg, track, state)


def step(cfg: MultiRacingConfig, track: Track, state: MultiState, action):
    """Full env step: (new_state, obs, reward, terminated, truncated, info)."""
    new_state, reward, terminated, truncated, info = transition(cfg, track, state, action)
    return new_state, observe(cfg, track, new_state), reward, terminated, truncated, info

"""Single-car racing env as batched PyTorch functions (port of
``self_play_racing_tpu/envs/single.py``).

Branch-free over a leading ``[num_envs]`` axis:

 - obs = ``num_sensors`` rays in a +-pi/3 cone + [v_fwd, v_lat, ang_vel, steering],
   normalized. The angular-velocity feature is always 0.0 (a reference quirk).
 - reward = 200*dprogress (with start/finish wraparound) + gated checkpoint bonuses
   (20 at 0.25/0.50/0.75) + speed*speed_weight while progressing - 60 on crash
   + finish bonus 100 + max(0, 200 - steps/10).
 - terminated = crashed | finished; truncated at ``max_steps``.

``transition`` (state, reward, done; no sensing) and ``observe`` (raycast + kinematic
features) are separate so the autoreset wrapper can merge stepped and reset states
first and raycast once per step. Observations are float32: ray hits are cast to f32
before normalization, the other features are computed at state dtype and cast last.
The geometry is per-env ``TrackArrays`` or a capacity layout (``envs/track.py``),
whose resident pool rows the kernels read by row id.

On the card an env step is two kernel launches: ``transition`` is
``csrc/single_transition.cu`` (K5, the corners and K2 of each car against its
waypoint row, and the whole reward and termination tail; a warp a row,
``ops/_cuda.py:single_transition_plan``, and on the tiled layout from
``SINGLE_TRANSITION_ROWS_FROM`` rows the same file's kernel of several rows a block,
the step and the tail a thread a car, whose rows share one staged pool row), and
``observe`` is the multi-car env's observation kernel at one car a row without its
car pass, a row's rays in several groups (``csrc/multi_observe.cu``,
``ops/_cuda.py:single_observe_plan``), which writes the whole observation row. Both
raise on what they do not take (float64 among it); nothing falls back. On CPU
tensors they run ``transition_plain`` and ``observe_plain``: the narrow kernels'
wrappers (``car_step_and_query``, ``geo.raycast_walls``, which take their own plain
versions there) and PyTorch around them, the composition the kernels are held to
bitwise on the card. ``transition_launches`` and ``observe_launches`` count the
kernels' launches, ``*_row_id_launches`` those reading pool rows by id and
``transition_rows_launches`` those of the transition's kernel of several rows a block.

``transition_autoreset`` is a vector step's transition with its NEXT_STEP autoreset
(``vector.autoreset``: the reset rows' fresh state and info, the masks, the episode
statistics and a rollout's rows of the step): on the card the same launch in the
kernels' autoreset mode (``csrc/autoreset.cuh``), counted also as
``transition_autoreset_launches`` (``transition_autoreset_rows_launches`` by the
kernel of several rows a block); on the CPU ``transition_autoreset_plain``, the
composition the mode is held to bitwise on the card.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .._numerics import div_const, f32_reciprocal
from ..ops import _cuda
from ..ops import geometry as geo
from ..ops.dynamics import DEFAULT_CAR, CarSpec, _step_constants, car_step_and_query
from . import track as trk
from . import vector
from .multi import _env_rows
from .track import Track

observe_launches = 0
observe_row_id_launches = 0
transition_launches = 0
transition_row_id_launches = 0
transition_rows_launches = 0
transition_autoreset_launches = 0
transition_autoreset_rows_launches = 0


@dataclasses.dataclass(frozen=True)
class RacingConfig:
    """Static configuration (shapes and reward constants)."""

    num_sensors: int = 7
    max_sensor_range: float = 50.0
    sensor_cone: float = float(np.pi / 3)
    # Clamp sensor reads to max_sensor_range. False keeps the reference's
    # unclamped-hit quirk (a hit beyond max range is returned as is).
    clamp_sensor_range: bool = False
    dt: float = 0.05
    max_steps: int = 3000
    speed_weight: float = 8.0
    car: CarSpec = DEFAULT_CAR

    progress_scale: float = 200.0
    checkpoint_bonus: float = 20.0
    crash_penalty: float = 60.0
    finish_bonus: float = 100.0
    time_bonus_base: float = 200.0
    time_bonus_divisor: float = 10.0

    @property
    def obs_dim(self) -> int:
        return self.num_sensors + 4

    @property
    def action_dim(self) -> int:
        return 2

    def sensor_angles(self) -> np.ndarray:
        """Relative sensor angles (np.linspace over the cone)."""
        return np.linspace(-self.sensor_cone, self.sensor_cone, self.num_sensors)


@dataclasses.dataclass
class CarState:
    """Batched car state, one entry per env."""

    x: torch.Tensor
    y: torch.Tensor
    angle: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    progress: torch.Tensor
    crashed: torch.Tensor   # bool
    finished: torch.Tensor  # bool


@dataclasses.dataclass
class RacingState:
    """Batched env state."""

    car: CarState
    steps: torch.Tensor          # int32
    last_progress: torch.Tensor
    last_steering: torch.Tensor
    cp25: torch.Tensor           # bool checkpoint flags
    cp50: torch.Tensor
    cp75: torch.Tensor


def reset_state(cfg: RacingConfig, track: Track) -> RacingState:
    """Fresh state for every env in the batch."""
    rows, _ = trk.rows_of(track)
    start = trk.scalars_of(track)
    dtype = rows.wp_x.dtype
    dev = rows.wp_x.device
    n = start.n_wp.shape[0]
    zeros = torch.zeros((n,), dtype=dtype, device=dev)
    false = torch.zeros((n,), dtype=torch.bool, device=dev)
    car = CarState(
        x=start.start_x.to(dtype).clone(),
        y=start.start_y.to(dtype).clone(),
        angle=start.start_angle.to(dtype).clone(),
        vx=zeros, vy=zeros, progress=zeros,
        crashed=false, finished=false,
    )
    return RacingState(
        car=car,
        steps=torch.zeros((n,), dtype=torch.int32, device=dev),
        last_progress=zeros, last_steering=zeros,
        cp25=false, cp50=false, cp75=false,
    )


@functools.lru_cache(maxsize=16)
def _sensor_angles(cfg: RacingConfig, dtype, device) -> torch.Tensor:
    # made once per device: a host-to-device copy on every step would stall it
    return torch.as_tensor(cfg.sensor_angles(), dtype=dtype, device=device)


def observe(cfg: RacingConfig, track: Track, state: RacingState) -> torch.Tensor:
    """Observation per env, float32 [N, num_sensors + 4]: one kernel launch on the
    card, ``observe_plain`` on the CPU."""
    global observe_launches, observe_row_id_launches
    if not geo._on_cuda(state.car.x, "single.observe"):
        return observe_plain(cfg, track, state)
    out = _observe_cuda(cfg, track, state)
    observe_launches += 1
    observe_row_id_launches += isinstance(track, trk.LAYOUTS)
    return out


def observe_plain(cfg: RacingConfig, track: Track, state: RacingState) -> torch.Tensor:
    """Plain version of ``observe``: K1's wrapper and PyTorch."""
    car = state.car
    dtype = car.x.dtype
    rows, row_ids = trk.rows_of(track)
    rel = _sensor_angles(cfg, dtype, car.x.device)                    # [R]
    world = car.angle[:, None] + rel[None, :]                         # [N, R]
    dist = geo.raycast_walls(
        car.x[:, None].expand(world.shape),
        car.y[:, None].expand(world.shape),
        torch.cos(world), torch.sin(world),
        rows.seg_sx[:, None, :], rows.seg_sy[:, None, :],
        rows.seg_vx[:, None, :], rows.seg_vy[:, None, :],
        cfg.max_sensor_range,
        seg_c=rows.seg_c[:, None, :], row_ids=row_ids,
    )                                                                 # [N, R]
    if cfg.clamp_sensor_range:
        dist = torch.clamp_max(dist, cfg.max_sensor_range)
    rays = div_const(dist.to(torch.float32), cfg.max_sensor_range)

    ca = torch.cos(car.angle)
    sa = torch.sin(car.angle)
    max_speed = cfg.car.max_speed
    v_fwd = torch.clamp(div_const(car.vx * ca + car.vy * sa, max_speed), -1.0, 1.0)
    v_lat = torch.clamp(div_const(-car.vx * sa + car.vy * ca, max_speed), -1.0, 1.0)
    ang_vel = torch.zeros_like(v_fwd)  # reference quirk: always 0.0
    feats = torch.stack([v_fwd, v_lat, ang_vel, state.last_steering], dim=-1)
    return torch.cat([rays, feats.to(torch.float32)], dim=-1)


def _car_fields(name, fields, n, dev):
    """The state's float32 fields as the kernels take them: contiguous [N] on
    ``dev`` (a no-op for the env's own tensors)."""
    geo._check_f32(name, fields, dev)
    if any(t.shape != (n,) for t in fields):
        raise ValueError(f"{name}: the car fields must share one shape [N]")
    return [t.contiguous() for t in fields]


def _row_period(track: Track) -> int:
    """T where env i reads pool row i % T (the tiled layout, whose rows T apart the
    kernels stage once for a block), else 0."""
    return trk.rows_of(track)[0].wp_x.shape[0] if isinstance(track, trk.TiledPooledTracks) else 0


def _observe_cuda(cfg: RacingConfig, track: Track, state: RacingState) -> torch.Tensor:
    """``observe`` on the card: the multi-car observation at one car a row with the
    car pass left out (a row's only car is the observer, whose rays see the walls
    alone), as ``single_observe_plan`` says, writing the [N, num_sensors + 4] rows."""
    car = state.car
    dev, n = car.x.device, car.x.shape[0]
    x, y, angle, vx, vy, last_steering = _car_fields(
        "single.observe", [car.x, car.y, car.angle, car.vx, car.vy, state.last_steering], n,
        dev)
    rows, row_ids = _env_rows("single.observe", track, n, dev)
    segs = [rows.seg_sx, rows.seg_sy, rows.seg_vx, rows.seg_vy, rows.seg_c]
    geo._check_f32("single.observe", segs, dev)
    if any(t.ndim != 2 or t.shape != segs[0].shape or not t.is_contiguous() for t in segs):
        raise ValueError("single.observe: the segment fields must share one contiguous "
                         "shape (rows, S)")
    num_segments = segs[0].shape[-1]
    period = _row_period(track)
    plan = _cuda.single_observe_plan(cfg.num_sensors, num_segments, period > 0, n)  # refuses first
    max_td = trk.scalars_of(track).max_track_distance.to(torch.float32).contiguous()
    rel = _sensor_angles(cfg, torch.float32, dev)
    obs = torch.empty((n, cfg.obs_dim), dtype=torch.float32, device=dev)
    f32 = np.float32
    with torch.cuda.device(dev):
        _cuda.launch_multi_observe(
            x, y, angle, vx, vy, last_steering, max_td, rel, *segs, obs, n, 1,
            cfg.num_sensors, num_segments, f32(cfg.car.length / 2), f32(cfg.car.width / 2),
            f32(cfg.max_sensor_range), f32_reciprocal(cfg.max_sensor_range),
            f32_reciprocal(cfg.car.max_speed), cfg.clamp_sensor_range, row_ids=row_ids,
            cars=False, plan=plan, row_period=period)
    return obs


def _transition_constants(cfg: RacingConfig, speed_weight: float):
    """The transition kernel's float32 constants, in
    ``csrc/single_transition.cu:single_transition_f32``'s order: K5's eight, the
    half length and width, then the tail's (the float32 reciprocals of max_speed and
    the time-bonus divisor, through which ``div_const`` divides, and the speed weight
    the kernel takes where no tensor is given)."""
    f32 = np.float32
    return _step_constants(cfg.dt, cfg.car) + [
        f32(cfg.car.length / 2), f32(cfg.car.width / 2), f32(cfg.progress_scale),
        f32(cfg.checkpoint_bonus), f32_reciprocal(cfg.car.max_speed), f32(speed_weight),
        f32(cfg.crash_penalty), f32(cfg.finish_bonus), f32(cfg.time_bonus_base),
        f32_reciprocal(cfg.time_bonus_divisor)]


def transition(cfg: RacingConfig, track: Track, state: RacingState, action,
               speed_weight=None):
    """One env step without sensing: (new_state, reward, terminated, truncated, info).

    ``action``: [N, 2] raw policy output; steering clipped to [-1, 1], throttle to
    [0, 1]. ``speed_weight`` may be a tensor (annealing); defaults to the config's.
    One kernel launch on the card, ``transition_plain`` on the CPU.
    """
    global transition_launches, transition_row_id_launches, transition_rows_launches
    if not geo._on_cuda(state.car.x, "single.transition"):
        return transition_plain(cfg, track, state, action, speed_weight)
    out, by_rows = _transition_cuda(cfg, track, state, action, speed_weight)
    transition_launches += 1
    transition_row_id_launches += isinstance(track, trk.LAYOUTS)
    transition_rows_launches += by_rows
    return out


def _transition_cuda(cfg: RacingConfig, track: Track, state: RacingState, action,
                     speed_weight=None, reset=None):
    """``transition`` on the card, as ``_cuda.launch_single_transition`` says (a
    warp a row; on the tiled layout, whose period it is given, several rows a
    block): each env row's waypoint row staged (pool row ``row_ids[i]`` with ids), its
    car stepped, queried and its tail run, every output written. A speed-weight
    tensor on the card is read there (float32, one value), so that a captured rollout
    sees each update's anneal; a number or a CPU tensor is taken as a float32
    constant. With ``reset`` = (pending_reset, stats, rows) the kernel's autoreset
    mode. Returns the step's outputs (with ``reset`` a ``vector.StepOut``) and whether
    the kernel of several rows a block ran."""
    car = state.car
    dev, n = car.x.device, car.x.shape[0]
    x, y, angle, vx, vy, old_progress, last_progress = _car_fields(
        "single.transition", [car.x, car.y, car.angle, car.vx, car.vy, car.progress,
                              state.last_progress], n, dev)
    flags = [car.crashed, car.finished, state.cp25, state.cp50, state.cp75]
    if (any(t.dtype != torch.bool or t.shape != (n,) or t.device != dev for t in flags)
            or state.steps.dtype != torch.int32 or state.steps.shape != (n,)
            or state.steps.device != dev):
        raise TypeError("single.transition: the flags must be bool [N] and steps int32 [N] "
                        "on the cars' device")
    flags = [t.contiguous() for t in flags]
    if action.device != dev or action.ndim != 2 or action.shape[0] != n or action.shape[1] < 2:
        raise ValueError(f"single.transition: action {tuple(action.shape)} on "
                         f"{action.device}, expected ({n}, 2) on {dev}")
    action = action.to(torch.float32)
    if action.stride(-1) != 1 or (n > 1 and action.stride(0) < 2):
        action = action.contiguous()
    on_card = isinstance(speed_weight, torch.Tensor) and speed_weight.device.type != "cpu"
    if on_card and (speed_weight.device != dev or speed_weight.dtype != torch.float32
                    or speed_weight.numel() != 1):
        raise TypeError("single.transition: a speed-weight tensor on the card must be one "
                        "float32 value on the cars' device")
    sw = speed_weight if on_card else None
    constants = _transition_constants(
        cfg, cfg.speed_weight if speed_weight is None or on_card else float(speed_weight))
    rows, row_ids = _env_rows("single.transition", track, n, dev)
    wp = [rows.wp_x, rows.wp_y, rows.nrm_x, rows.nrm_y]
    geo._check_f32("single.transition", wp, dev)
    if any(t.ndim != 2 or t.shape != wp[0].shape or not t.is_contiguous() for t in wp):
        raise ValueError("single.transition: the waypoint fields must share one contiguous "
                         "shape (rows, W)")
    num_waypoints = wp[0].shape[-1]
    _cuda.single_transition_plan(num_waypoints)  # refuses first
    per_env = trk.scalars_of(track)
    n_wp, width = per_env.n_wp, per_env.track_width
    if (n_wp.dtype != torch.int32 or width.dtype != torch.float32 or n_wp.device != dev
            or width.device != dev or n_wp.shape != (n,) or width.shape != (n,)):
        raise TypeError("single.transition: n_wp must be int32 [N] and track_width "
                        "float32 [N] on the cars' device")

    def new(dtype):
        return torch.empty((n,), dtype=dtype, device=dev)

    f32, b8 = torch.float32, torch.bool
    nx, ny, nang, nvx, nvy, progress, steering = (new(f32) for _ in range(7))
    crashed, finished, cp25, cp50, cp75 = (new(b8) for _ in range(5))
    new_steps, reward, speed, info_progress, delta = (
        new(torch.int32), new(f32), new(f32), new(f32), new(f32))
    terminated, truncated = new(b8), new(b8)
    if reset is None:
        reset_ptrs, outs, steps = [None] * _cuda.AUTORESET_PTRS, None, 0
    else:
        reset_ptrs, outs, steps, _, _ = vector.autoreset_args(
            "single.transition_autoreset", n, dev, *reset, per_env)
    ptrs = [x, y, angle, vx, vy, flags[0], action, *wp, row_ids, n_wp.contiguous(),
            width.contiguous(), old_progress, last_progress, *flags[1:],
            state.steps.contiguous(), sw,
            nx, ny, nang, nvx, nvy, progress, steering, crashed, finished, cp25, cp50, cp75,
            new_steps, reward, terminated, truncated, speed, info_progress, delta,
            *reset_ptrs]
    with torch.cuda.device(dev):
        by_rows = _cuda.launch_single_transition(
            ptrs, constants, n, num_waypoints, cfg.max_steps,
            action.stride(0) if n > 1 else 2, dev, row_period=_row_period(track), steps=steps)
    new_state = RacingState(
        car=CarState(x=nx, y=ny, angle=nang, vx=nvx, vy=nvy,
                     progress=progress, crashed=crashed, finished=finished),
        steps=new_steps,
        last_progress=progress,
        last_steering=steering,
        cp25=cp25, cp50=cp50, cp75=cp75,
    )
    info = {
        "x": nx, "y": ny, "speed": speed, "progress": info_progress,
        "crashed": crashed, "finished": finished,
        "reward": reward, "progress_delta": delta,
    }
    if reset is None:
        return (new_state, reward, terminated, truncated, info), by_rows
    return outs.step_out(new_state, reward, terminated, truncated, info, reset[0]), by_rows


def transition_autoreset(cfg: RacingConfig, track: Track, state: RacingState, action,
                         pending_reset, stats: vector.EpisodeStats, speed_weight=None,
                         rows: vector.RolloutRows = None) -> vector.StepOut:
    """``transition``, ``reset_state`` and ``vector.autoreset`` (with
    ``info_from_state``) in one: the rows in ``pending_reset`` [N] take the fresh
    state, and ``stats`` the step's reward. With ``rows``, also row ``rows.t`` of a
    rollout's buffers and ``rows.t_next``. One launch of the transition kernel in its
    autoreset mode on the card, ``transition_autoreset_plain`` on the CPU."""
    global transition_launches, transition_row_id_launches, transition_rows_launches
    global transition_autoreset_launches, transition_autoreset_rows_launches
    if not geo._on_cuda(state.car.x, "single.transition_autoreset"):
        return transition_autoreset_plain(cfg, track, state, action, pending_reset, stats,
                                          speed_weight, rows)
    out, by_rows = _transition_cuda(cfg, track, state, action, speed_weight,
                                    reset=(pending_reset, stats, rows))
    transition_launches += 1
    transition_row_id_launches += isinstance(track, trk.LAYOUTS)
    transition_rows_launches += by_rows
    transition_autoreset_launches += 1
    transition_autoreset_rows_launches += by_rows
    return out


def transition_autoreset_plain(cfg: RacingConfig, track: Track, state: RacingState, action,
                               pending_reset, stats: vector.EpisodeStats, speed_weight=None,
                               rows: vector.RolloutRows = None) -> vector.StepOut:
    """Plain version of ``transition_autoreset``: ``transition_plain``, then
    ``autoreset_plain``."""
    return autoreset_plain(cfg, track,
                           transition_plain(cfg, track, state, action, speed_weight),
                           pending_reset, stats, rows)


def autoreset_plain(cfg: RacingConfig, track: Track, transitioned, pending_reset,
                    stats: vector.EpisodeStats,
                    rows: vector.RolloutRows = None) -> vector.StepOut:
    """What the autoreset mode adds to a transition, in PyTorch, after
    ``transitioned`` (``transition``'s outputs): ``reset_state``,
    ``vector.autoreset`` with ``info_from_state`` and the rows as
    ``vector.write_rows`` writes them."""
    stepped, reward, terminated, truncated, info = transitioned
    out = vector.autoreset(pending_reset, stats, stepped, reset_state(cfg, track), reward,
                           terminated, truncated, info,
                           lambda merged: info_from_state(cfg, track, merged))
    if rows is not None:
        vector.write_rows(rows, out.reward, out.record)
        torch.add(rows.t, 1, out=rows.t_next)
    return out


def transition_plain(cfg: RacingConfig, track: Track, state: RacingState, action,
                     speed_weight=None):
    """Plain version of ``transition``: the transition kernel's wrapper
    (``car_step_and_query``) and PyTorch."""
    dtype = state.car.x.dtype
    car = state.car
    sw = cfg.speed_weight if speed_weight is None else speed_weight

    steering = torch.clamp(action[..., 0].to(dtype), -1.0, 1.0)
    throttle = torch.clamp(action[..., 1].to(dtype), 0.0, 1.0)

    # dynamics, then progress + wall collision (frozen once crashed) of the new
    # pose's centre and corners
    rows, row_ids = trk.rows_of(track)
    per_env = trk.scalars_of(track)
    nx, ny, nang, nvx, nvy, _, _, raw_progress, hit_wall = car_step_and_query(
        car.x, car.y, car.angle, car.vx, car.vy, car.crashed,
        steering, throttle, cfg.dt, cfg.car,
        rows.wp_x, rows.wp_y, rows.nrm_x, rows.nrm_y,
        per_env.n_wp, per_env.track_width, row_ids=row_ids,
    )
    new_progress = torch.where(car.crashed, car.progress, raw_progress)
    crashed = car.crashed | (~car.crashed & hit_wall)

    steps = state.steps + 1
    p, lp = new_progress, state.last_progress

    # dprogress with start/finish-line wraparound
    delta = p - lp
    delta = torch.where((lp > 0.9) & (p < 0.1), (1.0 - lp) + p, delta)
    delta = torch.where((lp < 0.1) & (p > 0.9), -((1.0 - p) + lp), delta)

    reward = delta * cfg.progress_scale

    # gated checkpoints, +20 each; the windows are disjoint, so at most one fires
    hit25 = ~state.cp25 & (p >= 0.25) & (p < 0.35)
    cp25 = state.cp25 | hit25
    hit50 = cp25 & ~state.cp50 & (p >= 0.50) & (p < 0.60)
    cp50 = state.cp50 | hit50
    hit75 = cp50 & ~state.cp75 & (p >= 0.75) & (p < 0.85)
    cp75 = state.cp75 | hit75
    reward = reward + cfg.checkpoint_bonus * (hit25 | hit50 | hit75).to(dtype)

    # speed shaping while progressing
    speed = torch.sqrt(nvx * nvx + nvy * nvy)
    speed_ratio = torch.clamp(div_const(speed, cfg.car.max_speed), 0.0, 1.0)
    reward = torch.where(~crashed & (delta > 0), reward + speed_ratio * sw, reward)

    # crash penalty (terminal, so it fires once per episode)
    reward = torch.where(crashed, reward - cfg.crash_penalty, reward)

    # lap completion; two separate adds, in the reference's order
    fin_now = cp25 & cp50 & cp75 & (lp > 0.9) & (p < 0.1) & (delta > 0)
    finished = car.finished | fin_now
    time_bonus = torch.clamp_min(
        cfg.time_bonus_base - div_const(steps.to(dtype), cfg.time_bonus_divisor), 0.0)
    reward = torch.where(fin_now, reward + cfg.finish_bonus, reward)
    reward = torch.where(fin_now, reward + time_bonus, reward)

    terminated = crashed | finished
    truncated = steps >= cfg.max_steps

    new_state = RacingState(
        car=CarState(x=nx, y=ny, angle=nang, vx=nvx, vy=nvy,
                     progress=new_progress, crashed=crashed, finished=finished),
        steps=steps,
        last_progress=new_progress,
        last_steering=steering,
        cp25=cp25, cp50=cp50, cp75=cp75,
    )
    info = {
        "x": nx, "y": ny,
        "speed": speed,
        "progress": torch.where(finished, torch.ones_like(new_progress), new_progress),
        "crashed": crashed,
        "finished": finished,
        "reward": reward,
        "progress_delta": delta,
    }
    return new_state, reward, terminated, truncated, info


def info_from_state(cfg: RacingConfig, track: Track, state: RacingState):
    """Info for a state outside any transition (the reset-info contract): the
    schema of ``transition``'s info with reward and progress_delta zeroed, so
    ``vector.step`` can substitute it on autoreset rows."""
    car = state.car
    speed = torch.sqrt(car.vx * car.vx + car.vy * car.vy)
    zero = torch.zeros_like(speed)
    return {
        "x": car.x, "y": car.y,
        "speed": speed,
        "progress": torch.where(car.finished, torch.ones_like(car.progress), car.progress),
        "crashed": car.crashed,
        "finished": car.finished,
        "reward": zero,
        "progress_delta": zero,
    }


def reset(cfg: RacingConfig, track: Track):
    """(state, obs) for a fresh batch."""
    state = reset_state(cfg, track)
    return state, observe(cfg, track, state)


def step(cfg: RacingConfig, track: Track, state: RacingState, action,
         speed_weight=None):
    """Full env step: (new_state, obs, reward, terminated, truncated, info)."""
    new_state, reward, terminated, truncated, info = transition(
        cfg, track, state, action, speed_weight)
    return new_state, observe(cfg, track, new_state), reward, terminated, truncated, info

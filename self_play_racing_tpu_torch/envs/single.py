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
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .._numerics import div_const
from ..ops import geometry as geo
from ..ops.dynamics import DEFAULT_CAR, CarSpec, car_update
from .track import TrackArrays


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


def reset_state(cfg: RacingConfig, track: TrackArrays) -> RacingState:
    """Fresh state for every env in the batch."""
    dtype = track.wp_x.dtype
    dev = track.wp_x.device
    n = track.wp_x.shape[0]
    zeros = torch.zeros((n,), dtype=dtype, device=dev)
    false = torch.zeros((n,), dtype=torch.bool, device=dev)
    car = CarState(
        x=track.start_x.to(dtype).clone(),
        y=track.start_y.to(dtype).clone(),
        angle=track.start_angle.to(dtype).clone(),
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


def observe(cfg: RacingConfig, track: TrackArrays, state: RacingState) -> torch.Tensor:
    """Observation per env, float32 [N, num_sensors + 4]."""
    car = state.car
    dtype = car.x.dtype
    rel = _sensor_angles(cfg, dtype, car.x.device)                    # [R]
    world = car.angle[:, None] + rel[None, :]                         # [N, R]
    dist = geo.raycast_walls(
        car.x[:, None].expand(world.shape),
        car.y[:, None].expand(world.shape),
        torch.cos(world), torch.sin(world),
        track.seg_sx[:, None, :], track.seg_sy[:, None, :],
        track.seg_vx[:, None, :], track.seg_vy[:, None, :],
        cfg.max_sensor_range,
        seg_c=track.seg_c[:, None, :],
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


def transition(cfg: RacingConfig, track: TrackArrays, state: RacingState, action,
               speed_weight=None):
    """One env step without sensing: (new_state, reward, terminated, truncated, info).

    ``action``: [N, 2] raw policy output; steering clipped to [-1, 1], throttle to
    [0, 1]. ``speed_weight`` may be a tensor (annealing); defaults to the config's.
    """
    dtype = state.car.x.dtype
    car = state.car
    sw = cfg.speed_weight if speed_weight is None else speed_weight

    steering = torch.clamp(action[..., 0].to(dtype), -1.0, 1.0)
    throttle = torch.clamp(action[..., 1].to(dtype), 0.0, 1.0)

    nx, ny, nang, nvx, nvy = car_update(
        car.x, car.y, car.angle, car.vx, car.vy, car.crashed,
        steering, throttle, cfg.dt, cfg.car,
    )
    # progress + wall collision, frozen once crashed; corners are computed here so
    # the track-query kernel needs no transcendentals
    cx, cy = geo.car_corners(nx, ny, nang, cfg.car.length / 2, cfg.car.width / 2)
    raw_progress, hit_wall = geo.progress_and_collision(
        nx, ny, cx, cy, track.wp_x, track.wp_y, track.nrm_x, track.nrm_y,
        track.n_wp, track.track_width,
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


def info_from_state(cfg: RacingConfig, track: TrackArrays, state: RacingState):
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


def reset(cfg: RacingConfig, track: TrackArrays):
    """(state, obs) for a fresh batch."""
    state = reset_state(cfg, track)
    return state, observe(cfg, track, state)


def step(cfg: RacingConfig, track: TrackArrays, state: RacingState, action,
         speed_weight=None):
    """Full env step: (new_state, obs, reward, terminated, truncated, info)."""
    new_state, reward, terminated, truncated, info = transition(
        cfg, track, state, action, speed_weight)
    return new_state, observe(cfg, track, new_state), reward, terminated, truncated, info

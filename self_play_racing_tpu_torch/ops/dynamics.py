"""Vectorized kinematic car dynamics (port of ``self_play_racing_tpu/ops/dynamics.py``).

Elementwise, branch-free: heading integration wrapped into [0, 2*pi), body-frame
throttle/drag/lateral friction, speed clamp, Euler position update, and a sticky
``crashed`` flag that freezes a crashed car.

Floating-point note: multiplication orders match the reference left-to-right
(e.g. ``(v_lat * lateral_friction) * grip``) so f64 trajectories are comparable
to the last bit wherever cos/sin round alike.

``car_update`` (K5) dispatches on the device of ``x``: a CPU tensor takes the plain
PyTorch version (``car_update_plain``), a CUDA tensor launches the hand-written
kernel in ``csrc/car_update.cu`` or raises. ``car_update_launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import dataclasses
import math

import torch

import numpy as np

from .._numerics import const_div
from . import _cuda
from .geometry import _check_f32, _on_cuda


@dataclasses.dataclass(frozen=True)
class CarSpec:
    """Car physics constants."""

    max_speed: float = 30.0
    acceleration: float = 10.0
    steering_speed: float = 3.0
    drag: float = 0.985
    lateral_friction: float = 0.85
    grip: float = 0.9
    length: float = 4.0
    width: float = 2.0


DEFAULT_CAR = CarSpec()

car_update_launches = 0


def car_update(x, y, angle, vx, vy, crashed, steering, throttle, dt=0.05,
               spec=DEFAULT_CAR):
    """One dynamics step for a batch of cars. All inputs share one shape.

    Returns (x, y, angle, vx, vy) with crashed cars frozen at their old values.
    """
    global car_update_launches
    if not _on_cuda(x, "car_update"):
        return car_update_plain(x, y, angle, vx, vy, crashed, steering, throttle, dt,
                                spec)
    out = _car_update_cuda(x, y, angle, vx, vy, crashed, steering, throttle, dt, spec)
    car_update_launches += 1
    return out


def _car_update_cuda(x, y, angle, vx, vy, crashed, steering, throttle, dt, spec):
    """K5 on the card: float32 fields of one shape (``crashed`` bool); the inputs
    are made contiguous (they are [cars]-sized)."""
    dev = x.device
    floats = [x, y, angle, vx, vy, steering, throttle]
    _check_f32("car_update", floats, dev)
    if crashed.device != dev or crashed.dtype != torch.bool:
        raise TypeError("car_update: crashed must be a bool tensor on the cars' device")
    if any(t.shape != x.shape for t in floats + [crashed]):
        raise ValueError("car_update: all inputs must share one shape")
    ins = [t.contiguous() for t in floats[:5] + [crashed] + floats[5:]]
    outs = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(5)]
    f32 = np.float32
    constants = [f32(spec.steering_speed), f32(spec.acceleration), f32(spec.drag),
                 f32(spec.lateral_friction), f32(spec.grip), f32(spec.max_speed),
                 f32(dt), f32(2.0 * math.pi)]
    with torch.cuda.device(dev):
        _cuda.launch_car_update(*ins, *outs, x.numel(), constants)
    return tuple(outs)


def car_update_plain(x, y, angle, vx, vy, crashed, steering, throttle, dt=0.05,
                     spec=DEFAULT_CAR):
    """Plain PyTorch K5. All inputs share one shape.

    Returns (x, y, angle, vx, vy) with crashed cars frozen at their old values.
    ``torch.remainder`` follows the divisor's sign, like ``jnp.mod``.
    """
    ang = torch.remainder(angle + (steering * spec.steering_speed) * dt, 2.0 * math.pi)
    ca = torch.cos(ang)
    sa = torch.sin(ang)

    v_fwd = vx * ca + vy * sa
    v_lat = vx * (-sa) + vy * ca
    v_fwd = (v_fwd + (throttle * spec.acceleration) * dt) * spec.drag
    v_lat = (v_lat * spec.lateral_friction) * spec.grip

    nvx = v_fwd * ca - v_lat * sa
    nvy = v_fwd * sa + v_lat * ca

    # clamp speed: rescale only when strictly above max
    speed = torch.sqrt(nvx * nvx + nvy * nvy)
    over = speed > spec.max_speed
    scale = torch.where(over, const_div(spec.max_speed, torch.where(over, speed, 1.0)), 1.0)
    nvx = torch.where(over, nvx * scale, nvx)
    nvy = torch.where(over, nvy * scale, nvy)

    nx = x + nvx * dt
    ny = y + nvy * dt

    return (
        torch.where(crashed, x, nx),
        torch.where(crashed, y, ny),
        torch.where(crashed, angle, ang),
        torch.where(crashed, vx, nvx),
        torch.where(crashed, vy, nvy),
    )

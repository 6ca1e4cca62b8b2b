"""Vectorized kinematic car dynamics (port of ``self_play_racing_tpu/ops/dynamics.py``).

Elementwise, branch-free: heading integration wrapped into [0, 2*pi), body-frame
throttle/drag/lateral friction, speed clamp, Euler position update, and a sticky
``crashed`` flag that freezes a crashed car.

Floating-point note: multiplication orders match the reference left-to-right
(e.g. ``(v_lat * lateral_friction) * grip``) so f64 trajectories are comparable
to the last bit wherever cos/sin round alike.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .._numerics import const_div


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


def car_update(x, y, angle, vx, vy, crashed, steering, throttle, dt=0.05,
               spec=DEFAULT_CAR):
    """One dynamics step for a batch of cars. All inputs share one shape.

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

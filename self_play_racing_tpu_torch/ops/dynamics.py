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

``car_step_and_query`` is the envs' transition: ``car_update``, ``car_corners`` and
``progress_and_collision`` (K2), and for the multi-car env the SAT test of every
pair of a row's cars (K4) with its velocity response, one kernel on the card
(``csrc/car_step_and_query.cu``), the same dispatch; ``car_step_and_query_launches``
counts its launches.
"""
from __future__ import annotations

import dataclasses
import math

import torch

import numpy as np

from .._numerics import const_div
from . import _cuda
from .geometry import (_check_f32, _check_row_ids, _on_cuda, _rows_leading, car_corners,
                       pool_rows, progress_and_collision_plain,
                       rectangles_intersect_pairs_plain)


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
car_step_and_query_launches = 0
car_step_and_query_row_id_launches = 0  # those of them that read pool rows by id


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
    with torch.cuda.device(dev):
        _cuda.launch_car_update(*ins, *outs, x.numel(), _step_constants(dt, spec))
    return tuple(outs)


def _step_constants(dt, spec):
    """K5's constants as float32, as PyTorch rounds a Python scalar against a
    float32 tensor."""
    f32 = np.float32
    return [f32(spec.steering_speed), f32(spec.acceleration), f32(spec.drag),
            f32(spec.lateral_friction), f32(spec.grip), f32(spec.max_speed), f32(dt),
            f32(2.0 * math.pi)]


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


def car_step_and_query(x, y, angle, vx, vy, crashed, steering, throttle, dt, spec,
                       wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width,
                       collision_speed_scale=None, row_ids=None):
    """The envs' transition kernel: ``car_update``, then the corners of the new
    pose (``car_corners``, the spec's half length and width), then
    ``progress_and_collision`` of the new centre and corners.

    The car fields share one shape ``B``; wp/nrm as ``progress_and_collision``
    takes them (on the card: rows ``P + (1,)*k + (W,)`` that lead ``B = P + Q``,
    and ``n_wp``, ``track_width`` one per row, broadcastable to ``P + (1,)*k``).
    Returns (x, y, angle, vx, vy, corners_x, corners_y, progress, hit_wall): the
    state ``B`` (crashed cars frozen), the corners ``B + (4,)``, progress ``B``
    and hit_wall ``B`` bool.

    With ``collision_speed_scale``, the last axis of ``B`` is a race's cars: every
    pair of them is tested for contact (``rectangles_intersect_pairs``, a car
    against itself excluded), each car's velocity is multiplied by the scale once
    per partner it touches, and ``num_hits`` (``B`` int32) is returned last. On the
    card one waypoint row must be one race (``P`` = ``B[:-1]``).

    With ``row_ids`` [N] the waypoint fields' first axis is a pool's rows, and row
    i of ``P`` reads pool row ``row_ids[i]``; ``n_wp`` and ``track_width`` stay one
    per row of ``P`` (an env's).
    """
    global car_step_and_query_launches, car_step_and_query_row_id_launches
    args = (x, y, angle, vx, vy, crashed, steering, throttle, dt, spec, wp_x, wp_y, nrm_x,
            nrm_y, n_wp, track_width, collision_speed_scale, row_ids)
    if not _on_cuda(x, "car_step_and_query"):
        return car_step_and_query_plain(*args)
    out = _car_step_and_query_cuda(*args)
    car_step_and_query_launches += 1
    car_step_and_query_row_id_launches += row_ids is not None
    return out


def car_step_and_query_plain(x, y, angle, vx, vy, crashed, steering, throttle, dt, spec,
                             wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width,
                             collision_speed_scale=None, row_ids=None):
    """Plain PyTorch version: ``car_update_plain``, ``car_corners`` and
    ``progress_and_collision_plain``, and with ``collision_speed_scale`` the
    multi-car env's contact response, as the envs composed them."""
    wp_x, wp_y, nrm_x, nrm_y = pool_rows(row_ids, wp_x, wp_y, nrm_x, nrm_y)
    nx, ny, nang, nvx, nvy = car_update_plain(x, y, angle, vx, vy, crashed, steering,
                                              throttle, dt, spec)
    ccx, ccy = car_corners(nx, ny, nang, spec.length / 2, spec.width / 2)
    progress, hit_wall = progress_and_collision_plain(nx, ny, ccx, ccy, wp_x, wp_y, nrm_x,
                                                      nrm_y, n_wp, track_width)
    if collision_speed_scale is None:
        return nx, ny, nang, nvx, nvy, ccx, ccy, progress, hit_wall
    # car-car contacts: the SAT test over every pair, the diagonal masked. A car's
    # velocity is scaled once per partner it touches, as a ladder of selects (the
    # reference multiplies in a pair loop; the same factor k times in any order)
    a = nx.shape[-1]
    hits = rectangles_intersect_pairs_plain(ccx, ccy)                # B + (A,)
    hits = hits & ~torch.eye(a, dtype=torch.bool, device=hits.device)
    num_hits = hits.sum(dim=-1)                                     # B
    for m in range(a - 1):
        more = num_hits > m
        nvx = torch.where(more, nvx * collision_speed_scale, nvx)
        nvy = torch.where(more, nvy * collision_speed_scale, nvy)
    return (nx, ny, nang, nvx, nvy, ccx, ccy, progress, hit_wall,
            num_hits.to(torch.int32))


def _car_step_and_query_cuda(x, y, angle, vx, vy, crashed, steering, throttle, dt, spec,
                             wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width,
                             collision_speed_scale=None, row_ids=None):
    """On the card: one block per waypoint row (with ``row_ids``, per env row,
    staging pool row ``row_ids[i]``), a warp per car. The car fields are made
    contiguous (they are small), the waypoint fields must be. The pair test runs
    inside the block, so it needs one block to be one race."""
    dev = x.device
    floats = [x, y, angle, vx, vy, steering, throttle]
    wp = [wp_x, wp_y, nrm_x, nrm_y]
    _check_f32("car_step_and_query", floats + wp, dev)
    if crashed.device != dev or crashed.dtype != torch.bool:
        raise TypeError("car_step_and_query: crashed must be a bool tensor on the cars' device")
    batch = x.shape
    if any(t.shape != batch for t in floats + [crashed]):
        raise ValueError("car_step_and_query: the car fields must share one shape")
    if any(t.shape != wp_x.shape for t in wp) or not all(t.is_contiguous() for t in wp):
        raise ValueError("car_step_and_query: the waypoint fields must share one "
                         "contiguous shape P+(W,)")
    row_shape = wp_x.shape[:-1]
    if row_ids is not None:
        _check_row_ids("car_step_and_query", row_ids, wp_x.shape[0], dev)
        row_shape = row_ids.shape + row_shape[1:]
    rows, cars_per_row = _rows_leading(row_shape, batch, "car_step_and_query",
                                       "waypoint rows", "car batch shape")
    pairs = collision_speed_scale is not None
    if pairs and (len(batch) == 0 or rows != math.prod(batch[:-1])
                  or cars_per_row != batch[-1]):
        raise ValueError(f"car_step_and_query: the pair test runs inside one block per "
                         f"race, so each waypoint row must be one race of the cars "
                         f"{tuple(batch)}: got {rows} rows of {cars_per_row} cars")
    num_waypoints = wp_x.shape[-1]
    _cuda.car_step_query_plan(cars_per_row, num_waypoints, pairs)  # refuses before any launch
    per_row = []
    for name, t, dtype in (("n_wp", n_wp, torch.int32), ("track_width", track_width,
                                                         torch.float32)):
        t = torch.as_tensor(t, device=dev)
        if t.dtype != dtype:
            raise TypeError(f"car_step_and_query: {name} must be {dtype}")
        try:
            fits = torch.broadcast_shapes(t.shape, row_shape) == row_shape
        except RuntimeError:
            fits = False
        if not fits:
            raise ValueError(f"car_step_and_query: {name} {tuple(t.shape)} is not one "
                             f"value per waypoint row {tuple(row_shape)}")
        per_row.append(t.expand(row_shape).reshape(rows).contiguous())
    ins = [t.contiguous() for t in floats[:5] + [crashed] + floats[5:]]
    outs = [torch.empty(batch, dtype=torch.float32, device=dev) for _ in range(5)]
    corners = [torch.empty(batch + (4,), dtype=torch.float32, device=dev) for _ in range(2)]
    progress = torch.empty(batch, dtype=torch.float32, device=dev)
    hit_wall = torch.empty(batch, dtype=torch.bool, device=dev)
    num_hits = torch.empty(batch, dtype=torch.int32, device=dev) if pairs else None
    f32 = np.float32
    constants = _step_constants(dt, spec) + [f32(spec.length / 2), f32(spec.width / 2)]
    with torch.cuda.device(dev):
        _cuda.launch_car_step_and_query(
            *ins, *wp, *per_row, *outs, *corners, progress, hit_wall, rows, cars_per_row,
            num_waypoints, constants, num_hits,
            f32(collision_speed_scale) if pairs else 1.0, row_ids=row_ids)
    out = (*outs, *corners, progress, hit_wall)
    return out + (num_hits,) if pairs else out

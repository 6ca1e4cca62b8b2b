"""Batched 2-D geometry for the racing env (port of ``self_play_racing_tpu/ops/geometry.py``).

Structure-of-arrays, as in the JAX package: separate x/y tensors, segments and
waypoints on the last axis.

The two reductions on every env step have two versions each:

- ``raycast_walls`` (K1) and ``progress_and_collision`` (K2) dispatch on the device
  of their segment/waypoint tensors: a CPU tensor takes the plain PyTorch version
  (``*_plain``), a CUDA tensor launches the hand-written kernel in ``csrc/`` or
  raises. There is no fallback from the kernel to the plain version.
- ``raycast_walls_launches`` / ``progress_and_collision_launches`` count kernel
  launches (plain integers, incremented only where a kernel launched), so a run
  can show that its main path went through the kernels.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _cuda

# Matches the parallel-segment epsilon of the JAX package.
_PARALLEL_EPS = 1e-10

raycast_walls_launches = 0
progress_and_collision_launches = 0


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


# ---------------------------------------------------------------- K1: wall raycast

def raycast_walls(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                  seg_c=None):
    """Min hit distance of rays against boundary segments.

    ox, oy, dx, dy: ray origins/directions, batch shape ``B``.
    seg_*: segment start points and direction vectors, shape broadcastable to
      ``B + (S,)`` (padding segments have zero direction vectors).
    Returns shape ``B``: the nearest hit distance, else ``max_dist``. A hit beyond
    ``max_dist`` is returned unclamped, as in the reference.
    """
    global raycast_walls_launches
    if not _on_cuda(seg_sx, "raycast_walls"):
        return raycast_walls_plain(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy,
                                   max_dist, seg_c)
    out = _raycast_walls_cuda(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy,
                              max_dist, seg_c)
    raycast_walls_launches += 1
    return out


def raycast_walls_plain(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                        seg_c=None):
    """Plain PyTorch K1: the JAX package's division-free form, reduced by a
    pairwise tree fold in index order (ties keep the left operand)."""
    if seg_c is None:
        seg_c = seg_vy * seg_sx - seg_vx * seg_sy
    u = ox * dy - oy * dx
    cn = oy[..., None] * seg_vx - ox[..., None] * seg_vy + seg_c
    dotp = seg_vy * dx[..., None] - seg_vx * dy[..., None]
    sn = seg_sx * dy[..., None] - seg_sy * dx[..., None] - u[..., None]
    d = dotp.abs()
    hit = (d > _PARALLEL_EPS) & (cn * dotp >= 0.0) & (sn * dotp >= 0.0) & (sn.abs() <= d)
    # a miss pair carries (inf, d); padding rows have d == 0, so their inf*0 = NaN
    # compares are false and they lose every comparison
    akey = torch.where(hit, cn.abs(), math.inf)
    amin, dmin = _ratio_min_fold(akey, d.expand_as(akey))
    tmin = amin / dmin
    return torch.where(torch.isinf(tmin), torch.full_like(tmin, max_dist), tmin)


def _ratio_min_fold(a, d):
    """Least a/d over the last axis without dividing: q beats p only on a strict
    ``qa * pd < pa * qd``. The axis is padded to a power of two with the identity
    (inf, 1) and halved level by level, combining neighbours (left, right) in
    index order. Returns (a, d) of the winner."""
    s = a.shape[-1]
    width = 1 << max(0, (s - 1).bit_length())
    if width != s:
        pad = a.shape[:-1] + (width - s,)
        a = torch.cat([a, a.new_full(pad, math.inf)], dim=-1)
        d = torch.cat([d, d.new_full(pad, 1.0)], dim=-1)
    while a.shape[-1] > 1:
        pa, qa = a[..., 0::2], a[..., 1::2]
        pd, qd = d[..., 0::2], d[..., 1::2]
        take_q = qa * pd < pa * qd
        a = torch.where(take_q, qa, pa)
        d = torch.where(take_q, qd, pd)
    return a[..., 0], d[..., 0]


def _raycast_walls_cuda(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                        seg_c):
    """K1 on the card. The segment fields must share one contiguous f32 shape
    ``P + (1,)*k + (S,)`` whose row shape ``P`` leads the ray batch shape
    ``B = P + Q``; each row's ``prod(Q)`` rays see that row's S segments. The ray
    tensors are broadcast to ``B`` and materialized (they are small)."""
    segs = [seg_sx, seg_sy, seg_vx, seg_vy] + ([seg_c] if seg_c is not None else [])
    rays = [ox, oy, dx, dy]
    dev = seg_sx.device
    for t in segs + rays:
        if t.device != dev:
            raise ValueError(f"raycast_walls: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"raycast_walls: the CUDA kernel takes float32, got {t.dtype}")
    seg_shape = seg_sx.shape
    if any(t.shape != seg_shape for t in segs):
        raise ValueError("raycast_walls: segment fields differ in shape")
    if any(not t.is_contiguous() for t in segs):
        raise ValueError("raycast_walls: segment fields must be contiguous")
    num_segments = seg_shape[-1]
    row_shape = list(seg_shape[:-1])
    while row_shape and row_shape[-1] == 1:
        row_shape.pop()
    ray_shape = torch.broadcast_shapes(*(t.shape for t in rays))
    if list(ray_shape[:len(row_shape)]) != row_shape:
        raise ValueError(f"raycast_walls: segment rows {tuple(row_shape)} do not "
                         f"lead the ray batch shape {tuple(ray_shape)}")
    rows = math.prod(row_shape)
    rays_per_row = math.prod(ray_shape[len(row_shape):])
    rays = [t.expand(ray_shape).contiguous() for t in rays]
    out = torch.empty(ray_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch_raycast_walls(*rays, *segs[:4], seg_c, out, rows, rays_per_row,
                                   num_segments, max_dist)
    return out


# ------------------------------------------------------------ dynamics helpers

def car_corners(x, y, angle, half_length, half_width):
    """Oriented-rectangle corners of a car. Returns (cx, cy), shape ``B + (4,)``,
    in the order FL(+l,+w), FR(+l,-w), RR(-l,-w), RL(-l,+w)."""
    ca = torch.cos(angle)[..., None]
    sa = torch.sin(angle)[..., None]
    lx, ly = _corner_offsets(half_length, half_width, x.dtype, x.device)
    cx = x[..., None] + ca * lx - sa * ly
    cy = y[..., None] + sa * lx + ca * ly
    return cx, cy


@functools.lru_cache(maxsize=16)
def _corner_offsets(half_length, half_width, dtype, device):
    """Body-frame corner offsets, made once per device: building them from a
    Python list on every step would copy host to device and wait on the stream."""
    lx = torch.tensor([half_length, half_length, -half_length, -half_length],
                      dtype=dtype, device=device)
    ly = torch.tensor([half_width, -half_width, -half_width, half_width],
                      dtype=dtype, device=device)
    return lx, ly


# --------------------------------------------------------------- K2: track query

def progress_and_collision(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width):
    """Progress of the car centre and corner collision against the centreline.

    x, y: centres ``B``; cx, cy: corners ``B + (C,)``; wp/nrm: ``B + (W,)``;
    n_wp (true waypoint counts) and track_width: ``B`` or scalars.
    Returns (progress ``B``, crashed ``B`` bool).
    """
    global progress_and_collision_launches
    if not _on_cuda(wp_x, "progress_and_collision"):
        return progress_and_collision_plain(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y,
                                            n_wp, track_width)
    out = _progress_and_collision_cuda(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y,
                                       n_wp, track_width)
    progress_and_collision_launches += 1
    return out


def progress_and_collision_plain(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp,
                                 track_width):
    """Plain PyTorch K2: ``torch.argmin`` returns the first minimum, the
    reference's tie-break; the projection is gathered at the winner."""
    qx = torch.cat([x[..., None], cx], dim=-1)          # B + (1+C,)
    qy = torch.cat([y[..., None], cy], dim=-1)
    ddx = qx[..., :, None] - wp_x[..., None, :]          # B + (1+C, W)
    ddy = qy[..., :, None] - wp_y[..., None, :]
    d2 = ddx * ddx + ddy * ddy
    proj = ddx * nrm_x[..., None, :] + ddy * nrm_y[..., None, :]
    idx = torch.argmin(d2, dim=-1)
    min_proj = torch.gather(proj, -1, idx[..., None])[..., 0]
    dtype, dev = wp_x.dtype, wp_x.device
    progress = idx[..., 0].to(dtype) / torch.as_tensor(n_wp, device=dev).to(dtype)
    tw = torch.as_tensor(track_width, dtype=dtype, device=dev)
    return progress, (min_proj[..., 1:].abs() > tw[..., None]).any(dim=-1)


def _progress_and_collision_cuda(x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp,
                                 track_width):
    """K2 on the card: queries and waypoint rows share the batch shape ``B``;
    ``n_wp`` and ``track_width`` broadcast to it."""
    dev = wp_x.device
    floats = [x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y]
    for t in floats:
        if t.device != dev:
            raise ValueError(f"progress_and_collision: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError("progress_and_collision: the CUDA kernel takes float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("progress_and_collision: inputs must be contiguous")
    batch = x.shape
    num_corners = cx.shape[-1]
    num_waypoints = wp_x.shape[-1]
    if (y.shape != batch or cx.shape != batch + (num_corners,) or cy.shape != cx.shape
            or any(t.shape != batch + (num_waypoints,) for t in (wp_y, nrm_x, nrm_y))
            or wp_x.shape[:-1] != batch):
        raise ValueError("progress_and_collision: shapes must be B, B, B+(C,), "
                         "B+(C,) and B+(W,) for the waypoint fields")
    if not 1 <= 1 + num_corners <= 32:
        raise ValueError(f"progress_and_collision: {num_corners} corners; the kernel "
                         "takes at most 31")
    n_wp = torch.as_tensor(n_wp, device=dev)
    track_width = torch.as_tensor(track_width, device=dev)
    if n_wp.dtype != torch.int32 or track_width.dtype != torch.float32:
        raise TypeError("progress_and_collision: n_wp must be int32 and track_width "
                        "float32")
    n_wp = n_wp.expand(batch).contiguous()
    track_width = track_width.expand(batch).contiguous()
    progress = torch.empty(batch, dtype=torch.float32, device=dev)
    crashed = torch.empty(batch, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch_progress_and_collision(
            x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y, n_wp, track_width, progress,
            crashed, math.prod(batch), num_corners, num_waypoints)
    return progress, crashed

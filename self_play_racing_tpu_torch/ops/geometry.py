"""Batched 2-D geometry for the racing env (port of ``self_play_racing_tpu/ops/geometry.py``).

Structure-of-arrays, as in the JAX package: separate x/y tensors, segments and
waypoints on the last axis.

The reductions of the env step have two versions each:

- ``raycast_walls`` (K1), ``progress_and_collision`` (K2), ``raycast_cars`` (K3)
  and ``rectangles_intersect_pairs`` (K4) dispatch on the device of their
  segment/waypoint/corner tensors: a CPU tensor takes the plain PyTorch version
  (``*_plain``), a CUDA tensor launches the hand-written kernel in ``csrc/`` or
  raises. There is no fallback from the kernel to the plain version.
- ``raycast_walls_and_cars`` is the multi-car env's sensing: K1 and K3 of every
  car's rays and their minimum, one kernel on the card (the rays and corners are
  formed inside it). Its plain version is that composition of the plain pieces.
- ``<name>_launches`` count kernel launches (plain integers, incremented only where
  a kernel launched), so a run can show that its main path went through the
  kernels; ``<name>_row_id_launches`` count those of them that read pool rows by
  id.
- ``raycast_walls`` and ``raycast_walls_and_cars`` (and ``dynamics.car_step_and_query``)
  take optional ``row_ids``, int32 [N]: the segment (waypoint) fields are then the
  rows of a resident pool, and env i reads pool row ``row_ids[i]`` (the capacity
  layouts of ``envs/track.py``). The kernels stage that row; the plain versions
  ``index_select`` the rows and run as before. The ids' values are checked when a
  layout is built, never here: that would read the device on every step.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import _cuda

# Matches the parallel-segment epsilon of the JAX package.
_PARALLEL_EPS = 1e-10

raycast_walls_launches = 0
progress_and_collision_launches = 0
raycast_cars_launches = 0
rectangles_intersect_launches = 0
raycast_walls_and_cars_launches = 0
raycast_walls_row_id_launches = 0
raycast_walls_and_cars_row_id_launches = 0


def _on_cuda(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


# ---------------------------------------------------------------- K1: wall raycast

def raycast_walls(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                  seg_c=None, row_ids=None):
    """Min hit distance of rays against boundary segments.

    ox, oy, dx, dy: ray origins/directions, batch shape ``B``.
    seg_*: segment start points and direction vectors, shape broadcastable to
      ``B + (S,)`` (padding segments have zero direction vectors); with
      ``row_ids`` [N] their first axis is a pool's rows, and ray row i (the first
      axis of ``B``) sees pool row ``row_ids[i]``.
    Returns shape ``B``: the nearest hit distance, else ``max_dist``. A hit beyond
    ``max_dist`` is returned unclamped, as in the reference.
    """
    global raycast_walls_launches, raycast_walls_row_id_launches
    if not _on_cuda(seg_sx, "raycast_walls"):
        return raycast_walls_plain(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy,
                                   max_dist, seg_c, row_ids)
    out = _raycast_walls_cuda(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy,
                              max_dist, seg_c, row_ids)
    raycast_walls_launches += 1
    raycast_walls_row_id_launches += row_ids is not None
    return out


def pool_rows(row_ids, *fields):
    """The plain versions' read of pool rows: each field's rows at ``row_ids``
    (the fields themselves when ``row_ids`` is None; None stays None)."""
    if row_ids is None:
        return fields
    idx = row_ids.long()
    return tuple(None if t is None else t.index_select(0, idx) for t in fields)


def raycast_walls_plain(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                        seg_c=None, row_ids=None):
    """Plain PyTorch K1: the JAX package's division-free form, reduced by a
    pairwise tree fold in index order (ties keep the left operand)."""
    seg_sx, seg_sy, seg_vx, seg_vy, seg_c = pool_rows(row_ids, seg_sx, seg_sy, seg_vx,
                                                      seg_vy, seg_c)
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


def raycast_walls_fold_shape(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                             seg_c=None, row_ids=None, stop_at_extent=False,
                             rays_per_group=None):
    """``raycast_walls`` in the kernels' reduction shape (``csrc/wall_fold.cuh``):
    per ray, run j folds segments [j*L, (j+1)*L) in index order (L = ceil(S/32), the
    row padded to 32 runs with zero direction), and the 32 runs combine in the
    warp's shuffle tree (``_ratio_min_fold``: neighbours at distance 1, 2, 4, 8, 16,
    left before right). ``stop_at_extent`` stops each row's runs at its real extent
    E, one past its last segment with a nonzero direction (the redesigned
    observation's runs, ``csrc/run_fold.cuh``): such segments never take, so the
    result is the same. ``rays_per_group`` takes the rays of the last axis in groups
    of that many and forms each segment's cross term once a group, from the group's
    first ray's origin (``run_fold.cuh``'s kCarOrigin, where each group is one car's
    rays). A model of the shape for tests; no kernel path calls it."""
    seg_sx, seg_sy, seg_vx, seg_vy, seg_c = pool_rows(row_ids, seg_sx, seg_sy, seg_vx,
                                                      seg_vy, seg_c)
    if seg_c is None:
        seg_c = seg_vy * seg_sx - seg_vx * seg_sy
    s = seg_sx.shape[-1]
    length = -(-s // 32)
    u = ox * dy - oy * dx
    if rays_per_group:
        first = torch.arange(ox.shape[-1], device=ox.device) // rays_per_group * rays_per_group
        cx, cy = ox[..., first], oy[..., first]
    else:
        cx, cy = ox, oy
    cn = cy[..., None] * seg_vx - cx[..., None] * seg_vy + seg_c
    dotp = seg_vy * dx[..., None] - seg_vx * dy[..., None]
    sn = seg_sx * dy[..., None] - seg_sy * dx[..., None] - u[..., None]
    d = dotp.abs()
    hit = (d > _PARALLEL_EPS) & (cn * dotp >= 0.0) & (sn * dotp >= 0.0) & (sn.abs() <= d)
    if stop_at_extent:
        real = (seg_vx != 0) | (seg_vy != 0)
        index = torch.arange(1, s + 1, device=real.device)
        extent = torch.where(real, index, 0).amax(dim=-1, keepdim=True)
        hit = hit & (index - 1 < extent)
    akey = torch.where(hit, cn.abs(), math.inf)
    d = d.expand_as(akey)
    pad = akey.shape[:-1] + (32 * length - s,)
    akey = torch.cat([akey, akey.new_full(pad, math.inf)], dim=-1)
    d = torch.cat([d, d.new_zeros(pad)], dim=-1)
    runs_a = akey.reshape(akey.shape[:-1] + (32, length))
    runs_d = d.reshape(d.shape[:-1] + (32, length))
    pa = torch.full(runs_a.shape[:-1], math.inf, dtype=akey.dtype, device=akey.device)
    pd = torch.ones_like(pa)
    for k in range(length):
        qa, qd = runs_a[..., k], runs_d[..., k]
        take = qa * pd < pa * qd
        pa = torch.where(take, qa, pa)
        pd = torch.where(take, qd, pd)
    amin, dmin = _ratio_min_fold(pa, pd)
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


def _rows_leading(row_shape, batch_shape, name, rows_what, batch_what, row_ids=None):
    """(rows, items per row) for row-major data whose row shape ``P`` (trailing
    1s after the first axis dropped) leads ``batch_shape = P + Q``; raises
    otherwise. With ``row_ids`` the data's first axis is a pool's, and the rows'
    first axis is the ids' (the pool's row count may differ from the batch's)."""
    row_shape = list(row_shape)
    if row_ids is not None and row_shape:
        row_shape[0] = row_ids.shape[0]
    while len(row_shape) > 1 and row_shape[-1] == 1:
        row_shape.pop()
    if list(batch_shape[:len(row_shape)]) != row_shape:
        raise ValueError(f"{name}: {rows_what} {tuple(row_shape)} do not lead the "
                         f"{batch_what} {tuple(batch_shape)}")
    return math.prod(row_shape), math.prod(batch_shape[len(row_shape):])


def _check_f32(name, tensors, dev):
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernel takes float32, got {t.dtype}")


def _check_row_ids(name, row_ids, num_pool_rows, dev):
    """What a kernel takes as row ids: int32, one contiguous axis, on ``dev``, and a
    pool with rows. Their values were checked when the layout was built."""
    if row_ids.device != dev:
        raise ValueError(f"{name}: row ids on {row_ids.device}, the pool on {dev}")
    if row_ids.dtype != torch.int32:
        raise TypeError(f"{name}: row ids must be int32, got {row_ids.dtype}")
    if row_ids.ndim != 1 or not row_ids.is_contiguous():
        raise ValueError(f"{name}: row ids must be one contiguous axis")
    if num_pool_rows < 1:
        raise ValueError(f"{name}: the pool has no rows")


def _raycast_walls_cuda(ox, oy, dx, dy, seg_sx, seg_sy, seg_vx, seg_vy, max_dist,
                        seg_c, row_ids=None):
    """K1 on the card. The segment fields must share one contiguous f32 shape
    ``P + (1,)*k + (S,)`` whose row shape ``P`` leads the ray batch shape
    ``B = P + Q``; each row's ``prod(Q)`` rays see that row's S segments. With
    ``row_ids`` the fields' first axis is the pool's, and ``P``'s the ids'. The ray
    tensors are broadcast to ``B`` and materialized (they are small)."""
    segs = [seg_sx, seg_sy, seg_vx, seg_vy] + ([seg_c] if seg_c is not None else [])
    rays = [ox, oy, dx, dy]
    dev = seg_sx.device
    _check_f32("raycast_walls", segs + rays, dev)
    seg_shape = seg_sx.shape
    if any(t.shape != seg_shape for t in segs):
        raise ValueError("raycast_walls: segment fields differ in shape")
    if any(not t.is_contiguous() for t in segs):
        raise ValueError("raycast_walls: segment fields must be contiguous")
    num_segments = seg_shape[-1]
    ray_shape = torch.broadcast_shapes(*(t.shape for t in rays))
    if row_ids is not None:
        _check_row_ids("raycast_walls", row_ids, seg_shape[0], dev)
    rows, rays_per_row = _rows_leading(seg_shape[:-1], ray_shape, "raycast_walls",
                                       "segment rows", "ray batch shape", row_ids)
    _cuda.raycast_walls_plan(rays_per_row, num_segments)  # refuses before any launch
    rays = [t.expand(ray_shape).contiguous() for t in rays]
    out = torch.empty(ray_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch_raycast_walls(*rays, *segs[:4], seg_c, out, rows, rays_per_row,
                                   num_segments, max_dist, row_ids=row_ids)
    return out


# ------------------------------------------------ plain track-query helpers

# The env step computes these three inside K2 (``progress_and_collision``, run in
# ``dynamics.car_step_and_query`` on the card); they stay plain PyTorch helpers
# for callers outside the env step.

def nearest_waypoint(px, py, wp_x, wp_y):
    """Index of the nearest waypoint (the first on ties, as np.argmin).

    px, py: query points, shape ``B``. wp_x, wp_y: waypoints, shape ``B + (W,)``
    (padding waypoints sit at huge coordinates so they never win the argmin).
    """
    d2 = (wp_x - px[..., None]) ** 2 + (wp_y - py[..., None]) ** 2
    return torch.argmin(d2, dim=-1)


NO_WAYPOINT = 2**31 - 1  # the kernels' index where no waypoint's d^2 is finite


def waypoint_search_model(qx, qy, wp_x, wp_y, n_wp, real_first=True):
    """The kernels' nearest waypoint, as a model for tests (no kernel path calls
    it): the first index of the least finite d^2 = dx*dx + dy*dy over a row's W
    waypoints (``csrc/track_query.cuh``; a NaN or overflowed d^2 never wins), or
    ``NO_WAYPOINT``. ``real_first`` searches as ``csrc/waypoint_search.cuh`` does:
    the real waypoints [0, n_wp) first, then the padding only where the least d^2
    its box allows is below the real winner's (or that is undefined).

    qx, qy: queries ``B``; wp_x, wp_y: ``B + (W,)``; n_wp: broadcastable to ``B``.
    Returns int64 ``B``."""
    ddx = qx[..., None] - wp_x
    ddy = qy[..., None] - wp_y
    d2 = ddx * ddx + ddy * ddy
    index = torch.arange(d2.shape[-1], device=d2.device)

    def first_least(among):
        v = torch.where(among & (d2 < math.inf), d2, math.inf)
        best, i = v.min(dim=-1)
        return best, torch.where(torch.isinf(best), NO_WAYPOINT, i)

    _, i_all = first_least(torch.ones_like(d2, dtype=torch.bool))
    if not real_first:
        return i_all
    n = torch.as_tensor(n_wp, device=d2.device).clamp(0, d2.shape[-1])
    real = index < n[..., None]
    best, i = first_least(real)
    pad = ~real

    def bounds(w):
        inf = torch.full_like(w, math.inf)
        lo = torch.where(pad & ~torch.isnan(w), w, inf).amin(dim=-1)
        hi = torch.where(pad & ~torch.isnan(w), w, -inf).amax(dim=-1)
        return lo, hi

    (x0, x1), (y0, y1) = bounds(wp_x), bounds(wp_y)
    zero = torch.zeros_like(qx)
    gx = torch.fmax(torch.fmax(x0 - qx, qx - x1), zero)
    gy = torch.fmax(torch.fmax(y0 - qy, qy - y1), zero)
    padding_may_win = ~(best <= gx * gx + gy * gy)
    return torch.where(padding_may_win, i_all, i)


def track_progress(px, py, wp_x, wp_y, n_wp):
    """Fraction of the track completed: nearest waypoint index / ``n_wp``, the
    true (unpadded) waypoint count."""
    idx = nearest_waypoint(px, py, wp_x, wp_y)
    return idx.to(wp_x.dtype) / torch.as_tensor(n_wp, dtype=wp_x.dtype, device=wp_x.device)


def centerline_collision(cx, cy, wp_x, wp_y, nrm_x, nrm_y, track_width):
    """Wall test: any corner farther than ``track_width`` from the centreline,
    measured along its nearest waypoint's normal (distance from the centreline,
    not a segment intersection).

    cx, cy: corners, shape ``B + (C,)``. wp/nrm: shape ``B + (W,)``.
    track_width: shape ``B`` or scalar. Returns bool, shape ``B``.
    """
    dx = cx[..., :, None] - wp_x[..., None, :]          # B + (C, W)
    dy = cy[..., :, None] - wp_y[..., None, :]
    idx = torch.argmin(dx * dx + dy * dy, dim=-1, keepdim=True)      # B + (C, 1)
    proj = dx * nrm_x[..., None, :] + dy * nrm_y[..., None, :]
    dist = torch.abs(torch.gather(proj, -1, idx)[..., 0])
    tw = torch.as_tensor(track_width, dtype=dist.dtype, device=dist.device)
    return torch.any(dist > tw[..., None], dim=-1)


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

    x, y: centres ``B``; cx, cy: corners ``B + (C,)``; wp/nrm: broadcastable to
    ``B + (W,)`` (on the card: rows ``P + (1,)*k + (W,)`` that lead ``B = P + Q``,
    so every car of a row reads that row's waypoints); n_wp (true waypoint counts)
    and track_width: broadcastable to ``B``.
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
    """K2 on the card: the waypoint fields share one contiguous shape
    ``P + (1,)*k + (W,)`` whose rows ``P`` lead the car batch ``B = P + Q``;
    ``n_wp`` and ``track_width`` broadcast to ``B``."""
    dev = wp_x.device
    _check_f32("progress_and_collision", [x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y], dev)
    if not all(t.is_contiguous() for t in (x, y, cx, cy, wp_x, wp_y, nrm_x, nrm_y)):
        raise ValueError("progress_and_collision: inputs must be contiguous")
    batch = x.shape
    num_corners = cx.shape[-1]
    num_waypoints = wp_x.shape[-1]
    if (y.shape != batch or cx.shape != batch + (num_corners,) or cy.shape != cx.shape
            or any(t.shape != wp_x.shape for t in (wp_y, nrm_x, nrm_y))):
        raise ValueError("progress_and_collision: shapes must be B, B, B+(C,), "
                         "B+(C,) and one shape P+(W,) for the waypoint fields")
    rows, cars_per_row = _rows_leading(wp_x.shape[:-1], batch, "progress_and_collision",
                                       "waypoint rows", "car batch shape")
    # refuses before any launch
    _cuda.progress_collision_plan(cars_per_row, num_corners, num_waypoints)
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
            crashed, rows, cars_per_row, num_corners, num_waypoints)
    return progress, crashed


# ------------------------------------------------- K4: car-car separating axes

def rectangles_intersect(ax, ay, bx, by):
    """SAT intersection test of two oriented rectangles given their corners
    ``B + (4,)``. Returns bool ``B``. Axes are the two unique edge normals of each
    rectangle (edges 0->1 and 1->2, normal ``(-ey, ex)``), a's then b's; a strict
    gap on any axis means no intersection."""
    def edge_normals(cx, cy):
        ex = cx[..., 1:3] - cx[..., 0:2]
        ey = cy[..., 1:3] - cy[..., 0:2]
        return -ey, ex

    nax, nay = edge_normals(ax, ay)
    nbx, nby = edge_normals(bx, by)
    axx = torch.cat([nax, nbx], dim=-1)                   # B + (4 axes,)
    axy = torch.cat([nay, nby], dim=-1)
    pa = axx[..., :, None] * ax[..., None, :] + axy[..., :, None] * ay[..., None, :]
    pb = axx[..., :, None] * bx[..., None, :] + axy[..., :, None] * by[..., None, :]
    gap = ((pa.amax(dim=-1) < pb.amin(dim=-1)) | (pb.amax(dim=-1) < pa.amin(dim=-1)))
    return ~gap.any(dim=-1)


def rectangles_intersect_pairs(cx, cy):
    """SAT test between every pair of the ``A`` cars of a row: corners ``P + (A,
    4)`` -> bool ``P + (A, A)``, entry ``[..., i, j]`` testing car i (axes first)
    against car j. The diagonal (a car against itself) is True."""
    global rectangles_intersect_launches
    if not _on_cuda(cx, "rectangles_intersect_pairs"):
        return rectangles_intersect_pairs_plain(cx, cy)
    out = _rectangles_intersect_pairs_cuda(cx, cy)
    rectangles_intersect_launches += 1
    return out


def rectangles_intersect_pairs_plain(cx, cy):
    """Plain PyTorch K4: ``rectangles_intersect`` over the broadcast pairs, as the
    JAX package's multi-car env calls it."""
    a = cx.shape[-2]
    shape = cx.shape[:-2] + (a, a, 4)
    return rectangles_intersect(cx[..., :, None, :].expand(shape),
                                cy[..., :, None, :].expand(shape),
                                cx[..., None, :, :].expand(shape),
                                cy[..., None, :, :].expand(shape))


def _rectangles_intersect_pairs_cuda(cx, cy):
    dev = cx.device
    _check_f32("rectangles_intersect_pairs", [cx, cy], dev)
    if cy.shape != cx.shape or cx.ndim < 2 or cx.shape[-1] != 4:
        raise ValueError("rectangles_intersect_pairs: corners must share one shape "
                         "P + (A, 4)")
    if not (cx.is_contiguous() and cy.is_contiguous()):
        raise ValueError("rectangles_intersect_pairs: corners must be contiguous")
    a = cx.shape[-2]
    out = torch.empty(cx.shape[:-2] + (a, a), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch_rectangles_intersect(cx, cy, out, math.prod(cx.shape[:-2]), a)
    return out


# ------------------------------------------------------- K3: rays against cars

def raycast_cars(ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, max_dist):
    """Min hit distance of rays against the edges of a set of cars.

    ox, oy, dx, dy: ray origins/directions, batch shape ``B``.
    car_cx, car_cy: car corners, broadcastable to ``B + (A, 4)``; car_x, car_y:
      centres ``B + (A,)``. A car whose centre lies within 0.5 of the ray origin
      is skipped (the reference's self-exclusion, which skips opponents that close
      too). On the card the car fields share one contiguous shape ``P + (1,)*k +
      (A, 4)`` (centres ``P + (1,)*k + (A,)``) whose rows ``P`` lead ``B = P + Q``.
    Returns shape ``B``: the nearest hit, clamped to ``max_dist``.
    """
    global raycast_cars_launches
    if not _on_cuda(car_cx, "raycast_cars"):
        return raycast_cars_plain(ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, max_dist)
    out = _raycast_cars_cuda(ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, max_dist)
    raycast_cars_launches += 1
    return out


def raycast_cars_plain(ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, max_dist):
    """Plain PyTorch K3, in the JAX package's order: edge ``i`` runs from corner
    ``i`` to corner ``(i+1) % 4``; ``t`` and ``s`` are IEEE divisions by the
    ray-edge cross product."""
    cdx = car_x - ox[..., None]
    cdy = car_y - oy[..., None]
    skip = torch.sqrt(cdx * cdx + cdy * cdy) < 0.5                  # B + (A,)
    sx, sy = car_cx, car_cy
    vx = torch.roll(car_cx, -1, dims=-1) - car_cx
    vy = torch.roll(car_cy, -1, dims=-1) - car_cy
    v1x = ox[..., None, None] - sx
    v1y = oy[..., None, None] - sy
    v3x = -dy[..., None, None]
    v3y = dx[..., None, None]
    dotp = vx * v3x + vy * v3y
    valid = (dotp.abs() >= _PARALLEL_EPS) & ~skip[..., None]
    safe = torch.where(valid, dotp, 1.0)
    t = (vx * v1y - vy * v1x) / safe
    s = (v1x * v3x + v1y * v3y) / safe
    hit = valid & (t >= 0.0) & (s >= 0.0) & (s <= 1.0)
    tmin = torch.where(hit, t, math.inf).flatten(-2).amin(dim=-1)
    tmin = torch.where(torch.isinf(tmin), torch.full_like(tmin, max_dist), tmin)
    return torch.clamp_max(tmin, max_dist)


def _raycast_cars_cuda(ox, oy, dx, dy, car_cx, car_cy, car_x, car_y, max_dist):
    """K3 on the card; the ray tensors are broadcast to ``B`` and materialized."""
    dev = car_cx.device
    rays = [ox, oy, dx, dy]
    _check_f32("raycast_cars", rays + [car_cx, car_cy, car_x, car_y], dev)
    corner_shape = car_cx.shape
    if (car_cy.shape != corner_shape or len(corner_shape) < 2 or corner_shape[-1] != 4
            or car_x.shape != corner_shape[:-1] or car_y.shape != car_x.shape):
        raise ValueError("raycast_cars: corners must share one shape P+(A, 4) and "
                         "centres P+(A,)")
    if not all(t.is_contiguous() for t in (car_cx, car_cy, car_x, car_y)):
        raise ValueError("raycast_cars: car fields must be contiguous")
    num_cars = corner_shape[-2]
    ray_shape = torch.broadcast_shapes(*(t.shape for t in rays))
    rows, rays_per_row = _rows_leading(corner_shape[:-2], ray_shape, "raycast_cars",
                                       "car rows", "ray batch shape")
    rays = [t.expand(ray_shape).contiguous() for t in rays]
    out = torch.empty(ray_shape, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch_raycast_cars(*rays, car_cx, car_cy, car_x, car_y, out, rows,
                                  rays_per_row, num_cars, max_dist)
    return out


# ------------------------------------- the multi-car sensing: K1 and K3 together

def raycast_walls_and_cars(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy, seg_c,
                           half_length, half_width, max_dist, row_ids=None):
    """Every car's sensor rays against the walls and the cars of its row: the
    minimum of the wall hit (unclamped, ``raycast_walls``) and the car hit
    (clamped to ``max_dist``, ``raycast_cars``).

    x, y, angle: car poses ``P + (A,)``; rel: sensor angles ``(R,)``, car ``a``'s
      rays point at ``angle + rel`` from its centre;
    seg_*: the row's segment fields ``P + (S,)``, ``seg_c = vy*sx - vx*sy`` among
      them; with ``row_ids`` [N] they are a pool's rows ``(T, S)``, the poses
      ``(N, A)``, and row i sees pool row ``row_ids[i]``;
    every car of a row sees the row's A cars (rectangles of the given half length
    and width), itself skipped by the 0.5 radius.
    Returns ``P + (A, R)``.
    """
    global raycast_walls_and_cars_launches, raycast_walls_and_cars_row_id_launches
    if not _on_cuda(seg_sx, "raycast_walls_and_cars"):
        return raycast_walls_and_cars_plain(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy,
                                            seg_c, half_length, half_width, max_dist,
                                            row_ids)
    out = _raycast_walls_and_cars_cuda(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy,
                                       seg_c, half_length, half_width, max_dist, row_ids)
    raycast_walls_and_cars_launches += 1
    raycast_walls_and_cars_row_id_launches += row_ids is not None
    return out


def raycast_walls_and_cars_plain(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy, seg_c,
                                 half_length, half_width, max_dist, row_ids=None):
    """Plain PyTorch version: the rays, ``raycast_walls_plain``, ``car_corners``,
    ``raycast_cars_plain`` and ``torch.minimum``, as the multi-car env composed
    them."""
    seg_sx, seg_sy, seg_vx, seg_vy, seg_c = pool_rows(row_ids, seg_sx, seg_sy, seg_vx,
                                                      seg_vy, seg_c)
    world = angle[..., None] + rel                                    # P + (A, R)
    ox = x[..., None].expand(world.shape)
    oy = y[..., None].expand(world.shape)
    dx, dy = torch.cos(world), torch.sin(world)
    rows = [t[..., None, None, :] for t in (seg_sx, seg_sy, seg_vx, seg_vy, seg_c)]
    wall = raycast_walls_plain(ox, oy, dx, dy, *rows[:4], max_dist, rows[4])  # P + (A, R)
    ccx, ccy = car_corners(x, y, angle, half_length, half_width)      # P + (A, 4)
    cars = raycast_cars_plain(ox, oy, dx, dy, ccx[..., None, None, :, :],
                              ccy[..., None, None, :, :], x[..., None, None, :],
                              y[..., None, None, :], max_dist)
    return torch.minimum(wall, cars)


def _raycast_walls_and_cars_cuda(x, y, angle, rel, seg_sx, seg_sy, seg_vx, seg_vy, seg_c,
                                 half_length, half_width, max_dist, row_ids=None):
    """On the card: one block per row of ``P``, which stages its segment row (pool
    row ``row_ids[i]`` with ids); the poses and sensor angles are made contiguous
    (they are small), the segment fields must be."""
    segs = [seg_sx, seg_sy, seg_vx, seg_vy, seg_c]
    cars = [x, y, angle]
    dev = seg_sx.device
    _check_f32("raycast_walls_and_cars", segs + cars + [rel], dev)
    if any(t.shape != x.shape for t in cars) or x.ndim < 1 or rel.ndim != 1:
        raise ValueError("raycast_walls_and_cars: poses must share one shape P+(A,) and "
                         "the sensor angles be (R,)")
    if row_ids is None and any(t.shape != x.shape[:-1] + seg_sx.shape[-1:] for t in segs):
        raise ValueError("raycast_walls_and_cars: segment fields must share one shape "
                         "P+(S,) with the poses' P")
    if row_ids is not None:
        _check_row_ids("raycast_walls_and_cars", row_ids, seg_sx.shape[0], dev)
        if (x.ndim != 2 or row_ids.shape[0] != x.shape[0]
                or any(t.ndim != 2 or t.shape != seg_sx.shape for t in segs)):
            raise ValueError("raycast_walls_and_cars: with row ids the segment fields "
                             "must share one pool shape (T, S) and the poses be (N, A) "
                             "for N row ids")
    if any(not t.is_contiguous() for t in segs):
        raise ValueError("raycast_walls_and_cars: segment fields must be contiguous")
    num_cars, num_sensors, num_segments = x.shape[-1], rel.shape[0], seg_sx.shape[-1]
    _cuda.raycast_walls_and_cars_plan(num_cars, num_sensors, num_segments)  # refuses first
    x, y, angle, rel = (t.contiguous() for t in (x, y, angle, rel))
    out = torch.empty(x.shape + (num_sensors,), dtype=torch.float32, device=dev)
    f32 = np.float32
    with torch.cuda.device(dev):
        _cuda.launch_raycast_walls_and_cars(
            x, y, angle, rel, *segs, out, math.prod(x.shape[:-1]), num_cars,
            num_sensors, num_segments, f32(half_length), f32(half_width), max_dist,
            row_ids=row_ids)
    return out

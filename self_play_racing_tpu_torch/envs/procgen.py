"""Procedural track pools built on the device with torch ops (port of
``self_play_racing_tpu/envs/procgen.py``).

Parameter sampling, the control polygon, the periodic cubic spline, waypoints,
normals, boundary segments and the start pose run batched over the pool, in the
pool's dtype, on the device the uniforms live on, so ``train scale`` can resample
a fresh pool every K updates without a host round trip. It runs once per K
updates and is plain tensor code; its one linear-algebra call is the batched
``torch.linalg.solve`` of the spline's cyclic system (n <= 15).

Divergences from the host pipeline (``envs/track.py``), as in the JAX package:
``num_points`` is fixed per call, and each track's parameters are continuous
draws over the host generator's ranges.

Random draws: the sampling functions take unit uniforms in [0, 1) as arguments
and map them as ``jax.random.uniform(key, minval=lo, maxval=hi)`` maps its own,
``max(lo, u * (hi - lo) + lo)``, so the CPU tests can feed JAX's draws.
``draw_track_uniforms`` draws them from a ``torch.Generator``; ``pool_generator``
seeds one from ``(seed, boundary)``, the key of a resampled pool.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import resolve_device
from .track import PAD_XY, WAYPOINT_FACTOR, TrackArrays, _round_up

BASE_RADIUS_RANGE = (50.0, 80.0)
ANGLE_JITTER_RANGE = (0.2, 0.7)
SMOOTHNESS_RANGE = (0.2, 0.7)
WIDTH_RANGE = (6.0, 10.0)


def periodic_spline_m(t, y):
    """Second derivatives of the periodic cubic spline through (t, y).

    t: [..., n+1] strictly increasing knots; y: [..., n+1] or [..., n+1, d] (d
    curves sharing the knots, solved together) with y[n] == y[0]. Returns M of
    y's shape with M[n] == M[0], from the cyclic tridiagonal system, for each
    unknown M_i (i = 0..n-1, indices mod n):

        h_{i-1}/6 M_{i-1} + (h_{i-1}+h_i)/3 M_i + h_i/6 M_{i+1}
            = (y_{i+1}-y_i)/h_i - (y_i-y_{i-1})/h_{i-1}
    """
    curves = y.ndim == t.ndim + 1
    n = t.shape[-1] - 1
    h = torch.diff(t, dim=-1)                                    # [..., n]
    s = torch.diff(y, dim=-2 if curves else -1) / (h[..., None] if curves else h)
    idx = torch.arange(n, device=t.device)
    prev = (idx - 1) % n
    nxt = (idx + 1) % n
    h_prev = h[..., prev]
    eye = torch.eye(n, dtype=t.dtype, device=t.device)
    a = (torch.diag_embed((h_prev + h) / 3.0)
         + (h_prev / 6.0)[..., :, None] * eye[prev]
         + (h / 6.0)[..., :, None] * eye[nxt])
    d = s - s[..., prev, :] if curves else s - s[..., prev]
    m = torch.linalg.solve(a, d if curves else d[..., None])
    if not curves:
        m = m[..., 0]
    cat_dim = -2 if curves else -1
    return torch.cat([m, m.narrow(cat_dim, 0, 1)], dim=cat_dim)


def eval_periodic_spline(t, y, m, ts):
    """The cubic with knot second derivatives m at query points ts: t, y, m
    [..., n+1], ts [..., Q] -> [..., Q]."""
    n = t.shape[-1] - 1
    i = torch.clamp(torch.searchsorted(t.contiguous(), ts.contiguous(), right=True) - 1,
                    0, n - 1)

    def at(a, k):
        return torch.gather(a, -1, k)

    t0, t1 = at(t, i), at(t, i + 1)
    h = t1 - t0
    lo = (t1 - ts) / h
    hi = (ts - t0) / h
    h2 = h * h / 6.0
    m0, m1 = at(m, i), at(m, i + 1)
    return ((m0 * (lo * lo * lo) + m1 * (hi * hi * hi)) * h2
            + (at(y, i) - m0 * h2) * lo + (at(y, i + 1) - m1 * h2) * hi)


def _uniform(u, lo, hi):
    """``jax.random.uniform``'s map of a unit uniform onto [lo, hi): the bounds in
    ``u``'s dtype, ``max(lo, u * (hi - lo) + lo)``."""
    lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def sample_track_params(u, base_radius_range=BASE_RADIUS_RANGE,
                        angle_jitter_range=ANGLE_JITTER_RANGE,
                        smoothness_range=SMOOTHNESS_RANGE):
    """Per-track parameters from unit uniforms ``u`` [..., 4] (base radius, radius
    variation, angle jitter, smoothness): the continuous analog of the host
    generator's per-track draws. The radius variation's bound depends on the base
    radius, so its uniform is scaled by that bound. Returns four [...] tensors."""
    base_radius = _uniform(u[..., 0], *base_radius_range)
    rv_hi = base_radius / 2.0 - 10.0
    radius_variation = 10.0 + u[..., 1] * (rv_hi - 10.0)
    angle_jitter = _uniform(u[..., 2], *angle_jitter_range)
    smoothness = _uniform(u[..., 3], *smoothness_range)
    return base_radius, radius_variation, angle_jitter, smoothness


def sample_control_points(u_params, u_angle, u_radius, **param_ranges):
    """The control polygon [..., n, 2] of each track: ``u_params`` [..., 4] for
    ``sample_track_params``, ``u_angle`` [..., n] the angle jitter's and
    ``u_radius`` [..., n] the radius variations' unit uniforms. A jittered circle
    with smoothed radius variation, closed by averaging the first and last radii."""
    base_radius, radius_variation, angle_jitter, smoothness = \
        sample_track_params(u_params, **param_ranges)
    n = u_angle.shape[-1]
    dtype, dev = u_angle.dtype, u_angle.device
    two_pi = 2.0 * math.pi
    angles = two_pi * (torch.arange(n, dtype=dtype, device=dev) / n)
    half = angle_jitter * (two_pi / n) / 2.0
    jitter = _uniform(u_angle, -1.0, 1.0) * half[..., None]
    angles = torch.sort(torch.remainder(angles + jitter, two_pi), dim=-1).values

    rv = radius_variation[..., None]
    variations = _uniform(u_radius, -rv, rv)
    radii = [base_radius + variations[..., 0]]
    for k in range(1, n):
        radii.append((1.0 - smoothness) * (base_radius + variations[..., k])
                     + smoothness * radii[-1])
    radii[0] = (radii[0] + radii[-1]) / 2.0  # close the loop
    radii = torch.stack(radii, dim=-1)
    return torch.stack([radii * torch.cos(angles), radii * torch.sin(angles)], dim=-1)


def _roll1(a):
    """``a`` shifted one place left along the last axis (next minus this)."""
    return torch.roll(a, -1, dims=-1)


def _decimate(bx, by, onx, ony, lod):
    """Closed chords through every ``lod``-th boundary vertex [K, W], each kept
    vertex moved outward along its normal by the largest outward bulge of the
    skipped vertices of its two chords (``make_track_pool``'s relaxed sensing,
    vectorized over the pool). Returns the chord vertices [K, W / lod]."""
    k, w = bx.shape
    m = w // lod
    vx, vy = bx.reshape(k, m, lod), by.reshape(k, m, lod)
    ax, ay = vx[:, :, 0], vy[:, :, 0]
    cx, cy = _roll1(ax) - ax, _roll1(ay) - ay
    norm = torch.sqrt(cx * cx + cy * cy)
    norm = torch.where(norm < 1e-12, torch.ones_like(norm), norm)
    cnx, cny = -cy / norm, cx / norm
    keep_onx, keep_ony = onx.reshape(k, m, lod)[:, :, 0], ony.reshape(k, m, lod)[:, :, 0]
    flip = torch.sign(cnx * keep_onx + cny * keep_ony)
    flip = torch.where(flip == 0, torch.ones_like(flip), flip)
    cnx, cny = cnx * flip, cny * flip
    dev = ((vx[:, :, 1:] - ax[:, :, None]) * cnx[:, :, None]
           + (vy[:, :, 1:] - ay[:, :, None]) * cny[:, :, None])
    chord_dev = torch.clamp_min(dev.amax(dim=-1), 0.0)
    off = torch.maximum(chord_dev, torch.roll(chord_dev, 1, dims=-1))
    return ax + keep_onx * off, ay + keep_ony * off


def build_track_arrays(control_points, track_width, pad_multiple: int = 128,
                       dtype=torch.float32, sensor_lod: int = 1) -> TrackArrays:
    """A padded ``TrackArrays`` pool from control points [K, n, 2] and widths [K]
    (or a scalar), computed in the control points' dtype and rounded to ``dtype``
    once: the layout ``make_track_pool`` gives (waypoints padded at PAD_XY,
    segments with zero direction vectors). ``sensor_lod`` > 1 senses against
    ``_decimate``'s chords and needs it to divide n_wp = 30 n."""
    cp = control_points
    k, n, _ = cp.shape
    cdt, dev = cp.dtype, cp.device
    width = torch.as_tensor(track_width, dtype=cdt, device=dev).expand(k)

    closed = torch.cat([cp, cp[:, :1]], dim=1)                        # [K, n+1, 2]
    step = torch.diff(closed, dim=1)
    chord = torch.sqrt(step[..., 0] * step[..., 0] + step[..., 1] * step[..., 1])
    t = torch.cat([torch.zeros((k, 1), dtype=cdt, device=dev),
                   torch.cumsum(chord, dim=1)], dim=1)                # [K, n+1]

    n_wp = n * WAYPOINT_FACTOR
    ts = t[:, -1:] * (torch.arange(n_wp, dtype=cdt, device=dev) / n_wp)  # [K, W]
    m = periodic_spline_m(t, closed)              # one solve for both coordinates
    wp_x = eval_periodic_spline(t, closed[..., 0], m[..., 0], ts)
    wp_y = eval_periodic_spline(t, closed[..., 1], m[..., 1], ts)

    tan_x, tan_y = _roll1(wp_x) - wp_x, _roll1(wp_y) - wp_y
    length = torch.sqrt(tan_x * tan_x + tan_y * tan_y)
    length = torch.where(length == 0, torch.ones_like(length), length)
    nrm_x, nrm_y = -tan_y / length, tan_x / length

    w = width[:, None]
    left_x, left_y = wp_x + nrm_x * w, wp_y + nrm_y * w
    right_x, right_y = wp_x - nrm_x * w, wp_y - nrm_y * w
    lod = int(sensor_lod)
    if lod > 1:
        if n_wp % lod:
            raise ValueError(f"sensor_lod={lod} must divide n_wp={n_wp}")
        left_x, left_y = _decimate(left_x, left_y, nrm_x, nrm_y, lod)
        right_x, right_y = _decimate(right_x, right_y, -nrm_x, -nrm_y, lod)
    seg_sx = torch.cat([left_x, right_x], dim=1)
    seg_sy = torch.cat([left_y, right_y], dim=1)
    seg_vx = torch.cat([_roll1(left_x), _roll1(right_x)], dim=1) - seg_sx
    seg_vy = torch.cat([_roll1(left_y), _roll1(right_y)], dim=1) - seg_sy

    span_x = wp_x.amax(dim=1) - wp_x.amin(dim=1)
    span_y = wp_y.amax(dim=1) - wp_y.amin(dim=1)
    w_pad = _round_up(n_wp, pad_multiple)
    s_pad = _round_up(seg_sx.shape[1], pad_multiple)

    def pad(a, total, fill):
        out = torch.nn.functional.pad(a, (0, total - a.shape[1]), value=fill)
        return out.to(dtype)

    def f(a):
        return a.to(dtype)

    return TrackArrays(
        wp_x=pad(wp_x, w_pad, PAD_XY), wp_y=pad(wp_y, w_pad, PAD_XY),
        nrm_x=pad(nrm_x, w_pad, 0.0), nrm_y=pad(nrm_y, w_pad, 0.0),
        seg_sx=pad(seg_sx, s_pad, 0.0), seg_sy=pad(seg_sy, s_pad, 0.0),
        seg_vx=pad(seg_vx, s_pad, 0.0), seg_vy=pad(seg_vy, s_pad, 0.0),
        seg_c=pad(seg_vy * seg_sx - seg_vx * seg_sy, s_pad, 0.0),
        n_wp=torch.full((k,), n_wp, dtype=torch.int32, device=dev),
        track_width=f(width),
        max_track_distance=f(torch.sqrt(span_x * span_x + span_y * span_y)),
        start_x=f(wp_x[:, 0]), start_y=f(wp_y[:, 0]),
        start_angle=f(torch.atan2(wp_y[:, 1] - wp_y[:, 0], wp_x[:, 1] - wp_x[:, 0])),
        start_nx=f(nrm_x[:, 0]), start_ny=f(nrm_y[:, 0]),
    )


@dataclasses.dataclass
class TrackUniforms:
    """The unit uniforms a pool of K tracks of n control points is made from."""

    params: torch.Tensor   # [K, 4]: sample_track_params
    angle: torch.Tensor    # [K, n]: the angle jitter
    radius: torch.Tensor   # [K, n]: the radius variations
    width: torch.Tensor    # [K]: the track widths


def draw_track_uniforms(generator: torch.Generator, num_tracks: int, num_points: int,
                        dtype=torch.float32) -> TrackUniforms:
    """One draw of a pool's unit uniforms from ``generator``, on its device."""
    u = torch.rand((num_tracks, 5 + 2 * num_points), generator=generator, dtype=dtype,
                   device=generator.device)
    n = num_points
    return TrackUniforms(params=u[:, :4], angle=u[:, 4:4 + n], radius=u[:, 4 + n:4 + 2 * n],
                         width=u[:, -1])


def pool_from_uniforms(u: TrackUniforms, pad_multiple: int = 128,
                       width_range=WIDTH_RANGE, sensor_lod: int = 1,
                       dtype=None) -> TrackArrays:
    """The padded pool the uniforms give, computed in their dtype (and rounded to
    ``dtype``, by default theirs)."""
    cps = sample_control_points(u.params, u.angle, u.radius)
    widths = _uniform(u.width, *width_range)
    return build_track_arrays(cps, widths, pad_multiple=pad_multiple,
                              dtype=u.width.dtype if dtype is None else dtype,
                              sensor_lod=sensor_lod)


def pool_generator(seed: int, boundary: int, device=None) -> torch.Generator:
    """The generator of the pool that a run seeded ``seed`` trains on from update
    ``boundary`` on, on ``device`` (default cuda): seeded from both numbers, so a
    resumed run draws the pool it was training on."""
    dev = resolve_device(device)
    state = np.random.SeedSequence([int(seed), int(boundary)]).generate_state(1, np.uint64)
    return torch.Generator(device=dev).manual_seed(int(state[0]))


def gen_track_pool(generator: torch.Generator, num_tracks: int, num_points: int = 12,
                   pad_multiple: int = 128, width_range=WIDTH_RANGE,
                   sensor_lod: int = 1, dtype=torch.float32) -> TrackArrays:
    """A whole padded pool of ``num_tracks`` procedural tracks, drawn from
    ``generator`` and built on its device (the counterpart of the JAX package's
    ``gen_track_pool_device``)."""
    u = draw_track_uniforms(generator, num_tracks, num_points, dtype=dtype)
    return pool_from_uniforms(u, pad_multiple=pad_multiple, width_range=width_range,
                              sensor_lod=sensor_lod)

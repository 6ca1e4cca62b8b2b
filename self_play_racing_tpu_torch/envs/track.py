"""Procedural track generation (host NumPy) and padded track pools as tensors.

Port of ``self_play_racing_tpu/envs/track.py``. The host pipeline is the JAX
package's, kept as NumPy/SciPy so the control-point streams and the float64 geometry
are the same to the bit, including the reference quirk that ``gen_random_track``
reseeds the global NumPy RNG inside every call while ``gen_tracks`` draws each
track's parameters between reseeds. Only the final ``TrackArrays`` is torch.

Padding contract (consumed by ``ops.geometry``):
 - waypoints padded at PAD_XY (1e8, 1e8): can never win a nearest-waypoint argmin.
 - segments padded with zero direction vectors: filtered as parallel by the raycast.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.interpolate import CubicSpline

from .._device import resolve_device
from .._tree import tree_map

PAD_XY = 1.0e8
WAYPOINT_FACTOR = 30  # waypoints per control point

# Default control polygon + width used when no pool is given.
DEFAULT_CONTROL_POINTS = np.array(
    [
        [0, 0], [50, 0], [70, 20], [60, 40],
        [70, 50], [50, 70], [20, 70], [10, 50],
        [10, 20], [0, 10],
    ],
    dtype=np.float64,
)
DEFAULT_TRACK_WIDTH = 6.0


def gen_random_track(num_points=15, base_radius=50, radius_variation=15,
                     angle_jitter=0.2, smoothness=0.5, seed=None):
    """Control points on a jittered circle with smoothed radius variation.

    Draw-for-draw identical to the original generator: one uniform array for
    angle offsets, then one scalar uniform per point for the radius variation, all on
    the *global* NumPy RNG (reseeded here when ``seed`` is given — reference quirk).
    """
    if seed is not None:
        np.random.seed(seed)

    angles = np.linspace(0.0, 2 * np.pi, num_points, endpoint=False)
    if angle_jitter > 0:
        spacing = 2 * np.pi / num_points
        half = angle_jitter * spacing / 2
        angles = np.sort((angles + np.random.uniform(-half, half, num_points)) % (2 * np.pi))

    variations = np.array([np.random.uniform(-radius_variation, radius_variation)
                           for _ in range(num_points)])
    radii = np.empty(num_points)
    if smoothness > 0:
        radii[0] = base_radius + variations[0]
        for i in range(1, num_points):
            radii[i] = (1 - smoothness) * (base_radius + variations[i]) + smoothness * radii[i - 1]
        radii[0] = (radii[0] + radii[-1]) / 2  # close the loop
    else:
        radii = base_radius + variations

    return np.column_stack([radii * np.cos(angles), radii * np.sin(angles)])


def gen_tracks(num_tracks=10, seed=None):
    """Per-track parameter draws + generation, same global-RNG stream as the original."""
    out = []
    for _ in range(num_tracks):
        num_points = np.random.randint(10, 15)
        base_radius = np.random.randint(50, 80)
        radius_variation = np.random.randint(10, base_radius // 2 - 10)
        angle_jitter = np.random.uniform(0.2, 0.7)
        smoothness = np.random.uniform(0.2, 0.7)
        out.append(gen_random_track(num_points, base_radius, radius_variation,
                                    angle_jitter, smoothness, seed))
    return out


def build_track_geometry(control_points, track_width):
    """Full float64 geometry for one track: waypoints, normals, boundary segments,
    bounds, start pose. Returns a plain dict of NumPy arrays/scalars."""
    cp = np.asarray(control_points, dtype=np.float64)
    closed = np.vstack([cp, cp[:1]])
    t = np.concatenate(([0.0], np.cumsum(np.sqrt(np.sum(np.diff(closed, axis=0) ** 2, axis=1)))))
    spline_x = CubicSpline(t, closed[:, 0], bc_type="periodic")
    spline_y = CubicSpline(t, closed[:, 1], bc_type="periodic")

    n_wp = len(cp) * WAYPOINT_FACTOR
    ts = np.linspace(0.0, t[-1], n_wp, endpoint=False)
    wp = np.column_stack((spline_x(ts), spline_y(ts)))

    tangents = np.diff(wp, axis=0, append=wp[:1])
    lengths = np.linalg.norm(tangents, axis=1, keepdims=True)
    tangents = tangents / np.where(lengths == 0, 1.0, lengths)
    normals = np.column_stack((-tangents[:, 1], tangents[:, 0]))

    left = wp + normals * track_width
    right = wp - normals * track_width
    seg_start = np.vstack([left, right])
    seg_end = np.vstack([np.roll(left, -1, axis=0), np.roll(right, -1, axis=0)])

    span_x = wp[:, 0].max() - wp[:, 0].min()
    span_y = wp[:, 1].max() - wp[:, 1].min()

    return {
        "waypoints": wp,
        "normals": normals,
        "seg_start": seg_start,
        "seg_vec": seg_end - seg_start,
        "n_wp": n_wp,
        "track_width": float(track_width),
        "max_track_distance": float(np.sqrt(span_x**2 + span_y**2)),
        "start_x": float(wp[0, 0]),
        "start_y": float(wp[0, 1]),
        "start_angle": float(np.arctan2(wp[1, 1] - wp[0, 1], wp[1, 0] - wp[0, 0])),
        "start_nx": float(normals[0, 0]),
        "start_ny": float(normals[0, 1]),
    }


@dataclasses.dataclass
class TrackArrays:
    """Stacked, padded track geometry (structure of arrays).

    Leading axis is the pool (or env) axis. ``wp_*``/``nrm_*`` have shape [K, W];
    ``seg_*`` have shape [K, S] (left boundary, then right). ``seg_c`` is the
    ray-independent half of the raycast's t-numerator, ``vy*sx - vx*sy``.
    """

    wp_x: torch.Tensor
    wp_y: torch.Tensor
    nrm_x: torch.Tensor
    nrm_y: torch.Tensor
    seg_sx: torch.Tensor
    seg_sy: torch.Tensor
    seg_vx: torch.Tensor
    seg_vy: torch.Tensor
    seg_c: torch.Tensor
    n_wp: torch.Tensor                # int32 [K] true waypoint counts
    track_width: torch.Tensor         # [K]
    max_track_distance: torch.Tensor  # [K]
    start_x: torch.Tensor
    start_y: torch.Tensor
    start_angle: torch.Tensor
    start_nx: torch.Tensor
    start_ny: torch.Tensor

    @property
    def num_tracks(self):
        return self.wp_x.shape[0]

    @property
    def pad_waypoints(self):
        return self.wp_x.shape[-1]


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def _decimate_boundary(pts, out_nrm, lod):
    """Closed chord decimation of one boundary polyline with CONSERVATIVE
    outward vertex offsets: every kept vertex moves outward (along its waypoint
    normal) by the largest outward bulge of the skipped vertices on its two
    adjacent chords, so the LOD polyline contains the true wall — near-wall
    rays shorten slightly (by <= the local sagitta) instead of flipping to a
    max-range miss when the car sits between a chord and the real boundary.

    pts: [n, 2] boundary vertices in track order; out_nrm: [n, 2] outward
    normals; lod: decimation stride. Returns the decimated vertices [m, 2].
    """
    n = len(pts)
    idx = np.arange(0, n, lod)
    m = len(idx)
    chord_dev = np.zeros(m)
    for j in range(m):
        lo = idx[j]
        hi = idx[(j + 1) % m]
        a = pts[lo]
        b = pts[hi]
        span = (np.arange(lo + 1, lo + lod) % n) if (hi - lo) % n else []
        if len(span) == 0:
            continue
        c = b - a
        norm = np.hypot(*c)
        if norm < 1e-12:
            continue
        # outward normal of the chord: consistent with the boundary's own
        # outward direction at its start vertex
        cn = np.array([-c[1], c[0]]) / norm
        if np.dot(cn, out_nrm[lo]) < 0:
            cn = -cn
        dev = (pts[span] - a) @ cn
        chord_dev[j] = max(0.0, float(dev.max()))
    vert_off = np.maximum(chord_dev, np.roll(chord_dev, 1))  # adjacent chords
    return pts[idx] + out_nrm[idx] * vert_off[:, None]


def make_track_pool(control_points_list, track_widths, dtype=torch.float32,
                    pad_multiple=128, sensor_lod=1, device=None):
    """Build a stacked padded TrackArrays pool from per-track control points + widths.

    ``track_widths`` may be a scalar (shared) or a per-track sequence. Waypoint
    padding is rounded up to ``pad_multiple``; segment padding likewise.

    ``sensor_lod`` (opt-in relaxed sensing, default 1 = exact reference semantics):
    with lod k > 1 the raycast segment arrays are rebuilt as closed chords through
    every kth boundary vertex, offset outward so the coarse polyline contains the
    true wall. Only sensing changes: waypoints and normals, and therefore progress,
    rewards, collision and termination, stay exact.
    """
    dev = resolve_device(device)
    k = len(control_points_list)
    if np.isscalar(track_widths):
        track_widths = [track_widths] * k
    geoms = [build_track_geometry(cp, w) for cp, w in zip(control_points_list, track_widths)]
    lod = int(sensor_lod)
    if lod > 1:
        for g in geoms:
            n = g["n_wp"]
            starts = g["seg_start"]                     # [2n, 2]: left then right
            nrm = g["normals"]                          # [n, 2] (+n = left side)
            out = []
            for pts, sign in ((starts[:n], 1.0), (starts[n:], -1.0)):
                out.append(_decimate_boundary(pts, sign * nrm, lod))
            dl, dr = out
            dec_start = np.vstack([dl, dr])
            dec_end = np.vstack([np.roll(dl, -1, axis=0), np.roll(dr, -1, axis=0)])
            g["seg_start"] = dec_start
            g["seg_vec"] = dec_end - dec_start
            g["n_seg"] = len(dec_start)
    else:
        for g in geoms:
            g["n_seg"] = 2 * g["n_wp"]

    w_pad = _round_up(max(g["n_wp"] for g in geoms), pad_multiple)
    s_pad = _round_up(max(g["n_seg"] for g in geoms), pad_multiple)

    def pad_wp(arr, fill):
        out = np.full((w_pad,), fill, dtype=np.float64)
        out[: len(arr)] = arr
        return out

    def pad_seg(arr):
        out = np.zeros((s_pad,), dtype=np.float64)
        out[: len(arr)] = arr
        return out

    fields = {
        "wp_x": np.stack([pad_wp(g["waypoints"][:, 0], PAD_XY) for g in geoms]),
        "wp_y": np.stack([pad_wp(g["waypoints"][:, 1], PAD_XY) for g in geoms]),
        "nrm_x": np.stack([pad_wp(g["normals"][:, 0], 0.0) for g in geoms]),
        "nrm_y": np.stack([pad_wp(g["normals"][:, 1], 0.0) for g in geoms]),
        "seg_sx": np.stack([pad_seg(g["seg_start"][:, 0]) for g in geoms]),
        "seg_sy": np.stack([pad_seg(g["seg_start"][:, 1]) for g in geoms]),
        "seg_vx": np.stack([pad_seg(g["seg_vec"][:, 0]) for g in geoms]),
        "seg_vy": np.stack([pad_seg(g["seg_vec"][:, 1]) for g in geoms]),
        "seg_c": np.stack([
            pad_seg(g["seg_vec"][:, 1] * g["seg_start"][:, 0]
                    - g["seg_vec"][:, 0] * g["seg_start"][:, 1])
            for g in geoms
        ]),
        "track_width": np.array([g["track_width"] for g in geoms]),
        "max_track_distance": np.array([g["max_track_distance"] for g in geoms]),
        "start_x": np.array([g["start_x"] for g in geoms]),
        "start_y": np.array([g["start_y"] for g in geoms]),
        "start_angle": np.array([g["start_angle"] for g in geoms]),
        "start_nx": np.array([g["start_nx"] for g in geoms]),
        "start_ny": np.array([g["start_ny"] for g in geoms]),
    }
    return TrackArrays(
        n_wp=torch.tensor([g["n_wp"] for g in geoms], dtype=torch.int32, device=dev),
        **{name: torch.as_tensor(v, dtype=dtype, device=dev) for name, v in fields.items()},
    )


def default_track_pool(dtype=torch.float32, device=None):
    """Single-track pool with the reference's fallback control polygon + width 6.0."""
    return make_track_pool([DEFAULT_CONTROL_POINTS], DEFAULT_TRACK_WIDTH, dtype=dtype,
                           device=device)


def gather_tracks(pool: TrackArrays, track_ids) -> TrackArrays:
    """Per-env track data: gather pool rows by env->track assignment (once, outside
    the step loop, so every step reads contiguous per-env geometry)."""
    ids = torch.as_tensor(np.asarray(track_ids), dtype=torch.long,
                          device=pool.wp_x.device)
    return tree_map(lambda a: a.index_select(0, ids), pool)

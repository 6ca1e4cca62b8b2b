"""Trajectory recording and rendering (port of ``self_play_racing_tpu/utils/viz.py``).

The recorders roll episodes on the tensors' device through the evaluation loops
of ``utils/metrics.py`` (one policy, shared by every car, or one per seat; on a
CUDA device a replayed CUDA graph of the loop's step), whose step writes its poses
into [max_steps, N, ...] device buffers at row ``t``, as the JAX recorders' scan
stacks its outputs, and copy env 0's rows to the host once, at the end.
Rendering is an offline host pass over those arrays: pygame frames written to an
mp4 with OpenCV, a labeled grid of videos, and a learning-curve plot with
matplotlib. pygame, cv2 and matplotlib are imported inside the functions that use
them, so recording needs none of the three.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..envs import multi as menv
from ..envs import single as senv
from ..envs import track as trk
from ..tournament import stack_bundles
from . import metrics as M


def _pygame():
    import os

    os.environ.setdefault("SDL_VIDEODRIVER", "dummy")
    import pygame

    if not pygame.get_init():
        pygame.init()
    return pygame


def _trimmed(trace):
    """Env 0's host arrays [T] or [T, A] from a loop's trace buffers, copied to the
    host once and trimmed to the rows active entering the step: 0 through the done
    step. The row after that would re-step the frozen terminal state (re-firing
    e.g. the crash penalty), so it is left out, and so are the rows an early exit
    never wrote (inactive)."""
    traj = {k: v[:, 0].cpu().numpy() for k, v in trace.items()}
    n = int(traj["active"].sum())
    return {k: v[:n] for k, v in traj.items()}


def record_trajectory_single(params, log_std, env_cfg: senv.RacingConfig,
                             track: trk.TrackArrays, generator=None, max_steps=2000,
                             deterministic=True, obs_norm=None):
    """Roll one (batch-1) episode on the track's device; return host arrays of x,
    y, angle, speed, progress, reward and active per step. Sampled mode draws from
    ``generator`` (on the track's device)."""
    trace = {}
    M._rollout_single_acc(params, log_std, env_cfg, track, generator, max_steps,
                          deterministic, obs_norm, trace=trace)
    return _trimmed(trace)


def record_trajectory_multi(params, log_std, env_cfg: menv.MultiRacingConfig,
                            track: trk.TrackArrays, generator, max_steps=3000,
                            deterministic=True, obs_norm=None):
    """Shared-policy multi-car episode; arrays shaped [T, A]. ``generator`` draws
    the start-grid slots (and the sampled actions' noise)."""
    trace = {}
    M._rollout_multi_acc(params, log_std, env_cfg, track, generator, max_steps,
                         deterministic, obs_norm, trace=trace)
    return _trimmed(trace)


def record_trajectory_match(bundles, env_cfg: menv.MultiRacingConfig,
                            track: trk.TrackArrays, generator, max_steps=3000,
                            deterministic=True):
    """Head-to-head episode with one policy per seat (a tournament match);
    ``bundles`` is a list of (params, log_std, obs_norm_or_None), one per car.
    Arrays shaped [T, A]."""
    p, ls, nrm = stack_bundles(bundles, env_cfg.obs_dim)
    trace = {}
    M._rollout_multi_acc(p, ls, env_cfg, track, generator, max_steps, deterministic,
                         nrm, per_seat=True, trace=trace)
    return _trimmed(trace)


class TrackRenderer:
    """World->screen transform and static track drawing."""

    CAR_COLORS = [(220, 60, 60), (60, 120, 220), (60, 200, 120), (220, 180, 60)]

    def __init__(self, geometry: dict, size=(800, 600), margin=40):
        self.pg = _pygame()
        self.size = size
        wp = geometry["waypoints"]
        width = geometry["track_width"]
        self.left = wp + geometry["normals"] * width
        self.right = wp - geometry["normals"] * width
        self.wp = wp
        allpts = np.vstack([self.left, self.right])
        mn, mx = allpts.min(0), allpts.max(0)
        scale = min((size[0] - 2 * margin) / max(mx[0] - mn[0], 1e-9),
                    (size[1] - 2 * margin) / max(mx[1] - mn[1], 1e-9))
        self.scale = scale
        self.offset = (
            margin - mn[0] * scale + (size[0] - 2 * margin - (mx[0] - mn[0]) * scale) / 2,
            margin - mn[1] * scale + (size[1] - 2 * margin - (mx[1] - mn[1]) * scale) / 2,
        )
        self.surface = self.pg.Surface(size)
        self.font = self.pg.font.SysFont(None, 22)

    def to_screen(self, pts):
        pts = np.atleast_2d(pts)
        x = pts[:, 0] * self.scale + self.offset[0]
        y = self.size[1] - (pts[:, 1] * self.scale + self.offset[1])  # y up -> down
        return np.stack([x, y], 1)

    def draw_track(self):
        s = self.surface
        s.fill((28, 30, 34))
        road = np.vstack([self.to_screen(self.left),
                          self.to_screen(self.right)[::-1]])
        self.pg.draw.polygon(s, (60, 62, 66), road.tolist())
        for boundary, color in ((self.left, (230, 230, 230)),
                                (self.right, (230, 230, 230))):
            pts = self.to_screen(boundary)
            self.pg.draw.lines(s, color, True, pts.tolist(), 2)
        # start line across the track at waypoint 0
        a = self.to_screen(self.left[0])[0]
        b = self.to_screen(self.right[0])[0]
        self.pg.draw.line(s, (240, 220, 60), a.tolist(), b.tolist(), 3)

    def draw_car(self, x, y, angle, color, half_length=2.0, half_width=1.0):
        ca, sa = np.cos(angle), np.sin(angle)
        local = np.array([[half_length, half_width], [half_length, -half_width],
                          [-half_length, -half_width], [-half_length, half_width]])
        world = local @ np.array([[ca, sa], [-sa, ca]]) + np.array([x, y])
        self.pg.draw.polygon(self.surface, color, self.to_screen(world).tolist())

    def draw_trail(self, xs, ys, color):
        if len(xs) > 1:
            pts = self.to_screen(np.stack([xs, ys], 1))
            self.pg.draw.lines(self.surface, color, False, pts.tolist(), 1)

    def draw_hud(self, lines: Sequence[str]):
        for i, text in enumerate(lines):
            img = self.font.render(text, True, (240, 240, 240))
            self.surface.blit(img, (8, 8 + 20 * i))

    def frame(self):
        """Current frame as an RGB ndarray [H, W, 3]."""
        arr = self.pg.surfarray.array3d(self.surface)
        return np.transpose(arr, (1, 0, 2))


def render_video(geometry: dict, traj: dict, out_path: str, fps: int = 60,
                 label: Optional[str] = None, size=(800, 600), trail=True,
                 frame_skip: int = 1):
    """Write an mp4 of a logged trajectory. ``traj`` arrays may be [T] (single car)
    or [T, A] (multi). Returns the number of frames written."""
    import cv2

    r = TrackRenderer(geometry, size=size)
    xs, ys, angles = traj["x"], traj["y"], traj["angle"]
    if xs.ndim == 1:
        xs, ys, angles = xs[:, None], ys[:, None], angles[:, None]
    T, A = xs.shape
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    # cumulative reward up to each step, so frame_skip > 1 doesn't drop the
    # rewards of skipped steps from the HUD total
    rew = traj.get("reward")
    cum_r = None
    if rew is not None:
        rew2 = np.asarray(rew).reshape(T, -1)[:, :A]
        cum_r = np.cumsum(rew2, axis=0)
    total_r = np.zeros(A)
    for t in range(0, T, frame_skip):
        r.draw_track()
        for a in range(A):
            if trail:
                r.draw_trail(xs[: t + 1, a], ys[: t + 1, a],
                             r.CAR_COLORS[a % len(r.CAR_COLORS)])
            r.draw_car(xs[t, a], ys[t, a], angles[t, a],
                       r.CAR_COLORS[a % len(r.CAR_COLORS)])
        if cum_r is not None:
            total_r = cum_r[t]
        prog = np.atleast_1d(traj["progress"][t]).reshape(-1)
        speed = np.atleast_1d(traj["speed"][t]).reshape(-1)
        hud = ([label] if label else []) + [
            f"step {t}  progress {prog[0]*100:.1f}%  speed {speed[0]:.1f}"
            f"  reward {total_r[0]:.1f}"
        ]
        r.draw_hud(hud)
        writer.write(cv2.cvtColor(r.frame(), cv2.COLOR_RGB2BGR))
    writer.release()
    return (T + frame_skip - 1) // frame_skip


def visualization_grid(video_paths: Sequence[str], model_names: Sequence[str],
                       output_path: str, cell=(400, 300), fps: int = 60):
    """Compose N videos into a labeled 2-column grid mp4."""
    import cv2

    caps = [cv2.VideoCapture(p) for p in video_paths]
    cols = 2
    rows = (len(caps) + cols - 1) // cols
    size = (cell[0] * cols, cell[1] * rows)
    writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    font = cv2.FONT_HERSHEY_SIMPLEX
    last = [None] * len(caps)
    wrote = 0
    while True:
        frames = []
        alive = 0
        for i, cap in enumerate(caps):
            ok, fr = cap.read()
            if ok:
                last[i] = fr
                alive += 1
            fr = last[i]
            if fr is None:
                fr = np.zeros((cell[1], cell[0], 3), np.uint8)
            fr = cv2.resize(fr, cell)
            cv2.putText(fr, model_names[i], (10, 24), font, 0.7, (255, 255, 255), 2)
            frames.append(fr)
        if alive == 0:
            break
        while len(frames) < rows * cols:
            frames.append(np.zeros((cell[1], cell[0], 3), np.uint8))
        grid = np.vstack([np.hstack(frames[r * cols:(r + 1) * cols])
                          for r in range(rows)])
        writer.write(grid)
        wrote += 1
    writer.release()
    for cap in caps:
        cap.release()
    return wrote


def eval_training(data: dict, output_path: str):
    """Normalized learning-curve overlay: ``data`` maps label -> training_info
    JSON path."""
    import json

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    loaded = {}
    for name, filepath in data.items():
        with open(filepath) as f:
            loaded[name] = json.load(f)
    min_len = min(len(d["steps"]) for d in loaded.values())
    plt.figure(figsize=(12, 7))
    for name, d in loaded.items():
        steps = d["steps"][:min_len]
        rewards = np.asarray(d["rewards"][:min_len], float)
        span = rewards.max() - rewards.min()
        normalized = (rewards - rewards.min()) / (span if span > 0 else 1.0)
        plt.plot(steps, normalized, label=name, linewidth=2, alpha=0.6)
    plt.xlabel("Training Steps")
    plt.ylabel("Normalized Rewards")
    plt.title("Learning Speed Comparison")
    plt.legend()
    plt.grid(True, alpha=0.3)
    plt.tight_layout()
    plt.savefig(output_path, dpi=150)
    plt.close()

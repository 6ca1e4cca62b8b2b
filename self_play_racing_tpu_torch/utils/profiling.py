"""Profiling hooks, a throughput meter and the canonical benchmark track pool (port
of ``self_play_racing_tpu/utils/profiling.py``).

``trace`` captures a ``torch.profiler`` trace of the host and, where there is one,
the card, written as a Chrome trace JSON that Perfetto opens; ``annotate`` names a
region on that timeline.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from ..envs import track as trk


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a profiler trace of the block into
    ``<log_dir>/trace_<pid>_<ns>.json`` (open it in Perfetto or chrome://tracing)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)


class Throughput:
    """Running steps/s meter with exponential window, for per-update logging."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self._last_t = None
        self._rate = None
        self.total_steps = 0

    def update(self, steps: int) -> float:
        now = time.perf_counter()
        self.total_steps += steps
        if self._last_t is not None:
            inst = steps / max(now - self._last_t, 1e-9)
            self._rate = (inst if self._rate is None
                          else self.alpha * inst + (1 - self.alpha) * self._rate)
        self._last_t = now
        return self._rate or 0.0

    @property
    def rate(self) -> float:
        return self._rate or 0.0


def canonical_bench_pool(num_tracks=16, dtype=None, sensor_lod=1, device=None):
    """The pinned benchmark pool: ``gen_tracks(seed=1)`` after seeding the global
    NumPy RNG with 1, and per-index ``RandomState(i)`` widths in [6, 10). With 16
    tracks it pads to W = 512 waypoints and S = 896 segments."""
    np.random.seed(1)
    cps = trk.gen_tracks(num_tracks=num_tracks, seed=1)
    widths = [float(np.random.RandomState(i).randint(6, 10)) for i in range(num_tracks)]
    return trk.make_track_pool(cps, widths, dtype=dtype or torch.float32,
                               sensor_lod=sensor_lod, device=device)

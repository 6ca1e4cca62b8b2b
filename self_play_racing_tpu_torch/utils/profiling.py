"""The canonical benchmark track pool (port of ``canonical_bench_pool`` in
``self_play_racing_tpu/utils/profiling.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..envs import track as trk


def canonical_bench_pool(num_tracks=16, dtype=None, sensor_lod=1, device=None):
    """The pinned benchmark pool: ``gen_tracks(seed=1)`` after seeding the global
    NumPy RNG with 1, and per-index ``RandomState(i)`` widths in [6, 10). With 16
    tracks it pads to W = 512 waypoints and S = 896 segments."""
    np.random.seed(1)
    cps = trk.gen_tracks(num_tracks=num_tracks, seed=1)
    widths = [float(np.random.RandomState(i).randint(6, 10)) for i in range(num_tracks)]
    return trk.make_track_pool(cps, widths, dtype=dtype or torch.float32,
                               sensor_lod=sensor_lod, device=device)

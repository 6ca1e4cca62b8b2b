"""The port's track pools against the JAX package's, on the CPU.

Every ``TrackArrays`` field must equal the JAX pool's bitwise: the host pipeline is
the same NumPy/SciPy code in float64, and both packages round to the target dtype
once. ``gen_tracks`` draws from the global NumPy RNG between its reseeds, so the RNG
is seeded before each side.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from self_play_racing_tpu.envs import track as jtrack
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.envs import track as ttrack

FIELDS = [f.name for f in dataclasses.fields(ttrack.TrackArrays)]
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _pools(seed, dtype, lod, n=16):
    jd, td = DTYPES[dtype]
    np.random.seed(seed)
    widths = np.random.RandomState(seed).uniform(5, 10, n)
    np.random.seed(seed)
    jp = jtrack.make_track_pool(jtrack.gen_tracks(n, seed=seed), list(widths), dtype=jd,
                                sensor_lod=lod)
    np.random.seed(seed)
    tp = ttrack.make_track_pool(ttrack.gen_tracks(n, seed=seed), list(widths), dtype=td,
                                sensor_lod=lod, device="cpu")
    return jp, tp


def _assert_same(jp, tp):
    assert sorted(FIELDS) == sorted(f.name for f in dataclasses.fields(jtrack.TrackArrays))
    for name in FIELDS:
        j = np.asarray(getattr(jp, name))
        t = getattr(tp, name).numpy()
        assert t.dtype == j.dtype, name
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t, j, err_msg=name)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("lod", [1, 4])
def test_pool_fields_bitwise(dtype, lod):
    jp, tp = _pools(11, dtype, lod)
    _assert_same(jp, tp)
    assert tp.num_tracks == 16 and tp.pad_waypoints == jp.pad_waypoints


def test_gen_tracks_stream_and_quirk():
    np.random.seed(123)
    j = jtrack.gen_tracks(6, seed=1)
    np.random.seed(123)
    t = ttrack.gen_tracks(6, seed=1)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttrack.gen_random_track(10, 55, 12, 0.5, 0.0, seed=3),
                                  jtrack.gen_random_track(10, 55, 12, 0.5, 0.0, seed=3))


def test_gather_tracks_bitwise():
    jp, tp = _pools(5, "f32", 1, n=4)
    ids = np.arange(10) % 4
    _assert_same(jtrack.gather_tracks(jp, ids), ttrack.gather_tracks(tp, ids))


def test_default_pool_and_pad_multiple():
    _assert_same(jtrack.default_track_pool(jnp.float64),
                 ttrack.default_track_pool(torch.float64, device="cpu"))
    cps = [ttrack.DEFAULT_CONTROL_POINTS]
    jp = jtrack.make_track_pool(cps, 6.0, dtype=jnp.float32, pad_multiple=64)
    tp = ttrack.make_track_pool(cps, 6.0, dtype=torch.float32, pad_multiple=64,
                                device="cpu")
    _assert_same(jp, tp)

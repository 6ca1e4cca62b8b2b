"""The port's procedural track pools (``envs/procgen.py``) against the JAX package's,
on the CPU.

- The periodic spline against ``scipy.interpolate.CubicSpline(bc_type="periodic")``
  within 1e-8 (as the JAX package's own test holds it), and against JAX's
  ``periodic_spline_m`` and ``eval_periodic_spline`` within 1e-12: the dense solve
  (LAPACK through ``torch.linalg.solve`` and ``jnp.linalg.solve``) rounds alike
  here, but nothing promises it.
- ``build_track_arrays`` against JAX's on the same control points and widths, at
  sensor_lod 1 and 2: float64 within rtol 1e-12 / atol 1e-10 (the cumulative sum
  and the spline's rounding; ``seg_c`` is a difference of products ~1e3), float32
  within 1 ulp of the float32 rounding of JAX's.
- ``sample_control_points`` fed JAX's own unit uniforms (the same key splits as
  JAX's ``sample_control_points``) within 1e-12: the cos/sin of the polygon round
  differently in XLA's and PyTorch's CPU math. A whole pool from JAX's draws
  (``pool_from_uniforms``) against ``gen_track_pool_device`` within 1 float32 ulp.
- The relaxed-sensing chords, with a chord of zero length and a chord normal
  perpendicular to the outward normal, equal the JAX package's host construction
  (``track._decimate_boundary``) exactly.
- ``gen_track_pool`` is deterministic per ``(seed, boundary)`` and its shapes are
  the launch plans' (12 points: W = 384, S = 768).
- ``train_scale(resample_tracks_every=2)`` resumed mid-period trains on the pool
  of the boundary before it, as the JAX package's does (the port's own pools: the
  two packages' random streams differ).
- ``evaluate --procgen --device cpu`` on 2 tracks.
"""
import dataclasses

import numpy as np
import pytest
import torch
from scipy.interpolate import CubicSpline

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import procgen as jpg
from self_play_racing_tpu.envs import track as jtrack
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch.envs import procgen as tpg
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack

FIELDS = [f.name for f in dataclasses.fields(ttrack.TrackArrays)]
MULTI_MODEL = "models/self_play_agent_dr_500M.npz"


def _closed_polygon(seed, n):
    cp = jtrack.gen_random_track(num_points=n, seed=seed)
    closed = np.vstack([cp, cp[:1]])
    t = np.concatenate(([0.0], np.cumsum(np.linalg.norm(np.diff(closed, axis=0), axis=1))))
    return closed, t


@pytest.mark.parametrize("seed,n", [(0, 10), (1, 12), (2, 15)])
def test_periodic_spline_matches_scipy_and_jax(seed, n):
    closed, t = _closed_polygon(seed, n)
    ts = np.linspace(0.0, t[-1], 173, endpoint=False)
    tt = torch.tensor(t)
    for dim in range(2):
        y = closed[:, dim]
        m = tpg.periodic_spline_m(tt, torch.tensor(y))
        ours = tpg.eval_periodic_spline(tt, torch.tensor(y), m, torch.tensor(ts)).numpy()
        np.testing.assert_allclose(ours, CubicSpline(t, y, bc_type="periodic")(ts), atol=1e-8)
        jm = jpg.periodic_spline_m(jnp.asarray(t), jnp.asarray(y))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-12, atol=1e-12)
        jo = jpg.eval_periodic_spline(jnp.asarray(t), jnp.asarray(y), jm, jnp.asarray(ts))
        np.testing.assert_allclose(ours, np.asarray(jo), rtol=1e-12, atol=1e-12)
    # both coordinates in one solve, as build_track_arrays solves them
    m2 = tpg.periodic_spline_m(tt, torch.tensor(closed))
    for dim in range(2):
        np.testing.assert_allclose(
            m2[:, dim].numpy(), tpg.periodic_spline_m(tt, torch.tensor(closed[:, dim])).numpy(),
            rtol=1e-12, atol=1e-12)
    assert float(m2[0, 0]) == float(m2[-1, 0])


def _assert_pool_close(jp, tp, f32):
    assert sorted(FIELDS) == sorted(f.name for f in dataclasses.fields(jtrack.TrackArrays))
    for name in FIELDS:
        j, t = np.asarray(getattr(jp, name)), getattr(tp, name).numpy()
        assert t.dtype == j.dtype and t.shape == j.shape, name
        if name == "n_wp":
            np.testing.assert_array_equal(t, j)
        elif f32:
            np.testing.assert_array_max_ulp(t, j, maxulp=1)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-10, err_msg=name)


@pytest.mark.parametrize("lod", [1, 2])
@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_build_track_arrays_matches_jax(lod, dtype):
    cps = np.stack([jtrack.gen_random_track(num_points=12, seed=s) for s in (3, 4, 5)])
    widths = np.array([6.0, 7.5, 9.0])
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.float64, torch.float64)
    jp = jpg.build_track_arrays(jnp.asarray(cps), jnp.asarray(widths), dtype=jd,
                                sensor_lod=lod)
    tp = tpg.build_track_arrays(torch.tensor(cps), torch.tensor(widths), dtype=td,
                                sensor_lod=lod)
    _assert_pool_close(jp, tp, dtype == "f32")
    assert tp.pad_waypoints == 384 and tp.seg_sx.shape[-1] == (768 if lod == 1 else 384)


def _jax_uniforms(key, n):
    """The unit uniforms JAX's sample_control_points draws from ``key``: its key
    splits, each drawn with uniform's defaults (u itself)."""
    kp, ka, kv = jax.random.split(key, 3)
    params = [float(jax.random.uniform(k, ())) for k in jax.random.split(kp, 4)]
    return (np.array(params), np.asarray(jax.random.uniform(ka, (n,))),
            np.asarray(jax.random.uniform(kv, (n,))))


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("n", [10, 12])
def test_sample_control_points_fed_jax_uniforms(seed, n):
    key = jax.random.key(seed)
    up, ua, ur = _jax_uniforms(key, n)
    ours = tpg.sample_control_points(torch.tensor(up), torch.tensor(ua), torch.tensor(ur))
    np.testing.assert_allclose(ours.numpy(), np.asarray(jpg.sample_control_points(key, n)),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("lod", [1, 2])
def test_pool_from_jax_uniforms_matches_gen_track_pool_device(lod):
    key, k, n = jax.random.key(7), 4, 12
    kc, kw = jax.random.split(key)
    drawn = [_jax_uniforms(kt, n) for kt in jax.random.split(kc, k)]
    u = tpg.TrackUniforms(
        params=torch.tensor(np.stack([d[0] for d in drawn])),
        angle=torch.tensor(np.stack([d[1] for d in drawn])),
        radius=torch.tensor(np.stack([d[2] for d in drawn])),
        width=torch.tensor(np.asarray(jax.random.uniform(kw, (k,)))))
    jp = jpg.gen_track_pool_device(key, k, n, 128, (6.0, 10.0), lod)
    _assert_pool_close(jp, tpg.pool_from_uniforms(u, sensor_lod=lod, dtype=torch.float32),
                       True)


def test_decimate_reaches_the_degenerate_branches():
    """Kept vertices 0 and 2 coincide (a zero-length chord: the norm < 1e-12 branch)
    and chord 2 -> 4 runs along the outward normal at 2 (its sign is 0)."""
    pts = np.array([[0, 0], [1, 1], [0, 0], [2, 3], [0, 4], [-3, 3], [-4, 1], [-2, -1]],
                   np.float64)
    out = np.array([[0, -1], [1, 0], [0, -1], [1, 1], [0, 1], [-1, 1], [-1, 0], [0, -1]],
                   np.float64)
    want = jtrack._decimate_boundary(pts, out, 2)
    px, py = torch.tensor(pts.T)[:, None]   # [1, n] each: a pool of one boundary
    ox, oy = torch.tensor(out.T)[:, None]
    gx, gy = tpg._decimate(px, py, ox, oy, 2)
    np.testing.assert_array_equal(np.stack([gx[0].numpy(), gy[0].numpy()], -1), want)
    # and through the pool builder the chords stay finite on a real track
    pool = tpg.gen_track_pool(torch.Generator().manual_seed(3), 2, sensor_lod=2,
                              dtype=torch.float64)
    assert torch.isfinite(pool.seg_c).all()


def test_gen_track_pool_deterministic_per_seed_and_boundary():
    def pool(seed, boundary):
        return tpg.gen_track_pool(tpg.pool_generator(seed, boundary, "cpu"), 4)

    a, a2, b, c = pool(1, 0), pool(1, 0), pool(1, 2), pool(2, 0)
    for name in FIELDS:
        assert torch.equal(getattr(a, name), getattr(a2, name)), name
    assert not torch.allclose(a.wp_x, b.wp_x) and not torch.allclose(a.wp_x, c.wp_x)
    assert a.wp_x.dtype == torch.float32 and a.num_tracks == 4
    assert (a.wp_x.shape[-1], a.seg_sx.shape[-1]) == (384, 768)
    assert ((a.track_width >= 6.0) & (a.track_width < 10.0)).all()
    assert (a.n_wp == 12 * ttrack.WAYPOINT_FACTOR).all()
    assert (a.max_track_distance > 0).all()
    # envs reset and step on it; a straight start crashes no car
    track = ttrack.gather_tracks(a, np.arange(8) % 4)
    cfg = tsingle.RacingConfig(num_sensors=11)
    state, obs = tsingle.reset(cfg, track)
    action = torch.tensor([[0.0, 1.0]]).expand(8, 2)
    for _ in range(5):
        state, obs, *_ = tsingle.step(cfg, track, state, action)
    assert torch.isfinite(obs).all() and not state.car.crashed.any()


def test_scale_resume_mid_period_restores_the_boundarys_pool(tmp_path):
    kw = dict(total_timesteps=8 * 16 * 6, num_envs=8, num_steps=16, num_tracks=2,
              track_points=10, resample_tracks_every=2,
              checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3,
              out=str(tmp_path / "m.npz"), info_out=str(tmp_path / "i.json"),
              num_minibatches=2, update_epochs=1, seed=1, snapshot_freq=100,
              device="cpu")
    # updates 0-3: the pool swaps before update 2; a checkpoint lands at update 3
    first = ttrain.train_scale(num_updates=4, **kw)
    tr = ttrain.train_scale(num_updates=1, **kw,
                            resume_from=str(tmp_path / "ck" / "checkpoint_update_3"))
    # update 4, the one trained after the resume, runs before the boundary-4 swap,
    # so the active pool is boundary 2's
    assert tr.runner.train.update == 4
    want = ttrack.gather_tracks(ttrain.procgen_pool(1, 2, 2, 10, device="cpu"),
                                np.arange(8) % 2)
    for name in FIELDS:
        assert torch.equal(getattr(tr.aux["track"], name), getattr(want, name)), name
        assert torch.equal(getattr(first.aux["track"], name), getattr(want, name)), name
    assert not torch.equal(want.wp_x, ttrack.gather_tracks(
        ttrain.procgen_pool(1, 0, 2, 10, device="cpu"), np.arange(8) % 2).wp_x)


def test_evaluate_cli_procgen(tmp_path, monkeypatch, capsys):
    import os

    model = os.path.abspath(MULTI_MODEL)
    monkeypatch.chdir(tmp_path)
    by_label = tevaluate.main(["--multi", model, "--procgen", "--num-tracks", "2",
                               "--num-runs", "1", "--device", "cpu"])
    r = by_label["self_play"]["procgen"]
    assert r["num_episodes"] == 2 and 0.0 <= r["success_rate"] <= 1.0
    assert "procgen zero-shot (self_play_agent_dr_500M.npz)" in capsys.readouterr().out
    direct = tevaluate.evaluate_multi_agent_procgen(model, num_tracks=2, device="cpu")
    assert direct == r

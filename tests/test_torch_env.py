"""The port's single-car env and autoreset against the JAX package's, on the CPU.

Both packages run in float64 with 32 envs; JAX runs jitted, as all its paths do.

- ``single.step`` runs in lockstep with JAX for 500 steps on one action stream: the
  JAX policy's greedy action plus NumPy noise of growing scale across envs, so some
  cars drive laps and some crash. Rewards and info match within rtol 1e-9 (cos and
  sin round differently in XLA's and PyTorch's CPU math in about 0.2% of float64
  values, so states drift by a few ulps); done flags are exact; observations, as
  float32, are exact for the rays and within 1e-12 absolute for the kinematic
  features (see ``_assert_obs``).
- ``vector.step`` with forced crashes: NEXT_STEP autoreset rows give reward 0 and
  done False, reset-info is substituted, and the episode records match, at the
  same tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import single as jenv
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.envs import vector as jvec
from self_play_racing_tpu.evaluate import load_policy_bundle
from self_play_racing_tpu.models import actor_critic as jnet
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.envs import single as tenv
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.envs import vector as tvec

N = 32
RTOL = 1e-9


def _tracks(n_tracks=8, seed=2, jd=jnp.float64, td=torch.float64):
    widths = [6.0 + (i % 4) for i in range(n_tracks)]
    ids = np.arange(N) % n_tracks
    np.random.seed(seed)
    jp = jtrack.make_track_pool(jtrack.gen_tracks(n_tracks, seed=seed), widths, dtype=jd)
    np.random.seed(seed)
    tp = ttrack.make_track_pool(ttrack.gen_tracks(n_tracks, seed=seed), widths, dtype=td,
                                device="cpu")
    return jtrack.gather_tracks(jp, ids), ttrack.gather_tracks(tp, ids)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_obs(t, j, num_rays=11):
    """Rays exact; the kinematic features exact up to cancellation noise: v_lat of a
    car driving straight is a difference of near-equal products whose last bits
    follow cos/sin (seen: 9e-19 against 0), so those get an absolute 1e-12."""
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t[:, :num_rays], j[:, :num_rays])
    np.testing.assert_allclose(t[:, num_rays:], j[:, num_rays:], rtol=0, atol=1e-12)


def _assert_tree_close(j, t, what):
    for k in j:
        a, b = np.asarray(j[k]), _np(t[k])
        if a.dtype == bool:
            np.testing.assert_array_equal(b, a, err_msg=f"{what}[{k}]")
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=RTOL, err_msg=f"{what}[{k}]")


@pytest.mark.parametrize("max_steps", [3000, 400])
def test_single_step_lockstep_500_f64(max_steps):
    jtr, ttr = _tracks()
    jcfg = jenv.RacingConfig(num_sensors=11, max_steps=max_steps)
    tcfg = tenv.RacingConfig(num_sensors=11, max_steps=max_steps)
    params, _, _ = load_policy_bundle("models/single_agent.npz")
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    # JAX runs under jit, as every path of the JAX package does (XLA turns a
    # division by a constant into a multiply by its reciprocal, and the port
    # rounds the same way); the track goes in as an argument, since closed over it
    # would be folded into constants and rewritten too
    jstep = jax.jit(lambda tr, s, a: jenv.step(jcfg, tr, s, a))
    policy = jax.jit(jnet.deterministic_action)

    js, jobs = jax.jit(lambda tr: jenv.reset(jcfg, tr))(jtr)
    ts, tobs = tenv.reset(tcfg, ttr)
    _assert_obs(tobs, jobs)
    rng = np.random.default_rng(0)
    noise_scale = np.linspace(0.05, 1.0, N)[:, None]  # calm drivers finish, wild ones crash
    events = {}
    for _ in range(500):
        action = np.asarray(policy(params, jobs)) + noise_scale * rng.normal(size=(N, 2))
        js, jobs, jr, jterm, jtrunc, jinfo = jstep(jtr, js, jnp.asarray(action))
        ts, tobs, tr, tterm, ttrunc, tinfo = tenv.step(tcfg, ttr, ts, torch.from_numpy(action))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=RTOL)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        np.testing.assert_array_equal(ttrunc.numpy(), np.asarray(jtrunc))
        _assert_tree_close(jinfo, tinfo, "info")
        _assert_obs(tobs, jobs)
    events["crashed"] = int(np.asarray(js.car.crashed).sum())
    events["finished"] = int(np.asarray(js.car.finished).sum())
    events["truncated"] = int(np.asarray(jtrunc).sum())
    # the stream exercises laps, crashes and (with the short horizon) truncation
    assert events["finished"] > 0 and events["crashed"] > 0
    assert (events["truncated"] > 0) == (max_steps < 500)


def test_vector_autoreset_forced_crashes():
    jtr, ttr = _tracks(n_tracks=4, seed=9)
    jcfg = jenv.RacingConfig(num_sensors=11)
    tcfg = tenv.RacingConfig(num_sensors=11)
    jstate, _ = jenv.reset(jcfg, jtr)
    tstate, _ = tenv.reset(tcfg, ttr)
    jvs = jvec.init(jstate, N, jax.random.key(0))
    tvs = tvec.init(tstate, N)
    jstep = jax.jit(lambda tr, vs, a: jvec.step(
        vs, a,
        lambda s, a_, k: jenv.transition(jcfg, tr, s, a_),
        lambda s: jenv.observe(jcfg, tr, s),
        lambda k: jenv.reset_state(jcfg, tr),
        info_fn=lambda s: jenv.info_from_state(jcfg, tr, s)))

    def tstep(vs, a):
        return tvec.step(
            vs, a,
            lambda s, a_, g, pending, stats: tenv.transition_autoreset(tcfg, ttr, s, a_, pending,
                                                                       stats),
            lambda s: tenv.observe(tcfg, ttr, s))

    rng = np.random.default_rng(1)
    autoresets = 0
    for t in range(150):
        # full throttle, hard steering: most cars hit a wall within a few dozen steps
        action = np.stack([rng.choice([-1.0, 1.0], N), np.ones(N)], -1).astype(np.float32)
        jvs, jobs, jr, jd, jterm, jtrunc, jinfo, jrec = jstep(jtr, jvs, jnp.asarray(action))
        tvs, tobs, tr, td, tterm, ttrunc, tinfo, trec = tstep(tvs, torch.from_numpy(action))
        _assert_obs(tobs, jobs)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=RTOL)
        for a, b in ((td, jd), (tterm, jterm), (ttrunc, jtrunc)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _assert_tree_close(jinfo, tinfo, "info")
        _assert_tree_close(jrec, trec, "record")
        reset_rows = trec["autoreset"].numpy()
        autoresets += int(reset_rows.sum())
        if reset_rows.any():
            assert (tr.numpy()[reset_rows] == 0).all() and not td.numpy()[reset_rows].any()
            # reset-info: the fresh state's position and zeroed per-step leaves
            np.testing.assert_array_equal(tinfo["x"].numpy()[reset_rows],
                                          ttr.start_x.numpy()[reset_rows])
            assert (tinfo["progress_delta"].numpy()[reset_rows] == 0).all()
    assert autoresets >= N  # every env crashed and reset at least once


def test_env_options_lockstep_f64():
    """The options the main test leaves at their defaults: clamped sensor reads, a
    LOD-4 sensing pool and a speed weight passed as a tensor (as annealing does),
    80 lockstep steps at the same tolerances."""
    n_tracks, seed = 4, 6
    widths = [7.0] * n_tracks
    ids = np.arange(N) % n_tracks
    np.random.seed(seed)
    jp = jtrack.make_track_pool(jtrack.gen_tracks(n_tracks, seed=seed), widths,
                                dtype=jnp.float64, sensor_lod=4)
    np.random.seed(seed)
    tp = ttrack.make_track_pool(ttrack.gen_tracks(n_tracks, seed=seed), widths,
                                dtype=torch.float64, sensor_lod=4, device="cpu")
    jtr, ttr = jtrack.gather_tracks(jp, ids), ttrack.gather_tracks(tp, ids)
    jcfg = jenv.RacingConfig(num_sensors=7, clamp_sensor_range=True, max_sensor_range=30.0)
    tcfg = tenv.RacingConfig(num_sensors=7, clamp_sensor_range=True, max_sensor_range=30.0)
    jstep = jax.jit(lambda tr, s, a, sw: jenv.step(jcfg, tr, s, a, speed_weight=sw))
    js, jobs = jax.jit(lambda tr: jenv.reset(jcfg, tr))(jtr)
    ts, tobs = tenv.reset(tcfg, ttr)
    _assert_obs(tobs, jobs, num_rays=7)
    rng = np.random.default_rng(3)
    for t in range(80):
        action = np.stack([rng.uniform(-0.3, 0.3, N), rng.uniform(0.3, 1.0, N)], -1)
        sw = 8.0 - 0.05 * t
        js, jobs, jr, jterm, jtrunc, jinfo = jstep(jtr, js, jnp.asarray(action),
                                                   jnp.float64(sw))
        ts, tobs, tr, tterm, ttrunc, tinfo = tenv.step(
            tcfg, ttr, ts, torch.from_numpy(action), speed_weight=torch.tensor(sw,
                                                                             dtype=torch.float64))
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=RTOL, atol=RTOL)
        np.testing.assert_array_equal(tterm.numpy(), np.asarray(jterm))
        _assert_tree_close(jinfo, tinfo, "info")
        _assert_obs(tobs, jobs, num_rays=7)
        assert tobs.numpy()[:, :7].max() <= 1.0  # clamped reads

"""The envs' two kernels' plain versions, on the CPU: each against the composition of
the port's pieces that it replaces in the env step, and against the JAX package.

``raycast_walls_and_cars`` is the multi-car env's sensing (K1 and K3 of every car's
rays and their minimum) and ``car_step_and_query`` the envs' transition (K5, the
corners and K2). On CPU tensors both run their plain versions, which the CUDA
kernels are held to on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).

Tolerances:
 - against the composition the envs made before (the rays and corners in
   PyTorch, then ``raycast_walls``, ``raycast_cars`` and ``torch.minimum``; then
   ``car_update``, ``car_corners`` and ``progress_and_collision``): bitwise, in
   float32 and float64, as the functions are that composition;
 - the sensing against JAX's ``car_corners``, ``raycast_walls``, eager
   ``raycast_cars`` and ``jnp.minimum`` on JAX's own cos and sin of the same ray
   angles: hit or miss identical; distances within rtol 1e-12 in float64 and 1e-5
   in float32. XLA's and PyTorch's CPU math round cos and sin differently in the
   last bit (about 0.2% of float64 and 5% of float32 values); a hit distance
   carries that through its division. Jitted JAX contracts K3's numerators into
   FMAs, so the car part is compared with eager JAX;
 - the transition against JAX's ``car_update``, ``car_corners`` and
   ``progress_and_collision``: in float64 the state and corners within rtol and
   atol 1e-12 (cos and sin again) and progress and the wall hit exact; in float32
   the state within rtol 1e-5 / atol 1e-4 (tests/test_torch_multi_env.py's
   tolerance for K5: v_lat's cancellation carries the cos/sin difference to the
   velocities), and progress and the wall hit exactly JAX's track query of the
   port's own new pose and corners (K2 is exact on equal inputs). The heading and
   crashed cars are exact in both.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.ops import dynamics as jdyn
from self_play_racing_tpu.ops import geometry as jgeo
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.ops import dynamics as tdyn
from self_play_racing_tpu_torch.ops import geometry as tgeo

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}
HALF_LENGTH, HALF_WIDTH, MAX_DIST = 2.0, 1.0, 50.0


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------------ sensing

def _sensing_inputs(rng, n, a, r, s, dtype):
    """n rows of a cars (car 1 of row 0 within the 0.5 skip radius of car 0), r
    sensor angles over +-pi/2, and a segment soup [n, s] per row whose last third
    (and all of row 0 at s = 1) is zero-direction padding."""
    x, y = rng.uniform(-8, 8, (2, n, a))
    ang = rng.uniform(0, 2 * np.pi, (n, a))
    if a > 1:
        x[0, 1], y[0, 1] = x[0, 0] + 0.3, y[0, 0] - 0.2
    rel = np.linspace(-np.pi / 2, np.pi / 2, r)
    sx, sy = rng.uniform(-15, 15, (2, n, s))
    vx, vy = rng.uniform(-12, 12, (2, n, s))
    pad = (slice(None), slice(s - s // 3, None)) if s > 1 else (0, slice(None))
    for f in (sx, sy, vx, vy):
        f[pad] = 0.0
    c = vy * sx - vx * sy
    return [v.astype(dtype) for v in (x, y, ang, rel, sx, sy, vx, vy, c)]


def _observe_composition(x, y, ang, rel, sx, sy, vx, vy, c):
    """The multi-car env's sensing as it was composed before its kernel."""
    world = ang[:, :, None] + rel
    ox = x[:, :, None].expand(world.shape)
    oy = y[:, :, None].expand(world.shape)
    dx, dy = torch.cos(world), torch.sin(world)
    wall = tgeo.raycast_walls(ox, oy, dx, dy, sx[:, None, None, :], sy[:, None, None, :],
                              vx[:, None, None, :], vy[:, None, None, :], MAX_DIST,
                              seg_c=c[:, None, None, :])
    ccx, ccy = tgeo.car_corners(x, y, ang, HALF_LENGTH, HALF_WIDTH)
    cars = tgeo.raycast_cars(ox, oy, dx, dy, ccx[:, None, None], ccy[:, None, None],
                             x[:, None, None, :].contiguous(), y[:, None, None, :].contiguous(),
                             MAX_DIST)
    return torch.minimum(wall, cars)


def _jax_sensing(x, y, ang, rel, sx, sy, vx, vy, c):
    x, y, ang, rel, sx, sy, vx, vy, c = map(jnp.asarray, (x, y, ang, rel, sx, sy, vx, vy, c))
    world = ang[:, :, None] + rel
    ox = jnp.broadcast_to(x[:, :, None], world.shape)
    oy = jnp.broadcast_to(y[:, :, None], world.shape)
    dx, dy = jnp.cos(world), jnp.sin(world)
    row = lambda f: jnp.broadcast_to(f[:, None, None, :], world.shape + f.shape[-1:])
    wall = jgeo.raycast_walls(ox, oy, dx, dy, row(sx), row(sy), row(vx), row(vy), MAX_DIST,
                              seg_c=row(c))
    ccx, ccy = jgeo.car_corners(x, y, ang, HALF_LENGTH, HALF_WIDTH)
    cars_shape = world.shape + ccx.shape[-2:]
    car = jgeo.raycast_cars(ox, oy, dx, dy,
                            jnp.broadcast_to(ccx[:, None, None], cars_shape),
                            jnp.broadcast_to(ccy[:, None, None], cars_shape),
                            jnp.broadcast_to(x[:, None, None, :], cars_shape[:-1]),
                            jnp.broadcast_to(y[:, None, None, :], cars_shape[:-1]), MAX_DIST)
    return np.asarray(jnp.minimum(wall, car)), np.asarray(car)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("a", [1, 2, 3])
@pytest.mark.parametrize("s", [1, 33])
def test_sensing_plain_is_the_composition_and_matches_jax(dt, a, s):
    nd, td = DTYPES[dt]
    args = _sensing_inputs(np.random.default_rng(10 * a + s), 8, a, 5, s, nd)
    t = [_t(v, td) for v in args]
    got = tgeo.raycast_walls_and_cars(*t, HALF_LENGTH, HALF_WIDTH, MAX_DIST)
    assert got.shape == (8, a, 5) and got.dtype == td
    assert torch.equal(got, _observe_composition(*t))
    assert torch.equal(got, tgeo.raycast_walls_and_cars_plain(*t, HALF_LENGTH, HALF_WIDTH,
                                                              MAX_DIST))

    want, car = _jax_sensing(*args)
    got = got.numpy()
    np.testing.assert_array_equal(got == MAX_DIST, want == MAX_DIST)
    np.testing.assert_allclose(got, want, rtol=1e-12 if dt == "f64" else 1e-5, atol=0)
    if a > 1:
        assert 0 < (car < MAX_DIST).mean() < 1  # rays do hit cars
    if a == 2:
        assert (car[0] == MAX_DIST).all()  # cars 0 and 1 of row 0 skip each other
    if s > 1:
        assert 0 < (want < MAX_DIST).mean() < 1


def test_sensing_counts_no_launch_on_the_cpu():
    before = tgeo.raycast_walls_and_cars_launches
    t = [_t(v, torch.float32) for v in _sensing_inputs(np.random.default_rng(0), 4, 2, 3,
                                                         9, np.float32)]
    tgeo.raycast_walls_and_cars(*t, HALF_LENGTH, HALF_WIDTH, MAX_DIST)
    assert tgeo.raycast_walls_and_cars_launches == before


# --------------------------------------------------------------- transition

def _pool(n):
    np.random.seed(6)
    pool = jtrack.make_track_pool(jtrack.gen_tracks(4, seed=6), [6.0, 7.0, 8.0, 9.0],
                                  dtype=jnp.float64)
    ids = np.arange(n) % 4
    return {f: np.asarray(getattr(pool, f))[ids] for f in
            ("wp_x", "wp_y", "nrm_x", "nrm_y", "n_wp", "track_width")}


def _step_inputs(rng, n, a, dtype):
    """n envs of a cars near random centreline waypoints, speeds above the clamp
    and 20% crashed; the rows as the envs pass them: cars [n] against [n, W] rows
    at one car, else cars [n, a] against [n, 1, W] rows with one count and width a
    row."""
    rows = _pool(n)
    i = rng.integers(0, rows["n_wp"][:, None], (n, a))
    x = rows["wp_x"][np.arange(n)[:, None], i] + rng.uniform(-6, 6, (n, a))
    y = rows["wp_y"][np.arange(n)[:, None], i] + rng.uniform(-6, 6, (n, a))
    cars = [x, y, rng.uniform(-7, 7, (n, a)), rng.normal(0, 25, (n, a)),
            rng.normal(0, 25, (n, a)), rng.random((n, a)) < 0.2,
            rng.uniform(-1, 1, (n, a)), rng.uniform(0, 1, (n, a))]
    cars = [v if v.dtype == bool else v.astype(dtype) for v in cars]
    wp = [rows[f].astype(dtype) for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")]
    per_row = [rows["n_wp"].astype(np.int32), rows["track_width"].astype(dtype)]
    if a == 1:
        return [v[:, 0] for v in cars], wp + per_row
    return cars, [f[:, None] for f in wp + per_row]


def _torch(vals, td):
    return [torch.as_tensor(v) if v.dtype.kind in "bi" else _t(v, td) for v in vals]


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("a", [1, 2])
def test_transition_plain_is_the_composition_and_matches_jax(dt, a):
    nd, td = DTYPES[dt]
    spec = tdyn.DEFAULT_CAR
    cars, wp = _step_inputs(np.random.default_rng(a), 64, a, nd)
    tc, tw = _torch(cars, td), _torch(wp, td)
    got = tdyn.car_step_and_query(*tc, 0.05, spec, *tw)
    state = tdyn.car_update(*tc, 0.05, spec)
    ccx, ccy = tgeo.car_corners(*state[:3], spec.length / 2, spec.width / 2)
    composed = (*state, ccx, ccy, *tgeo.progress_and_collision(*state[:2], ccx, ccy, *tw))
    plain = tdyn.car_step_and_query_plain(*tc, 0.05, spec, *tw)
    for g, c, p in zip(got, composed, plain):
        assert torch.equal(g, c) and torch.equal(g, p)
    got = [g.numpy() for g in got]
    crashed = cars[5]
    assert 0 < got[8][~crashed].mean() < 1  # both outcomes of the wall test
    speed = np.hypot(got[3], got[4])[~crashed]
    assert speed.max() <= 30.0 + 1e-4 and (speed > 29.9).sum() > 5  # the clamp

    jstate = jdyn.car_update(*(jnp.asarray(v) for v in cars))
    jcorners = jgeo.car_corners(*jstate[:3], spec.length / 2, spec.width / 2)
    np.testing.assert_array_equal(got[2], np.asarray(jstate[2]))  # the heading
    tol = dict(rtol=1e-12, atol=1e-12) if dt == "f64" else dict(rtol=1e-5, atol=1e-4)
    for g, w in zip(got[:7], (*jstate, *jcorners)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, **tol)
    for g, v in zip(got[:5], cars[:5]):
        np.testing.assert_array_equal(g[crashed], v[crashed])  # frozen
    # the track query: of JAX's own pose in float64, of the port's pose in float32
    pose = (jstate[:2] + jcorners) if dt == "f64" else tuple(map(jnp.asarray, got[:2] + got[5:7]))
    jprog, jhit = jgeo.progress_and_collision(*pose, *(jnp.asarray(v) for v in wp))
    np.testing.assert_array_equal(got[7], np.asarray(jprog))
    np.testing.assert_array_equal(got[8], np.asarray(jhit))


def test_transition_counts_no_launch_on_the_cpu():
    before = tdyn.car_step_and_query_launches
    cars, wp = _step_inputs(np.random.default_rng(0), 8, 2, np.float32)
    tdyn.car_step_and_query(*_torch(cars, torch.float32), 0.05, tdyn.DEFAULT_CAR,
                            *_torch(wp, torch.float32))
    assert tdyn.car_step_and_query_launches == before


# ------------------------------------------------- transition with car contacts

def _race_inputs(rng, n, a, dtype):
    """n races of a cars packed around one random centreline waypoint each, so that
    cars overlap (at 3 and 8 cars some touch two partners or more), 10% crashed;
    the JAX multi env's state and action for the same step, and its track."""
    np.random.seed(6)
    pool = jtrack.make_track_pool(jtrack.gen_tracks(4, seed=6), [6.0, 7.0, 8.0, 9.0],
                                  dtype=jnp.float64 if dtype == np.float64 else jnp.float32)
    track = jtrack.gather_tracks(pool, np.arange(n) % 4)
    wp_x, wp_y = np.asarray(track.wp_x), np.asarray(track.wp_y)
    i = rng.integers(0, np.asarray(track.n_wp))[:, None]
    spread = 1.5 + 0.25 * a
    x = wp_x[np.arange(n)[:, None], i] + rng.uniform(-spread, spread, (n, a))
    y = wp_y[np.arange(n)[:, None], i] + rng.uniform(-spread, spread, (n, a))
    ang = rng.uniform(0, 2 * np.pi, (n, a))
    vx, vy = rng.normal(0, 12, (2, n, a))
    crashed = rng.random((n, a)) < 0.1
    action = np.stack([rng.uniform(-1.2, 1.2, (n, a)), rng.uniform(-1.2, 1.2, (n, a))], -1)
    x, y, ang, vx, vy, action = (v.astype(dtype) for v in (x, y, ang, vx, vy, action))
    steering = np.clip(action[..., 0], -1.0, 1.0)
    throttle = np.clip((action[..., 1] + dtype(1.0)) / dtype(2.0), 0.0, 1.0)
    cars = [x, y, ang, vx, vy, crashed, steering, throttle]
    wp = [np.asarray(getattr(track, f))[:, None] for f in
          ("wp_x", "wp_y", "nrm_x", "nrm_y", "n_wp", "track_width")]
    zeros, false = np.zeros((n, a), dtype), np.zeros((n, a), bool)
    izeros = np.zeros((n, a), np.int32)
    state = jmulti.MultiState(
        x=x, y=y, angle=ang, vx=vx, vy=vy, progress=zeros, crashed=crashed,
        finished=false, steps=np.zeros(n, np.int32), last_progress=zeros,
        last_steering=zeros, cp25=false, cp50=false, cp75=false, has_crashed=crashed,
        finished_step=izeros, placement=izeros)
    return cars, wp, state, action, track


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("a", [2, 3, 8])
def test_transition_with_contacts_matches_jax_multi_transition(dt, a):
    """The transition with the pair test against JAX's multi-car transition on the
    same step (jitted, the track an argument): the stepped state and velocities
    after the contact ladder as in the transition tests above; num_hits exactly the
    touch penalty JAX's reward carries (the reward with and without it, over 5)."""
    nd, td = DTYPES[dt]
    spec = tdyn.DEFAULT_CAR
    cars, wp, jstate, action, jtr = _race_inputs(np.random.default_rng(a), 256, a, nd)
    tc, tw = _torch(cars, td), _torch(wp, td)
    got = tdyn.car_step_and_query(*tc, 0.05, spec, *tw, collision_speed_scale=0.92)
    plain = tdyn.car_step_and_query_plain(*tc, 0.05, spec, *tw, collision_speed_scale=0.92)
    without = tdyn.car_step_and_query(*tc, 0.05, spec, *tw)
    assert len(got) == 10 and got[9].dtype == torch.int32
    for g, p in zip(got, plain):
        assert torch.equal(g, p)
    for i in (0, 1, 2, 5, 6, 7, 8):  # the contacts move only the velocities
        assert torch.equal(got[i], without[i])
    hits = got[9].numpy()
    counts = np.bincount(hits.ravel(), minlength=3)
    assert counts[0] > 0 and counts[1] > 0 and (a == 2 or counts[2:].sum() > 0), counts

    step = jax.jit(jmulti.transition, static_argnums=0)
    cfg = jmulti.MultiRacingConfig(num_agents=a)
    jnew, jrew, *_ = step(cfg, jtr, jstate, jnp.asarray(action))
    no_touch = jmulti.MultiRacingConfig(num_agents=a, touch_penalty=0.0)
    _, jrew0, *_ = step(no_touch, jtr, jstate, jnp.asarray(action))
    jhits = np.rint((np.asarray(jrew0) - np.asarray(jrew)) / 5.0).astype(np.int32)
    np.testing.assert_array_equal(hits, jhits)
    got = [g.numpy() for g in got]
    tol = dict(rtol=1e-12, atol=1e-12) if dt == "f64" else dict(rtol=1e-5, atol=1e-4)
    for g, f in zip(got[:5], ("x", "y", "angle", "vx", "vy")):
        np.testing.assert_allclose(g, np.asarray(getattr(jnew, f)), **tol, err_msg=f)
    crashed = cars[5]
    np.testing.assert_array_equal(got[8][~crashed], np.asarray(jnew.crashed)[~crashed])
    # a crashed car's velocity is scaled too, as the env does
    touched = crashed & (hits > 0)
    assert touched.any()
    np.testing.assert_array_equal(got[3][touched] != cars[3][touched], True)


def test_transition_with_contacts_counts_no_launch_on_the_cpu():
    before = tdyn.car_step_and_query_launches
    cars, wp = _step_inputs(np.random.default_rng(0), 8, 2, np.float32)
    out = tdyn.car_step_and_query(*_torch(cars, torch.float32), 0.05, tdyn.DEFAULT_CAR,
                                  *_torch(wp, torch.float32), collision_speed_scale=0.92)
    assert len(out) == 10 and tdyn.car_step_and_query_launches == before

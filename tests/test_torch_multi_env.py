"""The port's multi-car env and its kernels' plain versions against the JAX package,
on the CPU.

- K3 ``raycast_cars``, K4 ``rectangles_intersect`` and K5 ``car_update`` (the
  plain versions the CPU runs) against the JAX functions, in float32 and float64.
  K3 is exact against eager JAX (the source's rounding, which the CUDA kernel
  keeps) and within 4 ulp of jitted JAX: XLA's CPU backend contracts ``a*b - c*d``
  into an FMA under ``jit``. It covers the skip radius, rays parallel to an edge
  and rays that miss. K4 is exact against jitted JAX, touching and separated
  rectangles included. K5 against eager JAX (the source's rounding): crashed cars
  and the wrapped heading exact; the rest within rtol 1e-15 / atol 1e-13 in
  float64 and rtol 1e-5 / atol 1e-4 in float32, because cos and sin round
  differently in XLA's and PyTorch's CPU math (about 0.2% of float64 values and 5%
  of float32 values), and v_lat's cancellation carries that to the velocities.
- ``multi.step`` in float64 lockstep with jitted JAX (the track passed as an
  argument) for 500 steps at A = 1, 2 and 3, with fed start-grid slots and one
  action stream (each JAX policy's greedy action plus NumPy noise of growing scale
  across envs), covering car-car contacts, crashes, finishes, placement ties and
  truncation. Done flags, placements and integer state exact; rewards, info and
  state within rtol 1e-9 (cos/sin drift of a few ulps); observations (float32)
  within 1e-6 absolute (a ray's hit distance carries the drift through a division).
- ``rollout_multi`` with deterministic actions against JAX's, on the JAX rollout's
  own start-grid slots: steps, finished, crashed and placement exact, the rest
  within rtol 1e-9 (``distance_per_step`` within 1e-6: the JAX package divides a
  float32 total by int32 steps in NumPy's float64, the port in float32).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.evaluate import load_policy_bundle
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.ops import dynamics as jdyn
from self_play_racing_tpu.ops import geometry as jgeo
from self_play_racing_tpu.utils import metrics as jM
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.ops import dynamics as tdyn
from self_play_racing_tpu_torch.ops import geometry as tgeo
from self_play_racing_tpu_torch.utils import metrics as tM

RTOL = 1e-9
POLICIES = {1: "models/single_agent.npz", 2: "models/self_play_agent.npz",
            3: "models/self_play_agent_3car_500M.npz"}
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


# ------------------------------------------------------------------ kernels

def _car_rects(rng, n, a):
    """n rows of a cars: centres, headings, corners (JAX's car_corners, f64)."""
    x = rng.uniform(-10, 10, (n, a))
    y = rng.uniform(-10, 10, (n, a))
    ang = rng.uniform(0, 2 * np.pi, (n, a))
    cx, cy = jgeo.car_corners(jnp.asarray(x), jnp.asarray(y), jnp.asarray(ang), 2.0, 1.0)
    return x, y, np.array(cx), np.array(cy)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_raycast_cars_matches_jax(dt):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(1)
    n, a, r = 64, 3, 9
    x, y, cx, cy = _car_rects(rng, n, a)
    # ray origins: seat 0's centre for the first rays (the skip radius), else free
    ox = np.where(np.arange(r) < 3, x[:, :1], rng.uniform(-12, 12, (n, r)))
    oy = np.where(np.arange(r) < 3, y[:, :1], rng.uniform(-12, 12, (n, r)))
    ang = rng.uniform(0, 2 * np.pi, (n, r))
    dx, dy = np.cos(ang), np.sin(ang)
    # a ray parallel to an edge of car 1, and one that points away from every car
    e = cx[:, 1, 1] - cx[:, 1, 0], cy[:, 1, 1] - cy[:, 1, 0]
    norm = np.hypot(*e)
    dx[:, 3], dy[:, 3] = e[0] / norm, e[1] / norm
    ox[:, 4], oy[:, 4], dx[:, 4], dy[:, 4] = 30.0, 30.0, 1.0, 0.0
    args = [ox, oy, dx, dy, cx[:, None], cy[:, None], x[:, None], y[:, None]]

    jargs = [jnp.asarray(v, jd) for v in args]
    want = np.asarray(jgeo.raycast_cars(*jargs, 50.0))
    got = tgeo.raycast_cars(*(_t(v, td) for v in args), 50.0)
    np.testing.assert_array_equal(got.numpy(), want)
    jitted = np.asarray(jax.jit(lambda *v: jgeo.raycast_cars(*v, 50.0))(*jargs))
    assert (np.abs(got.numpy() - jitted) <= 4 * np.spacing(jitted)).all()
    assert (want[:, 4] == 50.0).all()  # no hit gives max_dist
    assert ((want < 50.0).mean()) > 0.1  # and some rays do hit
    # the skip radius: from inside car 0, car 0 is not seen
    inside = tgeo.raycast_cars(*(_t(v, td) for v in args[:4]), _t(cx[:, None, :1], td),
                               _t(cy[:, None, :1], td), _t(x[:, None, :1], td),
                               _t(y[:, None, :1], td), 50.0)
    assert (inside[:, :3] == 50.0).all()


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_rectangles_intersect_matches_jax(dt):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(2)
    n, a = 256, 3
    x, y, cx, cy = _car_rects(rng, n, a)
    # row 0: cars 0 and 1 share the edge x = 4 exactly (corners FL, FR, RR, RL),
    # car 2 far away; row 1: all three far apart
    cx[0] = [[4, 4, 0, 0], [8, 8, 4, 4], [104, 104, 100, 100]]
    cy[0] = [[2, 0, 0, 2], [2, 0, 0, 2], [2, 0, 0, 2]]
    cx[1] += np.arange(a)[:, None] * 100.0
    got = tgeo.rectangles_intersect_pairs(_t(cx, td), _t(cy, td))
    shape = (n, a, a, 4)
    want = jax.jit(jgeo.rectangles_intersect)(
        *(jnp.broadcast_to(jnp.asarray(v, jd), shape) for v in
          (cx[:, :, None], cy[:, :, None], cx[:, None], cy[:, None])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = got.numpy()
    assert g[:, range(a), range(a)].all()          # a car touches itself
    assert g[0, 0, 1] and g[0, 1, 0]               # shared edge: no strict gap
    assert not g[1][~np.eye(a, dtype=bool)].any()  # separated
    assert 0 < g[2:][:, ~np.eye(a, dtype=bool)].mean() < 0.5


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_car_update_matches_jax(dt):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(3)
    n = 4096
    args = [rng.uniform(-50, 50, n), rng.uniform(-50, 50, n),
            rng.uniform(-7, 7, n),                     # angles beyond [0, 2 pi)
            rng.normal(0, 25, n), rng.normal(0, 25, n),  # some above max speed
            rng.random(n) < 0.2,
            rng.uniform(-1, 1, n), rng.uniform(0, 1, n)]
    want = jdyn.car_update(*(jnp.asarray(v, bool if i == 5 else jd)
                             for i, v in enumerate(args)))
    got = tdyn.car_update(*(torch.as_tensor(v) if i == 5 else _t(v, td)
                            for i, v in enumerate(args)))
    crashed = args[5]
    tol = dict(rtol=1e-15, atol=1e-13) if dt == "f64" else dict(rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))  # the heading
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_array_equal(g[crashed], w[crashed])  # frozen
        np.testing.assert_allclose(g, w, **tol)
    speed = np.hypot(got[3].numpy(), got[4].numpy())[~crashed]
    assert speed.max() <= 30.0 + 1e-4 and (speed > 29.9).sum() > 100  # the clamp


# ---------------------------------------------------------- env in lockstep

def _tracks(n, n_tracks=4, seed=5):
    widths = [6.0 + (i % 4) for i in range(n_tracks)]
    ids = np.arange(n) % n_tracks
    np.random.seed(seed)
    jp = jtrack.make_track_pool(jtrack.gen_tracks(n_tracks, seed=seed), widths,
                                dtype=jnp.float64)
    np.random.seed(seed)
    tp = ttrack.make_track_pool(ttrack.gen_tracks(n_tracks, seed=seed), widths,
                                dtype=torch.float64, device="cpu")
    return jtrack.gather_tracks(jp, ids), ttrack.gather_tracks(tp, ids)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_close(j, t, what):
    """Every field of two dicts of arrays: integers and bools exact, floats within
    RTOL (one comparison per kind)."""
    a = {k: np.asarray(j[k]) for k in j}
    b = {k: _np(t[k]) for k in j}
    exact = [k for k in a if a[k].dtype.kind in "bi"]
    close = [k for k in a if k not in exact]
    for k in exact:
        assert b[k].dtype.kind == a[k].dtype.kind, f"{what}.{k}"
    np.testing.assert_array_equal(np.concatenate([b[k].ravel().astype(np.int64) for k in exact]),
                                  np.concatenate([a[k].ravel().astype(np.int64) for k in exact]),
                                  err_msg=f"{what}: {exact}")
    np.testing.assert_allclose(np.concatenate([b[k].ravel() for k in close]),
                               np.concatenate([a[k].ravel() for k in close]),
                               rtol=RTOL, atol=RTOL, err_msg=f"{what}: {close}")


def _assert_obs(t, j, num_rays):
    """Observations (float32) within 1e-6 absolute, except rays that flip between
    a hit and a miss: a ray through a boundary vertex (the start grid's sideways
    rays run exactly through one) hits or misses on the last bit of its direction,
    where cos/sin round differently in XLA's and PyTorch's CPU math. Returns the
    number of such rays; the other features must agree."""
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_allclose(t[..., num_rays:], j[..., num_rays:], rtol=0, atol=1e-6)
    off = np.abs(t[..., :num_rays] - j[..., :num_rays]) > 1e-6
    assert ((t[..., :num_rays] == 1.0) | (j[..., :num_rays] == 1.0))[off].all() or \
        not off.any(), "a ray differs other than by a hit/miss flip"
    return int(off.sum())


def _state_dict(s):
    return {f: getattr(s, f) for f in s.__dataclass_fields__}


@pytest.mark.parametrize("agents,max_steps,steps", [(1, 3000, 450), (2, 3000, 450),
                                                     (3, 3000, 450), (2, 300, 310)])
def test_multi_step_lockstep_f64(agents, max_steps, steps):
    n = 16
    jtr, ttr = _tracks(n)
    jcfg = jmulti.MultiRacingConfig(num_agents=agents, max_steps=max_steps)
    tcfg = tmulti.MultiRacingConfig(num_agents=agents, max_steps=max_steps)
    params, _, _ = load_policy_bundle(POLICIES[agents])
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), params)
    rng = np.random.default_rng(agents)
    position_idx = np.argsort(rng.random((n, agents)), axis=-1)
    jstate, jobs = jax.jit(lambda tr: jmulti.reset(jcfg, tr, position_idx=position_idx))(jtr)
    tstate, tobs = tmulti.reset(tcfg, ttr, position_idx=torch.as_tensor(position_idx))
    jstep = jax.jit(lambda tr, s, act: jmulti.step(jcfg, tr, s, act))

    @jax.jit
    def jrestart(tr, s, done, idx):
        fresh = jmulti.reset_state(jcfg, tr, position_idx=idx)
        s = jax.tree.map(lambda f, o: jnp.where(done.reshape((n,) + (1,) * (f.ndim - 1)), f, o),
                         fresh, s)
        return s, jmulti.observe(jcfg, tr, s)

    act_fn = jax.jit(lambda p, o: jnet.deterministic_action(p, o))
    scale = np.linspace(0.0, 1.2, n)[:, None, None]  # low-noise envs drive laps
    seen = {"touch": 0, "crash": 0, "finish": 0, "done": 0, "placed": 0}
    flips, rays_seen = 0, 0
    for t in range(steps):
        flips += _assert_obs(tobs, jobs, tcfg.num_sensors)
        rays_seen += n * agents * tcfg.num_sensors
        act = np.asarray(act_fn(params, jobs.reshape(n * agents, -1))).reshape(n, agents, 2)
        act = np.clip(act + scale * rng.normal(0, 1, act.shape), -1.5, 1.5)
        jstate, jobs, jrew, jterm, jtrunc, jinfo = jstep(jtr, jstate, jnp.asarray(act))
        tstate, tobs, trew, tterm, ttrunc, tinfo = tmulti.step(tcfg, ttr, tstate,
                                                               torch.as_tensor(act))
        _assert_close({**jinfo, **_state_dict(jstate), "terminated": jterm,
                       "truncated": jtrunc, "reward": jrew},
                      {**tinfo, **_state_dict(tstate), "terminated": tterm,
                       "truncated": ttrunc, "reward": trew}, f"step {t}")
        done = np.asarray(jterm | jtrunc)
        seen["crash"] += int(np.asarray(jinfo["crashed"]).sum())
        seen["finish"] += int(np.asarray(jinfo["finished"]).sum())
        seen["done"] += int(done.sum())
        seen["placed"] += int((np.asarray(jinfo["placement"])[done] > 0).sum())
        # restart finished episodes from a fresh grid, as the autoreset would
        if done.any():
            fresh_idx = np.argsort(rng.random((n, agents)), axis=-1)
            jstate, jobs = jrestart(jtr, jstate, jnp.asarray(done), fresh_idx)
            tfresh = tmulti.reset_state(tcfg, ttr, position_idx=torch.as_tensor(fresh_idx))
            tstate = tmulti.MultiState(**{
                k: torch.where(torch.as_tensor(done).reshape((n,) + (1,) * (v.ndim - 1)),
                               getattr(tfresh, k), v)
                for k, v in _state_dict(tstate).items()})
            tobs = tmulti.observe(tcfg, ttr, tstate)
        if agents > 1:
            seen["touch"] += int(_touches(tstate, tcfg).sum())
    assert flips <= 1e-3 * rays_seen
    assert seen["crash"] > 0 and seen["done"] > 0
    assert seen["placed"] == seen["done"] * agents  # every car placed at episode end
    if max_steps == 3000:
        assert seen["finish"] > 0
    else:
        assert seen["done"] >= n  # every env reached the 300-step truncation
    if agents > 1:
        assert seen["touch"] > 0


def _touches(state, cfg):
    cx, cy = tgeo.car_corners(state.x, state.y, state.angle, cfg.car.length / 2,
                              cfg.car.width / 2)
    hits = tgeo.rectangles_intersect_pairs(cx, cy)
    return hits & ~torch.eye(cfg.num_agents, dtype=torch.bool)


def test_placement_ties_and_truncation():
    """At truncation on the first step, cars on one line with equal scores tie:
    the higher seat wins, and the winner bonus goes to it alone."""
    n, a = 4, 3
    jtr, ttr = _tracks(n)
    jcfg = jmulti.MultiRacingConfig(num_agents=a, max_steps=1)
    tcfg = tmulti.MultiRacingConfig(num_agents=a, max_steps=1)
    pos = np.tile(np.arange(a), (n, 1))
    act = np.zeros((n, a, 2))
    act[..., 1] = -1.0  # no throttle: progress stays 0 for every car
    js = jmulti.reset_state(jcfg, jtr, position_idx=pos)
    ts = tmulti.reset_state(tcfg, ttr, position_idx=torch.as_tensor(pos))
    _, jrew, _, jtrunc, jinfo = jax.jit(
        lambda tr, s, ac: jmulti.transition(jcfg, tr, s, ac))(jtr, js, jnp.asarray(act))
    _, trew, _, ttrunc, tinfo = tmulti.transition(tcfg, ttr, ts, torch.as_tensor(act))
    assert ttrunc.all() and np.asarray(jtrunc).all()
    np.testing.assert_array_equal(tinfo["placement"].numpy(), np.asarray(jinfo["placement"]))
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=RTOL)
    np.testing.assert_array_equal(tinfo["placement"].numpy(), np.tile([3, 2, 1], (n, 1)))
    assert (trew.numpy()[:, 2] - trew.numpy()[:, 0] == 250.0).all()


def test_reset_draws_a_grid_permutation():
    _, ttr = _tracks(64)
    cfg = tmulti.MultiRacingConfig(num_agents=3)
    gen = torch.Generator().manual_seed(0)
    s = tmulti.reset_state(cfg, ttr, gen)
    offsets = ((s.x - ttr.start_x[:, None]) * ttr.start_nx[:, None]
               + (s.y - ttr.start_y[:, None]) * ttr.start_ny[:, None])
    slots = torch.round(offsets / 3.5 + 1).long()
    assert torch.equal(torch.sort(slots, dim=1).values, torch.arange(3).expand(64, 3))
    assert len({tuple(r) for r in slots.tolist()}) > 3
    with pytest.raises(ValueError, match="generator"):
        tmulti.reset_state(cfg, ttr)


# ------------------------------------------------------------ rollout_multi

def test_rollout_multi_deterministic_matches_jax(monkeypatch):
    jparams, jls, _ = load_policy_bundle(POLICIES[2])
    jparams = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), jparams)
    jls = jnp.asarray(jls, jnp.float64)
    jgrid, _, _ = jM.build_eval_grid(3, 2, dtype=jnp.float64)
    tgrid, _, _ = tM.build_eval_grid(3, 2, dtype=torch.float64, device="cpu")
    cfg_j = jmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    cfg_t = tmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    key = jax.random.key(4)
    j = jM.rollout_multi(jparams, jls, cfg_j, jgrid, key, max_steps=700, deterministic=True)
    # the JAX rollout's start-grid slots, drawn from its reset key
    k_reset, _ = jax.random.split(key)
    order = jax.vmap(lambda k: jax.random.permutation(k, 2))(jax.random.split(k_reset, 6))
    pos = torch.as_tensor(np.asarray(jnp.argsort(order, axis=-1)))
    monkeypatch.setattr(tmulti, "random_grid_slots", lambda n, a, gen, device=None: pos)
    model = interop.params_from_jax(jax.tree.map(np.asarray, jparams), np.asarray(jls),
                                    dtype=torch.float64, device="cpu")
    t = tM.rollout_multi(model.params(), model.log_std, cfg_t, tgrid, torch.Generator(),
                         max_steps=700, deterministic=True)
    assert sorted(t) == sorted(j)
    for k in ("steps", "finished", "crashed", "placement"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    for k in ("total_reward", "total_distance", "progress", "speed"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(t["distance_per_step"].numpy(), j["distance_per_step"],
                               rtol=1e-6)
    assert int(t["finished"].sum()) > 0
    agg_t = tM.aggregate(t)
    agg_j = jM.aggregate({k: np.asarray(v) for k, v in j.items()})
    for k in agg_j:
        assert agg_t[k] == pytest.approx(agg_j[k], rel=1e-9), k

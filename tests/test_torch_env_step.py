"""The multi-car env step's plain versions (``multi.transition_plain`` and
``multi.observe_plain``, which ``multi.transition`` and ``multi.observe`` run on CPU
tensors) against the JAX package's jitted ``envs/multi.py`` ``transition`` and
``observe``, on the CPU, on states that drive every branch of the transition's
tail (``chip_smoke.crafted_state``: finishes with their time bonus, one past step
4500 where it clamps at 0, both lap wraps, each checkpoint crossing and a skipped
one, a crash and a car crashed before, touching pairs, truncation, exact score
ties), over the canonical 16-track pool, per-env rows and tiled by row id. On the
card each function is one kernel launch, held bitwise to these plain versions by
``tests/test_torch_cuda_kernels.py`` and chip_smoke.py phase m.

Both packages are handed the same state and actions (NumPy from a seed) and the
track as a jit argument (XLA rewrites ``x / const`` to ``x * (1/const)`` under
``jit``; the port follows that rounding, ``_numerics.py``). Tolerances:
 - integers and bools exact: every flag, ``steps``, ``finished_step``,
   ``placement``, ``terminated``, ``truncated``;
 - in float64 every float output within rtol 1e-9 / atol 1e-9, and the
   observations (float32 in both) within 1e-6 absolute: cos and sin round
   differently in XLA's and PyTorch's CPU math in the last bit, which the step
   and the rays carry on;
 - in float32 the state, reward and info within rtol 1e-5 / atol 1e-3 (K5's
   tolerance in tests/test_torch_multi_env.py, rtol 1e-5 / atol 1e-4, carried into
   the speed reward by ``speed_scale``, 18, and into the progress reward by the
   waypoint the stepped car sits at, which is exact), and the observations within
   1e-4 absolute.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import track as jtrk
from self_play_racing_tpu.utils import profiling as jprof
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import dynamics as tdyn
from self_play_racing_tpu_torch.utils import profiling as tprof

ENVS = 128  # 16 of each of chip_smoke's row kinds (env index % 8)
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
TOL = {"f64": dict(rtol=1e-9, atol=1e-9), "f32": dict(rtol=1e-5, atol=1e-3)}
OBS_ATOL = {"f64": 1e-6, "f32": 1e-4}


def _pools(dt):
    jd, td = DTYPES[dt]
    return jprof.canonical_bench_pool(16, dtype=jd), tprof.canonical_bench_pool(16, dtype=td, device="cpu")


def _layout(pool, where):
    if where == "tiled":
        return ttrack.tiled_pooled_tracks(pool, ENVS)
    return ttrack.gather_tracks(pool, np.arange(ENVS) % 16)


def _jax_gathered(jpool):
    return jtrk.gather_tracks(jpool, np.arange(ENVS) % 16)


def _jax_state(state, jd):
    """The port's state as the JAX package's ``MultiState`` (float fields in ``jd``)."""
    fields = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name).numpy()
        fields[f.name] = jnp.asarray(v, jd if v.dtype.kind == "f" else v.dtype)
    return jmulti.MultiState(**fields)


def _outputs(state, reward, terminated, truncated, info):
    out = {f"state.{f.name}": getattr(state, f.name) for f in dataclasses.fields(state)}
    out.update(reward=reward, terminated=terminated, truncated=truncated,
               **{f"info.{k}": v for k, v in info.items()})
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in out.items()}


def _assert_outputs(got, want, dt):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=k)
        else:
            np.testing.assert_allclose(g, w, **TOL[dt], err_msg=k)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("agents", [1, 2, 3])
def test_transition_and_observe_match_jitted_jax(dt, agents):
    jd, td = DTYPES[dt]
    jpool, tpool = _pools(dt)
    jtrack = _jax_gathered(jpool)
    cfg_kw = dict(num_agents=agents, num_sensors=11, max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    jcfg, tcfg = jmulti.MultiRacingConfig(**cfg_kw), tmulti.MultiRacingConfig(**cfg_kw)
    jtransition = jax.jit(lambda tr, s, a: jmulti.transition(jcfg, tr, s, a))
    jobserve = jax.jit(lambda tr, s: jmulti.observe(jcfg, tr, s))
    for where in ("gathered", "tiled"):
        track = _layout(tpool, where)
        state, action = chip_smoke.crafted_state(track, agents, tcfg.max_steps, seed=agents,
                                                 dtype=td)
        out = tmulti.transition(tcfg, track, state, action)
        want = jtransition(jtrack, _jax_state(state, jd), jnp.asarray(action.numpy(), jd))
        _assert_outputs(_outputs(*out), _outputs(*want), dt)

        obs = tmulti.observe(tcfg, track, state)
        jobs = np.asarray(jobserve(jtrack, _jax_state(state, jd)))
        assert obs.dtype == torch.float32 and obs.shape == (ENVS, agents, tcfg.obs_dim)
        np.testing.assert_allclose(obs.numpy(), jobs, rtol=0, atol=OBS_ATOL[dt])

        branches = chip_smoke.tail_branches(state, out)
        taken = {k: v for k, v in branches.items() if v == 0}
        if agents == 1:
            taken.pop("exact ties")
        assert not taken, f"{where}: no car took {taken}"
        if agents > 1:
            # the touching rows touch, and the tied rows place the higher seat first
            hits = tdyn.car_step_and_query_plain(
                state.x, state.y, state.angle, state.vx, state.vy, state.crashed,
                torch.clamp(action[..., 0], -1, 1), torch.clamp((action[..., 1] + 1) / 2, 0, 1),
                tcfg.dt, tcfg.car, *(getattr(ttrack.resolve(track), f)[:, None]
                                     for f in ("wp_x", "wp_y", "nrm_x", "nrm_y")),
                ttrack.scalars_of(track).n_wp[:, None],
                ttrack.scalars_of(track).track_width[:, None],
                collision_speed_scale=tcfg.collision_speed_scale)[-1]
            touching = np.arange(ENVS) % 8 == chip_smoke.ROW_TOUCHING
            assert (hits[touching] > 0).all()
            tied = np.arange(ENVS) % 8 == chip_smoke.ROW_TIES
            np.testing.assert_array_equal(out[0].placement[tied].numpy(),
                                          np.tile(np.arange(agents, 0, -1), (tied.sum(), 1)))


@pytest.mark.parametrize("agents", [2, 3])
def test_clamped_sensing_matches_jitted_jax(agents):
    """``clamp_sensor_range``: each ray clamped to the range before the scaling. In
    the multi-car env the car pass, clamped to the range, already bounds every ray
    through the minimum, so the clamped and unclamped observations agree; car 0 of
    every env sits 70 m off the track facing it, so that many of its walls lie
    beyond the range."""
    jpool, tpool = _pools("f64")
    cfg_kw = dict(num_agents=agents, num_sensors=11, clamp_sensor_range=True)
    jcfg, tcfg = jmulti.MultiRacingConfig(**cfg_kw), tmulti.MultiRacingConfig(**cfg_kw)
    track = _layout(tpool, "tiled")
    state, _ = chip_smoke.crafted_state(track, agents, tcfg.max_steps, seed=5,
                                        dtype=torch.float64)
    rows = ttrack.resolve(track)
    nx, ny = rows.nrm_x[:, 0], rows.nrm_y[:, 0]
    state.x[:, 0] = rows.wp_x[:, 0] + 70.0 * nx
    state.y[:, 0] = rows.wp_y[:, 0] + 70.0 * ny
    state.angle[:, 0] = torch.remainder(torch.atan2(-ny, -nx), 2 * np.pi)
    obs = tmulti.observe(tcfg, track, state)
    jobs = np.asarray(jax.jit(lambda tr, s: jmulti.observe(jcfg, tr, s))(
        _jax_gathered(jpool), _jax_state(state, jnp.float64)))
    np.testing.assert_allclose(obs.numpy(), jobs, rtol=0, atol=OBS_ATOL["f64"])
    assert (obs[:, 0, :11] == 1.0).any() and obs[..., :11].max() <= 1.0
    unclamped = tmulti.observe(dataclasses.replace(tcfg, clamp_sensor_range=False), track,
                               state)
    assert torch.equal(unclamped, obs)


@pytest.mark.parametrize("agents", [1, 2, 3])
def test_env_step_on_the_cpu_never_reaches_the_kernels(monkeypatch, agents):
    """On CPU tensors ``multi.transition`` and ``multi.observe`` run their plain
    versions: nothing of ``ops/_cuda`` is called and no counter moves."""
    def refuse(*args, **kwargs):
        raise AssertionError("ops/_cuda reached from CPU tensors")

    for name in ("build", "_call", "launch_multi_transition", "launch_multi_observe",
                 "launch_raycast_walls_and_cars", "launch_car_step_and_query"):
        monkeypatch.setattr(_cuda, name, refuse)
    counters = ("transition_launches", "observe_launches", "transition_row_id_launches",
                "observe_row_id_launches")
    before = [getattr(tmulti, c) for c in counters]
    pool = tprof.canonical_bench_pool(16, device="cpu")
    cfg = tmulti.MultiRacingConfig(num_agents=agents)
    for where in ("gathered", "tiled"):
        track = _layout(pool, where)
        state, action = chip_smoke.crafted_state(track, agents, cfg.max_steps, seed=3)
        new, *_ = tmulti.transition(cfg, track, state, action)
        obs = tmulti.observe(cfg, track, new)
        assert obs.shape == (ENVS, agents, cfg.obs_dim)
    assert [getattr(tmulti, c) for c in counters] == before


@pytest.mark.parametrize("pairs", [False, True])
def test_transition_tail_plan_sizes_its_shared_memory(pairs):
    """The transition's launch with the env's tail: 9 words a car after the staged
    row (and after the pair test's 10 floats a car), refused where a block's 227 KB
    cannot hold them."""
    base = _cuda.car_step_query_plan(8, 512)
    plan = _cuda.car_step_query_plan(8, 512, pairs, tail=True)
    words = (_cuda.PAIR_FLOATS_PER_CAR if pairs else 0) + _cuda.TAIL_WORDS_PER_CAR
    assert plan.threads == base.threads and plan.smem == base.smem + words * 8 * 4
    with pytest.raises(ValueError, match="tail of 400 cars"):
        _cuda.car_step_query_plan(400, 28_000, pairs, tail=True)

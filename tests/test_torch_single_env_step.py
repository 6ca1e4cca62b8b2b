"""The single-car env step's plain versions (``single.transition_plain`` and
``single.observe_plain``, which ``single.transition`` and ``single.observe`` run on
CPU tensors) against the JAX package's jitted ``envs/single.py`` ``transition`` and
``observe``, on the CPU, on states that drive every branch of the transition's tail
(``chip_smoke.crafted_single_state``: each checkpoint crossing and a skipped one,
both lap wraps, finishes with their time bonus and one past step 2000 where it
clamps at 0, a crash, a car crashed before, truncation at ``max_steps``), over the
canonical 16-track pool, per-env rows and tiled by row id, the speed weight the
config's and an annealed scalar tensor, the sensing clamped to the range and not.
On the card each function is one kernel launch, held bitwise to these plain
versions by ``tests/test_torch_cuda_kernels.py`` and chip_smoke.py phase o.

Both packages are handed the same state and actions (NumPy from a seed) and the
track as a jit argument (XLA rewrites ``x / const`` to ``x * (1/const)`` under
``jit``; the port follows that rounding, ``_numerics.py``). Tolerances, as in
``tests/test_torch_env_step.py``:
 - integers and bools exact: every flag, ``steps``, ``terminated``, ``truncated``;
 - in float64 every float output within rtol 1e-9 / atol 1e-9, and the
   observations (float32 in both) within 1e-6 absolute: cos and sin round
   differently in XLA's and PyTorch's CPU math in the last bit, which the step
   and the rays carry on;
 - in float32 the state, reward and info within rtol 1e-5 / atol 1e-3 (K5's
   tolerance carried into the speed reward by the speed weight and into the
   progress reward by the waypoint the stepped car sits at, which is exact), and
   the observations within 1e-4 absolute.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from self_play_racing_tpu.envs import single as jsingle
from self_play_racing_tpu.envs import track as jtrk
from self_play_racing_tpu.utils import profiling as jprof
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.utils import profiling as tprof

ENVS = 128  # 16 of each of chip_smoke's row kinds (env index % 8)
DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
TOL = {"f64": dict(rtol=1e-9, atol=1e-9), "f32": dict(rtol=1e-5, atol=1e-3)}
OBS_ATOL = {"f64": 1e-6, "f32": 1e-4}
ANNEALED = 5.3  # a speed weight between the anneal's ends


def _pools(dt):
    jd, td = DTYPES[dt]
    return (jprof.canonical_bench_pool(16, dtype=jd),
            tprof.canonical_bench_pool(16, dtype=td, device="cpu"))


def _layout(pool, where):
    if where == "tiled":
        return ttrack.tiled_pooled_tracks(pool, ENVS)
    return ttrack.gather_tracks(pool, np.arange(ENVS) % 16)


def _jax_state(state, jd):
    """The port's state as the JAX package's ``RacingState`` (floats in ``jd``)."""
    def leaf(t):
        v = t.numpy()
        return jnp.asarray(v, jd if v.dtype.kind == "f" else v.dtype)

    car = jsingle.CarState(**{f.name: leaf(getattr(state.car, f.name))
                              for f in dataclasses.fields(state.car)})
    return jsingle.RacingState(car=car, **{f.name: leaf(getattr(state, f.name))
                                           for f in dataclasses.fields(state) if f.name != "car"})


def _outputs(state, reward, terminated, truncated, info):
    out = {f"car.{f.name}": getattr(state.car, f.name) for f in dataclasses.fields(state.car)}
    out.update({f"state.{f.name}": getattr(state, f.name) for f in dataclasses.fields(state)
                if f.name != "car"})
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
@pytest.mark.parametrize("annealed", [False, True])
def test_transition_matches_jitted_jax(dt, annealed):
    """Every output of ``single.transition`` (the plain version on the CPU) against
    jitted JAX, every branch of the tail taken (asserted), per-env and tiled."""
    jd, td = DTYPES[dt]
    jpool, tpool = _pools(dt)
    jtrack = jtrk.gather_tracks(jpool, np.arange(ENVS) % 16)
    cfg_kw = dict(num_sensors=11, max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    jcfg, tcfg = jsingle.RacingConfig(**cfg_kw), tsingle.RacingConfig(**cfg_kw)
    jtransition = jax.jit(lambda tr, s, a, sw: jsingle.transition(jcfg, tr, s, a, sw))
    sw = torch.tensor(ANNEALED, dtype=td) if annealed else None
    jsw = jnp.asarray(ANNEALED if annealed else tcfg.speed_weight, jd)
    for where in ("gathered", "tiled"):
        track = _layout(tpool, where)
        state, action = chip_smoke.crafted_single_state(track, tcfg.max_steps, seed=7,
                                                        dtype=td)
        out = tsingle.transition(tcfg, track, state, action, speed_weight=sw)
        want = jtransition(jtrack, _jax_state(state, jd), jnp.asarray(action.numpy(), jd), jsw)
        _assert_outputs(_outputs(*out), _outputs(*want), dt)
        assert out[0].last_progress is out[0].car.progress
        branches = chip_smoke.single_tail_branches(state, out)
        missing = [k for k, v in branches.items() if v == 0]
        assert not missing, f"{where}: no env took {missing}"


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("clamp", [False, True])
def test_observe_matches_jitted_jax(dt, clamp):
    """``single.observe`` (the plain version on the CPU) against jitted JAX on the
    crafted states with every eighth car 70 m off its track facing it
    (``chip_smoke.single_off_track``), per-env and tiled: clamped,
    no ray exceeds the range; unclamped, the reference's hits beyond it stay."""
    jd, td = DTYPES[dt]
    jpool, tpool = _pools(dt)
    jtrack = jtrk.gather_tracks(jpool, np.arange(ENVS) % 16)
    jcfg = jsingle.RacingConfig(num_sensors=11, clamp_sensor_range=clamp)
    tcfg = tsingle.RacingConfig(num_sensors=11, clamp_sensor_range=clamp)
    jobserve = jax.jit(lambda tr, s: jsingle.observe(jcfg, tr, s))
    for where in ("gathered", "tiled"):
        track = _layout(tpool, where)
        state, _ = chip_smoke.crafted_single_state(track, tcfg.max_steps, seed=11, dtype=td)
        state = chip_smoke.single_off_track(track, state)
        obs = tsingle.observe(tcfg, track, state)
        assert obs.dtype == torch.float32 and obs.shape == (ENVS, tcfg.obs_dim)
        np.testing.assert_allclose(obs.numpy(), np.asarray(jobserve(jtrack, _jax_state(state, jd))),
                                   rtol=0, atol=OBS_ATOL[dt])
        rays = obs[:, :11]
        if clamp:
            assert rays.max() <= 1.0 and (rays == 1.0).any()
        else:
            assert rays.max() > 1.0


def test_env_step_on_the_cpu_never_reaches_the_kernels(monkeypatch):
    """On CPU tensors ``single.transition`` and ``single.observe`` run their plain
    versions: nothing of ``ops/_cuda`` is called and no counter moves."""
    def refuse(*args, **kwargs):
        raise AssertionError("ops/_cuda reached from CPU tensors")

    for name in ("build", "_call", "launch_single_transition", "launch_multi_observe",
                 "launch_raycast_walls", "launch_car_step_and_query"):
        monkeypatch.setattr(_cuda, name, refuse)
    counters = ("transition_launches", "observe_launches", "transition_row_id_launches",
                "observe_row_id_launches", "transition_rows_launches")
    before = [getattr(tsingle, c) for c in counters]
    pool = tprof.canonical_bench_pool(16, device="cpu")
    cfg = tsingle.RacingConfig(num_sensors=11)
    for where in ("gathered", "tiled"):
        track = _layout(pool, where)
        state, action = chip_smoke.crafted_single_state(track, cfg.max_steps, seed=3)
        new, *_ = tsingle.transition(cfg, track, state, action,
                                     speed_weight=torch.tensor(ANNEALED))
        obs = tsingle.observe(cfg, track, new)
        assert obs.shape == (ENVS, cfg.obs_dim)
    assert [getattr(tsingle, c) for c in counters] == before


@contextlib.contextmanager
def _calls(monkeypatch):
    """Every ``ops/_cuda._call`` inside the block, recorded instead of made."""
    calls = []
    monkeypatch.setattr(_cuda, "_call", lambda stem, fn, dev, *args: calls.append((fn, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    yield calls


def test_transition_launch_passes_the_kernels_arguments(monkeypatch):
    """What ``single._transition_cuda`` hands the kernels: the 41 pointers in the C
    entries' order (the row ids in their slot, the speed weight null for a number)
    and the autoreset's ``AUTORESET_PTRS`` after them, all null (the plain
    transition, ``tests/test_torch_autoreset.py`` holds the other mode),
    the 18 float32 constants with the given speed weight in its slot, and the
    launch's plan: a warp a row (``single_transition_f32``), and on the tiled layout
    from ``SINGLE_TRANSITION_ROWS_FROM`` rows the kernel of several rows a block with
    the layout's period (its blocks' rows share a pool row); float64 state is refused
    before any launch."""
    pool = tprof.canonical_bench_pool(16, device="cpu")
    cfg = tsingle.RacingConfig(num_sensors=11)
    assert _cuda.SINGLE_TRANSITION_ROWS_FROM > ENVS  # a warp a row at this width
    tiled = ttrack.tiled_pooled_tracks(pool, ENVS)
    pooled = ttrack.pooled_tracks(pool, np.arange(ENVS) % 16)
    for track, rows_from, entry in (
            (tiled, _cuda.SINGLE_TRANSITION_ROWS_FROM, "single_transition_f32"),
            (tiled, ENVS, "single_transition_rows_f32"),
            (pooled, ENVS, "single_transition_f32")):  # any ids: no period known
        monkeypatch.setattr(_cuda, "SINGLE_TRANSITION_ROWS_FROM", rows_from)
        state, action = chip_smoke.crafted_single_state(track, cfg.max_steps, seed=4)
        with _calls(monkeypatch) as calls:
            _, by_rows = tsingle._transition_cuda(cfg, track, state, action,
                                                  speed_weight=ANNEALED)
            (fn, args), = calls
        assert fn == entry and len(args) + 2 == len(_cuda._SIGNATURES[fn])
        assert by_rows == (entry == "single_transition_rows_f32")
        ptrs, num_ptrs, consts, num_consts, rows, w, *shape = args
        assert (num_ptrs, num_consts) == (_cuda.SINGLE_TRANSITION_PTRS,
                                          _cuda.SINGLE_TRANSITION_CONSTS)
        assert (len(ptrs), len(consts)) == (num_ptrs, num_consts)
        assert ptrs[41:] == [None] * _cuda.AUTORESET_PTRS
        assert ptrs[11] == ttrack.rows_of(track)[1].data_ptr() and ptrs[21] is None
        assert ptrs[0] == state.car.x.data_ptr() and ptrs[6] == action.data_ptr()
        assert consts[13] == np.float32(ANNEALED)
        assert consts[12] == np.float32(1.0) / np.float32(cfg.car.max_speed)
        assert (rows, w) == (ENVS, 512)
        if by_rows:
            plan = _cuda.single_transition_rows_plan(512)
            # the tiled layout's period: its blocks' rows share a pool row
            assert shape == [plan.threads, plan.smem, cfg.max_steps, 2, plan.rows_per_block, 16,
                             0]
        else:
            assert shape == [_cuda.single_transition_plan(512).smem, cfg.max_steps, 2, 0]
    wide = dataclasses.replace(state, car=dataclasses.replace(state.car, x=state.car.x.double()))
    with _calls(monkeypatch) as calls:
        with pytest.raises(TypeError):
            tsingle._transition_cuda(cfg, track, wide, action)
        with pytest.raises(ValueError):
            tsingle._transition_cuda(cfg, track, state, action[:, :1])
        assert calls == []


def test_observe_launch_is_multi_observe_at_one_car_without_the_car_pass(monkeypatch):
    """What ``single._observe_cuda`` hands the observation kernel: one car a row,
    the single cone's 11 angles, the car pass off, at every width the redesigned
    kernel at ``single_observe_plan``'s shape (a row's rays in groups, each the
    car's); on the tiled layout the shape whose blocks' rows share a staged pool row,
    and the layout's period."""
    pool = tprof.canonical_bench_pool(16, device="cpu")
    cfg = tsingle.RacingConfig(num_sensors=11)
    for track, shared in ((ttrack.pooled_tracks(pool, [3]), False),
                          (ttrack.pooled_tracks(pool, np.arange(ENVS) % 16), False),
                          (ttrack.tiled_pooled_tracks(pool, ENVS), True)):
        envs = ttrack.rows_of(track)[1].shape[0]
        plan = _cuda.single_observe_plan(11, 896, shared)
        state, _ = chip_smoke.crafted_single_state(track, cfg.max_steps, seed=4)
        with _calls(monkeypatch) as calls:
            tsingle._observe_cuda(cfg, track, state)
            (fn, args), = calls
        assert fn == "multi_observe_f32" and len(args) + 2 == len(_cuda._SIGNATURES[fn])
        assert args[15:19] == (envs, 1, 11, 896) and args[-2] == 0  # cars off
        assert args[-1] == (16 if shared else 0)  # the tiled layout's period
        assert args[13] == ttrack.rows_of(track)[1].data_ptr()
        assert args[25:31] == (plan.threads, plan.smem, plan.rays_per_lane, 1,
                               plan.rows_per_block, int(plan.overlay))
        assert plan.rays_per_lane < 11 and plan.per_car and plan.shared_row == shared


def test_single_transition_plan_sizes_its_shared_memory():
    """The transition's launches. A warp a row (``single_transition_plan``),
    staging the row's two position fields. The kernel of several rows a block, for
    the tiled layout (``single_transition_rows_plan``): ``SINGLE_TRANSITION_ROWS``
    rows a block of ``SINGLE_TRANSITION_WARPS`` warps, the one pool row they share
    staged once, 30 words a row beside it (the autoreset's start pose and running
    episode among them). A row without waypoints, or one that does not fit, is
    refused."""
    cap = _cuda._field_capacity(512)
    assert _cuda.single_transition_plan(512) == _cuda.TransitionPlan(32, 2 * cap * 4, 1)
    plan = _cuda.single_transition_rows_plan(512)
    rows, warps = _cuda.SINGLE_TRANSITION_ROWS, _cuda.SINGLE_TRANSITION_WARPS
    assert plan == _cuda.TransitionPlan(32 * warps, (2 * cap + 30 * rows) * 4, rows)
    assert rows <= _cuda.SINGLE_TRANSITION_MAX_ROWS_PER_BLOCK and warps * 32 <= 256
    limit = _cuda.BLOCK_SMEM_LIMIT - _cuda.STATIC_SMEM_RESERVE
    for plan_fn in (_cuda.single_transition_plan, _cuda.single_transition_rows_plan):
        assert plan_fn(20_000).smem <= limit
        with pytest.raises(ValueError):
            plan_fn(40_000)
        with pytest.raises(ValueError):
            plan_fn(0)


def test_multi_observe_plan_at_one_car_and_11_rays():
    """The observation's plan at one car and the single cone's 11 rays: on many rows
    a warp a row's 11 rays (one car's, so one cross term a segment), 4 rows a block
    staging their five segment fields, the run results over the staged rows; under
    ``OBSERVE_SMALL_BELOW`` rows the first kernel, a warp a row."""
    plan = _cuda.multi_observe_plan(1, 11, 896, 4096)
    cap = _cuda._field_capacity(896)
    assert (plan.threads, plan.rays_per_lane, plan.per_car, plan.rows_per_block,
            plan.overlay, plan.small) == (128, 11, True, 4, True, False)
    assert plan.smem == 4 * (5 * cap + 11 * 5 + 18 + 11) * 4
    small = _cuda.multi_observe_plan(1, 11, 896, 200)
    assert small.small and small.threads == 32 and small.rows_per_block == 1

"""The vector step's fused route (the envs' ``transition_autoreset``: the transition,
the NEXT_STEP reset, the merge, the reset info, the masks, the episode statistics,
a rollout's rows of the step and self-play's PFSP counts, which on the card are the
transition kernel's autoreset mode, ``csrc/autoreset.cuh``) on the CPU, where it
runs its plain version:

- ``vector.step`` through the fused route bitwise the generic composition
  (``_generic_step``: a transition, a fresh state, its info and ``vector.autoreset``,
  as the JAX package's ``vector.step`` composes them), float32 and float64, on
  ``chip_smoke.crafted_state`` with pending resets on no row, some and all, 8-48
  envs, 1 and 2 cars, per-env rows and the tiled pool;
- the same step against the JAX package's jitted ``vector.step`` with JAX's grid
  slots fed in: f64 rtol/atol 1e-9, f32 rtol 1e-5 / atol 1e-3 (the tolerances of
  ``tests/test_torch_env_step.py`` and ``test_torch_single_env_step.py``), integers
  and bools exact;
- ``ppo.rollout_step``'s reward, done and episode rows, ``extra`` and carry bitwise
  the composition's (the generic step, the rows written and the wins and games summed
  as the rollout step wrote them before the fused route), over rollouts that end and
  reset episodes;
- the wrappers hand the kernels their arguments in ``csrc/autoreset.cuh``'s order
  and refuse wrong dtypes, shapes and devices before any launch (``_cuda._call``
  patched, as ``tests/test_torch_single_env_step.py`` does);
- the kernels' PFSP count (int32 counts a slot, then one float add into ``extra``)
  bitwise ``multi.pfsp_counts`` added into it.

``tests/test_torch_update_graph.py`` holds the whole rollout step against JAX's.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import single as jsingle
from self_play_racing_tpu.envs import track as jtrk
from self_play_racing_tpu.envs import vector as jvector
from self_play_racing_tpu.utils import profiling as jprof
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent.self_play import make_selfplay_hooks
from self_play_racing_tpu_torch.agent.trainer import make_single_env_hooks
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import selfplay as tsp
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.envs import vector as tvector
from self_play_racing_tpu_torch.models import actor_critic as tnet
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.utils import profiling as tprof

DTYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64)}
TOL = {"f64": dict(rtol=1e-9, atol=1e-9), "f32": dict(rtol=1e-5, atol=1e-3)}
PENDING = ("none", "some", "all")
POOL = 3


def _pool(dtype=torch.float32):
    return tprof.canonical_bench_pool(16, dtype=dtype, device="cpu")


def _layout(pool, where, envs):
    if where == "tiled":
        return ttrack.tiled_pooled_tracks(pool, envs)
    return ttrack.gather_tracks(pool, np.arange(envs) % 16)


def _pending(kind, n, seed):
    if kind == "none":
        return torch.zeros((n,), dtype=torch.bool)
    if kind == "all":
        return torch.ones((n,), dtype=torch.bool)
    return torch.as_tensor(np.random.default_rng(seed).random(n) < 0.4)


def _stats(n, seed):
    rng = np.random.default_rng(seed + 1)
    return tvector.EpisodeStats(
        ep_return=torch.as_tensor(rng.normal(0.0, 50.0, n).astype(np.float32)),
        ep_length=torch.as_tensor(rng.integers(0, 500, n).astype(np.int32)))


def _leaves(tree, prefix=""):
    """Every tensor of ``tree`` by path (dataclasses, dicts, tuples)."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        items = list(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _bits(t):
    """``t``'s bits, so that -0.0 is not 0.0 and NaNs compare by payload."""
    if t.is_floating_point():
        return t.contiguous().view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _assert_bitwise(got, want):
    g, w = _leaves(got), _leaves(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
        assert torch.equal(_bits(g[k]), _bits(w[k])), k


def _single_case(dt, where, envs, pending, seed):
    td = DTYPES[dt][1]
    track = _layout(_pool(td), where, envs)
    cfg = tsingle.RacingConfig(num_sensors=11, max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    state, action = chip_smoke.crafted_single_state(track, cfg.max_steps, seed=seed, dtype=td)
    vstate = tvector.VecState(env=state, pending_reset=_pending(pending, envs, seed),
                              stats=_stats(envs, seed), generator=None)
    return cfg, track, vstate, action


def _generic_step(transition_fn, reset_fn, info_fn):
    """A vector step's transition and NEXT_STEP autoreset as the generic composition
    (the JAX package's ``vector.step``): ``transition_fn(state, action, generator)``,
    then ``reset_fn(generator)``'s fresh state on the pending rows with
    ``info_fn(merged)``'s info there (``vector.autoreset``)."""
    def step(state, action, generator, pending_reset, stats):
        stepped, reward, terminated, truncated, info = transition_fn(state, action, generator)
        return tvector.autoreset(pending_reset, stats, stepped, reset_fn(generator), reward,
                                 terminated, truncated, info, info_fn)

    return step


def _single_generic(cfg, track):
    return _generic_step(lambda s, a, g: tsingle.transition(cfg, track, s, a),
                         lambda g: tsingle.reset_state(cfg, track),
                         lambda s: tsingle.info_from_state(cfg, track, s))


def _selfplay_generic(cfg, track, opp):
    """Self-play's deferred pair as the trainer composed it before the fused route:
    the deferred transition (the opponents' draws first), a deferred fresh state (its
    grid drawn after them, a zero ``obs_all``) and seat 0's info."""
    return _generic_step(
        lambda s, a, g: tsp.transition_deferred(cfg, track, opp, s, a, g),
        lambda g: tsp.reset_state_deferred(cfg, track, g),
        lambda s: {k: v[:, 0] for k, v in tmulti.info_from_state(cfg, track, s.inner).items()})


def _single_steps(cfg, track, vstate, action):
    observe = lambda s: tsingle.observe(cfg, track, s)  # noqa: E731
    generic = tvector.step(vstate, action, _single_generic(cfg, track), observe)
    fused = tvector.step(
        vstate, action,
        lambda s, a, g, p, st: tsingle.transition_autoreset(cfg, track, s, a, p, st), observe)
    return generic, fused


def _opp(n, per_env, seed, obs_dim=19, dtype=torch.float32):
    """A pool of ``POOL`` random (obs_dim, 64, 64) actors, its members by env (or one
    for all) and use_policy mixed (or one for all)."""
    rng = np.random.default_rng(seed + 7)
    params = tnet.init_params(torch.Generator().manual_seed(seed), obs_dim, 2)
    actor = [(torch.stack([w + 0.01 * k for k in range(POOL)]),
              torch.stack([b + 0.01 * k for k in range(POOL)])) for w, b in params["actor"]]
    idx = (torch.as_tensor(rng.integers(0, POOL, n).astype(np.int32)) if per_env
           else torch.tensor(1, dtype=torch.int64))
    use = torch.as_tensor(rng.random(n) < 0.7) if per_env else torch.tensor(True)
    return {"params": {"actor": [(w.to(dtype), b.to(dtype)) for w, b in actor]},
            "log_std": torch.full((POOL, 2), -0.5, dtype=dtype), "idx": idx,
            "use_policy": use}


def _selfplay_case(dt, where, envs, agents, pending, seed, per_env=True):
    td = DTYPES[dt][1]
    track = _layout(_pool(td), where, envs)
    cfg = tmulti.MultiRacingConfig(num_agents=agents, num_sensors=11,
                                   max_steps=chip_smoke.CRAFTED_MAX_STEPS)
    inner, action = chip_smoke.crafted_state(track, agents, cfg.max_steps, seed=seed, dtype=td)
    state = tsp.SelfPlayState(inner=inner, obs_all=tmulti.observe(cfg, track, inner))
    vstate = tvector.VecState(env=state, pending_reset=_pending(pending, envs, seed),
                              stats=_stats(envs, seed), generator=None)
    return cfg, track, vstate, action[:, 0], _opp(envs, per_env, seed, cfg.obs_dim)


def _selfplay_steps(cfg, track, vstate, action0, opp, seed):
    hooks = make_selfplay_hooks(cfg, POOL)
    aux = {"track": track, "opp": opp}
    outs = []
    for fused in (False, True):
        gen = torch.Generator().manual_seed(seed)
        v = dataclasses.replace(vstate, generator=gen)
        outs.append(tvector.step(
            v, action0,
            ((lambda s, a, g, p, st: hooks.step(aux, s, a, g, p, st, None)) if fused
             else _selfplay_generic(cfg, track, opp)),
            lambda s: hooks.observe(aux, s),
            refresh_fn=lambda s: hooks.refresh(aux, s)))
        outs[-1] = (outs[-1], gen.get_state())
    return outs


def _without_generators(out):
    vstate, *rest = out
    return (dataclasses.replace(vstate, generator=None), *rest)


@pytest.mark.parametrize("pending", PENDING)
@pytest.mark.parametrize("where", ["gathered", "tiled"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_single_fused_route_is_the_composition(dt, where, pending):
    cfg, track, vstate, action = _single_case(dt, where, 48, pending, seed=3)
    generic, fused = _single_steps(cfg, track, vstate, action)
    _assert_bitwise(fused, generic)
    if pending != "none":
        # the reset rows took the start pose, reward 0 and the flags False
        rows = vstate.pending_reset
        start = ttrack.scalars_of(track)
        x = fused[0].env.car.x
        assert torch.equal(x[rows], start.start_x.to(x.dtype)[rows])
        assert not fused[3][rows].any() and (fused[2][rows] == 0).all()
    if pending != "all":
        assert fused[3].any()  # crafted rows end this step


@pytest.mark.parametrize("pending", PENDING)
@pytest.mark.parametrize("agents", [1, 2])
@pytest.mark.parametrize("where", ["gathered", "tiled"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_selfplay_fused_route_is_the_composition(dt, where, agents, pending):
    """Self-play's deferred pair: the opponents' draws, kernel B's plain version, the
    grid slots drawn after them (the generator ends where the composition's does),
    the transition, the merge (no zero ``obs_all``: ``refresh`` senses every row)."""
    cfg, track, vstate, action0, opp = _selfplay_case(dt, where, 16, agents, pending, seed=5)
    (generic, g_state), (fused, f_state) = _selfplay_steps(cfg, track, vstate, action0, opp, 11)
    assert torch.equal(g_state, f_state)
    _assert_bitwise(_without_generators(fused), _without_generators(generic))


def _single_jax(dt, track, tcfg, vstate, action):
    jd = DTYPES[dt][0]
    jtrack = jtrk.gather_tracks(jprof.canonical_bench_pool(16, dtype=jd),
                                np.arange(vstate.pending_reset.shape[0]) % 16)
    jcfg = jsingle.RacingConfig(num_sensors=11, max_steps=tcfg.max_steps)
    car = vstate.env.car
    jstate = jsingle.RacingState(
        car=jsingle.CarState(**{f.name: jnp.asarray(getattr(car, f.name).numpy(),
                                                    jd if getattr(car, f.name).is_floating_point()
                                                    else None)
                                for f in dataclasses.fields(car)}),
        **{f: jnp.asarray(getattr(vstate.env, f).numpy(),
                          jd if getattr(vstate.env, f).is_floating_point() else None)
           for f in ("steps", "last_progress", "last_steering", "cp25", "cp50", "cp75")})

    @jax.jit
    def step(tr, vs, a):
        return jvector.step(vs, a, lambda s, a_, k: jsingle.transition(jcfg, tr, s, a_),
                            lambda s: jsingle.observe(jcfg, tr, s),
                            lambda k: jsingle.reset_state(jcfg, tr),
                            info_fn=lambda s: jsingle.info_from_state(jcfg, tr, s))

    return step(jtrack, _jax_vstate(jstate, vstate), jnp.asarray(action.numpy(), jd))


def _jax_vstate(jenv, vstate):
    return jvector.VecState(
        env=jenv, pending_reset=jnp.asarray(vstate.pending_reset.numpy()),
        stats=jvector.EpisodeStats(ep_return=jnp.asarray(vstate.stats.ep_return.numpy()),
                                   ep_length=jnp.asarray(vstate.stats.ep_length.numpy())),
        key=jax.random.key(0))


def _assert_close(got, want, dt, skip=()):
    for k, w in want.items():
        if k in skip:
            continue
        g, w = got[k], np.asarray(w)
        assert g.shape == w.shape, k
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64), err_msg=k)
        else:
            np.testing.assert_allclose(g, w, **TOL[dt], err_msg=k)


def _named(out, env_fields):
    vstate, obs, reward, done, terminated, truncated, info, record = out
    named = {f"env.{k}": v for k, v in env_fields(vstate.env).items()}
    named.update({"pending_reset": vstate.pending_reset,
                  "stats.ep_return": vstate.stats.ep_return,
                  "stats.ep_length": vstate.stats.ep_length, "obs": obs, "reward": reward,
                  "done": done, "terminated": terminated, "truncated": truncated,
                  **{f"info.{k}": v for k, v in info.items()},
                  **{f"record.{k}": v for k, v in record.items()}})
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in named.items()}


def _single_fields(state):
    car = state.car
    out = {f.name: getattr(car, f.name) for f in dataclasses.fields(car)}
    out.update({f: getattr(state, f) for f in ("steps", "last_progress", "last_steering",
                                               "cp25", "cp50", "cp75")})
    return out


def _multi_fields(state):
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


@pytest.mark.parametrize("pending", PENDING)
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_single_fused_step_matches_jitted_jax(dt, pending):
    cfg, track, vstate, action = _single_case(dt, "tiled", 48, pending, seed=4)
    fused = tvector.step(
        vstate, action,
        lambda s, a, g, p, st: tsingle.transition_autoreset(cfg, track, s, a, p, st),
        lambda s: tsingle.observe(cfg, track, s))
    want = _single_jax(dt, track, cfg, vstate, action)
    # the observations carry cos and sin, which XLA's and PyTorch's CPU math round
    # apart in the last bit: tests/test_torch_single_env_step.py's observation bound
    _assert_close(_named(fused, _single_fields), _named(want, _single_fields), dt,
                  skip=("obs",))
    np.testing.assert_allclose(fused[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol={"f64": 1e-6, "f32": 1e-4}[dt])


@pytest.mark.parametrize("pending", PENDING)
@pytest.mark.parametrize("agents", [1, 2])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_multi_fused_step_matches_jitted_jax(dt, agents, pending):
    """``multi.transition_autoreset`` over seat 0's episode against JAX's
    ``vector.step`` of the multi env viewed from seat 0 (self-play's view without
    the opponents), JAX's grid slots fed to both resets. The rays sense over a
    +-1.5 rad cone: the start grid's +-pi/2 rays pass exactly through a boundary
    vertex, a hit or a miss on the last bit of cos, which XLA and PyTorch round
    apart."""
    jd, td = DTYPES[dt]
    envs = 16
    track = _layout(_pool(td), "gathered", envs)
    kw = dict(num_agents=agents, num_sensors=11, max_steps=chip_smoke.CRAFTED_MAX_STEPS,
              sensor_cone=1.5)
    cfg, jcfg = tmulti.MultiRacingConfig(**kw), jmulti.MultiRacingConfig(**kw)
    state, action = chip_smoke.crafted_state(track, agents, cfg.max_steps, seed=6, dtype=td)
    vstate = tvector.VecState(env=state, pending_reset=_pending(pending, envs, 6),
                              stats=_stats(envs, 6), generator=None)
    slots = jnp.argsort(jax.random.uniform(jax.random.key(9), (envs, agents)), axis=-1)
    fused = tvector.step(
        vstate, action,
        lambda s, a, g, p, st: tmulti.transition_autoreset(
            cfg, track, s, a, p, st, torch.as_tensor(np.asarray(slots), dtype=torch.int64)),
        lambda s: tmulti.observe(cfg, track, s))

    def seat0(out):
        new, rewards, terminated, truncated, info = out
        return new, rewards[:, 0], terminated, truncated, info

    @jax.jit
    def step(tr, vs, a):
        return jvector.step(vs, a, lambda s, a_, k: seat0(jmulti.transition(jcfg, tr, s, a_)),
                            lambda s: jmulti.observe(jcfg, tr, s),
                            lambda k: jmulti.reset_state(jcfg, tr, position_idx=slots),
                            info_fn=lambda s: jmulti.info_from_state(jcfg, tr, s))

    jstate = jmulti.MultiState(**{
        f.name: jnp.asarray(getattr(state, f.name).numpy(),
                            jd if getattr(state, f.name).is_floating_point() else None)
        for f in dataclasses.fields(state)})
    jtrack = jtrk.gather_tracks(jprof.canonical_bench_pool(16, dtype=jd),
                                np.arange(envs) % 16)
    want = step(jtrack, _jax_vstate(jstate, vstate), jnp.asarray(action.numpy(), jd))
    got = _named(fused, _multi_fields)
    _assert_close(got, _named(want, _multi_fields), dt, skip=("obs",))
    np.testing.assert_allclose(got["obs"], np.asarray(want[1]), rtol=0,
                               atol={"f64": 1e-6, "f32": 1e-4}[dt])


def _rollout_runner(kind, envs, seed, per_env=True):
    """(cfg, hooks, composed hooks, aux, runner) of a small rollout from a crafted
    state whose rows end, reset and (self-play) end against pool opponents within a
    few steps; the composed hooks step as ``_composed_step`` says."""
    cfg = base_config(num_envs=envs, num_steps=6, seed=seed)
    pool = _pool()
    track = _layout(pool, "tiled", envs)
    if kind == "single":
        env_cfg = tsingle.RacingConfig(num_sensors=11, max_steps=chip_smoke.CRAFTED_MAX_STEPS)
        hooks, aux = make_single_env_hooks(env_cfg), track
        generic = _single_generic(env_cfg, track)
        state, _ = chip_smoke.crafted_single_state(track, env_cfg.max_steps, seed=seed)
        obs_dim = env_cfg.obs_dim
    else:
        env_cfg = tmulti.MultiRacingConfig(num_agents=2, num_sensors=11,
                                           max_steps=chip_smoke.CRAFTED_MAX_STEPS)
        hooks = make_selfplay_hooks(env_cfg, POOL)
        aux = {"track": track, "opp": _opp(envs, per_env, seed)}
        generic = _selfplay_generic(env_cfg, track, aux["opp"])
        inner, _ = chip_smoke.crafted_state(track, 2, env_cfg.max_steps, seed=seed)
        state = tsp.SelfPlayState(inner=inner, obs_all=tmulti.observe(env_cfg, track, inner))
        obs_dim = env_cfg.obs_dim
    runner = tppo.init_runner(torch.Generator().manual_seed(seed), cfg, hooks, aux, obs_dim, 2)
    vec = dataclasses.replace(runner.vec, env=state,
                              pending_reset=_pending("some", envs, seed))
    pool = POOL if kind == "selfplay" else 0
    composed = hooks._replace(step=lambda aux_, s, a, g, p, st, rows: _composed_step(
        generic, aux_, s, a, g, p, st, rows, pool))
    return cfg, hooks, composed, aux, dataclasses.replace(runner, vec=vec)


def _composed_step(generic, aux, state, action, generator, pending_reset, stats, rows, pool):
    """The rollout's env step as the composition: ``generic``, then row ``rows.t`` of
    the reward, done and episode buffers, t + 1 and, with a pool, the per-slot wins and
    games summed into ``extra`` as ``ppo.rollout_step`` wrote them before the fused
    route."""
    out = generic(state, action, generator, pending_reset, stats)
    mask = out.record["mask"]
    values = {"reward": out.reward.to(torch.float32), "done_entering": rows.entering,
              "ep_return": torch.where(mask, out.record["return"], 0.0),
              "ep_length": torch.where(mask, out.record["length"], 0), "ep_mask": mask}
    for k, v in values.items():
        rows.out[k].index_copy_(0, rows.t, v[None])
    rows.t_next.copy_(rows.t + 1)
    if pool:
        opp = aux["opp"]
        st = tmulti.pfsp_counts(opp["idx"], opp["use_policy"], mask, out.info["placement"],
                                pool)
        rows.out.setdefault("extra", torch.zeros_like(st)).add_(st)
    return out


def _rollout(cfg, hooks, aux, runner):
    gen = runner.vec.generator
    start = gen.get_state()
    try:
        params = runner.train.model.params()
        noise = tnet.sample_noise((cfg.num_steps, cfg.num_envs, 2),
                                  torch.Generator().manual_seed(2))
        carry, out = tppo.rollout_carry(runner), {}
        for _ in range(cfg.num_steps):
            carry = tppo.rollout_step(cfg, hooks, aux, params, runner.train.model.log_std,
                                      noise, carry, out)
        return carry, out, gen.get_state()
    finally:
        gen.set_state(start)


@pytest.mark.parametrize("kind,per_env", [("single", True), ("selfplay", True),
                                          ("selfplay", False)])
def test_rollout_step_rows_and_extra_are_the_composition(kind, per_env):
    cfg, hooks, composed_hooks, aux, runner = _rollout_runner(kind, 32, seed=8,
                                                              per_env=per_env)
    with torch.no_grad():
        composed = _rollout(cfg, composed_hooks, aux, runner)
        fused = _rollout(cfg, hooks, aux, runner)
    assert torch.equal(composed[2], fused[2])  # the generator ends at the same draw
    _assert_bitwise(_without_carry_generator(fused[0]), _without_carry_generator(composed[0]))
    _assert_bitwise(fused[1], composed[1])
    assert list(fused[1]) == list(composed[1])
    assert fused[1]["ep_mask"].any() and fused[1]["done_entering"].any()
    if kind == "selfplay":
        assert fused[1]["extra"].shape == (2 * POOL,) and fused[1]["extra"][POOL:].sum() > 0


def _without_carry_generator(carry):
    return dataclasses.replace(carry, vec=dataclasses.replace(carry.vec, generator=None))


@contextlib.contextmanager
def _calls(monkeypatch):
    """Every ``ops/_cuda._call`` inside the block, recorded instead of made."""
    calls = []
    monkeypatch.setattr(_cuda, "_call", lambda stem, fn, dev, *args: calls.append((fn, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    yield calls


def _rows(steps, n):
    out = {}
    tvector.rollout_buffers(out, steps, tvector.VecState(
        env=None, pending_reset=torch.zeros((n,), dtype=torch.bool), stats=_stats(n, 0),
        generator=None))
    return tvector.RolloutRows(out, torch.tensor([2]), torch.zeros((n,), dtype=torch.bool),
                               torch.empty((1,), dtype=torch.int64))


def test_single_wrapper_passes_the_autoreset_arguments_and_refuses(monkeypatch):
    cfg, track, vstate, action = _single_case("f32", "tiled", 48, "some", seed=3)
    rows = _rows(5, 48)
    with _calls(monkeypatch) as calls:
        out, _ = tsingle._transition_cuda(cfg, track, vstate.env, action,
                                          reset=(vstate.pending_reset, vstate.stats, rows))
        (fn, args), = calls
    assert fn == "single_transition_f32" and len(args) + 2 == len(_cuda._SIGNATURES[fn])
    ptrs, num_ptrs = args[0], args[1]
    assert num_ptrs == _cuda.SINGLE_TRANSITION_PTRS == 41 + _cuda.AUTORESET_PTRS
    reset = ptrs[41:]
    start = ttrack.scalars_of(track)
    assert reset[0] == vstate.pending_reset.data_ptr()
    assert reset[1:3] == [vstate.stats.ep_return.data_ptr(), vstate.stats.ep_length.data_ptr()]
    assert reset[3:6] == [start.start_x.data_ptr(), start.start_y.data_ptr(),
                          start.start_angle.data_ptr()]
    assert reset[6:9] == [None] * 3 and reset[23:] == [None] * 4  # no grid, no pool
    assert reset[9] == out.done.data_ptr() and reset[10] == out.pending_reset.data_ptr()
    assert reset[11] == out.record["return"].data_ptr()
    assert reset[13] == out.stats.ep_return.data_ptr()
    assert reset[15:18] == [rows.t.data_ptr(), rows.t_next.data_ptr(), rows.entering.data_ptr()]
    assert reset[18:23] == [rows.out[k].data_ptr() for k in tvector.ROW_BUFFERS]
    assert args[-1] == 5  # the rollout's rows
    assert out.record["autoreset"] is vstate.pending_reset and out.reward is out.info["reward"]
    # the plain transition: every autoreset pointer null
    with _calls(monkeypatch) as calls:
        tsingle._transition_cuda(cfg, track, vstate.env, action)
        (fn, args), = calls
    assert args[0][41:] == [None] * _cuda.AUTORESET_PTRS and args[-1] == 0
    bad = [
        (vstate.pending_reset.to(torch.uint8), vstate.stats, rows),
        (vstate.pending_reset[:47], vstate.stats, rows),
        (vstate.pending_reset, tvector.EpisodeStats(vstate.stats.ep_return.double(),
                                                    vstate.stats.ep_length), rows),
        (vstate.pending_reset, tvector.EpisodeStats(vstate.stats.ep_return,
                                                    vstate.stats.ep_length.long()), rows),
        (vstate.pending_reset.to("meta"), vstate.stats, rows),
        (vstate.pending_reset, vstate.stats, dataclasses.replace(rows, t=rows.t.int())),
        (vstate.pending_reset, vstate.stats,
         dataclasses.replace(rows, out={**rows.out, "ep_length": rows.out["ep_length"].long()})),
    ]
    with _calls(monkeypatch) as calls:
        for reset in bad:
            with pytest.raises(TypeError):
                tsingle._transition_cuda(cfg, track, vstate.env, action, reset=reset)
        assert calls == []


@pytest.mark.parametrize("envs", [16, 4096])
def test_multi_wrapper_passes_the_autoreset_arguments_and_refuses(monkeypatch, envs):
    """The first kernel under ``TRANSITION_SMALL_BELOW`` rows, the redesigned one
    from it; the grid slots and the pool's four pointers, its slots and its mode."""
    cfg, track, vstate, action0, opp = _selfplay_case("f32", "tiled", envs, 2, "some", seed=5)
    inner = vstate.env.inner
    action = torch.stack([action0, action0], dim=1)
    slots = torch.zeros((envs, 2), dtype=torch.int64)
    extra = torch.zeros((2 * POOL,))
    counts = torch.zeros((2 * POOL + 1,), dtype=torch.int32)
    pfsp = tmulti.PFSP(opp["idx"], opp["use_policy"], extra, counts)
    rows = _rows(4, envs)
    with _calls(monkeypatch) as calls:
        out, small = tmulti._transition_cuda(
            cfg, track, inner, action, reset=(vstate.pending_reset, vstate.stats, rows, slots,
                                              pfsp))
        (fn, args), = calls
    assert small == (envs < _cuda.TRANSITION_SMALL_BELOW)
    assert fn == ("multi_transition_small_f32" if small else "multi_transition_f32")
    assert len(args) + 2 == len(_cuda._SIGNATURES[fn])
    ptrs, num_ptrs, consts, num_consts = args[:4]
    assert (num_ptrs, num_consts) == (_cuda.TRANSITION_PTRS, _cuda.TRANSITION_CONSTS)
    assert consts[21:] == [np.float32(0.5), np.float32(cfg.car.width + 1.5)]
    reset = ptrs[44:]
    start = ttrack.scalars_of(track)
    assert reset[6:9] == [start.start_nx.data_ptr(), start.start_ny.data_ptr(),
                          slots.data_ptr()]
    assert reset[23:] == [opp["idx"].data_ptr(), opp["use_policy"].data_ptr(),
                          extra.data_ptr(), counts.data_ptr()]
    assert args[-3:] == (4, POOL, _cuda.PFSP_IDX_PER_ENV | _cuda.PFSP_USE_PER_ENV)
    assert out.reward.shape == (envs,) and out.info["reward"].shape == (envs, 2)
    # one index for all, int64: the mode says so
    one = tmulti.PFSP(torch.tensor(2), torch.tensor(True), extra, counts)
    with _calls(monkeypatch) as calls:
        tmulti._transition_cuda(cfg, track, inner, action,
                                reset=(vstate.pending_reset, vstate.stats, None, slots, one))
        (fn, args), = calls
    assert args[-3:] == (0, POOL, _cuda.PFSP_IDX_WIDE) and args[0][44 + 15:44 + 23] == [None] * 8
    bad = [
        (vstate.pending_reset, vstate.stats, rows, slots.int(), pfsp),
        (vstate.pending_reset, vstate.stats, rows, slots[:, :1].contiguous(), pfsp),
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"].float(), opp["use_policy"], extra, counts)),
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"], opp["use_policy"].int(), extra, counts)),
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"], opp["use_policy"], extra.double(), counts)),
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"][:3], opp["use_policy"], extra, counts)),
        # the kernel's count scratch: missing, or not int32 [2 * pool + 1]
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"], opp["use_policy"], extra)),
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"], opp["use_policy"], extra, counts.long())),
        (vstate.pending_reset, vstate.stats, rows, slots,
         tmulti.PFSP(opp["idx"], opp["use_policy"], extra, counts[:-1])),
    ]
    with _calls(monkeypatch) as calls:
        for reset in bad:
            with pytest.raises(TypeError):
                tmulti._transition_cuda(cfg, track, inner, action, reset=reset)
        with pytest.raises(ValueError):  # another grid than the config's
            tmulti._transition_cuda(dataclasses.replace(cfg, num_agents=3), track, inner,
                                    action, reset=bad[0][:3] + (slots, pfsp))
        assert calls == []


def pfsp_kernel_model(idx, use_policy, mask, placement, pool, extra):
    """The kernels' PFSP count (``csrc/autoreset.cuh``): each row adds 1 to its slot's
    int32 games (and wins) where its episode ended against a policy opponent (and
    won), then each count goes into ``extra`` as one float32 add."""
    n = mask.shape[0]
    idx = np.broadcast_to(np.asarray(idx), (n,)).astype(np.int64)
    use = np.broadcast_to(np.asarray(use_policy), (n,))
    counts = np.zeros(2 * pool, np.int32)
    for r in range(n):
        if mask[r] and use[r] and 0 <= idx[r] < pool:
            counts[pool + idx[r]] += 1
            counts[idx[r]] += placement[r] == 1
    return (extra.astype(np.float32) + counts.astype(np.float32)).astype(np.float32)


@pytest.mark.parametrize("idx_kind", ["per env int32", "per env int64", "one int32",
                                      "one int64"])
@pytest.mark.parametrize("use_kind", ["per env", "one"])
def test_pfsp_count_model_is_the_stats_hook(idx_kind, use_kind):
    rng = np.random.default_rng(12)
    n, pool = 4096, 5
    dtype = torch.int64 if idx_kind.endswith("int64") else torch.int32
    idx = (torch.as_tensor(rng.integers(-1, pool + 1, n), dtype=dtype)
           if idx_kind.startswith("per env") else torch.tensor(3, dtype=dtype))
    use = torch.as_tensor(rng.random(n) < 0.8) if use_kind == "per env" else torch.tensor(True)
    mask = torch.as_tensor(rng.random(n) < 0.3)
    placement = torch.as_tensor(np.where(mask.numpy(), rng.integers(1, 3, n), 0), dtype=torch.int32)
    # running sums that are not whole, so the add's rounding shows
    extra = torch.as_tensor(rng.uniform(0, 3e7, 2 * pool).astype(np.float32))
    st = tmulti.pfsp_counts(idx, use, mask, placement, pool)
    want = extra.clone().add_(st)
    got = pfsp_kernel_model(idx.numpy(), use.numpy(), mask.numpy(), placement.numpy(), pool,
                            extra.numpy())
    assert np.array_equal(got.view(np.int32), want.numpy().view(np.int32))
    assert (st > 0).any()

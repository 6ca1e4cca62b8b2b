"""The port's Gymnasium adapters (``envs/gym_adapter.py``) against the JAX package's,
on the CPU.

- ``RacingEnv`` in float64 lockstep with JAX's (which jits its step with the track
  as an argument, so the port's division rounding matches) over 300 seeded actions
  that cross episode ends and resets: done flags and ``crashed``/``finished``
  exact; rewards, positions, speeds, progress and its delta within rtol 1e-9 (cos
  and sin round differently in XLA's and PyTorch's CPU math in about 0.2% of
  float64 values, so the state drifts by a few ulps); observations (float32) exact
  for the rays and within 1e-12 absolute for the kinematic features.
- ``MultiRacingEnv`` at 2 and 3 agents: the spaces' keys, bounds, shapes and dtypes
  equal JAX's; in lockstep on one action stream the dones dicts (``"__all__"``
  included), placements and rewards agree.
- ``SelfPlayWrapper`` in lockstep with JAX's under a fixed callable opponent, and
  the ``(params, log_std)`` opponent at log_std -30 (deterministic: the noise
  vanishes below float32's ulp) giving JAX's action on the same observations
  within 1e-6 (XLA's and PyTorch's tanh round differently). The wrappers sense
  over a +-1.5 rad cone: the default +-pi/2 start-grid rays pass exactly through a
  boundary vertex and hit or miss on the last bit of cos.
- The stand-in spaces (gymnasium hidden through ``sys.modules``) equal
  gymnasium's in bounds, shape and dtype, and the adapters run on them.
- ``EpisodeStatistics`` gives gymnasium's ``RecordEpisodeStatistics``'s ``r`` and
  ``l`` on the same episodes.
- The launch plans take the adapters' batch of one; ``dtype=None`` is float64 on
  the CPU and float32 on ``cuda``; the three adapters are package exports.
"""
import contextlib
import dataclasses
import importlib
import sys

import numpy as np
import pytest
import torch

import gymnasium as gym
import jax.numpy as jnp

from self_play_racing_tpu.envs import gym_adapter as jga
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.evaluate import load_policy as jload_policy
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
import self_play_racing_tpu_torch as port
from self_play_racing_tpu_torch.envs import gym_adapter as tga
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.evaluate import load_policy as tload_policy
from self_play_racing_tpu_torch.ops import _cuda
from self_play_racing_tpu_torch.ops import dynamics
from self_play_racing_tpu_torch.ops import geometry as geo

RTOL = 1e-9
MULTI_MODEL = "models/self_play_agent.npz"
CONE = 1.5


def _cps(n=3, seed=4):
    np.random.seed(seed)
    return jtrack.gen_tracks(n, seed=seed)


def _assert_single_obs(t, j, num_rays=11):
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t[:num_rays], j[:num_rays])
    np.testing.assert_allclose(t[num_rays:], j[num_rays:], rtol=0, atol=1e-12)


def _assert_info(t, j, what):
    assert t.keys() == j.keys(), what
    for k in j:
        if isinstance(j[k], bool):
            assert t[k] == j[k], f"{what}[{k}]"
        else:
            np.testing.assert_allclose(np.asarray(t[k], float), np.asarray(j[k], float),
                                       rtol=RTOL, atol=RTOL, err_msg=f"{what}[{k}]")


def test_racing_env_lockstep_with_jax():
    cps = _cps()
    jenv = jga.RacingEnv(num_sensors=11, track_pool=cps, track_id=1, track_width=7.0)
    tenv = tga.RacingEnv(num_sensors=11, track_pool=cps, track_id=1, track_width=7.0,
                         device="cpu")
    assert tenv.track.wp_x.dtype == torch.float64
    jo, ji = jenv.reset(seed=3)
    to, ti = tenv.reset(seed=3)
    _assert_single_obs(to, jo)
    _assert_info(ti, ji, "reset info")
    rng = np.random.RandomState(0)
    ends = 0
    for t in range(300):
        a = rng.uniform([-0.6, 0.2], [0.6, 1.0])
        jo, jr, jterm, jtrunc, ji = jenv.step(a)
        to, tr, tterm, ttrunc, ti = tenv.step(a)
        assert (tterm, ttrunc) == (jterm, jtrunc), t
        np.testing.assert_allclose(tr, jr, rtol=RTOL, atol=RTOL)
        _assert_single_obs(to, jo)
        _assert_info(ti, ji, f"step {t}")
        if jterm or jtrunc:
            ends += 1
            jo, ji = jenv.reset()
            to, ti = tenv.reset()
            _assert_single_obs(to, jo)
            _assert_info(ti, ji, f"reset after step {t}")
    assert ends >= 2  # the stream crosses resets


def _cone(env):
    env.cfg = dataclasses.replace(env.cfg, sensor_cone=CONE)
    return env


@pytest.mark.parametrize("agents", [2, 3])
def test_multi_env_spaces_and_dones_match_jax(agents):
    cps = _cps()
    kw = dict(num_agents=agents, num_sensors=11, track_pool=cps, track_id=0, track_width=8.0)
    jenv, tenv = _cone(jga.MultiRacingEnv(**kw)), _cone(tga.MultiRacingEnv(**kw, device="cpu"))
    for space in ("action_space", "observation_space"):
        js, ts = getattr(jenv, space), getattr(tenv, space)
        assert list(ts.keys()) == list(js.keys()) == [f"{i}" for i in range(agents)]
        for k in js.keys():
            assert ts[k] == js[k], (space, k)
            np.testing.assert_array_equal(ts[k].low, js[k].low)
            np.testing.assert_array_equal(ts[k].high, js[k].high)
            assert (ts[k].shape, ts[k].dtype) == (js[k].shape, js[k].dtype)
    rng = np.random.RandomState(1)
    for episode in range(2):
        np.random.seed(10 + episode)
        jo, _ = jenv.reset()
        np.random.seed(10 + episode)
        to, _ = tenv.reset()
        for t in range(400):
            acts = {f"{i}": rng.uniform([-1.0, -0.2], [1.0, 1.0]) for i in range(agents)}
            jo, jr, jd, jtr, ji = jenv.step(acts)
            to, tr, td, ttr, ti = tenv.step(acts)
            assert td == jd and ttr == jtr, (episode, t)
            for i in range(agents):
                k = f"{i}"
                np.testing.assert_allclose(tr[k], jr[k], rtol=RTOL, atol=RTOL)
                np.testing.assert_allclose(to[k], jo[k], rtol=0, atol=1e-6)
                assert ti[k].get("placement") == ji[k].get("placement")
                assert (ti[k]["crashed"], ti[k]["finished"]) == \
                    (ji[k]["crashed"], ji[k]["finished"])
            if jd["__all__"]:
                assert "placement" in ti["0"]
                break
        assert jd["__all__"], f"episode {episode} did not end"


class _Stream:
    """A fixed opponent: the next action of a seeded stream, whatever it sees."""

    def __init__(self, seed):
        self.rng = np.random.RandomState(seed)

    def __call__(self, obs):
        return self.rng.uniform([-1.0, 0.0], [1.0, 1.0]).astype(np.float32)


def _wrappers(agents=2):
    cps = _cps()
    kw = dict(num_agents=agents, num_sensors=11, track_pool=cps, track_id=2, track_width=7.0)
    return (jga.SelfPlayWrapper(_cone(jga.MultiRacingEnv(**kw))),
            tga.SelfPlayWrapper(_cone(tga.MultiRacingEnv(**kw, device="cpu"))))


def test_selfplay_wrapper_lockstep_with_jax():
    jw, tw = _wrappers()
    assert tw.action_space == jw.action_space
    assert tw.observation_space == jw.observation_space
    jw.set_opponent(_Stream(5))
    tw.set_opponent(_Stream(5))
    rng = np.random.RandomState(2)
    dones = 0
    np.random.seed(7)
    jo, ji = jw.reset()
    np.random.seed(7)
    to, ti = tw.reset()
    for t in range(300):
        a = rng.uniform([-0.5, 0.0], [0.5, 1.0]).astype(np.float32)
        jo, jr, jd, jtr, ji = jw.step(a)
        to, tr, td, ttr, ti = tw.step(a)
        assert (td, ttr) == (jd, jtr), t
        np.testing.assert_allclose(tr, jr, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(to, jo, rtol=0, atol=1e-6)
        _assert_info({k: v for k, v in ti.items() if k != "placement"},
                     {k: v for k, v in ji.items() if k != "placement"}, f"step {t}")
        assert ti.get("placement") == ji.get("placement")
        if jd:
            dones += 1
            np.random.seed(8 + t)
            jo, _ = jw.reset()
            np.random.seed(8 + t)
            to, _ = tw.reset()
    assert dones >= 1


def test_policy_opponent_matches_jax_at_vanishing_noise():
    """The (params, log_std) opponent at log_std -30 on the observations of a
    seeded episode: the port's action is JAX's within 1e-6, and repeats."""
    jparams, _ = jload_policy(MULTI_MODEL)
    tparams, _ = tload_policy(MULTI_MODEL, device="cpu")
    log_std = np.full((2,), -30.0, np.float32)
    jw, tw = _wrappers()
    jw.set_opponent((jparams, jnp.asarray(log_std)))
    tw.set_opponent((tparams, torch.as_tensor(log_std)))
    np.random.seed(3)
    jw.reset()
    rng = np.random.RandomState(4)
    seen = []
    for _ in range(120):
        _, _, done, _, _ = jw.step(rng.uniform([-0.3, 0.5], [0.3, 1.0]))
        seen.append(jw.last_obs_dict["1"])
        if done:
            break
    got = np.stack([tw._opponent_action(o) for o in seen])
    want = np.stack([np.asarray(jw._opponent_action(o)) for o in seen])
    assert got.dtype == np.float32 and got.shape == (len(seen), 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert np.abs(got).max() > 0.05  # the policy acts
    np.testing.assert_array_equal(np.stack([tw._opponent_action(o) for o in seen]), got)
    # numpy parameters (the JAX package's pytree) are taken as well
    tw.set_opponent((jparams, log_std))
    np.testing.assert_allclose(tw._opponent_action(seen[0]), got[0], rtol=0, atol=1e-6)


@contextlib.contextmanager
def _adapter_without_gymnasium(monkeypatch):
    """The adapter module imported afresh with gymnasium unimportable."""
    name = "self_play_racing_tpu_torch.envs.gym_adapter"
    monkeypatch.setitem(sys.modules, "gymnasium", None)
    monkeypatch.delitem(sys.modules, name)
    import self_play_racing_tpu_torch.envs as envs_pkg

    monkeypatch.setattr(envs_pkg, "gym_adapter", tga)
    mod = importlib.import_module(name)
    try:
        yield mod
    finally:
        sys.modules[name] = tga


def test_stand_in_spaces_equal_gymnasiums(monkeypatch):
    with _adapter_without_gymnasium(monkeypatch) as mod:
        assert not mod._GYM and mod.gym.Env is not gym.Env
        single = mod.RacingEnv(num_sensors=11, device="cpu")
        multi = mod.MultiRacingEnv(num_agents=3, num_sensors=11, device="cpu")
        wrapper = mod.SelfPlayWrapper(
            mod.MultiRacingEnv(num_agents=2, num_sensors=11, device="cpu"))
        stats = mod.EpisodeStatistics(single)
        # the adapters run on the stand-ins: a reset and a step, random opponents
        np.random.seed(0)
        obs, _ = wrapper.reset()
        obs, *_ = wrapper.step(wrapper.action_space.sample())
        assert obs.shape == wrapper.observation_space.shape
        stats.reset()
        stats.step(np.zeros(2, np.float32))
    want_single = tga.RacingEnv(num_sensors=11, device="cpu")
    want_multi = tga.MultiRacingEnv(num_agents=3, num_sensors=11, device="cpu")
    pairs = [(single.action_space, want_single.action_space),
             (single.observation_space, want_single.observation_space),
             (stats.observation_space, want_single.observation_space),
             (wrapper.action_space, want_multi.action_space["0"])]
    assert list(multi.action_space.keys()) == list(want_multi.action_space.keys())
    for k in want_multi.action_space.keys():
        pairs += [(multi.action_space[k], want_multi.action_space[k]),
                  (multi.observation_space[k], want_multi.observation_space[k])]
    for got, want in pairs:
        assert isinstance(want, gym.spaces.Box) and not isinstance(got, gym.spaces.Box)
        assert (got.shape, got.dtype) == (want.shape, want.dtype)
        np.testing.assert_array_equal(got.low, want.low)
        np.testing.assert_array_equal(got.high, want.high)
        assert got.low.dtype == want.low.dtype == np.float32
        draw = got.sample()
        assert draw.shape == want.shape and draw.dtype == want.dtype
        assert ((draw >= got.low) & (draw <= got.high)).all()
    # without gymnasium the random opponent draws what the JAX adapter draws
    np.random.seed(11)
    draw = pairs[3][0].sample()
    np.random.seed(11)
    np.testing.assert_array_equal(
        draw, np.random.uniform([-1.0, 0.0], [1.0, 1.0]).astype(np.float32))


def test_episode_statistics_match_gymnasiums():
    cps = _cps()
    kw = dict(num_sensors=11, track_pool=cps, track_id=0, track_width=7.0, device="cpu")
    ours = tga.EpisodeStatistics(tga.RacingEnv(**kw))
    theirs = gym.wrappers.RecordEpisodeStatistics(tga.RacingEnv(**kw))
    rng = np.random.RandomState(6)
    ours.reset()
    theirs.reset()
    episodes = 0
    for _ in range(400):
        a = rng.uniform([-1.0, 0.0], [1.0, 1.0])
        *_, oterm, otrunc, oinfo = ours.step(a)
        *_, tterm, ttrunc, tinfo = theirs.step(a)
        assert (oterm, otrunc) == (tterm, ttrunc)
        assert ("episode" in oinfo) == ("episode" in tinfo) == (oterm or otrunc)
        if oterm or otrunc:
            episodes += 1
            assert oinfo["episode"]["r"] == tinfo["episode"]["r"]
            assert oinfo["episode"]["l"] == tinfo["episode"]["l"]
            assert oinfo["episode"]["t"] >= 0.0
            ours.reset()
            theirs.reset()
    assert episodes >= 2


def test_launch_plans_take_a_batch_of_one(monkeypatch):
    """The adapters' kernel calls at N = 1 pass the wrappers' checks and reach the
    launch with one row: K1 (rays [1, 11]), the multi-car sensing ([1, 2] cars) and
    the transition (cars [1] and [1, 2], the latter with the pair test)."""
    calls = []
    monkeypatch.setattr(_cuda, "_call", lambda stem, fn, dev, *args: calls.append((fn, args)))
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    env = tga.RacingEnv(num_sensors=11, dtype=torch.float32, device="cpu")
    tr = env.track
    s, w = tr.seg_sx.shape[-1], tr.wp_x.shape[-1]
    f = lambda *shape: torch.zeros(shape, dtype=torch.float32)
    geo._raycast_walls_cuda(*(f(1, 11),) * 4, *(f(1, 1, s),) * 4, 50.0, None)
    fn, args = calls[-1]
    assert fn == "raycast_walls_f32" and args[11] == 1
    geo._raycast_walls_and_cars_cuda(f(1, 2), f(1, 2), f(1, 2), f(11), *(f(1, s),) * 5,
                                     2.0, 1.0, 50.0)
    assert calls[-1][1][11] == 1
    single = [f(1)] * 5 + [torch.zeros((1,), dtype=torch.bool)] + [f(1)] * 2
    dynamics._car_step_and_query_cuda(*single, 0.05, dynamics.DEFAULT_CAR,
                                      *(f(1, w),) * 4, torch.ones((1,), dtype=torch.int32),
                                      f(1))
    pair = [f(1, 2)] * 5 + [torch.zeros((1, 2), dtype=torch.bool)] + [f(1, 2)] * 2
    dynamics._car_step_and_query_cuda(*pair, 0.05, dynamics.DEFAULT_CAR,
                                      *(f(1, 1, w),) * 4,
                                      torch.ones((1, 1), dtype=torch.int32), f(1, 1),
                                      collision_speed_scale=0.92)
    assert len(calls) == 4
    assert _cuda.raycast_walls_plan(11, s).threads == 32
    assert _cuda.car_step_query_plan(2, w).threads == 64


def test_dtype_rule_and_device():
    assert tga._resolve_dtype(None, torch.device("cpu")) == torch.float64
    assert tga._resolve_dtype(None, torch.device("cuda")) == torch.float32
    assert tga._resolve_dtype(torch.float64, torch.device("cuda")) == torch.float64
    env = tga.RacingEnv(num_sensors=11, dtype=torch.float32, device="cpu")
    assert env.track.wp_x.dtype == torch.float32
    obs, _ = env.reset()
    assert obs.dtype == np.float32 and obs.shape == (15,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tga.RacingEnv()


def test_adapters_are_package_exports():
    from self_play_racing_tpu_torch import MultiRacingEnv, RacingEnv, SelfPlayWrapper

    assert (RacingEnv, MultiRacingEnv, SelfPlayWrapper) == \
        (tga.RacingEnv, tga.MultiRacingEnv, tga.SelfPlayWrapper)
    assert {"RacingEnv", "MultiRacingEnv", "SelfPlayWrapper"} <= set(port.__all__)
    assert issubclass(tga.RacingEnv, gym.Env) and issubclass(tga.SelfPlayWrapper, gym.Wrapper)
    assert ttrack.DEFAULT_TRACK_WIDTH == jtrack.DEFAULT_TRACK_WIDTH

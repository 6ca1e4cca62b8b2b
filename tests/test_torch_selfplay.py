"""The port's self-play view, its update step and the self-play trainer against the
JAX package, on the CPU.

- ``opponent_actions`` with one shared pool index and with one index per env, with
  and without per-member observation normalization, at float64, on JAX's own
  normal and uniform draws: within rtol 1e-12 / atol 1e-12 (the pool's matrix
  products sum in another order; tanh rounds differently in XLA's and PyTorch's
  CPU math); ``opponent_actions_all_seats`` flattens the seats env-major.
- The deferred transition plus ``refresh`` at A = 2 and 3 for 60 steps, fed JAX's
  draws (start-grid slots and opponent noise, through the port's two draw
  functions): observations within 1e-6 absolute, states and rewards within rtol
  1e-9, done flags exact (float64 tracks and pool; cos/sin drift by a few ulps).
  The opponents act on the cached float32 observations, which that drift can move
  by a float32 ulp, so each transition starts from JAX's cache.
- One whole self-play ``update_step`` (8 envs x 64 steps, float64 tracks, learner
  and pool, per-env and shared opponents, with the stats tail, and with
  ``reset_envs_each_update``'s stale observations), fed JAX's learner noise,
  opponent draws, start-grid slots and permutation constants: the metric vector
  with its "_extra" tail within rtol 1e-5 / atol 1e-6 and the exit decision,
  episode count and win/game counts exact; parameters and Adam moments within
  rtol 1e-6 / atol 1e-7 (as tests/test_torch_trainer.py states for single-car
  training).
- The env tests here sense over a cone of +-1.5 rad, not the default +-pi/2: the
  start grid's sideways rays at +-pi/2 run exactly through a boundary vertex,
  where a one-ulp difference of cos (XLA's and PyTorch's CPU math round it
  differently) decides hit or miss, and a learner acting on such a ray leaves the
  lockstep. tests/test_torch_multi_env.py holds the default cone to JAX and counts
  those rays.
- ``select_opponent`` and ``opponent_weights`` equal JAX's exactly (one
  ``np.random.RandomState`` stream) for uniform and PFSP sampling, both index modes.
- Snapshot timing, ring slots and the frozen log_std over 20 updates, exact.
- ``train.main(["multi", ...])`` and ``["scale", ...]`` run at toy size.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.self_play import SelfPlayTrainer as JSelfPlayTrainer
from self_play_racing_tpu.agent.self_play import make_selfplay_hooks as jhooks
from self_play_racing_tpu.configs import self_play_config as jself_play_config
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import selfplay as jsp
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.models import actor_critic as jnet
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer, make_selfplay_hooks
from self_play_racing_tpu_torch.configs import self_play_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import selfplay as tsp
from self_play_racing_tpu_torch.envs import track as ttrack

RTOL = 1e-9
CONE = 1.5  # sensor cone of the env tests (see the module docstring)


# ------------------------------------------------------------------ helpers

def _jax_pool(p, obs_dim, normalize, seed=0, dtype=jnp.float64, scale=30.0):
    """A stacked JAX pool of ``p`` random members (weights scaled by ``scale`` so
    the members' actions differ)."""
    members = [jnet.init_params(jax.random.key(seed + i), obs_dim, 2) for i in range(p)]
    params = jax.tree.map(lambda *xs: jnp.stack(xs).astype(dtype) * scale, *members)
    rng = np.random.default_rng(seed)
    pool = {"params": params,
            "log_std": jnp.asarray(rng.uniform(-1.5, -0.3, (p, 2)), jnp.float32)}
    if normalize:
        pool["norm_mean"] = jnp.asarray(rng.normal(0, 0.3, (p, obs_dim)), jnp.float32)
        pool["norm_var"] = jnp.asarray(rng.uniform(0.2, 2.0, (p, obs_dim)), jnp.float32)
    return pool


def _port_opp(jopp):
    pool = interop.pool_from_jax(jax.tree.map(np.asarray, {
        k: v for k, v in jopp.items() if k in ("params", "log_std", "norm_mean", "norm_var")
        and v is not None}), device="cpu")
    return {**pool, "norm_mean": pool.get("norm_mean"), "norm_var": pool.get("norm_var"),
            "idx": torch.as_tensor(np.asarray(jopp["idx"])),
            "use_policy": torch.as_tensor(np.asarray(jopp["use_policy"]))}


def _jax_randoms(key, rows, dtype=jnp.float64):
    """JAX's opponent draws from a transition key: (normal, [0, 1) uniforms)."""
    k_noise, k_rand = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_noise, (rows, 2), dtype)),
            np.asarray(jax.random.uniform(k_rand, (rows, 2), dtype)))


def _jax_slots(key, n, a):
    """JAX's start-grid slots from a reset key."""
    order = jax.vmap(lambda k: jax.random.permutation(k, a))(jax.random.split(key, n))
    return np.asarray(jnp.argsort(order, axis=-1))


class _Feed:
    """Replaces the port's two draw functions with queues of JAX's draws."""

    def __init__(self, monkeypatch):
        self.slots, self.randoms = [], []
        monkeypatch.setattr(tmulti, "random_grid_slots", self._slots)
        monkeypatch.setattr(tsp, "opponent_randoms", self._randoms)

    def _slots(self, n, a, generator, device=None):
        got = self.slots.pop(0)
        assert got.shape == (n, a)
        return torch.as_tensor(got)

    def _randoms(self, generator, rows, dtype, device):
        noise, uniforms = self.randoms.pop(0)
        assert noise.shape == (rows, 2)
        return torch.as_tensor(noise, dtype=dtype), torch.as_tensor(uniforms, dtype=dtype)


def _tracks(n, n_tracks=4, seed=5, width=6.0):
    widths = [width + (i % 4) for i in range(n_tracks)]
    ids = np.arange(n) % n_tracks
    np.random.seed(seed)  # gen_tracks draws each track's shape from the global RNG
    cps = jtrack.gen_tracks(n_tracks, seed=seed)
    jp = jtrack.make_track_pool(cps, widths, dtype=jnp.float64)
    tp = ttrack.make_track_pool(cps, widths, dtype=torch.float64, device="cpu")
    return jtrack.gather_tracks(jp, ids), ttrack.gather_tracks(tp, ids)


# ------------------------------------------------------- opponent actions

@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
def test_opponent_actions_match_jax(shared, normalize):
    n, d, p = 64, 19, 3
    rng = np.random.default_rng(int(shared) + 2 * int(normalize))
    jpool = _jax_pool(p, d, normalize)
    idx = np.int32(2) if shared else rng.integers(0, p, n).astype(np.int32)
    use = np.bool_(True) if shared else rng.random(n) < 0.7
    jopp = {**jpool, "norm_mean": jpool.get("norm_mean"), "norm_var": jpool.get("norm_var"),
            "idx": jnp.asarray(idx), "use_policy": jnp.asarray(use)}
    obs = rng.uniform(-1, 1.5, (n, d)).astype(np.float32)
    key = jax.random.key(7)
    cfg = jmulti.MultiRacingConfig()
    want = np.asarray(jsp.opponent_actions(cfg, jopp, jnp.asarray(obs), key))
    noise, uniforms = _jax_randoms(key, n)
    got = tsp.opponent_actions(tmulti.MultiRacingConfig(), _port_opp(jopp),
                               torch.as_tensor(obs), torch.as_tensor(noise),
                               torch.as_tensor(uniforms))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    if not shared:  # the random rows are uniform draws over [-1, 0]..[1, 1]
        rand = want[~use]
        assert (rand[:, 0] >= -1).all() and (rand[:, 1] >= 0).all()
        assert len({tuple(r) for r in want[use][:, :1].round(6)}) > 10


def test_opponent_actions_all_seats_env_major(monkeypatch):
    n, seats, a = 8, 2, 3
    cfg = jmulti.MultiRacingConfig(num_agents=a)
    d = cfg.obs_dim
    rng = np.random.default_rng(0)
    jpool = _jax_pool(4, d, normalize=True)
    idx, use = rng.integers(0, 4, n).astype(np.int32), rng.random(n) < 0.6
    jopp = {**jpool, "idx": jnp.asarray(idx), "use_policy": jnp.asarray(use)}
    obs = rng.uniform(-1, 1, (n, seats, d)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jsp.opponent_actions_all_seats(cfg, jopp, jnp.asarray(obs), key))
    feed = _Feed(monkeypatch)
    feed.randoms.append(_jax_randoms(key, n * seats))
    got = tsp.opponent_actions_all_seats(tmulti.MultiRacingConfig(num_agents=a),
                                         _port_opp(jopp), torch.as_tensor(obs), None)
    assert got.shape == (n, seats, 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


# ------------------------------------------- deferred transition + refresh

@pytest.mark.parametrize("agents", [2, 3])
def test_deferred_transition_and_refresh_match_jax(agents, monkeypatch):
    n = 12
    feed = _Feed(monkeypatch)
    jtr, ttr = _tracks(n)
    jcfg = jmulti.MultiRacingConfig(num_agents=agents, sensor_cone=CONE)
    tcfg = tmulti.MultiRacingConfig(num_agents=agents, sensor_cone=CONE)
    rng = np.random.default_rng(agents)
    jpool = _jax_pool(3, jcfg.obs_dim, normalize=True)
    jopp = {**jpool, "idx": jnp.asarray(rng.integers(0, 3, n).astype(np.int32)),
            "use_policy": jnp.asarray(rng.random(n) < 0.8)}
    opp = _port_opp(jopp)
    key = jax.random.key(1)
    feed.slots.append(_jax_slots(key, n, agents))
    js = jsp.reset_state_deferred(jcfg, jtr, key)
    js, jobs = jsp.refresh(jcfg, jtr, js)
    ts = tsp.reset_state_deferred(tcfg, ttr, torch.Generator())
    assert not ts.obs_all.any()  # stale until the refresh
    ts, tobs = tsp.refresh(tcfg, ttr, ts)
    jtrans = jax.jit(lambda tr, op, s, a, k: jsp.transition_deferred(jcfg, tr, op, s, a, k))
    jref = jax.jit(lambda tr, s: jsp.refresh(jcfg, tr, s))
    seats = agents - 1
    for t in range(60):
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=1e-6)
        act = rng.uniform(-1, 1, (n, 2))
        k = jax.random.fold_in(key, t)
        feed.randoms.append(_jax_randoms(k, n * seats))
        js, jrew, jdone, jtrunc, jinfo = jtrans(jtr, jopp, js, jnp.asarray(act), k)
        # the opponents act on float32 observations, which a few ulps of cos/sin
        # drift can move by one float32 ulp: they act on JAX's (held to the port's
        # after each refresh below), so the states can be compared at RTOL
        ts.obs_all = sensed = torch.as_tensor(np.asarray(js.obs_all))
        ts, trew, tdone, ttrunc, tinfo = tsp.transition_deferred(tcfg, ttr, opp, ts,
                                                                 torch.as_tensor(act))
        assert ts.obs_all is sensed  # stale until the refresh
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=RTOL, atol=RTOL)
        for f in ("x", "y", "vx", "vy", "progress"):
            np.testing.assert_allclose(getattr(ts.inner, f).numpy(),
                                       np.asarray(getattr(js.inner, f)), rtol=RTOL, atol=RTOL)
        np.testing.assert_array_equal(tinfo["placement"].numpy(), np.asarray(jinfo["placement"]))
        js, jobs = jref(jtr, js)
        ts, tobs = tsp.refresh(tcfg, ttr, ts)
        np.testing.assert_allclose(ts.obs_all.numpy(), np.asarray(js.obs_all), rtol=0,
                                   atol=1e-6)
    assert not feed.randoms and not feed.slots


# ----------------------------------------------------- the whole update step

def _draws(runner_key, vec_key, cfg, n, a, reset_each):
    """JAX's random inputs to one self-play update_step: learner noise [T, N, 2],
    permutation constants [E, 1, 8], and the queues of start-grid slots and
    opponent draws in the order the port asks for them."""
    slots, randoms = [], []
    key = runner_key
    if reset_each:
        key, k_env, vec_key = jax.random.split(key, 3)
        slots.append(_jax_slots(k_env, n, a))
    noise = []
    for _ in range(cfg.num_steps):
        key, akey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(akey, (n, 2), jnp.float64)))
        vec_key, reset_key, step_key = jax.random.split(vec_key, 3)
        randoms.append(_jax_randoms(step_key, n * (a - 1)))
        slots.append(_jax_slots(reset_key, n, a))
    _, ukey = jax.random.split(key)
    consts = jax.vmap(lambda k: jax.random.bits(k, (8,), jnp.uint32))(
        jax.random.split(ukey, cfg.update_epochs))
    return (np.stack(noise), np.asarray(consts).astype(np.int64)[:, None], slots, randoms)


UPDATE_CASES = {
    "per_env": dict(opponent_per_env=True, reset_envs_each_update=False),
    "shared_reset_each_update": dict(opponent_per_env=False, reset_envs_each_update=True),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_selfplay_update_step_matches_jax_f64(case, monkeypatch):
    n, a, p = 8, 2, 3
    kw = dict(num_envs=n, num_steps=64, num_minibatches=4, update_epochs=3,
              shuffle_block_size=4, total_timesteps=n * 64 * 5, kl_target=0.5,
              learning_rate=1e-3, **UPDATE_CASES[case])
    cfg, jcfg = self_play_config(**kw), jself_play_config(**kw)
    env_cfg = jmulti.MultiRacingConfig(num_agents=a, sensor_cone=CONE)
    tenv_cfg = tmulti.MultiRacingConfig(num_agents=a, sensor_cone=CONE)
    jtr, ttr = _tracks(n, width=3.5)  # narrow: both cars of a race crash within a rollout
    rng = np.random.default_rng(0)
    jpool = _jax_pool(p, env_cfg.obs_dim, normalize=False, seed=3, scale=3.0)
    shape = (n,) if cfg.opponent_per_env else ()
    jopp = {**jpool, "norm_mean": None, "norm_var": None,
            "idx": jnp.asarray(rng.integers(0, p, shape).astype(np.int32)),
            "use_policy": jnp.asarray(np.ones(shape, bool))}
    jaux = {"track": jtr, "opp": jopp}
    taux = {"track": ttr, "opp": _port_opp(jopp)}

    hooks = jhooks(env_cfg, p)
    jrunner = jppo.init_runner(jax.random.key(3), jcfg, hooks, jaux, env_cfg.obs_dim, 2)
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), jrunner.train.params)
    opt_state = jppo.make_optimizer(jcfg).init(params)
    jrunner = jrunner.replace(train=jrunner.train.replace(params=params, opt_state=opt_state))
    jstep = jax.jit(jppo.make_update_step(jcfg, hooks, 2))

    feed = _Feed(monkeypatch)
    k_env = jax.random.split(jax.random.key(3), 4)[1]
    feed.slots.append(_jax_slots(k_env, n, a))
    thooks = make_selfplay_hooks(tenv_cfg, p)
    runner = tppo.init_runner(torch.Generator().manual_seed(0), cfg, thooks, taux,
                              tenv_cfg.obs_dim, 2)
    np.testing.assert_allclose(runner.obs.numpy(), np.asarray(jrunner.obs), atol=1e-6)
    runner.train = interop.train_state_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state), 0,
        dtype=torch.float64, device="cpu")
    step = tppo.make_update_step(cfg, thooks)

    # the stale-observation reset only shows from the second update on
    for _ in range(2):
        noise, consts, feed.slots, feed.randoms = _draws(
            jrunner.key, jrunner.vec.key, cfg, n, a, cfg.reset_envs_each_update)
        jrunner, jpacked = jstep(jrunner, jaux)
        runner, packed = step(runner, taux, noise=torch.as_tensor(noise),
                              perm_consts=torch.as_tensor(consts))
        assert not feed.slots and not feed.randoms

    m, jm = tppo.unpack_metrics(packed), jppo.unpack_metrics(jpacked)
    assert m.keys() == jm.keys() and "_extra" in m and m["_extra"].shape == (2 * p,)
    for k in ("update", "global_step", "lr", "log_std", "episodes", "kl_stopped",
              "minibatches_applied"):
        assert m[k] == jm[k], k
    np.testing.assert_array_equal(m["_extra"], jm["_extra"])  # wins and games
    assert m["episodes"] > 0 and m["_extra"][p:].sum() == m["episodes"]
    np.testing.assert_allclose(packed, np.asarray(jpacked), rtol=1e-5, atol=1e-6)
    p_, adam, _ = interop.train_state_to_numpy(runner.train)
    jadam = jrunner.train.opt_state[1]
    for got, want in zip(jax.tree.leaves((p_, adam["mu"], adam["nu"])),
                         jax.tree.leaves((jrunner.train.params, jadam.mu, jadam.nu))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(runner.done.numpy(), np.asarray(jrunner.done))
    np.testing.assert_allclose(runner.obs.numpy(), np.asarray(jrunner.obs), atol=1e-5)


# --------------------------------------------------------- the trainer

def _pair(**kw):
    """The JAX and the port's SelfPlayTrainer on one toy config and track."""
    base = dict(num_envs=4, num_steps=16, num_minibatches=2, update_epochs=2,
                total_timesteps=4 * 16 * 40)
    base.update(kw)
    env_cfg = jmulti.MultiRacingConfig(num_agents=2)
    np.random.seed(1)
    cps = jtrack.gen_tracks(2, seed=1)
    jtr = jtrack.gather_tracks(jtrack.make_track_pool(cps, 7.0), np.arange(4) % 2)
    ttr = ttrack.gather_tracks(ttrack.make_track_pool(cps, 7.0, device="cpu"),
                               np.arange(4) % 2)
    return (JSelfPlayTrainer(jself_play_config(**base), env_cfg, jtr),
            SelfPlayTrainer(self_play_config(**base), tmulti.MultiRacingConfig(num_agents=2),
                            ttr))


@pytest.mark.parametrize("sampling", ["uniform", "pfsp"])
def test_select_opponent_and_weights_match_jax(sampling):
    for per_env in (False, True):
        jt, tt = _pair(opponent_sampling=sampling, opponent_per_env=per_env)
        rng = np.random.default_rng(1)
        for step in range(12):
            wins = rng.integers(0, 5, 5).astype(np.float64)
            games = wins + rng.integers(0, 4, 5)
            for tr in (jt, tt):
                tr.num_snapshots = min(step // 2, 5)
                tr.pool_wins, tr.pool_games = wins.copy(), games.copy()
            count = tt.pool_count
            if count:
                np.testing.assert_array_equal(tt.opponent_weights(), jt.opponent_weights())
            jt.select_opponent()
            tt.select_opponent()
            jo, to = jt.aux["opp"], tt.aux["opp"]
            np.testing.assert_array_equal(to["idx"].numpy(), np.asarray(jo["idx"]))
            np.testing.assert_array_equal(to["use_policy"].numpy(), np.asarray(jo["use_policy"]))
            assert to["idx"].shape == ((4,) if per_env else ())


def test_snapshot_timing_over_20_updates():
    _, tr = _pair(snapshot_freq=3, pool_size=4, total_timesteps=4 * 16 * 40,
                  opponent_per_env=True, reset_envs_each_update=False)
    seen = []
    pre = tr._pre_update

    def spy():
        pre()
        seen.append((tr._host_update, tr.num_snapshots, tr.pool_count,
                     tr.pool["log_std"][:, 0].tolist()))
    tr._pre_update = spy
    tr.train(num_updates=20)
    # a snapshot at the top of updates 3, 6, ..., 18; the ring of 4 wraps at 15
    want_snaps = [u // 3 for u in range(20)]
    assert [s[1] for s in seen] == want_snaps
    assert [s[2] for s in seen] == [min(k, 4) for k in want_snaps]
    jcfg = jself_play_config(num_envs=4, num_steps=16, num_minibatches=2, update_epochs=2,
                             total_timesteps=4 * 16 * 40, snapshot_freq=3, pool_size=4)
    frozen = {}
    for u in range(3, 20, 3):
        frozen[(u // 3 - 1) % 4] = float(jppo.anneal_fractions(jcfg, jnp.asarray(u - 1))[2][0])
    final = seen[-1][3]
    for slot, ls in frozen.items():
        assert np.float32(final[slot]) == np.float32(ls), slot  # the buffer's log_std
    assert len(tr.training_info["opponent_pool_size"]) == len(tr.training_info["steps"])
    assert tr.pool_games.sum() > 0  # the stats hook fed PFSP's counters


def test_train_main_multi_and_scale(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tr = ttrain.main(["multi", "--num-envs", "2", "--total-timesteps", str(2 * 2048 * 2),
                      "--num-updates", "1", "--seed", "4", "--device", "cpu"])
    assert tr.cfg.num_steps == 2048 and not tr.cfg.opponent_per_env
    assert tr.cfg.reset_envs_each_update and tr.runner.train.update == 1
    params, _, _ = tevaluate.load_policy_bundle("models/self_play_agent.npz", device="cpu")
    assert params["actor"][0][0].shape == (19, 64)
    info = json.loads((tmp_path / "data" / "training_info_self_play.json").read_text())
    assert set(info) == {"steps", "rewards", "opponent_pool_size", "pool_win_rate"}

    tr = ttrain.main(["scale", "--num-envs", "8", "--total-timesteps", str(8 * 256 * 3),
                      "--num-updates", "2", "--agents", "3", "--pfsp", "--device", "cpu"])
    assert tr.cfg.opponent_per_env and not tr.cfg.reset_envs_each_update
    assert tr.cfg.opponent_sampling == "pfsp" and tr.env_cfg.num_agents == 3
    assert tr.runner.train.update == 2
    assert tr.aux["track"].wp_x.shape[0] == 8
    params, _, _ = tevaluate.load_policy_bundle("models/self_play_agent_scale_1B.npz",
                                                device="cpu")
    assert params["actor"][0][0].shape == (23, 64)
    assert (tmp_path / "data" / "training_info_self_play_scale_1B.json").exists()

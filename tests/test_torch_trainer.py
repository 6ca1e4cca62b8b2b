"""The port's PPO update step, trainer and ``train`` entry point against the JAX
package, on the CPU.

- One whole ``update_step`` (rollout, GAE, update, packed metrics) at 8 envs x 64
  steps in float64 (tracks and parameters), fed JAX's action noise and permutation
  constants, with and without observation normalization. Observations are float32
  on both sides and cos/sin round differently in XLA's and PyTorch's CPU math, so
  a few observations land one float32 ulp apart (and the normalizer's float32
  statistics are summed in another order). Adam divides by sqrt(nu), so such a
  difference can move a near-zero gradient's step by ~1e-4 of lr = 1e-3:
  parameters and Adam moments rtol 1e-6 / atol 1e-7; the float32 metric vector rtol 1e-5 / atol 1e-6, with the exit
  decision, the anneals and the episode count exact.
- A CPU smoke run learns (late return > early + 10), as tests/test_train_smoke.py
  asks of the JAX trainer.
- Policies move both ways: a port-trained ``.npz`` reads back through the JAX
  package's ``load_policy_bundle`` to the same arrays, and the JAX package's file
  loads into the port's trainer unchanged (exact).
- ``make_training_pool`` equals the JAX package's bitwise; ``train.main(["single",
  ...])`` runs at toy size; the SB3 modes reach their legs.
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu import train as jtrain
from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.trainer import make_single_env_hooks as jhooks
from self_play_racing_tpu.configs import base_config as jbase_config
from self_play_racing_tpu.envs import single as jenv
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.evaluate import load_policy_bundle as jload
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent.trainer import (DivergenceError, PPOTrainer,
                                                      make_single_env_hooks)
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.envs import single as tenv
from self_play_racing_tpu_torch.envs import track as ttrack

MODEL = "models/single_agent.npz"


def _jax_draws(key, steps, envs, epochs):
    """JAX's action noise [T, N, 2] and permutation constants [E, 1, 8] for one
    update_step from the runner's key (the rollout's split chain, then ukey)."""
    noise = []
    for _ in range(steps):
        key, akey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(akey, (envs, 2), jnp.float64)))
    _, ukey = jax.random.split(key)
    ekeys = jax.random.split(ukey, epochs)
    consts = jax.vmap(lambda k: jax.random.bits(k, (8,), jnp.uint32))(ekeys)
    return np.stack(noise), np.asarray(consts).astype(np.int64)[:, None]


UPDATE_STEP_CASES = {
    "plain": {},
    "normalize_obs": dict(normalize_obs=True),
    # the reference's stale next_obs/next_done after a forced reset of every env
    "reset_envs_each_update": dict(reset_envs_each_update=True),
    "speed_weight_aux": {},  # the {"track", "speed_weight"} aux of the annealed variant
}


@pytest.mark.parametrize("case", sorted(UPDATE_STEP_CASES))
def test_update_step_matches_jax_f64(case):
    kw = dict(num_envs=8, num_steps=64, num_minibatches=4, update_epochs=3,
              shuffle_block_size=4, total_timesteps=8 * 64 * 5, kl_target=0.5,
              learning_rate=1e-3, **UPDATE_STEP_CASES[case])
    cfg, jcfg = base_config(**kw), jbase_config(**kw)
    ids = np.arange(8) % 4
    cps = jtrack.gen_tracks(4, seed=1)
    jtr = jtrack.gather_tracks(jtrack.make_track_pool(cps, [4.0] * 4, dtype=jnp.float64), ids)
    ttr = ttrack.gather_tracks(ttrack.make_track_pool(cps, [4.0] * 4, dtype=torch.float64,
                                                      device="cpu"), ids)
    env_cfg = jenv.RacingConfig(num_sensors=11)
    jaux, taux = jtr, ttr
    if case == "speed_weight_aux":
        jaux = {"track": jtr, "speed_weight": jnp.float32(11.5)}
        taux = {"track": ttr, "speed_weight": torch.tensor(11.5, dtype=torch.float32)}

    hooks = jhooks(env_cfg)
    jrunner = jppo.init_runner(jax.random.key(3), jcfg, hooks, jtr, 15, 2)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jrunner.train.params)
    opt_state = jppo.make_optimizer(jcfg).init(params)
    jrunner = jrunner.replace(train=jrunner.train.replace(params=params, opt_state=opt_state))
    jstep = jax.jit(jppo.make_update_step(jcfg, hooks, 2))

    runner = tppo.init_runner(torch.Generator().manual_seed(0), cfg,
                              make_single_env_hooks(tenv.RacingConfig(num_sensors=11)),
                              ttr, 15, 2)
    np.testing.assert_allclose(runner.obs.numpy(), np.asarray(jrunner.obs), rtol=1e-6)
    runner.train = interop.train_state_from_jax(
        jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt_state), 0,
        dtype=torch.float64, device="cpu")
    step = tppo.make_update_step(cfg, make_single_env_hooks(tenv.RacingConfig(num_sensors=11)))

    # the forced reset only shows from the second update on (stale obs, fresh envs)
    updates = 2 if cfg.reset_envs_each_update else 1
    for _ in range(updates):
        key = jrunner.key
        if cfg.reset_envs_each_update:  # update_step splits the reset's keys first
            key = jax.random.split(key, 3)[0]
        noise, consts = _jax_draws(key, cfg.num_steps, cfg.num_envs, cfg.update_epochs)
        jrunner, jpacked = jstep(jrunner, jaux)
        runner, packed = step(runner, taux, noise=torch.as_tensor(noise),
                              perm_consts=torch.as_tensor(consts))

    assert packed.dtype == np.float32 and packed.shape == (len(tppo.METRIC_NAMES),)
    m, jm = tppo.unpack_metrics(packed), jppo.unpack_metrics(jpacked)
    assert m.keys() == jm.keys()
    for k in ("update", "global_step", "lr", "log_std", "episodes", "kl_stopped",
              "minibatches_applied"):
        assert m[k] == jm[k], k
    assert m["episodes"] > 0 and m["minibatches_applied"] == 12
    np.testing.assert_allclose(packed, np.asarray(jpacked), rtol=1e-5, atol=1e-6)

    assert runner.train.update == int(jrunner.train.update) == updates
    p, adam, _ = interop.train_state_to_numpy(runner.train)
    jadam = jrunner.train.opt_state[1]
    assert adam["count"] == int(jadam.count) == 12 * updates
    for got, want in zip(jax.tree.leaves((p, adam["mu"], adam["nu"])),
                         jax.tree.leaves((jrunner.train.params, jadam.mu, jadam.nu))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(runner.done.numpy(), np.asarray(jrunner.done))
    np.testing.assert_allclose(runner.obs.numpy(), np.asarray(jrunner.obs), rtol=1e-5,
                               atol=1e-6)
    if cfg.normalize_obs:
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(runner.obs_norm, k).numpy(),
                                       np.asarray(getattr(jrunner.obs_norm, k)), rtol=1e-5)


def _toy_trainer(num_envs=4, num_steps=32, updates=2, **kw):
    cfg = base_config(num_envs=num_envs, num_steps=num_steps, num_minibatches=2,
                      update_epochs=2, total_timesteps=num_envs * num_steps * updates, **kw)
    track = ttrack.gather_tracks(ttrack.default_track_pool(device="cpu"), [0] * num_envs)
    return PPOTrainer(cfg, tenv.RacingConfig(num_sensors=11), track)


def test_ppo_smoke_learns():
    num_envs = 16
    cfg = base_config(num_envs=num_envs, num_steps=256, num_minibatches=8,
                      update_epochs=4, total_timesteps=16 * 256 * 12)
    pool = ttrack.make_track_pool(ttrack.gen_tracks(4, seed=1), [8.0] * 4, device="cpu")
    track = ttrack.gather_tracks(pool, np.arange(num_envs) % 4)
    info = PPOTrainer(cfg, tenv.RacingConfig(num_sensors=11), track).train()
    rewards = info["rewards"]
    assert len(rewards) >= 8
    early, late = np.mean(rewards[:3]), np.mean(rewards[-3:])
    assert late > early + 10, f"no learning signal: early={early:.1f} late={late:.1f}"
    assert np.isfinite(rewards).all()


def test_trainer_hooks_and_buffer_log_std():
    tr = _toy_trainer(updates=3)
    assert torch.equal(tr.buffer_log_std, torch.zeros(2))  # the registration value
    seen = []
    tr.train(on_update=lambda t, m: seen.append((int(m["update"]), t.runner.train.update)))
    # metrics of update u are consumed after update u+1 ran (the last after the loop)
    assert seen == [(0, 2), (1, 3), (2, 3)]
    want = np.asarray(jppo.anneal_fractions(
        jbase_config(total_timesteps=tr.cfg.total_timesteps, num_envs=4, num_steps=32,
                     num_minibatches=2), jnp.asarray(2, jnp.int32))[2])
    np.testing.assert_array_equal(tr.buffer_log_std.numpy(), want)
    np.testing.assert_array_equal(tr.log_std.numpy(), np.asarray(jppo.anneal_fractions(
        jbase_config(total_timesteps=tr.cfg.total_timesteps, num_envs=4, num_steps=32,
                     num_minibatches=2), jnp.asarray(3, jnp.int32))[2]))


def test_pre_update_anneals_speed_weight_and_resamples_tracks():
    tr = _toy_trainer(updates=4, anneal_speed_weight=True)
    assert float(tr.aux["speed_weight"]) == 8.0
    other = ttrack.gather_tracks(ttrack.make_track_pool(ttrack.gen_tracks(1, seed=3), 6.0,
                                                        device="cpu"), [0] * 4)
    calls = []

    def resample(update):
        calls.append(update)
        return other if update == 2 else None

    tr.track_resampler = resample
    tr.train(num_updates=3)
    assert calls == [0, 1, 2] and tr.aux["track"] is other
    # the reference's intended schedule 8 -> 14, set before update 2 of 4
    assert float(tr.aux["speed_weight"]) == 11.0
    tr.set_track(ttrack.gather_tracks(ttrack.default_track_pool(device="cpu"), [0] * 4))
    assert not tr.runner.done.any() and int(tr.runner.vec.env.steps.max()) == 0


def test_divergence_raises_or_warns():
    for mode in ("raise", "warn"):
        tr = _toy_trainer()
        with torch.no_grad():
            for p in tr.runner.train.model.parameters():
                p.mul_(float("nan"))
        if mode == "raise":
            with pytest.raises(DivergenceError, match="non-finite losses at update 1"):
                tr.train()
        else:
            tr.train(on_divergence="warn")


@pytest.mark.parametrize("normalize_obs", [False, True])
def test_save_load_round_trip_and_jax_reads_it(tmp_path, normalize_obs):
    tr = _toy_trainer(updates=1, normalize_obs=normalize_obs)
    tr.train()
    path = str(tmp_path / "agent.npz")
    tr.save(path)
    with np.load(path) as data:
        assert str(data["treedef"]) == str(jax.tree.structure(jppo.init_train_state(
            jax.random.key(0), jbase_config(), 15, 2).params))
        assert ("obs_mean" in data.files) == normalize_obs

    tr2 = _toy_trainer(updates=1, normalize_obs=normalize_obs, seed=5)
    assert not torch.equal(next(tr2.runner.train.model.parameters()),
                           next(tr.runner.train.model.parameters()))
    tr2.load(path)
    for a, b in zip(tr.runner.train.model.parameters(), tr2.runner.train.model.parameters()):
        assert torch.equal(a, b)
    if normalize_obs:
        assert torch.equal(tr2.runner.obs_norm.mean, tr.runner.obs_norm.mean)

    jparams, jlog_std, jnorm = jload(path)
    for a, b in zip(tr.runner.train.model.parameters(), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(jlog_std), tr.buffer_log_std.numpy())
    assert float(jlog_std[0]) == -0.5  # anneal(0) after one update
    assert (jnorm is not None) == normalize_obs
    if normalize_obs:
        np.testing.assert_array_equal(np.asarray(jnorm.count), tr.runner.obs_norm.count.numpy())


def test_port_trainer_loads_jax_policy_file():
    tr = _toy_trainer(num_envs=2, num_steps=8, updates=1)
    tr.load(MODEL)
    jparams, _, _ = jload(MODEL)
    for a, b in zip(tr.runner.train.model.parameters(), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    tr.train()  # and trains on from it


def test_make_training_pool_matches_jax():
    cfg = base_config(num_envs=6, seed=3)
    jtrain._seed_all(cfg.seed)
    want = jtrain.make_training_pool(jbase_config(num_envs=6, seed=3))
    ttrain._seed_all(cfg.seed)
    got = ttrain.make_training_pool(cfg, device="cpu")
    for name in got.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_train_main_single_and_later_modes(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = ttrain.main(["single", "--num-envs", "2", "--total-timesteps", "4096",
                           "--num-updates", "1", "--seed", "4", "--device", "cpu"])
    assert trainer.cfg.num_steps == 2048 and trainer.runner.train.update == 1
    params, log_std, obs_norm = tevaluate.load_policy_bundle("models/single_agent.npz",
                                                             device="cpu")
    assert len(params["actor"]) == 3 and obs_norm is None
    assert float(log_std[0]) == -0.5
    info = json.loads((tmp_path / "data" / "training_info_single.json").read_text())
    assert set(info) == {"steps", "rewards"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(["single", "--num-envs", "2", "--total-timesteps", "4096"])
    # --resample-tracks-every and --pooled-geometry run (tests/test_torch_procgen.py,
    # tests/test_torch_pooled_geometry.py); the SB3 modes run their legs
    # (tests/test_torch_sb3_compat.py runs them): here each reaches its legs
    legs = []
    for leg in ("train_multi", "train_single", "train_single_baseline"):
        monkeypatch.setattr(ttrain, leg, lambda *a, _leg=leg, **kw: legs.append(_leg))
    for args in (["sb3"], ["all"]):
        ttrain.main([*args, "--device", "cpu"])
    assert legs == ["train_single_baseline", "train_multi", "train_single",
                    "train_single_baseline"]

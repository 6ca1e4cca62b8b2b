"""The port's data-parallel self-play, scaling CLI, checkpoints and ``train scale``
over two CPU processes in a gloo group (mirroring tests/test_multihost.py, whose
two JAX processes own 4 virtual devices each).

- One self-play update with per-env opponents and the PFSP stats tail, sharded
  over 2 ranks and fed JAX's draws (start-grid slots, opponent noise and uniforms,
  action noise, the per-shard permutation constants), against the one-process
  update with ``data_shards = 2`` and JAX's update with the runner on 2 virtual
  devices: the win/game counters exact everywhere; parameters and Adam moments rtol
  1e-9 against the one-process run (the order of the sums) and rtol 1e-6 / atol
  1e-7 against JAX, the metric vector rtol 1e-5 / atol 1e-6 (as
  tests/test_torch_selfplay.py states them); every per-minibatch stat rtol 1e-6
  and the exit minibatch exact between the port's runs.
- Three updates of a PFSP trainer (opponents by PFSP weights, observation
  normalization) over 2 ranks against one process: the opponent assignments, the
  counters and the win-rate history equal on both ranks and equal to the
  one-process run's; the float32 state within rtol 1e-5 / atol 1e-6 (the float32
  normalizer moments combined over the ranks).
- The scaling CLI run as 2 processes writes its ``scaling_sweep_v1`` artifact with
  JAX's keys, from rank 0, and each row the minibatches every timed update
  computed and applied; with ``--kl-target inf`` (one process) every update
  computes and applies all update_epochs x num_minibatches.
- A checkpoint written by rank 0 of a sharded run resumes on both ranks, which
  continue alike and as one process resumed from its own checkpoint continues.
- ``train_scale`` over 2 processes shards with ``data_shards = 2`` where the
  minibatch divides (printing JAX's layout line) and with the global shuffle where
  it does not, each run equal to one process's.

Each multi-process run has its own time limit (``run_ranks(timeout=...)``).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.self_play import make_selfplay_hooks as jhooks
from self_play_racing_tpu.configs import self_play_config as jself_play_config
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.parallel import mesh as jmesh
from test_torch_selfplay import CONE, _Feed, _jax_pool, _jax_randoms, _jax_slots, _tracks
from test_torch_dist_workers import (SelfPlayBuild, checkpoint_rank, checkpoint_resume,
                                pfsp_rank, pfsp_train, run_ranks, scaling_rank,
                                train_scale_rank, train_scale_run, update_step_rank)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.configs import base_config, self_play_config
from self_play_racing_tpu_torch.parallel.scaling import main as scaling_main

TIMEOUT = 180  # seconds for a 2-process run


def _close_trees(got, want, rtol, atol=0.0):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


def _draws(runner_key, vec_key, cfg, n, a, shards):
    """JAX's random inputs to one self-play update_step with ``shards`` data
    shards: learner noise [T, N, 2], permutation constants [E, D, 8], and the
    queues of start-grid slots and opponent draws for all N envs."""
    slots, randoms, noise = [], [], []
    key = runner_key
    for _ in range(cfg.num_steps):
        key, akey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(akey, (n, 2), jnp.float64)))
        vec_key, reset_key, step_key = jax.random.split(vec_key, 3)
        randoms.append(_jax_randoms(step_key, n * (a - 1)))
        slots.append(_jax_slots(reset_key, n, a))
    _, ukey = jax.random.split(key)
    ekeys = jax.random.split(ukey, cfg.update_epochs)
    dkeys = jax.vmap(lambda k: jax.random.split(k, shards))(ekeys)
    consts = jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (8,), jnp.uint32)))(dkeys)
    return np.stack(noise), np.asarray(consts).astype(np.int64), slots, randoms


def test_selfplay_update_two_processes_match_one_process_and_jax(monkeypatch):
    n, a, p = 16, 2, 3
    # 64 steps: races on these narrow tracks end within the rollout
    kw = dict(num_envs=n, num_steps=64, num_minibatches=4, update_epochs=2,
              total_timesteps=n * 64 * 4, data_shards=2, kl_target=0.5,
              learning_rate=1e-3, opponent_per_env=True, reset_envs_each_update=False,
              snapshot_freq=1, pool_size=p)
    cfg, jcfg = self_play_config(**kw), jself_play_config(**kw)
    env_cfg = jmulti.MultiRacingConfig(num_agents=a, sensor_cone=CONE)
    jtr, _ = _tracks(n, width=3.5)  # narrow: both cars of a race crash within a rollout
    rng = np.random.default_rng(0)
    jpool = _jax_pool(p, env_cfg.obs_dim, normalize=False, seed=3, scale=3.0)
    jopp = {**jpool, "norm_mean": None, "norm_var": None,
            "idx": jnp.asarray(rng.integers(0, p, (n,)).astype(np.int32)),
            "use_policy": jnp.asarray(np.ones((n,), bool))}
    jaux = {"track": jtr, "opp": jopp}
    hooks = jhooks(env_cfg, p)
    jrunner = jppo.init_runner(jax.random.key(3), jcfg, hooks, jaux, env_cfg.obs_dim, 2)
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), jrunner.train.params)
    opt_state = jppo.make_optimizer(jcfg).init(params)
    jrunner = jrunner.replace(train=jrunner.train.replace(params=params, opt_state=opt_state))
    first_slots = _jax_slots(jax.random.split(jax.random.key(3), 4)[1], n, a)
    noise, consts, slots, randoms = _draws(jrunner.key, jrunner.vec.key, cfg, n, a, 2)
    mesh = jmesh.make_mesh(jax.devices()[:2])
    runner_s, aux_s = jmesh.shard_runner(jrunner, jaux, mesh, n)
    with mesh:
        jout, jpacked = jax.jit(jppo.make_update_step(jcfg, hooks, 2))(runner_s, aux_s)
    jm = jppo.unpack_metrics(jpacked)

    host = lambda t: jax.tree.map(np.asarray, t)
    adam = opt_state[1]
    build = SelfPlayBuild(kw, dict(num_agents=a, sensor_cone=CONE), 3.5, host(params),
                          (int(adam.count), host(adam.mu), host(adam.nu)),
                          {"params": host(jpool["params"]), "log_std": host(jpool["log_std"]),
                           "idx": host(jopp["idx"]), "use_policy": host(jopp["use_policy"])})
    feed = _Feed(monkeypatch)
    feed.slots.append(first_slots)
    one = build()
    feed.slots, feed.randoms = list(slots), list(randoms)
    seen = []
    run = tppo.run_ppo_update
    monkeypatch.setattr(tppo, "run_ppo_update",
                        lambda *args, **kwargs: seen.append(run(*args, **kwargs)) or seen[-1])
    out, packed = one.update_step(one.runner, one.aux, noise=torch.as_tensor(noise),
                                  perm_consts=torch.as_tensor(consts))
    assert not feed.slots and not feed.randoms
    ranks = run_ranks(update_step_rank, 2, build,
                      {"noise": noise, "perm_consts": consts,
                       "slots": [first_slots] + slots, "randoms": randoms},
                      timeout=TIMEOUT)

    m = tppo.unpack_metrics(packed)
    for k in ("update", "global_step", "episodes", "kl_stopped", "minibatches_applied"):
        assert m[k] == jm[k], k
    np.testing.assert_array_equal(m["_extra"], jm["_extra"])  # wins and games
    assert m["episodes"] > 0 and m["_extra"][p:].sum() == m["episodes"]
    np.testing.assert_allclose(packed, np.asarray(jpacked), rtol=1e-5, atol=1e-6)
    p_, adam_, _ = interop.train_state_to_numpy(out.train)
    jadam = jout.train.opt_state[1]
    _close_trees((p_, adam_["mu"], adam_["nu"]), (jout.train.params, jadam.mu, jadam.nu),
                 rtol=1e-6, atol=1e-7)
    for rank, got in enumerate(ranks):
        assert tppo.unpack_metrics(got["packed"])["_extra"].tolist() == m["_extra"].tolist()
        np.testing.assert_allclose(got["packed"], packed, rtol=1e-6, atol=1e-7)
        ustats, want = got["ustats"], seen[0][2]
        np.testing.assert_array_equal(ustats["applied"], want["applied"])
        np.testing.assert_array_equal(ustats["computed"], want["computed"])
        for k in tppo.STAT_NAMES[:6]:
            np.testing.assert_allclose(ustats[k], want[k], rtol=1e-6, atol=1e-7, err_msg=k)
        _close_trees(got["train"][:3], (p_, adam_["mu"], adam_["nu"]), rtol=1e-9,
                     atol=1e-12)
        rows = slice(rank * n // 2, (rank + 1) * n // 2)
        np.testing.assert_array_equal(got["done"], out.done.numpy()[rows])


PFSP = dict(num_envs=16, num_steps=32, num_minibatches=4, update_epochs=2,
            total_timesteps=16 * 32 * 4, snapshot_freq=1, pool_size=3,
            opponent_per_env=True, opponent_sampling="pfsp", normalize_obs=True,
            reset_envs_each_update=False, data_shards=2)


def test_pfsp_trainer_two_processes_match_one_process():
    one = pfsp_train(PFSP)
    ranks = run_ranks(pfsp_rank, 2, PFSP, timeout=TIMEOUT)
    # races end from the second update on, so the third update's PFSP weights
    # come from counted games
    assert one["games"].sum() > one["metrics"][-1]["_extra"][3:].sum() > 0
    assert len(one["metrics"]) == 3 and len(one["win_rate"]) >= 1
    for rank, got in enumerate(ranks):
        np.testing.assert_array_equal(got["wins"], one["wins"])
        np.testing.assert_array_equal(got["games"], one["games"])
        assert got["win_rate"] == one["win_rate"]
        np.testing.assert_array_equal(got["idx"], one["idx"][rank * 8:(rank + 1) * 8])
        for g, w in zip(got["metrics"], one["metrics"]):
            np.testing.assert_array_equal(g["_extra"], w["_extra"])
            assert g["minibatches_applied"] == w["minibatches_applied"]
            assert g["episodes"] == w["episodes"]
        _close_trees(got["train"][:3], one["train"][:3], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["obs_norm"], one["obs_norm"], rtol=1e-5, atol=1e-6)
    _close_trees(ranks[0]["train"][:3], ranks[1]["train"][:3], rtol=0.0)


def test_scaling_cli_two_process_artifact(tmp_path):
    baseline = {
        "schema": "scaling_sweep_v1", "num_processes": 1, "devices_total": 1,
        "rows": [{"devices": 1, "env_steps_per_s": 300.0}],
    }
    (tmp_path / "baseline.json").write_text(json.dumps(baseline))
    results = run_ranks(scaling_rank, 2, str(tmp_path), timeout=TIMEOUT, group=False)
    assert results == [(2, 8), (2, 8)]  # the whole group, 4 envs a device
    art = json.loads((tmp_path / "scaling_2proc.json").read_text())
    assert set(art) == {"schema", "platform", "num_processes", "devices_total",
                        "envs_per_device", "num_steps", "shard_local_minibatch", "rows",
                        "baseline_env_steps_per_s", "efficiency_vs_baseline"}
    assert art["schema"] == "scaling_sweep_v1" and art["platform"] == "cpu"
    assert art["num_processes"] == 2 and art["devices_total"] == 2
    assert len(art["rows"]) == 1 and art["rows"][0]["devices"] == 2
    assert set(art["rows"][0]) == {"devices", "num_envs", "shard_local_minibatch",
                                   "ms_per_update", "env_steps_per_s", "updates_per_s",
                                   "efficiency", "kl_target", "minibatches_computed",
                                   "minibatches_applied"}
    cfg = base_config()
    row = art["rows"][0]
    assert row["kl_target"] == cfg.kl_target
    assert len(row["minibatches_computed"]) == len(row["minibatches_applied"]) == 3
    for computed, applied in zip(row["minibatches_computed"], row["minibatches_applied"]):
        # the KL exit's minibatch is computed and not applied
        assert computed - applied in (0, 1)
        assert 1 <= computed <= cfg.update_epochs * cfg.num_minibatches
    assert art["baseline_env_steps_per_s"] == 300.0
    want = art["rows"][0]["env_steps_per_s"] / (2 * 300.0)
    assert art["efficiency_vs_baseline"] == pytest.approx(want)
    assert art["rows"][0]["shard_local_minibatch"] is True


def test_scaling_cli_without_kl_exit_runs_every_minibatch(tmp_path):
    out = tmp_path / "scaling_1proc.json"
    rows = scaling_main(["--device", "cpu", "--envs-per-device", "4", "--num-steps", "8",
                         "--kl-target", "inf", "--out", str(out)])
    cfg = base_config()
    every = cfg.update_epochs * cfg.num_minibatches
    assert len(rows) == 1 and rows[0]["kl_target"] == float("inf")
    assert rows[0]["minibatches_computed"] == [every] * 3
    assert rows[0]["minibatches_applied"] == [every] * 3
    assert json.loads(out.read_text())["rows"][0]["minibatches_applied"] == [every] * 3


CKPT = dict(num_envs=16, num_steps=8, num_minibatches=2, update_epochs=2,
            total_timesteps=16 * 8 * 4, snapshot_freq=1, pool_size=2, data_shards=2,
            reset_envs_each_update=False, opponent_per_env=True)


def test_two_process_checkpoint_resume(tmp_path):
    ckpt_dir = tmp_path / "ckpt"
    ckpt_dir.mkdir()
    ranks = run_ranks(checkpoint_rank, 2, CKPT, str(ckpt_dir), timeout=TIMEOUT)
    assert (ckpt_dir / "mh_ckpt.npz").exists()
    assert (ckpt_dir / "mh_ckpt.meta.json").exists()
    one_dir = tmp_path / "one"
    one_dir.mkdir()
    one = checkpoint_resume(CKPT, str(one_dir))
    for step, reward, loaded, train in ranks:
        # resumed and continued: 2 updates in all x batch 128
        assert (step, loaded) == (256, 2) == (one[0], one[2])
        np.testing.assert_allclose(reward, one[1], rtol=1e-6)
        _close_trees(train[:3], one[3][:3], rtol=1e-5, atol=1e-6)
    assert ranks[0][:3] == ranks[1][:3]
    _close_trees(ranks[0][3][:3], ranks[1][3][:3], rtol=0.0)


@pytest.mark.parametrize("num_steps,shards", [(4, 2), (6, 1)])
def test_train_scale_two_processes_choose_data_shards(tmp_path, num_steps, shards):
    """8 envs over 2 processes: the minibatch of 4 x 8 / 16 = 2 halves, so the
    envs shard with data_shards = 2; at 6 steps it is 3, and the run keeps the
    global shuffle (the batch gathered on every rank). Either run equals the one
    process run with the same data_shards."""
    kw = dict(num_envs=8, num_steps=num_steps, num_updates=1,
              total_timesteps=8 * num_steps * 4, num_tracks=4)
    ranks = run_ranks(train_scale_rank, 2, kw, str(tmp_path), timeout=TIMEOUT, group=False)
    solo = tmp_path / "solo"
    solo.mkdir()
    # one process with the layout the two chose
    text, one_shards, one_envs, one_train = train_scale_run(
        dict(kw, data_shards=shards), str(solo))
    assert (one_shards, one_envs) == (shards, 8) and "Sharding" not in text
    layout = ("shard-local minibatching (data_shards=2)" if shards == 2 else
              "global-shuffle minibatching (minibatch size not divisible by the "
              "device count)")
    for rank, (out, got_shards, envs, train) in enumerate(ranks):
        assert got_shards == shards and envs == 4
        assert f"Sharding over 2 devices: mesh {{'data': 2}}, {layout}" in out
        assert ("Final model saved" in out) == (rank == 0)
        _close_trees(train[:3], one_train[:3], rtol=1e-5, atol=1e-6)
    assert (tmp_path / "models" / "self_play_agent_scale_1B.npz").exists()

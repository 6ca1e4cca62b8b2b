"""Self-play checkpoints between the port and the JAX package, on the CPU. All exact.

- Format v1 both ways: a checkpoint the port writes loads in the JAX package's
  ``SelfPlayTrainer.load_checkpoint`` (which checks every leaf name, shape and
  dtype) to the port's arrays and counters, with and without observation
  normalization; one the JAX package writes loads into the port to JAX's arrays.
- The repo's format-v0 ``models/checkpoint_update_90.npz`` and the reference's
  ``models/reference_selfplay_checkpoint_update_90.pth`` load into the port to
  what the JAX package loads from them: parameters, Adam moments and count, the
  update counter (90 and 91), the pool and the snapshot count.
- A run resumed from a checkpoint equals the uninterrupted run, given the state a
  checkpoint does not carry in either package (the env state, the cached
  observations and the random streams), which the test copies across.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu.agent.self_play import SelfPlayTrainer as JSelfPlayTrainer
from self_play_racing_tpu.configs import self_play_config as jself_play_config
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import track as jtrack
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch._tree import tree_map
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
from self_play_racing_tpu_torch.configs import self_play_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.utils import checkpoint as ckpt

V0 = "models/checkpoint_update_90"
PTH = "models/reference_selfplay_checkpoint_update_90.pth"


def _trainers(num_envs=4, jax_side=True, **kw):
    base = dict(num_envs=num_envs, num_steps=32, num_minibatches=2, update_epochs=2,
                total_timesteps=num_envs * 32 * 40)
    base.update(kw)
    np.random.seed(1)  # gen_tracks draws each track's shape from the global RNG
    cps = jtrack.gen_tracks(2, seed=1)  # narrow tracks: races end within a rollout
    ids = np.arange(num_envs) % 2
    tr = SelfPlayTrainer(self_play_config(**base), tmulti.MultiRacingConfig(),
                         ttrack.gather_tracks(ttrack.make_track_pool(cps, 3.5, device="cpu"),
                                              ids))
    if not jax_side:
        return None, tr
    jtr = JSelfPlayTrainer(jself_play_config(**base), jmulti.MultiRacingConfig(),
                           jtrack.gather_tracks(jtrack.make_track_pool(cps, 3.5), ids))
    return jtr, tr


def _port_state(tr):
    """(train leaves, pool leaves, obs_norm leaves) of the port, as numpy."""
    p, adam, update = interop.train_state_to_numpy(tr.runner.train)
    train = jax.tree.leaves((p, adam["count"], adam["mu"], adam["nu"], update))
    pool = jax.tree.leaves(interop.pool_to_numpy(tr.pool))
    norm = [getattr(tr.runner.obs_norm, k).numpy() for k in ("mean", "var", "count")]
    return train, pool, norm


def _jax_state(jtr):
    t = jtr.runner.train
    adam = t.opt_state[1]
    train = jax.tree.leaves((t.params, adam.count, adam.mu, adam.nu, t.update))
    pool = jax.tree.leaves(jtr.pool)
    norm = [getattr(jtr.runner.obs_norm, k) for k in ("mean", "var", "count")]
    return [[np.asarray(x) for x in xs] for xs in (train, pool, norm)]


def _assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _assert_trainers_equal(tr, jtr, normalize):
    t, p, n = _port_state(tr)
    jt, jp, jn = _jax_state(jtr)
    _assert_same(t, jt)
    _assert_same(p, jp)
    if normalize:
        _assert_same(n, jn)
    assert tr.num_snapshots == jtr.num_snapshots
    assert tr._host_update == jtr._host_update
    np.testing.assert_array_equal(tr.pool_wins, jtr.pool_wins)
    np.testing.assert_array_equal(tr.pool_games, jtr.pool_games)


@pytest.mark.parametrize("normalize", [False, True])
def test_port_checkpoint_loads_in_jax(tmp_path, normalize):
    jtr, tr = _trainers(snapshot_freq=1, normalize_obs=normalize,
                        opponent_per_env=True, reset_envs_each_update=False)
    tr.train(num_updates=3)
    assert tr.num_snapshots == 2 and tr.pool_games.sum() > 0
    path = str(tmp_path / "checkpoint_update_3")
    tr.save_checkpoint(path)
    assert ckpt.format_version(path) == 1
    with np.load(path + ".npz") as data:
        names = [str(s) for s in data["leaf_names"]]
    assert names == [jax.tree_util.keystr(k) for k, _ in
                     jax.tree_util.tree_flatten_with_path(jtr._ckpt_tree())[0]]
    jtr.load_checkpoint(path)
    _assert_trainers_equal(tr, jtr, normalize)
    meta = json.loads((tmp_path / "checkpoint_update_3.meta.json").read_text())
    assert meta["global_step"] == 3 * tr.cfg.batch_size
    assert meta["config"] == json.loads(json.dumps(dataclasses.asdict(jtr.cfg)))
    assert json.dumps(jtr.training_info) == json.dumps(tr.training_info)


def test_jax_checkpoint_loads_into_port(tmp_path):
    jtr, tr = _trainers(normalize_obs=True)
    rng = np.random.default_rng(0)
    # a JAX trainer with non-trivial state: two snapshots, moments, counters
    jtr.runner = jtr.runner.replace(train=jtr.runner.train.replace(
        update=jnp.asarray(5, jnp.int32),
        opt_state=(jtr.runner.train.opt_state[0], jtr.runner.train.opt_state[1]._replace(
            count=jnp.asarray(7, jnp.int32),
            mu=jax.tree.map(lambda x: jnp.asarray(rng.normal(size=x.shape), x.dtype),
                            jtr.runner.train.opt_state[1].mu),
            nu=jax.tree.map(lambda x: jnp.asarray(rng.random(x.shape), x.dtype),
                            jtr.runner.train.opt_state[1].nu)))),
        obs_norm=jtr.runner.obs_norm.replace(mean=jnp.full((19,), 0.25, jnp.float32)))
    jtr._host_update = 5
    jtr.snapshot_agent()
    jtr.snapshot_agent()
    jtr.pool_wins[:2] = [3.0, 1.0]
    jtr.pool_games[:2] = [4.0, 6.0]
    path = str(tmp_path / "checkpoint_update_5")
    jtr.save_checkpoint(path)
    tr.load_checkpoint(path)
    _assert_trainers_equal(tr, jtr, normalize=True)
    assert tr.runner.train.update == 5 and tr.pool_count == 2


def test_repo_checkpoints_load_as_in_jax():
    jtr, tr = _trainers(num_envs=16)
    # format v0 (position-addressed, with the old TrainState's dead global_step)
    assert ckpt.format_version(V0) == 0
    jtr.load_checkpoint(V0)
    tr.load_checkpoint(V0)
    _assert_trainers_equal(tr, jtr, normalize=False)
    assert tr.runner.train.update == 90 and tr.pool_count == 5
    assert tr.training_info == jtr.training_info
    # the reference's torch training checkpoint: update 90 resumes at 91
    jtr, tr = _trainers(num_envs=16)
    jtr.load_torch_checkpoint(PTH)
    tr.load_torch_checkpoint(PTH)
    _assert_trainers_equal(tr, jtr, normalize=False)
    assert tr.runner.train.update == 91 and tr._resumed_at_update == 91
    assert tr.num_snapshots == 6 and tr.pool_count == 5
    with pytest.raises(ValueError, match="does not match"):
        _, small = _trainers(num_envs=4, jax_side=False, pool_size=3)
        small.load_checkpoint(V0)


def _runtime(tr):
    """What a checkpoint does not carry: env state, cached observations and the
    random streams."""
    gen = lambda g: torch.Generator(device=g.device).set_state(g.get_state())
    r = tr.runner
    vec = r.vec
    return dict(
        vec=type(vec)(env=tree_map(torch.clone, vec.env), pending_reset=vec.pending_reset.clone(),
                      stats=tree_map(torch.clone, vec.stats), generator=gen(vec.generator)),
        obs=r.obs.clone(), done=r.done.clone(), generator=gen(r.generator),
        opp_rng=tr._opp_rng.get_state())


def test_resumed_run_equals_uninterrupted(tmp_path):
    _, a = _trainers(jax_side=False, snapshot_freq=1, pool_size=3)
    d = str(tmp_path / "a")
    a.train(num_updates=2, checkpoint_dir=d, checkpoint_every=2)
    assert sorted(os.listdir(d)) == ["checkpoint_update_2.meta.json", "checkpoint_update_2.npz"]
    saved = _runtime(a)
    a.train(num_updates=3)  # uninterrupted: updates 2, 3 and 4

    _, b = _trainers(jax_side=False, snapshot_freq=1, pool_size=3)
    b.load_checkpoint(os.path.join(d, "checkpoint_update_2"))
    b.runner.vec, b.runner.obs, b.runner.done = saved["vec"], saved["obs"], saved["done"]
    b.runner.generator = saved["generator"]
    b._opp_rng.set_state(saved["opp_rng"])
    e = str(tmp_path / "b")
    b._resumed_at_update = b.runner.train.update
    b.train(num_updates=3, checkpoint_dir=e, checkpoint_every=2)
    # the update resumed from is not saved again; update 4 is
    assert sorted(os.listdir(e)) == ["checkpoint_update_4.meta.json", "checkpoint_update_4.npz"]

    ta, pa, na = _port_state(a)
    tb, pb, nb = _port_state(b)
    _assert_same(ta, tb)
    _assert_same(pa, pb)
    assert a.num_snapshots == b.num_snapshots == 4
    assert json.dumps(a.training_info) == json.dumps(b.training_info)  # NaN rates too
    np.testing.assert_array_equal(a.pool_games, b.pool_games)

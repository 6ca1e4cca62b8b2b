"""The port's capacity layouts (``envs/track.py``: ``PooledTracks``,
``GroupedPooledTracks``, ``TiledPooledTracks``) against the JAX package's and
against the gathered per-env geometry, on the CPU.

- ``resolve`` of each layout equals JAX's ``resolve`` of the same pool and ids, and
  the port's ``gather_tracks`` at the layout's ids, bitwise (a row gather).
- The envs read a layout as the resident pool and per-env row ids (the kernels'
  ``row_ids``; their plain versions ``index_select`` the rows): reset, observe and
  transition of both envs equal the gathered geometry's bitwise.
- PPO and self-play training (8 envs x 32 steps, 2 updates) are bitwise the
  gathered run's under ``tiled`` and ``gather`` (the default assignment
  ``arange(N) % T``) and under ``grouped`` against the gathered run on
  ``np.repeat(block_ids, block_envs)``, as the JAX package's
  tests/test_pooled_geometry.py holds its layouts.
- ``tree_map`` (and so the trainer's ``_place_aux`` and ``set_track``) keeps a
  layout's type and its ``reps`` / ``block_envs``.
- ``train scale --resample-tracks-every 1 --pooled-geometry tiled --device cpu``
  at a toy size.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from self_play_racing_tpu.envs import track as jtrack
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch._tree import tree_map
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
from self_play_racing_tpu_torch.configs import base_config, self_play_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack

FIELDS = [f.name for f in dataclasses.fields(ttrack.TrackArrays)]


def _pools(num_tracks=4, dtype="f32"):
    jd, td = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.float64, torch.float64)
    np.random.seed(3)
    jp = jtrack.make_track_pool(jtrack.gen_tracks(num_tracks, seed=3), [7.0] * num_tracks,
                                dtype=jd)
    np.random.seed(3)
    tp = ttrack.make_track_pool(ttrack.gen_tracks(num_tracks, seed=3), [7.0] * num_tracks,
                                dtype=td, device="cpu")
    return jp, tp


def _layouts(jp, tp):
    """(name, JAX layout, port layout, per-env ids) for each layout."""
    ids = np.array([3, 0, 0, 2, 1, 3, 1, 2, 0, 3, 3, 1])
    block_ids, be = np.array([2, 0, 3, 1]), 3
    return [
        ("gather", jtrack.pooled_tracks(jp, ids), ttrack.pooled_tracks(tp, ids), ids),
        ("grouped", jtrack.grouped_pooled_tracks(jp, block_ids, be),
         ttrack.grouped_pooled_tracks(tp, block_ids, be), np.repeat(block_ids, be)),
        ("tiled", jtrack.tiled_pooled_tracks(jp, 12), ttrack.tiled_pooled_tracks(tp, 12),
         np.arange(12) % 4),
    ]


def _assert_tracks_equal(a, b):
    for name in FIELDS:
        ta, tb = getattr(a, name), getattr(b, name)
        ta = ta if isinstance(ta, torch.Tensor) else torch.as_tensor(np.asarray(ta))
        assert ta.dtype == tb.dtype and torch.equal(ta, tb), name


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_resolve_matches_jax_and_gather(dtype):
    jp, tp = _pools(dtype=dtype)
    for name, jl, tl, ids in _layouts(jp, tp):
        got = ttrack.resolve(tl)
        _assert_tracks_equal(jtrack.resolve(jl), got)
        _assert_tracks_equal(ttrack.gather_tracks(tp, ids), got)
        assert (tl.num_envs, tl.num_tracks) == (jl.num_envs, jl.num_tracks) == (12, 4), name
        np.testing.assert_array_equal(tl.ids.numpy(), np.asarray(jl.ids))
        assert tl.ids.dtype == torch.int32
        for f in ttrack.SCALAR_FIELDS:  # gathered once at build
            assert torch.equal(getattr(tl.env, f), getattr(got, f)), (name, f)
    gathered = ttrack.gather_tracks(tp, np.arange(4))
    assert ttrack.resolve(gathered) is gathered
    assert ttrack.rows_of(gathered) == (gathered, None)
    assert ttrack.scalars_of(gathered) is gathered


def _env_steps_equal(env, cfg, layout, gathered, reset_kw, actions):
    """reset, then transition + observe over ``actions`` on both geometries: every
    state tensor, observation, reward and flag bitwise equal."""
    flat = lambda tree: tree_map(lambda t: t, tree)  # noqa: E731
    s1, o1 = env.reset(cfg, gathered, **reset_kw)
    s2, o2 = env.reset(cfg, layout, **reset_kw)
    assert torch.equal(o1, o2)
    for a in actions:
        s1, o1, *r1 = env.step(cfg, gathered, s1, a)
        s2, o2, *r2 = env.step(cfg, layout, s2, a)
        assert torch.equal(o1, o2)
        for x, y in zip(r1[:3], r2[:3]):
            assert torch.equal(x, y)
        for k in r1[3]:
            assert torch.equal(r1[3][k], r2[3][k]), k
        got = []
        tree_map(lambda x, y: got.append(torch.equal(x, y)), flat(s1), flat(s2))
        assert all(got)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_envs_read_layouts_bitwise_as_gathered_rows(dtype):
    jp, tp = _pools(dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    td = tp.wp_x.dtype
    for _, _, layout, ids in _layouts(jp, tp):
        gathered = ttrack.gather_tracks(tp, ids)
        single = [torch.rand((12, 2), generator=gen, dtype=td) * 2 - 1 for _ in range(20)]
        _env_steps_equal(tsingle, tsingle.RacingConfig(num_sensors=11), layout, gathered,
                         {}, single)
        for a in (2, 3):
            slots = torch.argsort(torch.rand((12, a), generator=gen), dim=-1)
            multi = [torch.rand((12, a, 2), generator=gen, dtype=td) * 2 - 1
                     for _ in range(20)]
            _env_steps_equal(tmulti, tmulti.MultiRacingConfig(num_agents=a), layout,
                             gathered, {"position_idx": slots}, multi)


def _assert_runs_equal(a, b):
    for x, y in zip(a.runner.train.model.parameters(), b.runner.train.model.parameters()):
        assert torch.equal(x, y)
    same = []
    tree_map(lambda x, y: same.append(torch.equal(x, y)), a.runner.vec, b.runner.vec)
    assert all(same) and same
    assert torch.equal(a.runner.obs, b.runner.obs)
    assert a.training_info == b.training_info


def _training_pair(kind, layout_name):
    """(gathered trainer, layout trainer) after 2 updates of 8 envs x 32 steps."""
    _, tp = _pools()
    if layout_name == "grouped":
        block_ids, be = np.array([1, 3, 0, 2]), 2
        layout = ttrack.grouped_pooled_tracks(tp, block_ids, be)
        ids = np.repeat(block_ids, be)
    elif layout_name == "tiled":
        layout, ids = ttrack.tiled_pooled_tracks(tp, 8), np.arange(8) % 4
    else:
        ids = np.arange(8) % 4
        layout = ttrack.pooled_tracks(tp, ids)
    gathered = ttrack.gather_tracks(tp, ids)
    common = dict(num_envs=8, num_steps=32, num_minibatches=2, update_epochs=2,
                  total_timesteps=8 * 32 * 3)
    trainers = []
    for track in (gathered, layout):
        if kind == "ppo":
            tr = PPOTrainer(base_config(**common), tsingle.RacingConfig(num_sensors=11), track)
        else:
            cfg = self_play_config(**common, snapshot_freq=1, pool_size=2,
                                   opponent_per_env=True, reset_envs_each_update=False)
            tr = SelfPlayTrainer(cfg, tmulti.MultiRacingConfig(num_agents=2, num_sensors=11),
                                 track)
        tr.train(num_updates=2)
        trainers.append(tr)
    return trainers


@pytest.mark.parametrize("layout_name", ["tiled", "gather", "grouped"])
@pytest.mark.parametrize("kind", ["ppo", "selfplay"])
def test_training_bitwise_under_layouts(kind, layout_name):
    eager, lazy = _training_pair(kind, layout_name)
    _assert_runs_equal(eager, lazy)
    aux = lazy.aux if kind == "ppo" else lazy.aux["track"]
    assert isinstance(aux, ttrack.LAYOUTS)


def test_tree_map_and_set_track_keep_a_layout():
    _, tp = _pools()
    for layout in (ttrack.tiled_pooled_tracks(tp, 8), ttrack.grouped_pooled_tracks(tp, [0, 2], 4),
                   ttrack.pooled_tracks(tp, [1, 1, 0, 3])):
        copy = tree_map(lambda t: t.clone(), layout)
        assert type(copy) is type(layout)
        for f in ("reps", "block_envs"):
            assert getattr(copy, f, None) == getattr(layout, f, None)
        assert torch.equal(copy.ids, layout.ids) and copy.pool.wp_x is not layout.pool.wp_x
    cfg = base_config(num_envs=8, num_steps=8, num_minibatches=2, update_epochs=1,
                      total_timesteps=8 * 8 * 2)
    tr = PPOTrainer(cfg, tsingle.RacingConfig(num_sensors=11), ttrack.gather_tracks(
        tp, np.arange(8) % 4))
    layout = ttrack.tiled_pooled_tracks(tp, 8)
    tr.set_track(layout)
    assert tr.aux is layout  # already on the trainer's device: placed as given
    tr.train(num_updates=1)
    with pytest.raises(ValueError, match="not divisible"):
        ttrack.tiled_pooled_tracks(tp, 10)


def test_train_scale_cli_resampled_tiled(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    trainer = ttrain.main(["scale", "--resample-tracks-every", "1", "--pooled-geometry",
                           "tiled", "--num-envs", "16", "--total-timesteps",
                           str(16 * 256 * 2), "--num-updates", "2", "--device", "cpu"])
    track = trainer.aux["track"]
    assert isinstance(track, ttrack.TiledPooledTracks) and track.reps == 1
    # the pool of boundary 1, the one the second update trained on
    want = ttrain.procgen_pool(trainer.cfg.seed, 1, 16, device="cpu")
    assert torch.equal(track.pool.wp_x, want.wp_x)
    assert trainer.runner.train.update == 2
    assert (tmp_path / "models" / "self_play_agent_scale_1B.npz").exists()
    grouped = ttrain.geometry_layout(want, 32, "grouped")
    assert isinstance(grouped, ttrack.GroupedPooledTracks) and grouped.block_envs == 2
    assert isinstance(ttrain.geometry_layout(want, 32, True), ttrack.PooledTracks)
    assert isinstance(ttrain.geometry_layout(want, 32), ttrack.TrackArrays)

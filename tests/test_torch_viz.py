"""The port's trajectory recorders and renderers against the JAX package, on the CPU.

- ``record_trajectory_single``, ``record_trajectory_multi`` and
  ``record_trajectory_match`` (deterministic) against JAX's on one held-out track,
  with random-init policies held to a steering angle at full throttle (they crash
  inside the horizon), the multi recorders on JAX's start-grid slots: the same
  keys and number of rows (no row after the done step), ``active`` all set. Single and multi run float64 policies on a float64 track:
  within rtol 1e-9 / atol 1e-9 (cos/sin round differently in XLA's and PyTorch's
  CPU math). The match casts its policies to float32 (``stack_bundles``, as JAX's
  does), whose matrix products sum in another order on each side: within rtol
  1e-5 / atol 1e-5.
- A noisy sampled episode ends before the horizon with no phantom terminal row
  (the crash penalty at most once).
- ``render_video``, ``visualization_grid`` and ``eval_training`` write files, as
  ``tests/test_viz.py`` checks JAX's; ``TrackRenderer``'s world-to-screen transform
  and a drawn frame equal JAX's exactly (the same NumPy and pygame calls).
- ``render.py``: the held-out track equals JAX's (geometry and float32 arrays
  exactly) and leaves the global NumPy RNG where it was; the CLI renders a match,
  and two models with a grid, on the CPU in a temporary directory.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu import render as jrender
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import single as jsingle
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.utils import viz as jviz
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch import render as trender
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.utils import viz as tviz

cv2 = pytest.importorskip("cv2")
pytest.importorskip("pygame")

MULTI_MODEL = "models/self_play_agent.npz"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ["active", "angle", "progress", "reward", "speed", "x", "y"]


@pytest.fixture(scope="module")
def setup():
    cps = [jtrack.gen_random_track(11, 55, 12, 0.3, 0.5, seed=4)]
    geometry = jtrack.build_track_geometry(cps[0], 8.0)
    jtr = jtrack.gather_tracks(jtrack.make_track_pool(cps, [8.0], dtype=jnp.float64), [0])
    ttr = ttrack.gather_tracks(ttrack.make_track_pool(cps, [8.0], dtype=torch.float64,
                                                      device="cpu"), [0])
    return geometry, jtr, ttr


def _policy(seed, obs_dim, dtype, steer=0.0):
    """A random-init policy as (JAX params, JAX log_std, port params, port log_std).
    With ``steer`` its mu head's bias holds the wheel at about ``steer`` at full
    throttle, so that a greedy episode crashes inside the horizon."""
    jp = jax.tree.map(lambda v: jnp.asarray(v, dtype),
                      jnet.init_params(jax.random.key(seed), obs_dim, 2))
    if steer:
        w, b = jp["actor"][-1]
        jp["actor"][-1] = (w, b + jnp.arctanh(jnp.asarray([steer, 0.95], dtype)))
    jls = jnp.full((2,), -0.7, dtype)
    model = interop.params_from_jax(jax.tree.map(np.asarray, jp), np.asarray(jls),
                                    dtype=torch.float64 if dtype == jnp.float64
                                    else torch.float32, device="cpu")
    return jp, jls, model.params(), model.log_std


def _jax_slots(key):
    k_reset, _ = jax.random.split(key)
    order = jax.random.permutation(jax.random.split(k_reset, 1)[0], 2)[None]
    return torch.as_tensor(np.array(jnp.argsort(order, axis=-1)))


def _same(t, j, max_steps, rtol, atol):
    assert sorted(t) == sorted(j) == KEYS
    assert 1 <= len(t["x"]) == len(j["x"]) < max_steps  # the episode ended, trimmed
    assert t["active"].all()
    for k in KEYS[1:]:
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=atol, err_msg=k)


def test_record_single_matches_jax(setup):
    _, jtr, ttr = setup
    jp, jls, tp, tls = _policy(0, 15, jnp.float64, steer=0.6)
    j = jviz.record_trajectory_single(jp, jls, jsingle.RacingConfig(num_sensors=11), jtr,
                                      jax.random.key(1), max_steps=200)
    t = tviz.record_trajectory_single(tp, tls, tsingle.RacingConfig(num_sensors=11), ttr,
                                      max_steps=200)
    _same(t, j, 200, 1e-9, 1e-9)
    assert t["x"].ndim == 1


def test_record_multi_matches_jax(setup, monkeypatch):
    _, jtr, ttr = setup
    jp, jls, tp, tls = _policy(0, 19, jnp.float64, steer=0.6)
    key = jax.random.key(1)
    j = jviz.record_trajectory_multi(jp, jls, jmulti.MultiRacingConfig(num_agents=2,
                                                                       num_sensors=11),
                                     jtr, key, max_steps=200)
    pos = _jax_slots(key)
    monkeypatch.setattr(tmulti, "random_grid_slots", lambda n, a, gen, device=None: pos)
    t = tviz.record_trajectory_multi(tp, tls, tmulti.MultiRacingConfig(num_agents=2,
                                                                       num_sensors=11),
                                     ttr, torch.Generator(), max_steps=200)
    _same(t, j, 200, 1e-9, 1e-9)
    assert t["x"].shape[1] == 2 and t["reward"].shape[1] == 2


def test_record_match_matches_jax(setup, monkeypatch):
    _, jtr, ttr = setup
    cfg_j = jmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    cfg_t = tmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    pols = [_policy(s, 19, jnp.float32, steer=st) for s, st in ((0, 0.6), (1, -0.4))]
    key = jax.random.key(2)
    j = jviz.record_trajectory_match([(jp, jls, None) for jp, jls, _, _ in pols], cfg_j,
                                     jtr, key, max_steps=200)
    pos = _jax_slots(key)
    monkeypatch.setattr(tmulti, "random_grid_slots", lambda n, a, gen, device=None: pos)
    t = tviz.record_trajectory_match([(tp, tls, None) for _, _, tp, tls in pols], cfg_t,
                                     ttr, torch.Generator(), max_steps=200)
    _same(t, j, 200, 1e-5, 1e-5)
    # distinct policies drive apart
    assert not np.allclose(t["x"][:, 0], t["x"][:, 1])


def test_recorded_trajectory_has_no_phantom_terminal_row(setup):
    """Every returned row comes from an active step: the row after the done step
    re-steps the frozen terminal state (re-firing the crash penalty)."""
    _, _, ttr = setup
    _, _, tp, _ = _policy(0, 15, jnp.float64)
    traj = tviz.record_trajectory_single(tp, torch.full((2,), 0.5, dtype=torch.float64),
                                         tsingle.RacingConfig(num_sensors=11), ttr,
                                         torch.Generator().manual_seed(3), max_steps=500,
                                         deterministic=False)
    assert len(traj["x"]) < 500
    assert traj["active"].all()
    assert (traj["reward"] < -30).sum() <= 1
    with pytest.raises(ValueError, match="generator"):
        tviz.record_trajectory_single(tp, torch.zeros(2), tsingle.RacingConfig(num_sensors=11),
                                      ttr, max_steps=5, deterministic=False)


def test_record_and_render_single_multi_and_grid(setup, tmp_path):
    geometry, _, ttr = setup
    _, _, tp, tls = _policy(0, 15, jnp.float64)
    traj = tviz.record_trajectory_single(tp, tls, tsingle.RacingConfig(num_sensors=11), ttr,
                                         max_steps=120)
    out = str(tmp_path / "single.mp4")
    frames = tviz.render_video(geometry, traj, out, label="test", frame_skip=4)
    assert frames > 0 and os.path.getsize(out) > 1000
    cap = cv2.VideoCapture(out)
    ok, frame = cap.read()
    assert ok and frame.shape == (600, 800, 3) and frame.sum() > 0
    cap.release()

    _, _, tp, tls = _policy(0, 19, jnp.float64)
    mtraj = tviz.record_trajectory_multi(tp, tls, tmulti.MultiRacingConfig(num_agents=2,
                                                                           num_sensors=11),
                                         ttr, torch.Generator().manual_seed(1), max_steps=100)
    v1 = str(tmp_path / "multi.mp4")
    mframes = tviz.render_video(geometry, mtraj, v1, label="multi", frame_skip=4)
    cap = cv2.VideoCapture(v1)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == mframes
    cap.release()
    grid = str(tmp_path / "grid.mp4")
    n = tviz.visualization_grid([v1, v1, v1], ["a", "b", "c"], grid)
    assert n > 0 and os.path.getsize(grid) > 1000

    # frame_skip > 1 keeps the skipped steps' rewards in the HUD total
    T = 23
    skip = {"x": np.linspace(0, 5, T), "y": np.zeros(T), "angle": np.zeros(T),
            "speed": np.ones(T), "progress": np.linspace(0, 0.2, T), "reward": np.ones(T)}
    assert tviz.render_video(geometry, skip, str(tmp_path / "skip.mp4"),
                             frame_skip=5) == (T + 4) // 5


def test_eval_training_plot(tmp_path):
    rng = np.random.default_rng(0)
    for name in ("a", "b"):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump({"steps": list(range(0, 1000, 100)),
                       "rewards": rng.normal(size=10).tolist()}, f)
    out = str(tmp_path / "curves.png")
    tviz.eval_training({"A": str(tmp_path / "a.json"), "B": str(tmp_path / "b.json")}, out)
    assert os.path.getsize(out) > 1000


def test_track_renderer_transform_equals_jax(setup):
    geometry, _, _ = setup
    ours, theirs = tviz.TrackRenderer(geometry), jviz.TrackRenderer(geometry)
    assert ours.scale == theirs.scale and ours.offset == theirs.offset
    pts = np.random.default_rng(0).uniform(-80, 80, (64, 2))
    assert np.array_equal(ours.to_screen(pts), theirs.to_screen(pts))
    assert np.array_equal(ours.to_screen(ours.left), theirs.to_screen(theirs.left))
    for r in (ours, theirs):
        r.draw_track()
        r.draw_trail(np.array([0.0, 5.0, 9.0]), np.array([0.0, 2.0, 1.0]), r.CAR_COLORS[1])
        r.draw_car(3.0, -4.0, 0.7, r.CAR_COLORS[0])
        r.draw_hud(["step 0"])
    assert np.array_equal(ours.frame(), theirs.frame())


def test_held_out_track_matches_jax_and_keeps_the_rng():
    np.random.seed(9)
    state = np.random.get_state()
    geometry, track = trender._held_out_track(123, 7.0, device="cpu")
    after = np.random.get_state()
    assert after[0] == state[0] and np.array_equal(after[1], state[1]) and after[2] == state[2]
    jgeometry, jtr = jrender._held_out_track(123, 7.0)
    assert sorted(geometry) == sorted(jgeometry)
    for k, v in geometry.items():
        np.testing.assert_array_equal(v, jgeometry[k], err_msg=k)
    for k in ("wp_x", "wp_y", "seg_sx", "seg_vy", "n_wp", "track_width", "start_angle"):
        np.testing.assert_array_equal(getattr(track, k).numpy(), np.asarray(getattr(jtr, k)),
                                      err_msg=k)


def test_render_cli_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    single, multi = (os.path.join(REPO, m) for m in ("models/single_agent.npz", MULTI_MODEL))
    trender.main(["--vs", multi, os.path.join(REPO, "models/self_play_agent_scale_1B.npz"),
                  "--max-steps", "60", "--frame-skip", "6", "--out", "match.mp4",
                  "--device", "cpu"])
    assert os.path.getsize("match.mp4") > 1000
    trender.main(["--single", single, "--multi", multi, "--grid", "grid.mp4",
                  "--max-steps", "40", "--frame-skip", "8", "--device", "cpu"])
    for f in ("static/single_agent_race.mp4", "static/self_play_agent_race.mp4", "grid.mp4"):
        assert os.path.getsize(f) > 1000, f
    out = capsys.readouterr().out
    assert "self_play_agent vs self_play_agent_scale_1B" in out and "60 steps" in out
    with pytest.raises(SystemExit, match="at least one"):
        trender.main(["--device", "cpu"])

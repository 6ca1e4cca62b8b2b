"""The SB3 baseline leg on the port (``interop/sb3_compat.py``, ``train sb3|all``,
``evaluate --sb3``) against the JAX package's, on the CPU: tests/test_sb3_compat.py's
five cases on the port, and the comparisons with JAX.

- ``DummyVecEnv``'s SAME-STEP autoreset and the ``EpisodeStatistics`` records.
- The leg end to end at 2 envs x 64 steps x 3 rollouts: train, save, curve, load
  and evaluate.
- The repo's ``models/sb3_baseline_agent_general.zip`` (a checkpoint of the
  vendored PPO) and a byte-faithful stable_baselines3 2.x archive: the port's
  ``predict`` is bitwise the JAX package's vendored ``predict`` on the same
  observations (the same torch code); the archive's action bounds decode with
  gymnasium and fall back to [-1, 1] without it.
- The eval harness on the repo's model over 4 tracks x 1 run against JAX's
  ``evaluate_sb3_agent_overall``: equal steps, finished and crashed per episode;
  rewards, progress, speed and distance within rtol 1e-3 (both run the float32
  env, and cos/sin round differently in XLA's and PyTorch's CPU math in about 5%
  of float32 values, which the deterministic policy carries on through its
  actions).
- The toy problem learns.
- ``train sb3`` and ``evaluate --sb3`` as CLIs in ``tmp_path`` with ``--device
  cpu``; ``train all`` runs multi, single and sb3 in JAX's order.
"""
import json
import os

import numpy as np
import pytest
import torch

import gymnasium as gym

from self_play_racing_tpu import evaluate as jevaluate
from self_play_racing_tpu import train as jtrain
from self_play_racing_tpu.interop import sb3_compat as jsb3
from test_sb3_compat import _write_real_sb3_archive
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch.envs import gym_adapter as tga
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.interop import sb3_compat as tsb3

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SB3_MODEL = os.path.join(REPO, "models", "sb3_baseline_agent_general.zip")
KEYS = ("success_rate", "crash_rate", "avg_speed", "avg_distance", "avg_steps_per_progress")


def test_dummy_vecenv_autoreset_and_episode_stats():
    cps = ttrack.gen_tracks(2, seed=1)

    def make(i):
        def thunk():
            return tga.EpisodeStatistics(
                tga.RacingEnv(num_sensors=11, track_pool=cps, track_id=i % 2,
                              track_width=7.0, dtype=torch.float32, device="cpu"))
        return thunk

    venv = tsb3.DummyVecEnv([make(i) for i in range(3)])
    venv.seed(7)
    obs = venv.reset()
    assert obs.shape == (3, 15) and obs.dtype == np.float32

    rng = np.random.RandomState(0)
    saw_terminal = False
    for _ in range(300):
        a = rng.uniform([-1, 0], [1, 1], (3, 2)).astype(np.float32)
        obs, rew, dones, infos = venv.step(a)
        assert obs.shape == (3, 15) and rew.shape == (3,)
        for d, info in zip(dones, infos):
            if d:
                saw_terminal = True
                assert info["terminal_observation"].shape == (15,)
                assert info["TimeLimit.truncated"] is False
                assert info["episode"]["l"] >= 1 and np.isfinite(info["episode"]["r"])
            else:
                assert "episode" not in info and "terminal_observation" not in info
    assert saw_terminal


def test_sb3_baseline_leg_end_to_end(tmp_path):
    out = tmp_path / "sb3_model"
    info = tmp_path / "training_info_sb3.json"
    model = ttrain.train_single_baseline(
        total_timesteps=2 * 64 * 3,  # 3 rollouts of n_steps=64 x 2 envs
        out=str(out), info_out=str(info), device="cpu",
        num_envs=2, num_steps=64,  # keeps the PPOConfig validation happy
        sb3_kwargs=dict(n_steps=64, batch_size=32),
    )
    assert isinstance(model, tsb3.PPO) and model.device == torch.device("cpu")
    assert model.num_timesteps == 384
    assert os.path.exists(str(out) + ".zip")
    with open(info) as f:
        curve = json.load(f)
    assert curve["steps"] and len(curve["steps"]) == len(curve["rewards"])

    obs = np.zeros(15, np.float32)
    act, _ = model.predict(obs, deterministic=True)
    assert act.shape == (2,)
    assert (act >= np.array([-1, 0]) - 1e-6).all()
    assert (act <= np.array([1, 1]) + 1e-6).all()

    results = tevaluate.evaluate_sb3_agent_overall(str(out) + ".zip", num_tracks=2,
                                                   num_runs=1, max_steps=80, device="cpu")
    for key in KEYS:
        assert key in results
    assert len(results["all_episodes"]) == 2
    # the port's checkpoint is the JAX package's vendored format
    jmodel = jsb3.PPO.load(str(out) + ".zip")
    obs = np.random.RandomState(1).randn(6, 15).astype(np.float32)
    np.testing.assert_array_equal(model.predict(obs, deterministic=True)[0],
                                  jmodel.predict(obs, deterministic=True)[0])


def test_load_repo_model_and_real_archive_predict_bitwise_jax(tmp_path, monkeypatch):
    obs = np.random.RandomState(0).randn(32, 15).astype(np.float32)
    ours = tsb3.PPO.load(SB3_MODEL, device="cpu")
    theirs = jsb3.PPO.load(SB3_MODEL)
    assert ours.num_timesteps == theirs.num_timesteps > 0
    for a, b in zip(ours._spaces, theirs._spaces):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ours.predict(obs, deterministic=True)[0],
                                  theirs.predict(obs, deterministic=True)[0])
    np.testing.assert_array_equal(ours.predict(obs[0], deterministic=True)[0],
                                  theirs.predict(obs[0], deterministic=True)[0])

    torch.manual_seed(3)
    src = tsb3.ActorCriticPolicy(15, 2)
    path = tmp_path / "real_sb3_model.zip"
    _write_real_sb3_archive(str(path), src)
    model = tsb3.PPO.load(str(path), device="cpu")
    jmodel = jsb3.PPO.load(str(path))
    assert model.num_timesteps == 12345
    _, _, low, high = model._spaces
    np.testing.assert_array_equal(low, [-1.0, 0.0])   # decoded Box, not the fallback
    np.testing.assert_array_equal(high, [1.0, 1.0])
    got, _ = model.predict(obs, deterministic=True)
    np.testing.assert_array_equal(got, jmodel.predict(obs, deterministic=True)[0])
    with torch.no_grad():
        want = src.act_deterministic(torch.as_tensor(obs)).numpy()
    np.testing.assert_allclose(got, np.clip(want, low, high), atol=1e-7)
    # SB3's suffix rule
    got2, _ = tsb3.PPO.load(str(tmp_path / "real_sb3_model"), device="cpu").predict(
        obs, deterministic=True)
    np.testing.assert_array_equal(got, got2)
    # without gymnasium the serialized Box cannot be unpickled: the loader falls
    # back to [-1, 1] and predict clips to that superset
    monkeypatch.setitem(__import__("sys").modules, "gymnasium", None)
    bare = tsb3.PPO.load(str(path), device="cpu")
    np.testing.assert_array_equal(bare._spaces[2], [-1.0, -1.0])
    np.testing.assert_array_equal(bare._spaces[3], [1.0, 1.0])
    np.testing.assert_array_equal(bare.predict(obs, deterministic=True)[0],
                                  np.clip(want, -1.0, 1.0))


def test_eval_harness_on_repo_model_matches_jax():
    ours = tevaluate.evaluate_sb3_agent_overall(SB3_MODEL, num_tracks=4, num_runs=1,
                                                device="cpu")
    theirs = jevaluate.evaluate_sb3_agent_overall(SB3_MODEL, num_tracks=4, num_runs=1)
    assert len(ours["all_episodes"]) == len(theirs["all_episodes"]) == 4
    for o, t in zip(ours["all_episodes"], theirs["all_episodes"]):
        assert (o["steps"], o["finished"], o["crashed"]) == \
            (t["steps"], t["finished"], t["crashed"])
        for k in ("total_reward", "progress", "speed", "total_distance",
                  "distance_per_step"):
            np.testing.assert_allclose(o[k], t[k], rtol=1e-3, err_msg=k)
    assert ours["success_rate"] == theirs["success_rate"] == 1.0
    for k in KEYS + ("avg_steps", "avg_reward"):
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-3, err_msg=k)


def test_sb3_compat_learns_on_toy_problem():
    class Toy(gym.Env):
        observation_space = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)
        action_space = gym.spaces.Box(-1.0, 1.0, (2,), np.float32)

        def reset(self, seed=None, options=None):
            self.t = 0
            return np.zeros(2, np.float32), {}

        def step(self, action):
            self.t += 1
            rew = float(-np.sum((np.asarray(action) - 0.5) ** 2))
            return (np.zeros(2, np.float32), rew, False, self.t >= 8, {})

    env = tsb3.DummyVecEnv([lambda: Toy() for _ in range(4)])
    model = tsb3.PPO("MlpPolicy", env, seed=0, n_steps=64, batch_size=64, n_epochs=4,
                     device="cpu")

    def mean_rew(m):
        a = m.predict(np.zeros((64, 2), np.float32), deterministic=True)[0]
        return float(-np.sum((a - 0.5) ** 2, axis=-1).mean())

    before = mean_rew(model)
    model.learn(total_timesteps=4 * 64 * 12)
    after = mean_rew(model)
    assert after > before + 0.1, (before, after)


def test_train_and_evaluate_sb3_clis(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    model = ttrain.main(["sb3", "--device", "cpu", "--num-envs", "1",
                         "--total-timesteps", "2048"])
    assert model.num_timesteps == 2048 and model.env.num_envs == 1
    zip_path = tmp_path / "models" / "sb3_baseline_agent_general.zip"
    with open(tmp_path / "data" / "training_info_sb3.json") as f:
        assert set(json.load(f)) == {"steps", "rewards"}
    by_label = tevaluate.main(["--sb3", str(zip_path), "--device", "cpu",
                               "--num-tracks", "2", "--num-runs", "1"])
    with open(tmp_path / "data" / "eval_info_sb3.json") as f:
        written = json.load(f)
    assert (tmp_path / "static" / "eval_comparison.png").exists()
    direct = tevaluate.evaluate_sb3_agent_overall(str(zip_path), num_tracks=2, num_runs=1,
                                                  device="cpu")
    assert written == by_label["sb3"]["results"] == json.loads(json.dumps(direct))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        tevaluate.main(["--sb3", str(zip_path), "--num-tracks", "1", "--num-runs", "1"])


def test_train_all_runs_the_legs_in_jax_order(monkeypatch):
    def recorder(module, log):
        for leg in ("train_multi", "train_single", "train_single_baseline"):
            monkeypatch.setattr(module, leg, lambda *a, _leg=leg, **kw:
                                log.append((_leg, a, {k: v for k, v in kw.items()
                                                      if k != "device"})))

    ours, theirs = [], []
    recorder(ttrain, ours)
    recorder(jtrain, theirs)
    argv = ["all", "--total-timesteps", "8192", "--seed", "3", "--num-updates", "1"]
    ttrain.main(argv + ["--device", "cpu"])
    jtrain.main(argv)
    assert [leg for leg, *_ in ours] == [leg for leg, *_ in theirs] == \
        ["train_multi", "train_single", "train_single_baseline"]
    assert ours == theirs
    ours.clear()
    ttrain.main(["sb3", "--device", "cpu", "--num-envs", "2"])
    assert ours == [("train_single_baseline", (None,), {"num_envs": 2})]

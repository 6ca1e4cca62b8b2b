"""The port's inference slice as a whole against the JAX package, on the CPU.

- The deterministic evaluation rollout on a 4 x 2 grid, params and tracks in float64
  on both sides: per-episode steps/finished/crashed are exact; reward, distance,
  progress and speed within rtol 1e-9 (cos/sin round differently in XLA's and
  PyTorch's CPU math, so the trajectories drift by a few ulps).
- ``serve.Policy.act`` on one batch against the JAX server: float32, rtol 1e-5 /
  atol 1e-6 (matrix products sum in another order).
- Importing the port loads no JAX, Flax, Optax or JAX-package module.
- Without CUDA, an entry point not told ``device="cpu"`` raises.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu import serve as jserve
from self_play_racing_tpu.envs import single as jenv
from self_play_racing_tpu.evaluate import load_policy_bundle as jload
from self_play_racing_tpu.utils import metrics as jM
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch import serve as tserve
from self_play_racing_tpu_torch.envs import single as tenv
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.utils import metrics as tM
from self_play_racing_tpu_torch.utils import profiling as tprof

MODEL = "models/single_agent.npz"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_deterministic_eval_rollout_matches_jax_f64():
    jp, jls, _ = jload(MODEL)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jp)
    jls = jnp.asarray(jls, jnp.float64)
    jtrack, jtids, _ = jM.build_eval_grid(4, 2, dtype=jnp.float64)
    ttrack_, ttids, _ = tM.build_eval_grid(4, 2, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(ttids, jtids)
    j = jM.rollout_single(jp, jls, jenv.RacingConfig(num_sensors=11), jtrack,
                          jax.random.key(0), max_steps=450, deterministic=True)
    model = interop.params_from_jax(jax.tree.map(np.asarray, jp), np.asarray(jls),
                                    dtype=torch.float64, device="cpu")
    t = tM.rollout_single(model.params(), model.log_std, tenv.RacingConfig(num_sensors=11),
                          ttrack_, max_steps=450, deterministic=True)
    assert sorted(t) == sorted(j)
    for k in ("steps", "finished", "crashed"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]), err_msg=k)
    for k in ("total_reward", "total_distance", "progress", "speed", "distance_per_step"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]), rtol=1e-9, err_msg=k)
    # the horizon cuts some laps short and lets others finish
    assert 0 < int(t["finished"].sum()) < len(ttids)
    agg_t, agg_j = tM.aggregate(t), jM.aggregate({k: np.asarray(v) for k, v in j.items()})
    assert agg_t.keys() == agg_j.keys()
    for k in agg_j:
        assert agg_t[k] == pytest.approx(agg_j[k], rel=1e-9), k


def test_sampled_evaluation_on_cpu():
    grid = tM.build_eval_grid(2, 2, device="cpu")
    r1 = tevaluate.evaluate_single_agent_overall(grid, MODEL, seed=3)
    r2 = tevaluate.evaluate_single_agent_overall(grid, MODEL, seed=3)
    assert r1 == r2  # the seeded generator makes sampling repeatable
    assert r1["num_episodes"] == len(r1["all_episodes"]) == 4
    assert r1["success_rate"] == 1.0  # this policy finishes every lap of the grid


def test_serve_policy_act_matches_jax():
    obs = np.random.default_rng(0).uniform(-1, 1.5, (64, 15)).astype(np.float32)
    jpol = jserve.Policy(MODEL)
    tpol = tserve.Policy(MODEL, device="cpu")
    a = tpol.act(obs)
    np.testing.assert_allclose(a, jpol.act(obs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tpol.act(obs[0]), a[0], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tpol.value(obs), jpol.value(obs), rtol=1e-5, atol=1e-5)
    sampled = tserve.Policy(MODEL, deterministic=False, device="cpu")
    s1, s2 = sampled.act(obs), sampled.act(obs)
    assert s1.shape == (64, 2) and np.abs(s1).max() <= 1.0 and not np.allclose(s1, s2)
    rows = tserve.bench(tpol, batches=(1, 8), reps=2)
    assert [r["batch"] for r in rows] == [1, 8]


def test_evaluate_cli_single_and_later_flags():
    by_path = tevaluate.main(["--single", MODEL, "--num-tracks", "2", "--num-runs", "1",
                              "--device", "cpu"])
    assert by_path[MODEL]["num_episodes"] == 2
    for flag in (["--multi", "x.npz"], ["--sb3", "x.zip"], ["--procgen"]):
        with pytest.raises(SystemExit, match="not ported yet"):
            tevaluate.main(["--single", MODEL, *flag])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import self_play_racing_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'self_play_racing_tpu'))\n"
        "print(len([m for m in sys.modules if m.startswith('self_play_racing_tpu_torch')]))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    n_port, bad = res.stdout.strip().splitlines()
    assert int(n_port) >= 15
    assert bad == "[]"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: ttrack.default_track_pool(),
        lambda: tprof.canonical_bench_pool(2),
        lambda: tM.build_eval_grid(1, 1),
        lambda: interop.load_npz(MODEL),
        lambda: tevaluate.load_policy_bundle(MODEL),
        lambda: tserve.Policy(MODEL),
        lambda: tevaluate.main(["--single", MODEL, "--num-tracks", "1", "--num-runs", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert ttrack.default_track_pool(device="cpu").wp_x.device.type == "cpu"

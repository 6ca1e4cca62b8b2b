"""The port's package API against the JAX package, on the CPU.

- The lazy top-level exports, the Gymnasium adapters among them, resolve to the
  port's own objects; an unknown name raises ``AttributeError``; ``load_policy``
  returns what ``load_policy_bundle`` does, equal to JAX's ``load_policy``.
- ``nearest_waypoint``, ``track_progress`` and ``centerline_collision`` equal JAX's
  (eager) bitwise in float32 and float64: an argmin, one division, and a
  projection read at the winner (JAX sums it out of a one-hot mask: adding zeros
  is exact).
- ``Throughput`` gives JAX's rates exactly under one patched clock.
- ``trace`` writes a Chrome trace holding the annotated region.
- Importing the new modules loads neither JAX nor the JAX package; the tournament
  and render entry points raise without CUDA unless the CPU is asked for.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import self_play_racing_tpu_torch as port
from self_play_racing_tpu.evaluate import load_policy as jload_policy
from self_play_racing_tpu.ops import geometry as jgeo
from self_play_racing_tpu.utils import profiling as jprof
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch import render as trender
from self_play_racing_tpu_torch import tournament as ttournament
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
from self_play_racing_tpu_torch.configs import PPOConfig, base_config, self_play_config
from self_play_racing_tpu_torch.ops import geometry as tgeo
from self_play_racing_tpu_torch.serve import Policy
from self_play_racing_tpu_torch.utils import profiling as tprof

MULTI_MODEL = "models/self_play_agent.npz"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def test_exports_resolve_to_the_port():
    from self_play_racing_tpu_torch.envs import gym_adapter

    expected = {"PPOConfig": PPOConfig, "base_config": base_config,
                "self_play_config": self_play_config, "PPOTrainer": PPOTrainer,
                "SelfPlayTrainer": SelfPlayTrainer, "Policy": Policy,
                "load_policy": tevaluate.load_policy,
                "load_policy_bundle": tevaluate.load_policy_bundle,
                "RacingEnv": gym_adapter.RacingEnv,
                "MultiRacingEnv": gym_adapter.MultiRacingEnv,
                "SelfPlayWrapper": gym_adapter.SelfPlayWrapper}
    assert sorted(port.__all__) == sorted([*expected, "__version__"])
    for name, obj in expected.items():
        assert getattr(port, name) is obj, name
    with pytest.raises(AttributeError):
        port.NotAnExport  # noqa: B018


def test_load_policy_matches_jax():
    params, log_std = port.load_policy(MULTI_MODEL, device="cpu")
    b_params, b_log_std, _ = port.load_policy_bundle(MULTI_MODEL, device="cpu")
    jparams, jlog_std = jload_policy(MULTI_MODEL)
    assert torch.equal(log_std, b_log_std)
    np.testing.assert_array_equal(log_std.numpy(), np.asarray(jlog_std))
    for tower in ("actor", "critic"):
        assert len(params[tower]) == len(jparams[tower])
        for (w, b), (bw, bb), (jw, jb) in zip(params[tower], b_params[tower], jparams[tower]):
            assert torch.equal(w, bw) and torch.equal(b, bb)
            np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jw))
            np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_geometry_helpers_bitwise_jax(dt):
    nd, td = DTYPES[dt]
    rng = np.random.default_rng(5)
    n, c, w = 64, 4, 96
    wp_x = rng.uniform(-60, 60, (n, w)).astype(nd)
    wp_y = rng.uniform(-60, 60, (n, w)).astype(nd)
    wp_x[:, -7:] = wp_y[:, -7:] = 1e9                 # padding never wins
    wp_x[:, 10] = wp_x[:, 11]                           # exact ties: the first wins
    wp_y[:, 10] = wp_y[:, 11]
    ang = rng.uniform(0, 2 * np.pi, (n, w))
    nrm_x, nrm_y = np.cos(ang).astype(nd), np.sin(ang).astype(nd)
    px = rng.uniform(-60, 60, n).astype(nd)
    py = rng.uniform(-60, 60, n).astype(nd)
    px[:4], py[:4] = wp_x[:4, 10], wp_y[:4, 10]
    cx = (px[:, None] + rng.uniform(-3, 3, (n, c))).astype(nd)
    cy = (py[:, None] + rng.uniform(-3, 3, (n, c))).astype(nd)
    n_wp = rng.integers(40, w - 7, n)
    width = rng.uniform(1, 8, n).astype(nd)

    def t(a):
        return torch.as_tensor(a, dtype=td if np.asarray(a).dtype.kind == "f" else None)

    idx = tgeo.nearest_waypoint(t(px), t(py), t(wp_x), t(wp_y))
    jidx = jgeo.nearest_waypoint(jnp.asarray(px), jnp.asarray(py), jnp.asarray(wp_x),
                                 jnp.asarray(wp_y))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert (idx[:4] == 10).all()
    prog = tgeo.track_progress(t(px), t(py), t(wp_x), t(wp_y), t(n_wp))
    jprog = jgeo.track_progress(jnp.asarray(px), jnp.asarray(py), jnp.asarray(wp_x),
                                jnp.asarray(wp_y), jnp.asarray(n_wp))
    assert prog.dtype == td
    np.testing.assert_array_equal(prog.numpy(), np.asarray(jprog))
    for tw in (width, nd(4.5)):
        hit = tgeo.centerline_collision(t(cx), t(cy), t(wp_x), t(wp_y), t(nrm_x), t(nrm_y),
                                        t(tw))
        jhit = jgeo.centerline_collision(jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(wp_x),
                                         jnp.asarray(wp_y), jnp.asarray(nrm_x),
                                         jnp.asarray(nrm_y), jnp.asarray(tw))
        np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
        assert 0 < int(hit.sum()) < n


def test_throughput_matches_jax(monkeypatch):
    clock = np.cumsum([0.0, 0.5, 0.25, 0.0, 1.0, 0.125, 2.0]).tolist()
    ours, theirs = tprof.Throughput(alpha=0.3), jprof.Throughput(alpha=0.3)
    for meter in (ours, theirs):
        stamps = iter(clock)
        monkeypatch.setattr(time, "perf_counter", lambda: next(stamps))
        meter.rates = [meter.update(s) for s in (100, 200, 50, 400, 10, 70, 30)]
    assert ours.rates == theirs.rates and ours.rate == theirs.rate
    assert ours.total_steps == theirs.total_steps == 860
    assert ours.rates[0] == 0.0 and ours.rates[3] > 1e9  # no time passed: the 1e-9 floor


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("policy_step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    files = os.listdir(tmp_path / "prof")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "prof" / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "policy_step" for e in events)


def test_new_modules_import_no_jax():
    code = (
        "import sys\n"
        "import self_play_racing_tpu_torch as pkg\n"
        "pkg.load_policy, pkg.PPOTrainer, pkg.SelfPlayTrainer, pkg.Policy\n"
        "from self_play_racing_tpu_torch import tournament, render\n"
        "pkg.RacingEnv, pkg.MultiRacingEnv, pkg.SelfPlayWrapper\n"
        "from self_play_racing_tpu_torch.interop import sb3_compat\n"
        "from self_play_racing_tpu_torch.parallel import mesh\n"
        "from self_play_racing_tpu_torch.utils import viz, profiling, metrics\n"
        "from self_play_racing_tpu_torch.ops import geometry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'optax', 'self_play_racing_tpu',\n"
        "              'pygame', 'cv2', 'matplotlib'))\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_tournament_and_render_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [
        lambda: ttournament.main([MULTI_MODEL, MULTI_MODEL, "--tracks", "1", "--runs", "1"]),
        lambda: ttournament.run_tournament([MULTI_MODEL, MULTI_MODEL], 1, 1),
        lambda: trender.main(["--vs", MULTI_MODEL, MULTI_MODEL]),
        lambda: trender.main(["--multi", MULTI_MODEL]),
        lambda: trender._held_out_track(123),
        lambda: port.load_policy(MULTI_MODEL),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()

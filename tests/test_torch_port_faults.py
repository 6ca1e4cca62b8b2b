"""Three places where the port's trainer and evaluation departed from the JAX
package, each held to the JAX function on the CPU.

- The speed-weight anneal runs only where the trainer's aux is a dict that holds
  ``"speed_weight"``: with ``aux=track`` and ``aux={"track": track}`` both
  packages leave the aux as given at update 1; with the default aux both set the
  same float32 weight.
- ``PPOTrainer.set_track`` places the new track through ``_place_aux`` (on the
  trainer's device), as JAX's does.
- ``evaluate.eval()`` and the CLI write ``eval_info_<label>.json`` with JAX's keys
  and labels and draw the comparison chart. On a 2 x 1 grid, deterministic, with
  JAX's start-grid slots fed to the port: steps, finished, crashed and placement
  exact; every other number within rtol 1e-5 for the single-car policy. The port
  rolls out in float32 and XLA's and PyTorch's CPU math round cos and sin
  differently in the last bit; ``distance_per_step`` is also float32 in the port
  and float64 in JAX. For the two-car policy within rtol 5e-3: the default
  sensor cone's +-pi/2 rays pass exactly through a start-grid boundary vertex, so
  whether they hit follows the last bit of cos (a reference behaviour the port
  keeps), and one of the two races drives a slightly different line to the same
  finish (its reward 0.2% apart, its distance 0.04%).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from self_play_racing_tpu import evaluate as jevaluate
from self_play_racing_tpu.agent.trainer import PPOTrainer as JPPOTrainer
from self_play_racing_tpu.configs import base_config as jbase_config
from self_play_racing_tpu.envs import single as jenv
from self_play_racing_tpu.envs import track as jtrack
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import evaluate as tevaluate
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import single as tenv
from self_play_racing_tpu_torch.envs import track as ttrack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "models/single_agent.npz")
MULTI_MODEL = os.path.join(REPO, "models/self_play_agent.npz")
ENVS, UPDATES = 2, 4


def _trainers(aux_form):
    """A port and a JAX trainer with ``anneal_speed_weight`` on the same track,
    given the aux in ``aux_form``: "track", "dict_track" or "default" (none)."""
    kw = dict(num_envs=ENVS, num_steps=8, num_minibatches=2, update_epochs=1,
              total_timesteps=ENVS * 8 * UPDATES, anneal_speed_weight=True)
    jt = jtrack.gather_tracks(jtrack.default_track_pool(), [0] * ENVS)
    tt = ttrack.gather_tracks(ttrack.default_track_pool(device="cpu"), [0] * ENVS)
    aux = {"track": lambda t: t, "dict_track": lambda t: {"track": t},
           "default": lambda t: None}[aux_form]
    tr = PPOTrainer(base_config(**kw), tenv.RacingConfig(num_sensors=11), tt, aux=aux(tt))
    jtr = JPPOTrainer(jbase_config(**kw), jenv.RacingConfig(num_sensors=11), jt, aux=aux(jt))
    return tr, jtr


@pytest.mark.parametrize("aux_form", ["track", "dict_track", "default"])
def test_speed_weight_anneal_keeps_the_references_guard(aux_form):
    tr, jtr = _trainers(aux_form)
    before, jbefore = tr.aux, jtr.aux
    for t in (tr, jtr):
        t._host_update = 1
        t._pre_update()
    assert isinstance(tr.aux, dict) == isinstance(jtr.aux, dict)
    if not isinstance(jtr.aux, dict):
        assert tr.aux is before and jtr.aux is jbefore  # left as given
        return
    assert sorted(tr.aux) == sorted(jtr.aux)
    if "speed_weight" in jtr.aux:
        # the reference's schedule 8 -> 14 at update 1 of 4
        assert tr.aux["speed_weight"].dtype == torch.float32
        assert float(tr.aux["speed_weight"]) == float(jtr.aux["speed_weight"]) == 9.5
    assert aux_form != "dict_track" or sorted(tr.aux) == ["track"]


@pytest.mark.parametrize("aux_form", ["track", "dict_track"])
def test_set_track_places_the_track_like_the_reference(aux_form, monkeypatch):
    tr, jtr = _trainers(aux_form)
    new = {"port": ttrack.gather_tracks(ttrack.make_track_pool(
               ttrack.gen_tracks(1, seed=3), 6.0, device="cpu"), [0] * ENVS),
           "jax": jtrack.gather_tracks(jtrack.make_track_pool(
               jtrack.gen_tracks(1, seed=3), 6.0), [0] * ENVS)}
    placed = {}
    for name, t in (("port", tr), ("jax", jtr)):
        place = t._place_aux

        def spy(aux, name=name, place=place):
            placed[name] = (aux, place(aux))
            return placed[name][1]

        monkeypatch.setattr(t, "_place_aux", spy)
        t.set_track(new[name])
        given, result = placed[name]
        assert given is new[name]
        stored = t.aux["track"] if isinstance(t.aux, dict) else t.aux
        assert stored is result
    assert tr.runner.vec.env.car.x.device == torch.device("cpu")
    assert not tr.runner.done.any() and int(tr.runner.vec.env.steps.max()) == 0


def _jax_slots(seed, n, a):
    """JAX's start-grid slots of ``rollout_multi`` from ``key(seed)``."""
    k_reset, _ = jax.random.split(jax.random.key(seed))
    keys = jax.random.split(k_reset, n)
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, a))(keys))


def _hold_results(port, ref, rtol):
    assert sorted(port) == sorted(ref)
    for k, v in ref.items():
        if k == "all_episodes":
            assert len(port[k]) == len(v)
            for pe, je in zip(port[k], v):
                assert sorted(pe) == sorted(je)
                for f, jv in je.items():
                    if isinstance(jv, float):
                        np.testing.assert_allclose(pe[f], jv, rtol=rtol, err_msg=f)
                    else:
                        assert pe[f] == jv, f
        elif isinstance(v, float):
            np.testing.assert_allclose(port[k], v, rtol=rtol, err_msg=k)
        else:
            assert port[k] == v, k


def test_eval_writes_the_references_results(tmp_path, monkeypatch):
    models = {"single": ("single", MODEL), "self_play": ("multi", MULTI_MODEL)}
    monkeypatch.setattr(tmulti, "random_grid_slots", lambda n, a, generator, device=None:
                        torch.as_tensor(_jax_slots(42, n, a), device=device))
    ref = jevaluate.eval(models, 2, 1, 42, out_dir=str(tmp_path / "jax"), chart=None,
                         deterministic=True)
    chart = tmp_path / "port" / "chart" / "comparison.png"
    got = tevaluate.eval(models, 2, 1, 42, out_dir=str(tmp_path / "port"), chart=str(chart),
                         deterministic=True, device="cpu")
    assert list(got) == list(ref) == ["single", "self_play"]
    for label in models:
        path = tmp_path / "port" / f"eval_info_{label}.json"
        assert got[label]["path"] == str(path)
        with open(path) as f:
            port = json.load(f)
        with open(tmp_path / "jax" / f"eval_info_{label}.json") as f:
            want = json.load(f)
        _hold_results(port, want, rtol=1e-5 if label == "single" else 5e-3)
        assert port["success_rate"] == 1.0
    assert chart.exists() and chart.stat().st_size > 0
    # a falsy chart draws nothing
    tevaluate.eval({"single": ("single", MODEL)}, 1, 1, 42, out_dir=str(tmp_path / "none"),
                   chart=None, deterministic=True, device="cpu")
    assert sorted(os.listdir(tmp_path / "none")) == ["eval_info_single.json"]


def test_evaluate_cli_writes_the_references_files(tmp_path, monkeypatch):
    argv = ["--single", MODEL, "--single", MODEL, "--multi", MULTI_MODEL,
            "--num-tracks", "1", "--num-runs", "1", "--deterministic"]
    written = {}
    for name, main, extra in (("jax", jevaluate.main, []),
                              ("port", tevaluate.main, ["--device", "cpu"])):
        (tmp_path / name).mkdir()
        monkeypatch.chdir(tmp_path / name)
        main(argv + extra)
        written[name] = sorted(os.path.relpath(os.path.join(d, f), tmp_path / name)
                               for d, _, fs in os.walk(tmp_path / name) for f in fs)
    assert written["port"] == written["jax"] == [
        "data/eval_info_self_play.json", "data/eval_info_single_0.json",
        "data/eval_info_single_1.json", "static/eval_comparison.png"]
    with open(tmp_path / "port" / "data" / "eval_info_single_1.json") as f:
        assert json.load(f)["num_episodes"] == 1

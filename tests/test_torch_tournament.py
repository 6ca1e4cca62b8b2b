"""The port's tournament and match play against the JAX package, on the CPU.

- ``rollout_match`` (one policy per seat) against JAX's on a 3 x 2 grid in float64,
  seat 0 the 1B-step agent with a seeded observation normalizer, seat 1
  ``models/self_play_agent.npz`` without one: deterministic, and sampled with JAX's
  per-seat noise fed through ``noise``; both on JAX's start-grid slots. steps,
  finished, crashed and placement exact; the floats within rtol 1e-9 (cos/sin
  round differently in XLA's and PyTorch's CPU math, so trajectories drift by a
  few ulps).
- A model against itself, seat by seat, gives ``rollout_multi``'s shared-policy
  raw accumulator bitwise (deterministic, float64, the seat axis a batch of the
  same products).
- ``bradley_terry_elo`` bitwise equal to JAX's on seeded win and draw matrices,
  the undefeated sweep included (the same NumPy code).
- ``stack_bundles`` rejects mixed architectures; ``play_match`` accounts for every
  env; a trained agent beats a random-init policy.
- ``run_tournament`` and the CLI on 3 random-init policies (2 tracks x 1 run, 150
  steps, CPU): the JSON keys, shapes and a ranking sorted by Elo; deterministic, on
  JAX's start-grid slots for every pair, wins and draws equal JAX's exactly and
  the ratings within rtol 1e-9 (the matches run in float32 on both sides, as
  ``stack_bundles`` casts).
"""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from self_play_racing_tpu import tournament as jT
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import normalize as jnorm
from self_play_racing_tpu.evaluate import load_policy_bundle as jload
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.utils import metrics as jM
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import tournament as tT
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import normalize as tnorm
from self_play_racing_tpu_torch.evaluate import load_policy_bundle as tload
from self_play_racing_tpu_torch.utils import metrics as tM

RTOL = 1e-9
TRAINED = "models/self_play_agent_scale_1B.npz"
OTHER = "models/self_play_agent.npz"
INTS = ("steps", "finished", "crashed", "placement")
FLOATS = ("total_reward", "total_distance", "progress", "speed")


def _save_policy(path, seed, obs_dim=19, act=2, hidden=(64, 64)):
    """A random-init policy in the repo's npz format (written with the JAX package)."""
    params = jnet.init_params(jax.random.key(seed), obs_dim, act, hidden=hidden)
    flat, treedef = jax.tree.flatten(params)
    np.savez(path, treedef=str(treedef), log_std=np.full((act,), -0.5, np.float32),
             **{f"p{i}": np.asarray(x) for i, x in enumerate(flat)})
    return str(path)


def _jax_grid_slots(key, n, a=2):
    """JAX's start-grid slots of a multi rollout from ``key`` (its reset key)."""
    k_reset, _ = jax.random.split(key)
    order = jax.vmap(lambda k: jax.random.permutation(k, a))(jax.random.split(k_reset, n))
    return torch.as_tensor(np.array(jnp.argsort(order, axis=-1)))


def _jax_seat_noise(key, steps, n, a=2):
    """The per-seat noise of JAX's sampled match rollout from ``key``, [T, N, A, 2]."""
    _, k_run = jax.random.split(key)

    @jax.jit
    def draws(keys):
        return jax.vmap(lambda k: jax.vmap(
            lambda ks: jax.random.normal(ks, (n, 2), jnp.float64))(jax.random.split(k, a)))(keys)
    return torch.as_tensor(np.array(draws(jax.random.split(k_run, steps))).transpose(0, 2, 1, 3))


def _match_stacks():
    """Seat 0: the 1B agent with a seeded normalizer; seat 1: OTHER. Float64, as
    (JAX stacks, port stacks)."""
    def f64(path):
        p, ls, _ = jload(path)
        return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), p), jnp.asarray(ls, jnp.float64)
    (pa, la), (pb, lb) = f64(TRAINED), f64(OTHER)
    rng = np.random.default_rng(0)
    mean = np.stack([rng.normal(0.0, 0.02, 19), np.zeros(19)])
    var = np.stack([rng.uniform(0.9, 1.1, 19), np.ones(19)])
    count = np.array([1.0, 1e-4])
    jp = jax.tree.map(lambda x, y: jnp.stack([x, y]), pa, pb)
    jl = jnp.stack([la, lb])
    jn = jnorm.ObsNormState(jnp.asarray(mean), jnp.asarray(var), jnp.asarray(count))
    tp = {tower: [(torch.as_tensor(np.array(w)), torch.as_tensor(np.array(b)))
                  for w, b in jp[tower]] for tower in ("actor", "critic")}
    tn = tnorm.ObsNormState(*(torch.as_tensor(x) for x in (mean, var, count)))
    return (jp, jl, jn), (tp, torch.as_tensor(np.array(jl)), tn)


@pytest.mark.parametrize("deterministic", [True, False], ids=["greedy", "sampled"])
def test_rollout_match_matches_jax(deterministic, monkeypatch):
    steps = 700
    (jp, jl, jn), (tp, tl, tn) = _match_stacks()
    jgrid, _, _ = jM.build_eval_grid(3, 2, dtype=jnp.float64)
    tgrid, _, _ = tM.build_eval_grid(3, 2, dtype=torch.float64, device="cpu")
    cfg_j = jmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    cfg_t = tmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    key = jax.random.key(4)
    j = jM.rollout_match(jp, jl, jn, cfg_j, jgrid, key, max_steps=steps,
                         deterministic=deterministic)
    pos = _jax_grid_slots(key, 6)
    monkeypatch.setattr(tmulti, "random_grid_slots", lambda n, a, gen, device=None: pos)
    noise = None if deterministic else _jax_seat_noise(key, steps, 6)
    t = tM.rollout_match(tp, tl, tn, cfg_t, tgrid, torch.Generator(), max_steps=steps,
                         deterministic=deterministic, noise=noise)
    assert sorted(t) == sorted(j)
    assert t["placement"].shape == (6, 2) and t["steps"].shape == (6,)
    for k in INTS:
        np.testing.assert_array_equal(t[k].numpy(), j[k], err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(t[k].numpy(), j[k], rtol=RTOL, err_msg=k)
    # the races ended, and both seats won some
    assert (j["placement"] > 0).all()
    assert set(j["placement"][:, 0].tolist()) == {1, 2}


def test_match_against_itself_equals_the_shared_policy_rollout():
    model, ls, _ = tload(OTHER, "cpu", dtype=torch.float64)
    model = {tower: [(w.detach(), b.detach()) for w, b in layers]
             for tower, layers in model.items()}
    # float64 stacks (stack_bundles casts to float32, as JAX's does), identity rows
    params = {tower: [(torch.stack([w, w]), torch.stack([b, b])) for w, b in layers]
              for tower, layers in model.items()}
    identity = tnorm.ObsNormState(torch.zeros(2, 19), torch.ones(2, 19), torch.ones(2))
    grid, _, _ = tM.build_eval_grid(3, 2, dtype=torch.float64, device="cpu")
    cfg = tmulti.MultiRacingConfig(num_agents=2, num_sensors=11)
    per_seat = tM.rollout_match(params, torch.stack([ls, ls]), identity, cfg, grid,
                                torch.Generator().manual_seed(3), max_steps=700,
                                deterministic=True)
    shared = tM._rollout_multi_acc(model, ls, cfg, grid, torch.Generator().manual_seed(3),
                                   700, True, None)
    assert sorted(per_seat) == sorted(shared)
    for k in shared:
        assert torch.equal(per_seat[k], shared[k]), k
    out = tM.rollout_multi(model, ls, cfg, grid, torch.Generator().manual_seed(3),
                           max_steps=700, deterministic=True)
    chosen = per_seat["finished"].to(torch.int8).argmax(dim=1)
    assert torch.equal(out["placement"], per_seat["placement"][torch.arange(6), chosen])
    assert int(out["finished"].sum()) > 0


def _bt_cases():
    rng = np.random.default_rng(11)
    cases = []
    for m in (2, 3, 4, 6):
        wins = rng.integers(0, 40, (m, m)).astype(float)
        np.fill_diagonal(wins, 0)
        draws = rng.integers(0, 5, (m, m)).astype(float)
        draws = np.triu(draws, 1) + np.triu(draws, 1).T
        cases.append((wins, draws))
    cases.append((np.array([[0, 10], [0, 0]], float), None))      # an undefeated sweep
    cases.append((np.array([[0, 5], [5, 0]], float), None))       # even
    cases.append((np.array([[0, 9, 8], [1, 0, 7], [2, 3, 0]], float), np.zeros((3, 3))))
    return cases


@pytest.mark.parametrize("case", range(len(_bt_cases())))
def test_bradley_terry_elo_bitwise_jax(case):
    wins, draws = _bt_cases()[case]
    ours = tT.bradley_terry_elo(wins, draws)
    theirs = jT.bradley_terry_elo(wins, draws)
    assert np.array_equal(ours, theirs)
    assert np.isfinite(ours).all() and abs(np.mean(ours)) < 1e-6


def test_stack_bundles_rejects_mixed_architectures(tmp_path):
    a = tload(_save_policy(tmp_path / "h64.npz", 0, hidden=(64, 64)), "cpu")
    b = tload(_save_policy(tmp_path / "h32.npz", 1, hidden=(32, 32)), "cpu")
    with pytest.raises(ValueError, match="architecture"):
        tT.stack_bundles([a, b], obs_dim=19)
    params, log_std, norm = tT.stack_bundles([a, a], obs_dim=19)
    assert params["actor"][0][0].shape == (2, 19, 64) and log_std.shape == (2, 2)
    # no normalizer saved: identity rows
    assert torch.equal(norm.mean, torch.zeros(2, 19)) and torch.equal(norm.var, torch.ones(2, 19))


def test_play_match_accounts_every_env(tmp_path):
    grid, _, _ = tM.build_eval_grid(num_tracks=2, num_runs=2, seed=42, device="cpu")
    a = tload(_save_policy(tmp_path / "a.npz", 0), "cpu")
    b = tload(_save_policy(tmp_path / "b.npz", 1), "cpu")
    wa, wb, d = tT.play_match(a, b, grid, torch.Generator().manual_seed(0), max_steps=200)
    # every env resolves to exactly one of: seat-0 win, seat-1 win, draw
    assert wa + wb + d == grid.wp_x.shape[0]
    assert min(wa, wb, d) >= 0


def test_trained_model_beats_random_init(tmp_path):
    grid, _, _ = tM.build_eval_grid(num_tracks=3, num_runs=1, seed=42, device="cpu")
    trained = tload(TRAINED, "cpu")
    random_ = tload(_save_policy(tmp_path / "rand.npz", 123), "cpu")
    wa, wb, d = tT.play_match(trained, random_, grid, torch.Generator().manual_seed(7),
                              max_steps=1500)
    assert wa > wb


def test_run_tournament_and_cli_end_to_end(tmp_path, monkeypatch, capsys):
    paths = [_save_policy(tmp_path / f"m{i}.npz", seed=i) for i in range(3)]
    kwargs = dict(num_tracks=2, num_runs=1, max_steps=150)
    res = tT.run_tournament(paths, device="cpu", **kwargs)
    assert sorted(res) == ["draws", "elo", "models", "names", "ranking", "wins"]
    wins, draws = np.array(res["wins"]), np.array(res["draws"])
    assert wins.shape == draws.shape == (3, 3) and (np.diag(wins) == 0).all()
    # every ordered pair played the 2 envs once
    assert ((wins + wins.T + draws)[~np.eye(3, dtype=bool)] == 4).all()
    assert np.isfinite(res["elo"]).all() and len(res["ranking"]) == 3
    ranked = [r["elo"] for r in res["ranking"]]
    assert ranked == sorted(ranked, reverse=True)
    assert [r["rank"] for r in res["ranking"]] == [1, 2, 3]

    # deterministic, on JAX's start-grid slots of every pair: JAX's results
    m = len(paths)
    slots = [_jax_grid_slots(jax.random.fold_in(jax.random.key(42), i * m + j), 2)
             for i in range(m) for j in range(m) if i != j]
    monkeypatch.setattr(tmulti, "random_grid_slots",
                        lambda n, a, gen, device=None: slots.pop(0))
    det = tT.run_tournament(paths, device="cpu", deterministic=True, **kwargs)
    assert not slots
    jres = jT.run_tournament(paths, deterministic=True, **kwargs)
    assert sorted(det) == sorted(jres)
    assert det["wins"] == jres["wins"] and det["draws"] == jres["draws"]
    np.testing.assert_allclose(det["elo"], jres["elo"], rtol=RTOL)
    assert [r["name"] for r in det["ranking"]] == [r["name"] for r in jres["ranking"]]
    monkeypatch.undo()

    out = tmp_path / "out" / "tournament.json"
    cli = tT.main([*paths, "--tracks", "2", "--runs", "1", "--max-steps", "150",
                   "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(cli))
    assert cli["wins"] == res["wins"] and cli["draws"] == res["draws"]
    assert "rank" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="at least 2"):
        tT.main([paths[0], "--device", "cpu"])

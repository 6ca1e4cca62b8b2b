"""The update's device-program form (``agent/ppo.py``: ``minibatch_step``,
``rollout_step``, ``bias_correction_table``) against the JAX package, on the CPU.

The CPU runs every step eagerly and never builds a CUDA graph; the graphs run the
same step functions on the card, where ``tests/test_torch_cuda_kernels.py`` holds
them bitwise to the eager steps.

- The minibatch loop, rewritten as JAX's masked carry, is held to JAX's
  ``run_ppo_update`` by ``tests/test_torch_learner.py``'s
  ``test_run_ppo_update_matches_jax_f64`` (its ``UPDATE_CASES``: no exit, exits
  mid-epoch, on an epoch's last minibatch and on the first, the clip taken and not,
  two data shards).
- ``num_steps`` calls of ``rollout_step`` against a ``lax.scan`` of JAX's rollout
  step (``self_play_racing_tpu/agent/ppo.py:351-397``, which JAX keeps inside
  ``make_update_step``), single-car and self-play, after
  ``reset_envs_each_update``'s rebuild and without it, fed JAX's noise and env
  draws: trajectories, rewards, done flags, episode records, the stats tail and
  the final carry, float64 tracks and learner (tolerances below).
- ``bias_correction_table`` equal to ``bias_correction`` at every count, across an
  exit: the next update's table starts at the count the exit left.
- A CPU runner never touches ``torch.cuda.CUDAGraph``, with no process group or
  over a gloo group, whose update stays eager wherever it runs (gloo's collectives
  run on the host); a mesh whose groups are NCCL's is graphed unless ``eager``.
"""
import numpy as np
import pytest
import torch

import torch.distributed as dist

import jax
import jax.numpy as jnp

from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.self_play import make_selfplay_hooks as jsp_hooks
from self_play_racing_tpu.agent.trainer import make_single_env_hooks as jsingle_hooks
from self_play_racing_tpu.configs import base_config as jbase_config
from self_play_racing_tpu.configs import self_play_config as jself_play_config
from self_play_racing_tpu.envs import multi as jmulti
from self_play_racing_tpu.envs import normalize as jobsnorm
from self_play_racing_tpu.envs import single as jsingle
from self_play_racing_tpu.envs import vector as jvector
from self_play_racing_tpu.models import actor_critic as jnet
from test_torch_dist_workers import group_of_one
from test_torch_learner import ACT_DIM, _batch, _params, update_both
from test_torch_selfplay import CONE, _Feed, _jax_pool, _jax_randoms, _jax_slots, _port_opp, _tracks
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent.self_play import make_selfplay_hooks
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer, make_single_env_hooks
from self_play_racing_tpu_torch.configs import base_config, self_play_config
from self_play_racing_tpu_torch.envs import multi as tmulti
from self_play_racing_tpu_torch.envs import single as tsingle
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.parallel import mesh as pmesh


# ------------------------------------------------------- the bias corrections

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bias_correction_table_across_an_exit(dtype, monkeypatch):
    """The table's rows are ``bias_correction``'s values for the counts that follow
    the update's starting count, capped at int32's maximum; after an update that
    exits, the next update's table starts at the count the exit left."""
    for b in (tppo.ADAM_B1, tppo.ADAM_B2):
        for count in (0, 7, 2**31 - 5):
            table = tppo.bias_correction_table(b, count, 12, dtype)
            assert table.dtype == np.dtype(str(dtype).removeprefix("torch."))
            want = [tppo.bias_correction(b, min(count + k + 1, 2**31 - 1), dtype)
                    for k in range(12)]
            np.testing.assert_array_equal(table, np.asarray(want, table.dtype))
    # an update that exits after 3 applied minibatches, then the tables it leaves
    cfg, (_, opt_state, stop, stats), _, _ = update_both("epoch_last_exit", monkeypatch)
    assert stop and opt_state.count == 3 == stats["applied"].sum()
    tables = []
    bias_correction_table = tppo.bias_correction_table
    monkeypatch.setattr(tppo, "bias_correction_table",
                        lambda *a: tables.append(a) or bias_correction_table(*a))
    model = interop.params_from_jax(_params(4), np.zeros(ACT_DIM), dtype=torch.float64,
                                    device="cpu")
    b = _batch(_params(4), cfg.batch_size, np.full((ACT_DIM,), -0.9, np.float32), 5)
    _, n_units, _ = tppo.minibatch_layout(cfg)
    perms = torch.stack([torch.randperm(n_units, generator=torch.Generator().manual_seed(e))
                         for e in range(cfg.update_epochs)])[:, None]
    tppo.run_ppo_update(cfg, model, opt_state, torch.full((ACT_DIM,), -0.9), 3e-4,
                        tppo.Batch(**{k: torch.as_tensor(v) for k, v in b.items()}), perms)
    total = cfg.update_epochs * cfg.num_minibatches
    assert [(a[1], a[2]) for a in tables] == [(3, total), (3, total)]


# --------------------------------------------------------------- the rollout step

def _jax_rollout(jcfg, hooks, runner, aux, log_std):
    """JAX's rollout phase as ``make_update_step`` defines it inside itself
    (``self_play_racing_tpu/agent/ppo.py:351-397``), from the package's functions:
    a ``lax.scan`` of one step. Returns (vec, next_obs, next_done, norm, traj,
    step stats [T, ...])."""
    params = runner.train.params

    def one_step(carry, _):
        vec, obs, done, key, norm = carry
        key, akey = jax.random.split(key)
        if jcfg.normalize_obs:
            norm = jobsnorm.update(norm, obs)
            policy_obs = jobsnorm.apply(norm, obs)
        else:
            policy_obs = obs
        action, logprob, value = jnet.sample_action(params, log_std, policy_obs, akey)
        vec, next_obs, reward, next_done, _, _, info, rec = jvector.step(
            vec, action,
            lambda s, a, k: hooks.transition(aux, s, a, k),
            lambda s: hooks.observe(aux, s),
            lambda k: hooks.reset(aux, k),
            refresh_fn=None if hooks.refresh is None else (lambda s: hooks.refresh(aux, s)),
            info_fn=None if hooks.info is None else (lambda s: hooks.info(aux, s)))
        out = {"obs": policy_obs, "actions": action, "logprobs": logprob, "values": value,
               "reward": reward.astype(jnp.float32), "done_entering": done,
               "ep_return": jnp.where(rec["mask"], rec["return"], 0.0),
               "ep_length": jnp.where(rec["mask"], rec["length"], 0),
               "ep_mask": rec["mask"]}
        if hooks.stats is not None:
            out["extra"] = hooks.stats(aux, info, rec)
        return (vec, next_obs.astype(jnp.float32), next_done, key, norm), out

    (vec, obs, done, _, norm), out = jax.lax.scan(
        one_step, (runner.vec, runner.obs, runner.done, runner.key, runner.obs_norm),
        None, length=jcfg.num_steps)
    return vec, obs, done, norm, out


def _jax_reset(jcfg, hooks, runner, aux):
    """JAX's ``reset_envs_each_update`` rebuild (``agent/ppo.py:402-417``)."""
    key, k_env, k_run = jax.random.split(runner.key, 3)
    env_state = hooks.reset(aux, k_env)
    if hooks.refresh is not None:
        env_state, _ = hooks.refresh(aux, env_state)
    return runner.replace(vec=jvector.init(env_state, jcfg.num_envs, k_run), key=key)


def _jax_noise(key, steps, n):
    noise = []
    for _ in range(steps):
        key, akey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(akey, (n, 2), jnp.float64)))
    return np.stack(noise)


def _env_draws(vec_key, steps, n, a):
    """The self-play rollout's env draws in the order the port asks for them: per
    step the opponents' draws, then the reset's start-grid slots."""
    slots, randoms = [], []
    for _ in range(steps):
        vec_key, reset_key, step_key = jax.random.split(vec_key, 3)
        randoms.append(_jax_randoms(step_key, n * (a - 1)))
        slots.append(_jax_slots(reset_key, n, a))
    return slots, randoms


def _f64_learner(jcfg, runner):
    params = jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), runner.train.params)
    return runner.replace(train=runner.train.replace(params=params))


def _assert_rollout(port, jax_out, tol):
    (vec, obs, done, _, traj, out), (jvec, jobs, jdone, _, jout) = port, jax_out
    assert set(out) == set(jout)
    for k in ("done_entering", "ep_mask", "ep_length"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
    for k in ("obs", "actions", "logprobs", "values", "reward", "ep_return"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]), rtol=tol, atol=tol,
                                   err_msg=k)
    assert traj.obs is out["obs"] and traj.values is out["values"]
    if "extra" in out:  # the per-slot wins and games, summed over the rollout
        np.testing.assert_array_equal(out["extra"].numpy(),
                                      np.asarray(jout["extra"]).sum(axis=0))
    np.testing.assert_array_equal(done.numpy(), np.asarray(jdone))
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), atol=tol)
    np.testing.assert_array_equal(vec.pending_reset.numpy(),
                                  np.asarray(jvec.pending_reset))
    np.testing.assert_allclose(vec.stats.ep_return.numpy(),
                               np.asarray(jvec.stats.ep_return), rtol=tol, atol=tol)


def _port_rollout(cfg, hooks, runner, aux, noise):
    """``num_steps`` calls of the port's step function, as ``rollout_phase`` and
    the captured graph make them."""
    _, _, log_std = tppo.anneal_fractions(cfg, runner.train.update, device="cpu")
    params = runner.train.model.params()
    carry, out = tppo.rollout_carry(runner), {}
    with torch.no_grad():
        for t in range(cfg.num_steps):
            assert int(carry.t) == t
            carry = tppo.rollout_step(cfg, hooks, aux, params, log_std,
                                      torch.as_tensor(noise), carry, out)
    traj = tppo.Batch(obs=out["obs"], actions=out["actions"], logprobs=out["logprobs"],
                      advantages=None, returns=None, values=out["values"])
    return carry.vec, carry.obs, carry.done, carry.norm, traj, out


@pytest.mark.parametrize("reset_each", [False, True])
def test_rollout_step_matches_jax_single_car(reset_each):
    """Single car with the observation normalizer, float64 tracks and learner:
    trajectories within 1e-5 (the normalizer is float32, and XLA sums its batch
    moments in another order, so the normalized observations, and the actions and
    values taken from them, move by float32 ulps), the flags and episode lengths
    exact."""
    n = 8
    kw = dict(num_envs=n, num_steps=48, total_timesteps=n * 48 * 4,
              reset_envs_each_update=reset_each, normalize_obs=True)
    cfg, jcfg = base_config(**kw), jbase_config(**kw)
    env_cfg = jsingle.RacingConfig(num_sensors=11, max_steps=30)
    tenv_cfg = tsingle.RacingConfig(num_sensors=11, max_steps=30)
    jtr, ttr = _tracks(n, width=5.0)
    hooks, thooks = jsingle_hooks(env_cfg), make_single_env_hooks(tenv_cfg)
    runner = _f64_learner(jcfg, jppo.init_runner(jax.random.key(2), jcfg, hooks, jtr,
                                                 env_cfg.obs_dim, 2))
    trunner = tppo.init_runner(torch.Generator().manual_seed(0), cfg, thooks, ttr,
                               tenv_cfg.obs_dim, 2)
    trunner.train = interop.train_state_from_jax(
        jax.tree.map(np.asarray, runner.train.params),
        jax.tree.map(np.asarray, jppo.make_optimizer(jcfg).init(runner.train.params)), 0,
        dtype=torch.float64, device="cpu")
    if reset_each:
        runner = _jax_reset(jcfg, hooks, runner, jtr)
        trunner = tppo.reset_env_state(thooks, trunner, ttr)
    log_std = jppo.anneal_fractions(jcfg, jnp.asarray(0, jnp.int32), 2)[2].astype(jnp.float32)
    noise = _jax_noise(runner.key, cfg.num_steps, n)
    jout = jax.jit(lambda r, a: _jax_rollout(jcfg, hooks, r, a, log_std))(runner, jtr)
    port = _port_rollout(cfg, thooks, trunner, ttr, noise)
    assert port[5]["ep_mask"].any()  # episodes ended (truncated at 30 steps)
    _assert_rollout(port, jout, 1e-5)
    np.testing.assert_allclose(port[3].mean.numpy(), np.asarray(jout[3].mean), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("reset_each", [False, True])
def test_rollout_step_matches_jax_self_play(reset_each, monkeypatch):
    """Self-play (2 cars, episodes truncated at 30 steps, opponents per env from a
    pool of 3, the stats tail), fed
    JAX's learner noise, opponent draws and start-grid slots: trajectories within
    1e-6 (the multi env's float32 observations drift by an ulp where cos/sin
    round apart, tests/test_torch_selfplay.py), flags, lengths and the per-slot
    wins and games exact."""
    n, a, p = 8, 2, 3
    kw = dict(num_envs=n, num_steps=48, total_timesteps=n * 48 * 4,
              opponent_per_env=True, reset_envs_each_update=reset_each)
    cfg, jcfg = self_play_config(**kw), jself_play_config(**kw)
    env_cfg = jmulti.MultiRacingConfig(num_agents=a, sensor_cone=CONE, max_steps=30)
    tenv_cfg = tmulti.MultiRacingConfig(num_agents=a, sensor_cone=CONE, max_steps=30)
    jtr, ttr = _tracks(n, width=3.5)
    jpool = _jax_pool(p, env_cfg.obs_dim, normalize=False, seed=3, scale=3.0)
    rng = np.random.default_rng(0)
    jopp = {**jpool, "norm_mean": None, "norm_var": None,
            "idx": jnp.asarray(rng.integers(0, p, (n,)).astype(np.int32)),
            "use_policy": jnp.asarray(np.ones((n,), bool))}
    jaux, taux = {"track": jtr, "opp": jopp}, {"track": ttr, "opp": _port_opp(jopp)}
    hooks, thooks = jsp_hooks(env_cfg, p), make_selfplay_hooks(tenv_cfg, p)
    runner = _f64_learner(jcfg, jppo.init_runner(jax.random.key(3), jcfg, hooks, jaux,
                                                 env_cfg.obs_dim, 2))
    feed = _Feed(monkeypatch)
    feed.slots.append(_jax_slots(jax.random.split(jax.random.key(3), 4)[1], n, a))
    trunner = tppo.init_runner(torch.Generator().manual_seed(0), cfg, thooks, taux,
                               tenv_cfg.obs_dim, 2)
    trunner.train = interop.train_state_from_jax(
        jax.tree.map(np.asarray, runner.train.params),
        jax.tree.map(np.asarray, jppo.make_optimizer(jcfg).init(runner.train.params)), 0,
        dtype=torch.float64, device="cpu")
    if reset_each:
        feed.slots.append(_jax_slots(jax.random.split(runner.key, 3)[1], n, a))
        runner = _jax_reset(jcfg, hooks, runner, jaux)
        trunner = tppo.reset_env_state(thooks, trunner, taux)
    log_std = jppo.anneal_fractions(jcfg, jnp.asarray(0, jnp.int32), 2)[2].astype(jnp.float32)
    noise = _jax_noise(runner.key, cfg.num_steps, n)
    feed.slots, feed.randoms = _env_draws(runner.vec.key, cfg.num_steps, n, a)
    jout = jax.jit(lambda r, x: _jax_rollout(jcfg, hooks, r, x, log_std))(runner, jaux)
    port = _port_rollout(cfg, thooks, trunner, taux, noise)
    assert not feed.slots and not feed.randoms
    assert port[5]["ep_mask"].any() and port[5]["extra"][p:].sum() > 0
    _assert_rollout(port, jout, 1e-6)


# ------------------------------------------------------------------- the CPU path

def test_cpu_runner_never_builds_a_graph(monkeypatch, tmp_path):
    """Two updates of a CPU trainer (graphs allowed: ``eager`` left False) with
    ``torch.cuda.CUDAGraph`` replaced by a class that raises: nothing touches it,
    and the update step holds no captured graph. Then the trainer sharded over a
    gloo group: the mesh is not ``capturable``, its update step has no graphs and
    trains two more updates eagerly. Whether a group is graphed is its backend's
    decision: the same mesh read as NCCL's is ``capturable`` and gets graphs, but
    for ``eager=True``, and a tensor-parallel mesh needs both its groups NCCL's."""
    class NoGraph:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a CPU run built a CUDA graph")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    n = 8
    cfg = base_config(num_envs=n, num_steps=16, num_minibatches=2, update_epochs=2,
                      total_timesteps=n * 16 * 4)
    tr = PPOTrainer(cfg, tsingle.RacingConfig(num_sensors=11),
                    ttrack.gather_tracks(ttrack.make_track_pool(
                        ttrack.gen_tracks(2, seed=3), 6.0, device="cpu"), np.arange(n) % 2))
    assert tr.eager is False and tr.update_step.graphs is not None
    tr.train(num_updates=2)
    graphs = tr.update_step.graphs
    assert graphs.rollout is None and graphs.minibatch_graph is None
    assert graphs.capture_seconds == 0.0
    assert tr.runner.train.update == 2

    with group_of_one() as mesh:
        assert mesh.group is not None and not mesh.capturable
        tr.shard(mesh)
        assert tr.update_step.graphs is None
        tr.train(num_updates=2)
        assert tr.runner.train.update == 4
        with monkeypatch.context() as m:
            m.setattr(dist, "get_backend", lambda group=None: "nccl")
            assert mesh.capturable
            assert tppo.make_update_step(cfg, tr.hooks, mesh=mesh).graphs is not None
            assert tppo.make_update_step(cfg, tr.hooks, mesh=mesh, eager=True).graphs is None
            tensor = pmesh.TensorMesh(world=1, rank=0, device=mesh.device, group=mesh.group,
                                      model_parallel=2, model_rank=0, model_group=None,
                                      process_rank=0, all_group=mesh.group)
            assert not tensor.capturable
            assert tppo.make_update_step(cfg, tr.hooks, mesh=tensor).graphs is None


# ------------------------------------------------------------ the static inputs

def test_static_tree_reads_in_place_and_copies_what_moved():
    """``_graph.StaticTree``: a tensor at a place outside ``copied`` is the
    caller's own (the graph reads it in place, and sees the caller's in-place
    writes); ``moved`` names the places where the caller hands another tensor, and
    a tree built with those places copied holds copies that ``load`` refreshes,
    leaving the places read in place alone."""
    from self_play_racing_tpu_torch import _graph

    pool = torch.arange(6.0).reshape(3, 2)
    aux = {"opp": {"params": [pool], "idx": torch.tensor([0, 2])},
           "speed_weight": torch.tensor(1.0), "name": "canonical"}
    static = _graph.StaticTree(aux, frozenset())
    assert static.tree["opp"]["params"][0] is pool and not static.copied
    assert static.tree["name"] == "canonical"
    assert [p for p, _ in _graph.tensor_leaves(aux)] == [
        ("opp", "params", 0), ("opp", "idx"), ("speed_weight",)]
    pool[1].fill_(-1.0)  # a snapshot written in place: nothing moved
    assert static.moved(aux) == frozenset()
    assert torch.equal(static.tree["opp"]["params"][0][1], torch.tensor([-1.0, -1.0]))

    nxt = {"opp": {"params": [pool], "idx": torch.tensor([1, 1])},
           "speed_weight": torch.tensor(0.5), "name": "canonical"}
    moved = static.moved(nxt)
    assert moved == {("opp", "idx"), ("speed_weight",)}
    static = _graph.StaticTree(nxt, moved)
    assert static.tree["opp"]["params"][0] is pool
    idx = static.tree["opp"]["idx"]
    assert idx is not nxt["opp"]["idx"] and torch.equal(idx, nxt["opp"]["idx"])
    assert static.copied == moved
    assert static.tree["speed_weight"] is not nxt["speed_weight"]
    third = {"opp": {"params": [pool], "idx": torch.tensor([2, 0])},
             "speed_weight": torch.tensor(0.25), "name": "canonical"}
    assert static.moved(third) == frozenset()
    static.load(third)
    assert static.tree["opp"]["idx"] is idx and idx.tolist() == [2, 0]
    assert float(static.tree["speed_weight"]) == 0.25
    other = dict(third, opp={**third["opp"], "params": [pool.clone()]})
    assert static.moved(other) == {("opp", "params", 0)}

"""The port's data-parallel training (``parallel/mesh.py``, ``PPOTrainer.shard``)
against its one-process layout and against the JAX package's sharded update on
the virtual CPU mesh, at tests/test_parallel.py's sizes (16 envs x 32 steps, 4
minibatches, 2 epochs).

The equivalence: a run over D processes with ``data_shards = D`` computes what one
process computes with ``data_shards = D`` on all the envs, and what JAX computes
with the env axis sharded over D devices. The port's runs here are 2 CPU processes
in a gloo group (``test_torch_dist_workers.run_ranks``, spawned, one thread each, with a
time limit), one process with ``data_shards = 2``, and JAX's program with the env
axis on 2 of conftest's 8 virtual devices. All three are fed the same draws
(action noise, the permutation constants of JAX's per-shard keys) in float64.

Tolerances: the 2-process run against the one-process run differs only in the
order of its sums (a mean of two half-minibatch means, Chan's combination of the
advantage moments), so the float64 state agrees to rtol 1e-9 and every
per-minibatch stat (float32 on the host) to rtol 1e-6, with the exit minibatch
exact; with the observation normalizer, whose float32 moments are combined over
the ranks, the policy's float32 inputs move by an ulp and the state agrees to
rtol 1e-5 / atol 1e-6. Against JAX the tolerances of the one-process comparisons hold
(tests/test_torch_trainer.py: parameters and Adam moments rtol 1e-6 / atol 1e-7,
the float32 metric vector rtol 1e-5 / atol 1e-6, the exit decision exact): XLA's
and PyTorch's CPU math round tanh and exp differently.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from self_play_racing_tpu.agent import ppo as jppo
from self_play_racing_tpu.agent.trainer import make_single_env_hooks as jhooks
from self_play_racing_tpu.configs import base_config as jbase_config
from self_play_racing_tpu.envs import single as jenv
from self_play_racing_tpu.envs import track as jtrack
from self_play_racing_tpu.models import actor_critic as jnet
from self_play_racing_tpu.parallel import mesh as jmesh
import chip_smoke
from test_torch_dist_workers import (SingleBuild, _AdamLike, group_of_one, loss_rank,
                                     ppo_update_once, ppo_update_rank, run_ranks,
                                     update_step_rank, world_one_rank)
from test_torch_learner import UPDATE_CASES as LEARNER_CASES
from test_torch_learner import ACT_DIM, _batch, _params
from test_torch_learner import _jax_consts as _learner_consts
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse fixture)
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch.agent import ppo as tppo
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
from self_play_racing_tpu_torch.configs import base_config
from self_play_racing_tpu_torch.envs import single as tenv
from self_play_racing_tpu_torch.envs import track as ttrack
from self_play_racing_tpu_torch.parallel import mesh as pmesh

N, T = 16, 32
SIZES = dict(num_envs=N, num_steps=T, num_minibatches=4, update_epochs=2,
             total_timesteps=N * T * 4)
TIMEOUT = 150  # seconds for a 2-process run (each child: import, build, one update)
KL_FIRST_EPOCH_EXIT = 0.001


def _jax_mesh(n=2):
    return jmesh.make_mesh(jax.devices()[:n])


def _jax_consts(ukey, epochs, shards):
    """JAX's permutation constants [E, D, 8] from the update's key: per epoch
    key, per shard key, ``bits((8,))``."""
    ekeys = jax.random.split(ukey, epochs)
    dkeys = jax.vmap(lambda k: jax.random.split(k, shards))(ekeys)
    consts = jax.vmap(jax.vmap(lambda k: jax.random.bits(k, (8,), jnp.uint32)))(dkeys)
    return np.asarray(consts).astype(np.int64)


def _close_trees(got, want, rtol, atol=0.0):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol, atol=atol)


def _assert_stats_close(got, want, rtol=1e-6, atol=1e-7):
    np.testing.assert_array_equal(got["computed"], want["computed"])
    np.testing.assert_array_equal(got["applied"], want["applied"])
    for k in tppo.STAT_NAMES[:6]:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


# ------------------------------------------------------------ the minibatch loop

def _learner_inputs(kl_target):
    """A seeded rollout-like flat batch [T*N] in float64 whose two env halves have
    advantages of different location and scale, the JAX train state, lr."""
    kw = dict(SIZES, data_shards=2, kl_target=kl_target, learning_rate=3e-3)
    cfg, jcfg = base_config(**kw), jbase_config(**kw)
    rng = np.random.default_rng(0)
    b = T * N
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64),
                          jnet.init_params(jax.random.key(3), 15, 2))
    log_std = jnp.full((2,), -0.5, jnp.float32)
    obs = rng.normal(size=(b, 15))
    actions = np.clip(rng.normal(0.0, 0.7, size=(b, 2)), -1.0, 1.0)
    lp = np.asarray(jnet.evaluate_action(params, log_std, obs, actions)[0])
    half = (np.arange(b) % N) < N // 2  # env halves: rank 0's and rank 1's envs
    adv = np.where(half, 1.5 + rng.normal(size=b), -0.5 + 4.0 * rng.normal(size=b))
    values = rng.normal(size=b)
    flat = (obs, actions, lp + rng.normal(0.0, 0.05, size=b), adv, values + adv, values)
    return cfg, jcfg, params, flat


def _jax_learner(jcfg, params, flat, lr):
    """JAX's run_ppo_update with the batch's env axis on 2 virtual devices."""
    opt = jppo.make_optimizer(jcfg)
    opt_state = opt.init(params)
    key = jax.random.key(11)
    mesh = _jax_mesh()
    steps = [jax.device_put(x.reshape((T, N) + x.shape[1:]),
                            NamedSharding(mesh, P(None, "data"))) for x in flat]

    @jax.jit
    def run(steps):
        fl = jppo.Batch(*(x.reshape((T * N,) + x.shape[2:]) for x in steps))
        return jppo.run_ppo_update(jcfg, opt, params, opt_state,
                                   jnp.full((2,), -0.5, jnp.float32), lr, fl, key)

    p, o, stopped, stats = run(steps)
    consts = _jax_consts(key, jcfg.update_epochs, 2)
    adam = o[1]
    init = (jax.tree.map(np.asarray, params),
            jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, params)),
            jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, params)), 0)
    return init, consts, (p, adam.mu, adam.nu, int(adam.count)), bool(stopped), \
        {k: np.asarray(v) for k, v in stats.items()}


@pytest.mark.parametrize("kl_target", [0.5, 0.004, KL_FIRST_EPOCH_EXIT])
def test_minibatch_loop_two_processes_match_one_process_and_jax(kl_target):
    """run_ppo_update over 2 gloo ranks = one process with data_shards = 2 = JAX's
    sharded loop: every per-minibatch stat, the exit minibatch, parameters and
    Adam moments (0.5: all 8 minibatches applied; 0.004: the KL exit midway;
    KL_FIRST_EPOCH_EXIT: the exit inside the first epoch, whose masked tail runs).
    Every minibatch's advantage moments are reduced before the loop, so a rank
    makes 2 all-reduces for them and 1 a minibatch run."""
    cfg, jcfg, params, flat = _learner_inputs(kl_target)
    lr = np.float32(3e-3)
    init, consts, jstate, jstopped, jstats = _jax_learner(jcfg, params, flat, lr)

    one_stats, one_stopped, one = ppo_update_once(cfg, init, flat, consts, lr)
    ranks = run_ranks(ppo_update_rank, 2, cfg, init, flat, consts, lr, timeout=TIMEOUT)

    applied = int(jstats["applied"].sum())
    assert (applied == 8) == (kl_target == 0.5) and applied >= 1
    if kl_target == KL_FIRST_EPOCH_EXIT:
        assert applied < cfg.num_minibatches
    assert one_stopped == jstopped == (applied < 8)
    _assert_stats_close(one_stats, jstats, rtol=1e-5, atol=1e-6)
    p, mu, nu, count, _ = one
    assert count == jstate[3] == applied
    _close_trees((p, mu, nu), jstate[:3], rtol=1e-6, atol=1e-7)
    run = -(-int(one_stats["computed"].sum()) // cfg.num_minibatches) * cfg.num_minibatches
    for stats, stopped, state, reduces in ranks:
        assert reduces == 2 + run
        assert stopped == one_stopped
        _assert_stats_close(stats, one_stats)
        assert state[3] == count
        _close_trees(state[:3], one[:3], rtol=1e-9, atol=1e-12)
    # every rank holds the same state, bitwise
    _close_trees(ranks[0][2][:3], ranks[1][2][:3], rtol=0.0)


def test_advantage_normalization_is_global():
    """Each rank's half of a minibatch normalizes its advantages by the whole
    minibatch's mean and unbiased std: the mean of the ranks' losses is the
    one-process loss, and normalizing each half by its own moments (what a
    DDP-style local normalization computes) gives another loss."""
    cfg = base_config(**SIZES)
    rng = np.random.default_rng(1)
    m = 256
    obs, actions = rng.normal(size=(m, 15)), np.clip(rng.normal(size=(m, 2)), -1, 1)
    adv = np.concatenate([2.0 + rng.normal(size=m // 2), -1.0 + 5.0 * rng.normal(size=m // 2)])
    values = rng.normal(size=m)
    mb = (obs, actions, rng.normal(-2.0, 0.1, size=m), adv, values + 1.0, values)
    params = tppo.net.init_params(torch.Generator().manual_seed(0), 15, 2,
                                  dtype=torch.float64)
    log_std = torch.full((2,), -0.5)
    whole = tppo.Batch(*(torch.as_tensor(x) for x in mb))
    loss, _ = tppo._ppo_loss(params, log_std, whole, cfg, *chip_smoke.flat_moments(whole.advantages))
    halves = [tppo.Batch(*(torch.as_tensor(x[h * m // 2:(h + 1) * m // 2]) for x in mb))
              for h in range(2)]
    local = [tppo._ppo_loss(params, log_std, half, cfg, *chip_smoke.flat_moments(half.advantages))[0]
             for half in halves]

    ranks = run_ranks(loss_rank, 2, mb, cfg, timeout=TIMEOUT)
    assert ranks[0][1]["approx_kl"] != ranks[1][1]["approx_kl"]  # each its own half
    global_loss = 0.5 * (ranks[0][0] + ranks[1][0])
    np.testing.assert_allclose(global_loss, float(loss), rtol=1e-12)
    local_loss = 0.5 * float(local[0] + local[1])
    assert abs(local_loss - float(loss)) > 1e-3 * abs(float(loss))


def _learner_case(case):
    """The port's inputs of ``tests/test_torch_learner.py``'s ``UPDATE_CASES[case]``
    (its ``update_both``): cfg, a fresh float64 model and Adam state, log_std, lr,
    the flat batch and the epoch permutations."""
    overrides, lr, seed, _ = LEARNER_CASES[case]
    kw = dict(num_envs=8, num_steps=16, num_minibatches=4, update_epochs=3,
              shuffle_block_size=4, total_timesteps=8 * 16 * 4, **overrides)
    cfg = base_config(**kw)
    params = _params(4)
    log_std = np.full((ACT_DIM,), -0.9, np.float32)
    b = _batch(params, cfg.batch_size, log_std, seed)
    _, n_units, _ = tppo.minibatch_layout(cfg)
    _, consts = _learner_consts(jax.random.key(11), cfg.update_epochs, cfg.data_shards)
    perms = tppo.epoch_permutation(None, n_units, shape=consts.shape[:2],
                                   consts=torch.as_tensor(consts))

    def fresh():
        zeros = jax.tree.map(np.zeros_like, params)
        return interop.train_state_from_jax(
            params, (_AdamLike(0, zeros, zeros),), 0, dtype=torch.float64, device="cpu")

    flat = tppo.Batch(**{k: torch.as_tensor(v) for k, v in b.items()})
    return cfg, fresh, torch.as_tensor(log_std), np.float32(lr), flat, perms


@pytest.mark.parametrize("case", sorted(LEARNER_CASES))
def test_advantage_moments_up_front_are_each_minibatchs_own(case, tmp_path, monkeypatch):
    """On one process (a gloo group of one) every minibatch's advantage moments,
    formed before the loop and reduced in two all-reduces, are bitwise the
    minibatch's own ``adv.mean()`` and ``adv.std(correction=1)``, in each of the
    learner's ``UPDATE_CASES`` (exits mid-epoch, on an epoch's last minibatch and on
    the first, two data shards): every row of the table, bitwise the table the
    update forms without a group, and what each minibatch run normalized by (the
    table's row at the loop's minibatch), against the minibatch's own moments and
    what the update without a group normalizes by. The update over the group is then
    bitwise the one without: stats, parameters and Adam state. It makes 2
    all-reduces for the moments and 1 a minibatch run."""
    cfg, fresh, log_std, lr, flat, perms = _learner_case(case)
    seen = {"group": [], "none": []}
    loss = tppo._ppo_loss
    where = None

    def recording(params, log_std, mb, cfg, moments, at, norm=None):
        adv = tppo.mbops.gather_units(mb.advantages, mb.rows).detach()
        row = moments.index_select(0, at)[0]
        assert torch.equal(row, torch.stack([adv.mean(), adv.std(correction=1)]))
        seen[where].append(row)
        return loss(params, log_std, mb, cfg, moments, at, norm)

    monkeypatch.setattr(tppo, "_ppo_loss", recording)
    runs = {}
    with group_of_one() as mesh:
        _, n_units, _ = tppo.minibatch_layout(cfg)
        units = tppo.Batch(*(x.reshape((cfg.data_shards * n_units,) + x.shape[2:])
                             for x in tppo.shard_blocks(cfg, flat)))
        index = tppo.minibatch_index(cfg, perms)
        table = tppo.advantage_moments(cfg, units, index, mesh)
        assert torch.equal(table, tppo.advantage_moments(cfg, units, index))
        for i in range(index.shape[0]):
            adv = units.advantages.index_select(0, index[i]).reshape(cfg.minibatch_size)
            assert torch.equal(table[i], torch.stack([adv.mean(), adv.std(correction=1)]))
        for where in ("group", "none"):
            train = fresh()
            with chip_smoke.all_reduce_calls() as reduces:
                opt, stop, stats = tppo.run_ppo_update(
                    cfg, train.model, train.opt_state, log_std, lr, flat, perms,
                    mesh=mesh if where == "group" else None)
            runs[where] = (sum(reduces), stop, stats, opt,
                           [p.detach() for p in train.model.parameters()])
    (g_reduces, g_stop, g_stats, g_opt, g_params) = runs["group"]
    (n_reduces, n_stop, n_stats, n_opt, n_params) = runs["none"]
    run = len(seen["none"])
    assert run == -(-int(n_stats["computed"].sum()) // cfg.num_minibatches) \
        * cfg.num_minibatches
    assert len(seen["group"]) == run and (g_reduces, n_reduces) == (2 + run, 0)
    for g_row, row in zip(seen["group"], seen["none"]):
        assert torch.equal(g_row, row)
    assert g_stop == n_stop
    for k in tppo.STAT_NAMES:
        np.testing.assert_array_equal(g_stats[k], n_stats[k], err_msg=k)
    assert g_opt.count == n_opt.count
    for a, b in zip(g_params + g_opt.mu + g_opt.nu, n_params + n_opt.mu + n_opt.nu):
        assert torch.equal(a, b)


# ------------------------------------------------------------- the whole update

def _tracks(dtype_j=jnp.float64, dtype_t=torch.float64):
    ids = np.arange(N) % 4
    np.random.seed(1)
    cps = jtrack.gen_tracks(4, seed=1)
    jtr = jtrack.gather_tracks(jtrack.make_track_pool(cps, [8.0] * 4, dtype=dtype_j), ids)
    ttr = ttrack.gather_tracks(ttrack.make_track_pool(cps, [8.0] * 4, dtype=dtype_t,
                                                      device="cpu"), ids)
    return jtr, ttr


def _numpy_train(params, opt_state):
    """JAX's params and optax state as (params, (count, mu, nu)) numpy pytrees."""
    adam = opt_state[1]
    host = lambda t: jax.tree.map(np.asarray, t)
    return host(params), (int(adam.count), host(adam.mu), host(adam.nu))


def _jax_draws(key, steps, envs, epochs, shards):
    """JAX's action noise [T, N, 2] and the permutation constants [E, D, 8] of one
    update_step from the runner's key."""
    noise = []
    for _ in range(steps):
        key, akey = jax.random.split(key)
        noise.append(np.asarray(jax.random.normal(akey, (envs, 2), jnp.float64)))
    _, ukey = jax.random.split(key)
    return np.stack(noise), _jax_consts(ukey, epochs, shards)


UPDATE_CASES = {"plain": {}, "normalize_obs": dict(normalize_obs=True)}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_step_two_processes_match_one_process_and_jax(case):
    """One whole PPO update (rollout, GAE, the minibatch loop, the packed metrics)
    of the trainer sharded over 2 gloo ranks = the one-process trainer with
    data_shards = 2 = JAX's update_step with the runner sharded over 2 devices."""
    kw = dict(SIZES, data_shards=2, kl_target=0.5, learning_rate=1e-3,
              **UPDATE_CASES[case])
    cfg, jcfg = base_config(**kw), jbase_config(**kw)
    jtr, _ = _tracks()
    hooks = jhooks(jenv.RacingConfig(num_sensors=11))
    jrunner = jppo.init_runner(jax.random.key(3), jcfg, hooks, jtr, 15, 2)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jrunner.train.params)
    opt_state = jppo.make_optimizer(jcfg).init(params)
    jrunner = jrunner.replace(train=jrunner.train.replace(params=params, opt_state=opt_state))
    noise, consts = _jax_draws(jrunner.key, T, N, cfg.update_epochs, 2)
    runner_s, aux_s = jmesh.shard_runner(jrunner, jtr, _jax_mesh(), N)
    jout, jpacked = jax.jit(jppo.make_update_step(jcfg, hooks, 2))(runner_s, aux_s)
    jm = jppo.unpack_metrics(jpacked)

    build = SingleBuild(kw, *_numpy_train(params, opt_state))
    one = build()
    out, packed = one.update_step(one.runner, one.aux, noise=torch.as_tensor(noise),
                                  perm_consts=torch.as_tensor(consts))
    feed = {"noise": noise, "perm_consts": consts}
    ranks = run_ranks(update_step_rank, 2, build, feed, timeout=TIMEOUT)

    m = tppo.unpack_metrics(packed)
    for k in ("update", "global_step", "lr", "log_std", "episodes", "kl_stopped",
              "minibatches_applied"):
        assert m[k] == jm[k], k
    assert m["minibatches_applied"] == 8
    np.testing.assert_allclose(packed, np.asarray(jpacked), rtol=1e-5, atol=1e-6)
    p, adam, _ = interop.train_state_to_numpy(out.train)
    jadam = jout.train.opt_state[1]
    _close_trees((p, adam["mu"], adam["nu"]), (jout.train.params, jadam.mu, jadam.nu),
                 rtol=1e-6, atol=1e-7)
    if cfg.normalize_obs:
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(out.obs_norm, k).numpy(),
                                       np.asarray(getattr(jout.obs_norm, k)), rtol=1e-5)

    # the normalizer's float32 moments are combined over the ranks: the policy's
    # float32 inputs move by an ulp, which Adam's 1/sqrt(nu) lifts to ~3e-7 on a
    # near-zero gradient's coordinate (8 steps at lr 1e-3)
    tol = dict(rtol=1e-5, atol=1e-6) if cfg.normalize_obs else dict(rtol=1e-9, atol=1e-12)
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got["packed"], packed, rtol=1e-6, atol=1e-7)
        assert got["packed"][8] == packed[8]  # minibatches_applied
        assert got["train"][3] == adam["count"]
        _assert_stats_close(got["ustats"], ranks[0]["ustats"], rtol=0.0, atol=0.0)
        _close_trees(got["train"][:3], (p, adam["mu"], adam["nu"]), **tol)
        rows = slice(rank * N // 2, (rank + 1) * N // 2)
        np.testing.assert_array_equal(got["done"], out.done.numpy()[rows])
        np.testing.assert_allclose(got["obs"], out.obs.numpy()[rows], rtol=1e-6)
        for g, w in zip(got["obs_norm"], (out.obs_norm.mean, out.obs_norm.var,
                                          out.obs_norm.count)):
            np.testing.assert_allclose(g, w.numpy(), rtol=1e-6)
    _close_trees(ranks[0]["train"][:3], ranks[1]["train"][:3], rtol=0.0)


def test_group_of_one_is_bitwise_the_single_process_update():
    """The mesh path over a gloo group of one process (every collective runs)
    gives bitwise the update without a group: the weights of the combined
    moments are 1 and a one-rank sum is its operand."""
    kw = dict(SIZES, kl_target=0.01, learning_rate=1e-3, normalize_obs=True)
    jcfg = jbase_config(**kw)
    params = jnet.init_params(jax.random.key(3), 15, 2)
    opt_state = jppo.make_optimizer(jcfg).init(params)
    rng = np.random.default_rng(2)
    feed = {"noise": rng.normal(size=(T, N, 2)),
            "perm_consts": rng.integers(0, 2**32, size=(2, 1, 8))}
    [(sharded, packed, plain)] = run_ranks(
        world_one_rank, 1, SingleBuild(kw, *_numpy_train(params, opt_state)), feed,
        timeout=TIMEOUT)
    np.testing.assert_array_equal(sharded["packed"], packed)
    assert sharded["train"][3] == plain[3] > 0
    _close_trees(sharded["train"][:3], plain[:3], rtol=0.0)


# -------------------------------------------------------- layout and placement

def test_shard_local_minibatch_layout():
    """Shard d of the one-process layout with data_shards = D is rank d's whole
    batch in the one-shard layout: a rank's minibatch part is its own samples."""
    cfg = base_config(**SIZES, data_shards=2)
    local = dataclasses.replace(cfg, num_envs=N // 2, data_shards=1)
    assert tppo.minibatch_layout(local) == tppo.minibatch_layout(cfg) == (8, 32, 8)
    ids = torch.arange(T * N, dtype=torch.float64)  # flat index t*N + n
    flat = tppo.Batch(*(ids for _ in range(6)))
    blocked = tppo.shard_blocks(cfg, flat)
    for rank in range(2):
        mine = ids.reshape(T, N)[:, rank * N // 2:(rank + 1) * N // 2].reshape(-1)
        own = tppo.shard_blocks(local, tppo.Batch(*(mine for _ in range(6))))
        assert torch.equal(blocked.obs[rank], own.obs[0])
        assert set((blocked.obs[rank].long() % N).unique().tolist()) == \
            set(range(rank * N // 2, (rank + 1) * N // 2))


def _cpu_mesh(world, rank):
    return pmesh.DataMesh(world=world, rank=rank, device=torch.device("cpu"))


def _single_trainer(**kw):
    np.random.seed(1)
    cps = ttrack.gen_tracks(4, seed=1)
    pool = ttrack.make_track_pool(cps, [8.0] * 4, device="cpu")
    cfg = base_config(**{**SIZES, **kw})
    return PPOTrainer(cfg, tenv.RacingConfig(num_sensors=11),
                      ttrack.gather_tracks(pool, np.arange(cfg.num_envs) % 4))


def test_mismatch_errors():
    """num_envs not divisible by the data axis and a data_shards that is neither 1
    nor the data axis are refused with JAX's messages; a model axis that does not
    divide the world is refused as JAX refuses it; without a group the mesh is one
    process and distributed_init a no-op."""
    tr = _single_trainer(num_envs=12, total_timesteps=12 * T * 4)
    with pytest.raises(ValueError, match="not divisible by the mesh's data axis"):
        tr.shard(_cpu_mesh(8, 0))
    tr = _single_trainer(data_shards=4)
    with pytest.raises(ValueError, match=r"data_shards=4 does not match the mesh's data "
                                         r"axis \(2\)"):
        tr.shard(_cpu_mesh(2, 0))
    with pytest.raises(ValueError, match="must be divisible by data_shards"):
        base_config(**{**SIZES, "num_envs": 12, "total_timesteps": 12 * T * 4},
                    data_shards=8)
    with pytest.raises(ValueError, match="1 devices not divisible by model_parallel=2"):
        pmesh.make_mesh("cpu", model_parallel=2)
    assert pmesh.distributed_init(None) is None
    mesh = pmesh.make_mesh("cpu")
    assert (mesh.world, mesh.rank, mesh.group, mesh.shape) == (1, 0, None, {"data": 1})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pmesh.make_mesh()


def test_capacity_layouts_per_rank():
    """Each rank keeps the whole pool and its envs' ids and scalars: tiled keeps
    reps / world (or reads by ids where the world does not divide reps), grouped
    slices its block ids where the blocks divide and keeps them whole otherwise;
    a rank's layout resolves to its rows of the whole run's, and its env reset
    and observations are those rows of the whole run's."""
    np.random.seed(1)
    pool = ttrack.make_track_pool(ttrack.gen_tracks(4, seed=1), [8.0] * 4, device="cpu")
    env_cfg = tenv.RacingConfig(num_sensors=11)
    layouts = {
        "tiled": ttrack.tiled_pooled_tracks(pool, 16),
        "tiled_odd_reps": ttrack.tiled_pooled_tracks(pool, 12),
        "grouped": ttrack.grouped_pooled_tracks(pool, np.arange(4), 4),
        "grouped_whole_blocks": ttrack.grouped_pooled_tracks(pool, np.arange(3), 4),
        "gather": ttrack.pooled_tracks(pool, np.arange(16)[::-1] % 4),
    }
    for name, layout in layouts.items():
        n = layout.num_envs
        state, obs = tenv.reset(env_cfg, layout)
        for rank in range(2):
            mesh = _cpu_mesh(2, rank)
            mine = pmesh.shard_by_env_axis({"track": layout, "x": torch.arange(n)},
                                           mesh, n)
            got = mine["track"]
            assert got.pool is layout.pool, name
            rows = slice(rank * n // 2, (rank + 1) * n // 2)
            assert torch.equal(mine["x"], torch.arange(n)[rows])
            assert torch.equal(got.ids, layout.ids[rows]), name
            whole = ttrack.resolve(layout)
            for f in dataclasses.fields(whole):
                assert torch.equal(getattr(ttrack.resolve(got), f.name),
                                   getattr(whole, f.name)[rows]), (name, f.name)
            _, local_obs = tenv.reset(env_cfg, got)
            assert torch.equal(local_obs, obs[rows]), name
            if name == "tiled":
                assert isinstance(got, ttrack.TiledPooledTracks) and got.reps == 2
            if name == "tiled_odd_reps":  # 3 envs a track do not halve
                assert type(got) is ttrack.PooledTracks
            if name == "grouped":
                assert torch.equal(got.block_ids, torch.tensor([0, 1], dtype=torch.int32)
                                   + 2 * rank)
            if name == "grouped_whole_blocks":  # 3 blocks over 2 ranks: kept whole
                assert torch.equal(got.block_ids, layout.block_ids)

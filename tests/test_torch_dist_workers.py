"""Runs a function in several CPU processes joined by a gloo group, for the port's
data-parallel tests (tests/test_torch_parallel.py, tests/test_torch_multihost.py).

``run_ranks(fn, world, *args, timeout=...)`` spawns ``world`` processes with
``torch.multiprocessing`` (one PyTorch thread each), joins them into a gloo group
over a free localhost port, calls ``fn(rank, *args)`` in each and returns the
results in rank order. ``fn`` must be importable by the children (a module-level
function of a module that does not import JAX: this one, or the port). A child
that raises fails the call with its traceback; a run that outlives ``timeout``
seconds is killed and fails the call.

The functions below it are the ranks' work for those tests; each returns numpy
arrays and plain numbers. The module holds no test of its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
import socket
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import chip_smoke
from self_play_racing_tpu_torch import interop
from self_play_racing_tpu_torch import train as ttrain
from self_play_racing_tpu_torch._tree import shard_rows
from self_play_racing_tpu_torch.agent import ppo
from self_play_racing_tpu_torch.agent.self_play import SelfPlayTrainer
from self_play_racing_tpu_torch.agent.trainer import PPOTrainer
from self_play_racing_tpu_torch.configs import base_config, self_play_config
from self_play_racing_tpu_torch.envs import multi, selfplay
from self_play_racing_tpu_torch.envs import single as senv
from self_play_racing_tpu_torch.envs import track as trk
from self_play_racing_tpu_torch.models import actor_critic as net
from self_play_racing_tpu_torch.parallel import mesh as pmesh
from self_play_racing_tpu_torch.parallel.scaling import main as scaling_main


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(fn, rank, world, port, out_dir, group, args):
    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        if group:
            pmesh.distributed_init(f"127.0.0.1:{port}", world, rank, device="cpu")
            try:
                result = ("ok", fn(rank, *args))
            finally:
                dist.destroy_process_group()
        else:  # fn joins the group itself, at 127.0.0.1:port
            result = ("ok", fn(rank, port, *args))
    except Exception:  # reported to the parent, which fails the test
        result = ("error", traceback.format_exc())
    with open(path, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world, *args, timeout=120.0, group=True):
    """``[fn(0, *args), ..., fn(world - 1, *args)]``, each in its own process of a
    gloo group of ``world``; with ``group=False`` the processes are not joined and
    each calls ``fn(rank, port, *args)`` with the port of 127.0.0.1 to join at
    (for entry points that join the group from their arguments)."""
    ctx = mp.get_context("spawn")
    port = _free_port()
    with tempfile.TemporaryDirectory() as out_dir:
        procs = [ctx.Process(target=_child,
                             args=(fn, r, world, port, out_dir, group, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        alive = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        if alive:
            raise TimeoutError(f"ranks {alive} still running after {timeout} s")
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(f"rank {r} exited with code {procs[r].exitcode} "
                                   "and no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
            results.append(value)
    return results


@contextlib.contextmanager
def group_of_one(device="cpu"):
    """This process joined through ``distributed_init`` as a group of one on
    ``device`` (gloo on the CPU, NCCL on a card; a TCP store on a free localhost
    port), left again on exit: the mesh path's collectives run over one rank.
    Yields the mesh."""
    pmesh.distributed_init(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    try:
        yield pmesh.make_mesh(device)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------- the ranks' work

def train_state_numpy(train):
    """(params, mu, nu, count, update) of a port TrainState, as numpy."""
    params, adam, update = interop.train_state_to_numpy(train)
    return params, adam["mu"], adam["nu"], int(adam["count"]), int(update)


class DrawFeed:
    """Queues of start-grid slots and opponent draws (numpy, the global draws)
    that replace the port's two draw functions, in the order they are asked
    for."""

    def __init__(self, slots, randoms):
        self.slots, self.randoms = list(slots), list(randoms)
        multi.random_grid_slots = self._slots
        selfplay.opponent_randoms = self._randoms

    def _slots(self, n, a, generator, device=None):
        got = self.slots.pop(0)
        assert got.shape == (n, a), (got.shape, n, a)
        return torch.as_tensor(got)

    def _randoms(self, generator, rows, dtype, device):
        noise, uniforms = self.randoms.pop(0)
        assert noise.shape == (rows, 2), (noise.shape, rows)
        return torch.as_tensor(noise, dtype=dtype), torch.as_tensor(uniforms, dtype=dtype)


def recorded_update_stats():
    """Wraps ``ppo.run_ppo_update`` so that each call's per-minibatch stats are
    appended to the returned list."""
    run = ppo.run_ppo_update
    seen = []

    def recording(*args, **kwargs):
        out = run(*args, **kwargs)
        seen.append(out[2])
        return out

    ppo.run_ppo_update = recording
    return seen


def update_step_rank(rank, build, feed):
    """One update of the trainer ``build(mesh)`` returns, sharded over the group,
    fed the global draws ``feed`` (a dict: noise [T, N, A], perm_consts [E, D, 8],
    and for self-play the slot and opponent-draw queues). Returns the packed
    metrics, the per-minibatch stats, the train state and the obs normalizer."""
    mesh = pmesh.make_mesh("cpu")
    seen = recorded_update_stats()
    if "slots" in feed:
        DrawFeed(feed["slots"][:1], [])  # the trainer's construction reset
    trainer = build()
    trainer.shard(mesh)
    if "slots" in feed:
        DrawFeed(feed["slots"][1:], feed["randoms"])
    runner, packed = trainer.update_step(
        trainer.runner, trainer.aux, noise=torch.as_tensor(feed["noise"]),
        perm_consts=torch.as_tensor(feed["perm_consts"]))
    norm = runner.obs_norm
    return {"packed": packed, "ustats": seen[0],
            "train": train_state_numpy(runner.train),
            "obs_norm": [getattr(norm, k).numpy() for k in ("mean", "var", "count")],
            "done": runner.done.numpy(), "obs": runner.obs.numpy()}


def ppo_update_rank(rank, cfg, init, flat, consts, lr):
    """``ppo_update_once`` over the group, with this rank's envs, and the count of
    the all-reduces it made."""
    mesh = pmesh.make_mesh("cpu")
    with chip_smoke.all_reduce_calls() as reduces:
        out = ppo_update_once(cfg, init, flat, consts, lr, mesh)
    return out + (sum(reduces),)


def ppo_update_once(cfg, init, flat, consts, lr, mesh=None):
    """``run_ppo_update`` from the numpy train state ``init`` (params, mu, nu, count)
    on the flat batch ``flat`` (numpy fields, all envs): in one process with
    ``cfg.data_shards`` shards when ``mesh`` is None, else over the group with
    this rank's envs. Returns (stats, stopped, train state as numpy)."""
    params, mu, nu, count = init
    train = interop.train_state_from_jax(params, (_AdamLike(count, mu, nu),), 0,
                                         dtype=torch.float64, device="cpu")
    log_std = torch.full((2,), -0.5, dtype=torch.float32)
    if mesh is None:
        batch = ppo.Batch(*(torch.as_tensor(x) for x in flat))
        perms = ppo.epoch_permutation(None, ppo.minibatch_layout(cfg)[1],
                                      shape=consts.shape[:2], consts=torch.as_tensor(consts))
        opt, stopped, stats = ppo.run_ppo_update(cfg, train.model, train.opt_state, log_std,
                                                 lr, batch, perms)
    else:
        steps = [torch.as_tensor(x).reshape((cfg.num_steps, cfg.num_envs) + x.shape[1:])
                 for x in flat]
        batch = ppo.Batch(*(shard_rows(x, mesh.shard, dim=1) for x in steps))
        opt, stopped, stats = ppo._sharded_update(
            cfg, mesh, train.model, train.opt_state, log_std, lr, batch, None,
            torch.as_tensor(consts), torch.device("cpu"))
    train = dataclasses.replace(train, opt_state=opt)
    return stats, stopped, train_state_numpy(train)


@dataclasses.dataclass
class _AdamLike:
    """The fields of optax's ScaleByAdamState that ``interop`` reads."""

    count: int
    mu: dict
    nu: dict


def _tracks(num_envs):
    """The tests' 4-track pool (widths 8) gathered over ``num_envs`` envs, env i on
    track i % 4 (``gen_tracks`` draws from the global NumPy RNG, seeded here)."""
    np.random.seed(1)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=1), [8.0] * 4, dtype=torch.float64,
                               device="cpu")
    return trk.gather_tracks(pool, np.arange(num_envs) % 4)


@dataclasses.dataclass
class SingleBuild:
    """Builds the port's single-car trainer for ``base_config(**kw)`` on the tests'
    float64 tracks, with the train state ``params`` and ``adam`` = (count, mu, nu)
    (numpy pytrees, e.g. the JAX trainer's). Picklable, so the ranks build the same
    trainer."""

    kw: dict
    params: object
    adam: tuple

    def __call__(self):
        cfg = base_config(**self.kw)
        tr = PPOTrainer(cfg, senv.RacingConfig(num_sensors=11), _tracks(cfg.num_envs))
        tr.runner.train = interop.train_state_from_jax(
            self.params, (_AdamLike(*self.adam),), 0, dtype=torch.float64, device="cpu")
        return tr


def loss_rank(rank, mb, cfg):
    """``_ppo_loss`` on this rank's half of the minibatch ``mb`` (numpy fields), its
    advantages normalized by the group's moments as the update forms them: the
    local ``mean()`` and ``std(correction=1)`` through ``combine_mean_std``."""
    mesh = pmesh.make_mesh("cpu")
    params = net.init_params(torch.Generator().manual_seed(0), 15, 2, dtype=torch.float64)
    part = ppo.Batch(*(shard_rows(torch.as_tensor(x), mesh.shard) for x in mb))
    adv = part.advantages
    mean, std = pmesh.combine_mean_std(adv.mean(), adv.std(correction=1), adv.numel(), mesh)
    at = torch.zeros((1,), dtype=torch.int64)
    loss, st = ppo._ppo_loss(params, torch.full((2,), -0.5), part, cfg,
                             torch.stack([mean, std])[None], at)
    return float(loss), {k: float(v) for k, v in zip(ppo.STAT_NAMES, st)}


def world_one_rank(rank, build, feed):
    """The update with the mesh path over a group of one, and without a group."""
    assert pmesh.make_mesh("cpu").group is not None
    sharded = update_step_rank(rank, build, feed)
    plain = build()
    runner, packed = plain.update_step(plain.runner, plain.aux,
                                       noise=torch.as_tensor(feed["noise"]),
                                       perm_consts=torch.as_tensor(feed["perm_consts"]))
    return sharded, packed, train_state_numpy(runner.train)


# ------------------------------------------------------------- self-play ranks

def selfplay_tracks(num_envs, width, num_tracks=4, seed=5):
    """tests/test_torch_selfplay.py's float64 tracks: widths ``width + i % 4``, env
    i on track i % num_tracks."""
    widths = [width + (i % 4) for i in range(num_tracks)]
    np.random.seed(seed)
    pool = trk.make_track_pool(trk.gen_tracks(num_tracks, seed=seed), widths,
                               dtype=torch.float64, device="cpu")
    return trk.gather_tracks(pool, np.arange(num_envs) % num_tracks)


@dataclasses.dataclass
class SelfPlayBuild:
    """The port's SelfPlayTrainer for ``self_play_config(**kw)`` on
    ``selfplay_tracks``, with the train state ``params``/``adam`` (count, mu, nu)
    and the opponents ``opp`` (numpy: a stacked pool's ``params`` and ``log_std``,
    ``idx`` and ``use_policy`` for every env) in its aux."""

    kw: dict
    env_kw: dict
    width: float
    params: object
    adam: tuple
    opp: dict

    def __call__(self):
        cfg = self_play_config(**self.kw)
        tr = SelfPlayTrainer(cfg, multi.MultiRacingConfig(**self.env_kw),
                             selfplay_tracks(cfg.num_envs, self.width))
        tr.runner.train = interop.train_state_from_jax(
            self.params, (_AdamLike(*self.adam),), 0, dtype=torch.float64, device="cpu")
        pool = interop.pool_from_jax({k: self.opp[k] for k in ("params", "log_std")},
                                     device="cpu")
        tr.aux["opp"] = {**pool, "norm_mean": None, "norm_var": None,
                         "idx": torch.as_tensor(self.opp["idx"]),
                         "use_policy": torch.as_tensor(self.opp["use_policy"])}
        return tr


def pfsp_trainer(kw):
    """test_parallel's scale-mode PFSP trainer at the port: per-env opponents by
    PFSP over a pool of 3, observation normalization, two snapshots taken."""
    cfg = self_play_config(**kw)
    np.random.seed(7)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=1), [8.0] * 4, device="cpu")
    tr = SelfPlayTrainer(cfg, multi.MultiRacingConfig(num_agents=2, num_sensors=11),
                         trk.gather_tracks(pool, np.arange(cfg.num_envs) % 4))
    tr.snapshot_agent()
    tr.snapshot_agent()
    return tr


def pfsp_train(kw, mesh=None):
    """Three updates of ``pfsp_trainer`` (sharded over ``mesh`` when given): the
    PFSP counters, the per-update metrics, the win-rate history and the state."""
    tr = pfsp_trainer(kw)
    if mesh is not None:
        tr.shard(mesh)
    seen = []
    tr.train(num_updates=3, on_update=lambda t, m: seen.append(m))
    return {"wins": tr.pool_wins.copy(), "games": tr.pool_games.copy(),
            "metrics": [dict(m) for m in seen],
            "win_rate": list(tr.training_info["pool_win_rate"]),
            "idx": tr.aux["opp"]["idx"].numpy(),
            "obs_norm": tr.runner.obs_norm.mean.numpy(),
            "train": train_state_numpy(tr.runner.train)}


def pfsp_rank(rank, kw):
    return pfsp_train(kw, pmesh.make_mesh("cpu"))


def checkpoint_resume(kw, ckpt_dir, mesh=None):
    """tests/test_multihost.py's checkpoint worker at the port: an update over the
    mesh, a snapshot, a checkpoint (rank 0 writes), then a fresh trainer loads it,
    is sharded and trains one more update. Returns (global_step, mean_reward,
    snapshots loaded, the resumed train state)."""
    cfg = self_play_config(**kw)
    env_cfg = multi.MultiRacingConfig(num_agents=2, num_sensors=11)

    def track():
        np.random.seed(1)
        pool = trk.make_track_pool(trk.gen_tracks(2, seed=1), [7.0, 8.0], device="cpu")
        return trk.gather_tracks(pool, np.arange(cfg.num_envs) % 2)

    tr = SelfPlayTrainer(cfg, env_cfg, track())
    tr.snapshot_agent()
    tr.select_opponent()
    if mesh is not None:
        tr.shard(mesh)
    tr.runner, _ = tr.update_step(tr.runner, tr.aux)
    tr._host_update = 1
    tr.snapshot_agent()  # after sharding: every rank snapshots the same learner
    path = os.path.join(ckpt_dir, "mh_ckpt")
    tr.save_checkpoint(path)

    tr2 = SelfPlayTrainer(cfg, env_cfg, track())
    tr2.load_checkpoint(path)
    loaded = tr2.num_snapshots
    if mesh is not None:
        tr2.shard(mesh)
    tr2.select_opponent()
    tr2.runner, m2 = tr2.update_step(tr2.runner, tr2.aux)
    m = ppo.unpack_metrics(m2)
    return (int(m["global_step"]), float(m["mean_reward"]), loaded,
            train_state_numpy(tr2.runner.train))


def checkpoint_rank(rank, kw, ckpt_dir):
    return checkpoint_resume(kw, ckpt_dir, pmesh.make_mesh("cpu"))


def scaling_rank(rank, port, out_dir):
    """The scaling CLI as one process of two runs it, joining at ``port``."""
    rows = scaling_main(["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
                 "--process-id", str(rank), "--device", "cpu",
                 "--envs-per-device", "4", "--num-steps", "8",
                 "--baseline-json", os.path.join(out_dir, "baseline.json"),
                 "--out", os.path.join(out_dir, "scaling_2proc.json")])
    return rows[-1]["devices"], rows[-1]["num_envs"]


def train_scale_run(kw, out_dir, coordinator=None, rank=None):
    """``train_scale`` at toy size on the CPU in ``out_dir`` (one process, or rank
    ``rank`` of two joining at ``coordinator``): its printed lines, the config,
    this process's env count and the final train state."""
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(out_dir)
    try:
        with contextlib.redirect_stdout(buf):
            tr = ttrain.train_scale(device="cpu", coordinator=coordinator,
                                   num_processes=None if rank is None else 2,
                                   process_id=rank, **kw)
    finally:
        os.chdir(cwd)
    return (buf.getvalue(), tr.cfg.data_shards, int(tr.runner.done.shape[0]),
            train_state_numpy(tr.runner.train))


def train_scale_rank(rank, port, kw, out_dir):
    try:
        return train_scale_run(kw, out_dir, f"127.0.0.1:{port}", rank)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ tensor-parallel ranks

def gathered_state(trainer):
    """(params, mu, nu, count, update) of a trainer as numpy, whole: a
    tensor-parallel rank's slices gathered over its model group."""
    params, mu, nu = trainer.full_state()
    host = lambda ts: interop._pytree([t.cpu().numpy().copy() for t in ts])
    train = trainer.runner.train
    return host(params), host(mu), host(nu), int(train.opt_state.count), int(train.update)


def tp_updates(build, feed, mesh=None, updates=2):
    """``updates`` updates of the trainer ``build()`` returns (sharded over
    ``mesh`` when given), the first fed ``feed``'s draws, the rest drawn from the
    runner's generator. Returns the local parameter and moment shapes and, per
    update, the packed metrics and the gathered state."""
    trainer = build()
    if mesh is not None:
        trainer.shard(mesh)
    train = trainer.runner.train
    shapes = [[tuple(t.shape) for t in ts] for ts in
              (list(train.model.parameters()), train.opt_state.mu, train.opt_state.nu)]
    out = []
    for u in range(updates):
        kw = {} if u else {"noise": torch.as_tensor(feed["noise"]),
                           "perm_consts": torch.as_tensor(feed["perm_consts"])}
        trainer.runner, packed = trainer.update_step(trainer.runner, trainer.aux, **kw)
        out.append((packed, gathered_state(trainer)))
    return {"shapes": shapes, "updates": out}


def tp_update_rank(rank, build, feed, model_parallel):
    """``tp_updates`` on a mesh of world / model_parallel data rows x
    ``model_parallel`` model ranks; with the mesh's place."""
    mesh = pmesh.make_mesh("cpu", model_parallel=model_parallel)
    out = tp_updates(build, feed, mesh)
    out["mesh"] = (dict(mesh.shape), mesh.axis_names, mesh.rank, mesh.model_rank,
                   mesh.process_rank)
    # shard_params then gather_params gives the whole tree back, bitwise
    full = {k: [(w.detach(), b.detach()) for w, b in layers]
            for k, layers in build().runner.train.model.params().items()}
    back = pmesh.gather_params(pmesh.shard_params(full, mesh))
    out["round_trip"] = all(torch.equal(a, b) for k in full
                            for x, y in zip(full[k], back[k]) for a, b in zip(x, y))
    return out


def tp_selfplay_trainer(kw):
    """A float32 self-play trainer of ``self_play_config(**kw)`` over 2 cars on
    the tests' 4-track pool, built alike in every process from the seed."""
    cfg = self_play_config(**kw)
    np.random.seed(7)
    pool = trk.make_track_pool(trk.gen_tracks(4, seed=1), [8.0] * 4, device="cpu")
    return SelfPlayTrainer(cfg, multi.MultiRacingConfig(num_agents=2, num_sensors=11),
                           trk.gather_tracks(pool, np.arange(cfg.num_envs) % 4))


def tp_selfplay(kw, consts, out_dir=None, mesh=None):
    """One self-play update (through ``train``, its opponents chosen on the host)
    fed the permutation constants ``consts``, then a snapshot; with ``out_dir``
    a checkpoint and an ``.npz`` policy written there (process 0 writes). Returns
    the gathered state, the snapshot's pool slot 0 and the local actor shapes."""
    tr = tp_selfplay_trainer(kw)
    if mesh is not None:
        tr.shard(mesh)
    step = tr.update_step
    tr.update_step = lambda runner, aux: step(runner, aux, perm_consts=torch.as_tensor(consts))
    tr.train(num_updates=1)
    tr.snapshot_agent()
    if out_dir is not None:
        tr.save_checkpoint(os.path.join(out_dir, "tp_ckpt"))
        tr.save(os.path.join(out_dir, "tp_policy.npz"))
    slot = [t[0].numpy().copy() for layers in tr.pool["params"].values()
            for layer in layers for t in layer]
    return {"state": gathered_state(tr), "slot": slot, "num_snapshots": tr.num_snapshots,
            "local": [tuple(p.shape) for p in tr.runner.train.model.parameters()]}


def tp_selfplay_rank(rank, kw, consts, out_dir, model_parallel):
    return tp_selfplay(kw, consts, out_dir, pmesh.make_mesh("cpu", model_parallel=model_parallel))

"""Process group and env-axis layout for data-parallel training (port of
``self_play_racing_tpu/parallel/mesh.py``).

The JAX package lays a 1-D ``('data',)`` mesh over all chips: env state, per-env
track rows, rollout buffers and observations are sharded on the ``num_envs`` axis;
params, optimizer state and the opponent pool are replicated; XLA inserts the
all-reduces from the sharding. Here each process owns one device and
``num_envs / world`` envs of the run, and every reduction over the env or batch
axis is written out as a collective over the process group (NCCL on the card,
gloo on the CPU):

- the minibatch gradient and the minibatch's stats (losses, entropy, approx_kl,
  clip_frac) are averaged over the group in one flat all-reduce before the host
  reads them, so every rank clips by the global norm and takes the same KL exit
  (``agent/ppo.py:run_ppo_update``);
- the minibatch advantage normalization takes the global mean and unbiased std
  (``global_mean_std``, two scalar all-reduces);
- the observation normalizer merges the global batch moments (``global_moments``);
- the rollout's episode sums, the mean reward and the self-play PFSP win/game
  counters are summed over the group before the metrics reach the host.

Random streams are global: every rank draws the whole run's action noise,
start-grid slots, opponent draws and permutation constants from the same seeded
generators and keeps its own rows (``DataMesh.shard``, ``_tree.shard_rows``). So a
run over D processes computes what one process computes with ``data_shards = D``
on all the envs, up to the order of the sums.

With no process group (one process, nothing initialized) no collective runs and
the trainers keep their single-process path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from .._tree import shard_rows
from ..envs import track as trk


def distributed_init(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     device=None):
    """Join the process group; a no-op when nothing is configured, as in JAX.

    ``coordinator_address`` is rank 0's ``host:port`` (or a ``tcp://``/``file://``
    URL); every process passes the same value with its own ``process_id``. The
    backend defaults to ``nccl`` for a CUDA ``device`` (the default device) and
    ``gloo`` for the CPU. A CUDA device without an index becomes
    ``cuda:<process_id % device_count>``, made the current device."""
    if coordinator_address is None:
        return
    if num_processes is None or process_id is None:
        raise ValueError("distributed_init: a coordinator address needs "
                         "num_processes and process_id")
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(process_id) % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    url = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """This process's place on the 1-D data axis: ``world`` processes, this one
    ``rank``, owning ``device``. ``group`` is the process group the collectives
    run over, None for one process with nothing initialized."""

    world: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    axis: str = "data"

    @property
    def shape(self) -> dict:
        return {self.axis: self.world}

    @property
    def axis_names(self) -> tuple:
        return (self.axis,)

    @property
    def shard(self) -> tuple:
        """``(rank, world)``: which of ``world`` equal row blocks of a global axis
        this process owns (the argument of ``_tree.shard_rows``)."""
        return (self.rank, self.world)


def make_mesh(devices=None, axis: str = "data", model_parallel: int = 1) -> DataMesh:
    """The data mesh over the initialized process group (world 1 without one).

    ``devices``: None for the current CUDA device, one device for this process,
    or one per rank (this process takes ``devices[rank]``). ``model_parallel`` > 1
    (the JAX package's tensor-parallel towers) is not ported."""
    if model_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={model_parallel}: tensor-parallel towers are not ported "
            "yet; the port's mesh is data parallel only (model_parallel=1)")
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if isinstance(devices, (list, tuple)):
        if len(devices) != world:
            raise ValueError(f"make_mesh: {len(devices)} devices for a group of {world} "
                             "processes (one device per process)")
        devices = devices[rank]
    dev = resolve_device(devices)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return DataMesh(world=world, rank=rank, device=dev,
                    group=dist.group.WORLD if initialized else None, axis=axis)


# ------------------------------------------------------------------ collectives

def all_reduce_sum_(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``x`` over the group, in place; returns it."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def global_mean_std(x: torch.Tensor, mesh: DataMesh):
    """Mean and unbiased std of the union of every rank's ``x`` (equal sizes), as
    [1] tensors: the local moments combined by Chan's rule, one all-reduce for
    the mean and one for the variance. With one rank both are ``x.mean()`` and
    ``x.std(correction=1)`` bitwise: the weights are 1, the between-rank term 0,
    and sqrt(s * s) == s in IEEE arithmetic."""
    n, total = x.numel(), x.numel() * mesh.world
    mean = x.mean()
    gmean = all_reduce_sum_(((n / total) * mean).reshape(1), mesh)
    if n > 1:
        std = x.std(correction=1)
        within = ((n - 1) / (total - 1)) * std * std
    else:  # one sample a rank: no spread within it
        within = torch.zeros_like(mean)
    between = (n / (total - 1)) * (mean - gmean) ** 2
    gvar = all_reduce_sum_(within + between, mesh)
    return gmean, gvar.sqrt()


def global_moments(x: torch.Tensor, mesh: DataMesh):
    """Mean and biased variance over dim 0 of the union of every rank's ``x``
    (equal row counts), combined from the local moments as ``global_mean_std``
    combines them: with one rank, ``x.mean(0)`` and ``x.var(0, correction=0)``
    bitwise."""
    w = 1.0 / mesh.world
    mean, var = x.mean(dim=0), x.var(dim=0, correction=0)
    gmean = all_reduce_sum_(w * mean, mesh)
    gvar = all_reduce_sum_(w * var + w * (mean - gmean) ** 2, mesh)
    return gmean, gvar


def all_gather_rows(x: torch.Tensor, mesh: DataMesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated in rank order along ``dim``."""
    parts = [torch.empty_like(x) for _ in range(mesh.world)]
    dist.all_gather(parts, x.contiguous(), group=mesh.group)
    return torch.cat(parts, dim=dim)


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if mesh is None or mesh.group is None:
        return
    if dist.get_backend(mesh.group) == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)


# ------------------------------------------------------------------- placement

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree) for t in _tensors(getattr(tree, f.name))]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


@torch.no_grad()
def replicate_tree(tree, mesh: DataMesh):
    """Make every tensor of ``tree`` rank 0's value on every rank (a broadcast in
    place; nothing without a group). Returns ``tree``: the placement of what
    the JAX package replicates (params, optimizer state, the opponent pool)."""
    if mesh.group is not None:
        for t in _tensors(tree):
            dist.broadcast(t, src=0, group=mesh.group)
    return tree


def shard_by_env_axis(tree, mesh: DataMesh, num_envs: int):
    """This rank's part of ``tree``: every tensor whose dim 0 is ``num_envs`` keeps
    this rank's rows (a copy), every other leaf stays whole (replicated).

    The capacity layouts follow their invariant rather than their shapes, so the
    pool stays whole even where its track count equals ``num_envs``: a layout
    keeps the whole pool with this rank's ids and per-env scalars; a tiled layout
    keeps ``reps / world`` (its rows are then again ``arange(n) % T``, or a layout
    by arbitrary ids where the world does not divide ``reps``); a grouped layout
    slices ``block_ids`` where the blocks divide over the world and keeps them
    whole otherwise. The env kernels read the whole pool by this rank's ids."""
    def take(x):
        return shard_rows(x, mesh.shard).clone()

    def place(x):
        if isinstance(x, trk.LAYOUTS):
            if x.ids.shape[0] != num_envs:
                return x
            fields = dict(pool=x.pool, ids=take(x.ids),
                          env=trk.TrackScalars(**{f.name: take(getattr(x.env, f.name))
                                                  for f in dataclasses.fields(x.env)}))
            if isinstance(x, trk.TiledPooledTracks):
                if x.reps % mesh.world == 0:
                    return trk.TiledPooledTracks(**fields, reps=x.reps // mesh.world)
                return trk.PooledTracks(**fields)
            if isinstance(x, trk.GroupedPooledTracks):
                blocks = x.block_ids
                if blocks.shape[0] % mesh.world == 0:
                    blocks = take(blocks)
                return trk.GroupedPooledTracks(**fields, block_ids=blocks,
                                               block_envs=x.block_envs)
            return trk.PooledTracks(**fields)
        if isinstance(x, torch.Tensor):
            return take(x) if x.ndim >= 1 and x.shape[0] == num_envs else x
        if dataclasses.is_dataclass(x):
            return type(x)(**{f.name: place(getattr(x, f.name)) for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(tree)


def shard_runner(runner, aux, mesh: DataMesh, num_envs: int):
    """Place a PPO ``RunnerState`` and its ``aux`` for data-parallel execution:
    the env state, observations and done flags keep this rank's envs, the train
    state and the observation normalizer are rank 0's on every rank, the
    generators stay as they are (every rank draws the global stream).

    num_envs must divide evenly over the data axis: uneven shards would skew the
    per-device work and break the shard-local minibatch layout's equal strata
    (``ppo.run_ppo_update``)."""
    if num_envs % mesh.world != 0:
        raise ValueError(
            f"num_envs={num_envs} is not divisible by the mesh's data axis "
            f"({mesh.axis}={mesh.world}); choose num_envs as a multiple of "
            f"the data-parallel degree so every device owns an equal env shard")
    train = runner.train
    replicate_tree([p.detach() for p in train.model.parameters()]
                   + list(train.opt_state.mu) + list(train.opt_state.nu), mesh)
    runner = dataclasses.replace(
        runner,
        vec=shard_by_env_axis(runner.vec, mesh, num_envs),
        obs=shard_rows(runner.obs, mesh.shard).clone(),
        done=shard_rows(runner.done, mesh.shard).clone(),
        obs_norm=replicate_tree(runner.obs_norm, mesh),
    )
    return runner, shard_by_env_axis(aux, mesh, num_envs)

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
  clip_frac) are averaged over the group in one flat all-reduce before the
  device decides the clip and the KL exit, so every rank clips by the global norm
  and takes the same exit (``agent/ppo.py:minibatch_step``);
- each minibatch's advantage normalization takes the global mean and unbiased
  std: every minibatch's local moments are formed before the loop and combined
  at once (``combine_mean_std``, two all-reduces an update);
- the observation normalizer merges the global batch moments (``global_moments``);
- the rollout's episode sums, the mean reward and the self-play PFSP win/game
  counters are summed over the group before the metrics reach the host.

Random streams are global: every rank draws the whole run's action noise,
start-grid slots, opponent draws and permutation constants from the same seeded
generators and keeps its own rows (``DataMesh.shard``, ``_tree.shard_rows``). So a
run over D processes computes what one process computes with ``data_shards = D``
on all the envs, up to the order of the sums.

With no process group (one process, nothing initialized) no collective runs and
the trainers keep their single-process path. A mesh whose groups are all NCCL's
is ``capturable``: its collectives run on the card's streams and are captured
with the update's steps as CUDA graph nodes (``agent/ppo.py``); gloo runs its
collectives on the host, so a gloo group's update stays eager.

Tensor parallelism (``make_mesh(model_parallel=m)``, a ``TensorMesh``): the JAX
package's 2-D mesh ``devices.reshape(-1, m)`` with axes ``('data', 'model')``. Rank r
sits at data index ``r // m`` and model index ``r % m``; the ranks of one data
index form its *model group*, those of one model index its *data group*. The
env axis is split over the data index only: every model rank of a data row keeps
the same envs and draws the same global noise. The towers follow
``param_shardings`` (the Megatron pattern of JAX's ``param_shardings``), the Adam
moments follow their params, and everything else stays whole. A ``TensorMesh``'s
``world``, ``rank``, ``group`` and ``shard`` are its data axis, so the
data-parallel reductions above run over the data group unchanged; the partial
products of the towers are summed over the model group in the forward and
backward passes (``models/actor_critic.py``), and the gradient's global norm adds
the sharded leaves' squares over it (``agent/ppo.py:global_norm``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from .._tree import shard_rows
from ..envs import track as trk
from ..models import actor_critic as net


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

    @property
    def process_rank(self) -> int:
        """This process's rank in the whole group (rank 0 writes the files)."""
        return self.rank

    @property
    def all_group(self):
        """The group of every process (what replicated state is broadcast over)."""
        return self.group

    @property
    def capturable(self) -> bool:
        """Whether the update's collectives can be captured in a CUDA graph: its
        group is NCCL's (gloo's collectives run on the host)."""
        return _all_nccl(self.group)

    model_parallel = 1


@dataclasses.dataclass(frozen=True)
class TensorMesh:
    """This process's place on a 2-D ``('data', 'model')`` mesh of
    ``world * model_parallel`` processes. ``world``, ``rank``, ``group`` and
    ``shard`` are the data axis (this process's data index among ``world``, over
    the ranks with its model index), as a ``DataMesh``'s; ``model_rank`` and
    ``model_group`` are the model axis (the ranks with its data index);
    ``process_rank`` and ``all_group`` the whole group."""

    world: int
    rank: int
    device: torch.device
    group: object
    model_parallel: int
    model_rank: int
    model_group: object
    process_rank: int
    all_group: object
    axis: str = "data"

    @property
    def shape(self) -> dict:
        return {self.axis: self.world, "model": self.model_parallel}

    @property
    def axis_names(self) -> tuple:
        return (self.axis, "model")

    @property
    def shard(self) -> tuple:
        return (self.rank, self.world)

    @property
    def capturable(self) -> bool:
        """Whether the update's collectives can be captured in a CUDA graph: its
        data and model groups are both NCCL's."""
        return _all_nccl(self.group, self.model_group)


def _all_nccl(*groups) -> bool:
    return all(g is not None and dist.get_backend(g) == "nccl" for g in groups)


def make_mesh(devices=None, axis: str = "data", model_parallel: int = 1):
    """The mesh over the initialized process group (world 1 without one): a
    ``DataMesh`` for ``model_parallel`` 1, else a ``TensorMesh`` of ``world / m``
    data rows of ``m`` model ranks (every process calls it alike: it creates the
    groups). Raises ``ValueError`` where ``m`` does not divide the world, as JAX's
    ``make_mesh`` does.

    ``devices``: None for the current CUDA device, one device for this process,
    or one per rank (this process takes ``devices[rank]``)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if model_parallel > 1 and world % model_parallel != 0:
        raise ValueError(f"{world} devices not divisible by model_parallel={model_parallel}")
    if isinstance(devices, (list, tuple)):
        if len(devices) != world:
            raise ValueError(f"make_mesh: {len(devices)} devices for a group of {world} "
                             "processes (one device per process)")
        devices = devices[rank]
    dev = resolve_device(devices)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if model_parallel <= 1:
        return DataMesh(world=world, rank=rank, device=dev,
                        group=dist.group.WORLD if initialized else None, axis=axis)
    m, n_data = model_parallel, world // model_parallel
    # every process creates every group, in one order
    data_groups = [dist.new_group([d * m + j for d in range(n_data)]) for j in range(m)]
    model_groups = [dist.new_group(list(range(d * m, (d + 1) * m))) for d in range(n_data)]
    return TensorMesh(world=n_data, rank=rank // m, device=dev, group=data_groups[rank % m],
                      model_parallel=m, model_rank=rank % m, model_group=model_groups[rank // m],
                      process_rank=rank, all_group=dist.group.WORLD, axis=axis)


# ------------------------------------------------------------ tensor parallel

def param_shardings(params, mesh):
    """Tensor-parallel placement of the actor-critic's parameter dict (JAX's
    ``param_shardings``, the Megatron pattern): per leaf the dimension split over
    'model', or None. In each tower a layer whose input is whole splits its
    *output* features when ``m`` divides them (w on dim 1, b on dim 0: column
    parallel); the layer after it splits its *input* features (w on dim 0, b whole:
    row parallel), and its partial products are summed over the model group.
    Heads are never output-split; on a mesh without a 'model' axis every leaf is
    whole. Returns ``{"actor": [(w_dim, b_dim), ...], "critic": [...]}``."""
    m = mesh.shape.get("model", 1)

    def tower(layers):
        out = []
        prev_out_sharded = False
        for i, (w, _) in enumerate(layers):
            is_head = i == len(layers) - 1
            out_sharded = (m > 1 and not is_head and not prev_out_sharded
                           and w.shape[1] % m == 0)
            w_dim = 0 if prev_out_sharded else (1 if out_sharded else None)
            out.append((w_dim, 0 if out_sharded else None))
            prev_out_sharded = out_sharded
        return out

    return {k: tower(v) for k, v in params.items()}


def _take(t: torch.Tensor, dim, size: int, rank: int) -> torch.Tensor:
    """This rank's slice of ``t`` on ``dim`` (a copy), or ``t`` whole for None."""
    if dim is None:
        return t.detach().clone()
    k = t.shape[dim] // size
    return t.detach().narrow(dim, rank * k, k).clone(memory_format=torch.contiguous_format)


def _tensor_parallel(params, mesh) -> net.TensorParallel:
    return net.TensorParallel(param_shardings(params, mesh), mesh.model_group,
                              mesh.model_parallel, mesh.model_rank)


def shard_params(full_params, mesh) -> net.ShardedParams:
    """This rank's slices of the full parameter dict (``param_shardings``), as the
    ``ShardedParams`` that ``actor_mu`` and ``critic_value`` run tensor parallel:
    how JAX's parameters (``interop.params_from_jax``) reach a tensor-parallel
    rank."""
    tp = _tensor_parallel(full_params, mesh)
    local = {k: [tuple(_take(t, d, tp.size, tp.rank) for t, d in zip(layer, dims))
                 for layer, dims in zip(layers, tp.dims[k])]
             for k, layers in full_params.items()}
    return net.ShardedParams(local, tp)


def gather_leaves(leaves, tp: net.TensorParallel) -> list:
    """Full tensors from a rank's slices in ``ActorCritic.parameters()`` order (its
    parameters, or the Adam moments that follow them): each split leaf
    all-gathered over the model group, in model-rank order."""
    out = []
    for t, d in zip(leaves, tp.leaf_dims()):
        t = t.detach()
        if d is None:
            out.append(t)
            continue
        parts = [torch.empty_like(t) for _ in range(tp.size)]
        dist.all_gather(parts, t.contiguous(), group=tp.group)
        out.append(torch.cat(parts, dim=d))
    return out


def gather_params(local: net.ShardedParams) -> dict:
    """The full parameter dict from a rank's ``ShardedParams`` (all-gathered over
    the model group its layout names; every model rank calls it)."""
    tp = local.tp
    flat = [t for tower in ("actor", "critic") for layer in local[tower] for t in layer]
    full = iter(gather_leaves(flat, tp))
    return {k: [tuple(next(full) for _ in layer) for layer in local[k]]
            for k in ("actor", "critic")}


# ------------------------------------------------------------------ collectives

def all_reduce_sum_(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``x`` over the group, in place; returns it."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def combine_mean_std(mean: torch.Tensor, std: torch.Tensor, n: int, mesh: DataMesh):
    """Each row's mean and unbiased std over the union of every rank's ``n``
    samples, from the local ``mean`` and ``std`` of the rows (tensors of one
    shape; ``std`` unused where ``n`` is 1) by Chan's rule: one all-reduce for all
    the means and one for all the variances. With one rank both come back
    bitwise: the weights are 1, the between-rank term 0, and sqrt(s * s) == s in
    IEEE arithmetic."""
    total = n * mesh.world
    gmean = all_reduce_sum_((n / total) * mean, mesh)
    if n > 1:
        within = ((n - 1) / (total - 1)) * std * std
    else:  # one sample a rank: no spread within it
        within = torch.zeros_like(mean)
    between = (n / (total - 1)) * (mean - gmean) ** 2
    gvar = all_reduce_sum_(within + between, mesh)
    return gmean, gvar.sqrt()


def global_moments(x: torch.Tensor, mesh: DataMesh):
    """Mean and biased variance over dim 0 of the union of every rank's ``x``
    (equal row counts), combined from the local moments as ``combine_mean_std``
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


def barrier(mesh) -> None:
    """Wait for every process (nothing to wait for without a group)."""
    if mesh is None or mesh.all_group is None:
        return
    if dist.get_backend(mesh.all_group) == "nccl":
        dist.barrier(group=mesh.all_group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.all_group)


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
def replicate_tree(tree, mesh):
    """Make every tensor of ``tree`` process 0's value on every process (a
    broadcast in place; nothing without a group). Returns ``tree``: the placement
    of what the JAX package replicates (params, optimizer state, the opponent
    pool)."""
    if mesh.all_group is not None:
        for t in _tensors(tree):
            dist.broadcast(t, src=0, group=mesh.all_group)
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


def _shard_train_state(train, mesh):
    """The train state of a tensor-parallel rank: a model holding its slices of
    the parameters (``shard_params``) and the Adam moments sliced alike."""
    model = train.model
    local = shard_params(model.params(), mesh)
    tp = local.tp
    dims = tp.leaf_dims()
    adam = train.opt_state
    moments = lambda xs: [_take(t, d, tp.size, tp.rank) for t, d in zip(xs, dims)]
    return dataclasses.replace(
        train, model=net.ActorCritic(local, model.log_std, tensor_parallel=tp),
        opt_state=dataclasses.replace(adam, mu=moments(adam.mu), nu=moments(adam.nu)))


def shard_runner(runner, aux, mesh, num_envs: int):
    """Place a PPO ``RunnerState`` and its ``aux`` for data-parallel execution:
    the env state, observations and done flags keep this rank's envs (its data
    index's, on a ``TensorMesh``), the train state and the observation normalizer
    are process 0's on every rank, the generators stay as they are (every rank
    draws the global stream). On a ``TensorMesh`` the parameters and their Adam
    moments are then cut to this rank's slices (``param_shardings``).

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
    if mesh.model_parallel > 1:
        train = _shard_train_state(train, mesh)
    runner = dataclasses.replace(
        runner,
        train=train,
        vec=shard_by_env_axis(runner.vec, mesh, num_envs),
        obs=shard_rows(runner.obs, mesh.shard).clone(),
        done=shard_rows(runner.done, mesh.shard).clone(),
        obs_norm=replicate_tree(runner.obs_norm, mesh),
    )
    return runner, shard_by_env_axis(aux, mesh, num_envs)

"""PPO: rollout, GAE and the clipped update with the KL early exit (port of
``self_play_racing_tpu/agent/ppo.py``).

One update is ``num_steps`` vector env steps (sample, transition, NEXT_STEP
autoreset, observe: ``rollout_step``), GAE over the rollout (kernel K6 on the card),
the epoch permutations (kernel K7 on the card), then ``update_epochs`` x
``num_minibatches`` clipped updates (``minibatch_step``). Semantics kept from the
JAX package:

- approx_kl = mean(old_logprob - new_logprob); once it exceeds ``kl_target`` the
  triggering minibatch is not applied and the update exits. As in the JAX
  package's ``lax.while_loop`` the exit is a masked carry decided on the device: a
  minibatch applies its update only while no earlier one triggered, and the stats
  record it with ``computed=1`` and ``applied=0``. The host reads the exit flag
  once an epoch and skips the epochs after it; the minibatches left in the exit's
  epoch run masked, changing nothing and recording zeros;
- per-minibatch advantage normalization with the unbiased std plus 1e-8;
- clipped value loss 0.5*max(unclipped, clipped); the entropy bonus is a constant
  (log_std is an annealed buffer, not a parameter);
- lr anneal frac*lr -> 0 and log_std anneal start -> end by update index, in
  float32; the learning rate is applied by hand, ``params + (-lr * u)``;
- gradients clipped by global norm as optax does it (a device select), then
  Adam(eps=1e-5) in optax's order (``clip_by_global_norm``, ``adam_update``), its
  bias corrections from a host table of the update's counts
  (``bias_correction_table``) that the device's applied count indexes; not
  ``torch.optim``, whose Adam folds the bias corrections into the step size and
  rounds otherwise. On the card the actor's and critic's MLPs forward and backward
  (``ops/mlp.py``: ``actor_critic_mlp``, whole towers; a tensor-parallel rank keeps
  the Megatron composition), the loss's per-row work and everything after the global
  norm are hand-written kernels (``ops/minibatch.py``: ``ppo_head``, ``adam_tail``),
  and the global norm comes out of the MLP backward's reduce launch, or out of its
  norm-only mode after a group's all-reduce (``norm_route``);
- episode statistics harvested from the autoreset wrapper's records; the update's
  metrics packed into one float32 vector in ``METRIC_NAMES`` order.

The model's ``nn.Parameter``s are trained in place by ``torch.autograd``; the Adam
state is functional (each update returns a new ``AdamState``). JAX's PRNG keys
become ``torch.Generator``s: the rollout's action noise and the permutations' round
constants are drawn from the runner's generator, or passed in, so tests can feed
the port and the JAX package the same numbers.

On a CUDA device the update runs as device programs, the port's counterpart of the
JAX package's one compiled update: the rollout step is captured once as a CUDA
graph and replayed ``num_steps`` times, and so is the minibatch step, E x M times
at most (``_graph.CapturedStep``). That holds with no process group and with one
whose groups are NCCL's (``mesh.capturable``): the step's collectives are then
captured with it as graph nodes, as JAX keeps its psums inside the one program. The
graphs are captured at the first update and again when a shape, a dtype or the
structure of what they read changes. ``make_update_step(..., eager=True)`` runs
the same step functions eagerly on the card (the reference the graphs are held
to); the CPU and a gloo group (whose collectives run on the host) always run them
eagerly.

Data parallelism (``make_update_step(..., mesh=...)``, a ``parallel.mesh.DataMesh``
with a process group): each rank steps its own envs, draws the global noise and
constants and keeps its rows, and reduces over the group what the JAX program
reduces over the env or batch axis (``parallel/mesh.py`` lists them): an update
makes two all-reduces for every minibatch's advantage moments (formed before the
loop, ``advantage_moments``), one a minibatch for the gradients and stats, one for
the metrics, and two a rollout step for the observation normalizer when it is on.
Without a group the update is the single-process one, unchanged. On a
``TensorMesh`` the same reductions run over the data group, the model holds this
rank's slices of the towers (its forward sums their partial products over the
model group), Adam runs on the slices, and ``global_norm`` is the full gradient's.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import PPOConfig
from ..envs import normalize as obsnorm
from ..envs import vector
from ..models import actor_critic as net
from ..ops import minibatch as mbops
from ..ops import mlp as mlpops
from ..ops import policy as polops
from ..ops.gae import compute_gae
from ..ops.minibatch import (ADAM_B1, ADAM_B2, adam_update,  # noqa: F401
                             apply_updates, clip_by_global_norm)
from ..ops.prng import draw_constants, epoch_permutation
from .. import _graph
from .._tree import shard_rows
from ..parallel import mesh as pmesh

_INT32_MAX = 2**31 - 1


class EnvHooks(NamedTuple):
    """Functional env interface consumed by the trainer. ``aux`` is the env data
    (track geometry, ...) passed to every call."""

    reset: Callable       # (aux, generator) -> env_state  (batched)
    transition: Callable  # (aux, env_state, action, generator) -> (state, rew, term, trunc, info)
    observe: Callable     # (aux, env_state) -> obs [N, obs_dim] float32
    # optional: (aux, env_state) -> (env_state, obs), for envs that cache their
    # observations in the state (self-play): called once per vector step on the
    # merged state, in place of observe (see envs.vector.step)
    refresh: Callable = None
    # optional: (aux, env_state) -> info with transition-info structure, for the
    # NEXT_STEP reset-info contract (see envs.vector.step)
    info: Callable = None
    # optional: (aux, info, episode_record) -> [S] float32 per rollout step, summed
    # over the rollout and appended to the packed metrics (``unpack_metrics``'s
    # "_extra"; self-play's per-slot wins and games)
    stats: Callable = None


@dataclasses.dataclass
class AdamState:
    """``optax.scale_by_adam``'s state: step count and the moments, one tensor per
    parameter in ``model.parameters()`` order."""

    count: int
    mu: list
    nu: list


@dataclasses.dataclass
class TrainState:
    model: net.ActorCritic
    opt_state: AdamState
    update: int  # update index (drives the anneals)


@dataclasses.dataclass
class RunnerState:
    train: TrainState
    vec: vector.VecState
    obs: torch.Tensor    # [N, obs_dim] float32 — next_obs in reference terms
    done: torch.Tensor   # [N] bool — next_done
    generator: torch.Generator  # action noise and permutation constants
    obs_norm: obsnorm.ObsNormState


def _device_of(aux) -> torch.device:
    if isinstance(aux, dict):
        return _device_of(next(v for v in aux.values()
                               if isinstance(v, torch.Tensor) or dataclasses.is_dataclass(v)))
    return vector._device_of(aux)


def _child_generator(generator: torch.Generator, device) -> torch.Generator:
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator(device=device).manual_seed(seed)


def init_adam(model: net.ActorCritic) -> AdamState:
    params = [p.detach() for p in model.parameters()]
    return AdamState(count=0, mu=[torch.zeros_like(p) for p in params],
                     nu=[torch.zeros_like(p) for p in params])


def init_train_state(generator: torch.Generator, cfg: PPOConfig, obs_dim: int,
                     action_dim: int, device=None) -> TrainState:
    """Orthogonally initialized float32 actor-critic (weights drawn from the CPU
    ``generator``) with a fresh Adam state."""
    params = net.init_params(generator, obs_dim, action_dim, hidden=cfg.hidden,
                             device=device)
    model = net.ActorCritic(params, torch.zeros((action_dim,), device=device))
    return TrainState(model=model, opt_state=init_adam(model), update=0)


def init_runner(generator: torch.Generator, cfg: PPOConfig, hooks: EnvHooks, aux,
                obs_dim: int, action_dim: int) -> RunnerState:
    """Learner and env state on the device of ``aux``. ``generator`` (CPU) draws
    the initial weights and seeds the runner's device generator and the vector
    env's."""
    dev = _device_of(aux)
    train = init_train_state(generator, cfg, obs_dim, action_dim, device=dev)
    vec_gen = _child_generator(generator, dev)
    carry = _child_generator(generator, dev)
    env_state, obs = reset_observe(hooks, aux, vec_gen)
    return RunnerState(
        train=train,
        vec=vector.init(env_state, cfg.num_envs, vec_gen),
        obs=obs.to(torch.float32),
        done=torch.zeros((cfg.num_envs,), dtype=torch.bool, device=dev),
        generator=carry,
        obs_norm=obsnorm.init(obs_dim, device=dev),
    )


def reset_observe(hooks: EnvHooks, aux, generator):
    """(env_state, obs) of a fresh reset, sensed through ``refresh`` where the env
    caches its observations."""
    env_state = hooks.reset(aux, generator)
    if hooks.refresh is not None:
        return hooks.refresh(aux, env_state)
    return env_state, hooks.observe(aux, env_state)


def reset_env_state(hooks: EnvHooks, runner: RunnerState, aux) -> RunnerState:
    """``reset_envs_each_update``'s rebuild before a rollout: the reference rebuilds
    every env each update but keeps its stale next_obs/next_done, so the env state
    resets (and an env that caches observations senses it: self-play's opponents
    act on the fresh reset obs) while ``runner.obs``/``runner.done`` do not."""
    env_state, _ = reset_observe(hooks, aux, runner.vec.generator)
    return dataclasses.replace(
        runner, vec=vector.init(env_state, runner.done.shape[0], runner.vec.generator))


def anneal_fractions(cfg: PPOConfig, update: int, action_dim: int = 2, device=None):
    """(frac, lr, log_std): frac = max(0, 1 - update/num_updates), lr = frac*lr0,
    log_std from start to end, all rounded in float32 as the reference computes
    them. frac and lr are numpy float32 scalars; log_std is a float32 [action_dim]
    tensor on ``device``."""
    f32 = np.float32
    frac = max(f32(0.0), f32(1.0) - f32(update) / f32(cfg.num_updates))
    lr = frac * f32(cfg.learning_rate)
    log_std = frac * f32(cfg.log_std_start) + (f32(1.0) - frac) * f32(cfg.log_std_end)
    return frac, lr, torch.full((action_dim,), float(log_std), dtype=torch.float32,
                                device=device)


class Batch(NamedTuple):
    obs: torch.Tensor
    actions: torch.Tensor
    logprobs: torch.Tensor
    advantages: torch.Tensor
    returns: torch.Tensor
    values: torch.Tensor


class UnitBatch(NamedTuple):
    """A minibatch as ``minibatch_step`` hands it to the loss: ``advantages``
    gathered, [n] (the advantages' moments read them), the observations, actions, old
    log-probs, returns and old values as the rollout's units [units, block, ...]
    (``shard_blocks``, shard and unit axes merged), and ``rows`` the minibatch's unit
    ids (int64 [n / block]): row r is unit ``rows[r // block]``, offset ``r % block``.
    ``_ppo_loss`` tells the two batches apart by ``rows``: where the batch has it, the
    MLPs and the loss head read those five fields through it."""
    obs: torch.Tensor
    actions: torch.Tensor
    logprobs: torch.Tensor
    advantages: torch.Tensor
    returns: torch.Tensor
    values: torch.Tensor
    rows: torch.Tensor


STAT_NAMES = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac",
              "applied", "computed")


def _ppo_loss(params, log_std, mb, cfg: PPOConfig, moments=None, norm=None):
    """The clipped loss and its stats, on a ``Batch`` or a ``UnitBatch``. The
    advantages are normalized by their own mean and unbiased std, or by ``moments`` =
    (mean, std) where given (the whole minibatch's over a group,
    ``advantage_moments``). The actor's mean and the critic's value are
    ``ops.mlp.actor_critic_mlp`` (on the card one launch forward, two backward), and
    the per-row work is ``ops.minibatch.ppo_head`` (one launch each way), a
    ``UnitBatch``'s fields read through its unit ids; the means, the entropy and the
    loss stay PyTorch's reductions over its rows. A tensor-parallel rank's sharded
    parameters keep the Megatron composition of ``models/actor_critic.py`` (the
    kernels take whole towers; ``actor_critic_mlp`` tells them apart). ``norm``
    (the kernels' route only, a 0-d tensor) receives the gradients' global norm from
    the MLPs' backward."""
    rows = getattr(mb, "rows", None)
    mu, new_v = mlpops.actor_critic_mlp(params, mb.obs, rows, norm)
    adv = mb.advantages
    mean, std = (adv.mean(), adv.std(correction=1)) if moments is None else moments
    neg_log_ratio, pg_max, v_max, clipped = mbops.ppo_head(
        mu, new_v, mb.actions, mb.logprobs, adv, mb.returns, mb.values, log_std, mean, std,
        cfg.clip_coef, rows)
    approx_kl = torch.mean(neg_log_ratio)  # mean(old - new)
    pg_loss = pg_max.mean()
    v_loss = 0.5 * v_max.mean()
    entropy = net.normal_entropy(log_std, mu.shape[-1], neg_log_ratio.shape)
    e_loss = -entropy.mean()
    loss = pg_loss + cfg.ent_coef * e_loss + cfg.vf_coef * v_loss
    stats = {
        "loss": loss, "pg_loss": pg_loss, "v_loss": v_loss,
        "entropy": -e_loss, "approx_kl": approx_kl, "clip_frac": clipped.mean(),
    }
    return loss, stats


def global_norm(grads, tp: net.TensorParallel = None) -> torch.Tensor:
    """sqrt of the sum over tensors of sum(g**2), as ``optax.global_norm``. With a
    tensor-parallel layout ``tp`` (``grads`` a rank's slices) it is the full
    gradient's norm: the split leaves' squares summed over the model group, the
    whole leaves' counted once, so every model rank takes the same clip."""
    squares = [torch.sum(s) for s in torch._foreach_mul(grads, grads)]
    if tp is None:
        return torch.stack(squares).sum().sqrt()
    dims = tp.leaf_dims()
    split = torch.stack([s for s, d in zip(squares, dims) if d is not None]).sum()
    dist.all_reduce(split, group=tp.group)
    whole = [s for s, d in zip(squares, dims) if d is None]
    return (split + torch.stack(whole).sum() if whole else split).sqrt()


def bias_correction(b: float, count: int, dtype: torch.dtype) -> float:
    """``1 - b**count`` taken in ``dtype``, as optax takes it from its int32 count
    and a weakly typed ``b``: a float32 pow for float32 moments, a float64 one for
    float64 moments."""
    t = np.dtype(str(dtype).removeprefix("torch.")).type
    return float(t(1) - t(b) ** t(count))


def bias_correction_table(b: float, count: int, steps: int, dtype: torch.dtype):
    """``bias_correction`` for the Adam counts ``count + 1 .. count + steps`` (each
    capped at int32's maximum, as optax's count saturates), as a numpy array of
    ``dtype``: row k is the correction of the (k+1)-th applied step of an update
    that starts at ``count``. Taken on the host with NumPy's pow, so that each
    value is ``bias_correction``'s to the bit."""
    counts = [min(count + k + 1, _INT32_MAX) for k in range(steps)]
    return np.array([bias_correction(b, c, dtype) for c in counts],
                    dtype=np.dtype(str(dtype).removeprefix("torch.")))


def minibatch_layout(cfg: PPOConfig):
    """(block, n_units, mb_units): samples per shuffled unit, units per shard, and
    units per shard per minibatch. A block is adjacent envs at one timestep
    (``gcd(shuffle_block_size, num_envs // data_shards)``), else 1."""
    d_shards = cfg.data_shards
    n_sub = cfg.num_envs // d_shards
    b_sub = cfg.batch_size // d_shards
    mb_sub = cfg.minibatch_size // d_shards
    block = math.gcd(cfg.shuffle_block_size, n_sub)
    if block <= 1 or b_sub % block != 0 or mb_sub % block != 0:
        block = 1
    return block, b_sub // block, mb_sub // block


def _mean_over_group(grads, st, mesh):
    """The gradients and the minibatch's stats averaged over the group (each rank's
    minibatch part is an equal share), in one flat all-reduce. Returns the
    gradients (views of the flat buffer, which opens with them), the stats and the
    flat buffer."""
    stat = torch.stack([st[k].detach().to(grads[0].dtype) for k in STAT_NAMES[:6]])
    flat = torch.cat([g.reshape(-1) for g in grads] + [stat])
    pmesh.all_reduce_sum_(flat, mesh).div_(mesh.world)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out, dict(zip(STAT_NAMES[:6], flat[at:])), flat


def shard_blocks(cfg: PPOConfig, flat: Batch) -> Batch:
    """The flat [batch_size, ...] rollout as [data_shards, n_units, block, ...]
    shuffle units (``minibatch_layout``): with D > 1 shards, [T, D, n_sub] ->
    [D, T, n_sub] -> [D, units, block], so shard d holds envs d*n_sub.. of every
    step, the envs rank d owns in a D-process run."""
    d_shards = cfg.data_shards
    block, n_units, _ = minibatch_layout(cfg)
    if d_shards == 1:
        return Batch(*(x.reshape((1, n_units, block) + x.shape[1:]) for x in flat))
    n_sub = cfg.num_envs // d_shards
    return Batch(*(
        x.reshape((cfg.num_steps, d_shards, n_sub) + x.shape[1:])
         .transpose(0, 1)
         .reshape((d_shards, n_units, block) + x.shape[1:])
        for x in flat))


@dataclasses.dataclass
class MinibatchLoop:
    """The minibatch loop's carry on the device, JAX's ``while_loop`` carry: ``i``
    the next minibatch (int64 [1]), ``applied`` the minibatches applied so far
    (int64 [1]; it indexes the bias-correction tables), ``stop`` the KL exit (0-d
    bool) and ``stats`` [E*M, 8] float32, row i minibatch i's ``STAT_NAMES``."""

    i: torch.Tensor
    applied: torch.Tensor
    stop: torch.Tensor
    stats: torch.Tensor

    @classmethod
    def zeros(cls, minibatches: int, device) -> "MinibatchLoop":
        z = torch.zeros((1,), dtype=torch.int64, device=device)
        return cls(i=z, applied=z.clone(),
                   stop=torch.zeros((), dtype=torch.bool, device=device),
                   stats=torch.zeros((minibatches, len(STAT_NAMES)), dtype=torch.float32,
                                     device=device))

    def reset(self) -> None:
        for t in (self.i, self.applied, self.stop, self.stats):
            t.zero_()


def minibatch_index(cfg: PPOConfig, perms) -> torch.Tensor:
    """[E*M, D*mb_units] int64: the shuffle units of minibatch i = e*M + m in the
    flat unit axis [D*n_units] of ``shard_blocks``' layout: shard d's units
    ``perms[e, d, m*mb_units:(m+1)*mb_units]``, offset by ``d*n_units``."""
    e_total, d_shards, n_units = perms.shape
    _, _, mb_units = minibatch_layout(cfg)
    units = perms.to(torch.int64) + torch.arange(
        d_shards, dtype=torch.int64, device=perms.device)[:, None] * n_units
    return (units.reshape(e_total, d_shards, cfg.num_minibatches, mb_units)
            .transpose(1, 2).reshape(e_total * cfg.num_minibatches, d_shards * mb_units))


def advantage_moments(cfg: PPOConfig, units: Batch, index, mesh) -> torch.Tensor:
    """[E*M, 2]: row i the mean and unbiased std of minibatch i's advantages over
    every rank's part, formed before the loop. Each minibatch's local moments come
    from the gather and the calls the loop would make (``adv.mean()``,
    ``adv.std(correction=1)`` of the flat minibatch; a row-wise reduction could
    round otherwise), then ``pmesh.combine_mean_std`` combines all of them in two
    all-reduces: bitwise the local moments with one rank."""
    n = cfg.minibatch_size
    means, stds = [], []
    for i in range(index.shape[0]):
        adv = mbops.gather_units(units.advantages, index[i])
        means.append(adv.mean())
        if n > 1:
            stds.append(adv.std(correction=1))
    mean, std = pmesh.combine_mean_std(torch.stack(means),
                                       torch.stack(stds) if stds else None, n, mesh)
    return torch.stack([mean, std], dim=1)


def norm_route(device: torch.device, mesh, tp) -> str:
    """Where a minibatch step's global norm comes from: ``"fused"`` on a card with no
    group and whole towers (the MLPs' backward writes it in its reduce launch),
    ``"norm-only"`` on a card with a group and whole towers (one launch of the
    reduce's norm-only mode over the all-reduced flat gradient), ``"composition"``
    on the CPU and on a tensor-parallel rank (``global_norm``: the MLP kernels do
    not run there, and a rank's norm needs the split squares' all-reduce)."""
    if tp is not None or device.type != "cuda":
        return "composition"
    return "fused" if mesh is None else "norm-only"


def minibatch_step(cfg: PPOConfig, model: net.ActorCritic, log_std, lr, units: Batch,
                   index, bc1, bc2, mu, nu, loop: MinibatchLoop, mesh=None,
                   moments=None) -> None:
    """One minibatch of the clipped update, JAX's ``body_fn``, with no value deciding
    a host branch: minibatch ``loop.i`` of ``units`` (``shard_blocks``' layout with
    the shard and unit axes merged) at its row of ``index`` (``minibatch_index``),
    its advantages gathered and its other fields read by the MLPs and the loss head
    through the unit ids (``UnitBatch``), then ``apply_minibatch``."""
    rows = index.index_select(0, loop.i)[0]
    mb = UnitBatch(units.obs, units.actions, units.logprobs,
                   mbops.gather_units(units.advantages, rows), units.returns, units.values,
                   rows)
    apply_minibatch(cfg, model, log_std, lr, mb, bc1, bc2, mu, nu, loop, mesh, moments)


def apply_minibatch(cfg: PPOConfig, model: net.ActorCritic, log_std, lr, mb, bc1, bc2,
                    mu, nu, loop: MinibatchLoop, mesh=None, moments=None) -> None:
    """The loss on the minibatch ``mb`` and its gradients (with a ``mesh``, the
    advantages normalized by row ``loop.i`` of ``advantage_moments``' table
    ``moments`` and the gradients averaged over the group), the global norm
    (``norm_route``), then ``ops.minibatch.adam_tail``: the clip as a select, and
    Adam with the corrections ``bc1[loop.applied]``, ``bc2[loop.applied]``. ``trig =
    approx_kl > kl_target``: the parameters, ``mu`` and ``nu`` take the new values
    where the loop is active (no earlier exit) and not ``trig``, in place; the stats
    row ``loop.i`` records the minibatch where it is active (``applied`` and
    ``computed`` its flags), zeros after the exit; the loop's counters and exit flag
    advance on the device."""
    params = list(model.parameters())
    route = norm_route(params[0].device, mesh, model.tensor_parallel)
    g_norm = (torch.empty((), dtype=params[0].dtype, device=params[0].device)
              if route == "fused" else None)
    if mesh is not None:
        moments = moments.index_select(0, loop.i)[0].unbind()
    with torch.enable_grad():
        loss, st = _ppo_loss(model.params(), log_std, mb, cfg, moments, g_norm)
        grads = torch.autograd.grad(loss, params)
    if mesh is not None:
        grads, st, flat = _mean_over_group(grads, st, mesh)
    with torch.no_grad():
        if route == "norm-only":
            g_norm = mlpops.grad_norm(flat[:sum(g.numel() for g in grads)])
        elif route == "composition":
            g_norm = global_norm(grads, model.tensor_parallel)
        mbops.adam_tail(params, list(grads), mu, nu, g_norm, [st[k] for k in STAT_NAMES[:6]],
                        bc1, bc2, lr, loop, cfg.max_grad_norm, cfg.kl_target)


class _MinibatchGraph:
    """``minibatch_step`` captured once (``_graph.CapturedStep``) over static copies
    of its inputs and of the Adam moments, the loop's carry and the model's
    parameters read and trained in place. With a ``mesh`` the step's all-reduce is
    captured with it, and ``advantage_moments`` is captured as a second graph
    (``moments_step``) that ``load`` replays once an update, before the loop.
    ``key`` is what the captures fix."""

    def __init__(self, cfg, model, inputs, opt_state, key, mesh=None):
        self.key = key
        dev = inputs[0].device
        self.inputs = _graph.clone_tree(inputs)
        self.mu = [m.clone() for m in opt_state.mu]
        self.nu = [v.clone() for v in opt_state.nu]
        self.loop = MinibatchLoop.zeros(inputs[3].shape[0], dev)
        self.loop.stop.fill_(True)  # the warm-up runs are masked: they move nothing
        self.moments = self.moments_step = None
        if mesh is not None:
            units, index = self.inputs[2], self.inputs[3]
            self.moments = torch.zeros((index.shape[0], 2), dtype=units.advantages.dtype,
                                       device=dev)
            self.moments_step = _graph.CapturedStep(
                lambda: self.moments.copy_(advantage_moments(cfg, units, index, mesh)),
                dev, [], lambda: None)

        def body():
            minibatch_step(cfg, model, *self.inputs, self.mu, self.nu, self.loop, mesh,
                           self.moments)

        self.step = _graph.CapturedStep(body, dev, [], self.loop.i.zero_)

    def load(self, inputs, opt_state) -> None:
        _graph.load_tree((self.inputs, self.mu, self.nu),
                         (inputs, opt_state.mu, opt_state.nu))
        self.loop.reset()
        if self.moments_step is not None:
            self.moments_step.replay()

    def owned(self) -> list:
        """The tensors the graph owns outside its private pools."""
        return [t for _, t in _graph.tensor_leaves((self.inputs, self.mu, self.nu,
                                                    self.loop, self.moments))]

    @property
    def pool_bytes(self) -> int:
        return sum(s.pool_bytes for s in (self.step, self.moments_step) if s is not None)


def run_ppo_update(cfg: PPOConfig, model: net.ActorCritic, opt_state: AdamState,
                   log_std, lr, flat: Batch, perms, mesh=None, graphs=None):
    """Epochs x minibatches of clipped updates with the KL early exit.

    ``flat`` is the flattened [batch_size, ...] rollout (flat index
    ``t*num_envs + n``); ``perms`` [epochs, data_shards, n_units] are the epoch
    permutations of block units (``minibatch_layout``). Minibatch m of epoch e
    takes units ``perms[e, :, m*mb_units:(m+1)*mb_units]`` from each shard. With
    ``data_shards`` = D > 1 the batch is laid out as [T, D, n_sub] -> [D, T, n_sub]
    -> [D, units, block] first, so each shard contributes an equal stratum.

    Each minibatch is ``minibatch_step``; the host reads the exit flag once an
    epoch and skips the epochs after an exit, then reads the stats and the applied
    count once. With ``graphs`` (an ``UpdateGraphs``: CUDA, and no group or an
    NCCL one) the step is a replayed CUDA graph; otherwise it runs eagerly.

    Trains ``model``'s parameters in place. Returns (opt_state, stopped, stats):
    ``stats`` maps ``STAT_NAMES`` to [epochs, minibatches] float32 numpy arrays,
    zero past the exit, with ``computed`` marking the executed minibatches and
    ``applied`` the applied ones.

    With a ``mesh`` (a group), ``flat`` and ``perms`` are this rank's part of each
    minibatch: the advantages are normalized by the global moments (every
    minibatch's, reduced before the loop: ``advantage_moments``), and the
    gradients and stats are averaged over the group, so every rank applies the
    same update and takes the same exit.
    """
    d_shards = cfg.data_shards
    e_total, m_total = cfg.update_epochs, cfg.num_minibatches
    _, n_units, _ = minibatch_layout(cfg)
    if tuple(perms.shape) != (e_total, d_shards, n_units):
        raise ValueError(f"run_ppo_update: perms {tuple(perms.shape)}, expected "
                         f"{(e_total, d_shards, n_units)}")
    dev = flat.obs.device
    units = Batch(*(x.reshape((d_shards * n_units,) + x.shape[2:])
                    for x in shard_blocks(cfg, flat)))
    index = minibatch_index(cfg, perms.to(dev))
    params = list(model.parameters())
    dtype = params[0].dtype
    steps = e_total * m_total
    bc1, bc2 = (_host_to(bias_correction_table(b, opt_state.count, steps, dtype), dev)
                for b in (ADAM_B1, ADAM_B2))
    inputs = (log_std, torch.full((), float(lr), dtype=dtype, device=dev), units, index,
              bc1, bc2)
    if graphs is None:
        mu = [m.clone() for m in opt_state.mu]
        nu = [v.clone() for v in opt_state.nu]
        loop = MinibatchLoop.zeros(steps, dev)
        moments = None if mesh is None else advantage_moments(cfg, units, index, mesh)

        def run(times):
            for _ in range(times):
                minibatch_step(cfg, model, *inputs, mu, nu, loop, mesh, moments)
    else:
        g = graphs.minibatch(cfg, model, inputs, opt_state, mesh)
        mu, nu, loop, run = g.mu, g.nu, g.loop, g.step.replay
    for e in range(e_total):
        run(m_total)
        if e + 1 < e_total and bool(loop.stop):  # the epoch's one host read
            break
    host = torch.cat([loop.stats.reshape(-1), loop.applied.to(torch.float32),
                      loop.stop.reshape(1).to(torch.float32)]).cpu().numpy()
    stats = host[:-2].reshape(e_total, m_total, len(STAT_NAMES))
    applied, stopped = int(host[-2]), bool(host[-1])
    if graphs is not None:  # the graph's buffers serve the next update
        mu, nu = [m.clone() for m in mu], [v.clone() for v in nu]
    opt_state = AdamState(count=min(opt_state.count + applied, _INT32_MAX), mu=mu, nu=nu)
    return opt_state, stopped, {k: stats[..., j].copy() for j, k in enumerate(STAT_NAMES)}


def _host_to(array: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory, without making
    the host wait for the stream."""
    t = torch.from_numpy(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _last_computed(ustats, name):
    """Value of ``name`` at the last executed minibatch (``run_ppo_update`` leaves
    slots after the KL exit at zero; ``computed`` marks the executed ones)."""
    n = int(np.sum(ustats["computed"]))
    return ustats[name].reshape(-1)[max(n - 1, 0)]


@dataclasses.dataclass
class RolloutCarry:
    """What one rollout step hands the next, JAX's ``scan`` carry: the vector env,
    the observations and done flags entering the step, the normalizer, and ``t``
    (int64 [1] on the device), the step's row of the [T, N, ...] buffers."""

    vec: vector.VecState
    obs: torch.Tensor
    done: torch.Tensor
    norm: obsnorm.ObsNormState
    t: torch.Tensor


def rollout_carry(runner: RunnerState) -> RolloutCarry:
    """The carry entering a rollout from ``runner``, at step 0."""
    return RolloutCarry(vec=runner.vec, obs=runner.obs, done=runner.done,
                        norm=runner.obs_norm,
                        t=torch.zeros((1,), dtype=torch.int64, device=runner.obs.device))


def rollout_step(cfg: PPOConfig, hooks: EnvHooks, aux, params, log_std, noise,
                 carry: RolloutCarry, out: dict, mesh=None) -> RolloutCarry:
    """One vector env step under the current policy, JAX's ``one_step``: the
    normalizer update, ``sample_action`` on ``noise[t]`` ([T, N, A], N this rank's
    envs; with a ``mesh`` the normalizer merges every rank's observations),
    ``vector.step`` with the hooks. On the card with whole towers the policy is one
    launch (``ops.policy.rollout_sample``: the normalizer's apply, both towers, the
    sample and its log-prob, and the obs, actions, logprobs and values rows written
    in place); on the CPU and a tensor-parallel rank ``rollout_policy_plain``. Writes row ``t`` of the [T, N, ...] buffers in
    ``out`` (made at the first call): obs, actions, logprobs, values, reward
    (float32), done_entering, and the episode records' ep_return, ep_length and
    ep_mask; adds ``hooks.stats`` into ``out["extra"]``. Returns the next carry.
    Reads the device only through ``t``, so one CUDA graph of it serves every
    step."""
    t, norm = carry.t, carry.norm
    if cfg.normalize_obs:
        norm = obsnorm.update(norm, carry.obs, mesh)
    if polops.whole_towers(params, carry.obs):
        # one launch: the normaliser, both towers, the sample and its log-prob, row t
        # of the obs, actions, log-probs and values buffers written in place
        action = polops.rollout_sample(params, log_std, carry.obs, noise, t,
                                       norm if cfg.normalize_obs else None, out)
        rows = {}
    else:
        action, rows = rollout_policy_plain(cfg, params, log_std, noise, carry.obs, t, norm)
    vec, next_obs, reward, next_done, _, _, info, rec = vector.step(
        carry.vec, action,
        lambda s, a, g: hooks.transition(aux, s, a, g),
        lambda s: hooks.observe(aux, s),
        lambda g: hooks.reset(aux, g),
        refresh_fn=(None if hooks.refresh is None
                    else (lambda s: hooks.refresh(aux, s))),
        info_fn=(None if hooks.info is None else (lambda s: hooks.info(aux, s))),
    )
    rows.update({
        "reward": reward.to(torch.float32), "done_entering": carry.done,
        "ep_return": torch.where(rec["mask"], rec["return"], 0.0),
        "ep_length": torch.where(rec["mask"], rec["length"], 0),
        "ep_mask": rec["mask"],
    })
    for k, v in rows.items():
        if k not in out:
            out[k] = v.new_empty((noise.shape[0],) + v.shape)
        out[k].index_copy_(0, t, v[None])
    if hooks.stats is not None:
        st = hooks.stats(aux, info, rec)
        if "extra" not in out:
            out["extra"] = torch.zeros_like(st)
        out["extra"].add_(st)
    return RolloutCarry(vec=vec, obs=next_obs.to(torch.float32), done=next_done,
                        norm=norm, t=t + 1)


def rollout_policy_plain(cfg: PPOConfig, params, log_std, noise, obs, t, norm):
    """Plain PyTorch policy of ``rollout_step``: the normaliser's ``apply``,
    ``net.sample_action_plain`` on ``noise[t]``. Returns the action and the rows the
    step writes at ``t`` (obs, actions, logprobs, values)."""
    policy_obs = obsnorm.apply(norm, obs) if cfg.normalize_obs else obs
    action, logprob, value = net.sample_action_plain(params, log_std, policy_obs,
                                                     noise.index_select(0, t)[0])
    return action, {"obs": policy_obs, "actions": action, "logprobs": logprob,
                    "values": value}


def _rollout_outputs(carry: RolloutCarry, out: dict):
    traj = Batch(obs=out["obs"], actions=out["actions"], logprobs=out["logprobs"],
                 advantages=None, returns=None, values=out["values"])
    return carry.vec, carry.obs, carry.done, carry.norm, traj, out


@torch.no_grad()
def rollout_phase(cfg: PPOConfig, hooks: EnvHooks, runner: RunnerState, aux, log_std,
                  noise, mesh=None):
    """``num_steps`` calls of ``rollout_step``, eagerly.

    ``noise`` [T, N, A] is the standard-normal action noise (N this rank's envs;
    with a ``mesh`` the observation normalizer merges every rank's). Returns (vec,
    next_obs, next_done, obs_norm, traj, step_stats): ``traj`` a ``Batch`` of
    [T, N, ...] tensors (advantages and returns empty), ``step_stats`` the
    per-step rewards (float32), done-entering flags and episode records, and the
    rollout's sum of ``hooks.stats`` under "extra" when the hooks have one."""
    params = runner.train.model.params()
    carry, out = rollout_carry(runner), {}
    for _ in range(cfg.num_steps):
        carry = rollout_step(cfg, hooks, aux, params, log_std, noise, carry, out, mesh)
    return _rollout_outputs(carry, out)


class _RolloutGraph:
    """``rollout_step`` captured once (``_graph.CapturedStep``, the vector env's
    generator registered) over static copies of the runner's env state,
    observations, done flags and normalizer, of log_std and of the noise, writing
    static [T, N, ...] buffers. The model's parameters are read in place, and so is
    the aux (``_graph.StaticTree``) but at the places in ``copied``: the tensors the
    trainer replaces between updates (the opponent draw, the speed-weight anneal, a
    swapped track). With a ``mesh`` the step's collectives (the normalizer's, a
    tensor-parallel forward's) are captured with it. ``key`` is what the capture
    fixes."""

    def __init__(self, cfg, hooks, runner, aux, log_std, noise, key, copied, mesh=None):
        self.key, self.steps = key, cfg.num_steps
        self.carry = _graph.clone_tree(rollout_carry(runner))
        self.aux = _graph.StaticTree(aux, copied)
        self.inputs = _graph.clone_tree((log_std, noise))
        self.out = {}
        params = runner.train.model.params()
        gen = runner.vec.generator

        def body():
            new = rollout_step(cfg, hooks, self.aux.tree, params, *self.inputs, self.carry,
                               self.out, mesh)
            _graph.load_tree(self.carry, new)

        self.step = _graph.CapturedStep(body, runner.obs.device,
                                        [] if gen is None else [gen], self.carry.t.zero_)

    def run(self, runner, aux, log_std, noise):
        """The rollout from ``runner``: ``rollout_phase``'s outputs, the runner
        state cloned (it outlives the update), the [T, N, ...] buffers the graph's
        own until its next run."""
        c = self.carry
        _graph.load_tree((c.vec, c.obs, c.done, c.norm, self.inputs),
                         (runner.vec, runner.obs, runner.done, runner.obs_norm,
                          (log_std, noise)))
        self.aux.load(aux)
        c.t.zero_()
        if "extra" in self.out:
            self.out["extra"].zero_()
        self.step.replay(self.steps)
        vec, obs, done, norm, traj, out = _rollout_outputs(self.carry, self.out)
        return (*_graph.clone_tree((vec, obs, done, norm)), traj, out)

    def owned(self) -> list:
        """The tensors the graph owns outside its private pool."""
        return ([t for _, t in _graph.tensor_leaves((self.carry, self.inputs, self.out))]
                + [t for p, t in _graph.tensor_leaves(self.aux.tree) if p in self.aux.copied])

    @property
    def pool_bytes(self) -> int:
        return self.step.pool_bytes


class UpdateGraphs:
    """The captured rollout and minibatch steps of one ``update_step`` on a CUDA
    device with no process group or an NCCL one: captured at its first update, and
    again when a shape, a dtype or the structure of what a step reads changes (a
    resampled pool of another size, another runner's parameters) or the trainer
    replaces an aux tensor that the rollout graph reads in place (from then on the
    graph copies it; the opponent draw, new each update, does this once, at the
    second update). ``capture_seconds`` sums the time the captures took.

    Under a group every rank must capture, and so run the warm-ups' collectives,
    at the same update. Each decision compares what the caller hands with what the
    graphs hold (shapes, dtypes, and tensors the graphs keep alive, so that a new
    tensor never shows an old one's address): it changes where the trainer hands
    new tensors or shapes, which every rank's trainer does at the same update."""

    def __init__(self):
        self.rollout = None
        self.minibatch_graph = None
        self.capture_seconds = 0.0

    def _params_key(self, model):
        return tuple(p.data_ptr() for p in model.parameters())

    @torch.no_grad()
    def rollout_phase(self, cfg, hooks, runner, aux, log_std, noise, mesh=None):
        key = (_graph.signature((runner.vec, runner.obs, runner.done, runner.obs_norm,
                                 aux, log_std, noise)),
               self._params_key(runner.train.model))
        same = self.rollout is not None and self.rollout.key == key
        moved = self.rollout.aux.moved(aux) if same else frozenset()
        if not same or moved:
            copied = moved if self.rollout is None else self.rollout.aux.copied | moved
            self.rollout = None  # free the old graph's buffers before the new capture
            t0 = time.perf_counter()
            self.rollout = _RolloutGraph(cfg, hooks, runner, aux, log_std, noise, key,
                                         copied, mesh)
            self.capture_seconds += time.perf_counter() - t0
        return self.rollout.run(runner, aux, log_std, noise)

    def minibatch(self, cfg, model, inputs, opt_state, mesh=None) -> _MinibatchGraph:
        """The minibatch graph for ``inputs``, loaded with them and ``opt_state``
        (with a ``mesh``, every minibatch's advantage moments formed too)."""
        key = (_graph.signature((inputs, opt_state.mu, opt_state.nu)),
               self._params_key(model))
        if self.minibatch_graph is None or self.minibatch_graph.key != key:
            self.minibatch_graph = None
            t0 = time.perf_counter()
            self.minibatch_graph = _MinibatchGraph(cfg, model, inputs, opt_state, key, mesh)
            self.capture_seconds += time.perf_counter() - t0
        self.minibatch_graph.load(inputs, opt_state)
        return self.minibatch_graph

    def memory(self) -> dict:
        """Bytes the graphs hold: the buffers they own (static copies of their
        inputs, the rollout's carry and [T, N, ...] outputs, the minibatch loop's
        moments and carry) and their private pools."""
        graphs = [g for g in (self.rollout, self.minibatch_graph) if g is not None]
        return {"static_bytes": sum(t.nbytes for g in graphs for t in g.owned()),
                "pool_bytes": sum(g.pool_bytes for g in graphs)}


def _sharded_update(cfg: PPOConfig, mesh, model, opt_state, log_std, lr, batch: Batch,
                    generator, perm_consts, device, graphs=None):
    """The minibatch phase of a data-parallel update (``batch`` [T, n, ...], this
    rank's envs). ``data_shards`` = world: the shard-local layout, whose shard d is
    rank d's envs, so each rank runs the one-shard layout over its own envs with
    its row of the global permutation constants and the collectives make every
    minibatch the global one. ``data_shards`` = 1 on several ranks: the global
    shuffle; every rank gathers the whole batch and runs the same update, no
    data-group collective inside its loop. ``graphs`` as ``run_ppo_update`` takes
    it."""
    e_total, d_shards = cfg.update_epochs, cfg.data_shards
    _, n_units, _ = minibatch_layout(cfg)
    if d_shards == 1 and mesh.world > 1:
        full = Batch(*(pmesh.all_gather_rows(x, mesh, dim=1) for x in batch))
        flat = Batch(*(x.reshape((cfg.batch_size,) + x.shape[2:]) for x in full))
        perms = epoch_permutation(generator, n_units, shape=(e_total, 1),
                                  consts=perm_consts, device=device)
        return run_ppo_update(cfg, model, opt_state, log_std, lr, flat, perms,
                              graphs=graphs)
    if d_shards != mesh.world:
        raise ValueError(f"cfg.data_shards={d_shards} does not match the mesh's data "
                         f"axis ({mesh.world}); use data_shards={mesh.world} or 1")
    local = dataclasses.replace(cfg, num_envs=cfg.num_envs // mesh.world, data_shards=1)
    rank = mesh.rank
    if n_units & (n_units - 1) == 0:
        if perm_consts is None:
            perm_consts = draw_constants((e_total, d_shards), generator, device=device)
        perms = epoch_permutation(None, n_units, shape=(e_total, 1),
                                  consts=perm_consts[:, rank:rank + 1])
    else:
        perms = epoch_permutation(generator, n_units, shape=(e_total, d_shards),
                                  device=device)[:, rank:rank + 1]
    flat = Batch(*(x.reshape((local.batch_size,) + x.shape[2:]) for x in batch))
    return run_ppo_update(local, model, opt_state, log_std, lr, flat, perms, mesh=mesh,
                          graphs=graphs)


def make_update_step(cfg: PPOConfig, hooks: EnvHooks, action_dim: int = 2, mesh=None,
                     eager: bool = False):
    """Returns ``update_step(runner, aux, noise=None, perm_consts=None) -> (runner,
    metrics)``: one full PPO update. ``noise`` [num_steps, num_envs, action_dim] and
    ``perm_consts`` [update_epochs, data_shards, 8] (uint32 values) replace the
    draws from ``runner.generator``. ``metrics`` is the packed float32 numpy
    vector (``unpack_metrics``).

    On a CUDA device with no process group, or with one whose groups are NCCL's
    (``mesh.capturable``), the rollout and minibatch steps run as CUDA graphs, the
    collectives captured with them (``UpdateGraphs``, ``update_step.graphs``);
    ``eager=True`` runs them eagerly there too, as the CPU and a gloo group always
    do. Both give the same numbers to the bit where the group's reductions round
    alike graphed and eager (always with one rank).

    ``mesh``: a ``parallel.mesh.DataMesh``. With a process group, the runner and
    aux hold this rank's envs (``PPOTrainer.shard``), ``noise`` and
    ``perm_consts`` are still the global draws (this rank takes its rows), and the
    metrics are the whole run's on every rank. Without one (None, or one process
    with nothing initialized) the update is the single-process one."""
    if mesh is not None and mesh.group is None:
        mesh = None
    graphs = None if eager or not (mesh is None or mesh.capturable) else UpdateGraphs()

    def update_step(runner: RunnerState, aux, noise=None, perm_consts=None):
        train = runner.train
        model = train.model
        dev = runner.obs.device
        graphed = graphs is not None and dev.type == "cuda"
        dtype = next(model.parameters()).dtype
        gen = runner.generator
        _, lr, log_std = anneal_fractions(cfg, train.update, action_dim, device=dev)

        if cfg.reset_envs_each_update:
            runner = reset_env_state(hooks, runner, aux)

        if noise is None:
            noise = net.sample_noise((cfg.num_steps, cfg.num_envs, action_dim), gen,
                                     dtype=dtype, device=dev)
        if mesh is not None:
            # this rank's envs' columns, made contiguous: the rollout's policy kernel
            # reads noise row t as one [N, A] block
            noise = shard_rows(noise, mesh.shard, dim=1).contiguous()
        if graphed:
            vec, next_obs, next_done, norm, traj, sstats = graphs.rollout_phase(
                cfg, hooks, runner, aux, log_std, noise, mesh)
        else:
            vec, next_obs, next_done, norm, traj, sstats = rollout_phase(
                cfg, hooks, runner, aux, log_std, noise, mesh)

        rewards = sstats["reward"]                  # [T, N] f32
        with torch.no_grad():
            next_policy_obs = (obsnorm.apply(norm, next_obs) if cfg.normalize_obs
                               else next_obs)
            next_value = net.critic_value(model.params(), next_policy_obs)
            advantages, returns = compute_gae(
                rewards, sstats["done_entering"], traj.values, next_value, next_done,
                cfg.gamma, cfg.gae_lambda)
        batch = traj._replace(advantages=advantages, returns=returns)
        if mesh is None:
            flat = Batch(*(x.reshape((cfg.batch_size,) + x.shape[2:]) for x in batch))
            _, n_units, _ = minibatch_layout(cfg)
            perms = epoch_permutation(gen, n_units,
                                      shape=(cfg.update_epochs, cfg.data_shards),
                                      consts=perm_consts, device=dev)
            opt_state, stopped, ustats = run_ppo_update(
                cfg, model, train.opt_state, log_std, lr, flat, perms,
                graphs=graphs if graphed else None)
        else:
            opt_state, stopped, ustats = _sharded_update(
                cfg, mesh, model, train.opt_state, log_std, lr, batch, gen, perm_consts,
                dev, graphs=graphs if graphed else None)

        new_runner = RunnerState(
            train=TrainState(model=model, opt_state=opt_state, update=train.update + 1),
            vec=vec, obs=next_obs, done=next_done, generator=gen, obs_norm=norm)

        ep_count = sstats["ep_mask"].sum()
        device_vals = torch.stack([
            sstats["ep_return"].sum(dim=1).sum(),
            sstats["ep_length"].sum().to(torch.float32),
            ep_count.to(torch.float32),
            rewards.mean(),
        ])
        if "extra" in sstats:  # the hook's sums ride the same transfer
            device_vals = torch.cat([device_vals, sstats["extra"].to(torch.float32)])
        if mesh is not None:  # every rank's sums; the mean reward of equal shards
            pmesh.all_reduce_sum_(device_vals, mesh)
            device_vals[3] /= mesh.world
        host = device_vals.cpu().numpy()
        ret_sum, len_sum, count, mean_reward = host[:4]
        f32 = np.float32
        metrics = {
            "update": f32(train.update),
            # derived from the update index: exact to 2^24 steps in this f32
            # packing; the host re-derives the exact integer as update * batch_size
            "global_step": f32(train.update + 1) * f32(cfg.batch_size),
            "lr": lr,
            "log_std": f32(log_std[0].item()),
            "episodes": count,
            "mean_ep_return": ret_sum / count if count > 0 else f32(np.nan),
            "mean_ep_length": len_sum / count if count > 0 else f32(np.nan),
            "kl_stopped": f32(stopped),
            "minibatches_applied": ustats["applied"].sum(dtype=np.float32),
            "approx_kl": _last_computed(ustats, "approx_kl"),
            "pg_loss": _last_computed(ustats, "pg_loss"),
            "v_loss": _last_computed(ustats, "v_loss"),
            "entropy": _last_computed(ustats, "entropy"),
            "mean_reward": mean_reward,
        }
        assert tuple(metrics) == METRIC_NAMES
        # the hook's sums ride after the named metrics ("_extra")
        packed = np.concatenate([np.array(list(metrics.values()), dtype=np.float32),
                                 host[4:]])
        return new_runner, packed

    update_step.graphs = graphs
    return update_step


METRIC_NAMES = (
    "update", "global_step", "lr", "log_std", "episodes", "mean_ep_return",
    "mean_ep_length", "kl_stopped", "minibatches_applied", "approx_kl",
    "pg_loss", "v_loss", "entropy", "mean_reward",
)


def unpack_metrics(packed):
    """Packed f32 metric vector -> {name: value}. Values past the named metrics
    (an ``EnvHooks.stats`` tail) land under ``"_extra"`` as an array."""
    vals = np.asarray(packed)
    out = dict(zip(METRIC_NAMES, vals))
    if len(vals) > len(METRIC_NAMES):
        out["_extra"] = vals[len(METRIC_NAMES):]
    return out

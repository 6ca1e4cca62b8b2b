"""PPO: rollout, GAE and the clipped update with the KL early exit (port of
``self_play_racing_tpu/agent/ppo.py``).

One update is an eager loop: ``num_steps`` vector env steps (sample, transition,
NEXT_STEP autoreset, observe), GAE over the rollout (kernel K6 on the card), the
epoch permutations (kernel K7 on the card), then ``update_epochs`` x
``num_minibatches`` clipped updates. Semantics kept from the JAX package:

- approx_kl = mean(old_logprob - new_logprob); once it exceeds ``kl_target`` the
  triggering minibatch is not applied and the update exits (no later minibatch is
  computed). Its stats are still recorded, with ``computed=1`` and ``applied=0``.
  The decision is one host read per minibatch.
- per-minibatch advantage normalization with the unbiased std plus 1e-8;
- clipped value loss 0.5*max(unclipped, clipped); the entropy bonus is a constant
  (log_std is an annealed buffer, not a parameter);
- lr anneal frac*lr -> 0 and log_std anneal start -> end by update index, in
  float32; the learning rate is applied by hand, ``params + (-lr * u)``;
- gradients clipped by global norm as optax does it, then Adam(eps=1e-5) in
  optax's order (``clip_by_global_norm``, ``adam_update``); not ``torch.optim``,
  whose Adam folds the bias corrections into the step size and rounds otherwise;
- episode statistics harvested from the autoreset wrapper's records; the update's
  metrics packed into one float32 vector in ``METRIC_NAMES`` order.

The model's ``nn.Parameter``s are trained in place by ``torch.autograd``; the Adam
state is functional (each step returns a new ``AdamState``). JAX's PRNG keys become
``torch.Generator``s: the rollout's action noise and the permutations' round
constants are drawn from the runner's generator, or passed in, so tests can feed
the port and the JAX package the same numbers.

Data parallelism (``make_update_step(..., mesh=...)``, a ``parallel.mesh.DataMesh``
with a process group): each rank steps its own envs, draws the global noise and
constants and keeps its rows, and reduces over the group what the JAX program
reduces over the env or batch axis (``parallel/mesh.py`` lists them). Without a
group the update is the single-process one, unchanged. On a ``TensorMesh`` the
same reductions run over the data group, the model holds this rank's slices of the
towers (its forward sums their partial products over the model group), Adam runs
on the slices, and ``global_norm`` is the full gradient's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..configs import PPOConfig
from ..envs import normalize as obsnorm
from ..envs import vector
from ..models import actor_critic as net
from ..ops.gae import compute_gae
from ..ops.prng import draw_constants, epoch_permutation
from .._tree import shard_rows
from ..parallel import mesh as pmesh

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-5
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


STAT_NAMES = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl", "clip_frac",
              "applied", "computed")


def _ppo_loss(params, log_std, mb: Batch, cfg: PPOConfig, mesh=None):
    new_lp, entropy, new_v = net.evaluate_action(params, log_std, mb.obs, mb.actions)
    log_ratio = new_lp - mb.logprobs
    ratio = torch.exp(log_ratio)
    approx_kl = torch.mean(-log_ratio)  # mean(old - new)

    adv = mb.advantages
    if mesh is None:
        adv = (adv - adv.mean()) / (adv.std(correction=1) + 1e-8)
    else:  # the minibatch is every rank's part: its global mean and std
        mean, std = pmesh.global_mean_std(adv, mesh)
        adv = (adv - mean) / (std + 1e-8)

    pg1 = -adv * ratio
    pg2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_coef, 1.0 + cfg.clip_coef)
    pg_loss = torch.maximum(pg1, pg2).mean()

    v_clip = mb.values + torch.clamp(new_v - mb.values, -cfg.clip_coef, cfg.clip_coef)
    v_loss = 0.5 * torch.maximum(
        (new_v - mb.returns) ** 2, (v_clip - mb.returns) ** 2).mean()

    e_loss = -entropy.mean()
    loss = pg_loss + cfg.ent_coef * e_loss + cfg.vf_coef * v_loss
    stats = {
        "loss": loss, "pg_loss": pg_loss, "v_loss": v_loss,
        "entropy": -e_loss, "approx_kl": approx_kl,
        "clip_frac": ((ratio - 1.0).abs() > cfg.clip_coef).to(torch.float32).mean(),
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


def clip_by_global_norm(grads, g_norm: torch.Tensor, below: bool, max_norm: float):
    """``optax.clip_by_global_norm``: the gradients as they are when ``g_norm <
    max_norm`` (``below``, decided on the host), else ``(g / g_norm) * max_norm``.
    (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6`` instead.)"""
    if below:
        return list(grads)
    return list(torch._foreach_mul(torch._foreach_div(grads, g_norm), max_norm))


def bias_correction(b: float, count: int, dtype: torch.dtype) -> float:
    """``1 - b**count`` taken in ``dtype``, as optax takes it from its int32 count
    and a weakly typed ``b``: a float32 pow for float32 moments, a float64 one for
    float64 moments."""
    t = np.dtype(str(dtype).removeprefix("torch.")).type
    return float(t(1) - t(b) ** t(count))


def adam_update(grads, state: AdamState, b1: float = ADAM_B1, b2: float = ADAM_B2,
                eps: float = ADAM_EPS):
    """``optax.scale_by_adam`` in its order: the moments, the count, the bias
    corrections (``bias_correction``) and ``mu_hat / (sqrt(nu_hat) + eps)``.
    Returns (updates, new state)."""
    mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                            torch._foreach_mul(state.mu, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                            torch._foreach_mul(state.nu, b2))
    count = min(state.count + 1, _INT32_MAX)
    ref = grads[0]
    bc1 = torch.full((), bias_correction(b1, count, ref.dtype), dtype=ref.dtype,
                     device=ref.device)
    bc2 = torch.full((), bias_correction(b2, count, ref.dtype), dtype=ref.dtype,
                     device=ref.device)
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
    updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
    return list(updates), AdamState(count=count, mu=list(mu), nu=list(nu))


@torch.no_grad()
def apply_updates(params, updates, lr) -> None:
    """``params + (-lr * u)``, in place on the parameters."""
    torch._foreach_add_(params, torch._foreach_mul(updates, -float(lr)))


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a comparison against a tensor of that
    dtype rounds its Python-float operand."""
    return float(torch.tensor(value, dtype=dtype))


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
    minibatch part is an equal share), in one flat all-reduce."""
    stat = torch.stack([st[k].detach().to(grads[0].dtype) for k in STAT_NAMES[:6]])
    flat = torch.cat([g.reshape(-1) for g in grads] + [stat])
    pmesh.all_reduce_sum_(flat, mesh).div_(mesh.world)
    out, at = [], 0
    for g in grads:
        out.append(flat[at:at + g.numel()].view_as(g))
        at += g.numel()
    return out, dict(zip(STAT_NAMES[:6], flat[at:]))


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


def run_ppo_update(cfg: PPOConfig, model: net.ActorCritic, opt_state: AdamState,
                   log_std, lr, flat: Batch, perms, mesh=None):
    """Epochs x minibatches of clipped updates with the KL early exit.

    ``flat`` is the flattened [batch_size, ...] rollout (flat index
    ``t*num_envs + n``); ``perms`` [epochs, data_shards, n_units] are the epoch
    permutations of block units (``minibatch_layout``). Minibatch m of epoch e
    takes units ``perms[e, :, m*mb_units:(m+1)*mb_units]`` from each shard. With
    ``data_shards`` = D > 1 the batch is laid out as [T, D, n_sub] -> [D, T, n_sub]
    -> [D, units, block] first, so each shard contributes an equal stratum.

    Trains ``model``'s parameters in place. Returns (opt_state, stopped, stats):
    ``stats`` maps ``STAT_NAMES`` to [epochs, minibatches] float32 numpy arrays,
    zero past the exit, with ``computed`` marking the executed minibatches and
    ``applied`` the applied ones.

    With a ``mesh`` (a group), ``flat`` and ``perms`` are this rank's part of each
    minibatch: the advantages are normalized by the global moments, and the
    gradients and stats are averaged over the group before the host reads them,
    so every rank applies the same update and takes the same exit.
    """
    d_shards = cfg.data_shards
    e_total, m_total = cfg.update_epochs, cfg.num_minibatches
    _, n_units, mb_units = minibatch_layout(cfg)
    if tuple(perms.shape) != (e_total, d_shards, n_units):
        raise ValueError(f"run_ppo_update: perms {tuple(perms.shape)}, expected "
                         f"{(e_total, d_shards, n_units)}")
    blocked = shard_blocks(cfg, flat)
    perms = perms.to(device=flat.obs.device, dtype=torch.int64)
    shard = torch.arange(d_shards, device=perms.device)[:, None]

    params = list(model.parameters())
    dtype = params[0].dtype
    kl_target = _in_dtype(cfg.kl_target, dtype)
    max_norm = _in_dtype(cfg.max_grad_norm, dtype)
    stats = {name: np.zeros((e_total * m_total,), np.float32) for name in STAT_NAMES}
    stopped = False
    for i in range(e_total * m_total):
        e, m = divmod(i, m_total)
        idx = perms[e, :, m * mb_units:(m + 1) * mb_units]
        mb = Batch(*(x[shard, idx].reshape((cfg.minibatch_size,) + x.shape[3:])
                     for x in blocked))
        with torch.enable_grad():
            loss, st = _ppo_loss(model.params(), log_std, mb, cfg, mesh)
            grads = torch.autograd.grad(loss, params)
        if mesh is not None:
            grads, st = _mean_over_group(grads, st, mesh)
        g_norm = global_norm(grads, model.tensor_parallel)
        # the one host read of the minibatch: its stats, the KL flag and the norm
        host = torch.stack([st[k] for k in STAT_NAMES[:6]] + [g_norm]).tolist()
        for k, v in zip(STAT_NAMES[:6], host):
            stats[k][i] = v
        stats["computed"][i] = 1.0
        if host[STAT_NAMES.index("approx_kl")] > kl_target:  # in the loss's dtype
            # the triggering minibatch is not applied, and the update exits
            stopped = True
            break
        stats["applied"][i] = 1.0
        grads = clip_by_global_norm(grads, g_norm, host[-1] < max_norm, cfg.max_grad_norm)
        updates, opt_state = adam_update(grads, opt_state)
        apply_updates(params, updates, lr)
    stats = {k: v.reshape(e_total, m_total) for k, v in stats.items()}
    return opt_state, stopped, stats


def _last_computed(ustats, name):
    """Value of ``name`` at the last executed minibatch (``run_ppo_update`` leaves
    slots after the KL exit at zero; ``computed`` marks the executed ones)."""
    n = int(np.sum(ustats["computed"]))
    return ustats[name].reshape(-1)[max(n - 1, 0)]


@torch.no_grad()
def rollout_phase(cfg: PPOConfig, hooks: EnvHooks, runner: RunnerState, aux, log_std,
                  noise, mesh=None):
    """``num_steps`` vector env steps under the current policy.

    ``noise`` [T, N, A] is the standard-normal action noise (N this rank's envs;
    with a ``mesh`` the observation normalizer merges every rank's). Returns (vec,
    next_obs, next_done, obs_norm, traj, step_stats): ``traj`` a ``Batch`` of
    [T, N, ...] tensors (advantages and returns empty), ``step_stats`` the
    per-step rewards (float32), done-entering flags and episode records, and the
    rollout's sum of ``hooks.stats`` under "extra" when the hooks have one."""
    params = runner.train.model.params()
    vec, obs, done, norm = runner.vec, runner.obs, runner.done, runner.obs_norm
    keys = ("obs", "actions", "logprobs", "values", "reward", "done_entering",
            "ep_return", "ep_length", "ep_mask")
    out = {k: [] for k in keys}
    extra = None
    for t in range(cfg.num_steps):
        if cfg.normalize_obs:
            norm = obsnorm.update(norm, obs, mesh)
            policy_obs = obsnorm.apply(norm, obs)
        else:
            policy_obs = obs
        action, logprob, value = net.sample_action(params, log_std, policy_obs, noise[t])
        vec, next_obs, reward, next_done, _, _, info, rec = vector.step(
            vec, action,
            lambda s, a, g: hooks.transition(aux, s, a, g),
            lambda s: hooks.observe(aux, s),
            lambda g: hooks.reset(aux, g),
            refresh_fn=(None if hooks.refresh is None
                        else (lambda s: hooks.refresh(aux, s))),
            info_fn=(None if hooks.info is None else (lambda s: hooks.info(aux, s))),
        )
        if hooks.stats is not None:
            st = hooks.stats(aux, info, rec)
            extra = st if extra is None else extra + st
        out["obs"].append(policy_obs)
        out["actions"].append(action)
        out["logprobs"].append(logprob)
        out["values"].append(value)
        out["reward"].append(reward.to(torch.float32))
        out["done_entering"].append(done)
        out["ep_return"].append(torch.where(rec["mask"], rec["return"], 0.0))
        out["ep_length"].append(torch.where(rec["mask"], rec["length"], 0))
        out["ep_mask"].append(rec["mask"])
        obs, done = next_obs.to(torch.float32), next_done
    stacked = {k: torch.stack(v) for k, v in out.items()}
    if extra is not None:
        stacked["extra"] = extra
    traj = Batch(obs=stacked["obs"], actions=stacked["actions"],
                 logprobs=stacked["logprobs"], advantages=None, returns=None,
                 values=stacked["values"])
    return vec, obs, done, norm, traj, stacked


def _sharded_update(cfg: PPOConfig, mesh, model, opt_state, log_std, lr, batch: Batch,
                    generator, perm_consts, device):
    """The minibatch phase of a data-parallel update (``batch`` [T, n, ...], this
    rank's envs). ``data_shards`` = world: the shard-local layout, whose shard d is
    rank d's envs, so each rank runs the one-shard layout over its own envs with
    its row of the global permutation constants and the collectives make every
    minibatch the global one. ``data_shards`` = 1 on several ranks: the global
    shuffle; every rank gathers the whole batch and runs the same update."""
    e_total, d_shards = cfg.update_epochs, cfg.data_shards
    _, n_units, _ = minibatch_layout(cfg)
    if d_shards == 1 and mesh.world > 1:
        full = Batch(*(pmesh.all_gather_rows(x, mesh, dim=1) for x in batch))
        flat = Batch(*(x.reshape((cfg.batch_size,) + x.shape[2:]) for x in full))
        perms = epoch_permutation(generator, n_units, shape=(e_total, 1),
                                  consts=perm_consts, device=device)
        return run_ppo_update(cfg, model, opt_state, log_std, lr, flat, perms)
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
    return run_ppo_update(local, model, opt_state, log_std, lr, flat, perms, mesh=mesh)


def make_update_step(cfg: PPOConfig, hooks: EnvHooks, action_dim: int = 2, mesh=None):
    """Returns ``update_step(runner, aux, noise=None, perm_consts=None) -> (runner,
    metrics)``: one full PPO update. ``noise`` [num_steps, num_envs, action_dim] and
    ``perm_consts`` [update_epochs, data_shards, 8] (uint32 values) replace the
    draws from ``runner.generator``. ``metrics`` is the packed float32 numpy
    vector (``unpack_metrics``).

    ``mesh``: a ``parallel.mesh.DataMesh``. With a process group, the runner and
    aux hold this rank's envs (``PPOTrainer.shard``), ``noise`` and
    ``perm_consts`` are still the global draws (this rank takes its rows), and the
    metrics are the whole run's on every rank. Without one (None, or one process
    with nothing initialized) the update is the single-process one."""
    if mesh is not None and mesh.group is None:
        mesh = None

    def update_step(runner: RunnerState, aux, noise=None, perm_consts=None):
        train = runner.train
        model = train.model
        dev = runner.obs.device
        dtype = next(model.parameters()).dtype
        gen = runner.generator
        _, lr, log_std = anneal_fractions(cfg, train.update, action_dim, device=dev)

        if cfg.reset_envs_each_update:
            # the reference rebuilds every env each update but keeps its stale
            # next_obs/next_done: the env state resets (and an env that caches
            # observations senses it: self-play's opponents act on the fresh
            # reset obs), runner.obs/done do not
            env_state, _ = reset_observe(hooks, aux, runner.vec.generator)
            runner = dataclasses.replace(
                runner, vec=vector.init(env_state, runner.done.shape[0], runner.vec.generator))

        if noise is None:
            noise = net.sample_noise((cfg.num_steps, cfg.num_envs, action_dim), gen,
                                     dtype=dtype, device=dev)
        if mesh is not None:
            noise = shard_rows(noise, mesh.shard, dim=1)
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
                cfg, model, train.opt_state, log_std, lr, flat, perms)
        else:
            opt_state, stopped, ustats = _sharded_update(
                cfg, mesh, model, train.opt_state, log_std, lr, batch, gen, perm_consts,
                dev)

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

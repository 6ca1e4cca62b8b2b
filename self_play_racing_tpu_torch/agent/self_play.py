"""Snapshot-pool self-play PPO trainer (port of
``self_play_racing_tpu/agent/self_play.py``).

 - Every ``snapshot_freq`` updates the current policy (its parameters, the log_std
   its buffer holds, and its observation statistics when it normalizes) is frozen
   into a ring of ``pool_size`` opponents, the oldest overwritten. The pool is
   stacked ``[P, ...]`` tensors with a write head ``num_snapshots % P``.
 - Before every update the rollout's opponent is chosen on the host from
   ``np.random.RandomState(cfg.seed)``, as the JAX package chooses it: one index
   shared by all envs (the reference's mode) or one per env
   (``cfg.opponent_per_env``), uniformly or by PFSP weights; an empty pool means
   random opponents.
 - PFSP: per-slot wins and games of the learner, counted on device from rollout
   episodes that ended against a policy opponent (in the env step's launch on the
   card; the rollout's "extra", the packed metrics' "_extra" tail), reach the host
   one update late and are zeroed when a slot is overwritten.
 - A full checkpoint (format v1 of ``utils.checkpoint``, with the JAX package's
   leaf names) every ``checkpoint_every`` updates and at the end of ``train()``
   on the interval, with ``resume_from`` for v1 and v0 files and the reference's
   ``.pth`` training checkpoints.
 - ``shard(mesh)``: data-parallel training. The pool is replicated and every rank
   takes the same snapshots; the opponent indices are chosen for every env on
   every rank alike, and each rank keeps its envs' rows; the PFSP counters are
   summed over the group with the metrics; rank 0 writes the checkpoints. On a
   ``TensorMesh`` the learner's towers are split over the model group: snapshots
   and checkpoints take the whole parameters, gathered.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from .. import interop
from ..configs import PPOConfig
from ..envs import multi as menv
from ..envs import normalize as obsnorm
from ..envs import selfplay as sp
from ..envs import track as trk
from ..models import actor_critic as net
from ..parallel import mesh as pmesh
from ..utils import checkpoint as ckpt
from . import ppo
from .trainer import PPOTrainer


def make_selfplay_hooks(env_cfg: menv.MultiRacingConfig, pool_size: int = 0,
                        shard=None) -> ppo.EnvHooks:
    """EnvHooks over the self-play view; aux = {"track": ..., "opp": ...}. The step
    is ``selfplay.transition_autoreset``.

    ``pool_size`` > 0: the step also counts per-slot [wins..., games...] of the
    learner against each pool opponent into the rollout's "extra", from the episodes
    that ended (placement 1 is a win), the signal PFSP sampling feeds on. ``shard`` =
    (rank, world): the aux holds this rank's envs of a data-parallel run, and the
    start-grid and opponent draws are this rank's rows of the draws for all envs."""

    def reset(aux, generator):
        return sp.reset_state_deferred(env_cfg, aux["track"], generator, shard=shard)

    def step(aux, state, action, generator, pending_reset, stats, rows):
        return sp.transition_autoreset(env_cfg, aux["track"], aux["opp"], state, action,
                                       pending_reset, stats, generator, shard=shard, rows=rows,
                                       pool_size=pool_size)

    def observe(aux, state):
        return sp.observe(state)

    def refresh(aux, state):
        return sp.refresh(env_cfg, aux["track"], state)

    return ppo.EnvHooks(reset=reset, step=step, observe=observe, refresh=refresh)


def empty_pool(pool_size: int, obs_dim: int, action_dim: int, hidden, normalize_obs: bool,
               device=None):
    """The zeroed stacked pool: ``params`` in the actor-critic's layout with a
    leading pool axis, ``log_std`` [P, action_dim] and, for a normalizing learner,
    ``norm_mean``/``norm_var`` [P, obs_dim] (zeros and ones)."""
    proto = net.init_params(torch.Generator().manual_seed(0), obs_dim, action_dim,
                            hidden=hidden)
    stack = lambda t: torch.zeros((pool_size,) + t.shape, dtype=t.dtype, device=device)
    pool = {
        "params": {k: [(stack(w), stack(b)) for w, b in layers]
                   for k, layers in proto.items()},
        "log_std": torch.zeros((pool_size, action_dim), dtype=torch.float32,
                               device=device),
    }
    if normalize_obs:
        pool["norm_mean"] = torch.zeros((pool_size, obs_dim), dtype=torch.float32,
                                        device=device)
        pool["norm_var"] = torch.ones((pool_size, obs_dim), dtype=torch.float32,
                                      device=device)
    return pool


class SelfPlayTrainer(PPOTrainer):
    """The reference's SelfPlayPPO. ``track`` is the per-env TrackArrays or a
    capacity layout (``envs/track.py``); ``eager`` as ``PPOTrainer`` takes it."""

    def __init__(self, cfg: PPOConfig, env_cfg: menv.MultiRacingConfig,
                 track: trk.Track, eager: bool = False):
        if cfg.pool_size <= 0 or cfg.snapshot_freq <= 0:
            raise ValueError("self-play needs pool_size > 0 and snapshot_freq > 0")
        self.pool_size = cfg.pool_size
        self.snapshot_freq = cfg.snapshot_freq
        self.num_snapshots = 0  # taken in all; the write head is num_snapshots % P
        self._opp_rng = np.random.RandomState(cfg.seed)
        self.checkpoint_dir: Optional[str] = None
        self.checkpoint_every = 10
        self._resumed_at_update = -1  # the update whose checkpoint was loaded
        self._pool_count_by_update = {}  # update -> pool size its rollout faced
        self.pool_wins = np.zeros((cfg.pool_size,), np.float64)
        self.pool_games = np.zeros((cfg.pool_size,), np.float64)
        dev = trk.rows_of(track)[0].wp_x.device
        self.pool = empty_pool(cfg.pool_size, env_cfg.obs_dim, env_cfg.action_dim,
                               cfg.hidden, cfg.normalize_obs, device=dev)
        idx_shape = (cfg.num_envs,) if cfg.opponent_per_env else ()
        aux = {"track": track,
               "opp": self._opp_aux(torch.zeros(idx_shape, dtype=torch.int32),
                                    torch.zeros(idx_shape, dtype=torch.bool))}
        super().__init__(cfg, env_cfg, track,
                         hooks=make_selfplay_hooks(env_cfg, cfg.pool_size), aux=aux,
                         eager=eager)
        self.training_info["opponent_pool_size"] = []
        self.training_info["pool_win_rate"] = []

    def shard(self, mesh: pmesh.DataMesh):
        """``PPOTrainer.shard`` with the self-play hooks drawing this rank's rows of
        the start grids and opponent draws, and the pool rank 0's on every rank
        (it is built alike on every rank, and every rank takes the same
        snapshots of the replicated learner)."""
        self.hooks = make_selfplay_hooks(self.env_cfg, self.pool_size, shard=mesh.shard)
        super().shard(mesh)
        self.pool = pmesh.replicate_tree(self.pool, mesh)

    # ---- pool ------------------------------------------------------------------

    @property
    def pool_count(self) -> int:
        return min(self.num_snapshots, self.pool_size)

    def _opp_aux(self, idx, use):
        return {"params": self.pool["params"], "log_std": self.pool["log_std"],
                "norm_mean": self.pool.get("norm_mean"),
                "norm_var": self.pool.get("norm_var"),
                "idx": idx, "use_policy": use}

    @torch.no_grad()
    def snapshot_agent(self):
        """Freeze the current parameters and ``buffer_log_std`` (the anneal of the
        last completed update: the reference snapshots at the top of an update,
        before its anneal) into the ring slot, and void that slot's outcomes."""
        slot = self.num_snapshots % self.pool_size
        pool_leaves = [t for layers in self.pool["params"].values()
                       for layer in layers for t in layer]
        for p, x in zip(pool_leaves, self.full_state()[0]):
            p[slot].copy_(x)
        self.pool["log_std"][slot].copy_(self.buffer_log_std)
        if "norm_mean" in self.pool:
            self.pool["norm_mean"][slot].copy_(self.runner.obs_norm.mean)
            self.pool["norm_var"][slot].copy_(self.runner.obs_norm.var)
        self.num_snapshots += 1
        self.pool_wins[slot] = 0.0
        self.pool_games[slot] = 0.0

    def opponent_weights(self) -> np.ndarray:
        """PFSP distribution over the live slots: ``(1 - p)**pfsp_power``
        normalized, with the Laplace-smoothed win rate ``p = (wins+1)/(games+2)``."""
        count = self.pool_count
        p_win = (self.pool_wins[:count] + 1.0) / (self.pool_games[:count] + 2.0)
        w = (1.0 - p_win) ** self.cfg.pfsp_power
        return w / w.sum()

    def select_opponent(self):
        """The rollout's opponents: uniform or PFSP over the live slots, one index
        per env or one shared; random opponents while the pool is empty."""
        count = self.pool_count
        cfg = self.cfg
        shape = (cfg.num_envs,) if cfg.opponent_per_env else ()
        if count == 0:
            idx = np.zeros(shape, np.int32)
            use = np.zeros(shape, bool)
        elif cfg.opponent_sampling == "pfsp":
            idx = self._opp_rng.choice(count, size=shape,
                                       p=self.opponent_weights()).astype(np.int32)
            use = np.ones(shape, bool)
        else:
            idx = self._opp_rng.randint(0, count, size=shape).astype(np.int32)
            use = np.ones(shape, bool)
        self.aux["opp"] = self._place_aux(self._opp_aux(torch.as_tensor(idx),
                                                        torch.as_tensor(use)))

    # ---- trainer hooks ---------------------------------------------------------

    def _pre_update(self):
        super()._pre_update()
        update = self._host_update
        # strict <: a checkpoint written at a snapshot update holds that snapshot,
        # so resuming from it must not take it twice
        if update > 0 and update % self.snapshot_freq == 0 and \
                self.num_snapshots * self.snapshot_freq < update:
            self.snapshot_agent()
        self.select_opponent()
        # the state after update N, before update N+1; not the update resumed from
        if self.checkpoint_dir and update > 0 and update % self.checkpoint_every == 0 \
                and update != self._resumed_at_update:
            self.save_checkpoint(os.path.join(self.checkpoint_dir,
                                              f"checkpoint_update_{update}"))
        self._pool_count_by_update[update] = self.pool_count

    def _post_update(self, metrics):
        update = int(metrics["update"])
        count = self._pool_count_by_update.pop(update, self.pool_count)
        extra = metrics.get("_extra")
        if extra is not None and extra.size == 2 * self.pool_size:
            self.pool_wins += extra[: self.pool_size].astype(np.float64)
            self.pool_games += extra[self.pool_size:].astype(np.float64)
        if int(metrics["episodes"]) > 0:
            self.training_info["opponent_pool_size"].append(count)
            games = self.pool_games.sum()
            self.training_info["pool_win_rate"].append(
                float(self.pool_wins.sum() / games) if games > 0 else float("nan"))

    # ---- checkpoint and resume -------------------------------------------------

    def _ckpt_tree(self, legacy_v0: bool = False):
        """The checkpointed state in the JAX package's tree layout: ``train``
        (params, optax's ``(EmptyState(), ScaleByAdamState(count, mu, nu))``,
        update), ``pool`` and, when normalizing, ``obs_norm``. ``legacy_v0`` adds
        the dead ``global_step`` leaf of the old TrainState."""
        train = self.runner.train
        params, mu, nu = self.full_state()
        fields = ckpt.Fields(
            params=interop._pytree(params),
            opt_state=(ckpt.Fields(), ckpt.Fields(count=np.int32(train.opt_state.count),
                                                  mu=interop._pytree(mu),
                                                  nu=interop._pytree(nu))),
            update=np.int32(train.update))
        if legacy_v0:
            fields["global_step"] = np.int32(0)
        tree = {"train": fields, "pool": self.pool}
        if self.cfg.normalize_obs:
            norm = self.runner.obs_norm
            tree["obs_norm"] = ckpt.Fields(mean=norm.mean, var=norm.var, count=norm.count)
        return tree

    def save_checkpoint(self, path: str):
        meta = {
            "num_snapshots": self.num_snapshots,
            "global_step": self._host_update * self.cfg.batch_size,
            "config": dataclasses.asdict(self.cfg),
            "training_info": self.training_info,
            "pool_wins": self.pool_wins.tolist(),
            "pool_games": self.pool_games.tolist(),
        }
        ckpt.save_pytree(path, self._ckpt_tree(), meta, mesh=self._mesh)
        if self._writes_files:
            print(f"Saved full checkpoint to {path}")

    @torch.no_grad()
    def _set_train(self, params, mu, nu, count: int, update: int):
        """Load learner parameters and Adam state (arrays in parameter order)."""
        model = self.runner.train.model
        dev = self.device
        for p, x in zip(model.parameters(), params):
            p.copy_(torch.as_tensor(np.asarray(x), dtype=p.dtype))
        like = [p.detach() for p in model.parameters()]
        # laid out as the parameters (the reference's moments arrive transposed),
        # as the tail's kernel takes them
        as_t = lambda xs: [torch.as_tensor(np.asarray(x), dtype=t.dtype, device=dev)
                           .clone(memory_format=torch.contiguous_format)
                           for x, t in zip(xs, like)]
        self.runner.train = ppo.TrainState(
            model=model, opt_state=ppo.AdamState(count=int(count), mu=as_t(mu), nu=as_t(nu)),
            update=int(update))

    def load_checkpoint(self, path: str):
        """Resume from a checkpoint of either package, format v1 or v0."""
        legacy = ckpt.format_version(path) == 0
        tree, meta = ckpt.load_pytree(path, self._ckpt_tree(legacy_v0=legacy))
        train = tree["train"]
        adam = train["opt_state"][1]
        leaves = lambda t: [a for tower in ("actor", "critic") for layer in t[tower]
                            for a in layer]
        self._set_train(leaves(train["params"]), leaves(adam["mu"]), leaves(adam["nu"]),
                        int(adam["count"]), int(train["update"]))
        if "obs_norm" in tree:
            self.runner.obs_norm = obsnorm.ObsNormState(
                **{k: torch.as_tensor(v, device=self.device)
                   for k, v in tree["obs_norm"].items()})
        self.pool = interop.pool_from_jax(tree["pool"], device=self.device)
        self.num_snapshots = int(meta["num_snapshots"])
        self._host_update = self.runner.train.update
        self.training_info = meta.get(
            "training_info", {"steps": [], "rewards": [], "opponent_pool_size": []})
        self.training_info.setdefault("pool_win_rate", [])
        if "pool_wins" in meta:
            self.pool_wins = np.asarray(meta["pool_wins"], np.float64)
            self.pool_games = np.asarray(meta["pool_games"], np.float64)
        print(f"Loaded checkpoint from {path} "
              f"(update {self.runner.train.update}, pool {self.pool_count})")

    @torch.no_grad()
    def load_torch_checkpoint(self, path: str):
        """Resume from a reference training checkpoint (``.pth``): parameters, Adam
        moments and step, the opponent pool, counters and training curves.

        The reference's 0-based ``update`` u means u + 1 completed updates, so the
        counters resume at u + 1; its oldest-to-newest pool list maps onto ring
        slots by global snapshot index. Weights transpose from (out, in) to
        (in, out), and so do the Adam moments."""
        ck = torch.load(path, map_location="cpu", weights_only=False)
        params, _ = net.params_from_torch_state_dict(ck["agent_state_dict"])
        leaves = [t for tower in ("actor", "critic") for layer in params[tower]
                  for t in layer]
        mine = list(self.runner.train.model.parameters())
        if [t.shape for t in leaves] != [t.shape for t in mine]:
            raise ValueError(f"{path}: agent architecture does not match "
                             f"cfg.hidden={self.cfg.hidden}")
        opt_sd = ck["optimizer_state_dict"]
        order = opt_sd["param_groups"][0]["params"]
        state = opt_sd["state"]

        def moment(i, field, like):
            if i not in state:  # the optimizer never stepped
                return torch.zeros_like(like)
            m = state[i][field].detach().to(torch.float64)
            return m.T if m.ndim == 2 else m

        mu = [moment(i, "exp_avg", t).cpu().numpy() for i, t in zip(order, leaves)]
        nu = [moment(i, "exp_avg_sq", t).cpu().numpy() for i, t in zip(order, leaves)]
        count = int(state[order[0]]["step"]) if order and order[0] in state else 0
        completed = int(ck["update"]) + 1
        self._set_train([t.numpy() for t in leaves], mu, nu, count, completed)
        self._host_update = completed

        pool_sds = ck.get("opponent_pool", [])
        if len(pool_sds) > self.pool_size:
            raise ValueError(f"{path}: pool has {len(pool_sds)} snapshots > "
                             f"pool_size={self.pool_size}")
        self.num_snapshots = max(int(ck["update"]) // self.snapshot_freq, len(pool_sds))
        first_global = self.num_snapshots - len(pool_sds)
        for k, sd in enumerate(pool_sds):
            opp_params, opp_log_std = net.params_from_torch_state_dict(sd)
            slot = (first_global + k) % self.pool_size
            opp = [t for tower in ("actor", "critic") for layer in opp_params[tower]
                   for t in layer]
            pool_leaves = [t for layers in self.pool["params"].values()
                           for layer in layers for t in layer]
            for p, x in zip(pool_leaves, opp):
                p[slot].copy_(x)
            self.pool["log_std"][slot].copy_(opp_log_std)
            # reference agents act on raw observations: a normalizing pool keeps
            # its identity statistics for these slots
        self._resumed_at_update = completed
        self.training_info = ck.get(
            "training_info", {"steps": [], "rewards": [], "opponent_pool_size": []})
        self.training_info.setdefault("opponent_pool_size", [])
        self.training_info.setdefault("pool_win_rate", [])
        print(f"Loaded reference torch checkpoint {path} "
              f"(resuming at update {completed}, pool {self.pool_count})")

    def train(self, num_updates: Optional[int] = None, log_every: int = 1,
              on_update=None, resume_from: Optional[str] = None,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 10):
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        if checkpoint_dir:
            os.makedirs(checkpoint_dir, exist_ok=True)
        if resume_from:
            if resume_from.endswith((".pth", ".pt")):
                self.load_torch_checkpoint(resume_from)
            else:
                self.load_checkpoint(resume_from)
                self._resumed_at_update = self.runner.train.update
            if num_updates is None:
                num_updates = self.cfg.num_updates - self.runner.train.update
        info = super().train(num_updates=num_updates, log_every=log_every,
                             on_update=on_update)
        # _pre_update only runs before a next update: a last update on the interval
        # is checkpointed here
        if self.checkpoint_dir and self._host_update > 0 \
                and self._host_update % self.checkpoint_every == 0 \
                and self._host_update != self._resumed_at_update:
            self.save_checkpoint(os.path.join(self.checkpoint_dir,
                                              f"checkpoint_update_{self._host_update}"))
        return info

"""Host-side training loop around the PPO update (port of
``self_play_racing_tpu/agent/trainer.py``).

Buffers, per-update anneals, logging and the training-info JSON as in the
reference; the trainer runs on the device its track lives on. It drives the
single-car env by default; the self-play trainer passes its own ``hooks`` and
``aux``. ``shard(mesh)`` spreads it over a data-parallel process group
(``parallel/mesh.py``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch

from .._tree import tree_map
from ..configs import PPOConfig
from ..envs import single as senv
from ..envs import track as trk
from ..envs import vector
from ..parallel import mesh as pmesh
from . import ppo


def make_single_env_hooks(env_cfg: senv.RacingConfig) -> ppo.EnvHooks:
    """EnvHooks over the single-car env. aux is either the geometry (per-env
    TrackArrays or a capacity layout, ``envs/track.py``) or a dict {"track": the
    geometry, "speed_weight": scalar tensor} (annealed variant). The step is
    ``single.transition_autoreset``."""

    def track_of(aux):
        return aux["track"] if isinstance(aux, dict) else aux

    def reset(aux, generator):
        return senv.reset_state(env_cfg, track_of(aux))

    def step(aux, state, action, generator, pending_reset, stats, rows):
        return senv.transition_autoreset(
            env_cfg, track_of(aux), state, action, pending_reset, stats,
            speed_weight=aux.get("speed_weight") if isinstance(aux, dict) else None, rows=rows)

    def observe(aux, state):
        return senv.observe(env_cfg, track_of(aux), state)

    return ppo.EnvHooks(reset=reset, step=step, observe=observe)


class DivergenceError(RuntimeError):
    """Training produced non-finite losses (see PPOTrainer.train(on_divergence=...))."""


def treedef_string(num_layers: int) -> str:
    """The JAX package's ``str(treedef)`` of a two-tower parameter pytree with
    ``num_layers`` (w, b) layers per tower, stored beside the leaves in ``.npz``
    policies."""
    layers = ", ".join(["(*, *)"] * num_layers)
    return f"PyTreeDef({{'actor': [{layers}], 'critic': [{layers}]}})"


class PPOTrainer:
    """Single-car PPO trainer (reference PPO class equivalent).

    track: per-env TrackArrays (already gathered to [num_envs, ...]) or a
    capacity layout over a resident pool (``envs/track.py``); the trainer runs on
    its device. Weights are drawn from a CPU generator seeded with ``cfg.seed``.
    ``eager``: run the update's steps eagerly on the card instead of as CUDA graphs
    (``ppo.make_update_step``), the reference the graphs are held to.
    """

    def __init__(self, cfg: PPOConfig, env_cfg: senv.RacingConfig, track: trk.Track,
                 hooks: Optional[ppo.EnvHooks] = None, aux=None, eager: bool = False):
        self.cfg = cfg
        self.env_cfg = env_cfg
        self.eager = eager
        self.device = trk.rows_of(track)[0].wp_x.device
        self._mesh = None  # set by shard(); re-applied on aux swaps
        if aux is not None:
            self.aux = self._place_aux(aux)
        elif cfg.anneal_speed_weight:
            self.aux = {"track": track,
                        "speed_weight": self._f32(env_cfg.speed_weight)}
        else:
            self.aux = track
        self.hooks = hooks if hooks is not None else make_single_env_hooks(env_cfg)
        self.update_step = ppo.make_update_step(cfg, self.hooks, env_cfg.action_dim,
                                                eager=eager)
        generator = torch.Generator().manual_seed(cfg.seed)
        self.runner = ppo.init_runner(generator, cfg, self.hooks, self.aux,
                                      env_cfg.obs_dim, env_cfg.action_dim)
        self.training_info = {"steps": [], "rewards": []}
        self._host_update = 0  # mirror of runner.train.update (see train())
        # optional domain randomization: fn(update:int) -> new geometry (per-env
        # TrackArrays or a layout; None keeps the current one); consulted before
        # every update
        self.track_resampler = None

    def _f32(self, value) -> torch.Tensor:
        return torch.tensor(value, dtype=torch.float32, device=self.device)

    def shard(self, mesh: pmesh.DataMesh):
        """Spread the trainer over a data-parallel mesh: this rank keeps its
        ``num_envs / world`` envs (env state, observations, per-env track rows
        and aux), params and optimizer state are rank 0's on every rank, and the
        update reduces over the group (``ppo.make_update_step(mesh=...)``). On a
        ``TensorMesh`` the envs are split by the data index and the learner keeps
        this rank's slices of the towers and their Adam moments
        (``pmesh.param_shardings``). Pair
        with ``cfg.data_shards`` = the data axis so the minibatch shuffle stays
        shard-local; ``data_shards=1`` (the reference-parity global shuffle) is
        also legal and gathers the batch on every rank, but any other value
        raises."""
        n_data = mesh.world
        if self.cfg.data_shards > 1 and self.cfg.data_shards != n_data:
            raise ValueError(
                f"cfg.data_shards={self.cfg.data_shards} does not match the "
                f"mesh's data axis ({n_data}): the shard-local minibatch layout "
                f"only stays collective-free when the shard count equals the "
                f"data-parallel degree (use data_shards={n_data} or 1)"
            )
        if mesh.device != self.device:
            raise ValueError(f"the trainer runs on {self.device}, the mesh's "
                             f"process owns {mesh.device}")
        self._mesh = mesh
        self.runner, self.aux = pmesh.shard_runner(
            self.runner, self.aux, mesh, self.cfg.num_envs)
        self.update_step = ppo.make_update_step(self.cfg, self.hooks,
                                                self.env_cfg.action_dim, mesh=mesh,
                                                eager=self.eager)

    @property
    def _writes_files(self) -> bool:
        """Process 0 writes the run's files (every rank holds the same state)."""
        return self._mesh is None or self._mesh.process_rank == 0

    def full_state(self):
        """(params, mu, nu): the learner's parameters and Adam moments as whole
        tensors in ``model.parameters()`` order. On a tensor-parallel rank they are
        gathered over the model group, so every rank of the group must call it."""
        train = self.runner.train
        tp = train.model.tensor_parallel
        state = ([p.detach() for p in train.model.parameters()],
                 list(train.opt_state.mu), list(train.opt_state.nu))
        if tp is None:
            return state
        return tuple(pmesh.gather_leaves(leaves, tp) for leaves in state)

    def _place_aux(self, aux):
        """Freshly built aux leaves, moved to the trainer's device (and, once
        sharded, cut to this rank's envs). An aux whose leaves are all there
        already is returned as it is, as the reference returns it where there is
        nothing to place it on."""
        on_device = []
        tree_map(lambda t: on_device.append(t.device == self.device), aux)
        if not all(on_device):
            aux = tree_map(lambda t: t.to(self.device), aux)
        if self._mesh is not None:
            aux = pmesh.shard_by_env_axis(aux, self._mesh, self.cfg.num_envs)
        return aux

    @property
    def params(self):
        return self.runner.train.model.params()

    @property
    def log_std(self):
        """log_std annealed for the upcoming update (what update_step will use)."""
        return ppo.anneal_fractions(self.cfg, self.runner.train.update,
                                    self.env_cfg.action_dim, device=self.device)[2]

    @property
    def buffer_log_std(self):
        """log_std as the reference's torch buffer holds it between updates: the
        value annealed for the last completed update (anneal(update-1)). Before any
        update has run the buffer holds its registration value, zeros."""
        if self._host_update == 0:
            return torch.zeros((self.env_cfg.action_dim,), dtype=torch.float32,
                               device=self.device)
        return ppo.anneal_fractions(self.cfg, self._host_update - 1,
                                    self.env_cfg.action_dim, device=self.device)[2]

    def train(self, num_updates: Optional[int] = None, log_every: int = 1,
              on_update=None, on_divergence: str = "raise"):
        """Run the update loop, logging as the reference does.

        ``on_divergence``: ``"raise"`` (default) aborts with a DivergenceError naming
        the update when its pg_loss, v_loss or mean reward is not finite; ``"warn"``
        logs and continues.

        The metrics of update N are consumed (logging, ``_post_update``,
        ``on_update``) after update N+1 has run, as in the JAX trainer: hooks
        observe ``self.runner`` one update ahead of the metrics they receive.
        """
        cfg = self.cfg
        total = cfg.num_updates if num_updates is None else num_updates
        self._host_update = self.runner.train.update
        start_gstep = self._host_update * cfg.batch_size  # steps before this call
        t0 = time.perf_counter()

        def consume(packed):
            m = ppo.unpack_metrics(packed)
            update = int(m["update"]) + 1
            if not (np.isfinite(m["pg_loss"]) and np.isfinite(m["v_loss"])
                    and np.isfinite(m["mean_reward"])):
                msg = (f"non-finite losses at update {update}: "
                       f"pg={m['pg_loss']} v={m['v_loss']} r={m['mean_reward']}")
                if on_divergence == "raise":
                    raise DivergenceError(msg)
                print(f"WARNING: {msg}")
            gstep = update * cfg.batch_size
            if int(m["episodes"]) > 0:
                self.training_info["steps"].append(gstep)
                self.training_info["rewards"].append(float(m["mean_ep_return"]))
                if update % log_every == 0:
                    sps = (gstep - start_gstep) / (time.perf_counter() - t0)
                    print(
                        f"Update {update}/{cfg.num_updates} | Step {gstep} | "
                        f"Episodes: {int(m['episodes'])} | "
                        f"Mean Reward: {float(m['mean_ep_return']):.2f} | "
                        f"Mean Length: {float(m['mean_ep_length']):.2f} | "
                        f"{sps:,.0f} steps/s"
                    )
            elif update % log_every == 0:
                print(f"Update {update}/{cfg.num_updates} | Step {gstep} | "
                      f"No episodes completed this rollout")
            self._post_update(m)
            if on_update is not None:
                on_update(self, m)

        pending = None
        for _ in range(total):
            self._pre_update()
            self.runner, metrics = self.update_step(self.runner, self.aux)
            self._host_update += 1
            if pending is not None:
                consume(pending)
            pending = metrics
        if pending is not None:
            consume(pending)
        return self.training_info

    def _pre_update(self):
        """Hook before each update: the speed-weight anneal and track resampling,
        keyed off the host-side update counter. The anneal runs only where the aux
        is the annealed variant's dict, as in the reference: a caller's own aux is
        left as given."""
        if self.cfg.anneal_speed_weight and isinstance(self.aux, dict) \
                and "speed_weight" in self.aux:
            # the reference's intended schedule, 8 -> 14
            frac = max(0.0, 1.0 - self._host_update / self.cfg.num_updates)
            self.aux["speed_weight"] = self._f32(8.0 + (1.0 - frac) * 6.0)
        if self.track_resampler is not None:
            new_track = self.track_resampler(self._host_update)
            if new_track is not None:
                self.set_track(new_track)

    def set_track(self, track, reset: bool = True):
        """Swap the env geometry for all subsequent updates. ``reset``
        re-initializes every env on the new geometry; in-flight episode statistics
        are discarded."""
        track = self._place_aux(track)
        if isinstance(self.aux, dict):
            self.aux = {**self.aux, "track": track}
        else:
            self.aux = track
        if reset:
            self.reset_envs()

    def reset_envs(self):
        """Re-reset all envs against the current aux, keeping learner state."""
        runner = self.runner
        vec_gen = runner.vec.generator
        n = runner.done.shape[0]  # this rank's envs
        env_state, obs = ppo.reset_observe(self.hooks, self.aux, vec_gen)
        self.runner = dataclasses.replace(
            runner,
            vec=vector.init(env_state, n, vec_gen),
            obs=obs.to(torch.float32),
            done=torch.zeros((n,), dtype=torch.bool, device=self.device),
        )

    def _post_update(self, metrics):
        """Hook after each update (self-play: periodic full checkpoints)."""

    def save(self, path: str):
        """Save the policy in the repo's ``.npz`` format: leaves ``p0..p{4L-1}`` in
        the JAX package's tree order, its ``treedef`` string and the buffer
        log_std. Policies trained with ``normalize_obs`` also store the running
        observation statistics. Process 0 writes in a distributed run the whole
        parameters (tensor-parallel slices gathered first, on every rank)."""
        params = self.full_state()[0]
        if not self._writes_files:
            return
        leaves = [p.cpu().numpy() for p in params]
        extra = {}
        if self.cfg.normalize_obs:
            norm = self.runner.obs_norm
            extra = {f"obs_{k}": getattr(norm, k).cpu().numpy()
                     for k in ("mean", "var", "count")}
        np.savez(path, treedef=treedef_string(len(leaves) // 4),
                 log_std=self.buffer_log_std.cpu().numpy(), **extra,
                 **{f"p{i}": x for i, x in enumerate(leaves)})

    def load(self, path: str):
        """Load policy parameters (and the observation normalizer, if saved) from a
        ``.npz`` or ``.pth`` policy; the optimizer state is kept."""
        from ..evaluate import load_policy_bundle

        params, _, obs_norm = load_policy_bundle(path, device=self.device)
        model = self.runner.train.model
        new = [t for tower in ("actor", "critic") for layer in params[tower] for t in layer]
        old = list(model.parameters())
        if [t.shape for t in new] != [t.shape for t in old]:
            raise ValueError(f"{path}: parameter shapes differ from the trainer's")
        with torch.no_grad():
            for p, t in zip(old, new):
                p.copy_(t)
        if obs_norm is not None:
            self.runner = dataclasses.replace(self.runner, obs_norm=obs_norm)

    def save_training_info(self, path: str):
        if not self._writes_files:
            return
        with open(path, "w") as f:
            json.dump(self.training_info, f)

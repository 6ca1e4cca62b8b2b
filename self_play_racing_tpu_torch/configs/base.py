"""Training hyperparameters (port of ``self_play_racing_tpu/configs/base.py``).

The port keeps its own copy of the JAX package's config: the same fields, defaults,
checks and derived ``batch_size``/``minibatch_size``/``num_updates``. The comments
on the fields are the JAX package's, and so are the names of its knobs (some, like
``data_shards`` or the self-play ones, only come into play in later parts of the
port).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    # training (base_config.py:4-7)
    total_timesteps: int = 5_000_000
    num_envs: int = 16
    num_steps: int = 2048
    learning_rate: float = 3e-4

    # ppo specific (base_config.py:10-18)
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_coef: float = 0.2
    ent_coef: float = 0.01
    vf_coef: float = 0.5
    update_epochs: int = 10
    num_minibatches: int = 16
    max_grad_norm: float = 0.5
    kl_target: float = 0.015

    # system (base_config.py:21-23)
    seed: int = 1

    # policy/value tower widths (reference fixed at 64-64, ppo.py:19-37)
    hidden: tuple = (64, 64)

    # running observation normalization (the reference ships this disabled,
    # ppo.py:89-90); policy inputs become (obs - mean)/std clipped to +-10
    normalize_obs: bool = False

    # epoch-shuffle granularity: contiguous blocks of this many samples are permuted
    # as units. The effective block is gcd(shuffle_block_size, num_envs) so a block
    # is always adjacent envs at ONE timestep (envs are independent, so minibatch
    # statistics stay effectively uniform; cross-timestep blocks would lock
    # correlated samples together). Set 1 for an exact per-sample uniform
    # permutation.
    shuffle_block_size: int = 64

    # Shard-local minibatch shuffling for data-parallel training: with D > 1 every
    # one of D env shards permutes its own rollout slice independently per epoch
    # and contributes an equal stratum to each minibatch, so a minibatch is
    # gathered from resident samples only. On one device it is a pure layout.
    # 1 = reference-parity global shuffle.
    data_shards: int = 1

    # log-std anneal endpoints (ppo.py:250-253 single; self_play_ppo.py:135-139 self-play)
    log_std_start: float = -0.5
    log_std_end: float = -1.6

    # intended-but-inert reference feature (SURVEY quirk #2): the single-agent
    # speed-weight anneal 8 -> 14 never reaches the env because setattr targets the
    # statistics wrapper (ppo.py:255-258). Default False reproduces the effective
    # constant-8.0 behavior; True enables the anneal as written.
    anneal_speed_weight: bool = False

    # self-play (self_play_config.py:21-22); 0 snapshot_freq = self-play disabled
    snapshot_freq: int = 0
    pool_size: int = 0

    # self-play parity knobs: one opponent per update shared by all envs + a forced
    # full reset of every env at each opponent swap (the reference rebuilds its
    # SyncVectorEnv every update, self_play_ppo.py:46-50; SURVEY quirk #7). Disable
    # both to sample opponents per-env and keep env state resident (scale mode).
    opponent_per_env: bool = False
    reset_envs_each_update: bool = False

    # opponent sampling over the snapshot pool: "uniform" (reference,
    # self_play_ppo.py:40-44) or "pfsp" — prioritized fictitious self-play:
    # slots the learner loses to are sampled more often, weight
    # (1 - winrate)^pfsp_power with winrates measured from training-rollout
    # episode outcomes (Laplace-smoothed, one update lagged by the metrics
    # pipeline, reset when a ring slot is overwritten).
    opponent_sampling: str = "uniform"
    pfsp_power: float = 2.0

    def __post_init__(self):
        if self.num_envs <= 0 or self.num_steps <= 0:
            raise ValueError(
                f"num_envs={self.num_envs} and num_steps={self.num_steps} must be positive"
            )
        if self.batch_size % self.num_minibatches != 0:
            raise ValueError(
                f"batch_size={self.batch_size} (num_steps*num_envs) must be divisible "
                f"by num_minibatches={self.num_minibatches} — the flattened rollout is "
                f"split into equal minibatches"
            )
        if self.total_timesteps < self.batch_size:
            raise ValueError(
                f"total_timesteps={self.total_timesteps} is less than one batch "
                f"({self.batch_size}): num_updates would be 0"
            )
        if (self.snapshot_freq > 0) != (self.pool_size > 0):
            raise ValueError(
                f"snapshot_freq={self.snapshot_freq} and pool_size={self.pool_size} "
                f"must be enabled together (both > 0) or both 0"
            )
        if self.data_shards < 1:
            raise ValueError(f"data_shards={self.data_shards} must be >= 1")
        if self.data_shards > 1:
            if self.num_envs % self.data_shards != 0:
                raise ValueError(
                    f"num_envs={self.num_envs} must be divisible by "
                    f"data_shards={self.data_shards} (one equal env shard per device)"
                )
            if self.minibatch_size % self.data_shards != 0:
                raise ValueError(
                    f"minibatch_size={self.minibatch_size} must be divisible by "
                    f"data_shards={self.data_shards} (each shard contributes an "
                    f"equal stratum per minibatch)"
                )
        if self.opponent_sampling not in ("uniform", "pfsp"):
            raise ValueError(
                f"opponent_sampling={self.opponent_sampling!r} must be "
                f"'uniform' or 'pfsp'"
            )

    @property
    def batch_size(self) -> int:
        return self.num_steps * self.num_envs

    @property
    def minibatch_size(self) -> int:
        return self.batch_size // self.num_minibatches

    @property
    def num_updates(self) -> int:
        return self.total_timesteps // self.batch_size


def base_config(**overrides) -> PPOConfig:
    """Single-agent PPO defaults (base_config.py)."""
    return dataclasses.replace(PPOConfig(), **overrides)


def self_play_config(**overrides) -> PPOConfig:
    """Self-play defaults (self_play_config.py): 3M steps, lambda .97, ent .02,
    snapshot every 15 updates, pool of 5, log-std -0.3 -> -1.2, env reset each update."""
    kw = dict(
        total_timesteps=3_000_000,
        gae_lambda=0.97,
        ent_coef=0.02,
        snapshot_freq=15,
        pool_size=5,
        log_std_start=-0.3,
        log_std_end=-1.2,
        reset_envs_each_update=True,
    )
    kw.update(overrides)
    return dataclasses.replace(PPOConfig(), **kw)

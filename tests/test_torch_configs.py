"""The port's copy of the training configs against the JAX package's (exact).

Every field, default and derived property of ``PPOConfig``, ``base_config()`` and
``self_play_config()`` equals the JAX package's, and the same invalid settings raise
``ValueError`` on both sides.
"""
import dataclasses

import pytest

from self_play_racing_tpu import configs as jconfigs
from self_play_racing_tpu_torch import configs as tconfigs


def _as_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def test_fields_and_defaults_match_jax():
    t = [(f.name, f.type, f.default) for f in dataclasses.fields(tconfigs.PPOConfig)]
    j = [(f.name, f.type, f.default) for f in dataclasses.fields(jconfigs.PPOConfig)]
    assert t == j
    assert tconfigs.PPOConfig.__dataclass_params__.frozen


@pytest.mark.parametrize("factory", ["base_config", "self_play_config"])
@pytest.mark.parametrize("overrides", [{}, dict(num_envs=4096, num_steps=256,
                                                total_timesteps=4096 * 256 * 100),
                                       dict(seed=7, gae_lambda=0.9, data_shards=2)])
def test_factories_and_properties_match_jax(factory, overrides):
    t = getattr(tconfigs, factory)(**overrides)
    j = getattr(jconfigs, factory)(**overrides)
    assert _as_dict(t) == _as_dict(j)
    for prop in ("batch_size", "minibatch_size", "num_updates"):
        assert getattr(t, prop) == getattr(j, prop), prop


INVALID = {
    "zero_envs": dict(num_envs=0),
    "negative_steps": dict(num_steps=-1),
    "batch_not_divisible": dict(num_envs=3, num_steps=5, total_timesteps=10_000),
    "less_than_one_batch": dict(total_timesteps=100),
    "snapshot_without_pool": dict(snapshot_freq=5),
    "pool_without_snapshot": dict(pool_size=5),
    "zero_shards": dict(data_shards=0),
    "envs_not_divisible_by_shards": dict(data_shards=3),
    "minibatch_not_divisible_by_shards": dict(num_envs=16, num_steps=2,
                                              num_minibatches=16, data_shards=4),
    "unknown_opponent_sampling": dict(opponent_sampling="elo"),
}


@pytest.mark.parametrize("case", sorted(INVALID))
def test_invalid_configs_raise_as_in_jax(case):
    with pytest.raises(ValueError) as jerr:
        jconfigs.base_config(**INVALID[case])
    with pytest.raises(ValueError) as terr:
        tconfigs.base_config(**INVALID[case])
    assert str(terr.value) == str(jerr.value)

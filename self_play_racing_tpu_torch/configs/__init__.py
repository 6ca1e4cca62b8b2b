"""Hyperparameter configs (port of ``self_play_racing_tpu/configs``)."""
from .base import PPOConfig, base_config, self_play_config

__all__ = ["PPOConfig", "base_config", "self_play_config"]

"""The PPO learner and its host-side trainer (port of ``self_play_racing_tpu/agent``)."""

"""The actor-critic policy."""

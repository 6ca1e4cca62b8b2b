"""Evaluation rollouts and the canonical benchmark pool."""

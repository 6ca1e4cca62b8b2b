"""PyTorch + CUDA port of the self-play racing framework (slices 1 and 2:
inference and single-car PPO training).

A second package beside ``self_play_racing_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's module tree and function names:

- ``ops``     — car dynamics, the batched geometry reductions, GAE and the epoch
                permutations; the wall raycast, the track query, GAE and the
                permutations run as hand-written CUDA kernels (``csrc/``) on CUDA
                tensors and as their plain PyTorch versions on CPU tensors
- ``envs``    — track pools, the single-car env, NEXT_STEP autoreset, obs normalizer
- ``models``  — the actor-critic MLP (weights stored ``(in, out)``, as in JAX)
- ``configs`` — the training hyperparameters (``PPOConfig``)
- ``agent``   — the PPO update (rollout, GAE, clipped update with the KL exit) and
                the single-car trainer
- ``utils``   — evaluation rollouts and the canonical benchmark pool
- ``train``, ``evaluate``, ``serve`` — the entry points
- ``interop`` — parameters and optimizer state carried over from the JAX package's
                numpy/npz formats

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

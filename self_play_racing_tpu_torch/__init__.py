"""PyTorch + CUDA port of the self-play racing framework (slices 1-3: inference,
single-car PPO training and snapshot-pool self-play).

A second package beside ``self_play_racing_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's module tree and function names:

- ``ops``     — car dynamics, the batched geometry reductions, GAE and the epoch
                permutations; the wall raycast, the track query, the car raycast,
                the car-pair SAT test, the car dynamics, GAE and the permutations
                run as hand-written CUDA kernels (``csrc/``) on CUDA tensors and as
                their plain PyTorch versions on CPU tensors; the env step launches
                the car raycast inside the wall raycast's kernel and the car
                dynamics inside the track query's
- ``envs``    — track pools, the single-car and multi-car envs, the self-play
                view, NEXT_STEP autoreset, obs normalizer
- ``models``  — the actor-critic MLP (weights stored ``(in, out)``, as in JAX)
- ``configs`` — the training hyperparameters (``PPOConfig``)
- ``agent``   — the PPO update (rollout, GAE, clipped update with the KL exit), the
                single-car trainer and the snapshot-pool self-play trainer
- ``utils``   — evaluation rollouts, checkpoints and the canonical benchmark pool
- ``train``, ``evaluate``, ``serve`` — the entry points
- ``interop`` — parameters, optimizer state and opponent pools carried over from
                the JAX package's numpy/npz formats

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

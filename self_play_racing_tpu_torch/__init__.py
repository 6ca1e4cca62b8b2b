"""PyTorch + CUDA port of the self-play racing framework (slice 1: inference).

A second package beside ``self_play_racing_tpu`` (the JAX reference, which it never
imports). It mirrors the reference's module tree and function names:

- ``ops``     — car dynamics and the batched geometry reductions; the wall raycast
                and the track query run as hand-written CUDA kernels (``csrc/``) on
                CUDA tensors and as their plain PyTorch versions on CPU tensors
- ``envs``    — track pools, the single-car env, NEXT_STEP autoreset, obs normalizer
- ``models``  — the actor-critic MLP (weights stored ``(in, out)``, as in JAX)
- ``utils``   — evaluation rollouts and the canonical benchmark pool
- ``evaluate``, ``serve`` — the inference entry points
- ``interop`` — parameters carried over from the JAX package's numpy/npz formats

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

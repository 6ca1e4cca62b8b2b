"""PyTorch + CUDA port of the self-play racing framework: inference, single-car PPO
training, snapshot-pool self-play, data- and tensor-parallel training, procedural
tracks, tournaments, rendering, the Gymnasium adapters and the SB3 baseline.

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
                view, NEXT_STEP autoreset, obs normalizer, and the Gymnasium-API
                adapters (``RacingEnv``, ``MultiRacingEnv``, ``SelfPlayWrapper``)
- ``models``  — the actor-critic MLP (weights stored ``(in, out)``, as in JAX)
- ``configs`` — the training hyperparameters (``PPOConfig``)
- ``agent``   — the PPO update (rollout, GAE, clipped update with the KL exit), the
                single-car trainer and the snapshot-pool self-play trainer
- ``utils``   — evaluation and match rollouts, checkpoints, trajectory recording and
                rendering, profiling and the canonical benchmark pool
- ``parallel`` — data-parallel training over ``torch.distributed`` (NCCL on the
                card, gloo on the CPU), tensor-parallel policy and value towers
                over a second process-group axis, and the scaling measurement
- ``train``, ``evaluate``, ``serve``, ``tournament``, ``render`` — the entry points
- ``interop`` — parameters, optimizer state and opponent pools carried over from
                the JAX package's numpy/npz formats; ``interop.sb3_compat``, SB3's
                default PPO in plain torch for the baseline (``train sb3``,
                ``evaluate --sb3``)

Every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Lazy top-level exports of the main user-facing entry points, resolved on first
# access so that importing the package stays light.
_EXPORTS = {
    "PPOConfig": ".configs",
    "base_config": ".configs",
    "self_play_config": ".configs",
    "PPOTrainer": ".agent.trainer",
    "SelfPlayTrainer": ".agent.self_play",
    "Policy": ".serve",
    "load_policy": ".evaluate",
    "load_policy_bundle": ".evaluate",
    "RacingEnv": ".envs.gym_adapter",
    "MultiRacingEnv": ".envs.gym_adapter",
    "SelfPlayWrapper": ".envs.gym_adapter",
}

__all__ = sorted(_EXPORTS) + ["__version__"]


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target, __name__), name)


def __dir__():
    return __all__

"""Sort-free random permutations for minibatch shuffling (port of
``self_play_racing_tpu/ops/prng.py``).

For a power-of-two domain [0, n) the permutation is a pseudorandom bijection on
indices: rounds of ``x <- (a*x + c) mod n`` (odd ``a``) and ``x <- x XOR (x >> s)``,
both invertible on k-bit integers, with round constants drawn per permutation.
Sizes that are not a power of two fall back to ``torch.randperm``.

The round constants are an argument (``[..., 8]`` integers in [0, 2^32), as the
JAX package draws them with ``jax.random.bits(key, (8,), uint32)``), or drawn from
a ``torch.Generator``, so tests can feed the port and the JAX package the same
numbers.

``mixbits_permutation`` (K7) dispatches on the device of the constants: a CPU
tensor takes the plain PyTorch version, a CUDA tensor launches the hand-written
kernel (``csrc/mixbits_permutation.cu``) or raises. ``mixbits_permutation_launches``
counts kernel launches.
"""
from __future__ import annotations

import math

import torch

from . import _cuda
from .geometry import _on_cuda

_ROUNDS = 4
_UINT32 = 1 << 32

mixbits_permutation_launches = 0


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1) or n > 1 << 31:
        raise ValueError(f"mixbits_permutation needs a power-of-two size up to 2^31, got {n}")
    return n.bit_length() - 1


def draw_constants(shape, generator: torch.Generator, device=None) -> torch.Tensor:
    """Round constants ``shape + (8,)``: int64 holding uniform uint32 values."""
    return torch.randint(0, _UINT32, tuple(shape) + (2 * _ROUNDS,), generator=generator,
                         dtype=torch.int64, device=device)


def mixbits_permutation(consts, n: int) -> torch.Tensor:
    """Permutations of [0, n), one per row of ``consts`` ([..., 8] integers in
    [0, 2^32)); n must be a power of two. Returns int32 ``consts.shape[:-1] + (n,)``."""
    global mixbits_permutation_launches
    log2_n = _log2(n)
    if consts.shape[-1:] != (2 * _ROUNDS,):
        raise ValueError(f"mixbits_permutation: constants must be [..., 8], got "
                         f"{tuple(consts.shape)}")
    if not _on_cuda(consts, "mixbits_permutation"):
        return mixbits_permutation_plain(consts, n)
    out = _mixbits_permutation_cuda(consts, log2_n)
    mixbits_permutation_launches += 1
    return out


def mixbits_permutation_plain(consts, n: int) -> torch.Tensor:
    """Plain PyTorch K7 in int64. Every round is masked to n - 1 and only the low
    k bits survive, so masking the multiplier first gives the uint32 result while
    keeping ``x * a`` below 2^62."""
    k = _log2(n)
    mask = n - 1
    shift = max(1, k // 2)
    consts = consts.to(torch.int64)
    x = torch.arange(n, dtype=torch.int64, device=consts.device).expand(
        consts.shape[:-1] + (n,))
    for r in range(_ROUNDS):
        a = ((consts[..., 2 * r] | 1) & mask)[..., None]
        c = consts[..., 2 * r + 1][..., None]
        x = (x * a + c) & mask
        x = x ^ (x >> shift)
    return x.to(torch.int32)


def _mixbits_permutation_cuda(consts, log2_n: int) -> torch.Tensor:
    if consts.dtype != torch.int64:
        raise TypeError(f"mixbits_permutation: the CUDA kernel takes int64 constants, "
                        f"got {consts.dtype}")
    consts = consts.contiguous()
    lead = consts.shape[:-1]
    out = torch.empty(lead + (1 << log2_n,), dtype=torch.int32, device=consts.device)
    with torch.cuda.device(consts.device):
        _cuda.launch_mixbits_permutation(consts, out, consts.numel() // (2 * _ROUNDS),
                                         log2_n)
    return out


def epoch_permutation(generator, n: int, shape=(), consts=None, device=None):
    """Shuffle indices for ``shape`` (e.g. ``(epochs, shards)``) independent epochs
    of n samples: the sort-free permutation from ``consts`` (or constants drawn
    from ``generator``) when n is a power of two, else ``torch.randperm`` from
    ``generator``. Returns ``shape + (n,)`` integer indices on ``device``."""
    shape = tuple(shape)
    if n & (n - 1) == 0:
        if consts is None:
            consts = draw_constants(shape, generator, device=device)
        return mixbits_permutation(consts, n)
    if generator is None:
        raise ValueError(f"epoch_permutation: size {n} is not a power of two; "
                         "the torch.randperm fallback needs a generator")
    count = math.prod(shape)
    perms = [torch.randperm(n, generator=generator, device=device) for _ in range(count)]
    return torch.stack(perms).reshape(shape + (n,))

"""Divisions rounded as the JAX package rounds them under ``jit``.

XLA rewrites a division by a compile-time constant into a multiplication by the
constant's reciprocal, rounded once in the operand's dtype; a division by a
computed value stays an IEEE division. PyTorch has its own rewrites: on CUDA
``tensor / scalar`` multiplies by a reciprocal, and everywhere ``scalar / tensor``
is ``reciprocal(tensor) * scalar``, which rounds twice. These helpers state the
reference's rounding explicitly so the CPU and the card agree with it.
"""
from __future__ import annotations

import numpy as np
import torch


def f32_reciprocal(c: float) -> np.float32:
    """``1 / c`` rounded to float32 as ``div_const`` rounds it for a float32 tensor
    (the value a kernel multiplies by to divide as the plain version does)."""
    return np.float32(1.0) / np.float32(c)


def div_const(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` for a constant ``c``, as XLA computes it: ``t * (1 / c)`` with the
    reciprocal rounded in ``t``'s dtype."""
    if t.dtype == torch.float32:
        recip = float(f32_reciprocal(c))
    elif t.dtype == torch.float64:
        recip = 1.0 / float(c)
    else:
        raise TypeError(f"div_const: unsupported dtype {t.dtype}")
    return t * recip


def const_div(c: float, t: torch.Tensor) -> torch.Tensor:
    """``c / t`` for a constant ``c``: one IEEE division."""
    return torch.full_like(t, c) / t
